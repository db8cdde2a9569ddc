"""The reference's products, in float32 or in one of the lower precisions
that the controls use. Plain PyTorch: TF32 is emulated by rounding each
operand to TF32's 10-bit mantissa before an fp32 product, fp8 by a
per-tensor scaled round trip through ``float8_e4m3fn``; the fp32 mode turns
the card's own TF32 off, so a product is a float32 product."""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")


def strict_fp32() -> None:
    """No TF32 anywhere in the process's float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest TF32 value (10 mantissa bits),
    ties away from zero, as the tensor core's conversion."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through e4m3 with one scale for the tensor (its abs-max onto
    e4m3's 448), back in fp32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Precision:
    """``linear`` and ``matmul`` in ``mode``; every other operation is
    float32 in every mode."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: one of {MODES}")
        self.mode = mode

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in fp32 rounded to the mode's precision; under autograd
        the rounding passes the gradient through unchanged."""
        x = x.float()
        if self.mode == "fp32":
            return x
        r = round_tf32(x.detach()) if self.mode == "tf32" else \
            round_fp8(x.detach())
        return x + (r - x.detach()) if x.requires_grad else r

    def linear(self, x, w, b=None):
        y = F.linear(self.cast(x), self.cast(w))
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        return torch.matmul(self.cast(a), self.cast(b))
