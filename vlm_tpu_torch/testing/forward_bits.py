"""Digests of B1's fp32 outputs, for holding two trees' kernels to the
same bits on one card:

    python vlm_tpu_torch/testing/forward_bits.py [--root DIR]

``--root``: the repository whose ``vlm_tpu_torch`` to import (default this
one), e.g. a parent commit unpacked with ``git archive`` under
``_checkout/``. The cases are the fp32 forms' cases of
``kernel_checks.py`` (the serving paths' shapes and masks, and the towers
at 4 images) and the probing step's CLIP-L attention at 32 images, all on
inputs drawn from a fixed seed on the card; each output, from the
no-gradient call (the serving path's: no lse written), is hashed with
SHA-256. Where the tree's forward can also write lse, the output of that
call must be bitwise the same, and lse must agree with the plain one
(``testing/attention_grad.py``) within ``FP32_TOL`` of its largest live
row. Prints one JSON line: the card's name and power limit, the root and
the digests by case.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

# (name, B, H, KV, Sq, Sk, D, masks)
CASES = (
    ("siglip_g4_h16_s256_d72", 4, 16, 16, 256, 256, 72, {}),
    ("gemma_prefill_g4_s316_kvlen", 4, 8, 1, 316, 316, 256,
     {"kv_len": [316, 290, 316, 0]}),
    ("prefix_kvlen_gqa_s64", 2, 4, 2, 64, 64, 128,
     {"causal": True, "prefix_len": [20, 5], "kv_len": [60, 64]}),
    ("causal_sq80_sk48_dead_rows", 2, 4, 4, 80, 48, 64, {"causal": True}),
    ("clip_l336_g4_h16_s577_d64", 4, 16, 16, 577, 577, 64, {}),
    ("eva_g4_h16_s257_d88", 4, 16, 16, 257, 257, 88, {}),
    ("clip_l336_g32_h16_s577_d64", 32, 16, 16, 577, 577, 64, {}),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vlm_tpu_torch.ops import attention
    if not torch.cuda.is_available():
        raise SystemExit("forward_bits: needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with_lse = "with_lse" in inspect.signature(
        attention._flash_forward).parameters
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {"gpu": gpu, "root": args.root, "with_lse": with_lse,
           "digests": {}, "lse_ok": {}}
    for name, b, h, kvh, sq, sk, d, masks in CASES:
        def bhsd(s, n):
            return torch.randn(b, s, n, d, generator=gen,
                               device=dev).transpose(1, 2)
        q, k, v = bhsd(sq, h), bhsd(sk, kvh), bhsd(sk, kvh)
        kw = {key: torch.tensor(val, dtype=torch.int32, device=dev)
              if isinstance(val, list) else val for key, val in masks.items()}
        with torch.no_grad():
            o = attention.flash_attention(q, k, v, **kw)
            out["digests"][name] = hashlib.sha256(
                o.contiguous().cpu().numpy().tobytes()).hexdigest()
            if with_lse and set(masks) <= {"causal"}:
                from vlm_tpu_torch.testing.attention_grad import \
                    attention_lse
                from vlm_tpu_torch.testing.kernel_checks import (FP32_TOL,
                                                                 NEG_LSE)
                o2, lse = attention._flash_forward(q, k, v, with_lse=True,
                                                   **kw)
                ref = attention_lse(q, k, v, **kw)
                live = ref > NEG_LSE
                err = float((lse - ref)[live].abs().max())
                out["lse_ok"][name] = bool(
                    torch.equal(o, o2)
                    and err <= FP32_TOL * float(ref[live].abs().max())
                    and (lse[~live] == -1e30).all())
        del q, k, v, o
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
