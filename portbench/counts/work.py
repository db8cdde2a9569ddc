"""Operations and bytes: the yardstick of the rooflines and of the whole
step's share of the peak. A kernel's bound is the larger of its bytes over
the HBM rate and its operations over the peak of its type (``peaks.json``);
each input byte is counted read once and each output byte written once.
Attention counts 4 d operations per (row, live key) for every head in the
forward, 10 d in the backward (five products, the scores recomputed)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

PEAKS = json.loads((Path(__file__).resolve().parents[1] /
                    "peaks.json").read_text(encoding="utf-8"))


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least seconds the card could take."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["ops_per_s"][peak])


def live_keys(b: int, sq: int, sk: int, causal: bool) -> int:
    """(row, key) pairs that a result depends on: every key, or under the
    causal mask (the diagonal at the end of the key axis) those at or
    before the row."""
    if not causal:
        return b * sq * sk
    return b * sum(min(sk, i + sk - sq + 1) for i in range(sq))


def attention(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
              causal: bool = False, elem: int = 2) -> Tuple[float, float]:
    """B1's forward: (operations, bytes); q, k, v read, o written."""
    return (4.0 * d * h * live_keys(b, sq, sk, causal),
            float(elem * d * (2 * b * h * sq + 2 * b * kvh * sk)))


def attention_diff(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
                   causal: bool = False, elem: int = 4
                   ) -> Dict[str, Tuple[float, float]]:
    """B1-diff: the forward as :func:`attention`; the backward 2.5 times
    its operations, q, k, v and the output's gradient read, dq, dk, dv
    written."""
    fwd = attention(b, h, kvh, sq, sk, d, causal, elem)
    tq, tkv = float(elem * d * b * h * sq), float(elem * d * b * kvh * sk)
    return {"fwd": fwd, "bwd": (2.5 * fwd[0], 3 * tq + 4 * tkv)}


def dense(rows: int, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def vit_forward(vis: dict, images: int) -> Dict[str, float]:
    """A ViT's forward over ``images``: the patch embedding, the blocks'
    products (``dense``, one block's) and attention (``attn``, one
    block's)."""
    p, d, m = vis["patch_size"], vis["hidden"], vis["mlp_dim"]
    n = (vis["image_size"] // p) ** 2
    s = n + 1
    return {"patch": dense(images * n, p * p * 3, d),
            "dense": 4 * dense(images * s, d, d) + 2 * dense(images * s, d, m),
            "attn": attention(images, vis["heads"], vis["heads"], s, s,
                              d // vis["heads"])[0],
            "blocks": vis["layers"]}


def vit_total(vis: dict, images: int) -> float:
    f = vit_forward(vis, images)
    return f["patch"] + f["blocks"] * (f["dense"] + f["attn"])


def qformer(qf: dict, decoder_hidden: int, images: int,
            image_tokens: int) -> float:
    """The Q-Former and the language projection."""
    q, h, m = qf["num_query_tokens"], qf["hidden"], qf["mlp_dim"]
    rows = images * q
    self_attn = 4 * dense(rows, h, h) + 4.0 * h * images * q * q
    cross = 2 * dense(rows, h, h) + 2 * dense(images * image_tokens,
                                              qf["encoder_hidden"], h) \
        + 4.0 * h * images * q * image_tokens
    ffn = 2 * dense(rows, h, m)
    n_cross = -(-qf["layers"] // qf["cross_attention_frequency"])
    return qf["layers"] * (self_attn + ffn) + n_cross * cross + \
        dense(rows, h, decoder_hidden)


def opt_layer_dense(dec: dict, rows: int) -> float:
    h, m = dec["hidden"], dec["mlp_dim"]
    return 4 * dense(rows, h, h) + 2 * dense(rows, h, m)


def serve_admission(widths: dict, images: int, prompt_rows: int) -> float:
    """One admission: the tower, the Q-Former, OPT's prefill over the
    prompt's rows (causal) and the head at each image's last row."""
    vis, dec = widths["vision"], widths["decoder"]
    hid = dec["hidden"]
    prefill = dec["layers"] * (
        opt_layer_dense(dec, images * prompt_rows) +
        4.0 * hid * live_keys(images, prompt_rows, prompt_rows, True))
    return vit_total(vis, images) + qformer(
        widths["qformer"], hid, images, (vis["image_size"] //
                                         vis["patch_size"]) ** 2 + 1) + \
        prefill + dense(images, hid, dec["vocab_size"])


def serve_token(widths: dict, length: int) -> float:
    """One decoded token whose row is the ``length``-th of its sequence:
    the layers' products, attention over its ``length`` live rows, the
    head."""
    dec = widths["decoder"]
    hid = dec["hidden"]
    return dec["layers"] * (opt_layer_dense(dec, 1) + 4.0 * hid * length) \
        + dense(1, hid, dec["vocab_size"])


def probe_step(widths: dict, images: int, trained_blocks: int,
               patch_trained: bool) -> float:
    """One training step of a tower whose gradient reaches the patch
    embedding (``patch_trained``) or only the last ``trained_blocks``
    blocks: the forward, the activation gradients of every block the
    gradient crosses (the products once more, attention 2.5 times), the
    weight gradients of the trained products only. The heads are left
    out (under 0.01 % of the step)."""
    vis = widths["vision"]
    f = vit_forward(vis, images)
    crossed = vis["layers"] if patch_trained else trained_blocks
    return vit_total(vis, images) + crossed * (f["dense"] +
                                               2.5 * f["attn"]) + \
        trained_blocks * f["dense"] + (f["patch"] if patch_trained else 0.0)
