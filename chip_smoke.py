#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vlm_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the CUDA kernels from ``vlm_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the serving
   paths' shapes (B1's differentiable form, forward and backward, at the
   probing step's; its fp32 backward kernel also at SigLIP's, EVA's, the
   probing mesh's, a causal and a grouped-head shape: against the
   recompute and the float64 formulation, bitwise on a second run), with
   error, tolerance, both times, the bound (the least
   time the card could take for the work) and, where one PyTorch call
   computes the same function, that call's time (timed only: the port
   never calls it); kernel and library call also profiled (their kernels'
   own device time, without the events' floor);
4. checkpoint: a synthetic PaliGemma-3B checkpoint with the real one's
   key set, shapes and dtypes (the hub layout of
   ``tests/goldens/manifests/paligemma-3b-mix-224.json``: 603 fp32
   tensors, 11.69 GB), values drawn from a seed on the card, written as
   three shards into a temporary directory (deleted at the end); then
   quantize-on-load: a depth-cut copy loaded on the card in 8bit and in
   4bit with the tower quantized, 10 Denses' ``q`` and ``scale`` bitwise
   against the CPU's quantization of the same file tensors;
5. bf16 slice: PaliGemma-3B at full width, bf16, its weights loaded from
   that checkpoint through ``create_model(..., model_id=<dir>)`` (the
   load's seconds, GB/s and device memory printed; the memory bounded by
   the model plus two fp32 copies of the largest tensor), through the
   port's continuous batcher (32 slots, 64 synthetic
   224 px images fed through the normalisation kernel straight into the
   patch embedding's layout, a 60-id prompt, up to 32 new tokens with
   per-image caps from [8, 32]); every kernel of the path must have
   launched, no plain version may have run, and every decode step must
   have written its KV rows inside B2's launch (B3's fused forms: as many
   as B2's launches; no standalone B3 launch but the int8 prefill rows');
6. bf16 reference: a depth-cut copy of the model (full widths, 2 vision and
   2 decoder layers, random weights) on the card against the same weights
   in fp32 on the CPU, through prefill and rotating-window decode steps;
7. 8bit slice: the same traffic with int8 decoder weights, quantized on
   load (the llm.int8 prefill, the weight-only decode products) and the
   int8 KV cache; then the model round-trips through ``save_checkpoint``
   and ``model_id``, bitwise;
8. 8bit reference: the depth-cut copy with int8 decoder and vision weights
   and the int8 cache on the card against fp32 compute on the CPU;
9. 4bit slice: the same traffic with grouped int4 decoder weights, packed
   on load (B7's decode form at every decode product, its prefill form at
   the admissions' 1264 rows) and the bf16 KV cache;
10. 4bit reference: the depth-cut copy with int4 decoder and vision
    weights against fp32 compute on the CPU, through a 2-image prefill (B7's
    prefill form at 512 rows and more) and 3 decode steps, then a 1-image
    prefill (B7 at 256 and 316 rows, SigLIP fc2 at group 16 in the decode
    form: its 2,152-byte packed rows) and one decode step;
11. fp32 slice: ``create_model("paligemma", size="3b", device="cuda",
    model_id=<dir>)`` with its default quantization, fp32, through the fp32
    forms of B1, B2 and B4 (16 images, up to 8 new tokens);
12. fp32 reference: the depth-cut copy in fp32 on the card against the CPU
    (``REF_TOL_FP32``);
13. LLaVA bf16 slice (random weights, as BLIP-2's):
    ``create_model("llava", size="7b")`` (CLIP-L/336, the MLP projector,
    Vicuna-7B with its untied head; MHA, 32 heads of 128) in bf16, the
    same checks as PaliGemma's: 32 slots, 64 synthetic
    336 px images, BOS + 4 ids before the 576 image tokens and 60 ids
    after them (a prompt of 641), up to 32 new tokens;
14. LLaVA bf16 reference: the depth-cut copy (full width, 2 vision and 2
    decoder layers: the feature tap at -2 is then block 0's output); then
    the name maps: a depth-cut checkpoint of LLaVA's real key set (layers
    0-1, the new-style layout, fp16) loaded by ``load_vlm_weights`` on the
    card in bf16 and on the CPU in fp32, held together as the reference;
15. LLaVA 8bit slice: the JAX package's LLaVA recipe: int8 decoder
    weights with ``VLM_TPU_INT8_PREFILL=dynamic_noout`` (B6 at every
    admission product), the int8 KV cache, 16 slots, admission groups of
    4, the same traffic;
16. LLaVA 8bit reference (int8 decoder weights and cache); then the 4bit
    slice (grouped int4 decoder weights, the bf16 cache, 32 slots: B7 at
    every decode product and at the admissions' 2,564 rows, counted) and
    its reference; then the fp32 slice at full
    depth (28.3 GB of fp32 weights, 16 slots, 16 images, up to 8 new
    tokens: the fp32 forms of B1 at CLIP-L's D = 64 and Vicuna's D = 128
    and of B2 at G = 1) and its fp32 reference;
17. BLIP-2 bf16 slice: ``create_model("blip2", size="6.7b")`` (EVA ViT-g,
    the Q-Former through B1, OPT-6.7B with learned positions and its tied
    head; MHA, 32 heads of 128) in bf16 at full width and depth, the same
    checks: 32 slots, 64 synthetic 224 px images, the 32 query tokens then
    BOS + 59 ids (a prompt of 92), up to 32 new tokens;
18. BLIP-2 bf16 reference: the depth-cut copy (full width, 2 EVA and 2 OPT
    layers, the Q-Former at its full 12 layers); then the name maps from a
    depth-cut checkpoint of BLIP-2's real key set (the hub layout, fp32,
    the Q-Former whole), as LLaVA's;
19. BLIP-2 8bit slice: the JAX package's BLIP-2 recipe: int8 decoder and
    tower weights (``quantize_vision``) with
    ``VLM_TPU_INT8_PREFILL=dynamic_noout`` (B6 at every admission product),
    the int8 KV cache, 64 slots, admission groups of 8, the same traffic;
20. BLIP-2 8bit reference (int8 decoder and tower weights, the int8
    cache); the 4bit slice (int4 decoder and tower, ``quantize_vision``,
    32 slots: B7 at every decode product, at the OPT prefill's 368 rows
    and the tower's 1,028) and its reference (the
    1-image prefill takes B7 at EVA's 257 rows); and an fp32 reference
    (the fp32 forms of B1 at D = 88, 64 and 128 and of B2 at G = 1,
    D = 128). Every slice prints the fit check's ``param_bytes``, the
    card's memory and the bytes its build allocated, which must be the
    weights' bytes;
21. loader: which path decodes the serving phases' image files (the
    native C++ loader of ``vlm_tpu_torch/native``, built here with g++,
    libjpeg and libpng, or PIL with the build's error) and the host ms an
    image on both paths over the probing data's 384 JPEGs at 224 px
    (``warp``) and 336 px (``shortest_edge_crop``);
22. loop: PaliGemma-3B bf16 from the checkpoint through
    ``generate_dataset`` over the first 192 of them (at most 16 new tokens, 32
    slots), at the default loop (pipelined: one blocking read an admission
    cycle, none inside a chunk) and at ``sync_every=4``: the texts
    identical, no result None, no plain version; each loop's blocking reads
    (the batcher's own and the synchronizing operations CUDA's sync debug
    mode reports) and guarded steps an image, img/s, p50 and p99;
23. wave paligemma bf16: PaliGemma-3B from the checkpoint, bf16,
    ``generate_batch`` greedy over one wave of 32 synthetic images (the
    wave engine: one prefill, up to 32 new tokens); img/s, the prefill's
    and a step's wall and device ms (each profiled alone on the same
    inputs), steps run, peak memory; B1, B4 and B2 with B3's uniform
    fused write at a live column under ``kv_len`` on every decode step,
    no plain version;
24. beam paligemma 8bit: the 8bit slice's recipe (int8 weights, the
    int8 KV cache) with ``num_beams=4`` over 8 images (32 beam rows): B5
    at m = 32, B6 at the prefill, the int8 B2/B3; the same prints;
25. beam llava bf16: LLaVA-1.5-7B (random weights) with 4 beams over 8
    images, the same prints and the cache gather's device ms a step over
    the columns decode wrote, its share of the step, and over whole rows;
26. beam reference: a depth-cut LLaVA-1.5-7B (2+2 layers, full width)
    in fp32, 4 beams over 2 images, 16 tokens, card against CPU: the best
    tokens and lengths identical, scores within ``REF_TOL_FP32``;
27. cli wave: the port's CLI with ``continuous_batching: false`` and
    ``num_beams: 2`` (the shipped config otherwise), PaliGemma-3B bf16
    from the checkpoint, over 8 of the probing data's JPEGs laid out as a
    MiviaPar test split; its summary and files; then cli profile: the same
    on the continuous path with ``--profile``: the meter's line printed,
    the Chrome trace naming B1's, B2's and B4's kernels;
28. sweep: the port's ``compare_models`` on a copy of
    ``configs/compare_models.yaml`` with the three families in bf16, 8bit
    and 4bit at full size (random weights) over the same 8 JPEGs, 16 new
    tokens, 8 slots: nine rows without an error, each build allocating
    its ``param_bytes``, the device memory back to where the sweep began
    (within 64 MiB) after each model, B7 under LLaVA's and BLIP-2's 4bit
    rows, no plain version, each batcher at the slots, admission block,
    prompt length and new tokens of the kernel checks' sweep cases; each
    row's img/s, peak memory and build seconds;
29. probe cache: single-task probing of LLaVA-1.5-7B's CLIP-L/336 tower in
    fp32 (``configs/train_probe.yaml``'s single profile, random weights)
    through the port's ``train_probe`` entry point on a synthetic face
    dataset of 336 px JPEGs (256 train, 64 val, 64 test images, task age)
    in a temporary project root: the decoder dropped, the features
    extracted by B4's and B1's fp32 forms, the head trained for 2 epochs;
30. probe e2e: the same data with the multi profile's backbone block (the
    last 4 blocks and the embeddings unfrozen) at batch 32 for an epoch and
    its validation: B1's differentiable form in every block of every step
    (the fp32 backward kernel, no recompute),
    blocks 20-23 and the embeddings changed, blocks 0-19 bitwise as built;
31. probe test: the port's ``test_probe`` on that checkpoint: preds, gts
    and metrics written, the preds the probe's own argmax;
32. probe reference: a depth-cut CLIP-L (2 blocks, full width) and a
    linear head, one end-to-end step with the last block unfrozen, card
    against CPU in fp32: loss and gradients within ``REF_TOL_FP32``;
33. probe multi: ``train_probe --profile multi`` (age, gender and emotion
    over one tower, augmentation and the weighted sampler, the 0.33
    emotion balancing: 256 train rows, 51 with emotion, 50 duplicates;
    the profile's backbone block) at batch 32 for 2 epochs, the second on
    the loss EMA's task weights: B1's differentiable form in every block
    of every step, blocks 20-23 and the embeddings changed, blocks 0-19
    bitwise as built; then a few more steps under the profiler (the
    device's busy share);
34. probe lora: the single profile with ``lora.enabled`` (rank 8, alpha
    16, the last 2 blocks' attention) and the tower frozen, at batch 32
    for an epoch: B1's differentiable form in blocks 22-23 only, every
    base weight bitwise as built, every adapter's B moved off zero, a
    checkpoint of the adapters and no tower;
35. probe multi test: ``test_probe --profile multi`` on the multi
    checkpoint (preds, gts and metrics per task, the preds each head's own
    argmax) and the single tester on the LoRA checkpoint (the adapters
    merged at load: no differentiable form);
36. probe multi reference: a depth-cut CLIP-L (2 blocks, full width), three
    heads, LoRA on the last block (A and B drawn nonzero) and uncertainty
    weighting, one step card against CPU in fp32: the loss and the
    gradients of A, B, the log-variances and the heads within
    ``REF_TOL_FP32``.

Between the generation phases and the sweep, the mesh phases:
PaliGemma-3B from the checkpoint through ``generate_dataset`` over 16
probing JPEGs (32 slots, 16 new tokens) on one GPU, then under a mesh of
two ranks (``vlm_tpu_torch/testing/mesh_serve.py`` on ranks launched
once under ``python -m torch.distributed.run`` by
``vlm_tpu_torch/testing/mesh_pool.py``, which take every mesh phase in
turn, each run with its own timeout; one GPU a rank over NCCL where the
machine has them, else both sharing the GPU over gloo):
``[mesh paligemma bf16 model=2]`` (shard-on-load, the vocabulary-parallel
head), ``[mesh paligemma 8bit model=2]`` (the 8bit slice's recipe with
the int8 cache: B5 and B6 at the shard shapes, the row abs-max over the
model group) and ``[mesh paligemma bf16 data=2]`` (16 slots a rank; then
``[beam mesh data=2]`` on the same model: 4 beams over 8 images, 16 new
tokens, tokens and lengths identical to the same call on one GPU). Each
prints the backend and devices, each rank's
``param_bytes`` (what its build left allocated must equal it within 1 %),
peak memory and launches (every kernel of the plan at its count, no plain
version), img/s marked "not a scaling figure" when the ranks share a
GPU, and how many texts equal the single-GPU run's; the texts must be the
same on every rank and the data ranks' slots must serve every image once.
Then ``[mesh reference bf16|8bit|fp32]``: a depth-cut copy (2 + 2 layers)
over ``model=2`` on the card against fp32 on the CPU (``REF_TOL``, and
``REF_TOL_FP32`` for fp32); in the bf16 one's run, ``[mesh row-parallel]``:
Gemma's o product (2048 -> 2048, 1024 inputs a rank) in bf16, int8 and
int4 at 32 and 1264 rows against the same layer whole on the rank, on
inputs whose halves of K nearly cancel, within one of the output's bf16
steps (a rank's partial rounded to bf16 before the all-reduce misses by
several).

Then the mesh beyond serving, each phase against the same work on one GPU
in this process, two ranks sharing the GPU over gloo (``mesh_probe.py``
and ``mesh_serve.py`` on the same two ranks; one run at ``data=2`` and one
at ``model=2`` carry the probing phases), on LLaVA-1.5-7B's
CLIP-L/336 tower in fp32 (random weights from the model's seed) and a
synthetic face dataset of 336 px JPEGs (48 train, 16 val, 16 test):
``[probe mesh cache data=2|model=2]`` (64 of the probing JPEGs through
``extract_features_dataset`` at batch 16: features within 1e-3 relative),
``[probe mesh e2e data=2|model=2]`` (3 steps of 16, the last 4 blocks and
the embeddings trained: each step's loss within 1e-3 relative, B1's fp32
and differentiable forms at their plan's counts, no plain call),
``[probe mesh multi data=2]`` (the multi profile, 2 steps of 24),
``[probe mesh lora model=2]`` (2 steps of 24: the adapters identical on
both ranks), ``[probe mesh test data=2]`` (the single tester on the
one-GPU e2e checkpoint: metrics equal), ``[mesh int8 tower model=2]`` and
``[mesh int4 tower model=2]`` (PaliGemma-3B's SigLIP from the checkpoint
split unevenly over the ranks, 16 images at batches of 8 and of 1: B6 and
B5, or B7, at K = 2144 and 2160, fc2's 2160 at batch 8 on the dequantized
product, ``dense_int4``'s gate; features within ``REF_TOL``). Each
prints its seconds,
img/s or step ms, each rank's peak memory and rank 0's collectives.

Each slice's launch counts are set to 0 just before it is driven and read
just after. Each phase prints its seconds.

Prints a JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SLOTS, N_IMAGES, PROMPT_IDS, NEW = 32, 64, 60, 32
# each model's slice: its label, size, image side, the ids before the image
# tokens (LLaVA: BOS + "USER: ", 5 ids) and the slots of each mode (the
# batcher admits 4 at a time at 16 and 32 slots, 8 at 64); the 60 prompt
# ids come after the image tokens (PaliGemma's and BLIP-2's start with
# BOS). The 8bit recipe: ``VLM_TPU_INT8_PREFILL`` (None: the default,
# ``dynamic``) and whether the 8bit and 4bit slices quantize the tower
# (``quantize_vision``); ``ref_vision``: whether the 8bit and 4bit
# references quantize the tower
MODELS = {
    "paligemma": dict(label="PaliGemma-3B", size="3b", image=224,
                      pre_ids=0, slots={}, int8_prefill=None,
                      quantize_vision=False, ref_vision=True),
    "llava": dict(label="LLaVA-1.5-7B", size="7b", image=336, pre_ids=5,
                  slots={"8bit": 16, "fp32": 16},
                  int8_prefill="dynamic_noout",
                  quantize_vision=False, ref_vision=False),
    "blip2": dict(label="BLIP-2 OPT-6.7B", size="6.7b", image=224,
                  pre_ids=0, slots={"8bit": 64},
                  int8_prefill="dynamic_noout", quantize_vision=True,
                  ref_vision=True),
}
# bf16 on the card vs fp32 on the CPU, relative to max|ref|; the 8bit model
# quantizes activations from bf16 on the card and from fp32 on the CPU, so
# one int8 step (1/127 of a row's abs-max) can flip where they differ
REF_TOL = 5e-2
# fp32 on both sides (no TF32 on the card): only the order of the sums
# differs
REF_TOL_FP32 = 1e-3
# the fp32 slice: fewer images and tokens (fp32 weights stream twice the
# bytes of bf16's, and the mode is for correctness)
FP32_IMAGES, FP32_NEW = 16, 8
# the vendored key manifests of the real checkpoints
MANIFESTS = {"paligemma": "paligemma-3b-mix-224.json",
             "llava": "llava-1.5-7b-hf.json",
             "blip2": "blip2-opt-6.7b.json"}
# the depth-cut checkpoints of LLaVA and BLIP-2: their layout (LLaVA's
# new-style roots in fp16, BLIP-2's hub names in fp32)
CKPT_LAYOUTS = {"llava": "new_style", "blip2": "hub"}
# the launch counters each slice must move (ops._lib.KERNELS); the second
# entry is B2's form, the third B3's write inside it
PATH_KERNELS = {
    "bf16": ("flash_attention", "decode_attention", "kv_write_fused",
             "normalize"),
    "8bit": ("flash_attention", "decode_attention_int8",
             "kv_write_int8_fused", "kv_write_int8", "normalize",
             "int8_matmul", "int8xint8_matmul"),
    "4bit": ("flash_attention", "decode_attention", "kv_write_fused",
             "normalize", "int4_matmul"),
    "fp32": ("flash_attention_fp32", "decode_attention_fp32",
             "kv_write_fused", "normalize_fp32"),
}


def device_phase(torch):
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return gpu.splitlines()[0]


def kernel_phase(gpu):
    from vlm_tpu_torch.testing import kernel_checks
    spent = {}
    records = kernel_checks.run("cuda", iters=20, spent=spent)
    print(f"[time] kernel checks: {len(records)} cases, "
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    t0 = time.perf_counter()
    diff = kernel_checks.run_diff("cuda", iters=10) + kernel_checks.run_diff(
        "cuda", iters=10, shape=kernel_checks.MESH_DIFF_SHAPE) + \
        kernel_checks.run_diff_bwd("cuda", iters=10)
    print(f"[time] B1-diff checks: {len(diff)} cases, "
          f"{time.perf_counter() - t0:.1f} s")
    for r in diff:
        if "fwd_ms" in r:
            print(f"[kernel] B1-diff {r['case']}: forward {r['fwd_ms']:.4f} "
                  f"ms (profiled {r['fwd_device_ms']}, bound "
                  f"{r['fwd_bound_ms']:.4f} by {r['fwd_bound_by']}), "
                  f"backward {r['bwd_ms']:.4f} ms (profiled "
                  f"{r['bwd_device_ms']}, bound {r['bwd_bound_ms']:.4f} by "
                  f"{r['bwd_bound_by']}); the forward against the "
                  f"no-gradient call {r['exact_err']:.3e} (bitwise) ({gpu})")
        else:
            lib_err = "n/a" if r["library_err"] is None else \
                f"{r['library_err']:.3e}"
            print(f"[kernel] B1-diff backward {r['case']}: {r['ms']:.4f} ms "
                  f"(profiled {r['device_ms']}), bound {r['bound_ms']:.4f} "
                  f"by {r['bound_by']} (share "
                  f"{r['bound_ms'] / r['ms']:.1%}), the recompute "
                  f"{r['plain_ms']:.4f} ms, SDPA backward "
                  f"{r['library_ms']:.4f} ms (profiled "
                  f"{r['library_device_ms']}), SDPA forward + backward "
                  f"{r['library_both_ms']:.4f} ms (err {lib_err}); against "
                  f"the recompute {r['max_abs_err']:.3e}, the float64 "
                  f"formulation {r['render_err']:.3e}, a second run "
                  f"{r['exact_err']:.3e} (bitwise), lse {r['lse_err']:.3e} "
                  f"({gpu})")
    records += diff
    for r in records:
        tol = f"{r['tol']:.1e}" + (" x max|plain|" if r["rel"] else "")
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        if r["library_err"] is not None:
            lib += (f" (err {r['library_err']:.3e}"
                    f"{'' if r['library_ok'] else ', outside tol'})")
        dev = " ".join(
            f"{k} {'null' if r[k] is None else f'{r[k]:.4f}'}"
            for k in ("device_ms", "library_device_ms")
            + (("baseline_device_ms",) if r["baseline_device_ms"] is not None
               else ()))
        if r["exact_err"] is not None:
            against = "a second run" if r["form"].endswith("_bwd") else \
                "the no-gradient call" if r["kernel"] == "B1-diff" \
                else "the unfused kernels"
            dev += f", vs {against} {r['exact_err']:.3e} (bitwise)"
        print(f"[kernel] {r['kernel']} {r['case']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {tol}) kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"profiled {dev}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (share "
              f"{r['bound_ms'] / r['ms']:.1%}), library {lib} "
              f"[{r['library_note']}] [{'ok' if r['ok'] else 'FAIL'}] "
              f"({gpu})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")
    return records


def prompt_ids(np, rng, dec, pre_ids):
    """The ids before the image tokens (BOS first) and the 60 after them
    (BOS first where nothing comes before the image)."""
    def ids(n, bos):
        return np.concatenate([[dec.bos_token_id] if bos else [],
                               rng.integers(3, dec.vocab_size,
                                            n - bos)]).astype(np.int32)
    return (ids(pre_ids, True) if pre_ids else np.zeros((0,), np.int32),
            ids(PROMPT_IDS, not pre_ids))


@contextlib.contextmanager
def int8_prefill(model_name, quantization):
    """``VLM_TPU_INT8_PREFILL`` while the model's int8 layers are built
    (they read it then): LLaVA's and BLIP-2's 8bit recipes take
    ``dynamic_noout``, which it yields; other slices keep the default
    (``dynamic``) and get None."""
    mode = MODELS[model_name]["int8_prefill"] if quantization == "8bit" \
        else None
    if mode:
        os.environ["VLM_TPU_INT8_PREFILL"] = mode
    try:
        yield mode
    finally:
        if mode:
            del os.environ["VLM_TPU_INT8_PREFILL"]


def slice_phase(torch, np, gpu, quantization, n_images=N_IMAGES, new=NEW,
                model_name="paligemma", model_id=None, round_trip=None):
    """Serve ``model_name``'s recipe with ``quantization`` "bf16", "8bit"
    (with the int8 KV cache), "4bit", or "fp32" (the model's default, so
    not passed); with ``model_id``, the weights come from that checkpoint
    directory (its load timed and its peak memory bounded); with
    ``round_trip`` (a directory), the served model is then saved there in
    the port's format and loaded back (:func:`round_trip_phase`). Returns
    the launch counts of the timed run and the slice's numbers."""
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import normalize_images

    spec = MODELS[model_name]
    slots = spec["slots"].get(quantization, SLOTS)
    tag = f"[slice {quantization}]" if model_name == "paligemma" else \
        f"[slice {model_name} {quantization}]"
    kw = {} if quantization == "fp32" else dict(
        quantization=quantization,
        kv_cache="int8" if quantization == "8bit" else None,
        quantize_vision=quantization in ("8bit", "4bit")
        and spec["quantize_vision"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    before = device_bytes(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with int8_prefill(model_name, quantization) as mode:
        model = create_model(model_name, size=spec["size"], device="cuda",
                             seed=0, model_id=model_id, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in model.module.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in
                  (*model.module.parameters(), *model.module.buffers()))
    print(f"{tag} {spec['label']} built: {n_params} params, {n_bytes} "
          f"bytes, KV cache {model.cache_dtype}, {slots} slots"
          f"{', int8 prefill ' + mode if mode else ''}"
          f"{', int8 tower' if model.quantize_vision else ''}, "
          f"{build_s:.1f} s ({gpu})")
    if model_id is not None:
        load_report(tag, model_id, build_s, load_peak, n_bytes, gpu)
    fit_report(torch, tag, model, before, gpu)
    cfg = model.cfg
    dec = cfg.decoder
    rng = np.random.default_rng(0)
    side = spec["image"]
    images = rng.integers(0, 256, (n_images, side, side, 3), dtype=np.uint8)
    pre_ids, post_ids = prompt_ids(np, rng, dec, spec["pre_ids"])
    prompt_len = len(pre_ids) + num_image_tokens(cfg) + PROMPT_IDS
    caps = rng.integers(min(8, new), new + 1, n_images)

    def pixel_fn(idxs):
        u8 = torch.from_numpy(images[idxs]).to("cuda", non_blocking=True)
        return normalize_images(u8, recipe=model.recipe,
                                compute_dtype=model.dtype,
                                patch_size=cfg.vision.patch_size)

    def batcher():
        return ContinuousBatcher(model.module, cfg, batch_size=slots,
                                 max_prompt_len=prompt_len,
                                 max_new_tokens=new,
                                 cache_dtype=model.cache_dtype)

    run_kw = dict(pre_ids_row=pre_ids, post_ids_row=post_ids,
                  prompt_len_scalar=prompt_len)
    batcher().run(pixel_fn, n_images=8, max_new_per_image=[4] * 8,
                  **run_kw)                                   # warm-up
    torch.cuda.synchronize()

    b = batcher()
    _lib.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = b.run(pixel_fn, n_images=n_images, max_new_per_image=caps,
                **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_lib.launches)
    plain = dict(_lib.plain_calls)

    if any(o is None for o in out):
        raise RuntimeError("some images returned no tokens")
    over = [i for i, o in enumerate(out) if len(o) > caps[i]]
    if over:
        raise RuntimeError(f"images {over} exceed their caps")
    toks = [t for o in out for t in o]
    if any(not 0 <= t < dec.vocab_size for t in toks):
        raise RuntimeError("token ids out of the vocabulary")
    idle = [k for k in PATH_KERNELS[quantization] if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the path: {idle} "
                           f"({launches})")
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the path: {plain}")
    # the decode steps write only inside B2's launch: one fused write a B2
    # launch, and standalone B3 only for the int8 prefill rows (one launch
    # a layer an admission)
    b2_form, fused_form = PATH_KERNELS[quantization][1:3]
    prefill_rows = dec.layers * b.last_stats["admits"] \
        if quantization == "8bit" else 0
    # a guarded step (dispatched past its chunk's stop, taking no effect)
    # runs the whole decode forward: launches follow dispatched steps
    dispatched = b.last_stats["steps"] + b.last_stats["guarded_steps"]
    if (launches[fused_form] != launches[b2_form] or launches["kv_write"]
            or launches["kv_write_int8"] != prefill_rows
            or launches[b2_form] != dec.layers * dispatched):
        raise RuntimeError(f"KV writes outside B2's launch: {launches} "
                           f"(int8 prefill rows: {prefill_rows}, "
                           f"{dispatched} steps dispatched)")
    if quantization == "4bit":
        groups = [min(b.admit_block, n_images - i)
                  for i in range(0, n_images, b.admit_block)]
        want = int4_launches(cfg, model.quantize_vision, dispatched, groups)
        if b7_launches(launches) != want:
            raise RuntimeError(f"{tag} B7 launched {b7_launches(launches)}"
                               f" times, not the {want} decode and "
                               f"admission products")
    lat = np.asarray(b.last_latency_s) * 1e3
    print(f"{tag} prompt {prompt_len} ids ({len(pre_ids)} + "
          f"{num_image_tokens(cfg)} image + {len(post_ids)}), "
          f"{b.last_stats['admits']} admissions of {b.admit_block}, "
          f"{b.last_stats['steps']} decode steps (and "
          f"{b.last_stats['guarded_steps']} guarded), "
          f"{b.last_stats['blocking_reads']} blocking reads")
    print(f"{tag} {n_images} images, {len(toks)} tokens in {wall:.3f} s: "
          f"{n_images / wall:.3f} img/s, {len(toks) / wall:.1f} tok/s "
          f"({gpu})")
    print(f"{tag} latency p50 {np.percentile(lat, 50):.1f} ms p99 "
          f"{np.percentile(lat, 99):.1f} ms ({gpu})")
    print(f"{tag} max_memory_allocated {peak / 2**30:.2f} GiB ({gpu})")
    print(f"{tag} launches {launches}, plain calls {plain}, "
          f"loop {b.last_stats}")

    # finite next-token logits of the expected shape at full size
    with torch.inference_mode():
        from vlm_tpu_torch.models.decoder import init_kv_cache
        g = 4
        cache = init_kv_cache(dec, g, prompt_len, model.cache_dtype, "cuda")
        pre, ids = (torch.from_numpy(t).cuda()[None].expand(g, -1)
                    for t in (pre_ids, post_ids))
        logits = model.module.prefill(
            pixel_fn(list(range(g))), pre, ids, cache,
            torch.full((g,), prompt_len, dtype=torch.int32, device="cuda"))
    if logits.shape != (g, dec.vocab_size) or not torch.isfinite(
            logits).all():
        raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")
    del cache, logits
    if round_trip is not None:
        round_trip_phase(torch, gpu, model, round_trip)
    del model
    torch.cuda.empty_cache()
    return launches, dict(wall_s=wall, img_per_s=n_images / wall,
                          p50_ms=float(np.percentile(lat, 50)),
                          p99_ms=float(np.percentile(lat, 99)),
                          peak_gib=peak / 2**30)


def load_report(tag, model_id, seconds, peak, model_bytes, gpu):
    """Print a checkpoint load's seconds, GB/s (bytes of the files) and
    the device memory it took beyond what was allocated before it; fail if
    that passes the model's own bytes plus two fp32 copies of the
    checkpoint's largest tensor (the one being written, and its cast or
    quantized form)."""
    from vlm_tpu_torch.utils.safetensors_io import open_dir
    refs = open_dir(model_id).values()
    file_bytes = sum(Path(f).stat().st_size for f in {r.path for r in refs})
    largest = max(math.prod(r.shape) for r in refs) * 4
    bound = model_bytes + 2 * largest
    print(f"{tag} load from {len({r.path for r in refs})} safetensors files "
          f"({file_bytes / 1e9:.2f} GB): {seconds:.2f} s, "
          f"{file_bytes / 1e9 / seconds:.2f} GB/s, max_memory_allocated "
          f"during the load {peak / 1e9:.2f} GB (model {model_bytes / 1e9:.2f}"
          f" GB + 2 x {largest / 1e9:.2f} GB = {bound / 1e9:.2f}) ({gpu})")
    if peak > bound:
        raise RuntimeError(f"the load took {peak} bytes of device memory, "
                           f"more than {bound}")


def device_bytes(torch):
    """(bytes the live tensors asked the allocator for, bytes of its
    blocks that hold them): the second rounds a tensor up to its block
    (by up to 1 MiB above 10 MiB)."""
    return (torch.cuda.memory_stats()["requested_bytes.all.current"],
            torch.cuda.memory_allocated())


# the allocator's blocks above the bytes a build's tensors ask for, at
# most (a share of ``param_bytes``): the margin the fit check leaves out
BLOCK_ROUNDING = 0.02


def fit_report(torch, tag, model, before, gpu):
    """Print the fit check's weights bytes (``param_bytes``, the module on
    ``meta``), the card's memory and the bytes the build allocated since
    ``before`` (:func:`device_bytes`); fail unless the tensors it asked
    for are the weights' bytes within 1 % and the allocator's blocks hold
    them within ``BLOCK_ROUNDING`` more."""
    from vlm_tpu_torch.models.vlm import device_memory_limit, param_bytes
    bits = model.policy.quantized_bits
    want = param_bytes(model.cfg, dtype=model.dtype, quant_bits=bits,
                       vision_quant_bits=bits if model.quantize_vision else 0)
    limit = device_memory_limit("cuda")
    asked, blocks = (b - a for a, b in zip(before, device_bytes(torch)))
    print(f"{tag} param_bytes {want} ({want / 1e9:.2f} GB), device limit "
          f"{limit} ({limit / 2**30:.2f} GiB), the build allocated {asked} "
          f"bytes ({blocks} in the allocator's blocks) ({gpu})")
    if abs(asked - want) > want / 100:
        raise RuntimeError(f"{tag} the build allocated {asked} bytes, "
                           f"param_bytes says {want}")
    if blocks - asked > BLOCK_ROUNDING * want:
        raise RuntimeError(f"{tag} the allocator's blocks hold {blocks} "
                           f"bytes for {asked} requested")


def b7_launches(launches):
    """B7's launches, its decode and prefill forms together."""
    return launches["int4_matmul"] + launches["int4_matmul_prefill"]


def int4_launches(cfg, tower, steps, groups):
    """B7's launches in a 4bit run: every decode step's decoder products
    and every admission's (and the tower's, when it is quantized), less
    the products ``dense_int4`` gives the dequantized product (the
    tower's fc2 at K % 32 != 0 from 1,536 rows)."""
    from vlm_tpu_torch.ops.quant import int4_dequant_gate
    dec = (7 if cfg.decoder.gated_mlp else 6) * cfg.decoder.layers

    def tower_products(images):
        rows = images * cfg.vision.seq_len
        return (5 + (not int4_dequant_gate(rows, cfg.vision.mlp_dim))) \
            * cfg.vision.layers
    return dec * (steps + len(groups)) + sum(
        tower_products(g) for g in groups if tower)


# the references' passes, (images, decode steps), by weight bits: 4bit
# adds a 1-image prefill, where B7 takes the prefill's products
REF_PASSES = {0: ((2, 3),), 4: ((2, 3), (1, 1))}


def reference_phase(torch, np, gpu, quantization, model_name="paligemma",
                    ckpt=None):
    """Full-width, depth-cut model (2 vision and 2 decoder layers; BLIP-2's
    Q-Former at its full 12): bf16 kernels on the card against fp32
    plain versions on the CPU, same weights, same inputs. "8bit": int8
    decoder weights (PaliGemma's and BLIP-2's vision weights too, as
    PaliGemma's reference always had and BLIP-2's recipe has; LLaVA's
    tower stays bf16, as its recipe) and the int8 KV cache on both sides. "4bit": int4 decoder and vision weights,
    and a 1-image prefill after the 2-image one, so that B7 takes the
    prefill's products too. "fp32": the fp32 kernels on the card, within
    ``REF_TOL_FP32``. With ``ckpt`` (a depth-cut HF checkpoint), both
    modules are filled from it by ``load_vlm_weights`` instead (the card's
    in its compute dtype, the CPU's in fp32)."""
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.hf_weights import load_vlm_weights
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES

    spec = MODELS[model_name]
    full = VLM_CONFIGS[model_name](spec["size"])
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        decoder=dataclasses.replace(full.decoder, layers=2))
    bits = {"8bit": 8, "4bit": 4}.get(quantization, 0)
    quant = dict(quant_bits=bits,
                 vision_quant_bits=bits if spec["ref_vision"] else 0)
    card = torch.float32 if quantization == "fp32" else torch.bfloat16
    tol = REF_TOL_FP32 if quantization == "fp32" else REF_TOL
    cache_dtypes = {"cuda": card, "cpu": torch.float32}
    if bits == 8:
        cache_dtypes = dict.fromkeys(cache_dtypes, "int8")
    with int8_prefill(model_name, quantization):
        gpu_mod = VLMModule(cfg, dtype=card, device="cuda", **quant)
        cpu_mod = VLMModule(cfg, dtype=torch.float32, device="cpu", **quant)
    if ckpt is None:
        init_random_(gpu_mod, seed=1)
        # integer weights stay as they are; floating tensors widen to fp32
        cpu_mod.load_state_dict({
            k: (v.float() if v.is_floating_point() else v).cpu()
            for k, v in gpu_mod.state_dict().items()})
    else:
        for mod in (gpu_mod, cpu_mod):
            load_vlm_weights(model_name, cfg, ckpt, mod)
    rng = np.random.default_rng(1)
    n_pre = spec["pre_ids"]
    plen = n_pre + num_image_tokens(cfg) + PROMPT_IDS
    recipe = RECIPES[model_name]
    side = spec["image"]
    worst = 0.0
    # (images, decode steps): the 1-image prefill is there for B7 at the
    # prefill's products, so one decode step follows it
    for b, steps in REF_PASSES[4 if bits == 4 else 0]:
        u8 = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3),
                                           dtype=np.uint8))
        pre, post = (torch.from_numpy(rng.integers(3, 1000, (b, n),
                                                   dtype=np.int32))
                     for n in (n_pre, PROMPT_IDS))
        _lib.reset_counts()
        worst = max(worst, _compare(torch, gpu_mod, cpu_mod, cfg, u8, pre,
                                    post, plen, steps, cache_dtypes, recipe,
                                    card))
        if bits == 4 and not b7_launches(_lib.launches):
            raise RuntimeError("B7 never launched in the 4bit reference")
        idle = [k for k in PATH_KERNELS["fp32"]
                if not _lib.launches[k]] if quantization == "fp32" else []
        if idle:
            raise RuntimeError(f"{idle} never launched in the fp32 reference")
        if bits == 8 and not _lib.launches["int8xint8_matmul"]:
            raise RuntimeError("B6 never launched in the 8bit reference")
    _lib.reset_counts()
    name = "reference" if model_name == "paligemma" else \
        f"reference {model_name}"
    if ckpt is not None:
        name = f"checkpoint {model_name}"
    qformer = f", Q-Former {cfg.qformer.layers} layers" if cfg.qformer \
        else ""
    passes = ", then ".join(f"{b} image{'s' * (b > 1)}: prefill + {n} "
                            f"decode step{'s' * (n > 1)}"
                            for b, n in REF_PASSES[4 if bits == 4 else 0])
    print(f"[{name} {quantization}] depth-cut {spec['label']} (2+2 layers"
          f"{qformer}, full width): {passes}, max |card - cpu| / "
          f"max|cpu| = {worst:.3e} (tol {tol:.0e}) ({gpu})")
    if worst > tol:
        raise RuntimeError("card disagrees with the CPU reference")


def checkpoint_write_phase(torch, gpu, model_name, path, layout="hub",
                           layers=None):
    """Write a synthetic checkpoint of ``model_name`` into ``path`` in three
    shards: the key set, shapes and dtypes of the real one's ``layout``
    (``tests/goldens/manifests``), depth-cut to ``layers`` tower and
    decoder layers when given, values drawn from a seed on the card."""
    from vlm_tpu_torch.testing.checkpoints import (depth_cut,
                                                   write_synthetic_checkpoint)
    doc = json.loads((ROOT / "tests" / "goldens" / "manifests" /
                      MANIFESTS[model_name]).read_text())
    manifest = doc[layout]
    if layers is not None:
        manifest = depth_cut(manifest, layers)
    t0 = time.perf_counter()
    n = write_synthetic_checkpoint(manifest, path, shards=3, seed=0,
                                   device="cuda")
    dt = time.perf_counter() - t0
    dtypes = sorted({m["dtype"] for m in manifest.values()})
    print(f"[checkpoint {model_name}] wrote {len(manifest)} tensors "
          f"({layout} layout of {doc['checkpoint']}"
          f"{f', layers 0-{layers - 1}' if layers else ''}, {dtypes}), "
          f"{n / 1e9:.2f} GB in 3 shards: {dt:.1f} s, {n / 1e9 / dt:.2f} GB/s"
          f" ({gpu})")


# Denses whose quantize-on-load is held against the CPU: (the port's
# module, the HF weight it is quantized from); SigLIP's fc2 (in 4304) takes
# int4 group 16, every other int4 Dense here group 128
QUANT_SAMPLE = [
    ("vision.blocks.0.attn.q_proj",
     "vision_tower.vision_model.encoder.layers.0.self_attn.q_proj.weight"),
    ("vision.blocks.0.fc1",
     "vision_tower.vision_model.encoder.layers.0.mlp.fc1.weight"),
    ("vision.blocks.1.fc2",
     "vision_tower.vision_model.encoder.layers.1.mlp.fc2.weight"),
] + [(f"decoder.blocks.{i}.{ours}",
      f"language_model.model.layers.{i}.{ours.replace('attn', 'self_attn')}"
      f".weight")
     for i, ours in ((0, "attn.q_proj"), (0, "attn.k_proj"),
                     (0, "attn.v_proj"), (1, "attn.o_proj"),
                     (1, "mlp.gate_proj"), (1, "mlp.up_proj"),
                     (1, "mlp.down_proj"))]


def quantize_on_load_phase(torch, gpu, ckpt):
    """Load a depth-cut PaliGemma-3B (2+2 layers, full width, the tower
    quantized too) from ``ckpt`` on the card in 8bit and in 4bit, and hold
    the ``q`` and ``scale`` of the sampled Denses bitwise against
    ``quantize_int8`` / ``quantize_int4`` of the same file tensors on the
    CPU."""
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.hf_weights import load_vlm_weights
    from vlm_tpu_torch.models.vlm import VLMModule
    from vlm_tpu_torch.ops.quant import quantize_int4, quantize_int8
    from vlm_tpu_torch.utils.safetensors_io import open_dir
    full = VLM_CONFIGS["paligemma"]("3b")
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        decoder=dataclasses.replace(full.decoder, layers=2))
    refs = open_dir(ckpt)
    for bits in (8, 4):
        t0 = time.perf_counter()
        mod = load_vlm_weights("paligemma", cfg, ckpt, VLMModule(
            cfg, dtype=torch.bfloat16, device="cuda", quant_bits=bits,
            vision_quant_bits=bits))
        torch.cuda.synchronize()
        bad, groups = [], set()
        for name, key in QUANT_SAMPLE:
            dense = mod.get_submodule(name)
            w = refs[key].load().float()
            want = quantize_int4(w, dense.group_size) if bits == 4 else \
                quantize_int8(w)
            groups.add(dense.group_size)
            if not (torch.equal(dense.q.cpu(), want.q)
                    and torch.equal(dense.scale.cpu(), want.scale)):
                bad.append(name)
        dt = time.perf_counter() - t0
        print(f"[quantize-on-load int{bits}] {len(QUANT_SAMPLE)} Denses of a "
              f"depth-cut PaliGemma-3B loaded on the card ({dt:.1f} s"
              f"{f'; groups {sorted(groups)}' if bits == 4 else ''}): q and "
              f"scale "
              f"{'bitwise equal to' if not bad else 'DIFFER from'} the CPU's "
              f"quantization of the file tensors{bad or ''} ({gpu})")
        if bad:
            raise RuntimeError(f"quantize-on-load differs from the CPU: {bad}")
        del mod
    torch.cuda.empty_cache()


def round_trip_phase(torch, gpu, model, path):
    """Save ``model`` in the port's own format and load it back through
    ``model_id``: every tensor of the state bitwise equal."""
    from vlm_tpu_torch.models.factory import create_model
    t0 = time.perf_counter()
    model.save_checkpoint(path)
    saved = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = create_model(model.family, size=MODELS[model.family]["size"],
                        device="cuda",
                        model_id=str(path), quantization=model.quantization,
                        kv_cache=model.kv_cache,
                        quantize_vision=model.quantize_vision)
    torch.cuda.synchronize()
    loaded = time.perf_counter() - t0
    own = model.module.state_dict()
    bad = [k for k, t in back.module.state_dict().items()
           if t.dtype != own[k].dtype or not torch.equal(t, own[k])]
    size = (Path(path) / "params.safetensors").stat().st_size
    print(f"[round trip {model.quantization}] save_checkpoint "
          f"{size / 1e9:.2f} GB in {saved:.1f} s ({size / 1e9 / saved:.2f} "
          f"GB/s), back through model_id in {loaded:.1f} s "
          f"({size / 1e9 / loaded:.2f} GB/s): {len(own)} tensors, "
          f"{'bitwise equal' if not bad else f'{len(bad)} differ'} ({gpu})")
    if bad:
        raise RuntimeError(f"the round trip changed {bad[:10]}")
    del back
    shutil.rmtree(path)
    torch.cuda.empty_cache()


def _compare(torch, gpu_mod, cpu_mod, cfg, u8, pre, post, plen, steps,
             cache_dtypes, recipe, card_dtype):
    """Prefill ``u8`` and ``steps`` rotating-window decode steps on both
    modules; the worst max |card - cpu| / max |cpu| over the logits."""
    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.ops.preprocess import normalize_images
    b = u8.shape[0]
    worst = 0.0
    with torch.inference_mode():
        runs = {}
        for dev, mod, dtype in (("cuda", gpu_mod, card_dtype),
                                ("cpu", cpu_mod, torch.float32)):
            cache = init_kv_cache(cfg.decoder, b, plen + steps,
                                  cache_dtypes[dev], dev)
            pl = torch.full((b,), plen, dtype=torch.int32, device=dev)
            px = normalize_images(u8.to(dev), recipe=recipe,
                                  compute_dtype=dtype,
                                  patch_size=cfg.vision.patch_size)
            runs[dev] = dict(cache=cache, pl=pl, logits=[mod.prefill(
                px, pre.to(dev), post.to(dev), cache, pl).float().cpu()])
        for step in range(steps):
            tok = runs["cuda"]["logits"][-1].argmax(-1).int()
            for dev, mod in (("cuda", gpu_mod), ("cpu", cpu_mod)):
                r = runs[dev]
                i32 = dict(dtype=torch.int32, device=dev)
                window = (torch.tensor(plen, **i32), steps,
                          torch.zeros(b, **i32),
                          torch.full((b,), step + 1, **i32))
                r["logits"].append(mod.decode_step(
                    tok.to(dev)[:, None], r["pl"] + step, r["cache"],
                    write_col=torch.tensor(plen + step, **i32),
                    kv_window=window).float().cpu())
        for got, ref in zip(runs["cuda"]["logits"], runs["cpu"]["logits"]):
            if not torch.isfinite(got).all():
                raise RuntimeError("non-finite logits on the card")
            worst = max(worst, float((got - ref).abs().max()
                                     / ref.abs().max()))
    return worst


def run_phases(torch, np, gpu, launches, tmp, pali):
    """The checkpoint phases, the slices and the references, adding each
    slice's launch counts into ``launches``. PaliGemma's four slices load
    their weights from a synthetic full-size checkpoint written to
    ``pali``; LLaVA's and BLIP-2's name maps run on depth-cut checkpoints
    in ``tmp``."""
    t0 = time.perf_counter()
    checkpoint_write_phase(torch, gpu, "paligemma", pali)
    quantize_on_load_phase(torch, gpu, pali)
    print(f"[time] checkpoint paligemma {time.perf_counter() - t0:.1f} s")
    # (model, mode, whether a slice is served before the reference)
    for model_name, quantization, serve in (
            ("paligemma", "bf16", True), ("paligemma", "8bit", True),
            ("paligemma", "4bit", True), ("paligemma", "fp32", True),
            ("llava", "bf16", True), ("llava", "8bit", True),
            ("llava", "4bit", True), ("llava", "fp32", True),
            ("blip2", "bf16", True), ("blip2", "8bit", True),
            ("blip2", "4bit", True), ("blip2", "fp32", False)):
        if serve:
            size = dict(n_images=FP32_IMAGES, new=FP32_NEW) \
                if quantization == "fp32" else {}
            t0 = time.perf_counter()
            trip = model_name == "paligemma" and quantization == "8bit"
            path, _ = slice_phase(
                torch, np, gpu, quantization, model_name=model_name,
                model_id=str(pali) if model_name == "paligemma" else None,
                round_trip=tmp / "native" if trip else None, **size)
            print(f"[time] slice {model_name} {quantization} "
                  f"{time.perf_counter() - t0:.1f} s")
            for name, n in path.items():
                launches[name] += n
        t0 = time.perf_counter()
        reference_phase(torch, np, gpu, quantization, model_name)
        print(f"[time] reference {model_name} {quantization} "
              f"{time.perf_counter() - t0:.1f} s")
        if model_name in CKPT_LAYOUTS and quantization == "bf16":
            t0 = time.perf_counter()
            cut = tmp / model_name
            checkpoint_write_phase(torch, gpu, model_name, cut,
                                   layout=CKPT_LAYOUTS[model_name], layers=2)
            reference_phase(torch, np, gpu, "bf16", model_name, ckpt=cut)
            shutil.rmtree(cut)
            print(f"[time] checkpoint {model_name} "
                  f"{time.perf_counter() - t0:.1f} s")


# the generation phases: the wave engine and beam search through
# ``generate_batch``, as a user calls it on PIL images. A wave of 32
# images; beams of 4 over 8 images (32 beam rows); up to 32 new tokens.
# The prompt texts' byte-level ids (the synthetic and random models have
# no tokenizer files) give the slices' prompts, so the kernels meet the
# checks' shapes: PaliGemma BOS + 58 + "\n" after the 256 image tokens
# (316); LLaVA BOS + "USER: " before the 576, "\n" + 46 + " ASSISTANT:"
# after them (641)
WAVE_IMAGES, BEAM_IMAGES, BEAMS, GEN_NEW = 32, 8, 4, 32
_TEXT = "Describe the person: upper and lower colours, gender, bag, hat."
GEN_PROMPTS = {"paligemma": (_TEXT[:58], 316), "llava": (_TEXT[:46], 641)}
# the steps run before the profiled ones: the beam gather's columns then
# cover about half the new tokens, a step's average
PROFILE_AT, PROFILED_STEPS = 15, 3
# timed calls of generate_batch after the warm-up, on the same inputs (3:
# the whole run stays near 650 s with the sweep and the new slices)
GEN_REPS = 3
# the beam reference: a depth-cut LLaVA in fp32, card against CPU
BEAM_REF_IMAGES, BEAM_REF_NEW = 2, 16
# the CLI's wave phase: images of the probing data, new tokens
CLI_IMAGES, CLI_NEW = 8, 16


def device_ms(torch, fn, reps=1):
    """``fn`` run ``reps`` times under ``torch.profiler``: the device's
    kernel ms a run (the kernels' own time summed; None where the profiler
    saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA"))
    return total / 1e3 / reps if total > 0 else None


def _ms(x):
    return "not measured" if x is None else f"{x:.3f} ms"


@contextlib.contextmanager
def uniform_writes():
    """Counts the decode steps' attention calls and how many of them wrote
    every row at one shared column (B3's uniform form inside B2)."""
    from vlm_tpu_torch.models import decoder
    real, seen = decoder.decode_attention, {"calls": 0, "uniform": 0}

    def spy(*args, **kw):
        seen["calls"] += 1
        seen["uniform"] += bool(kw["uniform"]) and \
            kw["write_start"].numel() == 1
        return real(*args, **kw)
    decoder.decode_attention = spy
    try:
        yield seen
    finally:
        decoder.decode_attention = real


def generation_phase(torch, np, gpu, tag, model_name, quantization,
                     n_images, num_beams, model_id=None):
    """``generate_batch`` over ``n_images`` synthetic images, greedy
    (``num_beams`` 1: the wave engine) or with beams, timed ``GEN_REPS``
    times after a short warm-up (median and range); then one call, its
    prefill and decode steps (and for beams the cache gather, over the
    written columns and over whole rows) profiled alone on the same
    inputs, for the device's share of the wall time. Returns the timed
    calls' launch counts."""
    from PIL import Image

    from vlm_tpu_torch.generate.beam import gather_cache
    from vlm_tpu_torch.generate.decode import build_prompt_ids
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import normalize_images

    spec = MODELS[model_name]
    t0 = time.perf_counter()
    with int8_prefill(model_name, quantization) as mode:
        model = create_model(
            model_name, size=spec["size"], device="cuda", seed=0,
            model_id=model_id, quantization=quantization,
            kv_cache="int8" if quantization == "8bit" else None,
            quantize_vision=quantization == "8bit" and spec["quantize_vision"])
    torch.cuda.synchronize()
    source = " from the checkpoint" if model_id else ""
    print(f"{tag} {spec['label']} built{source}: KV cache {model.cache_dtype}"
          f"{', int8 prefill ' + mode if mode else ''}, "
          f"{time.perf_counter() - t0:.1f} s ({gpu})")
    side = spec["image"]
    u8 = np.random.default_rng(0).integers(0, 256, (n_images, side, side, 3),
                                           dtype=np.uint8)
    images = [Image.fromarray(a) for a in u8]
    prompt, want_len = GEN_PROMPTS[model_name]
    kw = dict(num_beams=num_beams)
    model.generate_batch(images, prompt, max_tokens=4, **kw)     # warm-up
    torch.cuda.synchronize()
    _lib.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    walls, stats = [], []
    with uniform_writes() as writes:
        for _ in range(GEN_REPS):
            t0 = time.perf_counter()
            texts = model.generate_batch(images, prompt, max_tokens=GEN_NEW,
                                         **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            engine = next(e for e in model._engines.values()
                          if e.max_new_tokens == GEN_NEW)
            stats.append(dict(engine.last_stats))
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_lib.launches)
    plain = dict(_lib.plain_calls)
    if len({st["steps"] for st in stats}) != 1:
        raise RuntimeError(f"{tag} the timed calls ran different step "
                           f"counts on the same inputs: {stats}")
    steps = stats[0]["steps"]
    # steps dispatched after every row was done (the flags read late) run
    # the decode forward too
    dispatched = sum(st["steps"] + st["guarded_steps"] for st in stats)

    pixels = normalize_images(torch.from_numpy(u8).cuda(),
                              recipe=model.recipe, compute_dtype=model.dtype,
                              patch_size=model.cfg.vision.patch_size)
    pre_t, post_t, bos_pre, bos_post = model.format_prompt(prompt)
    pre, post, plen = build_prompt_ids(
        model.tokenizer, pre_t, post_t, num_image_tokens(model.cfg),
        n_images, add_bos_to_pre=bos_pre, add_bos_to_post=bos_post,
        device="cuda")
    if int(plen[0]) != want_len:
        raise RuntimeError(f"{tag} prompt of {int(plen[0])} ids, the kernel "
                           f"checks' {want_len} expected")
    if len(texts) != n_images or not all(isinstance(t, str) for t in texts):
        raise RuntimeError(f"{tag} {len(texts)} texts for {n_images} images")
    b2_form, fused_form = PATH_KERNELS[quantization][1:3]
    want = ["flash_attention", "normalize", b2_form, fused_form]
    if quantization == "8bit":
        want += ["int8_matmul", "int8xint8_matmul", "kv_write_int8"]
    idle = [k for k in want if launches[k] <= 0]
    if idle:
        raise RuntimeError(f"{tag} kernels never launched: {idle}")
    if any(plain.values()):
        raise RuntimeError(f"{tag} plain versions ran: {plain}")
    # every decode step writes inside B2, in the uniform form; standalone
    # B3 only for the int8 prefill's rows (one launch a layer)
    prefill_rows = model.cfg.decoder.layers if quantization == "8bit" else 0
    if not (launches[fused_form] == launches[b2_form] == writes["calls"]
            == writes["uniform"]
            == model.cfg.decoder.layers * dispatched
            and launches["kv_write"] == 0
            and launches["kv_write_int8"] == prefill_rows * GEN_REPS):
        raise RuntimeError(f"{tag} decode writes not all uniform inside B2: "
                           f"{writes}, {launches}, {steps} steps a call,"
                           f" {dispatched} dispatched in all")
    call_dev = device_ms(torch, lambda: model.generate_batch(
        images, prompt, max_tokens=GEN_NEW, **kw))

    with torch.inference_mode():
        held = {}
        prefill_dev = device_ms(torch, lambda: held.update(
            s=engine.start(pixels, pre, post, plen)))
        s = held["s"]
        while engine.running(s) and s.step < PROFILE_AT:
            engine.step(s)
        step_dev = device_ms(torch, lambda: engine.step(s), PROFILED_STEPS) \
            if engine.running(s) else None
        gather = ""
        if num_beams > 1:
            k = num_beams
            rows = (torch.arange(n_images, device="cuda")[:, None] * k
                    + torch.arange(k - 1, -1, -1, device="cuda")).reshape(-1)
            lo, hi = s.cols
            cols = slice(lo, hi + s.step - 1)
            col_dev = device_ms(torch, lambda: gather_cache(s.cache, rows,
                                                            cols), 3)
            row_dev = device_ms(torch, lambda: gather_cache(s.cache, rows), 3)
            share = "not measured" if None in (col_dev, step_dev) else \
                f"{col_dev / step_dev:.1%}"
            gather = (f"; the gather a step over columns {lo}.."
                      f"{hi + s.step - 2} ({s.step - 1} written): "
                      f"{_ms(col_dev)} device, "
                      f"{share} of the step; over whole rows (vlm_tpu's "
                      f"design) {_ms(row_dev)}")
        del s, held
    rows = n_images * num_beams
    rates = sorted(n_images / w for w in walls)
    step_ms = sorted(st["decode_s"] * 1e3 / max(steps, 1) for st in stats)
    pre_ms = sorted(st["prefill_s"] * 1e3 for st in stats)
    wall = statistics.median(walls)
    step_wall = statistics.median(step_ms)
    host = "not measured" if step_dev is None else \
        f"{(step_wall - step_dev) / step_wall:.1%}"
    busy = "not measured" if call_dev is None else \
        f"{call_dev / 1e3 / wall:.1%}"
    print(f"{tag} {n_images} images"
          f"{f' x {num_beams} beams ({rows} rows)' if num_beams > 1 else ''}"
          f", prompt {int(plen[0])} ids, {steps} decode steps run (of "
          f"{GEN_NEW - 1}; {dispatched - steps * GEN_REPS} guarded in all), "
          f"{GEN_REPS} calls: median "
          f"{statistics.median(rates):.3f} img/s (range {rates[0]:.3f}-"
          f"{rates[-1]:.3f}), {wall:.3f} s a call; one call's device time "
          f"{_ms(call_dev)}, {busy} of the median wall ({gpu})")
    print(f"{tag} wall (median, range): prefill "
          f"{statistics.median(pre_ms):.1f} ms ({pre_ms[0]:.1f}-"
          f"{pre_ms[-1]:.1f}), a step {step_wall:.2f} ms ({step_ms[0]:.2f}-"
          f"{step_ms[-1]:.2f}); device (profiled alone): prefill "
          f"{_ms(prefill_dev)}, a step {_ms(step_dev)} (steps {PROFILE_AT}-"
          f"{PROFILE_AT + PROFILED_STEPS - 1}); the host's share of a step "
          f"(wall - device) / wall {host}{gather} ({gpu})")
    print(f"{tag} max_memory_allocated {peak / 2**30:.2f} GiB ({gpu})")
    print(f"{tag} launches "
          f"{ {k: v for k, v in launches.items() if v} }, uniform fused "
          f"writes {writes['uniform']} of {writes['calls']}, plain calls "
          f"{sum(plain.values())}; first text {texts[0][:40]!r}")
    del model, pixels
    torch.cuda.empty_cache()
    return launches


def beam_reference_phase(torch, np, gpu):
    """Depth-cut LLaVA-1.5-7B (2 vision and 2 decoder layers, full width),
    fp32 on the card against fp32 on the CPU, same weights: beam search
    (4 beams, 2 images, 16 tokens). Best tokens and lengths identical,
    scores within ``REF_TOL_FP32``; where the beams part, the step and the
    CPU's score gap between the candidates the two sides swapped, which
    must be under the tolerance."""
    from vlm_tpu_torch.generate.beam import BeamSearchEngine
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
    from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images

    spec = MODELS["llava"]
    full = VLM_CONFIGS["llava"](spec["size"])
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        decoder=dataclasses.replace(full.decoder, layers=2))
    mods = {"cuda": init_random_(VLMModule(cfg, device="cuda"), seed=1)}
    mods["cpu"] = VLMModule(cfg, device="cpu")
    mods["cpu"].load_state_dict({k: v.cpu() for k, v in
                                 mods["cuda"].state_dict().items()})
    rng = np.random.default_rng(2)
    b, side = BEAM_REF_IMAGES, spec["image"]
    u8 = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3),
                                       dtype=np.uint8))
    vocab = cfg.decoder.vocab_size
    pre = np.concatenate([np.full((b, 1), cfg.decoder.bos_token_id),
                          rng.integers(3, vocab, (b, spec["pre_ids"] - 1))],
                         1).astype(np.int32)
    post = rng.integers(3, vocab, (b, PROMPT_IDS)).astype(np.int32)
    plen = spec["pre_ids"] + num_image_tokens(cfg) + PROMPT_IDS
    picks, results = {}, {}
    for dev, mod in mods.items():
        eng = BeamSearchEngine(mod, cfg, batch_size=b, max_prompt_len=plen,
                               num_beams=BEAMS, max_new_tokens=BEAM_REF_NEW)
        real, picks[dev] = eng._select, []

        def select(s, step, logp, real=real, out=picks[dev]):
            before = s.beam_scores.clone()
            src, tok = real(s, step, logp)
            out.append((before.cpu(), logp.float().cpu(), src.cpu(),
                        tok.cpu()))
            return src, tok
        eng._select = select
        px = normalize_images(u8.to(dev), recipe=RECIPES["llava"],
                              compute_dtype=torch.float32,
                              patch_size=cfg.vision.patch_size)
        results[dev] = eng.generate(
            px, torch.from_numpy(pre).to(dev), torch.from_numpy(post).to(dev),
            torch.full((b,), plen, dtype=torch.int32, device=dev))
    card, cpu = results["cuda"], results["cpu"]
    same = torch.equal(card.lengths.cpu(), cpu.lengths) and torch.equal(
        card.tokens.cpu(), cpu.tokens)
    err = float(((card.scores.cpu() - cpu.scores).abs()
                 / cpu.scores.abs()).max())
    parted, gap = None, 0.0
    for step, (c, p) in enumerate(zip(picks["cuda"], picks["cpu"])):
        if torch.equal(c[2], p[2]) and torch.equal(c[3], p[3]):
            continue
        parted = step
        cand = p[0][:, :, None] + p[1]            # the CPU's candidates
        for i in range(b):
            mine = set(zip(c[2][i].tolist(), c[3][i].tolist()))
            theirs = set(zip(p[2][i].tolist(), p[3][i].tolist()))
            for sa, ta in mine - theirs:
                for sb, tb in theirs - mine:
                    ref = float(cand[i, sb, tb])
                    gap = max(gap, abs(float(cand[i, sa, ta]) - ref)
                              / abs(ref))
        break
    print(f"[beam reference] depth-cut {spec['label']} (2+2 layers, full "
          f"width), fp32, {BEAMS} beams x {b} images, {BEAM_REF_NEW} tokens: "
          f"best tokens and lengths {'identical' if same else 'DIFFER'} "
          f"(lengths {card.lengths.tolist()}), scores {card.scores.tolist()}"
          f" vs {cpu.scores.tolist()}, max relative {err:.3e} (tol "
          f"{REF_TOL_FP32:.0e})"
          + ("" if parted is None else
             f"; the beams part at step {parted}, the swapped candidates' "
             f"score gap {gap:.3e}") + f" ({gpu})")
    if err > REF_TOL_FP32 or not (same or (parted is not None
                                           and gap < REF_TOL_FP32)):
        raise RuntimeError("[beam reference] the card's beams disagree "
                           "with the CPU's")


def mivia_split(tmp, base):
    """8 of the probing data's JPEGs laid out as a MiviaPar test split
    under ``tmp/mivia`` (made once), labels cycling through colours and
    flags; returns its base path."""
    mivia = tmp / "mivia"
    d = mivia / "MiviaPar" / "test"
    if d.exists():
        return mivia
    (d / "images").mkdir(parents=True)
    colours = ("black", "white", "red", "blue")
    lines = []
    for i, src in enumerate(sorted(
            (base / "TestDataset" / "test" / "images").glob("*.jpg"))[
                :CLI_IMAGES]):
        shutil.copy(src, d / "images" / src.name)
        lines.append(f"{src.name},{colours[i % 4]},{colours[(i + 1) % 4]},"
                     f"{i % 2},{(i // 2) % 2},{(i // 4) % 2}")
    (d / "labels.csv").write_text("\n".join(lines) + "\n")
    return mivia


def project_root(tmp, name, config, **over):
    """A project root ``tmp/name`` holding the task map, made the current
    one (``VLM_TPU_ROOT``), and a copy of ``configs/<config>`` with
    ``over`` in it; returns (root, the copy's path)."""
    import yaml
    root = tmp / name
    (root / "configs").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "task_datasets.yaml", root / "configs")
    cfg = yaml.safe_load((ROOT / "configs" / config).read_text())
    cfg.update(over)
    path = root / config
    path.write_text(yaml.safe_dump(cfg))
    os.environ["VLM_TPU_ROOT"] = str(root)
    return root, path


def cli_wave_phase(torch, gpu, tmp, ckpt, base):
    """The port's CLI with ``continuous_batching: false`` and ``num_beams:
    2`` (the shipped YAML otherwise: its MiviaPar prompt), PaliGemma-3B in
    bf16 from the checkpoint, over 8 of the probing data's JPEGs laid out
    as a MiviaPar test split; its summary and files. Returns the launch
    counts."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts.prompt_inference import main
    root, path = project_root(
        tmp, "cli_root", "prompt_inference.yaml", model_name="paligemma",
        model_id=str(ckpt), quantization="bf16", continuous_batching=False,
        num_beams=2, max_tokens=CLI_NEW, batch_size=CLI_IMAGES,
        dataset={"base_path": str(mivia_split(tmp, base))})
    _lib.reset_counts()
    t0 = time.perf_counter()
    summary = main(["--config", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    out = root / "eval" / "prompt_inference" / "paligemma_bf16" / "MiviaPar"
    missing = [f for f in ("preds.json", "gts.json", "metrics.json",
                           "used_config.yaml") if not (out / f).exists()]
    print(f"[cli wave] the port's CLI, continuous_batching false, "
          f"num_beams 2, PaliGemma-3B bf16 from the checkpoint, "
          f"{CLI_IMAGES} JPEGs, max_tokens {CLI_NEW}: "
          f"{json.dumps({k: v for k, v in summary.items() if k != 'metrics'})}"
          f", {wall:.1f} s with the load; files "
          f"{'written' if not missing else f'MISSING {missing}'}, metrics "
          f"{sorted(summary['metrics'])} ({gpu})")
    if missing or summary["images_completed"] != CLI_IMAGES:
        raise RuntimeError("[cli wave] the CLI did not complete")
    if any(plain.values()) or not launches["decode_attention"]:
        raise RuntimeError(f"[cli wave] the path left the kernels: "
                           f"{launches}, {plain}")
    torch.cuda.empty_cache()
    return launches


# the kernels a CLI trace must name: B1's, B2's and B4's (their symbols in
# csrc/flash_attention.cu, decode_attention.cu, normalize.cu)
TRACE_KERNELS = {"B1": "flash_kernel", "B2": "decode_kernel",
                 "B4": "normalize_kernel"}


def cli_profile_phase(torch, gpu, tmp, ckpt, base):
    """The port's CLI on the continuous path with ``--profile``,
    PaliGemma-3B in bf16 from the checkpoint, over the same 8 JPEGs: its
    files, the meter's ``[THROUGHPUT]`` line, and a Chrome trace that names
    B1's, B2's and B4's kernels. Returns the launch counts."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts.prompt_inference import main
    from vlm_tpu_torch.utils.profiling import TRACE_FILE
    root, path = project_root(
        tmp, "cli_profile_root", "prompt_inference.yaml",
        model_name="paligemma", model_id=str(ckpt), quantization="bf16",
        continuous_batching=True, num_beams=1, max_tokens=CLI_NEW,
        batch_size=CLI_IMAGES,
        dataset={"base_path": str(mivia_split(tmp, base))})
    trace_dir = tmp / "cli_trace"
    tee = _Tee(sys.stdout)
    _lib.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        summary = main(["--config", str(path), "--profile", str(trace_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    trace = trace_dir / TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(sym in n for n in kernels)
             for k, sym in TRACE_KERNELS.items()}
    meter = [ln for ln in tee.text().splitlines()
             if ln.startswith("[THROUGHPUT]")]
    print(f"[cli profile] the port's CLI, continuous, --profile, "
          f"PaliGemma-3B bf16 from the checkpoint, {CLI_IMAGES} JPEGs, "
          f"max_tokens {CLI_NEW}: {summary['images_completed']} images, "
          f"{wall:.1f} s with the load and the trace; trace "
          f"{trace.stat().st_size / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} kernel events, B1/B2/B4 kernels named {named}; "
          f"meter {meter} ({gpu})")
    if summary["images_completed"] != CLI_IMAGES or len(meter) != 1:
        raise RuntimeError("[cli profile] the CLI did not complete")
    if not all(named.values()):
        raise RuntimeError(f"[cli profile] the trace misses kernels: {named}")
    if any(plain.values()) or not launches["decode_attention"]:
        raise RuntimeError(f"[cli profile] the path left the kernels: "
                           f"{launches}, {plain}")
    return launches


# the sweep: configs/compare_models.yaml with these keys changed, over the
# 8 JPEGs of the CLI phases
SWEEP = dict(models=["paligemma", "llava", "blip2"],
             quantizations=["bf16", "8bit", "4bit"], datasets=["MiviaPar"],
             max_tokens=16, batch_size=8)
# device memory a released model may leave behind
SWEEP_LEFT = 64 << 20


def sweep_phase(torch, gpu, tmp, base, launches):
    """The port's ``compare_models`` at full size (random weights), every
    model in bf16, 8bit and 4bit: nine rows, none an error, 8 images
    each; each build allocating its ``param_bytes``; after each model the
    device memory back to where the sweep began (within ``SWEEP_LEFT``);
    B7 under the 4bit rows of LLaVA and BLIP-2; no plain version. Adds
    the launch counts into ``launches``."""
    from vlm_tpu_torch.models import base_model
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import compare_models
    from vlm_tpu_torch.testing import kernel_checks
    root, path = project_root(
        tmp, "sweep_root", "compare_models.yaml",
        dataset={"base_path": str(mivia_split(tmp, base))}, **SWEEP)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    runs = []
    real_create, real_release = (compare_models.create_model,
                                 compare_models.release)
    real_batcher = base_model.ContinuousBatcher

    class Batcher(real_batcher):
        """The batcher, its shapes recorded: the kernel checks' sweep
        cases are at these."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs[-1]["batcher"] = (self.batch_size, self.admit_block,
                                   self.max_prompt_len, self.max_new_tokens)

    def create(name, **kw):
        _lib.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        before = device_bytes(torch)
        t0 = time.perf_counter()
        model = real_create(name, **kw)
        torch.cuda.synchronize()
        runs.append(dict(model=name, quantization=kw["quantization"],
                         build_s=time.perf_counter() - t0))
        fit_report(torch, f"[sweep] {name} {kw['quantization']}", model,
                   before, gpu)
        return model

    def release(model):
        run = runs[-1]
        torch.cuda.synchronize()
        run.update(peak=torch.cuda.max_memory_allocated(),
                   launches=dict(_lib.launches),
                   plain=dict(_lib.plain_calls))
        real_release(model)
        run["left"] = torch.cuda.memory_allocated() - start

    compare_models.create_model, compare_models.release = create, release
    base_model.ContinuousBatcher = Batcher
    t0 = time.perf_counter()
    try:
        rows = compare_models.main(["--config", str(path)])
    finally:
        compare_models.create_model, compare_models.release = \
            real_create, real_release
        base_model.ContinuousBatcher = real_batcher
    wall = time.perf_counter() - t0
    bad = [r for r in rows if "error" in r]
    if bad:
        raise RuntimeError(f"[sweep] error rows {bad}")
    for row, run in zip(rows, runs):
        print(f"[sweep] {row['model']} {row['quantization']}: "
              f"{row['images']} images, {row['images_per_sec']} img/s"
              f" (the summary's), build {run['build_s']:.1f} s, peak "
              f"{run['peak'] / 2**30:.2f} GiB, after the release "
              f"{run['left'] / 2**20:.1f} MiB above the start, B7 "
              f"{b7_launches(run['launches'])}, B5 "
              f"{run['launches']['int8_matmul']}, B6 "
              f"{run['launches']['int8xint8_matmul']} launches ({gpu})")
    print(f"[sweep] {len(rows)} rows in {wall:.1f} s; summary.json and "
          f"summary.csv under {root / 'eval' / 'comparison'} ({gpu})")
    want = [(m, q) for m in SWEEP["models"] for q in SWEEP["quantizations"]]
    if [(r["model"], r["quantization"]) for r in rows] != want or any(
            r["images"] != CLI_IMAGES for r in rows):
        raise RuntimeError(f"[sweep] rows {rows}")
    shapes = [(r["model"], r["quantization"], r["batcher"]) for r in runs
              if r["batcher"] != (kernel_checks.SWEEP_SLOTS,
                                  kernel_checks.SWEEP_GROUP,
                                  kernel_checks.SWEEP_PROMPTS[r["model"]],
                                  kernel_checks.SWEEP_NEW)]
    if shapes:
        raise RuntimeError(f"[sweep] batcher shapes the kernel checks do "
                           f"not hold: {shapes}")
    left = [(r["model"], r["quantization"], r["left"]) for r in runs
            if r["left"] > SWEEP_LEFT]
    if left:
        raise RuntimeError(f"[sweep] memory not returned: {left}")
    for r in runs:
        need = ["flash_attention", "decode_attention", "kv_write_fused",
                "normalize"]
        if r["quantization"] == "4bit" and r["model"] != "paligemma":
            need.append("int4_matmul")
        idle = [k for k in need if not r["launches"][k]]
        if idle or any(r["plain"].values()):
            raise RuntimeError(f"[sweep] {r['model']} {r['quantization']}: "
                               f"never launched {idle}, plain {r['plain']}")
        for name, n in r["launches"].items():
            launches[name] += n


# the loop phase: generate_dataset over the first LOOP_IMAGES of the
# probing data's JPEGs, once at the default loop and once at a synchronous
# loop of LOOP_SYNC steps a chunk
LOOP_NEW, LOOP_SYNC, LOOP_IMAGES = 16, 4, 192


def probe_jpegs(base):
    """The probing data's 384 JPEGs (336 px), in a fixed order."""
    return sorted((base / "TestDataset").glob("*/images/*.jpg"))


@contextlib.contextmanager
def sync_warnings(torch):
    """Collects the synchronizing CUDA operations that
    ``torch.cuda.set_sync_debug_mode`` reports inside the block (a read or
    a copy that waits for the card: ``.item()``, ``.cpu()``, an upload
    from pageable memory), from every thread; the list fills when the block
    ends. An event's ``synchronize`` is not among them: the port counts
    its own (``blocking_reads``)."""
    import warnings
    seen = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode("default")
    seen.extend(str(w.message) for w in caught
                if "synchroniz" in str(w.message))


def loader_phase(np, gpu, base):
    """Which path decodes the serving phases' files (the native loader, or
    PIL with the build's error), and the host ms an image on both paths
    over the probing JPEGs at 224 px (``warp``) and 336 px
    (``shortest_edge_crop``), batches of 8 with the loader's 4 threads.
    Returns the path's name."""
    from vlm_tpu_torch.data import native_loader
    from vlm_tpu_torch.ops.preprocess import recipe_for
    paths = probe_jpegs(base)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        native = native_loader.native_available()
    build_s = time.perf_counter() - t0
    served = "native" if native else \
        f"PIL (the native build failed: {out.getvalue().strip()!r})"
    print(f"[loader] the serving path decodes with {served}; build and "
          f"load {build_s:.1f} s ({gpu})")
    for family in ("paligemma", "llava"):
        recipe = recipe_for(family)
        ms = {}
        for name, use in (("native", True), ("PIL", False)):
            if use and not native:
                ms[name] = "not measured (no build)"
                continue
            t0 = time.perf_counter()
            for i in range(0, len(paths), 8):
                batch = native_loader.load_batch(paths[i:i + 8], recipe,
                                                 use_native=use)
            ms[name] = f"{(time.perf_counter() - t0) * 1e3 / len(paths):.3f}"
            if batch.shape[1:] != (recipe.image_size,) * 2 + (3,):
                raise RuntimeError(f"[loader] batch {batch.shape}")
        print(f"[loader] {len(paths)} JPEGs (336 px) at "
              f"{recipe.image_size} px ({recipe.mode}): native "
              f"{ms['native']} ms an image, PIL {ms['PIL']} ms an image "
              f"(host, one thread calling) ({gpu})")
    return "native" if native else "PIL"


def loop_phase(torch, np, gpu, ckpt, base, served):
    """PaliGemma-3B bf16 from the checkpoint through ``generate_dataset``
    (the native loader, B4, the batcher) over the first ``LOOP_IMAGES``
    probing JPEGs, at
    most ``LOOP_NEW`` new tokens, 32 slots: once at the default loop
    (pipelined, no blocking read inside a chunk) and once at
    ``sync_every=LOOP_SYNC``. The texts must agree; no result may be None,
    no plain version may run, and the sync debug mode may report no
    synchronizing operation (the loop's own reads, event waits, are
    counted in ``blocking_reads``). Prints each loop's blocking reads and
    guarded steps an image, img/s and p50/p99. Returns the launch
    counts."""
    from vlm_tpu_torch.models import base_model
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops import _lib
    paths = probe_jpegs(base)[:LOOP_IMAGES]
    n = len(paths)
    model = create_model("paligemma", size="3b", device="cuda", seed=0,
                         model_id=str(ckpt), quantization="bf16")
    prompt = GEN_PROMPTS["paligemma"][0]
    real, made = base_model.ContinuousBatcher, []

    def loop(sync_every):
        class Batcher(real):
            def __init__(self, *args, **kw):
                super().__init__(*args, sync_every=sync_every, **kw)
                made.append(self)
        return Batcher

    model.generate_dataset(paths[:8], prompt, max_tokens=4,
                           batch_size=SLOTS)                  # warm-up
    torch.cuda.synchronize()
    texts, total = {}, dict.fromkeys(_lib.KERNELS, 0)
    for label, sync_every in (("default", 0),
                              (f"sync_every={LOOP_SYNC}", LOOP_SYNC)):
        base_model.ContinuousBatcher = loop(sync_every)
        _lib.reset_counts()
        try:
            with sync_warnings(torch) as syncs:
                t0 = time.perf_counter()
                texts[label] = model.generate_dataset(
                    paths, prompt, max_tokens=LOOP_NEW, batch_size=SLOTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            base_model.ContinuousBatcher = real
        launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
        b = made[-1]
        st = b.last_stats
        if any(t is None for t in texts[label]) or len(texts[label]) != n:
            raise RuntimeError(f"[loop] {label}: a text is missing")
        if any(plain.values()):
            raise RuntimeError(f"[loop] {label}: plain versions ran {plain}")
        idle = [k for k in PATH_KERNELS["bf16"] if launches[k] <= 0]
        if idle:
            raise RuntimeError(f"[loop] {label}: never launched {idle}")
        if launches["decode_attention"] != model.cfg.decoder.layers * (
                st["steps"] + st["guarded_steps"]):
            raise RuntimeError(f"[loop] {label}: B2 launches {launches} for "
                               f"{st['steps']} + {st['guarded_steps']} steps")
        lat = np.asarray(b.last_latency_s) * 1e3
        reads = st["blocking_reads"] + len(syncs)
        print(f"[loop] {label}: {n} JPEGs ({served} decode), "
              f"{n / wall:.3f} img/s, latency p50 "
              f"{np.percentile(lat, 50):.1f} ms p99 "
              f"{np.percentile(lat, 99):.1f} ms; {st['admits']} admissions, "
              f"{st['chunks']} chunks, {st['steps']} steps and "
              f"{st['guarded_steps']} guarded: {reads / n:.3f} blocking "
              f"reads an image ({st['blocking_reads']} the loop's, "
              f"{len(syncs)} synchronizing operations reported), "
              f"{st['guarded_steps'] / n:.3f} guarded steps an image, "
              f"{st['steps'] / max(st['chunks'], 1):.2f} steps a chunk; "
              f"{wall * 1e3 / max(st['steps'] + st['guarded_steps'], 1):.2f}"
              f" ms of wall a dispatched step ({gpu})")
        print(f"[loop] {label} loop {st}")
        # every wait for the card goes through the loop's counted reads
        # (a chunk's result; a step flag when the host runs too far ahead)
        if syncs:
            raise RuntimeError(f"[loop] {label}: {len(syncs)} synchronizing "
                               f"operations outside the loop's reads")
        for k, v in launches.items():
            total[k] += v
    if texts["default"] != texts[f"sync_every={LOOP_SYNC}"]:
        diff = sum(a != b for a, b in zip(*texts.values()))
        raise RuntimeError(f"[loop] {diff} texts differ between the loops")
    print(f"[loop] the two loops' {n} texts are identical; first "
          f"{texts['default'][0][:40]!r}")
    del model
    torch.cuda.empty_cache()
    return total


def generation_phases(torch, np, gpu, launches, tmp, ckpt, base):
    """The wave and beam phases, the beam reference and the CLI's wave
    path, adding the serving phases' launch counts into ``launches``; first
    the image loader's and the batcher loop's phases."""
    t0 = time.perf_counter()
    served = loader_phase(np, gpu, base)
    print(f"[time] loader {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, k in loop_phase(torch, np, gpu, ckpt, base, served).items():
        launches[name] += k
    print(f"[time] loop {time.perf_counter() - t0:.1f} s")
    for tag, model_name, quantization, n, beams in (
            ("[wave paligemma bf16]", "paligemma", "bf16", WAVE_IMAGES, 1),
            ("[beam paligemma 8bit]", "paligemma", "8bit", BEAM_IMAGES,
             BEAMS),
            ("[beam llava bf16]", "llava", "bf16", BEAM_IMAGES, BEAMS)):
        t0 = time.perf_counter()
        path = generation_phase(
            torch, np, gpu, tag, model_name, quantization, n, beams,
            model_id=str(ckpt) if model_name == "paligemma" else None)
        for name, k in path.items():
            launches[name] += k
        print(f"[time] {tag[1:-1]} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    beam_reference_phase(torch, np, gpu)
    print(f"[time] beam reference {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, k in cli_wave_phase(torch, gpu, tmp, ckpt, base).items():
        launches[name] += k
    print(f"[time] cli wave {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, k in cli_profile_phase(torch, gpu, tmp, ckpt, base).items():
        launches[name] += k
    print(f"[time] cli profile {time.perf_counter() - t0:.1f} s")


# the mesh phases: PaliGemma-3B from the checkpoint under a mesh of two
# ranks (``vlm_tpu_torch/testing/mesh_serve.py`` on the ranks of
# ``mesh_launch``), through ``generate_dataset`` over the first 16 probing
# JPEGs, 32 slots, up to 16 new tokens (the kernel checks' MESH_* cases);
# the bf16 ``data=2`` run then runs the beams on its model; the ranks
# share the one GPU over gloo unless the machine has one a rank
MESH_PHASES = (("bf16", {"data": 1, "model": 2}),
               ("8bit", {"data": 1, "model": 2}),
               ("bf16", {"data": 2, "model": 1}))
MESH_IMAGES, MESH_NEW = 16, 16
# the depth-cut references (2 + 2 layers, full width, model=2): 4 images,
# 2 decode steps, card against fp32 on the CPU
MESH_REFS = ("bf16", "8bit", "fp32")
MESH_REF_IMAGES, MESH_REF_STEPS = 4, 2
# the row-parallel check: Gemma's o product, a decode step's 32 slots and
# a 4-image admission's 1264 rows
MESH_ROW_PARALLEL = dict(k=2048, n=2048, rows=[32, 4 * 316])
# seconds a phase's ranks may take before they are killed
MESH_TIMEOUT = 420


def start_mesh_pool():
    """The mesh phases' two ranks, launched under torchrun (one GPU a rank
    when the machine has that many, else sharing it over gloo). They form
    their group and import the port while this process builds the kernels
    and runs the phases before the mesh's, then take every mesh run in
    turn: their launch, imports and group set-up are paid once."""
    from vlm_tpu_torch.testing.mesh_pool import MeshPool
    return MeshPool(2, Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_")),
                    MESH_TIMEOUT, device="cuda",
                    env=dict(os.environ,
                             VLM_TPU_DIST_TIMEOUT=str(MESH_TIMEOUT)))


def mesh_launch(pool, spec, run, worker="mesh_serve"):
    """``spec`` through ``vlm_tpu_torch.testing.<worker>`` on ``pool``'s
    ranks; their records by rank. A rank that fails, hangs or passes
    ``MESH_TIMEOUT`` fails the phase, and every process of the launch is
    killed."""
    run.mkdir(parents=True, exist_ok=True)
    return pool.run(worker, spec, run / "out")


def close_mesh_pool(pool):
    """Print the ranks' ``[mesh]`` lines (their group), then end them
    (killed if they do not end)."""
    if pool.proc.poll() is None:
        for line in pool.log().splitlines():
            if line.startswith("[mesh]"):
                print(line)
        pool.close()
    shutil.rmtree(pool.queue, ignore_errors=True)


def mesh_plan(cfg, quantization, stats):
    """Each rank's kernel launches for a run of ``stats`` (the batcher's
    admissions and dispatched steps): every admission whole on every rank
    (B4 once, B1 at each tower and decoder layer; 8bit: B6 at each of the
    7 block products, B3's int8 prompt rows), every decode step's layers
    (B2 with B3's write inside it; 8bit: B5 at the 7 products)."""
    admits = stats["admits"]
    steps = stats["steps"] + stats["guarded_steps"]
    dec = cfg.decoder.layers
    plan = {"normalize": admits,
            "flash_attention": admits * (cfg.vision.layers + dec)}
    if quantization == "8bit":
        plan.update(decode_attention_int8=dec * steps,
                    kv_write_int8_fused=dec * steps,
                    kv_write_int8=dec * admits,
                    int8_matmul=7 * dec * steps,
                    int8xint8_matmul=7 * dec * admits)
    else:
        plan.update(decode_attention=dec * steps, kv_write_fused=dec * steps)
    return plan


def mesh_phase(pool, gpu, quantization, mesh, ckpt, paths, single, tmp,
               launches, more=None):
    """One mesh phase: the ranks' texts, launches, memory and img/s,
    checked; returns the ranks' records. ``more``: fields added to the
    spec, with ``tasks`` run after the dataset's on the same model."""
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    tag = (f"[mesh paligemma {quantization} "
           f"{'model' if mesh['model'] > 1 else 'data'}=2]")
    more = dict(more or {})
    spec = dict(family="paligemma", size="3b", quantization=quantization,
                kv_cache="int8" if quantization == "8bit" else None,
                mesh=mesh, device="cuda", model_id=str(ckpt), pre_ids=[],
                post_ids=[], tasks=[["dataset", dict(
                    paths=[str(p) for p in paths],
                    prompt=GEN_PROMPTS["paligemma"][0], new=MESH_NEW,
                    slots=SLOTS, warmup=4)]] + more.pop("tasks", []))
    spec.update(more)
    t0 = time.perf_counter()
    recs = mesh_launch(pool, spec, tmp / f"mesh_{quantization}_"
                      f"{mesh['data']}x{mesh['model']}")
    wall = time.perf_counter() - t0
    cfg = VLM_CONFIGS["paligemma"]("3b")
    gpus = {r["device"] for r in recs}
    shared = len(gpus) < len(recs)
    scaling = (f"{len(recs)} ranks on one GPU: not a scaling figure"
               if shared else "one GPU a rank")
    tasks = [r["tasks"][0] for r in recs]
    texts = tasks[0]["texts"]
    if any(t["texts"] != texts for t in tasks):
        raise RuntimeError(f"{tag} the ranks' texts differ")
    if any(t is None for t in texts) or len(texts) != len(paths):
        raise RuntimeError(f"{tag} an image returned no text")
    served = sorted(i for r, t in zip(recs, tasks) if r["model_rank"] == 0
                    for i in t["images_served_here"])
    if served != list(range(len(paths))):
        raise RuntimeError(f"{tag} the data ranks' slots served {served}")
    for r, t in zip(recs, tasks):
        plan = mesh_plan(cfg, quantization, t["stats"])
        if t["launches"] != plan or t["plain_calls"]:
            raise RuntimeError(f"{tag} rank {r['rank']} launched "
                               f"{t['launches']} (plan {plan}), plain "
                               f"{t['plain_calls']}")
        asked = r["build_asked_bytes"]
        if abs(asked - r["param_bytes"]) > r["param_bytes"] / 100:
            raise RuntimeError(f"{tag} rank {r['rank']} holds {asked} bytes "
                               f"after its build, param_bytes says "
                               f"{r['param_bytes']}")
        for name, k in t["launches"].items():
            launches[name] += k
        coll = t["collectives"]
        print(f"{tag} rank {r['rank']} (data {r['data_rank']}, model "
              f"{r['model_rank']}) {r['backend']} on {r['device']}: "
              f"param_bytes {r['param_bytes']} ({r['param_bytes'] / 1e9:.2f}"
              f" GB), after the build {asked} bytes, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB of "
              f"{r['device_total_bytes'] / 2**30:.2f}; load "
              f"{r['build_s']:.1f} s; {t['stats']}; launches "
              f"{t['launches']} = plan, plain none; collectives {coll} "
              f"({gpu})")
    steps = tasks[0]["stats"]["steps"] + tasks[0]["stats"]["guarded_steps"]
    coll = tasks[0]["collectives"]
    per_step = {k: v for k, v in coll.items() if not k.endswith("_bytes")}
    print(f"{tag} {len(paths)} images in {tasks[0]['wall_s']:.3f} s: "
          f"{tasks[0]['img_per_s']:.3f} img/s ({scaling}; ranks "
          f"{sorted(gpus)}), {steps} decode steps dispatched, collectives "
          f"of rank 0 {per_step} ({gpu})")
    same = sum(a == b for a, b in zip(texts, single))
    print(f"{tag} texts: identical on every rank, {same}/{len(texts)} equal "
          f"to the single-GPU bf16 run's (not gated: a sum over ranks "
          f"rounds in another order); phase {wall:.1f} s with the ranks' "
          f"load")
    return recs


def mesh_reference_phase(torch, np, gpu, quantization, tmp, pool):
    """A depth-cut PaliGemma-3B (2 + 2 layers, full width, model=2) under
    the mesh on the card against the same weights in fp32 on the CPU: a
    prefill of 4 images and 2 decode steps, the CPU fed the card's tokens;
    within ``REF_TOL`` (bf16, 8bit: int8 decoder and cache) or
    ``REF_TOL_FP32`` (fp32)."""
    from vlm_tpu_torch.core.mesh import Mesh
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule
    from vlm_tpu_torch.ops.preprocess import RECIPES
    from vlm_tpu_torch.testing import mesh_serve
    full = VLM_CONFIGS["paligemma"]("3b")
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        decoder=dataclasses.replace(full.decoder, layers=2))
    bits = 8 if quantization == "8bit" else 0
    card = torch.float32 if quantization == "fp32" else torch.bfloat16
    tol = REF_TOL_FP32 if quantization == "fp32" else REF_TOL
    run = tmp / f"mesh_ref_{quantization}"
    run.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        gpu_mod = VLMModule(cfg, dtype=card, device="cuda", quant_bits=bits)
        init_random_(gpu_mod, seed=1)
        state = {k: v.cpu() for k, v in gpu_mod.state_dict().items()}
        del gpu_mod
        torch.save(state, run / "state.pt")
    rng = np.random.default_rng(2)
    np.save(run / "u8.npy", rng.integers(0, 256, (MESH_REF_IMAGES, 224, 224,
                                                  3), dtype=np.uint8))
    post = prompt_ids(np, rng, cfg.decoder, 0)[1].tolist()
    spec = dict(family="paligemma", size="3b", layers=[2, 2],
                quantization=quantization, dtype=str(card).split(".")[1],
                bits=bits, kv_cache="int8" if bits else None,
                mesh={"data": 1, "model": 2}, device="cuda",
                state=str(run / "state.pt"), images=str(run / "u8.npy"),
                pre_ids=[], post_ids=post,
                tasks=[["logits", dict(n=MESH_REF_IMAGES,
                                       steps=MESH_REF_STEPS)]])
    if quantization == "bf16":
        spec["tasks"].append(["row_parallel", MESH_ROW_PARALLEL])
    recs = mesh_launch(pool, spec, run)
    if quantization == "bf16":
        row_parallel_check(recs, gpu)
    got = [r["tasks"][0] for r in recs]
    cards = [np.load(t["logits_file"]) for t in got]
    if not np.array_equal(cards[0], cards[1]):
        raise RuntimeError("the model ranks' logits differ")
    cpu_mod = VLMModule(cfg, dtype=torch.float32, device="cpu",
                        quant_bits=bits)
    cpu_mod.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in state.items()})
    cpu_spec = dict(spec, kv_cache="int8" if bits else None)
    inputs = mesh_serve._Inputs(cpu_spec, cfg, torch.device("cpu"),
                                torch.float32, RECIPES["paligemma"])
    ref = mesh_serve.task_logits(
        cpu_mod, cfg, Mesh(1, 1, groups=False), inputs, cpu_spec,
        n=MESH_REF_IMAGES, steps=MESH_REF_STEPS, feed=got[0]["fed"])
    ref = ref["logits"]
    if not np.isfinite(cards[0]).all():
        raise RuntimeError("non-finite logits on the card")
    worst = max(float(np.abs(c - r).max() / np.abs(r).max())
                for c, r in zip(cards[0], ref))
    print(f"[mesh reference {quantization}] depth-cut PaliGemma-3B (2+2 "
          f"layers, full width) over model=2 on the card "
          f"({recs[0]['backend']}), {MESH_REF_IMAGES} images, "
          f"{MESH_REF_STEPS} decode steps: max |card - cpu| / max|cpu| = "
          f"{worst:.3e} (tol {tol:.0e}); launches {got[0]['launches']}, "
          f"plain {got[0]['plain_calls']} ({gpu})")
    if worst > tol or got[0]["plain_calls"]:
        raise RuntimeError(f"[mesh reference {quantization}] the card "
                           f"disagrees with the CPU or ran a plain version")
    shutil.rmtree(run)


def row_parallel_check(recs, gpu):
    """The ranks' ``row_parallel`` task: every case within one bf16 step
    of the whole layer, on inputs where a double rounding would miss by
    more than two; on the kernels, no plain version."""
    for r in recs:
        t = r["tasks"][-1]
        for c in t["cases"]:
            print(f"[mesh row-parallel] rank {r['rank']} bits {c['bits']} "
                  f"rows {c['rows']}: |sharded - whole| = "
                  f"{c['err_steps']:.3f} bf16 steps (tol 1), partials "
                  f"rounded first {c['naive_steps']:.3f} steps, partial / "
                  f"output {c['partial_over_out']:.1f} ({gpu})")
            if c["err_steps"] > 1 or c["naive_steps"] <= 2:
                raise RuntimeError(f"[mesh row-parallel] rank {r['rank']} "
                                   f"{c}")
        if t["plain_calls"]:
            raise RuntimeError(f"[mesh row-parallel] plain versions ran: "
                               f"{t['plain_calls']}")
        print(f"[mesh row-parallel] rank {r['rank']} launches "
              f"{t['launches']}")


def mesh_phases(torch, np, gpu, launches, tmp, ckpt, base, pool):
    """The mesh phases and their depth-cut references, adding the ranks'
    launches into ``launches``."""
    from vlm_tpu_torch.models.factory import create_model
    t0 = time.perf_counter()
    paths = probe_jpegs(base)[:MESH_IMAGES]
    prompt = GEN_PROMPTS["paligemma"][0]
    model = create_model("paligemma", size="3b", device="cuda",
                         model_id=str(ckpt), quantization="bf16")
    model.generate_dataset(paths[:4], prompt, max_tokens=2,
                           batch_size=SLOTS)                  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    single = model.generate_dataset(paths, prompt, max_tokens=MESH_NEW,
                                    batch_size=SLOTS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    print(f"[mesh single] PaliGemma-3B bf16 on one GPU, the same "
          f"{len(paths)} images: {len(paths) / dt:.3f} img/s ({gpu})")
    beam_spec, beam_ref = beam_mesh_reference(torch, np, tmp, model)
    del model
    torch.cuda.empty_cache()
    print(f"[time] mesh single {time.perf_counter() - t0:.1f} s")
    for quantization, mesh in MESH_PHASES:
        t0 = time.perf_counter()
        beams = quantization == "bf16" and mesh["data"] == 2
        recs = mesh_phase(pool, gpu, quantization, mesh, ckpt, paths,
                          single, tmp, launches,
                          more=beam_spec if beams else None)
        if beams:
            beam_mesh_check(recs, beam_ref, gpu, launches)
        print(f"[time] mesh {quantization} {mesh} "
              f"{time.perf_counter() - t0:.1f} s")
    for quantization in MESH_REFS:
        t0 = time.perf_counter()
        mesh_reference_phase(torch, np, gpu, quantization, tmp, pool)
        print(f"[time] mesh reference {quantization} "
              f"{time.perf_counter() - t0:.1f} s")


# the mesh beyond serving: the probing data's splits, the steps' batches,
# the e2e run's trained blocks, the features' images, the bound the CPU
# tests give fp32 under another order of sums; the beams' images, beams
# and new tokens; the quantized towers' images
PMESH_SPLITS = {"train": 48, "val": 16, "test": 16}
PMESH_BATCH, PMESH_MULTI_BATCH = 16, 24
PMESH_BLOCKS = 4
PMESH_FEATURES = 64
PMESH_TOL = 1e-3
BEAM_MESH_IMAGES, BEAM_MESH_K, BEAM_MESH_NEW = 8, 4, 16
TOWER_MESH_IMAGES, TOWER_CHUNKS = 16, [8, 1]
SIGLIP_BLOCKS = 27
PMESH_DATA, PMESH_MODEL = {"data": 2, "model": 1}, {"data": 1, "model": 2}


def pmesh_data(np, tmp):
    """The mesh phases' face dataset: 336 px JPEGs, every label on every
    row (so the multi profile's 0.33 balancing adds no row), the train
    split's class counts."""
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.testing.synthetic import make_face_dataset
    rng = np.random.default_rng(4)
    base = tmp / "pmesh_datasets"
    for split, n in PMESH_SPLITS.items():
        rows = [{"gender": i % 2, "age": int(rng.integers(1, 90)),
                 "emotion": i % 7} for i in range(n)]
        make_face_dataset(base, "TestDataset", split, rows, size=(336, 336))
    ds = DatasetFactory.create_dataset("TestDataset", split="train",
                                       base_path=str(base))
    counts = {t: {} for t in PROBE_TASKS}
    for r in ds.labels_list():
        for t in PROBE_TASKS:
            c = str(int(r[t]))
            counts[t][c] = counts[t].get(c, 0) + 1
    (base / "TestDataset" / "train" / "class_counts.json").write_text(
        json.dumps(counts))
    return base


def pmesh_cfgs(base):
    """The trainers' configs (the shapes of ``build_cfg_from_profile``'s):
    single e2e, multi (the profile's backbone block, augmentation and the
    sampler) and LoRA (the shipped block); dropout 0.3 in every head."""
    import copy

    import yaml
    raw = yaml.safe_load((ROOT / "configs" / "train_probe.yaml").read_text())
    common = raw["common"]
    single = copy.deepcopy(common)
    single.pop("mesh")
    single["data"].update(base_path=str(base), batch_size=PMESH_BATCH)
    single["train"].update(epochs=1, patience=3)
    single.update(task="gender", _cfg_path="chip_smoke")
    e2e = copy.deepcopy(single)
    e2e["model"]["backbone"] = dict(raw["multi"]["model"]["backbone"],
                                    unfreeze_last_k=PMESH_BLOCKS)
    multi = copy.deepcopy(single)
    multi.pop("task")
    multi.update(tasks=list(raw["multi"]["tasks"]))
    multi["data"].update(raw["multi"]["data"], batch_size=PMESH_MULTI_BATCH)
    multi["model"]["backbone"] = dict(raw["multi"]["model"]["backbone"])
    multi["train"].update(raw["multi"]["train"])
    lora = copy.deepcopy(single)
    lora["data"]["batch_size"] = PMESH_MULTI_BATCH
    lora["model"]["lora"]["enabled"] = True
    return {"e2e": e2e, "multi": multi, "lora": lora}


def pmesh_root(tmp, name):
    import yaml
    root = tmp / name
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump(
        {s: {t: ["TestDataset"] for t in PROBE_TASKS}
         for s in PMESH_SPLITS}))
    return root


def _task(rec, tid):
    return next(t for t in rec["tasks"] if t["id"] == tid)


def _rel(a, b):
    """max |a - b| / max |b| of two numpy arrays."""
    return float(abs(a - b).max() / max(float(abs(b).max()), 1e-30))


def _coll_line(coll):
    return ", ".join(f"{k} {v}" for k, v in sorted(coll.items()))


def _peaks(recs, tid):
    return ", ".join(f"rank {r['rank']} "
                     f"{_task(r, tid)['peak_bytes'] / 2**30:.2f} GiB"
                     for r in recs)


def _probe_plan(blocks_diff, steps, val):
    return {"flash_attention_diff_fp32": blocks_diff * steps,
            "flash_attention_diff_fp32_bwd": blocks_diff * steps,
            "flash_attention_fp32": CLIP_BLOCKS * (steps + val),
            "normalize_fp32": steps + val}


def _check_rank_launches(tag, rec, res, want):
    """Each count of ``want`` (a key of forms joined by "+": their sum)
    equal to the rank's launches, and no plain call."""
    def got(k):
        return sum(res["launches"].get(f, 0) for f in k.split("+"))
    bad = {k: (got(k), n) for k, n in want.items() if got(k) != n}
    if bad or res["plain_calls"]:
        raise RuntimeError(f"{tag} rank {rec['rank']}: launches (got, want) "
                           f"{bad}, plain {res['plain_calls']}")


def probe_mesh_references(torch, np, tmp, base, paths, ckpt, cfgs):
    """The mesh phases' work on one GPU, in this process: the same
    functions the ranks run (``mesh_probe``'s tasks with no mesh)."""
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.testing import mesh_probe
    root = pmesh_root(tmp, "pmesh_one")
    out = tmp / "pmesh_one_out"
    out.mkdir()
    os.environ["VLM_TPU_ROOT"] = str(root)
    DatasetFactory.load_task_map(force=True)
    spec = {"mesh": None, "device": "cuda", "root": str(root)}
    ref, t0 = {}, time.perf_counter()
    ref["feat"] = mesh_probe.task_features(None, spec, out, "feat", "llava",
                                           paths=paths,
                                           batch_size=PMESH_BATCH)
    ref["feat"]["features"] = np.load(out / "feat_dataset.npy")
    torch.cuda.empty_cache()
    for name, profile in (("e2e", "single"), ("multi", "multi"),
                          ("lora", "single")):
        ref[name] = mesh_probe.task_train(None, spec, out, name, profile,
                                          cfgs[name], run=name)
        torch.cuda.empty_cache()
    test_cfg = {"data": {"base_path": str(base), "batch_size": PMESH_BATCH},
                "eval": {"ckpt_from": ref["e2e"]["ckpt_dir"],
                         "dataset_name": "auto"}}
    mesh_probe.task_test(None, spec, out, "test", "single", test_cfg)
    ref["metrics"] = json.loads((root / PMESH_EVAL / "metrics.json")
                                .read_text())
    torch.cuda.empty_cache()
    for bits, quant in ((8, "8bit"), (4, "4bit")):
        ref[f"int{bits}"] = mesh_probe.task_features(
            None, spec, out, f"int{bits}", "paligemma", quantization=quant,
            quantize_vision=True, model_id=str(ckpt),
            images=str(tmp / "pmesh_u8.npy"), chunks=TOWER_CHUNKS)
        ref[f"int{bits}"]["features"] = {
            c: np.load(out / f"int{bits}_features_{c}.npy")
            for c in TOWER_CHUNKS}
        torch.cuda.empty_cache()
    ref["seconds"] = time.perf_counter() - t0
    return ref, test_cfg


PMESH_EVAL = Path("probing/linear_probing/eval/llava_fp32_linear/gender/"
                  "TestDataset")


def beam_mesh_reference(torch, np, tmp, model):
    """The beams' spec fields (8 random images, the serving prompt's ids
    after them, BOS first, as PaliGemma's prompt; the ``beam`` task) and
    their run on ``model``, PaliGemma-3B bf16 on one GPU."""
    from vlm_tpu_torch.core.mesh import Mesh
    from vlm_tpu_torch.testing import mesh_serve
    post = model.tokenizer.encode(f"{GEN_PROMPTS['paligemma'][0]}\n",
                                  add_bos=True)
    rng = np.random.default_rng(6)
    np.save(tmp / "beam_mesh_u8.npy", rng.integers(
        0, 256, (BEAM_MESH_IMAGES, 224, 224, 3), dtype=np.uint8))
    task = dict(n=BEAM_MESH_IMAGES, new=BEAM_MESH_NEW, k=BEAM_MESH_K)
    spec = dict(images=str(tmp / "beam_mesh_u8.npy"),
                post_ids=[int(t) for t in post], tasks=[["beam", task]])
    inputs = mesh_serve._Inputs(spec, model.cfg, torch.device("cuda"),
                                model.dtype, model.recipe)
    ref = mesh_serve.task_beam(
        model.module, model.cfg, Mesh(1, 1, device="cuda", groups=False),
        inputs, dict(spec, pre_ids=[]), **task)
    return spec, ref


def beam_mesh_check(recs, want, gpu, launches):
    """``[beam mesh data=2]``: the beam task of the bf16 ``data=2`` run
    against its run on one GPU (tokens and lengths identical)."""
    tag = "[beam mesh data=2]"
    shared = "2 ranks on one GPU over gloo: a figure of the layout, not of " \
        "scaling"

    def beam(rec):
        return next(t for t in rec["tasks"] if t["name"] == "beam")
    for r in recs:
        t = beam(r)
        if t["tokens"] != want["tokens"] or t["lengths"] != want["lengths"] \
                or t["plain_calls"]:
            raise RuntimeError(f"{tag} rank {r['rank']}: tokens or lengths "
                               f"differ from one GPU's, or plain "
                               f"{t['plain_calls']}")
        for name, n in t["launches"].items():
            launches[name] += n
    t = beam(recs[0])
    scores = max(abs(a - b) / abs(b) for a, b in zip(t["scores"],
                                                      want["scores"]))
    print(f"{tag} PaliGemma-3B bf16 from the checkpoint, {BEAM_MESH_K} beams"
          f" over {BEAM_MESH_IMAGES} images ({BEAM_MESH_IMAGES // 2} a rank),"
          f" {BEAM_MESH_NEW} new tokens: tokens and lengths identical to one "
          f"GPU's, scores within {scores:.3e} relative; "
          f"{BEAM_MESH_IMAGES / t['wall_s']:.3f} img/s (one GPU "
          f"{BEAM_MESH_IMAGES / want['wall_s']:.3f}; {shared}); "
          f"{t['stats']}; peak of the run (the dataset's and the beams') "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in recs]} GiB; rank "
          f"0's collectives {_coll_line(t['collectives'])}; launches "
          f"{t['launches']}, plain none; {t['seconds']:.1f} s on the loaded "
          f"model ({gpu})")


def probe_mesh_phases(torch, np, gpu, launches, tmp, ckpt, base, pool):
    """The mesh beyond serving (see the docstring), each phase held against
    its one-GPU reference; the ranks' launches added into ``launches``."""
    from vlm_tpu_torch.ops.quant import int4_dequant_gate
    from vlm_tpu_torch.testing import kernel_checks
    t_all = time.perf_counter()
    pbase = pmesh_data(np, tmp)
    cfgs = pmesh_cfgs(pbase)
    rng = np.random.default_rng(6)
    np.save(tmp / "pmesh_u8.npy", rng.integers(
        0, 256, (TOWER_MESH_IMAGES, 224, 224, 3), dtype=np.uint8))
    paths = [str(p) for p in probe_jpegs(base)[:PMESH_FEATURES]]
    ref, test_cfg = probe_mesh_references(torch, np, tmp, pbase, paths,
                                          ckpt, cfgs)
    print(f"[time] probe mesh references on one GPU {ref['seconds']:.1f} s")
    u8 = str(tmp / "pmesh_u8.npy")
    feat = ["features", dict(id="feat", family="llava", paths=paths,
                             batch_size=PMESH_BATCH)]
    train = {name: ["train", dict(id=name, profile=profile, cfg=cfgs[name],
                                  run=name)]
             for name, profile in (("e2e", "single"), ("multi", "multi"),
                                   ("lora", "single"))}
    towers = [["features", dict(id=f"int{bits}", family="paligemma",
                                quantization=f"{bits}bit",
                                quantize_vision=True, model_id=str(ckpt),
                                images=u8, chunks=TOWER_CHUNKS)]
              for bits in (8, 4)]
    runs = {
        "data": (PMESH_DATA, [feat, train["e2e"], train["multi"],
                              ["test", dict(id="test", profile="single",
                                            cfg=test_cfg)]]),
        "model": (PMESH_MODEL, [feat, train["e2e"], train["lora"],
                                *towers])}
    recs = {}
    for axis, (mesh, tasks) in runs.items():
        root = pmesh_root(tmp, f"pmesh_{axis}")
        t0 = time.perf_counter()
        recs[axis] = mesh_launch(pool, dict(mesh=mesh, device="cuda",
                                            root=str(root), tasks=tasks),
                                 tmp / f"pmesh_{axis}_run",
                                 worker="mesh_probe")
        recs[axis + "_root"] = root
        print(f"[time] probe mesh launch {axis}=2 "
              f"{time.perf_counter() - t0:.1f} s")
        for r in recs[axis]:
            for t in r["tasks"]:
                for name, n in t["launches"].items():
                    launches[name] += n
    val = -(-PMESH_SPLITS["val"] // PMESH_BATCH)
    shared = "2 ranks on one GPU over gloo: a figure of the layout, not of " \
        "scaling"
    # ---- feature extraction ----
    for axis in ("data", "model"):
        tag = f"[probe mesh cache {axis}=2]"
        rs = recs[axis]
        got = np.load(tmp / f"pmesh_{axis}_run" / "out" / "feat_dataset.npy")
        err = _rel(got, ref["feat"]["features"])
        chunks = -(-PMESH_FEATURES // PMESH_BATCH)
        for r in rs:
            _check_rank_launches(tag, r, _task(r, "feat")["dataset"], {
                "flash_attention_fp32": CLIP_BLOCKS * chunks,
                "normalize_fp32": chunks})
        d0 = _task(rs[0], "feat")["dataset"]
        print(f"{tag} {PMESH_FEATURES} JPEGs through CLIP-L/336 fp32 at "
              f"batch {PMESH_BATCH}: {d0['seconds']:.3f} s, "
              f"{d0['img_per_s']:.2f} img/s (one GPU "
              f"{ref['feat']['dataset']['img_per_s']:.2f}; {shared}); "
              f"max |mesh - one GPU| / max = {err:.3e} (tol "
              f"{PMESH_TOL:.0e}); peak {_peaks(rs, 'feat')}; rank 0's "
              f"collectives {_coll_line(d0['collectives'])}; launches "
              f"{d0['launches']}, plain none ({gpu})")
        if err > PMESH_TOL or got.shape != ref["feat"]["features"].shape:
            raise RuntimeError(f"{tag} features disagree with one GPU's")
    # ---- training ----
    for axis, name, tag in (("data", "e2e", "[probe mesh e2e data=2]"),
                            ("model", "e2e", "[probe mesh e2e model=2]"),
                            ("data", "multi", "[probe mesh multi data=2]"),
                            ("model", "lora", "[probe mesh lora model=2]")):
        rs = recs[axis]
        one = [s["losses"] for s in ref[name]["steps"]]
        for r in rs:
            t = _task(r, name)
            mine = [s["losses"] for s in t["steps"]]
            worst = max(abs(m[k] - o[k]) / abs(o[k]) for m, o in
                        zip(mine, one) for k in o)
            steps = len(mine)
            if steps != len(one) or worst > PMESH_TOL:
                raise RuntimeError(f"{tag} rank {r['rank']}: losses {mine}, "
                                   f"one GPU {one}")
            diff = LORA_BLOCKS if name == "lora" else CLIP_BLOCKS
            _check_rank_launches(tag, r, t, _probe_plan(diff, steps, val))
            if t["recomputes"]:
                raise RuntimeError(f"{tag} recomputes {t['recomputes']}")
        if name == "lora" and len({_task(r, name)["digest_own"]
                                   for r in rs}) != 1:
            raise RuntimeError(f"{tag} the ranks' adapters differ")
        if len({_task(r, name)["digest_heads"] for r in rs}) != 1:
            raise RuntimeError(f"{tag} the ranks' heads differ")
        t0 = _task(rs[0], name)
        ms = [round(s["ms"], 1) for s in t0["steps"]]
        one_ms = [round(s["ms"], 1) for s in ref[name]["steps"]]
        print(f"{tag} {len(ms)} steps of "
              f"{cfgs[name]['data']['batch_size']}: step ms {ms} (one GPU "
              f"{one_ms}; {shared}); losses "
              f"{[s['losses'] for s in t0['steps']]}, within {PMESH_TOL:.0e}"
              f" of one GPU's; peak {_peaks(rs, name)}; rank 0's "
              f"collectives {_coll_line(t0['collectives'])}; launches "
              f"{t0['launches']} = plan, no recompute, plain none; "
              f"{t0['seconds']:.1f} s with the build ({gpu})")
    # ---- the tester ----
    tag = "[probe mesh test data=2]"
    got = json.loads((recs["data_root"] / PMESH_EVAL / "metrics.json")
                     .read_text())
    if got != ref["metrics"]:
        raise RuntimeError(f"{tag} metrics {got} vs one GPU {ref['metrics']}")
    t0 = _task(recs["data"][0], "test")
    batches = -(-PMESH_SPLITS["test"] // PMESH_BATCH)
    for r in recs["data"]:
        _check_rank_launches(tag, r, _task(r, "test"), {
            "flash_attention_fp32": CLIP_BLOCKS * batches,
            "normalize_fp32": batches, "flash_attention_diff_fp32": 0,
        "flash_attention_diff_fp32_bwd": 0})
    print(f"{tag} the single tester on the one-GPU e2e checkpoint: metrics "
          f"equal to one GPU's ({got.get('average_accuracy')}); "
          f"{t0['seconds']:.1f} s with the build; peak "
          f"{_peaks(recs['data'], 'test')}; rank 0's collectives "
          f"{_coll_line(t0['collectives'])} ({gpu})")
    # ---- the quantized towers ----
    for bits in (8, 4):
        tag = f"[mesh int{bits} tower model=2]"
        rs = recs["model"]
        for c in TOWER_CHUNKS:
            got = np.load(tmp / "pmesh_model_run" / "out" /
                          f"int{bits}_features_{c}.npy")
            err = _rel(got, ref[f"int{bits}"]["features"][c])
            if err > REF_TOL or not np.isfinite(got).all():
                raise RuntimeError(f"{tag} batch {c}: {err:.3e} from one GPU")
            chunks = -(-TOWER_MESH_IMAGES // c)
            for r in rs:
                part = kernel_checks.SIGLIP_TP_MLP[r["rank"]]
                res = _task(r, f"int{bits}")[f"chunk{c}"]
                want = {"flash_attention": SIGLIP_BLOCKS * chunks,
                        "normalize": chunks}
                # B7: its two forms together, less fc2 where dense_int4
                # takes the dequantized product (2,160 inputs at 2,048
                # rows; 2,144 take the prefill form)
                kernel = {8: "int8xint8_matmul" if c * 256 >= 512
                          else "int8_matmul",
                          4: "int4_matmul+int4_matmul_prefill"}[bits]
                products = 6 - (bits == 4 and int4_dequant_gate(c * 256,
                                                                part))
                want[kernel] = products * SIGLIP_BLOCKS * chunks
                _check_rank_launches(f"{tag} batch {c}", r, res, want)
            r0 = _task(rs[0], f"int{bits}")[f"chunk{c}"]
            print(f"{tag} PaliGemma-3B's SigLIP int{bits} from the "
                  f"checkpoint, fc2's inputs 2144 | 2160 over the ranks, "
                  f"{TOWER_MESH_IMAGES} images at batch {c}: "
                  f"{r0['seconds']:.3f} s, {r0['img_per_s']:.2f} img/s (one "
                  f"GPU {ref[f'int{bits}'][f'chunk{c}']['img_per_s']:.2f}; "
                  f"{shared}); max |mesh - one GPU| / max = {err:.3e} (tol "
                  f"{REF_TOL:.0e}); launches {r0['launches']}, plain none; "
                  f"rank 0's collectives {_coll_line(r0['collectives'])} "
                  f"({gpu})")
        print(f"{tag} peak {_peaks(rs, f'int{bits}')}; held bytes "
              f"{[_task(r, f'int{bits}')['held_bytes'] for r in rs]}")
    print(f"[time] probe mesh {time.perf_counter() - t_all:.1f} s")


# the probing phases: LLaVA-1.5-7B's tower in fp32, the single and multi
# profiles of configs/train_probe.yaml; the dataset's split sizes and the
# end-to-end batch (the multi profile's backbone block; its own batch of
# 256 would need about 8 times the 32.66 GiB measured at 32)
PROBE_SPLITS = {"train": 256, "val": 64, "test": 64}
PROBE_E2E_BATCH = 32
CLIP_BLOCKS = 24
PROBE_TASKS = ("age", "gender", "emotion")
# the multi profile's training set: emotion on every fifth train row (51
# of 256), so the 0.33 balancing adds round((0.33 * 256 - 51) / 0.67) = 50
# duplicates
PROBE_MULTI_TRAIN = 306
# the LoRA phase: the shipped lora block's last_k
LORA_BLOCKS = 2
# profiled steps after a run, for the device's busy share
BUSY_STEPS = 3


def probe_root(tmp, name, base):
    """A project root whose ``configs/task_datasets.yaml`` maps age, gender
    and emotion to the synthetic dataset under ``base``, made the current
    one."""
    import yaml
    root = tmp / name
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump(
        {s: {t: ["TestDataset"] for t in PROBE_TASKS}
         for s in PROBE_SPLITS}))
    os.environ["VLM_TPU_ROOT"] = str(root)
    return root


def probe_data(np, tmp):
    """The synthetic face dataset: 336 px JPEGs with ages from a seed,
    gender on every row, emotion on every fifth train row and on every
    val and test row; the train split's class counts (the class weights
    and the sampler's), as a real dataset ships them."""
    from vlm_tpu_torch.testing.synthetic import make_face_dataset
    rng = np.random.default_rng(0)
    base = tmp / "probe_datasets"
    t0 = time.perf_counter()
    counts = {t: {} for t in PROBE_TASKS}
    for split, n in PROBE_SPLITS.items():
        rows = [{"gender": i % 2, "age": int(rng.integers(1, 90)),
                 "emotion": i % 7 if split != "train" or i % 5 == 1
                 else ""} for i in range(n)]
        make_face_dataset(base, "TestDataset", split, rows, size=(336, 336))
        if split == "train":
            from vlm_tpu_torch.data.dataset_factory import DatasetFactory
            ds = DatasetFactory.create_dataset("TestDataset", split="train",
                                               base_path=str(base))
            for t in PROBE_TASKS:
                for r in ds.labels_list():
                    c = r.get(t)
                    if c is not None and int(c) >= 0:
                        counts[t][str(int(c))] = \
                            counts[t].get(str(int(c)), 0) + 1
    (base / "TestDataset" / "train" / "class_counts.json").write_text(
        json.dumps(counts))
    n_emotion = sum(counts["emotion"].values())
    if n_emotion != 51:
        raise RuntimeError(f"[probe data] {n_emotion} train rows with "
                           f"emotion, 51 expected")
    print(f"[probe data] {sum(PROBE_SPLITS.values())} 336 px JPEGs "
          f"{PROBE_SPLITS}, {n_emotion} train rows with emotion: "
          f"{time.perf_counter() - t0:.1f} s")
    return base


def probe_config(root, base, name, **over):
    """``configs/train_probe.yaml`` with the dataset's ``base_path`` and
    ``over`` (dotted keys of ``common``), written into ``root``."""
    import yaml
    cfg = yaml.safe_load((ROOT / "configs" / name).read_text())
    cfg["common"]["data"]["base_path"] = str(base)
    for key, val in over.items():
        *path, leaf = key.split(".")
        node = cfg["common"]
        for k in path:
            node = node[k]
        node[leaf] = val
    out = root / name
    out.write_text(yaml.safe_dump(cfg))
    return out, cfg


def _check_launches(tag, launches, plain, want):
    """Every count of ``want`` as it must be, and no plain call."""
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if bad:
        raise RuntimeError(f"{tag}: launches (got, want) {bad} ({launches})")
    if any(plain.values()):
        raise RuntimeError(f"{tag}: plain versions ran: {plain}")


def _check_trained(torch, tag, module, before, first):
    """Blocks ``first``.. and the embeddings moved from ``before``, the
    blocks before ``first`` bitwise as built. Not ``post_ln``: mean pooling
    does not reach it (a zero gradient, and a decay of lr x weight_decay
    that rounds away)."""
    embeds = ("patch_embed.", "cls_token", "pos_embed", "pre_ln.")
    same, moved = [], []
    for n, p in module.named_parameters():
        block = int(n.split(".")[1]) if n.startswith("blocks.") else None
        changed = not torch.equal(p.detach(), before[n])
        if block is not None and block < first and changed:
            moved.append(n)
        if ((block is not None and block >= first) or n.startswith(embeds)) \
                and not changed:
            same.append(n)
    if moved or same:
        raise RuntimeError(f"{tag} frozen parameters moved {moved[:8]}, "
                           f"trained ones did not {same[:8]}")


def probe_cache_phase(torch, gpu, tmp, base):
    """The feature-cache mode through ``train_probe.main``."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import train_probe
    root = probe_root(tmp, "probe_cache", base)
    path, cfg = probe_config(root, base, "train_probe.yaml",
                             **{"train.epochs": 2})
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    t0 = time.perf_counter()
    trainer = train_probe.main(["--config", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    peak = torch.cuda.max_memory_allocated()
    bs = trainer.probe.backbone.batch_size
    batches = sum(-(-PROBE_SPLITS[s] // bs) for s in ("train", "val"))
    _check_launches("[probe cache]", launches, plain, {
        "flash_attention_fp32": CLIP_BLOCKS * batches,
        "normalize_fp32": batches, "flash_attention_diff_fp32": 0,
        "flash_attention_diff_fp32_bwd": 0})
    ex, st = trainer.extract_stats, trainer.last_stats
    if not trainer.use_feature_cache or ex["images"] != \
            PROBE_SPLITS["train"] + PROBE_SPLITS["val"]:
        raise RuntimeError(f"[probe cache] no feature cache: {ex}")
    if len(trainer.history["train"]) != cfg["common"]["train"]["epochs"] or \
            not all(math.isfinite(v) for v in trainer.history["val"]):
        raise RuntimeError(f"[probe cache] history {trainer.history}")
    print(f"[probe cache llava fp32] {ex['images']} images extracted in "
          f"{ex['seconds']:.2f} s: {ex['images'] / ex['seconds']:.1f} "
          f"features/s at batch {bs}; head {st['train_steps']} steps in "
          f"{st['train_s']:.3f} s: {st['train_steps'] / st['train_s']:.1f} "
          f"steps/s at batch {cfg['common']['data']['batch_size']}; losses "
          f"{trainer.history}; max_memory_allocated {peak / 2**30:.2f} GiB;"
          f" {wall:.1f} s in all ({gpu})")
    print(f"[probe cache llava fp32] launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def probe_e2e_phase(torch, gpu, tmp, base):
    """The end-to-end mode: the multi profile's backbone block at batch
    32 through ``train_probe.build_trainer`` and ``fit``; returns the
    launches, the project root and the trainer's run name."""
    import yaml
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import train_probe
    root = probe_root(tmp, "probe_e2e", base)
    multi = yaml.safe_load((ROOT / "configs" / "train_probe.yaml")
                           .read_text())["multi"]["model"]["backbone"]
    path, cfg = probe_config(root, base, "train_probe.yaml", **{
        "train.epochs": 1, "data.batch_size": PROBE_E2E_BATCH,
        "model.backbone": multi})
    trainer = train_probe.build_trainer(["--config", str(path)])
    module = trainer.probe.backbone.module
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    recomputes = dict(_lib.recomputes)
    peak = torch.cuda.max_memory_allocated()
    st = trainer.last_stats
    steps = st["train_steps"]
    val = -(-PROBE_SPLITS["val"] // PROBE_E2E_BATCH)
    _check_launches("[probe e2e]", launches, plain, {
        "flash_attention_diff_fp32": CLIP_BLOCKS * steps,
        "flash_attention_diff_fp32_bwd": CLIP_BLOCKS * steps,
        "flash_attention_fp32": CLIP_BLOCKS * (steps + val),
        "normalize_fp32": steps + val})
    if steps != -(-PROBE_SPLITS["train"] // PROBE_E2E_BATCH) or \
            any(recomputes.values()):
        raise RuntimeError(f"[probe e2e] {steps} steps, recomputes "
                           f"{recomputes}")
    first = CLIP_BLOCKS - multi["unfreeze_last_k"]
    _check_trained(torch, "[probe e2e]", module, before, first)
    n_train = sum(p.numel() for p in module.parameters() if p.requires_grad)
    print(f"[probe e2e llava fp32] blocks {first}-{CLIP_BLOCKS - 1} and the "
          f"embeddings unfrozen ({n_train} parameters): {steps} steps of "
          f"{PROBE_E2E_BATCH} in {st['train_s']:.2f} s: "
          f"{st['train_s'] / steps * 1e3:.1f} ms a step, "
          f"{st['train_images'] / st['train_s']:.1f} images/s; losses "
          f"{trainer.history}; blocks 0-{first - 1} bitwise as built, the "
          f"trained ones all changed; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s in all ({gpu})")
    print(f"[probe e2e llava fp32] launches {launches}, recomputes "
          f"{recomputes}")
    run_name = trainer.run_name
    del trainer, before, module
    torch.cuda.empty_cache()
    return launches, root, run_name


def probe_test_phase(torch, np, gpu, root, base, run_name):
    """``test_probe.main`` on the end-to-end checkpoint."""
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import test_probe
    os.environ["VLM_TPU_ROOT"] = str(root)
    path, cfg = probe_config(root, base, "test_probe.yaml")
    _lib.reset_counts()
    t0 = time.perf_counter()
    tester = test_probe.main(["--config", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    n = PROBE_SPLITS["test"]
    batches = -(-n // cfg["common"]["data"]["batch_size"])
    _check_launches("[probe test]", launches, plain, {
        "flash_attention_fp32": CLIP_BLOCKS * batches,
        "normalize_fp32": batches, "flash_attention_diff_fp32": 0,
        "flash_attention_diff_fp32_bwd": 0})
    out = root / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "age" / "TestDataset"
    preds = json.loads((out / "preds.json").read_text())
    gts = json.loads((out / "gts.json").read_text())
    metrics = json.loads((out / "metrics.json").read_text())
    ds = DatasetFactory.create_dataset("TestDataset", split="test",
                                       base_path=str(base))
    direct = tester.model.predict([ds[i][0] for i in range(len(ds))])
    if len(preds) != n or len(gts) != n or \
            [p["age"] for p in preds] != direct.tolist():
        raise RuntimeError("[probe test] preds differ from the probe's own "
                           "argmax")
    print(f"[probe test] {run_name}: {n} test images in {wall:.1f} s, preds "
          f"= the probe's argmax, accuracy {metrics['average_accuracy']:.4f}"
          f" (random weights) ({gpu})")
    del tester
    torch.cuda.empty_cache()
    return launches


def probe_reference_phase(torch, np, gpu, card="cuda"):
    """A depth-cut CLIP-L/336 (2 blocks, full width) and a linear head
    (dropout 0) on the ``card`` and on the CPU from the same weights: one
    end-to-end step's loss and gradients (the last block and the
    embeddings unfrozen), fp32 on both sides."""
    from vlm_tpu_torch.models.backbone import VisionBackbone
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vit import ViTEncoder
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES
    from vlm_tpu_torch.probing.probes import LinearProbe
    from vlm_tpu_torch.probing.train.singletask_trainer import probe_loss
    full = VLM_CONFIGS["llava"]("7b")
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2))
    probes = {}
    for dev in (card, "cpu"):
        tower = ViTEncoder(cfg.vision, dtype=torch.float32, device=dev)
        bb = VisionBackbone(cfg, tower, torch.float32, RECIPES["llava"])
        probes[dev] = LinearProbe(bb, 9, dropout_p=0.0, seed=3)
    init_random_(probes[card].backbone.module, seed=2)
    for part in ("module", "classifier"):
        src, dst = (probes[d].classifier if part == "classifier"
                    else probes[d].backbone.module for d in (card, "cpu"))
        dst.load_state_dict({k: v.cpu() for k, v in
                             src.state_dict().items()})
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (4, 336, 336, 3), dtype=np.uint8)
    y = np.array([0, 3, 8, -1])
    cw = np.linspace(0.5, 1.5, 9).astype(np.float32)
    res = {}
    for dev, probe in probes.items():
        probe.unfreeze_last_backbone_k_layers(1)
        _lib.reset_counts()
        loss = probe_loss(probe, torch.from_numpy(u8), y,
                          torch.from_numpy(cw).to(dev), train=True)
        loss.backward()
        named = {**{f"head.{n}": p for n, p in
                    probe.classifier.named_parameters()},
                 **{f"backbone.{n}": p for n, p in
                    probe.backbone.module.named_parameters()
                    if p.requires_grad}}
        res[dev] = (float(loss.detach()),
                    {n: p.grad.cpu() for n, p in named.items()
                     if p.grad is not None}, dict(_lib.launches),
                    dict(_lib.recomputes))
    _lib.reset_counts()
    (card_loss, grads, launches, recomputes), (cpu_loss, ref, _, cpu_re) = \
        res[card], res["cpu"]
    # the card's backward kernel where the CPU recomputed, and no recompute
    if launches["flash_attention_diff_fp32"] != 2 or set(grads) != set(ref) \
            or launches["flash_attention_diff_fp32_bwd"] != \
            cpu_re["flash_attention_diff_fp32"] or any(recomputes.values()):
        raise RuntimeError(f"[probe reference] launches {launches}, "
                           f"recomputes {recomputes} (the CPU's {cpu_re}), "
                           f"gradients {sorted(set(grads) ^ set(ref))}")
    if not grads["backbone.blocks.1.attn.q_proj.weight"].abs().max() > 0:
        raise RuntimeError("[probe reference] no gradient reached q_proj "
                           "through B1")
    # zero in exact arithmetic, rounding noise on both sides: the key bias
    # (softmax ignores it) and the last block's fc2 bias (a shift of every
    # sample's features, which the training-mode BatchNorm removes); held
    # to tol x the step's largest gradient instead of their own
    noise = ("backbone.blocks.1.attn.k_proj.bias",
             "backbone.blocks.1.fc2.bias")
    largest = max(float(g.abs().max()) for g in ref.values())
    worst, worst_name = abs(card_loss - cpu_loss) / abs(cpu_loss), "loss"
    for n, g in ref.items():
        scale = largest if n in noise else float(g.abs().max())
        err = float((grads[n] - g).abs().max()) / scale
        if err > worst:
            worst, worst_name = err, n
    print(f"[probe reference] depth-cut CLIP-L/336 (2 blocks, full width), "
          f"a linear head, one end-to-end step with block 1 and the "
          f"embeddings unfrozen: loss {card_loss:.6f} (cpu {cpu_loss:.6f}), "
          f"{len(ref)} gradients, max |card - cpu| / max|cpu| = "
          f"{worst:.3e} at {worst_name} (tol {REF_TOL_FP32:.0e}; "
          f"{', '.join(noise)}: / the largest gradient {largest:.3e}, their "
          f"own max|cpu| "
          f"{', '.join(f'{float(ref[n].abs().max()):.1e}' for n in noise)})"
          f" ({gpu})")
    if not worst <= REF_TOL_FP32:
        raise RuntimeError("[probe reference] card disagrees with the CPU")


class _Tee:
    """Writes to the real stdout and keeps a copy (a run's log lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def busy_share(torch, trainer, steps=BUSY_STEPS):
    """``steps`` more training steps from the trainer's own loader (its
    prefetch thread decoding and augmenting) under ``torch.profiler``: the
    wall ms a step, the device's kernel ms a step, their ratio (the
    device's busy share; None where the profiler saw no device time) and
    the largest kernels (ms a step, launches a step)."""
    from torch.profiler import ProfilerActivity, profile
    batches = iter(trainer.train_loader)
    next(batches)                 # the prefetch thread is running
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_batch(next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    batches.close()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    dev = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:48]} {ms:.1f} ({n:g})" for ms, n, k in rows[:5])
    return wall, dev, (dev / wall if dev > 0 else None), top


def _step_line(st, peak, busy):
    wall, dev, share, top = busy
    step_ms = st["train_s"] / st["train_steps"] * 1e3
    share = "not measured" if share is None else f"{share:.3f}"
    return (f"{st['train_steps']} steps of {PROBE_E2E_BATCH} in "
            f"{st['train_s']:.2f} s: {step_ms:.1f} ms a step, "
            f"{st['train_images'] / st['train_s']:.1f} images/s; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; {BUSY_STEPS} more "
            f"steps profiled: {wall:.1f} ms a step, device {dev:.1f} ms, "
            f"busy share {share}; largest kernels, ms (launches) a step: "
            f"{top}")


def probe_multi_phase(torch, gpu, tmp, base):
    """``train_probe --profile multi`` at batch 32 for 2 epochs; returns
    the launches, the project root and the run name."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import train_probe
    root = probe_root(tmp, "probe_multi", base)
    path, cfg = probe_config(root, base, "train_probe.yaml", **{
        "train.epochs": 2, "data.batch_size": PROBE_E2E_BATCH})
    trainer = train_probe.build_trainer(["--config", str(path), "--profile",
                                         "multi"])
    if len(trainer.train_loader.dataset) != PROBE_MULTI_TRAIN or \
            not trainer.use_sampler or trainer.augment is None:
        raise RuntimeError(f"[probe multi] {len(trainer.train_loader.dataset)}"
                           f" train rows, sampler {trainer.use_sampler}")
    module = trainer.probe.backbone.module
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    _lib.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    recomputes = dict(_lib.recomputes)
    peak = torch.cuda.max_memory_allocated()
    st = trainer.last_stats
    steps = st["train_steps"]
    val = 2 * -(-PROBE_SPLITS["val"] // PROBE_E2E_BATCH)
    _check_launches("[probe multi]", launches, plain, {
        "flash_attention_diff_fp32": CLIP_BLOCKS * steps,
        "flash_attention_diff_fp32_bwd": CLIP_BLOCKS * steps,
        "flash_attention_fp32": CLIP_BLOCKS * (steps + val),
        "normalize_fp32": steps + val})
    if steps != 2 * -(-PROBE_MULTI_TRAIN // PROBE_E2E_BATCH) or \
            any(recomputes.values()):
        raise RuntimeError(f"[probe multi] {steps} steps, recomputes "
                           f"{recomputes}")
    # epoch 2 ran on the loss EMA's task weights: logged, mean 1, not the
    # static ones
    w = trainer.current_task_weights
    static = trainer.static_task_weights
    if "[Weights][Epoch 2]" not in tee.text() or \
            abs(sum(w.values()) / len(w) - 1.0) > 1e-9 or \
            max(abs(w[t] - static[t]) for t in w) < 1e-6 or \
            any(trainer.rm.get(t) is None for t in w):
        raise RuntimeError(f"[probe multi] epoch-2 task weights {w}")
    first = CLIP_BLOCKS - cfg["multi"]["model"]["backbone"]["unfreeze_last_k"]
    _check_trained(torch, "[probe multi]", module, before, first)
    del before
    busy = busy_share(torch, trainer)
    print(f"[probe multi llava fp32] {'/'.join(trainer.tasks)} over one "
          f"tower, {PROBE_MULTI_TRAIN} balanced train rows, the weighted "
          f"sampler and augmentation, blocks {first}-{CLIP_BLOCKS - 1} and "
          f"the embeddings unfrozen: {_step_line(st, peak, busy)}; epoch-2 "
          f"task weights {({t: round(v, 4) for t, v in w.items()})}; "
          f"losses {trainer.history}; blocks 0-{first - 1} bitwise as "
          f"built; {wall:.1f} s in all ({gpu})")
    print(f"[probe multi llava fp32] launches {launches}, recomputes "
          f"{recomputes}")
    run_name = trainer.run_name
    del trainer, module
    torch.cuda.empty_cache()
    return launches, root, run_name


def probe_lora_phase(torch, gpu, tmp, base):
    """The single profile with the shipped ``lora:`` block enabled, the
    tower frozen, at batch 32 for an epoch; returns the launches and the
    project root."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.probing.train.utils import load_tensors
    from vlm_tpu_torch.scripts import train_probe
    root = probe_root(tmp, "probe_lora", base)
    path, cfg = probe_config(root, base, "train_probe.yaml", **{
        "train.epochs": 1, "data.batch_size": PROBE_E2E_BATCH,
        "model.lora.enabled": True})
    trainer = train_probe.build_trainer(["--config", str(path)])
    spec = trainer.lora_spec
    adapted = sorted({int(n.split(".")[1]) for n in trainer.lora})
    if spec["last_k"] != LORA_BLOCKS or not trainer.probe.fully_frozen or \
            trainer.use_feature_cache or \
            adapted != list(range(CLIP_BLOCKS - LORA_BLOCKS, CLIP_BLOCKS)):
        raise RuntimeError(f"[probe lora] spec {spec}, adapted {adapted}")
    module = trainer.probe.backbone.module
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
    recomputes = dict(_lib.recomputes)
    peak = torch.cuda.max_memory_allocated()
    st = trainer.last_stats
    steps = st["train_steps"]
    val = -(-PROBE_SPLITS["val"] // PROBE_E2E_BATCH)
    _check_launches("[probe lora]", launches, plain, {
        "flash_attention_diff_fp32": LORA_BLOCKS * steps,
        "flash_attention_diff_fp32_bwd": LORA_BLOCKS * steps,
        "flash_attention_fp32": CLIP_BLOCKS * (steps + val),
        "normalize_fp32": steps + val})
    if steps != -(-PROBE_SPLITS["train"] // PROBE_E2E_BATCH) or \
            any(recomputes.values()):
        raise RuntimeError(f"[probe lora] {steps} steps, recomputes "
                           f"{recomputes}")
    moved = [n for n, p in module.named_parameters()
             if not torch.equal(p.detach(), before[n]) or p.grad is not None]
    zero_b = [n for n, ab in trainer.lora.items() if not ab["B"].any()]
    saved = load_tensors(trainer.model_file)
    n_lora = sum(k.startswith("lora.") for k in saved)
    if moved or zero_b or n_lora != 2 * len(trainer.lora) or \
            any(k.startswith("backbone.") for k in saved):
        raise RuntimeError(f"[probe lora] base weights moved {moved[:8]}, "
                           f"B still zero {zero_b[:8]}, checkpoint "
                           f"{sorted(saved)[:8]}")
    del before
    busy = busy_share(torch, trainer)
    n_adapter = sum(t.numel() for ab in trainer.lora.values()
                    for t in ab.values())
    print(f"[probe lora llava fp32] rank {spec['rank']}, alpha "
          f"{spec['alpha']}, {len(trainer.lora)} adapters on blocks "
          f"{adapted} ({n_adapter} parameters), the tower frozen: "
          f"{_step_line(st, peak, busy)}; losses {trainer.history}; every "
          f"base weight bitwise as built, every B moved; the checkpoint "
          f"holds {n_lora} adapter tensors and no tower; {wall:.1f} s in "
          f"all ({gpu})")
    print(f"[probe lora llava fp32] launches {launches}, recomputes "
          f"{recomputes}")
    del trainer, module
    torch.cuda.empty_cache()
    return launches, root


def probe_multi_test_phase(torch, gpu, multi_root, lora_root, base,
                           run_name):
    """``test_probe --profile multi`` on the multi checkpoint, then the
    single tester on the LoRA checkpoint."""
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.scripts import test_probe
    n = PROBE_SPLITS["test"]
    total = dict.fromkeys(_lib.KERNELS, 0)
    lines = []
    for root, profile in ((multi_root, "multi"), (lora_root, "single")):
        os.environ["VLM_TPU_ROOT"] = str(root)
        path, cfg = probe_config(root, base, "test_probe.yaml")
        _lib.reset_counts()
        t0 = time.perf_counter()
        tester = test_probe.main(["--config", str(path), "--profile",
                                  profile])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(_lib.launches), dict(_lib.plain_calls)
        recomputes = dict(_lib.recomputes)
        tasks = list(tester.iter_tasks())
        batches = len(tasks) * -(-n // cfg["common"]["data"]["batch_size"])
        _check_launches(f"[probe {profile} test]", launches, plain, {
            "flash_attention_fp32": CLIP_BLOCKS * batches,
            "normalize_fp32": batches, "flash_attention_diff_fp32": 0,
        "flash_attention_diff_fp32_bwd": 0})
        if any(recomputes.values()):
            raise RuntimeError(f"[probe {profile} test] recomputes "
                               f"{recomputes}")
        for k, v in launches.items():
            total[k] += v
        ds = DatasetFactory.create_dataset("TestDataset", split="test",
                                           base_path=str(base))
        images = [ds[i][0] for i in range(len(ds))]
        direct = tester.model.predict(images)
        accs = {}
        for t in tasks:
            out = root / "probing" / ("multitask_probing" if profile ==
                                      "multi" else "linear_probing") / \
                "eval" / (run_name if profile == "multi" else
                          "llava_fp32_linear") / t / "TestDataset"
            preds = json.loads((out / "preds.json").read_text())
            gts = json.loads((out / "gts.json").read_text())
            metrics = json.loads((out / "metrics.json").read_text())
            want = direct[t] if profile == "multi" else direct
            if len(preds) != n or len(gts) != n or \
                    [p[t] for p in preds] != want.tolist():
                raise RuntimeError(f"[probe {profile} test] {t}: preds "
                                   f"differ from the probe's own argmax")
            accs[t] = round(metrics["average_accuracy"], 4)
        lines.append(f"{profile}: {tasks} on {n} test images in {wall:.1f} "
                     f"s, accuracy {accs}")
        del tester
        torch.cuda.empty_cache()
    print(f"[probe multi test] {'; '.join(lines)} (random weights); preds "
          f"= each head's argmax; the LoRA tester merged its adapters at "
          f"load: no differentiable form ({gpu})")
    return total


def probe_multi_reference_phase(torch, np, gpu, card="cuda"):
    """A depth-cut CLIP-L/336 (2 blocks, full width), three heads (dropout
    0), LoRA on the last block's attention with A and B drawn nonzero from
    a seed (training starts B at zero, where A's first gradient is zero in
    exact arithmetic), and uncertainty weighting, on the ``card`` and on
    the CPU from the same weights: one step's loss and the gradients of
    A, B, the log-variances and the heads, fp32 on both sides."""
    from vlm_tpu_torch.models.backbone import VisionBackbone
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vit import ViTEncoder
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES
    from vlm_tpu_torch.probing.lora import (lora_features, lora_named,
                                            resolve_lora)
    from vlm_tpu_torch.probing.probes import MultiTaskProbe
    from vlm_tpu_torch.probing.train.losses import UncertaintyWeighter
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        multitask_losses
    from vlm_tpu_torch.probing.train.utils import get_num_classes_for_task
    full = VLM_CONFIGS["llava"]("7b")
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2))
    tasks = {t: get_num_classes_for_task(t) for t in PROBE_TASKS}
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (4, 336, 336, 3), dtype=np.uint8)
    ys = {"age": np.array([0, 3, 8, -1]), "gender": np.array([1, -1, 0, 1]),
          "emotion": np.array([-1, 6, 2, -1])}
    cw = {t: np.linspace(0.5, 1.5, n).astype(np.float32)
          for t, n in tasks.items()}
    b_draws = None
    runs = {}
    for dev in (card, "cpu"):
        tower = ViTEncoder(cfg.vision, dtype=torch.float32, device=dev)
        bb = VisionBackbone(cfg, tower, torch.float32, RECIPES["llava"])
        probe = MultiTaskProbe(bb, tasks, dropout_p=0.0, seed=3)
        # the card's weights (the heads' too: a generator on the card
        # draws other values than one on the CPU) copied to the CPU
        if dev == card:
            init_random_(tower, seed=2)
            state = {k: v.cpu() for k, v in probe.state_tensors(
                with_backbone=False).items()}
            state.update({f"tower.{k}": v.cpu()
                          for k, v in tower.state_dict().items()})
        else:
            tower.load_state_dict({k[len("tower."):]: v
                                   for k, v in state.items()
                                   if k.startswith("tower.")})
            probe.load_state_tensors(state, with_backbone=False)
        spec, lora = resolve_lora({"lora": {"enabled": True, "last_k": 1}},
                                  bb, seed=4)
        if b_draws is None:
            gen = torch.Generator().manual_seed(6)
            b_draws = {n: 0.02 * torch.randn(ab["B"].shape, generator=gen)
                       for n, ab in lora.items()}
        log_vars = UncertaintyWeighter(list(tasks)).init_params(dev)
        with torch.no_grad():
            for n, ab in lora.items():
                ab["B"].copy_(b_draws[n])
            for v, s_t in zip(log_vars.values(), (0.1, -0.2, 0.3)):
                v.fill_(s_t)
        _lib.reset_counts()
        losses = multitask_losses(
            probe, torch.from_numpy(u8), ys,
            {t: torch.from_numpy(w).to(dev) for t, w in cw.items()},
            train=True, features=lora_features(bb, spec, lora))
        total = UncertaintyWeighter.combine(log_vars, losses)
        total.backward()
        named = {**{f"heads.{t}.{n}": p
                    for t, clf in probe.classifiers.items()
                    for n, p in clf.named_parameters()},
                 **{f"log_vars.{t}": v for t, v in log_vars.items()},
                 **lora_named(lora)}
        runs[dev] = (float(total.detach()),
                     {n: p.grad.cpu() for n, p in named.items()
                      if p.grad is not None},
                     dict(_lib.launches), dict(_lib.recomputes),
                     sum(p.grad is not None for p in tower.parameters()))
    _lib.reset_counts()
    (card_loss, grads, launches, recomputes, base_grads), \
        (cpu_loss, ref, _, cpu_re, _) = runs[card], runs["cpu"]
    if launches["flash_attention_diff_fp32"] != 1 or \
            launches["flash_attention_fp32"] != 2 or \
            launches["flash_attention_diff_fp32_bwd"] != 1 or \
            cpu_re["flash_attention_diff_fp32"] != 1 or \
            any(recomputes.values()) or base_grads or \
            set(grads) != set(ref) or len(grads) != len(named):
        raise RuntimeError(f"[probe multi reference] launches {launches}, "
                           f"recomputes {recomputes}, base gradients "
                           f"{base_grads}, gradients "
                           f"{sorted(set(named) - set(grads))}")
    if not grads["lora.blocks.1.attn.q_proj.A"].abs().max() > 0:
        raise RuntimeError("[probe multi reference] no gradient reached A "
                           "of q_proj through B1")
    worst, worst_name = abs(card_loss - cpu_loss) / abs(cpu_loss), "loss"
    for n, g in ref.items():
        err = float((grads[n] - g).abs().max()) / float(g.abs().max())
        if err > worst:
            worst, worst_name = err, n
    print(f"[probe multi reference] depth-cut CLIP-L/336 (2 blocks, full "
          f"width), heads {list(tasks)}, LoRA on block 1's attention (A "
          f"and B nonzero), uncertainty weighting, one step: loss "
          f"{card_loss:.6f} (cpu {cpu_loss:.6f}), {len(ref)} gradients, max "
          f"|card - cpu| / max|cpu| = {worst:.3e} at {worst_name} (tol "
          f"{REF_TOL_FP32:.0e}); B1's differentiable form in block 1 only "
          f"({gpu})")
    if not worst <= REF_TOL_FP32:
        raise RuntimeError("[probe multi reference] card disagrees with the "
                           "CPU")


def probe_phases(torch, np, gpu, launches, tmp, base):
    """The probing phases on the dataset under ``base``, adding their
    launch counts into ``launches``."""
    t0 = time.perf_counter()
    for phase in ("cache", "e2e", "test"):
        t1 = time.perf_counter()
        if phase == "cache":
            path = probe_cache_phase(torch, gpu, tmp, base)
        elif phase == "e2e":
            path, root, run_name = probe_e2e_phase(torch, gpu, tmp, base)
        else:
            path = probe_test_phase(torch, np, gpu, root, base, run_name)
        for name, n in path.items():
            launches[name] += n
        print(f"[time] probe {phase} {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    probe_reference_phase(torch, np, gpu)
    print(f"[time] probe reference {time.perf_counter() - t1:.1f} s")
    for phase in ("multi", "lora", "multi test"):
        t1 = time.perf_counter()
        if phase == "multi":
            path, multi_root, multi_run = probe_multi_phase(torch, gpu, tmp,
                                                            base)
        elif phase == "lora":
            path, lora_root = probe_lora_phase(torch, gpu, tmp, base)
        else:
            path = probe_multi_test_phase(torch, gpu, multi_root, lora_root,
                                          base, multi_run)
        for name, n in path.items():
            launches[name] += n
        print(f"[time] probe {phase} {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    probe_multi_reference_phase(torch, np, gpu)
    print(f"[time] probe multi reference {time.perf_counter() - t1:.1f} s")
    print(f"[time] probing {time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from vlm_tpu_torch.ops import _lib
        from vlm_tpu_torch.testing.kernel_checks import (FORM_SOURCES,
                                                         KERNELS)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    gpu = device_phase(torch)
    pool = start_mesh_pool()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        _lib.lib()
        print(f"[build] kernels from vlm_tpu_torch/csrc: "
              f"{time.perf_counter() - t0:.1f} s (nvcc "
              f"{_lib.last_build['seconds']:.1f} s) ({gpu})")
        t0 = time.perf_counter()
        records = kernel_phase(gpu)
        print(f"[time] kernels {time.perf_counter() - t0:.1f} s")
        launches = dict.fromkeys(_lib.KERNELS, 0)
        pali = tmp / "paligemma"
        run_phases(torch, np, gpu, launches, tmp, pali)
        base = probe_data(np, tmp)
        t0 = time.perf_counter()
        generation_phases(torch, np, gpu, launches, tmp, pali, base)
        print(f"[time] generation {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_phases(torch, np, gpu, launches, tmp, pali, base, pool)
        print(f"[time] mesh {time.perf_counter() - t0:.1f} s")
        probe_mesh_phases(torch, np, gpu, launches, tmp, pali, base, pool)
        close_mesh_pool(pool)
        shutil.rmtree(pali)
        t0 = time.perf_counter()
        sweep_phase(torch, gpu, tmp, base, launches)
        print(f"[time] sweep {time.perf_counter() - t0:.1f} s")
        probe_phases(torch, np, gpu, launches, tmp, base)
    finally:
        close_mesh_pool(pool)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[time] all phases {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for key, meta in KERNELS.items():
        forms = []
        for form in meta["forms"]:
            mine = [r for r in records if r["form"] == form]
            main_case = next((r for r in mine if r["on_path"]), mine[0])
            forms.append({
                "form": form,
                "source": FORM_SOURCES.get(form, meta["source"]),
                "launches": launches[form],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "device_ms": main_case["device_ms"],
                "library_device_ms": main_case["library_device_ms"],
                "baseline_device_ms": main_case["baseline_device_ms"],
                "library": main_case["library_note"],
                "case": main_case["case"]})
        main = forms[0]
        entry = {
            "name": meta["name"], "route": "cuda", "source": main["source"],
            "replaces": meta["replaces"],
            "launches": sum(f["launches"] for f in forms),
            "max_abs_err": max(f["max_abs_err"] for f in forms),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms", "library",
                                    "case")}}
        if len(forms) > 1:
            entry["forms"] = forms
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
