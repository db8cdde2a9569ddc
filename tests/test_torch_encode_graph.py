"""``VLMModule.encode_images`` as one CUDA graph of the tower and the
projector.

On the CPU: the calls the graph never takes (CPU pixels, grad mode on, a
mesh) give the eager encoding's output and spans and count under
``encode_eager``; a batcher run carries ``encode_graph_replays`` = 0; the
launches a thread makes inside ``_lib.counting_into`` count there alone.

On the card (``-m cuda``; skipped without a GPU; run with ``--noconftest``
where JAX is absent): BLIP-2's encoding at its "test" size and at full
width cut in depth, for two batch sizes, and every family's at its "test"
size with bf16, fp32, int8 and int4 towers, the first call eager and
capturing, later ones replaying: bitwise the eager output, counted, its
kernels counted in ``_lib.launches`` and seen by the profiler; a kept
result survives the next call; a capture a host read refuses leaves the key
eager; a capture with another thread launching B4 holds, and that thread's
launches count as made; grad mode and a mesh stay eager on the card too.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vlm_tpu_torch.core.mesh import Mesh
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models import vlm as vlm_mod
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.layers import init_random_
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.utils import profiling

torch.set_num_threads(2)

MODES = {"no_grad": torch.no_grad, "inference": torch.inference_mode,
         "grad": torch.enable_grad}


def _blip2(device, dtype, mesh=None, depth_cut=False):
    cfg = VLM_CONFIGS["blip2"]("test")
    if depth_cut:
        full = VLM_CONFIGS["blip2"]("6.7b")
        cfg = dataclasses.replace(
            full, vision=dataclasses.replace(full.vision, layers=2),
            qformer=dataclasses.replace(full.qformer, layers=2),
            decoder=dataclasses.replace(full.decoder, layers=1))
    mod = VLMModule(cfg, dtype=dtype, device=device, mesh=mesh)
    return cfg, init_random_(mod, seed=0).eval()


# a tower's precision -> (compute dtype, vision_quant_bits)
TOWERS = {"bf16": (torch.bfloat16, 0), "fp32": (torch.float32, 0),
          "8bit": (torch.bfloat16, 8), "4bit": (torch.bfloat16, 4)}


def _patches(cfg, b, seed, device, dtype):
    v = cfg.vision
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(b, (v.image_size // v.patch_size) ** 2,
                       v.patch_size ** 2 * 3, generator=g, device=device,
                       dtype=torch.float32).to(dtype)


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events() if e.name in profiling.SPANS}


def _counts(mod):
    return {k: getattr(mod, k) for k in (
        "encode_eager", "encode_graph_replays", "encode_graph_captures")}


# ---------------------------------- CPU ----------------------------------

@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bypassed_calls_run_eager_as_before(mode, mesh):
    cfg, mod = _blip2("cpu", torch.float32,
                      Mesh(1, 1, groups=False) if mesh else None)
    px = _patches(cfg, 2, 0, "cpu", torch.float32)
    with torch.no_grad():
        want = mod._encode(px, False)
    for call in range(3):
        with MODES[mode]():
            got, opened = _spans(lambda: mod.encode_images(px))
        assert torch.equal(got, want)
        assert opened == {"vlm.vision", "vlm.projector"}
        assert _counts(mod) == {
            "encode_eager": call + 1, "encode_graph_replays": 0,
            "encode_graph_captures": 0}
    assert mod._encode_graphs == {}


def test_a_cpu_batcher_run_replays_no_graph():
    cfg, mod = _blip2("cpu", torch.float32)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    s = cfg.vision.image_size
    px = np.random.default_rng(0).normal(size=(6, s, s, 3)).astype(
        np.float32)
    b = ContinuousBatcher(mod, cfg, batch_size=3, max_prompt_len=plen,
                          max_new_tokens=3, admit_block=2, eos_id=-5)
    out = b.run(lambda idxs: torch.from_numpy(px[idxs]),
                pre_ids_row=np.zeros(0, np.int32), post_ids_row=post,
                prompt_len_scalar=plen, n_images=6)
    assert all(len(o) == 3 for o in out)
    assert b.last_stats["encode_graph_replays"] == 0
    assert mod.encode_eager == b.last_stats["admits"] == 3


def test_a_capture_counts_only_its_own_threads_launches(monkeypatch):
    """Inside ``counting_into`` this thread's launches go to the block's
    counts; another thread's, made meanwhile, to ``_lib.launches``."""
    class Handle:
        def vlm_normalize(self, *args):
            return 0
    monkeypatch.setattr(_lib, "lib", Handle)
    _lib.reset_counts()
    mine = {name: 0 for name in _lib.KERNELS}
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        for _ in range(3):
            _lib.launch("normalize", "vlm_normalize")
        done.set()
    t = threading.Thread(target=other)
    t.start()
    with _lib.counting_into(mine):
        _lib.launch("flash_attention", "vlm_normalize",
                    also="flash_attention_diff")
        inside.set()
        done.wait()
        _lib.launch("flash_attention", "vlm_normalize")
    t.join()
    _lib.launch("normalize", "vlm_normalize")
    assert {k: n for k, n in mine.items() if n} == {
        "flash_attention": 2, "flash_attention_diff": 1}
    assert {k: n for k, n in _lib.launches.items() if n} == {"normalize": 4}
    _lib.reset_counts()


# --------------------------------- card ----------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


SIZES = {"test": False, "depth_cut": True}


# (family, tower, size, batch): BLIP-2 at two sizes and batches; every
# family at its "test" size with each tower: SigLIP and its last layer,
# CLIP's penultimate layer with the CLS token dropped, EVA and the
# Q-Former; bf16, fp32, int8 and int4 vision products
BITWISE = [("blip2", "bf16", size, batch) for size in sorted(SIZES)
           for batch in (2, 8)] + [
    (family, tower, "test", 4) for family in ("blip2", "llava", "paligemma")
    for tower in sorted(TOWERS) if (family, tower) != ("blip2", "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("family,tower,size,batch", BITWISE)
def test_graph_replays_bitwise_the_eager_encoding(card, family, tower, size,
                                                  batch):
    """Four calls at one key: bitwise the eager encoding, each launching
    the eager encoding's kernels once (the first eager on the capture's
    stream, the others replays), a result kept from call 3 unchanged by
    call 4."""
    dtype, bits = TOWERS[tower]
    if family == "blip2" and not bits:
        cfg, mod = _blip2(card, dtype, depth_cut=SIZES[size])
    else:
        cfg = VLM_CONFIGS[family](size)
        mod = init_random_(VLMModule(cfg, dtype=dtype, device=card,
                                     vision_quant_bits=bits), seed=0).eval()
    pxs = [_patches(cfg, batch, seed, card, dtype) for seed in range(4)]
    with torch.inference_mode():
        want = [mod._encode(px, False) for px in pxs]
        _lib.reset_counts()
        mod._encode(pxs[0], False)
        torch.cuda.synchronize()
        eager_launches = dict(_lib.launches)
        got, kept = [], None
        for i, px in enumerate(pxs):
            _lib.reset_counts()
            got.append(mod.encode_images(px))
            torch.cuda.synchronize()
            assert _lib.launches == eager_launches
            if i == 2:
                kept = got[-1].clone()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a result kept from a replay outlives the next replay's other pixels
    assert torch.equal(got[2], kept) and not torch.equal(got[2], got[3])
    assert _counts(mod) == {
        "encode_eager": 1, "encode_graph_replays": 3,
        "encode_graph_captures": 1}


@pytest.mark.cuda
def test_replays_are_spanned_and_profiled(card):
    cfg, mod = _blip2(card, torch.bfloat16, depth_cut=True)
    px = _patches(cfg, 8, 0, card, torch.bfloat16)
    with torch.inference_mode():
        mod.encode_images(px)
        mod.encode_images(px)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mod.encode_images(px)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "vlm.encode_graph" in names
    assert "vlm.vision" not in names and "vlm.projector" not in names
    kernels = [e.name for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    assert any("flash_kernel" in n for n in kernels), kernels


@pytest.mark.cuda
def test_a_refused_capture_leaves_the_key_eager(card, monkeypatch):
    cfg, mod = _blip2(card, torch.bfloat16)
    px = _patches(cfg, 2, 0, card, torch.bfloat16)
    ln = mod.vision.post_ln
    forward = type(ln).forward

    def reads_the_host(self, x):
        if torch.cuda.is_current_stream_capturing():
            x.sum().item()
        return forward(self, x)
    monkeypatch.setattr(type(ln), "forward", reads_the_host)
    with torch.inference_mode():
        want = mod._encode(px, False)
        with pytest.warns(UserWarning, match="no CUDA graph"):
            first = mod.encode_images(px)
        second = mod.encode_images(px)
        # the card and its generators still work
        after = torch.ones(4, device=card) * 2
        drawn = torch.randn(4, device=card)
        torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(second, want)
    assert float(after.sum()) == 8.0 and bool(torch.isfinite(drawn).all())
    assert _counts(mod) == {
        "encode_eager": 2, "encode_graph_replays": 0,
        "encode_graph_captures": 0}
    assert mod._encode_graphs == {(tuple(px.shape), px.dtype, False):
                                  "eager"}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


@pytest.mark.cuda
def test_a_capture_beside_a_thread_enqueueing_work(card):
    """As the batcher's prefetch thread makes the next admission's pixels
    (an upload, an index_select, B4) while the main thread captures: the
    capture holds, the replays are bitwise, and ``_lib.launches`` counts
    the thread's B4 launches as it made them and the main thread's
    encodings once each."""
    from vlm_tpu_torch.generate.readback import upload
    from vlm_tpu_torch.ops.preprocess import normalize_images, recipe_for
    cfg, mod = _blip2(card, torch.bfloat16, depth_cut=True)
    s, p = cfg.vision.image_size, cfg.vision.patch_size
    pool = torch.randint(0, 256, (16, s, s, 3), device=card,
                         dtype=torch.uint8)
    recipe = recipe_for("blip2")
    stop, started, made = threading.Event(), threading.Event(), []

    def normalize(sel):
        return normalize_images(pool.index_select(0, sel), recipe=recipe,
                                compute_dtype=torch.bfloat16, patch_size=p)

    def prefetch():
        i = 0
        while not stop.is_set():
            made.append(normalize(upload(np.arange(i, i + 8) % 16, card)))
            started.set()
            i += 1
    _lib.reset_counts()
    px = normalize(upload(np.arange(8), card))
    per_normalize = dict(_lib.launches)
    with torch.inference_mode():
        _lib.reset_counts()
        want = mod._encode(px, False)
        torch.cuda.synchronize()
        per_encode = dict(_lib.launches)
        _lib.reset_counts()
        t = threading.Thread(target=prefetch)
        t.start()
        try:
            started.wait()
            got = [mod.encode_images(px) for _ in range(3)]
        finally:
            stop.set()
            t.join()
        torch.cuda.synchronize()
    assert made and mod.encode_graph_captures == 1
    assert all(torch.equal(g, want) for g in got)
    assert _lib.launches == {k: len(made) * per_normalize[k]
                             + 3 * per_encode[k] for k in _lib.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["grad", "mesh"])
def test_grad_mode_and_a_mesh_stay_eager_on_the_card(card, why):
    cfg, mod = _blip2(card, torch.bfloat16,
                      Mesh(1, 1, groups=False) if why == "mesh" else None)
    px = _patches(cfg, 2, 0, card, torch.bfloat16)
    ctx = torch.enable_grad if why == "grad" else torch.inference_mode
    with ctx():
        want = mod._encode(px, False)
        got, opened = _spans(lambda: [mod.encode_images(px)
                                      for _ in range(3)])
    assert all(torch.equal(g, want) for g in got)
    assert opened == {"vlm.vision", "vlm.projector"}
    assert mod.encode_eager == 3 and mod._encode_graphs == {}


@pytest.mark.cuda
def test_the_batcher_counts_its_replayed_admissions(card, monkeypatch):
    """Eight admissions of two: the first runs eager and captures, the
    rest replay; with no graph kept (a cap of 0) every admission runs
    eager and the tokens are the same."""
    cfg, _ = _blip2(card, torch.bfloat16)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    px = _patches(cfg, 16, 0, card, torch.bfloat16)
    runs = []
    for graphs in (vlm_mod.ENCODE_GRAPHS, 0):
        monkeypatch.setattr(vlm_mod, "ENCODE_GRAPHS", graphs)
        _, mod = _blip2(card, torch.bfloat16)
        b = ContinuousBatcher(mod, cfg, batch_size=4, max_prompt_len=plen,
                              max_new_tokens=4, admit_block=2, eos_id=-5)
        out = b.run(lambda idxs: px[idxs], pre_ids_row=np.zeros(
            0, np.int32), post_ids_row=post, prompt_len_scalar=plen,
            n_images=16)
        runs.append((out, dict(b.last_stats)))
    (graphed, st), (eager, st0) = runs
    assert st["encode_graph_replays"] == st["admits"] - 1 == 7
    assert st0["encode_graph_replays"] == 0 and st0["admits"] == 8
    assert graphed == eager
