"""One rank of a mesh serving run, launched under ``torchrun``:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m vlm_tpu_torch.testing.mesh_serve SPEC.json OUT_DIR

``SPEC.json`` (written by the caller) holds:

- ``family``, ``size``, ``quantization`` (``fp32`` default, ``bf16``,
  ``8bit``, ``4bit``; or ``dtype`` and ``bits`` explicitly), ``kv_cache``,
  ``quantize_vision``,
  ``int8_prefill`` (``VLM_TPU_INT8_PREFILL``), ``mesh`` (``{data,
  model}``), ``device`` (``cpu`` or ``cuda``);
- the weights: ``model_id`` (a checkpoint directory, loaded shard by
  shard), ``state`` (a ``torch.save`` file of the full state, e.g. a
  ``vlm_tpu`` model bridged by ``testing.bridge.flax_to_state_dict``; each
  rank loads its slice) or neither (random weights from ``seed``);
  ``layers`` ``[vision, decoder]`` builds a depth-cut copy of the size's
  config (then ``state`` or ``seed``, no ``model_id``), ``vision`` (with
  ``bits`` or ``layers``) replaces fields of the tower's config;
- the inputs: ``pixels`` (a ``.npy`` of normalized NHWC float pixels) or
  ``images`` (a ``.npy`` of uint8 NHWC images, normalized by B4 on the
  rank), ``pre_ids``, ``post_ids``, ``pad_id`` (optional);
- ``tasks``, run in order, each with its keyword arguments:
  ``logits`` (``n``, ``steps``, ``feed``: a prefill and greedy decode
  steps, every row's fp32 logits, written to ``logits_rank<r>.npy``),
  ``engine`` (``n``, ``new``: the wave engine's
  tokens), ``batcher`` (``n``, ``slots``, ``new``, ``admit``, ``caps``,
  ``sync_every``: the continuous batcher's tokens and counters; timed),
  ``dataset`` (``paths``, ``prompt``, ``new``, ``slots``, ``warmup``:
  ``generate_dataset``'s texts; timed), ``beam`` (``n``, ``new``, ``k``,
  ``eos``, ``length_penalty``: beam search's best tokens, lengths and
  scores; timed), ``beam_texts`` (``paths``, ``prompt``, ``new``, ``k``,
  ``batch``, ``wave``: ``generate_batch`` and ``generate_dataset`` with
  ``num_beams=k``), ``row_parallel`` (``k``, ``n``,
  ``rows``, ``bits``: bf16 row-parallel layers against the same layer
  whole on the rank).

Each rank writes ``OUT_DIR/rank<r>.json``: its place on the mesh, backend
and device, ``param_bytes`` and the bytes its parameters hold, each
task's results, the kernel launches and plain calls of each task, the
collectives' counts and bytes, and its peak device memory. Imports
nothing of ``vlm_tpu`` or JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _build(spec: dict):
    """(model or None, module, cfg, mesh, device, dtype, recipe)"""
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.models.base_model import policy_for
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule
    from vlm_tpu_torch.ops.preprocess import recipe_for
    from vlm_tpu_torch.parallel.sharding import shard_state_dict

    if spec.get("int8_prefill"):
        os.environ["VLM_TPU_INT8_PREFILL"] = spec["int8_prefill"]
    quant = spec.get("quantization", "fp32")
    mesh = mesh_from_config(spec["mesh"], spec.get("device"))
    if spec.get("layers") or "bits" in spec:
        # the module alone: a depth-cut copy, or explicit compute dtype and
        # weight bits (fp32 compute over int8 weights, as the CPU parity
        # tests hold vlm_tpu's)
        cfg = VLM_CONFIGS[spec["family"]](spec["size"])
        if spec.get("vision"):
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
                cfg.vision, **spec["vision"]))
        if spec.get("layers"):
            cfg = dataclasses.replace(
                cfg, vision=dataclasses.replace(cfg.vision,
                                                layers=spec["layers"][0]),
                decoder=dataclasses.replace(cfg.decoder,
                                            layers=spec["layers"][1]))
        policy = policy_for(quant)
        bits = spec.get("bits", policy.quantized_bits)
        dtype = getattr(torch, spec["dtype"]) if spec.get("dtype") else \
            policy.compute_dtype
        kw = dict(dtype=dtype, quant_bits=bits,
                  vision_quant_bits=bits if spec.get("quantize_vision")
                  else 0)
        module = VLMModule(cfg, device=mesh.device, mesh=mesh, **kw)
        if not spec.get("state"):
            init_random_(module, spec.get("seed", 0),
                         full=VLMModule(cfg, device="meta", **kw))
        model = None
    else:
        model = create_model(
            spec["family"], size=spec["size"], quantization=quant,
            model_id=spec.get("model_id"), seed=spec.get("seed", 0),
            mesh=mesh, device=spec.get("device"),
            kv_cache=spec.get("kv_cache"),
            quantize_vision=spec.get("quantize_vision"))
        module, cfg = model.module, model.cfg
    if spec.get("state"):
        full_sd = torch.load(spec["state"], map_location="cpu")
        own = module.state_dict()
        with torch.no_grad():
            for name, t in shard_state_dict(full_sd, module).items():
                own[name].copy_(t.to(mesh.device))
    module.eval()
    recipe = model.recipe if model is not None else recipe_for(spec["family"])
    if recipe.image_size != cfg.vision.image_size:
        recipe = dataclasses.replace(recipe, image_size=cfg.vision.image_size)
    return model, module, cfg, mesh, module.dtype, recipe


class _Inputs:
    """The spec's pixels (rows on demand, on the rank's device)."""

    def __init__(self, spec, cfg, device, dtype, recipe):
        from vlm_tpu_torch.ops.preprocess import normalize_images
        self.device, self.dtype = device, dtype
        self.u8 = np.load(spec["images"]) if spec.get("images") else None
        self.px = np.load(spec["pixels"]) if spec.get("pixels") else None
        self.norm = lambda u8: normalize_images(
            u8, recipe=recipe, compute_dtype=dtype,
            patch_size=cfg.vision.patch_size)

    def __call__(self, idxs):
        idxs = list(idxs)
        if self.u8 is not None:
            return self.norm(torch.from_numpy(self.u8[idxs]).to(self.device))
        return torch.from_numpy(self.px[idxs]).to(self.device, self.dtype)


def _ids(spec, n, device):
    i32 = dict(dtype=torch.int32, device=device)
    pre = torch.tensor([spec["pre_ids"]] * n, **i32).reshape(
        n, len(spec["pre_ids"]))
    post = torch.tensor([spec["post_ids"]] * n, **i32).reshape(
        n, len(spec["post_ids"]))
    return pre, post


def _counts():
    from vlm_tpu_torch.ops import _lib
    return {"launches": {k: v for k, v in _lib.launches.items() if v},
            "plain_calls": {k: v for k, v in _lib.plain_calls.items() if v}}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def task_logits(module, cfg, mesh, inputs, spec, n=2, steps=3, feed=None):
    """A prefill of ``n`` images and ``steps`` greedy decode steps (each
    row at its own position, ``kv_len``), every row's fp32 logits; the
    tokens fed are the greedy ones, or ``feed[step]`` (another run's, so
    that two runs stay on the same tokens)."""
    from vlm_tpu_torch.core.mesh import DATA_AXIS
    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.vlm import num_image_tokens
    dev = mesh.device
    r = mesh.rows(n)
    pre, post = _ids(spec, n, dev)
    plen = len(spec["pre_ids"]) + num_image_tokens(cfg) + \
        len(spec["post_ids"])
    pl = torch.full((n,), plen, dtype=torch.int32, device=dev)
    cache = init_kv_cache(cfg.decoder, r.stop - r.start, plen + steps,
                          spec.get("kv_cache") or module.dtype, dev,
                          kv_heads=module.decoder.kv_heads)
    out = []
    with torch.inference_mode():
        last = module.prefill(inputs(range(n)[r]), pre[r], post[r], cache,
                              pl[r])
        logits = mesh.all_gather(last.float(), DATA_AXIS, 0)
        out.append(logits.cpu())
        for step in range(steps):
            tok = logits.argmax(-1).int() if feed is None else \
                torch.tensor(feed[step], dtype=torch.int32, device=dev)
            last = module.decode_step(tok[r, None], (pl + step)[r], cache)
            logits = mesh.all_gather(last.float(), DATA_AXIS, 0)
            out.append(logits.cpu())
    return {"logits": torch.stack(out).numpy(), "prompt_len": plen,
            "fed": [t.argmax(-1).tolist() for t in out[:-1]]}


def task_engine(module, cfg, mesh, inputs, spec, n=4, new=6):
    """The wave engine over ``n`` images: every row's tokens and
    lengths."""
    from vlm_tpu_torch.generate.decode import GenerationEngine
    from vlm_tpu_torch.models.vlm import num_image_tokens
    dev = mesh.device
    r = mesh.rows(n)
    pre, post = _ids(spec, n, dev)
    plen = len(spec["pre_ids"]) + num_image_tokens(cfg) + \
        len(spec["post_ids"])
    eng = GenerationEngine(module, cfg, batch_size=n, max_prompt_len=plen,
                           max_new_tokens=new,
                           cache_dtype=spec.get("kv_cache"),
                           pad_id=spec.get("pad_id"))
    res = eng.generate(inputs(range(n)[r]), pre, post,
                       torch.full((n,), plen, dtype=torch.int32, device=dev))
    return {"tokens": res.tokens.cpu().tolist(),
            "lengths": res.lengths.cpu().tolist(),
            "stats": {k: v for k, v in eng.last_stats.items()
                      if not k.endswith("_s")}}


def task_beam(module, cfg, mesh, inputs, spec, n=4, new=6, k=2, eos=None,
              length_penalty=1.0):
    """Beam search over ``n`` images (each data rank its own images' K
    beams): every image's best tokens, lengths and scores."""
    from vlm_tpu_torch.generate.beam import BeamSearchEngine
    from vlm_tpu_torch.models.vlm import num_image_tokens
    dev = mesh.device
    r = mesh.rows(n)
    pre, post = _ids(spec, n, dev)
    plen = len(spec["pre_ids"]) + num_image_tokens(cfg) + \
        len(spec["post_ids"])
    eng = BeamSearchEngine(module, cfg, batch_size=n, max_prompt_len=plen,
                           num_beams=k, max_new_tokens=new,
                           length_penalty=length_penalty,
                           cache_dtype=spec.get("kv_cache"), eos_id=eos,
                           pad_id=spec.get("pad_id"))
    _sync(dev)
    t0 = time.perf_counter()
    res = eng.generate(inputs(range(n)[r]), pre, post,
                       torch.full((n,), plen, dtype=torch.int32, device=dev))
    _sync(dev)
    return {"tokens": res.tokens.cpu().tolist(),
            "lengths": res.lengths.cpu().tolist(),
            "scores": res.scores.cpu().tolist(),
            "wall_s": time.perf_counter() - t0,
            "stats": {k: v for k, v in eng.last_stats.items()
                      if not k.endswith("_s")}}


def task_beam_texts(model, mesh, spec, paths, prompt, new=6, k=2, batch=3,
                    wave=4):
    """The user's beam entry points: ``generate_batch`` over the first
    ``batch`` image files and ``generate_dataset`` over all of them in
    waves of ``wave`` (both padded to a multiple of ``data``)."""
    from PIL import Image
    images = [Image.open(p).convert("RGB") for p in paths[:batch]]
    _sync(mesh.device)
    t0 = time.perf_counter()
    batch_texts = model.generate_batch(images, prompt, max_tokens=new,
                                       num_beams=k)
    texts = model.generate_dataset(paths, prompt, max_tokens=new,
                                   batch_size=wave, num_beams=k)
    _sync(mesh.device)
    return {"batch_texts": batch_texts, "texts": texts,
            "wall_s": time.perf_counter() - t0}


def _recording():
    """A :class:`ContinuousBatcher` that records, at each admission, the
    slots the device chooses (the host's mirror is gone after the run),
    and keeps its last instance."""
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher

    class Recording(ContinuousBatcher):
        last = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.chosen = []
            Recording.last = self

        def _admit(self, state, cache, pixels, *a):
            self.chosen.append(torch.argsort(
                state["occ"].to(torch.int8), stable=True)[:pixels.shape[0]])
            return super()._admit(state, cache, pixels, *a)

        def served_here(self, n):
            """The images the run admitted into this rank's slots."""
            blocks = [range(i, min(i + self.admit_block, n))
                      for i in range(0, n, self.admit_block)]
            return [int(img) for blk, s in zip(blocks, self.chosen)
                    for img, slot in zip(blk, s.tolist())
                    if self.local.start <= slot < self.local.stop]

        def report(self, n) -> dict:
            return {"stats": {k: v for k, v in self.last_stats.items()
                              if not k.endswith("_s")},
                    "admit_block": self.admit_block,
                    "images_served_here": self.served_here(n),
                    "latency_s": self.last_latency_s}
    return Recording


def task_batcher(module, cfg, mesh, inputs, spec, n=6, slots=4, new=6,
                 admit=None, caps=None, sync_every=0):
    """The continuous batcher over ``n`` images: token lists in input
    order, ``admits``/``chunks``/steps, the images each data rank's slots
    served, img/s."""
    from vlm_tpu_torch.models.vlm import num_image_tokens
    plen = len(spec["pre_ids"]) + num_image_tokens(cfg) + \
        len(spec["post_ids"])
    b = _recording()(
        module, cfg, batch_size=slots, max_prompt_len=plen,
        max_new_tokens=new, admit_block=admit,
        cache_dtype=spec.get("kv_cache"), pad_id=spec.get("pad_id"),
        sync_every=sync_every)
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = b.run(inputs, pre_ids_row=np.asarray(spec["pre_ids"], np.int32),
                post_ids_row=np.asarray(spec["post_ids"], np.int32),
                prompt_len_scalar=plen, n_images=n, max_new_per_image=caps)
    _sync(mesh.device)
    wall = time.perf_counter() - t0
    return {"tokens": out, "wall_s": wall, "img_per_s": n / wall,
            **b.report(n)}


def task_dataset(model, mesh, spec, paths, prompt, new=16, slots=32,
                 warmup=0):
    """``generate_dataset`` over image files, the user's entry point:
    texts in input order, img/s, and the batcher's counters; ``warmup``
    images first, outside the counts and the clock."""
    from vlm_tpu_torch.models import base_model
    from vlm_tpu_torch.ops import _lib
    rec = _recording()
    real, base_model.ContinuousBatcher = base_model.ContinuousBatcher, rec
    try:
        if warmup:
            model.generate_dataset(paths[:warmup], prompt, max_tokens=2,
                                   batch_size=slots)
            _sync(mesh.device)
            _lib.reset_counts()
            mesh.counts.clear()
        t0 = time.perf_counter()
        texts = model.generate_dataset(paths, prompt, max_tokens=new,
                                       batch_size=slots)
        _sync(mesh.device)
        wall = time.perf_counter() - t0
    finally:
        base_model.ContinuousBatcher = real
    return {"texts": texts, "wall_s": wall, "img_per_s": len(paths) / wall,
            **rec.last.report(len(paths))}


def task_row_parallel(module, cfg, mesh, inputs, spec, k=256, n=128,
                      rows=(4, 512), bits=(0, 8, 4), seed=0):
    """Row-parallel bf16 ``Dense`` layers of ``k`` inputs and ``n``
    outputs (float, int8 and int4 weights, with a bias) over the model
    group against the same layer whole on this rank, at each of ``rows``
    (B5 and B7 below 512 rows; llm.int8 and the dequantized product from
    512). The inputs' two halves of K nearly cancel (``x = [x0, d - x0]``
    over the same weights twice), so each rank's partial product is tens
    of times the output: a partial rounded to bf16 before the sum would
    miss by several of the output's bf16 steps, one rounding after it by
    at most one. For each case: ``err_steps``, max |sharded - whole| in
    steps (2^-7 of the largest power of two <= max |whole|), and
    ``naive_steps``, the same for the partials rounded to bf16 first
    (None at ``model == 1``, where the layer is whole)."""
    from vlm_tpu_torch.core.mesh import MODEL_AXIS
    from vlm_tpu_torch.models.layers import Dense, int4_group_size
    from vlm_tpu_torch.ops.quant import quantize_int4, quantize_int8
    from vlm_tpu_torch.parallel.sharding import shard_state_dict
    dev, bf16 = mesh.device, torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    w0 = torch.randn(n, k // 2, generator=gen) / (k // 2) ** 0.5
    w = torch.cat([w0, w0], 1)
    bias = torch.randn(n, generator=gen) * 0.05
    cases = []
    for b in bits:
        whole = Dense(k, n, dtype=bf16, device=dev, quant_bits=b)
        part = Dense(k, n, dtype=bf16, device=dev, quant_bits=b,
                     shard=(MODEL_AXIS, None), mesh=mesh)
        if b == 8:
            qw = quantize_int8(w)
        elif b == 4:
            qw = quantize_int4(w, int4_group_size(k))
        full = {"bias": bias.to(bf16)}
        full.update({"q": qw.q, "scale": qw.scale} if b else
                    {"weight": w.to(bf16)})
        with torch.no_grad():
            for mod, sd in ((whole, full), (part, shard_state_dict(full,
                                                                   part))):
                for name, t in sd.items():
                    getattr(mod, name).copy_(t.to(dev))
        partials = []
        finish = part._finish
        part._finish = lambda y: (partials.append(y.clone()), finish(y))[1]
        for m in rows:
            x0 = torch.randn(m, k // 2, generator=gen)
            d = torch.randn(m, k // 2, generator=gen) / 32
            x = torch.cat([x0, d - x0], 1).to(bf16).to(dev)
            partials.clear()
            with torch.inference_mode():
                want = whole(x).float()
                # a row-parallel rank takes its slice of K (the column-
                # parallel layer before it gives it only that)
                got = part(x[:, part.comm.k_lo:part.comm.k_lo +
                             part.in_dim]).float()
            top = float(want.abs().max())
            step = 2.0 ** (np.floor(np.log2(top)) - 7)
            case = {"bits": b, "rows": m,
                    "err_steps": float((got - want).abs().max()) / step,
                    "naive_steps": None, "partial_over_out": None}
            if partials:
                naive = mesh.all_reduce(partials[0].to(bf16).float(),
                                        MODEL_AXIS)
                naive = ((naive.to(bf16).float() if b else naive)
                         + bias.to(bf16).float().to(dev)).to(bf16).float()
                case.update(
                    naive_steps=float((naive - want).abs().max()) / step,
                    partial_over_out=float(partials[0].abs().max()) / top)
            cases.append(case)
    return {"cases": cases}


def _asked_bytes() -> int:
    """The bytes this process's tensors ask of the current CUDA device (0
    before CUDA has been touched)."""
    if not torch.cuda.is_initialized():
        return 0
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def run(spec: dict, out_dir: Path) -> dict:
    """The spec's model and tasks on this rank; writes and returns its
    record. The process group stays formed (see ``mesh_pool``)."""
    torch.set_num_threads(int(spec.get("threads", 2)))
    from vlm_tpu_torch.models.vlm import param_bytes
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.parallel.sharding import assert_params_sharded
    before = _asked_bytes()
    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, module, cfg, mesh, dtype, recipe = _build(spec)
    build_s = time.perf_counter() - t0
    assert_params_sharded(module, mesh)
    dev = mesh.device
    inputs = _Inputs(spec, cfg, dev, dtype, recipe)
    bits = spec.get("bits", {"8bit": 8, "4bit": 4}.get(
        spec.get("quantization"), 0))
    record = {
        "rank": mesh.rank, "data_rank": mesh.data_rank,
        "model_rank": mesh.model_rank, "backend": mesh.backend,
        "device": str(dev),
        "gpu": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "",
        "build_s": build_s,
        "param_bytes": param_bytes(
            cfg, dtype=dtype, quant_bits=bits,
            vision_quant_bits=bits if spec.get("quantize_vision") else 0,
            model_ways=mesh.model),
        "held_bytes": sum(t.numel() * t.element_size() for t in
                          (*module.parameters(), *module.buffers())),
        "tasks": []}
    if dev.type == "cuda":
        # what the build left allocated: the shard, and nothing of the
        # full tensors it was cut from
        record["build_asked_bytes"] = _asked_bytes() - before
        record["device_total_bytes"] = torch.cuda.mem_get_info(dev)[1]
    for name, kw in spec["tasks"]:
        _lib.reset_counts()
        mesh.counts.clear()
        t1 = time.perf_counter()
        if name in ("dataset", "beam_texts"):
            res = (task_dataset if name == "dataset" else task_beam_texts)(
                model, mesh, spec, **kw)
        else:
            fn = {"logits": task_logits, "engine": task_engine,
                  "batcher": task_batcher, "beam": task_beam,
                  "row_parallel": task_row_parallel}[name]
            res = fn(module, cfg, mesh, inputs, spec, **kw)
        _sync(dev)
        res.update(name=name, seconds=time.perf_counter() - t1,
                   collectives=dict(mesh.counts), **_counts())
        if "logits" in res:     # [steps + 1, n, vocab] fp32, beside the JSON
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"logits_rank{mesh.rank}.npy"
            np.save(path, res.pop("logits"))
            res["logits_file"] = str(path)
        record["tasks"].append(res)
    if dev.type == "cuda":
        record["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(record))
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(json.loads(Path(argv[0]).read_text()), Path(argv[1]))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
