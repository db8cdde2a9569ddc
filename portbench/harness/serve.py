"""The serving cells: zero-shot labelling of an image stream through the
port's continuous batcher, built as ``VLMModel.generate_dataset`` builds it
(the default admission block, loop and pipeline depth), greedy, with one
prompt for every image.

The window opens once as many images have completed as there are slots
(every slot has turned over once, in the mean) and closes at the first
result read ``--seconds`` after it; the stream is long enough that no slot
drains inside it. A traced run then profiles a further stretch of the same
stream, ``trace_seconds`` from the profiler's start. The run is stopped
as a user stops one, by an interrupt, raised where the batcher would
dispatch its next chunk, so that no result read is cut short; the batcher
then collects what it had dispatched.

The driver builds a model whose weights are floating point in the
configuration's ``dtype``; a configuration that asks for quantized
weights needs a driver and a reference of its own."""

from __future__ import annotations

import gc
import resource
import sys
import time

import numpy as np

from . import trace as tr
from .weights import draw, seed_of, specs_of

SPANS = ("portbench.prefill", "portbench.decode_step", "portbench.admit",
         "portbench.chunk")
#: the stand-ins ``controls.py`` puts in the program's place
CONTROLS = ("fp8",)
#: the port's unquantized weight formats and their dtypes
FLOAT = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}


class _Log(list):
    """``last_latency_s`` that records the order and host time of each
    completion as the batcher writes it."""

    def __init__(self, items):
        super().__init__(items)
        self.log = []

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self.log.append((i, time.perf_counter()))


def build(ctx):
    """The model on the card with the benchmark's weights, the prompt, the
    image pool and the caps. Returns a dict."""
    torch = ctx.torch
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.vlm import VLMModule

    port, w = ctx.config["port"], ctx.widths
    if port.get("quantization") not in FLOAT or \
            FLOAT[port["quantization"]] != ctx.config["dtype"]:
        raise SystemExit(f"the serving driver builds floating-point weights "
                         f"only ({sorted(FLOAT)}, as the configuration's "
                         f"dtype); {port.get('quantization')!r} with "
                         f"{ctx.config['dtype']!r} needs a driver of its own")
    vcfg = VLM_CONFIGS[port["family"]](ctx.size_name(port["size"]))
    ctx.check_widths(vcfg)
    dtype = getattr(torch, ctx.config["dtype"])
    module = VLMModule(vcfg, dtype=dtype, device="meta")
    weights = draw(specs_of(module), dtype, ctx.device, ctx.seed, torch)
    module.load_state_dict(weights, strict=True, assign=True)
    module.eval()
    if any(t.is_meta for t in (*module.parameters(), *module.buffers())):
        raise RuntimeError("a tensor of the model was left without weights")

    t = ctx.traffic
    dec = w["decoder"]
    rng = np.random.default_rng(seed_of(ctx.seed, 1))
    hi = min(dec["vocab_size"], t["prompt_id_high"])
    prompt = [dec["bos_token_id"]] + rng.integers(
        t["prompt_id_low"], hi, t["prompt_text_ids"]).tolist()
    # each block of the stream holds the same caps, in an order drawn
    # from the seed, so that every seed has the same work: the traffic's
    # ``cap_mix`` ([cap, images], ...), or every value from ``cap_min`` to
    # ``cap_max`` equally often in ``cap_block`` images
    n = t["stream_images"]
    if "cap_mix" in t:
        block = np.concatenate([np.full(int(k), int(c))
                                for c, k in t["cap_mix"]])
    else:
        values = np.arange(t["cap_min"], t["cap_max"] + 1)
        block = np.repeat(values, max(1, t["cap_block"] // len(values)))
    caps = np.concatenate([rng.permutation(block) for _ in range(
        -(-n // len(block)))])[:n].tolist()
    vis = w["vision"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed_of(ctx.seed, 2))
    s = vis["image_size"]
    pool = torch.randint(0, 256, (t["image_pool"], s, s, 3), generator=gen,
                         device=ctx.device, dtype=torch.uint8)
    return {"vcfg": vcfg, "module": module, "weights": weights,
            "prompt": prompt, "caps": caps, "pool": pool, "dtype": dtype,
            "prompt_rows": w["qformer"]["num_query_tokens"] + len(prompt)}


def run(ctx) -> dict:
    """One serving run: set-up, window, an optional traced stretch, then
    the check against the reference."""
    torch = ctx.torch
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher
    from vlm_tpu_torch.generate.readback import upload
    from vlm_tpu_torch.ops.preprocess import normalize_images, recipe_for

    m = build(ctx)
    t, dev = ctx.traffic, ctx.device
    vcfg, module, pool = m["vcfg"], m["module"], m["pool"]
    recipe = recipe_for(ctx.config["port"]["family"])
    patch = vcfg.vision.patch_size

    def pixel_fn(idxs):
        sel = upload(np.asarray(idxs, np.int64) % pool.shape[0], dev)
        return normalize_images(pool.index_select(0, sel), recipe=recipe,
                                compute_dtype=m["dtype"], patch_size=patch)

    class Batcher(ContinuousBatcher):
        @property
        def last_latency_s(self):
            return self._lat

        @last_latency_s.setter
        def last_latency_s(self, v):
            self._lat = _Log(v)

    dec = vcfg.decoder
    b = Batcher(module, vcfg, batch_size=t["slots"],
                max_prompt_len=m["prompt_rows"],
                max_new_tokens=t["max_new_tokens"], eos_id=dec.eos_token_id,
                pad_id=dec.pad_token_id, cache_dtype=m["dtype"])
    dtr = None
    if ctx.trace:
        dtr = tr.DeviceTrace(torch, SPANS)
        module.prefill = tr.record(torch, SPANS[0], module.prefill)
        module.decode_step = tr.record(torch, SPANS[1], module.decode_step)
        b._admit = tr.record(torch, SPANS[2], b._admit)
        b._chunk = tr.record(torch, SPANS[3], b._chunk)
    w = _Window(ctx, b, t["slots"], dtr)
    chunk = b._chunk

    def chunk_or_stop(*args, **kwargs):
        if w.phase == "done":
            raise KeyboardInterrupt
        return chunk(*args, **kwargs)
    b._chunk = chunk_or_stop
    n = t["stream_images"]
    results = b.run(pixel_fn, pre_ids_row=np.zeros(0, np.int32),
                    post_ids_row=np.asarray(m["prompt"], np.int32),
                    prompt_len_scalar=m["prompt_rows"], n_images=n,
                    progress=w.progress, max_new_per_image=m["caps"])
    w.host.close()
    if w.phase != "done":
        raise RuntimeError(f"the stream of {n} images ended in phase "
                           f"{w.phase}: make it longer")
    ctx.synchronize()
    memory_peak = ctx.memory_peak()
    win = w.summary(b, results, m["caps"], dec.eos_token_id)
    early = sum(1 for i in win["indices"] if len(results[i]) < m["caps"][i])
    print(f"[window] {win['images']} images in {win['seconds']:.3f} s, "
          f"{np.mean(win['generated']):.3f} tokens an image, {early} ended "
          f"by EOS before their cap", file=sys.stderr)
    print("[host] " + ", ".join(f"{k} {v:.6g}" for k, v in {
        **win["host"], **win["stats"]}.items()), file=sys.stderr)
    rec = {"kind": "serve", "window": win, "widths": ctx.widths,
           "prompt_rows": m["prompt_rows"], "admit_block": b.admit_block,
           "trace": dtr.read() if dtr is not None else None}
    del b
    ctx.free()
    finished = [i for i, r in enumerate(results) if r is not None]
    checks = check(ctx, m, results, finished, dec.eos_token_id)
    lat = sorted(win["latency_s"])
    e2e = {"images_per_s": win["images"] / win["seconds"],
           "latency_p95_ms": 1e3 * float(np.percentile(lat, 95))
           if lat else None}
    return {"setup_s": w.setup_s, "e2e": e2e, "record": rec,
            "attempted": win["images"], "failed": win["failed"],
            "checks": checks, "memory_peak": memory_peak}


class _Window:
    """Phases of the stream, driven by the batcher's progress calls: the
    ramp, the window, the traced stretch, done. Completions are grouped by
    the result read that returned them (``blocking_reads`` as the batcher
    counts them when it reports)."""

    def __init__(self, ctx, batcher, slots: int, dtr):
        self.ctx, self.b, self.slots, self.dtr = ctx, batcher, slots, dtr
        self.phase = "ramp"
        self.done = 0
        self.read = None            # the read being reported
        self.reads = []             # (read index, time, [image indices])
        self.open = self.close = None
        self.host = _Host(ctx.torch)

    def _snap(self):
        return dict(self.b.last_stats)

    def progress(self, _n):
        if self.phase == "done":
            return
        idx, now = self.b.last_latency_s.log[-1]
        r = self.b.last_stats["blocking_reads"]
        if r != self.read:
            self._read_ended(now)
            if self.phase == "done":
                return
            self.read = r
            self.reads.append((r, now, []))
        self.done += 1
        self.reads[-1][2].append(idx)

    def _read_ended(self, now):
        """Called at the first completion of a new read: the read before
        it is whole."""
        if not self.reads:
            return
        last = len(self.reads) - 1
        if self.phase == "ramp" and self.done >= self.slots:
            self.phase, self.open = "window", last
            self.setup_s = time.perf_counter() - self.ctx.t0
            self.stats_open = self._snap()
            self.host_open = self.host.snap()
        elif self.phase == "window" and \
                self.reads[last][1] - self.reads[self.open][1] >= \
                self.ctx.seconds:
            self.close = last
            self.stats_close = self._snap()
            self.host_close = self.host.snap()
            if self.dtr is None:
                self.phase = "done"
            else:
                self.phase = "trace"
                self.dtr.start()
        elif self.phase == "trace" and self.reads[last][1] - \
                self.dtr.t0 >= self.ctx.traffic["trace_seconds"]:
            # timed from the profiler's start: starting it takes seconds
            self.dtr.stop()
            self.phase = "done"

    def summary(self, b, results, caps, eos) -> dict:
        reads = self.reads[self.open + 1:self.close + 1]
        images = [i for _, _, ids in reads for i in ids]
        lat = b.last_latency_s
        gen = []
        for i in images:
            toks = results[i] or []
            gen.append(len(toks) + (1 if len(toks) < caps[i] else 0))
        a, z = self.stats_open, self.stats_close
        return {"seconds": self.reads[self.close][1] -
                self.reads[self.open][1], "indices": images,
                "images": len(images), "generated": gen,
                "latency_s": [lat[i] for i in images],
                "failed": sum(1 for i in images if not results[i]),
                "stats": {k: z[k] - a[k] for k in a},
                "host": {k: self.host_close[k] - self.host_open[k]
                         for k in self.host_open}}


class _Host:
    """What the host did in the window, for the record: the main thread's
    and the process's CPU seconds, the main thread's context switches, the
    garbage collector's runs and seconds, and the caching allocator's
    retries (each a synchronizing free of cached blocks)."""

    def __init__(self, torch):
        self.torch = torch
        self.gc_s, self.gc_runs, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)

    def _gc(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs += 1
            self._t = None

    def close(self) -> None:
        gc.callbacks.remove(self._gc)

    def snap(self) -> dict:
        th = resource.getrusage(resource.RUSAGE_THREAD)
        cuda = self.torch.cuda.is_available()
        return {"thread_cpu_s": time.thread_time(),
                "process_cpu_s": time.process_time(),
                "voluntary_switches": th.ru_nvcsw,
                "involuntary_switches": th.ru_nivcsw,
                "gc_s": self.gc_s, "gc_runs": self.gc_runs,
                "alloc_retries": self.torch.cuda.memory_stats().get(
                    "num_alloc_retries", 0) if cuda else 0}


def check(ctx, m, results, done, eos) -> list:
    """The served tokens of a sample of the requests ``done`` (every
    request the run finished, those collected after the stop too), drawn
    from the seed with the one that generated most among them, against the
    plain
    reference: the widest gap by which a served token's logit lies below
    the reference's best at its position (EOS counts as served where a
    request ended before its cap). With ``ctx.controls`` (``"fp8"``), the
    control's reading on the same sample is kept in ``ctx.readings``: at
    each position the gap of the token that the reference computed with
    fp8 products puts first."""
    torch = ctx.torch
    from portbench.reference.blip2 import served_logits
    from portbench.reference.precision import Precision, strict_fp32

    caps = m["caps"]
    served = {i: results[i] + ([eos] if len(results[i]) < caps[i] else [])
              for i in done}
    k = min(ctx.traffic["check_requests"], len(done))
    rng = np.random.default_rng(seed_of(ctx.seed, 3))
    longest = max(done, key=lambda i: (len(served[i]), -i))
    pick = [longest] + [int(i) for i in rng.choice(
        [i for i in done if i != longest], k - 1, replace=False)]
    strict_fp32()
    w, block = ctx.widths, ctx.traffic["check_block"]
    gap, ctrl = 0.0, {c: 0.0 for c in ctx.controls}
    with torch.no_grad():
        for j in range(0, k, block):
            ids = pick[j:j + block]
            images = m["pool"][torch.tensor(
                [i % m["pool"].shape[0] for i in ids], device=ctx.device)]
            toks = [served[i] for i in ids]

            def logits(mode):
                return served_logits(Precision(mode), m["weights"], w,
                                     w["image_mean"], w["image_std"],
                                     images, m["prompt"], toks)

            ref = logits("fp32")
            for lg, tk in zip(ref, toks):
                sel = torch.tensor(tk, device=ctx.device)[:, None]
                gap = max(gap, widest_gap(lg, sel))
            for c in ctx.controls:
                for lo, lg in zip(logits(c), ref):
                    ctrl[c] = max(ctrl[c], widest_gap(
                        lg, lo.argmax(-1, keepdim=True)))
    for c, v in ctrl.items():
        ctx.readings[c] = {"max_logit_gap": v}
    limit = ctx.limits["max_logit_gap"]
    tokens = sum(len(served[i]) for i in pick)
    return [{"name": "max_logit_gap", "value": gap, "limit": limit,
             "ok": bool(gap <= limit), "tokens": tokens}]


def widest_gap(logits, chosen) -> float:
    """max over rows of (the row's best logit - the chosen token's)."""
    top = logits.max(-1).values
    return float((top - logits.gather(1, chosen)[:, 0]).max())
