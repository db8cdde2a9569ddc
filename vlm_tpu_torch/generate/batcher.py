"""Continuous batching: slot-based admission over a stream of images
(``vlm_tpu/generate/batcher.py``).

``B`` decode slots stay busy: when a slot finishes (EOS or its cap), the
next pending images are prefilled into the free slots, up to
``admit_block`` at a time, and decoding continues. The per-slot decode state
(current token, length, generated count, cap, active and occupied flags,
token history) lives on the device; admission picks the first free slots by
the ``occ`` bit and updates that state in place, with no host round trip.

Every slot writes its new KV row at the same cache column each step (the
rotating decode window: column ``pcol + dstep mod W``), and slot i's live
rows are rebuilt in the attention mask from ``(pcol, W, acol[i], gcnt[i])``,
so the KV write is one uniform B3 launch and the mask never travels as a
``[B, L]`` tensor.

The host loop is ``vlm_tpu``'s: one blocking read per admission cycle, no
blocking read inside a chunk. A chunk decodes until ``stop_free`` slots are
free, every slot is done or ``max_steps`` steps ran; that condition is
evaluated on the device at every step, and a step whose condition is false
changes no state (token, length, count, flags, history, ``dstep`` and the
chunk's step count ``k`` stay as they were). The host enqueues steps and
reads each step's condition without waiting for it
(:class:`~vlm_tpu_torch.generate.readback.StepFlags`), up to
``steps_ahead`` steps past the last one it has read, and stops once it
reads a false one or reaches its upper bound on the steps the chunk can
take (the ``stop_free``-th smallest of the slots' remaining caps: an EOS
can end the chunk sooner). A step enqueued past the stop is "guarded": it
runs the decode forward and writes every slot's KV row at column ``pcol +
dstep mod W``, the column the next step that takes effect writes first
(an admission in between writes prompt rows only), so no row a mask can
reach changes. The chunk's packed result (history, active flags, counts
and ``k``) is copied to pinned memory when the chunk is dispatched and read
when the loop needs it: at once in the synchronous loop (``sync_every >
0``), one admission cycle later in the pipelined one (the default).

Under a mesh (the module's; ``vlm_tpu``'s ``mesh=``) every rank runs this
loop over the same images in the same order, and the slot state is whole
on every rank. Tensor parallelism lives in the module. Over ``data > 1``
the slots split into contiguous blocks, one a data rank, which holds only
its slots' KV cache (and one spare row, where an admission's rows for
other ranks' slots land) and runs the decode forward of its slots only;
the step's tokens are all-gathered over the data group, so the state,
the step flags, the chunk's packed result and every slot decision are
the same on every rank. An admission's prefill runs on every data rank
over the whole admission block, as ``vlm_tpu``'s admission group is not
sharded over ``data`` either; each rank keeps its slots' rows. The flags
are read in lockstep (:class:`StepFlags`), and an interrupt on any rank
stops every rank at the same chunk boundary (one all-reduce of a stop flag
a chunk).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import prefetch_batches
from ..models.decoder import QuantizedKV, init_kv_cache, local_heads
from ..models.vlm import VLMModule
from ..utils.profiling import annotate
from .decode import check_positions, feed_token, sample, sample_rows
from .readback import Pull, StepFlags, upload


@dataclasses.dataclass
class _Slot:
    # Host mirror of identity + liveness; caps/EOS/counts live on the device
    image_idx: int = -1
    active: bool = False


class _MeshStop:
    """Under a mesh, an interrupt on any rank stops every rank at the same
    chunk boundary: SIGINT sets a flag instead of raising, and
    :meth:`check`, at each chunk's dispatch, all-reduces the flag over the
    mesh on the host (:meth:`Mesh.any`, no device read; counted in
    :attr:`reads`) and raises ``KeyboardInterrupt`` on every rank if one is
    set. Without a mesh, Python's own ``KeyboardInterrupt`` serves."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.flag = False
        self.prev = None
        self.reads = 0

    def __enter__(self):
        if self.mesh is not None and \
                threading.current_thread() is threading.main_thread():
            self.prev = signal.signal(signal.SIGINT, self._set)
        return self

    def _set(self, *_):
        self.flag = True

    def check(self) -> None:
        if self.mesh is None:
            return
        self.reads += 1
        if self.mesh.any(self.flag):
            raise KeyboardInterrupt

    def __exit__(self, *_):
        if self.prev is not None:
            signal.signal(signal.SIGINT, self.prev)


class ContinuousBatcher:
    #: decode steps the host may enqueue past the last step flag it has
    #: read; more only wait on the card (in a chunk that EOS ends early,
    #: each is a guarded step)
    steps_ahead = 2

    def __init__(self, module: VLMModule, cfg, *, batch_size: int,
                 max_prompt_len: int, max_new_tokens: int = 100,
                 admit_block: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 cache_dtype=None, sync_every: int = 0,
                 pipeline_depth: int = 1):
        self.module = module
        self.cfg = cfg
        self.device = module.device
        self.batch_size = batch_size
        self.mesh = getattr(module, "mesh", None)
        if self.mesh is not None and batch_size % self.mesh.data:
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"mesh data axis {self.mesh.data}")
        #: this data rank's slots (all of them without a data split)
        self.local = self.mesh.rows(batch_size) if self.mesh is not None \
            else slice(0, batch_size)
        self.split = self.mesh is not None and self.mesh.data > 1
        self.kv_heads = local_heads(cfg.decoder, self.mesh)[1]
        self.max_new_tokens = max_new_tokens
        self.max_prompt_len = max_prompt_len
        self.cache_len = check_positions(cfg, max_prompt_len,
                                         max_new_tokens)
        # "int8" for the quantized cache; default: the compute dtype
        self.cache_dtype = cache_dtype or module.dtype
        self.eos_id = cfg.decoder.eos_token_id if eos_id is None else eos_id
        self.pad_id = cfg.decoder.pad_token_id if pad_id is None else pad_id
        # the token an idle slot is fed (the pad id still fills the history
        # and the results); the rows it writes stay masked for its next
        # occupant. In vlm_tpu an out-of-vocabulary pad makes those rows
        # NaN, which a masked weight of 0 does not cancel
        self.feed_id = feed_token(self.pad_id, cfg.decoder.vocab_size)
        # ~8 slots per admission, fewer for small batches (vlm_tpu's default;
        # tuned on a TPU and to be re-tuned on the card)
        self.admit_block = admit_block or min(
            batch_size, max(4, min(8, batch_size // 8)))
        if not 1 <= self.admit_block <= batch_size:
            raise ValueError(
                f"admit_block ({self.admit_block}) must be in "
                f"[1, batch_size={batch_size}]")
        # 0: the pipelined loop, chunks of up to max_new_tokens steps; N > 0:
        # the synchronous loop, one blocking read a chunk of at most N steps
        self.sync_every = int(sync_every)
        # pipelined loop: chunk results left unread behind the dispatches
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.generator = generator
        self._cols = torch.arange(max_new_tokens, device=self.device)[None]

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.temperature, self.generator, self.top_k,
                      self.top_p)

    def _init_state(self) -> dict:
        b, dev = self.batch_size, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "cur": torch.full((b,), self.feed_id, **i32),
            "slen": torch.zeros((b,), **i32),
            "gcnt": torch.zeros((b,), **i32),
            "caps": torch.full((b,), self.max_new_tokens, **i32),
            "act": torch.zeros((b,), dtype=torch.bool, device=dev),
            "hist": torch.full((b, self.max_new_tokens), self.pad_id, **i32),
            # rotating window: dstep counts decode steps that took effect;
            # acol[i] = dstep mod W when slot i was admitted; pcol = the
            # prompt length
            "dstep": torch.zeros((), **i32),
            "acol": torch.zeros((b,), **i32),
            "pcol": torch.zeros((), **i32),
            # occupied from admission until a chunk has reported the slot
            # inactive, so a slot finished inside its admission is not reused
            # before the host has read its tokens
            "occ": torch.zeros((b,), dtype=torch.bool, device=dev),
            # the steps of the current chunk that took effect
            "k": torch.zeros((), **i32),
        }

    def _new_cache(self, rows: int, length: int) -> dict:
        return init_kv_cache(self.cfg.decoder, rows, length,
                             self.cache_dtype, self.device,
                             kv_heads=self.kv_heads)

    def _admit(self, state: dict, cache: dict, pixels, pre_ids, post_ids,
               prompt_len, caps_new) -> float:
        """Prefill ``g`` images into the first ``g`` free slots (chosen on
        the device: lowest indices with ``occ`` False) and update the slot
        state and the cache in place. Under a data split, rows for other
        ranks' slots go to the cache's spare row. Returns the host's
        seconds in the module's prefill (its enqueue)."""
        g = pixels.shape[0]
        slots = torch.argsort(state["occ"].to(torch.int8), stable=True)[:g]
        p = self.max_prompt_len
        group = self._new_cache(g, p)
        # every data rank prefills the whole admission
        t0 = time.perf_counter()
        last = self.module.prefill(pixels, pre_ids, post_ids, group,
                                   prompt_len, replicated=True)
        prefill_s = time.perf_counter() - t0
        with annotate("batcher.cache_copy"):
            rows = slots
            if self.split:
                lo, n = self.local.start, self.local.stop - self.local.start
                rows = torch.where((slots >= lo) & (slots < lo + n),
                                   slots - lo, n)
            for full, part in zip(cache["k"] + cache["v"],
                                  group["k"] + group["v"]):
                if isinstance(full, QuantizedKV):       # values and scales
                    for f, t in zip(full, part):
                        f[rows, :p] = t
                else:
                    full[rows, :p] = part               # in place
        with annotate("batcher.admit_state"):
            first = self._sample(last)
            act_new = (first != self.eos_id) & (caps_new > 1)
            # index_fill_ takes its value as a kernel argument: an
            # index_put_ of a Python number would upload it, a blocking copy
            state["hist"].index_fill_(0, slots, self.pad_id)
            state["hist"][slots, 0] = first
            state["cur"][slots] = torch.where(act_new, first, self.feed_id)
            state["slen"][slots] = prompt_len
            state["gcnt"].index_fill_(0, slots, 1)
            state["caps"][slots] = caps_new
            state["act"][slots] = act_new
            state["acol"][slots] = torch.remainder(state["dstep"],
                                                   self.max_new_tokens)
            state["pcol"].copy_(prompt_len[0])
            state["occ"].index_fill_(0, slots, True)
        return prefill_s

    def _go(self, state: dict, stop_free: int, max_steps: int):
        """The chunk's condition on the device (0-d bool): fewer than
        ``max_steps`` steps taken, a slot active, fewer than ``stop_free``
        slots free."""
        n_act = state["act"].sum(dtype=torch.int32)
        return (state["k"] < max_steps) & (n_act > 0) & \
            (n_act > self.batch_size - stop_free)

    def _decode_step(self, state: dict, cache: dict, go, stop_free: int,
                     max_steps: int):
        """One decode step for every slot, taking effect only where ``go``
        (the chunk's condition before it) holds: finished slots go inactive.
        Returns the condition after it."""
        n_new = self.max_new_tokens
        act, gcnt = state["act"], state["gcnt"]
        wcol = state["pcol"] + torch.remainder(state["dstep"], n_new)
        r = self.local
        logits = self.module.decode_step(
            state["cur"][r, None], state["slen"][r], cache, write_col=wcol,
            kv_window=(state["pcol"], n_new, state["acol"][r], gcnt[r]))
        live = act & go
        nxt = torch.where(live, sample_rows(
            logits, self.mesh, self.temperature, self.generator, self.top_k,
            self.top_p), self.pad_id)
        state["hist"] = torch.where(
            live[:, None] & (self._cols == gcnt[:, None]), nxt[:, None],
            state["hist"])
        finished = live & ((nxt == self.eos_id) | (gcnt + 1 >= state["caps"]))
        inc = live.int()
        state["slen"] = state["slen"] + inc
        state["gcnt"] = gcnt + inc
        state["act"] = act & ~finished
        state["cur"] = torch.where(
            go, torch.where(state["act"], nxt, self.feed_id), state["cur"])
        took = go.int()
        state["dstep"] = state["dstep"] + took
        state["k"] = state["k"] + took
        return self._go(state, stop_free, max_steps)

    def _chunk(self, state: dict, cache: dict, stop_free: int,
               max_steps: int, limit: int,
               flags: StepFlags) -> Tuple[Pull, int]:
        """Enqueue the chunk's steps, at most ``limit`` (an upper bound on
        the steps it takes), reading the step flags without waiting, and
        its packed result ([B, W + 3]: token history, active flag,
        generated count, ``k``). Returns the result's pull and the steps
        dispatched."""
        flags.start()
        state["k"] = torch.zeros_like(state["k"])
        go = self._go(state, stop_free, max_steps)
        flags.push(go)
        n = 0
        while n < limit and flags.poll() is None:
            behind = n + 1 - self.steps_ahead
            if behind > flags.read and flags.wait(behind) is not None:
                break
            with annotate("batcher.step"):
                go = self._decode_step(state, cache, go, stop_free,
                                       max_steps)
            flags.push(go)
            n += 1
        state["occ"] = state["act"].clone()
        b = self.batch_size
        with annotate("batcher.pack"):
            packed = torch.cat([state["hist"], state["act"].int()[:, None],
                                state["gcnt"][:, None],
                                state["k"].expand(b)[:, None]], dim=1)
            return Pull(packed), n

    @torch.inference_mode()
    def run(self, pixel_fn: Callable[[List[int]], torch.Tensor],
            pre_ids_row, post_ids_row, prompt_len_scalar: int, n_images: int,
            progress: Optional[Callable[[int], None]] = None,
            max_new_per_image: Optional[Sequence[int]] = None,
            prefetch_depth: int = 2) -> List[Optional[List[int]]]:
        """Generate for ``n_images`` inputs; returns token lists in input
        order (EOS removed; None for inputs an interrupt left unfinished).
        ``pixel_fn(indices)`` returns the normalized pixel batch and runs on
        a prefetch thread, ``prefetch_depth`` admission blocks ahead.
        ``max_new_per_image`` caps each request (clamped to
        ``max_new_tokens``).

        Afterwards ``last_latency_s`` holds each image's admission-to-
        completion time as the host observed it (at the read of the chunk
        that finished it: in the pipelined loop one cycle late), and
        ``last_stats`` the loop's counters: ``vlm_tpu``'s (``admit_s``,
        ``admits``, ``chunks``, ``sync_s``: the blocking reads' seconds,
        ``block_wait_s``), ``prefill_s`` (the host's seconds in the
        module's prefill, inside ``admit_s``), ``step_enqueue_s`` and
        ``flag_wait_s`` (a chunk's dispatch seconds: enqueueing its steps
        and its packed result, and blocked in :meth:`StepFlags.wait`),
        ``pixels_s`` (``pixel_fn``'s seconds, on the prefetch thread),
        ``steps`` (decode steps that took effect), ``guarded_steps``
        (dispatched steps that took none), ``blocking_reads`` (the
        chunks' result reads and the waits for a step flag) and, under a
        mesh, ``stop_reads`` (the host reads of the ranks' stop flag, one
        a chunk)."""
        B = self.batch_size
        n_new = self.max_new_tokens
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        n_local = self.local.stop - self.local.start
        # under a data split one spare row takes other ranks' admissions
        cache = self._new_cache(n_local + (1 if self.split else 0),
                                self.cache_len)
        view = cache if not self.split else {
            kv: tuple(QuantizedKV(*(t[:n_local] for t in layer))
                      if isinstance(layer, QuantizedKV) else layer[:n_local]
                      for layer in layers) for kv, layers in cache.items()}
        state = self._init_state()
        flags = StepFlags(dev, lockstep=self.mesh is not None)
        stop_flag = _MeshStop(self.mesh)
        slots = [_Slot() for _ in range(B)]
        results: List[Optional[List[int]]] = [None] * n_images
        self.last_latency_s: List[Optional[float]] = [None] * n_images
        t_admit = [0.0] * n_images
        stats = {"admit_s": 0.0, "admits": 0, "prefill_s": 0.0,
                 "step_enqueue_s": 0.0, "flag_wait_s": 0.0, "chunks": 0,
                 "sync_s": 0.0, "block_wait_s": 0.0, "pixels_s": 0.0,
                 "steps": 0, "guarded_steps": 0, "blocking_reads": 0}
        self.last_stats = stats
        pre_row = upload(np.asarray(pre_ids_row, np.int32), dev)
        post_row = upload(np.asarray(post_ids_row, np.int32), dev)
        plen_g: Dict[int, torch.Tensor] = {}

        def cap(i: int) -> int:
            return n_new if max_new_per_image is None else \
                max(1, min(n_new, int(max_new_per_image[i])))

        # the host's upper bound on the steps each unfinished image has
        # left: (cap - generated count as last read, the chunk it was read
        # before), less the steps each chunk since is known to have taken
        known: List[int] = []
        left: Dict[int, Tuple[int, int]] = {}

        def limit(stop_free: int, max_steps: int) -> int:
            """Steps after which the next chunk's condition is surely
            false: once at most B - stop_free slots can still be active
            (or none, when stop_free > B)."""
            after = [0] * (len(known) + 1)
            for c in range(len(known) - 1, -1, -1):
                after[c] = after[c + 1] + known[c]
            ups = sorted((max(0, r - after[c]) for r, c in left.values()),
                         reverse=True)
            r = B - stop_free
            if r < 0:
                t = ups[0] if ups else 0
            else:
                t = ups[r] if len(ups) > r else 0
            return min(max_steps, t)

        def timed(key, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            stats[key + "_s"] += time.perf_counter() - t0
            return out

        blocks = [list(range(i, min(i + self.admit_block, n_images)))
                  for i in range(0, n_images, self.admit_block)]
        # on the prefetch thread, the one writer of "pixels_s"
        block_iter = prefetch_batches(
            blocks, lambda idxs: (idxs, timed("pixels", pixel_fn, idxs)),
            depth=max(1, prefetch_depth))
        max_steps = n_new if self.sync_every <= 0 else self.sync_every

        def next_block():
            with annotate("batcher.block_wait"):
                return timed("block_wait", next, block_iter, None)

        def dispatch_admit(idxs: List[int], pixels) -> None:
            """Enqueue the admission; the device chooses the slots (first g
            free), which assign_slots mirrors without a read."""
            g = len(idxs)
            stats["admits"] += 1
            if g not in plen_g:
                plen_g[g] = torch.full((g,), prompt_len_scalar, **i32)
            caps = [cap(i) for i in idxs]
            with annotate("batcher.admit"):
                stats["prefill_s"] += self._admit(
                    state, cache, pixels.to(dev, non_blocking=True),
                    pre_row[None].expand(g, -1),
                    post_row[None].expand(g, -1), plen_g[g],
                    upload(np.asarray(caps, np.int32), dev))
            for i, c in zip(idxs, caps):
                left[i] = (c - 1, len(known))

        def dispatch_chunk(stop_free: int):
            stop_flag.check()
            stats["chunks"] += 1
            t0, w0 = time.perf_counter(), flags.wait_s
            with annotate("batcher.chunk"):
                pull, n = self._chunk(state, view, stop_free, max_steps,
                                      limit(stop_free, max_steps), flags)
            known.append(flags.effective(n))
            waited = flags.wait_s - w0
            stats["flag_wait_s"] += waited
            stats["step_enqueue_s"] += time.perf_counter() - t0 - waited
            return (pull, len(known) - 1, n), t0

        def assign_slots(idxs: List[int], t0: float) -> None:
            """Mirror the device's slot choice: the first len(idxs) free
            slots by index (the mirror is updated in dispatch order, so it
            is argsort(occ)[:g])."""
            free = [i for i, s in enumerate(slots) if not s.active]
            assert len(free) >= len(idxs), "admission without free slots"
            for j, s in enumerate(free[:len(idxs)]):
                slots[s] = _Slot(image_idx=idxs[j], active=True)
                t_admit[idxs[j]] = t0

        def resolve(chunk) -> None:
            """Read a chunk's packed result (the one blocking read of a
            cycle) and resolve every slot it finished."""
            pull, c, n = chunk
            t0 = time.perf_counter()
            with annotate("batcher.read"):
                arr = pull.get()
            stats["sync_s"] += time.perf_counter() - t0
            stats["blocking_reads"] += 1
            act = arr[:, n_new].astype(bool)
            gcnt = arr[:, n_new + 1]
            known[c] = int(arr[0, n_new + 2])
            stats["steps"] += known[c]
            stats["guarded_steps"] += n - known[c]
            now = time.perf_counter()
            for i, s in enumerate(slots):
                if not s.active:
                    continue
                if act[i]:
                    left[s.image_idx] = (cap(s.image_idx) - int(gcnt[i]),
                                         c + 1)
                    continue
                left.pop(s.image_idx, None)
                results[s.image_idx] = [int(t) for t in arr[i, :gcnt[i]]
                                        if t != self.eos_id]
                self.last_latency_s[s.image_idx] = now - t_admit[s.image_idx]
                slots[i] = _Slot()
                if progress is not None:
                    progress(1)

        # admissions and chunk results in dispatch order, replayed when
        # resolved, so the host mirror follows the device's state at that
        # point of the stream; at run scope, so an interrupt can collect
        # the dispatched work
        events: List[tuple] = []   # ("admit", idxs, t) | ("chunk", ..., t)
        t_last_pull = 0.0

        def process_event() -> None:
            nonlocal t_last_pull
            kind, payload, t0 = events.pop(0)
            if kind == "admit":
                assign_slots(payload, max(t0, t_last_pull))
            else:
                resolve(payload)
                t_last_pull = time.perf_counter()

        def drain_events(keep_chunks: int) -> None:
            while sum(1 for e in events if e[0] == "chunk") > keep_chunks:
                process_event()

        def run_sync() -> None:
            """One blocking read a chunk of at most sync_every steps."""
            pending = next_block()
            while pending is not None or any(s.active for s in slots):
                n_free = sum(not s.active for s in slots)
                if pending is not None and n_free >= len(pending[0]):
                    idxs, pixels = pending
                    t0 = time.perf_counter()
                    timed("admit", dispatch_admit, idxs, pixels)
                    assign_slots(idxs, t0)
                    pending = next_block()
                    continue
                stop = len(pending[0]) if pending is not None else B + 1
                resolve(dispatch_chunk(stop)[0])

        def run_pipelined() -> None:
            """Enqueue cycle k+1's admissions and chunk before reading
            cycle k's result. ``guaranteed`` counts the slots surely free
            along the dispatch stream: a chunk with stop_free = s ends only
            once s slots are free (or all are), so the admission of g <= s
            images after it finds its slots. An admission's start is taken
            as max(its dispatch, the read before it); completions are seen
            at the lagged reads."""
            guaranteed = B
            pending = next_block()
            while pending is not None:
                while pending is not None and guaranteed >= len(pending[0]):
                    idxs, pixels = pending
                    timed("admit", dispatch_admit, idxs, pixels)
                    events.append(("admit", idxs, time.perf_counter()))
                    guaranteed -= len(idxs)
                    pending = next_block()
                stop = len(pending[0]) if pending is not None else B + 1
                chunk, t0 = dispatch_chunk(stop)
                events.append(("chunk", chunk, t0))
                guaranteed = len(pending[0]) if pending is not None else B
                drain_events(self.pipeline_depth)
            # the last chunk (stop_free > B) drained every slot
            while events:
                process_event()

        try:
            with stop_flag:
                if self.sync_every > 0:
                    run_sync()
                else:
                    run_pipelined()
        except KeyboardInterrupt:
            # unfinished inputs stay None so the caller can evaluate what
            # completed, as the reference does; the chunks already
            # dispatched run on the card regardless, so their results are
            # collected too, as vlm_tpu's loop does
            print("\n[batcher] interrupted — returning completed results")
            try:
                while events:
                    process_event()
            except Exception:
                pass
        finally:
            block_iter.close()
            stats["blocking_reads"] += flags.waits
            if self.mesh is not None:
                stats["stop_reads"] = stop_flag.reads
        return results
