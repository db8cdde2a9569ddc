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

Host loop: ``vlm_tpu`` pipelines its loop to hide a TPU round trip. Here,
in eager PyTorch, the host reads the active count after every decode step
to decide whether the chunk goes on (the shape of ``vlm_tpu``'s
``run_sync``): one small device-to-host copy per step. CUDA graphs and
fewer syncs are later work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import prefetch_batches
from ..models.decoder import QuantizedKV, init_kv_cache
from ..models.vlm import VLMModule
from .decode import check_positions, feed_token, sample


@dataclasses.dataclass
class _Slot:
    # Host mirror of identity + liveness; caps/EOS/counts live on the device
    image_idx: int = -1
    active: bool = False


class ContinuousBatcher:
    def __init__(self, module: VLMModule, cfg, *, batch_size: int,
                 max_prompt_len: int, max_new_tokens: int = 100,
                 admit_block: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 cache_dtype=None):
        self.module = module
        self.cfg = cfg
        self.device = module.device
        self.batch_size = batch_size
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
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.generator = generator

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
            # rotating window: dstep counts decode steps; acol[i] = dstep
            # mod W when slot i was admitted; pcol = the prompt length
            "dstep": torch.zeros((), **i32),
            "acol": torch.zeros((b,), **i32),
            "pcol": torch.zeros((), **i32),
            # occupied from admission until a chunk has reported the slot
            # inactive, so a slot finished inside its admission is not reused
            # before the host has read its tokens
            "occ": torch.zeros((b,), dtype=torch.bool, device=dev),
        }

    def _admit(self, state: dict, cache: dict, pixels, pre_ids, post_ids,
               prompt_len, caps_new) -> None:
        """Prefill ``g`` images into the first ``g`` free slots (chosen on
        the device: lowest indices with ``occ`` False) and update the slot
        state and the cache in place."""
        g = pixels.shape[0]
        slots = torch.argsort(state["occ"].to(torch.int8), stable=True)[:g]
        p = self.max_prompt_len
        group = init_kv_cache(self.cfg.decoder, g, p, self.cache_dtype,
                              self.device)
        last = self.module.prefill(pixels, pre_ids, post_ids, group,
                                   prompt_len)
        for full, part in zip(cache["k"] + cache["v"],
                              group["k"] + group["v"]):
            if isinstance(full, QuantizedKV):           # values and scales
                for f, t in zip(full, part):
                    f[slots, :p] = t
            else:
                full[slots, :p] = part                  # in place
        first = self._sample(last)
        act_new = (first != self.eos_id) & (caps_new > 1)
        state["hist"][slots] = self.pad_id
        state["hist"][slots, 0] = first
        state["cur"][slots] = torch.where(act_new, first, self.feed_id)
        state["slen"][slots] = prompt_len
        state["gcnt"][slots] = 1
        state["caps"][slots] = caps_new
        state["act"][slots] = act_new
        state["acol"][slots] = torch.remainder(state["dstep"],
                                               self.max_new_tokens)
        state["pcol"].copy_(prompt_len[0])
        state["occ"][slots] = True

    def _decode_step(self, state: dict, cache: dict) -> None:
        """One decode step for every slot; finished slots go inactive."""
        n_new = self.max_new_tokens
        act, gcnt = state["act"], state["gcnt"]
        wcol = state["pcol"] + torch.remainder(state["dstep"], n_new)
        logits = self.module.decode_step(
            state["cur"][:, None], state["slen"], cache, write_col=wcol,
            kv_window=(state["pcol"], n_new, state["acol"], gcnt))
        nxt = torch.where(act, self._sample(logits), self.pad_id)
        col = torch.arange(n_new, device=self.device)[None, :]
        state["hist"] = torch.where(act[:, None] & (col == gcnt[:, None]),
                                    nxt[:, None], state["hist"])
        finished = act & ((nxt == self.eos_id) | (gcnt + 1 >= state["caps"]))
        state["slen"] = state["slen"] + act.int()
        state["gcnt"] = gcnt + act.int()
        state["act"] = act & ~finished
        state["cur"] = torch.where(state["act"], nxt, self.feed_id)
        state["dstep"] = state["dstep"] + 1

    def _chunk(self, state: dict, cache: dict, stop_free: int,
               stats: dict) -> np.ndarray:
        """Decode until ``stop_free`` slots are free or no slot is active
        (at most ``max_new_tokens`` steps). Returns the packed [B, W + 2]
        host array: token history, active flag, generated count."""
        b = self.batch_size
        for _ in range(self.max_new_tokens):
            n_act = int(state["act"].sum())          # host sync per step
            if n_act == 0 or b - n_act >= stop_free:
                break
            self._decode_step(state, cache)
            stats["steps"] += 1
        state["occ"] = state["act"].clone()
        packed = torch.cat([state["hist"], state["act"].int()[:, None],
                            state["gcnt"][:, None]], dim=1)
        t0 = time.perf_counter()
        arr = packed.cpu().numpy()
        stats["sync_s"] += time.perf_counter() - t0
        return arr

    @torch.inference_mode()
    def run(self, pixel_fn: Callable[[List[int]], torch.Tensor],
            pre_ids_row, post_ids_row, prompt_len_scalar: int, n_images: int,
            progress: Optional[Callable[[int], None]] = None,
            max_new_per_image: Optional[Sequence[int]] = None
            ) -> List[Optional[List[int]]]:
        """Generate for ``n_images`` inputs; returns token lists in input
        order (EOS removed). ``pixel_fn(indices)`` returns the normalized
        pixel batch and runs on a prefetch thread, one admission block
        ahead. ``max_new_per_image`` caps each request (clamped to
        ``max_new_tokens``). Afterwards ``last_latency_s`` holds each
        image's admission-to-completion time as the host observed it and
        ``last_stats`` the loop's counters."""
        B = self.batch_size
        n_new = self.max_new_tokens
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        cache = init_kv_cache(self.cfg.decoder, B, self.cache_len,
                              self.cache_dtype, dev)
        state = self._init_state()
        slots = [_Slot() for _ in range(B)]
        results: List[Optional[List[int]]] = [None] * n_images
        self.last_latency_s: List[Optional[float]] = [None] * n_images
        t_admit = [0.0] * n_images
        stats = {"admit_s": 0.0, "admits": 0, "chunks": 0, "steps": 0,
                 "sync_s": 0.0, "block_wait_s": 0.0}
        self.last_stats = stats
        pre_row = torch.as_tensor(np.asarray(pre_ids_row), **i32)
        post_row = torch.as_tensor(np.asarray(post_ids_row), **i32)

        blocks = [list(range(i, min(i + self.admit_block, n_images)))
                  for i in range(0, n_images, self.admit_block)]
        block_iter = prefetch_batches(
            blocks, lambda idxs: (idxs, pixel_fn(idxs)))

        def next_block():
            t0 = time.perf_counter()
            out = next(block_iter, None)
            stats["block_wait_s"] += time.perf_counter() - t0
            return out

        def admit(idxs: List[int], pixels) -> None:
            g = len(idxs)
            caps = [n_new if max_new_per_image is None else
                    max(1, min(n_new, int(max_new_per_image[i])))
                    for i in idxs]
            t0 = time.perf_counter()
            self._admit(state, cache, pixels.to(dev),
                        pre_row[None].expand(g, -1),
                        post_row[None].expand(g, -1),
                        torch.full((g,), prompt_len_scalar, **i32),
                        torch.tensor(caps, **i32))
            stats["admit_s"] += time.perf_counter() - t0
            stats["admits"] += 1
            # mirror the device's choice: the first g free slots by index
            free = [i for i, s in enumerate(slots) if not s.active]
            for j, s in enumerate(free[:g]):
                slots[s] = _Slot(image_idx=idxs[j], active=True)
                t_admit[idxs[j]] = t0

        def resolve(arr: np.ndarray) -> None:
            act = arr[:, n_new].astype(bool)
            gcnt = arr[:, n_new + 1]
            now = time.perf_counter()
            for i, s in enumerate(slots):
                if not s.active or act[i]:
                    continue
                results[s.image_idx] = [int(t) for t in arr[i, :gcnt[i]]
                                        if t != self.eos_id]
                self.last_latency_s[s.image_idx] = now - t_admit[s.image_idx]
                slots[i] = _Slot()
                if progress is not None:
                    progress(1)

        try:
            pending = next_block()
            while pending is not None or any(s.active for s in slots):
                n_free = sum(not s.active for s in slots)
                if pending is not None and n_free >= len(pending[0]):
                    admit(*pending)
                    pending = next_block()
                    continue
                stop = len(pending[0]) if pending is not None else B + 1
                stats["chunks"] += 1
                resolve(self._chunk(state, cache, stop, stats))
        except KeyboardInterrupt:
            # unfinished inputs stay None so the caller can evaluate what
            # completed, as the reference does
            print("\n[batcher] interrupted — returning completed results")
        finally:
            block_iter.close()
        return results
