"""Assembled VLM (``vlm_tpu/models/vlm.py``): vision tower -> projector ->
token merge -> decoder. PaliGemma's layout is [256 image tokens]
[BOS + prompt + "\\n"], a prefix-LM: the prompt prefix attends
bidirectionally, generated tokens causally. LLaVA's is [BOS + "USER: "]
[576 image tokens: CLIP's penultimate layer, CLS dropped]
["\\n" + prompt + " ASSISTANT:"], causal throughout.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import torch
from torch import nn

from ..ops import _lib
from ..utils.profiling import annotate
from .configs import VLMConfig
from .decoder import Decoder
from .projector import build_projector
from .vit import ViTEncoder


#: CUDA graphs :meth:`VLMModule.encode_images` keeps a module, each holding
#: its encoding's activations in a private memory pool (~100-200 MB for
#: BLIP-2 at 8 images) while it is kept: the batcher and the wave engine
#: make two keys each (their block and the run's last, smaller one), beams
#: one, so two callers sharing a module fit
ENCODE_GRAPHS = 4


class _EncodeGraph:
    """One image encoding captured as a CUDA graph: the static input the
    pixels are copied into, the output each replay rewrites, and the
    kernel launches a replay makes (added to ``_lib.launches``, as the
    wrappers count them when called). Made at a key's first call, whose
    result is :attr:`first`: the encoding run eager on the capture's
    stream, which warms that stream's library state before the capture."""

    def __init__(self, encode, pixels: torch.Tensor):
        with torch.inference_mode(False):   # written by later calls too
            self.pixels = torch.empty(pixels.shape, dtype=pixels.dtype,
                                      device=pixels.device)
        self.pixels.copy_(pixels)
        caller = torch.cuda.current_stream(pixels.device)
        stream = torch.cuda.Stream(pixels.device)
        stream.wait_stream(caller)
        self.launches = {name: 0 for name in _lib.KERNELS}
        self.first = None
        try:
            # the outer context restores the caller's stream also where
            # the capture fails (torch.cuda.graph's exit then unsets it)
            with torch.cuda.stream(stream):
                self.first = encode(self.pixels)
                self.graph = torch.cuda.CUDAGraph()
                # thread_local: the batcher's prefetch thread may enqueue
                # work (on another stream) while the capture runs; its
                # launches count as ever, this thread's in self.launches
                with _lib.counting_into(self.launches), torch.cuda.graph(
                        self.graph, stream=stream,
                        capture_error_mode="thread_local"):
                    self.out = encode(self.pixels)
        finally:
            caller.wait_stream(stream)
            if self.first is not None:
                self.first.record_stream(caller)

    def __call__(self, pixels: torch.Tensor) -> torch.Tensor:
        self.pixels.copy_(pixels)
        self.graph.replay()
        for k, n in self.launches.items():
            if n:
                _lib.launches[k] += n
        # the caller's own tensor: the next replay rewrites self.out
        return self.out.clone()


class VLMModule(nn.Module):
    """``quant_bits`` (8, 4 or 0): the decoder blocks' weights, int8,
    grouped int4 or unquantized; ``vision_quant_bits``: the vision blocks'
    (``quantize_vision``). The patch embedding, the projector and the tied
    head stay in ``dtype``. ``mesh``: built at this rank's shard of
    ``vlm_tpu``'s tensor-parallel layout (each part's module docs).

    :meth:`encode_images` counts its calls: ``encode_graph_replays`` were
    answered by a CUDA graph's replay, ``encode_eager`` ran the encoding
    eager (a capturing call too); ``encode_graph_captures`` counts the
    graphs made."""

    def __init__(self, cfg: VLMConfig, *, dtype=torch.float32, device=None,
                 quant_bits: int = 0, vision_quant_bits: int = 0,
                 mesh=None):
        super().__init__()
        # input key -> its _EncodeGraph, or "eager" (its capture failed)
        self._encode_graphs: Dict[tuple, object] = {}
        self.encode_graph_replays = 0
        self.encode_graph_captures = 0
        self.encode_eager = 0
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.vision = ViTEncoder(cfg.vision, dtype=dtype, device=device,
                                 quant_bits=vision_quant_bits, mesh=mesh)
        self.projector = build_projector(cfg, dtype=dtype, device=device,
                                         mesh=mesh)
        self.decoder = Decoder(cfg.decoder, dtype=dtype, device=device,
                               quant_bits=quant_bits, mesh=mesh)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed.weight.device

    def _apply(self, fn, recurse=True):
        # a graph reads the weights where they lay at its capture
        self._encode_graphs.clear()
        return super()._apply(fn, recurse)

    def load_state_dict(self, *args, **kwargs):
        self._encode_graphs.clear()
        return super().load_state_dict(*args, **kwargs)

    # ---------------- vision ----------------
    def encode_images(self, pixels: torch.Tensor,
                      replicated: bool = False) -> torch.Tensor:
        """[B,H,W,3] normalized pixels, or their [B, N, P*P*3] patch
        vectors -> [B, T_img, decoder_hidden]. ``replicated``: as
        :meth:`prefill`'s.

        CUDA pixels with no gradient and no mesh take one CUDA graph of
        the tower and the projector for their shape, dtype and
        ``replicated`` (while fewer than :data:`ENCODE_GRAPHS` are kept):
        the first call at a key runs eager on the capture's stream, then
        captures; later calls replay the graph, the same kernels in the
        same order without their host work. A capture that fails leaves
        its key eager. A mesh's collectives cannot be captured and autograd
        cannot run through a replay, so those calls run eager."""
        if not pixels.is_cuda or torch.is_grad_enabled() or \
                self.mesh is not None:
            self.encode_eager += 1
            return self._encode(pixels, replicated)
        key = (tuple(pixels.shape), pixels.dtype, replicated)
        graphs = self._encode_graphs
        entry = graphs.get(key)
        if isinstance(entry, _EncodeGraph):
            self.encode_graph_replays += 1
            with annotate("vlm.encode_graph"):
                return entry(pixels)
        self.encode_eager += 1
        if entry is None and sum(isinstance(g, _EncodeGraph)
                                 for g in graphs.values()) < ENCODE_GRAPHS:
            return self._capture(key, pixels, replicated)
        return self._encode(pixels, replicated)

    def _capture(self, key: tuple, pixels: torch.Tensor,
                 replicated: bool) -> torch.Tensor:
        """Capture the graph at ``key`` (or mark it "eager" where the
        capture fails); the first call's result."""
        try:
            graph = _EncodeGraph(
                lambda px: self._encode(px, replicated), pixels)
        except RuntimeError as err:   # an operation a capture cannot hold
            # a capture cut short leaves the CUDA generators in capture
            # mode (each later draw would raise); a whole one ends it
            with torch.cuda.graph(torch.cuda.CUDAGraph(),
                                  capture_error_mode="thread_local"):
                torch.zeros(1, device=pixels.device)
            warnings.warn(f"encode_images: no CUDA graph at {key}, which "
                          f"runs eager: {err}")
            self._encode_graphs[key] = "eager"
            return self._encode(pixels, replicated)
        self.encode_graph_captures += 1
        self._encode_graphs[key] = graph
        first, graph.first = graph.first, None
        return first

    def _encode(self, pixels: torch.Tensor,
                replicated: bool) -> torch.Tensor:
        cfg = self.cfg
        with annotate("vlm.vision"):
            out = self.vision(
                pixels, keep_hidden_states=cfg.vision_feature_layer != -1,
                replicated=replicated)
        with annotate("vlm.projector"):
            if cfg.vision_feature_layer == -1:
                feats = out["last_hidden_state"]
            else:
                feats = out["hidden_states"][cfg.vision_feature_layer]
            if cfg.drop_cls_for_llm and cfg.vision.use_cls_token:
                feats = feats[:, 1:]
            return self.projector(feats)

    # ---------------- merge + decode ----------------
    def merge_embeds(self, pre_ids: torch.Tensor, image_embeds: torch.Tensor,
                     post_ids: torch.Tensor) -> torch.Tensor:
        """[B,P1],[B,T,H],[B,P2] -> [B, P1+T+P2, H]."""
        parts = []
        if pre_ids.shape[1] > 0:
            parts.append(self.decoder.embed_tokens(pre_ids))
        parts.append(image_embeds.to(self.dtype))
        if post_ids.shape[1] > 0:
            parts.append(self.decoder.embed_tokens(post_ids))
        return torch.cat(parts, dim=1)

    def forward(self, pixels: torch.Tensor, pre_ids: torch.Tensor,
                post_ids: torch.Tensor,
                kv_len: Optional[torch.Tensor] = None,
                prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward without a cache: logits [B, S, V]. For prefix-LM
        families ``prefix_len`` marks the bidirectional prefix; without it
        the whole input is prefix."""
        embeds = self.merge_embeds(pre_ids, self.encode_images(pixels),
                                   post_ids)
        if self.cfg.prefix_lm and prefix_len is None:
            return self.decoder(input_embeds=embeds, kv_len=kv_len,
                                causal=False)
        return self.decoder(input_embeds=embeds, kv_len=kv_len, causal=True,
                            prefix_len=prefix_len if self.cfg.prefix_lm
                            else None)

    def prefill(self, pixels: torch.Tensor, pre_ids: torch.Tensor,
                post_ids: torch.Tensor, cache: Dict[str, tuple],
                prompt_len: torch.Tensor,
                replicated: bool = False) -> torch.Tensor:
        """Run the prompt through the decoder, writing the cache in place
        from column 0; ``prompt_len`` [B] are the true merged lengths.
        Returns next-token logits [B, V] in the compute dtype.

        Under a mesh the rows are this data rank's share of a batch split
        over the data ranks, or, with ``replicated`` (the batcher's
        admissions), the same rows on every data rank: the quantized
        products' 512-row dispatch and llm.int8's outlier columns count
        the global rows either way."""
        with annotate("vlm.prefill"):
            image_embeds = self.encode_images(pixels, replicated)
            with annotate("vlm.decoder"):
                embeds = self.merge_embeds(pre_ids, image_embeds, post_ids)
                b, s, _ = embeds.shape
                positions = torch.arange(s, device=embeds.device).expand(b, s)
                logits = self.decoder(
                    input_embeds=embeds, positions=positions, cache=cache,
                    write_start=0, kv_len=prompt_len,
                    causal=not self.cfg.prefix_lm,
                    logits_index=prompt_len - 1, uniform_write=True,
                    logits_dtype=self.dtype, replicated=replicated)
                return logits[:, 0]

    def decode_step(self, token_ids: torch.Tensor, seq_len: torch.Tensor,
                    cache: Dict[str, tuple], uniform_write: bool = False,
                    write_col: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    kv_window=None) -> torch.Tensor:
        """One token per sequence: ``token_ids`` [B,1]; ``seq_len`` [B] is
        the new token's position. Returns logits [B, V].

        Without ``write_col``, each row writes at ``seq_len`` and attends
        over ``seq_len + 1`` rows; ``uniform_write=True`` promises that
        every row is at ``seq_len[0]`` (the wave and beam engines over
        batch-constant prompts), so B3 writes at that one column.

        ``write_col`` (a 0-d int32 tensor) with ``kv_valid`` [B, L] or
        ``kv_window`` ``(pcol, W, acol, gcnt)``: the continuous batcher's
        rotating window. Every slot writes its row at the same column,
        passed on as one offset (an expanded view would cost a copy kernel
        a layer to make contiguous); the mask marks each slot's live rows;
        RoPE positions still come from ``seq_len``."""
        positions = seq_len[:, None]
        if write_col is not None:
            write_start = write_col.reshape(1)
        elif uniform_write:
            write_start = seq_len[:1]
        else:
            write_start = seq_len
        masked = kv_valid is not None or kv_window is not None
        with annotate("vlm.decode_step"):
            logits = self.decoder(
                input_ids=token_ids, positions=positions, cache=cache,
                write_start=write_start,
                kv_len=None if masked else seq_len + 1, causal=False,
                uniform_write=uniform_write or write_col is not None,
                kv_valid=kv_valid, kv_window=kv_window,
                logits_dtype=self.dtype)
            return logits[:, 0]


def num_image_tokens(cfg: VLMConfig) -> int:
    if cfg.projector == "qformer":
        return cfg.qformer.num_query_tokens
    n = cfg.vision.num_patches
    if not cfg.drop_cls_for_llm and cfg.vision.use_cls_token:
        n += 1
    return n


def device_memory_limit(device) -> Optional[int]:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``),
    which stands for ``vlm_tpu``'s ``bytes_limit``; None off the card,
    where the fit check is skipped (as ``vlm_tpu`` skips a backend without
    ``memory_stats``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def param_bytes(cfg: VLMConfig, *, dtype=torch.float32, quant_bits: int = 0,
                vision_quant_bits: int = 0, model_ways: int = 1) -> int:
    """The weights' bytes, computed without allocating: the module built on
    ``meta``, its parameters and buffers summed at their real dtypes (int8
    tables, packed int4 bytes, fp32 scales); with ``model_ways``, one
    rank's shard of them (a replicated tensor counted whole)."""
    from ..core.mesh import Mesh
    mesh = Mesh(1, model_ways, groups=False) if model_ways > 1 else None
    module = VLMModule(cfg, dtype=dtype, device="meta", quant_bits=quant_bits,
                       vision_quant_bits=vision_quant_bits, mesh=mesh)
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def check_hbm_fit(cfg: VLMConfig, device, *, dtype=torch.float32,
                  quant_bits: int = 0, vision_quant_bits: int = 0,
                  model_ways: int = 1) -> None:
    """Refuse a build whose weights alone cannot fit the card's memory,
    before anything is allocated: ``vlm_tpu``'s decision, with a rank's
    bytes over ``model_ways`` tensor-parallel ways counted as its shard
    holds them (``vlm_tpu`` divides the total; the port also counts what
    every rank holds whole, such as MQA's K/V projections). Weights only:
    the KV cache and the activations come on top, so a refusal is never a
    false positive.
    ``param_bytes`` is what the tensors ask the allocator for; its blocks
    round each tensor up (on an H100, up to 96 MiB more for LLaVA-7B's
    8bit weights, 1.3 %; ``chip_smoke.py`` fails a build past 2 %), a
    margin the check leaves to the caller, as ``vlm_tpu``'s leaves XLA's
    padding. ``VLM_TPU_SKIP_FIT_CHECK=1`` skips it."""
    if os.environ.get("VLM_TPU_SKIP_FIT_CHECK") == "1":
        return
    limit = device_memory_limit(device)
    if limit is None:
        return
    quant = dict(dtype=dtype, quant_bits=quant_bits,
                 vision_quant_bits=vision_quant_bits)
    total = param_bytes(cfg, **quant)
    per_rank = total if model_ways <= 1 else \
        param_bytes(cfg, model_ways=model_ways, **quant)
    if per_rank <= limit:
        return
    need_ways = -(-total // limit)
    raise ValueError(
        f"Model weights ({total / 2**30:.1f} GiB"
        + (f", {per_rank / 2**30:.1f} GiB a rank over model={model_ways}"
           if model_ways > 1 else "")
        + f") exceed the device's memory ({limit / 2**30:.1f} GiB) before "
        f"any KV cache or activations. Use `quantization: 8bit` (or 4bit) "
        f"to shrink the weights, or shard them with tensor parallelism: "
        f"`mesh: {{model: {max(need_ways, 2)}}}` under `torchrun "
        f"--nproc_per_node N` (weights-only bound; leave headroom for the "
        f"KV cache).")
