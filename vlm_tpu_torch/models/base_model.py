"""User-facing model objects (``vlm_tpu/models/base_model.py``):
``VLMModel(...).generate_dataset(paths, prompt)`` on the continuous batcher
(beam search in waves of ``generate_batch``), the call ``run_zero_shot``
makes; ``generate_batch(images, prompt)`` and ``generate_text`` on the wave
engine or beam search; and ``get_vision_backbone()``, the tower alone for
probing.

Weights are random, drawn on the device from ``seed``, unless ``model_id``
names a local directory: a checkpoint in the port's own format
(:mod:`..utils.checkpoint`) or HF safetensors (:mod:`.hf_weights`),
chosen by the directory's contents. The tokenizer (from ``model_id`` when
given), the image files and PIL are reached only when generating.

A model runs on the card unless the caller asks for the CPU
(:func:`resolve_device`).

``mesh={data, model}`` (one process a rank under ``torchrun``,
:mod:`..core.mesh`) builds this rank's shard of the model on the rank's
device: random weights are the unsharded model's from the same seed, a
checkpoint is read a tensor at a time and sliced to the shard. The
generation calls pad a batch to a multiple of ``data`` with a repeat of
its last image (the extras dropped), decode only this data rank's images
(``generate_batch``) and give every rank the full, ordered results.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core.mesh import mesh_from_config, pad_to_multiple
from ..data.native_loader import load_batch
from ..generate.batcher import ContinuousBatcher
from ..generate.beam import BeamSearchEngine
from ..generate.decode import GenerationEngine, build_prompt_ids
from ..generate.readback import upload
from ..ops.preprocess import host_batch, normalize_images, recipe_for
from ..utils.checkpoint import (is_vlm_checkpoint, load_vlm_checkpoint,
                                save_vlm_checkpoint)
from .backbone import VisionBackbone
from .configs import VLM_CONFIGS, VLMConfig
from .hf_weights import load_vlm_weights
from .layers import init_random_
from .vlm import VLMModule, check_hbm_fit, num_image_tokens

@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Compute dtype and integer weight bits of one quantization mode."""
    compute_dtype: torch.dtype
    quantized_bits: int = 0


def policy_for(quantization: Optional[str]) -> DTypePolicy:
    """``vlm_tpu/core/dtypes.py``'s policy: fp32 -> float32; fp16/bf16 ->
    bfloat16; 8bit -> bfloat16 compute with int8 weights; 4bit -> bfloat16
    compute with grouped int4 weights."""
    q = (quantization or "fp32").lower()
    if q == "fp32":
        return DTypePolicy(torch.float32)
    if q in ("fp16", "bf16"):
        return DTypePolicy(torch.bfloat16)
    if q == "8bit":
        return DTypePolicy(torch.bfloat16, quantized_bits=8)
    if q == "4bit":
        return DTypePolicy(torch.bfloat16, quantized_bits=4)
    raise ValueError(f"Unknown quantization {quantization!r}; allowed: "
                     f"fp32 fp16 bf16 8bit 4bit")


def _checkpoint_kind(model_id) -> str:
    """"native" (the port's format) or "hf" (safetensors files), by the
    directory's contents, as ``vlm_tpu`` chooses. A path that does not
    exist raises ``FileNotFoundError`` (hub ids are never downloaded); a
    ``vlm_tpu`` directory (flax ``params.msgpack``) or one holding neither
    format raises too."""
    p = Path(model_id)
    if not p.exists():
        raise FileNotFoundError(
            f"model_id {model_id!r} is not a local checkpoint directory "
            f"(hub ids are not supported; convert the checkpoint locally)")
    if is_vlm_checkpoint(p):
        return "native"
    if (p / "params.msgpack").exists():
        raise ValueError(
            f"model_id {model_id!r} holds a vlm_tpu checkpoint "
            f"(params.msgpack, flax msgpack), which is not readable by the "
            f"port; load the HF safetensors it was made from instead")
    if p.is_dir() and any(p.glob("*.safetensors")):
        return "hf"
    raise FileNotFoundError(
        f"model_id {model_id!r} holds neither a checkpoint of the port "
        f"(params.safetensors + config.yaml) nor HF *.safetensors files")


def resolve_device(device=None) -> torch.device:
    """The device a model runs on: ``device`` when given; else the CPU if
    ``VLM_TPU_PLATFORM=cpu`` (``vlm_tpu``'s switch), else the card. With
    neither and no CUDA device, raises rather than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("VLM_TPU_PLATFORM", "").lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' or set "
                           "VLM_TPU_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")


def resolve_quantize_vision(flag: Optional[bool]) -> bool:
    """``quantize_vision``: an explicit value wins, else
    ``VLM_TPU_QUANT_VISION=1`` (``vlm_tpu``'s resolve_quantize_vision)."""
    if flag is None:
        return os.environ.get("VLM_TPU_QUANT_VISION", "0") == "1"
    return bool(flag)


class VLMModel:
    """Base VLM; subclasses define the prompt template
    (:meth:`format_prompt`)."""

    family: str = ""
    DEFAULT_SIZE = "test"

    def __init__(self, model_id: Optional[str] = None, device=None,
                 quantization: str = "fp32", *, size: Optional[str] = None,
                 seed: int = 0, batch_size: int = 8, mesh=None,
                 kv_cache: Optional[str] = None,
                 quantize_vision: Optional[bool] = None):
        self.mesh = mesh_from_config(mesh, device)
        self.model_id = model_id
        weights = _checkpoint_kind(model_id) if model_id else None
        self.quantization = quantization
        self.policy = policy_for(quantization)
        self.dtype = self.policy.compute_dtype
        self.kv_cache = kv_cache
        self.device = self.mesh.device if self.mesh is not None else \
            resolve_device(device)
        self.cfg: VLMConfig = VLM_CONFIGS[self.family](
            size or self.DEFAULT_SIZE)
        self.batch_size = batch_size
        self.recipe = recipe_for(self.family)
        if self.recipe.image_size != self.cfg.vision.image_size:
            self.recipe = dataclasses.replace(
                self.recipe, image_size=self.cfg.vision.image_size)
        bits = self.policy.quantized_bits
        self.quantize_vision = resolve_quantize_vision(quantize_vision)
        quant = dict(dtype=self.dtype, quant_bits=bits,
                     vision_quant_bits=bits if self.quantize_vision else 0)
        ways = self.mesh.model if self.mesh is not None else 1
        check_hbm_fit(self.cfg, self.device, model_ways=ways, **quant)
        self.module = VLMModule(self.cfg, device=self.device, mesh=self.mesh,
                                **quant)
        if weights == "native":
            load_vlm_checkpoint(model_id, self.module,
                                self._checkpoint_meta())
        elif weights == "hf":
            load_vlm_weights(self.family, self.cfg, model_id, self.module)
        else:
            init_random_(self.module, seed, full=VLMModule(
                self.cfg, device="meta", **quant) if ways > 1 else None)
        self.module.eval()
        self._tokenizer = None
        self._engines: Dict[Any, Any] = {}

    @property
    def cache_dtype(self):
        """The KV cache's dtype: "int8" (QuantizedKV layers) or the compute
        dtype. An explicit ``kv_cache`` wins; without one,
        ``VLM_TPU_KV_CACHE=int8`` is read here, at generation time, as
        ``vlm_tpu``'s ``kv_cache_dtype`` reads it."""
        choice = self.kv_cache if self.kv_cache is not None else \
            os.environ.get("VLM_TPU_KV_CACHE", "")
        return "int8" if str(choice).lower() == "int8" else self.dtype

    @property
    def tokenizer(self):
        """The tokenizer from ``model_id``'s files (a byte-level fallback
        without them), imported at first use."""
        if self._tokenizer is None:
            from ..data.tokenizer import load_tokenizer
            dec = self.cfg.decoder
            self._tokenizer = load_tokenizer(
                self.model_id, bos_id=dec.bos_token_id,
                eos_id=dec.eos_token_id, pad_id=dec.pad_token_id)
        return self._tokenizer

    def _checkpoint_meta(self) -> dict:
        """What a checkpoint of this model records (``vlm_tpu``'s keys);
        loading one that differs raises."""
        return {"family": self.family, "quantization": self.quantization,
                "vision_layers": self.cfg.vision.layers,
                "decoder_layers": self.cfg.decoder.layers}

    def save_checkpoint(self, path) -> None:
        """Write the model in the port's format; ``model_id=path`` loads
        it back. A model split over a mesh's model axis holds no whole
        tensor to write and raises."""
        if self.mesh is not None and self.mesh.model > 1:
            raise ValueError("save_checkpoint of a tensor-parallel shard: "
                             "save the model built without a mesh")
        save_vlm_checkpoint(path, self.module, self._checkpoint_meta())

    def data_ways(self) -> int:
        """The mesh's data axis (1 without a mesh)."""
        return self.mesh.data if self.mesh is not None else 1

    def format_prompt(self, prompt: str):
        """(pre_text, post_text, add_bos_to_pre, add_bos_to_post): the text
        around the image-token block."""
        raise NotImplementedError

    def _engine(self, batch: int, prompt_len: int, max_tokens: int,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0) -> GenerationEngine:
        # the cache dtype is in the key: flipping VLM_TPU_KV_CACHE between
        # calls must not reuse an engine of the other dtype
        key = (batch, prompt_len, max_tokens, str(self.cache_dtype),
               temperature, top_k, top_p)
        if key not in self._engines:
            self._engines[key] = GenerationEngine(
                self.module, self.cfg, batch_size=batch,
                max_prompt_len=prompt_len, max_new_tokens=max_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                cache_dtype=self.cache_dtype, eos_id=self.tokenizer.eos_id,
                pad_id=self.tokenizer.pad_id)
        return self._engines[key]

    def _beam_engine(self, batch: int, prompt_len: int, max_tokens: int,
                     num_beams: int) -> BeamSearchEngine:
        key = ("beam", batch, prompt_len, max_tokens, num_beams,
               str(self.cache_dtype))
        if key not in self._engines:
            self._engines[key] = BeamSearchEngine(
                self.module, self.cfg, batch_size=batch,
                max_prompt_len=prompt_len, num_beams=num_beams,
                max_new_tokens=max_tokens, cache_dtype=self.cache_dtype,
                eos_id=self.tokenizer.eos_id, pad_id=self.tokenizer.pad_id)
        return self._engines[key]

    def generate_batch(self, images: Sequence, prompt: str,
                       max_tokens: int = 100, num_beams: int = 1,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0) -> List[str]:
        """One prefill and one decode loop over a batch of PIL images;
        decoded texts, EOS removed. ``num_beams > 1`` runs beam search (HF
        ``generate`` semantics); ``temperature > 0`` samples (optionally
        top-k / nucleus filtered) from a generator seeded with ``seed``."""
        # under a mesh the batch splits over the data axis: pad it with a
        # repeat of the last image, drop the extras at the end
        n = len(images)
        b = pad_to_multiple(n, self.data_ways())
        images = list(images) + [images[-1]] * (b - n)
        mine = self.mesh.rows(b) if self.mesh is not None else slice(0, b)
        pixels = normalize_images(
            upload(host_batch(images[mine], self.recipe), self.device),
            recipe=self.recipe, compute_dtype=self.dtype,
            patch_size=self.cfg.vision.patch_size)
        tok = self.tokenizer
        pre_t, post_t, bos_pre, bos_post = self.format_prompt(prompt)
        ids = build_prompt_ids(
            tok, pre_t, post_t, num_image_tokens(self.cfg), b,
            add_bos_to_pre=bos_pre, add_bos_to_post=bos_post)
        plen = int(ids[2][0])
        pre_ids, post_ids, prompt_len = (upload(t, self.device) for t in ids)
        if num_beams > 1:
            if temperature > 0:
                raise ValueError("beam search is deterministic; "
                                 "temperature>0 with num_beams>1 is not "
                                 "supported (HF raises the same way)")
            result = self._beam_engine(b, plen, max_tokens, num_beams
                                       ).generate(pixels, pre_ids, post_ids,
                                                  prompt_len)
        else:
            generator = None
            if temperature > 0:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            result = self._engine(b, plen, max_tokens, temperature, top_k,
                                  top_p).generate(pixels, pre_ids, post_ids,
                                                  prompt_len,
                                                  generator=generator)
        toks = result.tokens.cpu().numpy()
        lens = result.lengths.cpu().numpy()
        return [tok.decode([int(t) for t in toks[i, :lens[i]]
                            if int(t) != tok.eos_id]).strip()
                for i in range(n)]

    def generate_text(self, image, prompt: str, max_tokens: int = 100) -> str:
        """One image (the reference's API); prefer :meth:`generate_batch`."""
        return self.generate_batch([image], prompt, max_tokens)[0]

    def generate_waves(self, image_paths: Sequence, prompt: str,
                       batch_size: Optional[int] = None, progress=None,
                       **generation) -> List[Optional[str]]:
        """Waves of ``batch_size`` image files through
        :meth:`generate_batch` (``generation``: its keyword arguments), a
        short last wave padded with its last image so that one engine
        serves every wave: the loop of ``vlm_tpu``'s beam
        ``generate_dataset`` and of its CLI without continuous batching.
        Texts in input order; None for the waves an interrupt left
        undone."""
        from PIL import Image
        bs = pad_to_multiple(batch_size or self.batch_size, self.data_ways())
        paths = list(image_paths)
        out: List[Optional[str]] = [None] * len(paths)
        try:
            for start in range(0, len(paths), bs):
                images = [Image.open(p).convert("RGB")
                          for p in paths[start:start + bs]]
                k = len(images)
                images += [images[-1]] * (bs - k)
                out[start:start + k] = self.generate_batch(
                    images, prompt, **generation)[:k]
                if progress is not None:
                    progress(k)
        except KeyboardInterrupt:
            print("\n[generate_waves] interrupted — returning completed "
                  "results")
        return out

    def generate_dataset(self, image_paths: Sequence, prompt: str,
                         max_tokens: int = 100,
                         batch_size: Optional[int] = None, progress=None,
                         num_beams: int = 1, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         seed: int = 0) -> List[Optional[str]]:
        """Generation over image files; decoded texts in input order (None
        for inputs an interrupt left unfinished). Continuous batching, or
        with ``num_beams > 1`` :meth:`generate_waves` (the beams of a wave
        share its cache)."""
        if num_beams > 1:
            return self.generate_waves(
                image_paths, prompt, batch_size, progress,
                max_tokens=max_tokens, num_beams=num_beams,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed)
        paths = list(image_paths)
        tok = self.tokenizer
        pre_t, post_t, bos_pre, bos_post = self.format_prompt(prompt)
        pre_ids, post_ids, prompt_len = build_prompt_ids(
            tok, pre_t, post_t, num_image_tokens(self.cfg), 1,
            add_bos_to_pre=bos_pre, add_bos_to_post=bos_post)

        def pixel_fn(idxs):
            batch = upload(load_batch([paths[i] for i in idxs], self.recipe),
                           self.device)
            return normalize_images(batch, recipe=self.recipe,
                                    compute_dtype=self.dtype,
                                    patch_size=self.cfg.vision.patch_size)

        generator = None
        if temperature > 0:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        batcher = ContinuousBatcher(
            self.module, self.cfg,
            batch_size=pad_to_multiple(batch_size or self.batch_size,
                                       self.data_ways()),
            max_prompt_len=int(prompt_len[0]), max_new_tokens=max_tokens,
            eos_id=tok.eos_id, pad_id=tok.pad_id, temperature=temperature,
            top_k=top_k, top_p=top_p, generator=generator,
            cache_dtype=self.cache_dtype)
        token_lists = batcher.run(
            pixel_fn, pre_ids_row=pre_ids[0].numpy(),
            post_ids_row=post_ids[0].numpy(),
            prompt_len_scalar=int(prompt_len[0]), n_images=len(paths),
            progress=progress)
        if os.environ.get("VLM_TPU_BATCHER_STATS", "0") == "1":
            print(f"[batcher stats] {batcher.last_stats}", file=sys.stderr)
        return [tok.decode(t).strip() if t is not None else None
                for t in token_lists]

    def get_vision_backbone(self, cleanup: bool = True) -> VisionBackbone:
        """The vision tower for probing, frozen. ``cleanup=True`` drops the
        projector and decoder and returns their device memory to the card
        (LLaVA-7B's fp32 decoder holds ~27 GB). Under a mesh the backbone
        keeps it: the rank's shard of the tower, its batches split over
        the data axis."""
        backbone = VisionBackbone(
            self.cfg, self.module.vision, self.dtype, self.recipe,
            batch_size=self.batch_size,
            quant_bits=self.policy.quantized_bits if self.quantize_vision
            else 0, mesh=self.mesh)
        if cleanup:
            self.module = None
            self._engines.clear()
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return backbone


class LLaVAModel(VLMModel):
    """LLaVA-1.5-7B: CLIP-L/14-336, the MLP projector and Vicuna-7B, as
    ``USER: <image>\\n{prompt} ASSISTANT:`` with BOS before ``USER:``."""
    family = "llava"
    DEFAULT_SIZE = "7b"

    def format_prompt(self, prompt: str):
        return "USER: ", f"\n{prompt} ASSISTANT:", True, False


class BLIP2OptModel(VLMModel):
    """BLIP-2 OPT-6.7B: EVA ViT-g, the Q-Former and OPT-6.7B, as the 32
    query tokens, then BOS + ``Question: {prompt}. Answer:``."""
    family = "blip2"
    DEFAULT_SIZE = "6.7b"

    def format_prompt(self, prompt: str):
        return "", f"Question: {prompt}. Answer:", False, True


class PaLIGemmaModel(VLMModel):
    """PaliGemma-3B-mix-224: image tokens first, then BOS + prompt +
    newline."""
    family = "paligemma"
    DEFAULT_SIZE = "3b"

    def format_prompt(self, prompt: str):
        return "", f"{prompt}\n", False, True
