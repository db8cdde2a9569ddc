"""Vision backbone adapter for probing (``vlm_tpu/models/backbone.py``):
batched feature extraction with per-family pooling, and freeze/unfreeze.

``forward(images) -> [B, D]`` takes PIL images, a uint8 ``[B, S, S, 3]``
batch (normalised by B4 straight into the patch embedding's layout) or
already normalised pixels. Freeze/unfreeze sets ``requires_grad`` on the
tower's parameters, selected by ``vlm_tpu``'s key sets matched against the
port's names (``blocks.<i>.attn.q_proj.weight``, ``patch_embed.weight``,
...); the tower is built all frozen, as every model of the port.
``get_lora_target_names`` selects LoRA's layers by the same key sets.

Under a mesh (``mesh=``, the model's) the tower holds its tensor-parallel
shard and a batch splits over the data axis: :meth:`forward` and
:meth:`extract_features_dataset` pad it to a multiple of ``data`` with
its last image, run this data rank's rows (each rank decodes only its
files) and all-gather the pooled features, so every rank returns the
whole ``[B, D]``; :meth:`features` runs the rows it is given (a trainer's
rank rows).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.mesh import DATA_AXIS, pad_to_multiple
from ..data.native_loader import load_batch
from ..ops.preprocess import PreprocessRecipe, host_batch, normalize_images
from ..parallel.distributed import process_local_slice
from ..parallel.sharding import shard_batch
from .configs import VLMConfig
from .vit import ViTEncoder

_EMBED_KEYS = ("patch_embed", "cls_token", "pos_embed", "pre_ln", "post_ln")
_ATTN_KEYS = ("q_proj", "k_proj", "v_proj", "out_proj")
_MLP_KEYS = ("fc1", "fc2")
_NORM_KEYS = ("ln1", "ln2")
_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def pad_rows(images, b: int):
    """``images`` (a list, an array or a tensor) padded to ``b`` rows with
    its last one."""
    n = len(images)
    if n == b:
        return images
    if isinstance(images, (list, tuple)):
        return list(images) + [images[-1]] * (b - n)
    if torch.is_tensor(images):
        return torch.cat([images, images[-1:].expand(b - n,
                                                     *images.shape[1:])])
    return np.concatenate([images, np.repeat(images[-1:], b - n, axis=0)])


class VisionBackbone:
    """Feature extractor over a :class:`ViTEncoder` with the reference's
    pooling (``cfg.backbone_pooling``: mean, cls or pooler)."""

    def __init__(self, cfg: VLMConfig, module: ViTEncoder,
                 dtype: torch.dtype, recipe: PreprocessRecipe,
                 batch_size: int = 64, quant_bits: int = 0, mesh=None):
        self.cfg = cfg
        #: the parent model's ``(data, model)`` mesh, or None
        self.mesh = mesh
        if mesh is not None:
            batch_size = pad_to_multiple(batch_size, mesh.data)
        self.vit_cfg = cfg.vision
        self.output_dim = cfg.backbone_dim
        self.recipe = recipe if recipe.image_size == cfg.vision.image_size \
            else dataclasses.replace(recipe, image_size=cfg.vision.image_size)
        self.dtype = dtype
        self.batch_size = batch_size
        #: int8/int4 tower (``quantize_vision``): feature extraction only
        self.quant_bits = quant_bits
        self.module = module
        self.set_freeze(True)

    @property
    def device(self) -> torch.device:
        return self.module.pos_embed.device

    # ------------------------- forward -------------------------
    def features(self, pixels: torch.Tensor, pooling: Optional[str] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """The differentiable path: normalised pixels (NHWC or patch
        vectors) -> pooled ``[B, D]``. ``params`` (names -> tensors) stand
        in for the tower's own through ``torch.func.functional_call``
        (LoRA's merged weights)."""
        pooling = pooling or self.cfg.backbone_pooling
        if pooling not in ("pooler", "cls", "mean"):
            raise ValueError(f"unsupported pooling strategy {pooling!r}")
        if params is None:
            out = self.module(pixels, keep_hidden_states=False)
        else:
            out = torch.func.functional_call(
                self.module, dict(params), (pixels,),
                {"keep_hidden_states": False})
        if pooling == "pooler":
            return out["pooled"]
        if pooling == "cls":
            return out["last_hidden_state"][:, 0]
        return out["last_hidden_state"].mean(dim=1)

    def forward(self, images, strategy: Optional[str] = None) -> torch.Tensor:
        """images: PIL images, a uint8 ``[B, S, S, 3]`` array or tensor, or
        normalised pixels. ``strategy`` overrides the pooling. Under a mesh
        every rank passes the whole batch and gets every row's features."""
        if self.mesh is None or self.mesh.data == 1:
            return self.features(self.to_pixels(images), strategy)
        n = len(images)
        b = pad_to_multiple(n, self.mesh.data)
        mine = shard_batch(pad_rows(images, b), self.mesh)
        return self.gather_rows(self.features(self.to_pixels(mine),
                                              strategy))[:n]

    def gather_rows(self, feats: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``feats``, in rank order."""
        if self.mesh is None or self.mesh.data == 1:
            return feats
        return self.mesh.gather(feats, DATA_AXIS, 0)

    __call__ = forward

    def to_pixels(self, images) -> torch.Tensor:
        """Normalised pixels on the tower's device: uint8 batches through
        B4 into the patch layout, floating ones cast to the compute dtype."""
        if isinstance(images, (list, tuple)):
            images = host_batch(images, self.recipe)
        t = torch.as_tensor(images).to(self.device)
        if t.dtype == torch.uint8:
            return normalize_images(t, recipe=self.recipe,
                                    compute_dtype=self.dtype,
                                    patch_size=self.vit_cfg.patch_size)
        return t.to(self.dtype)

    def extract_features_dataset(self, image_paths: Sequence,
                                 batch_size: Optional[int] = None,
                                 progress: bool = True) -> np.ndarray:
        """A whole dataset through the tower -> ``[N, D]`` fp32 numpy (the
        feature cache's hot loop). Files are decoded and resized on a
        background thread one batch ahead; the tail is padded to the batch
        size with its last image; features stay on the device until the
        end, so the loop never waits for a copy. Under a mesh the batch
        size is a multiple of ``data``, each rank decodes its rows of a
        batch and the features are all-gathered."""
        from ..data.pipeline import prefetch_batches

        bs = batch_size or self.batch_size
        if self.mesh is not None:
            bs = pad_to_multiple(bs, self.mesh.data)
        start, per = process_local_slice(bs, self.mesh)
        paths = list(image_paths)
        chunks = [paths[i:i + bs] for i in range(0, len(paths), bs)]

        def make_batch(chunk):
            # this rank's rows of the chunk padded with its last image: only
            # the files among them are decoded
            n = len(chunk)
            real = chunk[start:min(start + per, n)]
            arr = load_batch(real or chunk[-1:], self.recipe)
            if len(arr) < per:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], per - len(arr), axis=0)])
            return torch.from_numpy(arr), n

        it = prefetch_batches(chunks, make_batch, depth=2)
        if progress:
            try:
                from tqdm import tqdm
                it = tqdm(it, total=len(chunks), desc="Extracting features",
                          unit="batch")
            except ImportError:
                pass
        out = []
        with torch.inference_mode():
            for arr, n in it:
                out.append(self.gather_rows(
                    self.features(self.to_pixels(arr)))[:n])
            if not out:
                return np.zeros((0, self.output_dim), np.float32)
            return torch.cat(out).float().cpu().numpy()

    # ------------------------- freeze / unfreeze -------------------------
    def _refuse_quantized(self, what: str) -> None:
        if self.quant_bits:
            # an int8/int4 weight has no gradient: unfreezing would train
            # nothing
            raise ValueError(
                f"cannot {what} a quantized vision tower "
                f"(quant_bits={self.quant_bits}); use quantization=fp32/"
                "fp16 or quantize_vision=false for end-to-end training")

    def set_freeze(self, freeze: bool) -> None:
        if not freeze:
            self._refuse_quantized("unfreeze")
        for p in self.module.parameters():
            if p.is_floating_point():
                p.requires_grad_(not freeze)

    @property
    def fully_frozen(self) -> bool:
        return not any(p.requires_grad for p in self.module.parameters())

    def trainable_names(self) -> List[str]:
        return sorted(n for n, p in self.module.named_parameters()
                      if p.requires_grad)

    def unfreeze_last_k_layers(self, k: int = 2, parts: str = "all",
                               include_embeddings: bool = True) -> None:
        """Make the last ``k`` blocks trainable. ``parts``: "all" | "attn" |
        "mlp"; the block's LayerNorms always, the embeddings and global
        norms with ``include_embeddings`` (``vlm_tpu``'s selection)."""
        if int(k) > 0:
            self._refuse_quantized("unfreeze layers of")
        n_layers = self.vit_cfg.layers
        selected = set(range(max(0, n_layers - int(k)), n_layers)) \
            if int(k) > 0 else set()

        def want(name: str) -> bool:
            keys = set(name.split("."))
            m = _BLOCK.match(name)
            if m is not None and int(m.group(1)) in selected:
                if parts == "all":
                    return True
                attn_hit = bool(keys & set(_ATTN_KEYS)) or "attn" in keys
                norm_hit = bool(keys & set(_NORM_KEYS))
                if parts == "attn":
                    return attn_hit or norm_hit
                if parts == "mlp":
                    return bool(keys & set(_MLP_KEYS)) or norm_hit
                return False
            return include_embeddings and bool(keys & set(_EMBED_KEYS))

        for name, p in self.module.named_parameters():
            if want(name) and p.is_floating_point():
                p.requires_grad_(True)
        print(f"[unfreeze_last_k_layers] unfroze {len(selected)} layers "
              f"(indices: {sorted(selected)})")

    # ------------------------- LoRA -------------------------
    def get_lora_target_names(self, strategy: Dict) -> List[str]:
        """The Dense layers of the last ``last_k`` blocks that take
        adapters (``vlm_tpu``'s selection; reference llava.py:189-230):
        the attention projections, with ``attn_only: false`` fc1 and fc2
        too, sorted, by the port's names (``blocks.23.attn.q_proj``)."""
        if self.quant_bits:
            # an int8/int4 Dense holds q and scale: no float weight to merge
            # adapters into, and a LoRA run would train nothing
            raise ValueError(
                "LoRA targets unavailable on a quantized vision tower "
                f"(quant_bits={self.quant_bits}); use quantize_vision="
                "false (the default) for LoRA fine-tuning")
        last_k = int(strategy.get("last_k", 2))
        attn_only = bool(strategy.get("attn_only", True))
        n_layers = self.vit_cfg.layers
        selected = set(range(max(0, n_layers - last_k), n_layers))
        wanted = set(_ATTN_KEYS) if attn_only else \
            set(_ATTN_KEYS) | set(_MLP_KEYS)
        names = set()
        for name, p in self.module.named_parameters():
            m = _BLOCK.match(name)
            if (not name.endswith(".weight") or p.dim() != 2 or m is None
                    or int(m.group(1)) not in selected):
                continue
            if wanted & set(name.split(".")):
                names.add(name[:-len(".weight")])
        return sorted(names)
