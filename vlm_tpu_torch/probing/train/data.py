"""Batch loaders for probe training (``vlm_tpu/probing/train/data.py``):

- :class:`ImageBatchLoader`: ``(list[PIL.Image], list[label_dict])`` from
  a dataset's ``__getitem__``, decoded one batch ahead on a thread;
- :class:`ArrayBatchLoader`: ``(x [B, D], y [B])`` numpy slices of cached
  features.

Shuffled loaders draw one permutation an epoch from
``numpy.random.default_rng(seed)``, so the same seed gives ``vlm_tpu``'s
order; an image loader with a ``sampler`` (:class:`.utils.WeightedSampler`)
takes the sampler's draw an epoch instead. ``skip_epochs(n)`` draws the
first n permutations or samples, so a resumed run sees the order a
straight run would.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class Batch:
    """A training batch that declares its targets' form: ``"dicts"``
    (``list[dict[task, label]]``, -1 or None missing) or ``"array"`` (one
    task's labels). Unpacks as ``inputs, targets = batch``."""
    inputs: Any
    targets: Any
    kind: str = "dicts"

    def __iter__(self):
        yield self.inputs
        yield self.targets

    def valid_counts(self, tasks: List[str]) -> Dict[str, int]:
        """Per-task count of valid (label != -1) samples."""
        if self.kind == "array":
            y = np.asarray(self.targets)
            n = int((y != -1).sum()) if y.ndim else 1
            return {k: n for k in tasks}
        return {k: sum(1 for t in self.targets
                       if t.get(k, -1) is not None
                       and int(t.get(k, -1)) != -1) for k in tasks}


class ImageBatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 sampler=None, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def _order(self) -> List[int]:
        if self.sampler is not None:
            return list(self.sampler)
        if self.shuffle:
            return self._rng.permutation(len(self.dataset)).tolist()
        return list(range(len(self.dataset)))

    def skip_epochs(self, n: int) -> None:
        if self.shuffle or self.sampler is not None:
            for _ in range(n):
                self._order()

    def _load(self, idxs) -> Batch:
        images, targets = [], []
        for i in idxs:
            img, tgt = self.dataset[i]
            images.append(img)
            targets.append(tgt)
        return Batch(images, targets, kind="dicts")

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        bs = self.batch_size
        chunks = [order[s:s + bs] for s in range(0, len(order), bs)]
        if self.drop_last and chunks and len(chunks[-1]) < bs:
            chunks.pop()
        if self.prefetch > 0:
            from ...data.pipeline import prefetch_batches
            yield from prefetch_batches(chunks, self._load,
                                        depth=self.prefetch)
        else:
            for idxs in chunks:
                yield self._load(idxs)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else \
            len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)


class ArrayBatchLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        if len(x) != len(y):
            raise ValueError(f"{len(x)} features but {len(y)} labels")
        self.x = x
        self.y = y
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def _order(self) -> np.ndarray:
        return self._rng.permutation(len(self.x)) if self.shuffle \
            else np.arange(len(self.x))

    def skip_epochs(self, n: int) -> None:
        for _ in range(n if self.shuffle else 0):
            self._order()

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            yield Batch(self.x[idx], self.y[idx], kind="array")

    def __len__(self) -> int:
        return -(-len(self.x) // self.batch_size)
