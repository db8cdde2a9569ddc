"""The safetensors format, read and written with numpy and torch alone (the
``safetensors`` package is not needed; ``vlm_tpu`` imports it in
``models/hf_weights.py: _load_safetensors``).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end
within the data that follows; an optional ``__metadata__`` maps strings to
strings, which the reader skips), then the raw little-endian bytes.

:func:`open_dir` and :func:`open_file` read headers only and hand out one
:class:`TensorRef` a tensor: its :meth:`TensorRef.load` maps just that
tensor's bytes (``numpy.memmap`` in copy-on-write mode, so torch gets a
writable buffer and the file is never written), so a checkpoint never sits
whole in host memory. BF16 is mapped as ``uint16`` and reinterpreted.
:func:`save_file` writes one file, a tensor at a time (tensors on the card
pass through host memory one by one).
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

#: format name -> (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_NAMES = {tdt: name for name, (_, tdt) in DTYPES.items()}


class TensorRef(NamedTuple):
    """One tensor of a file: where its bytes lie, and how to read them."""
    path: Path
    dtype: str
    shape: Tuple[int, ...]
    offset: int             # of the first byte, from the start of the file

    def load(self) -> torch.Tensor:
        """The tensor on the CPU, backed by a copy-on-write map of the
        file (pages are read when the tensor is first touched)."""
        np_dtype, torch_dtype = DTYPES[self.dtype]
        count = math.prod(self.shape)
        if count == 0:
            return torch.empty(self.shape, dtype=torch_dtype)
        arr = np.memmap(self.path, dtype=np_dtype, mode="c",
                        offset=self.offset, shape=(count,))
        t = torch.from_numpy(arr).reshape(self.shape)
        return t.view(torch.bfloat16) if self.dtype == "BF16" else t


def _header(path: Path) -> Tuple[dict, int]:
    """The parsed header and the offset of the data; raises ``ValueError``
    naming the file on a truncated file, a bad header, an unknown dtype,
    a size that disagrees with the shape, or overlapping tensors."""
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file "
                             f"({size} bytes, no header length)")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: truncated safetensors file (header "
                             f"of {n} bytes in a file of {size})")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable safetensors header "
                             f"({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not an object")
    data = 8 + n
    spans = []
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        entry = entry if isinstance(entry, dict) else {}
        dtype, shape = entry.get("dtype"), entry.get("shape")
        offsets = entry.get("data_offsets")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}; "
                             f"the reader knows {sorted(DTYPES)}")
        if not (_ints(shape) and _ints(offsets) and len(offsets) == 2):
            raise ValueError(f"{path}: tensor {name!r} has a malformed "
                             f"shape {shape!r} or data_offsets {offsets!r}")
        begin, end = offsets
        want = math.prod(shape) * DTYPES[dtype][0].itemsize
        if begin > end or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}) but {dtype} {shape} needs "
                             f"{want}")
        if data + end > size:
            raise ValueError(f"{path}: truncated safetensors file (tensor "
                             f"{name!r} ends at byte {data + end} of "
                             f"{size})")
        spans.append((begin, end, name))
    last_end, last = 0, None
    for begin, end, name in sorted(spans):
        if end == begin:
            continue
        if begin < last_end:
            raise ValueError(f"{path}: tensors {last!r} and {name!r} overlap")
        last_end, last = end, name
    return header, data


def _ints(xs) -> bool:
    """A list of non-negative ints."""
    return isinstance(xs, list) and all(
        type(x) is int and x >= 0 for x in xs)


def open_file(path) -> Dict[str, TensorRef]:
    """Name -> :class:`TensorRef` for every tensor of one file."""
    path = Path(path)
    header, data = _header(path)
    return {name: TensorRef(path, e["dtype"], tuple(e["shape"]),
                            data + e["data_offsets"][0])
            for name, e in header.items() if name != "__metadata__"}


def open_dir(path) -> Dict[str, TensorRef]:
    """Every ``*.safetensors`` file of a directory, in sorted order, as
    ``vlm_tpu`` reads them (a ``model.safetensors.index.json`` is not
    needed). Raises ``FileNotFoundError`` without any, and ``ValueError``
    for a name found in two files."""
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    refs: Dict[str, TensorRef] = {}
    for f in files:
        for name, ref in open_file(f).items():
            if name in refs:
                raise ValueError(f"tensor {name!r} is in both "
                                 f"{refs[name].path.name} and {f.name}")
            refs[name] = ref
    return refs


def save_file(tensors: Mapping[str, torch.Tensor], path) -> None:
    """Write ``tensors`` (on any device) as one safetensors file, widest
    dtypes first and by name, so that every tensor starts at a multiple of
    its item size (the header is padded to 8 bytes)."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, dict] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name here ({sorted(DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            if t.numel():
                f.write(memoryview(t.numpy().reshape(-1)))
