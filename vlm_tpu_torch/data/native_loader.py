"""Decode and recipe-resize image files: the native C++ loader, or PIL.

``load_batch(paths, recipe)`` returns a uint8 [N, S, S, 3] batch, decoded
and resized by the C++ thread pool (``vlm_tpu_torch/native/imgloader.cpp``:
JPEG through libjpeg, PNG through libpng) when it builds, else by PIL
(:func:`~vlm_tpu_torch.ops.preprocess.host_resize`, the HF processors'
exact resize). Files the C++ side cannot read (other formats, or files
only PIL accepts) are retried through PIL one by one; a file neither can
read raises. The loader is built at the first call; a failed build prints
the compiler's error once and every later batch takes PIL.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ..ops.preprocess import PreprocessRecipe, host_resize

_lib = None
_lib_checked = False


def _load_lib():
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    from ..native.build import build_imgloader
    so = build_imgloader()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.vlm_load_batch.restype = ctypes.c_int
        lib.vlm_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except Exception as e:
        print(f"[native] imgloader load failed: {e}")
        _lib = None
    return _lib


def native_available() -> bool:
    """Whether the C++ loader built and loaded (builds it at the first
    call)."""
    return _load_lib() is not None


def load_batch(paths: Sequence, recipe: PreprocessRecipe, *,
               threads: int = 4,
               use_native: Optional[bool] = None) -> np.ndarray:
    """Decode + recipe-resize ``paths`` -> uint8 [N, S, S, 3];
    ``use_native=False`` takes PIL for every file."""
    from PIL import Image

    paths = [str(p) for p in paths]
    n = len(paths)
    s = recipe.image_size
    lib = _load_lib() if (use_native is None or use_native) else None
    if lib is not None and n > 0:
        out = np.zeros((n, s, s, 3), dtype=np.uint8)
        ok = np.zeros((n,), dtype=np.uint8)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        mode = 1 if recipe.mode == "shortest_edge_crop" else 0
        lib.vlm_load_batch(
            arr, n, s, mode, threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        for i in np.nonzero(~ok.astype(bool))[0]:
            out[i] = host_resize(Image.open(paths[i]), recipe)
        return out
    return np.stack(
        [host_resize(Image.open(p).convert("RGB"), recipe) for p in paths],
        axis=0)
