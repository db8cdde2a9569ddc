"""Build and bind the port's CUDA kernels.

Each of ``vlm_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc`` for
``sm_90a``, all started together, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
the first kernel launch (or an explicit :func:`build`), goes to
``vlm_tpu_torch/_build/`` (git-ignored) under a name that carries the hash
of the sources and flags, and is reused while that hash holds.
Importing this module builds nothing and imports no toolchain.

Each kernel wrapper counts its launches in :data:`launches` (inside
:func:`counting_into`, on that thread, in the block's own counts); each plain
PyTorch version counts its calls in :data:`plain_calls` under the form its
inputs select (fp32 operands: the ``_fp32`` form), so a run can show which
path it took. The backward of B1's differentiable form is a kernel for fp32
CUDA tensors (counted under ``flash_attention_diff_fp32_bwd``); elsewhere
(CPU tensors, and bf16 on the card) it recomputes the attention with plain
tensor operations and counts that in :data:`recomputes`, apart from the
plain versions' calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -Xptxas -v: registers, shared memory and spills per kernel, kept in
# last_build["log"]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# one count per kernel form: B1, B2 and B4 each have an fp32 form, B2 and
# B3 an int8 form; B3's write inside B2's launch (the decode step's) counts
# under B3's fused forms, once per launch, beside B2's own count; B1's
# launch as the forward of its differentiable form (a gradient is needed)
# counts under the ``_diff`` forms too, and the fp32 form's backward kernel
# under ``flash_attention_diff_fp32_bwd``, once a backward; B7 counts its
# decode form (up to 64 rows) under ``int4_matmul`` and its prefill form
# under ``int4_matmul_prefill``
KERNELS = ("flash_attention", "flash_attention_fp32", "flash_attention_diff",
           "flash_attention_diff_fp32", "flash_attention_diff_fp32_bwd",
           "decode_attention",
           "decode_attention_int8", "decode_attention_fp32", "kv_write",
           "kv_write_int8", "kv_write_fused", "kv_write_int8_fused",
           "normalize", "normalize_fp32", "int8_matmul", "int8xint8_matmul",
           "int4_matmul", "int4_matmul_prefill")
launches = {name: 0 for name in KERNELS}
# a fused or differentiable form has no plain version of its own: on the
# CPU its work is the plain versions of the kernels it runs (B3's write and
# B2's attention; B1's), each counted under its own form; the backward's
# plain version is the recompute; B7's prefill form (more than 64 rows)
# has B7's plain version, counted under ``int4_matmul``
plain_calls = {name: 0 for name in KERNELS
               if not name.endswith(("_fused", "_diff", "_diff_fp32",
                                     "_bwd", "_prefill"))}
# the backward of B1's differentiable form where it takes no kernel (CPU
# tensors; bf16 on the card): recomputes through plain tensor operations,
# one count per backward
recomputes = {"flash_attention_diff": 0, "flash_attention_diff_fp32": 0}
# where this thread's launches are counted inside counting_into
_sink = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "vlm_flash_attention": [_P] * 6 + [_I] * 10 + [_L] * 12 + [_F, _I, _P],
    "vlm_flash_attention_fp32": [_P] * 7 + [_I] * 12 + [_L] * 12 + [_F, _I,
                                                                     _P],
    "vlm_flash_attention_fp32_bwd": [_P] * 11 + [_L] + [_I] * 6 + [_L] * 24
    + [_F, _I, _P],
    "vlm_decode_attention": [_P] * 16 + [_I] * 11 + [_L] * 6 + [_F, _P],
    "vlm_decode_few_blocks": [_I] * 5 + [ctypes.POINTER(_I)],
    "vlm_decode_attention_fp32": [_P] * 14 + [_I] * 9 + [_L] * 6 + [_F, _P],
    "vlm_kv_write": [_P] * 5 + [_I] * 3 + [_L] * 3 + [_P],
    "vlm_kv_write_int8": [_P] * 7 + [_I] * 6 + [_P],
    "vlm_normalize": [_P, _P] + [_I] * 5 + [_P, _P, _I, _P],
    "vlm_int8_matmul": [_P] * 4 + [_I] * 8 + [_P],
    "vlm_int8xint8_matmul": [_P] * 5 + [_I] * 8 + [_P],
    "vlm_int4_matmul": [_P] * 4 + [_I] * 9 + [_P],
    "vlm_int4_matmul_prefill": [_P] * 4 + [_I] * 8 + [_P],
    "vlm_int4_matmul_narrow": [_P] * 4 + [_I] * 6 + [_P],
    "vlm_stream_clusters": [_I, ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sm_counts: dict = {}
_max_clusters: dict = {}
_few_blocks: dict = {}
_tile_counters: dict = {}
#: what the last build did: {"path", "seconds", "cached", "log"}
last_build: dict = {}


def reset_counts() -> None:
    for counts in (launches, plain_calls, recomputes):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels unless a library for the current sources and
    flags exists; returns its path. The compiler's output lands in
    ``last_build["log"]``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libvlm_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        last_build.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [(p.args[-3], log) for p, log in zip(procs, logs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(("link", link.stdout + link.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src}:\n{log}" for src, log in failed))
    os.replace(tmp, out)
    last_build.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log="".join(logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.vlm_error_string.argtypes = [ctypes.c_int]
            handle.vlm_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


@contextlib.contextmanager
def counting_into(counts: dict):
    """Count the launches this thread makes inside the block in ``counts``
    (a name -> count dict, as :data:`launches`) instead of
    :data:`launches`: a CUDA graph's capture, which runs nothing on the
    card; each replay then adds them. Other threads count as before."""
    _sink.counts = counts
    try:
        yield counts
    finally:
        _sink.counts = None


def launch(kernel: str, fn_name: str, *args, also: str = "") -> None:
    """Call one C entry point and raise if CUDA refused the launch; counts
    the launch under ``kernel``, and under ``also`` too where the launch
    also runs another kernel's work (B3's write inside B2) or serves another
    form (B1 as its differentiable form's forward)."""
    handle = lib()
    rc = getattr(handle, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({handle.vlm_error_string(rc).decode()})")
    counts = getattr(_sink, "counts", None)
    if counts is None:
        counts = launches
    counts[kernel] += 1
    if also:
        counts[also] += 1


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]


def max_clusters(device: torch.device) -> Tuple[int, ...]:
    """``[s]``: how many thread block clusters of s blocks (1-8) of B5's
    and B7's mainloop a CUDA device runs at once (index 0 unused;
    cached)."""
    if device.index not in _max_clusters:
        handle = lib()
        count = ctypes.c_int()
        got = [0]
        with torch.cuda.device(device):
            for s in range(1, 9):
                rc = handle.vlm_stream_clusters(s, ctypes.byref(count))
                if rc != 0:
                    raise RuntimeError(
                        f"vlm_stream_clusters: CUDA error {rc} "
                        f"({handle.vlm_error_string(rc).decode()})")
                got.append(count.value)
        _max_clusters[device.index] = tuple(got)
    return _max_clusters[device.index]


def few_blocks(device: torch.device, int8: bool, d: int, stages: int,
               fused: bool, heads: int = 1) -> int:
    """Blocks of B2's form for G < 8 with ``heads`` KV heads a block that an
    SM of a CUDA device holds with a ring of ``stages`` tiles (its
    registers and shared memory; cached)."""
    key = (device.index, int8, d, stages, fused, heads)
    if key not in _few_blocks:
        handle = lib()
        count = ctypes.c_int()
        with torch.cuda.device(device):
            rc = handle.vlm_decode_few_blocks(int(int8), d, stages,
                                              int(fused), heads,
                                              ctypes.byref(count))
        if rc != 0:
            raise RuntimeError(f"vlm_decode_few_blocks: CUDA error {rc} "
                               f"({handle.vlm_error_string(rc).decode()})")
        _few_blocks[key] = count.value
    return _few_blocks[key]


def tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters, one per (slot, KV head, head group),
    for B2's split-S launches on ``device``; every launch leaves them
    zeroed again."""
    buf = _tile_counters.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tile_counters[device.index] = buf
    return buf


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the current CUDA device, else raise."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.type != "cuda" or t.device.index != dev:
            raise ValueError(f"{name}: expected tensors on cuda:{dev}, got "
                             f"{t.device}")


def check_bf16(name: str, *tensors: torch.Tensor) -> None:
    check_dtype(name, torch.bfloat16, *tensors)


def check_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                            f"{t.dtype}")


def check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Contiguous, with a 16-byte aligned base (the kernels' vector loads)."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs contiguous, 16-byte aligned "
                             f"tensors, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")


def is_cpu(t: torch.Tensor, name: str) -> bool:
    """Dispatch rule of every wrapper: CPU tensors take the plain version,
    CUDA tensors the kernel, anything else raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
