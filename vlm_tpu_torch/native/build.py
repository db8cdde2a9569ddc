"""Build the native image loader (``imgloader.cpp``) with g++, libjpeg and
libpng.

The shared object goes to ``vlm_tpu_torch/_build/`` (git-ignored) under a
name that carries the hash of the source and the command, and is reused
while that hash holds. It is built at the first call of
:func:`build_imgloader`, never at import. A failed build prints the
compiler's error and returns None: the caller
(:mod:`vlm_tpu_torch.data.native_loader`) then decodes with PIL.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "imgloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")


def library_path() -> Path:
    """Where the build of this source and command lives."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libimgloader_{h.hexdigest()[:16]}.so"


def build_imgloader(force: bool = False) -> Optional[Path]:
    """Compile (if needed) and return the .so path, or None on failure."""
    lib = library_path()
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # written under a name of its own, then renamed: processes that build
    # at once never load a half-written file
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except Exception as e:
        print(f"[native] build failed to launch: {e}")
        return None
    if res.returncode != 0:
        print(f"[native] imgloader build failed:\n{res.stderr[:2000]}")
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib
