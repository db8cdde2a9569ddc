"""vlm_tpu_torch: the PyTorch and CUDA port of ``vlm_tpu`` for NVIDIA Hopper.

The package mirrors ``vlm_tpu``'s layout (``models/``, ``ops/``,
``generate/``, ``data/``, ``probing/``, ``testing/``). Plain tensor code
is PyTorch; the operations ``vlm_tpu`` wrote as Pallas TPU kernels are
hand-written CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use
and bound with ``ctypes`` (``ops/_lib.py``). CPU tensors take each kernel's
plain PyTorch version, which the tests hold against ``vlm_tpu``.

Importing the package imports neither JAX nor any kernel toolchain.
"""

__version__ = "0.1.0"
