"""The native (C++) image loader: threaded decode and resize of image
files, built with g++ at its first use (``build.py``) and bound with ctypes
by :mod:`vlm_tpu_torch.data.native_loader`."""
