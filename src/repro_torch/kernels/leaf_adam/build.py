"""Build and load ``csrc/leaf_adam.cu`` (nvcc -> ctypes)."""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.core.jit_stats import note_shape_event
from repro_torch.kernels.nvcc import NvccBuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "leaf_adam.cu"

_build: NvccBuild | None = None
_lib: ctypes.CDLL | None = None


def nvcc_build() -> NvccBuild:
    global _build
    if _build is None:
        _build = NvccBuild(SOURCE)
    return _build


def load() -> ctypes.CDLL:
    """The kernel library, built at first use; pointers and the stream are
    ``c_void_p`` (64-bit), counts and flags ``c_int``, the Adam constants
    ``c_float``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(nvcc_build().wait()))
        fn = lib.leaf_adam_step
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_int] \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("leaf_adam_max_leaves", "leaf_adam_blocks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.leaf_adam_error_string.argtypes = [ctypes.c_int]
        lib.leaf_adam_error_string.restype = ctypes.c_char_p
        _lib = lib
        note_shape_event("kernel:leaf_adam")
    return _lib
