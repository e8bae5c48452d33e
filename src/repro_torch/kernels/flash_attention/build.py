"""Build and load ``csrc/flash_attention.cu`` (nvcc -> ctypes)."""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.core.jit_stats import note_shape_event
from repro_torch.kernels.nvcc import NvccBuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_build: NvccBuild | None = None
_lib: ctypes.CDLL | None = None


def nvcc_build() -> NvccBuild:
    global _build
    if _build is None:
        _build = NvccBuild(SOURCE)
    return _build


def load() -> ctypes.CDLL:
    """The kernel library, built at first use; pointers and the stream are
    ``c_void_p`` (64-bit), strides ``c_longlong``, sizes ``c_int``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(nvcc_build().wait()))
        fn = lib.flash_attention_forward
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_float] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
        note_shape_event("kernel:flash_attention")
    return _lib
