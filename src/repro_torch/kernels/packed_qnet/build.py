"""Build and load ``csrc/packed_qnet.cu`` (nvcc -> ctypes)."""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.core.jit_stats import note_shape_event
from repro_torch.kernels.nvcc import NvccBuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "packed_qnet.cu"

_build: NvccBuild | None = None
_lib: ctypes.CDLL | None = None


def nvcc_build() -> NvccBuild:
    global _build
    if _build is None:
        _build = NvccBuild(SOURCE)
    return _build


def load() -> ctypes.CDLL:
    """The kernel library, built at first use; pointers and the stream are
    ``c_void_p`` (64-bit), sizes ``c_int``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(nvcc_build().wait()))
        packed = lib.packed_qnet_stacked_forward
        packed.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        packed.restype = ctypes.c_int
        dense = lib.dense_qnet_stacked_forward
        dense.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        dense.restype = ctypes.c_int
        lib.packed_qnet_error_string.argtypes = [ctypes.c_int]
        lib.packed_qnet_error_string.restype = ctypes.c_char_p
        _lib = lib
        note_shape_event("kernel:packed_qnet")
    return _lib
