"""Build and load ``csrc/ssd_scan.cu`` (nvcc -> ctypes)."""

from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.core.jit_stats import note_shape_event
from repro_torch.kernels.nvcc import NvccBuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

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
        fn = lib.ssd_scan_forward
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
        note_shape_event("kernel:ssd_scan")
    return _lib
