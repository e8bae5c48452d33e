"""Build a kernel source with ``nvcc`` into a shared library, once.

Every kernel of the port is CUDA C++ with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds.  Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  ``start`` spawns the compiler without waiting, so a
caller can build every kernel at once and ``wait`` on each.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.is_file() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class NvccBuild:
    """One source -> ``build/repro_torch/lib<stem>-<hash>.so``."""

    def __init__(self, source: Path):
        self.source = Path(source)
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
        self.library = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        self.log = self.library.with_suffix(".log")
        self._proc: subprocess.Popen | None = None
        self._tmp = self.library.with_suffix(f".{os.getpid()}.tmp.so")

    def start(self) -> None:
        """Spawn ``nvcc`` unless the library is built or being built."""
        if self._proc is not None or self.library.is_file():
            return
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> Path:
        """The built library's path; raises with the compiler's output."""
        self.start()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            rc, self._proc = self._proc.returncode, None
            self.log.write_text(out)
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {self.source}:\n{out}")
            os.replace(self._tmp, self.library)
        return self.library
