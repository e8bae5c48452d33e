"""The run's host environment: thread counts, cache directories inside the
checkout, the process's age, the settling of the process before its
window, the host's own readings over the window, and the guard against JAX
and the JAX package.

``prepare`` runs before numpy or torch is imported, so the thread
variables reach their libraries."""

from __future__ import annotations

import gc
import os
import time
import sys
from pathlib import Path

# one thread for every host library: the server and the trainer are paced
# by single-threaded Python, and the host's cores may be shared
HOST_THREADS = 1
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")
# top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare(root: Path) -> dict:
    """Pin the host thread counts and point every build and kernel cache at
    a fixed directory inside the checkout; returns what was set."""
    env = {k: str(HOST_THREADS) for k in THREAD_VARS}
    cache = root / "build" / "perfbench"
    env["TRITON_CACHE_DIR"] = str(cache / "triton")
    env["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    env["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    env["USE_FLAX"] = "0"
    env["USE_JAX"] = "0"
    os.environ.update(env)
    return env


def pin_torch(torch) -> dict:
    torch.set_num_threads(HOST_THREADS)
    try:
        torch.set_num_interop_threads(HOST_THREADS)
    except RuntimeError:          # already set in this process
        pass
    return {"cpu_count": os.cpu_count(),
            "torch_threads": torch.get_num_threads(),
            "torch_interop_threads": torch.get_num_interop_threads(),
            "blas_threads": HOST_THREADS}


def settle() -> dict:
    """At the end of set-up: collect, then freeze every object that set-up
    left alive (``gc.freeze``), so the window's collections do not walk the
    program's large, long-lived state; and keep the calling (driving)
    thread on one core, the last this process may use, so it is not moved
    between cores during the window.  Threads started earlier (the CUDA
    driver's) keep their cores.  Acts on this process alone."""
    gc.collect()
    gc.freeze()
    core = None
    if hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        core = cores[-1]
        os.sched_setaffinity(0, {core})
    return {"frozen_objects": gc.get_freeze_count(), "driving_core": core}


def _steal_ticks() -> int | None:
    """The host's summed steal time (ticks) from /proc/stat; None where
    there is none."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8])
    except (OSError, ValueError, IndexError):
        return None


class HostClock:
    """Wall seconds, the driving thread's CPU seconds and the host's steal
    seconds between ``start`` and ``stop``: where the window's wall time
    went on the host."""

    def start(self) -> None:
        self._w, self._c, self._s = (time.perf_counter(), time.thread_time(),
                                     _steal_ticks())

    def stop(self) -> dict:
        w, c, st = time.perf_counter(), time.thread_time(), _steal_ticks()
        out = {"wall_s": w - self._w, "thread_cpu_s": c - self._c}
        if st is not None and self._s is not None:
            out["host_steal_s"] = (st - self._s) / os.sysconf("SC_CLK_TCK")
        return out


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, so the
    interpreter's own start-up is counted); 0 where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared as a whole word: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
