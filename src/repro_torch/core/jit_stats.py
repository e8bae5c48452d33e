"""Port of ``repro.core.jit_stats``: shape-event accounting for the hot paths.

The reference's perf claims rest on *shape discipline*: after warmup, no
environment step may trigger an XLA compile, and it counts compiles through
``jax.monitoring``.  Eager PyTorch compiles nothing.  What can still change
under a running port after warmup is a **shape event**:

* a capacity-ladder buffer growing to a new rung: the fleet view's
  candidate buffers (``core.distributed._FleetView.reserve``), the serve
  dispatch buffer (``serving.service._ServePolicy.reserve``), and a batch
  landing on a rung of the property service's bucket ladder for the first
  time, which allocates that rung's staging buffer
  (``predictors.service.PropertyService``);
* a kernel library built or loaded at first use (``kernels/*/build.load``).

Each of those sites calls ``note_shape_event(site)``, a counter bump that
changes no result.  Warmup may have shape events; a measured window must
have none.  That is the port's form of the bounded-shapes contract and the
counterpart of the reference's 0-recompiles-after-warmup gate, under the
reference's names so the truth run (``launch/verify.py``) reads like its
reference.

``RecompileCounter``  the process-global, monotone count of shape events
                      (``.count``), and ``.by_site``, the count per site:
                      which buffer grew or which kernel loaded when the
                      count moves (the role of the reference's
                      ``jit_cache_size``).
"""

from __future__ import annotations

import threading
from collections import Counter


def note_shape_event(site: str) -> None:
    """Count one shape event at ``site`` (see the module docstring)."""
    RecompileCounter.install()._note(site)


class RecompileCounter:
    """Process-global shape-event counter.

    Usage::

        counter = RecompileCounter.install()
        ...warmup...
        mark = counter.count
        ...measured work...
        events = counter.count - mark   # 0 == no buffer grew, no kernel loaded
    """

    _instance: "RecompileCounter | None" = None
    _install_lock = threading.Lock()

    def __init__(self) -> None:
        self.count = 0
        self.by_site: Counter = Counter()
        self._lock = threading.Lock()

    @classmethod
    def install(cls) -> "RecompileCounter":
        with cls._install_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _note(self, site: str) -> None:
        # the pipelined rollout's threads may reach a site too
        with self._lock:
            self.count += 1
            self.by_site[site] += 1

    def delta_since(self, mark: int) -> int:
        return self.count - mark

    def window(self) -> "CompileWindow":
        """Context manager over a measured region::

            with counter.window() as w:
                ...measured work...
            assert w.count == 0      # no shape event inside the block

        ``w.count`` is live inside the block and frozen at exit.
        """
        return CompileWindow(self)


class CompileWindow:
    """Shape-event count within a ``with`` region (see
    ``RecompileCounter.window``)."""

    def __init__(self, counter: RecompileCounter) -> None:
        self._counter = counter
        self._mark = counter.count
        self._final: int | None = None

    @property
    def count(self) -> int:
        if self._final is not None:
            return self._final
        return self._counter.count - self._mark

    def __enter__(self) -> "CompileWindow":
        self._mark = self._counter.count
        self._final = None
        return self

    def __exit__(self, *exc) -> bool:
        self._final = self._counter.count - self._mark
        return False
