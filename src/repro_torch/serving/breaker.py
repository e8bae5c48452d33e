"""Copy of ``repro.serving.breaker``; only its imports differ.

Circuit breaker over the shared cross-request property tier.

The ``PropertyService``/``ChemCache`` tier is shared by every co-batched
request, so a sick predictor backend is a CORRELATED failure: without a
breaker, every request burns the retry budget on every step until the
whole fleet quarantines.  The breaker converts that into graceful
degradation:

``closed``     pass-through.  Terminal ``FaultError``s count; at
               ``failure_threshold`` consecutive failures the breaker
               trips (below it, the error propagates and the engine's
               per-molecule isolation handles the single row).
``open``       every call is served by the DEGRADED tier
               (``predictors.service.DegradedPropertyService``: primary's
               LRU cache, else the deterministic oracle stub) — no
               primary traffic at all.  Served molecules are remembered
               so the service can flag the owning requests ``degraded``.
               After ``cooldown_calls`` fallback serves, the next call
               becomes a half-open probe.
``half_open``  ONE probe call goes to the primary.  Success closes the
               breaker (counts reset); failure re-opens it and the probe
               batch is served degraded.

Everything is COUNT-based, never wall-clock-based: under a seeded
FaultPlan the trip/probe/recovery sequence is a pure function of the call
stream, which is what lets ``bench_serve --smoke`` pin shed/degraded
counts run-to-run.  Any non-fault exception propagates untouched — the
breaker absorbs the fault taxonomy, not bugs.
"""

from __future__ import annotations

import threading

from repro_torch.faults import FaultError

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Wraps a property service; every other attribute delegates to it."""

    def __init__(self, inner, fallback, *, failure_threshold: int = 3,
                 cooldown_calls: int = 8):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_calls < 1:
            raise ValueError("cooldown_calls must be >= 1")
        self.inner = inner
        self.fallback = fallback
        self.failure_threshold = int(failure_threshold)
        self.cooldown_calls = int(cooldown_calls)
        self.state = CLOSED
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._open_serves = 0           # fallback serves since the trip
        self._degraded_keys: set[str] = set()
        self.n_trips = 0
        self.n_fallback_serves = 0      # batches served by the degraded tier
        self.n_probes = 0
        self.n_probe_failures = 0
        self.n_recoveries = 0

    def __getattr__(self, name):
        # reserve(), cache, n_predict_calls, ... pass through untouched
        return getattr(self.inner, name)

    # ------------------------------------------------------------ #
    def _serve_fallback(self, mols):
        self.n_fallback_serves += 1
        self._open_serves += 1
        self._degraded_keys.update(m.canonical_key() for m in mols)
        return self.fallback.predict(mols)

    def _trip(self) -> None:
        self.state = OPEN
        self.n_trips += 1
        self._consecutive_failures = 0
        self._open_serves = 0

    def predict(self, mols):
        with self._lock:
            if self.state == OPEN:
                if self._open_serves < self.cooldown_calls:
                    return self._serve_fallback(mols)
                self.state = HALF_OPEN       # cooldown over: probe now

            if self.state == HALF_OPEN:
                self.n_probes += 1
                try:
                    out = self.inner.predict(mols)
                except FaultError:
                    self.n_probe_failures += 1
                    self._trip()
                    return self._serve_fallback(mols)
                self.state = CLOSED
                self.n_recoveries += 1
                self._consecutive_failures = 0
                return out

            try:                             # CLOSED
                out = self.inner.predict(mols)
            except FaultError:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._trip()
                    return self._serve_fallback(mols)
                raise                        # below threshold: let the
                #                            # engine isolate the one row
            self._consecutive_failures = 0
            return out

    # ------------------------------------------------------------ #
    def drain_degraded_keys(self) -> set[str]:
        """Canonical keys served by the degraded tier since the last
        drain — the service maps them back to requests after each step."""
        with self._lock:
            keys, self._degraded_keys = self._degraded_keys, set()
            return keys

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "n_trips": self.n_trips,
                "n_fallback_serves": self.n_fallback_serves,
                "n_probes": self.n_probes,
                "n_probe_failures": self.n_probe_failures,
                "n_recoveries": self.n_recoveries,
            }
