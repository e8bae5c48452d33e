"""Copy of ``repro.predictors.service`` (the parts serving needs); only
its imports differ.

The property tier behind the molecule-optimization server:

* ``Properties`` and ``OracleService``, the deterministic property stub
  backed by the chemistry oracles (no predictor training);
* ``DegradedPropertyService``, the last-known-good tier a tripped circuit
  breaker serves from;
* ``RetryPolicy`` and ``ResilientService``, bounded retries with seeded
  backoff and an optional per-call timeout around any property service.

The learned ``PropertyService`` (Alfabet-S / AIMNet-S predictors, padding
ladder, LRU cache) arrives with the predictor slice of the port.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from repro_torch.faults import FaultError, FaultTimeout, TransientFault

from repro_torch.chem.conformer import has_valid_conformer
from repro_torch.chem.molecule import Molecule


@dataclass
class Properties:
    bde: float | None
    ip: float | None

    @property
    def conformer_valid(self) -> bool:
        return self.ip is not None


class OracleService:
    """Deterministic, jit-free ``PropertyService`` stand-in backed by the
    chemistry oracles — identical answers in every process, no predictor
    training, no XLA compiles.

    THE shared stub for every harness that wants properties out of the
    equation: the tier-1 test matrices (tests/conftest.py re-exports it),
    the chemistry benchmarks, and the multi-device truth run
    (``repro.launch.verify``) — whose cross-process bit-equality pins
    silently depend on all of them predicting identically, which is why
    there is exactly one implementation.  ``predict`` entries are counted
    in ``n_calls`` so dispatch-per-step tests can assert batching.
    """

    def __init__(self):
        from repro_torch.chem.oracle import oracle_bde, oracle_ip
        self._bde, self._ip, self._ok = oracle_bde, oracle_ip, has_valid_conformer
        self.n_calls = 0

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        self.n_calls += 1
        return [Properties(bde=self._bde(m),
                           ip=self._ip(m) if self._ok(m) else None)
                for m in mols]


class DegradedPropertyService:
    """The last-known-good property tier a TRIPPED circuit breaker serves
    from (serving/breaker.py): per molecule, the primary service's LRU
    cache when it holds the answer, the deterministic oracle stub
    otherwise.  Never raises, never touches the (presumed sick) primary
    predictors — responses routed through here are flagged ``degraded``
    by the serving layer.

    ``primary`` may be a ``PropertyService`` (its ``cache`` is consulted),
    a ``ResilientService`` around one (attribute delegation exposes the
    cache), or any stub without a cache (pure oracle fallback).
    """

    def __init__(self, primary=None, stub=None):
        self.primary_cache = getattr(primary, "cache", None)
        self.stub = stub if stub is not None else OracleService()
        self.n_cache_serves = 0
        self.n_stub_serves = 0

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        out: list[Properties] = []
        for m in mols:
            hit = (self.primary_cache.get(m.iso_key())
                   if self.primary_cache is not None else None)
            if hit is not None:
                self.n_cache_serves += 1
                out.append(hit)
            else:
                self.n_stub_serves += 1
                out.append(self.stub.predict([m])[0])
        return out

    def stats(self) -> dict:
        return {"n_cache_serves": self.n_cache_serves,
                "n_stub_serves": self.n_stub_serves}


# ------------------------------------------------------------------ #
# fault tolerance: bounded retries + deterministic backoff + timeout
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for one property-service call.

    ``max_retries``     retries after the first attempt (so a call makes at
                        most ``max_retries + 1`` attempts).
    ``backoff_base_s``  attempt k sleeps ``min(cap, base * 2**k)`` scaled
                        by a seeded jitter in [0.5, 1.0) — deterministic
                        given the policy seed, capped, exponential.
    ``timeout_s``       per-call wall clock bound (None = no timeout).  A
                        call that overruns raises ``FaultTimeout`` and is
                        retried like any transient fault.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    timeout_s: float | None = None
    seed: int = 0


class ResilientService:
    """Bounded-retry wrapper around any property service.

    Composition over inheritance: ``inner`` is a ``PropertyService``, an
    ``OracleService``, or any object with ``predict(mols)``; every other
    attribute (``reserve``, cache counters, ...) passes through untouched.

    Retry semantics — the properties tests/test_faults.py gates:

    * only ``TransientFault`` (incl. ``FaultTimeout``) is retried; real
      exceptions propagate (they are bugs, not weather), and ``FaultError``
      stays terminal.
    * the retried batch is BIT-identical to a first-try batch, because the
      injection point sits BEFORE the inner call and the inner predictor is
      deterministic — retries are invisible to the equivalence matrix.
    * backoff is deterministic (seeded jitter, exponential, capped) and
      injectable (``sleep=``) so tests and the fault benches never
      actually wait.
    * after ``max_retries`` retries the transient escalates to a terminal
      ``FaultError`` — the fleet quarantines the affected slots instead of
      crashing (core/rollout.py).

    ``fault_plan`` arms the deterministic injection surface
    (``repro.core.faults.FaultPlan``, site ``"predict"``).

    Timeout caveat: the timed-out inner call keeps running on the worker
    thread (python threads cannot be killed); with a deterministic,
    internally-locked inner service the overlap is harmless, which is the
    only configuration the harness uses timeouts with.
    """

    def __init__(self, inner, policy: RetryPolicy = RetryPolicy(),
                 fault_plan=None,
                 sleep: Callable[[float], None] | None = time.sleep):
        self.inner = inner
        self.policy = policy
        self.fault_plan = fault_plan
        self._sleep = sleep if sleep is not None else (lambda s: None)
        self._backoff_rng = np.random.default_rng(policy.seed)
        self._timeout_pool: ThreadPoolExecutor | None = None
        self.n_retries = 0          # transient attempts absorbed
        self.n_timeouts = 0         # real (wall-clock) timeouts observed

    def __getattr__(self, name):
        # delegation target for everything predict() doesn't override
        # (reserve, n_predict_calls, cache, ...)
        return getattr(self.inner, name)

    def _backoff_s(self, attempt: int) -> float:
        base = min(self.policy.backoff_cap_s,
                   self.policy.backoff_base_s * (2.0 ** attempt))
        return base * (0.5 + 0.5 * float(self._backoff_rng.random()))

    def _call_inner(self, mols):
        if self.policy.timeout_s is None:
            return self.inner.predict(mols)
        if self._timeout_pool is None:
            self._timeout_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="predict-timeout")
        fut = self._timeout_pool.submit(self.inner.predict, mols)
        try:
            return fut.result(timeout=self.policy.timeout_s)
        except FuturesTimeout:
            self.n_timeouts += 1
            raise FaultTimeout(
                f"predict timed out after {self.policy.timeout_s}s "
                f"({len(mols)} molecules)") from None

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        attempt = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check_call("predict")
                return self._call_inner(mols)
            except FaultError:
                raise                     # terminal — the fleet quarantines
            except TransientFault as e:
                if attempt >= self.policy.max_retries:
                    raise FaultError(
                        f"predict retries exhausted after {attempt + 1} "
                        f"attempts: {e!r}") from e
                self._sleep(self._backoff_s(attempt))
                attempt += 1
                self.n_retries += 1

    def fault_stats(self) -> dict:
        return {
            "n_retries": self.n_retries,
            "n_timeouts": self.n_timeouts,
            "n_faults_injected": (self.fault_plan.n_injected
                                  if self.fault_plan is not None else 0),
        }
