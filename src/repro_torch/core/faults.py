"""Copy of ``repro.core.faults``; only its imports differ.

Deterministic fault injection for the training stack.

One injection surface — a seeded :class:`FaultPlan` — shared by tests,
benches, and the ``launch/verify.py`` fault scenarios, instead of ad-hoc
monkeypatching per harness.  The hook sites:

``predict``      ``ResilientService`` consults the plan before each
                 underlying ``PropertyService.predict`` call (serial —
                 counter-scheduled via :meth:`FaultPlan.check_call`).
``chem``         ``RolloutEngine`` consults the plan per *molecule* before
                 enumeration (threaded under ``fleet_pipelined`` —
                 content-keyed via :meth:`FaultPlan.check_key` so the
                 schedule is a pure function of the molecule, independent
                 of thread interleaving).
``checkpoint``   ``CheckpointManager.save`` consults the plan before each
                 write (serial, counter-scheduled).
``request``      serve site — ``serving.MoleculeOptService`` consults the
                 plan per *request* at bind time (content-keyed on the
                 request id, so the faulted request set is independent of
                 admission order).  Transient → the bind is retried next
                 service step; crash → the request fails with an Incident,
                 its co-batched neighbours untouched.

Fault taxonomy (what the hooks raise):

:class:`TransientFault`   retryable — the retry layer absorbs it; a
                          retried call is bit-identical to a first-try
                          call because every wrapped dependency is
                          deterministic.
:class:`FaultTimeout`     retryable — a ``TransientFault`` flavoured as a
                          per-call timeout (also raised by the real
                          timeout path in ``ResilientService``).
:class:`FaultError`       terminal — retries exhausted or an injected
                          slot crash; the fleet quarantines the affected
                          slot (structured :class:`Incident` record, slot
                          drains to dead, revived from the dataset cursor
                          at the next episode boundary).

Determinism contract: with the same plan (rules + seed) and the same
work content, the set of injected faults is identical run-to-run — for
serial sites because the call order is the program order, for threaded
sites because injection keys on *content* with fail-first-N-attempts
semantics rather than on arrival order.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field

# the exception taxonomy lives dependency-free at the package root (see
# repro.faults for why); this module is the RL core's import site for it
from repro_torch.faults import FaultError, FaultTimeout, TransientFault

__all__ = [
    "FaultError", "FaultTimeout", "TransientFault",
    "FaultPlan", "FaultRule", "Incident",
]


_KINDS = {
    "transient": TransientFault,
    "timeout": FaultTimeout,
    "crash": FaultError,
}


@dataclass(frozen=True)
class Incident:
    """Structured record of one handled fault (the operator-facing trail).

    ``action`` is what the stack did about it: ``"retried"`` (absorbed by
    the retry layer), ``"quarantined"`` (slot drained to dead, revived
    next episode), ``"checkpoint_skipped"`` (write abandoned, previous
    rotation entry remains authoritative), ``"restarted"`` (supervised
    pipelined shard re-run inline).
    """

    episode: int
    step: int
    site: str          # "predict" | "chem" | "checkpoint" | "pipeline"
                       # | "reward" (a custom/callable objective raised;
                       #   slot quarantined, fleet survives)
                       # | serve sites: "request" | "parse"
    worker: int        # -1 when not slot-attributable
    slot: int          # -1 when not slot-attributable
    key: str           # molecule canonical key / path / "" when n/a
    error: str         # repr of the triggering exception
    action: str

    def as_dict(self) -> dict:
        return {
            "episode": self.episode, "step": self.step, "site": self.site,
            "worker": self.worker, "slot": self.slot, "key": self.key,
            "error": self.error, "action": self.action,
        }


@dataclass(frozen=True)
class FaultRule:
    """One injection rule.

    ``site``           hook site this rule arms ("predict" / "chem" /
                       "checkpoint" / "pipeline" / "request").
    ``kind``           "transient" | "timeout" | "crash" (what is raised).
    ``every``          serial sites: fault every Nth logical call
                       (1-based: ``every=3`` faults calls 3, 6, 9, ...).
    ``rate``           keyed sites: fault fraction of keys (pure function
                       of (seed, site, key) — thread-order independent).
    ``fail_attempts``  consecutive failures per scheduled call/key before
                       it succeeds; set it above the retry budget to make
                       the fault terminal.
    ``max_injections`` stop injecting after this many faults (None =
                       unlimited).
    """

    site: str
    kind: str = "transient"
    every: int | None = None
    rate: float | None = None
    fail_attempts: int = 1
    max_injections: int | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if (self.every is None) == (self.rate is None):
            raise ValueError("exactly one of every/rate must be set")
        if self.every is not None and self.every < 1:
            raise ValueError("every must be >= 1")


@dataclass
class _SiteState:
    n_logical: int = 0          # completed logical calls (serial sites)
    burst: int = 0              # failures so far for the in-flight call
    n_injected: int = 0
    key_attempts: dict = field(default_factory=dict)   # keyed sites


class FaultPlan:
    """Seeded, reproducible fault schedule over the three hook sites.

    Thread-safe: ``check_key`` is called from the pipelined enumeration
    threads; all mutable state sits behind one lock.
    """

    def __init__(self, rules: tuple[FaultRule, ...] | list[FaultRule],
                 seed: int = 0):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._sites: dict[str, _SiteState] = {}
        by_site: dict[str, FaultRule] = {}
        for r in self.rules:
            if r.site in by_site:
                raise ValueError(f"duplicate rule for site {r.site!r}")
            by_site[r.site] = r
        self._by_site = by_site

    def _state(self, site: str) -> _SiteState:
        return self._sites.setdefault(site, _SiteState())

    def _raise(self, rule: FaultRule, st: _SiteState, detail: str):
        st.n_injected += 1
        exc = _KINDS[rule.kind]
        raise exc(f"injected {rule.kind} fault at {rule.site} ({detail})")

    # -- serial sites (predict / checkpoint) --------------------------------

    def check_call(self, site: str) -> None:
        """Consult the schedule for the next *serial* call at ``site``;
        raises the rule's exception when that call is scheduled to fail.

        Semantics: a scheduled logical call fails ``fail_attempts`` times
        in a row (each retry re-enters here), then succeeds — so the same
        retry budget sees the same failure burst on every run.
        """
        rule = self._by_site.get(site)
        if rule is None or rule.every is None:
            return
        with self._lock:
            st = self._state(site)
            if st.burst > 0:                       # mid-burst: retry arrives
                if st.burst < rule.fail_attempts:
                    st.burst += 1
                    self._raise(rule, st, f"call {st.n_logical + 1}, "
                                          f"attempt {st.burst}")
                st.burst = 0                       # burst over: succeed
                st.n_logical += 1
                return
            n = st.n_logical + 1                   # 1-based logical index
            due = (n % rule.every == 0) and (
                rule.max_injections is None or st.n_injected < rule.max_injections)
            if due:
                st.burst = 1
                self._raise(rule, st, f"call {n}, attempt 1")
            st.n_logical += 1

    # -- content-keyed sites (chem, threaded) -------------------------------

    def _key_hash01(self, site: str, key: str) -> float:
        h = hashlib.sha256(
            f"{self.seed}|{site}|{key}".encode()).digest()
        return int.from_bytes(h[:8], "little") / 2.0 ** 64

    def check_key(self, site: str, key: str) -> None:
        """Consult the schedule for content ``key`` at ``site``.  A pure
        function of (seed, site, key) decides WHETHER the key faults; a
        per-key attempt counter makes the first ``fail_attempts`` attempts
        fail and later attempts succeed — deterministic regardless of
        which thread gets there first."""
        rule = self._by_site.get(site)
        if rule is None or rule.rate is None:
            return
        if self._key_hash01(site, key) >= rule.rate:
            return
        with self._lock:
            st = self._state(site)
            if (rule.max_injections is not None
                    and st.n_injected >= rule.max_injections
                    and key not in st.key_attempts):
                return
            seen = st.key_attempts.get(key, 0)
            if seen < rule.fail_attempts:
                st.key_attempts[key] = seen + 1
                self._raise(rule, st, f"key {key[:40]!r}, attempt {seen + 1}")

    def has_rule(self, site: str) -> bool:
        """Whether any rule arms ``site`` — lets a hook skip key hashing
        entirely when the site is cold."""
        return site in self._by_site

    # -- accounting ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            per_site = {s: st.n_injected for s, st in self._sites.items()}
            return {
                "n_injected": sum(per_site.values()),
                "per_site": per_site,
            }

    @property
    def n_injected(self) -> int:
        return self.stats()["n_injected"]
