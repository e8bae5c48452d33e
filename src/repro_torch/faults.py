"""Copy of ``repro.faults``; only its imports differ.

Fault taxonomy for the training stack (dependency-free).

These exception types live at the package root (NOT in ``repro.core``) so
low-level layers like ``repro.predictors.service`` can raise/catch them
without importing ``repro.core`` — whose package init pulls in the trainer
and would close an import cycle.  ``repro.core.faults`` (the injection
scheduler, :class:`~repro.core.faults.FaultPlan`) re-exports them, and is
the import site the RL core uses.

:class:`TransientFault`   retryable: the next attempt may succeed (every
                          wrapped dependency is deterministic, so a retry
                          is bit-identical to a first try).
:class:`FaultTimeout`     a per-call timeout — a retryable
                          ``TransientFault`` flavour (raised both by fault
                          injection and by the real timeout path in
                          ``ResilientService``).
:class:`FaultError`       terminal: retries exhausted or a hard crash.
                          The caller must quarantine the affected unit of
                          work (slot / checkpoint write), not retry.
"""

from __future__ import annotations


class TransientFault(RuntimeError):
    """A retryable failure: the next attempt may succeed."""


class FaultTimeout(TransientFault):
    """A per-call timeout (retryable)."""


class FaultError(RuntimeError):
    """A terminal failure: retries exhausted or a hard crash — quarantine,
    don't retry."""
