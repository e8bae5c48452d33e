"""Copy of ``repro.serving.request``; only its imports differ.

Request/response types of the molecule-optimization service.

A request names a start molecule (SMILES), an objective, a step budget,
and an optional deadline; the service answers with exactly one
:class:`RequestResult` carrying a TERMINAL status:

``completed``          the episode ran its budget (or died legally on a
                       molecule with no legal edit) with every property
                       served by the primary tier.
``degraded``           the episode finished, but >= 1 step's properties
                       came from the degraded tier (tripped circuit
                       breaker: cached / oracle-stub values) — the result
                       is usable but not primary-grade.
``deadline_exceeded``  the deadline passed (queued or mid-flight); the
                       slot was reclaimed that very service step and the
                       best-so-far molecule is returned.
``shed``               admission control refused the request (bounded
                       queue full under the configured shedding policy).
``failed``             the request itself is poisoned — unparseable
                       SMILES, unknown objective, injected request fault,
                       or a terminal chem/predict fault quarantined its
                       slot.  Carries the error and an Incident on the
                       service trail; co-batched requests never notice.

Every admitted request reaches exactly one of these — none are lost or
hung, which `bench_serve.py --smoke` gates under an active FaultPlan.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.reward import ObjectiveSpec, RewardConfig

STATUSES = ("completed", "degraded", "deadline_exceeded", "shed", "failed")


def resolve_objective(objective) -> object:
    """Map a request's objective field to what the engine consumes.

    Named objectives resolve through THE scenario registry
    (:mod:`repro.configs.scenarios`) — the same table the trainer mixes
    per worker, so every trainable scenario (``antioxidant``, ``qed``,
    ``plogp``, ...) is requestable (Mol-AIR-style per-request objective
    selection, arXiv 2403.20109).  A name or an ``ObjectiveSpec`` is
    compiled FRESH per request (a novelty term's visit counts are
    request-private state); a ``RewardConfig`` or a callable
    ``(props, initial, current, steps_left) -> float`` passes through
    untouched.  Raises ``ValueError`` on anything else — caught at
    submit time, where it turns into a ``failed`` status whose message
    lists the registry names, instead of a crashed server."""
    if isinstance(objective, ObjectiveSpec):
        return objective.compile()
    if isinstance(objective, RewardConfig) or callable(objective):
        return objective
    if isinstance(objective, str):
        from repro_torch.configs.scenarios import get_scenario
        return get_scenario(objective).compile()
    raise ValueError(
        f"objective must be a scenario name, ObjectiveSpec, RewardConfig, "
        f"or callable, got {type(objective).__name__}")


@dataclass(frozen=True)
class OptimizeRequest:
    """One user query: optimize ``smiles`` under ``objective`` for up to
    ``budget`` env steps, answering within ``deadline`` clock units of
    submission (None = no deadline).  ``seed`` feeds the request's PRIVATE
    exploration RNG stream — co-batched requests never share draws, which
    is what keeps one request's fate from perturbing another's actions."""

    request_id: str
    smiles: str
    objective: object = "antioxidant"
    budget: int = 8
    deadline: float | None = None
    seed: int = 0


@dataclass
class RequestResult:
    """The single terminal answer for one request."""

    request_id: str
    status: str                      # one of STATUSES
    best_smiles: str | None = None   # best-so-far molecule (canonical)
    best_reward: float | None = None
    steps_used: int = 0
    degraded_steps: int = 0          # env steps served by the degraded tier
    submitted_at: float = 0.0        # service-clock units
    finished_at: float = 0.0
    wall_latency_s: float = 0.0      # measured wall clock (reporting only)
    error: str | None = None         # failed: what went wrong

    @property
    def latency(self) -> float:
        """Deterministic latency in service-clock units."""
        return self.finished_at - self.submitted_at

    def as_dict(self) -> dict:
        return {
            "request_id": self.request_id, "status": self.status,
            "best_smiles": self.best_smiles, "best_reward": self.best_reward,
            "steps_used": self.steps_used,
            "degraded_steps": self.degraded_steps,
            "latency": self.latency,
            "wall_latency_s": self.wall_latency_s, "error": self.error,
        }
