"""Copy of ``repro.serving``; only its imports differ.

Robust molecule-optimization serving (docs/serving.md).

``MoleculeOptService`` turns the trained fleet into a request router:
bounded admission queue with load shedding, continuous batching over
``RolloutEngine`` slots, per-request deadlines/objectives/RNG streams,
a circuit breaker over the shared property tier, and structured terminal
statuses for every request.
"""

from repro_torch.serving.admission import SHED_POLICIES, AdmissionQueue
from repro_torch.serving.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from repro_torch.configs.scenarios import list_scenarios
from repro_torch.serving.request import (STATUSES, OptimizeRequest,
                                   RequestResult, resolve_objective)
from repro_torch.serving.service import (MoleculeOptService, ServeConfig, StepClock)
from repro_torch.serving.stream import (DEFAULT_POOL, INVALID_SMILES, StreamConfig,
                                  drive_open_loop, latency_stats,
                                  seeded_request_stream)

__all__ = [
    "AdmissionQueue", "SHED_POLICIES",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "OptimizeRequest", "RequestResult", "STATUSES",
    "resolve_objective", "list_scenarios",
    "MoleculeOptService", "ServeConfig", "StepClock",
    "StreamConfig", "seeded_request_stream", "drive_open_loop",
    "latency_stats", "DEFAULT_POOL", "INVALID_SMILES",
]
