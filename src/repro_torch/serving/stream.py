"""Copy of ``repro.serving.stream``; only its imports differ.

Seeded open-loop request streams + the serve driver loop.

Shared by ``benchmarks/bench_serve.py``, ``launch/serve_molopt.py``, and
``examples/serve_predictor.py`` so they all speak the same workload:
arrivals are drawn ONCE from a seeded RNG (exponential inter-arrival
times on the service's virtual clock, molecules from a SMILES pool,
mixed budgets/deadlines/objectives, optionally every Nth request
poisoned with unparseable SMILES), then replayed open-loop — the driver
submits whatever is due at the current virtual time and steps the
service, never waiting for responses.  Identical seed => identical
stream => (by the serve determinism contract) identical statuses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.serving.request import OptimizeRequest
from repro_torch.serving.service import MoleculeOptService

# a churn-friendly default pool: the bench_train multi-start phenols
# (Kekulé form — the subset chem/smiles.py round-trips)
DEFAULT_POOL = (
    "C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O", "CC1=CC=CC=C1O", "OC1=CC=CC=C1O",
    "CC1=CC=C(O)C=C1", "COC1=CC=CC=C1O", "CC(C)C1=CC=CC=C1O", "NC1=CC=CC=C1O",
    "CC1=C(O)C(C)=CC=C1", "OC1=CC=C(O)C=C1", "CCC1=CC=CC=C1O", "CC1=CC(O)=CC=C1",
)

INVALID_SMILES = "not-a-molecule!"


@dataclass(frozen=True)
class StreamConfig:
    n_requests: int = 32
    rate: float = 2.0                # mean arrivals per virtual clock tick
    seed: int = 0
    budget_lo: int = 3
    budget_hi: int = 8               # inclusive
    deadline_frac: float = 0.0       # fraction of requests carrying deadlines
    deadline_lo: float = 4.0         # drawn deadline range (clock units)
    deadline_hi: float = 16.0
    invalid_every: int = 0           # every Nth request is unparseable
    prefix: str = "req"              # request-id prefix (ids must be unique
    #                                # per service — warmup streams differ)


def seeded_request_stream(cfg: StreamConfig, pool: tuple[str, ...] = DEFAULT_POOL
                          ) -> list[tuple[float, OptimizeRequest]]:
    """Draw the whole arrival schedule up front: ``(arrival_time, request)``
    pairs sorted by time.  Pure function of (cfg, pool)."""
    rng = np.random.default_rng(cfg.seed)
    t = 0.0
    out: list[tuple[float, OptimizeRequest]] = []
    for i in range(cfg.n_requests):
        t += float(rng.exponential(1.0 / cfg.rate))
        smiles = pool[int(rng.integers(len(pool)))]
        if cfg.invalid_every and (i + 1) % cfg.invalid_every == 0:
            smiles = INVALID_SMILES
        budget = int(rng.integers(cfg.budget_lo, cfg.budget_hi + 1))
        deadline = None
        if cfg.deadline_frac > 0.0 and rng.random() < cfg.deadline_frac:
            deadline = float(np.round(
                cfg.deadline_lo
                + rng.random() * (cfg.deadline_hi - cfg.deadline_lo), 1))
        out.append((t, OptimizeRequest(
            request_id=f"{cfg.prefix}-{i:04d}", smiles=smiles, budget=budget,
            deadline=deadline, seed=i)))
    return out


def drive_open_loop(svc: MoleculeOptService,
                    arrivals: list[tuple[float, OptimizeRequest]],
                    max_steps: int = 100_000) -> list[int]:
    """Replay ``arrivals`` against the service's virtual clock: submit
    everything due, step, repeat until the stream is exhausted AND the
    service is idle.  Raises if any request hangs past ``max_steps`` —
    every admitted request must terminate.  Returns the per-step count of
    newly finalized results (the streaming trace)."""
    i = 0
    trace: list[int] = []
    for _ in range(max_steps):
        while i < len(arrivals) and arrivals[i][0] <= svc.clock.now():
            svc.submit(arrivals[i][1])
            i += 1
        if i >= len(arrivals) and svc.idle:
            return trace
        trace.append(len(svc.step()))
    raise RuntimeError(
        f"stream not drained after {max_steps} steps "
        f"({i}/{len(arrivals)} submitted, idle={svc.idle})")


def latency_stats(results) -> dict:
    """p50/p99 latency over the terminal results, virtual + wall."""
    if not results:
        return {"p50_latency": 0.0, "p99_latency": 0.0,
                "p50_wall_ms": 0.0, "p99_wall_ms": 0.0}
    lat = np.array([r.latency for r in results], np.float64)
    wall = np.array([r.wall_latency_s for r in results], np.float64) * 1e3
    return {
        "p50_latency": float(np.percentile(lat, 50)),
        "p99_latency": float(np.percentile(lat, 99)),
        "p50_wall_ms": float(np.percentile(wall, 50)),
        "p99_wall_ms": float(np.percentile(wall, 99)),
    }
