"""Port of ``repro.launch.serve_molopt``: the molecule-optimization server.

Stands up a ``MoleculeOptService`` on the GPU — bounded admission queue,
continuous batching over RolloutEngine slots, circuit breaker over the
property tier, Q dispatch through the ``fused_qnet`` CUDA kernel — and
replays a seeded open-loop request stream against it, printing the
per-request terminal results and the service counters.

    PYTHONPATH=src python -m repro_torch.launch.serve_molopt \
        --slots 8 --requests 32 --rate 2.0 --deadline-frac 0.3

Properties come from the deterministic ``OracleService`` stub (no
predictor training, seconds to start); the reference's ``--trained``
needs the learned predictors, which arrive with a later slice of the
port.  ``--faults`` arms a seeded ``FaultPlan`` over the
predict/chem/request sites, exercising the whole degradation ladder:
retries, per-request quarantine, breaker trips into degraded serving,
half-open recovery.  ``--device cpu`` runs the plain PyTorch Q path.
The Q-network's weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.agent import QNetwork
from repro_torch.core.faults import FaultPlan, FaultRule
from repro_torch.predictors.service import (OracleService, ResilientService,
                                            RetryPolicy)
from repro_torch.serving import (MoleculeOptService, ServeConfig, StreamConfig,
                                 drive_open_loop, latency_stats,
                                 seeded_request_stream)


def build_service(args) -> MoleculeOptService:
    net = QNetwork(generator=torch.Generator().manual_seed(args.seed),
                   device=args.device)
    plan = None
    if args.faults:
        plan = FaultPlan([
            FaultRule(site="predict", kind="crash", every=args.fault_every,
                      fail_attempts=args.fault_attempts),
            FaultRule(site="chem", kind="crash", rate=args.fault_rate),
            FaultRule(site="request", kind="transient", rate=args.fault_rate,
                      fail_attempts=1),
        ], seed=args.fault_seed)
    prop = ResilientService(OracleService(),
                            RetryPolicy(max_retries=1, seed=args.seed),
                            fault_plan=plan, sleep=None)
    return MoleculeOptService(
        net, prop, fault_plan=plan, device=args.device,
        cfg=ServeConfig(n_slots=args.slots, max_queue=args.max_queue,
                        shed_policy=args.shed_policy, epsilon=args.epsilon,
                        seed=args.seed))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--shed-policy", choices=("reject_new", "evict_oldest"),
                    default="reject_new")
    ap.add_argument("--epsilon", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean arrivals per service step")
    ap.add_argument("--deadline-frac", type=float, default=0.3)
    ap.add_argument("--invalid-every", type=int, default=0,
                    help="poison every Nth request with unparseable SMILES")
    ap.add_argument("--faults", action="store_true",
                    help="arm a seeded FaultPlan (predict/chem/request)")
    ap.add_argument("--fault-every", type=int, default=7)
    ap.add_argument("--fault-rate", type=float, default=0.05)
    ap.add_argument("--fault-attempts", type=int, default=4)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch Q path")
    ap.add_argument("--json", action="store_true",
                    help="print machine-readable results instead of a table")
    return ap


def serve(args) -> tuple[MoleculeOptService, float]:
    """Build the service, warm it up off the clock, replay the seeded
    stream; returns the drained service and the stream's wall seconds."""
    svc = build_service(args)
    arrivals = seeded_request_stream(StreamConfig(
        n_requests=args.requests, rate=args.rate, seed=args.seed,
        deadline_frac=args.deadline_frac, invalid_every=args.invalid_every))
    svc.reserve_candidates(256)          # warmup: kernel built off the clock
    t0 = time.perf_counter()
    drive_open_loop(svc, arrivals)
    return svc, time.perf_counter() - t0


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    svc, wall = serve(args)

    if args.json:
        print(json.dumps({"results": [r.as_dict() for r in svc.results],
                          "stats": svc.stats()}, indent=2, default=str))
        return
    print(f"{'request':10s} {'status':18s} {'steps':>5s} {'deg':>3s} "
          f"{'lat':>6s} {'wall_ms':>8s}  best")
    for r in sorted(svc.results, key=lambda r: r.request_id):
        best = "-" if r.best_reward is None else \
            f"{r.best_reward:+.4f} {r.best_smiles}"
        err = f"  [{r.error[:48]}]" if r.error else ""
        print(f"{r.request_id:10s} {r.status:18s} {r.steps_used:5d} "
              f"{r.degraded_steps:3d} {r.latency:6.1f} "
              f"{r.wall_latency_s * 1e3:8.1f}  {best}{err}")
    st = svc.stats()
    lat = latency_stats(svc.results)
    print(f"\n{args.requests} requests in {wall:.2f}s on {svc.device} "
          f"({args.requests / wall:.1f} req/s) | statuses "
          f"{st['status_counts']} | p50/p99 wall "
          f"{lat['p50_wall_ms']:.1f}/{lat['p99_wall_ms']:.1f} ms")
    print(f"service steps {st['n_service_steps']} | Q dispatches "
          f"{st['n_q_dispatches']} | queue {st['queue']} | breaker "
          f"{st['breaker']}")
    timing = svc.dispatch_timing()
    if timing is not None:
        print(f"per Q dispatch: H2D copy {timing['h2d_ms']:.3f} ms, fused_qnet "
              f"{timing['kernel_ms']:.3f} ms (CUDA events)")


if __name__ == "__main__":
    main()
