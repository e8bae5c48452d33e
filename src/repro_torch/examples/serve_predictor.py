"""Port of ``examples/serve_predictor.py``: an end-to-end client of the
molecule-optimization service.

Builds a ``MoleculeOptService`` (the continuously-batched request router
of docs/serving.md), submits a small mixed request batch — different
start molecules, objectives, budgets, one deadline-bound request, one
INVALID SMILES — and prints each request's terminal status and latency.
Every request gets exactly one structured answer; the poisoned one fails
at the door without disturbing its co-batched neighbours.

    PYTHONPATH=src python -m repro_torch.examples.serve_predictor            # oracle stub
    PYTHONPATH=src python -m repro_torch.examples.serve_predictor --trained  # real predictors

The service runs on ``--device`` (default ``cuda``), and each Q dispatch
is one ``fused_qnet`` launch there.  The Q network's weights are a
He-normal init from ``torch.Generator().manual_seed(0)``: the reference
draws them from ``jax.random.PRNGKey(0)``, which torch cannot reproduce,
so the served molecules differ from the reference's.
``main(argv, cache_dir=...)`` points ``ensure_trained`` at a predictor
cache other than the default ``.cache/predictors_torch``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.agent import QNetwork
from repro_torch.predictors.service import OracleService
from repro_torch.serving import MoleculeOptService, OptimizeRequest, ServeConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve a mixed request batch through MoleculeOptService")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--trained", action="store_true",
                    help="serve through the trained BDE+IP predictors "
                         "(trains them on first run) instead of the oracle stub")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    return ap


def main(argv=None, *, cache_dir: str | None = None) -> None:
    args = parser().parse_args(argv)
    qnet = QNetwork(generator=torch.Generator().manual_seed(0), device=args.device)
    if args.trained:
        from repro_torch.predictors import PropertyService
        from repro_torch.predictors.training import ensure_trained
        bm, bp, im, ip_, metrics = ensure_trained(cache_dir, device=args.device)
        properties = PropertyService(bm, bp, im, ip_, device=args.device)
        print(f"predictor accuracy: BDE {metrics['bde']['rel_err_mean']:.2%}, "
              f"IP {metrics['ip']['rel_err_mean']:.2%} (paper: <5%)")
    else:
        properties = OracleService()
    svc = MoleculeOptService(
        qnet, properties,
        cfg=ServeConfig(n_slots=args.slots, max_queue=16, epsilon=0.05),
        device=args.device)

    requests = [
        OptimizeRequest("phenol", "C1=CC=CC=C1O", budget=8, seed=1),
        OptimizeRequest("catechol", "OC1=CC=CC=C1O", budget=8, seed=2),
        OptimizeRequest("cresol-bde", "CC1=CC=C(O)C=C1",
                        objective="antioxidant_bde", budget=6, seed=3),
        OptimizeRequest("anisole-ip", "COC1=CC=CC=C1O",
                        objective="antioxidant_ip", budget=6, seed=4),
        # a non-antioxidant scenario: any registry name is requestable
        # (configs/scenarios.py — the same table the trainer mixes)
        OptimizeRequest("druglike", "CC(=O)NC1=CC=C(O)C=C1",
                        objective="qed", budget=6, seed=6),
        OptimizeRequest("hurried", "CC(C)C1=CC=CC=C1O", budget=10,
                        deadline=9.0, seed=5),
        OptimizeRequest("poisoned", "this is not a molecule", budget=8),
    ]

    t0 = time.perf_counter()
    for req in requests:
        verdict = svc.submit(req)
        print(f"submit {req.request_id:12s} -> {verdict}")
    svc.run_until_idle()
    wall = time.perf_counter() - t0

    print(f"\n{'request':12s} {'status':18s} {'steps':>5s} {'lat':>5s} "
          f"{'wall_ms':>8s}  best")
    for r in svc.results:
        best = "-" if r.best_reward is None else \
            f"{r.best_reward:+.4f}  {r.best_smiles}"
        err = f"  [{r.error[:44]}]" if r.error else ""
        print(f"{r.request_id:12s} {r.status:18s} {r.steps_used:5d} "
              f"{r.latency:5.1f} {r.wall_latency_s * 1e3:8.1f}  {best}{err}")

    st = svc.stats()
    print(f"\n{len(requests)} requests in {wall:.2f}s | statuses "
          f"{st['status_counts']} | {st['n_service_steps']} service steps, "
          f"{st['n_q_dispatches']} Q dispatches, breaker "
          f"{st['breaker']['state']}")


if __name__ == "__main__":
    main()
