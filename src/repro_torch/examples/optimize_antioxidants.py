"""Port of ``examples/optimize_antioxidants.py``: the paper's §4
experiment end to end on the GPU.

Trains the DA-MolDQN GENERAL model on a set of antioxidants for a few
hundred episodes (default 60 — raise --episodes for a longer run), then:
  * optimizes the training molecules (Fig. 2),
  * optimizes UNSEEN test molecules (Fig. 4),
  * fine-tunes on the worst test molecule (§3.5) and reports the delta,
  * runs the filter script and prints surviving candidates with
    oracle ("DFT") validation of the predicted properties (Table 5).

    PYTHONPATH=src python -m repro_torch.examples.optimize_antioxidants \
        --episodes 60 --workers 4 --mols-per-worker 4

Everything runs on ``--device`` (default ``cuda``): fleet acting through
``packed_qnet_stacked``, greedy optimization and fine-tuning through
``fused_qnet``.  ``main(argv, cache_dir=...)`` points ``ensure_trained`` at
a predictor cache other than the default ``.cache/predictors_torch``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.chem.oracle import oracle_bde, oracle_ip
from repro_torch.chem.smiles import canonical_smiles
from repro_torch.core import (DQNConfig, EnvConfig, FilterCriteria, RewardConfig,
                              TrainerConfig, filter_molecules)
from repro_torch.core.agent import QNetwork
from repro_torch.core.distributed import (DistributedTrainer, greedy_optimize,
                                          optimization_failure_rate)
from repro_torch.core.finetune import fine_tune
from repro_torch.data.datasets import (antioxidant_dataset, dataset_property_table,
                                       train_test_split)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.predictors import PropertyService
from repro_torch.predictors.training import ensure_trained


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the paper's §4 experiment: train, Fig. 2, Fig. 4, "
                    "fine-tune, filter, oracle validation")
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--mols-per-worker", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=5)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    return ap


def main(argv=None, *, cache_dir: str | None = None) -> None:
    args = parser().parse_args(argv)
    bm, bp, im, ipar, _ = ensure_trained(cache_dir, device=args.device)
    service = PropertyService(bm, bp, im, ipar, device=args.device)
    ds = antioxidant_dataset(600)
    train, test = train_test_split(ds)
    props = dataset_property_table(train)
    rcfg = RewardConfig.from_dataset(props["bde"], props["ip"])

    n_mols = args.workers * args.mols_per_worker
    env_cfg = EnvConfig(max_steps=args.max_steps)
    cfg = TrainerConfig(
        n_workers=args.workers, mols_per_worker=args.mols_per_worker,
        episodes=args.episodes, sync_mode="episode", train_batch_size=32,
        max_candidates=48, updates_per_episode=4,
        dqn=DQNConfig(epsilon_decay=0.95), env=env_cfg)

    print(f"== training general model: {n_mols} molecules, {args.episodes} episodes ==")
    t0 = time.time()
    network = QNetwork(hidden=(512, 128, 32), device="cpu",
                       generator=torch.Generator().manual_seed(cfg.seed))
    trainer = DistributedTrainer(cfg, train[:n_mols], service, rcfg,
                                 network=network,
                                 mesh=make_host_mesh(device=args.device))
    trainer.train(log_every=10)
    trainer.close()
    print(f"trained in {time.time()-t0:.0f}s; cache hit rate {service.cache.hit_rate:.2f}")

    agent = trainer.as_agent(epsilon=0.0)

    print("\n== Fig. 2: training molecules ==")
    recs = greedy_optimize(agent, train[:n_mols], service, rcfg, env_cfg, seed=1)
    print(f"mean reward {np.mean([r.reward for r in recs]):.3f}  "
          f"OFR {optimization_failure_rate(recs):.2f}")

    print(f"\n== Fig. 4: {args.n_test} unseen molecules ==")
    trecs = greedy_optimize(agent, test[:args.n_test], service, rcfg, env_cfg, seed=2)
    print(f"mean reward {np.mean([r.reward for r in trecs]):.3f}  "
          f"OFR {optimization_failure_rate(trecs):.2f}")

    print("\n== §3.5 fine-tuning the worst unseen molecule ==")
    worst = int(np.argmin([r.reward for r in trecs]))
    ft = fine_tune(agent, test[worst], service, rcfg, episodes=15,
                   env_cfg=env_cfg, train_batch_size=16, max_candidates=32,
                   device=args.device)
    before = trecs[worst].reward
    after = greedy_optimize(ft, [test[worst]], service, rcfg, env_cfg, seed=3)[0].reward
    print(f"reward before {before:.3f} -> after fine-tune {after:.3f}")

    print("\n== filter script + oracle ('DFT') validation ==")
    results = filter_molecules([(r.molecule, r.bde, r.ip) for r in recs + trecs],
                               known=train[:n_mols] + test[:args.n_test],
                               criteria=FilterCriteria())
    for r in results:
        if r.passed:
            dft_bde = oracle_bde(r.molecule)
            dft_ip = oracle_ip(r.molecule)
            print(f"  {canonical_smiles(r.molecule):44s} "
                  f"ML bde/ip {r.bde:5.1f}/{r.ip:5.1f}  "
                  f"DFT {dft_bde:5.1f}/{dft_ip:5.1f}  SA {r.sa:.2f}")
    n_pass = sum(r.passed for r in results)
    print(f"{n_pass}/{len(results)} pass the filter")


if __name__ == "__main__":
    main()
