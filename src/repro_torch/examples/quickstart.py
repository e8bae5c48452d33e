"""Port of ``examples/quickstart.py``: optimize ONE antioxidant with a
freshly-trained tiny agent.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Walks the whole public API: dataset -> predictors -> environment -> DQN
training -> greedy optimization -> filter script, on ``--device``
(default ``cuda``).  Fleet acting goes through the ``packed_qnet_stacked``
kernel (one launch per mesh shard per fleet step), greedy optimization through
``fused_qnet``.  ``main(argv, cache_dir=...)`` points ``ensure_trained`` at
a predictor cache other than the default ``.cache/predictors_torch``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.chem.smiles import canonical_smiles
from repro_torch.core import (
    DQNConfig, EnvConfig, FilterCriteria, RewardConfig, TrainerConfig,
    filter_molecules,
)
from repro_torch.core.agent import QNetwork
from repro_torch.core.distributed import DistributedTrainer, greedy_optimize
from repro_torch.data.datasets import antioxidant_dataset, dataset_property_table
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.predictors import PropertyService
from repro_torch.predictors.training import ensure_trained


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="optimize one antioxidant with a freshly-trained tiny agent")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    return ap


def main(argv=None, *, cache_dir: str | None = None) -> None:
    args = parser().parse_args(argv)
    # 1. predictors (Alfabet-S / AIMNet-S), trained against the oracle once
    bde_model, bde_params, ip_model, ip_params, metrics = ensure_trained(
        cache_dir, device=args.device)
    print(f"predictors ready: BDE rel err {metrics['bde']['rel_err_mean']:.2%}, "
          f"IP rel err {metrics['ip']['rel_err_mean']:.2%}")
    service = PropertyService(bde_model, bde_params, ip_model, ip_params,
                              device=args.device)

    # 2. data + reward normalisation bounds (§3.4)
    mols = antioxidant_dataset(32, seed=9)
    props = dataset_property_table(mols)
    rcfg = RewardConfig.from_dataset(props["bde"], props["ip"])
    print(f"dataset: {len(mols)} antioxidants, "
          f"BDE [{rcfg.bde_min:.0f}, {rcfg.bde_max:.0f}] kcal/mol")

    # 3. train a small general model on 4 molecules (2 workers x 2); the
    # network's He init from the trainer's seed, as the trainer draws its own
    cfg = TrainerConfig(
        n_workers=2, mols_per_worker=2, episodes=15, sync_mode="episode",
        train_batch_size=16, max_candidates=32, updates_per_episode=3,
        dqn=DQNConfig(epsilon_decay=0.85), env=EnvConfig(max_steps=4))
    network = QNetwork(hidden=(256, 64), device="cpu",
                       generator=torch.Generator().manual_seed(cfg.seed))
    trainer = DistributedTrainer(cfg, mols[:4], service, rcfg,
                                 network=network,
                                 mesh=make_host_mesh(device=args.device))
    for st in trainer.train(log_every=5):
        pass
    trainer.close()
    # acting is fleet-batched: ONE Q dispatch + ONE property batch per step
    # across all workers (rollout="per_worker" restores the sequential path)
    print(f"acting: {trainer.n_q_dispatches} Q dispatches for "
          f"{trainer.engine.n_env_steps} fleet steps, "
          f"{service.n_predict_calls} property batches")

    # 4. greedy optimization with the general model
    agent = trainer.as_agent(epsilon=0.0)
    recs = greedy_optimize(agent, mols[:4], service, rcfg, cfg.env)
    for r in recs:
        print(f"  {canonical_smiles(r.molecule):40s} reward {r.reward:7.3f} "
              f"BDE {r.bde and round(r.bde,1)} IP {r.ip and round(r.ip,1)}")

    # 5. filter script (§3.5)
    results = filter_molecules(
        [(r.molecule, r.bde, r.ip) for r in recs], known=mols,
        criteria=FilterCriteria())
    kept = [r for r in results if r.passed]
    print(f"filter: {len(kept)}/{len(results)} pass BDE<76 & IP>145 & SA<=3.5")


if __name__ == "__main__":
    main()
