"""Port of ``repro.launch.train``: the training launcher.

Two modes, as the reference's:

* ``--mode rl`` (default; the paper): distributed DA-MolDQN over an
  antioxidant dataset on a mesh of every visible GPU (one shard each;
  ``launch/mesh.py``).  The learned BDE and IP predictors are
  trained or loaded (``ensure_trained``) and serve every property batch
  through ``PropertyService``; ``DistributedTrainer`` acts through the
  ``packed_qnet_stacked`` kernel (one launch per shard per fleet env step) and
  checkpoints its full state every ``--ckpt-every`` episodes into a
  ``CheckpointManager``; ``--resume`` continues bit for bit; the general
  model is scored by ``greedy_optimize`` (its Q dispatches through
  ``fused_qnet``) and the paper's OFR (Eq. 2).

* ``--mode lm --arch <id>``: train a model-zoo backbone (any registered
  config; ``--reduced`` for the CPU-sized variant) as a SMILES language
  model with ``make_train_step``, on the reference's corpus (canonical
  SMILES of ``antioxidant_dataset(256)``) and batches; encdec configs get
  stub encoder frames and vlm configs stub image patches, standard normals
  from ``np.random.default_rng(0)`` drawn every step, as in the reference.
  It trains through the plain routes, as the reference does: the LM
  kernels are forward only.

    PYTHONPATH=src python -m repro_torch.launch.train --mode rl --episodes 40
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --episodes 2 --workers 2 --mols-per-worker 2
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm --reduced \
        --steps 20 --device cpu

Everything runs on ``cuda`` unless ``--device cpu`` is passed.  The
predictors' cache defaults to ``.cache/predictors_torch`` and the
checkpoints to ``.cache/rl_ckpt_torch``, apart from the reference's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager


def parser() -> argparse.ArgumentParser:
    from repro_torch.core.distributed import LEARNER_MODES, REPLAY_MODES, ROLLOUT_MODES
    from repro_torch.data.datasets import DATASETS

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("rl", "lm"), default="rl")
    # rl args
    ap.add_argument("--episodes", type=int, default=40)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--mols-per-worker", type=int, default=4)
    ap.add_argument("--sync", choices=("episode", "step"), default="episode")
    ap.add_argument("--rollout", choices=ROLLOUT_MODES, default="fleet",
                    help="acting path (see core.distributed)")
    ap.add_argument("--learner", choices=LEARNER_MODES, default="packed",
                    help="replay->update path (see core.distributed)")
    ap.add_argument("--replay", choices=REPLAY_MODES, default="uniform",
                    help="replay sampling: uniform (reference) or "
                         "prioritized (proportional PER)")
    ap.add_argument("--priority-alpha", type=float, default=0.6)
    ap.add_argument("--priority-beta0", type=float, default=0.4)
    ap.add_argument("--dataset", choices=sorted(DATASETS), default=None,
                    help="multi-start episode stream: draw every episode's "
                         "start molecules from this seeded dataset cursor "
                         "(default: fixed train-split batch)")
    ap.add_argument("--dataset-size", type=int, default=None,
                    help="dataset pool size (default: the dataset's own)")
    ap.add_argument("--scenarios", default=None,
                    help="comma list of scenario-registry names cycled "
                         "across workers (configs/scenarios.py), e.g. "
                         "'antioxidant,qed'; default: the Eq. 1 "
                         "antioxidant objective on every worker")
    ap.add_argument("--ckpt-dir", default=".cache/rl_ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=5,
                    help="full trainer-state checkpoint every N episodes "
                         "(bit-exact resume granularity)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt-dir and "
                         "continue; the continued run is bit-identical to "
                         "one that never stopped")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    # lm args
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.mode == "rl":
        train_rl(args)
    else:
        train_lm(args)


def train_rl(args) -> None:
    from repro_torch.core import DQNConfig, RewardConfig, TrainerConfig
    from repro_torch.core.distributed import (DistributedTrainer, greedy_optimize,
                                              optimization_failure_rate)
    from repro_torch.data.datasets import (antioxidant_dataset,
                                           dataset_property_table, load_dataset,
                                           train_test_split)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.predictors import PropertyService
    from repro_torch.predictors.training import ensure_trained

    bm, bp, im, ip_, metrics = ensure_trained(device=args.device)
    service = PropertyService(bm, bp, im, ip_, device=args.device)
    n_mols = args.workers * args.mols_per_worker
    if args.dataset is not None:
        # multi-start: reward normalisation and evaluation come from the
        # streamed pool itself; the trainer re-draws starts every episode
        pool = load_dataset(args.dataset, count=args.dataset_size)
        train, molecules, dataset_pool = pool, None, pool
    else:
        ds = antioxidant_dataset(600)
        train, test = train_test_split(ds)
        molecules, dataset_pool = train[:n_mols], None
    props = dataset_property_table(train)
    rcfg = RewardConfig.from_dataset(props["bde"], props["ip"])

    cfg = TrainerConfig(
        n_workers=args.workers, mols_per_worker=args.mols_per_worker,
        episodes=args.episodes, sync_mode=args.sync, rollout=args.rollout,
        learner=args.learner, replay=args.replay,
        priority_alpha=args.priority_alpha, priority_beta0=args.priority_beta0,
        dataset=args.dataset, dataset_size=args.dataset_size,
        scenarios=(tuple(args.scenarios.split(","))
                   if args.scenarios else None),
        dqn=DQNConfig(epsilon_decay=0.97))
    # every visible card, as the reference launcher's make_host_mesh()
    trainer = DistributedTrainer(cfg, molecules, service, rcfg,
                                 dataset_pool=dataset_pool,
                                 mesh=make_host_mesh(device=args.device))
    mgr = CheckpointManager(args.ckpt_dir)
    if args.resume:
        ep0 = trainer.restore_checkpoint(mgr)
        print(f"resumed from episode {ep0} ({args.ckpt_dir})", flush=True)

    t0 = time.time()
    while trainer.episode < args.episodes:
        st = trainer.train_episode()
        ep = st["episode"]
        if ep % 5 == 0 or ep == args.episodes:
            print(f"[ep {ep:4d}] reward {st['mean_final_reward']:8.3f} "
                  f"loss {st['loss']:10.4f} eps {st['epsilon']:.3f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if ep % max(1, args.ckpt_every) == 0 or ep == args.episodes:
            # FULL trainer state (params, opt, replay rings, RNGs, dataset
            # cursor) — what --resume restores bit-exactly
            trainer.save_checkpoint(mgr)
    trainer.close()

    agent = trainer.as_agent(epsilon=0.0)
    recs = greedy_optimize(agent, list(train[:n_mols]), service, rcfg, cfg.env)
    print(f"train-set OFR: {optimization_failure_rate(recs):.3f}")
    print(f"cache hit rate: {service.cache.hit_rate:.3f}")


def lm_batches(batch: int, seq: int):
    """The reference launcher's batches: canonical SMILES of
    ``antioxidant_dataset(256)``, tokenized, seed 0."""
    from repro_torch.chem.smiles import canonical_smiles
    from repro_torch.data.datasets import antioxidant_dataset
    from repro_torch.data.pipeline import lm_batches_from_smiles
    from repro_torch.data.tokenizer import SmilesTokenizer
    smiles = [canonical_smiles(m) for m in antioxidant_dataset(256)]
    return lm_batches_from_smiles(smiles, SmilesTokenizer(), batch, seq)


def with_stub_inputs(cfg, batches):
    """``batches`` with the encdec family's stub frames ``[B, n_frames,
    d_model]`` or the vlm's stub patches ``[B, n_patches, vision_dim]``
    added to each, f32 standard normals from one ``np.random.default_rng(0)``
    drawn batch by batch, as the reference launcher feeds them."""
    rng = np.random.default_rng(0)
    for batch in batches:
        B = batch["tokens"].shape[0]
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.vlm.n_patches, cfg.vlm.vision_dim)).astype(np.float32)
        yield batch


def lm_loop(cfg, params, batches, steps: int, *, log_every: int = 10):
    """``steps`` train steps of ``make_train_step(cfg)`` from ``params``;
    prints ``[step N] loss`` at step 1 and every ``log_every`` steps, and
    returns the losses as floats."""
    from repro_torch.launch.steps import make_train_step

    step, opt = make_train_step(cfg)
    opt_state = opt.init(params)
    losses = []
    t0 = time.time()
    for i, batch in zip(range(steps), batches):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        if i == 0 or (i + 1) % log_every == 0:
            print(f"[step {i+1:4d}] loss {losses[-1]:.4f} ({time.time()-t0:.0f}s)",
                  flush=True)
    return losses


def train_lm(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device=args.device)
    batches = with_stub_inputs(cfg, lm_batches(args.batch, args.seq))
    losses = lm_loop(cfg, params, batches, args.steps)
    print(json.dumps({"final_loss": losses[-1], "steps": args.steps}))


if __name__ == "__main__":
    main()
