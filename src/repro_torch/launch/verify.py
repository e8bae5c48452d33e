"""Port of ``repro.launch.verify``: the truth run, one (rollout x learner x
chem x sync) cell of the equivalence matrix, on an nd-shard mesh.

Each invocation is one fresh process, one scenario, one ``.npz`` report:

    PYTHONPATH=src python -m repro_torch.launch.verify --out /tmp/v.npz \
        --rollout fleet_sharded --learner packed --chem incremental
    PYTHONPATH=src python -m repro_torch.launch.verify --device cpu --nd 4 \
        --out /tmp/nd4.npz

The report carries what the reference's equivalence matrix pins:

* a per-worker digest of the full replay transition stream, and one of
  each buffer's full serialised state,
* the loss and mean-final-reward trajectories,
* every live worker's parameter leaves (exact bits), in the reference's
  leaf order (each layer's ``b`` before its ``w``),
* shape-event accounting (``core.jit_stats``): events during warmup vs
  events during the measured episodes (the gate is 0 after warmup).

Two robustness scenario families run on the same runner, as in the
reference (docs/robustness.md):

* crash-resume: ``--ckpt-dir D`` checkpoints the FULL trainer state after
  every episode; ``--kill-at K`` additionally SIGKILLs the process after
  episode K's checkpoint (having first done post-checkpoint work the crash
  destroys); ``--resume`` restores the latest checkpoint and finishes the
  run, treating its first episode back as the warmup window.  The resumed
  report must be BIT-identical (losses, rewards, transition digests,
  replay-state digests, parameter leaves) to a straight-through run, with
  0 shape events after warmup on the resumed process.
* fault injection: ``--faults predict,chem`` arms a seeded FaultPlan
  (property-service timeouts, chem exceptions, pipelined-thread crashes)
  behind a ResilientService retry wrapper.  With faults inside the retry
  budgets the report must be bit-identical to the fault-free run; the
  injected/retry counters in the report prove the faults actually fired.

The mesh (``launch/mesh.py``): ``--nd`` shards out of a pool of
``--device-pool`` devices, as the reference sizes a submesh of its forced
host device pool; ``--nd`` above the pool exits non-zero.  On the CPU the
pool is logical shards of ``cpu`` (default 8, the reference's); on CUDA it
is ``--device-pool`` entries of the ``--device`` card (default ``--nd``),
so every shard of the truth run shares one card.  Identical bits across nd
is the acceptance criterion (``tests/test_torch_multidevice.py``), and a
ragged W pads to the mesh with dead worker slots.

What differs from the reference:

* The reference forces its pool through ``XLA_FLAGS`` before jax
  initialises, so that its nd = 1 and nd = 4 runs share one XLA client
  configuration.  Torch needs no setting before start-up: the pool is only
  the bound on ``--nd`` and the devices the mesh takes.
* ``warmup_compiles`` and ``recompiles_after_warmup`` count shape events:
  eager PyTorch compiles nothing, and what can still change after warmup
  is a capacity-ladder buffer growing or a kernel loaded at first use.
* ``--device`` (default ``cuda``), as every launcher of the port takes.
  On the card every fleet Q dispatch is one launch of the hand-written
  ``packed_qnet_stacked`` kernel.
* ``run_scenario(args, network=None)``: ``network`` is a ``QNetwork``
  holding the weights every worker starts from; None draws the trainer's
  He init from ``--seed``.  The parity tests hand in the reference's own
  initial weights, which ``torch`` cannot draw.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal

import numpy as np

DEFAULT_DEVICE_POOL = 8
MOLS_SMILES = ("C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O",
               "CC1=CC=CC=C1O", "OC1=CC=CC=C1O")


def _transition_digest(buf) -> str:
    """SHA-256 over the buffer's full transition stream, every field that
    the in-process equivalence matrix compares (tests/test_rollout.py)."""
    import numpy as np

    h = hashlib.sha256()
    for t in buf._items:
        h.update(t.state_fp.tobytes())
        h.update(np.float64(t.steps_left_frac).tobytes())
        h.update(np.float64(t.reward).tobytes())
        h.update(b"\x01" if t.done else b"\x00")
        h.update(t.next_fps.tobytes())
        h.update(np.float64(t.next_steps_left_frac).tobytes())
    return h.hexdigest()


def _replay_state_digest(buf) -> str:
    """SHA-256 over the buffer's FULL serialised state: the SoA rings,
    per-slot priorities, cursor (pos/size), max-priority and the sample
    RNG — what the crash-resume matrix must reproduce bit-exactly."""
    import numpy as np

    h = hashlib.sha256()
    for k, v in sorted(buf.state_dict().items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _build_fault_plan(args):
    """Seeded FaultPlan from the --faults site list (None when unarmed)."""
    if not args.faults:
        return None
    from repro_torch.core.faults import FaultPlan, FaultRule
    rules = []
    for site in args.faults.split(","):
        site = site.strip()
        if site == "predict":
            # property-service timeouts on a counter schedule, absorbed by
            # the ResilientService retry budget
            rules.append(FaultRule(site="predict", kind="timeout",
                                   every=args.fault_every,
                                   fail_attempts=args.fault_attempts))
        elif site == "chem":
            # content-keyed transient chem exceptions, retried in place
            rules.append(FaultRule(site="chem", kind="transient",
                                   rate=args.fault_rate,
                                   fail_attempts=args.fault_attempts))
        elif site == "pipeline":
            rules.append(FaultRule(site="pipeline", kind="transient",
                                   every=args.fault_every,
                                   fail_attempts=args.fault_attempts))
        else:
            raise SystemExit(f"FAIL: unknown fault site {site!r}")
    return FaultPlan(rules, seed=args.fault_seed)


def run(args, network=None):
    """Build the trainer, train warmup + measured episodes; return the
    report arrays (see the module docstring) and the trainer."""
    import torch

    from repro_torch.chem.smiles import from_smiles
    from repro_torch.core.agent import DQNConfig, QNetwork
    from repro_torch.core.distributed import DistributedTrainer, TrainerConfig
    from repro_torch.core.jit_stats import RecompileCounter
    from repro_torch.core.rollout import EnvConfig
    from repro_torch.core.reward import RewardConfig
    # the SHARED deterministic property stub (the same class the tier-1
    # test matrices use): identical answers in every process
    from repro_torch.predictors.service import OracleService

    from repro_torch.launch.mesh import make_host_mesh

    pool = _device_pool(args)
    if args.nd > pool:
        raise SystemExit(f"FAIL: --nd {args.nd} > --device-pool {pool}")
    if torch.device(args.device).type == "cpu":
        mesh = make_host_mesh(args.nd, device=args.device)
    else:
        mesh = make_host_mesh(args.nd, pool=[args.device] * pool)

    counter = RecompileCounter.install()
    cfg = TrainerConfig(
        n_workers=args.workers, mols_per_worker=args.mols_per_worker,
        episodes=args.warmup + args.episodes, sync_mode=args.sync,
        rollout=args.rollout, learner=args.learner, chem=args.chem,
        acting=args.acting, replay=args.replay,
        priority_alpha=args.priority_alpha, priority_beta0=args.priority_beta0,
        updates_per_episode=args.updates_per_episode,
        train_batch_size=args.batch_size, max_candidates=args.max_candidates,
        scenarios=(tuple(args.scenarios.split(","))
                   if args.scenarios else None),
        dqn=DQNConfig(epsilon_decay=args.epsilon_decay),
        env=EnvConfig(max_steps=args.max_steps), seed=args.seed)
    need = args.workers * args.mols_per_worker
    mols = [from_smiles(MOLS_SMILES[i % len(MOLS_SMILES)]) for i in range(need)]
    if network is None:
        # the trainer's own default init, at the asked widths
        hidden = tuple(int(h) for h in args.hidden.split(","))
        network = QNetwork(hidden=hidden, device="cpu",
                           generator=torch.Generator().manual_seed(args.seed))

    plan = _build_fault_plan(args)
    service = OracleService()
    if plan is not None:
        # retry wrapper over the deterministic stub; sleep=None makes the
        # (deterministic, capped) backoff a no-op so scenarios stay fast
        from repro_torch.predictors.service import ResilientService, RetryPolicy
        service = ResilientService(service, RetryPolicy(seed=args.fault_seed),
                                   fault_plan=plan, sleep=None)
    tr = DistributedTrainer(cfg, mols, service, RewardConfig(),
                            network=network, fault_plan=plan, mesh=mesh)
    if tr.mesh.size != args.nd or tr.n_padded_workers % args.nd:
        raise SystemExit(f"FAIL: trainer mesh {tr.mesh.size} x "
                         f"{tr.n_padded_workers} workers for --nd {args.nd}")

    mgr = None
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir)
    start_ep = 0
    if args.resume:
        if mgr is None:
            raise SystemExit("FAIL: --resume requires --ckpt-dir")
        start_ep = tr.restore_checkpoint(mgr)

    total = args.warmup + args.episodes

    def run_one() -> None:
        tr.train_episode()
        if mgr is not None and not args.resume:
            # checkpoint cadence: every episode (the writer side of the
            # crash-resume matrix; the resumed side only reads)
            tr.save_checkpoint(mgr)
        if args.kill_at is not None and tr.episode == args.kill_at:
            # post-checkpoint work the crash destroys — resume must
            # reproduce it bit-identically from the last snapshot
            tr.train_episode()
            os.kill(os.getpid(), signal.SIGKILL)

    # a resumed process loads its kernels and grows its buffers afresh, so
    # its first episode back is its warmup window wherever the run stopped
    n_warm = (args.warmup - start_ep) if start_ep < args.warmup \
        else (1 if start_ep < total else 0)
    with counter.window() as warm:
        for _ in range(n_warm):
            run_one()
        # one ladder rung of candidate headroom past the warmup high-water
        # mark, so drift in the measured episodes cannot grow the buffers
        if tr.candidate_capacity:
            tr.reserve_candidates(int(tr.candidate_capacity * 1.3))
    with counter.window() as measured:
        while tr.episode < total:
            run_one()
    tr.close()

    fault_stats = tr.engine.fault_stats()
    out = {
        "n_devices": np.int64(tr.mesh.size),
        "device_pool": np.int64(pool),
        "n_live_workers": np.int64(tr.n_live_workers),
        "n_padded_workers": np.int64(tr.n_padded_workers),
        # the trainer's checkpointed per-episode logs, so a resumed run's
        # report carries the FULL trajectory, pre-crash episodes included
        "losses": np.asarray(tr.loss_log, np.float64),
        "rewards": np.asarray(tr.reward_log, np.float64),
        "warmup_compiles": np.int64(warm.count),
        "recompiles_after_warmup": np.int64(measured.count),
        "transition_digests": np.asarray(
            [_transition_digest(b) for b in tr.buffers]),
        "replay_state_digests": np.asarray(
            [_replay_state_digest(b) for b in tr.buffers]),
        "n_transitions": np.asarray([len(b) for b in tr.buffers], np.int64),
        "n_faults_injected": np.int64(plan.n_injected if plan is not None else 0),
        "n_retries": np.int64(getattr(service, "n_retries", 0)),
        "n_timeouts": np.int64(getattr(service, "n_timeouts", 0)),
        "n_quarantined": np.int64(fault_stats["n_quarantined"]),
        "n_chem_retries": np.int64(fault_stats["n_chem_retries"]),
        "n_pipeline_restarts": np.int64(fault_stats["n_pipeline_restarts"]),
        "n_incidents": np.int64(fault_stats["n_incidents"]),
        "meta": np.asarray(json.dumps(vars(args), sort_keys=True)),
    }
    # exact parameter bits for every live worker, numbered as the
    # reference's ``jax.tree_util.tree_leaves(tr.params)`` numbers them
    leaves, order = tr._ckpt_trees()["params"]
    for i, j in enumerate(order):
        out[f"param_{i}"] = leaves[j].detach().cpu().numpy()[: tr.n_live_workers]
    return out, tr


def _device_pool(args) -> int:
    """``--device-pool``, or its default: 8 logical shards on the CPU (the
    reference's ``DEFAULT_DEVICE_POOL``), ``--nd`` entries of the card on
    CUDA."""
    import torch
    if args.device_pool is not None:
        return args.device_pool
    return DEFAULT_DEVICE_POOL if torch.device(args.device).type == "cpu" \
        else args.nd


def run_scenario(args, network=None) -> dict:
    """The report arrays of one scenario (see ``run``)."""
    return run(args, network)[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="one truth-run scenario (see module docstring)")
    ap.add_argument("--nd", type=int, default=1,
                    help="mesh size: the first nd devices of the pool")
    ap.add_argument("--device-pool", type=int, default=None,
                    help="devices the mesh is cut from (default: 8 logical "
                         "shards on the CPU, --nd entries of the card on "
                         "CUDA); --nd above it exits non-zero")
    ap.add_argument("--out", required=True, help="output .npz report path")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--mols-per-worker", type=int, default=2)
    ap.add_argument("--rollout", default="fleet_sharded")
    ap.add_argument("--learner", default="packed")
    ap.add_argument("--chem", default="incremental")
    ap.add_argument("--acting", default="packed",
                    help="fleet acting representation (core.ACTING_MODES)")
    ap.add_argument("--replay", default="uniform",
                    help="replay sampling (core.REPLAY_MODES); prioritized "
                         "with --priority-alpha 0 must match uniform bit "
                         "for bit — the parity scenarios pin exactly that")
    ap.add_argument("--scenarios", default=None,
                    help="comma list of scenario-registry names cycled "
                         "across workers (configs/scenarios.py); "
                         "homogeneous 'antioxidant' must be bit-identical "
                         "to the default path, and each mixed-fleet "
                         "worker to its solo single-scenario twin")
    ap.add_argument("--priority-alpha", type=float, default=0.6)
    ap.add_argument("--priority-beta0", type=float, default=0.4)
    ap.add_argument("--sync", default="episode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=1,
                    help="episodes before the shape-event window opens")
    ap.add_argument("--episodes", type=int, default=2,
                    help="measured episodes")
    ap.add_argument("--max-steps", type=int, default=3)
    ap.add_argument("--updates-per-episode", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-candidates", type=int, default=16)
    ap.add_argument("--hidden", default="32",
                    help="comma-separated QNetwork hidden sizes")
    ap.add_argument("--epsilon-decay", type=float, default=0.9)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs every kernel's plain "
                         "PyTorch version")
    # crash-resume scenarios (docs/robustness.md)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the full trainer state here after "
                         "every episode")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="SIGKILL the process after episode K's checkpoint "
                         "(plus uncheckpointed post-crash work)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest --ckpt-dir checkpoint and "
                         "finish the run")
    # deterministic fault injection (core.faults.FaultPlan)
    ap.add_argument("--faults", default=None,
                    help="comma list of armed sites: predict,chem,pipeline")
    ap.add_argument("--fault-every", type=int, default=3,
                    help="serial sites: fault every Nth call")
    ap.add_argument("--fault-rate", type=float, default=0.25,
                    help="keyed sites: fraction of molecule keys that fault")
    ap.add_argument("--fault-attempts", type=int, default=1,
                    help="consecutive failures per scheduled call/key "
                         "(> the retry budget makes the fault terminal)")
    ap.add_argument("--fault-seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = run_scenario(args)
    np.savez(args.out, **out)
    print(f"[verify] nd={args.nd} W={args.workers} rollout={args.rollout} "
          f"learner={args.learner} chem={args.chem} acting={args.acting} "
          f"replay={args.replay} sync={args.sync} device={args.device}: "
          f"{int(out['warmup_compiles'])} warmup shape events, "
          f"{int(out['recompiles_after_warmup'])} shape events after warmup, "
          f"{int(out['n_transitions'].sum())} transitions -> {args.out}",
          flush=True)


if __name__ == "__main__":
    main()
