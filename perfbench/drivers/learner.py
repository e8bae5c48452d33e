"""The DA-MolDQN learner alone: ``DistributedTrainer.run_updates`` over
replay buffers filled at set-up.

Traffic parameters: ``workers``, ``mols_per_worker`` and ``pool`` (the
trainer is built over the pool's first workers x mols_per_worker frozen
molecules; the learner never reads them), ``fill_per_worker`` and
``done_share`` (each worker's replay contents, from
``inputs.transition_stream``), ``trace_offset_s`` and ``trace_seconds``.
The window calls ``run_updates(1)`` (one round: one update of every
worker) until its seconds are up; set-up runs the first ``CHECK_ROUNDS``
rounds through the same call, and the reference follows them.  Of the
window's own rounds, every loss has to be finite and every worker has to
have moved (``window_unmoved``)."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from perfbench.harness import inputs, work

CHECK_ROUNDS = 3


def trainer_config(config: dict, traffic: dict, seed: int):
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.distributed import TrainerConfig
    from repro_torch.core.rollout import EnvConfig
    t, d = config["trainer"], config["dqn"]
    return TrainerConfig(
        n_workers=traffic["workers"], mols_per_worker=traffic["mols_per_worker"],
        sync_mode=t["sync_mode"], rollout=t["rollout"], learner=t["learner"],
        acting=t["acting"], chem=t["chem"], replay=t["replay"],
        replay_capacity=t["replay_capacity"],
        updates_per_episode=t["updates_per_episode"],
        train_batch_size=t["train_batch_size"],
        max_candidates=t["max_candidates"],
        dqn=DQNConfig(lr=d["lr"], discount=d["discount"],
                      grad_clip=d["grad_clip"],
                      epsilon_initial=d["epsilon_initial"],
                      epsilon_decay=d["epsilon_decay"]),
        env=EnvConfig(max_steps=config["env"]["max_steps"],
                      max_atoms=config["env"]["max_atoms"]),
        seed=int(seed))


def leaf_norms(tensors) -> np.ndarray:
    """``[L, W]`` per-worker norms of stacked ``[W, ...]`` leaves."""
    return np.stack([t.detach().flatten(1).norm(dim=1).cpu().numpy()
                     for t in tensors])


def unmoved(before: np.ndarray, after: np.ndarray) -> int:
    """How many workers kept every leaf's norm, bit for bit, between two
    ``leaf_norms`` readings ``[L, W]``.  Whole workers are counted: a leaf
    of one element can come back to its norm after a few steps (its sign
    flipped, or a step undone); a worker that took a step moves the norms
    of its large leaves."""
    return int(np.count_nonzero(np.all(before == after, axis=0)))


def reference_cfg(config: dict) -> dict:
    return {**config["trainer"], **config["dqn"]}


class LearnerRun:
    def __init__(self, cell, seed: int, spans, device: str):
        import torch
        from repro_torch.chem.smiles import from_smiles
        from repro_torch.core.agent import QNetwork, flat
        from repro_torch.core.distributed import DistributedTrainer
        from repro_torch.core.replay import Transition
        from repro_torch.core.reward import RewardConfig
        from repro_torch.predictors.service import OracleService

        self.cell, self.seed, self.spans, self.device = cell, seed, spans, device
        cfg, tr = cell.config, cell.traffic
        self.sizes = tuple(cfg["sizes"])
        self.split = {}
        t = time.perf_counter()
        mols = [from_smiles(s) for s in inputs.pool(tr["pool"])
                [: tr["workers"] * tr["mols_per_worker"]]]
        self.weights = inputs.qnet_weights(self.sizes, seed, device)
        self.split["molecules_weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.trainer = DistributedTrainer(
            trainer_config(cfg, tr, seed), mols, OracleService(), RewardConfig(),
            network=QNetwork(self.sizes[1:-1], self.sizes[0],
                             layers=self.weights, device=device),
            device=device)
        self.split["trainer_s"] = time.perf_counter() - t
        t = time.perf_counter()
        C = cfg["trainer"]["max_candidates"]
        self.fill = inputs.replay_fill(seed, tr["workers"], tr["fill_per_worker"],
                                       C, tr["done_share"])
        for buf, trs in zip(self.trainer.buffers, self.fill):
            buf.add_many(Transition(**x) for x in trs)
        self.split["replay_fill_s"] = time.perf_counter() - t
        spans.wrap(self.trainer, "_stacked_sample_packed_np", "learner.sample")
        spans.wrap(self.trainer, "_ship", "learner.ship")
        spans.wrap(self.trainer, "_update_once", "learner.update")

        # the rounds the reference follows, through the window's own call
        t = time.perf_counter()
        self.prog = {"loss": []}
        for r in range(CHECK_ROUNDS):
            self.prog["loss"] += self.trainer.run_updates(1)
            if r == 0:
                b1 = cfg["dqn"]["adam_b1"]
                self.prog["grad_norm"] = leaf_norms(
                    self.trainer.opt_state.mu) / (1.0 - b1)
        p0 = [x for wb in self.weights for x in wb]
        self.prog["change_norm"] = leaf_norms(
            [p - q for p, q in zip(flat(self.trainer.params), p0)])
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["check_rounds_s"] = time.perf_counter() - t

    def window(self, seconds: float, profile) -> dict:
        from repro_torch.core.agent import flat
        tr = self.trainer
        W = tr.n_live_workers
        norms0 = leaf_norms(flat(tr.params))
        rounds, bad, call_s = 0, 0, []
        s0 = dict(self.spans.seconds)
        t0 = time.perf_counter()
        if profile is not None:
            profile.start_window()
        while True:
            if profile is not None:
                profile.poll()
            t = time.perf_counter()
            losses = tr.run_updates(1)
            call_s.append(time.perf_counter() - t)
            bad += sum(not math.isfinite(x) for x in losses)
            rounds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        if profile is not None:
            profile.stop()
        self.window_readings = {
            "window_unmoved": float(unmoved(norms0, leaf_norms(flat(tr.params))))}
        cfg = self.cell.config["trainer"]
        flops = rounds * W * work.learner_update_flops(
            self.sizes, cfg["train_batch_size"], cfg["max_candidates"])
        return {
            "end_to_end": {"train_updates_per_s": rounds * W / elapsed},
            "attempted": rounds * W, "failed": bad * W,
            "detail": {"call_s": call_s},
            "counters": {"window_s": elapsed, "rounds": rounds, "workers": W,
                         "flops": flops,
                         "span_s": {k: v - s0.get(k, 0.0)
                                    for k, v in self.spans.seconds.items()}},
        }

    def release(self) -> None:
        self.trainer.close()
        del self.trainer
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from perfbench.reference.dqn import gaps, learner_reference
        ref = learner_reference(
            self.weights, self.fill, self.seed, reference_cfg(self.cell.config),
            CHECK_ROUNDS, device=self.device)
        return {**gaps(self.prog, ref), **self.window_readings}


def build(cell, seed: int, spans, device: str = "cuda") -> LearnerRun:
    return LearnerRun(cell, seed, spans, device)
