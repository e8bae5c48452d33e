"""The full training loop: ``DistributedTrainer.train_episode`` (rollout
of every worker's molecules, the updates, the episode sync) over a frozen
molecule pool, with Eq. 1's bounds taken from the pool.

Traffic parameters: ``workers``, ``mols_per_worker``, ``pool`` (the first
workers x mols_per_worker frozen molecules), ``check_workers`` (how many
workers, drawn from the seed, the reference follows through the first
episode's rollout), ``trace_offset_s`` and ``trace_seconds``.  Set-up
runs the first episode through the window's own call; the reference
follows its rollout for the sampled workers, and its first
``CHECK_ROUNDS`` updates and the sync for every worker.  Of the window's
own episodes, every loss has to be finite, every worker has to have
moved (``window_unmoved``), and every sync has to give the f64
mean of the workers' parameters just before it (``window_sync_gap``,
worked out on the device)."""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from perfbench.drivers.learner import (CHECK_ROUNDS, leaf_norms,
                                       reference_cfg, trainer_config, unmoved)
from perfbench.harness import inputs, work


def replay_rows(buf) -> list[dict]:
    """A copy of a replay buffer's transitions, in slot order, from its
    state dict."""
    d = {k: np.array(v) for k, v in buf.state_dict().items()}
    return [{"state_fp": d["state_bits"][i],
             "steps_left_frac": d["state_frac"][i], "reward": d["rewards"][i],
             "done": bool(d["dones"][i]),
             "next_fps": d["next_bits"][i, : d["next_counts"][i]],
             "next_steps_left_frac": d["next_frac"][i]}
            for i in range(int(d["size"]))]


class EpisodeRun:
    def __init__(self, cell, seed: int, spans, device: str):
        import torch
        from repro_torch.chem.smiles import from_smiles
        from repro_torch.core.agent import QNetwork, flat
        from repro_torch.core.distributed import DistributedTrainer
        from repro_torch.core.reward import RewardConfig
        from repro_torch.data.datasets import dataset_property_table
        from repro_torch.predictors.service import OracleService

        self.cell, self.seed, self.spans, self.device = cell, seed, spans, device
        cfg, tr = cell.config, cell.traffic
        self.sizes = tuple(cfg["sizes"])
        self.split = {}
        t = time.perf_counter()
        self.smiles = inputs.pool(tr["pool"])[: tr["workers"] * tr["mols_per_worker"]]
        mols = [from_smiles(s) for s in self.smiles]
        props = dataset_property_table(mols)
        rc = RewardConfig.from_dataset(props["bde"], props["ip"])
        self.weights = inputs.qnet_weights(self.sizes, seed, device)
        self.split["molecules_weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.trainer = tr_ = DistributedTrainer(
            trainer_config(cfg, tr, seed), mols, OracleService(), rc,
            network=QNetwork(self.sizes[1:-1], self.sizes[0],
                             layers=self.weights, device=device),
            device=device)
        self.split["trainer_s"] = time.perf_counter() - t
        rng = np.random.default_rng([int(seed), 13])
        self.followed = sorted(rng.choice(tr["workers"], tr["check_workers"],
                                          replace=False).tolist())
        self.prog = {"q": {w: [] for w in self.followed}, "loss": []}
        self.checking = True
        self.in_window = False
        self.window_sync = []          # each window episode's sync gap
        self.q_rows, self.q_bound_s, self.rounds = 0, 0.0, 0
        self._wrap()

        t = time.perf_counter()
        self.mol_steps = 0
        tr_.train_episode()                 # the episode the reference follows
        self.checking = False
        self.prog["synced"] = [x[0].cpu().numpy().copy() for x in flat(tr_.params)]
        self.fill = [replay_rows(b) for b in tr_.buffers]
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["check_episode_s"] = time.perf_counter() - t

    def _wrap(self) -> None:
        import torch
        """Spans around the trainer's layers, and, during the first episode,
        the program's outputs the reference judges: the followed workers'
        Q values at every step, each update's loss, the first gradient (from
        Adam's first moment) and the change after ``CHECK_ROUNDS`` rounds."""
        from repro_torch.core.agent import flat
        tr, spans, prog = self.trainer, self.spans, self.prog
        b1 = self.cell.config["dqn"]["adam_b1"]
        p0 = [x for wb in self.weights for x in wb]
        view = tr._fleet_policy
        q_packed, update, run_updates, rollout, sync = (
            view.fleet_q_values_packed, tr._update_once, tr.run_updates,
            tr.rollout_episode, tr._sync_episode)

        def fleet_q_values_packed(bits_pw, frac_pw):
            rows = sum(b.shape[0] for b in bits_pw)
            self.q_rows += rows
            self.q_bound_s += work.packed_dispatch_bound_s(
                self.sizes, rows, len(bits_pw))
            q = q_packed(bits_pw, frac_pw)
            if self.checking:
                for w in self.followed:
                    prog["q"][w].append(np.array(q[w]))
            return q

        def update_once(*a, **k):
            with spans.span("learner.update"):
                out = update(*a, **k)
            self.rounds += 1
            if self.checking:
                if self.rounds == 1:
                    prog["grad_norm"] = leaf_norms(tr.opt_state.mu) / (1.0 - b1)
                if self.rounds == CHECK_ROUNDS:
                    prog["change_norm"] = leaf_norms(
                        [p - q for p, q in zip(flat(tr.params), p0)])
            return out

        def run_updates_(n):
            with spans.span("learner"):
                losses = run_updates(n)
            if self.checking:
                prog["loss"] += losses
            return losses

        def sync_episode():
            if self.checking:     # the workers' parameters the sync averages
                prog["before_sync"] = [x.cpu().numpy().copy()
                                       for x in flat(tr.params)]
            if not self.in_window:
                return sync()
            mean = [x.mean(0, dtype=torch.float64) for x in flat(tr.params)]
            out = sync()
            self.window_sync.append(sync_gap_on_device(
                mean, [x[0] for x in flat(tr.params)], self.episode_start))
            return out

        def rollout_episode():
            if self.in_window:    # every worker holds the last sync's mean
                self.episode_start = [x[0].clone() for x in flat(tr.params)]
            with spans.span("rollout"):
                recs = rollout()
            self.mol_steps += sum(len(r) for r in recs)
            return recs

        view.fleet_q_values_packed = fleet_q_values_packed
        tr._update_once = update_once
        tr.run_updates = run_updates_
        tr.rollout_episode = rollout_episode
        tr._sync_episode = sync_episode
        spans.wrap(tr, "_stacked_sample_packed_np", "learner.sample")
        spans.wrap(tr.engine, "_compute_enum", "chem")

    def _counters(self) -> dict:
        tr = self.trainer
        chem = tr.engine.chem_stats()
        timing = tr.dispatch_timing() or {"dispatches": 0, "h2d_ms": 0.0,
                                          "kernel_ms": 0.0}
        return {"env_steps": tr.engine.n_env_steps, "mol_steps": self.mol_steps,
                "rounds": self.rounds, "q_rows": self.q_rows,
                "chem_s": chem["enum_s"] + chem["fp_s"],
                "dispatch_ms": (timing["h2d_ms"] + timing["kernel_ms"])
                * timing["dispatches"], "dispatches": timing["dispatches"]}

    def window(self, seconds: float, profile) -> dict:
        from repro_torch.core.agent import flat
        tr = self.trainer
        s0, c0 = dict(self.spans.seconds), self._counters()
        norms0 = leaf_norms(flat(tr.params))
        episodes, bad, ep_s = 0, 0, []
        self.in_window = True
        t0 = time.perf_counter()
        if profile is not None:
            profile.probe = lambda: self.q_bound_s
            profile.start_window()
        while True:
            if profile is not None:
                profile.poll()
            t = time.perf_counter()
            st = tr.train_episode()
            ep_s.append(time.perf_counter() - t)
            bad += not math.isfinite(st["loss"])
            episodes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.in_window = False
        trace_bound = None
        if profile is not None:
            profile.stop()
            if profile.probe_off is not None:
                trace_bound = profile.probe_off - profile.probe_on
        self.window_readings = {
            "window_unmoved": float(unmoved(norms0, leaf_norms(flat(tr.params)))),
            "window_sync_gap": max(self.window_sync, default=float("nan"))}
        c1 = self._counters()
        d = {k: c1[k] - c0[k] for k in c1}
        cfg = self.cell.config["trainer"]
        d.update(window_s=elapsed, episodes=episodes, trace_q_bound_s=trace_bound,
                 flops=d["q_rows"] * work.qnet_row_flops(self.sizes)
                 + d["rounds"] * tr.n_live_workers * work.learner_update_flops(
                     self.sizes, cfg["train_batch_size"], cfg["max_candidates"]),
                 span_s={k: v - s0.get(k, 0.0)
                         for k, v in self.spans.seconds.items()})
        return {
            "end_to_end": {"train_mol_steps_per_s": d["mol_steps"] / elapsed},
            "attempted": d["mol_steps"],
            "failed": d["mol_steps"] if bad else 0,
            "detail": {"episode_s": ep_s},
            "counters": d,
        }

    def release(self) -> None:
        self.trainer.close()
        del self.trainer
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def follow(self, tf32_control: bool = False) -> dict:
        """The followed workers' first episodes against the program's Q
        values and replay transitions."""
        from perfbench.reference.episode import (first_episode, reward_bounds,
                                                 transition_mismatches)
        cfg, tr = self.cell.config, self.cell.traffic
        rc = {**cfg["reward"], **reward_bounds(self.smiles)}
        env = {"max_steps": cfg["env"]["max_steps"],
               "max_atoms": cfg["env"]["max_atoms"],
               "epsilon_initial": cfg["dqn"]["epsilon_initial"]}
        k = tr["mols_per_worker"]
        q_gap, ctl_q_gap, mism = 0.0, 0.0, []
        for w in self.followed:
            ref = first_episode(self.smiles[w * k:(w + 1) * k], self.seed, w,
                                self.weights, env, rc, self.device, tf32_control)
            prog_q = self.prog["q"][w]
            if len(prog_q) != len(ref["q"]):
                mism.append(f"worker {w}: {len(prog_q)} Q dispatches, "
                            f"{len(ref['q'])} in the reference")
            for s, (qp, qr) in enumerate(zip(prog_q, ref["q"])):
                if qp.shape != qr.shape:
                    mism.append(f"worker {w} step {s}: {qp.shape[0]} Q rows, "
                                f"{qr.shape[0]} in the reference")
                    continue
                scale = max(float(np.max(np.abs(qr))), 1e-30)
                q_gap = max(q_gap, float(np.max(np.abs(qp - qr))) / scale)
                if tf32_control:
                    ctl_q_gap = max(ctl_q_gap, float(np.max(np.abs(
                        ref["control_q"][s] - qr))) / scale)
            mism += [f"worker {w}: {m}" for m in transition_mismatches(
                self.fill[w], ref["transitions"],
                cfg["trainer"]["max_candidates"])]
        out = {"q_gap": q_gap, "mismatches": float(len(mism)),
               "first_mismatches": mism[:5]}
        if tf32_control:
            out["ctl_q_gap"] = ctl_q_gap
        return out

    def learner_ref(self, **kw) -> dict:
        """Every worker's updates of the first episode and their mean, from
        the program's replay (the rollout that filled it is judged, on the
        followed workers, by ``follow``)."""
        from perfbench.reference.dqn import learner_reference
        return learner_reference(
            self.weights, self.fill, self.seed, reference_cfg(self.cell.config),
            self.cell.config["trainer"]["updates_per_episode"],
            device=self.device, change_at=CHECK_ROUNDS, **kw)

    def sync_readings(self) -> dict:
        """The sync against the mean of the program's own parameters just
        before it (the updates that made them are judged, for every worker,
        by ``learner_ref``'s numbers), and what a sync left out would read
        (worker 0's parameters in place of the mean)."""
        from perfbench.reference.dqn import sync_gap
        p0 = [x.cpu().numpy() for wb in self.weights for x in wb]
        before = self.prog["before_sync"]
        return {"sync_gap": sync_gap(before, self.prog["synced"], p0),
                "sync_left_out_gap": sync_gap(before, [b[0] for b in before], p0)}

    def check(self) -> dict:
        from perfbench.reference.dqn import gaps
        sync = self.sync_readings()
        return {**self.follow(), **gaps(self.prog, self.learner_ref()),
                "sync_gap": sync["sync_gap"], **self.window_readings}


def sync_gap_on_device(mean, after, start) -> float:
    """``reference.dqn.sync_gap`` on the device, for a sync inside the
    window: the workers' f64 mean of each leaf (``mean``) against one
    worker's leaf after the sync (``after``), by the worst leaf, against
    the norm of the mean's change since the episode's start (``start``), of
    that leaf or of the median leaf, whichever is larger."""
    import torch
    gap = torch.stack([(a.double() - m).norm() for a, m in zip(after, mean)])
    change = torch.stack([(m - s.double()).norm() for m, s in zip(mean, start)])
    floor = torch.maximum(change, change.median())
    return float((gap / floor).max())


def build(cell, seed: int, spans, device: str = "cuda") -> EpisodeRun:
    return EpisodeRun(cell, seed, spans, device)
