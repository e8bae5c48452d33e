"""Each cell's run with the timed path broken underneath comes out not
correct: the look for a chip is skipped and the rest of a run is driven on
the CPU at a small size (3 learner workers; 4 server slots; 2 trainer
workers of 4 molecules), with the cell's own limits.  One fault for each
that the cell can have: a step that returns its state unchanged (for
every worker, for one worker, and from the window's start), half of the
batch left out, an answer altered where it is produced, a wrong greedy
pick, and in the full loop the episode's sync left out (one chip: no
exchange between chips)."""

import pytest
import torch

import perfbench.run as R
from perfbench.harness.manifest import BENCH, Cell, _json

SEED = 2**31 + 77


def _cell(config, traffic, workload, **over):
    tr = _json(BENCH / "traffic" / f"{traffic}.json")
    tr.update(over)
    return Cell(workload, {"chips": 1}, _json(BENCH / "configs" / f"{config}.json"),
                tr, _json(BENCH / "checks" / f"{workload}.json"),
                [{"name": "setup_s", "unit": "s"}], [])


def learner():
    return _cell("damoldqn-general", "learner512", "general.learner512",
                 workers=3)


def server():
    return _cell("damoldqn-molopt", "closed64", "molopt.closed64",
                 slots=4, clients=4, check_sample=8, warmup_steps=2)


def trainer():
    return _cell("damoldqn-general", "antioxidant256", "general.antioxidant256",
                 workers=2, check_workers=2)


def _run(cell, seconds):
    return R.execute(cell, SEED, seconds, False, "cpu", log=lambda *a: None)


def test_sound_runs_are_correct():
    for cell, s in ((learner(), 0.1), (server(), 2.0), (trainer(), 0.1)):
        res = _run(cell, s)
        assert res["correct"], res["checks"]
        assert res["failed"] == 0


# ---- the learner ------------------------------------------------------- #
def _no_step(self, sh, i, grads):
    """Adam leaves the worker's state as it was."""


def _half_batch(orig):
    def loss(layers, target, batch, discount):
        return orig(layers, target,
                    {k: v[: v.shape[0] // 2] for k, v in batch.items()}, discount)
    return loss


def _loss_altered(orig):
    def scalar(self, loss):
        return orig(self, loss) * 1.001
    return scalar


def _no_step_for_worker_0(orig):
    """One worker of the fleet keeps its state; the others step."""
    def apply_worker(self, sh, i, grads):
        if sh.rows.start + i != 0:
            orig(self, sh, i, grads)
    return apply_worker


def _no_step_in_window(monkeypatch, driver_cls):
    """Every worker keeps its state from the window's first step on: the
    set-up steps the reference follows are sound."""
    import repro_torch.core.distributed as D
    on = []
    orig_apply = D.DistributedTrainer._apply_worker
    orig_window = driver_cls.window

    def apply_worker(self, sh, i, grads):
        if not on:
            orig_apply(self, sh, i, grads)

    def window(self, *a, **k):
        on.append(True)
        return orig_window(self, *a, **k)
    monkeypatch.setattr(D.DistributedTrainer, "_apply_worker", apply_worker)
    monkeypatch.setattr(driver_cls, "window", window)


def _failed(res) -> set[str]:
    return {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("fault", ["state_unchanged", "one_worker_unchanged",
                                   "unchanged_in_window", "half_batch",
                                   "loss_altered"])
def test_learner_faults_are_not_correct(fault, monkeypatch):
    import perfbench.drivers.learner as L
    import repro_torch.core.distributed as D
    if fault == "state_unchanged":
        monkeypatch.setattr(D.DistributedTrainer, "_apply_worker", _no_step)
    elif fault == "one_worker_unchanged":
        monkeypatch.setattr(D.DistributedTrainer, "_apply_worker",
                            _no_step_for_worker_0(D.DistributedTrainer._apply_worker))
    elif fault == "unchanged_in_window":
        _no_step_in_window(monkeypatch, L.LearnerRun)
    elif fault == "half_batch":
        monkeypatch.setattr(D, "dqn_loss", _half_batch(D.dqn_loss))
    else:
        monkeypatch.setattr(D.DistributedTrainer, "_loss_scalar",
                            _loss_altered(D.DistributedTrainer._loss_scalar))
    res = _run(learner(), 0.1)
    assert not res["correct"], res["checks"]
    # each of these is caught by the number that exists for it
    expect = {"one_worker_unchanged": "change_gap_worst",
              "unchanged_in_window": "window_unmoved"}.get(fault)
    assert expect is None or expect in _failed(res), res["checks"]


# ---- the server -------------------------------------------------------- #
def _q_altered(orig):
    def q(layers, x):
        return orig(layers, x) * 1.001
    return q


def _q_half_batch(orig):
    def q(layers, x):
        half = x.shape[0] // 2
        out = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        out[:half] = orig(layers, x[:half])
        return out
    return q


def _state_unchanged(orig):
    def apply_step(self, chosen, props, reward_cfg, buffers):
        before = [(s, s.current) for s, _, _ in chosen]
        out = orig(self, chosen, props, reward_cfg, buffers)
        for s, cur in before:
            s.current = cur
        return out
    return apply_step


def _answer_altered(orig):
    def finalize(self, fl, status, **kw):
        res = orig(self, fl, status, **kw)
        if res.best_reward is not None:
            res.best_reward += 1e-6
        return res
    return finalize


def _runner_up(orig):
    """The greedy choice takes the best candidate below the largest Q."""
    import numpy as np

    def select_action(self, q, worker):
        a = orig(self, q, worker)
        q = np.asarray(q)
        below = np.flatnonzero(q < q.max())
        if q[a] == q.max() and below.size:
            return int(below[np.argmax(q[below])])
        return a
    return select_action


@pytest.mark.parametrize("fault", ["q_altered", "half_batch", "state_unchanged",
                                   "answer_altered", "wrong_pick"])
def test_server_faults_are_not_correct(fault, monkeypatch):
    import repro_torch.core.rollout as RO
    import repro_torch.serving.service as S
    if fault == "wrong_pick":
        monkeypatch.setattr(S._ServePolicy, "select_action",
                            _runner_up(S._ServePolicy.select_action))
    elif fault == "q_altered":
        monkeypatch.setattr(S, "fused_qnet", _q_altered(S.fused_qnet))
    elif fault == "half_batch":
        monkeypatch.setattr(S, "fused_qnet", _q_half_batch(S.fused_qnet))
    elif fault == "state_unchanged":
        monkeypatch.setattr(RO.RolloutEngine, "_apply_step",
                            _state_unchanged(RO.RolloutEngine._apply_step))
    else:
        monkeypatch.setattr(S.MoleculeOptService, "_finalize",
                            _answer_altered(S.MoleculeOptService._finalize))
    res = _run(server(), 2.0)
    assert not res["correct"], res["checks"]
    assert fault != "wrong_pick" or "greedy_gap" in _failed(res), res["checks"]


def test_server_follows_only_the_windows_answers(monkeypatch):
    import perfbench.drivers.serve_closed as SC
    seen = {}
    orig = SC.ServeRun.sample

    def sample(self):
        out = orig(self)
        seen["window"] = {r.request_id for r in self.finished[self.mark:]}
        seen["sample"] = out
        seen["before"] = {r.request_id for r in self.finished[: self.mark]}
        return out
    monkeypatch.setattr(SC.ServeRun, "sample", sample)
    cell = server()
    cell.traffic["warmup_steps"] = 9    # past the longest budget: answers
    res = _run(cell, 2.0)
    assert res["correct"], res["checks"]
    assert seen["before"] and seen["sample"]
    assert set(seen["sample"]) <= seen["window"], seen


# ---- the full training loop ------------------------------------------- #
def _scaled(orig, factor=1.001):
    def f(*a, **k):
        return orig(*a, **k) * factor
    return f


def _no_sync(self):
    """The episode's parameter and moment average is left out."""


def _no_sync_in_window(monkeypatch):
    import perfbench.drivers.episodes as E
    import repro_torch.core.distributed as D
    on = []
    orig_sync, orig_window = D.DistributedTrainer._sync_episode, E.EpisodeRun.window

    def sync(self):
        if not on:
            orig_sync(self)

    def window(self, *a, **k):
        on.append(True)
        return orig_window(self, *a, **k)
    monkeypatch.setattr(D.DistributedTrainer, "_sync_episode", sync)
    monkeypatch.setattr(E.EpisodeRun, "window", window)


@pytest.mark.parametrize("fault", ["state_unchanged", "one_worker_unchanged",
                                   "unchanged_in_window", "half_batch",
                                   "q_altered", "reward_altered",
                                   "sync_left_out", "sync_left_out_in_window"])
def test_trainer_faults_are_not_correct(fault, monkeypatch):
    import perfbench.drivers.episodes as E
    import repro_torch.core.distributed as D
    import repro_torch.core.rollout as RO
    if fault == "state_unchanged":
        monkeypatch.setattr(D.DistributedTrainer, "_apply_worker", _no_step)
    elif fault == "one_worker_unchanged":
        monkeypatch.setattr(D.DistributedTrainer, "_apply_worker",
                            _no_step_for_worker_0(D.DistributedTrainer._apply_worker))
    elif fault == "unchanged_in_window":
        _no_step_in_window(monkeypatch, E.EpisodeRun)
    elif fault == "sync_left_out_in_window":
        _no_sync_in_window(monkeypatch)
    elif fault == "half_batch":
        monkeypatch.setattr(D, "dqn_loss", _half_batch(D.dqn_loss))
    elif fault == "q_altered":
        monkeypatch.setattr(D, "packed_qnet_stacked", _scaled(D.packed_qnet_stacked))
    elif fault == "reward_altered":
        monkeypatch.setattr(RO, "evaluate_rewards", _scaled(RO.evaluate_rewards))
    else:
        monkeypatch.setattr(D.DistributedTrainer, "_sync_episode", _no_sync)
    res = _run(trainer(), 0.1)
    assert not res["correct"], res["checks"]
    expect = {"unchanged_in_window": "window_unmoved",
              "sync_left_out_in_window": "window_sync_gap"}.get(fault)
    assert expect is None or expect in _failed(res), res["checks"]
