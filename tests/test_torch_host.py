"""The port's copies of the NumPy host layer give the reference's answers
bit for bit: chemistry, fingerprints, oracles, rewards and the rollout
engine's transition stream."""

from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest

from repro.serving.stream import DEFAULT_POOL
from repro_torch.serving.stream import DEFAULT_POOL as TORCH_POOL


def _package(root: str) -> SimpleNamespace:
    mod = lambda name: import_module(f"{root}.{name}")
    return SimpleNamespace(
        chem=mod("chem"), fingerprint=mod("chem.fingerprint"),
        rollout=mod("core.rollout"), replay=mod("core.replay"),
        reward=mod("core.reward"), scenarios=mod("configs.scenarios"),
        oracle=mod("predictors.service").OracleService)


J, T = _package("repro"), _package("repro_torch")
EXTRA = ("C", "CCO", "C1=CC=CC=C1", "OC1=CC(O)=CC(O)=C1", "CC(C)(C)C1=CC=CC=C1O",
         "NC1=CC=C(O)C=C1")
POOL = DEFAULT_POOL + EXTRA


def test_request_pool_is_the_same():
    assert TORCH_POOL == DEFAULT_POOL


@pytest.mark.parametrize("smiles", POOL)
def test_chemistry_is_identical(smiles):
    jm, tm = J.chem.from_smiles(smiles), T.chem.from_smiles(smiles)
    assert T.chem.canonical_smiles(tm) == J.chem.canonical_smiles(jm)
    ja, ta = J.chem.enumerate_actions(jm), T.chem.enumerate_actions(tm)
    assert [(a.kind, a.detail) for a in ta] == [(a.kind, a.detail) for a in ja]
    assert [T.chem.canonical_smiles(a.result) for a in ta] == \
        [J.chem.canonical_smiles(a.result) for a in ja]
    jfp = J.fingerprint.batch_morgan_fingerprints([a.result for a in ja])
    tfp = T.fingerprint.batch_morgan_fingerprints([a.result for a in ta])
    assert tfp.dtype == jfp.dtype and tfp.tobytes() == jfp.tobytes()
    assert T.fingerprint.pack_fps(tfp).tobytes() == \
        J.fingerprint.pack_fps(jfp).tobytes()
    assert T.chem.morgan_fingerprint(tm).tobytes() == \
        J.chem.morgan_fingerprint(jm).tobytes()
    assert T.chem.oracle_bde(tm) == J.chem.oracle_bde(jm)
    assert T.chem.oracle_ip(tm) == J.chem.oracle_ip(jm)
    assert T.chem.has_valid_conformer(tm) == J.chem.has_valid_conformer(jm)


def _reward_rows(pkg):
    initials, currents, steps = [], [], []
    for i, s in enumerate(POOL):
        m = pkg.chem.from_smiles(s)
        for j, a in enumerate(pkg.chem.enumerate_actions(m)[:6]):
            initials.append(m)
            currents.append(a.result)
            steps.append((i + j) % 11)
    return pkg.oracle().predict(currents), initials, currents, np.asarray(steps)


def test_scenario_registry_is_the_same():
    assert T.scenarios.list_scenarios() == J.scenarios.list_scenarios()


@pytest.mark.parametrize("name", J.scenarios.list_scenarios())
def test_rewards_are_identical(name):
    want = J.scenarios.get_scenario(name).compile().evaluate(*_reward_rows(J))
    got = T.scenarios.get_scenario(name).compile().evaluate(*_reward_rows(T))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_eq1_rewards_are_identical():
    want = J.reward.evaluate_rewards(J.reward.RewardConfig(), *_reward_rows(J))
    got = T.reward.evaluate_rewards(T.reward.RewardConfig(), *_reward_rows(T))
    assert got.tobytes() == want.tobytes()


class _RandomPolicy:
    """epsilon = 1: every action is a uniform draw from the worker's own
    numpy stream, so the transition stream does not read Q at all."""

    def __init__(self, n_workers, seed):
        self.rngs = [np.random.default_rng([seed, w]) for w in range(n_workers)]

    def fleet_q_values(self, per_worker):
        return [np.zeros(x.shape[0], np.float32) for x in per_worker]

    def select_action(self, q, worker):
        self.rngs[worker].random()
        return int(self.rngs[worker].integers(0, q.shape[0]))


def _run_engine(pkg, mode, max_steps=6):
    starts = [[pkg.chem.from_smiles(s) for s in POOL[w::3][:2]]
              for w in range(3)]
    eng = pkg.rollout.RolloutEngine(
        starts, pkg.rollout.EnvConfig(max_steps=max_steps), chem=mode)
    bufs = [pkg.replay.ReplayBuffer(capacity=64, seed=w) for w in range(3)]
    pol, oracle, cfg = _RandomPolicy(3, seed=7), pkg.oracle(), \
        pkg.reward.RewardConfig()
    trail = []
    while not eng.done:
        for r in eng.step(pol, oracle, cfg, bufs):
            trail.append((r.worker, r.slot, pkg.chem.canonical_smiles(r.molecule),
                          np.float64(r.reward).tobytes(), r.done,
                          r.conformer_valid, r.bde, r.ip))
    items = [[(t.state_fp.tobytes(), t.steps_left_frac, t.reward, t.done,
               t.next_fps.tobytes(), t.next_steps_left_frac) for t in b._items]
             for b in bufs]
    return trail, items, eng.n_env_steps, oracle.n_calls


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_rollout_engine_transitions_are_identical(mode):
    want = _run_engine(J, mode)
    got = _run_engine(T, mode)
    assert len(want[0]) > 0 and sum(len(b) for b in want[1]) > 0
    assert got == want


def test_replay_checkpoint_waits_for_training_slice():
    buf = T.replay.ReplayBuffer(capacity=4)
    with pytest.raises(NotImplementedError, match="training slice"):
        buf.state_dict()
    with pytest.raises(NotImplementedError, match="training slice"):
        buf.load_state_dict({})
