"""Checkpoint and resume of the port's trainer, the greedy evaluation and
the ``--mode rl`` launcher, on the CPU.

* The port's ``state_dict`` has the reference's keys, shapes and dtypes and
  a byte-equal ``meta/config`` for the same ``TrainerConfig``.
* In the port, a run stopped after K episodes, saved through a
  ``CheckpointManager`` and restored into a fresh trainer ends, at N, with
  every ``state_dict`` key bit-identical to an unbroken N-episode run, in
  four cells: uniform replay, prioritized replay, a dataset stream and a
  two-scenario fleet.
* Across the packages: a checkpoint written by the reference
  (``rollout="fleet_sharded"``; its ``"fleet"`` raises under this jax,
  ROADMAP C0) continues in the port, and the reverse, at epsilon 1 with
  ``OracleService``.  Replay transitions, reward and start logs are
  bit-identical to the writer's own continued run; losses within 1e-5
  (rel), the tolerance ``tests/test_torch_train.py`` holds whole runs to.
* ``greedy_optimize`` and ``optimization_failure_rate`` from the same Q
  parameters give the reference's final molecules, BDE, IP and OFR.
* The launcher: a 3-episode run cut after its second episode's
  checkpoint and resumed prints the unbroken run's reward, loss and OFR
  lines.
"""

import io
import json
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.chem.smiles import (canonical_smiles as jax_canonical,
                               from_smiles as jax_from_smiles)
from repro.core import (DQNConfig as JaxDQNConfig, EnvConfig as JaxEnvConfig,
                        RewardConfig as JaxRewardConfig,
                        TrainerConfig as JaxTrainerConfig)
from repro.core.agent import DQNAgent as JaxAgent, QNetwork as JaxQNetwork
from repro.core.distributed import (DistributedTrainer as JaxTrainer,
                                    greedy_optimize as jax_greedy,
                                    optimization_failure_rate as jax_ofr)
from repro.data.datasets import antioxidant_dataset as jax_dataset
from repro.predictors.service import OracleService as JaxOracle
from repro_torch.checkpoint import CheckpointError, CheckpointManager, save_pytree
from repro_torch.chem.smiles import canonical_smiles, from_smiles
from repro_torch.core import (DQNConfig, EnvConfig, RewardConfig, TrainerConfig,
                              greedy_optimize, optimization_failure_rate)
from repro_torch.core.agent import DQNAgent, QNetwork, params_from_jax
from repro_torch.core.distributed import DistributedTrainer
from repro_torch.data.datasets import antioxidant_dataset
from repro_torch.kernels.fused_qnet import ops as fused_ops
from repro_torch.predictors import gnn, ip_net
from repro_torch.predictors.service import OracleService

SMILES = ("C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O", "CC1=CC=CC=C1O",
          "OC1=CC=CC=C1O")
NARROW = (32, 16, 8, 4)
TOL = 1e-5


def _base(**over):
    base = dict(n_workers=2, mols_per_worker=2, episodes=3,
                updates_per_episode=2, train_batch_size=4, max_candidates=16,
                seed=0)
    base.update(over)
    return base


def _narrow_layers():
    g = torch.Generator().manual_seed(3)
    sizes = (2049,) + NARROW + (1,)
    return [(torch.randn(i, o, generator=g) * (2.0 / i) ** 0.5,
             0.1 * torch.randn(o, generator=g)) for i, o in zip(sizes[:-1], sizes[1:])]


def _port(cell="uniform", epsilon=0.3, **over) -> DistributedTrainer:
    kw = {"uniform": {}, "prioritized": dict(replay="prioritized"),
          "dataset": dict(dataset="antioxidant"),
          "scenarios": dict(scenarios=("antioxidant", "qed"))}[cell]
    cfg = TrainerConfig(env=EnvConfig(max_steps=3),
                        dqn=DQNConfig(epsilon_initial=epsilon, epsilon_decay=0.9),
                        **_base(**kw, **over))
    mols = None if cell == "dataset" else [from_smiles(s) for s in SMILES]
    return DistributedTrainer(
        cfg, mols, OracleService(), RewardConfig(),
        network=QNetwork(hidden=NARROW, device="cpu", layers=_narrow_layers()),
        dataset_pool=antioxidant_dataset(count=12) if cell == "dataset" else None,
        device="cpu")


def _assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


# ------------------------------------------------------------------ #
# layout against the reference
# ------------------------------------------------------------------ #
def _pair_configs(**over):
    """One configuration in both packages: reference ``fleet_sharded``
    (the port runs it as ``fleet`` on one device), epsilon 1 throughout."""
    kw = _base(rollout="fleet_sharded", episodes=2, **over)
    jcfg = JaxTrainerConfig(env=JaxEnvConfig(max_steps=3),
                            dqn=JaxDQNConfig(epsilon_initial=1.0,
                                             epsilon_decay=1.0), **kw)
    tcfg = TrainerConfig(env=EnvConfig(max_steps=3),
                         dqn=DQNConfig(epsilon_initial=1.0, epsilon_decay=1.0),
                         **kw)
    return jcfg, tcfg


def _jax_trainer(jcfg, hidden=(32,)):
    return JaxTrainer(jcfg, [jax_from_smiles(s) for s in SMILES], JaxOracle(),
                      JaxRewardConfig(), network=JaxQNetwork(hidden=hidden))


def _port_from(jt, tcfg):
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jt.params)
    return DistributedTrainer(tcfg, [from_smiles(s) for s in SMILES],
                              OracleService(), RewardConfig(),
                              network=params_from_jax(p0, device="cpu"),
                              device="cpu")


def test_state_dict_has_the_reference_layout():
    """Before any episode both states are bit-identical, key for key (so
    ``params/0`` is layer 0's ``b``: the reference's sorted leaf order).
    After an episode with two updates: the same keys, shapes, dtypes and
    ``meta/config`` bytes; host state bit-identical; device trees within
    1e-5."""
    jcfg, tcfg = _pair_configs(train_batch_size=2)
    jt = _jax_trainer(jcfg)
    tt = _port_from(jt, tcfg)
    assert tt._config_fingerprint().encode() == jt._config_fingerprint().encode()
    want0 = {k: np.asarray(v).copy() for k, v in jt.state_dict().items()}
    _assert_same_state(tt.state_dict(), want0)   # before any episode: all bits
    jt.train_episode()
    tt.train_episode()
    assert tt.n_updates == jt.n_updates > 0
    want, got = jt.state_dict(), tt.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
    assert got["meta/config"].tobytes() == want["meta/config"].tobytes()
    assert got["params/0"].shape == (2, 32) and got["params/1"].shape == (2, 2049, 32)
    assert got["opt/0"].tolist() == np.asarray(want["opt/0"]).tolist() == [2, 2]
    for k in want:
        if k.split("/")[0] in ("rng", "replay", "dataset") or k in (
                "meta/episode", "meta/epsilon", "meta/n_updates",
                "meta/reward_log", "meta/start_log"):
            assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k
        elif k.split("/")[0] in ("params", "target", "opt"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ #
# in-port stop and resume
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("cell", ["uniform", "prioritized", "dataset", "scenarios"])
def test_resume_is_bit_identical_to_an_unbroken_run(tmp_path, cell):
    """Episodes 1..3 unbroken against 1 episode, a checkpoint, a FRESH
    trainer restored from it, and episodes 2..3; at epsilon 0.3 Q decides
    most actions, so the parameters steer the continued transitions."""
    unbroken = _port(cell)
    unbroken.train(3)
    unbroken.close()
    first = _port(cell)
    first.train(1)
    mgr = CheckpointManager(str(tmp_path))
    first.save_checkpoint(mgr)
    first.close()
    resumed = _port(cell)
    assert resumed.restore_checkpoint(mgr) == 1
    resumed.train(2)
    resumed.close()
    assert resumed.n_updates == unbroken.n_updates > 0
    _assert_same_state(resumed.state_dict(), unbroken.state_dict())
    if cell == "dataset":
        assert len(resumed.start_log) == 3
    for w, b in zip(resumed.params, unbroken.params):
        assert torch.equal(w[0], b[0]) and w[0].is_contiguous()


def test_a_different_config_is_refused(tmp_path):
    tt = _port()
    tt.train(1)
    mgr = CheckpointManager(str(tmp_path))
    tt.save_checkpoint(mgr)
    other = _port(updates_per_episode=3)
    with pytest.raises(CheckpointError, match="different TrainerConfig"):
        other.restore_checkpoint(mgr)
    with pytest.raises(CheckpointError, match="missing leaf"):
        state = tt.state_dict()
        del state["opt/3"]
        _port().load_state_dict(state)


# ------------------------------------------------------------------ #
# across the packages
# ------------------------------------------------------------------ #
def _transitions(buffers):
    return [[getattr(b, k).tobytes() for k in
             ("_state_bits", "_state_frac", "_rewards", "_dones", "_next_bits",
              "_next_frac", "_next_counts", "_priorities")] + [b._pos]
            for b in buffers]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_hand_off_between_the_packages(tmp_path, writer):
    """One package trains an episode and checkpoints; the other restores
    that file and trains the second episode; the writer trains its second
    episode too.  The two continued runs match."""
    jcfg, tcfg = _pair_configs()
    jt = _jax_trainer(jcfg)
    tt = _port_from(jt, tcfg)
    src, dst = (jt, tt) if writer == "reference" else (tt, jt)
    src.train_episode()
    mgr = (JaxManager if writer == "reference" else CheckpointManager)(str(tmp_path))
    src.save_checkpoint(mgr)
    assert dst.restore_checkpoint(mgr) == 1
    src.train_episode()
    dst.train_episode()
    assert jt.n_updates == tt.n_updates == 4
    assert _transitions(tt.buffers) == _transitions(jt.buffers)
    assert tt.reward_log == jt.reward_log and tt.start_log == jt.start_log
    assert all(np.isfinite(tt.loss_log))
    np.testing.assert_allclose(tt.loss_log, jt.loss_log, rtol=TOL)
    for k, v in jt.state_dict().items():
        if k.startswith(("rng/", "replay/")):
            assert tt.state_dict()[k].tobytes() == np.asarray(v).tobytes(), k


def test_greedy_optimize_and_ofr_match_the_reference():
    """The same Q parameters (the reference's init at full width) at
    epsilon 0 over the oracle: the same final molecules, BDE, IP and OFR,
    with every greedy decision's Q within 1e-5 of the reference's."""
    jnet = JaxQNetwork()
    jagent = JaxAgent(JaxDQNConfig(epsilon_initial=0.0), seed=0, network=jnet)
    p = jax.tree_util.tree_map(np.asarray, jagent.params)
    agent = DQNAgent(DQNConfig(epsilon_initial=0.0), network=params_from_jax(p, device="cpu"),
                     device="cpu")
    mols = [s for s in SMILES] + ["CC(C)(C)C1=CC=CC=C1O", "OC1=CC=C(O)C=C1"]
    fused_ops.fused_qnet.launches = 0
    want = jax_greedy(jagent, [jax_from_smiles(s) for s in mols], JaxOracle(),
                      JaxRewardConfig(), JaxEnvConfig(max_steps=4))
    got = greedy_optimize(agent, [from_smiles(s) for s in mols], OracleService(),
                          RewardConfig(), EnvConfig(max_steps=4))
    assert agent.n_q_dispatches == 4 and fused_ops.fused_qnet.launches == 0
    assert len(got) == len(want) == len(mols)
    assert [canonical_smiles(r.molecule) for r in got] == \
        [jax_canonical(r.molecule) for r in want]
    assert [(r.bde, r.ip, r.done) for r in got] == [(r.bde, r.ip, r.done) for r in want]
    assert optimization_failure_rate(got) == jax_ofr(want)
    assert optimization_failure_rate([]) == 1.0
    assert optimization_failure_rate(got, bde_max=1e9, ip_min=-1e9) == \
        jax_ofr(want, bde_max=1e9, ip_min=-1e9)


# ------------------------------------------------------------------ #
# the launcher, in process
# ------------------------------------------------------------------ #
@pytest.fixture
def predictor_cache(tmp_path, monkeypatch):
    """A cache of random predictors at the launcher's widths, in the
    reference's format, as the port's default."""
    from repro_torch.predictors import training
    d = tmp_path / "predictors"
    d.mkdir()
    g = torch.Generator().manual_seed(0)
    save_pytree(str(d / "alfabet_s.npz"),
                gnn.params_to_numpy(gnn.AlfabetS(generator=g, device="cpu")))
    save_pytree(str(d / "aimnet_s.npz"),
                ip_net.params_to_numpy(ip_net.AIMNetS(generator=g, device="cpu")))
    (d / "metrics.json").write_text(json.dumps({"bde": {}, "ip": {}}))
    monkeypatch.setattr(training, "DEFAULT_CACHE_DIR", str(d))
    return d


class _Cut(Exception):
    """Stands for the process dying right after a checkpoint write."""


def _launch(args, cut_after=None, monkeypatch=None):
    from repro_torch.launch import train as launcher
    if cut_after is not None:
        save = DistributedTrainer.save_checkpoint

        def save_then_die(self, mgr, step=None):
            label = save(self, mgr, step)
            if self.episode == cut_after:
                raise _Cut
            return label
        monkeypatch.setattr(DistributedTrainer, "save_checkpoint", save_then_die)
    out = io.StringIO()
    with redirect_stdout(out):
        try:
            launcher.main(args)
        except _Cut:
            pass
    if cut_after is not None:
        monkeypatch.setattr(DistributedTrainer, "save_checkpoint", save)
    # the episode line's wall seconds are the one field that may differ
    return [re.sub(r"\(\d+s\)", "", l) for l in out.getvalue().splitlines()]


def test_launcher_resume_prints_the_unbroken_run(tmp_path, predictor_cache, monkeypatch):
    """``--episodes 3 --ckpt-every 1`` cut right after episode 2's
    checkpoint, then ``--resume``: the unbroken run's episode-3 reward and
    loss line and OFR.  The cache hit rate differs: the property cache is a
    memo, not checkpointed state.  The config fingerprint holds
    ``episodes``, as the reference's does, so ``--episodes 2`` then
    ``--resume --episodes 3`` is refused in both packages."""
    common = ["--device", "cpu", "--workers", "2", "--mols-per-worker", "2",
              "--ckpt-every", "1"]
    full = _launch(common + ["--episodes", "3", "--ckpt-dir", str(tmp_path / "a")])
    cut = _launch(common + ["--episodes", "3", "--ckpt-dir", str(tmp_path / "b")],
                  cut_after=2, monkeypatch=monkeypatch)
    assert cut == []
    assert sorted(os.listdir(tmp_path / "b")) == ["LATEST", "ckpt_1.npz", "ckpt_2.npz"]
    resumed = _launch(common + ["--episodes", "3", "--resume",
                                "--ckpt-dir", str(tmp_path / "b")])
    assert resumed[0].startswith("resumed from episode 2")
    assert resumed[1:3] == full[:2]
    assert [l.split()[0] for l in full] == ["[ep", "train-set", "cache"]
    assert resumed[3].startswith("cache hit rate")
    assert "OFR" in full[1]
    with pytest.raises(CheckpointError, match="different TrainerConfig"):
        _launch(common + ["--episodes", "4", "--resume", "--ckpt-dir", str(tmp_path / "b")])


def test_launcher_lm_mode_names_its_roadmap_item(capsys):
    """ROADMAP A6a (the LM training step) is done: ``--mode lm`` trains
    and prints the reference's final JSON instead of naming the item."""
    from repro_torch.launch import train as launcher
    launcher.main(["--mode", "lm", "--reduced", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "A6a" not in out
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 2
    assert launcher.parser().parse_args([]).device == "cuda"
    assert launcher.parser().parse_args([]).ckpt_dir == ".cache/rl_ckpt_torch"
