"""The training slice: the port's Adam, double-DQN learner and
``DistributedTrainer`` against the JAX reference, on the CPU.

Both trainers get the same start molecules, the same deterministic
``OracleService`` and the same initial parameters (the reference's own
worker-0 tree, carried over as numpy).  The reference runs
``rollout="fleet_sharded"``: its unsharded ``"fleet"`` jit raises jax's
vmap sharding error under this jax (ROADMAP C0), and the reference pins
the two transition-identical.

Tolerances, and why:

* Host-side results are bit-identical: at epsilon = 1 actions do not read
  Q, so every replay transition, ``reward_log`` and ``start_log`` must
  match bit for bit.
* Adam alone, fed the same gradients, matches within 1e-6 of the
  learning rate on the updates, 1e-6 of each moment's largest entry on
  the moments, and 1e-6 (abs)
  on the parameters: the frameworks sum the global norm in different
  orders, and a last-bit change in the clip scale is amplified where
  ``b1 * m + (1 - b1) * g`` cancels.
* One update (loss, |TD|, first moments = 0.1 x clipped gradients, and
  parameters) matches within 1e-5 at the narrow width
  ``tests/test_learner.py`` uses.  Each side sums its products in its own
  order in float32.
* A whole run's ``loss_log`` matches within 1e-5 (rel): losses are
  float64 means of float32 Huber terms computed on parameters that have
  drifted by those last bits.
* Greedy actions at epsilon = 0.05 match wherever the top-two Q gap
  exceeds 2e-5, the rule the serving slice uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chem.smiles import from_smiles as jax_from_smiles
from repro.core import (DQNConfig as JaxDQNConfig, EnvConfig as JaxEnvConfig,
                        RewardConfig as JaxRewardConfig,
                        TrainerConfig as JaxTrainerConfig)
from repro.core.agent import DQNAgent as JaxAgent, QNetwork as JaxQNetwork
from repro.core.agent import huber as jax_huber
from repro.core.distributed import DistributedTrainer as JaxTrainer
from repro.data.datasets import antioxidant_dataset as jax_dataset
from repro.optim import adam as jax_adam
from repro.optim.adam import global_norm as jax_global_norm
from repro.predictors.service import OracleService as JaxOracle
from repro_torch.chem.smiles import from_smiles
from repro_torch.core import (DQNConfig, EnvConfig, RewardConfig,
                              TrainerConfig)
from repro_torch.core.agent import (DQNAgent, QNetwork, flat, huber,
                                    params_from_jax,
                                    stacked_params_from_jax,
                                    stacked_params_to_numpy)
from repro_torch.core.distributed import (ACTING_MODES, LEARNER_MODES,
                                          DistributedTrainer)
from repro_torch.data.datasets import antioxidant_dataset
from repro_torch.kernels.fused_qnet import ops as fused_ops
from repro_torch.kernels.packed_qnet import ops as packed_ops
from repro_torch.optim.adam import (OptState, adam, apply_updates,
                                    clip_by_global_norm, global_norm)
from repro_torch.predictors.service import OracleService

SMILES = ("C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O", "CC1=CC=CC=C1O",
          "OC1=CC=CC=C1O")
NARROW = (32,)
TOL = 1e-5
GAP = 2e-5


# ------------------------------------------------------------------ #
# Adam and Huber on their own
# ------------------------------------------------------------------ #
def _tree(arrs):
    return {"layers": [{"w": arrs[i], "b": arrs[i + 1]}
                       for i in range(0, len(arrs), 2)]}


def _leaves(tree):
    return [np.asarray(l[k]) for l in tree["layers"] for k in ("w", "b")]


@pytest.mark.parametrize("scale", [50.0, 0.1], ids=["clipped", "unclipped"])
def test_adam_matches_the_reference_over_three_steps(scale):
    """Three steps on the reference's gradients, fed as numpy: step > 1
    exercises the f32 bias corrections, scale 50 the global-norm clip."""
    rng = np.random.default_rng(1)
    shapes = [(7, 5), (5,), (5, 1), (1,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    lr = 1e-3
    jopt, topt = jax_adam(lr, clip_norm=10.0), adam(lr, clip_norm=10.0)
    jp = _tree([jnp.asarray(p) for p in params])
    js = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    for g in grads:
        norm = float(global_norm([torch.from_numpy(x) for x in g]))
        assert (norm > 10.0) == (scale > 1.0)
        np.testing.assert_allclose(
            norm, float(jax_global_norm(_tree(g))), rtol=1e-6)
        ju, js = jopt.update(_tree([jnp.asarray(x) for x in g]), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tu, ts = topt.update([torch.from_numpy(x) for x in g], ts, tp)
        tp = apply_updates(tp, tu)
        for a, b in zip(_leaves(ju), tu):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6 * lr)
        for a, b in zip(_leaves(jp), tp):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
        for a, b in zip(_leaves(js.mu) + _leaves(js.nu), ts.mu + ts.nu):
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
    clipped = clip_by_global_norm([torch.ones(4) * 10.0], 1.0)
    np.testing.assert_allclose(clipped[0].numpy(), np.full(4, 0.5), rtol=1e-6)


def test_huber_is_bit_identical_to_the_reference():
    x = np.random.default_rng(2).standard_normal(64).astype(np.float32) * 3
    got = huber(torch.from_numpy(x)).numpy()
    assert got.tobytes() == np.asarray(jax_huber(jnp.asarray(x))).tobytes()


# ------------------------------------------------------------------ #
# trainer pairs
# ------------------------------------------------------------------ #
def _pair(hidden=NARROW, *, n_workers=2, dataset=False, port_rollout="fleet",
          epsilon=1.0, **cfg):
    """A reference ``fleet_sharded`` trainer and a port trainer on the CPU
    with the same configuration and initial parameters."""
    base = dict(n_workers=n_workers, mols_per_worker=2, episodes=2,
                updates_per_episode=3, train_batch_size=4, max_candidates=16,
                seed=0)
    base.update(cfg)
    if dataset:
        base.update(dataset="antioxidant")
    jcfg = JaxTrainerConfig(rollout="fleet_sharded", env=JaxEnvConfig(max_steps=3),
                            dqn=JaxDQNConfig(epsilon_initial=epsilon,
                                             epsilon_decay=0.9), **base)
    tcfg = TrainerConfig(rollout=port_rollout, env=EnvConfig(max_steps=3),
                         dqn=DQNConfig(epsilon_initial=epsilon,
                                       epsilon_decay=0.9), **base)
    need = n_workers * 2
    smiles = (SMILES * need)[:need]
    jmols = None if dataset else [jax_from_smiles(s) for s in smiles]
    tmols = None if dataset else [from_smiles(s) for s in smiles]
    jnet = JaxQNetwork() if hidden is None else JaxQNetwork(hidden=hidden)
    jt = JaxTrainer(jcfg, jmols, JaxOracle(), JaxRewardConfig(), network=jnet,
                    dataset_pool=jax_dataset(count=12) if dataset else None)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jt.params)
    tt = DistributedTrainer(tcfg, tmols, OracleService(), RewardConfig(),
                            network=params_from_jax(p0, device="cpu"),
                            dataset_pool=antioxidant_dataset(count=12)
                            if dataset else None, device="cpu")
    return jt, tt


_BUFFER_FIELDS = ("_state_bits", "_state_frac", "_rewards", "_dones",
                  "_next_bits", "_next_frac", "_next_counts", "_priorities")


def _assert_same_buffers(ja, tb):
    for b1, b2 in zip(ja, tb):
        assert len(b1) == len(b2) > 0 and b1._pos == b2._pos
        for k in _BUFFER_FIELDS:
            assert getattr(b1, k).tobytes() == getattr(b2, k).tobytes(), k


def _port_params(tt):
    return [t.numpy().tobytes() for t in flat(tt.params)]


def _assert_params_close(jt, tt, tol):
    tree, _ = stacked_params_to_numpy(tt.params)
    for a, b in zip(jax.device_get(jt.params)["layers"], tree["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(b[k], np.asarray(a[k]), atol=tol, rtol=tol)


def test_stacked_params_carry_over_bit_for_bit():
    jt, tt = _pair(n_workers=3)
    layers, opt = stacked_params_from_jax(jax.device_get(jt.params),
                                          jax.device_get(jt.opt_state),
                                          device="cpu")
    tree, opt_np = stacked_params_to_numpy(layers, opt)
    for a, b in zip(jax.device_get(jt.params)["layers"], tree["layers"]):
        for k in ("w", "b"):
            assert b[k].shape[0] == 3 and b[k].tobytes() == np.asarray(a[k]).tobytes()
    assert opt_np["step"].tolist() == [0, 0, 0]
    assert [t.numpy().tobytes() for t in flat(layers)] == _port_params(tt)
    assert opt.step.dtype == torch.int32 and tt.opt_state.step.shape == (3,)


@pytest.mark.parametrize("sync_mode", ["episode", "step"])
def test_one_update_matches_the_reference(sync_mode):
    """Both learners take the same packed host batch.  After one step from
    zero moments, mu = 0.1 x the clipped gradient (step mode: of the
    fleet mean), so mu holds the gradients to compare."""
    jt, tt = _pair(sync_mode=sync_mode)
    jt.rollout_episode()
    host = jt._stacked_sample_packed_np()
    jloss, jtd = jt._update_once(jt._ship(host), packed=True)
    tloss, ttd = tt._update_once(tt._ship(host), packed=True)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=TOL, atol=TOL)
    _assert_params_close(jt, tt, TOL)
    jmu = jax.device_get(jt.opt_state.mu)["layers"]
    for (w, b), l in zip(zip(tt.opt_state.mu[::2], tt.opt_state.mu[1::2]), jmu):
        for got, want in ((w, l["w"]), (b, l["b"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=1e-7)
    assert tt.opt_state.step.tolist() == [1, 1]
    if sync_mode == "step":      # one mean update: workers stay replicated
        for t in flat(tt.params):
            assert torch.equal(t[0], t[1])


@pytest.mark.parametrize("case", ["fixed", "dataset", "scenarios"])
def test_trainer_matches_the_reference_at_epsilon_one(case):
    """Two whole episodes: the fixed batch at full width, the dataset
    stream and a scenario fleet at the narrow width."""
    kw = {"fixed": dict(hidden=None), "dataset": dict(dataset=True),
          "scenarios": dict(scenarios=("antioxidant", "qed"))}[case]
    jt, tt = _pair(**kw)
    for _ in range(2):
        jt.train_episode()
        tt.train_episode()
    _assert_same_buffers(jt.buffers, tt.buffers)
    assert tt.reward_log == jt.reward_log
    assert tt.start_log == jt.start_log
    assert (len(tt.start_log) == 2) == (case == "dataset")
    assert np.isfinite(tt.loss_log[-1])
    np.testing.assert_allclose(tt.loss_log, jt.loss_log, rtol=TOL)
    assert tt.n_updates == jt.n_updates == 6
    assert tt.n_q_dispatches == jt.n_q_dispatches
    assert tt.acting_h2d_bytes == jt.acting_h2d_bytes
    assert tt.h2d_update_bytes == jt.h2d_update_bytes


def test_greedy_actions_match_where_the_gap_is_clear():
    """Episode 0 at epsilon 0.05, full width: every greedy decision sees
    Q within 1e-5 of the reference's and picks the same candidate when
    the top-two gap exceeds 2e-5; a closer call ends the comparison,
    since the runs may part there."""
    jt, tt = _pair(hidden=None, epsilon=0.05)
    seen = {"jax": [], "port": []}
    for name, tr in (("jax", jt), ("port", tt)):
        def select(q, w, _f=tr._select_action, _s=seen[name]):
            a = _f(q, w)
            _s.append((np.array(q, np.float32), a))
            return a
        tr._select_action = select
        tr.rollout_episode()
    assert len(seen["jax"]) == len(seen["port"]) > 0
    n_greedy = 0
    for (jq, ja), (tq, ta) in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(tq, jq, rtol=TOL, atol=TOL)
        top = np.sort(jq)[-2:]
        if jq.size > 1 and top[1] - top[0] <= GAP:
            break
        assert ta == ja
        n_greedy += ja == int(np.argmax(jq))
    assert n_greedy > 0


@pytest.mark.parametrize("sync_mode", ["episode", "step"])
def test_prioritized_update_matches_the_reference(sync_mode):
    """Prioritized replay across frameworks over one update: the first
    draw is the uniform one (all priorities equal), then the |TD|
    feedback reprioritises both buffers alike within tolerance."""
    jt, tt = _pair(replay="prioritized", sync_mode=sync_mode)
    jt.rollout_episode()
    tt.rollout_episode()
    np.testing.assert_allclose(tt.run_updates(1), jt.run_updates(1), rtol=TOL)
    for b1, b2 in zip(jt.buffers, tt.buffers):
        np.testing.assert_allclose(b2._priorities, b1._priorities, rtol=TOL)
        assert b2._max_priority == pytest.approx(b1._max_priority, rel=TOL)


# ------------------------------------------------------------------ #
# the port's own matrices: bit-identical on the CPU
# ------------------------------------------------------------------ #
def _port(**kw) -> DistributedTrainer:
    base = dict(n_workers=2, mols_per_worker=2, episodes=2,
                updates_per_episode=3, train_batch_size=4, max_candidates=16,
                env=EnvConfig(max_steps=3), seed=0)
    dqn = DQNConfig(epsilon_initial=kw.pop("epsilon", 0.3), epsilon_decay=0.9)
    base.update(kw)
    return DistributedTrainer(
        TrainerConfig(dqn=dqn, **base), [from_smiles(s) for s in SMILES],
        OracleService(), RewardConfig(),
        network=QNetwork(hidden=(32, 16, 8, 4), device="cpu",
                         layers=_narrow_layers()), device="cpu")


def _narrow_layers():
    g = torch.Generator().manual_seed(3)
    sizes = (2049, 32, 16, 8, 4, 1)
    return [(torch.randn(i, o, generator=g) * (2.0 / i) ** 0.5,
             0.1 * torch.randn(o, generator=g)) for i, o in zip(sizes[:-1], sizes[1:])]


def _signature(tt: DistributedTrainer):
    bufs = [[getattr(b, k).tobytes() for k in _BUFFER_FIELDS] for b in tt.buffers]
    return bufs, tt.loss_log, tt.reward_log, _port_params(tt)


def _run(**kw):
    tt = _port(**kw)
    tt.train(2)
    tt.close()
    return tt


def test_port_acting_and_rollout_matrix_is_bit_identical():
    """Every acting mode and rollout mode gives the dense fleet path's
    transitions, losses and parameters at epsilon 0.3 (so Q decides most
    actions).  Fleet modes make one Q dispatch per env step; per_worker
    one per worker per step, each a ``fused_qnet`` call."""
    ref = _run(acting="dense")
    want = _signature(ref)
    assert ref.n_q_dispatches == 6
    for acting in ACTING_MODES:
        for rollout in ("fleet", "fleet_sharded", "fleet_pipelined"):
            got = _run(acting=acting, rollout=rollout)
            assert _signature(got) == want, (acting, rollout)
            assert got.n_q_dispatches == ref.n_q_dispatches
    launches = fused_ops.fused_qnet.launches
    got = _run(rollout="per_worker")
    assert _signature(got) == want
    assert got.n_q_dispatches == 12 and fused_ops.fused_qnet.launches == launches


@pytest.mark.parametrize("sync_mode", ["episode", "step"])
def test_port_learner_matrix_is_bit_identical(sync_mode):
    runs = {m: _run(learner=m, sync_mode=sync_mode) for m in LEARNER_MODES}
    want = _signature(runs["dense"])
    assert np.isfinite(want[1]).all()
    for m in ("packed", "packed_pipelined"):
        assert _signature(runs[m]) == want, m
    assert runs["packed"].h2d_update_bytes * 20 < runs["dense"].h2d_update_bytes


def test_prioritized_alpha0_is_bit_identical_to_uniform():
    uni = _run()
    pri = _run(replay="prioritized", priority_alpha=0.0)
    assert _signature(pri)[1:] == _signature(uni)[1:]
    for b1, b2 in zip(uni.buffers, pri.buffers):
        for k in _BUFFER_FIELDS[:-1]:
            assert getattr(b1, k).tobytes() == getattr(b2, k).tobytes(), k


def test_agent_matches_the_reference_agent():
    jagent = JaxAgent(JaxDQNConfig(), seed=4, network=JaxQNetwork(hidden=NARROW))
    params = jax.tree_util.tree_map(np.asarray, jagent.params)
    agent = DQNAgent(DQNConfig(), network=params_from_jax(params, device="cpu"),
                     device="cpu")
    rng = np.random.default_rng(6)
    states = np.concatenate([(rng.random((40, 2048)) < 0.2),
                             rng.random((40, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(agent.q_values(states), jagent.q_values(states),
                               rtol=TOL, atol=TOL)
    C = 5
    batch = {"states": states[:8], "rewards": rng.standard_normal(8).astype(np.float32),
             "dones": (rng.random(8) < 0.3).astype(np.float32),
             "next_fps": states[:40].reshape(8, C, -1),
             "next_mask": (rng.random((8, C)) < 0.7).astype(np.float32)}
    for _ in range(2):
        np.testing.assert_allclose(agent.train_step(batch), jagent.train_step(batch),
                                   rtol=TOL)
    for (w, b), l in zip(agent.params, jagent.params["layers"]):
        np.testing.assert_allclose(w.numpy(), np.asarray(l["w"]), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(l["b"]), atol=TOL, rtol=TOL)


def test_as_agent_is_the_worker_mean():
    tt = _run()
    agent = tt.as_agent(epsilon=0.0)
    for (w, b), (sw, sb) in zip(agent.params, tt.params):
        assert torch.equal(w, (sw[0] + sw[1]) / 2)
    assert agent.epsilon == 0.0


def test_checkpoint_methods_wait_for_the_checkpoint_port(tmp_path):
    """The four checkpoint methods are ported: a trained trainer's state
    saved through a ``CheckpointManager`` restores into a fresh trainer
    whose own ``state_dict`` is the same, key for key, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    tt = _run()
    mgr = CheckpointManager(str(tmp_path))
    assert tt.save_checkpoint(mgr) == 2
    fresh = _port()
    assert fresh.restore_checkpoint(mgr) == 2
    want, got = tt.state_dict(), fresh.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_trainer_validates_like_the_reference():
    for field, bad in (("rollout", "x"), ("learner", "x"), ("sync_mode", "x"),
                       ("chem", "x"), ("acting", "x"), ("replay", "x")):
        with pytest.raises(ValueError, match=field):
            _port(**{field: bad})
    with pytest.raises(ValueError, match="need 16 molecules"):
        _port(n_workers=8)


def test_packed_acting_launches_no_kernel_on_the_cpu():
    launches = packed_ops.packed_qnet_stacked.launches
    tt = _run()
    assert tt.n_q_dispatches == 6 and tt.dispatch_timing() is None
    assert packed_ops.packed_qnet_stacked.launches == launches
