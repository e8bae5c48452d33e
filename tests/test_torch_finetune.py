"""The port's §3.5 fine-tuning against ``repro.core.finetune``, on the CPU.

* From the same general parameters (the reference's init, crossed over
  with ``params_from_jax``), reference ``fine_tune`` and the port's
  ``fine_tune(device="cpu")`` over ``OracleService`` at epsilon 1 (actions
  do not depend on Q, so both see the same transitions and replay samples)
  end with parameters within 1e-5 abs + 1e-4 rel, and the same epsilon.
  The reference's Q path here is plain JAX (``use_pallas_qnet`` False).
* The general agent comes out untouched, bit for bit, and the fine-tuned
  agent owns its tensors.
* In the port, ``scenario="antioxidant"`` (the registry's Eq. 1 objective,
  compiled) is bit-identical to ``scenario=None`` (the scalar path), at the
  paper's epsilon 0.5 where actions do follow Q.
"""

import jax
import numpy as np
import pytest

from repro.chem.smiles import from_smiles as jax_from_smiles
from repro.core import DQNConfig as JaxDQNConfig, EnvConfig as JaxEnvConfig
from repro.core import RewardConfig as JaxRewardConfig
from repro.core import fine_tune as jax_fine_tune
from repro.core.agent import DQNAgent as JaxAgent, QNetwork as JaxQNetwork
from repro.predictors.service import OracleService as JaxOracle
from repro_torch.chem.smiles import from_smiles
from repro_torch.core import DQNConfig, EnvConfig, RewardConfig, fine_tune
from repro_torch.core.agent import DQNAgent, params_from_jax
from repro_torch.kernels.fused_qnet import ops as fused_ops
from repro_torch.predictors.service import OracleService

SMILES = "CC1=CC=CC=C1O"
HIDDEN = (32, 16)
ATOL, RTOL = 1e-5, 1e-4


def _general_pair():
    jagent = JaxAgent(JaxDQNConfig(), seed=0, network=JaxQNetwork(hidden=HIDDEN))
    p = jax.tree_util.tree_map(np.asarray, jagent.params)
    agent = DQNAgent(DQNConfig(), network=params_from_jax(p, device="cpu"),
                     device="cpu")
    return jagent, agent


def _bytes(agent):
    return [t.numpy().tobytes() for wb in agent.params + agent.target_params
            for t in wb]


def _port(agent, **kw):
    return fine_tune(agent, from_smiles(SMILES), OracleService(), RewardConfig(),
                     env_cfg=EnvConfig(max_steps=3), train_batch_size=8,
                     device="cpu", **kw)


def test_fine_tune_matches_the_reference_at_epsilon_one():
    jgeneral, general = _general_pair()
    before = _bytes(general)
    kw = dict(episodes=3, epsilon_initial=1.0, epsilon_decay=1.0)
    want = jax_fine_tune(jgeneral, jax_from_smiles(SMILES), JaxOracle(),
                         JaxRewardConfig(), env_cfg=JaxEnvConfig(max_steps=3),
                         train_batch_size=8, **kw)
    fused_ops.fused_qnet.launches = 0
    got = _port(general, **kw)
    assert _bytes(general) == before, "the general agent must be untouched"
    assert got.epsilon == want.epsilon == 1.0
    # 3 episodes of 3 steps; updates start once 8 transitions are stored
    assert got.n_q_dispatches == 9 and fused_ops.fused_qnet.launches == 0
    assert int(got.opt_state.step) == int(want.opt_state.step) == 4
    for (w, b), layer in zip(got.params, want.params["layers"]):
        for t, ref in ((w, layer["w"]), (b, layer["b"])):
            np.testing.assert_allclose(
                t.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                err_msg=f"fine-tuned parameters within {ATOL} abs + {RTOL} rel")
    moved = max(float(np.max(np.abs(w.numpy() - np.asarray(l["w"]))))
                for (w, _), l in zip(got.params, jgeneral.params["layers"]))
    assert moved > 0, "4 updates moved no weight"


def test_general_agent_is_untouched_and_the_copy_is_owned():
    _, general = _general_pair()
    before = _bytes(general)
    ft = _port(general, episodes=2)
    assert _bytes(general) == before
    assert general.epsilon == DQNConfig().epsilon_initial
    assert ft.epsilon == pytest.approx(0.5 * 0.961 ** 2)
    assert ft.cfg.epsilon_initial == 0.5 and ft.cfg.epsilon_decay == 0.961
    ours = {t.data_ptr() for wb in ft.params + ft.target_params for t in wb}
    theirs = {t.data_ptr() for wb in general.params + general.target_params
              for t in wb}
    assert not ours & theirs


def test_antioxidant_scenario_is_the_scalar_path():
    _, general = _general_pair()
    plain = _port(general, episodes=4)
    named = _port(general, episodes=4, scenario="antioxidant")
    assert _bytes(named) == _bytes(plain)
    assert named.n_q_dispatches == plain.n_q_dispatches == 12
