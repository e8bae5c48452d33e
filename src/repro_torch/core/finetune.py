"""Port of ``repro.core.finetune``: per-molecule fine-tuning from the
general model (§3.5).

"The fine-tuning starts with the pre-trained general model, and the initial
epsilon threshold is 0.5" — 100-200 extra episodes specialise the general
model to one (possibly outlier) molecule with trivial overhead compared to
the 8000-episode individual models (Fig. 3).  Appendix C Table 2: epsilon
0.5, decay 0.961, batch 128, torchrun (single process) — i.e. a plain
single-worker DQN loop seeded from the general parameters.

The loop, seeds and defaults are the reference's.  The port's
``DQNAgent`` keeps no ``network`` object, so the new agent is built from
the general model's widths and holds a copy of its parameters on
``device`` (the GPU unless the caller names another).  Acting goes
through ``DQNAgent.q_values``: one ``fused_qnet`` launch per environment
step on the card.
"""

from __future__ import annotations

from dataclasses import replace

from repro_torch.chem.molecule import Molecule
from repro_torch.core.agent import DQNAgent, QNetwork
from repro_torch.core.env import BatchedEnv, EnvConfig
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.reward import RewardConfig
from repro_torch.device import resolve_device


def fine_tune(
    general_agent: DQNAgent,
    molecule: Molecule,
    service,
    reward_cfg: RewardConfig,
    *,
    episodes: int = 200,           # Table 1 (Fine-Tuned: 200 episodes)
    epsilon_initial: float = 0.5,  # Table 2
    epsilon_decay: float = 0.961,  # Table 2
    train_batch_size: int = 32,
    updates_per_episode: int = 4,
    max_candidates: int = 64,
    env_cfg: EnvConfig = EnvConfig(),
    seed: int = 0,
    scenario: "str | object | None" = None,
    device=None,
) -> DQNAgent:
    """Returns a NEW agent fine-tuned on ``molecule`` (general untouched).

    ``scenario`` optionally overrides the objective: a registry name or an
    ``ObjectiveSpec`` is compiled ONCE (fresh novelty state for this run)
    against ``reward_cfg``'s Eq. 1 bounds; any other object is used as the
    engine objective directly.  ``None`` keeps the plain ``reward_cfg``
    scalar path.
    """
    device = resolve_device(device)
    cfg = replace(
        general_agent.cfg,
        epsilon_initial=epsilon_initial,
        epsilon_decay=epsilon_decay,
    )
    layers = general_agent.params
    network = QNetwork(hidden=[w.shape[1] for w, _ in layers[:-1]],
                       in_dim=layers[0][0].shape[0], device=device,
                       layers=layers)
    # DQNAgent clones the network's tensors into params and target_params
    # and starts a fresh Adam state, as the reference's copies and
    # ``opt.init`` do
    agent = DQNAgent(cfg, seed=seed, network=network, device=device)
    agent.epsilon = epsilon_initial

    objective: object = reward_cfg
    if scenario is not None:
        from repro_torch.core.reward import ObjectiveSpec
        if isinstance(scenario, str):
            from repro_torch.configs.scenarios import get_scenario
            objective = get_scenario(scenario).compile(base=reward_cfg)
        elif isinstance(scenario, ObjectiveSpec):
            objective = scenario.compile(base=reward_cfg)
        else:
            objective = scenario

    env = BatchedEnv([molecule], env_cfg, seed=seed + 1)
    buffer = ReplayBuffer(capacity=4000, seed=seed + 2)

    for _ in range(episodes):
        env.run_episode(agent, service, objective, buffer)
        if len(buffer) >= train_batch_size:
            for _ in range(updates_per_episode):
                agent.train_step(buffer.sample(train_batch_size, max_candidates))
        agent.update_target()
        agent.decay_epsilon()
    return agent
