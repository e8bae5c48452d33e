"""Port of ``repro.core``: the agent, the host-side engine and the trainer.

Exports what ``repro.core`` exports.  The names resolve on first use
(PEP 562), so importing one module of the package, as the kernels' plain
versions import ``packed_batch``, never pulls in the others.
"""

import importlib

_EXPORTS = {
    "repro_torch.core.faults": (
        "FaultError", "FaultPlan", "FaultRule", "FaultTimeout", "Incident",
        "TransientFault"),
    "repro_torch.core.reward": (
        "RewardConfig", "compute_reward", "INVALID_CONFORMER_REWARD",
        "ObjectiveSpec", "TermSpec", "CompiledObjective", "evaluate_rewards",
        "REWARD_TERMS"),
    "repro_torch.core.agent": ("QNetwork", "DQNAgent", "DQNConfig"),
    "repro_torch.core.replay": ("ReplayBuffer", "Transition"),
    "repro_torch.core.rollout": (
        "RolloutEngine", "StepRecord", "AgentFleetPolicy", "CHEM_MODES"),
    "repro_torch.core.env": ("MoleculeEnv", "BatchedEnv", "EnvConfig"),
    "repro_torch.core.distributed": (
        "DistributedTrainer", "TrainerConfig", "ACTING_MODES",
        "LEARNER_MODES", "ROLLOUT_MODES", "greedy_optimize",
        "optimization_failure_rate"),
    "repro_torch.core.finetune": ("fine_tune",),
    "repro_torch.core.filter": ("filter_molecules", "FilterCriteria"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_MODULE_OF[name]), name)
