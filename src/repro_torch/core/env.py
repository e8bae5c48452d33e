"""Copy of ``repro.core.env``; only its imports differ.

Molecule-optimisation environments — thin adapters over RolloutEngine.

``MoleculeEnv``  one molecule, MolDQN semantics: every episode restarts
                 from the initial molecule; each step picks one valid edit;
                 Q states are candidate-next-state fingerprints ++ a
                 normalised steps-left feature.

``BatchedEnv``   the paper's *batched modification* (§3.1): a worker owns a
                 batch of molecules and advances them in lockstep — "it
                 will not go to the next step until all molecules in the
                 current step finished their operations".

Since the fleet-level refactor both are single-worker views over
``repro.core.rollout.RolloutEngine``; the slot machinery, the one-Q-call /
one-property-batch step loop, and replay threading all live there.  The
environment never calls predictors per molecule; the property batch is the
only predictor entry point (see PropertyService).
"""

from __future__ import annotations

from repro_torch.chem.chemcache import ChemCache
from repro_torch.chem.molecule import Molecule
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.reward import RewardConfig
from repro_torch.core.rollout import (
    EnvConfig, RolloutEngine, Slot, StepRecord, as_fleet_policy)

__all__ = ["EnvConfig", "StepRecord", "BatchedEnv", "MoleculeEnv"]


class BatchedEnv:
    """Lockstep batch of molecule episodes (one per 'slot'): a one-worker
    fleet.  ``agent`` may be anything with ``q_values``/``select_action``
    (DQNAgent, a trainer worker view) or a full FleetPolicy.

    ``chem``/``chem_cache`` select the engine's candidate-chemistry path;
    the trainer shares ONE ChemCache across all its per-worker envs, so the
    legacy ``rollout="per_worker"`` loop still dedupes chemistry fleet-wide.
    """

    def __init__(self, molecules: list[Molecule], cfg: EnvConfig = EnvConfig(),
                 seed: int = 0, chem: str = "full",
                 chem_cache: ChemCache | None = None):
        # ``seed`` is kept for API stability; the environment is
        # deterministic — action stochasticity lives in the agent's RNG
        self.cfg = cfg
        self.initials = list(molecules)
        self._engine = RolloutEngine([self.initials], cfg, chem=chem,
                                     chem_cache=chem_cache)

    # ------------------------------------------------------------ #
    @property
    def slots(self) -> list[Slot]:
        return self._engine.workers[0]

    def reset(self) -> None:
        self._engine.reset()

    @property
    def done(self) -> bool:
        return self._engine.done

    # ------------------------------------------------------------ #
    def step(
        self,
        agent,
        service,
        reward_cfg: "RewardConfig | object",
        buffer: ReplayBuffer | None = None,
    ) -> list[StepRecord]:
        """One lockstep environment step for every live slot.

        ``reward_cfg`` accepts any fleet objective the engine resolves:
        a ``RewardConfig`` (Eq. 1 scalar path), an ``ObjectiveSpec`` /
        registry scenario name (compiled + vectorised), a
        ``CompiledObjective``, or an arbitrary callable
        ``f(props, initial, current, steps_left) -> float``.
        """
        return self._engine.step(
            as_fleet_policy(agent), service, reward_cfg, [buffer])

    def run_episode(
        self,
        agent,
        service,
        reward_cfg: "RewardConfig | object",
        buffer: ReplayBuffer | None = None,
    ) -> list[StepRecord]:
        """Reset + roll a full episode; returns ALL step records (the
        final step's records are those with ``done=True``)."""
        return self._engine.run_episode(
            as_fleet_policy(agent), service, reward_cfg, [buffer])

    def final_molecules(self) -> list[Molecule]:
        return self._engine.final_molecules(worker=0)

    def best_molecules(self) -> list[tuple[float, Molecule]]:
        return self._engine.best_molecules(worker=0)


class MoleculeEnv(BatchedEnv):
    """Single-molecule environment (original MolDQN) = batch of one."""

    def __init__(self, molecule: Molecule, cfg: EnvConfig = EnvConfig(), seed: int = 0,
                 chem: str = "full", chem_cache: ChemCache | None = None):
        super().__init__([molecule], cfg, seed, chem=chem, chem_cache=chem_cache)
