"""Copy of ``repro.core.reward``; only its imports differ.

Reward objectives: Eq. 1 (paper §3.4) + composable scenario terms.

The paper's objective is one weighted sum:

    Reward = -w1 * nBDE + w2 * nIP + w3 * γ

* nBDE/nIP are min-max normalised with bounds taken from the *training
  dataset* properties ("The lower bound and upper bound are minimal and
  maximum properties in the proprietary data set").
* weights default to the paper's (0.8, 0.2, 0.5) — Table 3.
* γ rewards shrinking the molecule: "the relatively reduced atoms and bonds
  from the initial molecule".
* per-property factors (Table 3: BDE Factor 0.9, IP Factor 0.8) are applied
  as step-decays ``factor ** steps_left`` — early in the episode the agent
  sees weaker property signal, at the terminal step the full value (this is
  the MolDQN per-step discounting convention applied per property).
* molecules without a valid 3D conformer get INVALID_CONFORMER_REWARD
  (-1000, §3.3) — "much less than the normal rewards".

PR 10 generalises the objective layer around TERM COMPOSITION: an
:class:`ObjectiveSpec` names its reward terms (:data:`REWARD_TERMS`) with
per-term weights/factors and compiles to a :class:`CompiledObjective` — a
vectorized evaluator the rollout engine runs ONCE per env step over the
fleet's ``[W]`` property/state rows.  The scenario registry over these
specs lives in ``repro.configs.scenarios`` (one table serving trainer and
server).

Determinism contract (the repo's style, pinned by tests/test_reward_terms
and the rollout/multidevice matrices):

* :func:`compute_reward` stays THE scalar correctness reference, untouched.
* :func:`evaluate_rewards` (its fleet-vectorized twin) and a compiled
  Eq. 1-family spec are BIT-identical to it: elementwise float64 NumPy ops
  mirror the scalar arithmetic operation-for-operation, and the per-step
  decays are computed with the same Python ``float ** int`` pow — no libm
  vectorisation drift.
* the only stateful term (``novelty`` — a count-based intrinsic bonus over
  canonical keys, Thiede et al. arXiv 2012.11293) keeps its visit counts
  PER compiled instance, and a compiled objective is created per worker /
  per serving request — a worker in a mixed fleet is bit-identical to the
  same worker in a fleet running only its scenario.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.chem.molecule import Molecule

INVALID_CONFORMER_REWARD = -1000.0

# the composable reward term vocabulary (ObjectiveSpec validates against it):
#   bde / ip      Eq. 1 min-max normalised properties (need predictor props;
#                 an invalid conformer forces INVALID_CONFORMER_REWARD)
#   gamma         Eq. 1 shrinkage: relative atom+bond reduction vs the start
#   qed / plogp / sa
#                 structure-only surrogates from repro.chem.properties
#   similarity    Tanimoto to a fixed target SMILES (TermSpec.target) or, with
#                 target=None, to the slot's own start molecule (MEG-style
#                 "stay close to the lead" tether)
#   novelty       count-based intrinsic bonus 1/sqrt(visits) over canonical
#                 keys — stateful, scoped to the compiled instance
REWARD_TERMS = ("bde", "ip", "gamma", "qed", "plogp", "sa",
                "similarity", "novelty")


@dataclass(frozen=True)
class RewardConfig:
    bde_weight: float = 0.8     # w1
    ip_weight: float = 0.2      # w2
    gamma_weight: float = 0.5   # w3
    bde_factor: float = 0.9
    ip_factor: float = 0.8
    # min-max normalisation bounds (from the training set; §3.4)
    bde_min: float = 55.0
    bde_max: float = 95.0
    ip_min: float = 95.0
    ip_max: float = 200.0

    @classmethod
    def from_dataset(cls, bde_values, ip_values, **kw) -> "RewardConfig":
        return cls(
            bde_min=float(np.min(bde_values)), bde_max=float(np.max(bde_values)),
            ip_min=float(np.min(ip_values)), ip_max=float(np.max(ip_values)),
            **kw,
        )

    # ------------------------------------------------------------ #
    def normalize_bde(self, bde: float) -> float:
        return (bde - self.bde_min) / max(self.bde_max - self.bde_min, 1e-9)

    def normalize_ip(self, ip: float) -> float:
        return (ip - self.ip_min) / max(self.ip_max - self.ip_min, 1e-9)


def gamma_term(initial: Molecule, current: Molecule) -> float:
    """Relative reduction of atoms + bonds vs the initial molecule."""
    a0 = max(initial.num_atoms, 1)
    b0 = max(initial.num_bonds, 1)
    da = (a0 - current.num_atoms) / a0
    db = (b0 - current.num_bonds) / b0
    return 0.5 * (da + db)


def compute_reward(
    cfg: RewardConfig,
    *,
    bde: float | None,
    ip: float | None,
    initial: Molecule,
    current: Molecule,
    steps_left: int = 0,
) -> float:
    """Eq. 1.  ``ip is None`` means no valid 3D conformer -> -1000 (§3.3).
    ``bde is None`` (no O-H bond) is unreachable through protected actions
    but treated identically for robustness.

    This is the pinned SCALAR CORRECTNESS REFERENCE: the fleet-vectorized
    paths (:func:`evaluate_rewards`, a compiled Eq. 1 spec) must stay
    bit-identical to it."""
    if ip is None or bde is None:
        return INVALID_CONFORMER_REWARD
    nbde = cfg.normalize_bde(bde) * (cfg.bde_factor ** steps_left)
    nip = cfg.normalize_ip(ip) * (cfg.ip_factor ** steps_left)
    return -cfg.bde_weight * nbde + cfg.ip_weight * nip + cfg.gamma_weight * gamma_term(initial, current)


# ------------------------------------------------------------------ #
# fleet-vectorized Eq. 1 (the RewardConfig fast path of the reward layer)
# ------------------------------------------------------------------ #
def _decay_column(factor: float, steps_left) -> np.ndarray:
    """``factor ** steps_left`` per row, via the SAME Python ``float **
    int`` pow the scalar reference uses — np.power may route through SIMD
    loops whose last-ulp rounding differs from libm, which would break the
    bit-identity contract."""
    return np.array([factor ** int(s) for s in steps_left], np.float64)


def _gamma_values(initials, currents) -> np.ndarray:
    """Vectorized :func:`gamma_term`: int64 arrays divide to float64 with
    the exact IEEE ops of the scalar int/int division."""
    a0 = np.maximum(np.array([m.num_atoms for m in initials], np.int64), 1)
    b0 = np.maximum(np.array([m.num_bonds for m in initials], np.int64), 1)
    da = (a0 - np.array([m.num_atoms for m in currents], np.int64)) / a0
    db = (b0 - np.array([m.num_bonds for m in currents], np.int64)) / b0
    return 0.5 * (da + db)


def _invalid_mask(props) -> np.ndarray:
    return np.array([p.bde is None or p.ip is None for p in props], bool)


def evaluate_rewards(cfg: RewardConfig, props, initials, currents,
                     steps_left) -> np.ndarray:
    """Eq. 1 over ``[N]`` rows in ONE NumPy evaluation — the fleet reward
    layer's path for a plain :class:`RewardConfig` objective.  Every
    elementwise op mirrors :func:`compute_reward`'s scalar arithmetic in
    the same order, so the result is bit-identical per row (pinned by
    tests/test_reward_terms.py and the rollout equivalence matrix)."""
    invalid = _invalid_mask(props)
    bde = np.array([np.nan if v else p.bde for p, v in zip(props, invalid)],
                   np.float64)
    ip = np.array([np.nan if v else p.ip for p, v in zip(props, invalid)],
                  np.float64)
    nbde = (bde - cfg.bde_min) / max(cfg.bde_max - cfg.bde_min, 1e-9) \
        * _decay_column(cfg.bde_factor, steps_left)
    nip = (ip - cfg.ip_min) / max(cfg.ip_max - cfg.ip_min, 1e-9) \
        * _decay_column(cfg.ip_factor, steps_left)
    r = -cfg.bde_weight * nbde + cfg.ip_weight * nip \
        + cfg.gamma_weight * _gamma_values(initials, currents)
    if invalid.any():
        r = np.where(invalid, INVALID_CONFORMER_REWARD, r)
    return r


# ------------------------------------------------------------------ #
# term-composed objectives
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class TermSpec:
    """One weighted reward term of an :class:`ObjectiveSpec`.

    ``weight`` is the SIGNED contribution (Eq. 1's BDE term carries a
    negative weight); ``factor`` is the per-step decay ``factor **
    steps_left`` (1.0 = none).  ``lo``/``hi`` are the min-max bounds of the
    ``bde``/``ip`` terms — ``None`` defers to the ``base`` RewardConfig at
    compile time, which is how dataset-derived bounds flow into named
    scenarios.  ``target`` is the ``similarity`` term's target SMILES
    (``None`` = the slot's own start molecule)."""

    term: str
    weight: float = 1.0
    factor: float = 1.0
    lo: float | None = None
    hi: float | None = None
    target: str | None = None

    def __post_init__(self):
        if self.term not in REWARD_TERMS:
            raise ValueError(
                f"unknown reward term {self.term!r}; terms: {REWARD_TERMS}")


@dataclass(frozen=True)
class ObjectiveSpec:
    """A named objective as an ordered composition of weighted terms.

    The ONE objective abstraction of the system: the trainer assigns specs
    per worker (``TrainerConfig.scenarios``), the serving tier resolves
    request objectives to specs through the same registry
    (``repro.configs.scenarios``), and both compile here into the
    vectorized evaluator the rollout engine's fleet reward layer runs.

    Terms accumulate IN ORDER (IEEE addition is not associative — order is
    part of the bit-identity contract with the scalar reference)."""

    name: str
    terms: tuple[TermSpec, ...]

    def __post_init__(self):
        if not self.terms:
            raise ValueError(f"objective {self.name!r} has no terms")

    @classmethod
    def from_reward_config(cls, name: str, cfg: RewardConfig) -> "ObjectiveSpec":
        """Express an Eq. 1 :class:`RewardConfig` as term composition —
        compiled, it is bit-identical to :func:`compute_reward` under that
        config."""
        return cls(name, (
            TermSpec("bde", weight=-cfg.bde_weight, factor=cfg.bde_factor,
                     lo=cfg.bde_min, hi=cfg.bde_max),
            TermSpec("ip", weight=cfg.ip_weight, factor=cfg.ip_factor,
                     lo=cfg.ip_min, hi=cfg.ip_max),
            TermSpec("gamma", weight=cfg.gamma_weight),
        ))

    @property
    def uses_props(self) -> bool:
        """True when the spec reads predictor properties (bde/ip terms) —
        which also switches on the invalid-conformer -1000 guard."""
        return any(t.term in ("bde", "ip") for t in self.terms)

    def compile(self, base: RewardConfig | None = None) -> "CompiledObjective":
        """Build a FRESH vectorized evaluator.  ``base`` supplies the
        bde/ip bounds for terms that left ``lo``/``hi`` unset (the
        trainer passes its dataset-derived RewardConfig).  Fresh means
        fresh novelty state: compile once per worker / per request."""
        return CompiledObjective(self, base=base)


@dataclass(frozen=True)
class _BoundTerm:
    """A TermSpec with its bounds/target resolved at compile time."""
    term: str
    weight: float
    factor: float
    lo: float = 0.0
    den: float = 1.0                      # max(hi - lo, 1e-9)
    target_fp: np.ndarray | None = field(default=None, compare=False)


class CompiledObjective:
    """The vectorized reward evaluator an :class:`ObjectiveSpec` compiles
    to.  ``evaluate`` computes all terms over ``[N]`` rows in one NumPy
    pass; ``__call__`` is the one-row scalar convenience carrying the
    established pluggable-objective signature ``(props, initial, current,
    steps_left) -> float`` (so a compiled objective IS a valid
    ``Slot.objective``).

    Exception safety: term values are all computed before any state
    mutates (the novelty counts update last), so an objective that raises
    mid-evaluation leaves the instance unchanged — the rollout engine's
    per-row fallback then re-evaluates against consistent state.

    ``state_dict``/``load_state_dict`` expose the novelty visit counts for
    bit-exact checkpoint/resume."""

    def __init__(self, spec: ObjectiveSpec, base: RewardConfig | None = None):
        base = base if base is not None else RewardConfig()
        self.spec = spec
        self.name = spec.name
        self.uses_props = spec.uses_props
        bound = []
        for t in spec.terms:
            lo, den, target_fp = 0.0, 1.0, None
            if t.term in ("bde", "ip"):
                lo = t.lo if t.lo is not None else \
                    (base.bde_min if t.term == "bde" else base.ip_min)
                hi = t.hi if t.hi is not None else \
                    (base.bde_max if t.term == "bde" else base.ip_max)
                den = max(hi - lo, 1e-9)
            elif t.term == "similarity" and t.target is not None:
                from repro_torch.chem.fingerprint import morgan_fingerprint
                from repro_torch.chem.smiles import from_smiles
                target_fp = morgan_fingerprint(from_smiles(t.target))
            bound.append(_BoundTerm(term=t.term, weight=t.weight,
                                    factor=t.factor, lo=lo, den=den,
                                    target_fp=target_fp))
        self._terms = tuple(bound)
        self._novelty_counts: dict[str, int] | None = \
            {} if any(t.term == "novelty" for t in spec.terms) else None

    # -------------------------------------------------------------- #
    def _term_values(self, t: _BoundTerm, props, initials, currents
                     ) -> np.ndarray:
        from repro_torch.chem.properties import penalized_logp, qed_score, \
            sa_score, tanimoto
        if t.term == "bde":
            bde = np.array([np.nan if p.bde is None or p.ip is None
                            else p.bde for p in props], np.float64)
            return (bde - t.lo) / t.den
        if t.term == "ip":
            ip = np.array([np.nan if p.bde is None or p.ip is None
                           else p.ip for p in props], np.float64)
            return (ip - t.lo) / t.den
        if t.term == "gamma":
            return _gamma_values(initials, currents)
        if t.term == "qed":
            return np.array([qed_score(m) for m in currents], np.float64)
        if t.term == "plogp":
            return np.array([penalized_logp(m) for m in currents], np.float64)
        if t.term == "sa":
            return np.array([sa_score(m) for m in currents], np.float64)
        if t.term == "similarity":
            if t.target_fp is not None:
                return np.array([tanimoto(m, t.target_fp) for m in currents],
                                np.float64)
            return np.array(
                [tanimoto(m, m0) for m, m0 in zip(currents, initials)],
                np.float64)
        raise AssertionError(f"unhandled term {t.term!r}")  # pragma: no cover

    def _novelty_values(self, currents) -> np.ndarray:
        """Count-based intrinsic bonus 1/sqrt(visits), visits counted in
        row order over THIS instance's lifetime — per-worker / per-request
        scoping is what keeps a mixed fleet's worker bit-identical to its
        solo twin."""
        out = np.empty(len(currents), np.float64)
        for i, m in enumerate(currents):
            k = m.canonical_key()
            c = self._novelty_counts.get(k, 0) + 1
            self._novelty_counts[k] = c
            out[i] = 1.0 / math.sqrt(c)
        return out

    def evaluate(self, props, initials, currents, steps_left) -> np.ndarray:
        """All terms over ``[N]`` rows, accumulated in spec order; rows
        with invalid conformers collapse to INVALID_CONFORMER_REWARD when
        the spec reads bde/ip (exactly the scalar reference's guard)."""
        sl = [int(s) for s in steps_left]
        vals: dict[int, np.ndarray] = {}
        novelty_at = None
        for ti, t in enumerate(self._terms):
            if t.term == "novelty":
                novelty_at = ti           # stateful: computed after the
                continue                  # raise-capable terms
            vals[ti] = self._term_values(t, props, initials, currents)
        if novelty_at is not None:
            vals[novelty_at] = self._novelty_values(currents)
        out = None
        for ti, t in enumerate(self._terms):
            v = vals[ti]
            if t.factor != 1.0:
                v = v * _decay_column(t.factor, sl)
            contrib = t.weight * v
            out = contrib if out is None else out + contrib
        if self.uses_props:
            invalid = _invalid_mask(props)
            if invalid.any():
                out = np.where(invalid, INVALID_CONFORMER_REWARD, out)
        return out

    def __call__(self, props, initial, current, steps_left) -> float:
        return float(self.evaluate([props], [initial], [current],
                                   [steps_left])[0])

    # -------------------------------------------------------------- #
    def state_dict(self) -> dict:
        """JSON-serialisable mutable state (novelty visit counts)."""
        return {"novelty_counts": dict(self._novelty_counts)
                if self._novelty_counts is not None else None}

    def load_state_dict(self, state: dict) -> None:
        counts = state.get("novelty_counts")
        if (counts is None) != (self._novelty_counts is None):
            raise ValueError(
                f"objective {self.name!r}: checkpointed novelty state "
                f"mismatches the compiled spec")
        if self._novelty_counts is not None:
            self._novelty_counts = {str(k): int(v) for k, v in counts.items()}

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"CompiledObjective({self.name!r})"
