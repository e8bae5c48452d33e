"""Copy of ``repro.configs.scenarios``; only its imports differ.

The central scenario registry: named ObjectiveSpecs for trainer + server.

ONE table maps scenario names to term-composed objectives
(:class:`repro.core.reward.ObjectiveSpec`).  The trainer mixes them per
worker (``TrainerConfig.scenarios`` — a heterogeneous fleet optimises N
workloads in one run), the serving tier resolves request objectives
through the very same names (``serving.request.resolve_objective``), and
``launch/verify.py`` pins the mixed-fleet determinism contract over them
at nd ∈ {1, 2, 4}.

Built-ins:

=====================  ==================================================
``antioxidant``        the paper's Eq. 1 (w = 0.8/0.2/0.5, Table 3)
``antioxidant_bde``    Eq. 1, BDE-only property signal (w1=1, w2=0)
``antioxidant_ip``     Eq. 1, IP-only property signal (w1=0, w2=1)
``qed``                drug-likeness surrogate (Appendix D comparison)
``plogp``              penalised logP surrogate (Appendix D comparison)
``qed_sa``             QED with an explicit SA penalty (§3.5's filter
                       criterion folded into the objective)
``antioxidant_novel``  Eq. 1 + count-based intrinsic novelty bonus over
                       canonical keys (Thiede et al., arXiv 2012.11293)
``antioxidant_tether`` Eq. 1 + Tanimoto similarity to the slot's own
                       start molecule (MEG-style lead tether)
=====================  ==================================================

The Eq. 1-family scenarios leave their bde/ip bounds unset
(``TermSpec.lo/hi = None``): the trainer's dataset-derived
``RewardConfig`` flows in at compile time (``spec.compile(base=...)``),
while weights and step-decay factors are pinned by the spec itself.
Compiled, the ``antioxidant`` scenario is BIT-identical to
``compute_reward`` under the same config — the registry path costs no
reproducibility.
"""

from __future__ import annotations

from repro_torch.core.reward import ObjectiveSpec, RewardConfig, TermSpec

# Eq. 1 term triple with deferred bounds; weights/factors pinned here
def _eq1_terms(bde_weight: float = 0.8, ip_weight: float = 0.2,
               gamma_weight: float = 0.5) -> tuple[TermSpec, ...]:
    return (
        TermSpec("bde", weight=-bde_weight, factor=0.9),
        TermSpec("ip", weight=ip_weight, factor=0.8),
        TermSpec("gamma", weight=gamma_weight),
    )


SCENARIOS: dict[str, ObjectiveSpec] = {}


def register_scenario(spec: ObjectiveSpec, overwrite: bool = False) -> ObjectiveSpec:
    """Add a spec to the registry under ``spec.name``.  Collisions are an
    error unless ``overwrite=True`` — silently shadowing a scenario other
    workers/requests resolve by name is how fleets diverge."""
    if not overwrite and spec.name in SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    SCENARIOS[spec.name] = spec
    return spec


def get_scenario(name: str) -> ObjectiveSpec:
    """Resolve a scenario name; unknown names raise a ``ValueError`` that
    lists the registry (the serving door-reject message)."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registry scenarios: "
            f"{list_scenarios()}") from None


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


def worker_scenarios(names, n_workers: int) -> list[str]:
    """The per-worker assignment of a ``TrainerConfig.scenarios`` mix:
    the name tuple cycles across the fleet (worker w runs
    ``names[w % len(names)]``).  Validates every name up front."""
    names = list(names)
    if not names:
        raise ValueError("scenarios mix must name at least one scenario")
    for n in names:
        get_scenario(n)
    return [names[w % len(names)] for w in range(n_workers)]


def compile_worker_objectives(names, n_workers: int,
                              base: RewardConfig | None = None) -> list:
    """Per-worker compiled evaluators for a scenario mix: one FRESH
    ``CompiledObjective`` per worker (never shared — the novelty term's
    visit counts are per-worker state, which is what makes a mixed
    fleet's worker bit-identical to its solo twin)."""
    return [get_scenario(n).compile(base=base)
            for n in worker_scenarios(names, n_workers)]


register_scenario(ObjectiveSpec("antioxidant", _eq1_terms()))
register_scenario(ObjectiveSpec("antioxidant_bde", _eq1_terms(1.0, 0.0)))
register_scenario(ObjectiveSpec("antioxidant_ip", _eq1_terms(0.0, 1.0)))
register_scenario(ObjectiveSpec("qed", (TermSpec("qed", weight=1.0),)))
register_scenario(ObjectiveSpec("plogp", (TermSpec("plogp", weight=1.0),)))
register_scenario(ObjectiveSpec("qed_sa", (
    TermSpec("qed", weight=1.0),
    TermSpec("sa", weight=-0.1),
)))
register_scenario(ObjectiveSpec("antioxidant_novel",
                                _eq1_terms() + (TermSpec("novelty", weight=0.1),)))
register_scenario(ObjectiveSpec("antioxidant_tether",
                                _eq1_terms() + (TermSpec("similarity", weight=0.2),)))
