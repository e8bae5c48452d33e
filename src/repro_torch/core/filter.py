"""Copy of ``repro.core.filter``; only its imports differ.

The filter script (§3.5).

"an extra script filters out molecules without good BDE and IP properties.
The molecules are also filtered out if their SA scores are higher than 3.5
or if they are identical to existing antioxidants."

Constraints implemented (see §4.1 A-E):
  (A) BDE  < bde_max   (76 kcal/mol)
  (B) IP   > ip_min    (145 kcal/mol)
  (D) similar-but-not-identical: canonical-key inequality vs every known
      antioxidant, plus an optional Tanimoto ceiling
  (E) SA score <= sa_max (3.5)

Property values come from the *predictors* (as in the paper's pipeline);
the DFT-validation benchmark re-scores survivors with the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.chem.molecule import Molecule
from repro_torch.chem.properties import sa_score, tanimoto


@dataclass(frozen=True)
class FilterCriteria:
    bde_max: float = 76.0
    ip_min: float = 145.0
    sa_max: float = 3.5
    tanimoto_max: float = 0.999   # < 1.0 means "not identical" only
    require_oh: bool = True


@dataclass(frozen=True)
class FilterResult:
    molecule: Molecule
    bde: float
    ip: float
    sa: float
    max_similarity: float
    passed: bool
    reasons: tuple[str, ...]


def filter_molecules(
    candidates: list[tuple[Molecule, float | None, float | None]],
    known: list[Molecule],
    criteria: FilterCriteria = FilterCriteria(),
) -> list[FilterResult]:
    """``candidates`` are (molecule, predicted_bde, predicted_ip) triples."""
    known_keys = {m.canonical_key() for m in known}
    out: list[FilterResult] = []
    for mol, bde, ip in candidates:
        reasons: list[str] = []
        if bde is None or (criteria.require_oh and not mol.has_oh_bond()):
            reasons.append("no_oh_bond")
            bde = float("inf") if bde is None else bde
        if ip is None:
            reasons.append("invalid_conformer")
            ip = float("-inf")
        if bde >= criteria.bde_max:
            reasons.append("bde_too_high")
        if ip <= criteria.ip_min:
            reasons.append("ip_too_low")
        sa = sa_score(mol)
        if sa > criteria.sa_max:
            reasons.append("sa_too_high")
        if mol.canonical_key() in known_keys:
            reasons.append("identical_to_known")
        max_sim = max((tanimoto(mol, k) for k in known), default=0.0)
        if max_sim > criteria.tanimoto_max:
            reasons.append("too_similar")
        out.append(FilterResult(
            molecule=mol, bde=float(bde), ip=float(ip), sa=float(sa),
            max_similarity=float(max_sim), passed=not reasons,
            reasons=tuple(reasons),
        ))
    return out
