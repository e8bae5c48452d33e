"""The port's filter script (§3.5) against ``repro.core.filter``, on the CPU.

``filter_molecules`` is pure host code, copied from the reference with
only its imports changed, so every ``FilterResult`` field must be EQUAL:
the same molecule, BDE, IP, SA score, maximum Tanimoto similarity, verdict
and reasons, in the same order.  The candidates are 40 dataset molecules
with seeded numpy BDE and IP values around the thresholds, plus a molecule
with no BDE (no O-H bond), one with no IP (no valid conformer), a known
antioxidant and a near-duplicate of one.
"""

import numpy as np
import pytest

from repro.chem.smiles import canonical_smiles as jax_canonical
from repro.chem.smiles import from_smiles as jax_from_smiles
from repro.core import FilterCriteria as JaxCriteria
from repro.core import filter_molecules as jax_filter
from repro.data.datasets import antioxidant_dataset as jax_dataset
from repro_torch.chem.smiles import canonical_smiles, from_smiles
from repro_torch.core import FilterCriteria, filter_molecules
from repro_torch.data.datasets import antioxidant_dataset

KNOWN = ("CC1=CC=CC=C1O", "OC1=CC=C(O)C=C1", "CC(C)(C)C1=CC(C)=CC(C(C)(C)C)=C1O")
EXTRA = (
    ("C1=CC=CC=C1", None, 150.0),          # no O-H bond: no BDE
    ("CC1=CC=CC=C1O", 70.0, None),         # no valid conformer: no IP
    ("OC1=CC=C(O)C=C1", 70.0, 160.0),      # identical to a known antioxidant
    ("CCC1=CC=CC=C1O", 70.0, 160.0),       # near-duplicate of o-cresol
)
CRITERIA = {
    "paper": {},
    "loose": dict(bde_max=90.0, ip_min=100.0, sa_max=10.0),
    "similarity_ceiling": dict(tanimoto_max=0.3),
    "no_oh_required": dict(require_oh=False, bde_max=82.0),
}


def _candidates(dataset, parse):
    rng = np.random.default_rng(17)
    bde = rng.uniform(66.0, 86.0, len(dataset))
    ip = rng.uniform(130.0, 165.0, len(dataset))
    out = [(m, float(b), float(i)) for m, b, i in zip(dataset, bde, ip)]
    return out + [(parse(s), b, i) for s, b, i in EXTRA]


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_filter_matches_the_reference(name):
    want_mols, got_mols = jax_dataset(40, seed=5), antioxidant_dataset(40, seed=5)
    assert [canonical_smiles(m) for m in got_mols] == \
        [jax_canonical(m) for m in want_mols]
    want = jax_filter(_candidates(want_mols, jax_from_smiles),
                      [jax_from_smiles(s) for s in KNOWN], JaxCriteria(**CRITERIA[name]))
    got = filter_molecules(_candidates(got_mols, from_smiles),
                           [from_smiles(s) for s in KNOWN], FilterCriteria(**CRITERIA[name]))
    assert len(got) == len(want) == 44
    for g, w in zip(got, want):
        assert canonical_smiles(g.molecule) == jax_canonical(w.molecule)
        assert (g.bde, g.ip, g.sa, g.max_similarity, g.passed, g.reasons) == \
            (w.bde, w.ip, w.sa, w.max_similarity, w.passed, w.reasons), \
            f"{canonical_smiles(g.molecule)}: fields must be equal exactly (tolerance 0)"
    reasons = {r for g in got for r in g.reasons}
    # the special cases reach their branches under every criteria variant
    assert got[-3].reasons and "invalid_conformer" in got[-3].reasons
    assert "identical_to_known" in got[-2].reasons
    if name != "no_oh_required":
        assert got[-4].reasons[0] == "no_oh_bond"
    if name == "similarity_ceiling":
        assert "too_similar" in reasons
    if name == "loose":
        assert any(g.passed for g in got)
