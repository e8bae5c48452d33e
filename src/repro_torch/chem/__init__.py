"""Copy of ``repro.chem``; only its imports differ.

Self-contained chemistry substrate (the framework's RDKit replacement).

The paper (DA-MolDQN) relies on RDKit for molecule editing, valence
bookkeeping, Morgan fingerprints, 3D conformer embedding and SA scores, and
on Alfabet/AIMNet-NSE for BDE/IP prediction.  None of those ship in this
container, so this package implements the required subset from scratch:

``molecule``     graph molecules over {C, N, O} with implicit hydrogens,
                 valence rules and ring-size constraints (paper App. C:
                 allowed atoms C/O/N, allowed rings 3/5/6).
``actions``      MolDQN action enumeration (atom add / bond add / bond
                 remove / no-op) with the paper's O-H-bond protection.
``fingerprint``  Morgan/ECFP fingerprints, radius 3 folded to 2048 bits,
                 plus the paper's *incremental* variant (§3.6).
``smiles``       a SMILES-subset codec + canonicalisation.
``conformer``    deterministic 3D-conformer validity model + spectral
                 pseudo-coordinates (the AIMNet input stand-in).
``properties``   SA score / QED / penalised-logP surrogates (App. D).
``oracle``       closed-form BDE/IP ground truth with the paper's central
                 electron-donor trade-off (plays the role of DFT).
"""

from repro_torch.chem.molecule import Molecule, VALENCES, ELEMENTS, ALLOWED_RING_SIZES
from repro_torch.chem.actions import enumerate_actions, enumerate_actions_ref, Action
from repro_torch.chem.chemcache import ChemCache
from repro_torch.chem.fingerprint import (
    morgan_fingerprint, IncrementalMorgan, batch_fingerprints_incremental)
from repro_torch.chem.smiles import to_smiles, from_smiles, canonical_smiles
from repro_torch.chem.conformer import has_valid_conformer, conformer_features
from repro_torch.chem.properties import sa_score, qed_score, penalized_logp, tanimoto
from repro_torch.chem.oracle import oracle_bde, oracle_ip, oracle_properties

__all__ = [
    "Molecule", "VALENCES", "ELEMENTS", "ALLOWED_RING_SIZES",
    "enumerate_actions", "enumerate_actions_ref", "Action", "ChemCache",
    "morgan_fingerprint", "IncrementalMorgan", "batch_fingerprints_incremental",
    "to_smiles", "from_smiles", "canonical_smiles",
    "has_valid_conformer", "conformer_features",
    "sa_score", "qed_score", "penalized_logp", "tanimoto",
    "oracle_bde", "oracle_ip", "oracle_properties",
]
