"""Frozen copy of the port's ``repro_torch.chem.conformer`` (itself a copy of ``repro.chem.conformer``), kept for the benchmark's reference; only its imports differ.

3D-conformer validity + pseudo-conformer features (the RDKit/ETKDG stand-in).

AIMNet-NSE consumes 3D conformers; MolDQN-generated molecules are only
guaranteed valid as 2D graphs, and some have *no* valid 3D embedding
(paper §3.3, Appendix B).  The paper's fix is not a rule system — it sets the
reward of conformer-less molecules to −1000 and lets the agent learn to
avoid them.  To reproduce that dynamic we need a deterministic "embedder"
that (a) fails on strained structures the way distance geometry does, and
(b) produces coordinates for the IP predictor otherwise.

Validity model (deterministic, strain-motivated — mirrors the classes of
failures App. B shows):

* any atom in >= 3 rings (bridgehead over-constraint);
* two rings of size <= 4 sharing an edge (fused cyclopropane strain);
* a triple bond inside any ring (sp centre forced to bend);
* an sp centre (two double bonds or a triple) inside a ring of size <= 5;
* a ring of size 3 containing any double bond plus a substituted atom of
  degree 4 (over-pyramidalised).

Pseudo-coordinates: spectral embedding — the 3 non-trivial eigenvectors of
the graph Laplacian scaled by bond lengths.  Deterministic, O(n^3), and
smooth under single edits, which is all the surrogate IP net needs.
"""

from __future__ import annotations

import numpy as np

from .molecule import Molecule


def has_valid_conformer(mol: Molecule) -> bool:
    """Deterministic distance-geometry-style feasibility check."""
    n = mol.num_atoms
    if n == 0:
        return False
    rings = mol.ring_info()
    ring_sets = [frozenset(r) for r in rings]
    membership = np.zeros(n, dtype=np.int32)
    for r in ring_sets:
        for a in r:
            membership[a] += 1

    # bridgehead over-constraint
    if np.any(membership >= 3):
        return False

    # fused small rings sharing an edge
    for a in range(len(ring_sets)):
        for b in range(a + 1, len(ring_sets)):
            shared = ring_sets[a] & ring_sets[b]
            if len(shared) >= 2 and min(len(ring_sets[a]), len(ring_sets[b])) <= 4:
                return False

    in_ring_pair = np.zeros((n, n), dtype=bool)
    for r in rings:
        rs = list(r)
        for x in range(len(rs)):
            for y in range(x + 1, len(rs)):
                in_ring_pair[rs[x], rs[y]] = in_ring_pair[rs[y], rs[x]] = True

    for i in range(n):
        orders = mol.bonds[i][mol.bonds[i] > 0]
        n_double = int(np.sum(orders == 2))
        n_triple = int(np.sum(orders == 3))
        is_sp = n_triple >= 1 or n_double >= 2
        if membership[i] >= 1:
            ring_sizes = [len(r) for r in ring_sets if i in r]
            # triple bond in a ring
            if n_triple >= 1:
                return False
            # sp centre (cumulene) in small ring
            if is_sp and min(ring_sizes) <= 5:
                return False
            # strained substituted cyclopropene
            if min(ring_sizes) == 3 and n_double >= 1 and mol.degree(i) >= 4:
                return False
    return True


# idealised bond lengths (angstrom-ish), order-indexed
_BOND_LEN = {1: 1.5, 2: 1.34, 3: 1.2}


def conformer_coordinates(mol: Molecule) -> np.ndarray:
    """Deterministic pseudo-3D coordinates: weighted-Laplacian spectral embed.

    float64[n, 3].  Raises ValueError if the molecule has no valid conformer
    (mirrors an RDKit embed failure).
    """
    if not has_valid_conformer(mol):
        raise ValueError("no valid 3D conformer")
    n = mol.num_atoms
    if n == 1:
        return np.zeros((1, 3))
    w = np.zeros((n, n))
    for i in range(n):
        for j in np.nonzero(mol.bonds[i])[0]:
            w[i, j] = 1.0 / _BOND_LEN[int(mol.bonds[i, j])]
    lap = np.diag(w.sum(axis=1)) - w
    vals, vecs = np.linalg.eigh(lap)
    # skip the trivial 0-eigenvector(s); take next three, pad if tiny
    order = np.argsort(vals)
    nontrivial = [k for k in order if vals[k] > 1e-9][:3]
    coords = np.zeros((n, 3))
    for d, k in enumerate(nontrivial):
        coords[:, d] = vecs[:, k] / np.sqrt(max(vals[k], 1e-9))
    # scale to mean bond length ~1.5
    dists = [np.linalg.norm(coords[i] - coords[j])
             for i in range(n) for j in np.nonzero(mol.bonds[i])[0] if j > i]
    if dists and np.mean(dists) > 1e-12:
        coords *= 1.5 / np.mean(dists)
    return coords


CONFORMER_FEATURE_DIM = 8


def conformer_features(mol: Molecule, max_atoms: int) -> np.ndarray:
    """Per-atom geometric features for the IP predictor (AIMNet-S input).

    float32[max_atoms, CONFORMER_FEATURE_DIM]:
    radial distance from centroid, local crowding (#atoms within 2.2A),
    mean/min neighbour distance, coordination shell stats.
    Raises ValueError when no valid conformer exists (callers translate this
    to the paper's -1000 reward).
    """
    coords = conformer_coordinates(mol)
    n = mol.num_atoms
    out = np.zeros((max_atoms, CONFORMER_FEATURE_DIM), dtype=np.float32)
    centroid = coords.mean(axis=0)
    d2c = np.linalg.norm(coords - centroid, axis=1)
    pair = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    np.fill_diagonal(pair, np.inf)
    for i in range(n):
        out[i, 0] = d2c[i]
        out[i, 1] = float(np.sum(pair[i] < 2.2))
        finite = pair[i][np.isfinite(pair[i])]
        out[i, 2] = float(finite.mean()) if finite.size else 0.0
        out[i, 3] = float(finite.min()) if finite.size else 0.0
        bonded = np.nonzero(mol.bonds[i])[0]
        if bonded.size:
            out[i, 4] = float(pair[i, bonded].mean())
            out[i, 5] = float(pair[i, bonded].max())
        out[i, 6] = float(np.sum(pair[i] < 3.0))
        out[i, 7] = float(coords[i, 2])
    return out
