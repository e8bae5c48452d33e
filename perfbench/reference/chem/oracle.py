"""Frozen copy of the port's ``repro_torch.chem.oracle`` (itself a copy of ``repro.chem.oracle``), kept for the benchmark's reference; only its imports differ.

Closed-form BDE/IP ground truth — the framework's "DFT".

The real paper trains its predictors (Alfabet, AIMNet-NSE) on DFT data we
cannot compute here.  This module supplies a deterministic, chemically
structured oracle that reproduces the *decision structure* the paper's RL
agent must learn (§2.1):

* **BDE** (O-H bond strength, lower = better antioxidant) is a *local*
  property of each O-H oxygen: electron-donating groups (EDGs — methyl /
  alkyl carbons, amino nitrogens, ether/hydroxy oxygens) near the oxygen
  stabilise the radical and lower BDE, with ortho/para-like graph-distance
  weighting and a phenol-vs-alcohol base split.  Molecular BDE = min over
  all O-H oxygens (paper §2.1).

* **IP** (stability, higher = better) is a *global* property: every EDG in
  the molecule lowers IP, as does conjugation (6-rings).

This yields exactly the paper's Pareto trade-off: stacking donors lowers
BDE *and* IP ("it's not possible to stack five dimethyl amino groups...",
§2.1).  The optimum is a few donors placed ortho/para to one O-H and a
skeleton otherwise free of donors — a structure the DQN can discover.

A small structure-keyed jitter (BLAKE2 of the canonical key) keeps the
mapping non-trivial for the learned predictors while staying well inside
the paper's <5% predictor-error envelope.

Units are kcal/mol to match the paper's thresholds: effective antioxidant
BDE < 76, stable IP > 145.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .molecule import ELEMENT_INDEX, Molecule

# --- tunables (calibrated against repro.data.datasets distributions) ---- #
BDE_BASE_ALCOHOL = 96.0      # aliphatic O-H with no stabilisation
BDE_BASE_PHENOL = 85.0       # O-H on a 6-ring carbon (resonance base)
BDE_DONOR_GAIN = 3.1         # kcal/mol per unit of local donor score
BDE_JITTER = 1.0
BDE_CLIP = (55.0, 115.0)

IP_BASE = 200.0
IP_DONOR_GAIN = 9.0          # global donor score lowers IP (strongly: Table 5
                             # shows 30-50 kcal/mol IP swings from edits)
IP_RING6_GAIN = 6.0          # conjugation lowers IP
IP_RING5_GAIN = 3.0
IP_TRIPLE_GAIN = -2.5        # triple bonds (EWG-ish) raise IP
IP_JITTER = 2.0
IP_CLIP = (95.0, 230.0)

# ortho(2)/para(4) > adjacent(1) > meta(3) >> remote
_DIST_WEIGHT = {1: 1.20, 2: 1.00, 3: 0.30, 4: 0.90, 5: 0.15, 6: 0.10}


def _jitter(mol: Molecule, salt: bytes, amplitude: float) -> float:
    h = hashlib.blake2b(mol.canonical_key().encode() + salt, digest_size=8)
    u = int.from_bytes(h.digest(), "little") / 2 ** 64  # [0,1)
    return amplitude * (2.0 * u - 1.0)


def donor_weights(mol: Molecule) -> np.ndarray:
    """Electron-donating strength per atom (0 for non-donors)."""
    n = mol.num_atoms
    w = np.zeros(n, dtype=np.float64)
    fv = mol.free_valences()
    for i in range(n):
        e = int(mol.elements[i])
        if e == ELEMENT_INDEX["C"]:
            h = int(fv[i])
            if h >= 3:
                w[i] = 1.0       # methyl
            elif h == 2:
                w[i] = 0.55      # methylene
        elif e == ELEMENT_INDEX["N"]:
            if fv[i] >= 1 and not _has_multiple_bond(mol, i):
                w[i] = 1.6       # amino
            elif not _has_multiple_bond(mol, i):
                w[i] = 1.2       # tertiary amine
        elif e == ELEMENT_INDEX["O"]:
            if not _has_multiple_bond(mol, i):
                w[i] = 1.1       # hydroxy / ether
    return w


def _has_multiple_bond(mol: Molecule, i: int) -> bool:
    return bool(np.any(mol.bonds[i] >= 2))


def _ring_size_counts(mol: Molecule) -> dict[int, int]:
    counts: dict[int, int] = {}
    for r in mol.ring_info():
        counts[len(r)] = counts.get(len(r), 0) + 1
    return counts


def oracle_bde(mol: Molecule) -> float | None:
    """Lowest O-H BDE over the molecule, or None if no O-H bond exists."""
    oxys = mol.oh_oxygens()
    if oxys.size == 0:
        return None
    sp = mol.all_pairs_shortest_paths()
    donors = donor_weights(mol)
    ring_atoms6 = set()
    for r in mol.ring_info():
        if len(r) == 6:
            ring_atoms6.update(r)

    best = None
    for o in oxys.tolist():
        nbrs = mol.neighbors(o)
        phenol_like = any(int(v) in ring_atoms6 for v in nbrs)
        base = BDE_BASE_PHENOL if phenol_like else BDE_BASE_ALCOHOL
        local = 0.0
        for a in range(mol.num_atoms):
            if a == o or donors[a] == 0.0:
                continue
            d = int(sp[o, a])
            if d <= 0:
                continue
            local += donors[a] * _DIST_WEIGHT.get(d, 0.0)
        bde = base - BDE_DONOR_GAIN * local
        best = bde if best is None else min(best, bde)

    best += _jitter(mol, b"bde", BDE_JITTER)
    return float(np.clip(best, *BDE_CLIP))


def oracle_ip(mol: Molecule) -> float:
    """Ionisation potential of the molecule (always defined)."""
    donors = donor_weights(mol)
    rings = _ring_size_counts(mol)
    triples = int(np.sum(np.triu(mol.bonds) == 3))
    ip = (
        IP_BASE
        - IP_DONOR_GAIN * float(donors.sum())
        - IP_RING6_GAIN * rings.get(6, 0)
        - IP_RING5_GAIN * rings.get(5, 0)
        - IP_TRIPLE_GAIN * triples
    )
    ip += _jitter(mol, b"ip", IP_JITTER)
    return float(np.clip(ip, *IP_CLIP))


def oracle_properties(mol: Molecule) -> dict[str, float | None]:
    """Both properties at once (the "run DFT on this molecule" call)."""
    return {"bde": oracle_bde(mol), "ip": oracle_ip(mol)}
