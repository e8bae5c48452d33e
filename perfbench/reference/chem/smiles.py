"""Frozen copy of the port's ``repro_torch.chem.smiles`` (itself a copy of ``repro.chem.smiles``), kept for the benchmark's reference; only its imports differ.

A SMILES-subset codec for {C, N, O} molecules with implicit hydrogens.

Alfabet "accepts SMILES representation of molecules as input" (§2.2), the
datasets are SMILES files, and every figure in the paper renders molecules —
so the framework needs a text codec.  We implement the subset the action
space can produce: elements C/N/O, bond orders 1-3 (``-``/``=``/``#``,
single implicit), branches ``( )``, ring closures ``1``-``9`` and ``%nn``.
No aromatics (lowercase), charges, stereo or isotopes — the MolDQN action
space never creates them.

``canonical_smiles`` serialises from the molecule's canonical atom order, so
equal graphs produce equal strings (used for dataset files, the LRU cache
key and dedup).
"""

from __future__ import annotations

import numpy as np

from .molecule import (
    ELEMENT_INDEX,
    ELEMENTS,
    Molecule,
    refine_invariants,
    _canonical_order,
)

_BOND_CHARS = {1: "", 2: "=", 3: "#"}
_CHAR_BONDS = {"-": 1, "=": 2, "#": 3}


def to_smiles(mol: Molecule, order: list[int] | None = None) -> str:
    """Serialise a molecule (DFS with ring-closure digits)."""
    n = mol.num_atoms
    if n == 0:
        return ""
    if order is None:
        order = list(range(n))
    rank = {a: r for r, a in enumerate(order)}

    visited: set[int] = set()
    ring_bonds: dict[tuple[int, int], int] = {}   # (i,j) sorted -> closure no
    closure_counter = [0]

    # Pre-pass: find DFS tree edges vs ring-closure edges.
    tree_children: dict[int, list[int]] = {a: [] for a in range(n)}
    closures_at: dict[int, list[tuple[int, int]]] = {a: [] for a in range(n)}

    def explore(u: int, parent: int) -> None:
        visited.add(u)
        nbrs = sorted((int(v) for v in np.nonzero(mol.bonds[u])[0]), key=lambda v: rank[v])
        for v in nbrs:
            if v not in visited:
                tree_children[u].append(v)
                explore(v, u)
            elif v != parent:
                key = (min(u, v), max(u, v))
                if key not in ring_bonds:
                    closure_counter[0] += 1
                    num = closure_counter[0]
                    ring_bonds[key] = num
                    closures_at[u].append((v, num))
                    closures_at[v].append((u, num))

    roots = []
    for a in sorted(range(n), key=lambda x: rank[x]):
        if a not in visited:
            roots.append(a)
            explore(a, -1)

    emitted: set[int] = set()

    def write(u: int, parent: int) -> str:
        emitted.add(u)
        s = ""
        if parent >= 0:
            s += _BOND_CHARS[int(mol.bonds[parent, u])]
        s += ELEMENTS[int(mol.elements[u])]
        for v, num in closures_at[u]:
            key = (min(u, v), max(u, v))
            bond = _BOND_CHARS[int(mol.bonds[u, v])]
            tag = str(num) if num < 10 else f"%{num:02d}"
            # bond char goes on the first occurrence only (we put it on both
            # sides is illegal; standard allows either side — emit on opener)
            s += (bond if v not in emitted else "") + tag
        kids = tree_children[u]
        for k, v in enumerate(kids):
            if k < len(kids) - 1:
                s += "(" + write(v, u) + ")"
            else:
                s += write(v, u)
        return s

    return ".".join(write(r, -1) for r in roots)


def canonical_smiles(mol: Molecule) -> str:
    """SMILES from the canonical atom ordering — equal graphs, equal strings."""
    if mol.num_atoms == 0:
        return ""
    inv = refine_invariants(mol)
    order = _canonical_order(mol, inv)
    return to_smiles(mol, order)


def from_smiles(s: str) -> Molecule:
    """Parse the SMILES subset emitted by :func:`to_smiles`."""
    s = s.strip()
    if not s:
        return Molecule.empty()
    elements: list[int] = []
    bonds: list[tuple[int, int, int]] = []
    ring_open: dict[int, tuple[int, int]] = {}  # closure -> (atom, order)

    stack: list[int] = []
    prev = -1
    pending_order = 1
    i = 0
    while i < len(s):
        c = s[i]
        if c in _CHAR_BONDS:
            pending_order = _CHAR_BONDS[c]
            i += 1
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = -1
            pending_order = 1
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring_open:
                a, order0 = ring_open.pop(num)
                order = max(order0, pending_order)
                bonds.append((a, prev, order))
            else:
                ring_open[num] = (prev, pending_order)
            pending_order = 1
        elif c in ELEMENT_INDEX:
            idx = len(elements)
            elements.append(ELEMENT_INDEX[c])
            if prev >= 0:
                bonds.append((prev, idx, pending_order))
            prev = idx
            pending_order = 1
            i += 1
        elif c == "H":  # explicit H in brackets unsupported; skip bare H
            i += 1
        else:
            raise ValueError(f"unsupported SMILES char {c!r} in {s!r}")

    if ring_open:
        raise ValueError(f"unclosed ring closures {sorted(ring_open)} in {s!r}")
    n = len(elements)
    bm = np.zeros((n, n), dtype=np.int8)
    for a, b, o in bonds:
        bm[a, b] = bm[b, a] = o
    mol = Molecule(np.array(elements, dtype=np.int8), bm)
    mol.check_valences()
    return mol
