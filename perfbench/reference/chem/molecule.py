"""Frozen copy of the port's ``repro_torch.chem.molecule`` (itself a copy of ``repro.chem.molecule``), kept for the benchmark's reference; only its imports differ.

Graph molecules over {C, N, O} with implicit hydrogens.

This is the data structure the whole RL environment edits.  The design goals
are (in order): correctness of the valence/ring bookkeeping, cheap copies
(the action enumerator materialises ~10^2 candidate molecules per step), and
a stable canonical key for caching and dedup.

Representation
--------------
``elements``  int8[n]    0=C, 1=N, 2=O
``bonds``     int8[n,n]  symmetric bond-order matrix (0..3), zero diagonal

Hydrogens are implicit: ``implicit_h(i) = valence(element) - total_order(i)``
and must stay >= 0 — every mutator enforces this.

Ring rules follow the paper (Appendix C): new rings may only have size
3, 5 or 6.  Ring size on bond addition between already-connected atoms is
``shortest_path(i, j) + 1``.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Iterable

import numpy as np

# Element table.  The paper restricts the action space to C, O, N (App. C).
ELEMENTS: tuple[str, ...] = ("C", "N", "O")
ELEMENT_INDEX: dict[str, int] = {e: i for i, e in enumerate(ELEMENTS)}
VALENCES: tuple[int, ...] = (4, 3, 2)  # C, N, O

# Allowed ring sizes when a bond addition closes a cycle (paper App. C).
ALLOWED_RING_SIZES: frozenset[int] = frozenset({3, 5, 6})

MAX_BOND_ORDER = 3


class Molecule:
    """A small organic molecule as an undirected bond-order graph."""

    __slots__ = ("elements", "bonds", "_canon_cache", "_iso_cache",
                 "_fv_cache", "_apsp_cache")

    def __init__(self, elements: np.ndarray, bonds: np.ndarray):
        self.elements = np.asarray(elements, dtype=np.int8)
        self.bonds = np.asarray(bonds, dtype=np.int8)
        n = self.elements.shape[0]
        if self.bonds.shape != (n, n):
            raise ValueError(f"bonds shape {self.bonds.shape} != ({n},{n})")
        self._canon_cache: str | None = None
        self._iso_cache: int | None = None
        self._fv_cache: np.ndarray | None = None
        self._apsp_cache: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_element(cls, symbol: str) -> "Molecule":
        """Single heavy atom (e.g. methane when symbol == 'C')."""
        idx = ELEMENT_INDEX[symbol]
        return cls(np.array([idx], dtype=np.int8), np.zeros((1, 1), dtype=np.int8))

    @classmethod
    def empty(cls) -> "Molecule":
        return cls(np.zeros((0,), dtype=np.int8), np.zeros((0, 0), dtype=np.int8))

    def copy(self) -> "Molecule":
        return Molecule(self.elements.copy(), self.bonds.copy())

    # ------------------------------------------------------------------ #
    # basic queries
    # ------------------------------------------------------------------ #
    @property
    def num_atoms(self) -> int:
        return int(self.elements.shape[0])

    @property
    def num_bonds(self) -> int:
        """Number of bonded atom pairs (order ignored)."""
        return int(np.count_nonzero(np.triu(self.bonds)))

    @property
    def total_bond_order(self) -> int:
        return int(np.triu(self.bonds).sum())

    def symbol(self, i: int) -> str:
        return ELEMENTS[int(self.elements[i])]

    def valence(self, i: int) -> int:
        return VALENCES[int(self.elements[i])]

    def degree(self, i: int) -> int:
        return int(np.count_nonzero(self.bonds[i]))

    def total_order(self, i: int) -> int:
        return int(self.bonds[i].sum())

    def implicit_h(self, i: int) -> int:
        return self.valence(i) - self.total_order(i)

    def free_valence(self, i: int) -> int:
        return self.implicit_h(i)

    def free_valences(self) -> np.ndarray:
        """Vectorised free valence for every atom: int array [n].

        Memoized (molecules are immutable by convention — the enumerator
        calls this several times per step) and returned READ-ONLY; copy
        before mutating.
        """
        if self._fv_cache is None:
            vals = np.asarray(VALENCES, dtype=np.int16)[self.elements]
            fv = vals - self.bonds.sum(axis=1, dtype=np.int16)
            fv.flags.writeable = False
            self._fv_cache = fv
        return self._fv_cache

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.bonds[i])[0]

    def has_oh_bond(self) -> bool:
        """True iff some oxygen carries at least one implicit hydrogen.

        The paper's BDE property is min over O-H bonds, so molecules without
        any O-H are rejected by the protected action enumerator (§3.3).
        """
        fv = self.free_valences()
        return bool(np.any((self.elements == ELEMENT_INDEX["O"]) & (fv >= 1)))

    def oh_oxygens(self) -> np.ndarray:
        fv = self.free_valences()
        return np.nonzero((self.elements == ELEMENT_INDEX["O"]) & (fv >= 1))[0]

    def heavy_formula(self) -> str:
        counts = np.bincount(self.elements, minlength=len(ELEMENTS))
        return "".join(f"{e}{int(c)}" for e, c in zip(ELEMENTS, counts) if c)

    # ------------------------------------------------------------------ #
    # graph algorithms
    # ------------------------------------------------------------------ #
    def shortest_path_length(self, i: int, j: int) -> int:
        """BFS hop distance between atoms i and j; -1 if disconnected."""
        if i == j:
            return 0
        n = self.num_atoms
        dist = np.full(n, -1, dtype=np.int32)
        dist[i] = 0
        q = deque([i])
        while q:
            u = q.popleft()
            for v in np.nonzero(self.bonds[u])[0]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    if v == j:
                        return int(dist[v])
                    q.append(int(v))
        return -1

    def all_pairs_shortest_paths(self) -> np.ndarray:
        """Hop-distance matrix via repeated BFS.  -1 for disconnected pairs.

        Memoized like :meth:`free_valences` (the action enumerator needs it
        once per enumeration for the ring-size rule, the oracle again for
        BDE); the cached array is READ-ONLY.
        """
        if self._apsp_cache is not None:
            return self._apsp_cache
        n = self.num_atoms
        out = np.full((n, n), -1, dtype=np.int32)
        for s in range(n):
            out[s, s] = 0
            q = deque([s])
            while q:
                u = q.popleft()
                for v in np.nonzero(self.bonds[u])[0]:
                    if out[s, v] < 0:
                        out[s, v] = out[s, u] + 1
                        q.append(int(v))
        out.flags.writeable = False
        self._apsp_cache = out
        return out

    def connected_components(self) -> list[np.ndarray]:
        n = self.num_atoms
        seen = np.zeros(n, dtype=bool)
        comps: list[np.ndarray] = []
        for s in range(n):
            if seen[s]:
                continue
            q = deque([s])
            seen[s] = True
            comp = [s]
            while q:
                u = q.popleft()
                for v in np.nonzero(self.bonds[u])[0]:
                    if not seen[v]:
                        seen[v] = True
                        comp.append(int(v))
                        q.append(int(v))
            comps.append(np.array(sorted(comp), dtype=np.int64))
        return comps

    def is_connected(self) -> bool:
        return self.num_atoms <= 1 or len(self.connected_components()) == 1

    def ring_info(self) -> list[list[int]]:
        """Smallest-set-of-smallest-rings approximation.

        Returns a list of rings (atom index lists).  We compute, for every
        bond in a cycle, the smallest cycle through it (BFS with the bond
        removed), then dedup.  Exact SSSR is overkill for <= 6-rings.
        """
        rings: dict[frozenset[int], list[int]] = {}
        n = self.num_atoms
        for i in range(n):
            for j in np.nonzero(self.bonds[i])[0]:
                j = int(j)
                if j <= i:
                    continue
                # shortest i->j path avoiding the (i, j) bond.  The bond is
                # EXCLUDED in the traversal, never zeroed on self.bonds: the
                # pipelined rollout reads molecules from host threads while
                # the property path calls ring_info(), so even a
                # restored-immediately mutation here is a data race.
                path = self._bfs_path(i, j, skip_edge=(i, j))
                if path is not None:
                    key = frozenset(path)
                    if key not in rings or len(path) < len(rings[key]):
                        rings[key] = path
        return list(rings.values())

    def _bfs_path(self, src: int, dst: int,
                  skip_edge: tuple[int, int] | None = None) -> list[int] | None:
        n = self.num_atoms
        a, b = skip_edge if skip_edge is not None else (-1, -1)
        prev = np.full(n, -2, dtype=np.int32)
        prev[src] = -1
        q = deque([src])
        while q:
            u = q.popleft()
            if u == dst:
                path = [dst]
                while prev[path[-1]] >= 0:
                    path.append(int(prev[path[-1]]))
                return path[::-1]
            for v in np.nonzero(self.bonds[u])[0]:
                v = int(v)
                if (u == a and v == b) or (u == b and v == a):
                    continue
                if prev[v] == -2:
                    prev[v] = u
                    q.append(v)
        return None

    def atom_ring_membership(self) -> np.ndarray:
        """int[n]: number of rings each atom belongs to."""
        counts = np.zeros(self.num_atoms, dtype=np.int32)
        for ring in self.ring_info():
            for a in ring:
                counts[a] += 1
        return counts

    # ------------------------------------------------------------------ #
    # mutators (all return NEW molecules; Molecule is treated as immutable
    # by the environment so replay-buffer entries can alias safely)
    # ------------------------------------------------------------------ #
    def with_added_atom(self, symbol: str, attach_to: int, order: int) -> "Molecule":
        """Append a new atom bonded to ``attach_to`` with ``order``."""
        e = ELEMENT_INDEX[symbol]
        if order < 1 or order > MAX_BOND_ORDER:
            raise ValueError(f"bad bond order {order}")
        if order > VALENCES[e]:
            raise ValueError(f"order {order} exceeds valence of {symbol}")
        if self.free_valence(attach_to) < order:
            raise ValueError("insufficient free valence on anchor atom")
        n = self.num_atoms
        elements = np.append(self.elements, np.int8(e))
        bonds = np.zeros((n + 1, n + 1), dtype=np.int8)
        bonds[:n, :n] = self.bonds
        bonds[n, attach_to] = bonds[attach_to, n] = order
        return Molecule(elements, bonds)

    def with_bond_delta(self, i: int, j: int, delta: int) -> "Molecule":
        """Increase (+) or decrease (-) the order of bond (i, j) by |delta|."""
        if i == j:
            raise ValueError("self bond")
        cur = int(self.bonds[i, j])
        new = cur + delta
        if new < 0 or new > MAX_BOND_ORDER:
            raise ValueError(f"bond order out of range: {cur} -> {new}")
        if delta > 0 and (self.free_valence(i) < delta or self.free_valence(j) < delta):
            raise ValueError("insufficient free valence")
        bonds = self.bonds.copy()
        bonds[i, j] = bonds[j, i] = new
        return Molecule(self.elements.copy(), bonds)

    def largest_fragment(self) -> "Molecule":
        """Keep the largest connected component (paper Fig. 6: 'unconnected
        atoms are removed').  Ties prefer the fragment with more oxygens."""
        comps = self.connected_components()
        if len(comps) <= 1:
            return self
        def score(c: np.ndarray) -> tuple[int, int]:
            return (len(c), int(np.sum(self.elements[c] == ELEMENT_INDEX["O"])))
        best = max(comps, key=score)
        return self.subgraph(best)

    def subgraph(self, atom_indices: np.ndarray) -> "Molecule":
        idx = np.asarray(atom_indices, dtype=np.int64)
        return Molecule(self.elements[idx], self.bonds[np.ix_(idx, idx)])

    # ------------------------------------------------------------------ #
    # invariants / hashing
    # ------------------------------------------------------------------ #
    def check_valences(self) -> None:
        fv = self.free_valences()
        if np.any(fv < 0):
            bad = np.nonzero(fv < 0)[0]
            raise AssertionError(f"valence violated at atoms {bad.tolist()}")
        if np.any(self.bonds < 0) or np.any(self.bonds > MAX_BOND_ORDER):
            raise AssertionError("bond order out of range")
        if np.any(np.diag(self.bonds) != 0):
            raise AssertionError("self bond present")
        if not np.array_equal(self.bonds, self.bonds.T):
            raise AssertionError("bond matrix not symmetric")

    def canonical_key(self) -> str:
        """A canonical string key: invariant under atom relabelling.

        Uses iterative Morgan-style invariant refinement, then a
        lexicographically-minimal adjacency serialisation over the refined
        classes.  Cached (molecules are immutable by convention).
        """
        if self._canon_cache is None:
            self._canon_cache = _canonical_key(self)
        return self._canon_cache

    def iso_key(self) -> int:
        """Fast isomorphism-invariant hash (see :func:`iso_hash`); cached."""
        if self._iso_cache is None:
            self._iso_cache = iso_hash(self)
        return self._iso_cache

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Molecule) and self.canonical_key() == other.canonical_key()

    def __hash__(self) -> int:
        return hash(self.canonical_key())

    def __repr__(self) -> str:
        return f"Molecule({self.heavy_formula()}, bonds={self.num_bonds})"


# ---------------------------------------------------------------------- #
# vectorised 64-bit hashing (the analogue of the paper's C++ port: the
# original per-atom cryptographic hashing was the profiled hot spot; the
# production path below is branch-free numpy over uint64 with a
# splitmix64 finaliser and a *commutative* neighbour combine, so a full
# refinement round is three masked matvecs instead of n python loops).
# ---------------------------------------------------------------------- #
_SM_C0 = np.uint64(0x9E3779B97F4A7C15)
_SM_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_C2 = np.uint64(0x94D049BB133111EB)
# per-bond-order salts so (order, neighbour) pairs hash distinctly
_ORDER_SALT = np.array(
    [0x0, 0xA24BAED4963EE407, 0x9FB21C651E98DF25, 0xD6E8FEB86659FD93],
    dtype=np.uint64,
)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser over uint64 arrays (wraps mod 2^64).

    In-place on a working copy: the whole chemistry layer is memory-bound on
    this mixer's [k, m, m] temporaries, so two allocations beat eight.
    """
    z = x.astype(np.uint64)                  # always copies
    z += _SM_C0
    t = z >> np.uint64(30)
    z ^= t
    z *= _SM_C1
    np.right_shift(z, np.uint64(27), out=t)
    z ^= t
    z *= _SM_C2
    np.right_shift(z, np.uint64(31), out=t)
    z ^= t
    return z


def initial_invariants(mol: Molecule) -> np.ndarray:
    """Degree/element/valence-derived initial atom invariants (uint64)."""
    fv = mol.free_valences().astype(np.int64)
    deg = np.count_nonzero(mol.bonds, axis=1).astype(np.int64)
    tot = mol.bonds.sum(axis=1, dtype=np.int64)
    el = mol.elements.astype(np.int64)
    packed = (((el * 64 + deg) * 64 + tot) * 64 + fv).astype(np.uint64)
    return splitmix64(packed)


def neighbor_combine(bonds: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """Commutative neighbour aggregation: sum_j mix(inv_j ^ salt[order_ij]).

    Commutativity (sum) removes the per-atom neighbour sort of classic
    Morgan; 64-bit mixing keeps accidental collisions negligible.  Works on
    a single molecule (``bonds [n,n]``, ``inv [n]``) or a padded batch
    (``bonds [k,n,n]``, ``inv [k,n]``) with one splitmix64 pass either way.
    """
    salted = inv[..., None, :] ^ _ORDER_SALT[bonds]
    mixed = splitmix64(salted)
    return np.where(bonds > 0, mixed, np.uint64(0)).sum(axis=-1, dtype=np.uint64)


def refine_once(bonds: np.ndarray, inv: np.ndarray) -> np.ndarray:
    return splitmix64(splitmix64(inv) + neighbor_combine(bonds, inv))


def refine_invariants(mol: Molecule, rounds: int | None = None) -> np.ndarray:
    """Morgan refinement of atom invariants until class-stable (or ``rounds``)."""
    inv = initial_invariants(mol)
    n = mol.num_atoms
    max_rounds = rounds if rounds is not None else max(n, 1)
    n_classes = len(np.unique(inv))
    for _ in range(max_rounds):
        new = refine_once(mol.bonds, inv)
        new_classes = len(np.unique(new))
        inv = new
        if new_classes == n_classes:
            break
        n_classes = new_classes
    return inv


_PAD_VALENCE = np.array(list(VALENCES) + [0], dtype=np.int64)  # index 3 = pad


def iso_hashes_from_padded(el: np.ndarray, bonds: np.ndarray, sizes: np.ndarray,
                           rounds: int = 5) -> np.ndarray:
    """Batched iso hashes over prebuilt padded arrays (``el`` int64[k, m]
    with 3 = padding element, ``bonds`` int8[k, m, m], ``sizes`` int64[k]).

    The array-level core of :func:`iso_hashes_batch` — the delta action
    enumerator calls it directly on candidate arrays built from edit
    descriptors, skipping the per-candidate ``Molecule`` materialisation.
    Returns uint64[k].
    """
    m_max = el.shape[1]
    tot = bonds.sum(axis=2, dtype=np.int64)
    deg = np.count_nonzero(bonds, axis=2)
    fv = _PAD_VALENCE[el] - tot
    packed = (((el * 64 + deg) * 64 + tot) * 64 + (fv + 8)).astype(np.uint64)
    inv = splitmix64(packed)                              # [k, m]
    for _ in range(rounds):
        inv = splitmix64(splitmix64(inv) + neighbor_combine(bonds, inv))
    inv = np.sort(inv, axis=1)
    pos = splitmix64(np.arange(m_max, dtype=np.uint64))
    mixed = splitmix64(inv ^ pos[None, :]).sum(axis=1, dtype=np.uint64)
    return splitmix64(mixed ^ splitmix64(sizes.astype(np.uint64)))


def iso_hashes_batch(mols: list["Molecule"], rounds: int = 5) -> list[int]:
    """Isomorphism-invariant hashes for a *batch* of molecules at once.

    This is the paper's "batched modification" idea (§3.1) applied to the
    hashing hot loop: the action enumerator produces ~10^2 candidate
    molecules per environment step, and hashing them one by one pays the
    numpy dispatch overhead ~10^2 x ~20 times.  Padding every candidate to
    the batch max and running ONE vectorised refinement brings that down to
    ~10 array ops total.  Hash values equal :func:`iso_hash` semantics
    (equal iff isomorphic, up to 2^-64 collisions) but are a *different*
    hash family (padding participates), so don't mix the two.
    """
    k = len(mols)
    if k == 0:
        return []
    sizes = np.array([m.num_atoms for m in mols], dtype=np.int64)
    m_max = max(int(sizes.max()), 1)
    el = np.full((k, m_max), 3, dtype=np.int64)          # 3 = padding element
    bonds = np.zeros((k, m_max, m_max), dtype=np.int8)
    for b, mol in enumerate(mols):
        n = mol.num_atoms
        el[b, :n] = mol.elements
        bonds[b, :n, :n] = mol.bonds
    return [int(h) for h in iso_hashes_from_padded(el, bonds, sizes, rounds)]


def iso_hash(mol: Molecule) -> int:
    """Fast isomorphism-invariant molecule hash (used for action dedup and
    the property cache).  Equal graphs always hash equal; distinct graphs
    collide with ~2^-64 probability per pair."""
    if mol.num_atoms == 0:
        return 0
    # Fixed-round refinement is isomorphism-invariant regardless of class
    # stability, and 5 rounds separates everything a radius-3 fingerprint
    # can see; full stable refinement is reserved for canonical_key().
    inv = np.sort(refine_invariants(mol, rounds=5))
    pos = splitmix64(np.arange(inv.shape[0], dtype=np.uint64))
    mixed = splitmix64(inv ^ pos)
    return int(splitmix64(mixed.sum(dtype=np.uint64)[None])[0])


def _canonical_key(mol: Molecule) -> str:
    n = mol.num_atoms
    if n == 0:
        return "<empty>"
    inv = refine_invariants(mol)
    # Break remaining symmetry deterministically: order atoms by (invariant,
    # element), then by a canonical BFS from the smallest-invariant atom.
    order = _canonical_order(mol, inv)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    parts = [",".join(ELEMENTS[int(mol.elements[a])] for a in order)]
    edges = []
    for i in range(n):
        for j in np.nonzero(mol.bonds[i])[0]:
            j = int(j)
            if j > i:
                a, b = sorted((int(pos[i]), int(pos[j])))
                edges.append((a, b, int(mol.bonds[i, j])))
    edges.sort()
    parts.append(";".join(f"{a}-{b}:{o}" for a, b, o in edges))
    return "|".join(parts)


def _canonical_order(mol: Molecule, inv: np.ndarray) -> list[int]:
    """Deterministic atom ordering: BFS from the minimal invariant atom,
    expanding neighbours in (invariant, bond order) order.  Symmetric atoms
    get an arbitrary-but-deterministic order, which is fine for a key (two
    isomorphic graphs still serialise identically because expansion is driven
    purely by invariants)."""
    n = mol.num_atoms
    start = int(np.lexsort((np.arange(n), inv))[0])
    seen = [False] * n
    order: list[int] = []
    # deterministic multi-source: loop components
    pending = sorted(range(n), key=lambda a: (int(inv[a]), a))
    for src in pending:
        if seen[src]:
            continue
        q = deque([src])
        seen[src] = True
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = sorted(
                (int(inv[v]), int(mol.bonds[u, v]), int(v))
                for v in np.nonzero(mol.bonds[u])[0]
                if not seen[v]
            )
            for _, _, v in nbrs:
                if not seen[v]:
                    seen[v] = True
                    q.append(v)
    return order


# ---------------------------------------------------------------------- #
# array export for the GNN predictors
# ---------------------------------------------------------------------- #
def to_graph_arrays(mol: Molecule, max_atoms: int) -> dict[str, np.ndarray]:
    """Pad a molecule to fixed-size arrays for batched GNN inference.

    Returns ``atom_feat`` f32[max_atoms, F], ``adj`` f32[max_atoms, max_atoms,
     3] (one channel per bond order), ``mask`` f32[max_atoms].
    """
    n = mol.num_atoms
    if n > max_atoms:
        raise ValueError(f"molecule has {n} atoms > max_atoms={max_atoms}")
    fv = mol.free_valences()
    feat = np.zeros((max_atoms, ATOM_FEATURE_DIM), dtype=np.float32)
    for i in range(n):
        e = int(mol.elements[i])
        feat[i, e] = 1.0                                   # element one-hot (3)
        feat[i, 3 + min(mol.degree(i), 4)] = 1.0           # degree one-hot (5)
        feat[i, 8 + min(int(fv[i]), 4)] = 1.0              # implicit H one-hot (5)
        feat[i, 13] = mol.total_order(i) / 4.0             # scaled total order
        feat[i, 14] = 1.0 if (e == ELEMENT_INDEX["O"] and fv[i] >= 1) else 0.0  # O-H flag
    rings = mol.atom_ring_membership()
    for i in range(n):
        feat[i, 15] = min(int(rings[i]), 3) / 3.0          # ring membership
    adj = np.zeros((max_atoms, max_atoms, MAX_BOND_ORDER), dtype=np.float32)
    for order in range(1, MAX_BOND_ORDER + 1):
        sel = (mol.bonds == order)
        adj[:n, :n, order - 1] = sel.astype(np.float32)
    mask = np.zeros((max_atoms,), dtype=np.float32)
    mask[:n] = 1.0
    return {"atom_feat": feat, "adj": adj, "mask": mask}


ATOM_FEATURE_DIM = 16
