"""Frozen copy of the port's ``repro_torch.chem.actions`` (itself a copy of ``repro.chem.actions``), kept for the benchmark's reference; only its imports differ.

MolDQN action enumeration with the paper's O-H-bond protection (§3.3).

One environment step enumerates every *valid* single edit of the current
molecule:

* **atom addition** — attach a new C/N/O atom to any atom with free valence,
  with bond order 1..min(free valence, new-atom valence);
* **bond addition / order increase** — between two existing atoms with
  sufficient free valence; closing a new ring is only allowed for ring sizes
  in ``ALLOWED_RING_SIZES`` (3/5/6, paper App. C);
* **bond order decrease / removal** — decrease by 1..order; if the molecule
  falls apart, disconnected atoms are dropped (largest fragment kept,
  paper Fig. 6);
* **no-op** — keep the current molecule (lets the agent "stop early").

Protection (§3.3): every candidate that has *no remaining O-H bond* is
discarded, because BDE (min over O-H bonds) would be undefined.  The paper
notes this removes only a few of >100 candidates.

Three implementations are provided, in decreasing order of speed:

``enumerate_actions``        DELTA enumeration (the production path).  It
                             never materialises a candidate molecule up
                             front: candidates are *edit descriptors*
                             (kind + detail against the parent), the
                             valence / ring-size / O-H-protection filters
                             run as array masks over those descriptors, the
                             isomorphism dedup hashes padded candidate
                             arrays built directly from the edits, and the
                             returned ``Action``s materialise their
                             ``result`` lazily — in the rollout engine only
                             the *chosen* action ever builds a full
                             ``Molecule``.  (The only eager materialisation
                             is full bond removals, which may drop a
                             fragment and re-index atoms.)
``enumerate_actions_ref``    the previous vectorised materialise-then-filter
                             implementation — kept as the CORRECTNESS
                             REFERENCE: tests pin ``enumerate_actions`` to
                             produce the identical action list (same order,
                             same details, same concrete result arrays).
``enumerate_actions_naive``  a deliberately line-by-line port of the
                             original Python loop structure, kept as the
                             baseline for ``benchmarks/bench_env.py``.

All three return identical action sets (asserted by tests/property tests).
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from .molecule import (
    ALLOWED_RING_SIZES,
    ELEMENT_INDEX,
    ELEMENTS,
    MAX_BOND_ORDER,
    VALENCES,
    Molecule,
    iso_hashes_from_padded,
)

ActionKind = Literal["no_op", "add_atom", "bond_delta"]


def apply_edit(parent: Molecule, kind: str, detail: tuple) -> Molecule:
    """Materialise the molecule an edit descriptor produces.

    The single place that defines what (kind, detail) MEANS; both the eager
    reference enumerator and lazy ``Action.result`` go through the same
    mutators, so the two paths produce byte-identical molecules.
    """
    if kind == "no_op":
        return parent
    if kind == "add_atom":
        sym, anchor, order = detail
        if anchor < 0:                      # add to the empty molecule
            return Molecule.from_element(sym)
        return parent.with_added_atom(sym, int(anchor), int(order))
    if kind == "bond_delta":
        i, j, delta = detail
        cand = parent.with_bond_delta(int(i), int(j), int(delta))
        if delta < 0:
            cand = cand.largest_fragment()  # paper Fig. 6: drop fragments
        return cand
    raise ValueError(f"unknown action kind {kind!r}")


class Action:
    """A molecule edit.  ``result`` is the post-edit molecule.

    ``result`` may be LAZY: when constructed with a parent molecule instead
    of a result, the edit in ``detail`` is applied on first access (and
    cached).  The rollout engine exploits this — of the ~10^2 candidates per
    step only the chosen one is ever materialised.

    detail: add_atom ``(element_symbol, anchor, order)`` (anchor -1 = add to
    the empty molecule); bond_delta ``(i, j, delta)`` (negative delta =
    decrease / removal).
    """

    __slots__ = ("kind", "detail", "_result", "_parent")

    def __init__(self, kind: ActionKind, result: Molecule | None = None,
                 detail: tuple = (), *, parent: Molecule | None = None):
        if result is None and parent is None:
            raise ValueError("Action needs a result or a parent to derive it from")
        self.kind = kind
        self.detail = detail
        self._result = result
        self._parent = parent

    @property
    def result(self) -> Molecule:
        if self._result is None:
            # benign race under the pipelined rollout's host threads: both
            # compute equal molecules, the attribute write is atomic
            self._result = apply_edit(self._parent, self.kind, self.detail)
        return self._result

    @property
    def materialized(self) -> bool:
        return self._result is not None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tail = f"-> {self._result.heavy_formula()}" if self._result is not None \
            else "(lazy)"
        return f"Action({self.kind}, {self.detail}, {tail})"


_O = ELEMENT_INDEX["O"]


def enumerate_actions(
    mol: Molecule,
    *,
    allow_removal: bool = True,
    allow_no_op: bool = True,
    protect_oh: bool = True,
    allowed_ring_sizes: frozenset[int] = ALLOWED_RING_SIZES,
    max_atoms: int = 38,
) -> list[Action]:
    """Delta enumeration of all valid single-edit actions (§3.6).

    Pinned to return the identical action list as
    :func:`enumerate_actions_ref` (same order, details and concrete result
    molecules) while doing the valence / ring / O-H-protection filtering on
    edit-descriptor arrays and deferring ``Molecule`` construction to
    ``Action.result``.
    """
    n = mol.num_atoms
    if n == 0:
        # tiny fixed case: reuse the reference path verbatim
        return enumerate_actions_ref(
            mol, allow_removal=allow_removal, allow_no_op=allow_no_op,
            protect_oh=protect_oh, allowed_ring_sizes=allowed_ring_sizes,
            max_atoms=max_atoms)

    fv = np.asarray(mol.free_valences(), dtype=np.int64)
    el = mol.elements.astype(np.int64)
    oh_mask = (el == _O) & (fv >= 1)
    n_oh = int(oh_mask.sum())

    # ---- edit descriptors, generated in the reference order -------------- #
    # columns: cat (0 no_op / 1 add_atom / 2 bond_delta / 3 frag-removal),
    # p1/p2/p3 (add: anchor, element, order; bond: i, j, signed delta),
    # oh (True = at least one O-H survives the edit)
    cats: list[np.ndarray] = []
    p1s: list[np.ndarray] = []
    p2s: list[np.ndarray] = []
    p3s: list[np.ndarray] = []
    ohs: list[np.ndarray] = []

    def _push(cat, p1, p2, p3, oh):
        k = len(p1)
        cats.append(np.full(k, cat, dtype=np.int64))
        p1s.append(np.asarray(p1, dtype=np.int64))
        p2s.append(np.asarray(p2, dtype=np.int64))
        p3s.append(np.asarray(p3, dtype=np.int64))
        ohs.append(np.asarray(oh, dtype=bool))

    def _expand(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(group index, 1-based position) pairs for 1..counts[g] per group."""
        counts = np.maximum(counts, 0)
        rep = np.repeat(np.arange(counts.size), counts)
        pos = np.arange(rep.size) - np.repeat(np.cumsum(counts) - counts, counts) + 1
        return rep, pos

    if allow_no_op:
        _push(0, [0], [0], [0], [True])  # no_op always survives protection

    # ---- atom additions: anchor-major, element, then order --------------- #
    if n < max_atoms:
        anchors = np.nonzero(fv >= 1)[0]
        if anchors.size:
            val = np.minimum(np.asarray(VALENCES, dtype=np.int64), MAX_BOND_ORDER)
            maxo = np.minimum(fv[anchors][:, None], val[None, :])   # [A, 3]
            rep, order = _expand(maxo.ravel())
            anchor = anchors[rep // len(ELEMENTS)]
            elem = rep % len(ELEMENTS)
            lost = oh_mask[anchor] & (fv[anchor] - order < 1)
            gained = (elem == _O) & (order == 1)    # new O keeps an H iff order 1
            _push(1, anchor, elem, order,
                  (n_oh - lost.astype(np.int64) + gained.astype(np.int64)) > 0)

    # ---- bond additions / increases: triu pair-major, delta inner -------- #
    iu, ju = np.triu_indices(n, k=1)
    if iu.size:
        bij = mol.bonds[iu, ju].astype(np.int64)
        maxd = np.minimum(np.minimum(fv[iu], fv[ju]), MAX_BOND_ORDER - bij)
        ok = maxd >= 1
        unbonded = bij == 0
        if bool(np.any(ok & unbonded)):
            # new-ring rule: bond between already-connected atoms closes a
            # ring of size (hop distance + 1), only 3/5/6 allowed
            d = mol.all_pairs_shortest_paths()[iu, ju].astype(np.int64)
            ring_ok = (d < 0) | np.isin(d + 1, sorted(allowed_ring_sizes))
            ok &= ~unbonded | ring_ok
        pairs = np.nonzero(ok)[0]
        if pairs.size:
            rep, delta = _expand(maxd[pairs])
            bi, bj = iu[pairs][rep], ju[pairs][rep]
            lost_i = oh_mask[bi] & (fv[bi] - delta < 1)
            lost_j = oh_mask[bj] & (fv[bj] - delta < 1)
            _push(2, bi, bj, delta,
                  (n_oh - lost_i.astype(np.int64) - lost_j.astype(np.int64)) > 0)

    # ---- bond decreases / removals: bonded pair-major, delta inner ------- #
    frag_results: dict[int, Molecule] = {}   # candidate row -> materialised
    if allow_removal:
        ri, rj = np.nonzero(np.triu(mol.bonds))
        if ri.size:
            orders = mol.bonds[ri, rj].astype(np.int64)
            rep, delta = _expand(orders)
            di, dj = ri[rep], rj[rep]
            full = delta == orders[rep]         # bond disappears entirely
            # partial decreases keep the bond (and therefore every atom):
            # an O at zero free valence gains an H, nothing loses one
            gain_i = (el[di] == _O) & (fv[di] == 0)
            gain_j = (el[dj] == _O) & (fv[dj] == 0)
            oh = (n_oh + gain_i.astype(np.int64) + gain_j.astype(np.int64)) > 0
            keep_rows = np.ones(di.size, dtype=bool)
            base = sum(len(c) for c in cats)
            for k in np.nonzero(full)[0]:
                # full removal may disconnect the graph: materialise (few
                # candidates, <= one per bonded pair) and check the fragment
                cand = apply_edit(mol, "bond_delta",
                                  (int(di[k]), int(dj[k]), -int(delta[k])))
                if cand.num_atoms == 0:
                    keep_rows[k] = False
                    continue
                frag_results[base + int(np.count_nonzero(keep_rows[:k]))] = cand
                oh[k] = cand.has_oh_bond()
            _push(2, di[keep_rows], dj[keep_rows], -delta[keep_rows], oh[keep_rows])
            if full[keep_rows].any():
                cat_arr = cats[-1]
                cat_arr[np.nonzero(full[keep_rows])[0]] = 3

    if not cats:
        return []
    cat = np.concatenate(cats)
    p1 = np.concatenate(p1s)
    p2 = np.concatenate(p2s)
    p3 = np.concatenate(p3s)
    oh_ok = np.concatenate(ohs)

    # ---- O-H protection on the descriptor arrays (§3.3) ------------------ #
    # Protection status is an isomorphism invariant, so filtering before the
    # dedup keeps exactly the reference's dedup-then-protect output set.
    keep = oh_ok if protect_oh else np.ones(cat.size, dtype=bool)
    if not bool(keep.any()):
        # reference fallback: nothing survives protection -> first candidate
        return [_materialize(mol, int(cat[0]), int(p1[0]), int(p2[0]),
                             int(p3[0]), frag_results.get(0))]
    surv = np.nonzero(keep)[0]

    # ---- isomorphism dedup over padded arrays built from the edits ------- #
    C = surv.size
    scat, s1, s2, s3 = cat[surv], p1[surv], p2[surv], p3[surv]
    sizes = np.full(C, n, dtype=np.int64)
    sizes[scat == 1] = n + 1
    for r, row in enumerate(surv):
        if cat[row] == 3:
            sizes[r] = frag_results[int(row)].num_atoms
    m = max(int(sizes.max()), 1)
    el_pad = np.full((C, m), 3, dtype=np.int64)          # 3 = padding element
    bonds_pad = np.zeros((C, m, m), dtype=np.int8)
    shared = scat != 3                                    # parent-frame rows
    el_pad[shared, :n] = el
    bonds_pad[shared, :n, :n] = mol.bonds
    rows = np.nonzero(scat == 1)[0]
    if rows.size:                                         # atom additions
        el_pad[rows, n] = s2[rows]
        bonds_pad[rows, n, s1[rows]] = s3[rows].astype(np.int8)
        bonds_pad[rows, s1[rows], n] = s3[rows].astype(np.int8)
    rows = np.nonzero(scat == 2)[0]
    if rows.size:                                         # bond order edits
        nv = (mol.bonds[s1[rows], s2[rows]] + s3[rows]).astype(np.int8)
        bonds_pad[rows, s1[rows], s2[rows]] = nv
        bonds_pad[rows, s2[rows], s1[rows]] = nv
    for r, row in enumerate(surv):
        if cat[row] == 3:                                 # fragment survivors
            frag = frag_results[int(row)]
            k = frag.num_atoms
            el_pad[r, :k] = frag.elements
            bonds_pad[r, :k, :k] = frag.bonds
    hashes = iso_hashes_from_padded(el_pad, bonds_pad, sizes)

    out: list[Action] = []
    seen: set[int] = set()
    for r, row in enumerate(surv.tolist()):
        h = int(hashes[r])
        if h in seen:
            continue
        seen.add(h)
        out.append(_materialize(mol, int(cat[row]), int(p1[row]), int(p2[row]),
                                int(p3[row]), frag_results.get(row)))
    return out


def _materialize(mol: Molecule, cat: int, p1: int, p2: int, p3: int,
                 frag: Molecule | None) -> Action:
    """Edit descriptor -> Action (lazy except fragment removals)."""
    if cat == 0:
        return Action("no_op", mol, ())
    if cat == 1:
        return Action("add_atom", None, (ELEMENTS[p2], p1, p3), parent=mol)
    if cat == 3:
        return Action("bond_delta", frag, (p1, p2, p3))
    return Action("bond_delta", None, (p1, p2, p3), parent=mol)


def enumerate_actions_ref(
    mol: Molecule,
    *,
    allow_removal: bool = True,
    allow_no_op: bool = True,
    protect_oh: bool = True,
    allowed_ring_sizes: frozenset[int] = ALLOWED_RING_SIZES,
    max_atoms: int = 38,
) -> list[Action]:
    """Materialise-then-filter enumeration — the CORRECTNESS REFERENCE.

    Builds every candidate ``Molecule`` eagerly, dedups, then applies the
    O-H protection on the materialised results.  ``enumerate_actions`` (the
    delta path) is pinned to this output action-for-action.
    """
    actions: list[Action] = []
    if allow_no_op:
        actions.append(Action("no_op", mol, ()))

    n = mol.num_atoms
    if n == 0:
        for sym in ELEMENTS:
            actions.append(Action("add_atom", Molecule.from_element(sym), (sym, -1, 0)))
        return _protect(actions, protect_oh)

    fv = mol.free_valences()

    # ---- atom additions (vectorised over anchors) ----------------------- #
    if n < max_atoms:
        anchors = np.nonzero(fv >= 1)[0]
        for a in anchors:
            a = int(a)
            for ei, sym in enumerate(ELEMENTS):
                max_order = min(int(fv[a]), VALENCES[ei], MAX_BOND_ORDER)
                for order in range(1, max_order + 1):
                    actions.append(
                        Action("add_atom", mol.with_added_atom(sym, a, order), (sym, a, order))
                    )

    # ---- bond additions / increases -------------------------------------- #
    # Candidate pairs where both ends have free valence.  For unbonded pairs
    # we must respect the ring-size rule; for already-bonded pairs an order
    # increase never creates a new ring.
    cap = np.minimum.outer(fv, fv)          # max possible delta per pair
    iu, ju = np.triu_indices(n, k=1)
    sp = None
    for i, j in zip(iu.tolist(), ju.tolist()):
        max_delta = int(min(cap[i, j], MAX_BOND_ORDER - int(mol.bonds[i, j])))
        if max_delta < 1:
            continue
        if mol.bonds[i, j] == 0:
            # would close a ring iff i..j already connected
            if sp is None:
                sp = mol.all_pairs_shortest_paths()
            d = int(sp[i, j])
            if d >= 0 and (d + 1) not in allowed_ring_sizes:
                continue
        for delta in range(1, max_delta + 1):
            actions.append(Action("bond_delta", mol.with_bond_delta(i, j, delta), (i, j, delta)))

    # ---- bond decreases / removals ---------------------------------------- #
    if allow_removal:
        for i, j in zip(*np.nonzero(np.triu(mol.bonds))):
            i, j = int(i), int(j)
            order = int(mol.bonds[i, j])
            for delta in range(1, order + 1):
                cand = mol.with_bond_delta(i, j, -delta).largest_fragment()
                if cand.num_atoms == 0:
                    continue
                actions.append(Action("bond_delta", cand, (i, j, -delta)))

    return _protect(_dedup(actions), protect_oh)


def enumerate_actions_naive(
    mol: Molecule,
    *,
    allow_removal: bool = True,
    allow_no_op: bool = True,
    protect_oh: bool = True,
    allowed_ring_sizes: frozenset[int] = ALLOWED_RING_SIZES,
    max_atoms: int = 38,
) -> list[Action]:
    """Line-by-line port of the original Python MolDQN enumeration.

    Intentionally unoptimised: per-pair BFS, per-candidate full validity
    re-checks, no vectorisation.  Kept as the performance baseline that the
    paper's C++ port (and our vectorised path) is measured against.
    """
    actions: list[Action] = []
    if allow_no_op:
        actions.append(Action("no_op", mol, ()))
    if mol.num_atoms == 0:
        for sym in ELEMENTS:
            actions.append(Action("add_atom", Molecule.from_element(sym), (sym, -1, 0)))
        return _protect(actions, protect_oh)

    # atom additions -- python loops, recomputing free valence every time
    if mol.num_atoms < max_atoms:
        for a in range(mol.num_atoms):
            for ei, sym in enumerate(ELEMENTS):
                for order in range(1, MAX_BOND_ORDER + 1):
                    if order > VALENCES[ei]:
                        continue
                    if mol.free_valence(a) < order:  # recomputed per candidate
                        continue
                    cand = mol.with_added_atom(sym, a, order)
                    cand.check_valences()
                    actions.append(Action("add_atom", cand, (sym, a, order)))

    # bond additions -- per-pair BFS instead of one all-pairs pass
    for i in range(mol.num_atoms):
        for j in range(i + 1, mol.num_atoms):
            for delta in range(1, MAX_BOND_ORDER + 1):
                if mol.free_valence(i) < delta or mol.free_valence(j) < delta:
                    continue
                if int(mol.bonds[i, j]) + delta > MAX_BOND_ORDER:
                    continue
                if mol.bonds[i, j] == 0:
                    d = mol.shortest_path_length(i, j)
                    if d >= 0 and (d + 1) not in allowed_ring_sizes:
                        continue
                cand = mol.with_bond_delta(i, j, delta)
                cand.check_valences()
                actions.append(Action("bond_delta", cand, (i, j, delta)))

    # bond removals
    if allow_removal:
        for i in range(mol.num_atoms):
            for j in range(i + 1, mol.num_atoms):
                order = int(mol.bonds[i, j])
                for delta in range(1, order + 1):
                    cand = mol.with_bond_delta(i, j, -delta).largest_fragment()
                    if cand.num_atoms == 0:
                        continue
                    cand.check_valences()
                    actions.append(Action("bond_delta", cand, (i, j, -delta)))

    return _protect(_dedup_naive(actions), protect_oh)


def _dedup_naive(actions: list[Action]) -> list[Action]:
    """Per-candidate canonical-serialisation dedup — the original MolDQN
    approach (canonical SMILES per candidate via RDKit).  Baseline for
    ``benchmarks/bench_env.py``; same output set as :func:`_dedup`."""
    seen: set[str] = set()
    out: list[Action] = []
    for a in actions:
        key = a.result.canonical_key()
        if key in seen:
            continue
        seen.add(key)
        out.append(a)
    return out


def _dedup(actions: list[Action]) -> list[Action]:
    """Drop actions yielding isomorphic molecules (keep first occurrence).

    Hashes every candidate in ONE padded batch (``iso_hashes_batch``) —
    equal graphs always collide, distinct graphs collide with ~2^-64
    probability, which is acceptable for pruning a candidate list.
    """
    from .molecule import iso_hashes_batch

    keys = iso_hashes_batch([a.result for a in actions])
    seen: set[int] = set()
    out: list[Action] = []
    for a, key in zip(actions, keys):
        if key in seen:
            continue
        seen.add(key)
        out.append(a)
    return out


def _protect(actions: list[Action], protect_oh: bool) -> list[Action]:
    if not protect_oh:
        return actions
    kept = [a for a in actions if a.kind == "no_op" or a.result.has_oh_bond()]
    # Never return an empty action set: no-op always survives if present.
    return kept if kept else actions[:1]
