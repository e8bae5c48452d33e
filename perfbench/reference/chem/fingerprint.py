"""Frozen copy of the port's ``repro_torch.chem.fingerprint`` (itself a copy of ``repro.chem.fingerprint``), kept for the benchmark's reference; only its imports differ.

Morgan / ECFP fingerprints + the paper's incremental variant (§3.6).

The paper profiles MT-MolDQN and finds Morgan-fingerprint computation to be
one of two hot spots; it introduces a *fast incremental Morgan fingerprint*.
The key observation: a single molecule edit only perturbs the radius-R
neighbourhood of the touched atoms, so only those atoms' environment hashes
change.  ``IncrementalMorgan`` maintains per-atom per-radius environment
hashes plus a global hash multiset and updates them in O(|ball| * n) instead
of O(n^2 * R) per edit.

Both the full and the incremental paths run on the vectorised uint64
splitmix64 hashing core in ``repro.chem.molecule`` (the TPU-era analogue of
the paper's C++ port — see DESIGN.md §4).

Parameters follow Appendix C: radius 3, 2048 bits.
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np

from .molecule import (
    _ORDER_SALT,
    _PAD_VALENCE,
    ELEMENT_INDEX,
    Molecule,
    initial_invariants,
    neighbor_combine,
    splitmix64,
)

FP_RADIUS = 3
FP_BITS = 2048


def atom_env_hashes(mol: Molecule, radius: int = FP_RADIUS) -> np.ndarray:
    """uint64[n, radius+1]: environment hash of each atom at each radius."""
    n = mol.num_atoms
    out = np.zeros((n, radius + 1), dtype=np.uint64)
    if n == 0:
        return out
    out[:, 0] = initial_invariants(mol)
    for r in range(1, radius + 1):
        prev = out[:, r - 1]
        out[:, r] = splitmix64(splitmix64(prev) + neighbor_combine(mol.bonds, prev))
    return out


def fold_hashes(hashes: np.ndarray, n_bits: int, *, counts: bool = False) -> np.ndarray:
    fp = np.zeros(n_bits, dtype=np.float32)
    idx = (hashes.ravel() % np.uint64(n_bits)).astype(np.int64)
    if counts:
        np.add.at(fp, idx, 1.0)
    else:
        fp[idx] = 1.0
    return fp


def morgan_fingerprint(
    mol: Molecule,
    radius: int = FP_RADIUS,
    n_bits: int = FP_BITS,
    *,
    counts: bool = False,
) -> np.ndarray:
    """ECFP-style fingerprint: fold all (atom, radius) env hashes to n_bits.

    Returns float32[n_bits]; binary by default, counts if ``counts=True``.
    """
    return fold_hashes(atom_env_hashes(mol, radius), n_bits, counts=counts)


def pack_fps(fps: np.ndarray) -> np.ndarray:
    """Bit-pack {0,1}-valued fingerprint rows: f32[..., FP_BITS] ->
    u8[..., FP_BITS/8].

    THE bit-order contract for every packed fingerprint in the repo
    (replay storage, the packed learner batches, the packed acting
    planes): ``np.packbits`` big-endian-within-byte, so fingerprint bit
    ``8*i + k`` is bit ``MSB-k`` of byte ``i``.  The inverse transforms
    are pinned to it in lockstep — ``replay.unpack_fp`` /
    ``replay.densify_sample`` (host), ``core.packed_batch.unpack_bits``
    (jit-side shift/mask), and the ``kernels/packed_qnet`` bit-plane
    matmuls (plane k multiplies weight rows ``k::8``).  The round trip
    is exact because fingerprints are {0,1}-valued, which is what lets
    packed paths stay BIT-identical to their dense references."""
    return np.packbits(fps.astype(bool), axis=-1)


def batch_morgan_fingerprints(
    mols: list[Molecule],
    radius: int = FP_RADIUS,
    n_bits: int = FP_BITS,
    *,
    counts: bool = False,
    chunk: int = 256,
) -> np.ndarray:
    """Fingerprints for a batch of molecules in one padded vectorised pass.

    Bit-identical to per-molecule :func:`morgan_fingerprint` (padding atoms
    are masked out of the fold and, having no bonds, never contaminate real
    atoms' neighbourhoods).  This is the fingerprint path the batched
    environment uses: ~10^3 candidates per worker step in ~10 array ops.
    Returns float32[len(mols), n_bits].

    Fleet-sized batches (10^4+ candidates across all workers) are processed
    ``chunk`` molecules at a time: the [k, m, m] uint64 hash temporaries are
    bandwidth-bound, so keeping them cache-resident beats one huge pass
    (~3x on a 4-5k batch) while remaining bit-identical.
    """
    k = len(mols)
    if k == 0:
        return np.zeros((0, n_bits), dtype=np.float32)
    if chunk and k > chunk:
        return np.concatenate([
            batch_morgan_fingerprints(mols[i:i + chunk], radius, n_bits,
                                      counts=counts, chunk=0)
            for i in range(0, k, chunk)
        ])
    sizes = np.array([m.num_atoms for m in mols], dtype=np.int64)
    m_max = max(int(sizes.max()), 1)
    el = np.full((k, m_max), 3, dtype=np.int64)  # 3 = padding element
    bonds = np.zeros((k, m_max, m_max), dtype=np.int8)
    for b, mol in enumerate(mols):
        n = mol.num_atoms
        el[b, :n] = mol.elements
        bonds[b, :n, :n] = mol.bonds
    env = env_hashes_from_arrays(el, bonds, radius)
    fp = fold_env_hashes(env, sizes, n_bits)
    if not counts:
        fp = (fp > 0).astype(np.float32)
    return fp


def env_hashes_from_arrays(el: np.ndarray, bonds: np.ndarray,
                           radius: int = FP_RADIUS) -> np.ndarray:
    """Environment hashes for a padded molecule batch: ``el`` int64[k, m]
    (3 = padding element), ``bonds`` int8[k, m, m] -> uint64[k, m, radius+1].

    The array-level core shared by :func:`batch_morgan_fingerprints` and the
    incremental pass; real-atom rows are bit-identical to per-molecule
    :func:`atom_env_hashes` (padding atoms have no bonds, so they never
    contaminate real neighbourhoods — padding ROWS themselves are garbage
    and must be masked by the caller's fold).
    """
    # identical invariant formula to molecule.initial_invariants
    tot = bonds.sum(axis=2, dtype=np.int64)
    deg = np.count_nonzero(bonds, axis=2)
    fv = _PAD_VALENCE[el] - tot
    packed = (((el * 64 + deg) * 64 + tot) * 64 + fv).astype(np.uint64)
    env = np.zeros(el.shape + (radius + 1,), dtype=np.uint64)
    env[:, :, 0] = splitmix64(packed)
    for r in range(1, radius + 1):
        prev = env[:, :, r - 1]
        env[:, :, r] = splitmix64(splitmix64(prev) + neighbor_combine(bonds, prev))
    return env


def fold_env_hashes(env: np.ndarray, sizes: np.ndarray, n_bits: int) -> np.ndarray:
    """Masked fold of batched env hashes: COUNT vectors f32[k, n_bits]
    (rows past each molecule's ``sizes`` entry are excluded).

    Padding rows are routed to a sentinel bin instead of boolean-extracted,
    and the bincount runs over row blocks so its bin range stays cache-sized
    regardless of the batch (a flat fleet batch is 10^4+ molecules).
    """
    k, m_max = env.shape[0], env.shape[1]
    out = np.empty((k, n_bits), dtype=np.float32)
    block = 256
    for lo in range(0, k, block):
        e = env[lo:lo + block]
        b = e.shape[0]
        valid = np.arange(m_max)[None, :, None] < sizes[lo:lo + block, None, None]
        bits = (e % np.uint64(n_bits)).astype(np.int64)
        flat = np.where(valid, np.arange(b)[:, None, None] * n_bits + bits,
                        b * n_bits)
        counts = np.bincount(flat.ravel(), minlength=b * n_bits + 1)[:-1]
        out[lo:lo + b] = counts.reshape(b, n_bits)
    return out


# ---------------------------------------------------------------------- #
# shared-parent batched incremental fingerprints (paper §3.6, fleet form)
# ---------------------------------------------------------------------- #
def incremental_fingerprints_grouped(
    parents: Sequence[Molecule],
    groups: Sequence[Sequence],
    radius: int = FP_RADIUS,
    n_bits: int = FP_BITS,
    *,
    counts: bool = False,
    chunk: int = 256,
    full_ratio: float = 0.6,
) -> list[np.ndarray]:
    """Candidate fingerprints for many (parent, action set) groups at once.

    The fleet-scale form of the paper's fast incremental Morgan fingerprint:
    each parent's ``atom_env_hashes`` table is computed ONCE, then every
    candidate of every group re-hashes only the radius-``radius`` ball
    around its edit's touched atoms — one vectorised padded-array pass over
    ALL candidates of ALL groups (``IncrementalMorgan.after_action`` is the
    single-edit correctness reference).  Per candidate the work drops from
    O(n^2 * R) hash rows to O(|ball| * n * R).

    BIT-IDENTICAL to ``batch_morgan_fingerprints([a.result for a in group])``
    for every group (pinned by tests/test_chem.py): hashes of atoms outside
    the ball are unchanged by a single edit, so carrying the parent's rows
    is exact, not an approximation.  Edits that re-index atoms (fragment-
    dropping removals) and empty parents fall back to the full batched
    recompute for just those candidates.

    ``groups[g]`` holds ``chem.actions.Action``-likes (``kind``/``detail``,
    lazy ``result`` only touched for fallback candidates).  Candidates whose
    radius ball covers more than ``full_ratio`` of their atoms are routed to
    an array-level full recompute instead (identical bits, cheaper when the
    "delta" IS the whole molecule — small molecules early in an episode).
    Returns one ``f32[len(group), n_bits]`` array per group.
    """
    S = len(parents)
    if S != len(groups):
        raise ValueError(f"{S} parents but {len(groups)} action groups")
    n_of = np.array([p.num_atoms for p in parents], dtype=np.int64)
    out = [np.zeros((len(g), n_bits), dtype=np.float32) for g in groups]

    # classify: no_op / incremental-safe / fallback (re-indexing edits)
    noop_rows: list[tuple[int, int]] = []
    inc_sid: list[int] = []            # parent index per incremental cand
    inc_rows: list[tuple[int, int]] = []   # (group, position) per cand
    inc_size: list[int] = []
    inc_touch: list[tuple[int, int]] = []
    inc_edit: list[tuple[int, int, int, int]] = []  # (is_add, a, b, value)
    fb_rows: list[tuple[int, int]] = []
    fb_mols: list[Molecule] = []
    for g, (parent, actions) in enumerate(zip(parents, groups)):
        n = int(n_of[g])
        pbonds = parent.bonds
        for pos, a in enumerate(actions):
            kind = a.kind
            if kind == "no_op":
                noop_rows.append((g, pos))
                continue
            if kind == "add_atom" and n > 0 and a.detail[1] >= 0:
                sym, anchor, order = a.detail
                inc_sid.append(g)
                inc_rows.append((g, pos))
                inc_size.append(n + 1)
                inc_touch.append((n, int(anchor)))
                inc_edit.append((1, int(anchor), ELEMENT_INDEX[sym], int(order)))
                continue
            if kind == "bond_delta" and n > 0:
                i, j, delta = a.detail
                i, j, delta = int(i), int(j), int(delta)
                new_order = int(pbonds[i, j]) + delta
                # a surviving bond can't re-index atoms; a removed bond only
                # does if it was a bridge (then the result shrank)
                if new_order > 0 or a.result.num_atoms == n:
                    inc_sid.append(g)
                    inc_rows.append((g, pos))
                    inc_size.append(n)
                    inc_touch.append((i, j))
                    inc_edit.append((0, i, j, new_order))
                    continue
            fb_rows.append((g, pos))
            fb_mols.append(a.result)

    if fb_mols:
        fb = batch_morgan_fingerprints(fb_mols, radius, n_bits, counts=counts)
        for (g, pos), row in zip(fb_rows, fb):
            out[g][pos] = row

    Ci = len(inc_sid)
    sizes_all = np.array(inc_size, dtype=np.int64)
    m = max(int(sizes_all.max()) if Ci else 1, int(n_of.max()) if S else 1, 1)

    # stacked parent frames, padded to the global atom budget; ONE batched
    # env pass over all parents (the "shared parent" work of the step)
    par_el = np.full((S, m), 3, dtype=np.int64)
    par_bonds = np.zeros((S, m, m), dtype=np.int8)
    for s, p in enumerate(parents):
        k = int(n_of[s])
        par_el[s, :k] = p.elements
        par_bonds[s, :k, :k] = p.bonds
    par_env = env_hashes_from_arrays(par_el, par_bonds, radius)
    par_cnt = fold_env_hashes(par_env, n_of, n_bits)  # [S, n_bits] f32

    for g, pos in noop_rows:
        out[g][pos] = par_cnt[g] if counts else (par_cnt[g] > 0)
    if Ci == 0:
        return out

    sid_all = np.array(inc_sid, dtype=np.int64)
    touch_all = np.array(inc_touch, dtype=np.int64)   # [Ci, 2]
    edit_all = np.array(inc_edit, dtype=np.int64)     # [Ci, 4]

    step = chunk if chunk else Ci
    for lo in range(0, Ci, step):
        hi = min(lo + step, Ci)
        # per-chunk padding: candidates are group-ordered, and the engine's
        # groups are same-step slot molecules of similar size, so slicing
        # the shared frames to the chunk's own atom budget avoids paying the
        # global max for every candidate (mirrors batch_morgan's chunking)
        m_c = int(sizes_all[lo:hi].max())
        rows = _incremental_chunk(
            par_bonds, par_el, par_env, par_cnt, n_of,
            sid_all[lo:hi], sizes_all[lo:hi], touch_all[lo:hi],
            edit_all[lo:hi], m_c, radius, n_bits, full_ratio)
        if not counts:
            rows = rows > 0
        # scatter rows back per group (chunk-local candidates are group-
        # ordered, so each group's slice is contiguous)
        r = 0
        while r < hi - lo:
            g = inc_rows[lo + r][0]
            r2 = r
            while r2 < hi - lo and inc_rows[lo + r2][0] == g:
                r2 += 1
            pos = np.fromiter((inc_rows[lo + t][1] for t in range(r, r2)),
                              dtype=np.int64, count=r2 - r)
            out[g][pos] = rows[r:r2]
            r = r2
    return out


def _incremental_chunk(par_bonds, par_el, par_env, par_cnt, n_of,
                       sid, sizes, touch, edit, m, radius, n_bits,
                       full_ratio):
    """One padded pass over a chunk of incremental-safe candidates.

    Returns the candidates' COUNT vectors ``f32[c, n_bits]``: the parent's
    fold counts minus the touched ball's stale (atom, radius) hashes plus
    the re-hashed ones — exactly ``IncrementalMorgan.update`` vectorised
    over candidates.  Candidates whose ball exceeds ``full_ratio`` of their
    atoms are recomputed outright from their (already built) edited frames.
    """
    c = sid.shape[0]
    rows = np.arange(c)

    # candidate frames: parent frame + the one edit, sliced to this chunk's
    # atom budget ``m`` (advanced+basic indexing copies just the slice)
    cb = par_bonds[sid, :m, :m]                       # [c, m, m]
    ce = par_el[sid, :m]                              # [c, m]
    is_add = edit[:, 0] == 1
    r_add = rows[is_add]
    if r_add.size:
        na = n_of[sid[is_add]]                        # new-atom index = old n
        anchor = edit[is_add, 1]
        order = edit[is_add, 3].astype(np.int8)
        ce[r_add, na] = edit[is_add, 2]
        cb[r_add, na, anchor] = order
        cb[r_add, anchor, na] = order
    r_bd = rows[~is_add]
    if r_bd.size:
        bi, bj = edit[~is_add, 1], edit[~is_add, 2]
        nv = edit[~is_add, 3].astype(np.int8)
        cb[r_bd, bi, bj] = nv
        cb[r_bd, bj, bi] = nv

    valid = np.arange(m)[None, :] < sizes[:, None]    # [c, m]

    # distance-limited BFS from the touched atoms, all candidates at once
    adj = cb > 0
    dist = np.full((c, m), 127, dtype=np.int16)
    dist[rows, touch[:, 0]] = 0
    dist[rows, touch[:, 1]] = 0
    for r in range(1, radius + 1):
        frontier = dist == r - 1
        if not frontier.any():
            break
        reached = (adj & frontier[:, :, None]).any(axis=1)
        dist = np.where(reached & (dist > r), np.int16(r), dist)
    aff = (dist <= radius) & valid
    aff_cnt = aff.sum(axis=1)

    out = np.empty((c, n_bits), dtype=np.float32)

    # ball ~ whole molecule: the full recompute IS the cheaper delta
    go_full = aff_cnt > np.maximum(full_ratio * sizes, 1.0)
    f_rows = rows[go_full]
    if f_rows.size:
        env = env_hashes_from_arrays(ce[f_rows], cb[f_rows], radius)
        out[f_rows] = fold_env_hashes(env, sizes[f_rows], n_bits)
    i_rows = rows[~go_full]
    if i_rows.size == 0:
        return out
    if f_rows.size:
        sid, sizes, touch = sid[i_rows], sizes[i_rows], touch[i_rows]
        cb, aff, aff_cnt, dist = cb[i_rows], aff[i_rows], aff_cnt[i_rows], dist[i_rows]
        ce = ce[i_rows]
        c = i_rows.size

    K = int(aff_cnt.max())
    # affected atom indices, ascending, padded to K (stable sort: the False
    # entries of ~aff — i.e. affected atoms — sort first, in index order)
    aff_idx = np.argsort(~aff, axis=1, kind="stable")[:, :K]
    kmask = np.arange(K)[None, :] < aff_cnt[:, None]  # [c, K]
    dist_g = np.take_along_axis(dist, aff_idx, axis=1)

    sub_bonds = cb[np.arange(c)[:, None], aff_idx]    # [c, K, m]
    env_sid = par_env[sid, :m]                        # [c, m, radius+1]
    fresh = np.empty((c, K, radius + 1), dtype=np.uint64)

    # radius 0: local element/degree/valence invariants of the ball
    tot = sub_bonds.sum(axis=2, dtype=np.int64)
    deg = np.count_nonzero(sub_bonds, axis=2)
    elg = np.take_along_axis(ce, aff_idx, axis=1)
    fvv = _PAD_VALENCE[elg] - tot
    packed = (((elg * 64 + deg) * 64 + tot) * 64 + fvv).astype(np.uint64)
    cur = env_sid[:, :, 0].copy()
    base_g = np.take_along_axis(cur, aff_idx, axis=1)
    vals = np.where(kmask, splitmix64(packed), base_g)
    np.put_along_axis(cur, aff_idx, vals, axis=1)
    fresh[:, :, 0] = vals

    # radius r: re-hash ball rows within distance r; rows farther than r
    # keep the parent's radius-r hash (their r-ball is untouched)
    for r in range(1, radius + 1):
        mixed = splitmix64(cur[:, None, :] ^ _ORDER_SALT[sub_bonds])
        agg = np.where(sub_bonds > 0, mixed, np.uint64(0)).sum(
            axis=2, dtype=np.uint64)
        prev_aff = np.take_along_axis(cur, aff_idx, axis=1)
        new_r = splitmix64(splitmix64(prev_aff) + agg)
        base = env_sid[:, :, r].copy()
        base_g = np.take_along_axis(base, aff_idx, axis=1)
        vals = np.where(kmask & (dist_g <= r), new_r, base_g)
        np.put_along_axis(base, aff_idx, vals, axis=1)
        fresh[:, :, r] = vals
        cur = base

    # fold delta: parent counts - stale ball hashes + re-hashed ball hashes.
    # Entries where the re-hash reproduced the parent's value (rows farther
    # than r at radius r) cancel exactly — drop them up front, then segment-
    # sum the surviving sparse (candidate, bit) deltas via one sort instead
    # of a dense c*n_bits bincount.
    inc_out = par_cnt[sid]                            # [c, n_bits] copy
    row_off = (np.arange(c) * n_bits)[:, None, None]
    stale = np.take_along_axis(env_sid, aff_idx[:, :, None], axis=1)
    stale_mask = (kmask & (aff_idx < n_of[sid][:, None]))[:, :, None] \
        & np.ones((1, 1, radius + 1), dtype=bool)
    fresh_mask = kmask[:, :, None] & np.ones((1, 1, radius + 1), dtype=bool)
    unchanged = stale_mask & fresh_mask & (fresh == stale)
    stale_idx = (row_off + (stale % np.uint64(n_bits)).astype(np.int64)
                 )[stale_mask & ~unchanged]
    fresh_idx = (row_off + (fresh % np.uint64(n_bits)).astype(np.int64)
                 )[fresh_mask & ~unchanged]
    idx = np.concatenate([fresh_idx, stale_idx])
    if idx.size:
        w = np.ones(idx.size, dtype=np.float64)
        w[fresh_idx.size:] = -1.0
        uniq, inv = np.unique(idx, return_inverse=True)
        sums = np.bincount(inv, weights=w)
        nz = sums != 0
        inc_out.reshape(-1)[uniq[nz]] += sums[nz].astype(np.float32)
    out[i_rows] = inc_out
    return out


def batch_fingerprints_incremental(
    parent: Molecule,
    actions: Sequence,
    radius: int = FP_RADIUS,
    n_bits: int = FP_BITS,
    *,
    counts: bool = False,
) -> np.ndarray:
    """All candidate fingerprints of ONE parent from a single shared
    environment-hash table — see :func:`incremental_fingerprints_grouped`.
    Bit-identical to ``batch_morgan_fingerprints([a.result for a in
    actions], radius, n_bits, counts=counts)``."""
    if not len(actions):
        return np.zeros((0, n_bits), dtype=np.float32)
    return incremental_fingerprints_grouped(
        [parent], [actions], radius, n_bits, counts=counts)[0]


def morgan_fingerprint_reference(
    mol: Molecule,
    radius: int = FP_RADIUS,
    n_bits: int = FP_BITS,
    *,
    counts: bool = False,
) -> np.ndarray:
    """Per-atom cryptographic-hash Morgan — the pre-optimisation baseline.

    This mirrors the cost profile of the original RDKit-backed Python
    implementation the paper profiled (§3.6): one hash invocation per
    (atom, radius) with a sorted neighbour list.  Kept for
    ``benchmarks/bench_fingerprint.py``; produces the same *bit semantics*
    but a different hash family than :func:`morgan_fingerprint`.
    """
    import hashlib

    n = mol.num_atoms
    env = np.zeros((n, radius + 1), dtype=np.uint64)
    if n:
        fv = mol.free_valences()
        for i in range(n):
            h = hashlib.blake2b(digest_size=8)
            h.update(bytes([int(mol.elements[i]), mol.degree(i), mol.total_order(i), int(fv[i])]))
            env[i, 0] = np.uint64(int.from_bytes(h.digest(), "little"))
        for r in range(1, radius + 1):
            prev = env[:, r - 1]
            for i in range(n):
                nbrs = np.nonzero(mol.bonds[i])[0]
                pairs = sorted((int(mol.bonds[i, v]), int(prev[v])) for v in nbrs)
                h = hashlib.blake2b(digest_size=8)
                h.update(int(prev[i]).to_bytes(8, "little"))
                for order, niv in pairs:
                    h.update(order.to_bytes(1, "little"))
                    h.update(niv.to_bytes(8, "little"))
                env[i, r] = np.uint64(int.from_bytes(h.digest(), "little"))
    return fold_hashes(env, n_bits, counts=counts)


def fingerprint_with_steps(fp: np.ndarray, steps_left: int, max_steps: int) -> np.ndarray:
    """MolDQN state = fingerprint ++ normalised steps-left scalar."""
    return np.concatenate([fp, np.array([steps_left / max(max_steps, 1)], dtype=np.float32)])


class IncrementalMorgan:
    """Incrementally-maintained Morgan fingerprint (paper §3.6).

    Usage::

        inc  = IncrementalMorgan(mol)
        fp   = inc.fingerprint()                         # == morgan_fingerprint(mol)
        inc2 = inc.after_action(new_mol, kind, detail)   # O(|radius-ball|) update

    State is (per-atom env-hash table, folded bit-count vector); an update
    copies the 2048-float count vector (one memcpy) and scatter-adds the
    delta rows, avoiding any per-hash Python bookkeeping.  Instances are
    immutable; updates return new instances.  Edits that re-index atoms
    (fragment drops) fall back to a full recompute.
    """

    __slots__ = ("mol", "radius", "n_bits", "env", "counts")

    def __init__(
        self,
        mol: Molecule,
        radius: int = FP_RADIUS,
        n_bits: int = FP_BITS,
        _env: np.ndarray | None = None,
        _counts: np.ndarray | None = None,
    ):
        self.mol = mol
        self.radius = radius
        self.n_bits = n_bits
        if _env is None:
            self.env = atom_env_hashes(mol, radius)
            self.counts = fold_hashes(self.env, n_bits, counts=True)
        else:
            self.env = _env
            self.counts = _counts

    # -------------------------------------------------------------- #
    def fingerprint(self, *, counts: bool = False) -> np.ndarray:
        if counts:
            return self.counts.copy()
        return (self.counts > 0).astype(np.float32)

    # -------------------------------------------------------------- #
    def update(self, new_mol: Molecule, touched: list[int]) -> "IncrementalMorgan":
        """Recompute env hashes only inside the radius-ball of ``touched``.

        ``touched`` are atom indices *in new_mol* whose incident bonds (or
        existence) changed.  Requires that pre-existing atoms kept their
        indices (true for atom additions and bond edits).
        """
        n_new = new_mol.num_atoms
        n_old = self.env.shape[0]
        radius = self.radius

        # distance-limited BFS from the touched set
        dist: dict[int, int] = {t: 0 for t in touched}
        q = deque(touched)
        while q:
            u = q.popleft()
            if dist[u] >= radius:
                continue
            for v in np.nonzero(new_mol.bonds[u])[0]:
                v = int(v)
                if v not in dist:
                    dist[v] = dist[u] + 1
                    q.append(v)
        aff = np.array(sorted(dist.keys()), dtype=np.int64)

        env = np.zeros((n_new, radius + 1), dtype=np.uint64)
        env[:n_old] = self.env

        counts = self.counts.copy()
        stale_rows = aff[aff < n_old]
        if stale_rows.size:
            idx = (self.env[stale_rows].ravel() % np.uint64(self.n_bits)).astype(np.int64)
            np.subtract.at(counts, idx, 1.0)

        # radius-0: local degree/valence invariants for the affected rows only
        sub = new_mol.bonds[aff]
        el = new_mol.elements[aff].astype(np.int64)
        tot = sub.sum(axis=1, dtype=np.int64)
        deg = np.count_nonzero(sub, axis=1)
        fv = np.array([4, 3, 2], dtype=np.int64)[el] - tot
        packed = ((((el * 64 + deg) * 64 + tot) * 64) + fv).astype(np.uint64)
        env[aff, 0] = splitmix64(packed)

        # radius-r rows for atoms within distance r of an edit; rows farther
        # than r keep their old hash at this radius (already copied above)
        dist_arr = np.array([dist[int(i)] for i in aff], dtype=np.int64)
        for r in range(1, radius + 1):
            prev = env[:, r - 1]
            rows = aff[dist_arr <= r]
            if rows.size:
                sub_bonds = new_mol.bonds[rows]  # [k, n]
                mixed = splitmix64(prev[None, :] ^ _ORDER_SALT[sub_bonds])
                agg = np.where(sub_bonds > 0, mixed, np.uint64(0)).sum(axis=1, dtype=np.uint64)
                env[rows, r] = splitmix64(splitmix64(prev[rows]) + agg)

        idx = (env[aff].ravel() % np.uint64(self.n_bits)).astype(np.int64)
        np.add.at(counts, idx, 1.0)

        return IncrementalMorgan(new_mol, self.radius, self.n_bits, _env=env, _counts=counts)

    # -------------------------------------------------------------- #
    def after_action(self, new_mol: Molecule, kind: str, detail: tuple) -> "IncrementalMorgan":
        """Apply the effect of an Action (see chem.actions)."""
        if new_mol.num_atoms < self.mol.num_atoms or (
            kind == "bond_delta" and new_mol.num_atoms != self.mol.num_atoms
        ):
            # fragment drop re-indexed atoms: full recompute
            return IncrementalMorgan(new_mol, self.radius, self.n_bits)
        if kind == "no_op":
            return self
        if kind == "add_atom":
            _, anchor, _ = detail
            new_idx = new_mol.num_atoms - 1
            touched = [new_idx] if anchor < 0 else [new_idx, int(anchor)]
            return self.update(new_mol, touched)
        if kind == "bond_delta":
            i, j, _ = detail
            return self.update(new_mol, [int(i), int(j)])
        raise ValueError(f"unknown action kind {kind}")
