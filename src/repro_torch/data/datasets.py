"""Copy of ``repro.data.datasets``; only its imports differ.

Synthetic molecule datasets.

The paper's training set is "a random subset of 256 antioxidants ... from a
proprietary data set of over 500 antioxidant molecules" (§4.1) plus public
ChEMBL/AODB replays.  The proprietary set is unavailable by construction, so
this module *generates* structurally comparable sets:

* ``antioxidant_dataset`` — ~600 phenolic antioxidants (hindered phenols,
  aminophenols, bis-phenols...), the proprietary stand-in.  Split 256/128
  train/test with :func:`train_test_split` like §4.1/§4.3.
* ``public_antioxidant_dataset`` — a differently-distributed decoration mix
  (more polar groups, fewer hindered positions), the AODB/ChEMBL stand-in
  for the §4.4 replays.
* ``zinc_like_dataset`` — diverse non-phenolic drug-like molecules for the
  Appendix D QED/PlogP comparison (no O-H guarantee).

Everything is deterministic given the seed.  All generated molecules pass
``check_valences``, have a valid conformer, and (for the antioxidant sets)
contain at least one O-H bond.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.chem.conformer import has_valid_conformer
from repro_torch.chem.molecule import ELEMENT_INDEX, Molecule
from repro_torch.chem.oracle import oracle_bde, oracle_ip


# ------------------------------------------------------------------ #
# structural building blocks
# ------------------------------------------------------------------ #
def benzene() -> Molecule:
    """6-ring with alternating double bonds (kekulized benzene)."""
    el = np.zeros(6, dtype=np.int8)  # all C
    b = np.zeros((6, 6), dtype=np.int8)
    for k in range(6):
        b[k, (k + 1) % 6] = b[(k + 1) % 6, k] = 2 if k % 2 == 0 else 1
    return Molecule(el, b)


def cyclohexane() -> Molecule:
    el = np.zeros(6, dtype=np.int8)
    b = np.zeros((6, 6), dtype=np.int8)
    for k in range(6):
        b[k, (k + 1) % 6] = b[(k + 1) % 6, k] = 1
    return Molecule(el, b)


def _attach(mol: Molecule, anchor: int, fragment: str) -> Molecule:
    """Attach a named substituent to ``anchor``. Returns a new molecule."""
    if fragment == "hydroxy":                      # -OH
        return mol.with_added_atom("O", anchor, 1)
    if fragment == "amino":                        # -NH2
        return mol.with_added_atom("N", anchor, 1)
    if fragment == "methyl":                       # -CH3
        return mol.with_added_atom("C", anchor, 1)
    if fragment == "ethyl":                        # -CH2CH3
        m = mol.with_added_atom("C", anchor, 1)
        return m.with_added_atom("C", m.num_atoms - 1, 1)
    if fragment == "methoxy":                      # -OCH3
        m = mol.with_added_atom("O", anchor, 1)
        return m.with_added_atom("C", m.num_atoms - 1, 1)
    if fragment == "tbutyl":                       # -C(CH3)3
        m = mol.with_added_atom("C", anchor, 1)
        c = m.num_atoms - 1
        for _ in range(3):
            m = m.with_added_atom("C", c, 1)
        return m
    if fragment == "dimethylamino":                # -N(CH3)2
        m = mol.with_added_atom("N", anchor, 1)
        nn = m.num_atoms - 1
        m = m.with_added_atom("C", nn, 1)
        return m.with_added_atom("C", nn, 1)
    if fragment == "formyl":                       # -CH=O (EWG)
        m = mol.with_added_atom("C", anchor, 1)
        return m.with_added_atom("O", m.num_atoms - 1, 2)
    if fragment == "cyano":                        # -C#N (EWG)
        m = mol.with_added_atom("C", anchor, 1)
        return m.with_added_atom("N", m.num_atoms - 1, 3)
    raise ValueError(f"unknown fragment {fragment}")


_DONOR_FRAGMENTS = ["methyl", "ethyl", "methoxy", "tbutyl", "amino", "dimethylamino", "hydroxy"]
_EWG_FRAGMENTS = ["formyl", "cyano"]


def _ring_positions(n_ring: int = 6) -> list[int]:
    return list(range(n_ring))


def _make_phenol(rng: np.random.Generator, *, hindered_bias: float, polar_bias: float) -> Molecule:
    """One random phenolic antioxidant."""
    aromatic = rng.random() < 0.85
    mol = benzene() if aromatic else cyclohexane()
    # the phenolic OH
    oh_pos = 0
    mol = _attach(mol, oh_pos, "hydroxy")

    # decorate 1-4 other ring positions
    n_subs = int(rng.integers(1, 5))
    positions = rng.permutation([1, 2, 3, 4, 5])[:n_subs]
    for p in positions:
        if mol.free_valence(int(p)) < 1:
            continue
        r = rng.random()
        if r < hindered_bias:
            frag = rng.choice(["tbutyl", "methyl", "ethyl"], p=[0.5, 0.3, 0.2])
        elif r < hindered_bias + polar_bias:
            frag = rng.choice(["hydroxy", "methoxy", "amino", "dimethylamino"])
        elif r < hindered_bias + polar_bias + 0.12:
            frag = rng.choice(_EWG_FRAGMENTS)
        else:
            frag = rng.choice(["methyl", "methoxy"])
        mol = _attach(mol, int(p), str(frag))

    # occasionally fuse/append a second ring (bisphenol-like bridge)
    if rng.random() < 0.25 and mol.num_atoms <= 22:
        bridge_anchor = int(rng.choice([3, 4]))
        if mol.free_valence(bridge_anchor) >= 1:
            m = mol.with_added_atom("C", bridge_anchor, 1)
            c = m.num_atoms - 1
            ring2 = benzene()
            # splice second ring: append its atoms, bond c to its atom 0
            n0 = m.num_atoms
            el = np.concatenate([m.elements, ring2.elements])
            nb = np.zeros((el.shape[0], el.shape[0]), dtype=np.int8)
            nb[: n0, : n0] = m.bonds
            nb[n0:, n0:] = ring2.bonds
            nb[c, n0] = nb[n0, c] = 1
            mol = Molecule(el, nb)
            if rng.random() < 0.6:
                mol = _attach(mol, n0 + 3, "hydroxy")  # second phenolic OH

    return mol


def _generate(
    rng: np.random.Generator,
    count: int,
    *,
    hindered_bias: float,
    polar_bias: float,
    max_atoms: int = 34,
) -> list[Molecule]:
    out: list[Molecule] = []
    seen: set[int] = set()
    attempts = 0
    while len(out) < count and attempts < count * 60:
        attempts += 1
        mol = _make_phenol(rng, hindered_bias=hindered_bias, polar_bias=polar_bias)
        if mol.num_atoms > max_atoms:
            continue
        mol.check_valences()
        if not mol.has_oh_bond() or not has_valid_conformer(mol):
            continue
        key = mol.iso_key()
        if key in seen:
            continue
        seen.add(key)
        out.append(mol)
    if len(out) < count:
        raise RuntimeError(f"generator exhausted: {len(out)}/{count}")
    return out


def antioxidant_dataset(count: int = 600, seed: int = 20230) -> list[Molecule]:
    """The proprietary-dataset stand-in (hindered-phenol heavy)."""
    rng = np.random.default_rng(seed)
    return _generate(rng, count, hindered_bias=0.45, polar_bias=0.30)


def public_antioxidant_dataset(count: int = 256, seed: int = 20231) -> list[Molecule]:
    """AODB/ChEMBL-flavoured stand-in (more polar, less hindered)."""
    rng = np.random.default_rng(seed)
    return _generate(rng, count, hindered_bias=0.20, polar_bias=0.50)


def zinc_like_dataset(count: int = 512, seed: int = 20232) -> list[Molecule]:
    """Diverse drug-like set for App. D; O-H not guaranteed."""
    rng = np.random.default_rng(seed)
    out: list[Molecule] = []
    seen: set[int] = set()
    attempts = 0
    while len(out) < count and attempts < count * 80:
        attempts += 1
        base = benzene() if rng.random() < 0.6 else cyclohexane()
        mol = base
        n_subs = int(rng.integers(0, 5))
        for p in rng.permutation(6)[:n_subs]:
            if mol.free_valence(int(p)) < 1:
                continue
            frag = rng.choice(_DONOR_FRAGMENTS + _EWG_FRAGMENTS)
            mol = _attach(mol, int(p), str(frag))
        if mol.num_atoms > 30 or not has_valid_conformer(mol):
            continue
        key = mol.iso_key()
        if key in seen:
            continue
        seen.add(key)
        out.append(mol)
    return out


class DatasetStream:
    """Seeded multi-start cursor over a molecule pool (ROADMAP item 5).

    Shuffled-cycle semantics: each epoch visits every pool molecule exactly
    once in a fresh seeded permutation, so W workers x E episodes of draws
    are a pure function of ``(pool, seed)`` — the property the multi-start
    determinism tests pin identical across every rollout mode.  ``draw``
    crosses epoch boundaries transparently (a fleet wider than the pool
    just wraps into the next permutation mid-draw).
    """

    def __init__(self, molecules: Sequence[Molecule], seed: int = 0):
        if not molecules:
            raise ValueError("empty dataset pool")
        self._pool = list(molecules)
        self._rng = np.random.default_rng(seed)
        self._order = np.zeros((0,), np.int64)
        self._pos = 0
        self.n_drawn = 0
        self.n_epochs = 0

    def __len__(self) -> int:
        return len(self._pool)

    def draw(self, n: int) -> list[Molecule]:
        out: list[Molecule] = []
        while len(out) < n:
            if self._pos >= self._order.shape[0]:
                self._order = self._rng.permutation(len(self._pool))
                self._pos = 0
                self.n_epochs += 1
            out.append(self._pool[int(self._order[self._pos])])
            self._pos += 1
        self.n_drawn += n
        return out

    # -- checkpoint state (bit-exact resume) ---------------------------- #
    def state_dict(self) -> dict[str, np.ndarray]:
        """The full cursor: current epoch permutation + position, draw
        counters, and the permutation RNG stream.  The pool itself is NOT
        checkpointed — it is a pure function of (dataset name, count,
        seed), which live in the trainer config."""
        from repro_torch.checkpoint.checkpoint import rng_state_to_array

        return {
            "order": np.asarray(self._order, np.int64),
            "pos": np.int64(self._pos),
            "n_drawn": np.int64(self.n_drawn),
            "n_epochs": np.int64(self.n_epochs),
            "rng": rng_state_to_array(self._rng),
        }

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        from repro_torch.checkpoint.checkpoint import rng_state_from_array

        order = np.asarray(d["order"], np.int64)
        if order.shape[0] not in (0, len(self._pool)) or (
                order.size and int(order.max()) >= len(self._pool)):
            raise ValueError(
                f"dataset cursor permutation over {order.shape[0]} items "
                f"does not match pool of {len(self._pool)}")
        self._order = order
        self._pos = int(d["pos"])
        self.n_drawn = int(d["n_drawn"])
        self.n_epochs = int(d["n_epochs"])
        self._rng = rng_state_from_array(d["rng"])


# TrainerConfig.dataset names resolve here (launch/train.py --dataset too)
DATASETS = {
    "antioxidant": antioxidant_dataset,
    "public_antioxidant": public_antioxidant_dataset,
    "zinc_like": zinc_like_dataset,
}


def load_dataset(name: str, count: int | None = None,
                 seed: int | None = None) -> list[Molecule]:
    """Build a registry dataset; ``None`` keeps the dataset's own default
    count/seed.  Unknown names fail loudly with the known registry."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    kwargs = {}
    if count is not None:
        kwargs["count"] = count
    if seed is not None:
        kwargs["seed"] = seed
    return DATASETS[name](**kwargs)


def train_test_split(
    mols: list[Molecule], n_train: int = 256, n_test: int = 128, seed: int = 7
) -> tuple[list[Molecule], list[Molecule]]:
    """§4.1/§4.3: random 256 train + 128 test from the remainder."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(mols))
    train = [mols[i] for i in idx[:n_train]]
    test = [mols[i] for i in idx[n_train : n_train + n_test]]
    return train, test


def dataset_property_table(mols: list[Molecule]) -> dict[str, np.ndarray]:
    """Oracle BDE/IP arrays for a molecule list (the 'DFT ground truth')."""
    bde = np.array([oracle_bde(m) for m in mols], dtype=np.float64)
    ip = np.array([oracle_ip(m) for m in mols], dtype=np.float64)
    return {"bde": bde, "ip": ip}
