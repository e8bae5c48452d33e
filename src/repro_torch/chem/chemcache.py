"""Copy of ``repro.chem.chemcache``; only its imports differ.

Fleet-wide candidate-chemistry cache (the §3.6 LRU idea, applied to
enumeration + fingerprints instead of property predictions).

MolDQN revisits the same states constantly: every episode restarts from the
same initial molecules, exploitation makes workers that share an initial
molecule walk the same edit sequences, and the replay horizon is short.
``PropertyService`` already dedupes *predictions* across the fleet;
``ChemCache`` does the same for the other host hot path — per unique parent
molecule it memoizes the full per-step candidate chemistry:

* the deduped, protection-filtered ``Action`` list (lazy edit descriptors —
  cheap to hold, and a cached chosen action re-materialises against the
  cached parent, which is concrete-identical to the requesting slot's), and
* the bit-packed candidate fingerprint matrix ``uint8[C, FP_BITS/8]``.

A typical entry (C ~ 150 candidates) holds ~40 KB of packed bits plus the
lazy action tuple (~25 KB of Python objects), so the default capacity of
8192 bounds the cache at roughly half a GB when completely full of
worst-case entries — in practice episodes revisit a far smaller hot set and
the LRU keeps exactly that.

Keys are ``Molecule.canonical_key()`` — exact up to isomorphism, no hash
collisions.  Because the rollout engine's transition stream must stay
BIT-identical to the uncached path, entries additionally carry the parent's
concrete ``(elements, bonds)`` byte signature: enumeration order is a
function of the concrete atom labelling, and two isomorphic but differently
labelled parents would otherwise swap candidate orderings mid-rollout.  A
canonical-key hit whose signature differs is counted as a ``relabel_miss``
and recomputed; the incumbent entry is kept (``put`` refuses to replace a
different labelling, so two live twins cannot evict each other every step —
and since relabel misses don't refresh LRU recency, a dead labelling still
ages out).  Relabelled twins are rare: they need two distinct edit paths to
the same isomorphism class.

Thread-safe: the pipelined rollout calls ``get``/``put`` from its host
enumeration threads.  Values are immutable by convention (tuple of Actions,
read-only packed array), so sharing entries across workers is free.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from repro_torch.chem.molecule import Molecule


@dataclass(frozen=True)
class ChemEntry:
    """What one parent molecule's step costs to recompute."""
    signature: bytes                 # concrete (elements ++ bonds) bytes
    actions: tuple                   # tuple[Action, ...]
    packed_fps: np.ndarray           # uint8[C, FP_BITS // 8], read-only


def molecule_signature(mol: Molecule) -> bytes:
    """Concrete-labelling signature (NOT isomorphism-invariant)."""
    return mol.elements.tobytes() + mol.bonds.tobytes()


class ChemCache:
    """LRU over per-parent candidate chemistry, shared across the fleet."""

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._data: OrderedDict[str, ChemEntry] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.relabel_misses = 0      # canonical hit, different atom labelling
        self.evictions = 0           # LRU capacity evictions (serve dashboards)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    # ------------------------------------------------------------ #
    def get(self, mol: Molecule) -> ChemEntry | None:
        key = mol.canonical_key()
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.misses += 1
                return None
            if entry.signature != molecule_signature(mol):
                self.relabel_misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, mol: Molecule, actions, packed_fps: np.ndarray) -> None:
        # ALL-OR-NOTHING: materialise and validate the complete entry
        # before touching the lock, the dict, or the caller's array.  A
        # faulted enumeration handing over a throwing iterable or a
        # mismatched fingerprint matrix must leave the cache untouched
        # (the old order froze the caller's array and could start the
        # insert before tuple(actions) had finished materialising).
        actions = tuple(actions)
        packed_fps = np.asarray(packed_fps)
        if packed_fps.ndim != 2 or packed_fps.shape[0] != len(actions):
            raise ValueError(
                f"half-built chem entry refused: {len(actions)} actions vs "
                f"packed_fps shape {packed_fps.shape}")
        sig = molecule_signature(mol)
        key = mol.canonical_key()
        entry = ChemEntry(sig, actions, packed_fps)
        packed_fps.flags.writeable = False
        with self._lock:
            existing = self._data.get(key)
            if existing is not None and existing.signature != sig:
                # a relabelled twin is already cached: keep it (two live
                # labellings would otherwise evict each other every step —
                # first labelling wins; relabel-miss lookups don't refresh
                # recency, so a DEAD labelling still ages out of the LRU)
                return
            if existing is not None:
                self._data.move_to_end(key)
            self._data[key] = entry
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    # ------------------------------------------------------------ #
    @property
    def hit_rate(self) -> float:
        return self.stats()["hit_rate"]

    def stats(self) -> dict:
        # one consistent snapshot: the pipelined rollout reads stats while
        # its enumeration threads are still inserting, and an unlocked read
        # can tear (hits already bumped, misses not yet) — every counter
        # access goes through the same lock as get/put
        with self._lock:
            total = self.hits + self.misses + self.relabel_misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "relabel_misses": self.relabel_misses,
                "lookups": total,
                "hit_rate": self.hits / total if total else 0.0,
                "entries": len(self._data),
                "evictions": self.evictions,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.relabel_misses = 0
            self.evictions = 0
