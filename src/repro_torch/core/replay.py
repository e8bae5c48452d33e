"""Copy of ``repro.core.replay``; only its imports differ.

Replay buffer with bit-packed fingerprints (paper §3.2, size 4000).

Each transition stores the *chosen next state* fingerprint (the Q-network
input), the reward, terminal flag, and the candidate fingerprints of the
successor state (needed for the double-DQN max).  At 2048 bits a raw
float32 layout would cost ~1.2 MB per transition (~150 candidates); packing
to bits brings it to ~40 KB, which is what makes a 4000-entry buffer per
worker viable — the same engineering pressure the paper's §3.6 reacts to.

Two implementations share the semantics:

``ReplayBuffer``      structure-of-arrays ring storage.  ``add`` writes one
                      row of each preallocated array (the candidate axis and
                      the row axis grow geometrically to their caps, so
                      small buffers stay small); ``sample`` is pure
                      vectorized fancy indexing — no per-transition Python
                      loop, and the dense reconstruction needs exactly ONE
                      batched ``np.unpackbits`` per field.
                      ``sample_packed`` skips the unpack entirely and
                      returns the uint8 bit planes + scalar features: the
                      learner ships those to the device (32x less H2D
                      traffic) and unpacks inside the jit'd update step
                      (``repro.core.packed_batch.densify_batch`` is the
                      jit-side twin of the host densify here).
``ListReplayBuffer``  the seed ``list[Transition]`` implementation, kept as
                      the CORRECTNESS REFERENCE: tests/test_replay.py pins
                      seeded ``sample()`` equivalence of the two, and
                      benchmarks/bench_train.py measures the host-sample
                      speedup against it.

``ReplayBuffer`` additionally supports proportional PRIORITIZED sampling
(``sampling="prioritized"``, Schaul et al. 2015): per-row priority arrays
ride the same SoA ring storage, the weighted draw is one vectorized
inverse-CDF ``searchsorted`` over the cumulative priorities, and the batch
gains a ``weights`` key (importance weights ``(N * P(i))^-beta``, max-
normalised) the learner folds into the loss.  THE parity invariant: when
the effective priorities ``p^alpha`` are all equal (``alpha = 0``, or no
``update_priorities`` call has differentiated them yet), the draw takes the
EXACT uniform path — the same ``rng.integers`` call the uniform sampler
makes, unit weights — so a prioritized buffer with flat priorities is
BIT-identical (indices, batches, RNG stream) to a uniform one.
``ListReplayBuffer`` + uniform sampling stays the pinned reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np

from repro_torch.chem.fingerprint import FP_BITS, pack_fps

FP_BYTES = FP_BITS // 8


@dataclass
class Transition:
    state_fp: np.ndarray        # packed uint8 [FP_BITS/8]
    steps_left_frac: float      # steps-left feature of the state
    reward: float
    done: bool
    next_fps: np.ndarray        # packed uint8 [n_candidates, FP_BITS/8]
    next_steps_left_frac: float


def pack_fp(fp: np.ndarray) -> np.ndarray:
    """Single-row twin of ``chem.fingerprint.pack_fps`` (the one bit-order
    contract all packed fingerprints share)."""
    return pack_fps(fp)


def unpack_fp(packed: np.ndarray, n_bits: int = FP_BITS) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)[..., :n_bits].astype(np.float32)


def densify_sample(packed: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Packed sample -> the dense train-step layout (host-side twin of
    ``repro.core.packed_batch.densify_batch``; keep the two in lockstep).

    Candidate rows past each transition's count — and ALL rows of terminal
    transitions — are zeroed, exactly like the reference per-row loop."""
    bits, counts = packed["next_bits"], packed["next_counts"]
    B, C = bits.shape[0], bits.shape[1]
    states = np.empty((B, FP_BITS + 1), np.float32)
    states[:, :FP_BITS] = np.unpackbits(packed["state_bits"], axis=-1)
    states[:, FP_BITS] = packed["state_frac"]
    eff = np.where(packed["dones"] > 0, 0, np.minimum(counts, C))
    next_mask = (np.arange(C)[None, :] < eff[:, None]).astype(np.float32)
    next_fps = np.empty((B, C, FP_BITS + 1), np.float32)
    if C:
        next_fps[..., :FP_BITS] = np.unpackbits(bits, axis=-1) * next_mask[..., None]
    next_fps[..., FP_BITS] = packed["next_frac"][:, None] * next_mask
    out = {"states": states, "rewards": packed["rewards"],
           "dones": packed["dones"], "next_fps": next_fps,
           "next_mask": next_mask}
    if "weights" in packed:          # prioritized replay importance weights
        out["weights"] = packed["weights"]
    return out


SAMPLING_MODES = ("uniform", "prioritized")


class ReplayBuffer:
    """SoA ring buffer (paper Table 3: size 4000), uniform or prioritized.

    ``max_candidates`` bounds the stored successor set per transition
    (``None`` = keep every candidate); the trainer passes its replay
    truncation target so storage never holds rows ``sample`` would drop.
    Sampling wider than that storage bound raises: the dropped rows may
    include the taken action's candidate, so a silent zero-padded answer
    would diverge from the ``ListReplayBuffer`` reference (which stores
    full rows and truncates only at sample time).
    Row and candidate capacities grow geometrically up to their caps, so
    the arrays a mostly-empty buffer owns stay proportional to what was
    actually added.

    ``sampling="prioritized"`` keeps a per-row priority (new rows get the
    running max, so every transition is sampled at least once with high
    probability), draws proportional to ``priority**priority_alpha``, and
    adds max-normalised importance weights under the ``weights`` key.
    ``update_priorities(td_abs)`` refreshes the rows of the LAST draw with
    ``|td| + priority_eps`` (duplicate indices: last write wins).
    """

    def __init__(self, capacity: int = 4000, seed: int = 0,
                 max_candidates: int | None = None,
                 sampling: str = "uniform",
                 priority_alpha: float = 0.6,
                 priority_eps: float = 1e-3):
        if sampling not in SAMPLING_MODES:
            raise ValueError(f"sampling={sampling!r} not in {SAMPLING_MODES}")
        self.capacity = capacity
        self.max_candidates = max_candidates
        self.sampling = sampling
        self.priority_alpha = float(priority_alpha)
        self.priority_eps = float(priority_eps)
        self._rng = np.random.default_rng(seed)
        self._size = 0
        self._pos = 0
        self._rows = 0          # allocated rows (<= capacity)
        self._cand_cap = 0      # allocated candidate axis
        self._state_bits = np.zeros((0, FP_BYTES), np.uint8)
        self._state_frac = np.zeros((0,), np.float32)
        self._rewards = np.zeros((0,), np.float32)
        self._dones = np.zeros((0,), bool)
        self._next_bits = np.zeros((0, 0, FP_BYTES), np.uint8)
        self._next_frac = np.zeros((0,), np.float32)
        self._next_counts = np.zeros((0,), np.int32)
        self._priorities = np.zeros((0,), np.float64)
        self._max_priority = 1.0
        self._last_idx: np.ndarray | None = None   # indices of the last draw

    def __len__(self) -> int:
        return self._size

    # ------------------------------------------------------------ #
    # storage growth (amortised: both axes double up to their caps)
    # ------------------------------------------------------------ #
    def _grow_rows(self, need: int) -> None:
        rows = min(self.capacity, max(need, 64, 2 * self._rows))
        def grow(a, shape):
            out = np.zeros(shape, a.dtype)
            out[: a.shape[0]] = a
            return out
        self._state_bits = grow(self._state_bits, (rows, FP_BYTES))
        self._state_frac = grow(self._state_frac, (rows,))
        self._rewards = grow(self._rewards, (rows,))
        self._dones = grow(self._dones, (rows,))
        self._next_bits = grow(self._next_bits, (rows, self._cand_cap, FP_BYTES))
        self._next_frac = grow(self._next_frac, (rows,))
        self._next_counts = grow(self._next_counts, (rows,))
        self._priorities = grow(self._priorities, (rows,))
        self._rows = rows

    def _grow_candidates(self, need: int) -> None:
        cap = max(need, 2 * self._cand_cap, 8)
        if self.max_candidates is not None:
            cap = min(max(cap, need), self.max_candidates)
        out = np.zeros((self._rows, cap, FP_BYTES), np.uint8)
        out[:, : self._cand_cap] = self._next_bits
        self._next_bits = out
        self._cand_cap = cap

    # ------------------------------------------------------------ #
    def add(self, t: Transition) -> None:
        k = t.next_fps.shape[0]
        if self.max_candidates is not None:
            k = min(k, self.max_candidates)
        pos = self._pos
        if pos >= self._rows:
            self._grow_rows(pos + 1)
        if k > self._cand_cap:
            self._grow_candidates(k)
        self._state_bits[pos] = t.state_fp
        self._state_frac[pos] = t.steps_left_frac
        self._rewards[pos] = t.reward
        self._dones[pos] = t.done
        self._next_bits[pos, :k] = t.next_fps[:k]
        self._next_bits[pos, k:] = 0          # clear the evicted row's tail
        self._next_frac[pos] = t.next_steps_left_frac
        self._next_counts[pos] = k
        self._priorities[pos] = self._max_priority
        self._size = min(self._size + 1, self.capacity)
        self._pos = (pos + 1) % self.capacity

    def add_many(self, ts: "Iterable[Transition]") -> None:
        """Insertion-order bulk add (the rollout engine's per-worker flush)."""
        for t in ts:
            self.add(t)

    # ------------------------------------------------------------ #
    # sampling: one seeded index draw + pure fancy-indexing gathers
    # ------------------------------------------------------------ #
    def _check_candidate_bound(self, C: int) -> None:
        """Sampling wider than the storage bound cannot be answered
        honestly: rows past ``self.max_candidates`` (possibly including the
        taken action's candidate) were dropped at ``add`` time, while the
        ``ListReplayBuffer`` reference would return them — so fail loudly
        instead of silently zero-padding a divergent batch."""
        if self.max_candidates is not None and C > self.max_candidates:
            raise ValueError(
                f"sample max_candidates={C} exceeds the storage bound "
                f"max_candidates={self.max_candidates}: candidate rows past "
                f"the bound were dropped at add() time and cannot be "
                f"reconstructed (the list reference would return them)")

    def _draw(self, batch_size: int) -> np.ndarray:
        if self._size == 0:
            raise ValueError("empty replay buffer")
        idx = self._rng.integers(0, self._size, size=batch_size)
        self._last_idx = idx
        return idx

    def _draw_prioritized(self, batch_size: int, beta: float
                          ) -> tuple[np.ndarray, np.ndarray]:
        """One vectorized weighted draw: inverse-CDF ``searchsorted`` over
        the cumulative effective priorities, plus max-normalised importance
        weights ``(N * P(i))**-beta``.

        PARITY INVARIANT: with all-equal effective priorities this MUST
        take the exact uniform path — same ``rng.integers`` call, unit
        weights — so priorities-all-equal stays bit-identical to the
        uniform sampler (numpy's bounded-integer draw uses rejection
        sampling, which no weighted draw can reproduce)."""
        if self._size == 0:
            raise ValueError("empty replay buffer")
        q = self._priorities[: self._size] ** self.priority_alpha
        if q[0] == q[-1] and np.all(q == q[0]):
            idx = self._rng.integers(0, self._size, size=batch_size)
            weights = np.ones(batch_size, np.float32)
        else:
            csum = np.cumsum(q)
            u = self._rng.random(batch_size) * csum[-1]
            idx = np.searchsorted(csum, u, side="right")
            idx = np.minimum(idx, self._size - 1)
            probs = q[idx] / csum[-1]
            w = (self._size * probs) ** -float(beta)
            weights = (w / w.max()).astype(np.float32)
        self._last_idx = idx
        return idx, weights

    def update_priorities(self, td_abs: np.ndarray) -> None:
        """Refresh the priorities of the LAST sampled batch from its |TD|
        errors (proportional variant: ``p = |td| + eps``).  Duplicate draws
        of the same row resolve last-write-wins; the running max feeds the
        max-priority init of subsequently added rows."""
        if self.sampling != "prioritized":
            raise ValueError("update_priorities called on a uniform buffer")
        if self._last_idx is None:
            raise ValueError("update_priorities before any sample")
        td_abs = np.abs(np.asarray(td_abs, np.float64)).reshape(-1)
        if td_abs.shape[0] != self._last_idx.shape[0]:
            raise ValueError(
                f"td batch {td_abs.shape[0]} != last sampled batch "
                f"{self._last_idx.shape[0]}")
        p = td_abs + self.priority_eps
        self._priorities[self._last_idx] = p
        self._max_priority = max(self._max_priority, float(p.max()))

    def _gather_packed(self, idx: np.ndarray, C: int) -> dict[str, np.ndarray]:
        k = min(C, self._cand_cap)
        next_bits = np.zeros((idx.shape[0], C, FP_BYTES), np.uint8)
        if k:
            next_bits[:, :k] = self._next_bits[idx, :k]
        return {
            "state_bits": self._state_bits[idx],
            "state_frac": self._state_frac[idx],
            "rewards": self._rewards[idx],
            "dones": self._dones[idx].astype(np.float32),
            "next_bits": next_bits,
            "next_frac": self._next_frac[idx],
            "next_counts": np.minimum(self._next_counts[idx], C).astype(np.int32),
        }

    def sample_packed(self, batch_size: int, max_candidates: int = 160,
                      *, beta: float = 0.0) -> dict[str, np.ndarray]:
        """Packed uint8 bit planes + scalar features — what the packed
        learner ships to the device (32x smaller than the dense layout):

        state_bits  u8[B, FP_BITS/8]   state_frac  f32[B]
        rewards     f32[B]             dones       f32[B]
        next_bits   u8[B, C, FP_BITS/8] (zero past each count)
        next_frac   f32[B]             next_counts i32[B]
        weights     f32[B]             (prioritized mode ONLY — uniform
                                        batches keep exactly today's keys)

        Draws the SAME seeded indices as ``sample`` would have.  ``beta``
        is the importance-weight exponent (prioritized mode; ignored under
        uniform sampling).
        """
        self._check_candidate_bound(max_candidates)
        if self.sampling == "prioritized":
            idx, weights = self._draw_prioritized(batch_size, beta)
            out = self._gather_packed(idx, max_candidates)
            out["weights"] = weights
            return out
        return self._gather_packed(self._draw(batch_size), max_candidates)

    def sample(self, batch_size: int, max_candidates: int = 160,
               *, beta: float = 0.0) -> dict[str, np.ndarray]:
        """Returns dense arrays for the jit'd train step.

        states   f32[B, FP_BITS+1]
        rewards  f32[B]
        dones    f32[B]
        next_fps f32[B, C, FP_BITS+1]  (zero-padded)
        next_mask f32[B, C]
        weights  f32[B]  (prioritized mode only)
        """
        return densify_sample(
            self.sample_packed(batch_size, max_candidates, beta=beta))

    # ------------------------------------------------------------ #
    # checkpoint state (bit-exact resume)
    # ------------------------------------------------------------ #
    def state_dict(self) -> dict[str, np.ndarray]:
        """Everything needed to resume bit-identically: the SoA rings
        (including the per-slot priority array), the ring cursor, the
        running max priority, the indices of the last draw (pending
        ``update_priorities`` feedback), and the sampler RNG stream.
        Allocated capacities (``_rows``/``_cand_cap``) ride along as the
        array shapes themselves."""
        from repro_torch.checkpoint.checkpoint import rng_state_to_array

        d = {
            "state_bits": self._state_bits,
            "state_frac": self._state_frac,
            "rewards": self._rewards,
            "dones": self._dones,
            "next_bits": self._next_bits,
            "next_frac": self._next_frac,
            "next_counts": self._next_counts,
            "priorities": self._priorities,
            "size": np.int64(self._size),
            "pos": np.int64(self._pos),
            "max_priority": np.float64(self._max_priority),
            "rng": rng_state_to_array(self._rng),
        }
        if self._last_idx is not None:
            d["last_idx"] = np.asarray(self._last_idx, np.int64)
        return d

    def load_state_dict(self, d: dict[str, np.ndarray]) -> None:
        """Restore the state written by :meth:`state_dict` into a buffer
        constructed with the SAME config (capacity / sampling / bounds —
        those live in the trainer config, not the checkpoint)."""
        from repro_torch.checkpoint.checkpoint import rng_state_from_array

        bits = np.asarray(d["state_bits"], np.uint8)
        rows = bits.shape[0]
        nb = np.asarray(d["next_bits"], np.uint8)
        if bits.shape[1:] != (FP_BYTES,) or nb.shape[0] != rows \
                or nb.shape[2:] != (FP_BYTES,) or rows > self.capacity:
            raise ValueError(
                f"replay state shape mismatch: state_bits {bits.shape}, "
                f"next_bits {nb.shape}, capacity {self.capacity}")
        self._state_bits = bits
        self._state_frac = np.asarray(d["state_frac"], np.float32)
        self._rewards = np.asarray(d["rewards"], np.float32)
        self._dones = np.asarray(d["dones"]).astype(bool)
        self._next_bits = nb
        self._next_frac = np.asarray(d["next_frac"], np.float32)
        self._next_counts = np.asarray(d["next_counts"], np.int32)
        self._priorities = np.asarray(d["priorities"], np.float64)
        self._rows = rows
        self._cand_cap = nb.shape[1]
        self._size = int(d["size"])
        self._pos = int(d["pos"])
        self._max_priority = float(d["max_priority"])
        self._last_idx = (np.asarray(d["last_idx"], np.int64)
                          if "last_idx" in d else None)
        self._rng = rng_state_from_array(d["rng"])

    # ------------------------------------------------------------ #
    # compatibility / introspection
    # ------------------------------------------------------------ #
    @property
    def _items(self) -> list[Transition]:
        """Materialise the ring as ``Transition`` objects in slot order —
        exactly the ``ListReplayBuffer._items`` layout (insertion order
        until the first wraparound, then cyclic overwrite order)."""
        return [
            Transition(
                state_fp=self._state_bits[i].copy(),
                steps_left_frac=float(self._state_frac[i]),
                reward=float(self._rewards[i]),
                done=bool(self._dones[i]),
                next_fps=self._next_bits[i, : self._next_counts[i]].copy(),
                next_steps_left_frac=float(self._next_frac[i]),
            )
            for i in range(self._size)
        ]


class ListReplayBuffer:
    """The seed list-based ring buffer — kept as the correctness reference
    for ``ReplayBuffer`` (seeded-sample equivalence pinned in
    tests/test_replay.py) and as the baseline in benchmarks/bench_train.py.
    Its ``sample`` loops over transitions calling ``np.unpackbits`` per row:
    O(B) Python iterations per draw, dense float32 output only."""

    def __init__(self, capacity: int = 4000, seed: int = 0):
        self.capacity = capacity
        self._items: list[Transition] = []
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._items)

    def add(self, t: Transition) -> None:
        if len(self._items) < self.capacity:
            self._items.append(t)
        else:
            self._items[self._pos] = t
        self._pos = (self._pos + 1) % self.capacity

    def add_many(self, ts: "Iterable[Transition]") -> None:
        for t in ts:
            self.add(t)

    def sample(self, batch_size: int, max_candidates: int = 160) -> dict[str, np.ndarray]:
        n = len(self._items)
        if n == 0:
            raise ValueError("empty replay buffer")
        idx = self._rng.integers(0, n, size=batch_size)
        C = max_candidates
        B = batch_size
        states = np.zeros((B, FP_BITS + 1), dtype=np.float32)
        rewards = np.zeros((B,), dtype=np.float32)
        dones = np.zeros((B,), dtype=np.float32)
        next_fps = np.zeros((B, C, FP_BITS + 1), dtype=np.float32)
        next_mask = np.zeros((B, C), dtype=np.float32)
        for r, i in enumerate(idx):
            t = self._items[int(i)]
            states[r, :FP_BITS] = unpack_fp(t.state_fp)
            states[r, FP_BITS] = t.steps_left_frac
            rewards[r] = t.reward
            dones[r] = float(t.done)
            k = min(t.next_fps.shape[0], C)
            if k and not t.done:
                next_fps[r, :k, :FP_BITS] = unpack_fp(t.next_fps[:k])
                next_fps[r, :k, FP_BITS] = t.next_steps_left_frac
                next_mask[r, :k] = 1.0
        return {"states": states, "rewards": rewards, "dones": dones,
                "next_fps": next_fps, "next_mask": next_mask}
