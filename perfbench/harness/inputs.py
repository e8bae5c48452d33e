"""The inputs a cell is driven with, all made from ``--seed``: the Q
network's weights, the frozen molecule pools, the replay fill and the
closed-loop request schedule.  The program and the reference are handed
the same inputs.  Frozen copies of the repository's generators are kept
here in NumPy, so nothing of ``benchmarks/`` is imported."""

from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "data"
FP_BYTES = 2048 // 8


def pool(name: str) -> list[str]:
    """A frozen pool of canonical SMILES (``data/<name>.smi``, one a line)."""
    with open(DATA / f"{name}.smi") as f:
        return [line.strip() for line in f if line.strip()]


def qnet_weights(sizes, seed: int, device):
    """He-normal weights and zero biases, ``[(w [in, out], b [out])]``, f32,
    drawn on ``device`` by one ``torch.Generator`` in one call."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shapes = list(zip(sizes[:-1], sizes[1:]))
    flat = torch.randn(sum(i * o for i, o in shapes), generator=g,
                       device=device, dtype=torch.float32)
    out, off = [], 0
    for i, o in shapes:
        w = flat[off:off + i * o].view(i, o) * (2.0 / i) ** 0.5
        out.append((w, torch.zeros(o, device=device, dtype=torch.float32)))
        off += i * o
    return out


def transition_stream(rng: np.random.Generator, n: int, candidates: int,
                      done_share: float = 0.15) -> list[dict]:
    """Frozen copy of ``benchmarks/bench_train._transition_stream``'s draws:
    random packed state fingerprints, next-state counts uniform on
    0..candidates, ``done_share`` of them terminal (no next states)."""
    state_bits = rng.integers(0, 256, size=(n, FP_BYTES), dtype=np.uint8)
    counts = rng.integers(0, candidates + 1, size=n)
    dones = rng.random(n) < done_share
    out = []
    for i in range(n):
        k = int(0 if dones[i] else counts[i])
        out.append({
            "state_fp": state_bits[i],
            "steps_left_frac": float(rng.random()),
            "reward": float(rng.standard_normal()),
            "done": bool(dones[i]),
            "next_fps": rng.integers(0, 256, size=(k, FP_BYTES), dtype=np.uint8),
            "next_steps_left_frac": float(rng.random()),
        })
    return out


def replay_fill(seed: int, workers: int, per_worker: int, candidates: int,
                done_share: float) -> list[list[dict]]:
    """Each worker's replay contents, from ``default_rng([seed, w])``."""
    return [transition_stream(np.random.default_rng([int(seed), w]),
                              per_worker, candidates, done_share)
            for w in range(workers)]


def closed_loop_schedule(seed: int, clients: int, pool_size: int,
                         budget_lo: int, budget_hi: int, per_client: int
                         ) -> list[list[tuple[int, int]]]:
    """Each client's sequence of ``(pool index, budget)`` requests.

    The draws are those of ``serving.stream.seeded_request_stream`` (a
    molecule uniform over the pool, a budget uniform on lo..hi), taken
    without replacement from the one balanced multiset that holds every
    pool molecule at every budget, so every seed offers the same work in
    another order.  Client ``c`` takes every ``clients``-th entry from
    ``c``."""
    base = [(m, b) for m in range(pool_size)
            for b in range(budget_lo, budget_hi + 1)]
    need = clients * per_client
    rng = np.random.default_rng([int(seed), 7])
    order: list[tuple[int, int]] = []
    while len(order) < need:
        order.extend(base[i] for i in rng.permutation(len(base)))
    return [order[c:need:clients] for c in range(clients)]
