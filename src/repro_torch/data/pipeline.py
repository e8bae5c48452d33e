"""Port of ``repro.data.pipeline``: the token batch pipeline.

``TokenBatcher`` produces ``{"tokens", "labels", "mask"}`` numpy batches
from an id corpus, deterministic given the seed: an infinite iterator that
reshuffles every epoch with the reference's ``np.random.default_rng(seed)``
permutation, so its batches are the reference's bit for bit.  The LM
train step moves a batch to the parameters' device.

``shard_batch`` splits a host batch's leading dim over a ``HostMesh``
(``launch/mesh.py``) and returns one dict per shard on that shard's
device, as the reference's places a batch on a JAX mesh with the batch
dim split over its data axes.  The sharded RL trainer ships its replay
batches through it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import HostMesh, shard_slices


class TokenBatcher:
    def __init__(
        self,
        sequences: list[np.ndarray],
        batch_size: int,
        seq_len: int,
        *,
        pad_id: int = 0,
        seed: int = 0,
    ):
        if not sequences:
            raise ValueError("empty corpus")
        self.sequences = sequences
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            order = self.rng.permutation(len(self.sequences))
            for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                idx = order[start : start + self.batch_size]
                yield self._make_batch([self.sequences[i] for i in idx])

    def _make_batch(self, seqs: list[np.ndarray]) -> dict[str, np.ndarray]:
        L = self.seq_len
        tokens = np.full((len(seqs), L), self.pad_id, dtype=np.int32)
        for r, s in enumerate(seqs):
            s = s[: L]
            tokens[r, : len(s)] = s
        labels = np.concatenate(
            [tokens[:, 1:], np.full((len(seqs), 1), self.pad_id, dtype=np.int32)], axis=1
        )
        mask = (labels != self.pad_id).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "mask": mask}


def lm_batches_from_smiles(
    smiles: list[str], tokenizer, batch_size: int, seq_len: int, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    seqs = [tokenizer.encode(s) for s in smiles]
    return iter(TokenBatcher(seqs, batch_size, seq_len, pad_id=tokenizer.PAD, seed=seed))


def shard_batch(batch: dict, mesh: HostMesh) -> list[dict[str, torch.Tensor]]:
    """Split every leaf's leading dim over ``mesh``: shard ``s`` gets rows
    ``shard_slices(n, mesh)[s]`` of each leaf (numpy or torch) as a tensor
    on ``mesh.devices[s]``.  Raises when the leading dims differ or do not
    divide the mesh."""
    sizes = {int(v.shape[0]) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on the leading dim: {sorted(sizes)}")
    slices = shard_slices(sizes.pop(), mesh)
    return [{k: torch.as_tensor(v[sl]).to(dev) for k, v in batch.items()}
            for sl, dev in zip(slices, mesh.devices)]
