"""Copy of ``repro.predictors.cache``; only its imports differ.

The LRU property cache of §3.6.

"a Least Recently Used (LRU) cache is introduced to store the predicted BDE
values" — predictors dominate step cost (466.8x / 32.6x slower than QED),
and RL revisits molecules constantly (every episode restarts from the same
initial molecules), so the hit rate is high.

Keys are isomorphism-invariant molecule hashes (``Molecule.iso_key``), so
relabelled duplicates hit.  Tracks hit/miss statistics for
``benchmarks/bench_cache.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    def __init__(self, capacity: int = 100_000):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return default

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def put(self, key: Hashable, value: Any) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        if len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0
