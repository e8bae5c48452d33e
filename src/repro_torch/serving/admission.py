"""Copy of ``repro.serving.admission``; only its imports differ.

Bounded admission queue with load shedding (the backpressure tier).

The service cannot refuse to decide: when the queue is full, ``offer``
returns a VICTIM — either the new arrival (``reject_new``, default: the
queue keeps its oldest work, classic tail-drop) or the oldest queued item
(``evict_oldest``: freshest work wins, the head-drop policy for workloads
where stale requests are worthless anyway).  The caller finalizes the
victim with status ``shed``; nothing is silently dropped.

Deterministic by construction — pure data structure, no clocks, no
threads.  The service owns all access from its driver loop.
"""

from __future__ import annotations

from collections import deque

SHED_POLICIES = ("reject_new", "evict_oldest")


class AdmissionQueue:
    """Bounded FIFO; overflow yields an explicit shed victim."""

    def __init__(self, capacity: int, policy: str = "reject_new"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in SHED_POLICIES:
            raise ValueError(
                f"policy must be one of {SHED_POLICIES}, got {policy!r}")
        self.capacity = int(capacity)
        self.policy = policy
        self._items: deque = deque()
        self.n_offered = 0
        self.n_shed = 0
        self.depth_high_water = 0

    def __len__(self) -> int:
        return len(self._items)

    def offer(self, item):
        """Enqueue ``item``; returns the shed victim (possibly ``item``
        itself) when the queue is full, else ``None``."""
        self.n_offered += 1
        if len(self._items) < self.capacity:
            self._items.append(item)
            self.depth_high_water = max(self.depth_high_water, len(self._items))
            return None
        self.n_shed += 1
        if self.policy == "reject_new":
            return item
        victim = self._items.popleft()
        self._items.append(item)
        return victim

    def push_front(self, item) -> None:
        """Re-queue an item at the head (transient admission fault retry);
        deliberately allowed to overfill by the in-flight item — the item
        was already admitted once and must not be shed by its own retry."""
        self._items.appendleft(item)

    def pop(self):
        """Dequeue the oldest item, or ``None`` when empty."""
        return self._items.popleft() if self._items else None

    def drain_if(self, pred) -> list:
        """Remove and return every queued item matching ``pred`` (deadline
        expiry sweep), preserving order among survivors."""
        taken, keep = [], deque()
        for it in self._items:
            (taken if pred(it) else keep).append(it)
        self._items = keep
        return taken

    def stats(self) -> dict:
        return {"depth": len(self._items), "capacity": self.capacity,
                "policy": self.policy, "n_offered": self.n_offered,
                "n_shed": self.n_shed,
                "depth_high_water": self.depth_high_water}
