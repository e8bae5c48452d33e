"""The port's span recorder (``core/spans.py``) and the spans and
worker-update counter it gives ``DistributedTrainer``, on the CPU.

The recorder sums host seconds and calls per span and counts per counter;
only while a torch profiler records is a span also a ``record_function``
range.  The trainer's spans nest as ``trace_stats`` documents, count one
call per round, run of stacked rows or episode, and leave the private
methods that an instance wrap replaces (as the benchmark's does) called
through ``self``.
"""

import sys
import threading
import time

import pytest
import torch
from torch.autograd.profiler import profile

from repro_torch.chem.smiles import from_smiles
from repro_torch.core import (DQNConfig, EnvConfig, RewardConfig,
                              TrainerConfig)
from repro_torch.core import spans as spans_mod
from repro_torch.core.agent import QNetwork
from repro_torch.core.distributed import LEARNER_MODES, DistributedTrainer
from repro_torch.core.spans import SpanRecorder
from repro_torch.predictors.service import OracleService

SMILES = ("C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O", "CC1=CC=CC=C1O",
          "OC1=CC=CC=C1O")
WRAPPED = ("_stacked_sample_packed_np", "_ship", "_update_once")


# ---- the recorder ------------------------------------------------------ #
def test_nested_spans_add_seconds_and_calls():
    rec = SpanRecorder()
    for _ in range(3):
        with rec.span("outer"):
            with rec.span("inner"):
                time.sleep(0.002)
            with rec.span("inner"):
                pass
    snap = rec.snapshot()
    assert snap["calls"] == {"outer": 3, "inner": 6}
    assert snap["seconds"]["inner"] >= 3 * 0.002
    assert snap["seconds"]["outer"] >= snap["seconds"]["inner"]
    assert snap["counts"] == {}


def test_count_adds_and_snapshots_are_copies():
    rec = SpanRecorder()
    rec.count("a")
    rec.count("a", 4)
    rec.count("b", 0)
    before = rec.snapshot()
    rec.count("a", 2)
    assert before["counts"] == {"a": 5, "b": 0}
    assert rec.snapshot()["counts"] == {"a": 7, "b": 0}


def test_a_span_that_raises_is_still_counted():
    rec = SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("boom"):
            raise ValueError("inside")
    assert rec.snapshot()["calls"] == {"boom": 1}


class _CountingRange:
    made = 0

    def __init__(self, name):
        type(self).made += 1
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("profiling", [False, True])
def test_a_range_is_built_only_while_a_profiler_records(profiling, monkeypatch):
    monkeypatch.setattr(_CountingRange, "made", 0)
    monkeypatch.setattr(spans_mod, "record_function", _CountingRange)
    rec = SpanRecorder()
    if profiling:
        with profile(use_kineto=True):
            for _ in range(5):
                with rec.span("s"):
                    pass
    else:
        for _ in range(5):
            with rec.span("s"):
                pass
    assert _CountingRange.made == (5 if profiling else 0)
    assert rec.snapshot()["calls"] == {"s": 5}


def test_spans_are_nested_ranges_under_the_profiler():
    rec = SpanRecorder()
    with profile(use_kineto=True) as prof:
        with rec.span("t.outer"):
            with rec.span("t.inner"):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.function_events
          if e.name in ("t.outer", "t.inner")}
    assert set(ev) == {"t.outer", "t.inner"}
    assert ev["t.inner"].cpu_parent is not None
    assert ev["t.inner"].cpu_parent.name == "t.outer"


def test_spans_from_many_threads_are_all_counted():
    rec = SpanRecorder()
    n_threads, n = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with rec.span("thread"):
                    rec.count("c", 2)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot()
    assert snap["calls"] == {"thread": n_threads * n}
    assert snap["counts"] == {"c": 2 * n_threads * n}


# ---- the trainer's spans ---------------------------------------------- #
def _narrow_layers():
    g = torch.Generator().manual_seed(3)
    sizes = (2049, 32, 16, 8, 4, 1)
    return [(torch.randn(i, o, generator=g) * (2.0 / i) ** 0.5,
             0.1 * torch.randn(o, generator=g))
            for i, o in zip(sizes[:-1], sizes[1:])]


def _port(**kw) -> DistributedTrainer:
    base = dict(n_workers=2, mols_per_worker=2, episodes=2,
                updates_per_episode=3, train_batch_size=4, max_candidates=16,
                env=EnvConfig(max_steps=3), seed=0)
    base.update(kw)
    return DistributedTrainer(
        TrainerConfig(dqn=DQNConfig(epsilon_initial=0.3, epsilon_decay=0.9),
                      **base),
        [from_smiles(s) for s in SMILES], OracleService(), RewardConfig(),
        network=QNetwork(hidden=(32, 16, 8, 4), device="cpu",
                         layers=_narrow_layers()), device="cpu")


@pytest.fixture
def filled():
    """A trainer per learner mode whose buffers hold an episode."""
    made = []

    def make(**kw):
        tr = _port(**kw)
        tr.rollout_episode()
        made.append(tr)
        return tr
    yield make
    for tr in made:
        tr.close()


@pytest.mark.parametrize("learner", LEARNER_MODES)
def test_run_updates_spans_and_worker_update_count(learner, filled):
    tr = filled(learner=learner)
    before = tr.trace_stats()
    tr.run_updates(2)
    after = tr.trace_stats()
    calls = {k: v - before["calls"].get(k, 0) for k, v in after["calls"].items()}
    s = {k: v - before["seconds"].get(k, 0.0)
         for k, v in after["seconds"].items()}
    counts = {k: v - before["counts"].get(k, 0)
              for k, v in after["counts"].items()}
    W = tr.n_live_workers
    assert counts["trainer.worker_updates"] == 2 * W
    # the narrow fleet is one run of rows a step: W rows a stacked step
    assert counts["trainer.stacked_chunks"] == 2
    assert counts["trainer.worker_updates"] // counts["trainer.stacked_chunks"] == W
    assert calls["trainer.stacked_grad"] == 2
    assert calls["trainer.stacked_adam"] == 2
    assert calls["trainer.updates"] == 1
    for name in ("trainer.sample", "trainer.ship", "trainer.update",
                 "trainer.loss_read"):
        assert calls[name] == 2, name
    assert calls.get("trainer.densify", 0) == (0 if learner == "dense" else 2)
    children = (s.get("trainer.densify", 0.0) + s["trainer.stacked_grad"]
                + s["trainer.stacked_adam"])
    assert s["trainer.update"] >= children
    if learner != "packed_pipelined":   # its sampling runs on another thread
        assert s["trainer.updates"] >= (
            s["trainer.sample"] + s["trainer.ship"] + s["trainer.update"]
            + s["trainer.loss_read"])


def test_train_episode_adds_one_rollout_and_one_sync():
    tr = _port()
    tr.train_episode()
    before = tr.trace_stats()["calls"]
    tr.train_episode()
    after = tr.trace_stats()["calls"]
    tr.close()
    assert after["trainer.rollout"] - before["trainer.rollout"] == 1
    assert after["trainer.sync"] - before["trainer.sync"] == 1
    assert after["trainer.updates"] - before["trainer.updates"] == 1
    assert after["trainer.update"] - before["trainer.update"] == 3
    assert not hasattr(tr, "rollout_s") and not hasattr(tr, "learner_s")


@pytest.mark.parametrize("learner", ["packed", "packed_pipelined"])
def test_instance_wraps_see_every_call(learner, filled):
    tr = filled(learner=learner)
    seen = {a: 0 for a in WRAPPED}
    for attr in WRAPPED:
        fn = getattr(tr, attr)

        def wrapped(*a, _fn=fn, _attr=attr, **k):
            seen[_attr] += 1
            return _fn(*a, **k)
        setattr(tr, attr, wrapped)
    tr.run_updates(3)
    assert seen == {a: 3 for a in WRAPPED}
    calls = tr.trace_stats()["calls"]
    for name in ("trainer.sample", "trainer.ship", "trainer.update"):
        assert calls[name] == 3, name


def test_trainer_spans_nest_under_the_profiler(filled):
    tr = filled(learner="packed")
    with profile(use_kineto=True) as prof:
        tr.run_updates(1)
    parent = {}
    for e in prof.function_events:
        if e.name.startswith("trainer.") and e.cpu_parent is not None:
            parent.setdefault(e.name, set()).add(e.cpu_parent.name)
    assert parent["trainer.stacked_grad"] == {"trainer.update"}
    assert parent["trainer.stacked_adam"] == {"trainer.update"}
    assert parent["trainer.densify"] == {"trainer.update"}
    for name in ("trainer.sample", "trainer.ship", "trainer.update",
                 "trainer.loss_read"):
        assert parent[name] == {"trainer.updates"}, name
