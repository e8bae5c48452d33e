"""The inputs are a function of the seed alone: the frozen pools, the
replay fill, the request schedule and the weights, pinned by digest."""

import hashlib

import numpy as np
import pytest
import torch

from perfbench.harness import inputs

from conftest import ROOT

SIZES = (2049, 1024, 512, 128, 32, 1)
SEED = 2**31 + 5
POOLS = {
    "antioxidant600": (600, "843f5c5ee7e9266eb81f842af52ff447186dfbfb0956923a208e478ef66ab96b"),
    "public256": (256, "79dc2992d1b4296b6512c695a847e47e075261867940450154b99f5f5c45df8e"),
    "antioxidant_train256": (256, "15802432b71fd02788f37d50a88152130cb196cf203e175b72b3ec68761118f9"),
}


def _fill_digest(fill) -> str:
    h = hashlib.sha256()
    for trs in fill:
        for t in trs:
            for k in ("state_fp", "next_fps"):
                h.update(t[k].tobytes())
            for k in ("steps_left_frac", "reward", "next_steps_left_frac"):
                h.update(np.float64(t[k]).tobytes())
            h.update(bytes([t["done"]]))
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(POOLS))
def test_frozen_pools(name):
    n, digest = POOLS[name]
    path = ROOT / "perfbench" / "data" / f"{name}.smi"
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest
    assert len(inputs.pool(name)) == n


def test_replay_fill_is_the_seeds():
    a = inputs.replay_fill(SEED, 3, 64, 64, 0.15)
    assert _fill_digest(a) == \
        "fd1578f19bcaca97e32092761dca2e2187c09dd2999251261386548ec2616f19"
    assert _fill_digest(inputs.replay_fill(SEED + 1, 3, 64, 64, 0.15)) != _fill_digest(a)
    counts = [t["next_fps"].shape[0] for trs in a for t in trs]
    assert max(counts) <= 64 and all(
        t["next_fps"].shape[0] == 0 for trs in a for t in trs if t["done"])


def test_schedule_is_the_seeds_and_every_seed_offers_the_same_work():
    s = inputs.closed_loop_schedule(SEED, 64, 256, 3, 8, 120)
    assert hashlib.sha256(repr(s).encode()).hexdigest() == \
        "544c95908f64068cbf64f14fcf9be6242bb63739a8425c380a47023cd2e15b7e"
    assert all(len(c) == 120 for c in s)
    other = inputs.closed_loop_schedule(SEED + 1, 64, 256, 3, 8, 120)
    assert other != s
    # the first 1,536 requests in client order hold every molecule at every
    # budget once, whatever the seed
    for sched in (s, other):
        first = sorted(r for i in range(24) for c in sched for r in [c[i]])
        assert first == sorted((m, b) for m in range(256) for b in range(3, 9))


def test_weights_are_the_seeds():
    w = inputs.qnet_weights(SIZES, SEED, "cpu")
    digest = hashlib.sha256(b"".join(x.numpy().tobytes() for wb in w for x in wb))
    assert digest.hexdigest() == \
        "6e2d41e47d34e447724df076021ea7877b4885fed60ca18ca9e08f0b6a50df96"
    assert [tuple(x.shape) for x, _ in w] == list(zip(SIZES[:-1], SIZES[1:]))
    assert all(float(b.abs().sum()) == 0.0 for _, b in w)
    assert abs(float(w[0][0].std()) - (2 / 2049) ** 0.5) < 1e-3


def test_every_pool_molecule_completes_a_request_on_the_cpu():
    """A molecule that cannot complete would make the failures depend on
    which requests fall inside the window."""
    from repro_torch.core.agent import QNetwork
    from repro_torch.predictors.service import (OracleService,
                                                ResilientService, RetryPolicy)
    from repro_torch.serving import MoleculeOptService, ServeConfig
    from repro_torch.serving.request import OptimizeRequest
    pool = inputs.pool("public256")
    net = QNetwork((8,), 2049, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    svc = MoleculeOptService(
        net, ResilientService(OracleService(), RetryPolicy(max_retries=1),
                              sleep=None),
        device="cpu", cfg=ServeConfig(n_slots=64, max_queue=len(pool),
                                      epsilon=0.05, seed=SEED))
    for i, smi in enumerate(pool):
        assert svc.submit(OptimizeRequest(f"p{i:03d}", smi, budget=8,
                                          seed=i)) == "queued"
    svc.run_until_idle()
    st = svc.stats()["status_counts"]
    assert st["completed"] == len(pool), st
