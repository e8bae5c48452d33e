"""The control comes out not correct: the reference, computed one
precision lower (TF32 for the configuration's f32 with TF32 off), in the
program's place, fails one of the cell's compared numbers, while the
program at the same size passes them.  TF32 exists only on the card, so
these run there (``calibrate.py`` runs the same at the cells' own sizes,
on a dozen seeds)."""

import pytest

from perfbench import calibrate
from perfbench.harness.manifest import BENCH, Cell, _json

SEEDS = (2**31 + 101, 2**31 + 211, 2**31 + 307)


def _cell(config, traffic, workload, **over):
    tr = _json(BENCH / "traffic" / f"{traffic}.json")
    tr.update(over)
    return Cell(workload, {"chips": 1}, _json(BENCH / "configs" / f"{config}.json"),
                tr, _json(BENCH / "checks" / f"{workload}.json"), [], [])


def _fails(readings, limits):
    """Whether any number that ``readings`` holds is over its limit (the
    window's numbers are read by a run, not by ``calibrate``)."""
    return any(readings[k] > v for k, v in limits.items() if k in readings)


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_learner_control_and_half_batch_fault_fail(cuda, seed):
    cell = _cell("damoldqn-general", "learner512", "general.learner512",
                 workers=32)
    r = calibrate.learner_readings(cell, seed, cuda)
    assert not _fails(r["program"], cell.limits), r["program"]
    assert _fails(r["control_tf32"], cell.limits), r["control_tf32"]
    assert _fails(r["fault_half_batch"], cell.limits), r["fault_half_batch"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_server_control_fails(cuda, seed):
    cell = _cell("damoldqn-molopt", "closed64", "molopt.closed64",
                 slots=16, clients=16, check_sample=24, warmup_steps=4)
    r = calibrate.serve_readings(cell, seed, cuda, 3.0)
    assert not _fails(r["program"], cell.limits), r["program"]
    assert r["control_tf32"]["q_gap"] > cell.limits["q_gap"], r["control_tf32"]
    assert _fails(r["fault_wrong_pick"], cell.limits), r["fault_wrong_pick"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_trainer_control_and_half_batch_fault_fail(cuda, seed):
    cell = _cell("damoldqn-general", "antioxidant256", "general.antioxidant256",
                 workers=16, check_workers=2)
    r = calibrate.episode_readings(cell, seed, cuda)
    lim = cell.limits
    learn = {k: lim[k] for k in ("loss1_gap", "grad_gap_p90", "change_gap_p90",
                                 "change_gap_worst")}
    assert r["rollout"]["q_gap"] <= lim["q_gap"], r["rollout"]
    assert r["rollout"]["mismatches"] == 0, r["rollout"]
    assert not _fails(r["program"], learn), r["program"]
    assert r["sync"]["sync_gap"] <= lim["sync_gap"], r["sync"]
    assert r["rollout"]["ctl_q_gap"] > lim["q_gap"] \
        or _fails(r["control_tf32"], learn), (r["rollout"], r["control_tf32"])
    assert _fails(r["fault_half_batch"], learn), r["fault_half_batch"]
    assert r["sync"]["sync_left_out_gap"] > lim["sync_gap"], r["sync"]
