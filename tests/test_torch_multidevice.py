"""The port's multi-device truth run, in process on logical CPU shards.

The counterpart of ``tests/multidevice``: the same scenarios, each run
through ``repro_torch.launch.verify`` at nd in {1, 2, 4} of an 8-shard
CPU pool, and every nd > 1 report bit-identical to the port's own nd = 1
run of the same seed (transition digests and counts, loss and reward
trajectories, every live worker's parameter bits), with 0 shape events
after warmup.  Torch needs nothing set before start-up, so only the
crash-resume cells spawn a child (the one that is killed).

* the four cells of ``tests/multidevice/test_equivalence.py`` (every
  rollout, learner, chem, sync and acting mode at least once);
* prioritized replay at alpha = 0 against uniform, and alpha = 0.6 against
  itself;
* a ragged fleet, W = 6 on 4 shards (W_pad = 8, two dead slots), in both
  sync modes, and what its padded checkpoint holds;
* crash-resume at nd in {2, 4}: a ``--kill-at 2`` child, then ``--resume``;
* the scenario fleets of ``tests/multidevice/test_scenarios.py``;
* hypothesis seeds over W in {4, 8} (``test_seed_matrix.py``);
* ``launch/mesh.py`` (``padded_worker_count`` against the reference's),
  ``data.pipeline.shard_batch``, one kernel call per shard per dispatch,
  and checkpoints across meshes.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.launch.mesh import padded_worker_count as jax_padded_worker_count
from repro_torch.checkpoint import CheckpointError
from repro_torch.chem.smiles import from_smiles
from repro_torch.core import (DQNConfig, EnvConfig, RewardConfig, TrainerConfig,
                              distributed)
from repro_torch.core.agent import QNetwork
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import verify
from repro_torch.launch.mesh import (HostMesh, batch_axes, make_host_mesh,
                                     mesh_tp, padded_worker_count, shard_slices)
from repro_torch.predictors.service import OracleService

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
CHILD_TIMEOUT_S = 600
CELLS = (
    dict(rollout="fleet_sharded", learner="packed", chem="incremental",
         sync="episode", acting="packed"),
    dict(rollout="fleet_pipelined", learner="packed_pipelined",
         chem="incremental", sync="step", acting="packed_async"),
    dict(rollout="fleet", learner="dense", chem="full", sync="episode",
         acting="dense"),
    dict(rollout="per_worker", learner="dense", chem="full", sync="step",
         acting="dense"),
)
MIX = "antioxidant,qed,plogp,antioxidant_novel"


def _argv(**kw) -> list[str]:
    argv = ["--out", "unused", "--device", "cpu"]
    for k, v in kw.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


def _run(nd: int, **kw) -> dict:
    return verify.run_scenario(verify.parser().parse_args(_argv(nd=nd, **kw)))


def _cells(nds, **kw) -> dict[int, dict]:
    return {nd: _run(nd, **kw) for nd in nds}


def _assert_equivalent(ref: dict, other: dict, ctx: str) -> None:
    """``tests/multidevice/mdhelpers.assert_equivalent``: transitions,
    trajectories and every live worker's parameter bits."""
    assert list(other["transition_digests"]) == list(ref["transition_digests"]), ctx
    np.testing.assert_array_equal(other["n_transitions"], ref["n_transitions"],
                                  err_msg=ctx)
    for k in ("losses", "rewards"):
        assert other[k].tobytes() == ref[k].tobytes(), f"{ctx}: {k}"
    keys = sorted(k for k in ref if k.startswith("param_"))
    assert keys and keys == sorted(k for k in other if k.startswith("param_"))
    for k in keys:
        assert other[k].shape == ref[k].shape and \
            other[k].tobytes() == ref[k].tobytes(), f"{ctx}: {k}"


# ------------------------------------------------------------------ #
# the equivalence matrix
# ------------------------------------------------------------------ #
@pytest.mark.parametrize(
    "cell", CELLS,
    ids=lambda c: (f"{c['rollout']}-{c['learner']}-{c['chem']}-"
                   f"{c['acting']}-{c['sync']}"))
def test_matrix_cell_identical_across_nd(cell):
    res = _cells((1, 2, 4), **cell)
    if cell["rollout"] != "per_worker":   # the fleet view's buffer grows
        assert int(res[1]["warmup_compiles"]) > 0
    for nd in (1, 2, 4):
        assert int(res[nd]["n_devices"]) == nd
        assert int(res[nd]["device_pool"]) == verify.DEFAULT_DEVICE_POOL
        assert int(res[nd]["recompiles_after_warmup"]) == 0, nd
        _assert_equivalent(res[1], res[nd], f"nd={nd} {cell}")


def test_prioritized_alpha_zero_matches_uniform_across_nd():
    cell = dict(CELLS[0])
    uniform = _run(1, replay="uniform", **cell)
    for nd in (1, 2, 4):
        got = _run(nd, replay="prioritized", priority_alpha=0.0, **cell)
        assert int(got["recompiles_after_warmup"]) == 0
        _assert_equivalent(uniform, got, f"prioritized(alpha=0) nd={nd}")


def test_prioritized_alpha_active_self_consistent_across_nd():
    res = _cells((1, 2, 4), replay="prioritized", priority_alpha=0.6,
                 **CELLS[0])
    uniform = _run(1, **CELLS[0])
    assert res[1]["losses"].tobytes() != uniform["losses"].tobytes()
    for nd in (2, 4):
        _assert_equivalent(res[1], res[nd], f"prioritized(alpha=0.6) nd={nd}")


@pytest.mark.parametrize("sync", ["episode", "step"])
def test_ragged_fleet_pads_to_mesh(sync):
    """W = 6 on 4 shards: two dead slots, and the live workers' results
    identical to the unpadded nd = 1 run."""
    res = _cells((1, 4), workers=6, sync=sync)
    assert int(res[1]["n_padded_workers"]) == 6
    assert int(res[4]["n_live_workers"]) == 6
    assert int(res[4]["n_padded_workers"]) == 8
    assert int(res[4]["recompiles_after_warmup"]) == 0
    _assert_equivalent(res[1], res[4], f"ragged W=6 nd=4 sync={sync}")


def _trainer(nd: int, workers: int = 4, **over) -> distributed.DistributedTrainer:
    """A trainer at ``verify``'s small defaults on ``nd`` CPU shards."""
    cfg = TrainerConfig(n_workers=workers, mols_per_worker=2, episodes=4,
                        updates_per_episode=2, train_batch_size=4,
                        max_candidates=16, dqn=DQNConfig(epsilon_decay=0.9),
                        env=EnvConfig(max_steps=3), **over)
    mols = [from_smiles(verify.MOLS_SMILES[i % len(verify.MOLS_SMILES)])
            for i in range(workers * 2)]
    net = QNetwork(hidden=(32,), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return distributed.DistributedTrainer(
        cfg, mols, OracleService(), RewardConfig(), network=net,
        mesh=make_host_mesh(nd, device="cpu"))


def _trained(nd: int, episodes: int, **kw) -> distributed.DistributedTrainer:
    tr = _trainer(nd, **kw)
    tr.train(episodes)
    tr.close()
    return tr


@pytest.mark.parametrize("sync", ["episode", "step"])
def test_padded_checkpoint_holds_the_dead_rows(sync):
    """A padded ``state_dict`` holds ``[W_pad, ...]`` leaves: its live rows
    are the unpadded run's bit for bit; its dead rows took every Adam step
    (their step counters equal the live ones) and, at an episode boundary,
    hold the synced (episode) or replicated (step) parameters and moments,
    as the reference's masked update bodies leave them."""
    padded = _trained(4, 3, workers=6, sync_mode=sync).state_dict()
    plain = _trained(1, 3, workers=6, sync_mode=sync).state_dict()
    assert sorted(padded) == sorted(plain)
    for key in sorted(plain):
        a, b = np.asarray(padded[key]), np.asarray(plain[key])
        if not key.startswith(("params/", "target/", "opt/")):
            assert a.tobytes() == b.tobytes(), key
            continue
        assert a.shape == (8,) + b.shape[1:] and a.dtype == b.dtype, key
        assert a[:6].tobytes() == b.tobytes(), key
        for dead in (6, 7):
            assert a[dead].tobytes() == a[0].tobytes(), (key, dead)
    assert np.asarray(padded["opt/0"]).tolist() == [6] * 8   # 3 episodes x 2


# ------------------------------------------------------------------ #
# crash-resume (tests/multidevice/test_crash_resume.py)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("cell", [
    dict(nd=2, replay="prioritized", rollout="fleet_sharded",
         learner="packed", acting="packed"),
    dict(nd=4, replay="uniform", rollout="fleet_pipelined", learner="packed",
         acting="packed_async"),
], ids=lambda c: f"nd{c['nd']}-{c['replay']}-{c['rollout']}")
def test_killed_run_resumes_bit_identical(tmp_path, cell):
    base = dict(cell, mols_per_worker=2, warmup=1, episodes=3, seed=5,
                chem="incremental")
    ck = tmp_path / "ck"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    argv = _argv(ckpt_dir=ck, kill_at=2, **base)
    argv[1] = str(tmp_path / "killed.npz")
    killed = subprocess.run([sys.executable, "-m", "repro_torch.launch.verify",
                             *argv], env=env, cwd=REPO, capture_output=True,
                            text=True, timeout=CHILD_TIMEOUT_S)
    assert killed.returncode == -signal.SIGKILL, killed.stdout + killed.stderr
    assert not (tmp_path / "killed.npz").exists()
    assert sorted(os.listdir(ck))[-1] == "ckpt_2.npz"
    resumed = verify.run_scenario(verify.parser().parse_args(
        _argv(ckpt_dir=ck, **base) + ["--resume"]))
    straight = _run(**base)
    ctx = f"nd={cell['nd']} {cell['replay']} resume"
    _assert_equivalent(straight, resumed, ctx)
    assert resumed["replay_state_digests"].tobytes() == \
        straight["replay_state_digests"].tobytes(), ctx
    assert len(resumed["losses"]) == 4
    assert int(resumed["recompiles_after_warmup"]) == 0


def test_checkpoint_crosses_meshes_of_one_padding():
    """W = 4 pads to 4 on 1, 2 and 4 shards: a checkpoint written at nd = 4
    restores at nd = 2 and the continued run is the unbroken nd = 1 run's
    bit for bit.  W = 6 pads to 8 at nd = 4 and to 6 at nd = 1: the leaf
    shapes differ, and the load raises naming the leaf."""
    state = _trained(4, 2).state_dict()
    moved = _trainer(2)
    moved.load_state_dict(state)
    moved.train(2)
    moved.close()
    got, want = moved.state_dict(), _trained(1, 4).state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k

    ragged = _trained(4, 1, workers=6).state_dict()
    with pytest.raises(CheckpointError, match=r"leaf 'params/0'.*\(8, 32\)"):
        _trainer(1, workers=6).load_state_dict(ragged)


# ------------------------------------------------------------------ #
# scenario fleets (tests/multidevice/test_scenarios.py)
# ------------------------------------------------------------------ #
def test_homogeneous_antioxidant_scenario_matches_default_across_nd():
    base = _run(1)
    for nd in (1, 2, 4):
        got = _run(nd, scenarios="antioxidant")
        assert int(got["recompiles_after_warmup"]) == 0
        _assert_equivalent(base, got, f"scenarios=antioxidant nd={nd}")


def test_mixed_scenario_fleet_identical_across_nd():
    res = _cells((1, 2, 4), scenarios=MIX)
    for nd in (2, 4):
        assert int(res[nd]["recompiles_after_warmup"]) == 0
        _assert_equivalent(res[1], res[nd], f"scenarios={MIX} nd={nd}")


@pytest.mark.parametrize("nd", [1, 4])
def test_mixed_fleet_worker_matches_solo_twin(nd):
    runs = {tag: _run(nd, scenarios=scen, updates_per_episode=0)
            for tag, scen in (("mixed", "antioxidant,qed"),
                              ("anti", "antioxidant"), ("qed", "qed"))}
    for w in range(4):
        twin = "anti" if w % 2 == 0 else "qed"
        assert runs["mixed"]["transition_digests"][w] == \
            runs[twin]["transition_digests"][w], (nd, w)
        assert runs["mixed"]["n_transitions"][w] == runs[twin]["n_transitions"][w]


# ------------------------------------------------------------------ #
# seeds (tests/multidevice/test_seed_matrix.py)
# ------------------------------------------------------------------ #
_SEEDED = dict(warmup=0, episodes=1, max_steps=2, updates_per_episode=1,
               batch_size=2, hidden="16", rollout="fleet_sharded",
               learner="packed", chem="incremental")


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**20), W=st.sampled_from([4, 8]),
       sync=st.sampled_from(["episode", "step"]))
def test_seeded_matrix_bit_identical_across_nd(seed, W, sync):
    res = _cells((1, 2, 4), workers=W, seed=seed, sync=sync, **_SEEDED)
    for nd in (2, 4):
        _assert_equivalent(res[1], res[nd], f"seed={seed} W={W} sync={sync} nd={nd}")


# ------------------------------------------------------------------ #
# the mesh, the batch split and the per-shard dispatch
# ------------------------------------------------------------------ #
def test_host_mesh_on_the_cpu():
    cpu = torch.device("cpu")
    assert make_host_mesh(device="cpu").devices == (cpu,)
    mesh = make_host_mesh(4, device="cpu")
    assert mesh.devices == (cpu,) * 4 and mesh.size == 4
    assert mesh.shape == {"data": 4} and batch_axes(mesh) == ("data",)
    assert mesh_tp(mesh) == 1
    assert make_host_mesh(2, pool=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="outside"):
        make_host_mesh(4, pool=["cpu"] * 3)
    with pytest.raises(ValueError, match="outside"):
        make_host_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        HostMesh(())


def test_host_mesh_on_cuda_needs_a_pool_past_the_visible_cards(monkeypatch):
    """On CUDA ``nd`` above the visible cards raises; an explicit pool
    repeats a card.  (Only ``torch.device`` objects are built: no card is
    touched.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = lambda i: torch.device("cuda", i)
    assert make_host_mesh().devices == (cuda(0), cuda(1))
    assert make_host_mesh(device="cuda:1").devices == (cuda(1), cuda(0))
    assert make_host_mesh(1).devices == (torch.device("cuda"),)
    with pytest.raises(ValueError, match="explicit pool"):
        make_host_mesh(4)
    assert make_host_mesh(4, pool=["cuda:0"] * 4).devices == (cuda(0),) * 4
    assert make_host_mesh(pool=["cuda:0"] * 3).size == 3


@pytest.mark.parametrize("nd", [1, 2, 3, 4, 8])
def test_padded_worker_count_matches_the_reference(nd):
    mesh = make_host_mesh(nd, device="cpu")
    ref_mesh = SimpleNamespace(devices=np.empty(nd))
    for w in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 512):
        assert padded_worker_count(w, mesh) == jax_padded_worker_count(w, ref_mesh)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            padded_worker_count(bad, mesh)


def test_shard_batch_splits_the_leading_dim():
    mesh = make_host_mesh(4, device="cpu")
    assert shard_slices(8, mesh) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                     slice(6, 8)]
    batch = {"a": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "b": torch.arange(8, dtype=torch.int32)}
    parts = shard_batch(batch, mesh)
    assert len(parts) == 4
    for s, part in enumerate(parts):
        assert part["a"].device == torch.device("cpu")
        assert torch.equal(part["a"], torch.from_numpy(batch["a"][2 * s:2 * s + 2]))
        assert part["b"].tolist() == [2 * s, 2 * s + 1]
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch({"a": np.zeros((6, 2))}, mesh)
    with pytest.raises(ValueError, match="disagree"):
        shard_batch({"a": np.zeros((8, 2)), "b": np.zeros((4,))}, mesh)


@pytest.mark.parametrize("acting", ["packed", "dense"])
def test_one_kernel_call_per_shard_per_dispatch(monkeypatch, acting):
    """Each fleet dispatch calls the stacked Q wrapper once per shard, on
    that shard's ``[W_pad / nd, C, ...]`` rows and parameters, the all-dead
    shard of W = 6 on 4 included."""
    name = "packed_qnet_stacked" if acting == "packed" else "dense_qnet_stacked"
    real, shapes = getattr(distributed, name), []

    def counted(weights, *rows):
        shapes.append((tuple(weights[0][0].shape[:1]), rows[0].shape[0]))
        return real(weights, *rows)
    monkeypatch.setattr(distributed, name, counted)
    tr = _trained(4, 1, workers=6, acting=acting)
    assert tr.n_q_dispatches > 0
    assert len(shapes) == 4 * tr.n_q_dispatches
    assert set(shapes) == {((2,), 2)}
