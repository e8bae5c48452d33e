"""The port's checkpoint layer: a twin of each of ``tests/test_checkpoint.py``'s
tests against ``repro_torch.checkpoint``, and the file format held against
``repro.checkpoint`` in both directions.

The contract under test is the reference's: a checkpoint file either
loads COMPLETELY or raises ``CheckpointError`` — never a partial or
garbage tree — and a manager restore walks back through the rotation
until it finds a readable snapshot.  Across the packages, a tree or a
flat dict written by one loads in the other with equal keys, manifests,
dtypes and bytes, and both serialize a numpy generator to the same
array.
"""

import os

import numpy as np
import pytest
import torch

import repro.checkpoint as J
from repro_torch.checkpoint import (
    CheckpointError, CheckpointManager, load_flat, load_pytree,
    rng_state_from_array, rng_state_to_array, save_flat, save_pytree,
    tree_leaves, tree_leaves_with_paths, unflatten_like,
)
from repro_torch.core.faults import FaultPlan, FaultRule

TREE = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": {"c": np.asarray(3, np.int64),
              "d": np.ones((4,), np.uint8)}}


# ------------------------------------------------------------------ #
# manifest validation + corruption (twins of tests/test_checkpoint.py)
# ------------------------------------------------------------------ #
def test_flat_roundtrip_and_manifest(tmp_path):
    path = str(tmp_path / "x.npz")
    flat = {"p/0": np.arange(4, dtype=np.float64),
            "p/1": np.asarray(7, np.int64)}
    save_flat(path, flat)
    out = load_flat(path)
    assert sorted(out) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(out[k], flat[k])


def test_reserved_manifest_key_refused(tmp_path):
    with pytest.raises(ValueError):
        save_flat(str(tmp_path / "x.npz"), {"__manifest__": np.zeros(1)})


def test_missing_file_is_filenotfound_not_corrupt(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_flat(str(tmp_path / "nope.npz"))


def test_truncated_checkpoint_raises_loud(tmp_path):
    path = str(tmp_path / "x.npz")
    save_pytree(path, TREE)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(CheckpointError):
        load_pytree(path, TREE)


def test_garbage_file_raises_checkpoint_error(tmp_path):
    path = str(tmp_path / "x.npz")
    with open(path, "wb") as f:
        f.write(b"not an npz archive at all")
    with pytest.raises(CheckpointError):
        load_flat(path)


def test_missing_key_vs_manifest_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    save_flat(path, {"a": np.zeros(2), "b": np.ones(2)})
    data = dict(np.load(path))
    del data["b"]
    np.savez(path, **data)   # manifest still lists "b"
    with pytest.raises(CheckpointError):
        load_flat(path)


def test_unmanifested_archive_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, a=np.zeros(2))
    with pytest.raises(CheckpointError):
        load_flat(path)


def test_kill_mid_write_torture(tmp_path):
    """Truncations at many offsets: the load either succeeds completely
    (only when nothing was cut) or raises CheckpointError."""
    path = str(tmp_path / "x.npz")
    save_pytree(path, TREE)
    blob = open(path, "rb").read()
    rng = np.random.default_rng(0)
    offsets = sorted(set(
        list(rng.integers(1, len(blob), size=40)) + [1, len(blob) - 1]))
    for off in offsets:
        with open(path, "wb") as f:
            f.write(blob[:off])
        try:
            out = load_pytree(path, TREE)
        except CheckpointError:
            continue
        np.testing.assert_array_equal(out["a"], TREE["a"])
        np.testing.assert_array_equal(out["b"]["d"], TREE["b"]["d"])
        assert off == len(blob), \
            f"truncation at {off}/{len(blob)} loaded without error"


def test_unflatten_like_validates_shape_and_missing():
    flat = {"a": np.zeros((2, 3), np.float32),
            "b/c": np.asarray(1, np.int64), "b/d": np.zeros((4,), np.uint8)}
    out = unflatten_like(dict(flat), TREE)
    assert out["a"].shape == (2, 3)
    bad = dict(flat)
    bad["a"] = np.zeros((9, 9), np.float32)
    with pytest.raises(CheckpointError):
        unflatten_like(bad, TREE)
    del flat["b/c"]
    with pytest.raises(CheckpointError):
        unflatten_like(flat, TREE)


def test_latest_pointer_and_stale_pointer_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in (1, 2, 3):
        mgr.save(s, TREE)
    assert (tmp_path / "LATEST").read_text().strip() == "3"
    (tmp_path / "LATEST").write_text("999")
    assert mgr.latest_step() == 3
    (tmp_path / "LATEST").write_text("garbage")
    assert mgr.latest_step() == 3


def test_corrupt_newest_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in (1, 2):
        mgr.save(s, TREE)
    newest = tmp_path / "ckpt_2.npz"
    blob = newest.read_bytes()
    newest.write_bytes(blob[: len(blob) // 3])
    step, out = mgr.restore(TREE)
    assert step == 1
    np.testing.assert_array_equal(out["a"], TREE["a"])


def test_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, TREE)
    p = tmp_path / "ckpt_1.npz"
    p.write_bytes(p.read_bytes()[:10])
    with pytest.raises(CheckpointError):
        mgr.restore(TREE)


def test_save_retries_under_fault_plan(tmp_path):
    plan = FaultPlan([FaultRule(site="checkpoint", kind="transient",
                                every=1, fail_attempts=1)])
    mgr = CheckpointManager(str(tmp_path), fault_plan=plan, save_retries=2)
    mgr.save(1, TREE)
    assert mgr.latest_step() == 1
    assert mgr.n_save_retries == 1
    step, out = mgr.restore(TREE)
    np.testing.assert_array_equal(out["a"], TREE["a"])


def test_save_retries_exhausted_raise(tmp_path):
    plan = FaultPlan([FaultRule(site="checkpoint", kind="transient",
                                every=1, fail_attempts=10)])
    mgr = CheckpointManager(str(tmp_path), fault_plan=plan, save_retries=2)
    with pytest.raises(CheckpointError):
        mgr.save(1, TREE)
    assert mgr.latest_step() is None


def test_rng_state_roundtrip_exact():
    rng = np.random.default_rng(1234)
    rng.random(17)
    rng.integers(0, 10, 3)
    arr = rng_state_to_array(rng)
    assert arr.dtype == np.uint64 and arr.shape == (6,)
    clone = rng_state_from_array(arr)
    np.testing.assert_array_equal(clone.random(32), rng.random(32))
    np.testing.assert_array_equal(clone.integers(0, 1000, 16),
                                  rng.integers(0, 1000, 16))


# ------------------------------------------------------------------ #
# the tree walk: JAX's key paths and leaf order
# ------------------------------------------------------------------ #
# dict keys out of order, nested lists, tuples, None, scalars and torch
# tensors: the predictors' and the trainer's tree shapes and then some
NESTED = {
    "rounds": [{"self": {"w": np.ones((2, 2), np.float32), "b": np.zeros(2, np.float32)},
                "msg": [{"w": np.full((2, 2), i, np.float32), "b": np.arange(2, dtype=np.float32)}
                        for i in range(3)],
                "ln_scale": np.ones(2, np.float32), "ln_bias": np.zeros(2, np.float32)}],
    "embed": {"w": np.eye(3, dtype=np.float32), "b": np.zeros(3, np.float32)},
    "ensemble": [{"pool2": np.zeros(1, np.float32), "atom1": np.ones(1, np.float32),
                  "pool1": np.ones(2, np.float32), "atom2": np.ones(3, np.float32)}],
    "pair": (np.int32(7), np.arange(3, dtype=np.int64)),
    "none": None,
    "scalar": 2.5,
}


def test_tree_paths_and_order_are_jax_s():
    """Keys are ``jax.tree_util``'s path strings (dict keys sorted, list
    and tuple indices, None an empty subtree), and the leaf order is
    ``tree_leaves``' — checked on the values' bytes, not only the keys."""
    import jax
    from repro.checkpoint.checkpoint import _flatten_with_paths
    want = _flatten_with_paths(NESTED)
    got = tree_leaves_with_paths(NESTED)
    assert [k for k, _ in got] == list(want)
    assert "rounds/0/msg/2/w" in want and "ensemble/0/atom1" in want
    assert [np.asarray(v).tobytes() for v in tree_leaves(NESTED)] == \
        [np.asarray(v).tobytes() for v in jax.tree_util.tree_leaves(NESTED)]


def test_torch_leaves_are_saved_as_their_bytes(tmp_path):
    path = str(tmp_path / "t.npz")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, requires_grad=True), "step": torch.tensor([1, 2], dtype=torch.int32)}
    save_pytree(path, tree)
    flat = load_flat(path)
    assert sorted(flat) == ["b", "step", "w"]
    assert flat["w"].tobytes() == tree["w"].numpy().tobytes()
    assert flat["step"].dtype == np.int32
    out = load_pytree(path, {k: v.detach().numpy() for k, v in tree.items()})
    assert out["b"].tobytes() == np.ones(3, np.float32).tobytes()


# ------------------------------------------------------------------ #
# across the packages, both directions
# ------------------------------------------------------------------ #
def _archive(path):
    with np.load(path) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trees_cross_between_the_packages(tmp_path, writer):
    """A tree written by one package loads in the other: same keys, the
    same manifest, and every array with the same dtype and bytes."""
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    J.save_pytree(ref_path, NESTED)
    save_pytree(port_path, NESTED)
    assert _archive(ref_path) == _archive(port_path)
    src = ref_path if writer == "reference" else port_path
    for loaded in (load_pytree(src, NESTED), J.load_pytree(src, NESTED)):
        got = tree_leaves_with_paths(loaded)
        want = tree_leaves_with_paths(NESTED)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert load_flat(src).keys() == J.load_flat(src).keys()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_flat_dicts_cross_between_the_packages(tmp_path, writer):
    flat = {"meta/config": np.frombuffer(b'{"a": 1}', np.uint8).copy(),
            "params/0": np.arange(12, dtype=np.float32).reshape(3, 4),
            "opt/0": np.array([1, 2], np.int32),
            "rng/worker_0": rng_state_to_array(np.random.default_rng(5)),
            "replay/0/size": np.int64(9)}
    path = str(tmp_path / "f.npz")
    (J.save_flat if writer == "reference" else save_flat)(path, flat)
    other = str(tmp_path / "g.npz")
    (save_flat if writer == "reference" else J.save_flat)(other, flat)
    assert _archive(path) == _archive(other)
    for out in (load_flat(path), J.load_flat(path)):
        assert sorted(out) == sorted(flat)
        for k, v in flat.items():
            assert out[k].dtype == np.asarray(v).dtype
            assert out[k].tobytes() == np.asarray(v).tobytes()


def test_rng_state_arrays_match_the_reference():
    for seed in (0, 7, 2**40 + 3):
        rng = np.random.default_rng(seed)
        rng.random(5)
        rng.integers(0, 3, 1)    # leaves a cached half-word (has_uint32)
        a, b = rng_state_to_array(rng), J.rng_state_to_array(rng)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(rng_state_from_array(b).random(8),
                                      J.rng_state_from_array(a).random(8))


def test_manager_directories_cross_between_the_packages(tmp_path):
    """A directory rotated by the reference's manager restores in the
    port's, LATEST pointer included, and the reverse."""
    jm = J.CheckpointManager(str(tmp_path / "j"), max_to_keep=2)
    tm = CheckpointManager(str(tmp_path / "t"), max_to_keep=2)
    for s in (1, 2, 3):
        jm.save(s, {"x": np.full(3, s, np.float32)})
        tm.save(s, {"x": np.full(3, s, np.float32)})
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    for mgr, other in ((CheckpointManager(str(tmp_path / "j")), "j"),
                       (J.CheckpointManager(str(tmp_path / "t")), "t")):
        step, flat = mgr.restore_flat()
        assert step == 3 and np.asarray(flat["x"]).tolist() == [3.0] * 3, other
    assert J.load_flat(str(tmp_path / "t" / "ckpt_2.npz"))["x"].tolist() == [2.0] * 3
