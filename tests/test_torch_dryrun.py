"""The port's dry-run half against the JAX reference, on the CPU: the
damoldqn config and its train and serve steps, the sharding plan, the
production mesh's specs, the roofline formulas, the op walk, the dry-run's
report, the slurm template and ``optim.sgd``.

The reference's ``repro.launch.dryrun`` is never imported here: its import
sets ``XLA_FLAGS`` to 512 host devices, which would change every later JAX
test in the same process.  Its tables are read from its source with
``ast``.  The reference's specs are built on a ``jax.sharding.AbstractMesh``
of the production shape, which needs no devices.

A reference ``PartitionSpec`` may list fewer entries than its leaf has
dims; the comparison pads it with ``None`` to the leaf's rank (the port's
specs list one entry per dim).  Tolerances of the qnet step are
``tests/test_torch_lm_train.py``'s: loss 1e-5 relative, first moments 1e-4
of each leaf's max, updates 1e-3 x lr where the gradient exceeds 1e-3 of
its leaf's max.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from torch_config_fields import with_port_only_fields
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core.agent import QNetwork as JaxQNetwork
from repro.launch import slurm as jax_slurm
from repro.launch import specs as JS
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.steps import pick_microbatches as jax_pick_microbatches
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.optim import sgd as jax_sgd
from repro.roofline import analysis as JA
from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, slurm
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import batch_axes, make_production_mesh, mesh_tp
from repro_torch.launch.steps import (loss_and_grads, make_serve_step,
                                      make_train_step, pick_microbatches)
from repro_torch.models import model as M
from repro_torch.models import params_from_numpy
from repro_torch.optim import sgd
from repro_torch.roofline import analysis as A
from repro_torch.roofline.op_walk import aggregate, collective_schedule

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4             # of the leaf's max
UPDATE_TOL = 1e-3           # x lr, where |g_ref| > UPDATE_MASK x the leaf's max
UPDATE_MASK = 1e-3
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _norm(spec, rank: int) -> tuple:
    parts = tuple(spec)
    return parts + (None,) * (rank - len(parts))


def _ref_paths(tree, **kw) -> dict:
    """The reference's tree by the port's paths (keys and list indices as
    strings)."""
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, **kw)}


def _assert_specs_equal(ref_specs, ref_tree, port_specs):
    ref = _ref_paths(ref_specs, is_leaf=_is_spec)
    leaves = _ref_paths(ref_tree)
    port = dict(M.leaves_with_paths(port_specs))
    assert ref.keys() == leaves.keys() == port.keys()
    for path, r in ref.items():
        assert _norm(r, len(leaves[path].shape)) == port[path], (path, r, port[path])


def _abstract_mesh(multi_pod: bool) -> AbstractMesh:
    m = make_production_mesh(multi_pod=multi_pod)
    return AbstractMesh(m.dims, m.axis_names)


def _reference_dryrun_tables() -> dict:
    """SKIP, LONG_WINDOW, _PURE_FULL_ATTN and run_one's own report keys of
    ``src/repro/launch/dryrun.py``, read from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    out, keys = {}, set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            if isinstance(target, ast.Name) and target.id in (
                    "SKIP", "LONG_WINDOW", "_PURE_FULL_ATTN"):
                out[target.id] = ast.literal_eval(node.value)
            if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name) \
                    and target.value.id == "out":
                keys.add(ast.literal_eval(target.slice))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "update" and isinstance(node.args[0], ast.Dict):
            keys |= {ast.literal_eval(k) for k in node.args[0].keys}
    out["report_keys"] = keys
    return out


# ------------------------------------------------------------------ #
# damoldqn and the qnet steps
# ------------------------------------------------------------------ #
def test_damoldqn_config_equals_the_reference():
    assert set(jax_list_archs()) <= set(list_archs())
    assert set(list_archs()) - set(jax_list_archs()) == {"moonlight-16b-a3b"}
    assert dataclasses.asdict(get_config("damoldqn")) == \
        with_port_only_fields(dataclasses.asdict(jax_get_config("damoldqn")))


def _qnet_batches():
    """tests/test_models.py::test_qnet_train_step's batch (no legal next
    action), and a random-mask batch at full width with two rows that have
    no legal next action."""
    rng = np.random.default_rng(0)
    zero = {"states": rng.random((8, 2049)).astype(np.float32),
            "rewards": rng.random(8).astype(np.float32),
            "dones": np.ones(8, np.float32),
            "next_fps": np.zeros((8, 4, 2049), np.float32),
            "next_mask": np.zeros((8, 4), np.float32)}
    rng = np.random.default_rng(1)
    fps = lambda *s: np.concatenate(
        [(rng.random((*s, 2048)) < 0.1).astype(np.float32),
         rng.integers(0, 11, (*s, 1)).astype(np.float32) / 10], -1)
    mask = (rng.random((8, 4)) < 0.6).astype(np.float32)
    mask[[1, 5]] = 0.0
    rand = {"states": fps(8), "rewards": rng.standard_normal(8).astype(np.float32),
            "dones": (rng.random(8) < 0.3).astype(np.float32),
            "next_fps": fps(8, 4), "next_mask": mask}
    return {"zero_mask": zero, "random_mask": rand}


@pytest.mark.parametrize("which", ["zero_mask", "random_mask"])
def test_qnet_train_step_matches_the_reference(which):
    """One step from the reference's parameters (online) and a perturbed
    copy (target): the loss, the first moments (the clipped gradient) and
    Adam's update."""
    batch = _qnet_batches()[which]
    ref_cfg, cfg = jax_get_config("damoldqn"), get_config("damoldqn")
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(ref_cfg, jax.random.PRNGKey(0)))
    target = jax.tree_util.tree_map(
        lambda a: (a * 0.9 + 0.01).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jax_init_params(ref_cfg, jax.random.PRNGKey(1))))
    jstep, jopt = jax_make_train_step(ref_cfg)
    jp, jstate, jloss = jax.jit(jstep)(params, target, jopt.init(params), batch)
    step, opt = make_train_step(cfg)
    tp = params_from_numpy(params, device="cpu")
    new, state, loss = step(tp, params_from_numpy(target, device="cpu"), opt.init(tp), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert int(state.step) == int(jstate.step) == 1
    ref_mu = [np.asarray(m) for m in jax.tree_util.tree_leaves(jstate.mu)]
    for got, want in zip(state.mu, ref_mu):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()))
    for i, (p0, want, got, m) in enumerate(zip(
            jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jp),
            tree_leaves(new), ref_mu)):
        upd_want, upd_got = np.asarray(want) - p0, got.numpy() - p0
        sel = np.abs(m) > UPDATE_MASK * np.abs(m).max()
        diff = np.abs(upd_got - upd_want)[sel]
        assert diff.size == 0 or diff.max() <= UPDATE_TOL * LR, (i, diff.max())
    assert list(new) == ["layers"] and len(new["layers"]) == 5


def test_qnet_serve_step_matches_the_reference():
    """Any leading shape through one ``fused_qnet`` call (its plain version
    on the CPU), against ``QNetwork.apply``."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_get_config("damoldqn"), jax.random.PRNGKey(2)))
    x = _qnet_batches()["random_mask"]["next_fps"]
    serve = make_serve_step(get_config("damoldqn"))
    tp = params_from_numpy(params, device="cpu")
    for states in (x, x.reshape(-1, x.shape[-1]), x[0, 0]):
        got = serve(tp, states)
        want = np.asarray(JaxQNetwork().apply(params, jnp.asarray(states)))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ #
# the sharding plan and the mesh
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", jax_list_archs())
def test_param_pspecs_and_add_fsdp_equal_the_reference(arch):
    for seq_shard in (False, True):
        ref_cfg = dataclasses.replace(jax_get_config(arch), seq_shard=seq_shard)
        cfg = dataclasses.replace(get_config(arch), seq_shard=seq_shard)
        tree = JM.abstract_params(ref_cfg)
        ref, port = JM.param_pspecs(ref_cfg, tp=16), M.param_pspecs(cfg, tp=16)
        _assert_specs_equal(ref, tree, port)
        for size, axes in ((16, ("data",)), (32, ("pod", "data"))):
            _assert_specs_equal(
                JM.add_fsdp(ref, ref_cfg, fsdp_axes=axes, fsdp_size=size), tree,
                M.add_fsdp(port, cfg, fsdp_axes=axes, fsdp_size=size))
    # tests/test_models.py::test_param_pspecs_cover_tree's rule: every dim
    # sharded on "model" divides by 16
    abstract = M.abstract_params(get_config(arch))
    specs = dict(M.leaves_with_paths(M.param_pspecs(get_config(arch))))
    for path, leaf in M.leaves_with_paths(abstract):
        spec = specs[path]
        assert len(spec) == leaf.dim()
        for d, part in enumerate(spec):
            if part == "model":
                assert leaf.shape[d] % 16 == 0, (arch, leaf.shape, spec)


def test_production_mesh_is_the_reference_shape():
    for multi_pod, dims, axes in ((False, (16, 16), ("data", "model")),
                                  (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi_pod=multi_pod)
        assert m.axis_names == axes and tuple(m.shape.values()) == dims
        assert m.size == len(m.devices) == int(np.prod(dims))
        assert all(d.type == "meta" for d in m.devices)
        assert batch_axes(m) == axes[:-1] and mesh_tp(m) == 16


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_input_specs_equal_the_reference(multi_pod):
    """data_spec, the train / qnet batch specs, the decode cache's specs and
    stand-ins, and the ZeRO moments' specs, on the production mesh."""
    jmesh, mesh = _abstract_mesh(multi_pod), make_production_mesh(multi_pod=multi_pod)
    for shp, seq in (((256, 4096), ()), ((32, 32768), (1,)), ((3, 7), ()), ((1,), ())):
        assert _norm(JS.data_spec(shp, jmesh, seq_dims=seq), len(shp)) == \
            S.data_spec(shp, mesh, seq_dims=seq)
    shape = INPUT_SHAPES["train_4k"]
    jspecs, jshard = JS.qnet_batch_specs(JAX_SHAPES["train_4k"], jmesh)
    specs, shard = S.qnet_batch_specs(shape, mesh)
    assert list(specs) == list(jspecs)
    for k in specs:
        assert tuple(specs[k].shape) == jspecs[k].shape and specs[k].device.type == "meta"
        assert _norm(jshard[k].spec, len(jspecs[k].shape)) == shard[k]
    for arch in ("whisper-large-v3", "paligemma-3b", "yi-34b", "zamba2-1.2b"):
        ref_cfg, cfg = jax_get_config(arch), get_config(arch)
        for name in ("train_4k", "prefill_32k"):
            jspecs, jshard = JS.train_batch_specs(ref_cfg, JAX_SHAPES[name], jmesh)
            specs, shard = S.train_batch_specs(cfg, INPUT_SHAPES[name], mesh)
            assert list(specs) == list(jspecs)
            for k in specs:
                assert tuple(specs[k].shape) == jspecs[k].shape
                assert str(specs[k].dtype).split(".")[1] == str(jspecs[k].dtype)
                assert _norm(jshard[k].spec, len(jspecs[k].shape)) == shard[k]
        jtok, jcache, jts, jcs = JS.decode_specs(ref_cfg, JAX_SHAPES["decode_32k"], jmesh)
        tok, cache, ts, cs = S.decode_specs(cfg, INPUT_SHAPES["decode_32k"], mesh)
        assert tuple(tok.shape) == jtok.shape and _norm(jts.spec, 2) == ts
        assert sorted(cache) == sorted(jcache)
        for k in cache:
            shp = () if k == "pos" else tuple(cache[k].shape)
            assert shp == jcache[k].shape, k
            assert _norm(jcs[k].spec, len(shp)) == cs[k], k
        fsdp = M.count_params(cfg) > 8e9
        jp = JS.param_pspecs_for(ref_cfg, jmesh, fsdp=fsdp)
        pp = S.param_pspecs_for(cfg, mesh, fsdp=fsdp)
        assert S.param_shardings(cfg, mesh, fsdp=fsdp) == pp
        _assert_specs_equal(JS.zero_opt_shardings(ref_cfg, jmesh, jp),
                            JM.abstract_params(ref_cfg), S.zero_opt_shardings(cfg, mesh, pp))


# ------------------------------------------------------------------ #
# the roofline formulas and the op walk
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", jax_list_archs())
def test_hbm_and_model_flops_estimates_equal_the_reference(arch, monkeypatch):
    """Every shape, at each mesh's tp, dp, FSDP rule and microbatches, and
    with ZeRO moments; the reference's count_params is read once."""
    ref_cfg, cfg = jax_get_config(arch), get_config(arch)
    n_ref = JM.count_params(ref_cfg)
    assert M.count_params(cfg) == n_ref and M.active_params(cfg) == JM.active_params(ref_cfg)
    monkeypatch.setattr(JM, "count_params", lambda c: n_ref)
    for name, shape in INPUT_SHAPES.items():
        assert A.model_flops_estimate(cfg, shape) == \
            JA.model_flops_estimate(ref_cfg, JAX_SHAPES[name])
        for dp in (16, 32):
            mb = pick_microbatches(cfg, shape, dp)
            assert mb == jax_pick_microbatches(ref_cfg, JAX_SHAPES[name], dp)
            for zero in (False, True):
                kw = dict(tp=16, dp=dp, zero_opt=zero, microbatches=mb,
                          fsdp=n_ref > 8e9)
                try:
                    want = JA.estimate_hbm_per_chip(ref_cfg, JAX_SHAPES[name], **kw)
                except AttributeError:      # damoldqn's decode: no ssm (a SKIP pair)
                    with pytest.raises(AttributeError):
                        A.estimate_hbm_per_chip(cfg, shape, **kw)
                    continue
                assert A.estimate_hbm_per_chip(cfg, shape, **kw) == want


def test_estimate_hbm_shapes():
    """tests/test_distributed.py::test_estimate_hbm_shapes on the port."""
    cfg = get_config("yi-34b")
    est = A.estimate_hbm_per_chip(cfg, INPUT_SHAPES["train_4k"], tp=16, dp=16,
                                  fsdp=True, microbatches=16)
    assert 0 < est["total"] < 16 * 2 ** 30
    est_d = A.estimate_hbm_per_chip(cfg, INPUT_SHAPES["decode_32k"], tp=16, dp=16)
    assert "cache" in est_d and est_d["total"] > 0


def test_roofline_report_formulas_equal_the_reference():
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, flops_per_chip=3e12,
              bytes_per_chip=2e10, collective_bytes_per_chip=5e9,
              collectives={"all-reduce": 5}, model_flops=6e14, memory_per_chip=1e9)
    assert A.RooflineReport(**kw, hw=A.HW_V5E).to_dict() == \
        JA.RooflineReport(**kw, hw=JA.HW_V5E).to_dict()
    assert A.RooflineReport(**kw).hw == A.HW_H100
    assert (A.HW_H100.peak_flops, A.HW_H100.hbm_bw, A.HW_H100.link_bw) == \
        (989e12, 3.35e12, 450e9)
    hlo = "%all-reduce.1 = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}"
    assert A.collective_bytes_from_hlo(hlo) == JA.collective_bytes_from_hlo(hlo)


def test_op_walk_pins_the_nested_loop():
    """tests/test_distributed.py::test_hlo_walker_nested_scan in torch: 5
    outer x 3 inner [64, 64] products."""
    def f(h, ws):
        for w in ws:
            for _ in range(3):
                h = torch.tanh(h @ w)
        return h

    for device in ("meta", "cpu"):
        agg = aggregate(f, torch.ones(64, 64, device=device),
                        torch.ones(5, 64, 64, device=device))
        assert agg["flops"] == 15 * 2 * 64 ** 3
        assert agg["collective_bytes"] == 0.0 and set(agg["collectives"]) >= {
            "all-gather", "all-reduce", "reduce-scatter"}


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-235b-a22b"])
def test_op_walk_on_meta_equals_the_cpu_count(arch):
    """A reduced train step (two microbatches) counted on real CPU tensors
    and on ``meta`` gives the same flops.  The bytes are the same for the
    dense config; the MoE's ``F.one_hot`` checks its input with an
    ``aminmax`` and scatters on the CPU, where ``meta`` compares with an
    ``arange``, so there they agree within 1e-4 only."""
    cfg = get_config(arch).reduced()
    step, opt = make_train_step(cfg, microbatches=2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens),
             "mask": torch.ones(4, 32)}
    counts = {}
    for device in ("cpu", "meta"):
        params = M.init_params(cfg, 0, device=device)
        counts[device] = aggregate(step, params, opt.init(params),
                                   {k: v.to(device) for k, v in batch.items()})
    assert counts["cpu"]["flops"] == counts["meta"]["flops"] > 0
    if cfg.moe is None:
        assert counts["cpu"]["bytes"] == counts["meta"]["bytes"] > 0
    np.testing.assert_allclose(counts["cpu"]["bytes"], counts["meta"]["bytes"], rtol=1e-4)
    grads_flops = aggregate(loss_and_grads, M.init_params(cfg, 0, device="meta"), cfg,
                            {k: v.to("meta")[:2] for k, v in batch.items()})["flops"]
    assert counts["meta"]["flops"] == 2 * grads_flops


def test_collective_schedule_follows_the_specs():
    """yi-34b train_4k on 16x16 with FSDP: every large leaf's gathers and
    scatters, the small ones' data-parallel all-reduce, the row-parallel
    outputs' all-reduce over "model"."""
    cfg, shape = get_config("yi-34b"), INPUT_SHAPES["train_4k"]
    mesh = make_production_mesh()
    pspecs = S.param_pspecs_for(cfg, mesh, fsdp=True)
    coll = collective_schedule(cfg, shape, mesh, pspecs, microbatches=16)
    assert coll["all-to-all"] == coll["collective-permute"] == 0
    assert coll["all-gather"] == 2 * coll["reduce-scatter"] > 0
    decode = collective_schedule(cfg, INPUT_SHAPES["decode_32k"], mesh, pspecs)
    assert decode["reduce-scatter"] == 0 and decode["all-gather"] > 0
    qnet = get_config("damoldqn")
    q = collective_schedule(qnet, shape, mesh, S.param_pspecs_for(qnet, mesh))
    assert q["all-reduce"] == pytest.approx(M.count_params(qnet) * 4 * 15 / 16)


# ------------------------------------------------------------------ #
# the dry-run, slurm, sgd
# ------------------------------------------------------------------ #
def test_dryrun_tables_equal_the_reference():
    ref = _reference_dryrun_tables()
    assert dryrun.SKIP == ref["SKIP"]
    assert dryrun.LONG_WINDOW == ref["LONG_WINDOW"]
    assert dryrun._PURE_FULL_ATTN == ref["_PURE_FULL_ATTN"]


def test_run_one_keys_are_the_reference_keys(tmp_path):
    """damoldqn x train_4k: the reference's RooflineReport keys and
    run_one's, without the XLA CPU memory analysis, ``fits_16gb`` as
    ``fits_80gb``, plus ``hw`` and ``analytic``; the other shapes skip with
    the reference's reasons."""
    out = dryrun.run_one("damoldqn", "train_4k", verbose=False)
    report_keys = set(JA.RooflineReport("a", "s", "m", 1, 0.0, 0.0, 0.0).to_dict())
    want = (report_keys | _reference_dryrun_tables()["report_keys"]) \
        - {"hbm_gb_per_chip_cpu", "fits_16gb"} | {"fits_80gb", "hw", "analytic"}
    assert set(out) == want
    assert out["status"] == "ok" and out["fits_80gb"] and out["microbatches"] == 1
    assert out["chips"] == 256 and out["mesh"] == "16x16" and out["hw"]["name"] == "h100-sxm"
    assert set(out["analytic"]) <= set(out)
    assert out["params_total"] == M.count_params(get_config("damoldqn"))
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        res = dryrun.run_one("damoldqn", name, verbose=False)
        assert res["status"] == "skipped" and res["reason"] == dryrun.SKIP[("damoldqn", name)]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "damoldqn", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"damoldqn_{s}_16x16.json" for s in INPUT_SHAPES)


def test_slurm_render_is_the_reference_with_the_port_module():
    for kw in ({}, {"nodes": 2, "episodes": 10, "workers": 8}):
        assert slurm.render(**kw) == jax_slurm.render(**kw).replace(
            "python -m repro.launch.train", "python -m repro_torch.launch.train")


@pytest.mark.parametrize("momentum,nesterov,clip", [
    (0.0, False, None), (0.9, False, 1.0), (0.9, True, None)])
def test_sgd_matches_the_reference(momentum, nesterov, clip):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    jopt = jax_sgd(0.1, momentum=momentum, nesterov=nesterov, clip_norm=clip)
    opt = sgd(0.1, momentum=momentum, nesterov=nesterov, clip_norm=clip)
    jstate = jopt.init(params)
    leaves = [torch.from_numpy(a.copy()) for a in jax.tree_util.tree_leaves(params)]
    state = opt.init(leaves)
    for t in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        jupd, jstate = jopt.update(grads, jstate, params)
        upd, state = opt.update([torch.from_numpy(g) for g in jax.tree_util.tree_leaves(grads)],
                                state, leaves)
        for a, b in zip(jax.tree_util.tree_leaves(jupd), upd):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        for a, b in zip(jax.tree_util.tree_leaves(jstate.mu), state.mu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        assert int(state.step) == int(jstate.step) == t + 1
