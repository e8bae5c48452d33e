"""Port of ``repro.launch.dryrun``: one report per (arch x input shape x
mesh) of the production matrix, with no device and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]

For each combination this:
  1. builds the parameter, optimizer and cache trees on the ``meta`` device
     (shapes only: a 235B model "loads" in milliseconds) and the sharding
     plan as specs (``launch/specs.py``);
  2. runs the family's step ONCE on ``meta`` at the global batch: the train
     step with its microbatches (the qnet's double-DQN step for damoldqn),
     the prefill, or one decode token, under ``roofline.op_walk``;
  3. writes a JSON report with the reference's keys.

What replaces the reference's XLA compile, and so what is analytic (the
report's ``analytic`` key lists those keys): ``flops_per_chip`` and
``bytes_per_chip`` are the step's counts split evenly over the chips; the
collectives come from the specs (``op_walk.collective_schedule``); memory
is ``estimate_hbm_per_chip`` against the H100's 80 GB (``fits_80gb``, the
reference's ``fits_16gb``); the terms use ``HW_H100`` (``hw``).  The
reference's ``hbm_gb_per_chip_cpu`` (the XLA CPU backend's memory analysis)
has no source here and is absent.  ``compile_s`` keeps its name: it is the
wall seconds of building and counting the step.

Unlike the reference this module sets no environment variable: nothing
here asks for devices.  A failure (a spec that does not fit, a step that
cannot be built) is reported as ``FAIL`` and the run exits 1.
"""

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step, pick_microbatches)
from repro_torch.models import model as M
from repro_torch.roofline.analysis import (
    estimate_hbm_per_chip, model_flops_estimate, roofline_terms)
from repro_torch.roofline.op_walk import aggregate, collective_schedule

HBM_GB = 80.0                   # H100 80GB HBM3
# long_500k policy (DESIGN.md §3): native for ssm/hybrid/SWA archs; dense
# archs run the sliding-window variant; whisper skipped (448-pos decoder).
LONG_WINDOW = 8192
SKIP: dict[tuple[str, str], str] = {
    ("whisper-large-v3", "long_500k"):
        "decoder max position is 448 (learned embedding); 500k decode is architecturally meaningless",
    ("damoldqn", "prefill_32k"): "fingerprint MLP has no sequence dim",
    ("damoldqn", "decode_32k"): "fingerprint MLP has no KV cache",
    ("damoldqn", "long_500k"): "fingerprint MLP has no sequence dim",
}
_PURE_FULL_ATTN = {"stablelm-1.6b", "granite-34b", "granite-20b", "yi-34b", "paligemma-3b"}
ANALYTIC = ("flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
            "collectives", "memory_per_chip", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_flops_ratio", "hbm_gb_per_chip",
            "hbm_breakdown_gb", "fits_80gb")


def prepare(arch: str, shape_name: str, multi_pod: bool):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if (arch, shape_name) in SKIP:
        return None
    if shape_name == "long_500k" and arch in _PURE_FULL_ATTN:
        cfg = cfg.with_window(LONG_WINDOW)  # beyond-paper SWA variant
    return cfg, shape


def _step_and_args(cfg, shape, mesh, mb: int):
    """The step function and its ``meta`` arguments."""
    params = M.abstract_params(cfg)
    if shape.kind == "train":
        step_fn, opt = make_train_step(cfg, microbatches=mb)
        opt_state = opt.init(params)
        if cfg.family == "qnet":
            batch, _ = S.qnet_batch_specs(shape, mesh)
            return step_fn, (params, M.abstract_params(cfg), opt_state, batch)
        batch, _ = S.train_batch_specs(cfg, shape, mesh)
        return step_fn, (params, opt_state, batch)
    if shape.kind == "prefill":
        batch, _ = S.train_batch_specs(cfg, shape, mesh)
        batch = {k: v for k, v in batch.items() if k not in ("labels", "mask")}
        return make_prefill_step(cfg), (params, batch)
    tokens, cache, _, _ = S.decode_specs(cfg, shape, mesh)
    return make_serve_step(cfg), (params, cache, tokens)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            zero_opt: bool = False, seq_shard: bool = False,
            verbose: bool = True) -> dict:
    t0 = time.time()
    prep = prepare(arch, shape_name, multi_pod)
    if prep is None:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": SKIP[(arch, shape_name)]}
    cfg, shape = prep
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_desc = "x".join(str(s) for s in mesh.dims)
    chips = mesh.size
    tp = mesh.shape.get("model", 1)
    dp = chips // tp

    # FSDP for the big archs: params+opt at TP-only exceed the HBM budget
    fsdp = M.count_params(cfg) > 8e9
    pspecs = S.param_pspecs_for(cfg, mesh, fsdp=fsdp)
    mb = pick_microbatches(cfg, shape, dp) if shape.kind == "train" else 1

    step_fn, args = _step_and_args(cfg, shape, mesh, mb)
    walk = aggregate(step_fn, *args, collectives=collective_schedule(
        cfg, shape, mesh, pspecs, microbatches=mb))
    hbm_est = estimate_hbm_per_chip(
        cfg, shape, tp=tp, dp=dp, zero_opt=zero_opt,
        microbatches=mb if shape.kind == "train" else 1, fsdp=fsdp)
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_desc=mesh_desc, chips=chips, walk=walk,
        model_flops=model_flops_estimate(cfg, shape),
        memory_per_chip=float(hbm_est["total"]))
    out = report.to_dict()
    out.update({
        "status": "ok",
        "kind": shape.kind,
        "microbatches": mb if shape.kind == "train" else None,
        "fsdp": fsdp,
        "zero_opt": zero_opt,
        "seq_shard": seq_shard,
        "window": cfg.attn_window,
        "params_total": M.count_params(cfg),
        "params_active": M.active_params(cfg),
        "compile_s": round(time.time() - t0, 1),
    })
    out["hbm_gb_per_chip"] = round(hbm_est["total"] / 2**30, 3)
    out["hbm_breakdown_gb"] = {k: round(v / 2**30, 3) for k, v in hbm_est.items()}
    out["fits_80gb"] = out["hbm_gb_per_chip"] <= HBM_GB
    out["hw"] = dataclasses.asdict(report.hw)
    out["analytic"] = list(ANALYTIC)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {mesh_desc}: OK "
              f"({out['compile_s']}s, {out['flops_per_chip']:.4g} FLOP/chip, "
              f"{out['hbm_gb_per_chip']} GiB/chip, dominant={out['dominant']}, "
              f"fits_80gb={out['fits_80gb']})", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--zero-opt", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}" + \
                    ("_zero" if args.zero_opt else "") + \
                    ("_seqshard" if args.seq_shard else "")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached", flush=True)
                    continue
                try:
                    res = run_one(arch, shape, multi_pod=mp, zero_opt=args.zero_opt,
                                  seq_shard=args.seq_shard)
                except Exception as e:  # noqa: BLE001 — must report every combo
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                    n_fail += 1
                res["mesh"] = "2x16x16" if mp else "16x16"
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=str)
    print(f"[dryrun] done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
