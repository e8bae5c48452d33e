#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  - require CUDA; print the card's name and power limit as
             ``nvidia-smi`` gives them.
2. build   - compile every kernel of the port from ``src/`` with ``nvcc``,
             all at once, and print the build seconds and ptxas' report.
3. kernels - hold each kernel against its plain PyTorch version on the
             card, at full width and the shapes the serving path gives it
             (within 1e-4 abs + 1e-4 rel); check that two launches are
             bit-identical and that a row's Q ignores the other rows; time
             the kernel, the plain version and a library yardstick with
             CUDA events beside the card's bound for the same work.
4. serve   - the main path: ``repro_torch.launch.serve_molopt`` on the GPU
             at full width (8 slots, 32 requests, deadlines, poisoned
             requests, a seeded FaultPlan).  Every request must end
             terminal, every Q dispatch must be one kernel launch, a rerun
             must be bit-identical, and the same stream at epsilon = 1 must
             give the CPU run's results bit for bit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package ``repro``.
"""

from __future__ import annotations

import json
import math
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-4                      # abs and rel, as tests/test_kernels.py holds fused_qnet
SERVE_ARGS = ["--slots", "8", "--requests", "32", "--deadline-frac", "0.3",
              "--invalid-every", "8", "--faults"]
KERNEL_ROWS = (1, 5, 128, 300, 2048, 4096)

# dense peaks by card (NVIDIA data sheets): f32 FMA FLOP/s, HBM bytes/s
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 66.9e12, 3.35e12), ("H200", 66.9e12, 4.8e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peak = next(((f, b) for key, f, b in PEAKS if key in name), None)
    if peak is None:
        fail(f"no f32/HBM peak on record for {name!r}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {name} | "
          f"{torch.cuda.device_count()} device(s) | peaks f32 "
          f"{peak[0] / 1e12} TFLOP/s, HBM {peak[1] / 1e12} TB/s", flush=True)
    return card, name, peak


def phase_build() -> None:
    from repro_torch.kernels.fused_qnet import build as fq_build
    builds = [fq_build.nvcc_build()]           # one entry per kernel source
    t0 = time.perf_counter()
    for b in builds:
        b.start()
    for b in builds:
        b.wait()
    print(f"build: {len(builds)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for b in builds:
        if b.log.is_file():
            print(f"ptxas {b.source.name}:\n" + "\n".join(
                "  " + l for l in b.log.read_text().splitlines() if l.strip()))
    fq_build.load()


def cuda_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(peak) -> list[dict]:
    import numpy as np
    import torch
    from repro_torch.core.agent import STATE_DIM, QNetwork
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.fused_qnet.ref import qnet_ref

    rng = np.random.default_rng(0)
    sizes = (STATE_DIM, 1024, 512, 128, 32, 1)
    layers = [(torch.from_numpy((rng.standard_normal((i, o)) * (2.0 / i) ** 0.5)
                                .astype(np.float32)),
               torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32)))
              for i, o in zip(sizes[:-1], sizes[1:])]
    weights = QNetwork(device="cuda", layers=layers).layers()
    n_params = sum(w.numel() + b.numel() for w, b in weights)
    mac_per_row = sum(w.numel() for w, _ in weights)

    def library(x):                          # yardstick only: addmm chain
        h = x
        for li, (w, b) in enumerate(weights):
            h = torch.addmm(b, h, w)
            if li < len(weights) - 1:
                h = torch.relu_(h)
        return h[:, 0]

    rows = []
    for n in KERNEL_ROWS:
        bits = (rng.random((n, STATE_DIM - 1)) < 0.2).astype(np.float32)
        frac = rng.integers(0, 11, (n, 1)).astype(np.float32) / 10.0
        x = torch.from_numpy(np.concatenate([bits, frac], 1)).cuda()
        qk = fused_qnet(weights, x)
        qp = qnet_ref(x, weights)
        torch.cuda.synchronize()
        if qk.shape != (n,) or not bool(torch.isfinite(qk).all()):
            fail(f"fused_qnet N={n}: shape {tuple(qk.shape)} or non-finite values")
        err = (qk - qp).abs()
        max_abs = float(err.max())
        if not bool((err <= TOL + TOL * qp.abs()).all()):
            fail(f"fused_qnet N={n}: max |kernel - plain| {max_abs:.3e} "
                 f"exceeds {TOL} + {TOL}*|plain|")
        if not torch.equal(fused_qnet(weights, x), qk):
            fail(f"fused_qnet N={n}: two launches on one input differ")
        if n > 1:
            x2 = x.clone()
            x2[1::2] = 1.0 - x2[1::2]        # change every odd row
            q2 = fused_qnet(weights, x2)
            if not torch.equal(q2[0::2], qk[0::2]):
                fail(f"fused_qnet N={n}: a row's Q moved with other rows")
        reps = 20 if n >= 2048 else 50
        flops = 2.0 * n * mac_per_row
        nbytes = 4.0 * (x.numel() + n_params + n)
        t_ops, t_bytes = flops / peak[0], nbytes / peak[1]
        rows.append({
            "name": "fused_qnet", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_qnet/csrc/fused_qnet.cu",
            "replaces": "src/repro/kernels/fused_qnet/fused_qnet.py:63",
            "rows": n, "launches": None, "max_abs_err": max_abs,
            "ms": cuda_ms(lambda: fused_qnet(weights, x), reps),
            "plain_ms": cuda_ms(lambda: qnet_ref(x, weights), reps),
            "library_ms": cuda_ms(lambda: library(x), reps),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        })
        rows[-1]["kernel_ms"] = rows[-1]["ms"]
        print(f"fused_qnet N={n}: max_abs_err {max_abs:.3e} | kernel "
              f"{rows[-1]['ms']:.4f} ms, plain {rows[-1]['plain_ms']:.4f} ms, "
              f"library {rows[-1]['library_ms']:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms", flush=True)
    return rows


def _signature(svc):
    return [(r.request_id, r.status, r.steps_used, r.degraded_steps, r.latency,
             r.best_smiles, None if r.best_reward is None
             else struct.pack("<d", r.best_reward).hex())
            for r in sorted(svc.results, key=lambda r: r.request_id)]


def phase_serve() -> int:
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.launch import serve_molopt
    from repro_torch.serving import STATUSES, latency_stats

    args = serve_molopt.parser().parse_args(SERVE_ARGS + ["--device", "cuda"])
    runs = []
    for run in ("first", "rerun"):
        fused_qnet.launches = 0
        svc, wall = serve_molopt.serve(args)
        launches = fused_qnet.launches
        runs.append((svc, wall, launches))
        st = svc.stats()
        ids = {r.request_id for r in svc.results}
        if len(svc.results) != args.requests or len(ids) != args.requests \
                or any(r.status not in STATUSES for r in svc.results):
            fail(f"serve: {len(svc.results)} results over {len(ids)} ids for "
                 f"{args.requests} requests")
        if not svc.idle:
            fail("serve: service not idle after the stream drained")
        if launches != st["n_q_dispatches"] or launches == 0:
            fail(f"serve: fused_qnet launches {launches} != Q dispatches "
                 f"{st['n_q_dispatches']}")
        bad = [r.request_id for r in svc.results if r.best_reward is not None
               and not math.isfinite(r.best_reward)]
        if bad:
            fail(f"serve: non-finite best reward for {bad}")
        lat = latency_stats(svc.results)
        steps = st["n_service_steps"]
        timing = svc.dispatch_timing()
        chem = svc.engine.chem_stats()
        print(f"serve ({run}): {args.requests} requests in {wall:.3f} s = "
              f"{args.requests / wall:.2f} req/s | p50/p99 wall "
              f"{lat['p50_wall_ms']:.2f}/{lat['p99_wall_ms']:.2f} ms | statuses "
              f"{st['status_counts']} | service steps {steps} | Q dispatches "
              f"{st['n_q_dispatches']} ({svc._policy.n_workers} x "
              f"{svc._policy._cap} rows) | fused_qnet launches {launches}",
              flush=True)
        print(f"serve ({run}): per Q dispatch H2D copy {timing['h2d_ms']:.4f} ms,"
              f" fused_qnet {timing['kernel_ms']:.4f} ms (CUDA events) | per "
              f"service step {wall * 1e3 / steps:.2f} ms wall, host enumeration "
              f"{chem['enum_s'] * 1e3 / steps:.2f} ms, host fingerprints "
              f"{chem['fp_s'] * 1e3 / steps:.2f} ms", flush=True)

    (a, _, _), (b, _, _) = runs
    if _signature(a) != _signature(b):
        fail("serve: rerun on the same seed gave different results")
    if json.dumps(a.stats(), sort_keys=True, default=str) != \
            json.dumps(b.stats(), sort_keys=True, default=str):
        fail("serve: rerun on the same seed gave different counters")

    # epsilon = 1: actions do not read Q, so the GPU run must reproduce the
    # CPU run's results and counters bit for bit
    twins = []
    for dev in ("cuda", "cpu"):
        twin_args = serve_molopt.parser().parse_args(
            SERVE_ARGS + ["--device", dev, "--epsilon", "1.0"])
        twins.append(serve_molopt.serve(twin_args)[0])
    if _signature(twins[0]) != _signature(twins[1]) or \
            json.dumps(twins[0].stats(), sort_keys=True, default=str) != \
            json.dumps(twins[1].stats(), sort_keys=True, default=str):
        fail("serve: epsilon=1 results on the GPU differ from the CPU run's")
    print("serve: rerun bit-identical; epsilon=1 GPU run bit-identical to "
          "the CPU run", flush=True)
    return runs[0][2]


def main() -> None:
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card, name, peak = phase_device()
    import torch
    from repro_torch.device import resolve_device
    resolve_device("cuda")                   # TF32 off for the plain versions
    phase_build()
    rows = phase_kernels(peak)
    launches = phase_serve()
    for r in rows:
        r["launches"] = launches
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    print(json.dumps({"card": card, "kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
