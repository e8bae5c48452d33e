#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  - require CUDA; print the card's name and power limit as
             ``nvidia-smi`` gives them.
2. build   - compile every kernel of the port from ``src/`` with ``nvcc``,
             all at once, and print the build seconds and ptxas' report.
3. kernels - hold each kernel against its plain PyTorch version on the
             card, at full width and the shapes its path gives it (within
             1e-4 abs + 1e-4 rel); check that two launches are
             bit-identical and that a row's Q ignores the other rows; for
             ``packed_qnet_stacked`` also that dead workers' zero planes
             evaluate like zero input without touching live workers, that
             its packed and dense loaders agree bit for bit, and that each
             worker's Q equals ``fused_qnet``'s on its densified rows; time
             the kernel, the plain version and a library yardstick with
             CUDA events beside the card's bound for the same work.
4. serve   - the serving path: ``repro_torch.launch.serve_molopt`` on the
             GPU at full width (8 slots, 32 requests, deadlines, poisoned
             requests, a seeded FaultPlan).  Every request must end
             terminal, every Q dispatch must be one ``fused_qnet`` launch,
             a rerun must be bit-identical, and the same stream at
             epsilon = 1 must give the CPU run's results bit for bit.
5. train   - the training path: ``DistributedTrainer`` on the GPU at the
             launcher's defaults (4 workers x 4 molecules of the
             antioxidant train split, rollout fleet, packed acting and
             learner, 4 updates of 32 per episode) for 3 episodes.  Every
             fleet Q dispatch must be one ``packed_qnet_stacked`` launch,
             losses and rewards finite, a rerun bit-identical, an
             epsilon = 1 run's transitions and rewards equal to the CPU
             run's (losses within 1e-4 rel), the acting, rollout and
             learner modes bit-identical to one another, and a run under
             a seeded FaultPlan bit-identical to its fault-free twin.

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
STACKED_SHAPES = ((1, 5), (3, 300), (4, 1024), (128, 32))   # workers x rows
TRAIN_EPISODES = 3
TRAIN_LOSS_RTOL = 1e-4          # GPU vs CPU losses: cuBLAS vs CPU BLAS sums

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
    from repro_torch.kernels.packed_qnet import build as pq_build
    builds = [fq_build.nvcc_build(), pq_build.nvcc_build()]  # one per source
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
    pq_build.load()


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

def _stacked_weights(n_workers: int):
    """Full-width per-worker weights, distinct for every worker, made on
    the card from a seed."""
    import torch
    from repro_torch.core.agent import STATE_DIM
    g = torch.Generator(device="cuda").manual_seed(n_workers)
    sizes = (STATE_DIM, 1024, 512, 128, 32, 1)
    return [((torch.randn(n_workers, i, o, generator=g, device="cuda")
              * (2.0 / i) ** 0.5).contiguous(),
             (0.1 * torch.randn(n_workers, o, generator=g, device="cuda")).contiguous())
            for i, o in zip(sizes[:-1], sizes[1:])]


def phase_stacked_kernel(peak) -> list[dict]:
    import torch
    from repro_torch.core.packed_batch import unpack_bits
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                     packed_qnet_stacked)
    from repro_torch.kernels.packed_qnet.ref import packed_qnet_stacked_ref

    rows = []
    for W, C in STACKED_SHAPES:
        tag = f"packed_qnet_stacked W={W} C={C}"
        weights = _stacked_weights(W)
        g = torch.Generator(device="cuda").manual_seed(1000 + W)
        rand_u8 = lambda: torch.randint(0, 256, (W, C, 256), generator=g,
                                        device="cuda").to(torch.uint8)
        bits = rand_u8() & rand_u8()             # ~25% of bits set
        frac = torch.randint(0, 11, (W, C), generator=g,
                             device="cuda").float() / 10.0
        qk = packed_qnet_stacked(weights, bits, frac)
        qp = packed_qnet_stacked_ref(bits, frac, weights)
        torch.cuda.synchronize()
        if qk.shape != (W, C) or not bool(torch.isfinite(qk).all()):
            fail(f"{tag}: shape {tuple(qk.shape)} or non-finite values")
        err = (qk - qp).abs()
        max_abs = float(err.max())
        if not bool((err <= TOL + TOL * qp.abs()).all()):
            fail(f"{tag}: max |kernel - plain| {max_abs:.3e} exceeds "
                 f"{TOL} + {TOL}*|plain|")
        if not torch.equal(packed_qnet_stacked(weights, bits, frac), qk):
            fail(f"{tag}: two launches on one input differ")
        if C > 1:
            b2, f2 = bits.clone(), frac.clone()
            b2[:, 1::2] ^= 0xFF                  # change every odd row
            f2[:, 1::2] = 1.0 - f2[:, 1::2]
            if not torch.equal(packed_qnet_stacked(weights, b2, f2)[:, 0::2],
                               qk[:, 0::2]):
                fail(f"{tag}: a row's Q moved with other rows")
        x = torch.cat([unpack_bits(bits), frac.unsqueeze(-1)], -1).contiguous()
        if not torch.equal(dense_qnet_stacked(weights, x), qk):
            fail(f"{tag}: the dense loader differs from the packed one")
        fused_equal = all(
            torch.equal(fused_qnet([(w[i], b[i]) for w, b in weights], x[i]), qk[i])
            for i in range(W))
        if not fused_equal:
            fail(f"{tag}: a worker's Q differs from fused_qnet on its rows")
        if W > 1:                                # worker 1 dead: zero planes
            bd, fd = bits.clone(), frac.clone()
            bd[1], fd[1] = 0, 0.0
            qd = packed_qnet_stacked(weights, bd, fd)
            live = [i for i in range(W) if i != 1]
            zero = dense_qnet_stacked(weights, torch.zeros_like(x))
            if not torch.equal(qd[live], qk[live]) or not torch.equal(qd[1], zero[1]):
                fail(f"{tag}: dead-worker rows are not zero input, or moved "
                     f"live workers")
        print(f"{tag}: max_abs_err {max_abs:.3e} | rerun, row independence, "
              f"dead workers, dense loader bit-identical | equal to fused_qnet "
              f"per worker bit for bit: {fused_equal}", flush=True)

        def library():                           # yardstick only
            h = x
            for li, (w, b) in enumerate(weights):
                h = torch.baddbmm(b.unsqueeze(1), h, w)
                if li < len(weights) - 1:
                    h = torch.relu_(h)
            return h[..., 0]

        if not bool(((library() - qp).abs() <= TOL + TOL * qp.abs()).all()):
            fail(f"{tag}: the library yardstick computes something else")
        n_params = sum(w[0].numel() + b[0].numel() for w, b in weights)
        mac_per_row = sum(w[0].numel() for w, _ in weights)
        flops = 2.0 * W * C * mac_per_row
        nbytes = bits.numel() + 4.0 * (frac.numel() + W * n_params + W * C)
        t_ops, t_bytes = flops / peak[0], nbytes / peak[1]
        reps = 20 if W * C >= 2048 else 50
        rows.append({
            "name": "packed_qnet_stacked", "route": "cuda",
            "source": "src/repro_torch/kernels/packed_qnet/csrc/packed_qnet.cu",
            "replaces": "src/repro/kernels/packed_qnet/packed_qnet.py:158",
            "workers": W, "rows": C, "launches": None, "max_abs_err": max_abs,
            "ms": cuda_ms(lambda: packed_qnet_stacked(weights, bits, frac), reps),
            "plain_ms": cuda_ms(lambda: packed_qnet_stacked_ref(bits, frac, weights),
                                reps),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "fused_qnet_bitwise": fused_equal,
        })
        print(f"{tag}: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms, library "
              f"{rows[-1]['library_ms']:.4f} ms, bound {rows[-1]['bound_ms']:.4f} "
              f"ms ({rows[-1]['bound_by']})", flush=True)
        del weights
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


def _train_setup():
    """The launcher's data and reward: the antioxidant train split, its
    first W x mols_per_worker molecules, Eq. 1 bounds from the split."""
    from repro_torch.core.reward import RewardConfig
    from repro_torch.data.datasets import (antioxidant_dataset,
                                           dataset_property_table,
                                           train_test_split)
    train, _ = train_test_split(antioxidant_dataset(600))
    props = dataset_property_table(train)
    return train, RewardConfig.from_dataset(props["bde"], props["ip"])


def _trainer(setup, device="cuda", faults=False, episodes=TRAIN_EPISODES,
             dqn=None, **over):
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.distributed import DistributedTrainer, TrainerConfig
    from repro_torch.core.faults import FaultPlan, FaultRule
    from repro_torch.predictors.service import (OracleService,
                                                ResilientService, RetryPolicy)
    train, rcfg = setup
    cfg = TrainerConfig(episodes=episodes,
                        dqn=dqn or DQNConfig(epsilon_decay=0.97), **over)
    svc, plan = OracleService(), None
    if faults:                 # the fault smoke's plan, inside the budgets
        plan = FaultPlan([
            FaultRule(site="predict", kind="timeout", every=3, fail_attempts=1),
            FaultRule(site="chem", kind="transient", rate=0.3, fail_attempts=1),
        ], seed=8)
        svc = ResilientService(svc, RetryPolicy(seed=8), fault_plan=plan,
                               sleep=None)
    n = cfg.n_workers * cfg.mols_per_worker
    tr = DistributedTrainer(cfg, list(train[:n]), svc, rcfg, fault_plan=plan,
                            device=device)
    tr.train(episodes)
    tr.close()
    return tr


def _train_signature(tr):
    bufs = [[getattr(b, k).tobytes() for k in
             ("_state_bits", "_state_frac", "_rewards", "_dones", "_next_bits",
              "_next_frac", "_next_counts")] for b in tr.buffers]
    return (bufs, [struct.pack("<d", x).hex() for x in tr.reward_log],
            [struct.pack("<d", x).hex() for x in tr.loss_log],
            [t.cpu().numpy().tobytes() for wb in tr.params for t in wb])


def phase_train() -> int:
    from repro_torch.core.agent import DQNConfig
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked

    setup = _train_setup()
    runs = []
    for run in ("first", "rerun"):
        packed_qnet_stacked.launches = 0
        t0 = time.perf_counter()
        tr = _trainer(setup)
        wall = time.perf_counter() - t0
        launches = packed_qnet_stacked.launches
        runs.append((tr, launches))
        if launches != tr.n_q_dispatches or launches == 0:
            fail(f"train: packed_qnet_stacked launches {launches} != fleet Q "
                 f"dispatches {tr.n_q_dispatches}")
        if not all(math.isfinite(x) for x in tr.reward_log) or \
                not any(math.isfinite(x) for x in tr.loss_log) or \
                any(math.isnan(x) for x in tr.loss_log[1:]):
            fail(f"train: rewards {tr.reward_log} or losses {tr.loss_log} "
                 f"not finite")
        steps = tr.engine.n_env_steps
        timing = tr.dispatch_timing()
        chem = tr.engine.chem_stats()
        step_ms = tr.rollout_s * 1e3 / steps
        busy = (timing["h2d_ms"] + timing["kernel_ms"]) / step_ms
        print(f"train ({run}): {TRAIN_EPISODES} episodes in {wall:.3f} s | "
              f"{steps} env steps, {steps / tr.rollout_s:.2f} env steps/s | "
              f"{tr.n_updates} updates, {tr.n_updates / tr.learner_s:.2f} "
              f"updates/s, {tr.learner_s * 1e3 / tr.n_updates:.2f} ms per "
              f"update (host clock, ends synced) | rewards {tr.reward_log} | "
              f"losses {tr.loss_log}", flush=True)
        print(f"train ({run}): per Q dispatch ({tr.cfg.n_workers} x "
              f"{tr.candidate_capacity} rows) H2D {timing['h2d_ms']:.4f} ms "
              f"({tr.acting_h2d_bytes / tr.n_q_dispatches / 1e6:.3f} MB), "
              f"packed_qnet_stacked {timing['kernel_ms']:.4f} ms (CUDA "
              f"events) | per env step {step_ms:.2f} ms wall, host enumeration "
              f"{chem['enum_s'] * 1e3 / steps:.2f} ms, host fingerprints "
              f"{chem['fp_s'] * 1e3 / steps:.2f} ms | card busy on acting "
              f"{100 * busy:.1f}% of a step | launches {launches} = Q "
              f"dispatches {tr.n_q_dispatches}", flush=True)
    (a, launches), (b, _) = runs
    if _train_signature(a) != _train_signature(b):
        fail("train: rerun on the same seed gave different transitions, "
             "losses, rewards or parameters")

    # epsilon = 1 throughout: actions do not read Q, so the card's
    # transitions and rewards must be the CPU run's bit for bit
    explore = DQNConfig(epsilon_decay=1.0)
    gpu = _trainer(setup, dqn=explore)
    cpu = _trainer(setup, device="cpu", dqn=explore)
    sg, sc = _train_signature(gpu), _train_signature(cpu)
    if sg[:2] != sc[:2]:
        fail("train: epsilon=1 transitions or rewards on the GPU differ from "
             "the CPU run's")
    rel = max((abs(x - y) / max(abs(y), 1e-30) for x, y in
               zip(gpu.loss_log, cpu.loss_log) if math.isfinite(y)), default=0.0)
    if rel > TRAIN_LOSS_RTOL or len(gpu.loss_log) != len(cpu.loss_log):
        fail(f"train: epsilon=1 GPU losses {gpu.loss_log} vs CPU "
             f"{cpu.loss_log}: rel {rel:.3e} > {TRAIN_LOSS_RTOL}")
    print(f"train: rerun bit-identical; epsilon=1 transitions and rewards on "
          f"the GPU bit-identical to the CPU run, losses within {rel:.3e} rel",
          flush=True)

    # acting x rollout at epsilon 0.05: Q decides most actions
    greedy = DQNConfig(epsilon_initial=0.05, epsilon_decay=0.97)
    ref = _train_signature(_trainer(setup, episodes=2, dqn=greedy))
    for acting, rollout in (("dense", "fleet"), ("packed_async", "fleet"),
                            ("packed", "fleet_pipelined"),
                            ("packed_async", "fleet_pipelined"),
                            ("packed", "per_worker")):
        got = _train_signature(_trainer(setup, episodes=2, dqn=greedy,
                                        acting=acting, rollout=rollout))
        if got[:3] != ref[:3]:
            fail(f"train: acting={acting} rollout={rollout} transitions differ "
                 f"from packed fleet at epsilon 0.05")
    print("train: acting {dense, packed, packed_async} x rollout {fleet, "
          "fleet_pipelined, per_worker}: identical transitions at epsilon "
          "0.05", flush=True)

    want = _train_signature(a)
    for learner in ("dense", "packed_pipelined"):
        if _train_signature(_trainer(setup, learner=learner)) != want:
            fail(f"train: learner={learner} losses or parameters differ from "
                 f"learner=packed")
    print("train: learner {dense, packed, packed_pipelined}: bit-identical "
          "loss trajectories and parameters", flush=True)

    clean = _trainer(setup, episodes=2)
    faulted = _trainer(setup, episodes=2, faults=True)
    retries = faulted.service.n_retries
    if retries == 0 or _train_signature(faulted) != _train_signature(clean):
        fail(f"train: faulted run ({retries} retries) differs from its "
             f"fault-free twin")
    print(f"train: FaultPlan run ({retries} predict retries, "
          f"{faulted.engine.fault_stats()['n_chem_retries']} chem retries) "
          f"bit-identical to its fault-free twin", flush=True)
    return launches


def main() -> None:
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card, name, peak = phase_device()
    import torch
    from repro_torch.device import resolve_device
    resolve_device("cuda")                   # TF32 off for the plain versions
    phase_build()
    rows = phase_kernels(peak)
    stacked_rows = phase_stacked_kernel(peak)
    launches = phase_serve()
    for r in rows:
        r["launches"] = launches
    launches = phase_train()
    for r in stacked_rows:
        r["launches"] = launches
    rows += stacked_rows
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    print(json.dumps({"card": card, "kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
