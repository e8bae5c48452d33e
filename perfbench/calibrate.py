"""The readings that a cell's limits are set from, for many seeds in one
process: the program's, the control's (the reference computed one
precision lower, TF32, in the program's place) and a planted fault's: for
a training cell the reference that averages the loss over half of each
worker's batch, for the server the reference's runner-up candidate taken
at every greedy step.  The full-loop cell's rollout is read for the
program (``q_gap``, ``mismatches``) and for the control (``ctl_q_gap``),
and its sync for the program and for a sync left out.  The numbers a run
reads over its window alone (``window_*``) are not read here.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 5]

Prints one JSON line per seed.  The benchmark's own runs never run the
control; ``tests/test_perfbench_control.py`` runs this at a size a CPU
test can hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import hostenv  # noqa: E402

hostenv.prepare(ROOT)

from perfbench.harness import manifest  # noqa: E402
from perfbench.harness.trace import Spans  # noqa: E402


def learner_readings(cell, seed: int, device: str) -> dict:
    from perfbench.drivers.learner import CHECK_ROUNDS, LearnerRun, reference_cfg
    from perfbench.reference.dqn import gaps, learner_reference
    run = LearnerRun(cell, seed, Spans(), device)
    run.release()
    cfg, steps = reference_cfg(cell.config), CHECK_ROUNDS
    ref = learner_reference(run.weights, run.fill, seed, cfg, steps, device=device)
    out = {}
    for name, other in (
            ("program", run.prog),
            ("control_tf32", learner_reference(run.weights, run.fill, seed, cfg,
                                               steps, device=device, tf32=True)),
            ("fault_half_batch", learner_reference(
                run.weights, run.fill, seed, cfg, steps, device=device,
                rows=cfg["train_batch_size"] // 2))):
        out[name] = gaps(other, ref)
    return out


def episode_readings(cell, seed: int, device: str) -> dict:
    from perfbench.drivers.episodes import EpisodeRun
    from perfbench.reference.dqn import gaps
    run = EpisodeRun(cell, seed, Spans(), device)
    run.release()
    ref = run.learner_ref()
    out = {"rollout": run.follow(tf32_control=True), "sync": run.sync_readings()}
    B = cell.config["trainer"]["train_batch_size"]
    for name, other in (("program", run.prog),
                        ("control_tf32", run.learner_ref(tf32=True)),
                        ("fault_half_batch", run.learner_ref(rows=B // 2))):
        out[name] = gaps(other, ref)
    return out


def serve_readings(cell, seed: int, device: str, seconds: float) -> dict:
    from perfbench.drivers.serve_closed import ServeRun
    run = ServeRun(cell, seed, Spans(), device)
    win = run.window(seconds, None)
    run.release()
    per = run.follow_all(controls=True)
    return {"program": {"q_gap": max(p["q_gap"] for p in per),
                        "greedy_gap": max(p["greedy_gap"] for p in per),
                        "mismatches": sum(len(p["mismatches"]) for p in per)},
            "control_tf32": {"q_gap": max(p["ctl_q_gap"] for p in per),
                             "greedy_gap": max(p["ctl_greedy_gap"] for p in per)},
            "fault_wrong_pick": {"greedy_gap": max(p["wrong_pick_greedy_gap"]
                                                   for p in per)},
            "followed": len(per), "failed": win["failed"],
            "completed": win["counters"]["completed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    hostenv.pin_torch(torch)
    cell = manifest.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if cell.traffic["driver"] == "learner":
            r = learner_readings(cell, seed, args.device)
        elif cell.traffic["driver"] == "episodes":
            r = episode_readings(cell, seed, args.device)
        else:
            r = serve_readings(cell, seed, args.device, args.seconds)
        r.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(r), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
