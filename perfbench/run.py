"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (building the program's state from
the seed, the rounds or requests the reference follows, warm-up) is timed
as ``setup_s``; then the cell's traffic runs for ``--seconds``; then the
program's state is freed and the plain reference judges what the window's
path produced.  ``memory_peak_gb`` is the fullest device's peak of
allocated memory over set-up and the window, read before the release.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
torch.profiler trace over part of the window and from the benchmark's own
spans and the program's counters.  The last line of standard output is
the result as JSON; the numbers compared, each beside its limit, are the
last lines of standard error.  Exits non-zero, printing no result, without
a CUDA device, with fewer devices than the cell asks for, without the
program's package, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import hostenv  # noqa: E402

ENV = hostenv.prepare(ROOT)
AGE0 = hostenv.process_age_s()

from perfbench.harness import manifest  # noqa: E402
from perfbench.harness.trace import ProfileWindow, Spans, reduce_trace  # noqa: E402


class Refused(Exception):
    """A run that may print no result; its message goes to standard error."""


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def judge(limits: dict, readings: dict) -> list[tuple[str, float, float, bool]]:
    """Each compared number with its limit; a number passes at or under
    its limit, and a missing or non-finite number fails."""
    out = []
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        v = readings.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        out.append((name, float("nan") if v is None else float(v), limit, ok))
    return out


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            log=print) -> dict:
    """Set-up, window, release and check of one run; returns the result
    object (``checks`` last)."""
    import torch
    threads = hostenv.pin_torch(torch)
    log(f"# host: cpu_count {threads['cpu_count']}, torch threads "
        f"{threads['torch_threads']}, interop {threads['torch_interop_threads']}, "
        f"BLAS/OpenMP {threads['blas_threads']}")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    t_build = time.perf_counter()
    run = manifest.driver(cell.traffic["driver"]).build(cell, seed, spans, device)
    if cuda:
        torch.cuda.synchronize()
    t_settle = time.perf_counter()
    settled = hostenv.settle() if cuda else {}
    setup_s = AGE0 + (time.perf_counter() - _T0)
    split = {"before_build_s": AGE0 + (t_build - _T0), **run.split,
             "settle_s": time.perf_counter() - t_settle}
    log("# setup: " + json.dumps({"setup_s": setup_s, **split}))
    log("# settled: " + json.dumps(settled))

    profile = None
    if trace:
        tr = cell.traffic
        profile = ProfileWindow(spans, tr["trace_offset_s"],
                                min(tr["trace_seconds"], seconds))
    clock = hostenv.HostClock()
    clock.start()
    out = run.window(seconds, profile)
    log("# window: " + json.dumps({**out["end_to_end"], **out.get("detail", {}),
                                   "host": clock.stop()}))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if profile is not None and profile.prof is not None:
        summary = reduce_trace(profile.prof, list(spans.seconds))
    run.release()
    t = time.perf_counter()
    readings = run.check()
    log(f"# check: {time.perf_counter() - t:.3f} s, readings "
        + json.dumps(readings))
    checks = judge(cell.limits, readings)
    correct = bool(checks) and all(ok for *_, ok in checks) and out["failed"] == 0

    if trace:
        ctx = {"counters": out["counters"], "trace": summary,
               "config": cell.config, "traffic": cell.traffic}
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": setup_s,
                  "memory_peak_gb": peak / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in summary["device_ops"]],
            "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim, _ in checks}
    return result


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise Refused(f"the program's package is missing: "
                          f"{ROOT / 'src' / 'repro_torch'}")
        cell = manifest.load_cell(ROOT, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{args.workload} needs {cell.chips} CUDA devices, "
                          f"torch sees {torch.cuda.device_count()}")
        result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
        found = hostenv.forbidden_modules()
        if found:
            raise Refused("loaded in the benchmark process: " + ", ".join(found))
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
