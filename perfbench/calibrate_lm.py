"""The readings that the LM training cell's limits are set from, for many
seeds in one process: the program's (set-up's checked steps, no window),
the control's (the plain reference with the router's scores rounded to
bf16, one precision below the f32 the configuration states, read in the
program's place), and planted faults' (the program with its shared
experts dropped, its RoPE key dropped, its routed scaling left out, half
of each batch left out, its router's scores in bf16, or Adam's update
skipped, taken at twice the learning rate, or taken without its second
moment).

    python3 perfbench/calibrate_lm.py --workload moonlight.train8k \\
        --seeds 1,2,3 [--faults 1,2] [--device cuda]

Prints one JSON line per seed: ``program``, and for the seeds in
``--faults`` also ``control`` and one entry per fault, each the numbers the
cell compares.  The numbers a run reads over its window alone
(``window_*``) are not read here.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import hostenv  # noqa: E402

hostenv.prepare(ROOT)

from perfbench.harness import manifest  # noqa: E402
from perfbench.harness.trace import Spans  # noqa: E402


@contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _fault(name: str):
    """A context manager that plants fault ``name`` in the program."""
    import torch
    import perfbench.drivers.lm_train as LT
    import repro_torch.launch.steps as St
    import repro_torch.models.mla as Mla
    import repro_torch.models.moe as Moe
    Adam = importlib.import_module("repro_torch.optim.adam")  # the package's
                                        # ``adam`` attribute is the function

    if name == "shared_dropped":
        return patched(Moe, "mlp_forward", lambda p, x, act: torch.zeros_like(x))
    if name == "rope_key_dropped":
        rope = Mla.rope_interleaved

        def no_key(x, positions, theta):        # the key is the one 1-head input
            out = rope(x, positions, theta)
            return torch.zeros_like(out) if x.shape[-2] == 1 else out
        return patched(Mla, "rope_interleaved", no_key)
    if name == "routed_scale_left_out":
        cfg_of = LT.program_config

        def unscaled(config):
            cfg = cfg_of(config)
            return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                    routed_scale=1.0))
        return patched(LT, "program_config", unscaled)
    if name == "half_batch":
        grads_of = St.loss_and_grads

        def half(params, cfg, batch, **kw):
            n = batch["tokens"].shape[0] // 2
            return grads_of(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)
        return patched(St, "loss_and_grads", half)
    if name == "bf16_scores":
        route = Moe.route_topk

        def bf16(router, bias, x2, mcfg):
            scores, idx, w = route(router, bias, x2, mcfg)
            s16 = scores.to(torch.bfloat16).float()
            idx = torch.topk(s16 + bias, mcfg.top_k, dim=-1).indices
            w = torch.gather(s16, -1, idx)
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
            return s16, idx, w * mcfg.routed_scale
        return patched(Moe, "route_topk", bf16)
    if name == "lr_x2":
        make = Adam.adam
        return patched(Adam, "adam", lambda lr, *a, **kw: make(2 * lr, *a, **kw))
    if name in ("update_skipped", "nu_dropped"):
        make = Adam.adam

        def faulty(lr, b1, *a, **kw):
            opt = make(lr, b1, *a, **kw)

            @torch.no_grad()
            def update(grads, state, params):
                updates, state = opt.update(grads, state, params)
                bc1 = 1.0 - b1 ** float(state.step)
                for u, m in zip(updates, state.mu):
                    if name == "update_skipped":
                        u.zero_()
                        continue
                    # -lr m_hat: the step with sqrt(v_hat) + eps left out,
                    # a slice at a time as Adam's own loop
                    uf, mf = u.view(-1), m.view(-1)
                    for lo in range(0, uf.numel(), Adam._CHUNK):
                        uf[lo:lo + Adam._CHUNK].copy_(
                            mf[lo:lo + Adam._CHUNK] * (-lr / bc1))
                return updates, state
            return Adam.Optimizer(init=opt.init, update=update)
        return patched(Adam, "adam", faulty)
    raise KeyError(name)


FAULTS = ("shared_dropped", "rope_key_dropped", "routed_scale_left_out",
          "half_batch", "bf16_scores", "update_skipped", "lr_x2", "nu_dropped")


def program_readings(cell, seed: int, device: str):
    from perfbench.drivers.lm_train import LMTrainRun
    run = LMTrainRun(cell, seed, Spans(), device)
    run.release()
    prog, batches = run.prog, run.check_batches
    del run
    gc.collect()
    return prog, batches


def reference(cell, seed: int, batches, device: str, score_dtype=None):
    import torch
    from perfbench.reference import moonlight as ref
    o, d = cell.config["optimizer"], ref.dims_from_config(cell.config)
    tree = ref.init_params(d, seed, device, getattr(torch, cell.config["dtype"]))
    out = ref.reference_steps(tree, d, batches, lr=o["lr"], clip=o["clip_norm"],
                              b1=o["b1"], b2=o["b2"], eps=o["eps"],
                              score_dtype=score_dtype or torch.float32)
    del tree
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def readings(cell, seed: int, device: str, faults: bool) -> dict:
    import torch
    from perfbench.drivers.lm_train import gaps
    from perfbench.reference import moonlight as ref
    d = ref.dims_from_config(cell.config)

    def g(prog, want):
        return gaps(prog, want, d.n_experts, d.bias_rate)
    t = time.perf_counter()
    prog, batches = program_readings(cell, seed, device)
    want = reference(cell, seed, batches, device)
    out = {"seed": seed, "program": g(prog, want)}
    if faults:
        out["control"] = g(reference(cell, seed, batches, device, torch.bfloat16), want)
        for name in FAULTS:
            with _fault(name):
                out[name] = g(program_readings(cell, seed, device)[0], want)
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    hostenv.pin_torch(torch)
    cell = manifest.load_cell(ROOT, args.workload)
    with_faults = {int(s) for s in args.faults.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(cell, s, args.device, s in with_faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
