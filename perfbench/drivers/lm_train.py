"""An LM configuration's training on one device's share: the port's normal
path, ``launch/steps.make_train_step`` -> ``models.loss_fn`` ->
``optim/adam.py``, steps back to back.

Traffic parameters: ``batch`` sequences of ``seq`` tokens a step, split
into ``microbatches``; token ids Zipf (exponent ``zipf_s``) over the
configuration's vocabulary slice, the rank order permuted from the seed,
one causal sequence a row; ``check_steps`` steps the reference follows;
``trace_offset_s`` and ``trace_seconds``.  Set-up builds the program's
configuration (refused before anything is allocated if the program lacks
it or its widths differ from the file's), draws the weights on the device
from the seed (``reference.moonlight.init_params``, the program's tree),
runs one warm-up gradient (the step's own ``loss_and_grads``, no update:
the state stays the seed's), then the checked steps through the window's
own call.  Of the window's steps every loss has to be finite and every
leaf has to have moved (``window_unmoved``).  After ``release()`` the
plain reference (``reference/moonlight.py``) follows the checked steps
from the same seed and batches."""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np

from perfbench.harness import lm_work
from perfbench.harness.lm_trace import span_device_seconds
from perfbench.reference import moonlight as ref

# the program's spans whose device time a metric reads
DEVICE_SPANS = ("lm.moe.route", "lm.moe.experts", "lm.moe.combine", "lm.adam")
# the file's published widths and the program's configuration fields they set
WIDTHS = {
    "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_hidden_layers": "n_layers", "moe_intermediate_size": "d_ff",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
    "intermediate_size": "moe.dense_d_ff", "first_k_dense_replace": "moe.first_dense",
    "router_experts": "moe.n_experts", "num_experts_per_tok": "moe.top_k",
    "n_shared_experts": "moe.n_shared", "routed_scaling_factor": "moe.routed_scale",
    "bias_update_rate": "moe.bias_rate", "seq_aux_alpha": "moe.seq_aux_weight",
    "kv_lora_rank": "mla.kv_lora_rank", "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim", "v_head_dim": "mla.v_head_dim",
    "kv_norm_eps": "mla.kv_norm_eps",
}
# the router the program implements, and nothing else
ROUTER = {"scoring_func": "sigmoid", "norm_topk_prob": True}


def program_config(config: dict):
    """The program's registered configuration at this device's share: the
    vocabulary slice and the held experts, in the file's ``dtype``, with
    per-layer recomputation.
    Raises (``KeyError``, ``ValueError``) before anything is allocated
    where the program lacks the configuration or disagrees with the file."""
    from repro_torch.configs import get_config
    base = get_config(config["arch"])
    wrong = [f"{key}: file {config[key]!r}, program {want!r}"
             for key, want in ROUTER.items() if config[key] != want]
    for key, field in WIDTHS.items():
        obj = base
        for part in field.split("."):
            obj = getattr(obj, part)
        if obj != config[key]:
            wrong.append(f"{key}: file {config[key]!r}, program {obj!r}")
    if wrong:
        raise ValueError("the program's configuration differs: " + "; ".join(wrong))
    moe = dataclasses.replace(base.moe, expert_share=(config["expert_first"],
                                                      config["n_routed_experts"]))
    return dataclasses.replace(base, vocab=config["vocab_size"], moe=moe,
                               dtype=config["dtype"], remat=True, use_pallas=False)


def named_leaves(tree, prefix=()):
    """(path, leaf) in sorted-key order, paths joined by '.'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def gaps(prog: dict, want: dict, n_experts: int, bias_rate: float) -> dict:
    """The numbers compared with the cell's limits, and ``loss1_gap``
    beside them.  ``grad_gap_p90``: the 90th percentile over leaves of the
    first gradient's norm gap, against the reference's norm.
    ``change_gap_p90`` and ``change_gap_worst``: the 90th percentile over
    leaves, and the worst leaf, of the gap between the norms of the
    parameters' change over step 1 (on ``ref.leaf_samples``' elements),
    each against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = sorted(want["grad_norms"])
    g = [abs(prog["grad_norms"][n] - want["grad_norms"][n]) / want["grad_norms"][n]
         for n in names if want["grad_norms"][n] > 0]
    rc = want["change_norms"]
    med = float(np.median(list(rc.values())))
    c = [abs(prog["change_norms"][n] - rc[n]) / max(rc[n], med) for n in sorted(rc)]
    routes = prog["routes1"].to(want["routes1"].device)
    bias = prog["bias"].to(want["bias"].device)
    return {
        "loss1_gap": abs(prog["loss1"] - want["loss1"]) / abs(want["loss1"]),
        "grad_gap_p90": float(np.quantile(g, 0.9)),
        "change_gap_p90": float(np.quantile(c, 0.9)),
        "change_gap_worst": float(max(c)),
        "route_mismatch_share": ref.route_mismatch(routes, want["routes1"], n_experts),
        "bias_gap": float(((bias - want["bias"]).abs() > bias_rate / 2)
                          .float().mean()),
    }


class LMTrainRun:
    def __init__(self, cell, seed: int, spans, device: str):
        import torch
        from repro_torch.core.spans import SpanRecorder
        from repro_torch.launch.steps import (_split, loss_and_grads, make_train_step,
                                              with_leaves)
        from repro_torch.models import abstract_params
        from repro_torch.models.moe import StepStats
        from repro_torch.optim.adam import adam

        self.cell, self.seed, self.spans, self.device = cell, seed, spans, device
        cfg, tr = cell.config, cell.traffic
        self.split = {}
        t = time.perf_counter()
        self.cfg = program_config(cfg)
        self.dims = ref.dims_from_config(cfg)
        o = cfg["optimizer"]
        opt = adam(o["lr"], o["b1"], o["b2"], o["eps"], clip_norm=o["clip_norm"],
                   mu_dtype=torch.float32)
        self.rec = SpanRecorder()
        self.step, opt_wrap = make_train_step(self.cfg, opt, tr["microbatches"],
                                              recorder=self.rec)
        self.split["config_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.params = ref.init_params(self.dims, seed, device, self.cfg.torch_dtype)
        want = dict(named_leaves(abstract_params(self.cfg)))
        got = dict(named_leaves(self.params))
        bad = sorted(set(got) ^ set(want)) + [
            p for p in want if p in got and (tuple(got[p].shape) != tuple(want[p].shape)
                                             or got[p].dtype != want[p].dtype)]
        if bad:
            raise ValueError(f"the program's parameter tree differs at {bad}")
        self.opt_state = opt_wrap.init(self.params)
        self.gen = torch.Generator(device=device).manual_seed(int(seed) * 2 + 1)
        self.perm = torch.randperm(self.dims.vocab, generator=self.gen, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["init_s"] = time.perf_counter() - t

        # one warm-up gradient through the step's own path; no update
        t = time.perf_counter()
        batch = self._batch()
        with spans.span("lm.warmup"):
            loss_and_grads(self.params, self.cfg, _split(batch, tr["microbatches"])[0])
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["warmup_s"] = time.perf_counter() - t

        # the checked steps, through the window's own call
        t = time.perf_counter()
        self.check_batches = [self._batch() for _ in range(tr["check_steps"])]
        self.prog = {}
        b1 = o["b1"]
        before = ref.leaf_samples(self.params)
        for i, batch in enumerate(self.check_batches):
            stats = StepStats(keep_routes=i == 0)
            with spans.span("lm.step"):
                self.params, self.opt_state, loss = self.step(
                    self.params, self.opt_state, batch, stats)
            if i == 0:
                self.prog["change_norms"] = ref.change_norms(
                    before, ref.leaf_samples(self.params))
                del before
                self.prog["loss1"] = float(loss)
                mu = dict(named_leaves(with_leaves(self.params, self.opt_state.mu)))
                self.prog["grad_norms"] = {p: float(m.norm()) / (1.0 - b1)
                                           for p, m in mu.items()}
                self.prog["routes1"] = torch.stack(
                    [stats.routes[j] for j in sorted(stats.routes)]).cpu()
        self.prog["bias"] = self.params["blocks"]["moe"]["bias"].detach().cpu().clone()
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["check_steps_s"] = time.perf_counter() - t

    def _batch(self) -> dict:
        tr = self.cell.traffic
        return ref.zipf_batch(self.gen, tr["batch"], tr["seq"], self.perm, tr["zipf_s"])

    def window(self, seconds: float, profile) -> dict:
        import torch
        tr, d = self.cell.traffic, self.dims
        before = ref.leaf_samples(self.params)
        snap0 = self.rec.snapshot()
        steps, bad, step_s = 0, 0, []
        if profile is not None:
            profile.probe = self.rec.snapshot
        t0 = time.perf_counter()
        if profile is not None:
            profile.start_window()
        while True:
            if profile is not None:
                profile.poll()
            t = time.perf_counter()
            batch = self._batch()
            with self.spans.span("lm.step"):
                self.params, self.opt_state, loss = self.step(
                    self.params, self.opt_state, batch)
            bad += not math.isfinite(float(loss))
            step_s.append(time.perf_counter() - t)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        if profile is not None:
            profile.stop()
        snap1 = self.rec.snapshot()
        after = ref.leaf_samples(self.params)
        self.window_readings = {
            "window_unmoved": float(sum(torch.equal(before[p], after[p]) for p in before))}
        del before, after
        program = _diff(snap0, snap1)
        n_moe = d.n_layers - d.first_dense
        calls = program["calls"].get("lm.moe.route", 0)
        pairs = program["counts"].get("lm.moe.local_rows", 0) * steps * n_moe / max(calls, 1)
        tokens = steps * tr["batch"] * tr["seq"]
        flops = steps * lm_work.step_model_flops(d, tr["batch"], tr["seq"],
                                                 pairs / max(steps, 1))
        counters = {"window_s": elapsed, "steps": steps, "tokens": tokens,
                    "flops": flops, "experts_held": d.expert_count,
                    "program": program}
        if profile is not None and profile.prof is not None and profile.probe_on:
            traced = _diff(profile.probe_on, profile.probe_off)
            t_steps = traced["counts"].get("lm.steps", 0)
            counters["traced"] = {
                "steps": t_steps,
                "attn_flops": (traced["calls"].get("lm.mla", 0)
                               + 2 * t_steps * tr["microbatches"] * d.n_layers)
                * lm_work.attn_core_flops(d, tr["batch"] // tr["microbatches"], tr["seq"]),
                "expert_flops": traced["counts"].get("lm.moe.local_rows", 0)
                * lm_work.expert_row_flops(d),
                "span_device_s": span_device_seconds(profile.prof, DEVICE_SPANS),
            }
        return {"end_to_end": {}, "attempted": steps, "failed": bad,
                "detail": {"step_s": step_s}, "counters": counters}

    def release(self) -> None:
        del self.params, self.opt_state, self.step
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def check(self) -> dict:
        o = self.cell.config["optimizer"]
        tree = ref.init_params(self.dims, self.seed, self.device, self.cfg.torch_dtype)
        want = ref.reference_steps(tree, self.dims, self.check_batches, lr=o["lr"],
                                   clip=o["clip_norm"], b1=o["b1"], b2=o["b2"],
                                   eps=o["eps"])
        return {**gaps(self.prog, want, self.dims.n_experts, self.dims.bias_rate),
                **self.window_readings}


def _diff(a: dict, b: dict) -> dict:
    return {k: {n: v - a[k].get(n, 0) for n, v in b[k].items()} for k in b}


def build(cell, seed: int, spans, device: str = "cuda") -> LMTrainRun:
    return LMTrainRun(cell, seed, spans, device)
