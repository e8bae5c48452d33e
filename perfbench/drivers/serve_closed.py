"""The molecule-optimization server under a closed loop: ``clients``
clients, each sending its next request only when its last one has
returned, against ``MoleculeOptService`` with ``slots`` slots.  No
deadline, no fault plan and no unparseable SMILES: every request can
complete, so one that does not is a fault of the program.

Traffic parameters: ``slots``, ``clients``, ``pool`` (frozen SMILES),
``budget_lo`` / ``budget_hi`` (steps, inclusive), ``per_client`` (the
length of each client's schedule), ``warmup_steps`` (service steps run in
set-up before the window), ``drain_s`` (how long, after the window, the
requests still in flight may take to answer), ``check_sample`` (how many
requests that finished after the window opened the reference follows, the
longest among them) and
``trace_offset_s`` / ``trace_seconds``."""

from __future__ import annotations

import gc
import time

import numpy as np

from perfbench.harness import inputs, work


class ServeRun:
    def __init__(self, cell, seed: int, spans, device: str):
        import torch
        from repro_torch.core.agent import QNetwork
        from repro_torch.predictors.service import (OracleService,
                                                    ResilientService,
                                                    RetryPolicy)
        from repro_torch.serving import MoleculeOptService, ServeConfig

        self.cell, self.seed, self.spans, self.device = cell, seed, spans, device
        cfg, tr = cell.config, cell.traffic
        sv = cfg["serve"]
        self.sizes = tuple(cfg["sizes"])
        self.split = {}
        t = time.perf_counter()
        self.weights = inputs.qnet_weights(self.sizes, seed, device)
        self.pool = inputs.pool(tr["pool"])
        self.schedule = inputs.closed_loop_schedule(
            seed, tr["clients"], len(self.pool), tr["budget_lo"],
            tr["budget_hi"], tr["per_client"])
        self.split["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        prop = ResilientService(OracleService(),
                                RetryPolicy(max_retries=sv["retry_max"], seed=int(seed)),
                                fault_plan=None, sleep=None)
        spans.wrap(prop, "predict", "property")
        self.svc = MoleculeOptService(
            QNetwork(self.sizes[1:-1], self.sizes[0], layers=self.weights,
                     device=device),
            prop, device=device,
            cfg=ServeConfig(n_slots=tr["slots"], max_queue=tr["clients"],
                            shed_policy="reject_new", max_steps=sv["max_steps"],
                            epsilon=sv["epsilon"], chem=sv["chem"],
                            seed=int(seed)))
        self.svc.reserve_candidates(sv["reserve_candidates"])
        spans.wrap(self.svc.engine, "_compute_enum", "chem")
        self._wrap_policy()
        self.split["service_s"] = time.perf_counter() - t

        self.owner: dict[str, int] = {}
        self.requests: dict[str, dict] = {}
        self.next_i = [0] * tr["clients"]
        self.finished: list = []      # every terminal result, in order
        self.mark = 0                 # where the window's answers start
        self.submitting = True
        t = time.perf_counter()
        for c in range(tr["clients"]):
            self._submit(c)
        for _ in range(tr["warmup_steps"]):
            self._step()
        if device == "cuda":
            torch.cuda.synchronize()
        self.split["warmup_s"] = time.perf_counter() - t

    def _wrap_policy(self) -> None:
        """Record every Q choice of every request (its Q values and the
        chosen index), and count and time the Q dispatches' real rows."""
        pol, svc, spans = self.svc._policy, self.svc, self.spans
        self.trajectory: dict[str, list] = {}
        self.q_rows = 0
        self.q_bound_s = 0.0
        select, dispatch = pol.select_action, pol.fleet_q_values

        def select_action(q, worker):
            a = select(q, worker)
            rid = svc._active[worker].req.request_id
            self.trajectory.setdefault(rid, []).append((np.array(q), a))
            return a

        def fleet_q_values(per_worker):
            rows = sum(x.shape[0] for x in per_worker)
            self.q_rows += rows
            self.q_bound_s += work.qnet_dispatch_bound_s(self.sizes, rows)
            with spans.span("qdispatch"):
                return dispatch(per_worker)
        pol.select_action = select_action
        pol.fleet_q_values = fleet_q_values

    def _submit(self, c: int) -> None:
        from repro_torch.serving.request import OptimizeRequest
        i = self.next_i[c]
        if i >= len(self.schedule[c]):
            raise RuntimeError(f"client {c} ran out of its {i} scheduled "
                               f"requests: raise per_client")
        self.next_i[c] = i + 1
        m, budget = self.schedule[c][i]
        rid = f"c{c:03d}-{i:05d}"
        req = {"request_id": rid, "smiles": self.pool[m], "budget": budget,
               "seed": c * 100_000 + i}
        self.requests[rid] = req
        self.owner[rid] = c
        verdict = self.svc.submit(OptimizeRequest(
            objective=self.cell.config["serve"]["objective"], deadline=None,
            **req))
        if verdict != "queued":       # answered at the door: a failure
            self._done(self.svc.result_by_id[rid], resubmit=False)

    def _done(self, res, resubmit: bool = True) -> None:
        self.finished.append(res)
        if resubmit and self.submitting:
            self._submit(self.owner[res.request_id])

    def _step(self) -> None:
        with self.spans.span("service_step"):
            out = self.svc.step()
        for res in out:
            self._done(res)

    def _counters(self) -> dict:
        chem = self.svc.engine.chem_stats()
        timing = self.svc.dispatch_timing() or {"dispatches": 0, "h2d_ms": 0.0,
                                                "kernel_ms": 0.0}
        return {
            "service_steps": self.svc.stats()["n_service_steps"],
            "chem_s": chem["enum_s"] + chem["fp_s"],
            "cache_hits": chem.get("hits", 0),
            "cache_lookups": chem.get("lookups", 0),
            "dispatch_ms": (timing["h2d_ms"] + timing["kernel_ms"])
            * timing["dispatches"],
            "dispatches": timing["dispatches"],
            "q_rows": self.q_rows,
            "span_s": dict(self.spans.seconds),
        }

    def window(self, seconds: float, profile) -> dict:
        before = self._counters()
        self.mark = mark = len(self.finished)
        t0 = time.perf_counter()
        if profile is not None:
            profile.probe = lambda: self.q_bound_s
            profile.start_window()
        step_s = []
        while True:
            if profile is not None:
                profile.poll()
            t = time.perf_counter()
            self._step()
            step_s.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        trace_bound = None
        if profile is not None:
            profile.stop()
            if profile.probe_off is not None:
                trace_bound = profile.probe_off - profile.probe_on
        after = self._counters()
        done = self.finished[mark:]
        completed = sum(r.status == "completed" for r in done)
        lat = np.array([r.wall_latency_s for r in done], np.float64)

        # no new requests; the ones in flight answer within drain_s
        self.submitting = False
        t = time.perf_counter()
        while not self.svc.idle and time.perf_counter() - t < self.cell.traffic["drain_s"]:
            self._step()
        # every request answered after the window opened, or never
        answered = self.finished[mark:]
        unanswered = len(self.requests) - len(self.finished)
        d = {k: after[k] - before[k] for k in after if k != "span_s"}
        d["span_s"] = {k: v - before["span_s"].get(k, 0.0)
                       for k, v in after["span_s"].items()}
        d.update(window_s=elapsed, finished=len(done), completed=completed,
                 p95_latency_s=float(np.percentile(lat, 95)) if len(lat) else None,
                 trace_q_bound_s=trace_bound, qnet_sizes=list(self.sizes))
        return {"end_to_end": {"serve_done_req_s": completed / elapsed},
                "attempted": len(answered) + unanswered,
                "failed": sum(r.status != "completed" for r in answered)
                + unanswered,
                "detail": {"steps": len(step_s),
                           "step_s_quartiles": np.percentile(
                               step_s, [0, 25, 50, 75, 100]).tolist()},
                "counters": d}

    def release(self) -> None:
        # the answers of the window: every request that finished after it
        # opened, the ones drained after it closed included
        self.results = {r.request_id: r for r in self.finished[self.mark:]}
        del self.svc
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def sample(self) -> list[str]:
        """The requests the reference follows, drawn from the seed among
        those that completed after the window opened: the longest first,
        then at random."""
        done = sorted(rid for rid, r in self.results.items()
                      if r.status == "completed")
        n = min(self.cell.traffic["check_sample"], len(done))
        longest = sorted(done, key=lambda k: (-self.results[k].steps_used, k))
        take = longest[: n // 4]
        chosen = set(take)
        rest = [k for k in done if k not in chosen]
        rng = np.random.default_rng([int(self.seed), 11])
        take += [rest[i] for i in rng.choice(len(rest), n - len(take), replace=False)]
        return take

    def follow_all(self, controls: bool = False) -> list[dict]:
        from perfbench.reference.molopt import follow
        cfg = self.cell.config
        out = []
        for rid in self.sample():
            r = self.results[rid]
            out.append(follow(
                self.requests[rid], self.trajectory.get(rid, []),
                {"best_smiles": r.best_smiles, "best_reward": r.best_reward,
                 "steps_used": r.steps_used},
                self.weights, cfg["serve"], cfg["reward"], self.seed,
                self.device, controls=controls))
        return out

    def check(self) -> dict:
        per = self.follow_all()
        mism = [m for p in per for m in p["mismatches"]]
        return {"q_gap": max((p["q_gap"] for p in per), default=float("nan")),
                "greedy_gap": max((p["greedy_gap"] for p in per),
                                  default=float("nan")),
                "mismatches": float(len(mism)),
                "followed": len(per),
                "first_mismatches": mism[:5]}


def build(cell, seed: int, spans, device: str = "cuda") -> ServeRun:
    return ServeRun(cell, seed, spans, device)
