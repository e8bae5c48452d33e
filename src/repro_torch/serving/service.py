"""Port of ``repro.serving.service``: the continuously-batched request router.

What differs from the reference is the Q dispatch and the device: the
network is a ``QNetwork`` module that carries its own parameters (so the
constructor takes ``qnet`` where the reference takes ``network, params``),
the service runs on ``device`` (the GPU unless the caller names another),
and every dispatch goes through the hand-written ``fused_qnet`` kernel on
the card.  PyTorch runs eagerly, so there is nothing to recompile; the
port's counterpart of the reference's 0-recompile gate is that the
kernel's launches equal the service's Q dispatches.

The trained policy is a generalist (the paper's premise: optimize NEW
molecules without retraining), so serving is a scheduling problem, not a
learning one.  Concurrent user requests ARE fleet slots: the service owns
one ``RolloutEngine`` whose W workers each hold at most one in-flight
request, and every service step is ONE fleet env step — one Q dispatch,
one property batch — over whatever request mix is currently bound.

Continuous batching: a finished / quarantined / deadline-reclaimed slot
is rebound to the next queued request the very next service step
(``RolloutEngine.bind_slot``), while its co-batched neighbours keep
stepping undisturbed.  Request objectives resolve through THE scenario
registry (``configs/scenarios.py``) at the door — the same table the
trainer mixes per worker — so the in-flight mix is a heterogeneous
objective fleet exactly like a ``TrainerConfig.scenarios`` run.  The
dense Q batch keeps ONE shape ``[W, C_cap, STATE_DIM]`` via the sticky
capacity-ladder buffer, whatever the request mix.

Isolation, so one request can never hurt another:

* per-request exploration RNG streams (seeded from the request) — a
  request's action draws are independent of who it is batched with;
* per-row Q values — each candidate row's result is independent of the
  other rows' values (the kernel sums every row on its own, in a fixed
  order);
* per-molecule property isolation + quarantine — a poisoned
  request drains ITS slot with an Incident, siblings never notice;
* the circuit breaker (serving/breaker.py) over the SHARED property tier
  — the one genuinely correlated failure mode degrades to cached/stub
  properties flagged ``degraded`` instead of sinking the fleet.

Together these give the serve determinism contract (gated for the port
by ``tests/test_torch_serve.py`` and ``chip_smoke.py``): under a seeded
FaultPlan every admitted request reaches a terminal status, a rerun is
bit-identical, and every request the faults never touched returns a
result BIT-identical to the unfaulted run's.

Time: the service clock is a VIRTUAL step clock (one tick per service
step) — deadlines, shedding, and reported ``latency`` are deterministic
functions of the request stream.  Wall-clock latency is measured
separately and only reported (``wall_latency_s``, the bench's p50/p99).
"""

from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.chem.chemcache import ChemCache
from repro_torch.chem.molecule import Molecule
from repro_torch.chem.smiles import canonical_smiles, from_smiles
from repro_torch.core.agent import (QNetwork, candidate_capacity,
                                    candidate_capacity_table)
from repro_torch.core.faults import FaultError, Incident, TransientFault
from repro_torch.core.rollout import STATE_DIM, EnvConfig, RolloutEngine, Slot
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_qnet.ops import fused_qnet
from repro_torch.predictors.service import DegradedPropertyService
from repro_torch.serving.admission import AdmissionQueue
from repro_torch.serving.breaker import CircuitBreaker
from repro_torch.serving.request import (OptimizeRequest, RequestResult,
                                         resolve_objective)


class StepClock:
    """Virtual service clock: ``tick`` units per service step.  Purely
    deterministic — the clock that deadlines and shedding run on."""

    def __init__(self, tick: float = 1.0):
        self.t = 0.0
        self.tick = float(tick)

    def now(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.tick


@dataclass(frozen=True)
class ServeConfig:
    """Admission / degradation knobs (docs/serving.md)."""

    n_slots: int = 8                 # fleet width = max co-batched requests
    max_queue: int = 64              # admission queue bound (backpressure)
    shed_policy: str = "reject_new"  # or "evict_oldest"
    max_steps: int = 16              # env horizon; budgets clamp to this
    epsilon: float = 0.0             # per-request exploration rate
    breaker_threshold: int = 3       # consecutive FaultErrors to trip
    breaker_cooldown: int = 8        # degraded serves before half-open probe
    chem: str = "incremental"
    seed: int = 0                    # folds into every request RNG stream


@dataclass
class _Flight:
    """One admitted request's mutable serving state."""

    req: OptimizeRequest
    molecule: Molecule | None
    objective: object
    budget: int
    submitted_at: float
    deadline_at: float | None
    wall_t0: float
    rng: np.random.Generator
    steps_used: int = 0
    degraded_steps: int = 0
    incident_mark: int = 0           # engine incident count at bind


class _ServePolicy:
    """Dense ``FleetPolicy`` with a sticky ``[W, C_cap, STATE_DIM]``
    buffer: capacity only ever climbs the candidate ladder, so a churning
    request mix reuses one dispatch shape.  Parameters are SHARED across
    slots — serving runs one trained generalist policy, so the dispatch is
    one ``fused_qnet`` call over all ``W * C_cap`` rows.  Per-row results
    are independent of sibling rows' values (the kernel sums each row on
    its own, in a fixed order), which is what makes co-batching invisible
    in the numbers.

    On the GPU every dispatch times its host-to-device copy and its kernel
    with CUDA events, read after the result's copy back has synchronised
    the stream, and adds them to ``h2d_ms`` and ``kernel_ms``."""

    def __init__(self, qnet: QNetwork, select_fn, n_workers: int,
                 device: torch.device):
        self.qnet = qnet
        self.device = device
        self._select_fn = select_fn
        self.n_workers = n_workers
        self._table = candidate_capacity_table(n_workers)
        self._cap = 0
        self._buf: np.ndarray | None = None
        self.n_dispatches = 0
        self.h2d_ms = 0.0
        self.kernel_ms = 0.0

    def reserve(self, max_candidates: int) -> None:
        cap = candidate_capacity(max(1, int(max_candidates)), self._table)
        if cap > self._cap:
            self._cap = cap
            self._buf = np.zeros((self.n_workers, cap, STATE_DIM), np.float32)

    def warm_dispatch(self) -> None:
        """Run the current capacity's shape once off the serving path
        (builds the kernel at first use)."""
        self.reserve(1)
        self._dispatch()

    def _dispatch(self) -> np.ndarray:
        self.n_dispatches += 1
        timed = self.device.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        x = torch.from_numpy(self._buf).to(self.device)
        if timed:
            ev[1].record()
        q = fused_qnet(self.qnet.layers(), x.view(-1, STATE_DIM))
        if timed:
            ev[2].record()
        out = q.view(self.n_workers, self._cap).cpu().numpy()
        if timed:
            self.h2d_ms += ev[0].elapsed_time(ev[1])
            self.kernel_ms += ev[1].elapsed_time(ev[2])
        return out

    def fleet_q_values(self, per_worker) -> list[np.ndarray]:
        counts = [x.shape[0] for x in per_worker]
        self.reserve(max(counts))
        buf = self._buf
        for w, x in enumerate(per_worker):
            buf[w, :counts[w]] = x
            buf[w, counts[w]:] = 0.0
        q = self._dispatch()
        return [q[w, :n] for w, n in enumerate(counts)]

    def select_action(self, q: np.ndarray, worker: int) -> int:
        return self._select_fn(q, worker)


class MoleculeOptService:
    """Bounded-queue, continuously-batched molecule-optimization server.

    Drive it with ``submit`` + ``step`` (or ``run_until_idle``); every
    submitted request ends up exactly once in ``results`` with a terminal
    status (serving/request.py).  See module docstring for the contracts.
    """

    def __init__(self, qnet: QNetwork, property_service, *,
                 cfg: ServeConfig = ServeConfig(),
                 fault_plan=None, clock=None, fallback=None,
                 chem_cache: ChemCache | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else StepClock()
        self.fault_plan = fault_plan
        self.engine = RolloutEngine(
            [[] for _ in range(cfg.n_slots)],
            EnvConfig(max_steps=cfg.max_steps),
            chem=cfg.chem, chem_cache=chem_cache, fault_plan=fault_plan)
        self.breaker = CircuitBreaker(
            property_service,
            fallback if fallback is not None
            else DegradedPropertyService(property_service),
            failure_threshold=cfg.breaker_threshold,
            cooldown_calls=cfg.breaker_cooldown)
        try:
            property_service.reserve(cfg.n_slots)
        except AttributeError:
            pass                     # stubs have no padding ladder
        self.queue = AdmissionQueue(cfg.max_queue, cfg.shed_policy)
        self._policy = _ServePolicy(
            qnet.to(self.device), self._select_action, cfg.n_slots,
            self.device)
        self._free: deque[int] = deque(range(cfg.n_slots))
        self._active: dict[int, _Flight] = {}
        self._retry_bind: list[_Flight] = []
        self._inflight_ids: set[str] = set()
        self.results: list[RequestResult] = []
        self.result_by_id: dict[str, RequestResult] = {}
        self.incidents: list[Incident] = []   # serve-site incident trail
        self.status_counts = {s: 0 for s in
                              ("completed", "degraded", "deadline_exceeded",
                               "shed", "failed")}
        self.n_submitted = 0
        self.n_bound = 0
        self.n_bind_retries = 0
        self.n_service_steps = 0

    # ------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------ #
    def submit(self, req: OptimizeRequest) -> str:
        """Admit one request.  Returns ``"queued"``, ``"shed"``, or
        ``"failed"`` (parse/objective rejects decided at the door).  A
        shed/failed verdict is ALSO a terminal result in ``results`` —
        submit never silently drops work."""
        self.n_submitted += 1
        now = self.clock.now()
        fl = _Flight(
            req=req, molecule=None, objective=None,
            budget=max(1, min(int(req.budget), self.cfg.max_steps)),
            submitted_at=now,
            deadline_at=(now + req.deadline
                         if req.deadline is not None else None),
            wall_t0=time.perf_counter(),
            rng=np.random.default_rng(
                [self.cfg.seed, req.seed,
                 zlib.crc32(req.request_id.encode())]))
        # poisoned requests fail AT THE DOOR — they never touch a slot,
        # so invalid SMILES cannot stall a co-batched neighbour
        try:
            if req.request_id in self._inflight_ids \
                    or req.request_id in self.result_by_id:
                raise ValueError(f"duplicate request_id {req.request_id!r}")
            fl.objective = resolve_objective(req.objective)
            fl.molecule = from_smiles(req.smiles)
            if fl.molecule.num_atoms == 0:
                raise ValueError("empty molecule")
        except Exception as e:  # noqa: BLE001 — any reject is the same story
            self._record_incident(site="parse", key=req.request_id,
                                  error=repr(e), action="rejected")
            self._finalize(fl, "failed", error=repr(e))
            return "failed"
        victim = self.queue.offer(fl)
        if victim is None:
            self._inflight_ids.add(req.request_id)
            return "queued"
        if victim is not fl:                      # evict_oldest shed
            self._inflight_ids.add(req.request_id)
            self._inflight_ids.discard(victim.req.request_id)
        self._finalize(victim, "shed")
        return "shed" if victim is fl else "queued"

    # ------------------------------------------------------------ #
    # the service step (one virtual clock tick)
    # ------------------------------------------------------------ #
    def step(self) -> list[RequestResult]:
        """One continuous-batching service step: expire deadlines, admit
        queued requests into free slots, advance the fleet ONE env step,
        finalize newly-terminal requests.  Returns the results finalized
        during this step (the streaming interface)."""
        mark = len(self.results)
        now = self.clock.now()
        for fl in reversed(self._retry_bind):     # transient bind retries
            self.queue.push_front(fl)
        self._retry_bind = []
        for fl in self.queue.drain_if(
                lambda f: f.deadline_at is not None and now >= f.deadline_at):
            self._finalize(fl, "deadline_exceeded")
        self._reclaim_deadlines(now)
        self._admit()
        stepped = [w for w, fl in self._active.items()
                   if self._slot(w).steps_left > 0]
        if stepped:
            self.engine.step(self._policy, self.breaker,
                             None, buffers=None)
            self.n_service_steps += 1
            degraded = self.breaker.drain_degraded_keys()
            for w in stepped:
                fl = self._active[w]
                fl.steps_used += 1
                if self._slot(w).current.canonical_key() in degraded:
                    fl.degraded_steps += 1
        self._collect_terminal()
        self.clock.advance()
        return self.results[mark:]

    @property
    def idle(self) -> bool:
        return not self._active and not len(self.queue) \
            and not self._retry_bind

    def run_until_idle(self, max_steps: int = 100_000) -> list[RequestResult]:
        """Step until every admitted request is terminal.  The hard cap is
        a liveness backstop: hitting it means a request hung, which the
        terminal-status contract forbids — so it raises."""
        mark = len(self.results)
        for _ in range(max_steps):
            if self.idle:
                return self.results[mark:]
            self.step()
        raise RuntimeError(
            f"service not idle after {max_steps} steps: "
            f"{len(self._active)} active, {len(self.queue)} queued")

    # ------------------------------------------------------------ #
    def _slot(self, w: int) -> Slot:
        return self.engine.workers[w][0]

    def _select_action(self, q: np.ndarray, worker: int) -> int:
        """Per-REQUEST epsilon-greedy: draws come from the bound request's
        private RNG stream, so shed/failed/reordered neighbours cannot
        shift another request's exploration sequence."""
        fl = self._active[worker]
        if self.cfg.epsilon > 0.0 and fl.rng.random() < self.cfg.epsilon:
            return int(fl.rng.integers(0, q.shape[0]))
        return int(np.argmax(q))

    def _reclaim_deadlines(self, now: float) -> None:
        """A slot is reclaimed the service step its deadline passes: the
        in-flight transition is dropped, the worker is freed for the next
        queued request, and the best-so-far molecule ships back."""
        for w in list(self._active):
            fl = self._active[w]
            if fl.deadline_at is not None and now >= fl.deadline_at:
                slot = self._slot(w)
                self.engine.kill_slot(w)
                self._release(w)
                self._finalize(fl, "deadline_exceeded", slot=slot)

    def _admit(self) -> None:
        while self._free and len(self.queue):
            fl = self.queue.pop()
            if self.fault_plan is not None \
                    and self.fault_plan.has_rule("request"):
                try:
                    self.fault_plan.check_key("request", fl.req.request_id)
                except FaultError as e:
                    self._record_incident(
                        site="request", key=fl.req.request_id,
                        error=repr(e), action="failed")
                    self._finalize(fl, "failed", error=repr(e))
                    continue
                except TransientFault:
                    # retried at the head of the queue NEXT step — the
                    # burst is bounded by the rule's fail_attempts
                    self.n_bind_retries += 1
                    self._retry_bind.append(fl)
                    continue
            w = self._free.popleft()
            fl.incident_mark = len(self.engine.incidents)
            self.engine.bind_slot(w, fl.molecule, fl.budget,
                                  objective=fl.objective)
            self._active[w] = fl
            self.n_bound += 1

    def _collect_terminal(self) -> None:
        for w in list(self._active):
            fl = self._active[w]
            slot = self._slot(w)
            if slot.steps_left > 0:
                continue
            error = None
            for inc in self.engine.incidents[fl.incident_mark:]:
                if inc.worker == w and inc.action == "quarantined":
                    error = inc.error
                    break
            self._release(w)
            if error is not None:
                self._finalize(fl, "failed", error=error, slot=slot)
            elif fl.degraded_steps > 0:
                self._finalize(fl, "degraded", slot=slot)
            else:
                self._finalize(fl, "completed", slot=slot)

    def _release(self, w: int) -> None:
        del self._active[w]
        self.engine.workers[w] = []
        self.engine.worker_initials[w] = []
        self._free.append(w)

    def _finalize(self, fl: _Flight, status: str, *, error: str | None = None,
                  slot: Slot | None = None) -> RequestResult:
        best_smiles = best_reward = None
        if slot is not None and slot.best is not None:
            best_reward, best_mol = slot.best
            best_smiles = canonical_smiles(best_mol)
        res = RequestResult(
            request_id=fl.req.request_id, status=status,
            best_smiles=best_smiles, best_reward=best_reward,
            steps_used=fl.steps_used, degraded_steps=fl.degraded_steps,
            submitted_at=fl.submitted_at, finished_at=self.clock.now(),
            wall_latency_s=time.perf_counter() - fl.wall_t0, error=error)
        self.results.append(res)
        self.result_by_id[res.request_id] = res
        self.status_counts[status] += 1
        self._inflight_ids.discard(fl.req.request_id)
        return res

    def _record_incident(self, *, site: str, key: str, error: str,
                         action: str) -> None:
        self.incidents.append(Incident(
            episode=0, step=self.n_service_steps, site=site,
            worker=-1, slot=-1, key=key, error=error, action=action))

    # ------------------------------------------------------------ #
    def reserve_candidates(self, max_candidates: int) -> None:
        """Pre-size the Q-dispatch buffer and run it once (warmup: the
        kernel is built and loaded off the clock); request mixes whose
        candidate counts stay inside the reservation keep this shape."""
        self._policy.reserve(max_candidates)
        self._policy.warm_dispatch()

    def dispatch_timing(self) -> dict | None:
        """Mean host-to-device copy and ``fused_qnet`` kernel milliseconds
        per Q dispatch (CUDA events, warm-up included); ``None`` off the
        GPU."""
        pol = self._policy
        if pol.device.type != "cuda" or not pol.n_dispatches:
            return None
        return {"dispatches": pol.n_dispatches,
                "h2d_ms": pol.h2d_ms / pol.n_dispatches,
                "kernel_ms": pol.kernel_ms / pol.n_dispatches}

    def stats(self) -> dict:
        """Operator counters: admission, statuses, breaker, engine faults."""
        return {
            "n_submitted": self.n_submitted,
            "n_bound": self.n_bound,
            "n_bind_retries": self.n_bind_retries,
            "n_service_steps": self.n_service_steps,
            "n_q_dispatches": self._policy.n_dispatches,
            "status_counts": dict(self.status_counts),
            "queue": self.queue.stats(),
            "breaker": self.breaker.stats(),
            "engine_faults": self.engine.fault_stats(),
            "serve_incidents": [i.as_dict() for i in self.incidents],
        }
