"""Copy of ``repro.core.rollout``; only its imports differ.

Fleet-level rollout engine.

The paper's *batched modification* (§3.1) batches the candidates of the
molecules owned by ONE worker.  ``RolloutEngine`` lifts that one level up:
the unit of batching is the whole fleet.  Per environment step, across all
W workers it performs

* one candidate-enumeration + fingerprint pass over every live slot,
* ONE Q-network jit dispatch over the concatenation of every worker's
  candidate states (per-worker parameters selected inside the call via a
  vmap'd apply over the stacked ``[W, ...]`` parameter tree),
* per-worker epsilon-greedy selection (each worker keeps its own RNG
  stream, so fleet-stepping reproduces the per-worker sequential rollout
  transition-for-transition),
* ONE ``PropertyService.predict`` over all chosen successors fleet-wide
  (bigger predictor buckets, fewer recompiles),
* replay-buffer writes threaded through per worker.

Acting cost is therefore O(1) jit dispatches per step instead of O(W).
``BatchedEnv``/``MoleculeEnv`` (core/env.py) are thin single-worker
adapters over this engine, so the MolDQN-style APIs keep working.

Two step implementations share every helper:

``step()``            the CORRECTNESS REFERENCE.  Strictly sequential:
                      enumerate -> Q dispatch -> select -> property batch
                      -> transitions -> enumerate next.  Driven by a DENSE
                      policy this defines correctness; every other acting
                      path (``step_pipelined``, the packed/async policy
                      protocols, the sharded trainer views) is pinned
                      transition-identical to it by tests/test_rollout.py
                      — change it first, then make the fast paths match.
``step_pipelined()``  the same transition stream, but step t+1's candidate
                      enumeration + fingerprinting runs on host threads
                      WHILE step t's property batch runs on device (the two
                      only depend on step t's selected actions, not on each
                      other).  Bit-identical because per-slot enumeration is
                      pure and the chunked fingerprint batch is
                      composition-independent (pinned by
                      test_chunked_fingerprints_bit_identical).

Ragged fleets are supported: workers may own different slot counts, slots
may finish episodes at different steps, and a slot whose molecule has NO
valid candidate actions dies cleanly — its in-flight transition is
completed with an empty successor set (the double-DQN max treats that as a
zero-value terminal) and flushed, and the slot stops acting.  None of this
changes jit shapes: dead slots simply drop out of the dense batch rows.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.chem.actions import Action, enumerate_actions
from repro_torch.chem.chemcache import ChemCache, molecule_signature
from repro_torch.chem.fingerprint import (
    FP_BITS, batch_morgan_fingerprints, incremental_fingerprints_grouped,
    pack_fps)
from repro_torch.chem.molecule import ALLOWED_RING_SIZES, Molecule
from repro_torch.core.faults import FaultError, Incident, TransientFault
from repro_torch.core.replay import FP_BYTES, ReplayBuffer, Transition, unpack_fp
from repro_torch.core.reward import (
    CompiledObjective, ObjectiveSpec, RewardConfig, evaluate_rewards)

STATE_DIM = FP_BITS + 1  # fingerprint ++ steps-left feature

# candidate-chemistry paths (see RolloutEngine):
#   "full"         enumerate + full fingerprint recompute every step — the
#                  seed behaviour, kept as the pinned reference
#   "incremental"  shared-parent batched incremental fingerprints + the
#                  fleet-wide ChemCache (canonical-key memo of action set +
#                  packed fingerprints); transition streams are pinned
#                  bit-identical to "full" by tests/test_rollout.py
CHEM_MODES = ("full", "incremental")


@dataclass(frozen=True)
class EnvConfig:
    max_steps: int = 10                       # Table 3
    max_atoms: int = 38
    allow_removal: bool = True
    protect_oh: bool = True                   # §3.3
    allowed_ring_sizes: frozenset = ALLOWED_RING_SIZES


@dataclass
class StepRecord:
    """What one molecule produced in one environment step."""
    slot: int
    molecule: Molecule
    reward: float
    done: bool
    conformer_valid: bool
    bde: float | None
    ip: float | None
    worker: int = 0


@dataclass(eq=False)
class Slot:
    """One molecule episode; ``index`` is its position in the worker's
    modification batch (stored once — no identity scans per record)."""
    worker: int
    index: int
    initial: Molecule
    current: Molecule
    steps_left: int
    candidates: Sequence[Action] = field(default_factory=list)
    cand_fps: np.ndarray | None = None        # f32[C, FP_BITS] (no steps col)
    cand_fps_packed: np.ndarray | None = None  # u8[C, FP_BITS/8] (same rows)
    pending: Transition | None = None         # waiting for next-state candidates
    best: tuple[float, Molecule] | None = None
    # per-slot reward override (a serving request's objective); ``None``
    # falls back to the fleet-wide reward_cfg passed to step()
    objective: object | None = None

    def steps_frac(self, max_steps: int) -> float:
        return self.steps_left / max_steps


@runtime_checkable
class FleetPolicy(Protocol):
    """What the engine needs from the acting side.

    ``fleet_q_values`` receives one stacked state matrix per worker
    (``f32[N_w, STATE_DIM]``, possibly empty) and must evaluate ALL of
    them in a single jit dispatch, returning one ``f32[N_w]`` per worker.
    ``select_action`` draws from the given worker's RNG stream.

    A policy may additionally opt into the PACKED acting protocol by
    exposing ``wants_packed_states = True``: the engine then never builds
    the dense f32 state matrices and instead hands over the per-worker
    ``u8[N_w, FP_BITS/8]`` bit planes + ``f32[N_w]`` steps-left columns
    through ``fleet_q_values_packed``.  With ``async_q = True`` on top,
    the engine splits the dispatch (``fleet_q_dispatch_packed`` returns a
    handle without blocking; ``fleet_q_fetch`` blocks) and pre-draws the
    eps-greedy decisions through ``plan_action(n_candidates, worker)``
    while the device computes — ``plan_action`` must consume the worker's
    RNG stream exactly like ``select_action`` would (one uniform; plus
    the integer draw on the explore branch) and return the explored index
    or -1, in which case the engine resolves the greedy branch as
    ``int(np.argmax(q))`` once the Q values land.  Both packed protocols
    are pinned bit-identical to this dense one by tests/test_rollout.py.
    """

    def fleet_q_values(self, per_worker: Sequence[np.ndarray]) -> list[np.ndarray]: ...

    def select_action(self, q: np.ndarray, worker: int) -> int: ...


class AgentFleetPolicy:
    """Adapts a single-model agent (``q_values``/``select_action``) to the
    fleet interface: shared parameters, so the fleet call is one flat batch."""

    def __init__(self, agent):
        self.agent = agent

    def fleet_q_values(self, per_worker: Sequence[np.ndarray]) -> list[np.ndarray]:
        lens = [x.shape[0] for x in per_worker]
        flat = np.concatenate([x for x in per_worker if x.shape[0]], axis=0) \
            if any(lens) else np.zeros((0, STATE_DIM), np.float32)
        q = self.agent.q_values(flat) if flat.shape[0] else np.zeros((0,), np.float32)
        out, off = [], 0
        for ln in lens:
            out.append(q[off:off + ln])
            off += ln
        return out

    def select_action(self, q: np.ndarray, worker: int) -> int:
        return self.agent.select_action(q)


def as_fleet_policy(obj) -> FleetPolicy:
    if isinstance(obj, FleetPolicy):
        return obj
    return AgentFleetPolicy(obj)


# row marker of the fleet reward layer: the slot's objective raised while
# evaluating this row — the slot quarantines (Incident site "reward"), its
# co-batched neighbours keep their rewards
_REWARD_FAULT = object()


@dataclass(frozen=True)
class _EnumFailure:
    """Sentinel a failed per-molecule chemistry computation returns instead
    of a ``(actions, fps, packed)`` tuple — the quarantine signal that
    travels through the enumeration batch without poisoning its siblings."""
    key: str       # molecule canonical key
    error: str     # repr of the terminal exception


class RolloutEngine:
    """Advances W workers' slot batches in lockstep, fleet-batched.

    The engine itself is deterministic: all action stochasticity comes from
    the policy's per-worker RNG streams (``FleetPolicy.select_action``).
    ``pipeline_threads`` sizes the host thread pool used only by
    ``step_pipelined``.
    """

    def __init__(self, worker_molecules: Sequence[Sequence[Molecule]],
                 cfg: EnvConfig | None = None, pipeline_threads: int | None = None,
                 chem: str = "full", chem_cache: ChemCache | None = None,
                 pad_workers_to: int | None = None, packed_states: bool = False,
                 fault_plan=None, chem_retries: int = 2):
        if chem not in CHEM_MODES:
            raise ValueError(f"chem must be one of {CHEM_MODES}, got {chem!r}")
        self.cfg = cfg if cfg is not None else EnvConfig()
        self.chem = chem
        # packed acting: every consumer reads Slot.cand_fps_packed, so chem
        # may skip rebuilding dense f32 rows for cache hits (cand_fps stays
        # None) — the fleet-mode contract that no dense f32 candidate
        # buffer is ever materialised on the host (ROADMAP invariants)
        self.packed_states = packed_states
        # the cache may be shared fleet-wide (the trainer hands the same
        # instance to every engine/env it builds)
        self.chem_cache = chem_cache if chem_cache is not None else \
            (ChemCache() if chem == "incremental" else None)
        self.worker_initials = [list(ms) for ms in worker_molecules]
        self.n_live_workers = len(self.worker_initials)
        # mesh padding: DEAD workers own no molecules, contribute zero-row
        # state matrices to every dense batch, and never touch a buffer —
        # how a fleet that does not divide the device count tiles the mesh
        # without changing any live worker's transitions (PR-2's ragged
        # zero-slot semantics, promoted to whole workers)
        if pad_workers_to is not None:
            if pad_workers_to < self.n_live_workers:
                raise ValueError(
                    f"pad_workers_to={pad_workers_to} < {self.n_live_workers} live workers")
            self.worker_initials += [
                [] for _ in range(pad_workers_to - self.n_live_workers)]
        self.n_workers = len(self.worker_initials)
        # per-worker default objectives (the heterogeneous-scenario fleet):
        # stamped onto every Slot at reset(); None falls through to the
        # reward_cfg argument of step()/run_episode().  A serving bind_slot
        # objective still wins per slot.
        self.worker_objectives: list[object | None] = [None] * self.n_workers
        # lazy (worker, spec-or-name) -> CompiledObjective memo for raw
        # ObjectiveSpec / registry-name objectives handed straight to the
        # engine — per-WORKER instances, never shared (the novelty term's
        # counts are worker-scoped state)
        self._compiled_objectives: dict[tuple[int, object], CompiledObjective] = {}
        self.workers: list[list[Slot]] = []
        self.n_env_steps = 0
        self.chem_enum_s = 0.0   # host seconds in candidate enumeration
        self.chem_fp_s = 0.0     # host seconds in candidate fingerprints
        self._stats_lock = threading.Lock()  # pipelined threads accumulate
        # self-healing: a slot whose chem/property path raises a terminal
        # FaultError drains to dead under quarantine (empty successor set,
        # structured Incident record) and is revived from the worker's
        # start assignment at the next episode boundary (run_episode ->
        # reset()); transient chem faults are retried in place
        self.fault_plan = fault_plan
        self.chem_retries = int(chem_retries)
        self.incidents: list[Incident] = []
        self.episode_counter = 0
        self.n_quarantined = 0
        self.n_chem_retries = 0
        self.n_pipeline_restarts = 0
        self._enumerated = False
        # leave a core for the main thread (property featurize + the XLA
        # dispatch): oversubscribing a small host makes the overlap a loss
        self._pipeline_threads = pipeline_threads or \
            max(1, min(4, (os.cpu_count() or 2) - 1))
        self._pool: ThreadPoolExecutor | None = None  # built on first pipelined step
        self.reset()

    # ------------------------------------------------------------ #
    def set_initial_molecules(
            self, worker_molecules: Sequence[Sequence[Molecule]]) -> None:
        """Swap every LIVE worker's start molecules — the multi-start
        dataset stream's per-episode assignment.  Mesh-padding (dead)
        workers keep their empty slots.  Takes effect at the next
        ``reset()``; ``run_episode`` resets first, so the trainer can
        re-seed starts right before each episode."""
        if len(worker_molecules) != self.n_live_workers:
            raise ValueError(
                f"expected {self.n_live_workers} live workers' molecule "
                f"batches, got {len(worker_molecules)}")
        pad = self.worker_initials[self.n_live_workers:]
        self.worker_initials = [list(ms) for ms in worker_molecules] + pad

    def set_worker_objectives(self, objectives: Sequence[object | None]) -> None:
        """Install per-worker default objectives (the scenario mix): one
        entry per LIVE worker — a ``RewardConfig``, ``ObjectiveSpec``,
        compiled objective, callable, or ``None`` (fall through to the
        fleet-wide ``reward_cfg``).  Takes effect on current slots and at
        every subsequent ``reset()``; mesh-padding workers stay ``None``."""
        objectives = list(objectives)
        if len(objectives) != self.n_live_workers:
            raise ValueError(
                f"expected {self.n_live_workers} live workers' objectives, "
                f"got {len(objectives)}")
        self.worker_objectives = objectives + \
            [None] * (self.n_workers - self.n_live_workers)
        for w, slots in enumerate(self.workers):
            for s in slots:
                s.objective = self.worker_objectives[w]

    def reset(self) -> None:
        self.workers = [
            [Slot(worker=w, index=i, initial=m, current=m,
                  steps_left=self.cfg.max_steps,
                  objective=self.worker_objectives[w])
             for i, m in enumerate(ms)]
            for w, ms in enumerate(self.worker_initials)
        ]
        # the enumerate+fingerprint pass is deferred to the first step():
        # run_episode resets again, and the trainer builds engines it may
        # never step (rollout="per_worker"), so eager work here is wasted
        self._enumerated = False

    @property
    def done(self) -> bool:
        return all(s.steps_left <= 0 for slots in self.workers for s in slots)

    def _live(self, w: int) -> list[Slot]:
        return [s for s in self.workers[w] if s.steps_left > 0]

    def _pad_buffers(self, buffers: Sequence[ReplayBuffer | None] | None
                     ) -> Sequence[ReplayBuffer | None] | None:
        """Accept per-LIVE-worker buffer lists on a mesh-padded engine: the
        padding workers own no slots, so they can never write a transition —
        extend the list with ``None`` instead of making every caller care
        about the padded width."""
        if buffers is None or len(buffers) == self.n_workers:
            return buffers
        if len(buffers) != self.n_live_workers:
            raise ValueError(
                f"expected {self.n_live_workers} (live) or {self.n_workers} "
                f"(padded) buffers, got {len(buffers)}")
        return list(buffers) + [None] * (self.n_workers - self.n_live_workers)

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._pipeline_threads,
                thread_name_prefix="rollout-enum")
        return self._pool

    # ------------------------------------------------------------ #
    # candidate enumeration + fingerprinting
    # ------------------------------------------------------------ #
    def _enumerate_one(self, m: Molecule) -> list[Action]:
        return enumerate_actions(
            m,
            allow_removal=self.cfg.allow_removal,
            protect_oh=self.cfg.protect_oh,
            allowed_ring_sizes=self.cfg.allowed_ring_sizes,
            max_atoms=self.cfg.max_atoms,
        )

    def _record_incident(self, *, site: str, worker: int, slot: int,
                         key: str, error: str, action: str) -> None:
        with self._stats_lock:
            self.incidents.append(Incident(
                episode=self.episode_counter, step=self.n_env_steps,
                site=site, worker=worker, slot=slot, key=key,
                error=error, action=action))

    def _enum_or_failure(self, m: Molecule):
        """``_enumerate_one`` under the fault plan: retries transient chem
        faults in place (bit-identical — enumeration is pure), degrades a
        terminal fault to an :class:`_EnumFailure` sentinel instead of
        letting one molecule sink the whole batch.  Thread-safe and
        thread-order independent: injection keys on molecule content."""
        if self.fault_plan is None:
            return self._enumerate_one(m)
        key = m.canonical_key()
        attempt = 0
        while True:
            try:
                self.fault_plan.check_key("chem", key)
                return self._enumerate_one(m)
            except FaultError as e:
                return _EnumFailure(key=key, error=repr(e))
            except TransientFault as e:
                if attempt >= self.chem_retries:
                    return _EnumFailure(key=key, error=repr(e))
                attempt += 1
                with self._stats_lock:
                    self.n_chem_retries += 1

    def _quarantine(self, s: Slot, *, site: str, key: str, error: str) -> None:
        """Drain a faulted slot to dead: empty candidate set, in-flight
        transition completed with an empty successor (the double-DQN max
        values it at zero — identical to the no-legal-action death), and a
        structured incident on the operator trail.  The slot revives from
        the worker's start assignment at the next ``reset()``."""
        s.candidates = []
        s.cand_fps = np.zeros((0, FP_BITS), np.float32)
        s.cand_fps_packed = np.zeros((0, FP_BYTES), np.uint8)
        if s.pending is not None:
            s.pending.next_fps = s.cand_fps_packed
            s.pending.next_steps_left_frac = (s.steps_left - 1) / self.cfg.max_steps
        s.steps_left = 0
        with self._stats_lock:
            self.n_quarantined += 1
        self._record_incident(site=site, worker=s.worker, slot=s.index,
                              key=key, error=error, action="quarantined")

    def _compute_enum(self, mols: Sequence[Molecule]
                      ) -> list[tuple[Sequence[Action], np.ndarray, np.ndarray]]:
        """Pure per-molecule work: candidate actions, their fingerprints
        (dense f32 rows for the Q states) and the SAME rows bit-packed (what
        the replay successor sets store).  Thread-safe (reads molecules,
        builds fresh ones; the chem cache locks internally); per-slot
        results do not depend on how the molecule list is sharded across
        calls — cache hits return values identical to a fresh compute.
        """
        if self.chem == "incremental":
            return self._compute_enum_incremental(mols)
        t0 = time.perf_counter()
        cands = [self._enum_or_failure(m) for m in mols]
        t1 = time.perf_counter()
        # the full path materialises every candidate and recomputes every
        # fingerprint from scratch — the pinned reference behaviour.
        # Failed molecules carry their sentinel through; their siblings'
        # fingerprint batch is unchanged (composition-independent).
        flat = [a.result for acts in cands
                if not isinstance(acts, _EnumFailure) for a in acts]
        fps = batch_morgan_fingerprints(flat) if flat else \
            np.zeros((0, FP_BITS), np.float32)
        packed = pack_fps(fps)
        t2 = time.perf_counter()
        with self._stats_lock:
            self.chem_enum_s += t1 - t0
            self.chem_fp_s += t2 - t1
        out, off = [], 0
        for acts in cands:
            if isinstance(acts, _EnumFailure):
                out.append(acts)
                continue
            out.append((acts, fps[off:off + len(acts)],
                        packed[off:off + len(acts)]))
            off += len(acts)
        return out

    def _compute_enum_incremental(self, mols: Sequence[Molecule]
                                  ) -> list[tuple[Sequence[Action], np.ndarray, np.ndarray]]:
        """The tentpole path: fleet-wide ChemCache lookups short-circuit the
        whole per-parent chemistry; misses enumerate (delta descriptors) and
        derive all candidate fingerprints from ONE shared parent env-hash
        table per slot, batched across the miss slots."""
        cache = self.chem_cache
        t0 = time.perf_counter()
        out: list = [None] * len(mols)
        miss: list[int] = []
        for i, m in enumerate(mols):
            entry = cache.get(m) if cache is not None else None
            if entry is not None:
                out[i] = (entry.actions, None, entry.packed_fps)
            else:
                miss.append(i)
        # in-batch dedup (the PropertyService idiom): workers sharing a
        # concrete parent — e.g. every slot at episode start — enumerate it
        # ONCE per step and share the (immutable) results
        uniq: list[int] = []
        rep_of: dict[bytes, int] = {}
        dup_of: dict[int, int] = {}
        for i in miss:
            sig = molecule_signature(mols[i])
            if sig in rep_of:
                dup_of[i] = rep_of[sig]
            else:
                rep_of[sig] = i
                uniq.append(i)
        acts_by = [self._enum_or_failure(mols[i]) for i in uniq]
        t1 = time.perf_counter()
        # failed molecules keep their sentinel; only intact ones enter the
        # grouped fingerprint batch and the cache (all-or-nothing put)
        good = [(i, acts) for i, acts in zip(uniq, acts_by)
                if not isinstance(acts, _EnumFailure)]
        for i, acts in zip(uniq, acts_by):
            if isinstance(acts, _EnumFailure):
                out[i] = acts
        if good:
            fps_by = incremental_fingerprints_grouped(
                [mols[i] for i, _ in good], [acts for _, acts in good])
            for (i, acts), fps in zip(good, fps_by):
                packed = pack_fps(fps)
                if cache is not None:
                    cache.put(mols[i], acts, packed)
                out[i] = (acts, fps, packed)
        for i, rep in dup_of.items():
            out[i] = out[rep]   # duplicates share results AND failures
        # cache hits rebuild the dense rows from the packed bits (exact:
        # the fingerprints are {0,1}-valued) — unless the engine runs
        # packed acting, where nothing ever reads the dense rows and the
        # unpack would be the hot path's only host f32 materialisation
        if not self.packed_states:
            out = [res if isinstance(res, _EnumFailure) else
                   (res[0], unpack_fp(res[2]) if res[1] is None else res[1],
                    res[2])
                   for res in out]
        t2 = time.perf_counter()
        with self._stats_lock:
            self.chem_enum_s += t1 - t0
            self.chem_fp_s += t2 - t1
        return out

    def _apply_enum(self, slots: Sequence[Slot],
                    results: Sequence[tuple[Sequence[Action], np.ndarray, np.ndarray]]
                    ) -> None:
        """Install fresh candidate sets; complete pending transitions; kill
        slots with no legal action (their pending gets an empty successor
        set, which the double-DQN max values at zero).  A slot whose
        chemistry failed terminally (``_EnumFailure``) is quarantined —
        same empty-successor death, plus an incident record."""
        for s, res in zip(slots, results, strict=True):
            if isinstance(res, _EnumFailure):
                self._quarantine(s, site="chem", key=res.key, error=res.error)
                continue
            acts, fps, packed = res
            s.candidates = acts
            s.cand_fps = fps
            s.cand_fps_packed = packed
            if s.pending is not None:
                # successor candidates are exactly this step's candidates;
                # the packed rows are shared with the slot (replay copies)
                s.pending.next_fps = packed
                s.pending.next_steps_left_frac = (s.steps_left - 1) / self.cfg.max_steps
            if not acts:
                s.steps_left = 0  # nothing to act on: the episode ends here

    def _enumerate_all(self) -> None:
        """One candidate-enumeration + ONE fingerprint batch over every live
        slot of every worker (the reference, single-threaded pass)."""
        todo = [s for slots in self.workers for s in slots if s.steps_left > 0]
        if todo:
            self._apply_enum(todo, self._compute_enum([s.current for s in todo]))

    # ------------------------------------------------------------ #
    # step helpers shared by the reference and pipelined paths
    # ------------------------------------------------------------ #
    def _flush_ready(self, live_by_worker: Sequence[Sequence[Slot]],
                     buffers: Sequence[ReplayBuffer | None] | None) -> None:
        """Move completed pending transitions into the per-worker buffers."""
        if buffers is None:
            return
        for w, live in enumerate(live_by_worker):
            buf = buffers[w]
            if buf is None:
                continue
            ready = [s for s in live
                     if s.pending is not None and s.pending.next_fps is not None]
            buf.add_many(s.pending for s in ready)
            for s in ready:
                s.pending = None

    def _flush_dead(self, buffers: Sequence[ReplayBuffer | None] | None) -> None:
        """Flush completed pendings of slots that died mid-episode (no legal
        candidates) — no later step will ever visit them again."""
        if buffers is None:
            return
        for w, slots in enumerate(self.workers):
            buf = buffers[w]
            for s in slots:
                if (s.steps_left <= 0 and s.pending is not None
                        and s.pending.next_fps is not None):
                    if buf is not None:
                        buf.add(s.pending)
                    s.pending = None

    def _build_states(self, live_by_worker: Sequence[Sequence[Slot]]
                      ) -> list[np.ndarray]:
        """Per-worker candidate state matrices (fingerprint ++ steps-left)."""
        per_worker_states: list[np.ndarray] = []
        for live in live_by_worker:
            if not live:
                per_worker_states.append(np.zeros((0, STATE_DIM), np.float32))
                continue
            stacked = []
            for s in live:
                steps_after = (s.steps_left - 1) / self.cfg.max_steps
                col = np.full((s.cand_fps.shape[0], 1), steps_after, dtype=np.float32)
                stacked.append(np.concatenate([s.cand_fps, col], axis=1))
            per_worker_states.append(np.concatenate(stacked, axis=0))
        return per_worker_states

    def _build_states_packed(self, live_by_worker: Sequence[Sequence[Slot]]
                             ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Per-worker PACKED candidate states, straight from the slots'
        ``pack_fps`` planes: u8 ``[N_w, FP_BITS/8]`` bits + f32 ``[N_w]``
        steps-left columns.  The packed twin of ``_build_states`` — no
        dense f32 fingerprint buffer is materialised on the host (~32x
        fewer bytes per candidate row)."""
        bits_pw: list[np.ndarray] = []
        frac_pw: list[np.ndarray] = []
        for live in live_by_worker:
            if not live:
                bits_pw.append(np.zeros((0, FP_BYTES), np.uint8))
                frac_pw.append(np.zeros((0,), np.float32))
                continue
            bits_pw.append(live[0].cand_fps_packed if len(live) == 1 else
                           np.concatenate([s.cand_fps_packed for s in live]))
            frac_pw.append(np.concatenate([
                np.full((len(s.candidates),),
                        (s.steps_left - 1) / self.cfg.max_steps, np.float32)
                for s in live]))
        return bits_pw, frac_pw

    def _plan_selection(self, live_by_worker: Sequence[Sequence[Slot]],
                        policy) -> list[list[int]]:
        """Pre-draw every slot's eps-greedy decision (``plan_action``: the
        explored index, or -1 for argmax-when-Q-lands) in the reference
        worker-major slot order — the host-side half of action selection,
        run while the async Q dispatch is still in flight on device."""
        return [[policy.plan_action(len(s.candidates), w) for s in live]
                for w, live in enumerate(live_by_worker)]

    def _dispatch_q(self, live_by_worker: Sequence[Sequence[Slot]],
                    policy) -> tuple[Sequence[np.ndarray], list[list[int]] | None]:
        """One fleet Q dispatch in the policy's preferred representation
        (dense f32 reference, packed u8, or packed + pre-drawn plans)."""
        if getattr(policy, "wants_packed_states", False):
            bits_pw, frac_pw = self._build_states_packed(live_by_worker)
            if getattr(policy, "async_q", False):
                handle = policy.fleet_q_dispatch_packed(bits_pw, frac_pw)
                plans = self._plan_selection(live_by_worker, policy)
                return policy.fleet_q_fetch(handle), plans
            return policy.fleet_q_values_packed(bits_pw, frac_pw), None
        return policy.fleet_q_values(self._build_states(live_by_worker)), None

    def _select(self, live_by_worker: Sequence[Sequence[Slot]],
                q_by_worker: Sequence[np.ndarray], policy: FleetPolicy,
                plans: Sequence[Sequence[int]] | None = None
                ) -> list[tuple[Slot, Action, np.ndarray]]:
        """Per-worker eps-greedy selection from each worker's RNG stream.

        With ``plans`` (the async path) the RNG draws already happened in
        this exact slot order during ``_plan_selection``; only the greedy
        markers (-1) are resolved here, from the same ``np.argmax`` the
        sync branch uses.  The chosen tuple carries the PACKED fingerprint
        row — it becomes the replay ``state_fp`` without a repack."""
        chosen: list[tuple[Slot, Action, np.ndarray]] = []
        for w, live in enumerate(live_by_worker):
            q_all, off = q_by_worker[w], 0
            for i, s in enumerate(live):
                ln = len(s.candidates)
                if ln == 0:  # _apply_enum kills candidate-less slots
                    raise RuntimeError(
                        f"invariant violation: live slot (worker {w}, index "
                        f"{s.index}) reached selection with zero candidates")
                if plans is None:
                    a_idx = policy.select_action(q_all[off:off + ln], w)
                else:
                    a_idx = plans[w][i]
                    if a_idx < 0:
                        a_idx = int(np.argmax(q_all[off:off + ln]))
                off += ln
                chosen.append((s, s.candidates[a_idx], s.cand_fps_packed[a_idx]))
        return chosen

    def _predict_chosen(self, service, chosen):
        """Fleet property batch with per-molecule fault isolation.  The
        happy path is ONE ``service.predict`` over all chosen successors —
        bit-identical to the reference.  If that batch fails terminally
        (retries exhausted), each molecule is retried in isolation so one
        poisoned successor quarantines one slot, not the fleet; failed rows
        come back as ``None``."""
        mols = [a.result for _, a, _ in chosen]
        try:
            return service.predict(mols)
        except FaultError:
            props = []
            for (s, a, _), m in zip(chosen, mols, strict=True):
                try:
                    props.append(service.predict([m])[0])
                except FaultError as e:
                    props.append(None)
                    self._record_incident(
                        site="predict", worker=s.worker, slot=s.index,
                        key=m.canonical_key(), error=repr(e),
                        action="quarantined")
            return props

    def _resolve_objective(self, obj, worker: int):
        """Normalise a slot/fleet objective to what the reward layer
        evaluates: ``RewardConfig`` and callables (compiled objectives
        included) pass through; a raw ``ObjectiveSpec`` or a scenario
        registry NAME compiles lazily, memoised PER WORKER so the novelty
        term's visit counts persist across steps without leaking between
        workers."""
        if obj is None or isinstance(obj, (RewardConfig, CompiledObjective)):
            return obj
        if isinstance(obj, ObjectiveSpec) or isinstance(obj, str):
            key = (worker, obj)
            hit = self._compiled_objectives.get(key)
            if hit is None:
                spec = obj
                if isinstance(obj, str):
                    from repro_torch.configs.scenarios import get_scenario
                    spec = get_scenario(obj)
                hit = spec.compile()
                self._compiled_objectives[key] = hit
            return hit
        return obj

    def _reward_or_fault(self, obj, pr, initial, current, steps_left: int,
                         s: Slot):
        """One row through an arbitrary objective, isolated: a raising
        objective yields the ``_REWARD_FAULT`` marker plus a structured
        Incident instead of crashing the fleet (the slot quarantines in
        ``_apply_step``)."""
        try:
            return float(obj(pr, initial, current, steps_left))
        except Exception as e:  # noqa: BLE001 - user objectives raise anything
            self._record_incident(
                site="reward", worker=s.worker, slot=s.index,
                key=current.canonical_key(), error=repr(e),
                action="quarantined")
            return _REWARD_FAULT

    def _fleet_rewards(self, chosen, props, reward_cfg) -> list:
        """THE fleet-vectorized reward layer: one NumPy evaluation over
        the step's ``[W]`` property/state rows per distinct objective.

        Rows whose property row is ``None`` (terminal predict fault) are
        masked out — their slots quarantine in ``_apply_step``.  The
        remaining rows group by their RESOLVED objective (the slot's own
        ``Slot.objective`` wins over the fleet-wide ``reward_cfg``): a
        homogeneous fleet is exactly ONE ``evaluate_rewards`` call, a
        mixed fleet one vectorized call per scenario.  Per-group inputs
        keep the reference worker-major row order, so the stateful
        novelty term sees the same visit sequence as the scalar path.

        Returns one entry per chosen row: a float reward, ``None`` for a
        masked predict-fault row, or ``_REWARD_FAULT`` when the objective
        itself raised (satellite of the self-healing contract: a broken
        CUSTOM objective quarantines its slot, never the fleet)."""
        rewards: list = [None] * len(chosen)
        groups: dict[int, tuple[object, list[int]]] = {}
        for i, ((s, _act, _fp), pr) in enumerate(zip(chosen, props, strict=True)):
            if pr is None:
                continue
            obj = self._resolve_objective(
                s.objective if s.objective is not None else reward_cfg,
                s.worker)
            groups.setdefault(id(obj), (obj, []))[1].append(i)
        for obj, idx in groups.values():
            rows = [chosen[i] for i in idx]
            prs = [props[i] for i in idx]
            initials = [s.initial for s, _, _ in rows]
            # the reward sees the POST-step state: the chosen successor and
            # the decremented step budget (Action.result is memoised — this
            # is the very molecule _apply_step installs as s.current)
            currents = [a.result for _, a, _ in rows]
            sls = [s.steps_left - 1 for s, _, _ in rows]
            if isinstance(obj, RewardConfig):
                vals = evaluate_rewards(obj, prs, initials, currents, sls)
                for k, i in enumerate(idx):
                    rewards[i] = float(vals[k])
            elif isinstance(obj, CompiledObjective):
                try:
                    vals = obj.evaluate(prs, initials, currents, sls)
                except Exception:  # noqa: BLE001 - isolate the poisoned row
                    # re-run per row against consistent state (evaluate
                    # mutates nothing on a raise): only the poisoned rows
                    # quarantine, their group neighbours keep rewards
                    for k, i in enumerate(idx):
                        rewards[i] = self._reward_or_fault(
                            obj, prs[k], initials[k], currents[k], sls[k],
                            rows[k][0])
                else:
                    for k, i in enumerate(idx):
                        rewards[i] = float(vals[k])
            else:
                # arbitrary callable objective: per-row, isolated
                for k, i in enumerate(idx):
                    rewards[i] = self._reward_or_fault(
                        obj, prs[k], initials[k], currents[k], sls[k],
                        rows[k][0])
        return rewards

    def _apply_step(self, chosen, props, reward_cfg,
                    buffers) -> list[StepRecord]:
        """Commit the chosen actions: rewards, transitions, slot advance.
        A ``None`` property row (terminal predict fault, isolated by
        ``_predict_chosen``) quarantines its slot: no transition, no step
        record, episode over — revived at the next reset.  A
        ``_REWARD_FAULT`` row (the slot's objective raised inside the
        fleet reward layer) quarantines identically, with its
        ``site="reward"`` Incident already on the trail."""
        records: list[StepRecord] = []
        rewards = self._fleet_rewards(chosen, props, reward_cfg)
        for (s, act, fp), pr, reward in zip(chosen, props, rewards, strict=True):
            if pr is None:
                # the pending (if any) was already flushed at _begin_step,
                # so draining here loses no committed transition
                s.steps_left = 0
                with self._stats_lock:
                    self.n_quarantined += 1
                continue
            if reward is _REWARD_FAULT:
                s.steps_left = 0
                with self._stats_lock:
                    self.n_quarantined += 1
                continue
            s.current = act.result
            s.steps_left -= 1
            done = s.steps_left <= 0
            if s.best is None or reward > s.best[0]:
                s.best = (reward, s.current)
            t = Transition(
                # the chosen candidate's ALREADY-packed row (chem packed it
                # once, pack_fps contract) — no per-transition repack
                state_fp=fp,
                steps_left_frac=s.steps_left / self.cfg.max_steps,
                reward=reward,
                done=done,
                next_fps=np.zeros((0, FP_BYTES), dtype=np.uint8),
                next_steps_left_frac=0.0,
            )
            if done:
                buf = buffers[s.worker] if buffers is not None else None
                if buf is not None:
                    buf.add(t)               # terminal: no successor needed
            else:
                t.next_fps = None            # filled by the next enumerate
                s.pending = t
            records.append(StepRecord(
                slot=s.index, molecule=s.current, reward=reward,
                done=done, conformer_valid=pr.conformer_valid,
                bde=pr.bde, ip=pr.ip, worker=s.worker,
            ))
        return records

    def _begin_step(self, buffers) -> list[list[Slot]] | None:
        """Common step prologue: first-use enumeration, liveness, flush."""
        if not self._enumerated:
            self._enumerate_all()
            self._enumerated = True
        live_by_worker = [self._live(w) for w in range(self.n_workers)]
        if not any(live_by_worker):
            return None
        self.n_env_steps += 1
        self._flush_ready(live_by_worker, buffers)
        return live_by_worker

    # ------------------------------------------------------------ #
    def step(
        self,
        policy,
        service,
        reward_cfg: "RewardConfig | ObjectiveSpec | object",
        buffers: Sequence[ReplayBuffer | None] | None = None,
    ) -> list[StepRecord]:
        """One lockstep step for every live slot of every worker.

        This is the CORRECTNESS REFERENCE implementation — strictly
        sequential, no overlap.  ``step_pipelined`` must stay
        transition-identical to it (tests/test_rollout.py)."""
        policy = as_fleet_policy(policy)
        buffers = self._pad_buffers(buffers)
        live_by_worker = self._begin_step(buffers)
        if live_by_worker is None:
            return []

        # ---- ONE Q dispatch over all candidates of all workers -------- #
        q_by_worker, plans = self._dispatch_q(live_by_worker, policy)

        # ---- per-worker eps-greedy selection --------------------------- #
        chosen = self._select(live_by_worker, q_by_worker, policy, plans)

        # ---- ONE property batch over the chosen successors fleet-wide -- #
        props = self._predict_chosen(service, chosen)

        records = self._apply_step(chosen, props, reward_cfg, buffers)
        self._enumerate_all()
        self._flush_dead(buffers)
        return records

    def _enum_shard(self, mols: Sequence[Molecule]):
        """One pipelined shard, run on a pool thread.  The fault plan's
        ``pipeline`` site models the thread itself dying mid-shard."""
        if self.fault_plan is not None:
            self.fault_plan.check_call("pipeline")
        return self._compute_enum(mols)

    def _submit_enum(self, pairs: Sequence[tuple[Slot, Molecule]]) -> list:
        """Shard ``(slot, successor)`` chemistry across the host pool.
        Returns ``(future, shard_molecules)`` pairs so the supervisor
        (``_collect_enum``) can re-run a crashed shard inline."""
        if not pairs:
            return []
        pool = self._get_pool()
        mols = [m for _, m in pairs]
        shard = -(-len(mols) // self._pipeline_threads)
        return [(pool.submit(self._enum_shard, mols[i:i + shard]),
                 mols[i:i + shard])
                for i in range(0, len(mols), shard)]

    def _collect_enum(self, shards) -> list:
        """Supervised harvest of the pipelined shards: a shard whose thread
        died (injected ``pipeline`` fault) is re-run inline on the calling
        thread — per-shard chemistry is composition-independent and pure,
        so the restarted results are bit-identical to what the dead thread
        would have produced."""
        results: list = []
        for fut, mols in shards:
            try:
                results.extend(fut.result())
            except (TransientFault, FaultError) as e:
                with self._stats_lock:
                    self.n_pipeline_restarts += 1
                self._record_incident(
                    site="pipeline", worker=-1, slot=-1, key="",
                    error=repr(e), action="restarted")
                results.extend(self._compute_enum(mols))
        return results

    def step_pipelined(
        self,
        policy,
        service,
        reward_cfg: "RewardConfig | ObjectiveSpec | object",
        buffers: Sequence[ReplayBuffer | None] | None = None,
    ) -> list[StepRecord]:
        """``step()`` with the host/device overlap: after action selection,
        step t+1's candidate enumeration + fingerprinting is sharded across
        host threads while the fleet property batch runs.  Both depend only
        on the selected actions, not on each other, so the transition
        stream is identical to the reference.

        With an ``async_q`` packed policy the overlap additionally covers
        the Q round-trip itself: the dispatch returns a device handle
        without blocking, the eps-greedy decisions are pre-drawn
        (``_plan_selection``, identical RNG order), and the EXPLORING
        survivors' next-step chemistry — their successors are known before
        any Q value is — starts on the pool while the device still
        computes.  Only then does the fetch block.  Per-slot chemistry
        results are composition-independent (pinned by the chem matrix),
        so splitting the enumeration batch changes nothing downstream."""
        policy = as_fleet_policy(policy)
        buffers = self._pad_buffers(buffers)
        live_by_worker = self._begin_step(buffers)
        if live_by_worker is None:
            return []

        early: list[tuple[Slot, Molecule]] = []
        if getattr(policy, "wants_packed_states", False) and \
                getattr(policy, "async_q", False):
            bits_pw, frac_pw = self._build_states_packed(live_by_worker)
            handle = policy.fleet_q_dispatch_packed(bits_pw, frac_pw)
            plans = self._plan_selection(live_by_worker, policy)
            early = [(s, s.candidates[p].result)
                     for w, live in enumerate(live_by_worker)
                     for s, p in zip(live, plans[w])
                     if p >= 0 and s.steps_left - 1 > 0]
            early_futs = self._submit_enum(early)
            q_by_worker = policy.fleet_q_fetch(handle)
        else:
            q_by_worker, plans = self._dispatch_q(live_by_worker, policy)
            early_futs = []
        chosen = self._select(live_by_worker, q_by_worker, policy, plans)

        # slots still alive after this step, in the reference enumeration
        # order (worker-major, slot order); their successors' candidates are
        # what the end-of-step enumeration would compute.  Exploring slots
        # already submitted above (Action.result is memoised, so the chosen
        # molecule is the very object the early chemistry enumerated).
        early_slots = {id(s) for s, _ in early}
        nxt = [(s, a.result) for s, a, _ in chosen
               if s.steps_left - 1 > 0 and id(s) not in early_slots]
        futures = self._submit_enum(nxt)

        props = self._predict_chosen(service, chosen)
        records = self._apply_step(chosen, props, reward_cfg, buffers)

        if early_futs:
            self._apply_enum([s for s, _ in early],
                             self._collect_enum(early_futs))
        if futures:
            self._apply_enum([s for s, _ in nxt],
                             self._collect_enum(futures))
        self._flush_dead(buffers)
        return records

    # ------------------------------------------------------------ #
    def run_episode(
        self,
        policy,
        service,
        reward_cfg: "RewardConfig | ObjectiveSpec | object",
        buffers: Sequence[ReplayBuffer | None] | None = None,
        pipelined: bool = False,
    ) -> list[StepRecord]:
        """Reset + roll a full fleet episode; returns ALL step records.

        ``reset()`` is also the REVIVAL hook: slots quarantined by faults
        last episode were drained to dead, and here they are rebuilt from
        the worker's start assignment (``set_initial_molecules`` — the
        dataset cursor's per-episode draw) exactly like any other slot —
        a revived fleet is indistinguishable from a fresh one."""
        self.episode_counter += 1
        self.reset()
        step = self.step_pipelined if pipelined else self.step
        all_recs: list[StepRecord] = []
        while not self.done:
            all_recs.extend(step(policy, service, reward_cfg, buffers))
        return all_recs

    # ------------------------------------------------------------ #
    # continuous-batching slot control (the serving router's hooks)
    # ------------------------------------------------------------ #
    def bind_slot(self, worker: int, molecule: Molecule, steps_left: int,
                  objective=None) -> Slot:
        """Install a FRESH episode in one worker's slot batch without
        touching any sibling — the serving tier's continuous-batching
        rebind: a finished/dead/reclaimed slot is immediately handed the
        next queued request while co-batched slots keep stepping.

        The new slot's candidates are enumerated right here (a one-slot
        chemistry batch — per-slot chemistry is composition-independent,
        so this is bit-identical to enumerating it with the fleet), which
        means a poisoned start molecule quarantines at bind time exactly
        like a mid-episode chem fault: Incident + empty candidate set,
        siblings untouched.  ``objective`` (a ``RewardConfig`` or callable)
        overrides the fleet reward for this slot only."""
        if not 0 <= worker < self.n_live_workers:
            raise ValueError(
                f"worker {worker} out of range [0, {self.n_live_workers})")
        s = Slot(worker=worker, index=0, initial=molecule, current=molecule,
                 steps_left=int(steps_left), objective=objective)
        self.workers[worker] = [s]
        self.worker_initials[worker] = [molecule]
        if self._enumerated:
            self._apply_enum([s], self._compute_enum([molecule]))
        else:
            # first bind on a fresh engine: bring every pre-existing live
            # slot in with the same deferred pass the first step() would run
            self._enumerated = True
            self._enumerate_all()
        return s

    def kill_slot(self, worker: int) -> None:
        """Reclaim a worker's slots NOW (deadline passed, request
        cancelled): drop any in-flight transition and stop acting.  The
        dense batch simply loses the rows — jit shapes are unchanged and
        siblings never notice (the ragged-fleet contract)."""
        for s in self.workers[worker]:
            s.pending = None
            s.steps_left = 0

    # ------------------------------------------------------------ #
    def chem_stats(self) -> dict:
        """Host-chemistry accounting: enumeration / fingerprint seconds and
        (incremental mode) the fleet-wide cache hit statistics."""
        st = {
            "mode": self.chem,
            "enum_s": self.chem_enum_s,
            "fp_s": self.chem_fp_s,
            "env_steps": self.n_env_steps,
        }
        if self.chem_cache is not None:
            st.update(self.chem_cache.stats())
        return st

    def fault_stats(self) -> dict:
        """Self-healing accounting: quarantines, in-place retries,
        supervised pipeline restarts, and the structured incident trail."""
        with self._stats_lock:
            return {
                "n_quarantined": self.n_quarantined,
                "n_chem_retries": self.n_chem_retries,
                "n_pipeline_restarts": self.n_pipeline_restarts,
                "n_incidents": len(self.incidents),
                "incidents": [i.as_dict() for i in self.incidents],
            }

    def reset_chem_stats(self) -> None:
        self.chem_enum_s = 0.0
        self.chem_fp_s = 0.0
        if self.chem_cache is not None:
            self.chem_cache.reset_stats()

    # ------------------------------------------------------------ #
    def final_molecules(self, worker: int | None = None) -> list[Molecule]:
        slots = self.workers[worker] if worker is not None else \
            [s for ws in self.workers for s in ws]
        return [s.current for s in slots]

    def best_molecules(self, worker: int | None = None) -> list[tuple[float, Molecule]]:
        slots = self.workers[worker] if worker is not None else \
            [s for ws in self.workers for s in ws]
        return [s.best if s.best is not None else (-np.inf, s.current) for s in slots]
