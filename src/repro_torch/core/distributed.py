"""Port of ``repro.core.distributed``: the DA-MolDQN trainer on a device
mesh.

N workers, each owning a batch of start molecules and a private replay
buffer, cooperate on ONE general model.  The two synchronisation regimes
of the reference:

* ``sync_mode="step"``    — MT-MolDQN/DDP: gradients are averaged across
  workers at every optimiser step (parameters stay replicated);
* ``sync_mode="episode"`` — DA-MolDQN: every worker updates its own
  parameters, and parameters and Adam moments are averaged once per
  episode boundary.

The mesh (``launch/mesh.py``) is the reference's single-controller
program: this one process owns every worker's environment, replay buffer
and RNG stream, and only the device state is split.  Worker state is
stacked along a padded ``[W_pad, ...]`` axis and cut into ``nd`` shards;
shard ``s`` holds workers ``shard_slices(W_pad, mesh)[s]`` — parameters,
target and Adam state, ``[W_pad / nd, ...]`` each — on ``mesh.devices[s]``.
A fleet whose W does not divide the mesh pads to it with DEAD worker slots
(``padded_worker_count``): they own no molecules and ship zero batches,
their gradients are zero, yet they take every Adam step and receive every
sync and step-mode mean update, as the reference's masked ``shard_map``
bodies do, so a padded checkpoint holds the reference's rows.  With no mesh
the trainer runs one shard on ``device``, and ``params``, ``target_params``
and ``opt_state`` are that shard's own ``[W, ...]`` tensors; at nd > 1 they
are gathered read-only copies on the mesh's first device.

Both averages are ``_fleet_mean``: every shard's rows gathered onto one
device, dead rows left out, summed in worker order from +0 and divided by
the live count, as the reference's ``fleet_mean`` (``all_gather`` + one
full-axis reduction) is.  The reduction order never depends on nd.  A
shard's workers take their update together, in runs of rows sized from
the shapes (``_chunk_rows``): one batched double-DQN gradient over the
run's stacked parameters and batches, then one fused Adam step
(``stacked_adam``) of the run's rows, every worker on its own parameters,
batch and step.  nd changes how many rows a run holds, so a run at nd = 2
or 4 is bit-identical to nd = 1 where a batched product gives a row the
same bits whatever the run's length (``_MIN_RUN``): checked on the CPU,
and on an H100 at the paper's widths and batch.

Acting is host-driven through ``RolloutEngine``: every environment step is
one Q dispatch over every worker's candidates and one property batch.  A
fleet dispatch (``"fleet"``, ``"fleet_sharded"`` and ``"fleet_pipelined"``
alike) copies each shard's ``[W_pad / nd, C, ...]`` rows from one pinned
host buffer to its device and launches the hand-written CUDA
``packed_qnet_stacked`` kernel on that shard's own parameters: nd launches
a dispatch, all enqueued before the one fetch, so shards on distinct cards
overlap.  ``acting="packed"`` and ``"packed_async"`` read u8 fingerprint
planes; ``"dense"`` reads f32 rows through the same kernel's dense loader
(``dense_qnet_stacked``), with the same bits.  On the CPU the wrappers run
their plain versions.  ``rollout="per_worker"`` dispatches each worker's
rows through ``fused_qnet`` on its shard's device; ``"fleet_pipelined"``
adds the engine's double-buffered host step.

Learning is the reference's double-DQN loss with the hand-ported Adam
(``optim/adam.py``) under ``TrainerConfig.learner``: ``"dense"`` ships
host-densified f32 batches, ``"packed"`` ships u8 planes and densifies on
each shard's device (``packed_batch.densify_batch``), and
``"packed_pipelined"`` draws update k+1's packed batch on a sampler thread
while update k runs.  All three give the same batches, so the same losses
and parameters.  The learner's products are batched matmuls under
``torch.func.vmap`` over ``dqn_loss`` (f32), differentiated by autograd;
the reference leaves them to XLA and has no kernel there.  Adam is the
hand-written CUDA ``stacked_adam``, ``optim/adam.py``'s formulas over the
stacked leaves.

``state_dict`` / ``load_state_dict`` gather the shards into the
reference's checkpoint layout (``[W_pad, ...]`` leaves) and scatter them
back, so a resumed run is bit-identical to one that never stopped and a
checkpoint crosses between the packages.  ``greedy_optimize`` and
``optimization_failure_rate`` are the paper's evaluation of the general
model (Eq. 2); their Q dispatches go through ``DQNAgent.q_values`` and so
through ``fused_qnet``.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np
import torch
from torch.func import vmap

from repro_torch.chem.chemcache import ChemCache
from repro_torch.chem.molecule import Molecule
from repro_torch.core.agent import (
    DQNAgent, DQNConfig, Layers, QNetwork, candidate_capacity,
    candidate_capacity_table, dqn_loss, flat, unflat,
)
from repro_torch.core.env import BatchedEnv, EnvConfig, StepRecord
from repro_torch.core.jit_stats import note_shape_event
from repro_torch.core.packed_batch import densify_batch, packed_nbytes
from repro_torch.core.replay import FP_BYTES, ReplayBuffer
from repro_torch.core.reward import RewardConfig
from repro_torch.core.rollout import CHEM_MODES, STATE_DIM, RolloutEngine
from repro_torch.core.spans import SpanRecorder
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_qnet.ops import fused_qnet
from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                 packed_qnet_stacked)
from repro_torch.kernels.stacked_adam import build as stacked_adam_build
from repro_torch.kernels.stacked_adam.ops import stacked_adam
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import (HostMesh, make_host_mesh,
                                     padded_worker_count, shard_slices)
from repro_torch.optim.adam import OptState

ROLLOUT_MODES = ("fleet", "fleet_sharded", "fleet_pipelined", "per_worker")
_FLEET_MODES = ("fleet", "fleet_sharded", "fleet_pipelined")
LEARNER_MODES = ("packed", "packed_pipelined", "dense")
# replay sampling (core.replay.SAMPLING_MODES): "uniform" is the reference
# path; "prioritized" is proportional PER with |TD| feedback after every
# update.  With all-equal effective priorities (priority_alpha = 0)
# prioritized is bit-identical to uniform: same RNG stream, unit weights.
REPLAY_MODES = ("uniform", "prioritized")
# fleet acting-batch representation, all transition-identical:
#   "packed"        u8 bit planes straight from the slots' cand_fps_packed
#   "packed_async"  packed + the async Q protocol: the dispatch returns a
#                   handle, eps-greedy decisions are pre-drawn, and the
#                   fetch is the one synchronisation point
#   "dense"         [W, C, STATE_DIM] f32 rows, the correctness reference
ACTING_MODES = ("packed", "packed_async", "dense")
# What one stacked learner step may hold in temporaries: the widest layer's
# output over its rows' next states, twice while its bias and ReLU run, or
# its rows' gradients, whichever is larger.  At the paper's shapes (B 32 x
# C 64 next states, width 1024: 16.8 MB a worker) that is 128 workers, far
# under the densified batch's own transient.
_CHUNK_BYTES = 2 << 30
# Rows a stacked learner step computes at least.  BLAS takes a batched
# product of fewer matrices down other paths (split-K on cuBLAS, one
# threaded product on the CPU) whose sums run in other orders, so a shorter
# run is padded with copies of its rows: a worker's bits must not depend on
# how many rows share its step (one worker a shard at nd = 4 against four
# at nd = 1).  On an H100 at the paper's widths and B 32 x C 64, runs of
# every length from 4 to 127 rows agree with a run of 128 bit for bit
# (``chip_smoke.py``'s mesh phase); on the CPU runs of 2 or more.  Other
# widths and batches on the card are not checked.
_MIN_RUN = 4


@dataclass(frozen=True)
class TrainerConfig:
    n_workers: int = 4
    mols_per_worker: int = 4          # "Modification Batch" (Table 1)
    episodes: int = 250               # general model (Table 1)
    sync_mode: str = "episode"        # "episode" (DA-MolDQN) | "step" (DDP)
    rollout: str = "fleet"            # see ROLLOUT_MODES (module docstring)
    learner: str = "packed"           # see LEARNER_MODES (module docstring)
    acting: str = "packed"            # see ACTING_MODES (fleet modes only;
                                      # per_worker always acts dense)
    chem: str = "incremental"         # candidate chemistry: rollout.CHEM_MODES
                                      # ("full" = per-step recompute reference)
    updates_per_episode: int = 4
    train_batch_size: int = 32        # <= Table 2's 512 cap
    max_candidates: int = 64          # replay target max truncation
    replay_capacity: int = 4000       # Table 3
    replay: str = "uniform"           # replay sampling: see REPLAY_MODES
    priority_alpha: float = 0.6       # PER proportional exponent (0 = flat)
    priority_beta0: float = 0.4       # importance-weight anneal start
    priority_beta_episodes: int | None = None  # episodes for beta -> 1.0
                                               # (None: cfg.episodes)
    priority_eps: float = 1e-3        # |TD| priority floor
    dataset: str | None = None        # multi-start episode stream: draw each
                                      # episode's start molecules from a
                                      # seeded data.datasets cursor (DATASETS
                                      # name); None = fixed ctor molecules
    dataset_size: int | None = None   # pool size (None: dataset default)
    dataset_seed: int | None = None   # pool+cursor seed (None: cfg.seed)
    scenarios: tuple[str, ...] | None = None
                                      # heterogeneous scenario fleet: worker w
                                      # optimises scenarios[w % len]; None =
                                      # every worker runs reward_cfg
    pipeline_threads: int | None = None  # fleet_pipelined host pool (None: auto)
    dqn: DQNConfig = field(default_factory=lambda: DQNConfig(epsilon_decay=0.97))
    env: EnvConfig = field(default_factory=EnvConfig)
    seed: int = 0


def _spanned(name: str):
    """Method decorator: each call is one span ``name`` of the trainer's
    recorder; the method's frame, and what it alone holds (a round's batch,
    a run's autograd graph), is freed inside the span."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            with self._trace.span(name):
                return fn(self, *args, **kwargs)
        return call
    return wrap


def _worker_layers(layers: Layers, w: int) -> Layers:
    """Worker ``w``'s ``[(w [in, out], b [out])]`` views of stacked layers."""
    return [(wt[w], bt[w]) for wt, bt in layers]


def _runs(n: int, cap: int) -> list[slice]:
    """``range(n)`` cut into the fewest runs of at most ``cap`` rows, their
    lengths as even as possible."""
    k = -(-n // cap)
    return [slice(n * i // k, n * (i + 1) // k) for i in range(k)]


def _loss_grad(leaves: list[torch.Tensor], target: list[torch.Tensor],
               batch: dict[str, torch.Tensor], discount: float):
    """Each row's ``dqn_loss`` on its own parameters, target and batch
    (stacked ``[n, ...]`` leaves and ``[n, B, ...]`` batch): its gradients
    (``[n, ...]`` a leaf), its loss ``[n]`` and |TD| ``[n, B]``.  The
    per-worker formula runs under ``vmap``, so every product is one
    batched matmul over the rows; a row's loss reads only its own rows, so
    the gradient of the summed losses is each row's own.  (``torch.func``'s
    ``grad`` would do the same, but its first call imports ``torch._dynamo``:
    3 s of set-up.)"""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss, td = vmap(lambda l, t, b: dqn_loss(unflat(l), unflat(t), b, discount))(
        leaves, target, batch)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return list(grads), loss.detach(), td


def _rows_of(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` stacked copies of ``x`` in fresh memory (never a view of
    ``x``: shards on one device must not share storage)."""
    return x.unsqueeze(0).repeat((n,) + (1,) * x.dim())


@dataclass
class _Shard:
    """One mesh shard: padded workers ``rows`` resident on ``device`` as
    ``[W_pad / nd, ...]`` stacks."""
    device: torch.device
    rows: slice
    params: Layers
    target: Layers
    opt: OptState

    def opt_leaves(self) -> list[torch.Tensor]:
        return [self.opt.step] + list(self.opt.mu) + list(self.opt.nu)


class _WorkerView:
    """Adapter giving BatchedEnv the per-worker agent interface (the
    sequential path: one ``fused_qnet`` launch per worker per step, on the
    worker's shard)."""

    def __init__(self, trainer: "DistributedTrainer", w: int):
        self.t = trainer
        self.w = w

    def q_values(self, states: np.ndarray) -> np.ndarray:
        self.t.n_q_dispatches += 1
        sh, i = self.t._locate(self.w)
        x = torch.from_numpy(np.ascontiguousarray(states, np.float32))
        q = fused_qnet(_worker_layers(sh.params, i), x.to(sh.device))
        return q.cpu().numpy()

    def select_action(self, q: np.ndarray) -> int:
        return self.t._select_action(q, self.w)


class _QHandle:
    """An in-flight fleet Q dispatch: the host array (on the CPU it is
    computed already), the per-worker counts, and on the card one
    ``(done, events)`` pair per shard: the event that fires once the
    shard's Q is back in the pinned output, and the CUDA events that time
    its copy in and its kernel."""

    def __init__(self, q_host: np.ndarray | None, counts: list[int],
                 pending: list | None = None):
        self.q_host, self.counts, self.pending = q_host, counts, pending


class _FleetView:
    """FleetPolicy over the trainer's stacked per-worker parameters: ONE
    kernel launch per shard evaluates that shard's workers' candidates
    under each worker's own parameters.

    The candidate axis is padded to a rung of the capacity ladder
    (``candidate_capacity_table``) and the host batch buffer, ``[W_pad, C,
    ...]`` for the whole fleet, is a sticky high-water mark, as in the
    reference; the kernel masks nothing past the buffer, and the padded
    rows (dead workers' included) are zero planes.  On the card the host
    buffers are pinned; each shard's copy in, its launch and the copy of
    its Q back into the pinned output are queued with ``non_blocking=True``
    on its device's stream, every shard before any wait, and
    ``fleet_q_fetch`` waits on each shard's event: the only
    synchronisation point of a dispatch, and what keeps the engine from
    rewriting the host buffer under a copy.  CUDA events time each shard's
    copy in and kernel (``dispatch_timing`` sums the shards).
    """

    def __init__(self, trainer: "DistributedTrainer", acting: str = "dense"):
        self.t = trainer
        self.acting = acting
        # engine-facing protocol switches (see rollout.FleetPolicy)
        self.wants_packed_states = acting != "dense"
        self.async_q = acting == "packed_async"
        self._table = candidate_capacity_table(trainer.cfg.n_workers)
        self._host: list[torch.Tensor] = []   # dense, or bits + frac
        self._q_out: torch.Tensor | None = None
        self._cap = 0
        self.h2d_ms = 0.0
        self.kernel_ms = 0.0
        self.n_timed = 0

    def _alloc(self, shape, dtype) -> torch.Tensor:
        pin = self.t.device.type == "cuda"
        return torch.zeros(shape, dtype=dtype, pin_memory=pin)

    def reserve(self, max_candidates: int) -> None:
        """Pre-grow the batch buffers (ladder-rounded)."""
        cap = candidate_capacity(max_candidates, self._table)
        if cap > self._cap:
            self._cap = cap
            W = self.t.n_padded_workers
            if self.wants_packed_states:
                self._host = [self._alloc((W, cap, FP_BYTES), torch.uint8),
                              self._alloc((W, cap), torch.float32)]
            else:
                self._host = [self._alloc((W, cap, STATE_DIM), torch.float32)]
            self._q_out = self._alloc((W, cap), torch.float32)
            note_shape_event("fleet_view")

    def warm_dispatch(self) -> None:
        """Run the current capacity once (builds the kernel at first use)."""
        n = self.t.engine.n_workers
        if self.wants_packed_states:
            self.fleet_q_fetch(self.fleet_q_dispatch_packed(
                [np.zeros((1, FP_BYTES), np.uint8)] * n,
                [np.zeros((1,), np.float32)] * n))
        else:
            self.fleet_q_values([np.zeros((1, STATE_DIM), np.float32)] * n)

    def _dispatch(self, counts: list[int]) -> _QHandle:
        t = self.t
        t.n_q_dispatches += 1
        t.acting_h2d_bytes += sum(h.numel() * h.element_size() for h in self._host)
        kernel = packed_qnet_stacked if self.wants_packed_states \
            else dense_qnet_stacked
        if t.device.type != "cuda":
            q = [kernel(sh.params, *[h[sh.rows] for h in self._host])
                 for sh in t._shards]
            return _QHandle(torch.cat(q).numpy(), counts)
        pending = []
        for sh in t._shards:     # every shard enqueued before any wait
            stream = torch.cuda.current_stream(sh.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.cuda.device(sh.device):
                ev[0].record(stream)
                xs = [h[sh.rows].to(sh.device, non_blocking=True)
                      for h in self._host]
                ev[1].record(stream)
                q = kernel(sh.params, *xs)
                ev[2].record(stream)
                self._q_out[sh.rows].copy_(q, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            pending.append((done, ev))
        return _QHandle(None, counts, pending)

    # ---- dense reference ---------------------------------------- #
    def fleet_q_values(self, per_worker: list[np.ndarray]) -> list[np.ndarray]:
        counts = [x.shape[0] for x in per_worker]
        if not any(counts):
            return [np.zeros((0,), np.float32) for _ in per_worker]
        self.reserve(max(counts))
        dense = self._host[0].numpy()   # never sliced down: shapes only grow
        for w, x in enumerate(per_worker):
            dense[w, : x.shape[0]] = x
            dense[w, x.shape[0]:] = 0.0  # clear rows left by the last step
        return self.fleet_q_fetch(self._dispatch(counts))

    # ---- packed protocol (rollout.FleetPolicy) ------------------- #
    def fleet_q_dispatch_packed(self, bits_pw: list[np.ndarray],
                                frac_pw: list[np.ndarray]) -> _QHandle:
        """Copy the per-worker planes into the sticky buffers and dispatch
        without waiting for the result."""
        counts = [b.shape[0] for b in bits_pw]
        if not any(counts):
            return _QHandle(None, counts)
        self.reserve(max(counts))
        bits, frac = (h.numpy() for h in self._host)
        for w, (b, f) in enumerate(zip(bits_pw, frac_pw)):
            n = b.shape[0]
            bits[w, :n] = b
            bits[w, n:] = 0   # dead/finished rows: zero planes, never garbage
            frac[w, :n] = f
            frac[w, n:] = 0.0
        return self._dispatch(counts)

    def fleet_q_fetch(self, handle: _QHandle) -> list[np.ndarray]:
        """Wait for every shard of the dispatch and slice its Q back per
        worker."""
        if handle.pending is None and handle.q_host is None:
            return [np.zeros((0,), np.float32) for _ in handle.counts]
        qh = handle.q_host
        if handle.pending is not None:
            for done, ev in handle.pending:
                done.synchronize()
                self.h2d_ms += ev[0].elapsed_time(ev[1])
                self.kernel_ms += ev[1].elapsed_time(ev[2])
            self.n_timed += 1
            qh = self._q_out.numpy()
        return [qh[w, :n].copy() for w, n in enumerate(handle.counts)]

    def fleet_q_values_packed(self, bits_pw: list[np.ndarray],
                              frac_pw: list[np.ndarray]) -> list[np.ndarray]:
        return self.fleet_q_fetch(self.fleet_q_dispatch_packed(bits_pw, frac_pw))

    def plan_action(self, n_candidates: int, worker: int) -> int:
        return self.t._plan_action(n_candidates, worker)

    def select_action(self, q: np.ndarray, worker: int) -> int:
        return self.t._select_action(q, worker)


class DistributedTrainer:
    """Trains ONE general model over many molecules with W workers on a
    device mesh.

    ``network`` supplies the architecture and the initial weights every
    worker starts from (like a DDP broadcast); None builds a He-normal
    ``QNetwork`` from ``cfg.seed``.  Parity tests pass the reference's
    worker-0 parameters through ``params_from_jax``.  ``mesh=None`` is one
    shard on ``device``; ``device=None`` is the GPU and raises without one.
    With a mesh, ``device`` may be left out or must be its first device.
    """

    def __init__(
        self,
        cfg: TrainerConfig,
        molecules: list[Molecule] | None,
        service,
        reward_cfg: RewardConfig,
        network: QNetwork | None = None,
        dataset_pool: list[Molecule] | None = None,
        fault_plan=None,
        device: str | torch.device | None = None,
        mesh: HostMesh | None = None,
    ):
        if mesh is None:
            mesh = make_host_mesh(1, device=device)
        elif device is not None and resolve_device(device) != mesh.devices[0]:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.devices[0]}")
        if len({d.type for d in mesh.devices}) != 1:
            raise ValueError(f"a mesh spans one device type, got {mesh.devices}")
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.cfg = cfg
        self.service = service
        self.reward_cfg = reward_cfg
        self.fault_plan = fault_plan
        W = cfg.n_workers
        need = W * cfg.mols_per_worker

        # multi-start dataset streaming: with cfg.dataset set, every episode
        # draws its start molecules from a seeded DatasetStream cursor on
        # the host, before any rollout-mode branch
        self._dataset_stream = None
        if cfg.dataset is not None:
            if molecules is not None:
                raise ValueError(
                    "pass molecules=None when cfg.dataset streams the "
                    "episode starts (the fixed batch would be ignored)")
            from repro_torch.data.datasets import DatasetStream, load_dataset
            pool = dataset_pool if dataset_pool is not None else load_dataset(
                cfg.dataset, count=cfg.dataset_size, seed=cfg.dataset_seed)
            dseed = cfg.seed if cfg.dataset_seed is None else cfg.dataset_seed
            self._dataset_stream = DatasetStream(pool, seed=dseed)
            # episode-0 placeholder (rollout_episode re-draws first)
            molecules = [pool[i % len(pool)] for i in range(need)]
        elif molecules is None:
            raise ValueError("molecules=None requires cfg.dataset")
        if len(molecules) < need:
            raise ValueError(f"need {need} molecules for {W}x{cfg.mols_per_worker}, got {len(molecules)}")
        self.molecules = molecules[:need]
        self.start_log: list[tuple[str, ...]] = []  # per-episode start keys

        # fleets that do not divide the mesh pad to it with DEAD worker
        # slots (a W = 6 fleet on 4 shards trains as W_pad = 8); the live
        # workers' transitions, losses and parameters equal the unpadded
        # run's
        self.n_live_workers = W
        self.n_padded_workers = padded_worker_count(W, mesh)

        if cfg.rollout not in ROLLOUT_MODES:
            raise ValueError(f"rollout must be one of {ROLLOUT_MODES}, got {cfg.rollout!r}")
        if cfg.learner not in LEARNER_MODES:
            raise ValueError(f"learner must be one of {LEARNER_MODES}, got {cfg.learner!r}")
        if cfg.sync_mode not in ("episode", "step"):
            raise ValueError(f"sync_mode must be 'episode' or 'step', got {cfg.sync_mode!r}")
        if cfg.chem not in CHEM_MODES:
            raise ValueError(f"chem must be one of {CHEM_MODES}, got {cfg.chem!r}")
        if cfg.acting not in ACTING_MODES:
            raise ValueError(f"acting must be one of {ACTING_MODES}, got {cfg.acting!r}")
        if cfg.replay not in REPLAY_MODES:
            raise ValueError(f"replay must be one of {REPLAY_MODES}, got {cfg.replay!r}")

        if hasattr(service, "reserve"):
            service.reserve(W * cfg.mols_per_worker)

        # ONE chemistry cache for the whole trainer
        self.chem_cache = ChemCache() if cfg.chem == "incremental" else None
        self.engine = RolloutEngine(
            [self.molecules[w * cfg.mols_per_worker : (w + 1) * cfg.mols_per_worker]
             for w in range(W)],
            cfg.env, pipeline_threads=cfg.pipeline_threads,
            chem=cfg.chem, chem_cache=self.chem_cache,
            pad_workers_to=self.n_padded_workers,
            packed_states=cfg.acting != "dense",
            fault_plan=fault_plan)
        # heterogeneous scenario fleet: one compiled objective per worker,
        # the same instances for the engine and the per_worker envs
        self.worker_objectives = None
        self.scenario_names: tuple[str, ...] | None = None
        if cfg.scenarios:
            from repro_torch.configs.scenarios import (
                compile_worker_objectives, worker_scenarios)
            base = reward_cfg if isinstance(reward_cfg, RewardConfig) else None
            self.scenario_names = tuple(worker_scenarios(cfg.scenarios, W))
            self.worker_objectives = compile_worker_objectives(
                cfg.scenarios, W, base=base)
            self.engine.set_worker_objectives(self.worker_objectives)
        self._envs: list[BatchedEnv] | None = None  # built lazily
        self.buffers = [ReplayBuffer(cfg.replay_capacity, seed=cfg.seed + 200 + w,
                                     max_candidates=cfg.max_candidates,
                                     sampling=cfg.replay,
                                     priority_alpha=cfg.priority_alpha,
                                     priority_eps=cfg.priority_eps)
                        for w in range(W)]
        self._worker_rngs = [np.random.default_rng(cfg.seed + 300 + w) for w in range(W)]
        self.n_q_dispatches = 0    # acting-side kernel dispatches (both paths)
        self.n_updates = 0         # learner update steps issued
        self.h2d_update_bytes = 0  # host->device bytes shipped by update batches
        self.acting_h2d_bytes = 0  # host->device bytes shipped by fleet Q batches
        # host spans and the worker-update counter (``trace_stats``)
        self._trace = SpanRecorder()
        self._sampler_pool: ThreadPoolExecutor | None = None  # packed_pipelined

        # stacked per-worker parameters, [W_pad / nd, ...] per shard: every
        # worker, dead slots included, starts from the same weights
        if network is None:
            network = QNetwork(generator=torch.Generator().manual_seed(cfg.seed),
                               device="cpu")
        self._shards: list[_Shard] = []
        for dev, rows in zip(mesh.devices,
                             shard_slices(self.n_padded_workers, mesh)):
            n = rows.stop - rows.start
            params = [tuple(_rows_of(t.detach().to(dev, torch.float32), n)
                            for t in wb) for wb in network.layers()]
            self._shards.append(_Shard(
                dev, rows, params, self._copy(params),
                OptState(step=torch.zeros(n, dtype=torch.int32, device=dev),
                         mu=[torch.zeros_like(t) for t in flat(params)],
                         nu=[torch.zeros_like(t) for t in flat(params)])))
        if self.device.type == "cuda":   # nvcc runs while the replays fill
            stacked_adam_build.nvcc_build().start()

        self.epsilon = cfg.dqn.epsilon_initial
        self.episode = 0
        self.loss_log: list[float] = []
        self.reward_log: list[float] = []
        self._views = [_WorkerView(self, w) for w in range(W)]
        self._fleet_policy = _FleetView(self, acting=cfg.acting)

    @staticmethod
    def _copy(layers: Layers) -> Layers:
        return [(w.clone(), b.clone()) for w, b in layers]

    def _locate(self, w: int) -> tuple[_Shard, int]:
        """The shard holding padded worker ``w``, and its row there."""
        per = self.n_padded_workers // self.mesh.size
        return self._shards[w // per], w % per

    def _gather(self, leaves_of) -> list[torch.Tensor]:
        """``leaves_of(shard)``'s leaves as ``[W_pad, ...]`` tensors: the
        shard's own tensors on one shard, else copies concatenated on the
        mesh's first device."""
        if len(self._shards) == 1:
            return list(leaves_of(self._shards[0]))
        parts = [leaves_of(sh) for sh in self._shards]
        return [torch.cat([p[k].to(self.device) for p in parts])
                for k in range(len(parts[0]))]

    @property
    def params(self) -> Layers:
        """The stacked ``[W_pad, ...]`` parameters (read-only at nd > 1)."""
        return unflat(self._gather(lambda sh: flat(sh.params)))

    @property
    def target_params(self) -> Layers:
        return unflat(self._gather(lambda sh: flat(sh.target)))

    @property
    def opt_state(self) -> OptState:
        leaves = self._gather(_Shard.opt_leaves)
        n = (len(leaves) - 1) // 2
        return OptState(step=leaves[0], mu=leaves[1:1 + n], nu=leaves[1 + n:])

    @property
    def envs(self) -> list[BatchedEnv]:
        """Per-worker single-worker envs for the ``per_worker`` rollout,
        built on first access."""
        if self._envs is None:
            cfg = self.cfg
            self._envs = [
                BatchedEnv(
                    self.molecules[w * cfg.mols_per_worker : (w + 1) * cfg.mols_per_worker],
                    cfg.env, chem=cfg.chem, chem_cache=self.chem_cache)
                for w in range(cfg.n_workers)
            ]
        return self._envs

    # ------------------------------------------------------------ #
    # cross-worker means and the update bodies
    # ------------------------------------------------------------ #
    def _mean_rows(self, rows) -> torch.Tensor:
        """The live workers' rows, given in worker order on any devices:
        summed on the mesh's first device from +0, divided by the live
        count."""
        rows = list(rows)
        acc = torch.zeros_like(rows[0], device=self.device)
        for r in rows:
            acc = acc + r.to(self.device)
        return acc / self.n_live_workers

    def _fleet_mean(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Mean over the live workers of one leaf held as per-shard
        ``[W_pad / nd, ...]`` parts: gathered, dead rows left out, reduced
        in worker order, so the bits do not depend on nd."""
        rows = (p[i] for p in parts for i in range(p.shape[0]))
        return self._mean_rows(r for _, r in zip(range(self.n_live_workers), rows))

    def _sync(self, leaves_of) -> list[list[torch.Tensor]]:
        """Per shard, ``leaves_of(shard)`` with every row, dead rows
        included, set to the leaf's fleet mean."""
        per_shard = [leaves_of(sh) for sh in self._shards]
        out = [[] for _ in self._shards]
        for k in range(len(per_shard[0])):
            mean = self._fleet_mean([p[k] for p in per_shard])
            for s, sh in enumerate(self._shards):
                out[s].append(_rows_of(mean.to(sh.device),
                                       per_shard[s][k].shape[0]))
        return out

    @_spanned("trainer.sync")
    def _sync_episode(self) -> None:
        """Average parameters and Adam moments across the workers; keep
        every worker's int step."""
        params = self._sync(lambda sh: flat(sh.params))
        moments = self._sync(lambda sh: list(sh.opt.mu) + list(sh.opt.nu))
        for sh, p, m in zip(self._shards, params, moments):
            n = len(p)
            sh.params = unflat(p)
            sh.opt = OptState(step=sh.opt.step, mu=m[:n], nu=m[n:])

    def _chunk_rows(self, batch: dict[str, torch.Tensor]) -> int:
        """Rows of one stacked step: as many as keep its temporaries under
        ``_CHUNK_BYTES`` (see there), at least one."""
        nxt = batch["next_fps"]
        layers = self._shards[0].params
        width = max(w.shape[-1] for w, _ in layers)
        n_params = sum(t[0].numel() for t in flat(layers))
        per_row = nxt.element_size() * max(
            2 * (nxt[0].numel() // nxt.shape[-1]) * width, n_params)
        return max(1, _CHUNK_BYTES // per_row)

    @_spanned("trainer.stacked_grad")
    def _stacked_grad(self, sh: _Shard, rows: slice,
                      batch: dict[str, torch.Tensor]):
        """The losses ``[n]``, |TD| ``[n, B]`` and gradients (``[n, ...]`` a
        leaf) of shard ``sh``'s ``rows``, each on its own parameters and
        batch, in one batched step (``_loss_grad``); a run shorter than
        ``_MIN_RUN`` is computed with copies of its rows after it."""
        self._trace.count("trainer.stacked_chunks")
        n = rows.stop - rows.start
        if n >= _MIN_RUN:
            take = lambda t: t[rows]
        else:
            pad = torch.arange(_MIN_RUN, device=sh.device) % n + rows.start
            take = lambda t: t[pad]
        grads, loss, td = _loss_grad(
            [take(t) for t in flat(sh.params)],
            [take(t) for t in flat(sh.target)],
            {k: take(v) for k, v in batch.items()}, self.cfg.dqn.discount)
        return loss[:n], td[:n], [g[:n] for g in grads]

    @_spanned("trainer.stacked_adam")
    def _stacked_adam(self, sh: _Shard, rows: slice,
                      grads: list[torch.Tensor]) -> None:
        """One Adam step of shard ``sh``'s ``rows`` on ``grads``
        (``[n, ...]`` a leaf, or one row expanded), written in place into
        the shard's stacked parameters, moments and steps."""
        cut = lambda ts: [t[rows] for t in ts]
        dqn = self.cfg.dqn
        stacked_adam(cut(flat(sh.params)), grads, cut(sh.opt.mu),
                     cut(sh.opt.nu), sh.opt.step[rows], lr=dqn.lr,
                     clip=dqn.grad_clip)

    @_spanned("trainer.update")
    def _update_once(self, batches: list[dict[str, torch.Tensor]], packed: bool):
        """One optimiser step under the configured sync mode from one batch
        dict per shard (``_ship``); returns the per-worker ``(loss [W_pad],
        |td| [W_pad, B])`` on the mesh's first device, zero on dead rows.

        Each shard's live rows take their step in runs of ``_chunk_rows``:
        one batched gradient a run, then (episode mode) one Adam step of
        its rows.  A dead worker computes nothing: its gradient is zero,
        but it still takes its Adam step (episode mode) or the fleet's mean
        update (step mode), as the reference's masked update bodies do.
        Step mode means the live rows' gradients in worker order and steps
        every row on that mean."""
        if packed:
            with self._trace.span("trainer.densify"):
                batches = [densify_batch(b) for b in batches]
        step_mode = self.cfg.sync_mode == "step"
        cap = self._chunk_rows(batches[0])
        losses, tds, grads = [], [], []
        for sh, batch in zip(self._shards, batches):
            n = sh.rows.stop - sh.rows.start
            live = min(n, max(0, self.n_live_workers - sh.rows.start))
            for rows in _runs(live, cap):
                loss, td, g = self._stacked_grad(sh, rows, batch)
                losses.append(loss.to(self.device))
                tds.append(td.to(self.device))
                if step_mode:
                    grads.append(g)
                else:
                    self._stacked_adam(sh, rows, g)
            if live < n:
                losses.append(torch.zeros(n - live, device=self.device))
                tds.append(torch.zeros(n - live, batch["rewards"].shape[1],
                                       device=self.device))
                if not step_mode:
                    dead = slice(live, n)
                    self._stacked_adam(sh, dead, [
                        torch.zeros_like(t[0]).expand_as(t[dead])
                        for t in flat(sh.params)])
        del batches, batch
        if step_mode:
            gmean = [self._mean_rows(r for g in gs for r in g)
                     for gs in zip(*grads)]
            del grads
            for sh in self._shards:
                n = sh.rows.stop - sh.rows.start
                self._stacked_adam(sh, slice(0, n), [
                    m.to(sh.device).expand((n,) + m.shape) for m in gmean])
        self.n_updates += 1
        self._trace.count("trainer.worker_updates", self.n_live_workers)
        return torch.cat(losses), torch.cat(tds)

    # ------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------ #
    def train_episode(self) -> dict:
        """One paper episode: rollouts on all workers, local training
        updates, then (episode mode) the parameter sync."""
        cfg = self.cfg
        with self._trace.span("trainer.rollout"):
            records = self.rollout_episode()

        losses = []
        min_fill = min(len(b) for b in self.buffers)
        if min_fill >= cfg.train_batch_size:
            losses = self.run_updates(cfg.updates_per_episode)

        if cfg.sync_mode == "episode":
            self._sync_episode()

        self.episode += 1
        if self.episode % cfg.dqn.target_update_episodes == 0:
            for sh in self._shards:
                sh.target = self._copy(sh.params)
        self.epsilon = max(self.epsilon * cfg.dqn.epsilon_decay, cfg.dqn.epsilon_min)

        flat_recs = [r for recs in records for r in recs]
        final = [r for r in flat_recs if r.done]
        n_invalid = sum(1 for r in flat_recs if not r.conformer_valid)
        st = {
            "episode": self.episode,
            "mean_final_reward": float(np.mean([r.reward for r in final])) if final else float("nan"),
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": self.epsilon,
            "invalid_conformer_rate": n_invalid / max(len(flat_recs), 1),
        }
        self.loss_log.append(st["loss"])
        self.reward_log.append(st["mean_final_reward"])
        return st

    def rollout_episode(self) -> list[list[StepRecord]]:
        """One full acting episode for every worker, grouped per worker.

        The fleet modes drive the RolloutEngine: all workers advance in
        lockstep with one Q dispatch + one property batch per step
        (``fleet_pipelined`` additionally overlaps next-step chemistry with
        the property batch).  ``per_worker`` replays the paper's sequential
        per-process loop.  All paths draw from the same per-worker RNG
        streams, so they produce identical transitions."""
        W = self.cfg.n_workers
        if self._dataset_stream is not None:
            self._assign_starts(
                self._dataset_stream.draw(W * self.cfg.mols_per_worker))
        if self.cfg.rollout in _FLEET_MODES:
            flat_recs = self.engine.run_episode(
                self._fleet_policy, self.service, self.reward_cfg,
                self.buffers, pipelined=self.cfg.rollout == "fleet_pipelined")
            records: list[list[StepRecord]] = [[] for _ in range(W)]
            for r in flat_recs:
                records[r.worker].append(r)
            return records
        records = []
        for w, env in enumerate(self.envs):
            rc = self.worker_objectives[w] \
                if self.worker_objectives is not None else self.reward_cfg
            recs = env.run_episode(self._views[w], self.service, rc,
                                   self.buffers[w])
            for r in recs:  # single-worker envs stamp worker=0; fix up
                r.worker = w
            records.append(recs)
        return records

    def _assign_starts(self, molecules: list[Molecule]) -> None:
        """Install one episode's start molecules in the fleet engine and
        drop the per-worker envs for lazy rebuild; log the schedule."""
        cfg = self.cfg
        self.molecules = list(molecules)
        self.engine.set_initial_molecules(
            [self.molecules[w * cfg.mols_per_worker : (w + 1) * cfg.mols_per_worker]
             for w in range(cfg.n_workers)])
        self._envs = None
        self.start_log.append(tuple(m.iso_key() for m in self.molecules))

    @property
    def candidate_capacity(self) -> int:
        """Current candidate-axis capacity of the fleet view (0 until the
        first dispatch or ``reserve_candidates``)."""
        return 0 if self.cfg.rollout == "per_worker" else self._fleet_policy._cap

    def reserve_candidates(self, max_candidates: int) -> None:
        """Pre-grow the fleet view's candidate capacity (ladder-rounded)
        and run it once; bumps ``n_q_dispatches`` once if it grows.  No-op
        for the per_worker path."""
        if self.cfg.rollout == "per_worker":
            return
        view = self._fleet_policy
        before = view._cap
        view.reserve(max_candidates)
        if view._cap != before:
            view.warm_dispatch()

    def dispatch_timing(self) -> dict | None:
        """Mean host-to-device copy and kernel milliseconds per fleet Q
        dispatch (CUDA events, warm-up included); None off the GPU."""
        v = self._fleet_policy
        if not v.n_timed:
            return None
        return {"dispatches": v.n_timed, "h2d_ms": v.h2d_ms / v.n_timed,
                "kernel_ms": v.kernel_ms / v.n_timed}

    def trace_stats(self) -> dict[str, dict]:
        """Totals since construction of the trainer's host spans and
        counters (``core/spans.py``): ``{"seconds", "calls", "counts"}``.

        Spans: ``trainer.updates`` (``run_updates``) holds
        ``trainer.sample``, ``trainer.ship``, ``trainer.update`` and
        ``trainer.loss_read``; ``trainer.update`` (``_update_once``) holds
        ``trainer.densify``, ``trainer.stacked_grad`` (one run of live
        rows: its batched loss and gradients, enqueued) and
        ``trainer.stacked_adam`` (one Adam launch: a run's rows in episode
        mode, a shard's dead rows, or a shard's rows on the fleet's mean
        in step mode); ``trainer.rollout`` and ``trainer.sync`` are
        ``train_episode``'s.  Counters ``trainer.worker_updates``: live
        worker updates; ``trainer.stacked_chunks``: runs of live rows, so
        rows a stacked step = worker updates / stacked chunks."""
        return self._trace.snapshot()

    def _select_action(self, q: np.ndarray, w: int) -> int:
        """Decaying eps-greedy from worker ``w``'s private RNG stream."""
        rng = self._worker_rngs[w]
        if rng.random() < self.epsilon:
            return int(rng.integers(0, q.shape[0]))
        return int(np.argmax(q))

    def _plan_action(self, n_candidates: int, w: int) -> int:
        """The pre-draw half of ``_select_action`` for the async acting
        path: consume worker ``w``'s RNG stream exactly as
        ``_select_action`` would, without Q; return the explored index, or
        -1 for argmax once Q lands."""
        rng = self._worker_rngs[w]
        if rng.random() < self.epsilon:
            return int(rng.integers(0, n_candidates))
        return -1

    # ------------------------------------------------------------ #
    # learner: replay sampling + update dispatch (LEARNER_MODES)
    # ------------------------------------------------------------ #
    def _beta(self) -> float:
        """PER importance-weight exponent, annealed ``priority_beta0 -> 1``
        over ``priority_beta_episodes`` (default: the full run)."""
        cfg = self.cfg
        horizon = cfg.priority_beta_episodes or cfg.episodes
        frac = min(1.0, self.episode / max(1, horizon))
        return cfg.priority_beta0 + (1.0 - cfg.priority_beta0) * frac

    def _sample_kwargs(self) -> dict:
        if self.cfg.replay == "prioritized":
            return {"beta": self._beta()}
        return {}

    def _stack(self, per: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        """Stack the live workers' samples to ``[W_pad, B, ...]``: dead
        workers get all-zero batches."""
        if self.n_padded_workers != self.n_live_workers:
            zero = {k: np.zeros_like(v) for k, v in per[0].items()}
            per = per + [zero] * (self.n_padded_workers - self.n_live_workers)
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    @_spanned("trainer.sample")
    def _stacked_sample_np(self) -> dict[str, np.ndarray]:
        """One dense float32 sample per worker buffer, stacked ``[W_pad, B,
        ...]``."""
        kw = self._sample_kwargs()
        return self._stack(
            [b.sample(self.cfg.train_batch_size, self.cfg.max_candidates, **kw)
             for b in self.buffers])

    @_spanned("trainer.sample")
    def _stacked_sample_packed_np(self) -> dict[str, np.ndarray]:
        """u8 planes + scalars per worker buffer, stacked ``[W_pad, B,
        ...]``: the same seeded draws as ``_stacked_sample_np``."""
        kw = self._sample_kwargs()
        return self._stack(
            [b.sample_packed(self.cfg.train_batch_size, self.cfg.max_candidates,
                             **kw)
             for b in self.buffers])

    @_spanned("trainer.ship")
    def _ship(self, host_batch: dict[str, np.ndarray]
              ) -> list[dict[str, torch.Tensor]]:
        """One batch dict per shard, on its device (``shard_batch``)."""
        self.h2d_update_bytes += packed_nbytes(host_batch)
        return shard_batch(host_batch, self.mesh)

    def _apply_priorities(self, td: torch.Tensor) -> None:
        """Feed the update's ``[W_pad, B]`` |TD| back into the live
        workers' buffers."""
        td_host = td.cpu().numpy()
        for w, buf in enumerate(self.buffers):
            buf.update_priorities(td_host[w])

    @_spanned("trainer.loss_read")
    def _loss_scalar(self, loss: torch.Tensor) -> float:
        """Scalar loss over the live workers of a ``[W_pad]`` loss vector;
        the host waits here for the round's device work."""
        return float(loss.cpu().numpy()[: self.n_live_workers].mean())

    def _get_sampler(self) -> ThreadPoolExecutor:
        if self._sampler_pool is None:
            self._sampler_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="replay-sample")
        return self._sampler_pool

    @_spanned("trainer.updates")
    def run_updates(self, n: int) -> list[float]:
        """``n`` optimiser steps from the replay buffers under
        ``cfg.learner``.  ``packed_pipelined`` draws update k+1's batch on
        the sampler thread while update k runs (sound because nothing
        writes the buffers between updates and one thread drains each
        buffer's RNG stream in order).  Prioritized replay runs every mode
        sequentially: update k's |TD| must reprioritise the buffers before
        batch k+1 is drawn."""
        if n <= 0:
            return []
        mode = self.cfg.learner
        prioritized = self.cfg.replay == "prioritized"
        if mode != "packed_pipelined" or prioritized:
            packed = mode != "dense"
            losses = []
            for _ in range(n):
                host = self._stacked_sample_packed_np() if packed \
                    else self._stacked_sample_np()
                loss, td = self._update_once(self._ship(host), packed=packed)
                if prioritized:
                    self._apply_priorities(td)
                losses.append(self._loss_scalar(loss))
            return losses
        pool = self._get_sampler()
        fut = pool.submit(self._stacked_sample_packed_np)
        device_losses = []
        for k in range(n):
            host_batch = fut.result()
            if k + 1 < n:
                fut = pool.submit(self._stacked_sample_packed_np)
            device_losses.append(
                self._update_once(self._ship(host_batch), packed=True)[0])
        return [self._loss_scalar(l) for l in device_losses]

    def train(self, episodes: int | None = None, log_every: int = 0) -> list[dict]:
        stats = []
        for _ in range(episodes or self.cfg.episodes):
            st = self.train_episode()
            stats.append(st)
            if log_every and st["episode"] % log_every == 0:
                print(f"[ep {st['episode']}] reward {st['mean_final_reward']:.3f} "
                      f"loss {st['loss']:.4f} eps {st['epsilon']:.3f}")
        return stats

    def close(self) -> None:
        """Stop the sampler thread, if one was started."""
        if self._sampler_pool is not None:
            self._sampler_pool.shutdown(wait=True)
            self._sampler_pool = None

    # ------------------------------------------------------------ #
    # checkpoint / resume (bit-exact)
    # ------------------------------------------------------------ #
    # Everything a continued run's bits depend on, at an EPISODE BOUNDARY:
    # the three stacked device trees, every worker's action RNG, every
    # replay buffer ring (priorities included — their sample RNG rides in
    # the buffer state), the dataset cursor, the episode counter (which
    # alone positions the target-update cadence and the PER beta anneal)
    # and the exact epsilon float.  NOT state: the engine (rebuilt from the
    # start assignment every reset), the chemistry cache and property
    # memo (pure deterministic memos — they change speed, never bits), and
    # the fleet view's sticky pinned buffers.  The stacked trees are
    # gathered from the shards into ``[W_pad, ...]`` leaves, dead rows
    # included, and scattered back on load: a checkpoint of a padded fleet
    # restores only into a mesh that pads it to the same W_pad.
    #
    # The keys are the reference's, so a checkpoint crosses between the
    # packages: ``params/{i}``, ``target/{i}`` and ``opt/{i}`` number the
    # leaves of the reference's trees in ``jax.tree_util`` order — each
    # layer's ``b`` before its ``w`` (sorted dict keys), and ``opt`` is
    # ``step``, then every ``mu`` leaf, then every ``nu`` leaf.

    def _config_fingerprint(self) -> str:
        """Canonical JSON of the full TrainerConfig — a resume against a
        DIFFERENT config is an operator error, caught loudly at load."""
        import dataclasses
        import json

        def enc(o):
            if isinstance(o, frozenset):
                return sorted(o)
            raise TypeError(f"unserialisable config field: {o!r}")
        return json.dumps(dataclasses.asdict(self.cfg), sort_keys=True,
                          default=enc)

    def _ckpt_trees(self) -> dict[str, tuple[list[torch.Tensor], list[int]]]:
        """Per checkpoint tree, a fresh list of the gathered ``[W_pad, ...]``
        tensors and the indices into it in the reference's leaf order."""
        p = self._gather(lambda sh: flat(sh.params))
        n = len(p)
        b_w = [i + j for i in range(0, n, 2) for j in (1, 0)]
        return {
            "params": (p, b_w),
            "target": (self._gather(lambda sh: flat(sh.target)), b_w),
            "opt": (self._gather(_Shard.opt_leaves),
                    [0] + [1 + k for k in b_w] + [1 + n + k for k in b_w]),
        }

    def state_dict(self) -> dict[str, np.ndarray]:
        """Flat ``{key: array}`` snapshot of the complete training state
        (``repro_torch.checkpoint.save_flat`` layout, the reference's
        keys)."""
        import json
        from repro_torch.checkpoint.checkpoint import rng_state_to_array
        flat_state: dict[str, np.ndarray] = {}
        flat_state["meta/config"] = np.frombuffer(
            self._config_fingerprint().encode(), np.uint8).copy()
        flat_state["meta/episode"] = np.asarray(self.episode, np.int64)
        flat_state["meta/epsilon"] = np.asarray(self.epsilon, np.float64)
        flat_state["meta/n_updates"] = np.asarray(self.n_updates, np.int64)
        flat_state["meta/loss_log"] = np.asarray(self.loss_log, np.float64)
        flat_state["meta/reward_log"] = np.asarray(self.reward_log, np.float64)
        flat_state["meta/start_log"] = np.frombuffer(json.dumps(
            [list(t) for t in self.start_log]).encode(), np.uint8).copy()
        for w, rng in enumerate(self._worker_rngs):
            flat_state[f"rng/worker_{w}"] = rng_state_to_array(rng)
        for name, (ts, order) in self._ckpt_trees().items():
            for i, j in enumerate(order):
                flat_state[f"{name}/{i}"] = ts[j].detach().to(
                    "cpu", copy=True).numpy()
        for w, buf in enumerate(self.buffers):
            for k, v in buf.state_dict().items():
                flat_state[f"replay/{w}/{k}"] = v
        if self._dataset_stream is not None:
            for k, v in self._dataset_stream.state_dict().items():
                flat_state[f"dataset/{k}"] = v
        if self.worker_objectives is not None:
            # scenario objectives carry mutable state (novelty visit
            # counts) — snapshot it per worker so a resumed mixed fleet
            # keeps the exact intrinsic-bonus schedule
            for w, obj in enumerate(self.worker_objectives):
                flat_state[f"scenario/{w}"] = np.frombuffer(json.dumps(
                    obj.state_dict(), sort_keys=True).encode(),
                    np.uint8).copy()
        return flat_state

    def load_state_dict(self, flat_state) -> None:
        """Restore a :meth:`state_dict` snapshot (the port's or the
        reference's); the continued run is bit-identical to one that never
        stopped.  Each shard's rows of a leaf land on its device,
        contiguous, in the dtype of the live tensor they replace."""
        import json
        from repro_torch.checkpoint.checkpoint import (
            CheckpointError, rng_state_from_array)
        got = bytes(np.asarray(flat_state["meta/config"], np.uint8)).decode()
        want = self._config_fingerprint()
        if got != want:
            raise CheckpointError(
                "checkpoint was written under a different TrainerConfig — "
                "resume requires the identical configuration")
        trees = self._ckpt_trees()
        for name, (ts, order) in trees.items():
            for i, j in enumerate(order):
                key, ref = f"{name}/{i}", ts[j]
                if key not in flat_state:
                    raise CheckpointError(f"checkpoint missing leaf {key!r}")
                arr = np.asarray(flat_state[key])
                if tuple(arr.shape) != tuple(ref.shape):
                    raise CheckpointError(
                        f"leaf {key!r}: checkpoint shape {arr.shape} != "
                        f"live shape {tuple(ref.shape)}")
                ts[j] = torch.from_numpy(np.array(arr)).to(ref.dtype)
        (p, _), (t, _), (opt, _) = (trees[k] for k in ("params", "target", "opt"))
        n = len(p)
        for sh in self._shards:
            p_s, t_s, o_s = ([x[sh.rows].to(sh.device).contiguous() for x in ts]
                             for ts in (p, t, opt))
            sh.params, sh.target = unflat(p_s), unflat(t_s)
            sh.opt = OptState(step=o_s[0], mu=o_s[1:1 + n], nu=o_s[1 + n:])
        self.episode = int(flat_state["meta/episode"])
        self.epsilon = float(flat_state["meta/epsilon"])
        self.n_updates = int(flat_state["meta/n_updates"])
        self.loss_log = [float(x) for x in
                         np.asarray(flat_state["meta/loss_log"], np.float64)]
        self.reward_log = [float(x) for x in
                           np.asarray(flat_state["meta/reward_log"], np.float64)]
        self.start_log = [tuple(x) for x in json.loads(
            bytes(np.asarray(flat_state["meta/start_log"], np.uint8)).decode())]
        for w in range(len(self._worker_rngs)):
            self._worker_rngs[w] = rng_state_from_array(
                flat_state[f"rng/worker_{w}"])
        for w, buf in enumerate(self.buffers):
            prefix = f"replay/{w}/"
            sub = {k[len(prefix):]: v for k, v in flat_state.items()
                   if k.startswith(prefix)}
            if not sub:
                raise CheckpointError(f"checkpoint missing replay state "
                                      f"for worker {w}")
            buf.load_state_dict(sub)
        if self._dataset_stream is not None:
            sub = {k[len("dataset/"):]: v for k, v in flat_state.items()
                   if k.startswith("dataset/")}
            if not sub:
                raise CheckpointError(
                    "trainer streams episode starts but the checkpoint "
                    "carries no dataset cursor")
            self._dataset_stream.load_state_dict(sub)
        if self.worker_objectives is not None:
            # cfg.scenarios rides the config fingerprint, so a matching
            # checkpoint always carries every worker's scenario state
            for w, obj in enumerate(self.worker_objectives):
                key = f"scenario/{w}"
                if key not in flat_state:
                    raise CheckpointError(
                        f"trainer runs a scenario fleet but the checkpoint "
                        f"carries no objective state for worker {w}")
                obj.load_state_dict(json.loads(
                    bytes(np.asarray(flat_state[key], np.uint8)).decode()))

    def save_checkpoint(self, manager, step: int | None = None) -> int:
        """Snapshot into a ``repro_torch.checkpoint.CheckpointManager``
        (flat layout); returns the step label (default: the episode
        counter)."""
        label = self.episode if step is None else int(step)
        manager.save(label, self.state_dict(), flat=True)
        return label

    def restore_checkpoint(self, manager, step: int | None = None) -> int:
        """Load the latest (or given) snapshot from a manager; returns the
        restored episode counter."""
        _, flat_state = manager.restore_flat(step)
        self.load_state_dict(flat_state)
        return self.episode

    # ------------------------------------------------------------ #
    # evaluation / export
    # ------------------------------------------------------------ #
    def mean_params(self) -> Layers:
        """The general model: worker-averaged ``[(w [in, out], b [out])]``
        over the live workers, on the mesh's first device."""
        n = len(self._shards[0].params)
        return [tuple(self._fleet_mean([sh.params[l][k] for sh in self._shards])
                      for k in (0, 1)) for l in range(n)]

    def as_agent(self, epsilon: float = 0.0, seed: int = 1234) -> DQNAgent:
        """Materialise the general model as a single-model DQNAgent."""
        layers = self._shards[0].params
        net = QNetwork(hidden=[w.shape[2] for w, _ in layers[:-1]],
                       in_dim=layers[0][0].shape[1], device=self.device,
                       layers=self.mean_params())
        agent = DQNAgent(replace(self.cfg.dqn, epsilon_initial=epsilon),
                         seed=seed, network=net, device=self.device)
        agent.epsilon = epsilon
        return agent


def greedy_optimize(
    agent: DQNAgent,
    molecules: list[Molecule],
    service,
    reward_cfg: RewardConfig,
    env_cfg: EnvConfig = EnvConfig(),
    seed: int = 0,
) -> list[StepRecord]:
    """Greedy (eps as configured in ``agent``) rollout over a molecule
    batch; returns final-step records — the paper's 'optimize the N
    antioxidants with the trained model' evaluation."""
    env = BatchedEnv(molecules, env_cfg, seed=seed)
    last: list[StepRecord] = []
    while not env.done:
        recs = env.step(agent, service, reward_cfg, buffer=None)
        if recs:
            last = recs
    return last


def optimization_failure_rate(records: list[StepRecord], *, bde_max: float = 76.0,
                              ip_min: float = 145.0) -> float:
    """Eq. 2: OFR = 1 - S/A (success = BDE < 76 and IP > 145)."""
    if not records:
        return 1.0
    ok = sum(
        1 for r in records
        if r.bde is not None and r.ip is not None and r.bde < bde_max and r.ip > ip_min
    )
    return 1.0 - ok / len(records)
