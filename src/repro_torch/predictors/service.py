"""Port of ``repro.predictors.service``: the RL loop's view of the two
predictors (+ cache).

Responsibilities, mirroring §3.3/§3.6:

* features: molecule -> padded graph arrays (+ pseudo-conformer geometry);
* batched inference with shape bucketing (predictors are shared by all
  molecules in a worker's modification batch — the paper's stated reason
  for batched modification);
* the LRU cache, keyed by isomorphism-invariant hashes;
* the invalid-conformer protocol: molecules with no valid 3D conformer get
  ``ip = None`` (the environment maps that to reward -1000);
* molecules with no O-H bond get ``bde = None`` (protected actions should
  make this unreachable from valid starts).

``PropertyService.predict`` is the ONLY property entry point the RL core
uses, so predictor-call counting here gives the §3.6 cache statistics.
On the card each predictor batch is one host-to-device copy of one packed
pinned buffer, one forward of each model under ``torch.inference_mode()``
and one copy back.  The padding ladder (``capacity_table``) keeps the
batch shapes few, as it bounds the reference's jit compiles; the LRU cache
makes a molecule's first predicted value sticky, whatever batch shape a
later visit would have given it.

Beside it: ``OracleService``, the deterministic stub backed by the
chemistry oracles; ``DegradedPropertyService``, the last-known-good tier a
tripped circuit breaker serves from; ``RetryPolicy`` and
``ResilientService``, bounded retries with seeded backoff and an optional
per-call timeout around any property service.  Because every wrapped
predictor is deterministic, a retried batch is bit-identical to a
first-try batch.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.faults import FaultError, FaultTimeout, TransientFault

from repro_torch.chem.conformer import CONFORMER_FEATURE_DIM, conformer_features, has_valid_conformer
from repro_torch.chem.molecule import ATOM_FEATURE_DIM, MAX_BOND_ORDER, Molecule, to_graph_arrays
from repro_torch.core.jit_stats import note_shape_event
from repro_torch.device import resolve_device
from repro_torch.predictors import gnn, ip_net
from repro_torch.predictors.cache import LRUCache
from repro_torch.predictors.gnn import AlfabetS
from repro_torch.predictors.ip_net import AIMNetS

MAX_ATOMS = 40
DEFAULT_MAX_BATCH = 64  # one chosen successor per worker at the default fleet size


def capacity_table(max_batch: int, *, grain: int = 8, ratio: float = 1.5) -> tuple[int, ...]:
    """Geometric bucket ladder for predictor batch padding, ``1..max_batch``.

    Deliberately separate from ``core.agent.candidate_capacity_table``:
    this ladder terminates EXACTLY at the fleet batch size (the snap
    behaviour below), the candidate ladder is open-ended with a
    fleet-dependent ratio — and predictors must not import repro_torch.core.

    Derived from the fleet size: ``max_batch`` should be the largest batch
    the caller expects (W workers x mols each — see ``PropertyService.reserve``).
    Interior rungs grow by ``ratio`` (padding bounded by ``ratio``x there)
    and the ladder ends EXACTLY at ``max_batch``: every batch within ~2x of
    the fleet-wide size (in-batch dedupe makes the count drift a little below
    W) snaps to the one reserved shape instead of walking its own rungs.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    caps = [1]
    c = grain
    while c * ratio < max_batch:
        caps.append(c)
        c = max(c + grain, grain * round(c * ratio / grain))
    if max_batch > 1:
        caps.append(max_batch)
    return tuple(caps)


def featurize(mol: Molecule, max_atoms: int = MAX_ATOMS) -> dict[str, np.ndarray]:
    """Graph arrays + conformer features (zeros if conformer invalid)."""
    arrs = to_graph_arrays(mol, max_atoms)
    if has_valid_conformer(mol):
        arrs["conf_feat"] = conformer_features(mol, max_atoms)
        arrs["conf_valid"] = np.float32(1.0)
    else:
        arrs["conf_feat"] = np.zeros((max_atoms, CONFORMER_FEATURE_DIM), dtype=np.float32)
        arrs["conf_valid"] = np.float32(0.0)
    return arrs


def stack_features(feats: Sequence[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([f[k] for f in feats]) for k in feats[0]}


@dataclass
class Properties:
    bde: float | None
    ip: float | None

    @property
    def conformer_valid(self) -> bool:
        return self.ip is not None


class OracleService:
    """Deterministic, jit-free ``PropertyService`` stand-in backed by the
    chemistry oracles — identical answers in every process, no predictor
    training, no XLA compiles.

    THE shared stub for every harness that wants properties out of the
    equation: the tier-1 test matrices (tests/conftest.py re-exports it),
    the chemistry benchmarks, and the multi-device truth run
    (``repro.launch.verify``) — whose cross-process bit-equality pins
    silently depend on all of them predicting identically, which is why
    there is exactly one implementation.  ``predict`` entries are counted
    in ``n_calls`` so dispatch-per-step tests can assert batching.
    """

    def __init__(self):
        from repro_torch.chem.oracle import oracle_bde, oracle_ip
        self._bde, self._ip, self._ok = oracle_bde, oracle_ip, has_valid_conformer
        self.n_calls = 0

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        self.n_calls += 1
        return [Properties(bde=self._bde(m),
                           ip=self._ip(m) if self._ok(m) else None)
                for m in mols]


def _input_layout(max_atoms: int) -> dict[str, tuple[int, int, tuple[int, ...]]]:
    """The model inputs side by side in one f32 row per molecule, so a
    batch crosses to the device in one copy: name -> (offset, size,
    per-molecule shape)."""
    A = max_atoms
    out, off = {}, 0
    for name, shape in (("atom_feat", (A, ATOM_FEATURE_DIM)),
                        ("adj", (A, A, MAX_BOND_ORDER)), ("mask", (A,)),
                        ("conf_feat", (A, CONFORMER_FEATURE_DIM))):
        n = int(np.prod(shape))
        out[name] = (off, n, shape)
        off += n
    return out


@dataclass
class PropertyService:
    """Both learned predictors on ``device`` behind the LRU cache.

    ``bde_params`` / ``ip_params`` are the reference's parameter trees as
    numpy (``ensure_trained`` returns them, ``gnn.params_to_numpy`` makes
    them): when given they are loaded onto ``device`` and fix the models'
    widths; when None the modules ``bde_model`` / ``ip_model`` are used as
    they are, moved to ``device``.  ``device=None`` is the GPU and raises
    without one."""

    bde_model: AlfabetS
    bde_params: dict | None
    ip_model: AIMNetS
    ip_params: dict | None
    max_atoms: int = MAX_ATOMS
    cache: LRUCache | None = field(default_factory=lambda: LRUCache(200_000))
    max_batch_hint: int = DEFAULT_MAX_BATCH  # fleet-wide batch bound (see reserve)

    # statistics (§3.6)
    n_predict_calls: int = 0      # predict() entries (one per env step fleet-wide)
    n_predictor_batches: int = 0  # model batches actually run (cache misses)
    n_predictor_mols: int = 0
    predict_s: float = 0.0        # host seconds in predict()
    model_s: float = 0.0          # of which in the model batches (ends synced)

    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.bde_model = (gnn.params_from_numpy(self.bde_params, device=self.device)
                          if self.bde_params is not None
                          else self.bde_model.to(self.device))
        self.ip_model = (ip_net.params_from_numpy(self.ip_params, device=self.device)
                         if self.ip_params is not None
                         else self.ip_model.to(self.device))
        self._buckets = capacity_table(self.max_batch_hint)
        self._layout = _input_layout(self.max_atoms)
        self._row = sum(n for _, n, _ in self._layout.values())
        self._staging: dict[int, torch.Tensor] = {}   # padded batch -> host buffer

    def reserve(self, max_batch: int) -> None:
        """Size the padding ladder for a fleet that predicts up to
        ``max_batch`` molecules per step (the trainer calls this with
        W x mols_per_worker).  Only ever grows the hint."""
        if max_batch > self.max_batch_hint:
            self.max_batch_hint = max_batch
            self._buckets = capacity_table(max_batch)

    # ------------------------------------------------------------ #
    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        t0 = time.perf_counter()
        self.n_predict_calls += 1
        out: list[Properties | None] = [None] * len(mols)
        todo: list[int] = []
        keys = [m.iso_key() for m in mols]
        for i, key in enumerate(keys):
            if self.cache is not None:
                hit = self.cache.get(key)
                if hit is not None:
                    out[i] = hit
                    continue
            todo.append(i)

        if todo:
            # one fleet-wide batch may name the same molecule several times
            # (e.g. two workers choosing the same successor) — featurize and
            # predict each distinct iso_key once, fan results back out
            slot_of: dict = {}
            unique: list[int] = []
            for i in todo:
                if keys[i] not in slot_of:
                    slot_of[keys[i]] = len(unique)
                    unique.append(i)
            feats = [featurize(mols[i], self.max_atoms) for i in unique]
            batch = stack_features(feats)
            bde_arr, ip_arr = self._run_models(batch)
            for i in todo:
                slot = slot_of[keys[i]]
                mol = mols[i]
                bde = float(bde_arr[slot]) if mol.has_oh_bond() else None
                if bde is not None and not np.isfinite(bde):
                    bde = None
                ip = float(ip_arr[slot]) if batch["conf_valid"][slot] > 0.5 else None
                props = Properties(bde=bde, ip=ip)
                out[i] = props
                if self.cache is not None:
                    self.cache.put(keys[i], props)
        self.predict_s += time.perf_counter() - t0
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------ #
    def _host_buffer(self, padded: int) -> torch.Tensor:
        """The ``[padded, row]`` f32 staging buffer (pinned on the card),
        one per rung of the ladder."""
        buf = self._staging.get(padded)
        if buf is None:
            buf = torch.zeros((padded, self._row), dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._staging[padded] = buf
            note_shape_event("predictor_bucket")
        return buf

    def _run_models(self, batch: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """Pad the batch dim to a bucket; pack, copy in once, run both
        models, copy both outputs back once."""
        t0 = time.perf_counter()
        b = batch["atom_feat"].shape[0]
        padded = self._pad_to(b)
        host = self._host_buffer(padded)
        rows = host.numpy()
        for name, (off, n, _) in self._layout.items():
            rows[:b, off:off + n] = batch[name].reshape(b, n)
        rows[b:] = 0.0
        # padding rows must look like 1-atom dummies to avoid nan paths
        rows[b:, self._layout["mask"][0]] = 1.0
        self.n_predictor_batches += 1
        self.n_predictor_mols += b
        with torch.inference_mode():
            dev = host.to(self.device, non_blocking=True)
            inputs = {name: dev[:, off:off + n].reshape((padded,) + shape)
                      for name, (off, n, shape) in self._layout.items()}
            _, mol_bde = self.bde_model(inputs)
            ip = self.ip_model(inputs)
            both = torch.stack([mol_bde, ip]).cpu().numpy()
        self.model_s += time.perf_counter() - t0
        return both[0, :b], both[1, :b]

    def _pad_to(self, b: int) -> int:
        for cap in self._buckets:
            if b <= cap:
                return cap
        # over-hint batch: grow the ladder (grain-rounded) so near-identical
        # follow-up batches reuse the same shape
        self.reserve(8 * -(-b // 8))
        return self._buckets[-1]


class DegradedPropertyService:
    """The last-known-good property tier a TRIPPED circuit breaker serves
    from (serving/breaker.py): per molecule, the primary service's LRU
    cache when it holds the answer, the deterministic oracle stub
    otherwise.  Never raises, never touches the (presumed sick) primary
    predictors — responses routed through here are flagged ``degraded``
    by the serving layer.

    ``primary`` may be a ``PropertyService`` (its ``cache`` is consulted),
    a ``ResilientService`` around one (attribute delegation exposes the
    cache), or any stub without a cache (pure oracle fallback).
    """

    def __init__(self, primary=None, stub=None):
        self.primary_cache = getattr(primary, "cache", None)
        self.stub = stub if stub is not None else OracleService()
        self.n_cache_serves = 0
        self.n_stub_serves = 0

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        out: list[Properties] = []
        for m in mols:
            hit = (self.primary_cache.get(m.iso_key())
                   if self.primary_cache is not None else None)
            if hit is not None:
                self.n_cache_serves += 1
                out.append(hit)
            else:
                self.n_stub_serves += 1
                out.append(self.stub.predict([m])[0])
        return out

    def stats(self) -> dict:
        return {"n_cache_serves": self.n_cache_serves,
                "n_stub_serves": self.n_stub_serves}


# ------------------------------------------------------------------ #
# fault tolerance: bounded retries + deterministic backoff + timeout
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for one property-service call.

    ``max_retries``     retries after the first attempt (so a call makes at
                        most ``max_retries + 1`` attempts).
    ``backoff_base_s``  attempt k sleeps ``min(cap, base * 2**k)`` scaled
                        by a seeded jitter in [0.5, 1.0) — deterministic
                        given the policy seed, capped, exponential.
    ``timeout_s``       per-call wall clock bound (None = no timeout).  A
                        call that overruns raises ``FaultTimeout`` and is
                        retried like any transient fault.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    timeout_s: float | None = None
    seed: int = 0


class ResilientService:
    """Bounded-retry wrapper around any property service.

    Composition over inheritance: ``inner`` is a ``PropertyService``, an
    ``OracleService``, or any object with ``predict(mols)``; every other
    attribute (``reserve``, cache counters, ...) passes through untouched.

    Retry semantics — the properties tests/test_faults.py gates:

    * only ``TransientFault`` (incl. ``FaultTimeout``) is retried; real
      exceptions propagate (they are bugs, not weather), and ``FaultError``
      stays terminal.
    * the retried batch is BIT-identical to a first-try batch, because the
      injection point sits BEFORE the inner call and the inner predictor is
      deterministic — retries are invisible to the equivalence matrix.
    * backoff is deterministic (seeded jitter, exponential, capped) and
      injectable (``sleep=``) so tests and the fault benches never
      actually wait.
    * after ``max_retries`` retries the transient escalates to a terminal
      ``FaultError`` — the fleet quarantines the affected slots instead of
      crashing (core/rollout.py).

    ``fault_plan`` arms the deterministic injection surface
    (``repro.core.faults.FaultPlan``, site ``"predict"``).

    Timeout caveat: the timed-out inner call keeps running on the worker
    thread (python threads cannot be killed); with a deterministic,
    internally-locked inner service the overlap is harmless, which is the
    only configuration the harness uses timeouts with.
    """

    def __init__(self, inner, policy: RetryPolicy = RetryPolicy(),
                 fault_plan=None,
                 sleep: Callable[[float], None] | None = time.sleep):
        self.inner = inner
        self.policy = policy
        self.fault_plan = fault_plan
        self._sleep = sleep if sleep is not None else (lambda s: None)
        self._backoff_rng = np.random.default_rng(policy.seed)
        self._timeout_pool: ThreadPoolExecutor | None = None
        self.n_retries = 0          # transient attempts absorbed
        self.n_timeouts = 0         # real (wall-clock) timeouts observed

    def __getattr__(self, name):
        # delegation target for everything predict() doesn't override
        # (reserve, n_predict_calls, cache, ...)
        return getattr(self.inner, name)

    def _backoff_s(self, attempt: int) -> float:
        base = min(self.policy.backoff_cap_s,
                   self.policy.backoff_base_s * (2.0 ** attempt))
        return base * (0.5 + 0.5 * float(self._backoff_rng.random()))

    def _call_inner(self, mols):
        if self.policy.timeout_s is None:
            return self.inner.predict(mols)
        if self._timeout_pool is None:
            self._timeout_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="predict-timeout")
        fut = self._timeout_pool.submit(self.inner.predict, mols)
        try:
            return fut.result(timeout=self.policy.timeout_s)
        except FuturesTimeout:
            self.n_timeouts += 1
            raise FaultTimeout(
                f"predict timed out after {self.policy.timeout_s}s "
                f"({len(mols)} molecules)") from None

    def predict(self, mols: Sequence[Molecule]) -> list[Properties]:
        attempt = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check_call("predict")
                return self._call_inner(mols)
            except FaultError:
                raise                     # terminal — the fleet quarantines
            except TransientFault as e:
                if attempt >= self.policy.max_retries:
                    raise FaultError(
                        f"predict retries exhausted after {attempt + 1} "
                        f"attempts: {e!r}") from e
                self._sleep(self._backoff_s(attempt))
                attempt += 1
                self.n_retries += 1

    def fault_stats(self) -> dict:
        return {
            "n_retries": self.n_retries,
            "n_timeouts": self.n_timeouts,
            "n_faults_injected": (self.fault_plan.n_injected
                                  if self.fault_plan is not None else 0),
        }
