"""The whole serving slice: the port's ``MoleculeOptService`` against the
reference's, on the CPU, at full width.

Both services get the same full-width Q-network parameters (the
reference's ``QNetwork.init`` tree carried over), the same seeded request
stream (deadlines and poisoned requests included), the same seeded
``FaultPlan`` and 4 slots.

* epsilon = 1: actions do not read Q, so results and counters must be
  bit-identical.
* epsilon = 0: every Q-dispatch buffer of the reference run, fed to the
  port's dispatch, gives Q within 1e-5 (abs and rel) of the reference's,
  and the same greedy action wherever the reference's top-two gap exceeds
  2e-5.  Smaller gaps (candidates with equal fingerprints tie exactly)
  are left out of the action check by that rule."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core.agent import QNetwork as JaxQNetwork
from repro.core.faults import FaultPlan as JaxFaultPlan, FaultRule as JaxFaultRule
from repro.predictors.service import (OracleService as JaxOracle,
                                      ResilientService as JaxResilient,
                                      RetryPolicy as JaxRetry)
from repro.serving import (MoleculeOptService as JaxService,
                           ServeConfig as JaxServeConfig,
                           StreamConfig as JaxStreamConfig,
                           drive_open_loop as jax_drive,
                           seeded_request_stream as jax_stream)
from repro_torch.core.agent import STATE_DIM, params_from_jax
from repro_torch.core.faults import FaultPlan, FaultRule
from repro_torch.kernels.fused_qnet import ops
from repro_torch.launch import serve_molopt
from repro_torch.predictors.service import (OracleService, ResilientService,
                                            RetryPolicy)
from repro_torch.serving import (MoleculeOptService, ServeConfig, StreamConfig,
                                 drive_open_loop, seeded_request_stream)
from repro_torch.serving.service import _ServePolicy

TOL = 1e-5
GAP = 2e-5
STREAM = dict(n_requests=12, rate=2.0, seed=3, deadline_frac=0.3,
              invalid_every=5)


@pytest.fixture(scope="module")
def jax_params():
    tree = JaxQNetwork().init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _rules(rule_cls):
    return [rule_cls(site="predict", kind="crash", every=5, fail_attempts=6),
            rule_cls(site="chem", kind="crash", rate=0.03),
            rule_cls(site="request", kind="transient", rate=0.2,
                     fail_attempts=1)]


def _jax_service(params, epsilon):
    plan = JaxFaultPlan(_rules(JaxFaultRule), seed=7)
    prop = JaxResilient(JaxOracle(), JaxRetry(max_retries=1), fault_plan=plan,
                        sleep=None)
    return JaxService(JaxQNetwork(), params, prop, fault_plan=plan,
                      cfg=JaxServeConfig(n_slots=4, epsilon=epsilon))


def _torch_service(params, epsilon, faults=True):
    plan = FaultPlan(_rules(FaultRule), seed=7) if faults else None
    prop = ResilientService(OracleService(), RetryPolicy(max_retries=1),
                            fault_plan=plan, sleep=None)
    return MoleculeOptService(params_from_jax(params, device="cpu"), prop,
                              fault_plan=plan, device="cpu",
                              cfg=ServeConfig(n_slots=4, epsilon=epsilon))


def _signature(svc):
    return [(r.request_id, r.status, r.best_smiles,
             None if r.best_reward is None
             else np.float64(r.best_reward).tobytes(),
             r.steps_used, r.degraded_steps, r.latency, r.error)
            for r in sorted(svc.results, key=lambda r: r.request_id)]


def _stats(svc):
    return json.dumps(svc.stats(), sort_keys=True, default=str)


def test_epsilon_one_results_and_counters_are_bit_identical(jax_params):
    want = _jax_service(jax_params, 1.0)
    jax_drive(want, jax_stream(JaxStreamConfig(**STREAM)))
    got = _torch_service(jax_params, 1.0)
    drive_open_loop(got, seeded_request_stream(StreamConfig(**STREAM)))
    mix = want.stats()["status_counts"]
    assert mix["completed"] and mix["degraded"] and mix["failed"]
    assert want.stats()["breaker"]["n_trips"] > 0
    assert _signature(got) == _signature(want)
    assert _stats(got) == _stats(want)


def test_epsilon_zero_q_and_greedy_actions_match(jax_params):
    ref = _jax_service(jax_params, 0.0)
    pol = ref._policy
    seen, counts = [], []
    fleet_q_values, dispatch = pol.fleet_q_values, pol._dispatch

    def record_counts(per_worker):
        counts.append([x.shape[0] for x in per_worker])
        return fleet_q_values(per_worker)

    def record_dispatch():
        q = dispatch()
        seen.append((pol._buf.copy(), np.asarray(q).copy()))
        return q

    pol.fleet_q_values, pol._dispatch = record_counts, record_dispatch
    jax_drive(ref, jax_stream(JaxStreamConfig(**STREAM)))
    assert len(seen) == len(counts) == ref.stats()["n_q_dispatches"] > 5

    port = _ServePolicy(params_from_jax(jax_params, device="cpu"), None, 4,
                        torch.device("cpu"))
    checked = skipped = 0
    for (buf, q_ref), n_w in zip(seen, counts):
        port._buf, port._cap = buf, buf.shape[1]
        q = port._dispatch()
        assert q.shape == q_ref.shape == buf.shape[:2]
        assert buf.shape[2] == STATE_DIM
        np.testing.assert_allclose(q, q_ref, atol=TOL, rtol=TOL)
        for w, n in enumerate(n_w):
            if n < 2:
                continue
            top2 = np.sort(q_ref[w, :n])[-2:]
            if top2[1] - top2[0] > GAP:
                assert int(np.argmax(q[w, :n])) == int(np.argmax(q_ref[w, :n]))
                checked += 1
            else:
                skipped += 1
    assert checked >= 30
    assert port.n_dispatches == len(seen)


def test_port_reruns_and_fault_isolation_hold(jax_params):
    """The reference's serve determinism contract, within the port: a
    faulted stream reruns bit-identically, and every request the faults
    never touched matches the unfaulted run bit for bit."""
    runs = []
    for faults in (True, True, False):
        svc = _torch_service(jax_params, 0.05, faults=faults)
        drive_open_loop(svc, seeded_request_stream(StreamConfig(**STREAM)))
        runs.append(svc)
    faulted, again, clean = runs
    assert _signature(again) == _signature(faulted)
    assert _stats(again) == _stats(faulted)
    untouched = [r for r in faulted.results
                 if r.status == "completed" and r.degraded_steps == 0]
    assert untouched
    ids = {r.request_id for r in untouched}
    clean_sig = {s[0]: s[1:6] for s in _signature(clean)}
    for s in _signature(faulted):   # status, smiles, reward, steps, degraded
        if s[0] in ids:
            assert clean_sig[s[0]] == s[1:6]


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    before = ops.fused_qnet.launches
    serve_molopt.main(["--device", "cpu", "--slots", "2", "--requests", "4",
                       "--invalid-every", "4", "--faults"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "on cpu" in out
    assert "req-0003   failed" in out             # poisoned at the door
    assert ops.fused_qnet.launches == before      # the CPU runs no kernel


def test_served_dispatches_are_one_per_step_plus_warmup(jax_params):
    svc = _torch_service(jax_params, 0.0)
    svc.reserve_candidates(64)
    drive_open_loop(svc, seeded_request_stream(StreamConfig(**STREAM)))
    st = svc.stats()
    assert st["n_q_dispatches"] == st["n_service_steps"] + 1
    assert svc._policy._buf.shape == (4, svc._policy._cap, STATE_DIM)
    assert all(r.status in ("completed", "degraded", "deadline_exceeded",
                            "shed", "failed") for r in svc.results)
    assert len(svc.results) == STREAM["n_requests"]
    assert svc.dispatch_timing() is None          # CUDA events on the GPU only
