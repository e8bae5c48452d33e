"""The port's truth run (``repro_torch.launch.verify``) on the CPU.

* Against the reference: ONE ``python -m repro.launch.verify --nd 1``
  child at the default ``fleet_sharded / packed / incremental`` cell with
  ``--epsilon-decay 1.0 --faults predict,chem`` (epsilon stays 1, so
  actions do not depend on Q), and the port's ``run_scenario`` in process
  from the reference's initial weights.  Transition digests, replay-state
  digests, transition counts, rewards and every fault counter are equal;
  losses within 1e-4 rel; parameters within 1e-4 abs + 1e-4 rel.
* Port only: a ``--kill-at 2`` child dies by SIGKILL after episode 2's
  checkpoint, a ``--resume`` child finishes the run, and its report equals
  the straight run's bit for bit on every key but ``meta`` and the
  shape-event counters; both have 0 shape events after warmup.
* At nd = 2: ONE ``python -m repro.launch.verify --nd 2`` child at the
  same cell and epsilon 1, and the port's ``--nd 2`` run in process from
  the same weights: the same keys as at nd = 1 (``n_devices`` 2 and the
  pool of 8 included) equal bit for bit, losses and parameters within the
  same tolerances.  ``--nd`` above ``--device-pool`` exits non-zero.
* The shape-event counter counts each growth of a capacity ladder: the
  fleet view's, the serve dispatch buffer's and the predictor service's.

Every child has a timeout, as ``tests/multidevice/mdhelpers.py`` gives its.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.agent import QNetwork as JaxQNetwork
from repro_torch.core.agent import QNetwork, params_from_jax
from repro_torch.core.jit_stats import RecompileCounter
from repro_torch.launch import verify

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
CHILD_TIMEOUT_S = 600
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4
EXACT = ("n_devices", "device_pool", "n_live_workers", "n_padded_workers",
         "rewards",
         "transition_digests", "replay_state_digests", "n_transitions",
         "n_faults_injected", "n_retries", "n_timeouts", "n_quarantined",
         "n_chem_retries", "n_pipeline_restarts", "n_incidents")
NOT_COMPARED = ("meta", "warmup_compiles", "recompiles_after_warmup")


def _child(module: str, out: Path, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", module, "--out", str(out), *args]
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _args(*argv: str):
    return verify.parser().parse_args(["--out", "unused", "--device", "cpu", *argv])


def _against_the_reference_child(tmp_path, *flags: str) -> tuple[dict, dict]:
    """The reference child's report and the port's, in process from the
    reference trainer's initial weights (worker 0 of its vmapped init)."""
    res = _child("repro.launch.verify", tmp_path / "ref.npz", *flags)
    assert res.returncode == 0, res.stdout + res.stderr
    want = _load(tmp_path / "ref.npz")
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    p = jax.vmap(JaxQNetwork(hidden=(32,)).init)(keys)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), p)
    got = verify.run_scenario(_args(*flags), network=params_from_jax(p0, device="cpu"))
    assert set(got) == set(want)
    for k in EXACT:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               err_msg=f"losses within {LOSS_RTOL} rel")
    params = sorted(k for k in want if k.startswith("param_"))
    assert len(params) == 4
    for k in params:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(
            got[k], want[k], atol=PARAM_TOL, rtol=PARAM_TOL,
            err_msg=f"{k} within {PARAM_TOL} abs + {PARAM_TOL} rel")
    return got, want


def test_port_report_matches_the_reference_child(tmp_path):
    flags = ("--nd", "1", "--epsilon-decay", "1.0", "--faults", "predict,chem")
    got, want = _against_the_reference_child(tmp_path, *flags)
    assert int(got["n_devices"]) == 1
    assert int(got["n_faults_injected"]) > 0 and int(got["n_retries"]) > 0
    assert int(got["n_chem_retries"]) > 0
    assert int(got["recompiles_after_warmup"]) == 0
    assert int(want["recompiles_after_warmup"]) == 0


def test_killed_then_resumed_run_is_bit_identical(tmp_path):
    ck = str(tmp_path / "ck")
    common = ("--device", "cpu", "--ckpt-dir", ck)
    killed = _child("repro_torch.launch.verify", tmp_path / "killed.npz",
                    *common, "--kill-at", "2")
    assert killed.returncode == -signal.SIGKILL, killed.stdout + killed.stderr
    assert not (tmp_path / "killed.npz").exists()
    assert sorted(os.listdir(ck))[-1] == "ckpt_2.npz"
    resumed = _child("repro_torch.launch.verify", tmp_path / "resumed.npz",
                     *common, "--resume")
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    got = _load(tmp_path / "resumed.npz")
    want = verify.run_scenario(_args())
    assert set(got) == set(want)
    for k in sorted(set(want) - set(NOT_COMPARED)):
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    assert len(got["losses"]) == 3
    assert int(got["recompiles_after_warmup"]) == 0
    assert int(want["recompiles_after_warmup"]) == 0


def test_port_nd2_report_matches_the_reference_nd2_child(tmp_path):
    """The reference's ``fleet_sharded / packed / incremental / packed /
    episode`` cell at nd = 2 of its forced pool of 8, at epsilon 1."""
    got, want = _against_the_reference_child(
        tmp_path, "--nd", "2", "--epsilon-decay", "1.0")
    assert int(got["n_devices"]) == 2 and int(got["device_pool"]) == 8
    assert int(got["n_padded_workers"]) == 4
    assert int(got["recompiles_after_warmup"]) == 0
    assert int(want["recompiles_after_warmup"]) == 0


def test_nd_above_the_pool_exits_non_zero(tmp_path):
    with pytest.raises(SystemExit) as e:
        verify.main(["--nd", "3", "--device-pool", "2", "--out",
                     str(tmp_path / "x.npz"), "--device", "cpu"])
    assert str(e.value.code) == "FAIL: --nd 3 > --device-pool 2"
    assert not (tmp_path / "x.npz").exists()
    assert verify.parser().parse_args(["--out", "x"]).device == "cuda"


def test_shape_events_are_counted():
    """The fleet view's buffer grows inside the warmup window (``by_site``
    names the site), and a trainer pushed past its last rung counts one
    more event, which a measured window would report."""
    counter = RecompileCounter.install()
    before = counter.by_site["fleet_view"]
    out, tr = verify.run(_args("--episodes", "1"))
    grown = counter.by_site["fleet_view"] - before
    assert int(out["warmup_compiles"]) == grown > 0
    assert int(out["recompiles_after_warmup"]) == 0
    with counter.window() as w:
        tr.reserve_candidates(4 * tr.candidate_capacity)
        tr.reserve_candidates(4 * tr.candidate_capacity // 4)
    assert w.count == 1


def test_the_other_ladders_count_shape_events():
    """The serve dispatch buffer and the predictor service's staging
    buffers count one event per new rung, none for a rung already held."""
    from repro_torch.chem.smiles import from_smiles
    from repro_torch.predictors import gnn, ip_net
    from repro_torch.predictors.service import OracleService, PropertyService
    from repro_torch.serving import MoleculeOptService
    counter = RecompileCounter.install()
    g = torch.Generator().manual_seed(0)
    svc = PropertyService(gnn.AlfabetS(generator=g, device="cpu"), None,
                          ip_net.AIMNetS(generator=g, device="cpu"), None,
                          device="cpu")
    with counter.window() as w:
        svc.predict([from_smiles("C1=CC=CC=C1O")])
    assert w.count == 1 and counter.by_site["predictor_bucket"] >= 1
    with counter.window() as w:
        svc.predict([from_smiles("CC1=CC=CC=C1O")])
    assert w.count == 0
    serve = MoleculeOptService(QNetwork(hidden=(8, 8, 8, 8), device="cpu"),
                               OracleService(), device="cpu")
    with counter.window() as w:
        serve.reserve_candidates(40)
        serve.reserve_candidates(40)
    assert w.count == 1 and counter.by_site["serve_dispatch"] >= 1


@pytest.mark.parametrize("hidden", [(32,), (256, 64), (512, 128, 32)],
                         ids=["verify_default", "quickstart", "optimize_antioxidants"])
def test_shallow_networks_pad_to_the_kernel_depth_bit_for_bit(hidden):
    """The truth run's default width and the examples' widths reach the
    five-layer Q kernels padded with identity layers: the padded network
    gives the unpadded one's bits (checked here through the plain
    versions, on the card by chip_smoke.py through the kernels)."""
    from repro_torch.kernels.fused_qnet.ref import qnet_ref
    from repro_torch.kernels.packed_qnet.ref import stacked_qnet_ref
    from repro_torch.kernels.qnet_depth import pad_to_kernel_depth
    g = torch.Generator().manual_seed(len(hidden))
    net = QNetwork(hidden=hidden, generator=g, device="cpu")
    layers = [(w, 0.1 * torch.randn(b.shape, generator=g)) for w, b in net.layers()]
    x = torch.rand((64, 2049), generator=g)
    padded = pad_to_kernel_depth(layers)
    assert len(padded) == 5 and padded[-1] is layers[-1]
    assert qnet_ref(x, padded).numpy().tobytes() == qnet_ref(x, layers).numpy().tobytes()
    stacked = [(torch.stack([w, 2 * w]), torch.stack([b, b])) for w, b in layers]
    xs = torch.stack([x, x.flip(0)])
    sp = pad_to_kernel_depth(stacked)
    assert [tuple(w.shape) for w, _ in sp][len(layers) - 1:-1] == \
        [(2, hidden[-1], hidden[-1])] * (5 - len(layers))
    assert stacked_qnet_ref(xs, sp).numpy().tobytes() == \
        stacked_qnet_ref(xs, stacked).numpy().tobytes()
    full = [(w, b) for w, b in QNetwork(generator=g, device="cpu").layers()]
    assert pad_to_kernel_depth(full) == full
