"""The port's example twins (``repro_torch.examples``) on the CPU.

* Each twin runs as ``python -m repro_torch.examples.<name>``: ``--help``
  exits 0, and ``--device`` defaults to ``cuda``.
* ``quickstart`` walks dataset -> predictors -> training -> greedy ->
  filter against a cache of random predictors (``cache_dir``), and its
  acting line shows one Q dispatch per fleet step.
* ``serve_predictor`` serves its mixed batch over the oracle stub: every
  request ends terminal and the poisoned one fails at the door.

The reference examples train with ``rollout="fleet"``, which raises under
jax 0.9 (ROADMAP C0), so they are no parity oracle here; the
pieces they walk are held to the reference by the other port suites.
"""

import ast
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.examples import optimize_antioxidants, quickstart, serve_predictor
from repro_torch.predictors import gnn, ip_net

REPO = Path(__file__).resolve().parents[1]
TWINS = {"quickstart": quickstart, "optimize_antioxidants": optimize_antioxidants,
         "serve_predictor": serve_predictor}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_as_a_module(name):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--help"], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout
    assert TWINS[name].parser().parse_args([]).device == "cuda"


def _run(main, argv, **kw) -> list[str]:
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv, **kw)
    return out.getvalue().splitlines()


def test_quickstart_walks_the_api(tmp_path):
    g = torch.Generator().manual_seed(0)
    save_pytree(str(tmp_path / "alfabet_s.npz"),
                gnn.params_to_numpy(gnn.AlfabetS(generator=g, device="cpu")))
    save_pytree(str(tmp_path / "aimnet_s.npz"),
                ip_net.params_to_numpy(ip_net.AIMNetS(generator=g, device="cpu")))
    (tmp_path / "metrics.json").write_text(json.dumps(
        {"bde": {"rel_err_mean": 0.5}, "ip": {"rel_err_mean": 0.5}}))
    lines = _run(quickstart.main, ["--device", "cpu"], cache_dir=str(tmp_path))
    assert lines[0].startswith("predictors ready")
    assert sum(l.startswith("[ep ") for l in lines) == 3
    acting = next(l for l in lines if l.startswith("acting:"))
    q, steps, batches = map(int, re.findall(r"\d+", acting))
    assert q == steps == batches == 15 * 4
    assert re.fullmatch(r"filter: \d/4 pass .*", lines[-1])


def test_serve_predictor_answers_every_request():
    lines = _run(serve_predictor.main, ["--device", "cpu"])
    submits = [l for l in lines if l.startswith("submit ")]
    assert len(submits) == 7 and submits[-1].endswith("-> failed")
    summary = lines[-1]
    assert summary.startswith("7 requests in")
    counts = ast.literal_eval(re.search(r"statuses (\{.*?\})", summary).group(1))
    assert sum(counts.values()) == 7 and counts["failed"] == 1
    steps, dispatches = map(int, re.search(
        r"(\d+) service steps, (\d+) Q dispatches", summary).groups())
    assert steps == dispatches > 0
