"""The PyTorch port stands alone: no JAX, nothing of ``repro``, and the GPU
by default with no silent fallback to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def _forbidden(mod: str) -> bool:
    return any(mod == p or mod.startswith(p + ".") for p in ("jax", "repro"))


def test_port_has_the_serving_slice():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/device.py", "src/repro_torch/core/agent.py",
                "src/repro_torch/serving/service.py",
                "src/repro_torch/launch/serve_molopt.py",
                "src/repro_torch/kernels/fused_qnet/ops.py", "chip_smoke.py"):
        assert rel in names
    assert (ROOT / "src/repro_torch/kernels/fused_qnet/csrc/fused_qnet.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_launcher_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.launch.serve_molopt, repro_torch.chem; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_default_device_is_the_gpu_or_an_error():
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_service_and_launcher_default_to_cuda():
    from repro_torch.core.agent import QNetwork
    from repro_torch.launch.serve_molopt import parser
    from repro_torch.predictors.service import OracleService
    from repro_torch.serving import MoleculeOptService
    assert parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            QNetwork(hidden=(8, 8, 8, 8))
        with pytest.raises(RuntimeError, match="GPU"):
            MoleculeOptService(QNetwork(hidden=(8, 8, 8, 8), device="cpu"),
                              OracleService())
