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


def test_port_has_the_training_slice():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/core/distributed.py",
                "src/repro_torch/core/packed_batch.py",
                "src/repro_torch/core/env.py",
                "src/repro_torch/data/datasets.py",
                "src/repro_torch/optim/adam.py",
                "src/repro_torch/kernels/packed_qnet/ops.py",
                "src/repro_torch/kernels/packed_qnet/ref.py"):
        assert rel in names
    for rel in ("src/repro_torch/kernels/packed_qnet/csrc/packed_qnet.cu",
                "src/repro_torch/kernels/csrc/qnet_tiles.cuh"):
        assert (ROOT / rel).is_file()


def test_port_has_the_lm_slice():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/configs/base.py",
                "src/repro_torch/configs/zamba2_1p2b.py",
                "src/repro_torch/configs/stablelm_1p6b.py",
                "src/repro_torch/configs/mamba2_2p7b.py",
                "src/repro_torch/models/layers.py",
                "src/repro_torch/models/ssm.py",
                "src/repro_torch/models/model.py",
                "src/repro_torch/launch/steps.py",
                "src/repro_torch/launch/serve.py",
                "src/repro_torch/kernels/flash_attention/ops.py",
                "src/repro_torch/kernels/flash_attention/ref.py",
                "src/repro_torch/kernels/ssd_scan/ops.py",
                "src/repro_torch/kernels/ssd_scan/ref.py"):
        assert rel in names
    for rel in ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"):
        assert (ROOT / rel).is_file()
    code = ("import sys, repro_torch.launch.serve, repro_torch.models, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_port_has_the_launcher_slice():
    """The RL launcher's path: checkpointing, the learned predictors and
    the launcher itself, importable without pulling in JAX or ``repro``."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/checkpoint/__init__.py",
                "src/repro_torch/checkpoint/checkpoint.py",
                "src/repro_torch/predictors/cache.py",
                "src/repro_torch/predictors/gnn.py",
                "src/repro_torch/predictors/ip_net.py",
                "src/repro_torch/predictors/service.py",
                "src/repro_torch/predictors/training.py",
                "src/repro_torch/launch/train.py"):
        assert rel in names
    code = ("import sys, repro_torch.launch.train, repro_torch.predictors.training, "
            "repro_torch.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "ROADMAP A2" in p.read_text()
             or "needs repro_torch.checkpoint" in p.read_text()]
    assert not stubs, stubs


def test_port_has_the_pipeline_slice():
    """The paper's §3.5 pipeline and the truth run: fine-tune, filter, the
    shape-event counter, the verify runner and the example twins, all in
    the AST walk below and importable without JAX or ``repro``."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/core/finetune.py",
                "src/repro_torch/core/filter.py",
                "src/repro_torch/core/jit_stats.py",
                "src/repro_torch/launch/verify.py",
                "src/repro_torch/examples/__init__.py",
                "src/repro_torch/examples/quickstart.py",
                "src/repro_torch/examples/optimize_antioxidants.py",
                "src/repro_torch/examples/serve_predictor.py"):
        assert rel in names
    code = ("import sys, repro_torch.launch.verify, repro_torch.core.finetune, "
            "repro_torch.core.filter, repro_torch.examples.quickstart, "
            "repro_torch.examples.optimize_antioxidants, "
            "repro_torch.examples.serve_predictor; "
            "from repro_torch.core import fine_tune, filter_molecules, FilterCriteria; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "ROADMAP A4" in p.read_text()]
    assert not stubs, stubs


def test_port_has_the_lm_train_slice():
    """The LM training step: the tokenizer and batch pipeline, the LR
    schedules, ``loss_fn``, ``make_train_step``, the launcher's ``--mode
    lm`` and the backbone example twin, importable without JAX or
    ``repro``; no port file still says the slice is missing."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/data/tokenizer.py",
                "src/repro_torch/data/pipeline.py",
                "src/repro_torch/optim/schedules.py",
                "src/repro_torch/examples/backbone_lm.py"):
        assert rel in names
    code = ("import sys, repro_torch.examples.backbone_lm; "
            "from repro_torch.models import loss_fn; "
            "from repro_torch.launch.steps import make_train_step, pick_microbatches; "
            "from repro_torch.launch.train import train_lm, lm_loop; "
            "from repro_torch.data import SmilesTokenizer, TokenBatcher, lm_batches_from_smiles; "
            "from repro_torch.optim import constant, cosine_decay, linear_warmup_cosine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "ROADMAP A6a" in p.read_text()
             or "arrive with the backbone slice" in p.read_text()
             or "comes with the LM training slice" in p.read_text()]
    assert not stubs, stubs


def test_port_has_the_multidevice_slice():
    """The sharded trainer: the mesh helpers and ``shard_batch``, importable
    without JAX or ``repro``; no port file still waits for the multi-GPU
    port or refuses ``--nd`` above 1."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/launch/mesh.py" in names
    code = ("import sys; "
            "from repro_torch.launch.mesh import HostMesh, make_host_mesh, "
            "padded_worker_count, shard_slices, batch_axes, mesh_tp; "
            "from repro_torch.data.pipeline import shard_batch; "
            "import repro_torch.core.distributed, repro_torch.launch.verify; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "multi-GPU port" in p.read_text()
             or "ROADMAP A6)" in p.read_text()]
    assert not stubs, stubs


def test_port_has_the_families_slice():
    """The moe, encdec and vlm families: ``models/moe.py`` and the seven
    configs that came with them, importable without JAX or ``repro``; no
    port file still says the families are missing."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/models/moe.py" in names
    for cfg in ("granite_20b", "granite_34b", "mixtral_8x22b", "paligemma_3b",
                "qwen3_moe_235b_a22b", "whisper_large_v3", "yi_34b"):
        assert f"src/repro_torch/configs/{cfg}.py" in names
    code = ("import sys; "
            "from repro_torch.models.moe import moe_forward, route; "
            "from repro_torch.models.layers import cross_kv; "
            "from repro_torch.models import active_params; "
            "from repro_torch.configs import list_archs; "
            "assert len(list_archs()) == 12, list_archs(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "comes with the encdec family" in p.read_text()
             or "families raise in ``init_params``" in p.read_text()
             or "is not ported yet (ROADMAP A7); the port" in p.read_text()]
    assert not stubs, stubs


def test_port_has_the_dryrun_slice():
    """The dry-run half: the damoldqn config, the sharding plan, the
    production mesh, the specs, the roofline and its op walk, the dry-run
    and slurm launchers, ``optim.sgd`` and the packed exports, importable
    without JAX or ``repro``; no port file still cites the dry-run slice as
    missing."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/configs/damoldqn.py",
                "src/repro_torch/launch/dryrun.py",
                "src/repro_torch/launch/specs.py",
                "src/repro_torch/launch/slurm.py",
                "src/repro_torch/roofline/__init__.py",
                "src/repro_torch/roofline/analysis.py",
                "src/repro_torch/roofline/op_walk.py"):
        assert rel in names
    code = ("import sys; "
            "import repro_torch.launch.dryrun, repro_torch.launch.slurm; "
            "from repro_torch.launch.specs import input_specs, zero_opt_shardings; "
            "from repro_torch.launch.mesh import make_production_mesh; "
            "from repro_torch.models import abstract_params, param_pspecs; "
            "from repro_torch.models.model import add_fsdp; "
            "from repro_torch.roofline import HW_H100, aggregate, roofline_terms; "
            "from repro_torch.optim import sgd; "
            "from repro_torch.kernels.packed_qnet import pack_w1, packed_qnet_ref; "
            "from repro_torch.configs import list_archs; "
            "assert 'damoldqn' in list_archs(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    stubs = [p for p in PORT_FILES if "ROADMAP A7" in p.read_text()
             or "comes with the dry-run slice" in p.read_text()]
    assert not stubs, stubs


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


def test_trainer_defaults_to_cuda():
    """The trainer and agent resolve ``device=None`` to the GPU before any
    other work, and raise without one."""
    from repro_torch.chem.smiles import from_smiles
    from repro_torch.core import (DQNAgent, DQNConfig, DistributedTrainer,
                                  RewardConfig, TrainerConfig)
    from repro_torch.predictors.service import OracleService
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    mols = [from_smiles("C1=CC=CC=C1O")] * 16
    with pytest.raises(RuntimeError, match="GPU"):
        DistributedTrainer(TrainerConfig(), mols, OracleService(), RewardConfig())
    with pytest.raises(RuntimeError, match="GPU"):
        DQNAgent(DQNConfig())
