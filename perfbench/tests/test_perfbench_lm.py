"""The LM training cell (``drivers/lm_train.py``) driven on the CPU at a
reduced Moonlight configuration (3 layers, d_model 64, 8 experts of which
4 are held, 2 x 64 tokens a step), in f32 (the file's ``dtype``: bf16's
rounding at these widths is not the card's), with the cell's own limits:
a sound run is correct and every reading finite; with the shared experts
dropped it is not; the configuration is refused before anything is built
where the program lacks it or disagrees with the file; a wrong optimizer
update fails the parameters' change; the run loads no
JAX; each metric reader reads nothing from an empty run and a number from
a full one."""

import dataclasses
import json
import math
import subprocess
import sys

import pytest

import perfbench.run as R
from perfbench.harness.manifest import BENCH, Cell, _json

from conftest import ROOT

SEED = 2**31 + 77
SMALL = dict(hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
             moe_intermediate_size=32, intermediate_size=64, first_k_dense_replace=1,
             router_experts=8, num_experts_per_tok=3, n_routed_experts=4,
             expert_first=0, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
             v_head_dim=8, vocab_size=256, dtype="float32")
METRICS = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
           if "moonlight.train8k" in m.get("workloads", [])]


def _tiny_arch():
    from repro_torch.configs import get_config
    base = get_config("moonlight-16b-a3b")
    return dataclasses.replace(
        base, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=3, dense_d_ff=64),
        mla=dataclasses.replace(base.mla, kv_lora_rank=16, qk_nope_head_dim=8,
                                qk_rope_head_dim=4, v_head_dim=8))


@pytest.fixture
def cell(monkeypatch):
    import repro_torch.configs as C
    tiny = _tiny_arch()
    monkeypatch.setattr(C, "get_config", lambda name: tiny)
    config = _json(BENCH / "configs" / "moonlight-16b-a3b-ep8.json")
    config.update(SMALL)
    tr = _json(BENCH / "traffic" / "train8k.json")
    tr.update(batch=2, seq=64)
    return Cell("moonlight.train8k", {"chips": 1}, config, tr,
                _json(BENCH / "checks" / "moonlight.train8k.json"),
                [{"name": "setup_s", "unit": "s"}, {"name": "memory_peak_gb", "unit": "GB"}],
                [])


def _run(cell):
    return R.execute(cell, SEED, 0.3, False, "cpu", log=lambda *a: None)


def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(math.isfinite(c["value"]) for c in res["checks"].values())
    assert set(res["checks"]) == {"grad_gap_p90", "change_gap_p90", "change_gap_worst",
                                  "route_mismatch_share", "bias_gap", "window_unmoved"}


def test_shared_experts_dropped_is_not_correct(cell):
    from perfbench.calibrate_lm import _fault
    with _fault("shared_dropped"):
        res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["grad_gap_p90"]["value"] > res["checks"]["grad_gap_p90"]["limit"]


@pytest.mark.parametrize("fault", ["update_skipped", "lr_x2", "nu_dropped"])
def test_a_wrong_update_is_not_correct(cell, fault):
    from perfbench.calibrate_lm import _fault
    with _fault(fault):
        res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap_p90"]["value"] > res["checks"]["change_gap_p90"]["limit"]


def test_the_configuration_is_refused_before_anything_is_built(cell):
    from perfbench.drivers.lm_train import program_config
    program_config(cell.config)
    with pytest.raises(ValueError, match="hidden_size"):
        program_config({**cell.config, "hidden_size": 128})
    with pytest.raises(ValueError, match="scoring_func"):
        program_config({**cell.config, "scoring_func": "softmax"})


def test_a_program_without_the_configuration_fails_at_once():
    from perfbench.drivers.lm_train import program_config
    config = _json(BENCH / "configs" / "moonlight-16b-a3b-ep8.json")
    with pytest.raises(KeyError):
        program_config({**config, "arch": "no-such-arch"})


PROBE = """
import sys, dataclasses
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.run as R
sys.path.insert(0, {tests!r})
import test_perfbench_lm as T
import repro_torch.configs as C
tiny = T._tiny_arch()
C.get_config = lambda name: tiny
from perfbench.harness import hostenv
from perfbench.harness.manifest import BENCH, Cell, _json
config = _json(BENCH / "configs/moonlight-16b-a3b-ep8.json"); config.update(T.SMALL)
tr = _json(BENCH / "traffic/train8k.json"); tr.update(batch=2, seq=32)
cell = Cell("probe", {{"chips": 1}}, config, tr, _json(BENCH / "checks/moonlight.train8k.json"),
            [{{"name": "setup_s", "unit": "s"}}], [])
res = R.execute(cell, 5, 0.2, False, "cpu", log=lambda *a: None)
print(res["correct"], sorted(hostenv.forbidden_modules()))
"""


def test_the_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                                            tests=str(ROOT / "perfbench" / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_nothing_from_an_empty_run_and_a_number_from_a_full_one(name):
    from perfbench.harness.manifest import metric_reader
    read = metric_reader(name)
    assert read({"counters": {}, "trace": None, "config": {}, "traffic": {}}) is None
    traced = {"steps": 2, "mla_calls": 108, "local_rows": 9_000_000,
              "attn_flops": 1.0e15, "expert_flops": 2.0e14,
              "span_device_s": {"lm.moe.experts": 1.0, "lm.moe.route": 0.2,
                                "lm.moe.combine": 0.1, "lm.adam": 0.3}}
    ctx = {"counters": {"window_s": 30.0, "steps": 10, "tokens": 655360,
                        "flops": 6.6e15, "experts_held": 8, "traced": traced,
                        "program": {"counts": {"lm.moe.local_rows": 8_000_000,
                                               "lm.moe.max_local_rows": 2_000_000}}},
           "trace": {"window_s": 6.0, "busy_s": 5.4,
                     "device_s_by_name": {"cudnn_sdpa_flash_fprop": 2.0, "gemm": 3.0}},
           "config": {}, "traffic": {}}
    v = read(ctx)
    assert v is not None and math.isfinite(v) and v > 0
