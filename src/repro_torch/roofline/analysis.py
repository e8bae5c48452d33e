"""Port of ``repro.roofline.analysis``: the three-term roofline of a
dry-run step.

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = bytes_per_chip / HBM_bw
    collective term = collective_bytes_per_chip / link_bw

The reference reads flops and bytes from the partitioned HLO of an XLA
compile (``hlo_walk``).  PyTorch has no such artifact: the port counts the
step's aten ops on the ``meta`` device (``op_walk.aggregate``) at the
global batch, and ``roofline_terms`` divides flops and bytes evenly over
the chips (an analytic partition); the collective bytes are already per
chip (``op_walk.collective_schedule``).  ``collective_bytes_from_hlo`` is
kept, as are the formulas of ``RooflineReport``,
``estimate_hbm_per_chip`` and ``model_flops_estimate``, which the tests
hold to the reference's.

Hardware: the port's reports use ``HW_H100`` (NVIDIA's data sheet, H100
SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a
direction as the link).  ``HW_V5E`` stays only so that the tests can hold
the formulas to the reference's; no port figure is computed with it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, FLOP/s (bf16)
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per ICI link


HW_V5E = Hardware("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
# NVLink 4: 18 links x 25 GB/s = 450 GB/s each direction; the port's reports
HW_H100 = Hardware("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of 'bf16[128,4096]' etc.; tuples handled by caller."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> dict[str, int]:
    """Sum result-shape bytes per collective kind from (partitioned) HLO."""
    out: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        # e.g.  %all-reduce.1 = f32[1024]{0} all-reduce(f32[1024]{0} %x), ...
        m = re.match(r"%?[\w.\-]+\s*=\s*(\(?[^=]*?)\s+([\w\-]+)\(", line)
        if not m:
            continue
        result_shape, opname = m.group(1), m.group(2)
        for kind in _COLLECTIVES:
            if opname == kind or opname.startswith(kind + "-"):
                out[kind] += _shape_bytes(result_shape)
                break
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0          # 6*N*D (or 6*N_active*D for MoE)
    memory_per_chip: float = 0.0      # bytes (estimate_hbm_per_chip)

    hw: Hardware = HW_H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (global) — remat/redundancy waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "memory_per_chip": self.memory_per_chip,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline_terms(
    *, arch: str, shape: str, mesh_desc: str, chips: int, walk: dict,
    model_flops: float, memory_per_chip: float = 0.0,
) -> RooflineReport:
    """Terms from ``op_walk.aggregate``'s dict: its ``flops`` and ``bytes``
    are the whole step's at the global batch, split evenly over ``chips``;
    its ``collectives`` are per chip."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_chip=float(walk["flops"]) / chips,
        bytes_per_chip=float(walk["bytes"]) / chips,
        collective_bytes_per_chip=float(walk["collective_bytes"]),
        collectives={k: int(v) for k, v in walk["collectives"].items()},
        model_flops=model_flops,
        memory_per_chip=memory_per_chip,
    )


def estimate_hbm_per_chip(cfg, shape, *, tp: int, dp: int, zero_opt: bool = False,
                          microbatches: int = 1, fsdp: bool = False) -> dict:
    """Analytic per-chip HBM occupancy for the fits-proof.

    The reference's formula, unchanged (it models what an allocator would
    hold on a chip of the mesh; the port has no compiled memory analysis
    beside it):

      params/chip + optimizer moments/chip (f32 x2) + token batch
      + rematted residual stack (L x B_loc x S x d_model x 2B)
      + KV/state cache (decode)
      + peak transient (attention block scores, MLP/MoE intermediates,
        loss chunk logits) x 1.5 scheduling slack
    """
    from repro_torch.models.model import count_params
    import math

    dtype_b = 2 if cfg.dtype == "bfloat16" else 4
    n_params = count_params(cfg)
    shard = tp * (dp if fsdp else 1)
    params_b = n_params * dtype_b / shard
    B_loc = max(shape.global_batch // dp, 1)
    S = shape.seq_len
    D = cfg.d_model
    L = cfg.n_layers

    out = {"params": params_b}
    if shape.kind == "train":
        mu = max(microbatches, 1)
        B_mu = max(B_loc // mu, 1)
        out["opt"] = 2 * n_params * 4 / tp / (dp if (zero_opt or fsdp) else 1)
        out["residuals"] = L * B_mu * S * D * dtype_b
        if cfg.encdec is not None:
            out["residuals"] += cfg.encdec.n_enc_layers * B_mu * cfg.encdec.n_frames * D * dtype_b
        # transient peaks (largest of): attention score block (f32),
        # mlp/expert intermediates, loss-chunk logits (f32, vocab/tp)
        h_loc = max(cfg.n_heads // tp, 1)
        attn_t = B_mu * min(S, 1024) * S * h_loc * 4 * 2
        ff = cfg.d_ff if cfg.moe is None else cfg.d_ff * cfg.moe.top_k
        mlp_t = B_mu * S * max(ff // tp, 1) * dtype_b * 3
        loss_t = B_mu * min(S, 512) * max(cfg.vocab // tp, 1) * 4 * 3
        out["transient"] = 1.5 * max(attn_t, mlp_t, loss_t)
        out["grads"] = n_params * dtype_b / shard
        if mu > 1:
            out["grad_accum"] = n_params * dtype_b / shard
    elif shape.kind == "prefill":
        h_loc = max(cfg.n_heads // tp, 1)
        out["activations"] = B_loc * S * D * dtype_b * 4
        out["transient"] = 1.5 * B_loc * min(S, 1024) * S * h_loc * 4 * 2
    else:  # decode
        K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        Sc = S if cfg.attn_window is None else min(S, cfg.attn_window)
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            cache = L * B_loc * (Sc / (tp if Sc % tp == 0 else 1)) * K * Dh * dtype_b * 2
        else:
            d_inner = cfg.ssm.expand * D
            n_h = d_inner // cfg.ssm.head_dim
            cache = L * B_loc * max(n_h // tp, 1) * cfg.ssm.head_dim * cfg.ssm.state_dim * dtype_b
            if cfg.family == "hybrid":
                cache += B_loc * (Sc / (tp if Sc % tp == 0 else 1)) * K * Dh * dtype_b * 2
        out["cache"] = cache
        out["transient"] = B_loc * D * 64 * dtype_b
    out["total"] = float(sum(out.values()))
    return out


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D with N = active params (MoE: top-k experts only); D = tokens
    processed per step (decode: global_batch tokens)."""
    from repro_torch.models.model import active_params
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
