"""The port's counterpart of ``repro.roofline.hlo_walk``: a step's cost,
counted op by op.

The reference walks the partitioned HLO text of an XLA compile.  PyTorch
produces no HLO, so ``aggregate(fn, *args)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts every aten op that reaches it, after
autograd and the composite ops' decomposition (so a backward, a
checkpointed block's recompute and every loop iteration are counted as
they run; there are no loop bodies to multiply).  Run it on the ``meta``
device and nothing is allocated: a 235B-parameter step is counted on the
host.

Counted per executed op:
  * flops  -- ``torch.utils.flop_counter``'s registry, so matrix products,
              convolutions and SDPA count as ``FlopCounterMode`` counts them
              (2 x multiply-adds); elementwise work is not counted, as
              ``hlo_walk`` counts only ``dot``;
  * bytes  -- the bytes of the op's tensor inputs and of its outputs that
              are not one of its inputs (an in-place op writes what it
              read).  View ops move nothing.  Nothing is fused, so this is
              an unfused upper bound on HBM traffic, as ``hlo_walk``'s
              per-op count is outside fusions.

There is no partitioned module to read collectives from either, so
``collective_schedule`` derives them analytically from the specs
(``models.param_pspecs`` / ``add_fsdp``) as the GSPMD schedule the
reference's dry-run would compile: see its docstring.  Every figure it
returns is analytic.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_NO_TRAFFIC = {torch.ops.aten.detach, torch.ops.aten.alias, torch.ops.aten.lift_fresh}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Walk(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            seen = {id(t) for t in ins}
            self.bytes += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in _tensors(out) if id(t) not in seen)
        return out


def aggregate(fn: Callable[..., Any], *args,
              collectives: dict[str, float] | None = None) -> dict:
    """Run ``fn(*args)`` once and count it.  Returns ``{"flops", "bytes",
    "ops", "collectives", "collective_bytes"}``: the flops and bytes of the
    whole call (on ``meta`` tensors: the shapes' work), the number of aten
    ops, and ``collectives`` (per kind, e.g. ``collective_schedule``'s;
    zeros when not given) with their sum."""
    walk = _Walk()
    with walk:
        fn(*args)
    coll = {k: 0.0 for k in COLLECTIVES}
    coll.update(collectives or {})
    return {"flops": walk.flops, "bytes": walk.bytes, "ops": walk.ops,
            "collectives": coll, "collective_bytes": float(sum(coll.values()))}


# ------------------------------------------------------------------ #
# the analytic collective schedule
# ------------------------------------------------------------------ #
# row-parallel projections: leaf name, its parents, the contraction dim
# (after the stacked-layer dim) whose "model" sharding leaves partial sums
_ROW_PARALLEL = {("wo", "attn"): 0, ("wo", "cross"): 0, ("wo", "shared_attn"): 0,
                 ("w2", "mlp"): 0, ("w2", "shared_attn"): 0, ("w2", "moe"): 1,
                 ("out_proj", "ssm"): 0}


def collective_schedule(cfg, shape, mesh, pspecs, *, microbatches: int = 1
                        ) -> dict[str, float]:
    """Per-chip collective bytes of one step, by kind, from the specs.

    With ``n`` the size of the axes a collective runs over, each
    collective moves ``(n - 1) / n`` of its tensor's bytes through a chip:
      * a leaf sharded over the data axes (FSDP): an all-gather of its
        model shard in the forward, another in the backward and a
        reduce-scatter of its gradient, per microbatch of a train step
        (the forward's all-gather alone in prefill and decode);
      * a leaf not sharded over them: a data-parallel all-reduce of its
        gradient (model shard) once per train step;
      * a row-parallel projection sharded on "model" over its contraction
        dim (``wo``, an MLP's or mixtral's expert ``w2``, ``out_proj``): an
        all-reduce of its ``[B_loc, S, D]`` output over "model" at every
        layer it serves, twice in a train step (forward, and the backward
        of the column-parallel input), once in prefill and decode (S = 1).
    Expert-parallel MoE (qwen3's experts sharded on E) would add
    all-to-alls of the dispatched tokens; they are not modelled."""
    from repro_torch.models.model import (abstract_params, hybrid_n_apps,
                                          leaves_with_paths)

    sizes = mesh.shape
    data = tuple(a for a in mesh.axis_names if a != "model")
    dp = math.prod(sizes[a] for a in data)
    tp = sizes.get("model", 1)
    train = shape.kind == "train"
    mb = max(microbatches, 1) if train else 1
    out = {k: 0.0 for k in COLLECTIVES}

    def axes_of(part) -> tuple[str, ...]:
        return () if part is None else (part,) if isinstance(part, str) else tuple(part)

    specs = dict(leaves_with_paths(pspecs))
    leaves = list(leaves_with_paths(abstract_params(cfg)))
    for path, leaf in leaves:
        spec = specs[path]
        used = [a for p in spec for a in axes_of(p)]
        n_model = math.prod(sizes[a] for a in used if a == "model")
        n_data = math.prod(sizes[a] for a in used if a != "model")
        shard = leaf.numel() * leaf.element_size() / n_model
        if n_data > 1:
            frac = (n_data - 1) / n_data
            out["all-gather"] += (2 * mb if train else 1) * frac * shard
            if train:
                out["reduce-scatter"] += mb * frac * shard
        elif train and dp > 1:
            out["all-reduce"] += (dp - 1) / dp * shard

    if tp > 1 and cfg.family != "qnet":
        act_b = 2 if cfg.dtype == "bfloat16" else 4
        b_loc = max(shape.global_batch // dp, 1)
        dec = 1 if shape.kind == "decode" else shape.seq_len + (
            cfg.vlm.n_patches if cfg.family == "vlm" else 0)
        apps = {"blocks": cfg.n_layers,
                "enc_blocks": cfg.encdec.n_enc_layers if cfg.encdec else 0,
                "shared_attn": hybrid_n_apps(cfg) if cfg.family == "hybrid" else 0}
        for path, _ in leaves:
            name, parent = path[-1], path[-2] if len(path) > 1 else ""
            if (name, parent) not in _ROW_PARALLEL:
                continue
            off = 1 if path[0] in ("blocks", "enc_blocks") else 0
            if specs[path][off + _ROW_PARALLEL[(name, parent)]] != "model":
                continue
            pos = cfg.encdec.n_frames if path[0] == "enc_blocks" else dec
            out["all-reduce"] += ((2 if train else 1) * apps[path[0]] * (tp - 1) / tp
                                  * b_loc * pos * cfg.d_model * act_b)
    return out
