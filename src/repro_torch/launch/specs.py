"""Port of ``repro.launch.specs``: the dry-run's input stand-ins and their
shardings per (arch, shape).

``input_specs(cfg, shape, mesh)`` returns (specs, shardings) for the step
function's data arguments: token batches for train/prefill, the (one-token
batch, KV/state cache) pair for decode, and the replay batch for the
paper's qnet.  Stubs per the assignment carve-out: whisper gets
precomputed frame embeddings, paligemma gets patch embeddings.

The reference's ``jax.ShapeDtypeStruct`` stand-ins are tensors on the
``meta`` device (shapes and types, no storage).  A sharding is its spec
itself: a tuple with one entry per dim, an axis name, a tuple of names or
``None`` (``models.model.param_pspecs``' form).  JAX's ``NamedSharding``
binds a spec to devices; one card needs no such binding, and the dry-run
reads only the spec.

Sharding policy for data: batch dim over every non-"model" axis that
divides it; long sequence dims over "model" when divisible (sequence
parallelism for the 32k/500k caches); everything else replicated.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import ProductionMesh, batch_axes
from repro_torch.models import model as M

Spec = tuple


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _div(n: int, axes: tuple[str, ...], mesh: ProductionMesh) -> bool:
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total > 0 and n % total == 0


def _batch_part(mesh: ProductionMesh):
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def data_spec(shape: tuple[int, ...], mesh: ProductionMesh, *,
              seq_dims: tuple[int, ...] = ()) -> Spec:
    """Batch dim 0 over data axes (if divisible); listed seq dims over
    "model" (if divisible); rest replicated."""
    ba = batch_axes(mesh)
    parts: list = [None] * len(shape)
    if shape and _div(shape[0], ba, mesh):
        parts[0] = _batch_part(mesh)
    for d in seq_dims:
        if "model" in mesh.axis_names and shape[d] % mesh.shape["model"] == 0 \
                and parts[d] is None:
            parts[d] = "model"
    return tuple(parts)


# ------------------------------------------------------------------ #
def train_batch_specs(cfg: ArchConfig, shape: InputShape, mesh: ProductionMesh):
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
        "mask": _meta((B, S), torch.float32),
    }
    if cfg.family == "encdec":
        specs["frames"] = _meta((B, cfg.encdec.n_frames, cfg.d_model), cfg.torch_dtype)
    if cfg.family == "vlm":
        specs["patches"] = _meta((B, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                 cfg.torch_dtype)
    shardings = {k: data_spec(tuple(v.shape), mesh) for k, v in specs.items()}
    return specs, shardings


def qnet_batch_specs(shape: InputShape, mesh: ProductionMesh, *,
                     n_candidates: int = 160):
    """Replay batch for the paper's DQN train step (damoldqn config)."""
    from repro_torch.core.agent import STATE_DIM
    B = shape.global_batch
    specs = {
        "states": _meta((B, STATE_DIM), torch.float32),
        "rewards": _meta((B,), torch.float32),
        "dones": _meta((B,), torch.float32),
        "next_fps": _meta((B, n_candidates, STATE_DIM), torch.float32),
        "next_mask": _meta((B, n_candidates), torch.float32),
    }
    shardings = {k: data_spec(tuple(v.shape), mesh) for k, v in specs.items()}
    return specs, shardings


# cache leaf -> (rank, the dim sharded over "model" when it divides)
_CACHE_DIMS = {"k": (5, 2), "v": (5, 2), "cross_k": (5, 2), "cross_v": (5, 2),
               "shared_k": (5, 2), "shared_v": (5, 2),     # [L|A, B, S, K, Dh]
               "state": (5, 2),                            # [L, B, H, P, N]
               "conv": (4, 3)}                             # [L, B, W-1, C]


def decode_specs(cfg: ArchConfig, shape: InputShape, mesh: ProductionMesh):
    """(tokens, cache) stand-ins for ``serve_step`` with a ``seq_len``
    cache, and their specs; the cache is ``init_cache`` on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    tokens = _meta((B, 1), torch.int32)
    cache = M.init_cache(cfg, B, S, device="meta")

    def cache_spec(name: str, leaf) -> Spec:
        if name not in _CACHE_DIMS:                       # pos
            return ()
        rank, seq_dim = _CACHE_DIMS[name]
        sp: list = [None] * rank
        if _div(leaf.shape[1], batch_axes(mesh), mesh):
            sp[1] = _batch_part(mesh)
        if "model" in mesh.axis_names and leaf.shape[seq_dim] % mesh.shape["model"] == 0:
            sp[seq_dim] = "model"
        return tuple(sp)

    cache_shardings = {k: cache_spec(k, v) for k, v in cache.items()}
    return tokens, cache, data_spec(tuple(tokens.shape), mesh), cache_shardings


def param_pspecs_for(cfg: ArchConfig, mesh: ProductionMesh, *, fsdp: bool = False):
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    pspecs = M.param_pspecs(cfg, tp=tp)
    if fsdp:
        ba = batch_axes(mesh)
        size = 1
        for a in ba:
            size *= mesh.shape[a]
        pspecs = M.add_fsdp(pspecs, cfg, fsdp_axes=tuple(ba), fsdp_size=size)
    return pspecs


def param_shardings(cfg: ArchConfig, mesh: ProductionMesh, *, fsdp: bool = False):
    """The parameters' shardings: their specs (see the module docstring)."""
    return param_pspecs_for(cfg, mesh, fsdp=fsdp)


def zero_opt_shardings(cfg: ArchConfig, mesh: ProductionMesh, param_pspecs_tree):
    """ZeRO-style: additionally shard optimizer moments over the data axes
    on the first dimension not already taken (beyond-paper option)."""
    ba = batch_axes(mesh)
    axis = ba if len(ba) > 1 else (ba[0] if ba else None)
    size = 1
    for a in (ba or ()):
        size *= mesh.shape[a]

    specs = dict(M.leaves_with_paths(param_pspecs_tree))

    def widen(path, leaf) -> Spec:
        parts = list(specs[path])
        for d, p in enumerate(parts):
            if p is None and axis is not None and leaf.shape[d] % size == 0 \
                    and leaf.shape[d] > 0:
                parts[d] = axis
                break
        return tuple(parts)

    return M._map(widen, M.abstract_params(cfg), with_path=True)


def input_specs(cfg: ArchConfig, shape: InputShape, mesh: ProductionMesh):
    """Unified entry point: ``meta`` stand-ins + shardings for every model
    input of the (arch, input-shape) pair, the dry-run contract.

    train/prefill -> ({"tokens", "labels", "mask", [frames|patches]}, shardings)
    decode        -> ((tokens, cache), (tok_sharding, cache_shardings))
    qnet train    -> (replay batch, shardings)
    """
    if cfg.family == "qnet":
        return qnet_batch_specs(shape, mesh)
    if shape.kind in ("train", "prefill"):
        specs, shardings = train_batch_specs(cfg, shape, mesh)
        if shape.kind == "prefill":
            specs = {k: v for k, v in specs.items() if k not in ("labels", "mask")}
            shardings = {k: v for k, v in shardings.items() if k in specs}
        return specs, shardings
    tokens, cache, tok_sh, cache_sh = decode_specs(cfg, shape, mesh)
    return (tokens, cache), (tok_sh, cache_sh)
