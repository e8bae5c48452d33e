"""Port of ``repro.models.model``: model assembly for every LM family,
forward, the LM loss and one-token decode.

Families: dense (stablelm, yi, granite), moe (mixtral, qwen3-moe: attention
+ a GShard MoE layer, ``models/moe.py``), ssm (mamba2), hybrid (zamba2:
mamba2 blocks + one shared attention block applied every
``shared_attn_every`` layers), encdec (whisper: stub frame embeddings ->
bidirectional encoder -> decoder with cross-attention), vlm (paligemma:
stub patch embeddings -> projector -> prefix-LM decoder over the image
prefix and the text).  The qnet family (``damoldqn``, the paper's DQN) has
its parameter tree here, ``{"layers": [{"w", "b"}, ...]}`` as the
reference's ``QNetwork.init`` builds it; its steps are ``launch/steps.py``'s
and its model lives in ``repro_torch.core``.

Parameters are the reference's tree: nested dicts, per-layer leaves
stacked on a leading ``[L, ...]`` axis, each leaf in its own type (the SSM's
``A_log``, ``D_skip`` and ``dt_bias`` stay f32 in a bf16 tree).
``params_from_numpy`` / ``params_to_numpy`` carry a reference tree across
(``jax.tree_util.tree_map(np.asarray, params)``) bit for bit.  The forward
walks the layers in a Python loop over views of the stacked leaves, each
leaf unbound once per forward (under autograd, ``t[i]`` per layer would
build a zero tensor of the whole ``[L, ...]`` leaf in each layer's
backward; ``unbind``'s backward stacks the layers' gradients once).  With
``cfg.remat`` and grad enabled each block is checkpointed, as the
reference's ``_stack_scan`` does.  With ``cfg.use_pallas`` attention and
the SSD scan go through the hand-written CUDA kernels, exactly where the
reference goes through Pallas (every self-attention, the encoder's
bidirectional one included; whisper's cross-attention stays plain, as the
reference passes no ``use_pallas`` there); they are forward only and refuse autograd,
so ``loss_fn`` trains through the plain routes, as the reference does.
An LM runs on one device.  The sharding plan is data, as the dry-run
reads it: ``abstract_params`` is the ``meta`` tree, ``param_pspecs`` gives
each leaf a tuple with one entry per dim (a mesh axis name, a tuple of
names, or ``None``) by the reference's policy, and ``add_fsdp`` widens the
large leaves over the data axes.  Nothing places a tensor by them: the
reference's sequence-parallel constraint (``_seq_shard``) has no
counterpart, and ``launch/dryrun.py`` counts the collectives they imply.

Decode (``serve_step``) is plain PyTorch, as the reference's is plain
JAX.  It writes the new key and value into the KV cache's ring slot and the
new conv window and SSM state into their stacked cache tensors IN PLACE
(the reference returns fresh arrays): at long contexts the cache is the
model's largest tensor, and a copy per token would double it.  The cache's
``pos`` is a Python int, so the ring slot needs no device sync.  As in the
reference, nothing fills the encdec cross K/V or the vlm image-prefix slots
of a fresh cache: decode attends to those zeros (ROADMAP C3).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm

PyTree = Any
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _require_family(cfg: ArchConfig) -> None:
    """The LM paths (forward, cache, decode) take the LM families only; the
    qnet family raises ``ValueError`` there, as the reference's
    ``init_cache`` does: its forward is the Q-network's."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.family} is not an LM family")


# ================================================================== #
# parameter construction
# ================================================================== #
def _ones(lead, n, dtype, device):
    return torch.ones((*lead, n), dtype=dtype, device=device)


def _block_init(gen, cfg: ArchConfig, dtype, *, cross: bool = False, lead=(),
                device=None) -> dict:
    """One transformer block (attn [+ cross-attn] + mlp/moe) param group."""
    kw = dict(lead=lead, device=device)
    p = {
        "norm1": _ones(lead, cfg.d_model, dtype, device),
        "attn": Lyr.attn_params_init(gen, cfg, dtype, **kw),
        "norm2": _ones(lead, cfg.d_model, dtype, device),
    }
    if cross:
        p["norm_x"] = _ones(lead, cfg.d_model, dtype, device)
        p["cross"] = Lyr.attn_params_init(gen, cfg, dtype, **kw)
    if cfg.family == "moe":
        p["moe"] = Moe.moe_params_init(gen, cfg, dtype, **kw)
    elif cfg.d_ff > 0:
        p["mlp"] = Lyr.mlp_params_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                       dtype, **kw)
    return p


def _mamba_block_init(gen, cfg: ArchConfig, dtype, *, lead=(), device=None) -> dict:
    return {
        "norm1": _ones(lead, cfg.d_model, dtype, device),
        "ssm": Ssm.ssm_params_init(gen, cfg, dtype, lead=lead, device=device),
    }


def _hybrid_shared_init(gen, cfg: ArchConfig, dtype, *, device=None) -> dict:
    """Zamba2's shared attention(+MLP) block: ONE copy reused."""
    return {
        "norm1": _ones((), cfg.d_model, dtype, device),
        "attn": Lyr.attn_params_init(gen, cfg, dtype, device=device),
        "norm2": _ones((), cfg.d_model, dtype, device),
        "mlp": Lyr.mlp_params_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                   device=device),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> PyTree:
    """Random parameters in the reference's tree layout and types, drawn on
    ``device`` (default: the GPU) from a ``torch.Generator`` seeded with
    ``seed``.  The values differ from ``repro``'s ``init_params`` (another
    generator); carry a reference tree over with ``params_from_numpy``.
    ``device="meta"`` builds the shapes and types only.  The qnet family
    gets ``QNetwork``'s tree: He-normal ``w [in, out]`` and zero ``b``."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "qnet":
        from repro_torch.core.agent import HIDDEN_SIZES, STATE_DIM
        sizes = (STATE_DIM, *HIDDEN_SIZES, 1)
        return {"layers": [
            {"w": Lyr.dense_init(gen, (i, o), torch.float32, (2.0 / i) ** 0.5,
                                 device=device),
             "b": torch.zeros((o,), dtype=torch.float32, device=device)}
            for i, o in zip(sizes[:-1], sizes[1:])]}
    _require_family(cfg)
    dtype = cfg.torch_dtype
    kw = dict(device=device)
    params: dict = {
        "embed": Lyr.dense_init(gen, (cfg.vocab, cfg.d_model), dtype, 0.02, **kw),
        "final_norm": _ones((), cfg.d_model, dtype, device),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = Lyr.dense_init(gen, (cfg.d_model, cfg.vocab), dtype, **kw)
    lead = (cfg.n_layers,)
    if cfg.family in ("dense", "moe", "vlm"):
        params["blocks"] = _block_init(gen, cfg, dtype, lead=lead, **kw)
    elif cfg.family == "encdec":
        params["blocks"] = _block_init(gen, cfg, dtype, cross=True, lead=lead, **kw)
        params["enc_blocks"] = _block_init(gen, cfg, dtype,
                                           lead=(cfg.encdec.n_enc_layers,), **kw)
        params["enc_pos"] = Lyr.dense_init(gen, (cfg.encdec.n_frames, cfg.d_model),
                                           dtype, 0.02, **kw)
        params["enc_final_norm"] = _ones((), cfg.d_model, dtype, device)
    else:
        params["blocks"] = _mamba_block_init(gen, cfg, dtype, lead=lead, **kw)
    if cfg.family == "hybrid":
        params["shared_attn"] = _hybrid_shared_init(gen, cfg, dtype, **kw)
    if cfg.family == "vlm":
        params["vision_proj"] = {
            "w": Lyr.dense_init(gen, (cfg.vlm.vision_dim, cfg.d_model), dtype, **kw),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        }
    return params


def _map(fn, tree: PyTree, path: tuple[str, ...] = (), *,
         with_path: bool = False) -> PyTree:
    """``fn`` on every leaf of a tree of dicts and lists, keeping its keys
    and order; with ``with_path``, ``fn(path, leaf)`` with the leaf's key
    path (list indices as strings, as the reference's ``_key_str``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),), with_path=with_path)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (str(i),), with_path=with_path)
                for i, v in enumerate(tree)]
    return fn(path, tree) if with_path else fn(tree)


def leaves_with_paths(tree: PyTree, path: tuple[str, ...] = ()):
    """``(path, leaf)`` for every leaf of a tree of dicts and lists, in its
    key order, with ``_map``'s paths (a spec tuple is one leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (str(i),))
    else:
        yield path, tree


def abstract_params(cfg: ArchConfig) -> PyTree:
    """The parameter tree's shapes and types on the ``meta`` device, with
    no allocation (the dry-run path)."""
    return init_params(cfg, device="meta")


def count_params(cfg: ArchConfig) -> int:
    """Parameter count from a shape-only (``meta``) tree: no allocation."""
    return sum(math.prod(t.shape) for _, t in leaves_with_paths(abstract_params(cfg)))


def active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: top_k of E experts)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    # expert weights are [E, D, F] x3 per layer
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    expert_total = cfg.n_layers * 3 * cfg.d_model * cfg.d_ff * E
    return total - expert_total + expert_total * K // E


# ------------------------------------------------------------------ #
# weight carry-over
# ------------------------------------------------------------------ #
def _bf16_numpy_dtype() -> np.dtype:
    try:
        return np.dtype("bfloat16")
    except TypeError as e:          # numpy knows bfloat16 only once ml_dtypes is loaded
        raise TypeError("numpy has no bfloat16 type registered here; import "
                        "ml_dtypes (as JAX does) to exchange bf16 leaves") from e


def params_from_numpy(tree: PyTree, *,
                      device: str | torch.device | None = None) -> PyTree:
    """The reference's parameter tree (numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as tensors on ``device``
    (default: the GPU): the same key paths, stacked layouts and per-leaf
    types, bit for bit.  bf16 leaves (``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` refuses) cross as their uint16 bits."""
    device = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)

    return _map(leaf, tree)


def params_to_numpy(params: PyTree) -> PyTree:
    """The inverse of ``params_from_numpy``: numpy arrays in the reference's
    types (bf16 as ``np.dtype("bfloat16")``, which needs ml_dtypes loaded)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_bf16_numpy_dtype())
        return t.numpy()

    return _map(leaf, params)


def _layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return _map(lambda t: t[i], tree)


def _unstack(tree: PyTree, n: int) -> list[PyTree]:
    """The ``n`` layers of a stacked tree, each leaf unbound once (views)."""
    flat = _map(torch.unbind, tree)
    return [_map(lambda layers: layers[i], flat) for i in range(n)]


# ================================================================== #
# forward passes
# ================================================================== #
def _dense_block_fwd(cfg: ArchConfig, p: dict, h: torch.Tensor, positions,
                     aux: torch.Tensor, *, causal: bool = True,
                     prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    x = Lyr.rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + Lyr.attn_forward(p["attn"], x, positions, theta=cfg.rope_theta,
                             causal=causal, window=cfg.attn_window,
                             prefix_len=prefix_len, use_pallas=cfg.use_pallas)
    x = Lyr.rms_norm(h, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        y, a = Moe.moe_forward(p["moe"], x, cfg)
        h = h + y
        aux = aux + a
    elif "mlp" in p:
        h = h + Lyr.mlp_forward(p["mlp"], x, cfg.act)
    return h, aux


def _dec_block_fwd(cfg: ArchConfig, p: dict, h: torch.Tensor, positions,
                   memory: torch.Tensor) -> torch.Tensor:
    """An encdec decoder block: causal self-attention (the kernel with
    ``use_pallas``), plain cross-attention over the encoder memory, MLP."""
    x = Lyr.rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + Lyr.attn_forward(p["attn"], x, positions, theta=cfg.rope_theta,
                             causal=True, use_pallas=cfg.use_pallas)
    x = Lyr.rms_norm(h, p["norm_x"], cfg.norm_eps)
    h = h + Lyr.attn_forward(p["cross"], x, positions, theta=cfg.rope_theta,
                             causal=False, kv_override=Lyr.cross_kv(p["cross"], memory),
                             rope=False)
    x = Lyr.rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + Lyr.mlp_forward(p["mlp"], x, cfg.act)


def _mamba_block_fwd(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    x = Lyr.rms_norm(h, p["norm1"], cfg.norm_eps)
    return h + Ssm.ssm_forward(p["ssm"], x, cfg, use_pallas=cfg.use_pallas)


def _shared_attn_fwd(cfg: ArchConfig, p: dict, h: torch.Tensor, positions) -> torch.Tensor:
    x = Lyr.rms_norm(h, p["norm1"], cfg.norm_eps)
    h = h + Lyr.attn_forward(p["attn"], x, positions, theta=cfg.rope_theta,
                             window=cfg.attn_window, use_pallas=cfg.use_pallas)
    x = Lyr.rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + Lyr.mlp_forward(p["mlp"], x, cfg.act)


def forward_train(params: PyTree, cfg: ArchConfig,
                  batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V], aux_loss scalar)."""
    h, aux = forward_hidden(params, cfg, batch)
    return _unembed(params, cfg, h), aux


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _embed(params: PyTree, tokens) -> torch.Tensor:
    """Token embeddings; ``tokens`` ([B, S] ints) moved to the parameters'
    device.  F.embedding, not embed[tokens]: the same rows, and a backward
    that sums each row's gradients in a fixed order (index_put's accumulate
    does not)."""
    embed = params["embed"]
    return F.embedding(torch.as_tensor(tokens, device=embed.device).long(), embed)


def _batch_input(batch: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    """``batch[key]`` (an array or tensor of stub embeddings) in the
    model's type on its device."""
    return torch.as_tensor(batch[key]).to(device=like.device, dtype=like.dtype)


def forward_hidden(params: PyTree, cfg: ArchConfig,
                   batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states [B,S,D] (text positions only for the vlm)
    and the aux loss.  ``batch["tokens"]`` is a [B, S] int tensor or array
    (with ``batch["patches"]`` [B, n_patches, vision_dim] for the vlm and
    ``batch["frames"]`` [B, T, D] for encdec); all are moved to the
    parameters' device."""
    _require_family(cfg)
    if cfg.family == "encdec":
        return _forward_encdec_hidden(params, cfg, batch)
    h = _embed(params, batch["tokens"])
    prefix_len = 0
    if cfg.family == "vlm":
        vp = params["vision_proj"]
        himg = _batch_input(batch, "patches", h) @ vp["w"] + vp["b"]
        h = torch.cat([himg, h], dim=1)
        prefix_len = cfg.vlm.n_patches
    B, S = h.shape[:2]
    positions = _positions(B, S, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    layers = _unstack(params["blocks"], cfg.n_layers)
    # per-block remat of the stacked layers, as the reference's _stack_scan;
    # the hybrid's shared block sits outside the scan there and here
    block = Lyr.remat if cfg.remat else (lambda fn, *a: fn(*a))
    if cfg.family in ("dense", "moe", "vlm"):
        fwd = partial(_dense_block_fwd, cfg, prefix_len=prefix_len)
        for lp in layers:
            h, aux = block(fwd, lp, h, positions, aux)
    elif cfg.family == "ssm":
        for lp in layers:
            h = block(partial(_mamba_block_fwd, cfg), lp, h)
    else:   # hybrid: k mamba layers, then the shared attention block
        for lo, hi, with_attn in _hybrid_segments(cfg):
            for lp in layers[lo:hi]:
                h = block(partial(_mamba_block_fwd, cfg), lp, h)
            if with_attn:
                h = _shared_attn_fwd(cfg, params["shared_attn"], h, positions)

    h = Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h[:, prefix_len:], aux


def _forward_encdec_hidden(params: PyTree, cfg: ArchConfig,
                           batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Stub frames [B, T, D] + ``enc_pos`` -> the bidirectional encoder
    (its self-attention ``causal=False``) -> ``memory``; tokens -> the
    decoder with cross-attention over it."""
    block = Lyr.remat if cfg.remat else (lambda fn, *a: fn(*a))
    frames = _batch_input(batch, "frames", params["enc_pos"])
    B, T, _ = frames.shape
    hm = frames + params["enc_pos"][None, :T]
    pos_e = _positions(B, T, hm.device)
    aux = torch.zeros((), dtype=torch.float32, device=hm.device)
    enc = partial(_dense_block_fwd, cfg, causal=False)
    for lp in _unstack(params["enc_blocks"], cfg.encdec.n_enc_layers):
        hm, _ = block(enc, lp, hm, pos_e, aux)     # the encoder's aux is dropped
    memory = Lyr.rms_norm(hm, params["enc_final_norm"], cfg.norm_eps)

    h = _embed(params, batch["tokens"])
    pos_d = _positions(*h.shape[:2], h.device)
    for lp in _unstack(params["blocks"], cfg.n_layers):
        h = block(partial(_dec_block_fwd, cfg), lp, h, pos_d, memory)
    return Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def _hybrid_segments(cfg: ArchConfig) -> list[tuple[int, int, bool]]:
    """(layer_lo, layer_hi, apply_shared_attn) segments: the shared block
    runs after layers k-1, 2k-1, ... (matching the original cond-in-scan
    schedule)."""
    k = cfg.shared_attn_every
    out = []
    lo = 0
    while lo < cfg.n_layers:
        hi = min(lo + k, cfg.n_layers)
        out.append((lo, hi, hi - lo == k))
        lo = hi
    return out


def hybrid_n_apps(cfg: ArchConfig) -> int:
    return sum(1 for _, _, a in _hybrid_segments(cfg) if a)


def _unembed(params, cfg, h):
    if cfg.tied_embeddings:
        return h @ params["embed"].T
    return h @ params["unembed"]


_LOSS_CHUNK = 512


def _xent_chunk(params, cfg, h, labels, mask):
    """f32 cross-entropy summed over one sequence chunk, with the
    reference's one-hot (iota-compare) contraction for the label logit."""
    logits = _unembed(params, cfg, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None] == iota).to(logits.dtype)
    ll = torch.sum(logits * onehot, dim=-1)
    return torch.sum((logz - ll) * mask)


def loss_fn(params: PyTree, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Masked LM cross-entropy + the aux loss (the MoE load balance; 0 for
    the other families).

    ``batch`` holds ``tokens``, ``labels`` and ``mask`` ([B, S], arrays or
    tensors; moved to the parameters' device), and the vlm's ``patches`` or
    encdec's ``frames`` (see ``forward_hidden``).  When ``S`` is a multiple of
    512 above it, the unembed and softmax run in 512-token chunks, each
    checkpointed under grad, so the f32 logits working set is ``[B, 512,
    V]``; the chunks' sums add in sequence order, as the reference's scan."""
    h, aux = forward_hidden(params, cfg, batch)
    labels = torch.as_tensor(batch["labels"], device=h.device).long()
    mask = torch.as_tensor(batch["mask"], device=h.device).float()
    S = labels.shape[1]
    chunk = _LOSS_CHUNK if (S % _LOSS_CHUNK == 0 and S > _LOSS_CHUNK) else S
    if chunk == S:
        total = _xent_chunk(params, cfg, h, labels, mask)
    else:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, S, chunk):
            c = slice(lo, lo + chunk)
            total = total + Lyr.remat(partial(_xent_chunk, params, cfg),
                                      h[:, c], labels[:, c], mask[:, c])
    return total / torch.clamp(mask.sum(), min=1.0) + aux


# ================================================================== #
# decode (serve_step)
# ================================================================== #
def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Ring-buffer length: the window for SWA archs, else the full seq."""
    if cfg.attn_window is not None and cfg.attn_window < seq_len:
        return cfg.attn_window
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               device: str | torch.device | None = None) -> PyTree:
    """Zero cache on ``device`` (default: the GPU), in the config's type;
    ``pos`` is a Python int."""
    _require_family(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    L, K, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    Sc = cache_len(cfg, seq_len)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "moe", "vlm"):
        S_tot = Sc + (cfg.vlm.n_patches if cfg.family == "vlm" else 0)
        return {"k": zeros(L, batch, S_tot, K, Dh), "v": zeros(L, batch, S_tot, K, Dh),
                "pos": 0}
    if cfg.family == "encdec":
        T = cfg.encdec.n_frames
        return {"k": zeros(L, batch, Sc, K, Dh), "v": zeros(L, batch, Sc, K, Dh),
                "cross_k": zeros(L, batch, T, K, Dh),
                "cross_v": zeros(L, batch, T, K, Dh), "pos": 0}
    d = Ssm.ssm_dims(cfg)
    cache = {
        "conv": zeros(L, batch, cfg.ssm.conv_width - 1, d["conv_dim"]),
        "state": zeros(L, batch, d["n_heads"], cfg.ssm.head_dim, cfg.ssm.state_dim),
    }
    if cfg.family == "hybrid":
        # ONE KV cache per shared-block application: weights are shared,
        # the attended activations are not
        napps = hybrid_n_apps(cfg)
        cache["shared_k"] = zeros(napps, batch, Sc, K, Dh)
        cache["shared_v"] = zeros(napps, batch, Sc, K, Dh)
    cache["pos"] = 0
    return cache


def _decode_attn(cfg, p, x, pos: int, ck, cv, Sc: int, *, prefix_len: int = 0):
    """One-token attention against a (ring) cache.

    x [B,1,D]; ck/cv [B,Sc(+prefix),K,Dh], written in place at the ring
    slot; pos the absolute position.  Keys are stored ALREADY rotated.
    Returns out [B,1,D]."""
    B = x.shape[0]
    q = Lyr._proj(x, p["wq"])
    k_new = Lyr._proj(x, p["wk"])
    v_new = Lyr._proj(x, p["wv"])
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = Lyr.apply_rope(q, posv, cfg.rope_theta)
    k_new = Lyr.apply_rope(k_new, posv, cfg.rope_theta)

    slot = prefix_len + (pos % Sc)
    ck[:, slot] = k_new[:, 0]
    cv[:, slot] = v_new[:, 0]

    # a ring slot is valid iff it holds a real position: 0 <= abs <= pos
    # (and inside the window); prefix slots are always valid
    s_idx = torch.arange(ck.shape[1], device=x.device)
    ring = s_idx >= prefix_len
    abs_pos = torch.where(ring, _ring_abs_pos(s_idx - prefix_len, pos, Sc),
                          torch.zeros_like(s_idx))
    valid = torch.where(ring, (abs_pos <= pos) & (abs_pos >= 0),
                        torch.ones_like(ring))
    if cfg.attn_window is not None:
        valid = valid & torch.where(ring, abs_pos > pos - cfg.attn_window,
                                    torch.ones_like(ring))
    mask = valid[None, None, :].expand(B, 1, ck.shape[1])
    out = Lyr.gqa_attention(q, ck, cv, mask)
    wo = p["wo"]
    return out.reshape(B, 1, -1) @ wo.reshape(-1, wo.shape[-1])


def _ring_abs_pos(slot: torch.Tensor, pos: int, Sc: int) -> torch.Tensor:
    """Absolute position stored in ring slot ``slot`` after writing ``pos``."""
    cur_slot = pos % Sc
    base = pos - cur_slot
    return torch.where(slot <= cur_slot, base + slot, base - Sc + slot)


def serve_step(params: PyTree, cfg: ArchConfig, cache: PyTree,
               tokens) -> tuple[torch.Tensor, PyTree]:
    """Decode ONE token: tokens [B,1] -> (logits [B,1,V], cache).  The
    cache's tensors are updated in place; the returned dict shares them and
    has ``pos`` advanced by one."""
    _require_family(cfg)
    pos = int(cache["pos"])
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    h = embed[tokens]

    def mamba(i, h):
        x = Lyr.rms_norm(h, params["blocks"]["norm1"][i], cfg.norm_eps)
        y, conv, state = Ssm.ssm_decode_step(
            _layer(params["blocks"]["ssm"], i), x, cfg, cache["conv"][i],
            cache["state"][i])
        cache["conv"][i] = conv
        cache["state"][i] = state
        return h + y

    if cfg.family in ("dense", "moe", "vlm"):
        prefix = cfg.vlm.n_patches if cfg.family == "vlm" else 0
        Sc = cache["k"].shape[2] - prefix
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            x = Lyr.rms_norm(h, lp["norm1"], cfg.norm_eps)
            h = h + _decode_attn(cfg, lp["attn"], x, pos, cache["k"][i],
                                 cache["v"][i], Sc, prefix_len=prefix)
            x = Lyr.rms_norm(h, lp["norm2"], cfg.norm_eps)
            if "moe" in lp:
                h = h + Moe.moe_forward(lp["moe"], x, cfg)[0]
            else:
                h = h + Lyr.mlp_forward(lp["mlp"], x, cfg.act)
    elif cfg.family == "encdec":
        zero_pos = torch.zeros((h.shape[0], 1), dtype=torch.int32, device=h.device)
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            x = Lyr.rms_norm(h, lp["norm1"], cfg.norm_eps)
            h = h + _decode_attn(cfg, lp["attn"], x, pos, cache["k"][i],
                                 cache["v"][i], cache["k"].shape[2])
            x = Lyr.rms_norm(h, lp["norm_x"], cfg.norm_eps)
            h = h + Lyr.attn_forward(
                lp["cross"], x, zero_pos, theta=cfg.rope_theta, causal=False,
                kv_override=(cache["cross_k"][i], cache["cross_v"][i]), rope=False)
            x = Lyr.rms_norm(h, lp["norm2"], cfg.norm_eps)
            h = h + Lyr.mlp_forward(lp["mlp"], x, cfg.act)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = mamba(i, h)
    else:   # hybrid: per-application shared KV caches
        shared = params["shared_attn"]
        app = 0
        for lo, hi, with_attn in _hybrid_segments(cfg):
            for i in range(lo, hi):
                h = mamba(i, h)
            if with_attn:
                x = Lyr.rms_norm(h, shared["norm1"], cfg.norm_eps)
                h = h + _decode_attn(cfg, shared["attn"], x, pos,
                                     cache["shared_k"][app],
                                     cache["shared_v"][app],
                                     cache["shared_k"].shape[2])
                x = Lyr.rms_norm(h, shared["norm2"], cfg.norm_eps)
                h = h + Lyr.mlp_forward(shared["mlp"], x, cfg.act)
                app += 1

    h = Lyr.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, h), {**cache, "pos": pos + 1}


# ================================================================== #
# sharding plan (data only: the dry-run reads it)
# ================================================================== #
Spec = tuple            # one entry per leaf dim: an axis name, a tuple of names, or None


def _axis_for(dim: int, tp: int) -> bool:
    return dim % tp == 0


def add_fsdp(pspecs: PyTree, cfg: ArchConfig, *, fsdp_axes: tuple[str, ...],
             fsdp_size: int, min_elements: int = 1_000_000) -> PyTree:
    """FSDP/ZeRO-3: additionally shard every large leaf over the data axes.

    Picks the first unassigned dim divisible by the data-axis product,
    skipping the stacked-layer dim 0 (the reference's scan axis), as the
    reference's ``add_fsdp`` does; leaves under ``min_elements`` keep
    their spec."""
    specs = dict(leaves_with_paths(pspecs))
    axis = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]

    def widen(path, leaf) -> Spec:
        spec = specs[path]
        if math.prod(leaf.shape) < min_elements:
            return spec
        parts = list(spec)
        start = 1 if leaf.dim() >= 2 and leaf.shape[0] <= 256 else 0
        for d in range(start, len(parts)):
            if parts[d] is None and leaf.shape[d] % fsdp_size == 0:
                parts[d] = axis
                return tuple(parts)
        return spec

    return _map(widen, abstract_params(cfg), with_path=True)


def param_pspecs(cfg: ArchConfig, tp: int = 16, model_axis: str = "model") -> PyTree:
    """A spec for every leaf of ``abstract_params(cfg)``, in its tree.

    The reference's policy, rule by rule (tensor and expert parallel over
    ``model_axis``; batch-like dims are the activations' business):
      * embed [V,D] -> (model, None); unembed [D,V] -> (None, model)
      * attention: shard the head dim when divisible by tp, else the
        d_model input dim (row parallel), else replicate; with
        ``cfg.seq_shard`` an indivisible head count replicates instead
      * mlp w1/w3 [D,F] -> (None, model); w2 [F,D] -> (model, None)
      * moe experts [E,D,F] -> (model, None, None) when E % tp == 0
        (expert parallel: qwen3) else (None, None, model) (mixtral)
      * ssm projections: the inner dim on model
      * norms, scalars, the qnet's layers: replicated
    Every spec lists one entry per dim (the reference's ``P(...)`` may be
    shorter: its missing entries are ``None``)."""
    M = model_axis

    def attn_spec(name: str, shape) -> Spec:
        if name == "wo":                       # [H, Dh, D]
            if _axis_for(shape[0], tp):
                return (M, None, None)
            if cfg.seq_shard:
                # replicated compute, FSDP shards storage: row-parallel D
                # under seq-sharded activations all-reduces partial logits
                # every layer, as the reference measured
                return (None, None, None)
            if _axis_for(shape[2], tp):
                return (None, None, M)
            return (None, None, None)
        # wq/wk/wv [D, H_or_K, Dh]
        if _axis_for(shape[1], tp):
            return (None, M, None)
        if cfg.seq_shard:
            return (None, None, None)
        if _axis_for(shape[0], tp):
            return (M, None, None)
        return (None, None, None)

    def spec_for(path: tuple[str, ...], leaf) -> Spec:
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        shape = tuple(leaf.shape)
        off = 1 if path[0] in ("blocks", "enc_blocks") else 0   # leading L dim

        def pad(spec: Spec) -> Spec:
            return (None,) * off + spec

        if name == "embed":
            return (M, None) if _axis_for(shape[0], tp) else (
                (None, M) if _axis_for(shape[1], tp) else (None, None))
        if name == "unembed":
            if _axis_for(shape[1], tp):
                return (None, M)
            return (M, None) if _axis_for(shape[0], tp) else (None, None)
        if name == "enc_pos":
            return (None, None)
        if parent in ("attn", "cross") or (parent == "shared_attn" and name in
                                           ("wq", "wk", "wv", "wo")):
            return pad(attn_spec(name, shape[off:]))
        if parent == "mlp" or (parent == "shared_attn" and name in ("w1", "w2", "w3")):
            return pad((None, M) if name in ("w1", "w3") else (M, None))
        if parent == "moe":
            if name == "router":
                return pad((None, None))
            if _axis_for(shape[off], tp):
                return pad((M, None, None))
            return pad((None, None, M) if name in ("w1", "w3") else (None, M, None))
        if parent == "ssm":
            rest = len(shape) - off
            if name in ("in_z", "in_xbc"):
                return pad((None, M))
            if name == "in_dt":
                return pad((None, M) if _axis_for(shape[off + 1], tp) else (None, None))
            if name in ("conv_w", "conv_b"):
                return pad((None,) * (rest - 1) + (M,))
            if name == "out_proj":
                return pad((M, None))
            if name == "gate_norm":
                return pad((M,) if _axis_for(shape[off], tp) else (None,))
            return pad((None,) * rest)
        if parent == "vision_proj":
            return (None, M) if name == "w" else (M,)
        # norms, scalars, biases, the qnet's layers
        return (None,) * len(shape)

    return _map(spec_for, abstract_params(cfg), with_path=True)
