"""Plain PyTorch reference of Moonlight-16B-A3B's training step on one
device's share of an expert-parallel deployment (the benchmark's copy; it
imports nothing of the program).

f32 with TF32 off, at the published widths, in blocks that fit: a layer
at a time (each checkpointed under grad), attention a sequence and a
query block at a time (each block checkpointed), the loss a sequence at a
time.  Its parts, as the papers give them:

* MLA (DeepSeek-V2, arXiv:2405.04434 §2.1) with the latent materialised:
  q = x wq; [c | k_r] = x wkv_a; c = RMSNorm(c); [k_n | v] = c wkv_b; the
  one RoPE key k_r is shared by every head; softmax(q k^T / sqrt(192)),
  causal; y = o wo.  RoPE turns interleaved pairs (the published pairing).
* DeepSeek-V3's router (arXiv:2412.19437 §2.1.2): sigmoid scores in f32,
  the top K of scores + bias select, the unbiased scores of the chosen
  weigh, renormalised, times the routed scaling factor.
* The experts this device holds, each over the tokens that chose it (a
  loop over experts and a boolean selection; no sort, no capacity); the
  shared experts (one SwiGLU of n_shared x F) for every token.  What the
  other experts would add is left out, as in the program.
* The sequence-wise balance loss (eqs. 17-20), the LM loss over the
  sliced vocabulary, gradients by autograd, Adam (the port's formulas:
  the global-norm clip, f32 moments, bias corrections, ``eps`` after the
  square root), parameters stored in their own types (bf16 matrices,
  f32 norms, router and bias), and the bias step after each step.

Departures: none from the papers' equations; the deployment's exchange
(all-to-all) and the absent experts are left out by design.  The
parameter tree is the program's layout (stacked ``[L, ...]`` leaves), made
here from the seed (``init_params``).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 1024


@dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    first_dense: int
    dense_d_ff: int
    d_ff: int
    n_experts: int          # the router's width
    top_k: int
    expert_first: int       # the experts held here: [first, first + count)
    expert_count: int
    n_shared: int
    routed_scale: float
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_dim: int
    rope_theta: float
    norm_eps: float
    kv_norm_eps: float
    seq_aux_weight: float
    bias_rate: float


def dims_from_config(c: dict) -> Dims:
    """The benchmark configuration file's keys (Moonlight's config.json
    names; ``n_routed_experts`` is the count held here, ``router_experts``
    the router's width)."""
    return Dims(
        vocab=c["vocab_size"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_layers=c["num_hidden_layers"],
        first_dense=c["first_k_dense_replace"], dense_d_ff=c["intermediate_size"],
        d_ff=c["moe_intermediate_size"], n_experts=c["router_experts"],
        top_k=c["num_experts_per_tok"], expert_first=c["expert_first"],
        expert_count=c["n_routed_experts"], n_shared=c["n_shared_experts"],
        routed_scale=c["routed_scaling_factor"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope=c["qk_nope_head_dim"],
        qk_rope=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        kv_norm_eps=c["kv_norm_eps"], seq_aux_weight=c["seq_aux_alpha"],
        bias_rate=c["bias_update_rate"])


@contextmanager
def no_tf32():
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, dnn


# ------------------------------------------------------------------ #
# parameters and inputs from the seed
# ------------------------------------------------------------------ #
def init_params(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The program's tree, drawn on ``device`` from ``seed``: N(0, 1) x
    fan_in ** -0.5 in f32, cast to ``dtype`` (embedding 0.02, ``wo`` (H
    dv) ** -0.5); norm scales ones and the router f32, the bias zeros."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def w(shape, lead=(), scale=None, dt=dtype):
        s = scale if scale is not None else shape[0] ** -0.5
        return (torch.randn((*lead, *shape), generator=gen, dtype=torch.float32,
                            device=device) * s).to(dt)

    def ones(lead, n):
        return torch.ones((*lead, n), dtype=torch.float32, device=device)

    D, H, r = d.d_model, d.n_heads, d.kv_lora_rank

    def block(lead, moe: bool):
        p = {"norm1": ones(lead, D),
             "attn": {"wq": w((D, H, d.qk_nope + d.qk_rope), lead),
                      "wkv_a": w((D, r + d.qk_rope), lead),
                      "kv_norm": ones(lead, r),
                      "wkv_b": w((r, H, d.qk_nope + d.v_dim), lead),
                      "wo": w((H, d.v_dim, D), lead, (H * d.v_dim) ** -0.5)},
             "norm2": ones(lead, D)}
        if moe:
            E, Fd, n = d.n_experts, d.d_ff, d.expert_count
            p["moe"] = {"router": w((D, E), lead, dt=torch.float32),
                        "bias": torch.zeros((*lead, E), dtype=torch.float32,
                                            device=device),
                        "w1": w((n, D, Fd), lead, D ** -0.5),
                        "w3": w((n, D, Fd), lead, D ** -0.5),
                        "w2": w((n, Fd, D), lead, Fd ** -0.5)}
            if d.n_shared:
                Fs = d.n_shared * Fd
                p["moe"]["shared"] = {"w1": w((D, Fs), lead), "w2": w((Fs, D), lead),
                                      "w3": w((D, Fs), lead)}
        else:
            p["mlp"] = {"w1": w((D, d.dense_d_ff), lead), "w2": w((d.dense_d_ff, D), lead),
                        "w3": w((D, d.dense_d_ff), lead)}
        return p

    tree = {"embed": w((d.vocab, D), scale=0.02), "final_norm": ones((), D),
            "unembed": w((D, d.vocab))}
    if d.first_dense:
        tree["dense_blocks"] = block((d.first_dense,), False)
    tree["blocks"] = block((d.n_layers - d.first_dense,), True)
    return tree


def zipf_batch(gen: torch.Generator, batch: int, seq: int, perm: torch.Tensor,
               s: float = 1.0) -> dict:
    """``batch`` sequences of ``seq + 1`` ids: Zipf ranks (P(r) ~ r^-s) over
    the vocabulary, ``perm`` maps rank to id; tokens, next-token labels,
    mask."""
    probs = torch.arange(1, perm.numel() + 1, dtype=torch.float32,
                         device=perm.device) ** -s
    ranks = torch.multinomial(probs, batch * (seq + 1), replacement=True,
                              generator=gen).view(batch, seq + 1)
    ids = perm[ranks]
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous(),
            "mask": torch.ones((batch, seq), dtype=torch.float32, device=perm.device)}


# ------------------------------------------------------------------ #
# the forward pass, f32
# ------------------------------------------------------------------ #
def rms_norm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x, pos, theta):
    """x [S, n, e], pos [S]: pair (x[2i], x[2i+1]) turns by pos theta^(-2i/e)."""
    e = x.shape[-1]
    inv = theta ** (-torch.arange(0, e, 2, dtype=torch.float32, device=x.device) / e)
    ang = pos.float()[:, None] * inv                                # [S, e/2]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).flatten(-2)


def _attn_block(q, k, v, q0: int):
    """q [n, H, e] at positions q0..q0+n-1; k [m, H, e], v [m, H, dv] at
    0..m-1 (m = q0 + n): causal softmax attention -> [n, H, dv]."""
    n, m = q.shape[0], k.shape[0]
    s = torch.einsum("nhe,mhe->hnm", q, k) * q.shape[-1] ** -0.5
    keep = torch.arange(m, device=q.device)[None, :] <= \
        (q0 + torch.arange(n, device=q.device))[:, None]
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("hnm,mhd->nhd", torch.softmax(s, dim=-1), v)


def mla(p, x, d: Dims):
    """x [B, S, D] f32 -> [B, S, D]."""
    B, S, _ = x.shape
    dn, r = d.qk_nope, d.kv_lora_rank
    pos = torch.arange(S, device=x.device)
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].float())
    ckv = x @ p["wkv_a"].float()
    c = rms_norm(ckv[..., :r], p["kv_norm"], d.kv_norm_eps)           # the latent
    kv = torch.einsum("bsr,rhe->bshe", c, p["wkv_b"].float())
    outs = []
    for b in range(B):
        qb = torch.cat([q[b, :, :, :dn], rope(q[b, :, :, dn:], pos, d.rope_theta)], -1)
        kr = rope(ckv[b, :, None, r:], pos, d.rope_theta)               # [S, 1, dr]
        kb = torch.cat([kv[b, :, :, :dn], kr.expand(S, d.n_heads, d.qk_rope)], -1)
        vb = kv[b, :, :, dn:]
        for q0 in range(0, S, Q_BLOCK):
            q1 = min(q0 + Q_BLOCK, S)
            args = (qb[q0:q1], kb[:q1], vb[:q1], q0)
            outs.append(checkpoint(_attn_block, *args, use_reentrant=False)
                        if torch.is_grad_enabled() else _attn_block(*args))
    o = torch.cat(outs).view(B, S, d.n_heads * d.v_dim)
    return o @ p["wo"].float().reshape(-1, d.d_model)


def swiglu(p, x):
    return (F.silu(x @ p["w1"].float()) * (x @ p["w3"].float())) @ p["w2"].float()


def route(p, x2, d: Dims, score_dtype=torch.float32):
    """-> scores [T, E] f32, idx [T, K], weights [T, K]."""
    scores = torch.sigmoid(x2 @ p["router"].float())
    if score_dtype != torch.float32:
        scores = scores.to(score_dtype).float()
    idx = torch.topk(scores + p["bias"].float(), d.top_k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return scores, idx, w * d.routed_scale


def moe(p, x, d: Dims, rec: dict | None, layer: int, score_dtype=torch.float32):
    """x [B, S, D] -> (y, the sequence-wise aux loss); ``rec`` gets the
    layer's loads [E] and choices [T, K]."""
    B, S, D = x.shape
    x2 = x.reshape(-1, D)
    scores, idx, w = route(p, x2, d, score_dtype)
    if rec is not None:
        rec["loads"][layer] = torch.bincount(idx.reshape(-1), minlength=d.n_experts)
        rec["routes"][layer] = idx.detach().to(torch.uint8)
    sc, ix = scores.view(B, S, -1), idx.view(B, S, -1)
    P = (sc / sc.sum(-1, keepdim=True)).mean(1)
    f = F.one_hot(ix, d.n_experts).float().sum((1, 2)) * (d.n_experts / (d.top_k * S))
    aux = d.seq_aux_weight * (f * P).sum(-1).mean()
    y = torch.zeros_like(x2)
    for j in range(d.expert_count):
        tok, k = (idx == d.expert_first + j).nonzero(as_tuple=True)
        h = F.silu(x2[tok] @ p["w1"][j].float()) * (x2[tok] @ p["w3"][j].float())
        y = y.index_add(0, tok, (h @ p["w2"][j].float()) * w[tok, k, None])
    if "shared" in p:
        y = y + swiglu(p["shared"], x2)
    return y.view(B, S, D), aux


def layer_forward(lp, h, d: Dims, rec, layer, score_dtype=torch.float32):
    h = h + mla(lp["attn"], rms_norm(h, lp["norm1"], d.norm_eps), d)
    x = rms_norm(h, lp["norm2"], d.norm_eps)
    if "moe" in lp:
        y, aux = moe(lp["moe"], x, d, rec, layer, score_dtype)
        return h + y, aux
    return h + swiglu(lp["mlp"], x), torch.zeros((), device=h.device)


def layers_of(tree: dict, d: Dims, dtype=None) -> list[dict]:
    """Per-layer dicts of the stacked tree (views; or copies in ``dtype``)."""
    def split(t, n):
        if isinstance(t, dict):
            parts = {k: split(v, n) for k, v in t.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return [x if dtype is None else x.to(dtype, copy=True) for x in t.unbind(0)]
    out = []
    if "dense_blocks" in tree:
        out += split(tree["dense_blocks"], d.first_dense)
    return out + split(tree["blocks"], d.n_layers - d.first_dense)


def loss(top: dict, layers: list[dict], d: Dims, batch: dict, rec=None,
         score_dtype=torch.float32):
    """The LM loss over the sliced vocabulary plus the aux losses."""
    h = F.embedding(batch["tokens"], top["embed"]).float()
    aux = torch.zeros((), device=h.device)
    for i, lp in enumerate(layers):
        moe_i = i - d.first_dense

        def fn(h, lp=lp, moe_i=moe_i):
            return layer_forward(lp, h, d, rec, moe_i, score_dtype)
        h, a = checkpoint(fn, h, use_reentrant=False) if torch.is_grad_enabled() \
            else fn(h)
        aux = aux + a
    h = rms_norm(h, top["final_norm"], d.norm_eps)

    def xent(hb, lb):
        logits = hb @ top["unembed"].float()
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lb[:, None])[:, 0]).sum()
    total = torch.zeros((), device=h.device)
    for b in range(h.shape[0]):
        args = (h[b], batch["labels"][b])
        total = total + (checkpoint(xent, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else xent(*args))
    return total / batch["mask"].sum() + aux


# ------------------------------------------------------------------ #
# the checked steps
# ------------------------------------------------------------------ #
def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def leaf_samples(tree: dict) -> dict:
    """Per leaf (its path joined by '.'), a copy of up to ~2^20 of its
    elements at an even stride: every element of a leaf under 2^21 of them,
    and an even spread over every slice of a larger one (a whole copy of the
    share's tree would take 5.5 GB beside it)."""
    return {p: t.detach().flatten()[:: max(1, t.numel() >> 20)].clone()
            for p, t in _paths(tree)}


def change_norms(before: dict, after: dict) -> dict:
    """{path: norm of the sampled elements' change}, in f32."""
    return {p: float((after[p].float() - before[p].float()).norm()) for p in before}


def _stacked_names(d: Dims) -> list[tuple[str, int]]:
    return [("dense_blocks", d.first_dense), ("blocks", d.n_layers - d.first_dense)]


def reference_steps(tree: dict, d: Dims, batches: list[dict], *, lr: float,
                    clip: float, b1: float, b2: float, eps: float,
                    score_dtype=torch.float32) -> dict:
    """Follow the program's checked steps from ``tree`` (updated in place):
    step 1 in full (loss, every leaf's clipped gradient norm, the routers'
    choices and loads, Adam, the bias step), then each later step's forward
    (its loads, the bias step).  Returns ``loss1``, ``grad_norms`` {path:
    norm}, ``change_norms`` {path: norm of the sampled elements' change over
    step 1, ``leaf_samples``}, ``routes1`` [L_moe, T, K] uint8 and ``bias``
    [L_moe, E] after the last step."""
    before = leaf_samples(tree)
    with no_tf32():
        rec = {"loads": {}, "routes": {}}
        top = {k: tree[k].to(torch.float32, copy=True).requires_grad_()
               for k in ("embed", "final_norm", "unembed")}
        layers = layers_of(tree, d, torch.float32)
        trained = list(top.values())
        for lp in layers:                    # the bias only selects: no gradient
            trained += [t.requires_grad_() for path, t in _paths(lp)
                        if path != "moe.bias"]
        with torch.enable_grad():
            l1 = loss(top, layers, d, batches[0], rec, score_dtype)
            grads = torch.autograd.grad(l1, trained)
        gmap = {id(t): g for t, g in zip(trained, grads)}
        del grads
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in gmap.values())).float()
        scale = torch.clamp(clip / (norm + 1e-12), max=1.0)
        sq = {}
        for k, t in top.items():
            sq[k] = (gmap[id(t)] * scale).double().pow(2).sum()
        n_dense = d.first_dense
        for i, lp in enumerate(layers):
            stack = "dense_blocks" if i < n_dense else "blocks"
            for path, t in _paths(lp):
                if id(t) in gmap:
                    key = f"{stack}.{path}"
                    sq[key] = sq.get(key, 0.0) + (gmap[id(t)] * scale).double().pow(2).sum()
        grad_norms = {k: float(v.sqrt()) for k, v in sq.items()}

        # Adam's first step, stored in each leaf's own type, in place
        def adam_leaf(stored: torch.Tensor, g: torch.Tensor):
            g = g * scale
            m, v = (1 - b1) * g, (1 - b2) * g * g
            u = -lr * (m / (1 - b1)) / (torch.sqrt(v / (1 - b2)) + eps)
            stored.copy_((stored.float() + u.to(stored.dtype).float()).to(stored.dtype))
        with torch.no_grad():
            for k, t in top.items():
                adam_leaf(tree[k], gmap[id(t)])
            for name, n in _stacked_names(d):
                if name not in tree:
                    continue
                off = 0 if name == "dense_blocks" else n_dense
                for path, stored in _paths(tree[name]):
                    if path == "moe.bias":
                        continue
                    for i in range(n):
                        lp = layers[off + i]
                        t = lp
                        for part in path.split("."):
                            t = t[part]
                        adam_leaf(stored[i], gmap[id(t)])
        del gmap, layers, top, trained
        routes1 = torch.stack([rec["routes"][i] for i in sorted(rec["routes"])])
        bias = tree["blocks"]["moe"]["bias"]

        def bias_step(loads):
            L = torch.stack([loads[i] for i in sorted(loads)]).float()
            bias.add_(d.bias_rate * torch.sign(L.mean(-1, keepdim=True) - L))
        bias_step(rec["loads"])
        change = change_norms(before, leaf_samples(tree))
        del before
        for batch in batches[1:]:
            rec2 = {"loads": {}, "routes": {}}
            with torch.no_grad():
                loss(tree, layers_of(tree, d), d, batch, rec2, score_dtype)
            bias_step(rec2["loads"])
        return {"loss1": float(l1.detach()), "grad_norms": grad_norms,
                "change_norms": change, "routes1": routes1, "bias": bias.clone()}


def route_mismatch(a: torch.Tensor, b: torch.Tensor, n_experts: int) -> float:
    """Share of the (token, layer, choice) picks in ``a`` [L, T, K] that
    ``b`` does not make (as sets of K a token and layer); 1 where the two
    hold different tokens or layers."""
    if a.shape != b.shape:
        return 1.0
    ma = torch.zeros((*a.shape[:2], n_experts), dtype=torch.bool, device=a.device)
    mb = torch.zeros_like(ma)
    ma.scatter_(-1, a.long(), True)
    mb.scatter_(-1, b.long(), True)
    return float((ma & ~mb).sum()) / a.numel()
