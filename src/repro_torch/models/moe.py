"""Port of ``repro.models.moe``: the Mixture-of-Experts layer (GShard-style
capacity dispatch); and, port-only, DeepSeek-V3's MoE layer with a
dropless path over the experts this device holds (the mla_moe family).

Top-k routing with softmax-renormalised gates (Mixtral convention), token
priority token-major within a group of ``group_size`` tokens, each expert
taking at most ``C = max(int(G_tok * K * capacity_factor) // E, 1)`` of
them; a dropped (token, choice) passes through the residual.  The aux
load-balance loss follows Shazeer et al.

Dispatch and combine are the reference's one-hot tensors (``[G, S, E, C]``,
made in ``x``'s type) and every product is an einsum, as the reference
computes them outside Pallas; there is no kernel here.  ``jax.lax.top_k``
puts the lower expert index first on a tie, which ``torch.topk`` does not
promise, so the choices come from a stable descending sort: the same
experts in the same order, and so the same queue positions.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_forward, mlp_params_init


def moe_params_init(gen, cfg, dtype, *, lead=(), device=None) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    kw = dict(lead=lead, device=device)
    return {
        "router": dense_init(gen, (D, E), torch.float32, **kw),   # router math in f32
        "w1": dense_init(gen, (E, D, Fd), dtype, **kw),
        "w3": dense_init(gen, (E, D, Fd), dtype, **kw),
        "w2": dense_init(gen, (E, Fd, D), dtype, **kw),
    }


def route(router: torch.Tensor, xt: torch.Tensor,
          top_k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt [G, S, D] -> (probs [G, S, E] f32, gate_vals [G, S, K] f32,
    renormalised, gate_idx [G, S, K] int64): ``lax.top_k``'s choices and
    order, ties to the lower index."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def moe_forward(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar f32)."""
    mcfg = cfg.moe
    B, S, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    T = B * S
    G_tok = min(mcfg.group_size, T)
    C = max(int(G_tok * K * mcfg.capacity_factor) // E, 1)     # Python ints, as the reference
    if T % G_tok:
        raise ValueError(f"tokens {T} not divisible by group size {G_tok}")
    G = T // G_tok
    xt = x.reshape(G, G_tok, D)
    probs, gate_vals, gate_idx = route(p["router"], xt, K)

    # aux load-balance loss (fraction routed x mean prob, scaled by E)
    onehot = F.one_hot(gate_idx, E).float()                       # [G,S,K,E]
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(dim=(0, 1, 2)) / (G * G_tok * K)
    aux = E * torch.sum(me * ce) * mcfg.aux_loss_weight

    # capacity slots: position of each (token, k) choice in its expert queue
    flat = onehot.reshape(G, G_tok * K, E)                        # priority: token-major
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(G, G_tok, K, E)
    within_cap = pos_in_expert < C
    slot = torch.where(within_cap, pos_in_expert, 0).to(torch.int32)

    # [G,S,K,E,C] one-hot of the capacity slot, zeroed for over-capacity and
    # for non-chosen experts (slot values are garbage there)
    dt = x.dtype
    slot_oh = ((slot[..., None] == torch.arange(C, device=x.device, dtype=torch.int32))
               .to(dt) * within_cap[..., None].to(dt) * onehot[..., None].to(dt))
    dispatch = slot_oh.sum(dim=2)                                 # [G,S,E,C]
    gate_per_e = torch.einsum("gske,gsk->gse", onehot, gate_vals)
    combine = dispatch * gate_per_e[..., None].to(dt)             # [G,S,E,C]

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xt)      # [E,G,C,D]
    h = torch.einsum("egcd,edf->egcf", expert_in, p["w1"])
    h = F.silu(h) * torch.einsum("egcd,edf->egcf", expert_in, p["w3"])
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w2"])       # [E,G,C,D]
    y = torch.einsum("gsec,egcd->gsd", combine, expert_out)
    return y.reshape(B, S, D), aux


# ================================================================== #
# DeepSeek-V3's MoE layer (the mla_moe family)
# ================================================================== #
class StepStats:
    """What a train step's forward leaves for the step, and where its parts
    are spanned: per MoE layer (keyed by its index among the MoE layers) the
    router's expert loads ``[E]`` over the step's tokens, and with
    ``keep_routes`` its choices ``[T, K]`` (uint8).  A recomputed forward
    writes the same entries again.  ``rec`` is a ``core.spans.SpanRecorder``
    (or None: nothing is timed or counted)."""

    def __init__(self, rec=None, *, keep_routes: bool = False):
        self.rec = rec
        self.loads: dict[int, torch.Tensor] = {}
        self.routes: dict[int, torch.Tensor] | None = {} if keep_routes else None

    def span(self, name: str):
        return self.rec.span(name) if self.rec is not None else nullcontext()

    def count(self, name: str, n: int) -> None:
        if self.rec is not None:
            self.rec.count(name, n)


def dsmoe_params_init(gen, cfg, dtype, *, lead=(), device=None) -> dict:
    """The router [D, E] and its selection bias [E] (both f32, every expert
    of the router), the held experts' w1 / w3 [E_local, D, F] and w2
    [E_local, F, D], and the shared experts as one SwiGLU of width
    n_shared x F."""
    m, D, Fd = cfg.moe, cfg.d_model, cfg.d_ff
    _, count = m.local_experts
    kw = dict(lead=lead, device=device)
    p = {
        "router": dense_init(gen, (D, m.n_experts), torch.float32, **kw),
        "bias": torch.zeros((*lead, m.n_experts), dtype=torch.float32, device=device),
        "w1": dense_init(gen, (count, D, Fd), dtype, **kw),
        "w3": dense_init(gen, (count, D, Fd), dtype, **kw),
        "w2": dense_init(gen, (count, Fd, D), dtype, **kw),
    }
    if m.n_shared:
        p["shared"] = mlp_params_init(gen, D, m.n_shared * Fd, "swiglu", dtype, **kw)
    return p


def route_topk(router: torch.Tensor, bias: torch.Tensor, x2: torch.Tensor,
               mcfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router (``noaux_tc`` with one group), in f32: x2 [T, D]
    -> (sigmoid scores [T, E], idx [T, K], weights [T, K]).  The bias only
    selects: the top K of ``scores + bias``; the weights are the unbiased
    scores of the chosen, renormalised and times ``routed_scale``."""
    scores = torch.sigmoid(x2.float() @ router)
    idx = torch.topk(scores + bias, mcfg.top_k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return scores, idx, w * mcfg.routed_scale


def seq_aux_loss(scores: torch.Tensor, idx: torch.Tensor, mcfg) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss (eqs. 17-20): scores [B, S,
    E], idx [B, S, K] -> alpha x mean over sequences of sum_i f_i P_i, with
    f_i = E / (K S) x (tokens choosing i) and P_i the mean over the sequence
    of the scores normalised over all E."""
    B, S, E = scores.shape
    K = idx.shape[-1]
    P = (scores / scores.sum(-1, keepdim=True)).mean(1)                # [B, E]
    f = torch.zeros((B, E), dtype=torch.float32, device=scores.device)
    f = f.scatter_add_(1, idx.reshape(B, -1),
                       torch.ones((B, S * K), dtype=torch.float32,
                                  device=scores.device)) * (E / (K * S))
    return mcfg.seq_aux_weight * (f * P).sum(-1).mean()


def dsmoe_forward(p: dict, x: torch.Tensor, cfg, *, stats: StepStats | None = None,
                  layer: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the sequence-wise aux loss).

    The router scores all E experts; this device computes the experts it
    holds (``moe.local_experts``) for the (token, choice) pairs routed to
    them, every pair (no capacity, nothing dropped), plus the shared
    experts for every token.  What the other experts would add is left
    out.  The pairs are sorted by local expert (one host read of the
    counts a call), gathered, run through one matrix product chain an
    expert, scaled by their weights and added back to their tokens."""
    mcfg = cfg.moe
    stats = stats or StepStats()
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    first, count = mcfg.local_experts
    with stats.span("lm.moe.route"):
        scores, idx, w = route_topk(p["router"], p["bias"], x2, mcfg)
        aux = seq_aux_loss(scores.view(B, S, -1), idx.view(B, S, -1), mcfg)
        flat = idx.reshape(-1)
        stats.loads[layer] = torch.bincount(flat, minlength=mcfg.n_experts).detach()
        if stats.routes is not None:
            stats.routes[layer] = idx.detach().to(torch.uint8)
        e = flat - first
        key = torch.where((e >= 0) & (e < count), e, count)
        order = torch.argsort(key, stable=True)
        rows = torch.bincount(key, minlength=count + 1)[:count].tolist()
        n = sum(rows)
        pairs = order[:n]
        tok = torch.div(pairs, mcfg.top_k, rounding_mode="floor")
        xs = x2[tok]
    stats.count("lm.moe.local_rows", n)
    stats.count("lm.moe.max_local_rows", max(rows))
    with stats.span("lm.moe.experts"):
        outs = []
        for xj, w1, w3, w2 in zip(torch.split(xs, rows), p["w1"].unbind(0),
                                  p["w3"].unbind(0), p["w2"].unbind(0)):
            outs.append((F.silu(xj @ w1) * (xj @ w3)) @ w2)
        ys = torch.cat(outs)
    with stats.span("lm.moe.combine"):
        gs = w.reshape(-1)[pairs].to(ys.dtype)
        y = torch.zeros_like(x2).index_add(0, tok, ys * gs[:, None])
    if "shared" in p:
        with stats.span("lm.moe.shared"):
            y = y + mlp_forward(p["shared"], x2, "swiglu")
    return y.view(B, S, D), aux


@torch.no_grad()
def update_bias(bias: torch.Tensor, loads: torch.Tensor, rate: float) -> torch.Tensor:
    """DeepSeek-V3 §2.1.2: after a step, each expert's selection bias falls
    by ``rate`` if its load is above the mean load of its layer, rises by it
    if below.  bias, loads [L, E] -> the new bias (f32)."""
    loads = loads.float()
    return bias + rate * torch.sign(loads.mean(-1, keepdim=True) - loads)
