"""Port of ``repro.models.moe``: the Mixture-of-Experts layer (GShard-style
capacity dispatch).

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

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


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
