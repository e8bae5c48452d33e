"""Port of ``repro.models.ssm``: the Mamba2 (SSD, state-space duality)
block, chunked-parallel form, forward and one-token decode.

Follows Dao & Gu 2024 (arXiv:2405.21060): per-head scalar decay
``a_t = exp(-A dt_t)``, rank-1 state update

    S_t = a_t * S_{t-1} + dt_t * x_t B_t^T          (S in R^{P x N})
    y_t = C_t S_t + D * x_t

computed in O(L) by the chunked algorithm: within a chunk of length Q the
quadratic "attention form", chunk states passed by a loop over chunks.
With ``use_pallas`` the full-sequence forward runs the scan as one launch
of the hand-written CUDA ``ssd_scan`` kernel (``kernels/ssd_scan``).

Tensor conventions (B=batch, L=seq, H=heads, P=head_dim, G=BC-groups,
N=state_dim):  x [B,L,H,P], dt [B,L,H], B/C [B,L,G,N].

The block: in_proj -> (z, xBC, dt); causal depthwise conv over xBC; SSD;
gated RMSNorm; out_proj.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ------------------------------------------------------------------ #
# core SSD math (plain PyTorch; kernels/ssd_scan is the CUDA route)
# ------------------------------------------------------------------ #
def ssd_chunked(
    x: torch.Tensor,      # [B, L, H, P]
    dt: torch.Tensor,     # [B, L, H]   (softplus'd, positive)
    A: torch.Tensor,      # [H]         (positive decay rates)
    B_: torch.Tensor,     # [B, L, G, N]
    C_: torch.Tensor,     # [B, L, G, N]
    chunk: int,
    initial_state: torch.Tensor | None = None,   # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,L,H,P], final_state [B,H,P,N]) in x's type; f32 inside."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    assert L % chunk == 0, f"L={L} % chunk={chunk}"
    nc = L // chunk
    rep = H // G

    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = B_.reshape(Bb, nc, chunk, G, N)
    Cc = C_.reshape(Bb, nc, chunk, G, N)

    # log-decay within chunk: l[t] = sum_{u<=t} log a_u  (per head)
    log_a = (-A[None, None, None, :] * dtc).float()               # [B,nc,Q,H]
    cum = torch.cumsum(log_a, dim=2)                              # [B,nc,Q,H]
    total = cum[:, :, -1, :]                                      # [B,nc,H]

    # intra-chunk (quadratic) term:
    # y_t += sum_{u<=t} C_t.B_u * exp(cum_t - cum_u) * dt_u * x_u
    Bh = torch.repeat_interleave(Bc, rep, dim=3).float()          # [B,nc,Q,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3).float()
    scores = torch.einsum("bnqhk,bnshk->bnhqs", Ch, Bh)           # [B,nc,H,Q,S]
    cum_h = cum.permute(0, 1, 3, 2)                               # [B,nc,H,Q]
    decay = cum_h[..., :, None] - cum_h[..., None, :]             # cum_q - cum_s
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # mask BEFORE the exp: above the diagonal cum_q - cum_s > 0 overflows
    # to inf at long chunks, and the reference's where(causal, exp(decay), 0)
    # then backpropagates 0 * inf = NaN; the forward values are the same
    gate = torch.exp(decay.masked_fill(~causal, -math.inf))
    weights = scores * gate                                       # [B,nc,H,Q,S]
    xdt = xc.float() * dtc[..., None].float()
    y_intra = torch.einsum("bnhqs,bnshp->bnqhp", weights, xdt)

    # chunk summary states: S_chunk = sum_u exp(total - cum_u) dt_u x_u B_u^T
    state_decay = torch.exp(total[:, :, None, :] - cum)           # [B,nc,Q,H]
    contrib = torch.einsum("bnqhp,bnqhk,bnqh->bnhpk", xdt, Bh,
                           state_decay)                           # [B,nc,H,P,N]

    # inter-chunk scan: S_c = exp(total_c) * S_{c-1} + contrib_c; keep the
    # state ENTERING each chunk
    S = (initial_state.float() if initial_state is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(S)
        S = torch.exp(total[:, c])[:, :, None, None] * S + contrib[:, c]
    entering = torch.stack(entering, dim=1)                       # [B,nc,H,P,N]

    # inter-chunk contribution: y_t += C_t S_entering * exp(cum_t)
    y_inter = torch.einsum("bnqhk,bnhpk,bnqh->bnqhp", Ch, entering,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    return y.to(x.dtype), S.to(x.dtype)


def ssd_decode_step(
    state: torch.Tensor,  # [B, H, P, N]
    x: torch.Tensor,      # [B, H, P]
    dt: torch.Tensor,     # [B, H]
    A: torch.Tensor,      # [H]
    B_: torch.Tensor,     # [B, G, N]
    C_: torch.Tensor,     # [B, G, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update.  Returns (y [B,H,P], new_state), the
    state rounded to its own type as the reference does."""
    H = x.shape[1]
    G = B_.shape[1]
    rep = H // G
    Bh = torch.repeat_interleave(B_, rep, dim=1)     # [B,H,N]
    Ch = torch.repeat_interleave(C_, rep, dim=1)
    a = torch.exp((-A[None, :] * dt).float())                     # [B,H]
    upd = torch.einsum("bhp,bhk,bh->bhpk", x.float(), Bh.float(), dt.float())
    new_state = a[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhk,bhpk->bhp", Ch.float(), new_state)
    return y.to(x.dtype), new_state.to(state.dtype)


# ------------------------------------------------------------------ #
# the mamba2 block
# ------------------------------------------------------------------ #
def ssm_dims(cfg) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return {"d_inner": d_inner, "n_heads": n_heads, "conv_dim": conv_dim,
            "proj_out": 2 * d_inner + 2 * s.n_groups * s.state_dim + n_heads}


def ssm_params_init(gen, cfg, dtype, *, lead=(), device=None) -> dict:
    s = cfg.ssm
    dims = ssm_dims(cfg)
    H = dims["n_heads"]
    device = gen.device if gen is not None else device
    kw = dict(lead=lead, device=device)

    def full(shape, value, dt):
        return torch.full((*lead, *shape), value, dtype=dt, device=device)

    # separate projections (not mamba2's fused in_proj), as the reference
    return {
        "in_z": dense_init(gen, (cfg.d_model, dims["d_inner"]), dtype, **kw),
        "in_xbc": dense_init(gen, (cfg.d_model, dims["conv_dim"]), dtype, **kw),
        "in_dt": dense_init(gen, (cfg.d_model, H), dtype, **kw),
        "conv_w": dense_init(gen, (s.conv_width, dims["conv_dim"]), dtype, 0.5, **kw),
        "conv_b": full((dims["conv_dim"],), 0.0, dtype),
        "A_log": full((H,), 0.0, torch.float32),       # A = exp(A_log) in (0, inf)
        "D_skip": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "gate_norm": full((dims["d_inner"],), 1.0, dtype),
        "out_proj": dense_init(gen, (dims["d_inner"], cfg.d_model), dtype, **kw),
    }


def _project_in(cfg, p: dict, x: torch.Tensor):
    s = cfg.ssm
    dims = ssm_dims(cfg)
    z = x @ p["in_z"]
    xbc = x @ p["in_xbc"]
    dt_raw = x @ p["in_dt"]
    return z, xbc, dt_raw, dims["d_inner"], dims["n_heads"], s.n_groups * s.state_dim


def ssm_forward(p: dict, x: torch.Tensor, cfg, *,
                use_pallas: bool = False) -> torch.Tensor:
    """Full-sequence mamba2 block: x [B,L,D] -> [B,L,D]."""
    s = cfg.ssm
    B, L, D = x.shape
    z, xbc, dt_raw, d_inner, H, gn = _project_in(cfg, p, x)

    # causal depthwise conv over the sequence (width W)
    xbc = causal_conv1d(xbc, p["conv_w"], p["conv_b"])
    xs, B_, C_ = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    P_ = s.head_dim
    xh = xs.reshape(B, L, H, P_)            # views into xbc: the kernel reads
    dt = _softplus(dt_raw.float() + p["dt_bias"])                  # [B,L,H]
    A = torch.exp(p["A_log"])
    Bm = B_.reshape(B, L, s.n_groups, s.state_dim)
    Cm = C_.reshape(B, L, s.n_groups, s.state_dim)

    if use_pallas:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, _ = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=s.chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(s.chunk, L))
    y = y + xh * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, L, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,L,C], w [W,C] -> [B,L,C] (silu), summed
    tap by tap in x's type, as the reference."""
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for t in range(W):
        out = out + pad[:, t:t + x.shape[1], :] * w[t][None, None, :]
    return F.silu(out + b[None, None, :])


# ------------------------------------------------------------------ #
# decode path
# ------------------------------------------------------------------ #
def ssm_decode_step(
    p: dict, x: torch.Tensor, cfg,
    conv_cache: torch.Tensor,   # [B, W-1, conv_dim] (last W-1 inputs)
    state: torch.Tensor,        # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token mamba2 step: x [B,1,D] -> (y [B,1,D], conv_cache, state)."""
    s = cfg.ssm
    B = x.shape[0]
    z, xbc, dt_raw, d_inner, H, gn = _project_in(cfg, p, x[:, 0])

    # rolling conv window
    window = torch.cat([conv_cache, xbc[:, None, :]], dim=1)       # [B,W,C]
    conv = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"])
    new_conv_cache = window[:, 1:, :]

    xs, B_, C_ = torch.split(conv, [d_inner, gn, gn], dim=-1)
    xh = xs.reshape(B, H, s.head_dim)
    dt = _softplus(dt_raw.float() + p["dt_bias"])                  # [B,H]
    A = torch.exp(p["A_log"])
    Bm = B_.reshape(B, s.n_groups, s.state_dim)
    Cm = C_.reshape(B, s.n_groups, s.state_dim)

    y, new_state = ssd_decode_step(state, xh, dt, A, Bm, Cm)
    y = y + xh * p["D_skip"][None, :, None].to(y.dtype)
    y = y.reshape(B, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], new_conv_cache, new_state
