"""The DA-MolDQN learner's first steps, in plain PyTorch: replay sampling,
the unpacking of packed fingerprints, the online and target forwards, the
double-DQN Huber loss, the global-norm clip and Adam, for every worker.

The workers are computed in blocks, each block's parameters stacked
``[Wb, in, out]`` and updated together; every worker's loss, gradient and
update depend on its own rows only.  Precision is f32 with TF32 off
unless ``tf32`` (the control) says otherwise."""

from __future__ import annotations

import numpy as np
import torch

FP_BITS = 2048


def _bit_table(device) -> torch.Tensor:
    """[256, 8] f32: byte -> its bits, most significant first."""
    b = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)
    return torch.from_numpy(b.astype(np.float32)).to(device)


def replay_indices(seed: int, worker: int, filled: int, batch: int,
                   steps: int) -> list[np.ndarray]:
    """The trainer's uniform replay draws: worker ``w``'s buffer samples
    with replacement from ``numpy.random.default_rng(seed + 200 + w)``."""
    rng = np.random.default_rng(int(seed) + 200 + worker)
    return [rng.integers(0, filled, size=batch) for _ in range(steps)]


def _block_batch(fill, idx, candidates: int, table) -> dict:
    """Dense ``[Wb, B, ...]`` tensors of one block's sampled transitions."""
    Wb, B = len(fill), len(idx[0])
    sb = np.zeros((Wb, B, FP_BITS // 8), np.uint8)
    nb = np.zeros((Wb, B, candidates, FP_BITS // 8), np.uint8)
    sf, r, d, nf, cnt = (np.zeros((Wb, B), np.float32) for _ in range(5))
    for w, (trs, ix) in enumerate(zip(fill, idx)):
        for j, i in enumerate(ix):
            t = trs[int(i)]
            sb[w, j] = t["state_fp"]
            sf[w, j] = t["steps_left_frac"]
            r[w, j] = t["reward"]
            d[w, j] = float(t["done"])
            k = min(t["next_fps"].shape[0], candidates)
            nb[w, j, :k] = t["next_fps"][:k]
            nf[w, j] = t["next_steps_left_frac"]
            cnt[w, j] = 0 if t["done"] else k
    dev = table.device
    to = lambda a: torch.from_numpy(a).to(dev)
    states = torch.cat([table[to(sb).long()].flatten(-2),
                        to(sf).unsqueeze(-1)], -1)
    mask = (torch.arange(candidates, device=dev)
            < to(cnt).unsqueeze(-1)).to(torch.float32)
    nxt = torch.cat([table[to(nb).long()].flatten(-2),
                     to(nf)[..., None, None].expand(Wb, B, candidates, 1)], -1)
    nxt = nxt * mask.unsqueeze(-1)
    return {"states": states, "rewards": to(r), "dones": to(d),
            "next": nxt, "mask": mask}


def _q(layers, x):
    """Plain MLP, ReLU between layers, over ``x [Wb, ..., in]``: per-worker
    weights ``[Wb, in, out]`` or one shared ``[in, out]``."""
    lead = x.shape[:-1]
    h = x.reshape(x.shape[0], -1, x.shape[-1])
    for k, (w, b) in enumerate(layers):
        if w.dim() == 3:
            h = torch.bmm(h, w) + b.unsqueeze(1)
        else:
            h = torch.matmul(h, w) + b
        if k < len(layers) - 1:
            h = torch.relu(h)
    return h[..., 0].reshape(lead)


def _losses(online, target, batch, discount: float, rows: int) -> torch.Tensor:
    """Per-worker mean Huber loss of the double-DQN target over the first
    ``rows`` rows of each worker's batch."""
    q_sa = _q(online, batch["states"])
    with torch.no_grad():
        mask = batch["mask"]
        q_on = _q(online, batch["next"]).masked_fill(mask == 0, float("-inf"))
        a_star = q_on.argmax(-1, keepdim=True)
        v = _q(target, batch["next"]).gather(-1, a_star)[..., 0]
        v = torch.where(mask.sum(-1) > 0, v, torch.zeros_like(v))
        y = batch["rewards"] + discount * (1.0 - batch["dones"]) * v
    td = (q_sa - y)[:, :rows]
    a = td.abs()
    h = torch.where(a <= 1.0, 0.5 * td * td, a - 0.5)
    return h.mean(-1)


def learner_reference(weights, fill, seed: int, cfg: dict, steps: int, *,
                      device, tf32: bool = False, rows: int | None = None,
                      block: int = 64, change_at: int | None = None) -> dict:
    """Every worker's first ``steps`` updates from ``weights`` (the online
    and the target network alike) over its ``fill``.  Returns each step's
    loss averaged over the workers, each leaf's norm of the first clipped
    gradient ``[L, W]``, and each leaf's norm of the parameters' change
    after step ``change_at`` (default: the last) ``[L, W]``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(weights, fill, seed, cfg, steps, device, rows, block,
                    change_at or steps)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _run(weights, fill, seed, cfg, steps, device, rows, block, change_at):
    B, C = cfg["train_batch_size"], cfg["max_candidates"]
    lr, b1, b2, eps = cfg["lr"], cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    clip, discount = cfg["grad_clip"], cfg["discount"]
    rows = B if rows is None else rows
    W = len(fill)
    table = _bit_table(device)
    target = [(w.to(device), b.to(device)) for w, b in weights]
    p0 = [t for wb in target for t in wb]
    draws = [replay_indices(seed, w, len(fill[w]), B, steps) for w in range(W)]
    loss_sum = np.zeros(steps, np.float64)
    grad_n = torch.zeros(len(p0), W, dtype=torch.float32)
    change_n = torch.zeros(len(p0), W, dtype=torch.float32)
    for lo in range(0, W, block):
        ws = range(lo, min(W, lo + block))
        Wb = len(ws)
        p = [t.unsqueeze(0).repeat((Wb,) + (1,) * t.dim()) for t in p0]
        m = [torch.zeros_like(t) for t in p]
        v = [torch.zeros_like(t) for t in p]
        for s in range(steps):
            batch = _block_batch([fill[w] for w in ws],
                                 [draws[w][s] for w in ws], C, table)
            leaves = [t.detach().requires_grad_(True) for t in p]
            online = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
            loss = _losses(online, target, batch, discount, rows)
            g = torch.autograd.grad(loss.sum(), leaves)
            loss_sum[s] += float(loss.detach().double().sum())
            with torch.no_grad():
                sq = sum(x.flatten(1).double().pow(2).sum(1) for x in g)
                scale = torch.clamp(clip / (sq.sqrt() + 1e-12), max=1.0).float()
                g = [x * scale.view((Wb,) + (1,) * (x.dim() - 1)) for x in g]
                if s == 0:
                    for k, x in enumerate(g):
                        grad_n[k, lo:lo + Wb] = x.flatten(1).norm(dim=1).cpu()
                t = s + 1
                for k in range(len(p)):
                    m[k] = b1 * m[k] + (1 - b1) * g[k]
                    v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                    mh = m[k] / (1 - b1 ** t)
                    vh = v[k] / (1 - b2 ** t)
                    p[k] = p[k] - lr * mh / (vh.sqrt() + eps)
                if t == change_at:
                    for k in range(len(p)):
                        change_n[k, lo:lo + Wb] = \
                            (p[k] - p0[k]).flatten(1).norm(dim=1).cpu()
            del batch, leaves, online, loss, g
        del p, m, v
    return {"loss": loss_sum / W, "grad_norm": grad_n.numpy(),
            "change_norm": change_n.numpy()}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared.  ``loss1_gap``: the first step's loss (the
    workers' mean) as a share of the reference's.  ``grad_gap_p90`` and
    ``change_gap_p90``: for each worker, the worst leaf's gap between the
    program's and the reference's norm of the first gradient, and of the
    parameters' change after the steps, each against the reference's norm
    of that leaf or of the worker's median leaf, whichever is larger; then
    the 90th percentile of that over the workers.  Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change.  ``change_gap_worst``: the same for the worst worker, which
    swings more by rounding between two summation orders (the 90th
    percentile is what the one-precision-lower control fails; the worst
    worker is what a fault confined to a few workers fails).  The worst
    worker's gradient gap and every step's loss gap are reported beside
    them."""
    pl, rl = np.asarray(prog["loss"], np.float64), np.asarray(ref["loss"], np.float64)
    loss_steps = (np.abs(pl - rl) / np.abs(rl)).tolist()
    rg = ref["grad_norm"].astype(np.float64)
    med = np.median(rg, axis=0, keepdims=True)
    g = (np.abs(prog["grad_norm"] - rg) / np.maximum(rg, med)).max(0)
    rc = ref["change_norm"].astype(np.float64)
    medc = np.median(rc, axis=0, keepdims=True)
    keep = rg >= 1e-3 * med
    c = np.where(keep, np.abs(prog["change_norm"] - rc) / np.maximum(rc, medc),
                 0.0).max(0)
    return {"loss1_gap": loss_steps[0], "grad_gap_p90": float(np.percentile(g, 90)),
            "change_gap_p90": float(np.percentile(c, 90)),
            "grad_gap_worst": float(g.max()), "change_gap_worst": float(c.max()),
            "loss_gap_steps": loss_steps, "leaves_left_out": int((~keep).sum())}



def sync_gap(before: list[np.ndarray], after: list[np.ndarray],
             initial: list[np.ndarray]) -> float:
    """The episode sync: the workers' mean of each leaf, worked out in f64
    from the program's parameters just before the sync (``before``,
    ``[W, ...]`` each), against the program's parameters after it (``after``:
    any worker's row, since the sync gives every worker the mean).  By the
    worst leaf, the norm of the difference against the norm of the mean's
    change from the ``initial`` weights, of that leaf or of the median
    leaf, whichever is larger."""
    gap, change = [], []
    for b, a, p0 in zip(before, after, initial):
        mean = b.astype(np.float64).mean(0)
        gap.append(float(np.linalg.norm(a.astype(np.float64) - mean)))
        change.append(float(np.linalg.norm(mean - p0.astype(np.float64))))
    change = np.asarray(change)
    with np.errstate(invalid="ignore"):    # no change at all reads nan: fails
        return float(np.max(np.asarray(gap) / np.maximum(change, np.median(change))))
