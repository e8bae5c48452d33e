"""The learner's stacked step (``DistributedTrainer._update_once``) and its
fused Adam (``kernels/stacked_adam``), on the CPU.

The stacked step is held against a per-worker computation written here,
the learner as it stood before: each live worker's ``dqn_loss`` under
``torch.autograd`` on its own parameters and batch, then ``optim/adam.py``'s
update, one worker at a time (step mode: the live gradients meaned in
worker order, every row stepping on the mean).  Batched products sum in
another order than one worker's, so losses, |TD|, the gradients (read from
the first moments after one step from zero: ``mu = 0.1 x`` the clipped
gradient) and the parameters are compared by the norm of the difference
over the norm of the per-worker value, per worker (the gradient over all
its leaves, the parameters leaf by leaf), within 1e-5, the tolerance
``test_torch_train.py`` gives the same comparison across frameworks: over
60 seeded updates here the loss reached 9.8e-7 and the gradient 5.7e-6
(float32 sums of 2,049 terms in two orders, through five layers).
Where the arithmetic is the same (a dead row's zero gradient, Adam fed the
same gradients and scale) the comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.chem.smiles import from_smiles
from repro_torch.core import DQNConfig, RewardConfig, TrainerConfig
from repro_torch.core import distributed as D
from repro_torch.core.agent import QNetwork, dqn_loss, flat, unflat
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels.stacked_adam.ops import stacked_adam
from repro_torch.kernels.stacked_adam.ref import row_scale, stacked_adam_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adam import OptState, adam, apply_updates
from repro_torch.predictors.service import OracleService

SMILES = ("C1=CC=CC=C1O", "CC1=CC(C)=CC(C)=C1O", "CC1=CC=CC=C1O",
          "OC1=CC=CC=C1O")
WIDTHS = (2049, 32, 16, 8, 4, 1)
B, C = 4, 8
TOL = 1e-5
ADAM = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _trainer(W: int, nd: int = 1, sync: str = "episode") -> D.DistributedTrainer:
    """A narrow trainer whose workers, and their targets, differ (seeded
    per padded row), with zero moments."""
    g = torch.Generator().manual_seed(3)
    layers = [(torch.randn(i, o, generator=g) * (2.0 / i) ** 0.5,
               0.1 * torch.randn(o, generator=g))
              for i, o in zip(WIDTHS[:-1], WIDTHS[1:])]
    tr = D.DistributedTrainer(
        TrainerConfig(n_workers=W, mols_per_worker=1, sync_mode=sync,
                      learner="dense", train_batch_size=B, max_candidates=C,
                      dqn=DQNConfig(), seed=0),
        [from_smiles(SMILES[i % len(SMILES)]) for i in range(W)],
        OracleService(), RewardConfig(),
        network=QNetwork(hidden=WIDTHS[1:-1], device="cpu", layers=layers),
        mesh=make_host_mesh(nd, device="cpu"))
    for sh in tr._shards:
        for j, tree in enumerate((sh.params, sh.target)):
            for k, t in enumerate(flat(tree)):
                for i in range(t.shape[0]):
                    row = torch.Generator().manual_seed(
                        10000 * j + 100 * (sh.rows.start + i) + k)
                    t[i].add_(0.05 * torch.randn(t[i].shape, generator=row))
    return tr


def _batch(W_pad: int, W: int, seed: int, weights: bool = False) -> dict:
    """A dense ``[W_pad, B, ...]`` batch, all-zero on dead rows (as the
    trainer's ``_stack`` pads them)."""
    g = torch.Generator().manual_seed(seed)
    out = {"states": (torch.rand(W_pad, B, 2049, generator=g) < 0.3).float(),
           "next_fps": (torch.rand(W_pad, B, C, 2049, generator=g) < 0.3).float(),
           "next_mask": (torch.rand(W_pad, B, C, generator=g) < 0.7).float(),
           "rewards": torch.randn(W_pad, B, generator=g),
           "dones": (torch.rand(W_pad, B, generator=g) < 0.2).float()}
    out["next_mask"][:, 0] = 0.0                  # a row with no candidates
    out["next_fps"] *= out["next_mask"].unsqueeze(-1)
    if weights:
        out["weights"] = torch.rand(W_pad, B, generator=g) + 0.5
    for v in out.values():
        v[W:] = 0
    return out


def _plain(tr: D.DistributedTrainer, batch: dict):
    """The per-worker learner: losses ``[W_pad]``, |TD| ``[W_pad, B]``, and
    the params, mu, nu and step after one step, every row."""
    W, W_pad = tr.n_live_workers, tr.n_padded_workers
    params = [t.clone() for t in flat(tr.params)]
    target = flat(tr.target_params)
    st = tr.opt_state
    opt = adam(tr.cfg.dqn.lr, clip_norm=tr.cfg.dqn.grad_clip)
    losses, tds = torch.zeros(W_pad), torch.zeros(W_pad, B)
    grads = []
    for w in range(W):
        leaves = [t[w].detach().requires_grad_(True) for t in params]
        loss, td = dqn_loss(unflat(leaves), unflat([t[w] for t in target]),
                            {k: v[w] for k, v in batch.items()},
                            tr.cfg.dqn.discount)
        grads.append(list(torch.autograd.grad(loss, leaves)))
        losses[w], tds[w] = loss.detach(), td
    if tr.cfg.sync_mode == "step":
        mean = []
        for gs in zip(*grads):
            acc = torch.zeros_like(gs[0])
            for x in gs:
                acc = acc + x
            mean.append(acc / W)
        grads = [mean] * W_pad
    else:
        grads += [[torch.zeros_like(t[0]) for t in params]] * (W_pad - W)
    out = [[torch.empty_like(t) for t in params] for _ in range(3)]
    step = torch.empty_like(st.step)
    for w in range(W_pad):
        p = [t[w] for t in params]
        upd, s2 = opt.update(grads[w], OptState(st.step[w], [m[w] for m in st.mu],
                                                [v[w] for v in st.nu]), p)
        for dst, new in zip(out, (apply_updates(p, upd), s2.mu, s2.nu)):
            for t, x in zip(dst, new):
                t[w] = x
        step[w] = s2.step
    return losses, tds, out, step


def _update(tr: D.DistributedTrainer, batch: dict):
    return tr._update_once(shard_batch(batch, tr.mesh), packed=False)


def _assert_rows_close(tr, got_loss, got_td, want, rows):
    losses, tds, (p, mu, _), _ = want
    for w in rows:
        assert abs(float(got_loss[w] - losses[w])) <= TOL * abs(float(losses[w])), w
        assert _rel(got_td[w], tds[w]) <= TOL, w
        row = lambda ts: torch.cat([t[w].flatten() for t in ts])
        assert _rel(row(tr.opt_state.mu), row(mu)) <= TOL, w
        for k, (a, b) in enumerate(zip(flat(tr.params), p)):
            assert _rel(a[w], b[w]) <= TOL, (k, w)


# ------------------------------------------------------------------ #
# the stacked step against the per-worker learner
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", ["whole", "one", "uneven", "shapes",
                                  "prioritized"])
def test_stacked_update_matches_the_per_worker_learner(case, monkeypatch):
    """W = 5 in runs of 5 rows, of 1, of 1 + 2 + 2, of what the shapes give
    (all five), and with prioritized replay's importance weights."""
    W = 5
    rows = {"whole": 5, "one": 1, "uneven": 2}.get(case)
    assert D._MIN_RUN > 2     # so "one" and "uneven" run padded
    if rows is not None:
        monkeypatch.setattr(D.DistributedTrainer, "_chunk_rows",
                            lambda self, batch: rows)
    tr = _trainer(W)
    batch = _batch(W, W, seed=11, weights=case == "prioritized")
    want = _plain(tr, batch)
    before = tr.trace_stats()["counts"].get("trainer.stacked_chunks", 0)
    loss, td = _update(tr, batch)
    chunks = tr.trace_stats()["counts"]["trainer.stacked_chunks"] - before
    assert chunks == {"one": 5, "uneven": 3}.get(case, 1)
    assert tr.opt_state.step.tolist() == [1] * W
    _assert_rows_close(tr, loss, td, want, range(W))


@pytest.mark.parametrize("sync", ["episode", "step"])
def test_ragged_fleet_dead_rows_take_their_step(sync):
    """W = 6 on 4 shards (W_pad 8), from moments set non-zero: the live
    rows match the per-worker learner; the dead rows report zero loss and
    |TD|, compute no gradient, and take Adam's step, bit for bit as
    ``optim/adam.py`` does on a zero gradient (episode mode), or on the
    fleet's mean like every row (step mode)."""
    W = 6
    tr = _trainer(W, nd=4, sync=sync)
    assert tr.n_padded_workers == 8
    g = torch.Generator().manual_seed(5)
    for sh in tr._shards:
        for m, v in zip(sh.opt.mu, sh.opt.nu):
            m.copy_(1e-3 * torch.randn(m.shape, generator=g))
            v.copy_((1e-3 * torch.randn(v.shape, generator=g)).square())
        sh.opt.step.fill_(4)
    batch = _batch(8, W, seed=12)
    want = _plain(tr, batch)
    dead_before = [t[W:].clone() for t in flat(tr.params)]
    loss, td = _update(tr, batch)
    assert tr.opt_state.step.tolist() == [5] * 8
    assert torch.equal(loss[W:], torch.zeros(2)) and torch.equal(td[W:], torch.zeros(2, B))
    _assert_rows_close(tr, loss, td, want, range(W if sync == "episode" else 8))
    if sync == "episode":        # a zero gradient: the same arithmetic, bits
        _, _, (p, mu, nu), _ = want
        for got, exp in zip((flat(tr.params), tr.opt_state.mu, tr.opt_state.nu),
                            (p, mu, nu)):
            for a, b in zip(got, exp):
                assert torch.equal(a[W:], b[W:])
        for a, b in zip(flat(tr.params), dead_before):
            assert not torch.equal(a[W:], b)       # the step moved them


@pytest.mark.parametrize("rows", [4, 1])
def test_step_mode_means_the_live_gradients(rows, monkeypatch):
    monkeypatch.setattr(D.DistributedTrainer, "_chunk_rows",
                        lambda self, batch: rows)
    tr = _trainer(4, nd=2, sync="step")
    batch = _batch(4, 4, seed=13, weights=True)
    want = _plain(tr, batch)
    loss, td = _update(tr, batch)
    _assert_rows_close(tr, loss, td, want, range(4))
    for m in tr.opt_state.mu:    # one gradient, from zero moments: one mu
        assert all(torch.equal(m[0], m[i]) for i in range(4))


def test_a_workers_bits_do_not_depend_on_its_run():
    """One update at nd 1, 2 and 4 (runs of 4, 2 and 1 rows): losses, |TD|
    and every parameter bit equal."""
    out = []
    for nd in (1, 2, 4):
        tr = _trainer(4, nd=nd)
        loss, td = _update(tr, _batch(4, 4, seed=14))
        out.append([loss, td] + flat(tr.params) + tr.opt_state.mu)
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


def test_chunk_rows_from_the_shapes():
    """The paper's shapes (B 32 x C 64 next states, width 1024) give runs
    of 128 workers; the narrow test network, the whole fleet."""
    tr = D.DistributedTrainer(
        TrainerConfig(n_workers=1, mols_per_worker=1, learner="dense"),
        [from_smiles(SMILES[0])], OracleService(), RewardConfig(),
        network=QNetwork(device="cpu"), device="cpu")
    paper = {"next_fps": torch.empty((1, 32, 64, 2049), device="meta")}
    assert tr._chunk_rows(paper) == 128
    assert _trainer(2)._chunk_rows(_batch(2, 2, seed=0)) > 512


@pytest.mark.parametrize("n,cap,sizes", [(512, 128, [128] * 4), (5, 2, [1, 2, 2]),
                                         (6, 4, [3, 3]), (3, 8, [3]), (0, 4, [])])
def test_runs_cut_evenly(n, cap, sizes):
    runs = D._runs(n, cap)
    assert [r.stop - r.start for r in runs] == sizes
    assert [r.start for r in runs] == [0, *(r.stop for r in runs)][:len(runs)]


# ------------------------------------------------------------------ #
# stacked_adam's plain version against optim/adam.py
# ------------------------------------------------------------------ #
def _adam_inputs(W: int, seed: int, grad_norm: float):
    g = torch.Generator().manual_seed(seed)
    shapes = [s for i, o in zip(WIDTHS[:-1], WIDTHS[1:]) for s in ((i, o), (o,))]
    n = sum(int(np.prod(s)) for s in shapes)
    rnd = lambda s, scale: scale * torch.randn((W,) + s, generator=g)
    return ([rnd(s, 0.05) for s in shapes],
            [rnd(s, grad_norm / n ** 0.5) for s in shapes],
            [rnd(s, 1e-3) for s in shapes],
            [rnd(s, 1e-3).square() for s in shapes],
            torch.arange(W, dtype=torch.int32) * 7)


def _per_worker(p, g, m, v, step, clip):
    """``optim/adam.py``'s update and ``apply_updates``, one row at a time."""
    opt = adam(ADAM["lr"], ADAM["b1"], ADAM["b2"], ADAM["eps"], clip_norm=clip)
    out = [[], [], [], []]
    for w in range(step.shape[0]):
        pw = [t[w] for t in p]
        upd, s2 = opt.update([t[w] for t in g],
                             OptState(step[w], [t[w] for t in m], [t[w] for t in v]), pw)
        for dst, new in zip(out, (apply_updates(pw, upd), s2.mu, s2.nu, [s2.step])):
            dst.append(new)
    return [[torch.stack(xs) for xs in zip(*rows)] for rows in out[:3]] + \
        [torch.stack([s[0] for s in out[3]])]


@pytest.mark.parametrize("case", ["clip_idle", "zero_gradient", "shared_gradient"])
def test_stacked_adam_plain_is_adam_py_bit_for_bit(case):
    """Where the clip scale is 1 either way (norms under the clip, a dead
    worker's zero gradient) the whole step is the same arithmetic: params,
    moments and steps equal bit for bit, each row at its own step."""
    p, g, m, v, step = _adam_inputs(6, seed=21, grad_norm=1.5)
    if case == "shared_gradient":
        g = [t[2:3].expand_as(t) for t in g]
    elif case == "zero_gradient":
        g = [torch.zeros_like(t) for t in g]
    want = _per_worker(p, g, m, v, step, 10.0)
    got = [[t.clone() for t in xs] for xs in (p, m, v)] + [step.clone()]
    stacked_adam(got[0], g, got[1], got[2], got[3], clip=10.0, **ADAM)
    for a, b in zip(got[:3], want[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(got[3], want[3])


def test_stacked_adam_plain_is_adam_py_where_the_clip_bites():
    """With gradients of norm ~150 the clip bites: fed the same clipped
    gradients (``optim/adam.py`` without its clip), the step is bit for
    bit; and the float64 norm's scale is ``optim/adam.py``'s within 1e-6."""
    p, g, m, v, step = _adam_inputs(5, seed=22, grad_norm=150.0)
    scale = row_scale(g, 10.0)
    ref_scale = torch.stack([torch.clamp(10.0 / (torch.sqrt(sum(
        torch.sum(torch.square(t[w])) for t in g)) + 1e-12), max=1.0)
        for w in range(5)])
    assert bool((scale < 0.2).all())
    assert float(((scale - ref_scale) / ref_scale).abs().max()) <= TOL
    clipped = [t * scale.view((-1,) + (1,) * (t.dim() - 1)) for t in g]
    want = _per_worker(p, clipped, m, v, step, None)
    got = [[t.clone() for t in xs] for xs in (p, m, v)] + [step.clone()]
    stacked_adam_ref(got[0], g, got[1], got[2], got[3], clip=10.0, **ADAM)
    for a, b in zip(got[:3], want[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(got[3], want[3])


def test_stacked_adam_writes_in_place_and_refuses_other_devices():
    p, g, m, v, step = _adam_inputs(2, seed=23, grad_norm=1.0)
    ids = [t.data_ptr() for t in p + m + v] + [step.data_ptr()]
    before = [t.clone() for t in p]
    stacked_adam(p, g, m, v, step, clip=10.0, **ADAM)
    assert [t.data_ptr() for t in p + m + v] + [step.data_ptr()] == ids
    assert not any(torch.equal(a, b) for a, b in zip(p, before))
    assert step.tolist() == [1, 8]
    meta = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        stacked_adam(p, g, m, v, meta, clip=10.0, **ADAM)
