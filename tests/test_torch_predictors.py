"""The property tier: the port's features, predictors, ``PropertyService``
and training loops against ``repro.predictors`` on the CPU.

Tolerances, and why:

* Features, the padding ladder and the corpus are host numpy code copied
  from the reference: bit-identical.
* The forwards, from the reference's own ``init`` trees carried over as
  numpy, match ``model.apply`` within 1e-5 relative (+inf exactly where
  a molecule has no O-H oxygen): each side sums its f32 products in its
  own order.
* ``PropertyService.predict``: the same ``None`` pattern, values within
  1e-5 relative, the same counters and cache statistics.
* Training: 20 steps of each loop from the same init and the same numpy
  minibatch stream.  Losses at every step and the held-out predictions
  are held to ``TRAIN_RTOL`` = 1e-4 relative.  The two sides' gradients
  differ in their last bits; Adam divides each moment by the root of its
  second moment, so a gradient entry near 0 whose sign differs between
  the frameworks moves its parameter by up to 2 x lr = 6e-4 apart, and the
  clip scale (``clip_norm=1.0``, summed in the reference's sorted leaf
  order on both sides) inherits the same last bits.  Measured on the CPU
  (x86, this test's inputs): at most 2.4e-6 relative on the BDE losses
  and 3.2e-7 on the IP losses, 0 and 9.7e-8 on the held-out predictions,
  and 6.0e-8 / 3.0e-8 max abs on the parameters; no sign flip happened in
  these 20 steps, so 1e-4 keeps a margin for one.  The parameters are
  held to the bound a flip allows, 2 x lr per step.
* Caches written by ``ensure_trained`` in either package load in the
  other, bit for bit, and both services then predict the same values.
"""

import os

import jax
import numpy as np
import pytest
import torch

import repro.predictors.training as JT
from repro.chem.smiles import from_smiles as jax_from_smiles
from repro.predictors.gnn import AlfabetS as JaxAlfabetS
from repro.predictors.ip_net import AIMNetS as JaxAIMNetS
from repro.predictors.service import (PropertyService as JaxService,
                                      capacity_table as jax_capacity_table,
                                      featurize as jax_featurize,
                                      stack_features as jax_stack)
import repro_torch.predictors.training as TT
from repro_torch.chem.smiles import from_smiles
from repro_torch.predictors import gnn, ip_net
from repro_torch.predictors.cache import LRUCache
from repro_torch.predictors.gnn import AlfabetS
from repro_torch.predictors.ip_net import AIMNetS
from repro_torch.predictors.service import (PropertyService, capacity_table,
                                            featurize, stack_features)

RTOL = 1e-5
TRAIN_RTOL = 1e-4
TRAIN_STEPS = 20
SMALL = dict(hidden=16, rounds=1)
# O-H phenols; symmetric O-H pairs (hydroquinone-like: tied per-atom
# BDEs); no O-H (+inf); invalid conformers (fused small rings, a ring
# triple bond)
SMILES = ("C1=CC=CC=C1O", "OC1=CC=C(O)C=C1", "CC(C)(C)C1=CC(O)=CC(C(C)(C)C)=C1O",
          "OC1=CC(O)=CC(O)=C1", "CC", "C1=CC=CC=C1", "OC1=CC2CC2C=C1",
          "C1#CCCCCC1O", "C1CC2CC12", "CC1=CC=CC=C1O", "NC1=CC=C(O)C=C1")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


@pytest.fixture(scope="module")
def corpus():
    """``build_corpus(max_mols=64)`` of both packages, with the molecules
    above appended (symmetric O-H pairs, no O-H, invalid conformers)."""
    jm = JT.build_corpus(max_mols=64) + [jax_from_smiles(s) for s in SMILES]
    tm = TT.build_corpus(max_mols=64) + [from_smiles(s) for s in SMILES]
    return jm, tm


# ------------------------------------------------------------------ #
# host code: bit-identical
# ------------------------------------------------------------------ #
def test_features_and_corpus_are_bit_identical(corpus):
    jm, tm = corpus
    assert [m.iso_key() for m in tm[:64]] == [m.iso_key() for m in jm[:64]]
    want = jax_stack([jax_featurize(m) for m in jm])
    got = stack_features([featurize(m) for m in tm])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert got["conf_valid"][-len(SMILES):].tolist() == [1, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1]
    jc, tc = JT.featurized_corpus(jm), TT.featurized_corpus(tm)
    for a, b in zip(jc[1:], tc[1:]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("max_batch", [1, 2, 7, 8, 16, 17, 64, 100, 512, 2048])
def test_capacity_table_is_the_reference_s(max_batch):
    assert capacity_table(max_batch) == jax_capacity_table(max_batch)
    assert capacity_table(max_batch, grain=4, ratio=2.0) == \
        jax_capacity_table(max_batch, grain=4, ratio=2.0)


# ------------------------------------------------------------------ #
# the forwards from the reference's own params
# ------------------------------------------------------------------ #
def _batch(corpus):
    jm, tm = corpus
    picks = list(range(0, 64, 9)) + list(range(64, 64 + len(SMILES)))
    want = jax_stack([jax_featurize(jm[i]) for i in picks])
    got = {k: torch.from_numpy(v) for k, v in
           stack_features([featurize(tm[i]) for i in picks]).items()}
    return want, got


@pytest.mark.parametrize("size", ["small", "launcher"])
def test_predictors_match_the_reference(corpus, size):
    kw = SMALL if size == "small" else {}
    jb, tb = _batch(corpus)
    jm = JaxAlfabetS(**kw)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = gnn.params_from_numpy(_np(jp), device="cpu")
    assert (tm.hidden, tm.n_rounds) == (jm.hidden, jm.rounds)
    jat, jmol = jm.apply(jp, jb)
    with torch.no_grad():
        tat, tmol = tm(tb)
    jmol = np.asarray(jmol)
    inf = ~np.isfinite(jmol)
    assert inf.any() and (~inf).any()
    assert np.array_equal(~np.isfinite(tmol.numpy()), inf)
    assert np.all(tmol.numpy()[inf] == np.inf)
    assert _rel(tmol.numpy()[~inf], jmol[~inf]) < RTOL
    assert _rel(tat.numpy(), jat) < RTOL

    ji = JaxAIMNetS(hidden=kw.get("hidden", 128), n_ensemble=2)
    jip = ji.init(jax.random.PRNGKey(1))
    ti = ip_net.params_from_numpy(_np(jip), device="cpu")
    assert ti.n_ensemble == 2
    with torch.no_grad():
        got = ti(tb).numpy()
    assert _rel(got, ji.apply(jip, jb)) < RTOL
    for back, tree in ((gnn.params_to_numpy(tm), jp), (ip_net.params_to_numpy(ti), jip)):
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            assert a.tobytes() == np.asarray(b).tobytes()


def test_params_from_numpy_refuses_a_wrong_tree():
    tree = gnn.params_to_numpy(AlfabetS(**SMALL, device="cpu"))
    tree["head2"]["w"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="head2/w"):
        gnn.params_from_numpy(tree, device="cpu")
    del tree["head2"]
    with pytest.raises((ValueError, KeyError)):
        gnn.load_tree(AlfabetS(**SMALL, device="cpu"), tree)


# ------------------------------------------------------------------ #
# PropertyService
# ------------------------------------------------------------------ #
def _services(cache=True):
    jm, ji = JaxAlfabetS(**SMALL), JaxAIMNetS(hidden=16)
    jp, jip = jm.init(jax.random.PRNGKey(2)), ji.init(jax.random.PRNGKey(3))
    kw = {} if cache else {"cache": None}
    jsvc = JaxService(jm, jp, ji, jip, max_batch_hint=16, **kw)
    tsvc = PropertyService(AlfabetS(**SMALL, device="cpu"), _np(jp),
                           AIMNetS(hidden=16, device="cpu"), _np(jip),
                           max_batch_hint=16, device="cpu", **kw)
    return jsvc, tsvc


def _stats(svc):
    c = svc.cache
    return (svc.n_predict_calls, svc.n_predictor_batches, svc.n_predictor_mols,
            None if c is None else (c.hits, c.misses, len(c)), svc._buckets)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_property_service_matches_the_reference(corpus, cache):
    """A sequence of batches with in-batch duplicates, cache hits, rows
    with no O-H and invalid conformers, sizes on several rungs and one
    over the hint: the same None pattern, values within 1e-5, counters."""
    jm, tm = corpus
    seqs = [[0, 1, 1, 64, 68, 69, 70], [0, 1, 2, 3], list(range(5, 30)),
            [64 + i for i in range(len(SMILES))] * 2, [2], list(range(30, 48))]
    jsvc, tsvc = _services(cache)
    every = []
    for seq in seqs:
        want = jsvc.predict([jm[i] for i in seq])
        got = tsvc.predict([tm[i] for i in seq])
        every += got
        assert [(p.bde is None, p.ip is None) for p in got] == \
            [(p.bde is None, p.ip is None) for p in want]
        for g, w in zip(got, want):
            for a, b in ((g.bde, w.bde), (g.ip, w.ip)):
                if b is not None:
                    assert abs(a - b) <= RTOL * abs(b)
        assert _stats(tsvc) == _stats(jsvc)
    assert any(p.bde is None for p in every) and any(p.ip is None for p in every)
    if cache:
        assert tsvc.cache.hits > 0 and isinstance(tsvc.cache, LRUCache)
    tsvc.reserve(40)
    jsvc.reserve(40)
    assert tsvc._buckets == jsvc._buckets


def test_property_service_pads_with_one_atom_dummies(corpus):
    """A batch of 3 pads to the rung of 8: the 5 padding rows are 1-atom
    dummies (mask[:, 0] = 1), so nothing in the padded forward is NaN, and
    the staging buffer of that rung is reused on the next call."""
    _, tm = corpus
    _, tsvc = _services(cache=False)
    seen = []
    fwd = tsvc.ip_model.forward

    def spy(batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        out = fwd(batch)
        assert torch.isfinite(out).all()
        return out
    tsvc.ip_model.forward = spy
    tsvc.predict(tm[:3])
    buf = tsvc._staging[8]
    tsvc.predict(tm[3:5])
    assert tsvc._staging[8] is buf and len(tsvc._staging) == 1
    for batch, b in zip(seen, (3, 2)):
        assert batch["mask"].shape == (8, 40)
        assert torch.all(batch["mask"][b:, 0] == 1) and torch.all(batch["mask"][b:, 1:] == 0)
        assert torch.all(batch["atom_feat"][b:] == 0) and torch.all(batch["adj"][b:] == 0)


def test_property_service_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="GPU"):
        PropertyService(None, gnn.params_to_numpy(AlfabetS(**SMALL, device="cpu")),
                        None, ip_net.params_to_numpy(AIMNetS(hidden=16, device="cpu")))


# ------------------------------------------------------------------ #
# training parity
# ------------------------------------------------------------------ #
class _LossRecorder:
    """Stands in for ``jax`` inside ``repro.predictors.training``: every
    attribute is jax's, but the jitted ``step`` records its loss."""

    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, *a, **kw):
        jitted = jax.jit(fn, *a, **kw)
        if fn.__name__ != "step":
            return jitted

        def run(*args):
            out = jitted(*args)
            self.losses.append(float(out[2]))
            return out
        return run


@pytest.mark.parametrize("kind", ["bde", "ip"])
def test_training_matches_the_reference(corpus, monkeypatch, kind):
    jm, tm = corpus
    rec = _LossRecorder()
    monkeypatch.setattr(JT, "jax", rec)
    if kind == "bde":
        monkeypatch.setattr(JT, "AlfabetS", lambda: JaxAlfabetS(**SMALL))
        jmodel, jparams, jmetrics = JT.train_bde_model(
            jm, steps=TRAIN_STEPS, batch_size=16, seed=0)
        init = _np(JaxAlfabetS(**SMALL).init(jax.random.PRNGKey(0)))
        train, to_np, seed = TT.train_bde_model, gnn.params_to_numpy, 0
    else:
        monkeypatch.setattr(JT, "AIMNetS", lambda: JaxAIMNetS(hidden=16))
        jmodel, jparams, jmetrics = JT.train_ip_model(
            jm, steps=TRAIN_STEPS, batch_size=16, seed=1)
        init = _np(JaxAIMNetS(hidden=16).init(jax.random.PRNGKey(1)))
        train, to_np, seed = TT.train_ip_model, ip_net.params_to_numpy, 1
    losses = []
    tmodel, tparams, tmetrics = train(
        tm, steps=TRAIN_STEPS, batch_size=16, seed=seed, device="cpu", init=init,
        on_step=lambda it, loss: losses.append(float(loss)))
    assert len(losses) == len(rec.losses) == TRAIN_STEPS
    assert _rel(losses, rec.losses) < TRAIN_RTOL
    assert losses[-1] < losses[0]
    assert sorted(tmetrics) == sorted(jmetrics)
    assert tmetrics["n_eval"] == jmetrics["n_eval"]
    for k in ("rel_err_mean", "mae"):
        assert _rel(tmetrics[k], jmetrics[k]) < 1e-3
    feats, _, _, has_bde = TT.featurized_corpus(tm)
    hold, _ = TT.holdout_split(has_bde if kind == "bde" else feats["conf_valid"] > 0.5)
    batch = {k: v[hold] for k, v in feats.items()}
    want = jmodel.apply(jparams, batch)
    want = np.asarray(want[1] if kind == "bde" else want)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    got = (got[1] if kind == "bde" else got).numpy()
    assert _rel(got, want) < TRAIN_RTOL
    for a, b in zip(jax.tree_util.tree_leaves(tparams), jax.tree_util.tree_leaves(_np(jparams))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * 3e-4 * TRAIN_STEPS)
    assert tparams.keys() == to_np(tmodel).keys()


# ------------------------------------------------------------------ #
# the disk cache, both directions
# ------------------------------------------------------------------ #
def test_ensure_trained_caches_cross_between_the_packages(corpus, tmp_path, monkeypatch):
    """Each package trains 5 steps on the 64-molecule corpus into its own
    directory; each loads both directories, with the same params (bit for
    bit) and metrics, and both services then predict the same values."""
    jm, tm = corpus
    monkeypatch.setattr(JT, "build_corpus", lambda: jm[:64])
    monkeypatch.setattr(TT, "build_corpus", lambda: tm[:64])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JT.ensure_trained(jdir, steps=5, verbose=False)
    trained = TT.ensure_trained(tdir, steps=5, verbose=False, device="cpu")
    assert sorted(os.listdir(tdir)) == \
        ["aimnet_s.npz", "alfabet_s.npz", "metrics.json"]
    for d in (jdir, tdir):
        jb, jbp, ji, jip, jmet = JT.ensure_trained(d, verbose=False)
        tb, tbp, ti, tip, tmet = TT.ensure_trained(d, verbose=False, device="cpu")
        assert tmet == jmet
        for a, b in zip(jax.tree_util.tree_leaves((tbp, tip)),
                        jax.tree_util.tree_leaves((jbp, jip))):
            assert a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes()
        jsvc = JaxService(jb, jbp, ji, jip)
        tsvc = PropertyService(tb, tbp, ti, tip, device="cpu")
        mols = list(range(0, 64, 5))
        for g, w in zip(tsvc.predict([tm[i] for i in mols]),
                        jsvc.predict([jm[i] for i in mols])):
            assert abs(g.bde - w.bde) <= RTOL * abs(w.bde)
            assert abs(g.ip - w.ip) <= RTOL * abs(w.ip)
    for a, b in zip(jax.tree_util.tree_leaves(gnn.params_to_numpy(trained[0])),
                    jax.tree_util.tree_leaves(trained[1])):
        assert a.tobytes() == b.tobytes()
