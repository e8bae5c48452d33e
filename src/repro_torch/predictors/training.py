"""Port of ``repro.predictors.training``: train the surrogate predictors
against the chemistry oracle, on the card.

The paper's predictors come pre-trained on >100k molecules; ours are small
enough to train here, but they must generalise to the molecules the *RL
agent* visits, not just the dataset — so the training corpus augments the
antioxidant sets with random edit-walks (the same action space the agent
uses).  Accuracy target is the paper's: <5% average relative error (§2.2).

The loops are the reference's: the same corpus, the same numpy minibatch
stream, MSE on normalised targets, the hand-ported Adam
(``optim/adam.py``) with ``clip_norm=1.0`` over the parameters in the
reference's leaf order (so the clip's global norm sums in the same order),
under torch autograd on ``device``.  The featurized corpus is put on the
device once and each minibatch is gathered there.

``ensure_trained`` is the entry point everything else uses: it trains once
and caches params + a metrics json in the reference's format
(``alfabet_s.npz``, ``aimnet_s.npz``, ``metrics.json``) under
``.cache/predictors_torch``, apart from the reference's ``.cache/predictors``
so that one package's cache is never taken for the other's silently.
Either package's cache loads when its directory is passed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree, save_pytree, tree_leaves
from repro_torch.chem.actions import enumerate_actions
from repro_torch.chem.molecule import Molecule
from repro_torch.chem.oracle import oracle_bde, oracle_ip
from repro_torch.data.datasets import antioxidant_dataset, public_antioxidant_dataset
from repro_torch.device import resolve_device
from repro_torch.optim.adam import adam
from repro_torch.predictors import gnn, ip_net
from repro_torch.predictors.gnn import AlfabetS, BDE_MEAN, BDE_SCALE
from repro_torch.predictors.ip_net import AIMNetS, IP_MEAN, IP_SCALE
from repro_torch.predictors.service import MAX_ATOMS, featurize, stack_features

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                 ".cache", "predictors_torch")

Corpus = tuple[dict, np.ndarray, np.ndarray, np.ndarray]
_MODEL_INPUTS = ("atom_feat", "adj", "mask", "conf_feat")


# ------------------------------------------------------------------ #
# corpus
# ------------------------------------------------------------------ #
def build_corpus(n_walk_steps: int = 3, seed: int = 11, max_mols: int = 4000) -> list[Molecule]:
    """Dataset molecules + random edit-walk intermediates (dedup'd)."""
    rng = np.random.default_rng(seed)
    base = antioxidant_dataset(600) + public_antioxidant_dataset(256)
    out: list[Molecule] = []
    seen: set[int] = set()

    def add(m: Molecule) -> None:
        key = m.iso_key()
        if key not in seen and m.num_atoms <= MAX_ATOMS:
            seen.add(key)
            out.append(m)

    for m in base:
        add(m)
    for m in base:
        cur = m
        for _ in range(n_walk_steps):
            acts = enumerate_actions(cur, protect_oh=True)
            if len(acts) <= 1:
                break
            cur = acts[int(rng.integers(1, len(acts)))].result
            add(cur)
        if len(out) >= max_mols:
            break
    return out[:max_mols]


def featurized_corpus(mols: list[Molecule]) -> Corpus:
    """Stacked features + oracle targets + validity masks."""
    feats = stack_features([featurize(m) for m in mols])
    bde = np.array([oracle_bde(m) if m.has_oh_bond() else np.nan for m in mols], np.float32)
    ip = np.array([oracle_ip(m) for m in mols], np.float32)
    has_bde = np.isfinite(bde)
    return feats, bde, ip, has_bde


def corpus_to_device(feats: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """The model inputs of the whole corpus, copied to ``device`` once."""
    return {k: torch.from_numpy(feats[k]).to(device) for k in _MODEL_INPUTS}


# ------------------------------------------------------------------ #
# training loops
# ------------------------------------------------------------------ #
def _minibatches(rng: np.random.Generator, n: int, batch: int):
    while True:
        order = rng.permutation(n)
        for s in range(0, n - batch + 1, batch):
            yield order[s : s + batch]


def _fit(model: torch.nn.Module, loss_fn, dev: dict[str, torch.Tensor],
         target_n: np.ndarray, train: np.ndarray, *, steps: int,
         batch_size: int, lr: float, seed: int, log_every: int, tag: str,
         on_step: Callable[[int, torch.Tensor], None] | None) -> None:
    """The reference's loop: ``steps`` Adam steps (clip 1.0) on minibatches
    of ``train`` drawn from ``np.random.default_rng(seed)``."""
    device = next(model.parameters()).device
    leaves = tree_leaves(model.tree())   # the reference's order: the clip sums in it
    opt = adam(lr, clip_norm=1.0)
    state = opt.init(leaves)
    tgt_all = torch.from_numpy(target_n).to(device)
    rng = np.random.default_rng(seed)
    gen = _minibatches(rng, len(train), min(batch_size, len(train)))
    for it in range(steps):
        sel = torch.from_numpy(train[next(gen)]).to(device)
        loss = loss_fn({k: v[sel] for k, v in dev.items()}, tgt_all[sel])
        grads = torch.autograd.grad(loss, leaves)
        updates, state = opt.update(list(grads), state, leaves)
        with torch.no_grad():
            for p, u in zip(leaves, updates):
                p.add_(u)
        if on_step is not None:
            on_step(it, loss.detach())
        if log_every and (it + 1) % log_every == 0:
            print(f"[{tag}] step {it+1}: loss {float(loss):.4f}")


def holdout_split(valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(held-out, train) corpus indices over the rows where ``valid``: the
    first tenth (at least one) is held out, as in the reference."""
    idx = np.nonzero(valid)[0]
    n_hold = max(len(idx) // 10, 1)
    return idx[:n_hold], idx[n_hold:]


def _rel_metrics(pred: np.ndarray, truth: np.ndarray) -> dict:
    rel = np.abs(pred - truth) / np.abs(truth)
    return {"rel_err_mean": float(rel.mean()), "rel_err_p95": float(np.percentile(rel, 95)),
            "mae": float(np.abs(pred - truth).mean()), "n_eval": int(len(truth))}


def train_bde_model(
    mols: list[Molecule] | None = None,
    *,
    steps: int = 1500,
    batch_size: int = 128,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 0,
    device: str | torch.device | None = None,
    init: dict | None = None,
    corpus: Corpus | None = None,
    on_step: Callable[[int, torch.Tensor], None] | None = None,
) -> tuple[AlfabetS, dict, dict]:
    """Returns (model, params, metrics): the trained module on ``device``,
    its parameters as the reference's numpy tree, and the held-out error.

    ``init`` starts from a given numpy tree (parity tests pass the
    reference's ``init``) instead of a He-normal draw from ``seed``;
    ``corpus`` reuses a ``featurized_corpus`` result; ``on_step(it, loss)``
    sees each step's loss on the device."""
    device = resolve_device(device)
    if corpus is None:
        corpus = featurized_corpus(mols if mols is not None else build_corpus())
    feats, bde, _, has_bde = corpus
    hold, train = holdout_split(has_bde)

    model = gnn.params_from_numpy(init, device=device) if init is not None else \
        AlfabetS(generator=torch.Generator().manual_seed(seed), device=device)
    target_n = (bde - BDE_MEAN) / BDE_SCALE

    def loss_fn(batch, tgt):
        _, mol_bde = model(batch)
        pred_n = (mol_bde - BDE_MEAN) / BDE_SCALE
        return torch.mean(torch.square(pred_n - tgt))

    dev = corpus_to_device(feats, device)
    _fit(model, loss_fn, dev, target_n, train, steps=steps, batch_size=batch_size,
         lr=lr, seed=seed, log_every=log_every, tag="bde", on_step=on_step)
    pred = predict_corpus(model, dev, hold, "bde")
    return model, gnn.params_to_numpy(model), _rel_metrics(pred, bde[hold])


def train_ip_model(
    mols: list[Molecule] | None = None,
    *,
    steps: int = 1500,
    batch_size: int = 128,
    lr: float = 3e-4,
    seed: int = 1,
    log_every: int = 0,
    device: str | torch.device | None = None,
    init: dict | None = None,
    corpus: Corpus | None = None,
    on_step: Callable[[int, torch.Tensor], None] | None = None,
) -> tuple[AIMNetS, dict, dict]:
    """As ``train_bde_model``, for the IP model over valid conformers."""
    device = resolve_device(device)
    if corpus is None:
        corpus = featurized_corpus(mols if mols is not None else build_corpus())
    feats, _, ip, _ = corpus
    hold, train = holdout_split(feats["conf_valid"] > 0.5)

    model = ip_net.params_from_numpy(init, device=device) if init is not None else \
        AIMNetS(generator=torch.Generator().manual_seed(seed), device=device)
    target_n = (ip - IP_MEAN) / IP_SCALE

    def loss_fn(batch, tgt):
        pred = model(batch)
        return torch.mean(torch.square((pred - IP_MEAN) / IP_SCALE - tgt))

    dev = corpus_to_device(feats, device)
    _fit(model, loss_fn, dev, target_n, train, steps=steps, batch_size=batch_size,
         lr=lr, seed=seed, log_every=log_every, tag="ip", on_step=on_step)
    pred = predict_corpus(model, dev, hold, "ip")
    return model, ip_net.params_to_numpy(model), _rel_metrics(pred, ip[hold])


def predict_corpus(model: torch.nn.Module, dev: dict[str, torch.Tensor],
                   idx: np.ndarray, kind: str) -> np.ndarray:
    """One forward of ``model`` over the corpus rows ``idx`` (``kind``
    "bde": the molecule BDE; "ip": the IP), back on the host."""
    with torch.inference_mode():
        sel = torch.from_numpy(np.asarray(idx)).to(next(iter(dev.values())).device)
        out = model({k: v[sel] for k, v in dev.items()})
        return (out[1] if kind == "bde" else out).cpu().numpy()


# ------------------------------------------------------------------ #
# disk-cached entry point
# ------------------------------------------------------------------ #
def ensure_trained(cache_dir: str | None = None, *, steps: int = 1500,
                   verbose: bool = True, device: str | torch.device | None = None,
                   corpus: Corpus | None = None):
    """Train-or-load both predictors.  Returns (bde_model, bde_params,
    ip_model, ip_params, metrics): the modules on ``device`` and their
    parameters as the reference's numpy trees.  Training uses ``corpus``
    (a ``featurized_corpus`` result) when given, else builds the
    reference's ``featurized_corpus(build_corpus())``."""
    device = resolve_device(device)
    cache_dir = os.path.abspath(cache_dir or DEFAULT_CACHE_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    bde_path = os.path.join(cache_dir, "alfabet_s.npz")
    ip_path = os.path.join(cache_dir, "aimnet_s.npz")
    meta_path = os.path.join(cache_dir, "metrics.json")

    if os.path.exists(bde_path) and os.path.exists(ip_path) and os.path.exists(meta_path):
        bde_params = load_pytree(bde_path, gnn.params_to_numpy(AlfabetS(device="cpu")))
        ip_params = load_pytree(ip_path, ip_net.params_to_numpy(AIMNetS(device="cpu")))
        with open(meta_path) as f:
            metrics = json.load(f)
        return (gnn.params_from_numpy(bde_params, device=device), bde_params,
                ip_net.params_from_numpy(ip_params, device=device), ip_params, metrics)

    if verbose:
        print("[predictors] training Alfabet-S + AIMNet-S against the oracle ...")
    if corpus is None:
        t0 = time.perf_counter()
        corpus = featurized_corpus(build_corpus())
        if verbose:
            print(f"[predictors] corpus: {len(corpus[1])} molecules built and "
                  f"featurized in {time.perf_counter() - t0:.2f} s (host)",
                  flush=True)
    timed = []
    for train in (train_bde_model, train_ip_model):
        t0 = time.perf_counter()
        timed.append(train(steps=steps, device=device, corpus=corpus))
        if verbose:
            print(f"[predictors] {train.__name__}: {steps} steps and the held-out "
                  f"eval in {time.perf_counter() - t0:.2f} s on {device}", flush=True)
    (bde_model, bde_params, bde_metrics), (ip_model, ip_params, ip_metrics) = timed
    metrics = {"bde": bde_metrics, "ip": ip_metrics}
    if verbose:
        print(f"[predictors] BDE rel err {bde_metrics['rel_err_mean']:.3%}, "
              f"IP rel err {ip_metrics['rel_err_mean']:.3%}")
    save_pytree(bde_path, bde_params)
    save_pytree(ip_path, ip_params)
    with open(meta_path, "w") as f:
        json.dump(metrics, f, indent=2)
    return bde_model, bde_params, ip_model, ip_params, metrics
