"""Port of ``repro.models``: the model zoo for the dense, moe, ssm, hybrid,
encdec and vlm families (and the qnet family's parameter tree), as plain
functions over parameter trees.

    init_params(cfg, seed, device=)          random params on the device
    abstract_params(cfg)                     the tree on ``meta`` (dry-run)
    count_params(cfg)                        from a shape-only tree
    active_params(cfg)                       per token (MoE: top_k of E experts)
    params_from_numpy(tree, device=)         the reference's params, bit for bit
    params_to_numpy(params)                  and back
    forward_train(params, cfg, batch)        -> (logits, aux)
    loss_fn(params, cfg, batch)              -> masked LM cross-entropy
    init_cache(cfg, batch, seq_len, device=) -> decode cache
    serve_step(params, cfg, cache, tokens)   -> (logits, cache)
    param_pspecs(cfg, tp)                    a spec tuple per leaf (dry-run)

With ``cfg.use_pallas`` the full-sequence forward runs attention and the
SSD scan through the hand-written CUDA kernels, which are forward only
(``loss_fn`` trains through the plain routes, as the reference does).
"""

from repro_torch.models.model import (
    init_params, abstract_params, forward_train, loss_fn, init_cache, serve_step,
    param_pspecs, count_params, active_params, params_from_numpy, params_to_numpy,
)

__all__ = [
    "init_params", "abstract_params", "forward_train", "loss_fn", "init_cache",
    "serve_step", "param_pspecs", "count_params", "active_params",
    "params_from_numpy", "params_to_numpy",
]
