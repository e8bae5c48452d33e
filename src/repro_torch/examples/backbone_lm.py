"""Port of ``examples/backbone_lm.py``: train a model-zoo backbone as a
SMILES language model (reduced config).

The same train step the launcher runs (``launch/steps.make_train_step``)
on a reduced config over the antioxidant SMILES corpus (with the
reference's stub frames or patches for encdec and vlm configs): the loss
should drop from ~ln(vocab) toward the corpus entropy within ~100 steps,
and the run fails if the last loss is not below the first.

    PYTHONPATH=src python -m repro_torch.examples.backbone_lm --arch mamba2-2.7b --steps 100
    PYTHONPATH=src python -m repro_torch.examples.backbone_lm --device cpu --steps 20

It runs on ``--device`` (default ``cuda``).  The weights are
``init_params(cfg, 0)`` from a ``torch.Generator``, not the reference's
``jax.random.PRNGKey(0)``, so the losses differ from the reference's.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.launch.train import lm_batches, lm_loop, with_stub_inputs
from repro_torch.models import init_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="train a reduced backbone as a SMILES LM")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, 0, device=args.device)
    t0 = time.time()
    losses = lm_loop(cfg, params, with_stub_inputs(cfg, lm_batches(args.batch, args.seq)),
                     args.steps, log_every=20)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} in {args.steps} steps "
          f"({time.time()-t0:.0f}s)")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"LM loss must decrease: {losses[0]} -> {losses[-1]}")


if __name__ == "__main__":
    main()
