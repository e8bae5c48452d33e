"""Port of ``repro.launch.serve``: batched greedy decoding through
``serve_step``, on the GPU unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batch 4 --prompt-len 8 --new-tokens 16

Any registered config (every family; encdec and vlm decode from the
reference's zero cross K/V and image-prefix slots).  Runs prefill
(token-by-token fill of the KV/state cache, as the reference does) then
greedy decode, printing tokens/s on the host clock with the
device synchronised at both ends.  The flags are the reference's, quirk
included: ``--reduced`` is ``store_true`` with default True, so the
launcher always runs the reduced config.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import init_cache, init_params, serve_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the GPU raises if absent")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(args) -> tuple[list[list[int]], float]:
    """Run the launcher; returns (generated ids per row, decode seconds)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device=device)
    B = args.batch
    total = args.prompt_len + args.new_tokens
    cache = init_cache(cfg, B, total, device=device)

    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(1, cfg.vocab, (B, args.prompt_len)).astype(np.int64)).to(device)

    # warmup: one decode step on a throwaway cache, off the clock
    serve_step(params, cfg, init_cache(cfg, B, total, device=device), prompt[:, :1])

    # prefill (sequentially through the decode path)
    for t in range(args.prompt_len):
        logits, cache = serve_step(params, cfg, cache, prompt[:, t:t + 1])

    _sync(device)
    out = []
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        out.append(tok[:, 0])
        logits, cache = serve_step(params, cfg, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    _sync(device)
    dt = time.perf_counter() - t0
    ids = torch.stack(out, dim=1).cpu().tolist()
    toks = B * args.new_tokens
    print(f"arch={cfg.name} batch={B} decode {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s on {device.type})")
    print("sample token ids:", ids[0][:12])
    return ids, dt


def main(argv=None) -> None:
    serve(parser().parse_args(argv))


if __name__ == "__main__":
    main()
