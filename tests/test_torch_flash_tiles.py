"""The bf16 ``flash_attention`` kernel's tile rules, on the CPU.

The kernel skips a 64-key tile for a 128-query block, and a warp's 16-row
slice skips its math, where ``tile_live`` is false; it evaluates no
per-element mask where ``tile_full`` is true (``csrc/flash_attention.cu``).
``ref.tile_live`` and ``ref.tile_full`` mirror those rules; here they are
held against ``attention_ref``'s own mask over causal, window and prefix
combinations and ragged Sq / Sk: a skipped tile has no valid pair, a tile
with a valid pair is live, and a full tile has only valid pairs.  The
kernel itself runs only on the card (``chip_smoke.py``)."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (BK, BQ, attn_mask,
                                                     tile_full, tile_live)

SHAPES = [(320, 320), (384, 384), (200, 200), (200, 264), (264, 200),
          (1, 70), (130, 64), (4096, 4096)]
MASKS = [  # causal, window, prefix
    (True, None, 0), (False, None, 0), (True, 96, 0), (True, 1, 0),
    (True, None, 130), (True, 32, 16), (False, 200, 0), (False, 64, 130),
    (True, 96, 1)]


def _tiles(sq: int, sk: int, bq: int):
    for q0 in range(0, sq, bq):
        for k0 in range(0, sk, BK):
            yield q0, min(q0 + bq, sq) - 1, k0


@pytest.mark.parametrize("sq,sk", SHAPES)
@pytest.mark.parametrize("causal,window,prefix", MASKS)
@pytest.mark.parametrize("bq", [BQ, 16], ids=["block", "warp"])
def test_tile_rules_agree_with_the_reference_mask(sq, sk, causal, window,
                                                  prefix, bq):
    mk = dict(causal=causal, window=window, prefix_len=prefix)
    mask = attn_mask(sq, sk, **mk)
    n_live = 0
    for q0, qmax, k0 in _tiles(sq, sk, bq):
        tile = mask[q0:qmax + 1, k0:k0 + BK]
        live = tile_live(q0, qmax, k0, sk, **mk)
        assert live == bool(tile.any()), (q0, k0)
        n_live += live
        # the kernel asks with the slice's last row, padded rows included
        if tile_full(q0, q0 + bq - 1, k0, sk, **mk):
            assert bool(tile.all()) and tile.shape[1] == BK, (q0, k0)
    assert n_live > 0


def test_causal_skip_halves_the_path_shape():
    """At the prefill path's S = 4096, causal, a (batch, head) visits 1056
    of its 2048 tiles of 128 x 64, and 992 of those need no mask."""
    sq = sk = 4096
    mk = dict(causal=True, window=None, prefix_len=0)
    live = [t for t in _tiles(sq, sk, BQ) if tile_live(*t, sk, **mk)]
    full = [t for t in live if tile_full(t[0], t[0] + BQ - 1, t[2], sk, **mk)]
    assert (len(live), len(full)) == (1056, 992)


def test_bf16_alignment_is_checked_only_for_the_card():
    """A bf16 view whose strides are not 16-byte multiples runs the plain
    version on the CPU; the same view on the card raises (``chip_smoke.py``
    checks that)."""
    base = torch.randn(1, 64, 2, 65).bfloat16()
    q = k = v = base[..., 1:65]                  # 2-byte offset, stride 130
    assert q.stride(-1) == 1 and q.storage_offset() == 1
    launches = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa_ops.flash_attention.launches == launches
    assert out.shape == (1, 64, 2, 64) and bool(torch.isfinite(out.float()).all())
