"""Port of ``repro.core.packed_batch``: device-side unpack of packed batches.

The packed learner path ships ``ReplayBuffer.sample_packed`` output to the
device as uint8 bit planes (32x less host-to-device traffic than the dense
float32 layout) and rebuilds the dense train-step arrays there, on the
batch's own device, so the full ``[W, B, C, FP_BITS+1]`` float32 tensor
never crosses the bus.

``unpack_bits`` reproduces ``np.unpackbits`` (MSB first within each byte,
the ``pack_fps`` contract) with shifts and masks, and ``densify_batch`` is
the tensor twin of ``repro_torch.core.replay.densify_sample``: both give
bit-identical training batches, which is what makes the packed learner's
loss trajectory match the dense one bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.chem.fingerprint import FP_BITS


def unpack_bits(packed: torch.Tensor, n_bits: int | None = None) -> torch.Tensor:
    """uint8 [..., n_bytes] -> float32 [..., n_bytes*8] of exact {0.0, 1.0}.

    Bit order matches ``np.unpackbits`` (MSB of byte i becomes bit 8i)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    out = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    if n_bits is not None:
        out = out[..., :n_bits]
    return out.to(torch.float32)


def densify_batch(packed: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Packed batch -> the dense layout the double-DQN loss consumes.

    Works for any leading batch dims (the trainer passes ``[W, B, ...]``
    stacked batches).  Candidate rows past each transition's count — and
    every row of terminal transitions — are zeroed, exactly like the
    host-side ``densify_sample``.
    """
    states = torch.cat(
        [unpack_bits(packed["state_bits"]), packed["state_frac"].unsqueeze(-1)],
        dim=-1)
    C = packed["next_bits"].shape[-2]
    dones = packed["dones"]
    eff = torch.where(dones > 0, torch.zeros_like(packed["next_counts"]),
                      torch.clamp(packed["next_counts"], max=C))
    next_mask = (torch.arange(C, device=dones.device)
                 < eff.unsqueeze(-1)).to(torch.float32)
    next_fps = torch.cat(
        [unpack_bits(packed["next_bits"]) * next_mask.unsqueeze(-1),
         (packed["next_frac"].unsqueeze(-1) * next_mask).unsqueeze(-1)],
        dim=-1)
    out = {"states": states, "rewards": packed["rewards"],
           "dones": dones, "next_fps": next_fps, "next_mask": next_mask}
    if "weights" in packed:          # prioritized replay importance weights
        out["weights"] = packed["weights"]
    return out


def packed_nbytes(packed: dict) -> int:
    """Host->device bytes a packed (or dense) batch dict ships."""
    return int(sum(v.nbytes for v in packed.values()))


def dense_nbytes_equivalent(packed: dict) -> int:
    """What the same batch would ship in the dense float32 layout
    (states/rewards/dones/next_fps/next_mask) — the H2D-reduction metric."""
    b_shape = packed["state_bits"].shape[:-1]      # [..., B]
    C = packed["next_bits"].shape[-2]
    rows = 1
    for d in b_shape:
        rows *= d
    n = 4 * (rows * (FP_BITS + 1)             # states
             + rows + rows                    # rewards, dones
             + rows * C * (FP_BITS + 1)       # next_fps
             + rows * C)                      # next_mask
    if "weights" in packed:                   # prioritized: weights ship in
        n += 4 * rows                         # both layouts identically
    return n
