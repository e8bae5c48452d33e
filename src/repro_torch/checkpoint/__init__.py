"""Port of ``repro.checkpoint``: pytree checkpointing (npz-based, no
external deps), in the reference's file format."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointError,
    CheckpointManager,
    load_flat,
    load_pytree,
    rng_state_from_array,
    rng_state_to_array,
    save_flat,
    save_pytree,
    tree_leaves,
    tree_leaves_with_paths,
    unflatten_like,
)

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "load_flat",
    "load_pytree",
    "rng_state_from_array",
    "rng_state_to_array",
    "save_flat",
    "save_pytree",
    "tree_leaves",
    "tree_leaves_with_paths",
    "unflatten_like",
]
