"""Port of ``repro.optim`` (Adam and its gradient transforms; the LR
schedules arrive with the backbone slice)."""

from repro_torch.optim.adam import (OptState, Optimizer, adam, apply_updates,
                                    clip_by_global_norm, global_norm)

__all__ = ["OptState", "Optimizer", "adam", "apply_updates",
           "clip_by_global_norm", "global_norm"]
