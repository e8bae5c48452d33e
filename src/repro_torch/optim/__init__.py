"""Port of ``repro.optim``: Adam, SGD, their gradient transforms and the
learning-rate schedules."""

from repro_torch.optim.adam import (OptState, Optimizer, adam, apply_updates,
                                    clip_by_global_norm, global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         exponential_decay, linear_warmup_cosine)

__all__ = ["OptState", "Optimizer", "adam", "apply_updates",
           "clip_by_global_norm", "global_norm", "sgd", "constant", "cosine_decay",
           "linear_warmup_cosine", "exponential_decay"]
