"""Port of the repository's ``examples/``: the paper's workflow end to end
on the GPU, one runnable module each (``python -m
repro_torch.examples.<name>``)."""
