"""Port of ``repro.core``: the agent's Q-network and the host-side engine.

Modules are imported by path (``repro_torch.core.rollout``); this package
init imports nothing, so loading one module never pulls in the others.
"""
