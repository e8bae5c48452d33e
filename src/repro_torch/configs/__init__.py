"""Port of ``repro.configs``: the architecture registry and the scenario
registry (``scenarios.py``).

So far the registry holds the architectures whose families the port's
model zoo runs (dense, ssm, hybrid): ``zamba2-1.2b``, ``stablelm-1.6b`` and
``mamba2-2.7b``.  The other reference configs come with their families
(ROADMAP A7).
"""

from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, EncDecConfig, VLMConfig,
    InputShape, INPUT_SHAPES, get_config, register, list_archs,
)

# import for registration side effects
import repro_torch.configs.zamba2_1p2b          # noqa: F401
import repro_torch.configs.stablelm_1p6b        # noqa: F401
import repro_torch.configs.mamba2_2p7b          # noqa: F401

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "EncDecConfig", "VLMConfig",
    "InputShape", "INPUT_SHAPES", "get_config", "register", "list_archs",
]
