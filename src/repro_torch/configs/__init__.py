"""Port of ``repro.configs``: the architecture registry and the scenario
registry (``scenarios.py``).

The registry holds every architecture of the reference: the LM families
(dense, moe, ssm, hybrid, encdec and vlm) and the paper's own Q-network
(``damoldqn``, the qnet family).
"""

from repro_torch.configs.base import (
    ArchConfig, MoEConfig, SSMConfig, EncDecConfig, VLMConfig,
    InputShape, INPUT_SHAPES, get_config, register, list_archs,
)

# import for registration side effects
import repro_torch.configs.qwen3_moe_235b_a22b  # noqa: F401
import repro_torch.configs.zamba2_1p2b          # noqa: F401
import repro_torch.configs.stablelm_1p6b        # noqa: F401
import repro_torch.configs.granite_34b          # noqa: F401
import repro_torch.configs.mamba2_2p7b          # noqa: F401
import repro_torch.configs.yi_34b               # noqa: F401
import repro_torch.configs.mixtral_8x22b        # noqa: F401
import repro_torch.configs.whisper_large_v3     # noqa: F401
import repro_torch.configs.paligemma_3b         # noqa: F401
import repro_torch.configs.granite_20b          # noqa: F401
import repro_torch.configs.damoldqn             # noqa: F401

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "EncDecConfig", "VLMConfig",
    "InputShape", "INPUT_SHAPES", "get_config", "register", "list_archs",
]
