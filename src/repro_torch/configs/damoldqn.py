"""Copy of ``repro.configs.damoldqn``; only its imports differ.

The paper's own model: the DA-MolDQN fingerprint Q-network.

Not one of the 10 assigned architectures but included in the dry-run matrix
so the paper's actual train step is exercised on the production mesh (the
'technique-representative' roofline row).  Expressed in ArchConfig terms as
a degenerate dense MLP: the launcher special-cases family="qnet".
"""

from repro_torch.configs.base import ArchConfig, register


@register("damoldqn")
def config() -> ArchConfig:
    return ArchConfig(
        name="damoldqn",
        family="qnet",
        n_layers=5,                     # [1024, 512, 128, 32] + head
        d_model=2049,                   # fingerprint ++ steps-left
        n_heads=1,
        n_kv_heads=1,
        d_ff=1024,
        vocab=0,
        dtype="float32",
        remat=False,
        source="this paper (MolDQN arch, Zhou et al. 2019)",
    )
