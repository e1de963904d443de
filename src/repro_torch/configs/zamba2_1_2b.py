"""zamba2-1.2b [hybrid]: mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ArchConfig, Family, SSMConfig

ARCH = ArchConfig(
    name="zamba2-1.2b",
    family=Family.HYBRID,
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, version=2),
    shared_attn_period=6,
    subquadratic=True,
)
