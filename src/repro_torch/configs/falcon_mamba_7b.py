"""falcon-mamba-7b [ssm]: attention-free mamba1. [arXiv:2410.05355; unverified]"""
from repro_torch.models.config import ArchConfig, Family, SSMConfig

ARCH = ArchConfig(
    name="falcon-mamba-7b",
    family=Family.SSM,
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    subquadratic=True,
)
