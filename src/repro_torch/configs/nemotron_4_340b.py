"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ArchConfig, Family, MLPKind

ARCH = ArchConfig(
    name="nemotron-4-340b",
    family=Family.DENSE,
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp=MLPKind.RELU2,
)
