"""qwen2-1.5b [dense]: GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ArchConfig, Family

ARCH = ArchConfig(
    name="qwen2-1.5b",
    family=Family.DENSE,
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
)
