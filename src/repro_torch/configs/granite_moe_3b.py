"""granite-moe-3b-a800m [moe]: 40 experts, top-8 (spec field; the assignment
comment says 32 but the structured field says 40 — we implement 40, padded to
48 so the expert axis shards over the 16-way model axis).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.config import ArchConfig, Family, MoEConfig

ARCH = ArchConfig(
    name="granite-moe-3b-a800m",
    family=Family.MOE,
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, n_experts_padded=48),
)
