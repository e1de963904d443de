"""granite-4.0-h-small [hybrid_moe]: 40 layers, 36 mamba2 mixers and 4 NoPE
GQA attention mixers (layers 5, 15, 25, 35), each followed by 72 SwiGLU
experts (top 10) and a shared expert; 32 B parameters, 9 B active.
[hf:ibm-granite/granite-4.0-h-small, config.json; model_type
granitemoehybrid]

Kept out of ``configs.registry.ARCHS``, which holds the JAX package's
assigned architectures (the JAX package has no such family)."""
from repro_torch.models.config import ArchConfig, Family, MoEConfig, SSMConfig

# layer_types: "attention" at 5, 15, 25 and 35, "mamba" elsewhere
PATTERN = "".join("A" if i % 10 == 5 else "M" for i in range(40))

ARCH = ArchConfig(
    name="granite-4.0-h-small",
    family=Family.HYBRID_MOE,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    head_dim=128,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, capacity_factor=7.2, shared_d_ff=1536),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256, version=2),
    layer_pattern=PATTERN,
    rope=False,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)
