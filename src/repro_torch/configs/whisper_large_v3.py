"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ArchConfig, Family, MLPKind

ARCH = ArchConfig(
    name="whisper-large-v3",
    family=Family.AUDIO,
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp=MLPKind.GELU,
    qkv_bias=True,
    enc_len=1536,            # native 1500 mel frames, padded to 128-multiple
    frontend_stub="audio",
    subquadratic=False,
)
