"""llava-next-mistral-7b [vlm]: mistral-7b backbone, anyres patch frontend
stubbed. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.config import ArchConfig, Family

ARCH = ArchConfig(
    name="llava-next-mistral-7b",
    family=Family.VLM,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    frontend_stub="vision",
)
