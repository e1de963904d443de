"""Architecture registry: ``--arch <id>`` resolution."""
from typing import Dict

from repro_torch.models.config import ArchConfig

from . import (
    falcon_mamba_7b,
    granite_moe_3b,
    llava_next_mistral_7b,
    nemotron_4_340b,
    phi3_5_moe,
    qwen2_1_5b,
    whisper_large_v3,
    yi_6b,
    yi_9b,
    zamba2_1_2b,
)

ARCHS: Dict[str, ArchConfig] = {
    m.ARCH.name: m.ARCH
    for m in (
        whisper_large_v3, falcon_mamba_7b, zamba2_1_2b, yi_9b, qwen2_1_5b,
        yi_6b, nemotron_4_340b, phi3_5_moe, granite_moe_3b,
        llava_next_mistral_7b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
