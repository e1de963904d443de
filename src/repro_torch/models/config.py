"""Architecture and shape configuration for the assigned model pool.

Every assigned architecture is a selectable config (``--arch <id>``); every
(arch x shape) cell is well-defined through ``Cell``.  Configs are exact to
the assignment table; sharding-driven padding (vocab to multiples of 256)
is recorded separately so the logical vocab is preserved for the loss.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"          # decoder-only full attention
    MOE = "moe"              # decoder-only with MoE MLP
    SSM = "ssm"              # pure mamba1
    HYBRID = "hybrid"        # mamba2 backbone + shared attention blocks
    HYBRID_MOE = "hybrid_moe"  # mamba2 / attention mixers by layer_pattern, each + MoE
    ENC_DEC = "enc_dec"      # whisper-style encoder-decoder
    VLM = "vlm"              # decoder-only w/ vision-patch stub frontend
    AUDIO = "audio"          # alias for enc-dec with audio stub frontend


class MLPKind(str, enum.Enum):
    GATED_SILU = "gated_silu"    # llama-style SwiGLU
    GELU = "gelu"                # plain 2-matrix GELU (whisper)
    RELU2 = "relu2"              # squared-ReLU (nemotron)


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Experts padded so the expert axis is shardable over the model axis.
    n_experts_padded: int = 0
    # Width of a SwiGLU shared expert that every token also goes through,
    # added to the routed sum (0: none).
    shared_d_ff: int = 0

    def __post_init__(self):
        if self.n_experts_padded == 0:
            object.__setattr__(
                self, "n_experts_padded", self.n_experts
            )


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # mamba2 only:
    head_dim: int = 64
    chunk: int = 256
    version: int = 1   # 1 = mamba1 selective scan, 2 = mamba2 SSD


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    mlp: MLPKind = MLPKind.GATED_SILU
    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one shared attention block applied every `shared_attn_period`
    # backbone layers (zamba2-style).
    shared_attn_period: int = 0
    # enc-dec: encoder length used by serving/training cells.
    enc_len: int = 0
    # Modality frontend stub: inputs are precomputed embeddings of this dim.
    frontend_stub: Optional[str] = None  # "audio" | "vision" | None
    norm_eps: float = 1e-5
    # Whether the arch supports 500k contexts (sub-quadratic path).
    subquadratic: bool = False
    # hybrid_moe: one letter a layer, M (mamba2 mixer) or A (attention
    # mixer), each followed by the MoE MLP; a string, so the config hashes.
    layer_pattern: str = ""
    # False: no positional embedding in attention (NoPE).
    rope: bool = True
    # granite's scalar multipliers: the embedding is multiplied by
    # ``embedding_multiplier``, attention scores by ``attention_multiplier``
    # (None: 1/sqrt(hd)), each block's output by ``residual_multiplier``
    # before its residual add, and the logits divided by ``logits_scaling``.
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        if self.family == Family.HYBRID_MOE and (
                len(self.layer_pattern) != self.n_layers
                or set(self.layer_pattern) - set("MA")):
            raise ValueError(f"layer_pattern {self.layer_pattern!r} must hold one M or A "
                             f"for each of the {self.n_layers} layers")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        """hybrid_moe: the indices of the mamba2 layers in ``layer_pattern``."""
        return tuple(i for i, c in enumerate(self.layer_pattern) if c == "M")

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        """hybrid_moe: the indices of the attention layers."""
        return tuple(i for i, c in enumerate(self.layer_pattern) if c == "A")

    def param_count(self) -> int:
        """Approximate parameter count N (for 6ND model FLOPs)."""
        L, d, V = self.n_layers, self.d_model, self.vocab_padded
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.mlp == MLPKind.GATED_SILU:
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family in (Family.DENSE, Family.VLM):
            total += L * (attn + mlp)
        elif self.family == Family.MOE:
            assert self.moe
            total += L * (attn + self.moe.n_experts * mlp + d * self.moe.n_experts)
        elif self.family == Family.SSM:
            di, n = self.d_inner, self.ssm.d_state
            # in_proj (x,z), conv, dt/B/C projections, A, D, out_proj
            per = d * 2 * di + di * self.ssm.d_conv + di * (2 * n + di // 16) \
                + di * n + 2 * di + di * d
            total += L * per
        elif self.family == Family.HYBRID:
            # zamba2: mamba2 backbone layers (no per-layer MLP) + ONE shared
            # attention+MLP block applied every shared_attn_period layers.
            di, n = self.d_inner, self.ssm.d_state
            nh = di // self.ssm.head_dim
            per = d * (2 * di + 2 * n + nh) + di * self.ssm.d_conv + di * d
            total += L * per
            total += attn + 3 * d * self.d_ff  # shared block (attn + SwiGLU)
        elif self.family == Family.HYBRID_MOE:
            di, n = self.d_inner, self.ssm.d_state
            nh = di // self.ssm.head_dim
            mamba = d * (2 * di + 2 * n + nh) + di * self.ssm.d_conv + di * d
            moe = self.moe.n_experts * mlp + d * self.moe.n_experts \
                + 3 * d * self.moe.shared_d_ff
            total += len(self.mamba_layers) * mamba + len(self.attn_layers) * attn + L * moe
        elif self.family in (Family.ENC_DEC, Family.AUDIO):
            total += L * (attn + mlp)            # decoder self-attn + mlp
            total += L * attn                    # decoder cross-attn
            total += L * (attn + mlp)            # encoder
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.family not in (Family.MOE, Family.HYBRID_MOE):
            return self.param_count()
        mlp = (3 if self.mlp == MLPKind.GATED_SILU else 2) * self.d_model * self.d_ff
        return self.param_count() - self.n_layers * (self.moe.n_experts - self.moe.top_k) * mlp


# ---------------------------------------------------------------------------
# Shapes (per assignment: all LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------


class Kind(str, enum.Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", Kind.TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", Kind.PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", Kind.DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", Kind.DECODE, 524_288, 1),
}


@dataclass(frozen=True)
class CellTuning:
    """Per-(arch x shape) execution tuning (microbatching, remat, dtypes)."""

    num_microbatches: int = 1
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    accum_dtype: str = "float32"     # gradient-accumulation buffer dtype
    # Kernel implementation: "kernel" (the hand-written CUDA kernels in
    # ``repro_torch.kernels``; their plain versions on a CPU tensor) or
    # "torch" (the chunked PyTorch path).
    attention_impl: str = "kernel"
    ssm_impl: str = "kernel"
    # §Perf hillclimb flags (default off = paper-faithful baseline):
    seq_parallel_attn: bool = False   # seq-shard attention when heads don't divide
    remat_chunk_attn: bool = False    # recompute chunk scores in backward
    moe_row_dispatch: bool = False    # batch-local MoE dispatch/combine
    seq_parallel_residual: bool = False  # seq-shard the residual stream


def cell_tuning(arch: "ArchConfig", shape: ShapeConfig) -> CellTuning:
    if shape.kind != Kind.TRAIN:
        return CellTuning(num_microbatches=1, remat=False)
    big = arch.param_count() > 30e9
    # 8 microbatches: micro-batch (32 rows) still shards over the 32-way
    # (pod x data) batch axes of the multi-pod mesh.
    return CellTuning(
        num_microbatches=8,
        remat=True,
        opt_state_dtype="bfloat16" if big else "float32",
        accum_dtype="bfloat16" if big else "float32",
    )


def cell_is_supported(arch: "ArchConfig", shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the (arch x shape) cell runs, with the reason when skipped."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{arch.name} is pure full-attention (skip mandated by assignment)"
        )
    return True, ""
