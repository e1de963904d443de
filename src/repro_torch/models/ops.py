"""Shared model ops: norms, rotary embeddings, attention (direct + chunked).

``attention_chunked`` is the plain PyTorch path (a loop over query chunks
that never holds the full S_q x S_k score tensor).  The hand-written CUDA
kernel in ``repro_torch.kernels`` computes the same contraction and is held
against ``kernels.ref.attention_ref``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

NEG_INF = -1e30
ATTENTION_IMPLS = ("kernel", "torch")
SSM_IMPLS = ("kernel", "torch")


@dataclass(frozen=True)
class ShardCtx:
    """Execution context.  Of ``repro.models.ops.ShardCtx`` the port keeps
    only what selects an implementation; sharding waits for the
    multi-device slice.

    ``attention_impl``: "kernel" (prefill attention through
    ``kernels.ops.flash_attention``: the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor) or "torch" (``attention_chunked``).
    ``ssm_impl``: "kernel" (the mamba2 prefill scan through
    ``kernels.ops.ssd_scan``, likewise) or "torch" (``ssm.ssd_chunked``).
    ``moe_row_dispatch``: route MoE tokens with a per-row capacity
    (``moe._moe_mlp_rows``) instead of one global token pool.
    """

    attention_impl: str = "kernel"
    ssm_impl: str = "kernel"
    moe_row_dispatch: bool = False

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} not in {ATTENTION_IMPLS}")
        if self.ssm_impl not in SSM_IMPLS:
            raise ValueError(f"ssm_impl {self.ssm_impl!r} not in {SSM_IMPLS}")


NOSHARD = ShardCtx()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved (NeoX pair) rotary embedding, angles in float32.

    x: (..., S, n_heads, hd); positions: (..., S) absolute positions.
    """
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                      exps)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x2 = x.reshape(*x.shape[:-1], half, 2)
    x_even, x_odd = x2[..., 0], x2[..., 1]
    out = torch.stack(
        [x_even * cos - x_odd * sin, x_even * sin + x_odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain softmax attention with GQA head grouping, math in float32.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  H must be a multiple of KV.
    ``q_offset``: absolute position of q[0] (for causal masking in decode).
    ``kv_len``: optional number of valid kv entries (cache decode); a
    scalar, or a (B,) vector for continuous-batching decode where every
    slot sits at its own sequence position.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = None  # broadcastable to (B, 1, 1, Sq, Sk)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
        valid = valid[:, None, None, None, :]       # (B|1, 1, 1, 1, Sk)
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Query-chunked attention: O(q_chunk * Sk) live scores.

    The same math as ``attention_reference``, one query chunk at a time; a
    ragged last chunk is allowed.
    """
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return attention_reference(q, k, v, causal=causal)
    outs = [
        attention_reference(q[:, i:i + q_chunk], k, v, causal=causal, q_offset=i)
        for i in range(0, Sq, q_chunk)
    ]
    return torch.cat(outs, dim=1)
