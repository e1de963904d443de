"""Naive PyTorch oracles for the port's kernels.

Deliberately the naive formulation (materialised scores, KV heads repeated),
independent of both the kernels and the chunked model path, so a kernel bug
and a model-path bug cannot cancel out in tests: attention with materialised
scores, and the SSD scan as its step-by-step recurrence.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention with GQA.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H a multiple of KV.
    Returns (B, Sq, H, hd) in q.dtype; math in f32.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kf = k.repeat_interleave(G, dim=2).float()    # (B, Sk, H, hd)
    vf = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (step-by-step) mamba2/SSD recurrence, the slow oracle.

    x: (B, S, nh, hp); dt: (B, S, nh); A: (nh,) (negative);
    Bc, Cc: (B, S, n) shared across heads.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t
    Returns (y (B, S, nh, hp), h_final (B, nh, hp, n)); math in f32.
    """
    B_, S, nh, hp = x.shape
    n = Bc.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bc.float(), Cc.float()
    Af = A.float()
    h = torch.zeros(B_, nh, hp, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])                    # (B, nh)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h
