"""Naive PyTorch oracles for the port's kernels.

Deliberately the naive formulation (materialised scores, KV heads repeated),
independent of both the kernels and the chunked model path, so a kernel bug
and a model-path bug cannot cancel out in tests.  ``ssd_ref`` waits for the
SSD kernel's slice.
"""
from __future__ import annotations

import math

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
