"""Plain PyTorch reference of granite-moe-3b-a800m as the port runs it.

A decoder of ``n_layers`` blocks, each an attention block and then a
mixture-of-experts block, both pre-norm and residual.  Float32 with TF32
off, no kernel, no cache and no batching: the full causal forward pass over
one token sequence, layer by layer, attention in blocks of query rows and
each expert over the tokens routed to it, so a 4,096-token sequence fits
beside the served model's weights.

Per block, x (S, d):
    h = rmsnorm(x) * attn.ln
    q, k, v = h Wq, h Wk, h Wv  (n_heads, n_kv_heads, n_kv_heads heads of hd)
    q, k turned by rotary positions (interleaved pairs, theta ** (-i / (hd/2)))
    x = x + softmax(q k^T / sqrt(hd), causal) v Wo  (each kv head serving
        n_heads / n_kv_heads query heads)
    h = rmsnorm(x) * moe.ln
    p = softmax(h Wrouter) over the experts; the top_k largest (ties to the
        lower index), their gates renormalised to sum to 1
    x = x + sum over the chosen experts e of gate_e (silu(h Wgate_e) * (h Wup_e)) Wdown_e
Final rmsnorm, then the tied head: logits = h E^T with E the embedding.
Every token reaches every expert it chooses (no capacity, no drops), as
in the published model.

Where this model departs from the Hugging Face configuration is listed
under ``departures`` in ``portbench/configs/granite-moe-3b-a800m.json``.

``precision="fp8"`` is the benchmark's control: every matrix product takes
its inputs rounded to float8 e4m3, the activations scaled per row and the
weights per output column; attention's softmax, the router's softmax and
the norms stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def padded_vocab(cfg: dict) -> int:
    """Rows of the embedding: the vocabulary padded to a multiple of 256,
    as the port lays it out; ids past ``vocab`` are never sent or read."""
    return -(-cfg["vocab"] // 256) * 256


def param_spec(cfg: dict) -> Dict[str, tuple]:
    """Leaf path -> (shape, init) of the weights the benchmark draws.

    Projections have unit-variance outputs (std 1/sqrt of the contracted
    width), the router too, so that routing is decided by margins well above
    rounding; the embedding has std 1/sqrt(d), so that the tied head's logits
    have unit variance; norm scales are drawn around 1, so a path that
    ignores one of them shows."""
    d, L = cfg["d_model"], cfg["n_layers"]
    H, KV, ff, E = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"], cfg["moe_n_experts"]
    hd = d // H

    def w(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    scale = ("normal", 0.1, 1.0)
    return {
        "embed": ((padded_vocab(cfg), d), w(d)),
        "final_norm": ((d,), scale),
        "layers/attn/ln": ((L, d), scale),
        "layers/attn/wq": ((L, d, H, hd), w(d)),
        "layers/attn/wk": ((L, d, KV, hd), w(d)),
        "layers/attn/wv": ((L, d, KV, hd), w(d)),
        "layers/attn/wo": ((L, H, hd, d), w(H * hd)),
        "layers/moe/ln": ((L, d), scale),
        "layers/moe/router": ((L, d, E), w(d)),
        "layers/moe/w_gate": ((L, E, d, ff), w(d)),
        "layers/moe/w_up": ((L, E, d, ff), w(d)),
        "layers/moe/w_down": ((L, E, ff, d), w(ff)),
    }


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude to the format's largest), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Mm:
    """x @ w in float32, or with both inputs rounded to float8 first."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd): pairs (x[2j], x[2j+1]) turned by pos * theta ** (-j / (hd/2))."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    ev, od = x[..., 0::2], x[..., 1::2]
    return torch.stack([ev * cos - od * sin, ev * sin + od * cos], -1).reshape(x.shape)


def _attention(p: Dict, i: int, x: torch.Tensor, cfg: dict, mm: _Mm,
               rows: int = 1024) -> torch.Tensor:
    S, d = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // H
    h = _rmsnorm(x, p["ln"][i], cfg["norm_eps"])
    q = _rotary(mm(h, p["wq"][i].reshape(d, H * hd)).reshape(S, H, hd), cfg["rope_theta"])
    k = _rotary(mm(h, p["wk"][i].reshape(d, KV * hd)).reshape(S, KV, hd), cfg["rope_theta"])
    v = mm(h, p["wv"][i].reshape(d, KV * hd)).reshape(S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    out = torch.empty(S, H, hd, device=x.device)
    for r0 in range(0, S, rows):
        qb = q[r0:r0 + rows]
        n = r0 + qb.shape[0]
        scores = torch.einsum("qhd,khd->hqk", qb, k[:n]) / math.sqrt(hd)
        qpos = torch.arange(r0, n, device=x.device)
        kpos = torch.arange(n, device=x.device)
        scores = scores.masked_fill(kpos[None, None, :] > qpos[None, :, None], -math.inf)
        out[r0:n] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v[:n])
    return x + mm(out.reshape(S, H * hd), p["wo"][i].reshape(H * hd, d))


def _moe(p: Dict, i: int, x: torch.Tensor, cfg: dict, mm: _Mm) -> torch.Tensor:
    k = cfg["moe_top_k"]
    h = _rmsnorm(x, p["ln"][i], cfg["norm_eps"])
    probs = torch.softmax(mm(h, p["router"][i]), -1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(probs.shape[1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = h[tok]
        u = F.silu(mm(he, p["w_gate"][i, e])) * mm(he, p["w_up"][i, e])
        y.index_add_(0, tok, gates[tok, slot][:, None] * mm(u, p["w_down"][i, e]))
    return x + y


@contextlib.contextmanager
def _full_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@torch.no_grad()
def logits(weights: Dict, cfg: dict, tokens: torch.Tensor, start: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (len(tokens) - start, vocab) at positions start..end
    of the causal forward pass over ``tokens`` (1-D), each predicting the
    token after its position."""
    mm = _Mm(precision)
    layers = weights["layers"]
    with _full_float32():
        x = weights["embed"][tokens].float()
        for i in range(cfg["n_layers"]):
            x = _attention(layers["attn"], i, x, cfg, mm)
            x = _moe(layers["moe"], i, x, cfg, mm)
        h = _rmsnorm(x[start:], weights["final_norm"], cfg["norm_eps"])
        return mm(h, weights["embed"].T)[:, :cfg["vocab"]]
