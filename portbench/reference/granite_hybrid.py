"""Plain PyTorch reference of granite-4.0-h-small as the port runs it.

A stack of ``n_layers`` layers, each a mixer (``layer_pattern``: M a mamba2
block, A a GQA attention block with no positional embedding) and then a
mixture-of-experts block with a shared expert, both pre-norm, their outputs
scaled by ``residual_multiplier`` before the residual add.  Float32 with
TF32 off, no kernel, no cache and no batching: the full causal forward pass
over one token sequence, layer by layer; attention and the state-space
mixer in blocks of query rows and each expert over the tokens routed to it,
so a 12,800-token sequence fits beside the served model's weights.

Input x = E[tokens] * embedding_multiplier, x (S, d).  Per layer:
    h = rmsnorm(x) * ln
    M:  z, xs, B, C, dt = h Wz, h Wx, h WB, h WC, h Wdt
        xs, B, C = silu(causal depthwise conv_K(.) + bias)
        dt = softplus(dt + dt_bias),  A = -exp(A_log)
        per head j (head_dim channels):
            H_t = exp(dt_tj A_j) H_{t-1} + dt_tj x_tj B_t^T,  y_tj = H_t C_t + D_j x_tj
        written here in its quadratic (dual) form,
            y_tj = sum_{s<=t} exp(sum_{s<k<=t} dt_kj A_j) (C_t . B_s) dt_sj x_sj + D_j x_tj
        o = (rmsnorm(y * silu(z)) * out_norm) Wout
    A:  q, k, v = h Wq, h Wk, h Wv  (no rotary)
        o = softmax(attention_multiplier q k^T, causal) v Wo  (each kv head
            serving n_heads / n_kv_heads query heads)
    x = x + residual_multiplier o
    h = rmsnorm(x) * moe.ln
    r = h Wrouter; the top_k largest logits (ties to the lower index), gates
        g = softmax over those top_k logits
    x = x + residual_multiplier (sum_e g_e (silu(h Wgate_e) * (h Wup_e)) Wdown_e
                                 + (silu(h Sgate) * (h Sup)) Sdown)
Final: logits = (rmsnorm(x) * final_norm) E^T / logits_scaling, with E the
tied embedding.  Every token reaches every expert it chooses (no capacity,
no drops), as in the published model.

Where this model departs from the Hugging Face configuration is listed
under ``departures`` in ``portbench/configs/granite-4.0-h-small.json``.

``precision="fp8"`` is the benchmark's control, as in ``granite_moe.py``
(whose helpers this file loads): every weight product takes its inputs
rounded to float8 e4m3; the state-space recurrence, attention's and the
router's softmax and the norms stay float32.
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F


def _granite_moe():
    """``granite_moe.py`` beside this file, loaded by path (the harness
    loads references by path, outside any package)."""
    name = "portbench_ref_granite_moe"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).with_name("granite_moe.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


_gm = _granite_moe()
padded_vocab = _gm.padded_vocab
_Mm, _rmsnorm, _full_float32 = _gm._Mm, _gm._rmsnorm, _gm._full_float32


def _layers(cfg: dict, kind: str) -> int:
    return cfg["layer_pattern"][:cfg["n_layers"]].count(kind)


def param_spec(cfg: dict) -> Dict[str, tuple]:
    """Leaf path -> (shape, init) of the weights the benchmark draws, in the
    port's layout: the mamba2 mixers stacked under ``mamba``, the
    attention mixers under ``attn`` (each in pattern order) and every
    layer's MoE under ``moe``.

    Projections have unit-variance outputs (std 1/sqrt of the contracted
    width), the router too; q and k are drawn at std hd**(1/4) / sqrt(d),
    so that the scores, scaled by ``attention_multiplier`` (1/hd where
    1/sqrt(hd) is usual), have unit variance; the causal convolutions have
    unit-variance outputs; ``A_log`` and ``dt_bias`` follow mamba2's own
    init (A in [-16, -1], softplus(dt_bias) log-uniform in [1e-3, 1e-1]);
    the embedding has std 1/(embedding_multiplier sqrt(d)), so the scaled
    embedding has norm 1 beside block outputs of norm ~sqrt(d) (at std
    1/sqrt(d) its 12x would carry each token's own row to the head, whose
    largest logit would echo the input token whatever the layers did); norm
    scales, biases and D are drawn around their usual values, so a path
    that ignores one of them shows."""
    d, L = cfg["d_model"], cfg["n_layers"]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    ff, E, sff = cfg["d_ff"], cfg["moe_n_experts"], cfg["moe_shared_d_ff"]
    n, K, hp = cfg["ssm_d_state"], cfg["ssm_d_conv"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    nh = di // hp
    nM, nA = _layers(cfg, "M"), _layers(cfg, "A")

    def w(fan_in, gain=1.0):
        return ("normal", gain / math.sqrt(fan_in))

    scale = ("normal", 0.1, 1.0)
    bias = ("normal", 0.1)
    qk = w(d, hd ** 0.25)
    return {
        "embed": ((padded_vocab(cfg), d), w(d, 1.0 / cfg["embedding_multiplier"])),
        "final_norm": ((d,), scale),
        "mamba/ln": ((nM, d), scale),
        "mamba/wz": ((nM, d, di), w(d)),
        "mamba/wx": ((nM, d, di), w(d)),
        "mamba/wB": ((nM, d, n), w(d)),
        "mamba/wC": ((nM, d, n), w(d)),
        "mamba/wdt": ((nM, d, nh), w(d)),
        "mamba/conv_x_w": ((nM, K, di), w(K)),
        "mamba/conv_x_b": ((nM, di), bias),
        "mamba/conv_B_w": ((nM, K, n), w(K)),
        "mamba/conv_B_b": ((nM, n), bias),
        "mamba/conv_C_w": ((nM, K, n), w(K)),
        "mamba/conv_C_b": ((nM, n), bias),
        "mamba/A_log": ((nM, nh), ("log_of_uniform", 1.0, 16.0)),
        "mamba/D": ((nM, nh), scale),
        "mamba/dt_bias": ((nM, nh), ("softplus_inv_log_uniform", 1e-3, 1e-1)),
        "mamba/out_norm": ((nM, di), scale),
        "mamba/w_out": ((nM, di, d), w(di)),
        "attn/ln": ((nA, d), scale),
        "attn/wq": ((nA, d, H, hd), qk),
        "attn/wk": ((nA, d, KV, hd), qk),
        "attn/wv": ((nA, d, KV, hd), w(d)),
        "attn/wo": ((nA, H, hd, d), w(H * hd)),
        "moe/ln": ((L, d), scale),
        "moe/router": ((L, d, E), w(d)),
        "moe/w_gate": ((L, E, d, ff), w(d)),
        "moe/w_up": ((L, E, d, ff), w(d)),
        "moe/w_down": ((L, E, ff, d), w(ff)),
        "moe/shared_gate": ((L, d, sff), w(d)),
        "moe/shared_up": ((L, d, sff), w(d)),
        "moe/shared_down": ((L, sff, d), w(sff)),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of x (S, C) with taps w (K, C): out[t] =
    sum_i x[t - K + 1 + i] w[i] + b, zeros before the first position."""
    K, C = w.shape
    out = F.conv1d(x.T[None], w.float().T[:, None, :], b.float(), padding=K - 1, groups=C)
    return out[0, :, :x.shape[0]].T


def ssd_dual(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """The state-space recurrence's output without its D term, in the dual
    form, one block of ``rows`` query rows at a time: x (S, nh, hp), dt
    (S, nh), A (nh,), B, C (S, n) -> y (S, nh, hp).  The decay exponents
    come from a float64 running sum taken relative to the block's first
    row, so their float32 values are exact to rounding where the decay is
    not negligible."""
    S = x.shape[0]
    cum = torch.cumsum((dt * A).double(), 0)                      # (S, nh)
    u = dt[..., None] * x                                          # (S, nh, hp)
    y = torch.empty_like(x)
    pos = torch.arange(S, device=x.device)
    for r0 in range(0, S, rows):
        r1 = min(r0 + rows, S)
        c = (cum[:r1] - cum[r0]).float()                           # (r1, nh)
        seg = c[r0:r1, None, :] - c[None, :, :]                    # (R, r1, nh)
        later = pos[None, :r1] > pos[r0:r1, None]
        decay = torch.exp(seg.masked_fill(later[..., None], -math.inf))
        w = decay * (C[r0:r1] @ B[:r1].T)[..., None]               # (R, r1, nh)
        y[r0:r1] = torch.einsum("tsh,shp->thp", w, u[:r1])
    return y


def _mamba(p: Dict, j: int, x: torch.Tensor, cfg: dict, mm: _Mm) -> torch.Tensor:
    S = x.shape[0]
    hp = cfg["ssm_head_dim"]
    h = _rmsnorm(x, p["ln"][j], cfg["norm_eps"])
    z = mm(h, p["wz"][j])
    xs = F.silu(_conv(mm(h, p["wx"][j]), p["conv_x_w"][j], p["conv_x_b"][j]))
    B = F.silu(_conv(mm(h, p["wB"][j]), p["conv_B_w"][j], p["conv_B_b"][j]))
    C = F.silu(_conv(mm(h, p["wC"][j]), p["conv_C_w"][j], p["conv_C_b"][j]))
    dt = F.softplus(mm(h, p["wdt"][j]) + p["dt_bias"][j].float())
    A = -torch.exp(p["A_log"][j].float())
    xh = xs.reshape(S, -1, hp)
    y = ssd_dual(xh, dt, A, B, C) + p["D"][j].float()[:, None] * xh
    y = _rmsnorm(y.reshape(S, -1) * F.silu(z), p["out_norm"][j], cfg["norm_eps"])
    return mm(y, p["w_out"][j])


def _attention(p: Dict, j: int, x: torch.Tensor, cfg: dict, mm: _Mm,
               rows: int = 1024) -> torch.Tensor:
    S, d = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = _rmsnorm(x, p["ln"][j], cfg["norm_eps"])
    q = mm(h, p["wq"][j].reshape(d, H * hd)).reshape(S, H, hd)
    k = mm(h, p["wk"][j].reshape(d, KV * hd)).reshape(S, KV, hd)
    v = mm(h, p["wv"][j].reshape(d, KV * hd)).reshape(S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    out = torch.empty(S, H, hd, device=x.device)
    for r0 in range(0, S, rows):
        qb = q[r0:r0 + rows]
        n = r0 + qb.shape[0]
        scores = torch.einsum("qhd,khd->hqk", qb, k[:n]) * cfg["attention_multiplier"]
        qpos = torch.arange(r0, n, device=x.device)
        kpos = torch.arange(n, device=x.device)
        scores = scores.masked_fill(kpos[None, None, :] > qpos[None, :, None], -math.inf)
        out[r0:n] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v[:n])
    return mm(out.reshape(S, H * hd), p["wo"][j].reshape(H * hd, d))


def _moe(p: Dict, i: int, x: torch.Tensor, cfg: dict, mm: _Mm) -> torch.Tensor:
    k = cfg["moe_top_k"]
    h = _rmsnorm(x, p["ln"][i], cfg["norm_eps"])
    logits = mm(h, p["router"][i])
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k], -1)
    idx = idx[:, :k]
    y = torch.zeros_like(x)
    for e in range(logits.shape[1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = h[tok]
        u = F.silu(mm(he, p["w_gate"][i, e])) * mm(he, p["w_up"][i, e])
        y.index_add_(0, tok, gates[tok, slot][:, None] * mm(u, p["w_down"][i, e]))
    shared = F.silu(mm(h, p["shared_gate"][i])) * mm(h, p["shared_up"][i])
    return y + mm(shared, p["shared_down"][i])


@torch.no_grad()
def logits(weights: Dict, cfg: dict, tokens: torch.Tensor, start: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (len(tokens) - start, vocab) at positions start..end
    of the causal forward pass over ``tokens`` (1-D), each predicting the
    token after its position."""
    mm = _Mm(precision)
    rm = cfg["residual_multiplier"]
    with _full_float32():
        x = weights["embed"][tokens].float() * cfg["embedding_multiplier"]
        nm = na = 0
        for i, kind in enumerate(cfg["layer_pattern"][:cfg["n_layers"]]):
            if kind == "M":
                x = x + rm * _mamba(weights["mamba"], nm, x, cfg, mm)
                nm += 1
            else:
                x = x + rm * _attention(weights["attn"], na, x, cfg, mm)
                na += 1
            x = x + rm * _moe(weights["moe"], i, x, cfg, mm)
        h = _rmsnorm(x[start:], weights["final_norm"], cfg["norm_eps"])
        return mm(h, weights["embed"].T)[:, :cfg["vocab"]] / cfg["logits_scaling"]
