"""Model forward for the DENSE family (qwen2, yi, nemotron; also VLM
backbones without their frontend stub) and the HYBRID family (zamba2: a
mamba2 backbone with one shared attention+MLP block).

Three modes share one code path per family:
  * train    — full-sequence forward, no cache;
  * prefill  — full-sequence forward EMITTING a KV/state cache;
  * decode   — one-token step consuming/updating the cache (serve_step).

Layer weights are stacked along a leading L axis, as in ``repro``; the layer
stack is a Python loop over that axis (the JAX package's ``lax.scan``).
Caches carry the same leading L axis (the shared block's KV cache: one
entry per application point).  Decode updates the cache's tensors IN PLACE
(k/v at the new position; the mamba2 conv and SSM states whole) and
returns them, where the JAX package returns updated copies.

Parameters must already be in the compute dtype: ``cast_params`` casts them
once, where ``repro.models.model.forward`` casts on every call (which in
eager PyTorch would copy every weight each decode step).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, Family, MLPKind
from .ops import NOSHARD, ShardCtx, attention_chunked, attention_reference, rms_norm, rotary
from .sharding import ParamSchema as PS
from .ssm import STATE_KEYS, mamba2_block

Cache = Dict[str, torch.Tensor]

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
# cache leaves whose dim 2 is the sequence axis (allocated at max_len); the
# others are per-layer states, written whole
SEQ_KEYS = ("k", "v", "shared_k", "shared_v")

_PORTED = (Family.DENSE, Family.VLM, Family.HYBRID)
_ROADMAP_ITEM = {
    Family.MOE: "ROADMAP, queue 1 'Model stack': moe.py",
    Family.SSM: "ROADMAP, queue 1 'Model stack': ssm.py (mamba1)",
    Family.ENC_DEC: "ROADMAP, queue 1 'Model stack': encoder-decoder stack",
    Family.AUDIO: "ROADMAP, queue 1 'Model stack': encoder-decoder stack",
}


def cast_params(params, dtype: torch.dtype, device=None):
    """Float32 leaves to ``dtype`` (others kept), all leaves on ``device``.
    Returns the same tensor where nothing changes."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    to = dtype if params.dtype == torch.float32 else params.dtype
    return params.to(device=device, dtype=to)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def attention_block(
    p: Dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    ctx: ShardCtx,
    *,
    mode: str,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Residual causal self-attention block.

    decode: ``kv_cache`` = (k, v, pos), k/v (B, S_max, KV, hd) views of one
    layer of the pooled cache.  The new token's k/v are written into them
    IN PLACE (the JAX package returns updated copies).
    Returns (residual output, (k, v) for the cache).
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    S = q.shape[1]

    if mode == DECODE:
        # ``pos`` is a scalar (lockstep batch) or a (B,) vector (continuous
        # batching: each slot at its own sequence position).
        kc, vc, pos = kv_cache
        per_slot = pos.ndim == 1
        steps = torch.arange(S, device=x.device)
        rope_pos = (pos[:, None] if per_slot else pos) + steps
        q = rotary(q, rope_pos, cfg.rope_theta)
        k = rotary(k, rope_pos, cfg.rope_theta)
        if per_slot:
            b_idx = torch.arange(kc.shape[0], device=x.device)
            kc[b_idx, pos.long()] = k[:, 0].to(kc.dtype)
            vc[b_idx, pos.long()] = v[:, 0].to(vc.dtype)
        else:
            kc.index_copy_(1, pos.long() + steps, k.to(kc.dtype))
            vc.index_copy_(1, pos.long() + steps, v.to(vc.dtype))
        out = attention_reference(q, kc, vc, causal=False, kv_len=pos + S)
        new_kv = (kc, vc)
    else:
        positions = torch.arange(S, device=x.device)
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
        if ctx.attention_impl == "kernel":
            from repro_torch.kernels.ops import flash_attention

            out = flash_attention(q, k, v, causal=True).to(q.dtype)
        else:
            out = attention_chunked(q, k, v, causal=True)
        new_kv = (k, v)
    B = x.shape[0]
    proj = out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)
    return x + proj, new_kv


def mlp_block(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if cfg.mlp == MLPKind.GATED_SILU:
        u = F.silu(h @ p["w_gate"]) * (h @ p["w_up"])
    elif cfg.mlp == MLPKind.GELU:
        u = h @ p["w_up"]
        if "b_up" in p:
            u = u + p["b_up"]
        u = F.gelu(u, approximate="tanh")
    else:  # RELU2 (nemotron)
        u = torch.square(F.relu(h @ p["w_up"]))
    out = u @ p["w_down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return x + out


def _layer(params: Dict, i: int) -> Dict:
    return {blk: {name: w[i] for name, w in ws.items()}
            for blk, ws in params["layers"].items()}


def _dense_stack(params, h, cfg, ctx, cache, *, mode):
    """DENSE / VLM decoder: a loop over the stacked [L, ...] weights."""
    pos0 = cache["pos"] if cache is not None else None
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kv = (cache["k"][i], cache["v"][i], pos0) if cache is not None else None
        h, (k, v) = attention_block(lp["attn"], h, cfg, ctx, mode=mode, kv_cache=kv)
        h = mlp_block(lp["mlp"], h, cfg)
        if mode == PREFILL:
            ks.append(k)
            vs.append(v)
    new_cache = None
    if mode == PREFILL:
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                     "pos": torch.tensor(h.shape[1], dtype=torch.int32,
                                         device=h.device)}
    elif mode == DECODE:
        # k/v were updated in place
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos0 + 1}
    return h, new_cache


def _flat_layer(params: Dict, i: int) -> Dict:
    """Layer i of a flat ``{name: [L, ...]}`` stack (the mamba2 layers)."""
    return {name: w[i] for name, w in params["layers"].items()}


def _hybrid_stack(params, h, cfg, ctx, cache, *, mode):
    """zamba2: mamba2 backbone; a single SHARED attention+MLP block applied
    after every ``shared_attn_period`` layers (own KV cache per application
    point).  G = L // period groups of ``period`` mamba2 layers, each
    followed by the shared block, then the L - G * period tail layers."""
    period = cfg.shared_attn_period
    pos0 = cache["pos"] if cache is not None else None
    shared = params["shared"]
    states, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        lc = {key: cache[key][i] for key in STATE_KEYS} if cache is not None else None
        h, st = mamba2_block(_flat_layer(params, i), h, cfg, ctx, cache=lc,
                             return_state=mode == PREFILL)
        if mode == PREFILL:
            states.append(st)
        if (i + 1) % period == 0:
            g = i // period
            kv = (cache["shared_k"][g], cache["shared_v"][g], pos0) \
                if cache is not None else None
            h, (k, v) = attention_block(shared["attn"], h, cfg, ctx, mode=mode,
                                        kv_cache=kv)
            h = mlp_block(shared["mlp"], h, cfg)
            if mode == PREFILL:
                ks.append(k)
                vs.append(v)
    new_cache = None
    if mode == PREFILL:
        new_cache = {key: torch.stack([st[key] for st in states]) for key in STATE_KEYS}
        new_cache.update(shared_k=torch.stack(ks), shared_v=torch.stack(vs),
                         pos=torch.tensor(h.shape[1], dtype=torch.int32,
                                          device=h.device))
    elif mode == DECODE:
        # every lane was updated in place
        new_cache = dict(cache, pos=pos0 + 1)
    return h, new_cache


def backbone(params: Dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
             ctx: ShardCtx = NOSHARD, mode: str = TRAIN,
             cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Embedding + layer stack + final norm: (hidden (B, S, d), cache)."""
    if (cache is not None) != (mode == DECODE):
        raise ValueError(f"mode {mode!r} with cache={cache is not None}: "
                         "decode needs a cache and only decode takes one")
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family.value}) is not ported yet: "
            f"{_ROADMAP_ITEM[cfg.family]}")
    h = params["embed"][batch["tokens"]]
    stack = _hybrid_stack if cfg.family == Family.HYBRID else _dense_stack
    h, new_cache = stack(params, h, cfg, ctx, cache, mode=mode)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), new_cache


def head(params: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits (..., Vp); the tied embedding or the separate lm_head."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def forward(
    params: Dict,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    *,
    ctx: ShardCtx = NOSHARD,
    mode: str = TRAIN,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache], Dict]:
    """Returns (logits (B, S, Vp), cache (prefill/decode) or None, aux)."""
    h, new_cache = backbone(params, cfg, batch, ctx=ctx, mode=mode, cache=cache)
    return head(params, cfg, h), new_cache, {}


def cache_schema(cfg: ArchConfig, batch: int, max_len: int, enc_len: int = 0) -> Dict:
    """Decode-cache schema; leading L axis matches the layer stack."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family.value}) is not ported yet: "
            f"{_ROADMAP_ITEM[cfg.family]}")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    pos = PS((), (), init="zeros", dtype=torch.int32)
    if cfg.family == Family.HYBRID:
        di, n, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        nh = di // cfg.ssm.head_dim
        G = L // cfg.shared_attn_period
        shared_kv = PS((G, batch, max_len, KV, hd),
                       ("groups", "batch", "seq", "heads_kv", "hd_cache"),
                       init="zeros")
        return {
            "conv_x": PS((L, batch, K - 1, di),
                         ("layers", "batch", "conv", "d_inner"), init="zeros"),
            "conv_B": PS((L, batch, K - 1, n),
                         ("layers", "batch", "conv", "state"), init="zeros"),
            "conv_C": PS((L, batch, K - 1, n),
                         ("layers", "batch", "conv", "state"), init="zeros"),
            "ssm": PS((L, batch, nh, cfg.ssm.head_dim, n),
                      ("layers", "batch", "ssm_heads", "hd", "state"),
                      init="zeros", dtype=torch.float32),
            "shared_k": shared_kv,
            "shared_v": shared_kv,
            "pos": pos,
        }
    kv = PS((L, batch, max_len, KV, hd),
            ("layers", "batch", "seq", "heads_kv", "hd_cache"), init="zeros")
    return {"k": kv, "v": kv, "pos": pos}
