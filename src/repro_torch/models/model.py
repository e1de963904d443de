"""Model forward for the DENSE family (qwen2, yi, nemotron; also VLM
backbones without their frontend stub), the MOE family (granite-moe,
phi3.5-moe: the dense decoder with a mixture-of-experts MLP), the SSM
family (falcon-mamba: mamba1 layers), the HYBRID family (zamba2: a
mamba2 backbone with one shared attention+MLP block) and the ENC_DEC /
AUDIO family (whisper: an encoder over stub frame embeddings and a
decoder with cross-attention).

Three modes share one code path per family:
  * train    — full-sequence forward, no cache;
  * prefill  — full-sequence forward EMITTING a KV/state cache;
  * decode   — one-token step consuming/updating the cache (serve_step).

Layer weights are stacked along a leading L axis, as in ``repro``; the layer
stack is a Python loop over that axis (the JAX package's ``lax.scan``).
Caches carry the same leading L axis (the shared block's KV cache: one
entry per application point; whisper's cross K/V: one per decoder layer,
written at prefill and only read by decode).  Decode updates the cache's
tensors IN PLACE (k/v at the new position; the mamba conv and SSM states
whole) and returns them, where the JAX package returns updated copies.

Parameters must already be in the compute dtype: ``cast_params`` casts them
once, where ``repro.models.model.forward`` casts on every call (which in
eager PyTorch would copy every weight each decode step).  Training casts
inside the differentiated function (``train.steps.loss_fn``), so the
float32 leaves get the gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, Family, MLPKind
from .moe import moe_mlp
from .ops import (NOSHARD, ShardCtx, attention_chunked, attention_reference, maybe_remat,
                  rms_norm, rotary)
from .sharding import ParamSchema as PS
from .ssm import STATE_KEYS, mamba1_block, mamba2_block

Cache = Dict[str, torch.Tensor]

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"
# cache leaves whose dim 2 is the sequence axis (allocated at max_len); the
# others are per-layer states, written whole
SEQ_KEYS = ("k", "v", "shared_k", "shared_v")


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
    causal: bool = True,
    use_rope: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    cross_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Residual attention block: self-attention over ``x``, or
    cross-attention when ``cross_states`` (B, Sk, d) gives k/v.

    decode (self-attention only): ``kv_cache`` = (k, v, pos), k/v
    (B, S_max, KV, hd) views of one layer of the pooled cache.  The new
    token's k/v are written into them IN PLACE (the JAX package returns
    updated copies).  Cross-attention decode reads its cached k/v in
    ``_cross_from_cache``.
    Returns (residual output, (k, v) for the cache).
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    src = h if cross_states is None else cross_states
    q = _proj(h, p["wq"])
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    S = q.shape[1]

    if mode == DECODE and cross_states is None:
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
        if use_rope:
            q = rotary(q, torch.arange(S, device=x.device), cfg.rope_theta)
            k = rotary(k, torch.arange(k.shape[1], device=x.device), cfg.rope_theta)
        if ctx.attention_impl == "kernel":
            from repro_torch.kernels.ops import flash_attention

            out = flash_attention(q, k, v, causal=causal).to(q.dtype)
        else:
            out = attention_chunked(q, k, v, causal=causal,
                                    remat_body=ctx.remat_chunk_attn)
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


def _unstack(stack, n: int) -> List:
    """The ``n`` per-layer views of a stacked ``[L, ...]`` dict, nested
    (``{block: {name: w}}``) or flat.  Each weight is unbound once, so under
    autograd all of its layers' gradients land in one ``[L, ...]`` buffer:
    ``w[i]`` per layer would build a zero ``[L, ...]`` gradient per layer."""
    if isinstance(stack, dict):
        per_key = {k: _unstack(v, n) for k, v in stack.items()}
        return [{k: per_key[k][i] for k in stack} for i in range(n)]
    return torch.unbind(stack)


def _dense_stack(params, h, cfg, ctx, cache, *, mode, with_aux, remat=False):
    """DENSE / VLM / MOE decoder: a loop over the stacked [L, ...] weights.
    Returns (h, cache, aux): for MOE with ``with_aux``, each aux loss's mean
    over the layers."""
    is_moe = cfg.family == Family.MOE
    pos0 = cache["pos"] if cache is not None else None

    def layer(h, lp, kv):
        h, new_kv = attention_block(lp["attn"], h, cfg, ctx, mode=mode, kv_cache=kv)
        aux = {}
        if is_moe:
            y, aux = moe_mlp(lp["moe"], h, cfg, ctx, with_aux=with_aux)
            h = h + y
        else:
            h = mlp_block(lp["mlp"], h, cfg)
        return h, new_kv, aux

    layer = maybe_remat(layer, remat)
    ks, vs, auxes = [], [], []
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        kv = (cache["k"][i], cache["v"][i], pos0) if cache is not None else None
        h, (k, v), aux = layer(h, lp, kv)
        auxes.append(aux)
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
    aux = {}
    if is_moe and with_aux:
        aux = {key: torch.stack([a[key] for a in auxes]).mean() for key in auxes[0]}
    return h, new_cache, aux


def _ssm_stack(params, h, cfg, ctx, cache, *, mode, with_aux, remat=False):
    """falcon-mamba: a loop over the stacked mamba1 layers."""
    pos0 = cache["pos"] if cache is not None else None

    def layer(h, lp, lc):
        return mamba1_block(lp, h, cfg, ctx, cache=lc, return_state=mode == PREFILL)

    layer = maybe_remat(layer, remat)
    states = []
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        lc = {key: cache[key][i] for key in ("conv", "ssm")} if cache is not None else None
        h, st = layer(h, lp, lc)
        if mode == PREFILL:
            states.append(st)
    new_cache = None
    if mode == PREFILL:
        new_cache = {key: torch.stack([st[key] for st in states])
                     for key in ("conv", "ssm")}
        new_cache["pos"] = torch.tensor(h.shape[1], dtype=torch.int32,
                                        device=h.device)
    elif mode == DECODE:
        # both lanes were updated in place
        new_cache = dict(cache, pos=pos0 + 1)
    return h, new_cache, {}


def _hybrid_stack(params, h, cfg, ctx, cache, *, mode, with_aux, remat=False):
    """zamba2: mamba2 backbone; a single SHARED attention+MLP block applied
    after every ``shared_attn_period`` layers (own KV cache per application
    point).  G = L // period groups of ``period`` mamba2 layers, each
    followed by the shared block, then the L - G * period tail layers.
    ``remat`` checkpoints the mamba2 layers, as the JAX stack does."""
    period = cfg.shared_attn_period
    pos0 = cache["pos"] if cache is not None else None
    shared = params["shared"]

    def m2_layer(h, lp, lc):
        return mamba2_block(lp, h, cfg, ctx, cache=lc, return_state=mode == PREFILL)

    m2_layer = maybe_remat(m2_layer, remat)
    states, ks, vs = [], [], []
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        lc = {key: cache[key][i] for key in STATE_KEYS} if cache is not None else None
        h, st = m2_layer(h, lp, lc)
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
    return h, new_cache, {}


def encoder(params: Dict, cfg: ArchConfig, enc_embeds: torch.Tensor, *,
            ctx: ShardCtx = NOSHARD, remat: bool = False) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings (B, enc_len, d):
    non-causal self-attention with rope, then the GELU MLP, per layer;
    then ``enc_final_norm``."""

    def layer(e, lp):
        e, _ = attention_block(lp["attn"], e, cfg, ctx, mode=TRAIN, causal=False)
        return mlp_block(lp["mlp"], e, cfg)

    layer = maybe_remat(layer, remat)
    e = enc_embeds
    for lp in _unstack(params["enc_layers"], cfg.n_layers):
        e = layer(e, lp)
    return rms_norm(e, params["enc_final_norm"], cfg.norm_eps)


def _cross_from_cache(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """Residual cross-attention against the cached encoder K/V (decode):
    every one of the enc_len keys, no rope, no mask."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    out = attention_reference(q, ck, cv, causal=False)
    return x + out.reshape(*x.shape[:2], -1) @ p["wo"].reshape(-1, cfg.d_model)


def _encdec_stack(params, h, cfg, ctx, cache, *, mode, with_aux, remat=False,
                  enc_embeds=None):
    """whisper: the encoder (train and prefill only), then per decoder layer
    causal self-attention, non-causal cross-attention over the encoder
    output and the MLP.  Decode never re-runs the encoder: it reads the
    cross K/V that prefill wrote into the cache."""
    pos0 = cache["pos"] if cache is not None else None
    enc_out = None
    if mode != DECODE:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} needs batch['enc_embeds'] in {mode} mode")
        enc_out = encoder(params, cfg, enc_embeds, ctx=ctx, remat=remat)

    def layer(h, lp, kv, cross_kv):
        h, new_kv = attention_block(lp["attn"], h, cfg, ctx, mode=mode, kv_cache=kv)
        if mode == DECODE:
            h = _cross_from_cache(lp["cross"], h, cfg, *cross_kv)
        else:
            h, cross_kv = attention_block(lp["cross"], h, cfg, ctx, mode=mode,
                                          causal=False, use_rope=False,
                                          cross_states=enc_out)
        return mlp_block(lp["mlp"], h, cfg), new_kv, cross_kv

    layer = maybe_remat(layer, remat)
    ks, vs, cks, cvs = [], [], [], []
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        kv = cross = None
        if cache is not None:
            kv = (cache["k"][i], cache["v"][i], pos0)
            cross = (cache["cross_k"][i], cache["cross_v"][i])
        h, (k, v), (ck, cv) = layer(h, lp, kv, cross)
        if mode == PREFILL:
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
    new_cache = None
    if mode == PREFILL:
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                     "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
                     "pos": torch.tensor(h.shape[1], dtype=torch.int32,
                                         device=h.device)}
    elif mode == DECODE:
        # self k/v were updated in place; cross k/v are read only
        new_cache = dict(cache, pos=pos0 + 1)
    return h, new_cache, {}


_STACKS = {Family.DENSE: _dense_stack, Family.VLM: _dense_stack,
           Family.MOE: _dense_stack, Family.SSM: _ssm_stack,
           Family.HYBRID: _hybrid_stack, Family.ENC_DEC: _encdec_stack,
           Family.AUDIO: _encdec_stack}


def backbone(params: Dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
             ctx: ShardCtx = NOSHARD, mode: str = TRAIN,
             cache: Optional[Cache] = None, with_aux: bool = False,
             remat: bool = False) -> Tuple[torch.Tensor, Optional[Cache], Dict]:
    """Embedding + layer stack + final norm: (hidden (B, S, d), cache, aux).
    ``aux`` holds the MoE aux losses when ``with_aux`` (else ``{}``).
    The encoder-decoder family reads ``batch["enc_embeds"]`` (B, enc_len,
    d) in train and prefill mode, cast to the parameters' dtype.
    ``remat``: recompute each layer's activations in the backward pass."""
    if (cache is not None) != (mode == DECODE):
        raise ValueError(f"mode {mode!r} with cache={cache is not None}: "
                         "decode needs a cache and only decode takes one")
    extra = {}
    if cfg.family in (Family.ENC_DEC, Family.AUDIO):
        enc = batch.get("enc_embeds")
        extra["enc_embeds"] = None if enc is None else enc.to(params["embed"].dtype)
    h = params["embed"][batch["tokens"]]
    h, new_cache, aux = _STACKS[cfg.family](params, h, cfg, ctx, cache, mode=mode,
                                            with_aux=with_aux, remat=remat, **extra)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), new_cache, aux


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
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache], Dict]:
    """Returns (logits (B, S, Vp), cache (prefill/decode) or None, aux: the
    MoE aux losses' means over the layers, ``{}`` for other families).
    ``remat`` checkpoints each layer, as the JAX ``forward``'s does."""
    h, new_cache, aux = backbone(params, cfg, batch, ctx=ctx, mode=mode,
                                 cache=cache, with_aux=True, remat=remat)
    return head(params, cfg, h), new_cache, aux


def cache_schema(cfg: ArchConfig, batch: int, max_len: int, enc_len: int = 0) -> Dict:
    """Decode-cache schema; leading L axis matches the layer stack.  The
    encoder-decoder family adds its cross K/V at ``enc_len``."""
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
    if cfg.family == Family.SSM:
        di, n, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        return {
            "conv": PS((L, batch, K - 1, di),
                       ("layers", "batch", "conv", "d_inner"), init="zeros"),
            "ssm": PS((L, batch, di, n),
                      ("layers", "batch", "d_inner", "state"),
                      init="zeros", dtype=torch.float32),
            "pos": pos,
        }
    kv = PS((L, batch, max_len, KV, hd),
            ("layers", "batch", "seq", "heads_kv", "hd_cache"), init="zeros")
    if cfg.family in (Family.ENC_DEC, Family.AUDIO):
        cross = PS((L, batch, enc_len, KV, hd),
                   ("layers", "batch", "seq", "heads_kv", "hd_cache"), init="zeros")
        return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross, "pos": pos}
    return {"k": kv, "v": kv, "pos": pos}
