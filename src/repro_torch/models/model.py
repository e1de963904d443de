"""Model forward for the DENSE family (qwen2, yi, nemotron; also VLM
backbones without their frontend stub), the MOE family (granite-moe,
phi3.5-moe: the dense decoder with a mixture-of-experts MLP), the SSM
family (falcon-mamba: mamba1 layers), the HYBRID family (zamba2: a
mamba2 backbone with one shared attention+MLP block), the HYBRID_MOE
family (granite-4.0-h: mamba2 and attention mixers by a per-layer pattern,
each followed by a MoE MLP with a shared expert) and the ENC_DEC / AUDIO
family (whisper: an encoder over stub frame embeddings and a decoder with
cross-attention).

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

Sharded (``ctx.enabled``, DTensor parameters and inputs on a mesh): the
step is the JAX package's SPMD program written out for DTensor.  Every
``ctx.act``/``ctx.res`` site of ``repro.models.model`` redistributes the
activation there; each layer gathers its weights over the FSDP axes at
their point of use (``ShardCtx.gather``); plain tensors made inside the
step (positions, masks) count as replicated (``launch.mesh.plain_tensors_replicated``).
What DTensor has no rule for runs per shard in ``local_map`` with the
placements the JAX constraints name.  A block's output projection, a
partial sum over the model axis where its weight is sharded there, is
reduced by the residual constraint before the residual add (``ctx.res``),
where XLA reduces it; DTensor would otherwise carry the partial sum into
the next norm.  ``local_map`` runs: GQA attention whose q heads are
sharded while its kv heads are not (``_attend``), a cache write into a
sequence-sharded cache (``_write_cache``), the MoE dispatch and the
mamba1 scan.

Parameters must already be in the compute dtype: ``cast_params`` casts them
once, where ``repro.models.model.forward`` casts on every call (which in
eager PyTorch would copy every weight each decode step).  Training casts
inside the differentiated function (``train.steps.loss_fn``), so the
float32 leaves get the gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import attention_reference
from repro_torch.launch.mesh import (local_shape_and_offset, per_shard,
                                     plain_tensors_replicated, redistribute)
from repro_torch.obs.trace import TRACER

from .config import ArchConfig, Family, MLPKind
from .moe import moe_mlp
from .ops import NOSHARD, ShardCtx, attention_chunked, maybe_remat, rms_norm, rotary
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
    scale: Optional[float] = None,
    out_scale: float = 1.0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Residual attention block: self-attention over ``x``, or
    cross-attention when ``cross_states`` (B, Sk, d) gives k/v.
    ``use_rope=False`` leaves q and k unturned in every mode (NoPE);
    ``scale`` is the scores' factor (None: 1/sqrt(hd)); the block's output
    is multiplied by ``out_scale`` before the residual add.

    decode (self-attention only): ``kv_cache`` = (k, v, pos), k/v
    (B, S_max, KV, hd) views of one layer of the pooled cache.  The new
    token's k/v are written into them IN PLACE (the JAX package returns
    updated copies).  Cross-attention decode reads its cached k/v in
    ``_cross_from_cache``.
    Returns (residual output, (k, v) for the cache).
    """
    p = ctx.gather(p)
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
        if use_rope:
            rope_pos = (pos[:, None] if per_slot else pos) + steps
            q = rotary(q, rope_pos, cfg.rope_theta)
            k = rotary(k, rope_pos, cfg.rope_theta)
        _write_cache(kc, k, pos, steps)
        _write_cache(vc, v, pos, steps)
        out = _attend_cache(q, kc, vc, ctx, kv_len=pos + S, scale=scale)
        new_kv = (kc, vc)
    else:
        if use_rope:
            q = rotary(q, torch.arange(S, device=x.device), cfg.rope_theta)
            k = rotary(k, torch.arange(k.shape[1], device=x.device), cfg.rope_theta)
        seq_par = ctx.seq_parallel_attn and ctx.heads is None \
            and ctx.tp is not None
        if seq_par:
            # heads don't divide the model axis: shard the SEQUENCE dim of
            # q over it (k/v stay replicated), so the attention compute
            # and its S^2 score buffers split instead of replicating
            q = ctx.act(q, ctx.dp, ctx.tp, None, None)
            k = ctx.act(k, ctx.dp, None, None, None)
            v = ctx.act(v, ctx.dp, None, None, None)
            out = _attend_seq_parallel(q, k, v, causal, ctx, scale)
            out = ctx.act(out, ctx.dp, ctx.tp, None, None)
        else:
            q = ctx.act(q, ctx.dp, None, ctx.heads, None)
            out = _attend(q, k, v, causal, ctx, scale)
        new_kv = (k, v)
    out = _out_proj(out, p["wo"])
    if out_scale != 1.0:
        out = out * out_scale
    return x + ctx.res(out), new_kv


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd'): one matmul over the flattened heads; on
    DTensors the einsum itself, which contracts a sharded head dim where a
    flattening could not keep it sharded."""
    if isinstance(out, DTensor):
        return torch.einsum("bshk,hkd->bsd", out, wo)
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _attend_cache(q, kc, vc, ctx: ShardCtx, kv_len=None, scale=None) -> torch.Tensor:
    """Decode attention over a cache (self or cross), the JAX package's
    head-dim-sharded constraint on the cache: q follows k onto the head
    dim (its heads whole), and the output goes back to the heads' layout
    for the output projection.

    On the kernel route a cache whose head dim is not sharded (plain
    tensors, as on one card) goes through ``kernels.ops.decode_attention``,
    which reads only each slot's first ``kv_len`` keys.  A head-dim shard
    holds part of every dot product, which no per-shard kernel can finish,
    so a sharded cache keeps ``attention_reference``."""
    kc = ctx.act(kc, ctx.dp, None, None, ctx.tp)
    vc = ctx.act(vc, ctx.dp, None, None, ctx.tp)
    q = ctx.act(q, ctx.dp, None, None, ctx.tp)
    if ctx.attention_impl == "kernel" and not _head_dim_sharded(kc):
        out = kops.decode_attention(q, kc, vc, kv_len, scale)
    else:
        out = attention_reference(q, kc, vc, causal=False, kv_len=kv_len, scale=scale)
    return ctx.act(out, ctx.dp, None, ctx.heads, None)


def _head_dim_sharded(t: torch.Tensor) -> bool:
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == t.ndim - 1 for p in t.placements)


def _attention_core(q, k, v, causal, ctx, scale=None):
    if ctx.attention_impl == "kernel":
        return kops.flash_attention(q, k, v, causal=causal, scale=scale).to(q.dtype)
    return attention_chunked(q, k, v, causal=causal, remat_body=ctx.remat_chunk_attn,
                             scale=scale)


def _attend(q, k, v, causal: bool, ctx: ShardCtx, scale=None) -> torch.Tensor:
    """Prefill / train attention.  On DTensors each mesh dim has q, k and v
    all replicated, batch-sharded together or heads-sharded together (the
    kernel's rules), or the q heads sharded with the kv heads replicated.
    The kernel route calls the operator on the DTensors (its sharding
    strategy runs it per shard); the plain route runs per shard in
    ``local_map``, which DTensor's own rules would take apart into
    strided-shard views of the chunked einsums.

    GQA with the q heads sharded over the model axis and the kv heads
    replicated (yi-6b: 32 q heads, 4 kv heads, a 16-wide axis), on either
    route: the local kernel would pair local q head ``h`` with kv head
    ``h // G``, where the right one is ``(rank * H_local + h) // G``.  Each
    shard then slices the kv heads its q heads need (``local_map``): one kv
    head for all of them when ``G`` is a multiple of ``H_local``, a
    contiguous block of ``H_local / G`` when ``H_local`` is a multiple of
    ``G``, else one kv head per q head.  Their gradient is a partial sum
    over the model axis."""
    if not isinstance(q, DTensor):
        return _attention_core(q, k, v, causal, ctx, scale)
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    m = names.index(ctx.tp) if ctx.tp in names else None
    for d in range(mesh.ndim):
        got = (q.placements[d], k.placements[d], v.placements[d])
        if got not in _ATTEND_RULES:
            raise ValueError(f"attention has no per-shard rule for {got} on "
                             f"mesh dim {names[d]!r}")
    sliced = m is not None and q.placements[m] == Shard(2) \
        and k.placements[m] != Shard(2)
    if ctx.attention_impl == "kernel" and not sliced:
        return _attention_core(q, k, v, causal, ctx, scale)
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    Hl = H // mesh.size(m) if sliced else H

    def local(ql, kl, vl):
        if sliced:
            first = mesh.get_local_rank(m) * Hl
            lo, hi = first // G, (first + Hl - 1) // G + 1
            if Hl % G == 0 or G % Hl == 0:
                idx = torch.arange(lo, hi, device=kl.device)
            else:
                idx = (first + torch.arange(Hl, device=kl.device)) // G
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return _attention_core(ql, kl, vl, causal, ctx, scale)

    return per_shard(local, out=(q.placements,),
                     ins=(q.placements, k.placements, v.placements), mesh=mesh)(q, k, v)


def _attend_seq_parallel(q, k, v, causal: bool, ctx: ShardCtx, scale=None) -> torch.Tensor:
    """Attention of a sequence-sharded q (its rows split over the model
    axis) against k and v replicated there.  The plain route is the masked
    full product, as the JAX package's sequence-parallel path (no
    query-chunk loop: a shard's score slab is already 1/n of S^2).  The
    kernel route runs the kernel on each shard's rows against every key,
    its causal mask starting at the shard's first row (``q_offset``); its
    FLOP formula counts those rows against every key, as the plain route's
    product does, so both routes count the same."""
    if ctx.attention_impl != "kernel":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if not isinstance(q, DTensor):
        return _attention_core(q, k, v, causal, ctx, scale)
    mesh = q.device_mesh
    m = mesh.mesh_dim_names.index(ctx.tp)
    if q.placements[m] != Shard(1) or k.placements[m] != Replicate() \
            or v.placements[m] != Replicate():
        raise ValueError("sequence-parallel attention wants q's rows sharded "
                         f"and k, v replicated on {ctx.tp!r}; got {q.placements}, "
                         f"{k.placements}, {v.placements}")
    first = local_shape_and_offset(q.shape, mesh, q.placements)[1][1]

    def local(ql, kl, vl):
        return kops.flash_attention(ql, kl, vl, causal=causal,
                                    q_offset=first if causal else 0,
                                    scale=scale).to(ql.dtype)

    return per_shard(local, out=(q.placements,),
                     ins=(q.placements, k.placements, v.placements), mesh=mesh)(q, k, v)


# per mesh dim (q, k, v): replicated, batch-sharded, heads-sharded, or q
# heads sharded against replicated kv heads (sliced per shard)
_ATTEND_RULES = ((Replicate(),) * 3, (Shard(0),) * 3, (Shard(2),) * 3,
                 (Shard(2), Replicate(), Replicate()))


def _write_cache(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 steps: torch.Tensor) -> None:
    """Write ``new`` (B, S, ...) into the cache view ``c`` (B, S_max, ...)
    at ``pos`` IN PLACE: ``pos`` a scalar (every slot at one position) or a
    (B,) vector (continuous batching: each slot at its own position).

    On a DTensor cache the write is local: ``new`` is first given the
    cache's placements, then each shard writes its part.  Where the cache's
    sequence dim is sharded (a batch-1 long-context cell), each shard owns
    a range of positions: it writes the rows of ``pos`` that fall in its
    range and rewrites its own values elsewhere (a masked write, no branch
    on the position)."""
    if not isinstance(c, DTensor):
        if pos.ndim == 1:
            c[torch.arange(c.shape[0], device=c.device), pos.long()] = \
                new[:, 0].to(c.dtype)
        else:
            c.index_copy_(1, pos.long() + steps, new.to(c.dtype))
        return
    if pos.ndim != 0:
        raise NotImplementedError("per-slot positions on a sharded cache")
    new = redistribute(new.to(c.dtype), c.placements).to_local()
    pos = pos.to_local() if isinstance(pos, DTensor) else pos
    cl = c.to_local()
    _, offset = local_shape_and_offset(c.shape, c.device_mesh, c.placements)
    idx = pos.long() + steps.to(pos.device) - offset[1]
    if cl.shape[1] == c.shape[1]:
        cl.index_copy_(1, idx, new)
        return
    inside = (idx >= 0) & (idx < cl.shape[1])
    idx = idx.clamp(0, cl.shape[1] - 1)
    keep = cl.index_select(1, idx)
    mask = inside.reshape(1, -1, *([1] * (cl.ndim - 2)))
    cl.index_copy_(1, idx, torch.where(mask, new, keep))


def mlp_block(p: Dict, x: torch.Tensor, cfg: ArchConfig,
              ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    p = ctx.gather(p)
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
    u = ctx.act(u, ctx.dp, None, ctx.tp if ctx.ff_sharded else None)
    out = ctx.res(u @ p["w_down"])
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
    over the layers.  While ``TRACER`` is on, each layer records a
    ``layer.attn`` span around its attention block's enqueue."""
    is_moe = cfg.family == Family.MOE
    pos0 = cache["pos"] if cache is not None else None

    def layer(h, lp, kv):
        on = TRACER.on
        if on:
            TRACER.open("layer.attn")
        h, new_kv = attention_block(lp["attn"], h, cfg, ctx, mode=mode, kv_cache=kv)
        if on:
            TRACER.close()
        aux = {}
        if is_moe:
            y, aux = moe_mlp(lp["moe"], h, cfg, ctx, with_aux=with_aux)
            h = h + y
        else:
            h = mlp_block(lp["mlp"], h, cfg, ctx)
        return ctx.res(h), new_kv, aux

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
        # filled on the device: a host copy would sync, and a CUDA graph
        # cannot capture it
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                     "pos": torch.full((), h.shape[1], dtype=torch.int32,
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
        h, st = mamba1_block(lp, h, cfg, ctx, cache=lc, return_state=mode == PREFILL)
        return ctx.res(h), st

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
        h, st = mamba2_block(lp, h, cfg, ctx, cache=lc, return_state=mode == PREFILL)
        return ctx.res(h), st

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
            h = ctx.res(mlp_block(shared["mlp"], h, cfg, ctx))
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


def _hybrid_moe_stack(params, h, cfg, ctx, cache, *, mode, with_aux, remat=False):
    """granite-4.0-h: ``cfg.layer_pattern`` names each layer's mixer, a
    mamba2 block (M) or a GQA attention block (A, rotary only where
    ``cfg.rope``, scores scaled by ``cfg.attention_multiplier``); every
    mixer is followed by the MoE MLP with its shared expert.  Both blocks'
    outputs are multiplied by ``cfg.residual_multiplier`` before their
    residual adds.  The weights are stacked per kind (``mamba``, ``attn``:
    the M and A layers in order; ``moe``: every layer), and so is the
    cache: conv and SSM state lanes for the M layers only, K/V lanes for
    the A layers only.  While ``TRACER`` is on, each mamba2 mixer records a
    ``layer.mamba`` span (``tokens``: the tokens it mixes) and each
    attention mixer a ``layer.attn`` span around its enqueue."""
    pos0 = cache["pos"] if cache is not None else None
    rm = cfg.residual_multiplier

    def m_layer(h, lp, lc):
        return mamba2_block(lp, h, cfg, ctx, cache=lc, return_state=mode == PREFILL,
                            out_scale=rm)

    def a_layer(h, lp, kv):
        return attention_block(lp, h, cfg, ctx, mode=mode, use_rope=cfg.rope, kv_cache=kv,
                               scale=cfg.attention_multiplier, out_scale=rm)

    def moe_layer(h, lp):
        y, aux = moe_mlp(lp, h, cfg, ctx, with_aux=with_aux)
        if rm != 1.0:
            y = y * rm
        return ctx.res(h + y), aux

    m_layer, a_layer, moe_layer = (maybe_remat(f, remat) for f in (m_layer, a_layer, moe_layer))
    mambas = _unstack(params["mamba"], len(cfg.mamba_layers))
    attns = _unstack(params["attn"], len(cfg.attn_layers))
    moes = _unstack(params["moe"], cfg.n_layers)
    states, ks, vs, auxes = [], [], [], []
    for i, kind in enumerate(cfg.layer_pattern):
        on = TRACER.on
        if kind == "M":
            j = len(states)
            lc = {key: cache[key][j] for key in STATE_KEYS} if cache is not None else None
            if on:
                TRACER.open("layer.mamba", tokens=h.shape[0] * h.shape[1])
            h, st = m_layer(h, mambas[j], lc)
            states.append(st)
        else:
            j = len(ks)
            kv = (cache["k"][j], cache["v"][j], pos0) if cache is not None else None
            if on:
                TRACER.open("layer.attn")
            h, (k, v) = a_layer(h, attns[j], kv)
            ks.append(k)
            vs.append(v)
        if on:
            TRACER.close()
        h, aux = moe_layer(ctx.res(h), moes[i])
        auxes.append(aux)
    new_cache = None
    if mode == PREFILL:
        new_cache = {key: torch.stack([st[key] for st in states]) for key in STATE_KEYS}
        new_cache.update(k=torch.stack(ks), v=torch.stack(vs),
                         pos=torch.tensor(h.shape[1], dtype=torch.int32, device=h.device))
    elif mode == DECODE:
        # every lane was updated in place
        new_cache = dict(cache, pos=pos0 + 1)
    aux = {}
    if with_aux:
        aux = {key: torch.stack([a[key] for a in auxes]).mean() for key in auxes[0]}
    return h, new_cache, aux


def encoder(params: Dict, cfg: ArchConfig, enc_embeds: torch.Tensor, *,
            ctx: ShardCtx = NOSHARD, remat: bool = False) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings (B, enc_len, d):
    non-causal self-attention with rope, then the GELU MLP, per layer;
    then ``enc_final_norm``."""

    def layer(e, lp):
        e, _ = attention_block(lp["attn"], e, cfg, ctx, mode=TRAIN, causal=False)
        return ctx.res(mlp_block(lp["mlp"], e, cfg, ctx))

    layer = maybe_remat(layer, remat)
    e = enc_embeds
    for lp in _unstack(params["enc_layers"], cfg.n_layers):
        e = layer(e, lp)
    return rms_norm(e, ctx.gather(params["enc_final_norm"]), cfg.norm_eps)


def _cross_from_cache(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      ck: torch.Tensor, cv: torch.Tensor,
                      ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """Residual cross-attention against the cached encoder K/V (decode):
    every one of the enc_len keys, no rope, no mask."""
    p = ctx.gather(p)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    return x + ctx.res(_out_proj(_attend_cache(q, ck, cv, ctx), p["wo"]))


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
            h = _cross_from_cache(lp["cross"], h, cfg, *cross_kv, ctx=ctx)
        else:
            h, cross_kv = attention_block(lp["cross"], h, cfg, ctx, mode=mode,
                                          causal=False, use_rope=False,
                                          cross_states=enc_out)
        return ctx.res(mlp_block(lp["mlp"], h, cfg, ctx)), new_kv, cross_kv

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
           Family.HYBRID: _hybrid_stack, Family.HYBRID_MOE: _hybrid_moe_stack,
           Family.ENC_DEC: _encdec_stack, Family.AUDIO: _encdec_stack}


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
    sharded = ctx.enabled and isinstance(params["embed"], DTensor)
    with plain_tensors_replicated() if sharded else contextlib.nullcontext():
        if sharded:
            h = _embed(ctx.gather(params["embed"]), batch["tokens"])
        else:
            h = params["embed"][batch["tokens"]]
        if cfg.embedding_multiplier != 1.0:
            h = h * cfg.embedding_multiplier
        h = ctx.res(h)
        h, new_cache, aux = _STACKS[cfg.family](params, h, cfg, ctx, cache, mode=mode,
                                                with_aux=with_aux, remat=remat, **extra)
        h = rms_norm(h, ctx.gather(params["final_norm"]), cfg.norm_eps)
    return h, new_cache, aux


def _embed(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """Rows of a (vocab-sharded) embedding table: each shard gathers the
    tokens that fall in its slice and zeros elsewhere, a partial sum over
    the vocab's mesh dims that the residual constraint reduces (the
    gradient lands in the owning shard's rows)."""
    mesh, pl = table.device_mesh, table.placements
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [m for m, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 0]
    out = tuple(Partial() if m in vocab else p for m, p in enumerate(tokens.placements))
    first = local_shape_and_offset(table.shape, mesh, pl)[1][0]

    def lookup(w, t):
        idx = t.long() - first
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = w[idx.clamp(0, w.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return per_shard(lookup, out=(out,), ins=(pl, tokens.placements),
                     mesh=mesh)(table, tokens)


def head(params: Dict, cfg: ArchConfig, h: torch.Tensor,
         ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """Logits (..., Vp); the tied embedding or the separate lm_head,
    sharded over the vocab as ``repro.models.model.forward``'s logits,
    divided by ``cfg.logits_scaling``."""
    w = ctx.gather(params["embed"]).T if cfg.tie_embeddings \
        else ctx.gather(params["lm_head"])
    with plain_tensors_replicated() if isinstance(h, DTensor) else contextlib.nullcontext():
        logits = h @ w
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
    return ctx.act(logits, ctx.dp, *([None] * (h.ndim - 2)), ctx.tp)


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
    return head(params, cfg, h, ctx), new_cache, aux


def cache_schema(cfg: ArchConfig, batch: int, max_len: int, enc_len: int = 0) -> Dict:
    """Decode-cache schema; leading L axis matches the layer stack.  The
    encoder-decoder family adds its cross K/V at ``enc_len``."""
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    pos = PS((), (), init="zeros", dtype=torch.int32)
    if cfg.family == Family.HYBRID:
        G = L // cfg.shared_attn_period
        shared_kv = PS((G, batch, max_len, KV, hd),
                       ("groups", "batch", "seq", "heads_kv", "hd_cache"),
                       init="zeros")
        return {**_mamba2_state_schema(cfg, L, batch), "shared_k": shared_kv,
                "shared_v": shared_kv, "pos": pos}
    if cfg.family == Family.HYBRID_MOE:
        kv = PS((len(cfg.attn_layers), batch, max_len, KV, hd),
                ("layers", "batch", "seq", "heads_kv", "hd_cache"), init="zeros")
        return {**_mamba2_state_schema(cfg, len(cfg.mamba_layers), batch),
                "k": kv, "v": kv, "pos": pos}
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


def _mamba2_state_schema(cfg: ArchConfig, L: int, batch: int) -> Dict:
    """The decode state lanes of ``L`` mamba2 layers: the last K-1 pre-conv
    inputs of x, B and C, and the float32 SSM state."""
    di, n, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    nh = di // cfg.ssm.head_dim
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
    }
