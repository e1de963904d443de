"""Shared model ops: norms, rotary embeddings, chunked attention, the
training loss.

``attention_chunked`` is the plain PyTorch path (a loop over query chunks
that never holds the full S_q x S_k score tensor), each chunk
``kernels.flash_attention.attention_reference``: the flash kernel's plain
version, which the kernel is held against on the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch._guards import detect_fake_mode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import NEG_INF, attention_reference
from repro_torch.launch.mesh import (local_shape_and_offset, per_shard, redistribute,
                                     spec_to_placements)

ATTENTION_IMPLS = ("kernel", "torch")
SSM_IMPLS = ("kernel", "torch")


@dataclass(frozen=True)
class ShardCtx:
    """Execution context: activation-sharding constraints and kernel
    implementation selection (``repro.models.ops.ShardCtx``).
    ``enabled=False`` (one card, or a step on plain tensors) turns every
    constraint into a no-op.

    ``act(x, *axes)`` is the JAX package's ``with_sharding_constraint``: on
    a DTensor it redistributes ``x`` to the placements of the spec ``axes``
    (``launch.mesh.spec_to_placements``) on ``x``'s own mesh; on a plain
    tensor it does nothing.  ``dp`` (batch axes, None = replicated), ``tp``
    (the model axis), ``heads_sharded`` / ``ff_sharded`` and the
    sequence-parallel flags follow the JAX bodies line for line:
    ``seq_parallel_attn`` shards q (and the attention output) on the
    SEQUENCE dim over the model axis when the heads do not divide it (k/v
    replicated; on the kernel route each shard runs the kernel on its rows
    with their causal offset); ``seq_parallel_residual`` shards the
    residual carry over the model axis on the seq dim.

    ``attention_impl``: "kernel" (prefill attention through
    ``kernels.ops.flash_attention`` and decode attention through
    ``kernels.ops.decode_attention``: the CUDA kernel on a CUDA tensor, its
    plain version ``attention_reference`` on a CPU tensor) or "torch"
    (``attention_chunked``, and ``attention_reference`` itself in decode).
    ``ssm_impl``: "kernel" (the mamba2 prefill scan through
    ``kernels.ops.ssd_scan``, likewise with ``ssd_chunked``) or "torch"
    (``kernels.ssd_scan.ssd_chunked`` itself).  Each kernel's one plain
    version lives in its kernel module; on the CPU both routes run it.
    ``moe_row_dispatch``: route MoE tokens with a per-row capacity
    (``moe._moe_mlp_rows``) instead of one global token pool.
    ``remat_chunk_attn``: ``attention_chunked`` recomputes each query
    chunk's scores in the backward pass instead of keeping them.
    """

    # the implementation flags first: the port's contexts name them by
    # position (``ShardCtx("torch", "torch")``)
    attention_impl: str = "kernel"
    ssm_impl: str = "kernel"
    moe_row_dispatch: bool = False
    remat_chunk_attn: bool = False
    enabled: bool = False
    dp: Optional[Tuple[str, ...]] = ("data",)     # batch axes
    tp: Optional[str] = "model"
    heads_sharded: bool = True
    ff_sharded: bool = True
    seq_parallel_attn: bool = False
    seq_parallel_residual: bool = False

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} not in {ATTENTION_IMPLS}")
        if self.ssm_impl not in SSM_IMPLS:
            raise ValueError(f"ssm_impl {self.ssm_impl!r} not in {SSM_IMPLS}")

    def act(self, x: torch.Tensor, *axes) -> torch.Tensor:
        if not self.enabled or not isinstance(x, DTensor):
            return x
        return redistribute(x, spec_to_placements(axes, x.device_mesh))

    def batch(self, x: torch.Tensor) -> torch.Tensor:
        """Constrain leading axis to the data-parallel axes only."""
        return self.act(x, self.dp, *([None] * (x.ndim - 1)))

    def res(self, x: torch.Tensor) -> torch.Tensor:
        """Residual-stream constraint for a (B, S, d) carry.  Seq-shards
        only full sequences (decode carries have S == 1)."""
        if self.seq_parallel_residual and self.tp is not None \
                and x.ndim >= 3 and x.shape[1] % 128 == 0:
            return self.act(x, self.dp, self.tp, *([None] * (x.ndim - 2)))
        return self.batch(x)

    @property
    def heads(self):
        return self.tp if self.heads_sharded else None

    def gather(self, params):
        """The FSDP (ZeRO-3) gather at a weight's point of use, as XLA
        inserts it: every DTensor of ``params`` (a tensor or a dict of
        them) replicated over every mesh axis but ``tp``, whose shards are
        kept.  DTensor's backward of this redistribute reduce-scatters the
        gradient back onto the FSDP axes.  Gathering here, not leaving the
        choice to DTensor's matmul propagation, keeps a batch-sharded
        activation from being all-gathered against a weight sharded on the
        same axis."""
        if isinstance(params, dict):
            return {k: self.gather(v) for k, v in params.items()}
        if not self.enabled or not isinstance(params, DTensor):
            return params
        return redistribute(params, tuple(
            pl if name == self.tp else Replicate()
            for name, pl in zip(params.device_mesh.mesh_dim_names, params.placements)))


NOSHARD = ShardCtx(enabled=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# rotary's frequencies, one tensor per (half, theta, device)
_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rotary_freqs(half: int, theta: float, device) -> torch.Tensor:
    """``theta ** (-i / half)`` for ``i < half``, float32, on ``device``.

    Building it copies ``theta`` from the host, which synchronises the
    stream and cannot be captured in a CUDA graph, so it is built once per
    ``(half, theta, device)``, outside inference mode, and kept; every
    later call returns the kept tensor, the same bits.  Under a fake mode
    (a dry run's count) it is built each call and not kept."""
    if detect_fake_mode() is not None:
        return _freqs(half, theta, device)
    key = (half, float(theta), torch.device(device))
    freqs = _FREQS.get(key)
    if freqs is None:
        with torch.inference_mode(False):
            freqs = _FREQS[key] = _freqs(half, theta, device)
    return freqs


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved (NeoX pair) rotary embedding, angles in float32.

    x: (..., S, n_heads, hd); positions: (..., S) absolute positions.
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = rotary_freqs(half, theta, x.device)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x2 = x.reshape(*x.shape[:-1], half, 2)
    x_even, x_odd = x2[..., 0], x2[..., 1]
    out = torch.stack(
        [x_even * cos - x_odd * sin, x_even * sin + x_odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def maybe_remat(fn, remat: bool):
    """``fn`` under activation checkpointing when ``remat`` (the JAX
    package's ``jax.checkpoint`` of a layer or a query chunk): its
    activations are recomputed in the backward pass instead of kept.  The
    model draws no random numbers, so no RNG state is stashed."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_chunk: int = 512,
    remat_body: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Query-chunked attention: O(q_chunk * Sk) live scores.

    The same math as ``attention_reference``, one query chunk at a time; a
    ragged last chunk is allowed.  ``remat_body`` recomputes each chunk's
    scores in the backward pass (a non-reentrant ``torch.utils.checkpoint``
    per chunk), so no chunk's softmax is kept between the forward and the
    backward: the JAX package's ``jax.checkpoint`` of the chunk body.
    """
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return attention_reference(q, k, v, causal=causal, scale=scale)
    chunk = maybe_remat(attention_reference, remat_body)
    outs = [chunk(q[:, i:i + q_chunk], k, v, causal=causal, q_offset=i, scale=scale)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over tokens + z-loss term; logits (..., Vp) may be padded to
    Vp >= vocab — padded slots are masked out of the partition function."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab:
        pad_mask = torch.arange(vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad_mask, NEG_INF)
    if _vocab_sharded(logits):
        logz, gold = _sharded_logz_gold(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (logz - gold).mean()
    zloss = torch.square(logz).mean()
    return ce, zloss


def _vocab_sharded(logits: torch.Tensor) -> bool:
    return isinstance(logits, DTensor) and any(
        isinstance(pl, Shard) and pl.dim % logits.ndim == logits.ndim - 1
        for pl in logits.placements)


def _sharded_logz_gold(logits: DTensor, labels: torch.Tensor):
    """``logsumexp`` and the gold logit over logits sharded on the vocab:
    per shard its max (a partial max, reduced), its sum of exp(l - max) and
    its gold logit where the label falls in its slice (partial sums over
    the vocab's mesh dims, reduced), the counterpart of XLA's sharded
    reduction.  DTensor's own rules would gather the (..., Vp) logits."""
    mesh, pl, last = logits.device_mesh, logits.placements, logits.ndim - 1
    vocab = [m for m, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim % logits.ndim == last]
    rows = tuple(Replicate() if m in vocab else p for m, p in enumerate(pl))

    def partial(red):
        return tuple(Partial(red) if m in vocab else p for m, p in enumerate(pl))

    if isinstance(labels, DTensor):
        labels = redistribute(labels, rows)
    first = local_shape_and_offset(logits.shape, mesh, pl)[1][-1]
    top = per_shard(lambda x: x.detach().amax(-1), out=(partial("max"),), ins=(pl,),
                    mesh=mesh)(logits)
    top = redistribute(top, rows)

    def parts(x, t, y):
        idx = y.long() - first
        inside = (idx >= 0) & (idx < x.shape[-1])
        gold = torch.gather(x, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        return (torch.exp(x - t[..., None]).sum(-1),
                torch.where(inside, gold, torch.zeros_like(gold)))

    sums, gold = per_shard(parts, out=(partial("sum"), partial("sum")),
                           ins=(pl, rows, rows), mesh=mesh)(logits, top, labels)
    return top + torch.log(redistribute(sums, rows)), redistribute(gold, rows)
