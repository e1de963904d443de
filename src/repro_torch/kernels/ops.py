"""Model-layout wrappers of the port's kernels.

Each kernel is a ``torch.library`` operator (``repro_torch::flash_attention``,
``repro_torch::decode_attention``, ``repro_torch::ssd_scan``): its CUDA
implementation is the hand-written kernel, which launches or raises; its
CPU implementation is the kernel's one plain PyTorch version, after the
same argument checks: ``flash_attention.attention_reference`` for both
attention operators (with ``kv_len`` for decode), ``ssd_scan.ssd_chunked``
for the scan.  The models' plain routes call those same functions.  There
is no other route: nothing here falls back from the kernel to the plain
version.
``LAUNCHES`` counts kernel launches, in the CUDA implementations and,
for a step captured in a CUDA graph (``serve.engine.DecodeGraph``), once
for each replay of the calls its capture made.  One ``ssd_scan`` count
stands for one call of the scan, which launches its five passes (cumsum,
C.B^T, chunk states, state passing, chunk output) as five CUDA kernels on
the current stream; one ``decode_attention`` count for one call, which
launches two (the chunks' partial softmax, then their combination); one
``flash_attention`` count is one kernel launch.

Each operator also has a fake implementation (output shapes and dtypes)
and a FLOP formula, so ``launch.cost`` counts a step that goes through the
kernels under ``FakeTensorMode`` without launching anything.  The formula
is what ``FlopCounterMode`` counts for the operator's plain version at the
same shapes (``attention_reference``: the masked full score matrix, over
the whole cache lane for decode; ``ssd_chunked``: the chunked SSD), which
is also the work the plain route and the JAX package's XLA code do, so a
roofline reads the same work whichever route computes it.

On DTensors each operator runs per shard through the sharding strategy
registered here (``register_sharding``): flash attention with the batch
sharded, or the heads of q, k and v sharded together (each shard keeps its
GQA groups whole); decode attention with the batch sharded (q, k, v and a
(B,) ``kv_len``; a 0-d one replicated), or everything replicated; the SSD
scan with the batch sharded, or its heads (x, dt, A and both outputs) with
``Bc``/``Cc`` replicated.  Every rule keeps
the operator's own semantics on the local shards, so a shard's call is the
kernel (or its plain version) on local tensors, and its fake
implementation and FLOP formula count the local shapes.  A DTensor call
whose placements match none of those rules raises: DTensor would
otherwise gather the inputs to ``Replicate`` around the kernel.

Neither kernel has a backward (the JAX package's Pallas kernels have none
either): a call that autograd would have to differentiate raises, on the
card and on the CPU alike, and falls back to nothing.  Training goes
through the plain paths, ``ShardCtx(attention_impl="torch",
ssm_impl="torch")`` (``train.steps.TRAIN_CTX``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from .decode_attention import _check as _decode_check, decode_attention_cuda
from .flash_attention import _check as _flash_check, attention_reference, flash_attention_cuda
from .ssd_scan import _check as _ssd_check, ssd_chunked, ssd_scan_cuda

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor do the JAX package's Pallas kernels): "
            "train with ShardCtx(attention_impl='torch', ssm_impl='torch'), "
            "as train.steps.TRAIN_CTX does")


def _on_cpu_or_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {t.device}")


def _rule_of(name: str, rules, *tensors: torch.Tensor) -> None:
    """On DTensors: raise unless, on every mesh dim, the inputs' placements
    are one of ``rules`` (each a tuple of one placement per input)."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return
    if not all(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: mixed DTensor and plain tensor inputs")
    for m in range(tensors[0].device_mesh.ndim):
        got = tuple(t.placements[m] for t in tensors)
        if got not in rules:
            raise ValueError(
                f"{name} has no sharding rule for placements {got} on mesh dim "
                f"{m}; constrain its inputs to one of {rules}")


# -- flash attention ----------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, q_offset: int, scale: Optional[float]) -> torch.Tensor:
    _flash_check(q, k, v, causal, q_offset)
    # contiguous, as the fake implementation's output
    return attention_reference(q, k, v, causal=causal, q_offset=q_offset,
                               scale=scale).contiguous()


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, q_offset, scale):
    out = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, q_offset, scale):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, q_offset, scale=None, *args,
                 out_shape=None, **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, causal or not."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * Sq * k_shape[1] * hd


_FLASH_RULES = ((Replicate(),) * 3, (Shard(0),) * 3, (Shard(2),) * 3)


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_sharding(q, k, v, causal, q_offset, scale):
    """Per mesh dim: all replicated, the batch sharded, or the heads of q,
    k and v sharded together (out like q)."""
    return [([rule[0]], [*rule, None, None, None]) for rule in _FLASH_RULES]


def flash_attention(
    q: torch.Tensor,      # (B, Sq, H, hd)
    k: torch.Tensor,      # (B, Sk, KV, hd)
    v: torch.Tensor,      # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention in the model layout; returns (B, Sq, H, hd).
    ``q_offset``: the position of q's first row under the causal mask (a
    slice of later query rows against every key; 0 when Sq == Sk).
    ``scale``: the scores' factor (None: 1/sqrt(hd))."""
    _forward_only("flash_attention", q, k, v)
    _on_cpu_or_cuda("flash_attention", q)
    _rule_of("flash_attention", _FLASH_RULES, q, k, v)
    return _flash_op(q, k, v, causal, q_offset, scale)


# -- decode attention ---------------------------------------------------------

@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: Optional[torch.Tensor], scale: Optional[float]) -> torch.Tensor:
    _decode_check(q, k, v, kv_len)
    return attention_reference(q, k, v, causal=False, kv_len=kv_len,
                               scale=scale).contiguous()


@_decode_op.register_kernel("cuda")
def _decode_cuda(q, k, v, kv_len, scale):
    out = decode_attention_cuda(q, k, v, kv_len, scale)
    LAUNCHES["decode_attention"] += 1
    return out


@_decode_op.register_fake
def _decode_fake(q, k, v, kv_len, scale):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, v_shape, kv_len_shape, scale=None, *args,
                  out_shape=None, **kwargs) -> int:
    """QK^T and PV over the whole lane, as ``attention_reference`` computes
    them (the kernel reads only the live prefix; the count is the plain
    version's, so the dry run counts the same work on either route)."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * Sq * k_shape[1] * hd


def _decode_rules(kv_len):
    """Per mesh dim (q, k, v, kv_len): all replicated, or the batch sharded
    (a 0-d ``kv_len`` replicated); no ``kv_len``, no placement for it."""
    if kv_len is None:
        return ((Replicate(),) * 3 + (None,), (Shard(0),) * 3 + (None,))
    batch = Replicate() if kv_len.ndim == 0 else Shard(0)
    return ((Replicate(),) * 4, (Shard(0),) * 3 + (batch,))


@register_sharding(torch.ops.repro_torch.decode_attention.default)
def _decode_sharding(q, k, v, kv_len, scale):
    """Per mesh dim: all replicated, or the batch sharded (out like q)."""
    return [([rule[0]], [*rule, None]) for rule in _decode_rules(kv_len)]


def decode_attention(
    q: torch.Tensor,                          # (B, 1, H, hd)
    k: torch.Tensor,                          # (B, Sk, KV, hd)
    v: torch.Tensor,                          # (B, Sk, KV, hd)
    kv_len: Optional[torch.Tensor] = None,    # None, 0-d or (B,): keys live
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query row a slot against the first ``kv_len`` keys of its cache
    lane (all Sk where None), non-causal; returns (B, 1, H, hd) in q's
    dtype.  Each length must lie in [1, Sk].  ``scale``: the scores'
    factor (None: 1/sqrt(hd))."""
    _forward_only("decode_attention", q, k, v)
    _on_cpu_or_cuda("decode_attention", q)
    rules = _decode_rules(kv_len)
    if kv_len is None:
        _rule_of("decode_attention", tuple(r[:3] for r in rules), q, k, v)
    else:
        _rule_of("decode_attention", rules, q, k, v, kv_len)
    return _decode_op(q, k, v, kv_len, scale)


# -- SSD scan -----------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _ssd_check(x, dt, A, Bc, Cc, chunk)
    return ssd_chunked(x, dt, A, Bc, Cc, chunk)


@_ssd_op.register_kernel("cuda")
def _ssd_cuda(x, dt, A, Bc, Cc, chunk):
    out = ssd_scan_cuda(x, dt, A, Bc, Cc, chunk=chunk)
    LAUNCHES["ssd_scan"] += 1
    return out


@_ssd_op.register_fake
def _ssd_fake(x, dt, A, Bc, Cc, chunk):
    B_, S, nh, hp = x.shape
    return (x.new_empty((B_, S, nh, hp), dtype=torch.float32),
            x.new_empty((B_, nh, hp, Bc.shape[-1]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flops(x_shape, dt_shape, A_shape, Bc_shape, Cc_shape, chunk, *args,
               out_shape=None, **kwargs) -> int:
    """What ``FlopCounterMode`` counts for ``ssd_chunked`` at the same
    shapes (S padded to ``nc`` chunks of ``chunk``): per chunk C.B^T
    (Q^2 n), the intra-chunk product (nh Q^2 hp), the chunk states and the
    inter-chunk output (nh Q hp n each)."""
    B_, S, nh, hp = x_shape
    n = Bc_shape[-1]
    nc = -(-S // chunk)
    return 2 * B_ * nc * chunk * (chunk * n + nh * chunk * hp + 2 * nh * hp * n)


# (x, dt, A, Bc, Cc) -> (y, h_final), per mesh dim
_SSD_RULES = {
    (Replicate(),) * 5: (Replicate(), Replicate()),
    (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0)): (Shard(0), Shard(0)),
    (Shard(2), Shard(2), Shard(0), Replicate(), Replicate()): (Shard(2), Shard(1)),
}


def ssd_out_placements(x, dt, A, Bc, Cc) -> Tuple[Tuple, Tuple]:
    """The placements of (y, h_final) of an SSD scan of DTensors whose
    placements are, on every mesh dim, one of the strategy's rules (raises
    otherwise)."""
    _rule_of("ssd_scan", tuple(_SSD_RULES), x, dt, A, Bc, Cc)
    outs = [_SSD_RULES[tuple(t.placements[m] for t in (x, dt, A, Bc, Cc))]
            for m in range(x.device_mesh.ndim)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


@register_sharding(torch.ops.repro_torch.ssd_scan.default)
def _ssd_sharding(x, dt, A, Bc, Cc, chunk):
    """Per mesh dim: all replicated, the batch sharded (A replicated), or
    the heads sharded (x, dt, A, y and h_final; Bc/Cc replicated)."""
    return [(list(outs), [*ins, None]) for ins, outs in _SSD_RULES.items()]


def ssd_scan(
    x: torch.Tensor,      # (B, S, nh, hp)
    dt: torch.Tensor,     # (B, S, nh)
    A: torch.Tensor,      # (nh,)
    Bc: torch.Tensor,     # (B, S, n)
    Cc: torch.Tensor,     # (B, S, n)
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in the model layout.  Returns (y (B, S, nh, hp) f32,
    h_final (B, nh, hp, n) f32).  A ragged last chunk is handled inside
    (it equals the JAX wrapper's dt = 0 padding), so nothing is padded."""
    _forward_only("ssd_scan", x, dt, A, Bc, Cc)
    _on_cpu_or_cuda("ssd_scan", x)
    _rule_of("ssd_scan", tuple(_SSD_RULES), x, dt, A, Bc, Cc)
    return _ssd_op(x, dt, A, Bc, Cc, chunk)
