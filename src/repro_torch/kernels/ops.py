"""Model-layout wrappers of the port's kernels.

Each kernel is a ``torch.library`` operator (``repro_torch::flash_attention``,
``repro_torch::ssd_scan``): its CUDA implementation is the hand-written
kernel, which launches or raises; its CPU implementation is the kernel's
plain PyTorch version.  There is no other route: nothing here falls back
from the kernel to the plain version.  ``LAUNCHES`` counts kernel launches,
in the CUDA implementations and nowhere else.  One ``ssd_scan`` count
stands for one call of the scan, which launches its five passes (cumsum,
C.B^T, chunk states, state passing, chunk output) as five CUDA kernels on
the current stream; one ``flash_attention`` count is one kernel launch.

Each operator also has a fake implementation (output shapes and dtypes)
and a FLOP formula, so ``launch.cost`` counts a step that goes through the
kernels under ``FakeTensorMode`` without launching anything.  The formula
is the work the torch route does for the same call (``attention_chunked``
and the JAX package's XLA attention compute the masked full score matrix;
``models.ssm.ssd_chunked`` the chunked SSD), so a roofline reads the same
work whichever route computes it.

Neither kernel has a backward (the JAX package's Pallas kernels have none
either): a call that autograd would have to differentiate raises, on the
card and on the CPU alike, and falls back to nothing.  Training goes
through the plain paths, ``ShardCtx(attention_impl="torch",
ssm_impl="torch")`` (``train.steps.TRAIN_CTX``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .flash_attention import flash_attention_cuda, flash_attention_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "ssd_scan": 0}


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


# -- flash attention ----------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    return flash_attention_plain(q, k, v, causal=causal)


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal):
    out = flash_attention_cuda(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
                 **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, causal or not."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * Sq * k_shape[1] * hd


def flash_attention(
    q: torch.Tensor,      # (B, Sq, H, hd)
    k: torch.Tensor,      # (B, Sk, KV, hd)
    v: torch.Tensor,      # (B, Sk, KV, hd)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Flash attention in the model layout; returns (B, Sq, H, hd)."""
    _forward_only("flash_attention", q, k, v)
    _on_cpu_or_cuda("flash_attention", q)
    return _flash_op(q, k, v, causal)


# -- SSD scan -----------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk)


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
    """What ``FlopCounterMode`` counts for ``models.ssm.ssd_chunked`` at the
    same shapes (S padded to ``nc`` chunks of ``chunk``): per chunk C.B^T
    (Q^2 n), the intra-chunk product (nh Q^2 hp), the chunk states and the
    inter-chunk output (nh Q hp n each)."""
    B_, S, nh, hp = x_shape
    n = Bc_shape[-1]
    nc = -(-S // chunk)
    return 2 * B_ * nc * chunk * (chunk * n + nh * chunk * hp + 2 * nh * hp * n)


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
    return _ssd_op(x, dt, A, Bc, Cc, chunk)
