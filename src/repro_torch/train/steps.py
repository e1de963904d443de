"""Serving step factories (training waits for a later slice of the port).

``make_prefill_step`` / ``make_serve_step`` build the serving entry points:
the full-sequence cache build and the one-token decode step.  Parameters
come in the compute dtype already (``models.model.cast_params``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import DECODE, PREFILL, backbone, head
from repro_torch.models.ops import NOSHARD, ShardCtx


def make_prefill_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD) -> Callable:
    """prefill(params, batch) -> (last-token logits (B, Vp), cache).

    Only the last position goes through the vocab head: the logits are
    the same as the JAX step's ``logits[:, -1]`` without the (B, S, Vp)
    tensor it builds first."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        h, cache, _ = backbone(params, cfg, batch, ctx=ctx, mode=PREFILL)
        return head(params, cfg, h[:, -1]), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD) -> Callable:
    """serve_step(params, cache, tokens (B,1)) -> (logits (B,Vp), cache).

    One new token against a KV cache of length max_len; the cache's k/v
    are updated in place and returned."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        h, new_cache, _ = backbone(params, cfg, {"tokens": tokens}, ctx=ctx,
                                mode=DECODE, cache=cache)
        return head(params, cfg, h[:, -1]), new_cache

    return serve_step
