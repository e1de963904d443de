"""Continuous-batching serving engine.

A slot-based engine in the vLLM style, built on the prefill/decode steps: a
fixed pool of B slots shares one pre-allocated KV cache; requests are
admitted into free slots (a B=1 prefill fills the slot's cache lane), every
engine tick decodes ONE token for ALL slots, and finished sequences (EOS /
max tokens) free their slot immediately for the next queued request.

The cache pool is allocated once, in the compute dtype (the mamba SSM
states in float32), with the layouts of ``cache_schema``: ``(L, B, S_max,
KV, hd)`` for k/v, and per-layer state lanes for the SSM and hybrid
families, which an admission writes whole.  Idle
slots decode a stale token at position 0 of their own lane, which the next
admission overwrites, as in ``repro.serve.engine``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ArchConfig, CellTuning
from repro_torch.models.model import SEQ_KEYS, cache_schema, cast_params
from repro_torch.models.ops import ShardCtx
from repro_torch.models.sharding import map_schema
from repro_torch.train.steps import make_prefill_step, make_serve_step


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None

    # filled by the engine
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class EngineStats:
    admitted: int = 0
    finished: int = 0
    ticks: int = 0
    decoded_tokens: int = 0
    # Host-clock seconds spent in prefill and in decode steps, and the prompt
    # tokens prefilled.  Both steps end in a device-to-host read of the
    # chosen tokens, so the clock covers the device work.
    prefill_tokens: int = 0
    prefill_s: float = field(default=0.0, compare=False)
    decode_s: float = field(default=0.0, compare=False)

    @property
    def occupancy_tokens_per_tick(self) -> float:
        return self.decoded_tokens / self.ticks if self.ticks else 0.0


class ServeEngine:
    """Continuous-batching engine over one model.

    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` to run on the CPU.  The weights are cast to
    ``tuning.compute_dtype`` once, here."""

    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        *,
        slots: int = 4,
        max_len: int = 128,
        tuning: Optional[CellTuning] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        tuning = tuning or CellTuning(compute_dtype="float32")
        self.dtype = getattr(torch, tuning.compute_dtype)
        self.params = cast_params(params, self.dtype, self.device)
        self.slots = slots
        self.max_len = max_len

        # single-sequence prefill (B=1) + pooled decode (B=slots)
        ctx = ShardCtx(attention_impl=tuning.attention_impl,
                       ssm_impl=tuning.ssm_impl,
                       moe_row_dispatch=tuning.moe_row_dispatch)
        self._prefill = make_prefill_step(cfg, ctx)
        self._decode = make_serve_step(cfg, ctx)

        schema = cache_schema(cfg, slots, max_len, enc_len=cfg.enc_len)
        self.cache = map_schema(
            lambda ps: torch.zeros(ps.shape, dtype=ps.dtype or self.dtype,
                                   device=self.device),
            schema)
        # per-slot sequence positions live on the host; each decode step
        # gets them as a (B,) vector
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats()
        self._next_tok = np.zeros(slots, np.int64)

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                     device=self.device)            # (1, S)
            t0 = time.perf_counter()
            last_logits, cache1 = self._prefill(self.params, {"tokens": prompt})
            self._write_slot(slot, cache1, prompt.shape[1])
            self._next_tok[slot] = int(torch.argmax(last_logits[0, : self.cfg.vocab]))
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_tokens += prompt.shape[1]
            self.slot_req[slot] = req
            self.slot_pos[slot] = prompt.shape[1]
            self.stats.admitted += 1

    def _write_slot(self, slot: int, cache1, seq_len: int) -> None:
        """Copy a single-sequence (B=1) prefill cache into the pool lane:
        sequence leaves up to ``seq_len`` with the rest of the lane zeroed,
        state leaves whole."""
        for key, pool in self.cache.items():
            if key == "pos":
                continue
            lane = pool[:, slot]                            # drop the B dim
            if key in SEQ_KEYS:
                lane[:, :seq_len] = cache1[key][:, 0]
                lane[:, seq_len:] = 0
            else:
                lane.copy_(cache1[key][:, 0])

    # -- decode tick -----------------------------------------------------------

    def tick(self) -> None:
        """Admit waiting requests, then decode one token for all occupied
        slots (idle slots decode a pad token into a scratch lane)."""
        self._admit()
        occupied = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not occupied:
            self.stats.ticks += 1
            return
        t0 = time.perf_counter()
        cache = dict(self.cache, pos=torch.as_tensor(self.slot_pos, device=self.device))
        toks = torch.as_tensor(self._next_tok[:, None], device=self.device)
        logits, _ = self._decode(self.params, cache, toks)   # updated in place
        nxt = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0

        self.stats.ticks += 1
        for i in occupied:
            req = self.slot_req[i]
            tok = int(self._next_tok[i])
            req.generated.append(tok)
            self.stats.decoded_tokens += 1
            self.slot_pos[i] += 1
            self._next_tok[i] = int(nxt[i])
            if (req.eos_token is not None and tok == req.eos_token) \
                    or len(req.generated) >= req.max_new_tokens \
                    or self.slot_pos[i] >= self.max_len:
                req.done = True
                self.stats.finished += 1
                self.slot_req[i] = None
                self.slot_pos[i] = 0

    def run_until_drained(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()
        return self.stats
