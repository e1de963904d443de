"""Continuous-batching serving engine.

A slot-based engine in the vLLM style, built on the prefill/decode steps: a
fixed pool of B slots shares one pre-allocated KV cache; requests are
admitted into free slots (a B=1 prefill fills the slot's cache lane), every
engine tick decodes ONE token for ALL slots, and finished sequences (EOS /
max tokens) free their slot immediately for the next queued request.

The cache pool is allocated once, in the compute dtype (the mamba SSM
states in float32), with the layouts of ``cache_schema``: ``(L, B, S_max,
KV, hd)`` for k/v, and per-layer state lanes for the SSM and hybrid
families, which an admission writes whole.  The encoder-decoder family
(whisper) prefills each request over zero frame embeddings (the JAX
engine's; the frontend is a stub) and writes its cross K/V lanes
``(L, B, enc_len, KV, hd)`` whole, as they are enc_len long in both the
prefill and the pool.  Idle
slots decode a stale token at position 0 of their own lane, which the next
admission overwrites, as in ``repro.serve.engine``.

The decode step always runs all B slots at fixed shapes, so on one card
(a CUDA device, plain parameters) ``DecodeGraph`` captures it once as a
CUDA graph and replays it every tick: the host launches one graph where
the eager step launches thousands of kernels.  An admission's B=1 prefill
changes shape with every prompt; where the cache holds only K/V and a
prompt padded at its end prefills as the prompt alone (``pads_safely``),
``PrefillGraphs`` pads it to a multiple of ``PREFILL_BUCKET`` tokens and
replays one graph per such length, up to ``PREFILL_GRAPH_MAX``.  On the
CPU, or with a mesh's DTensor parameters, every step runs eagerly.

While ``repro_torch.obs.trace.TRACER`` is on (enabled, or a
``torch.profiler`` trace active at the tick's start), each tick records
its spans on the host clock (``time.perf_counter``)::

    serve.tick              queued (queue length at entry), slots; admitted, live,
    │                       kv_tokens (the keys the decode step attends to:
    │                       the sum over every slot of pos + 1; 0 without a step)
    ├── serve.admit         one an admission: request_id, slot, prompt_len,
    │   │                   queued_s (submit() to the prefill's start)
    │   ├── serve.prefill.enqueue   the prefill step returning, then the slot write;
    │   │   │                       graph (1: the step replayed, 0: it ran eagerly)
    │   │   ├── layer.attn, moe.route, moe.dispatch, moe.experts, moe.combine
    │   │   │                       (none in a replay)
    │   │   └── serve.write_slot
    │   └── serve.prefill.wait      the read of the first token
    ├── serve.decode.enqueue        the step's inputs and the decode step returning;
    │   │                           graph (1: the step replayed, 0: it ran eagerly)
    │   └── layer.attn, moe.*       (every layer; none in a replay, which runs no Python)
    ├── serve.decode.wait           the read of the tokens
    └── serve.emit                  appending the tokens, freeing slots

An enqueue span times the host launching the step, and holds whatever
waits for the device happen inside it (a synchronizing copy, a full
launch queue); a wait span is the host blocked on the device for the
tokens.  ``prefill.*`` cover exactly the interval ``EngineStats.prefill_s``
adds, ``decode.*`` the one ``decode_s`` adds: they share the clock reads.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.kernels.ops import LAUNCHES
from repro_torch.models.config import ArchConfig, CellTuning
from repro_torch.models.model import SEQ_KEYS, cache_schema, cast_params
from repro_torch.models.ops import ShardCtx
from repro_torch.models.sharding import map_schema
from repro_torch.obs.trace import TRACER
from repro_torch.train.steps import make_prefill_step, make_serve_step
from repro_torch.tree import leaves


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None

    # filled by the engine
    generated: List[int] = field(default_factory=list)
    done: bool = False
    submitted_s: Optional[float] = field(default=None, compare=False)   # perf_counter


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
    # decode steps and prefills that replayed a captured graph (0 on the
    # eager path)
    decode_graph_replays: int = 0
    prefill_graph_replays: int = 0

    @property
    def occupancy_tokens_per_tick(self) -> float:
        return self.decoded_tokens / self.ticks if self.ticks else 0.0


# an admission's prefill is padded to a multiple of PREFILL_BUCKET tokens
# and replayed as a graph up to PREFILL_GRAPH_MAX tokens; longer prompts
# keep the device busy eagerly
PREFILL_BUCKET = 128
PREFILL_GRAPH_MAX = 2048


def prefill_bucket(seq_len: int) -> int:
    """The length a prompt of ``seq_len`` tokens is padded to: the next
    multiple of ``PREFILL_BUCKET``."""
    return -(-seq_len // PREFILL_BUCKET) * PREFILL_BUCKET


def pads_safely(cfg: ArchConfig, schema) -> bool:
    """Whether a prompt padded at its end prefills to the same cache rows
    and last-position logits as the prompt alone, for a model ``cfg`` whose
    decode cache has the leaves of ``schema``.  Only a cache of K/V alone
    (the causal decoders) does: a state lane would run on through the
    padding, and a cross K/V is not the prompt's.  A MoE must also drop no
    token at any length (capacity factor times top-k covers every expert):
    where its capacity binds, the padded pool's larger capacity keeps
    tokens that the prompt alone drops."""
    moe = cfg.moe
    dropless = moe is None or moe.capacity_factor * moe.top_k >= moe.n_experts_padded
    return set(schema) == {"k", "v", "pos"} and dropless


def _run_on(side, fn):
    """``fn()`` on the stream ``side``, after the current stream's work
    so far and before its later work."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def _capture(fn, side, pool=None):
    """``fn()`` captured as one CUDA graph on the stream ``side``, in the
    memory pool ``pool`` where given, with ``TRACER`` off.  A capture runs
    nothing, so the kernel calls it counts in ``LAUNCHES`` are taken back
    out.  Returns (graph, ``fn``'s outputs, the kernel calls of one
    replay)."""
    graph = torch.cuda.CUDAGraph()
    before, on = dict(LAUNCHES), TRACER.on
    TRACER.on = False
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side):
            out = fn()
    finally:
        TRACER.on = on
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        LAUNCHES.update(before)
    return graph, out, launches


def _replay(graph, launches) -> None:
    graph.replay()
    for name, n in launches.items():
        LAUNCHES[name] += n


class DecodeGraph:
    """The decode step ``(params, cache, tokens) -> (logits, cache)``,
    replayed as one CUDA graph where the parameters are plain tensors on a
    CUDA device; elsewhere (the CPU, a mesh's DTensors) the eager step.

    The first call runs the step eagerly on a side stream: the tick's real
    step, and the warm-up of what a capture needs (kernel builds, rotary's
    frequencies, cuBLAS's workspace on that stream).  It then captures the
    step once on that stream, on static buffers for the tokens (B, 1) and
    the positions (B,) and on the cache's own pool tensors, which the step
    updates in place.  A capture executes nothing, so no lane is written
    twice.  Every later call copies the tokens and ``cache["pos"]`` into the
    buffers and replays on the current stream; the logits and the returned
    cache's ``pos`` are the graph's outputs, overwritten by the next replay.
    A call with other parameters or cache tensors than the captured ones
    raises, and so does a failed capture: nothing falls back to the eager
    step.  While the capture runs, ``TRACER`` records nothing.

    ``kernels.ops.LAUNCHES`` counts what the device runs: the capture adds
    nothing, and each replay adds the kernel calls of the captured step."""

    def __init__(self, step):
        self.step = step
        self.replays = 0
        self._graphed: Optional[bool] = None     # decided at the first call
        self._cuda_graph = None

    def __call__(self, params, cache, tokens):
        if self._cuda_graph is not None:
            return self._replay(params, cache, tokens)
        if self._graphed is None:
            self._graphed = self.graphable(leaves(params)[0])
        if not self._graphed:
            return self.step(params, cache, tokens)
        return self._capture(params, cache, tokens)

    @staticmethod
    def graphable(param: torch.Tensor) -> bool:
        """Whether a step on parameters like ``param`` is captured: a plain
        tensor (not a DTensor) on a CUDA device."""
        return not isinstance(param, DTensor) and param.is_cuda

    def _capture(self, params, cache, tokens):
        self._tokens, self._pos = tokens.clone(), cache["pos"].clone()
        static = dict(cache, pos=self._pos)

        def step():
            return self.step(params, static, self._tokens)

        side = torch.cuda.Stream(tokens.device)
        out = _run_on(side, step)
        self._cuda_graph, self._out, self._launches = _capture(step, side)
        self._params = params
        self._leaves = {k: v for k, v in cache.items() if k != "pos"}
        return out

    def _replay(self, params, cache, tokens):
        if params is not self._params or cache.keys() != self._leaves.keys() | {"pos"} \
                or any(cache[k] is not v for k, v in self._leaves.items()):
            raise RuntimeError("the decode graph was captured on other parameters "
                               "or cache tensors")
        self._tokens.copy_(tokens)
        self._pos.copy_(cache["pos"])
        _replay(self._cuda_graph, self._launches)
        self.replays += 1
        return self._out


class PrefillGraphs:
    """The B=1 prefill step ``(params, batch) -> (logits, cache)``, replayed
    as CUDA graphs at bucketed prompt lengths where ``pads`` (the model's
    ``pads_safely``) and the parameters are plain tensors on a CUDA device
    (``DecodeGraph.graphable``); elsewhere, and for a prompt longer than
    ``PREFILL_GRAPH_MAX`` once padded, the eager step.

    A prompt of S tokens is padded with token 0 at its end to
    ``Sb = prefill_bucket(S)``, and the step reads the logits at position
    S - 1 (``last``).  A bucket's first prompt runs the padded step eagerly
    on a side stream, as ``DecodeGraph`` does, which is that prompt's
    prefill; the step is then captured on static buffers for the tokens
    (1, Sb) and ``last`` (1,).  Every later prompt of the bucket is copied
    into them and replayed.  The logits (1, Vp) and the cache, whose
    sequence leaves hold Sb rows of which the first S are the prompt's,
    are the graph's outputs.  All buckets' graphs share one memory pool,
    sized by the largest bucket's step rather than by their sum, so a
    replay may overwrite any bucket's outputs: read them (the first token)
    and copy them out (the slot write) before the next replay.  A call
    with other parameters than the first capture's raises."""

    def __init__(self, step, pads: bool):
        self.step = step
        self.pads = pads
        self.replays = 0
        self._graphed: Optional[bool] = None     # decided at the first call
        self._buckets = {}      # Sb -> (graph, outputs, launches, tokens, last)
        self._side = self._pool = self._params = None

    def graphed(self, params, seq_len: int) -> bool:
        """Whether a prompt of ``seq_len`` tokens prefills through a graph."""
        if self._graphed is None:
            self._graphed = self.pads and DecodeGraph.graphable(leaves(params)[0])
        return self._graphed and prefill_bucket(seq_len) <= PREFILL_GRAPH_MAX

    def __call__(self, params, batch):
        tokens = batch["tokens"]
        if not self.graphed(params, tokens.shape[1]):
            return self.step(params, batch)
        Sb = prefill_bucket(tokens.shape[1])
        if self._params is None:
            self._params = params
            self._side = torch.cuda.Stream(tokens.device)
            self._pool = torch.cuda.graph_pool_handle()
        elif params is not self._params:
            raise RuntimeError("the prefill graphs were captured on other parameters")
        bucket = self._buckets.get(Sb)
        if bucket is None:
            return self._capture(params, tokens, Sb)
        graph, out, launches, toks, last = bucket
        self._fill(toks, last, tokens)
        _replay(graph, launches)
        self.replays += 1
        return out

    @staticmethod
    def _fill(toks, last, tokens) -> None:
        S = tokens.shape[1]
        toks[:, :S].copy_(tokens)
        toks[:, S:].zero_()
        last.fill_(S - 1)

    def _capture(self, params, tokens, Sb):
        toks = tokens.new_zeros(1, Sb)
        last = torch.empty(1, dtype=torch.int64, device=tokens.device)
        self._fill(toks, last, tokens)

        def step():
            return self.step(params, {"tokens": toks}, last)

        out = _run_on(self._side, step)
        self._buckets[Sb] = (*_capture(step, self._side, self._pool), toks, last)
        return out


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
        schema = cache_schema(cfg, slots, max_len, enc_len=cfg.enc_len)
        # the engine calls ``_prefill`` and ``_decode``, which a wrapper may
        # replace; ``_prefill_graphs`` and ``_graph`` keep the runners,
        # whose replays the engine counts
        self._prefill_graphs = PrefillGraphs(make_prefill_step(cfg, ctx),
                                             pads_safely(cfg, schema))
        self._prefill = self._prefill_graphs
        self._graph = DecodeGraph(make_serve_step(cfg, ctx))
        self._decode = self._graph
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
        # the encoder-decoder family's frames: zeros, allocated once
        self._enc_embeds = torch.zeros(1, cfg.enc_len, cfg.d_model, dtype=self.dtype,
                                       device=self.device) if cfg.enc_len else None

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.submitted_s = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        tr = TRACER
        on = tr.on
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            if on:
                tr.open("serve.admit", request_id=req.request_id, slot=slot,
                        prompt_len=len(req.prompt))
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                     device=self.device)            # (1, S)
            batch = {"tokens": prompt}
            if self._enc_embeds is not None:
                batch["enc_embeds"] = self._enc_embeds
            t0 = time.perf_counter()
            if on:
                tr.open("serve.prefill.enqueue", t0)
            replays = self._prefill_graphs.replays
            last_logits, cache1 = self._prefill(self.params, batch)
            replayed = self._prefill_graphs.replays - replays
            self.stats.prefill_graph_replays += replayed
            if on:
                tr.open("serve.write_slot")
            self._write_slot(slot, cache1, prompt.shape[1])
            if on:
                tr.close()
            if on:
                tr.then("serve.prefill.wait", graph=replayed)
            self._next_tok[slot] = int(torch.argmax(last_logits[0, : self.cfg.vocab]))
            t2 = time.perf_counter()
            self.stats.prefill_s += t2 - t0
            self.stats.prefill_tokens += prompt.shape[1]
            self.slot_req[slot] = req
            self.slot_pos[slot] = prompt.shape[1]
            self.stats.admitted += 1
            if on:
                tr.close(t2)
                tr.close(queued_s=t0 - req.submitted_s)

    def _write_slot(self, slot: int, cache1, seq_len: int) -> None:
        """Copy a single-sequence (B=1) prefill cache into the pool lane:
        sequence leaves' first ``seq_len`` rows (a padded prompt's cache
        holds more) with the rest of the lane zeroed, state leaves (and the
        cross K/V) whole."""
        for key, pool in self.cache.items():
            if key == "pos":
                continue
            lane = pool[:, slot]                            # drop the B dim
            if key in SEQ_KEYS:
                lane[:, :seq_len] = cache1[key][:, 0, :seq_len]
                lane[:, seq_len:] = 0
            else:
                lane.copy_(cache1[key][:, 0])

    # -- decode tick -----------------------------------------------------------

    def tick(self) -> None:
        """Admit waiting requests, then decode one token for all occupied
        slots (idle slots decode a pad token into a scratch lane)."""
        tr = TRACER
        on = tr.poll()
        if on:
            tr.open("serve.tick", queued=len(self.queue), slots=self.slots)
        admitted0 = self.stats.admitted
        self._admit()
        occupied = [i for i, r in enumerate(self.slot_req) if r is not None]
        kv_tokens = int(self.slot_pos.sum()) + self.slots if on and occupied else 0
        if occupied:
            self._step(occupied, on)
        self.stats.ticks += 1
        if on:
            tr.close(admitted=self.stats.admitted - admitted0, live=len(occupied),
                     kv_tokens=kv_tokens)
            tr.settle()

    def _step(self, occupied: List[int], on: bool) -> None:
        """One decode step for every slot, then the occupied slots' tokens."""
        tr = TRACER
        t0 = time.perf_counter()
        if on:
            tr.open("serve.decode.enqueue", t0)
        cache = dict(self.cache, pos=torch.as_tensor(self.slot_pos, device=self.device))
        toks = torch.as_tensor(self._next_tok[:, None], device=self.device)
        replays = self._graph.replays
        logits, _ = self._decode(self.params, cache, toks)   # updated in place
        replayed = self._graph.replays - replays
        self.stats.decode_graph_replays += replayed
        if on:
            tr.then("serve.decode.wait", graph=replayed)
        nxt = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).cpu().numpy()
        t2 = time.perf_counter()
        self.stats.decode_s += t2 - t0
        if on:
            tr.then("serve.emit", t2)
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
        if on:
            tr.close()

    def run_until_drained(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()
        return self.stats
