"""Serving driver: ``repro_torch.serve.ServeEngine`` under a cell's traffic.

Set-up draws the weights on the device from the seed (the configuration's
reference module names them and their init), builds the engine at the
cell's ``engine`` sizes (``slots``, ``max_len``), and sends one warm
request at the mix's longest prompt.  The window then runs the traffic for
``--seconds``:

* open loop: requests are due on the schedule the generator draws; each
  is submitted at the first tick boundary at or after its due time, and
  timed from its due time;
* closed loop: ``clients`` clients each send their next request when the
  last one finished.  With ``in_flight`` the clients' first requests are
  admitted in set-up (one tick), so the window opens on a full engine.

Between submissions the driver calls ``engine.tick()`` (admit, then one
decode step for every slot) and reads the tokens each request gained.
A token is emitted when the tick that appended it returns.

After the window, the requests it finished are sampled (from the seed,
the longest always in) and the configuration's float32 reference scores
every served token by the gap by which its reference logit lies below the
reference's best there (0 where the served token is the reference's
first).  The number compared is the mean gap over every token checked:
a widest gap is set by the rarest near-tie, and swings too far from seed
to seed to tell a lower precision from the program's own.
With ``bench.control`` (a lower precision of the reference) the same
check also judges, in the program's place, the tokens the reference in
that precision puts first at the same positions.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.yardstick import traffic as gen
from portbench.yardstick.device import DeviceTrace, reduce
from portbench.yardstick.weights import draw


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` from a configuration file: ``ssm_<k>``
    keys fill its ``SSMConfig``, ``moe_<k>`` keys its ``MoEConfig``, the
    others its own fields."""
    from repro_torch.models.config import ArchConfig, Family, MoEConfig, SSMConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields and k not in ("family", "ssm", "moe")}
    ssm = {k[4:]: v for k, v in cfg.items() if k.startswith("ssm_")}
    moe = {k[4:]: v for k, v in cfg.items() if k.startswith("moe_")}
    return ArchConfig(family=Family(cfg["family"]), ssm=SSMConfig(**ssm) if ssm else None,
                      moe=MoEConfig(**moe) if moe else None, **kw)


class _Spans:
    """Host spans of the traced slice: wraps the engine's admission and its
    decode step while ``on``."""

    def __init__(self, engine):
        self.on = False
        self.spans: List = []
        for attr, name in (("_admit", "admit"), ("_decode", "decode")):
            setattr(engine, attr, self._wrap(getattr(engine, attr), name))

    def _wrap(self, fn, name):
        def timed(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return timed


def run(bench) -> Dict:
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import EngineStats, Request, ServeEngine

    cfg, cell, device = bench.config, bench.cell, bench.device
    ref = bench.reference
    traffic = cell["traffic"]
    weights = draw(ref.param_spec(cfg), bench.seed, device, getattr(torch, cfg["dtype"]))
    eng = cell["engine"]
    engine = ServeEngine(arch_config(cfg), weights, slots=eng["slots"], max_len=eng["max_len"],
                         tuning=CellTuning(compute_dtype=cfg["dtype"]), device=device)
    reqs = gen.requests(traffic, bench.seconds, bench.seed, cfg["vocab"])
    warm = np.random.default_rng([int(bench.seed) % (2 ** 64), 2]).integers(
        0, cfg["vocab"], size=int(traffic["prompt"]["max"]), dtype=np.int64)
    engine.submit(Request(-1, warm, max_new_tokens=2))
    engine.run_until_drained()
    first = []
    if traffic["loop"] == "closed" and traffic.get("in_flight"):
        first = [Request(r.index, r.prompt, max_new_tokens=r.max_new_tokens)
                 for r in reqs[:int(traffic["clients"])]]
        reqs = reqs[len(first):]
        for req in first:
            engine.submit(req)
        engine.tick()
    engine.stats = EngineStats()
    spans = _Spans(engine) if bench.trace else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    # no collector pauses inside the window: what set-up made is frozen,
    # and the window's garbage is freed by reference counts
    gc.collect()
    gc.freeze()
    gc.disable()
    bench.setup_done()
    try:
        out = _window(engine, reqs, traffic, bench, spans, first)
    finally:
        gc.enable()
        gc.unfreeze()
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    served = out.pop("served")
    engine = spans = None                      # the program's state goes first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.update(_check(served, weights, cfg, cell["correct"], ref, bench.seed, device,
                      bench.control))
    return out


def _window(engine, reqs, traffic, bench, spans, first=()) -> Dict:
    from repro_torch.serve import Request

    T = float(bench.seconds)
    open_loop = traffic["loop"] == "open"
    pending = list(reqs)                       # in send order
    live: List = []                            # submitted, not done
    info: Dict[int, Dict] = {}                 # request index -> timings
    served = []
    ticks = []
    tr = DeviceTrace() if bench.trace else None
    plan = bench.cell.get("trace", {})
    slice_at = T * plan.get("start_frac", 0.3)
    slice_s = plan.get("seconds", 6.0)
    slice_state = None

    def end_slice():
        slice_state.update(end=len(ticks), stats_end=dataclasses.replace(engine.stats),
                           ops=tr.stop())
        spans.on = False

    def submit(r, due):
        req = Request(r.index, r.prompt, max_new_tokens=r.max_new_tokens)
        engine.submit(req)
        live.append(req)
        info[r.index] = {"due": due, "times": []}
        served.append(req)

    for req in first:                          # admitted in set-up
        live.append(req)
        served.append(req)
        info[req.request_id] = {"due": None, "times": [None] * len(req.generated)}
    live[:] = [r for r in live if not r.done]
    t0 = time.perf_counter()
    if not open_loop:
        for _ in range(int(traffic["clients"]) - len(first)):
            if pending:
                submit(pending.pop(0), 0.0)
        for _ in range(len(first) - len(live)):    # done in set-up's tick
            if pending:
                submit(pending.pop(0), 0.0)
    while True:
        now = time.perf_counter() - t0
        if now >= T:
            break
        if tr is not None and slice_state is None and now >= slice_at:
            spans.on = True
            tr.start()
            slice_state = {"t": len(ticks), "stats": dataclasses.replace(engine.stats)}
        elif slice_state is not None and "end" not in slice_state and now >= slice_at + slice_s:
            end_slice()
        while open_loop and pending and pending[0].arrival_s <= now:
            r = pending.pop(0)
            submit(r, r.arrival_s)
        if not live:
            wait = (pending[0].arrival_s if pending else T) - now
            if spans is not None and spans.on:
                spans.spans.append(("wait", time.perf_counter(), time.perf_counter() + wait))
            time.sleep(max(0.0, min(wait, T - now)))
            continue
        queued = list(engine.queue)
        admitted0, tok0 = engine.stats.admitted, engine.stats.decoded_tokens
        engine.tick()
        t_end = time.perf_counter() - t0
        ticks.append({"admitted": [len(r.prompt) for r in queued[:engine.stats.admitted - admitted0]],
                      "decoded": engine.stats.decoded_tokens > tok0,
                      "live": engine.stats.decoded_tokens - tok0})
        for req in list(live):
            times = info[req.request_id]["times"]
            times.extend([t_end] * (len(req.generated) - len(times)))
            if req.done and not open_loop and pending:
                submit(pending.pop(0), t_end)
        live[:] = [r for r in live if not r.done]
    close = time.perf_counter() - t0
    if slice_state is not None and "end" not in slice_state:
        end_slice()

    ttft, itl, tokens = [], [], 0
    for rec in info.values():
        times = [t for t in rec["times"] if t is not None]    # in the window
        if rec["due"] is not None:
            ttft.append((times[0] if times else close) - rec["due"])
        itl.extend(np.diff(times).tolist())
        tokens += len(times)
    if open_loop:                   # due in the window, never sent
        ttft.extend(close - r.arrival_s for r in pending if r.arrival_s < T)
    backlog = len(engine.queue) + sum(1 for r in pending if open_loop and r.arrival_s < T)
    record = {"ttft_s": ttft, "itl_s": itl, "output_tokens": tokens, "window_s": close,
              "backlog_at_close": backlog,
              "due_ttft": sorted((rec["due"], (rec["times"][0] if rec["times"] else close)
                                  - rec["due"]) for rec in info.values()
                                 if rec["due"] is not None),
              "live_max": max((t["live"] for t in ticks), default=0)}
    if slice_state is not None:
        record["slice"] = _slice(slice_state, ticks, tr, spans.spans)
    return {"record": record, "attempted": len(ttft), "served": served}


def _slice(state, ticks, tr, host) -> Dict:
    inside = ticks[state["t"]:state["end"]]
    s0, s1 = state["stats"], state["stats_end"]
    dev = reduce(state["ops"], tr.t0, tr.t1, host)
    dev.update(ticks=len(inside), decode_ticks=sum(t["decoded"] for t in inside),
               admitted_prompts=[s for t in inside for s in t["admitted"]],
               prefill_s=s1.prefill_s - s0.prefill_s, decode_s=s1.decode_s - s0.decode_s)
    return dev


def _sample(finished, seed: int, want_tokens: int, most: int) -> List:
    """Finished requests to check: the longest (prompt and output), then a
    seeded draw of the rest until ``want_tokens`` served tokens or ``most``
    requests."""
    if not finished:
        return []
    finished = sorted(finished, key=lambda r: r.request_id)
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.generated), -r.request_id))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([int(seed) % (2 ** 64), 3]).permutation(len(rest))
    picked, n = [longest], len(longest.generated)
    for i in order:
        if n >= want_tokens or len(picked) >= most:
            break
        picked.append(rest[i])
        n += len(rest[i].generated)
    return picked


def _gaps(weights, cfg, ref, req, device, control=None) -> Dict:
    """Per served token of ``req``: the float32 reference's best logit less
    its logit for the token judged (0 where they agree), teacher-forced
    over the prompt and the served tokens.  ``"program"`` judges the served
    tokens; with ``control`` (a precision of the reference), ``"control"``
    judges the tokens the reference in that precision puts first at the
    same positions."""
    gen_tok = torch.as_tensor(np.asarray(req.generated, np.int64), device=device)
    if gen_tok.numel() and (gen_tok.min() < 0 or gen_tok.max() >= cfg["vocab"]):
        bad = torch.full((gen_tok.numel(),), float("inf"))
        return {"program": bad} if control is None else {"program": bad, "control": bad}
    toks = torch.cat([torch.as_tensor(np.asarray(req.prompt, np.int64), device=device),
                      gen_tok[:-1]])
    start = len(req.prompt) - 1
    lg = ref.logits(weights, cfg, toks, start)
    best = lg.max(-1).values
    out = {"program": (best - lg.gather(1, gen_tok[:, None])[:, 0]).cpu()}
    if control is not None:
        low = ref.logits(weights, cfg, toks, start, control).argmax(-1)
        out["control"] = (best - lg.gather(1, low[:, None])[:, 0]).cpu()
    return out


def _verdict(gaps: List, rule: Dict) -> Dict:
    """``correct``, ``failed`` and the numbers compared, of one side's
    per-request gaps: their mean over every token checked, and how many
    tokens were checked.  A request fails where its own mean is over the
    limit."""
    limit = rule["logit_gap_mean_limit"]
    checked = sum(g.numel() for g in gaps)
    mean = float(sum(float(g.sum()) for g in gaps) / checked) if checked else 0.0
    compared = {
        "logit_gap_mean": {"value": mean, "limit": limit},
        "tokens_checked": {"value": checked, "limit": rule["min_tokens_checked"]},
    }
    return {"correct": bool(mean <= limit and checked >= rule["min_tokens_checked"]),
            "failed": sum(int(g.numel() > 0 and float(g.mean()) > limit) for g in gaps),
            "compared": compared}


def _check(served, weights, cfg, rule, ref, seed, device, control=None) -> Dict:
    finished = [r for r in served if r.done]
    sample = _sample(finished, seed, rule["sample_tokens"], rule["sample_max_requests"])
    sides: Dict[str, List] = {"program": []} if control is None else \
        {"program": [], "control": []}
    for req in sample:
        for side, g in _gaps(weights, cfg, ref, req, device, control).items():
            sides[side].append(g)
    out = dict(_verdict(sides["program"], rule), finished=len(finished),
               gaps={k: [g.tolist() for g in v] for k, v in sides.items()})
    if control is not None:
        out["control"] = _verdict(sides["control"], rule)
    return out
