"""The serving engine's and the MoE block's spans (``repro_torch.obs.trace.TRACER``)
on a reduced granite-moe config on the CPU: the span tree, the partition of
``EngineStats``' clocks, the off path, the profiler gate and
``Tracer.leaves``."""
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import ARCHS
from repro_torch.models.config import CellTuning
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.obs.trace import TRACER, Tracer
from repro_torch.serve import Request, ServeEngine

MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
PARENT = {
    "serve.tick": None,
    "serve.admit": "serve.tick",
    "serve.prefill.enqueue": "serve.admit",
    "serve.write_slot": "serve.prefill.enqueue",
    "serve.prefill.wait": "serve.admit",
    "serve.decode.enqueue": "serve.tick",
    "serve.decode.wait": "serve.tick",
    "serve.emit": "serve.tick",
}


@pytest.fixture(scope="module")
def moe_setup():
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    return cfg, init_from_schema(0, build_schema(cfg), torch.float32, "cpu")


@pytest.fixture(autouse=True)
def fresh_tracer():
    TRACER.enabled = False
    TRACER.clear()
    yield
    TRACER.enabled = False
    TRACER.clear()


def _serve(setup, *, rows=False, sizes=(9, 11, 7, 5), slots=2, max_new=3):
    """Serve ``sizes`` prompts to the end (more requests than slots, so
    some wait in the queue); returns the engine, the requests and the
    clock read before the first and after the last tick."""
    cfg, params = setup
    engine = ServeEngine(cfg, params, slots=slots, max_len=32, device="cpu",
                         tuning=CellTuning(compute_dtype="float32", moe_row_dispatch=rows))
    rng = np.random.default_rng(7)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(sizes)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_drained()
    return engine, reqs, t0, time.perf_counter()


@pytest.mark.parametrize("rows", [False, True], ids=["global", "rows"])
def test_span_tree(moe_setup, rows):
    TRACER.enabled = True
    engine, reqs, t0, t1 = _serve(moe_setup, rows=rows)
    spans = TRACER.spans
    by_id = {s.span_id: s for s in spans}
    names = Counter(s.name for s in spans)
    L = moe_setup[0].n_layers
    assert names["serve.tick"] == engine.stats.ticks
    assert names["serve.admit"] == engine.stats.admitted == len(reqs)
    assert names["serve.decode.enqueue"] == names["serve.decode.wait"] \
        == names["serve.emit"] == sum(1 for s in TRACER.by_name("serve.tick") if s.attrs["live"])
    assert set(names) == set(PARENT) | set(MOE) | {"layer.attn"}
    for s in spans:
        assert t0 <= s.t0 <= s.t1 <= t1
        parent = by_id.get(s.parent)
        if s.name in PARENT:
            assert (parent.name if parent else None) == PARENT[s.name], s
        else:       # the model's spans sit directly under a step's enqueue
            assert parent.name in ("serve.prefill.enqueue", "serve.decode.enqueue"), s
        if parent is not None:
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    for step in TRACER.by_name("serve.prefill.enqueue") + TRACER.by_name("serve.decode.enqueue"):
        kids = Counter(c.name for c in TRACER.children(step.span_id))
        assert all(kids[n] == L for n in MOE + ("layer.attn",)), kids
    # each admission's attributes, and its wait from submit() to its prefill
    for admit in TRACER.by_name("serve.admit"):
        req = reqs[admit.attrs["request_id"]]
        (enq,) = [c for c in TRACER.children(admit.span_id) if c.name == "serve.prefill.enqueue"]
        assert admit.attrs["prompt_len"] == len(req.prompt)
        assert admit.attrs["queued_s"] == enq.t0 - req.submitted_s >= 0
    assert sorted(s.attrs["slot"] for s in TRACER.by_name("serve.admit")) == [0, 0, 1, 1]
    ticks = TRACER.by_name("serve.tick")
    assert sum(s.attrs["admitted"] for s in ticks) == len(reqs)
    assert sum(s.attrs["live"] for s in ticks) == engine.stats.decoded_tokens
    assert all(s.attrs["slots"] == 2 and s.attrs["live"] <= 2 for s in ticks)
    assert ticks[0].attrs["queued"] == len(reqs)


def test_step_spans_partition_engine_clocks(moe_setup):
    TRACER.enabled = True
    engine, *_ = _serve(moe_setup)

    def total(*names):
        return sum(s.t1 - s.t0 for n in names for s in TRACER.by_name(n))

    assert abs(total("serve.prefill.enqueue", "serve.prefill.wait") - engine.stats.prefill_s) < 1e-6
    assert abs(total("serve.decode.enqueue", "serve.decode.wait") - engine.stats.decode_s) < 1e-6
    # each step's two spans meet: the enqueue ends where the wait starts
    for enq_name, wait_name in (("serve.prefill.enqueue", "serve.prefill.wait"),
                                ("serve.decode.enqueue", "serve.decode.wait")):
        for enq, wait in zip(TRACER.by_name(enq_name), TRACER.by_name(wait_name)):
            assert enq.t1 == wait.t0 and enq.parent == wait.parent


def test_tick_counts_the_keys_its_decode_step_attends_to(moe_setup, monkeypatch):
    """``serve.tick``'s ``kv_tokens``: the sum over every slot (free ones at
    position 0) of the step's kv_len, ``slot_pos + 1``, read before the step
    advances the positions; 0 on a tick without a step."""
    seen = []
    step = ServeEngine._step

    def counted(self, occupied, on):
        seen.append(int((self.slot_pos + 1).sum()))
        return step(self, occupied, on)

    monkeypatch.setattr(ServeEngine, "_step", counted)
    TRACER.enabled = True
    engine, *_ = _serve(moe_setup, sizes=(9, 11, 7, 5, 3), slots=3, max_new=4)
    ticks = TRACER.by_name("serve.tick")
    assert [s.attrs["kv_tokens"] for s in ticks if s.attrs["live"]] == seen
    assert all(s.attrs["kv_tokens"] == 0 for s in ticks if not s.attrs["live"])
    assert len(seen) == engine.stats.ticks and min(seen) > engine.slots


def test_off_records_nothing_and_serves_the_same_tokens(moe_setup):
    _, off, *_ = _serve(moe_setup)
    assert TRACER.spans == [] and not TRACER.on
    TRACER.enabled = True
    _, on, *_ = _serve(moe_setup)
    assert TRACER.spans
    assert [r.generated for r in off] == [r.generated for r in on]


def test_a_profiler_turns_the_spans_on(moe_setup):
    with profile(activities=[ProfilerActivity.CPU]):
        engine, *_ = _serve(moe_setup, sizes=(6, 8))
    assert not TRACER.enabled and not TRACER.on      # settled when the tick ended
    assert len(TRACER.by_name("serve.tick")) == engine.stats.ticks
    assert len(TRACER.by_name("moe.route")) == moe_setup[0].n_layers * (
        engine.stats.admitted + len(TRACER.by_name("serve.decode.enqueue")))
    n = len(TRACER.spans)
    _serve(moe_setup, sizes=(6,))                     # the profiler has stopped
    assert len(TRACER.spans) == n


def test_leaves_partition_the_root_spans(moe_setup):
    TRACER.enabled = True
    _serve(moe_setup)
    leaves = TRACER.leaves()
    assert all(a[2] <= b[1] for a, b in zip(leaves, leaves[1:]))       # in order, disjoint
    assert all(t0 < t1 for _, t0, t1 in leaves)
    roots = TRACER.by_name("serve.tick")
    assert sum(t1 - t0 for _, t0, t1 in leaves) == pytest.approx(
        sum(s.t1 - s.t0 for s in roots), abs=1e-9)
    # a span's share of the leaves is its self time: its length less its children's
    by_name = Counter()
    for name, t0, t1 in leaves:
        by_name[name] += t1 - t0
    for name in ("serve.tick", "serve.prefill.enqueue", "moe.experts", "serve.decode.wait"):
        self_s = sum(s.t1 - s.t0 - sum(c.t1 - c.t0 for c in TRACER.children(s.span_id))
                     for s in TRACER.by_name(name))
        assert by_name[name] == pytest.approx(self_s, abs=1e-9)


def test_leaves_charge_the_innermost_span():
    t = Tracer()
    a = t.add("a", 0.0, 10.0)
    b = t.add("b", 2.0, 4.0, parent=a)
    t.add("c", 3.0, 3.5, parent=b)
    t.add("d", 6.0, 7.0, parent=a)
    t.add("e", 12.0, 13.0)
    assert t.leaves() == [("a", 0.0, 2.0), ("b", 2.0, 3.0), ("c", 3.0, 3.5), ("b", 3.5, 4.0),
                          ("a", 4.0, 6.0), ("d", 6.0, 7.0), ("a", 7.0, 10.0),
                          ("e", 12.0, 13.0)]


def test_span_off_path_allocates_nothing():
    t = Tracer(enabled=False)
    assert t.span("a") is t.span("b", k=1)            # one shared no-op context
    with t.span("a") as sid:
        assert sid is None
    assert t.add("a", 0.0, 1.0) == -1 and t.spans == []
    t.enabled = True
    with t.span("outer", t0=3, t1=4) as outer:
        with t.span("inner"):
            pass
    assert [(s.name, s.parent) for s in t.spans] == [("inner", outer), ("outer", None)]
    assert t.spans[1].attrs == {"t0": 3, "t1": 4}
    assert Tracer.from_jsonl(t.to_jsonl()) == t.spans
