"""The port's faults, observability and watchtower against the JAX
package's, on the CPU.

Fault schedules, the degraded planning views and the placement validator
are numpy in both packages and must give the same arrays, events and
violations.  The eager loop under faults, with an ``Observability`` bundle
and a ``Watchtower`` attached, runs in both packages (the port's pipeline
and planner on ``device="cpu"``): tick records, final assignments,
placement violations, ledger entries and cells, span names and nesting,
registry events and counters, alerts, detector state and the report text
must all be equal, with no tolerance.  Wall-clock readings (span times,
stage histograms, event timestamps) and the planner's compile counts are
left out: each package's process-wide planner cache has seen other
problems.  The Prometheus exposition must equal the reference's golden
file.
"""
import dataclasses
import os
import types
import urllib.request

import numpy as np
import pytest

import repro.continuum as jcontinuum
import repro.faults as jfaults
import repro.obs as jobs
import repro_torch.continuum as tcontinuum
import repro_torch.faults as tfaults
import repro_torch.obs as tobs
from repro.obs import export as jexport
from repro_torch.obs import export as texport

from test_megaloop import START, _scenario
from test_torch_continuum import _strip, _zeroed, assert_same_run, runtimes
from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)
from test_watch import _SpikedCarbon

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "prometheus_golden.txt")
REGIONS = ("solar-south", "wind-north", "coal-east")
PKGS = ((jfaults, jobs, jcontinuum), (tfaults, tobs, tcontinuum))


def _both(fn):
    """``fn(faults, obs, continuum)`` in each package: (reference, port)."""
    return tuple(fn(*pkg) for pkg in PKGS)


def _raises(fn):
    try:
        fn()
    except (ValueError, TypeError, AssertionError) as exc:
        return type(exc).__name__, str(exc)
    return None


# ---------------------------------------------------------------------------
# fault schedules
# ---------------------------------------------------------------------------

GENERATE = {
    "outages5": (4, 96, dict(seed=3, node_outages=5)),
    "outages5_seed4": (4, 96, dict(seed=4, node_outages=5)),
    "short": (2, 10, dict(seed=0, telemetry_dropouts=1, zone_blackouts=1)),
    # the continuum phase of chip_smoke.py: its week under faults
    "week_derate": (6, 24 + 168, dict(seed=0, earliest=24,
                                      capacity_derates=1)),
}


def _assert_same_faults(j, t):
    for name in ("alive", "zone_dark", "telemetry_drop", "spike", "derate"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None, name
            continue
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert t.events == to_port(j.events)
    for tick in range(-1, j.ticks + 2):
        np.testing.assert_array_equal(t.alive_at(tick), j.alive_at(tick))
        np.testing.assert_array_equal(t.dark_at(tick), j.dark_at(tick))
        assert t.dropout_at(tick) == j.dropout_at(tick)
        assert t.spike_at(tick) == j.spike_at(tick)
        da, db = j.derate_at(tick), t.derate_at(tick)
        assert (da is None) == (db is None)
        if da is not None:
            np.testing.assert_array_equal(db, da)
        assert [t.staleness(z, tick) for z in t.zones] == \
            [j.staleness(z, tick) for z in j.zones]
        assert list(t.starting(tick)) == to_port(list(j.starting(tick)))


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_fault_trace_generate_matches(case):
    n, ticks, kw = GENERATE[case]
    ids = [f"n{i}" for i in range(n)]
    j, t = _both(lambda f, o, c: f.FaultTrace.generate(ids, REGIONS, ticks,
                                                       **kw))
    _assert_same_faults(j, t)
    assert t.alive.any(axis=1).all()


def _outage_events(FaultEvent):
    # tests/test_faults.py's events: outages on the zone the carbon
    # planner parks on, a blackout, a dropout and a spike
    return [
        FaultEvent("node_outage", "wind-north-0", START + 8, 6),
        FaultEvent("node_outage", "wind-north-1", START + 11, 3),
        FaultEvent("zone_blackout", "wind-north", START + 12, 5),
        FaultEvent("telemetry_dropout", "", START + 20, 2),
        FaultEvent("workload_spike", "", START + 18, 3, 2.0),
    ]


def _derate_events(FaultEvent):
    return [FaultEvent("capacity_derate", "wind-north-0", START + 5, 4, 0.5)]


def _node_ids():
    return [n.node_id for n in _scenario(n_services=2)[1].nodes]


def test_fault_trace_from_events_matches():
    j, t = _both(lambda f, o, c: f.FaultTrace.from_events(
        _node_ids(), REGIONS, START + 24,
        _outage_events(f.FaultEvent) + _derate_events(f.FaultEvent)))
    _assert_same_faults(j, t)


BAD_FAULTS = {
    "unknown_node": lambda f: f.FaultTrace.from_events(
        ["n0"], REGIONS, 8, [f.FaultEvent("node_outage", "nope", 1, 2)]),
    "unknown_kind": lambda f: f.FaultTrace.from_events(
        ["n0"], REGIONS, 8, [f.FaultEvent("meteor", "n0", 1, 2)]),
    "zero_derate": lambda f: f.FaultTrace.from_events(
        ["n0"], REGIONS, 8,
        [f.FaultEvent("capacity_derate", "n0", 1, 2, 0.0)]),
    "node_order": lambda f: f.FaultTrace.none(
        _node_ids()[::-1], REGIONS, 4).check_infra(
            _scenario(n_services=2)[1]),
}


@pytest.mark.parametrize("case", sorted(BAD_FAULTS))
def test_fault_trace_errors_match(case):
    j, t = _both(lambda f, o, c: _raises(lambda: BAD_FAULTS[case](f)))
    assert j is not None and t == j


# ---------------------------------------------------------------------------
# validator
# ---------------------------------------------------------------------------


def _toy_low():
    # tests/test_faults.py's tensor surface: S=2 x F=1, N=2
    return types.SimpleNamespace(
        S=2, N=2, service_ids=("a", "b"), node_ids=("n0", "n1"),
        flavour_names=(("f0",), ("f0",)),
        service_index=lambda: {"a": 0, "b": 1},
        node_index=lambda: {"n0": 0, "n1": 1},
        cpu_req=np.array([[2.0], [2.0]]), ram_req=np.array([[1.0], [1.0]]),
        cpu_cap=np.array([3.0, 3.0]), ram_cap=np.array([8.0, 8.0]))


VALIDATOR = {
    "over_capacity": (np.array([0, 0]), None),
    "dead_node": (np.array([0, 1]), np.array([True, False])),
    "clean": (np.array([0, 1]), np.array([True, True])),
}


@pytest.mark.parametrize("case", sorted(VALIDATOR))
def test_validator_matches(case):
    ncur, alive = VALIDATOR[case]
    placed, fcur = np.array([True, True]), np.zeros(2, np.int64)
    j, t = _both(lambda f, o, c: f.check_placement(
        _toy_low(), placed, fcur, ncur, alive=alive, t=5))
    assert t == to_port(j)
    assign = {"a": ("f0", "n0"), "b": ("f0", f"n{ncur[1]}")}
    ja, ta = _both(lambda f, o, c: f.check_assignment(
        _toy_low(), assign, alive=alive, t=5))
    assert ta == to_port(ja) == t
    je, te = _both(lambda f, o, c: _raises(lambda: f.assert_valid(
        f.check_placement(_toy_low(), placed, fcur, ncur, alive=alive))))
    assert te == je and (te is None) == (case == "clean")


# ---------------------------------------------------------------------------
# degraded views
# ---------------------------------------------------------------------------


def test_degraded_carbon_matches():
    def view(f, o, c):
        carbon = c.CarbonTrace(c.REGION_PRESETS, hours=48, seed=1)
        ft = f.FaultTrace.from_events(
            ["x"], REGIONS, 48,
            [f.FaultEvent("zone_blackout", "wind-north", 10, 6)])
        return f.DegradedCarbon(carbon, ft, widen_per_stale_h=0.5)

    j, t = _both(view)
    regions = ["wind-north", "coal-east", "solar-south", "wind-north"]
    for r in REGIONS:
        np.testing.assert_array_equal(t.series(r), j.series(r))
    for tick in (5, 10, 12, 15, 16, 20):
        for r in REGIONS:
            assert t.history_signal(tick)(r) == j.history_signal(tick)(r)
            assert t.forecast_signal(tick, 6)(r) == \
                j.forecast_signal(tick, 6)(r)
        for name, args in (("now", ()), ("future_matrix", (6,)),
                           ("scenario_matrix", (6, 8))):
            np.testing.assert_array_equal(
                getattr(t, name)(regions, tick, *args),
                getattr(j, name)(regions, tick, *args), err_msg=name)


def test_degraded_workload_matches():
    app = _scenario(n_services=3)[0]

    def view(f, o, c):
        a = app if c is jcontinuum else to_port(app)
        ft = f.FaultTrace.from_events(
            ["x"], REGIONS, 40,
            [f.FaultEvent("telemetry_dropout", "", 20, 3),
             f.FaultEvent("workload_spike", "", 8, 2, 2.0)])
        return f.DegradedWorkload(c.WorkloadTrace(a, seed=2), ft)

    j, t = _both(view)
    for tick in (7, 8, 9, 19, 20, 21, 22, 23, 24):
        # NaN samples compare by their repr (NaN != NaN)
        assert repr(t.monitoring(tick)) == repr(to_port(j.monitoring(tick)))
        assert t.clean(tick) == to_port(j.clean(tick))
        for window in (1, 2, 3):
            assert t.stale(tick, window) == j.stale(tick, window)
            assert t.lowering_monitoring(tick, window) == \
                to_port(j.lowering_monitoring(tick, window))


# ---------------------------------------------------------------------------
# the eager loop under faults, observed
# ---------------------------------------------------------------------------


def _strip_event(e):
    return {k: v for k, v in e.items() if k != "ts"}


def _untimed(metrics):
    """Registry counters/gauges that read no clock nor the compile cache."""
    return {k: v for k, v in metrics.items() if "compile" not in k[0]}


def assert_same_observed(j, t):
    """Everything an attached Observability bundle recorded."""
    jl, tl = j.obs.ledger, t.obs.ledger
    assert len(tl.entries) == len(jl.entries)
    for a, b in zip(jl.entries, tl.entries):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert y.dtype == x.dtype, f.name
                np.testing.assert_array_equal(y, x, err_msg=f.name)
            else:
                assert y == to_port(x), f.name
        assert list(b.cells()) == list(a.cells())
        assert (b.emissions_g, b.migration_g) == (a.emissions_g,
                                                 a.migration_g)
    assert tl.totals() == jl.totals()
    for view in ("by_service", "by_node", "by_zone"):
        assert getattr(tl, view)() == getattr(jl, view)(), view
    assert texport.billing_report(tl) == jexport.billing_report(jl)
    jt, tt = j.obs.tracer.spans, t.obs.tracer.spans
    assert [(s.span_id, s.name, s.parent, s.attrs) for s in tt] == \
        [(s.span_id, s.name, s.parent, s.attrs) for s in jt]
    jr, tr = j.obs.registry, t.obs.registry
    assert [_strip_event(e) for e in tr.events] == \
        [_strip_event(e) for e in jr.events]
    assert _untimed(tr.counters()) == _untimed(jr.counters())
    assert _untimed(tr.gauges()) == _untimed(jr.gauges())
    assert sorted(tr.histograms()) == sorted(jr.histograms())


def _runtime_pair(ticks, faults=None, observed=True, watch=None,
                  n_services=6, **cfg):
    """test_megaloop.py's ``_runtime`` in both packages, faults and
    observability attached."""
    app, infra = _scenario(n_services=n_services)
    config = dict(dict(scenarios=4, hysteresis_g=30.0), **cfg)
    j, t = runtimes(
        app, infra,
        lambda cls, p: cls(p, hours=START + ticks + 25, seed=0),
        lambda cls, a: cls(a, seed=0), config=config)
    if faults is not None:
        jf, tf = _both(lambda f, o, c: f.FaultTrace.from_events(
            [n.node_id for n in infra.nodes], REGIONS, START + ticks,
            faults(f.FaultEvent)))
        j.config.faults, t.config.faults = jf, tf
    if observed:
        j.obs, t.obs = jobs.Observability(), tobs.Observability()
    if watch is not None:
        j.watch, t.watch = watch(jobs), watch(tobs)
    return j, t


FAULTY = {
    "outages": (_outage_events, {}),
    "outages_no_emergency": (_outage_events, dict(emergency_replan=False)),
    "outages_frozen_gate": (lambda fe: _outage_events(fe)[:2],
                            dict(hysteresis_g=1e9)),
    "outages_frozen_gate_no_emergency": (lambda fe: _outage_events(fe)[:2],
                                         dict(hysteresis_g=1e9,
                                              emergency_replan=False)),
    "capacity_derate": (_derate_events, {}),
    "outage_and_derate": (lambda fe: [
        fe("node_outage", "wind-north-0", START + 6, 4),
        fe("capacity_derate", "wind-north-1", START + 8, 3, 0.5)], {}),
}


@pytest.mark.parametrize("case", sorted(FAULTY))
def test_faulty_run_matches(case):
    events, cfg = FAULTY[case]
    ticks = 24 if case.startswith("outages") else 16
    j, t = _runtime_pair(ticks, faults=events, **cfg)
    jres, tres = j.run(START, ticks), t.run(START, ticks)
    assert_same_run(jres, tres)
    assert t.placement_violations == to_port(j.placement_violations) == []
    assert_same_observed(j, t)
    if case == "outages":
        evicted = [r for r in tres.ticks if r.evicted]
        assert evicted and all(r.emergency and r.switched for r in evicted)
    if case == "outages_frozen_gate_no_emergency":
        assert len(tres.final_assignment) < 6


def test_generated_fault_week_matches():
    """The first 48 ticks of chip_smoke.py's faulty week: a generated
    schedule with a capacity derate, a watchtower and observability."""
    ticks = 48
    app, infra = _scenario(n_services=12)
    ids = [n.node_id for n in infra.nodes]
    j, t = runtimes(
        app, infra, lambda cls, p: cls(p, hours=START + ticks + 25, seed=0),
        lambda cls, a: cls(a, seed=0),
        config=dict(scenarios=4, hysteresis_g=30.0))
    j.config.faults, t.config.faults = _both(
        lambda f, o, c: f.FaultTrace.generate(
            ids, REGIONS, START + ticks, seed=1, earliest=START,
            node_outages=4, capacity_derates=1, outage_hours=(3, 8)))
    j.obs, t.obs = jobs.Observability(), tobs.Observability()
    j.watch, t.watch = jobs.Watchtower(), tobs.Watchtower()
    jres, tres = j.run(START, ticks), t.run(START, ticks)
    assert_same_run(jres, tres)
    assert_same_observed(j, t)
    assert_same_watch(j.watch, t.watch)
    assert t.placement_violations == []
    assert any(r.evicted for r in tres.ticks)


# ---------------------------------------------------------------------------
# exporters, spans, report
# ---------------------------------------------------------------------------


def _golden_registry(MetricsRegistry):
    """tests/test_observability.py's deterministic exposition registry."""
    reg = MetricsRegistry()
    reg.describe("planner.compile.hits", "counter",
                 help="planner cache hits")
    reg.inc("planner.compile.hits", 7)
    reg.inc("planner.compile.misses", 2)
    reg.inc("lowering.path", 3, labels={"path": "delta"})
    reg.inc("lowering.path", 1, labels={"path": "full"})
    reg.inc("watch.alerts", 1,
            labels={"name": 'zone "wind\\north"\nline2'})
    reg.gauge("engine.candidates", 120)
    reg.describe("stage.plan_s", "histogram", help="plan stage seconds",
                 buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.02, 0.02, 0.5):
        reg.observe("stage.plan_s", v)
    return reg


def _escaping_registry(MetricsRegistry):
    reg = MetricsRegistry()
    reg.describe("weird", "counter", help="multi\nline help")
    reg.inc("weird", 2, labels={"zone": 'wind "north"\nplus\\more'})
    return reg


def test_prometheus_text_equals_the_golden_file():
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert tobs.prometheus_text(_golden_registry(tobs.MetricsRegistry)) \
        == golden
    assert tobs.prometheus_text(_escaping_registry(tobs.MetricsRegistry)) \
        == jobs.prometheus_text(_escaping_registry(jobs.MetricsRegistry))
    for s in ('a\\b"c\nd', "\\n", "line1\nline2 \\x"):
        assert texport._escape_label(s) == jexport._escape_label(s)
        assert texport._escape_help(s) == jexport._escape_help(s)


def test_metrics_server_serves_the_exposition():
    reg = _golden_registry(tobs.MetricsRegistry)
    with tobs.serve_metrics(reg, port=0) as server:
        reg.inc("planner.compile.hits")     # read live on the next scrape
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            body = resp.read().decode()
    assert body == tobs.prometheus_text(reg)


def test_events_jsonl_matches_and_round_trips():
    def reg(o):
        r = o.MetricsRegistry()
        r.event("runtime.scanned_fallback", tick=31,
                reason="engine structural key drifted mid-trace",
                detail="abc -> def")
        r.event("custom", value=1.5)
        for e in r.events:
            e["ts"] = 1.0e9
        return r

    j, t = reg(jobs), reg(tobs)
    assert tobs.events_jsonl(t) == jobs.events_jsonl(j)
    assert tobs.events_from_jsonl(tobs.events_jsonl(t)) == t.events


def test_span_tracer_nesting_matches_and_round_trips():
    def spans(o):
        tr = o.Tracer()
        with tr.span("tick", t=3):
            with tr.span("constraints"):
                pass
            with tr.span("plan"):
                pass
        tr.add("late", 0.0, 1.0, parent=0, path="delta")
        return tr

    j, t = spans(jobs), spans(tobs)
    assert [(s.span_id, s.name, s.parent, s.attrs) for s in t.spans] == \
        [(s.span_id, s.name, s.parent, s.attrs) for s in j.spans]
    assert tobs.Tracer.from_jsonl(t.to_jsonl()) == t.spans
    off = tobs.Tracer(enabled=False)
    with off.span("tick"):
        pass
    assert off.add("x", 0.0, 1.0) == -1 and off.spans == []


def test_observed_run_ledger_spans_and_report_match():
    j, t = _runtime_pair(10, n_services=8)
    jres, tres = j.run(START, 10), t.run(START, 10)
    assert_same_run(jres, tres)
    assert_same_observed(j, t)
    # the audit report, with the wall-clock and compile fields zeroed
    # (its stage-latency section reads span times, so no tracer here)
    assert tobs.render_report(_zeroed(tres), ledger=t.obs.ledger,
                              registry=t.obs.registry) == \
        jobs.render_report(_zeroed(jres), ledger=j.obs.ledger,
                           registry=j.obs.registry)
    assert _zeroed(tres).render_report() == _zeroed(jres).render_report()
    txt = t.obs.report(tres)
    for section in ("Green audit: 10 ticks", "attribution (ledger)",
                    "stage latency", "svc0"):
        assert section in txt
    assert texport.render_billing(texport.billing_report(t.obs.ledger)) == \
        jexport.render_billing(jexport.billing_report(j.obs.ledger))
    # observability is a pure tap: the same decisions without it
    _, bare = _runtime_pair(10, n_services=8, observed=False)
    assert [_strip(r) for r in bare.run(START, 10).ticks] == \
        [_strip(r) for r in tres.ticks]


# ---------------------------------------------------------------------------
# watchtower: rings, SLOs, detectors, observe and arm
# ---------------------------------------------------------------------------


def test_series_ring_and_store_match():
    def drive(o):
        from importlib import import_module
        tsdb = import_module(o.__name__ + ".tsdb")
        r = tsdb.SeriesRing(capacity=4)
        for tick in range(10):
            r.append(tick, float(tick) * 2.0)
        v = tsdb.SeriesRing(capacity=8)
        v.append(0, np.arange(3, dtype=np.float64))
        v.append(1, np.ones(3))
        s = tsdb.TimeSeriesStore(capacity=16)
        s.record("burn", 5, 1.5, labels={"tenant": "t0", "slo": "x"})
        reg = o.MetricsRegistry()
        reg.inc("ticks", 3)
        reg.gauge("emissions_g", 41.5)
        s.capture_registry(7, reg)
        return (r.ts.tolist(), r.values.tolist(), r.last(2).tolist(),
                r.last(99).tolist(), v.values.tolist(), s.names(),
                s.window("burn", 4, labels={"slo": "x", "tenant": "t0"}
                         ).tolist(),
                s.window("counter.ticks", 1).tolist(),
                s.window("gauge.emissions_g", 1).tolist(),
                s.window("nope", 4).size,
                _raises(lambda: v.append(2, np.ones(4))),
                _raises(lambda: tsdb.SeriesRing(capacity=0)))

    j, t = _both(lambda f, o, c: drive(o))
    assert t == j


BAD_SLOS = {
    "kind": lambda o: o.SLO("x", "latency", 1.0),
    "target": lambda o: o.SLO("x", "carbon_budget", 0.0),
    "windows": lambda o: o.SLO("x", "carbon_budget", 1.0, fast_window_h=4,
                               slow_window_h=2),
    "window_h": lambda o: o.SLO("x", "carbon_budget", 1.0, window_h=0),
    "unique": lambda o: o.SLOEngine([o.SLO("x", "carbon_budget", 1.0),
                                     o.SLO("x", "churn_limit", 2.0)]),
    "mode": lambda o: o.WatchConfig(mode="panic"),
    "alpha": lambda o: o.WatchConfig(ewma_alpha=1.0),
}


@pytest.mark.parametrize("case", sorted(BAD_SLOS))
def test_slo_validation_matches(case):
    j, t = _both(lambda f, o, c: _raises(lambda: BAD_SLOS[case](o)))
    assert j is not None and t == j


def test_slo_burn_rates_match():
    def drive(o):
        eng = o.SLOEngine([o.SLO("budget", "carbon_budget", target=24.0,
                                 window_h=24, fast_window_h=1,
                                 slow_window_h=3, burn_threshold=2.5)])
        fired = []
        for tick, g in enumerate([0.5, 0.5, 0.5, 5.0, 5.0, 5.0, 0.1, 5.0]):
            fired += eng.observe(tick, consumption_g=g)
        kinds = o.SLOEngine([
            o.SLO("churn", "churn_limit", target=24.0, window_h=24,
                  slow_window_h=1),
            o.SLO("ci", "intensity_ceiling", target=300.0,
                  slow_window_h=1)])
        kinds.observe(0, consumption_g=999.0, ci_mean=450.0, migrations=2)
        scoped = o.SLOEngine([o.SLO("t1-budget", "carbon_budget",
                                    target=10.0, tenant="t1")])
        scoped.observe(0, consumption_g=5.0, tenant="")
        scoped.observe(0, consumption_g=3.0, tenant="t1")
        return (fired, eng.spent("budget"), eng.burn_rates("budget"),
                kinds.burn_rates("churn"), kinds.burn_rates("ci"),
                scoped.spent("t1-budget"), scoped.for_tenant("t1"))

    j, t = _both(lambda f, o, c: drive(o))
    assert [a.t for a in t[0]] == [4, 7]
    assert t == to_port(j)


def test_cusum_matches():
    def drive(o):
        w = o.Watchtower()
        low = types.SimpleNamespace(
            E=np.full((3, 2), 0.5), node_ids=("n0", "n1"),
            service_ids=("s0", "s1", "s2"))
        ci = np.array([100.0, 100.0])
        rec = lambda g: types.SimpleNamespace(  # noqa: E731
            emissions_g=g, migration_g=0.0, migrations=0)
        alerts = [w.observe_tick(tick, rec(100.0), low, None, None, ci)
                  for tick in range(30)]
        alerts += [w.observe_tick(tick, rec(200.0), low, None, None, ci)
                   for tick in (30, 31)]
        return w, alerts

    (jw, ja), (tw, ta) = _both(lambda f, o, c: drive(o))
    assert [a.name for a in ta[30]] == ["emissions_drift"]
    assert ta == to_port(ja)
    assert_same_watch(jw, tw)


def assert_same_watch(j, t):
    assert t.alerts == to_port(j.alerts)
    assert t.report() == j.report()
    assert t.budget_spent_g == j.budget_spent_g
    if j._state is not None:
        for a, b in zip(j._state.carry(), t._state.carry()):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert t.store.names() == j.store.names()
    for name in j.store.names():
        np.testing.assert_array_equal(t.store.window(name, 10 ** 6),
                                      j.store.window(name, 10 ** 6))


def _budget_watch(o):
    return o.Watchtower(slos=[o.SLO("run-budget", "carbon_budget",
                                    target=1e9, window_h=24)])


def test_observe_mode_is_a_tap_and_matches():
    ticks = 18
    j, t = _runtime_pair(ticks, observed=False, watch=_budget_watch)
    jres, tres = j.run(START, ticks), t.run(START, ticks)
    assert_same_run(jres, tres)
    assert_same_watch(j.watch, t.watch)
    _, bare = _runtime_pair(ticks, observed=False)
    assert [_strip(r) for r in bare.run(START, ticks).ticks] == \
        [_strip(r) for r in tres.ticks]
    acc = 0.0
    for r in tres.ticks:
        acc = acc + (r.emissions_g + r.migration_g)
    assert t.watch.budget_spent_g == acc == t.watch.slo.spent("run-budget")


def test_fault_edges_alert_once_and_match():
    ticks = 28
    events = lambda fe: [  # noqa: E731
        fe("node_outage", "wind-north-0", START + 8, 6),
        fe("zone_blackout", "wind-north", START + 12, 5),
        fe("telemetry_dropout", "", START + 20, 2)]
    j, t = _runtime_pair(ticks, faults=events,
                         watch=lambda o: o.Watchtower())
    assert_same_run(j.run(START, ticks), t.run(START, ticks))
    assert_same_watch(j.watch, t.watch)
    assert_same_observed(j, t)
    by = {}
    for a in t.watch.alerts:
        by.setdefault((a.name, a.target), []).append(a.t)
    assert by[("node_down", "wind-north-0")] == [START + 8]
    assert by[("feed_stale", "wind-north")] == [START + 12]
    assert by[("telemetry_stale", "")] == [START + 20]


@pytest.mark.parametrize("mode", ["observe", "arm"])
def test_spiked_zone_watch_matches(mode):
    """tests/test_watch.py's one-tick carbon spike: in arm mode the zone is
    evacuated through the emergency machinery."""
    ticks, spike_t = 24, START + 18
    j, t = _runtime_pair(ticks, observed=False,
                         watch=lambda o: o.Watchtower(o.WatchConfig(
                             mode=mode)))
    j.carbon = _SpikedCarbon(j.carbon, "wind-north", spike_t)
    t.carbon = _SpikedCarbon(t.carbon, "wind-north", spike_t)
    jres, tres = j.run(START, ticks), t.run(START, ticks)
    assert_same_run(jres, tres)
    assert_same_watch(j.watch, t.watch)
    assert t.placement_violations == []
    for dt in range(0, t.watch.config.evacuate_hold_h + 2):
        assert t.watch.evacuated_zones(spike_t + dt) == \
            j.watch.evacuated_zones(spike_t + dt)
    evac = next(r for r in tres.ticks if r.t == spike_t + 1)
    if mode == "arm":
        assert evac.evicted > 0 and evac.emergency and evac.switched
    else:
        assert all(r.evicted == 0 for r in tres.ticks)
