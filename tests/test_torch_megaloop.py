"""The port's fused trace replay against the JAX package's, on the CPU.

``ContinuumRuntime.run_scanned`` stages the whole trace on the host and
rolls the decision tick over it on the scheduler's device.  Each case runs
the same trace three times: the reference's ``run_scanned`` (one
``jit(lax.scan)``), the port's ``run_scanned`` and the port's eager
``run`` (the port's pipeline and planner on ``device="cpu"``).

* Port replay against the port's eager loop: every ``TickRecord`` field
  but the wall-clock timings and ``compiles``, the final assignment and
  the learned KB are equal with no tolerance (the replay prices plans in
  numpy's summation order, so even ``expected_saving_g`` carries the
  eager loop's bits).
* Port replay against the reference replay, under the reference's own
  contract (tests/test_megaloop.py, test_faults.py, test_observability.py,
  test_watch.py): the records of ``_records``, the eviction fields, the
  final assignment and the KB with no tolerance, ``expected_saving_g``
  within ``atol 1e-9`` (XLA's reductions are not numpy's), Monte Carlo
  totals within ``rel 1e-12``, the detector lanes within 1e-12; ledger,
  spans, events and alerts equal; fallbacks with the same reason string.

The reference's replay imports ``jax.experimental.enable_x64``; the
``x64`` fixture of tests/test_torch_planner.py aliases it per test.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.continuum as jcontinuum
import repro.faults as jfaults
import repro.obs as jobs
import repro_torch.continuum as tcontinuum
import repro_torch.faults as tfaults
import repro_torch.obs as tobs
from repro.core.library import ConstraintLibrary as JLibrary
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
from repro.core.scheduler import GreenScheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JSchedConfig
from repro_torch.configs.synth import synth
from repro_torch.continuum import megaloop
from repro_torch.core import scheduler as tscheduler
from repro_torch.core.library import ConstraintLibrary as TLibrary
from repro_torch.core.lowering import ScenarioBatch
from repro_torch.core.pipeline import GreenConstraintPipeline as TPipeline
from repro_torch.core.problem import PlacementProblem
from repro_torch.core.scheduler import GreenScheduler as TScheduler
from repro_torch.core.scheduler import SchedulerConfig as TSchedConfig

from test_megaloop import START, _DriftingWorkload, _records, _scenario
from test_torch_continuum import _strip, fan_in_scenario
from test_torch_faults_obs import (
    _derate_events,
    _outage_events,
    _strip_event,
    _untimed,
)
from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)
from test_watch import _SpikedCarbon

REGIONS = ("solar-south", "wind-north", "coal-east")
PKGS = {
    "ref": (jcontinuum, jfaults, jobs, JPipeline, JScheduler, JSchedConfig,
            JLibrary, {}),
    "port": (tcontinuum, tfaults, tobs, TPipeline, TScheduler, TSchedConfig,
             TLibrary, dict(device="cpu")),
}


def _make(pkg, app, infra, ticks, seed=0, batch_library=False, faults=None,
          observed=False, watch=None, **cfg):
    """tests/test_megaloop.py's ``_runtime`` in package ``pkg``: the
    port's pipeline and planner on the CPU.  ``faults`` and ``watch``
    build their objects from the package's modules."""
    (cont, flt, obs, Pipeline, Scheduler, SchedConfig, Library,
     dev) = PKGS[pkg]
    if pkg == "port":
        app, infra = to_port(app), to_port(infra)
    config = dict(scenarios=4, hysteresis_g=30.0)
    config.update(cfg)
    if faults is not None:
        config["faults"] = flt.FaultTrace.from_events(
            [n.node_id for n in infra.nodes], REGIONS, START + ticks,
            faults(flt.FaultEvent))
    pipe_kw = dict(dev)
    if batch_library:
        pipe_kw["library"] = Library.with_batch_extension()
    rt = cont.ContinuumRuntime(
        app, infra,
        cont.CarbonTrace(cont.REGION_PRESETS, hours=START + ticks + 25,
                         seed=seed),
        cont.WorkloadTrace(app, seed=seed),
        config=cont.RuntimeConfig(**config), pipeline=Pipeline(**pipe_kw),
        planner=cont.WhatIfPlanner(Scheduler(
            SchedConfig(emission_weight=1.0), **dev)))
    if observed:
        rt.obs = obs.Observability()
    if watch is not None:
        rt.watch = watch(obs)
    return rt


def _trio(ticks, scenario_kw=None, **kw):
    """The reference runtime, the port's runtime for ``run_scanned`` and
    the port's runtime for eager ``run``, on identical traces."""
    app, infra = _scenario(**(scenario_kw or {}))
    return tuple(_make(pkg, app, infra, ticks, **kw)
                 for pkg in ("ref", "port", "port"))


def _kb(rt):
    kb = rt.pipeline.kb.to_kb()
    return (dict(kb.sk), dict(kb.ik), dict(kb.nk),
            [(k, sc.em, sc.mu, sc.t, sc.constraint)
             for k, sc in kb.ck.items()])


def _savings(result):
    return [r.expected_saving_g for r in result.ticks]


def _fault_fields(result):
    return [(r.evicted, r.emergency, r.violations) for r in result.ticks]


def assert_replay(j, ts, te, ticks, start=START, fallback=None):
    """Run the three runtimes over the trace and hold the port's replay
    to its eager loop (exact) and to the reference's replay."""
    jr = j.run_scanned(start, ticks)
    tr = ts.run_scanned(start, ticks)
    er = te.run(start, ticks)
    assert j.last_scanned_fallback == fallback
    assert ts.last_scanned_fallback == fallback
    assert [str(e.reason) for e in ts.scanned_fallbacks] == \
        [str(e.reason) for e in j.scanned_fallbacks]
    # the port's replay is its eager loop, bit for bit
    assert [_strip(r) for r in tr.ticks] == [_strip(r) for r in er.ticks]
    assert tr.final_assignment == er.final_assignment
    assert _kb(ts) == _kb(te)
    # the reference replay's own contract
    assert _records(tr) == _records(jr)
    assert _fault_fields(tr) == _fault_fields(jr)
    np.testing.assert_allclose(_savings(tr), _savings(jr), rtol=0,
                               atol=1e-9)
    assert tr.final_assignment == jr.final_assignment
    assert _kb(ts) == to_port(_kb(j))
    return jr, tr, er


# ---------------------------------------------------------------------------
# tests/test_megaloop.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_scanned_trace_matches(seed):
    j, ts, te = _trio(36, seed=seed)
    assert_replay(j, ts, te, 36)


@pytest.mark.parametrize("cfg_kw", [
    dict(oracle=True, hysteresis_g=0.0, horizon_h=1),
    dict(use_whatif=False),
    dict(use_kb=False),
    dict(replan_every=3),
    dict(warm_start=False),
    dict(replan_every=10 ** 9),        # static: plan once, coast
    dict(delta_replanning=False),
    dict(telemetry_window=4),          # pooled profile estimation
], ids=["oracle", "no_whatif", "no_kb", "replan3", "no_warm", "static",
        "no_delta", "window4"])
def test_config_variants_match(cfg_kw):
    j, ts, te = _trio(16, **cfg_kw)
    assert_replay(j, ts, te, 16)


def test_sparse_lowering_matches(monkeypatch):
    """The same trace lowered to the COO edge list (the auto threshold
    forced to 0 in both packages): the replay's sparse pricing."""
    import repro.core.lowering as jlowering
    import repro_torch.core.lowering as tlowering

    monkeypatch.setattr(jlowering, "SPARSE_AUTO_THRESHOLD", 0)
    monkeypatch.setattr(tlowering, "SPARSE_AUTO_THRESHOLD", 0)
    j, ts, te = _trio(16)
    assert_replay(j, ts, te, 16)
    assert ts.pipeline._lowering_cache[2].comm.kind == "sparse"


def test_timeshift_library_matches():
    """TimeShift constraints (batch-extension library) are staged
    natively and land in the KB as real objects."""
    j, ts, te = _trio(24, seed=1, batch_library=True,
                      scenario_kw=dict(delay_tolerance_h=6))
    assert_replay(j, ts, te, 24)
    kinds = {type(sc.constraint).__name__
             for sc in ts.pipeline.kb.to_kb().ck.values()}
    assert "TimeShift" in kinds


def test_scanned_then_eager_continues():
    """The commit hands the engine cache, lowering cache, KB and current
    assignment back: eager ticks after a replay continue exactly as an
    all-eager run, in the port as in the reference."""
    app, infra = _scenario()
    t_all = _make("port", app, infra, 30)
    t_mix = _make("port", app, infra, 30)
    j_mix = _make("ref", app, infra, 30)
    res_all = t_all.run(START, 30)
    t_mix.run_scanned(START, 24)
    j_mix.run_scanned(START, 24)
    tail = [t_mix.tick(START + 24 + i) for i in range(6)]
    jtail = [j_mix.tick(START + 24 + i) for i in range(6)]
    assert [_strip(r) for r in tail] == [_strip(r) for r in res_all.ticks[24:]]
    assert [_strip(r) for r in tail] == [_strip(r) for r in jtail]
    assert t_all.current == t_mix.current == j_mix.current
    assert _kb(t_mix) == _kb(t_all) == to_port(_kb(j_mix))


def test_structure_drift_falls_back_to_eager():
    j, ts, te = _trio(8)
    for rt in (j, ts, te):
        rt.workload = _DriftingWorkload(rt.workload, START + 3)
    assert_replay(j, ts, te, 8,
                  fallback="engine structural key drifted mid-trace")
    [ev] = ts.scanned_fallbacks
    assert ev.tick == START + 3 == j.scanned_fallbacks[0].tick
    assert ev.detail == j.scanned_fallbacks[0].detail


def test_steady_state_scan_compiles_once():
    """The port compiles nothing; its compile cache keeps the reference's
    accounting per device: the second replay of the same shapes on the
    same device records zero misses, the first at least one, and the
    fused-tick timing field is filled on every tick."""
    app, infra = _scenario()
    rt1, rt2 = (_make("port", app, infra, 11) for _ in range(2))
    before = tscheduler.compile_cache_stats()
    res1 = rt1.run_scanned(START, 11)
    mid = tscheduler.compile_cache_stats()
    res2 = rt2.run_scanned(START, 11)
    after = tscheduler.compile_cache_stats()
    assert mid["misses"] - before["misses"] >= 1
    assert after["misses"] - mid["misses"] == 0
    assert sum(r.compiles for r in res2.ticks) == 0
    assert sum(r.compiles for r in res1.ticks) == 1
    for res in (res1, res2):
        assert all(r.tick_fused_s > 0 for r in res.ticks)
    assert ("cpu", "megaloop", "dense", 11) == \
        next(s for s in tscheduler.COMPILE_CACHE.signatures
             if s[1] == "megaloop" and s[3] == 11)[:4]


def test_monte_carlo_emissions_matches(monkeypatch):
    """All realities in one batched planner call per planning tick; scale
    1.0 replays the deterministic trace; the reference's totals."""
    app, infra = _scenario()
    scales = [1.0, 0.8, 1.3]
    calls = []
    real = megaloop.plan_branches

    def spy(kind, ci, *args, **kw):
        calls.append(ci.shape[0])
        return real(kind, ci, *args, **kw)

    monkeypatch.setattr(megaloop, "plan_branches", spy)
    rt = _make("port", app, infra, 16)
    totals, per_tick = tcontinuum.monte_carlo_emissions(rt, START, 16,
                                                        scales)
    assert totals.shape == (3,) and per_tick.shape == (3, 16)
    mc_calls = list(calls)
    calls.clear()
    baseline = _make("port", app, infra, 16).run_scanned(START, 16)
    replans = sum(r.replanned for r in baseline.ticks)
    assert calls == [4] * replans
    assert mc_calls == [3 * 4] * replans
    assert totals[0] == pytest.approx(baseline.total_emissions_g, rel=1e-12)
    np.testing.assert_array_equal(
        per_tick[0], [r.emissions_g for r in baseline.ticks])
    # staging is read-only: the probed runtime is still fresh
    assert rt.pipeline.iteration == 0 and rt.current is None
    jtotals, jper_tick = jcontinuum.monte_carlo_emissions(
        _make("ref", app, infra, 16), START, 16, scales)
    np.testing.assert_allclose(totals, jtotals, rtol=1e-12, atol=0)
    np.testing.assert_allclose(per_tick, jper_tick, rtol=1e-12, atol=0)


def test_zero_ticks_is_a_no_op():
    app, infra = _scenario()
    rt = _make("port", app, infra, 4)
    res = rt.run_scanned(START, 0)
    assert res.ticks == [] and rt.current is None


def test_bench_scenario_168_tick_matches():
    """The continuum benchmark's week on its adaptive policy (B=8)."""
    from benchmarks.continuum_loop import build_scenario

    app, infra = build_scenario()
    j, ts, te = (_make(pkg, app, infra, 168, scenarios=8)
                 for pkg in ("ref", "port", "port"))
    assert_replay(j, ts, te, 168)


def test_fan_in_week_matches():
    """A day of the fan-in continuum (8 links into each service, dense):
    the replay's multi-term pair sums and the planner's."""
    app, infra = fan_in_scenario()
    j, ts, te = (_make(pkg, app, infra, 24, scenarios=8)
                 for pkg in ("ref", "port", "port"))
    assert_replay(j, ts, te, 24)
    low = ts.pipeline._lowering_cache[2]
    assert low.comm.kind == "dense" and low.comm.n_links == 8 * 12


# ---------------------------------------------------------------------------
# tests/test_faults.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emergency", [True, False])
def test_faulty_trace_matches(emergency):
    j, ts, te = _trio(24, scenario_kw=dict(n_services=6),
                      faults=_outage_events, emergency_replan=emergency)
    _, tr, _ = assert_replay(j, ts, te, 24)
    assert ts.scanned_fallbacks == []
    assert ts.placement_violations == [] == to_port(j.placement_violations)
    if emergency:
        assert any(r.emergency for r in tr.ticks)


def test_capacity_derate_falls_back_with_structured_reason():
    j, ts, te = _trio(16, scenario_kw=dict(n_services=6),
                      faults=_derate_events, observed=True)
    te.obs = None
    _, tr, _ = assert_replay(
        j, ts, te, 16, fallback=tcontinuum.FallbackReason.FAULT_CAPACITY_DERATE)
    [ev] = ts.scanned_fallbacks
    assert ev.reason is tcontinuum.FallbackReason.FAULT_CAPACITY_DERATE
    assert len(tr.ticks) == 16 and ts.placement_violations == []
    falls = [e for e in ts.obs.registry.events
             if e["name"] == "runtime.scanned_fallback"]
    assert len(falls) == 1
    assert ts.obs.registry.value("runtime.scanned_fallbacks") == 1.0
    assert_same_observed(j, ts)


def test_fallback_reasons_are_the_reference_closed_enum():
    """The replay raises only FallbackReason members, the same 15 reasons
    with the same strings as the reference's."""
    with pytest.raises(TypeError, match="FallbackReason"):
        megaloop._Fallback("some ad-hoc reason string")
    jreasons = {m.name: str(m) for m in jcontinuum.FallbackReason}
    treasons = {m.name: str(m) for m in tcontinuum.FallbackReason}
    assert treasons == jreasons and len(treasons) == 15
    fb = megaloop._Fallback(tcontinuum.FallbackReason.ENGINE_KEY_DRIFT,
                            tick=3, detail="a -> b")
    assert str(fb) == "engine structural key drifted mid-trace"
    assert (fb.tick, fb.detail) == (3, "a -> b")


def _event_counts(rt):
    named = {}
    for e in rt.obs.registry.events:
        named[e["name"]] = named.get(e["name"], 0) + 1
    return named


def test_fault_events_surface_exactly_once():
    j, ts, te = _trio(24, scenario_kw=dict(n_services=6),
                      faults=_outage_events, observed=True)
    assert_replay(j, ts, te, 24)
    eager, scanned = _event_counts(te), _event_counts(ts)
    assert eager["fault.node_outage"] == 2
    for name in ("fault.node_outage", "fault.zone_blackout",
                 "fault.telemetry_dropout", "fault.workload_spike",
                 "fault.emergency_replan"):
        assert scanned.get(name, 0) == eager.get(name, 0), name
    assert ts.obs.registry.value("runtime.evictions") == \
        te.obs.registry.value("runtime.evictions") > 0
    assert_same_observed(j, ts)


# ---------------------------------------------------------------------------
# tests/test_observability.py
# ---------------------------------------------------------------------------

SCAN_CUM = "scan.cum."


def assert_same_observed(j, t):
    """The ledger, spans, events, counters and gauges the two replays
    recorded (the in-scan accumulators within 1e-12: XLA's sums)."""
    jl, tl = j.obs.ledger, t.obs.ledger
    assert len(tl.entries) == len(jl.entries)
    for a, b in zip(jl.entries, tl.entries):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(y, x, err_msg=f.name)
            else:
                assert y == to_port(x), f.name
    assert tl.totals() == jl.totals()
    for view in ("by_service", "by_node", "by_zone"):
        assert getattr(tl, view)() == getattr(jl, view)(), view
    assert [(s.span_id, s.name, s.parent, s.attrs)
            for s in t.obs.tracer.spans] == \
        [(s.span_id, s.name, s.parent, s.attrs) for s in j.obs.tracer.spans]
    jr, tr = j.obs.registry, t.obs.registry
    assert [_strip_event(e) for e in tr.events] == \
        [_strip_event(e) for e in jr.events]
    assert _untimed(tr.counters()) == _untimed(jr.counters())
    jg, tg = _untimed(jr.gauges()), _untimed(tr.gauges())
    assert sorted(tg) == sorted(jg)
    for key, value in jg.items():
        if key[0].startswith(SCAN_CUM):
            assert tg[key] == pytest.approx(value, rel=1e-12, abs=1e-12)
        else:
            assert tg[key] == value, key
    assert sorted(_untimed(tr.histograms())) == \
        sorted(_untimed(jr.histograms()))


def _assert_ledger_is_records(obs, result):
    entries = obs.ledger.entries
    assert len(entries) == len(result.ticks)
    for e, r in zip(entries, result.ticks):
        assert (e.t, e.emissions_g, e.migration_g) == \
            (r.t, r.emissions_g, r.migration_g)
    em, mig = obs.ledger.totals()
    assert em == sum(r.emissions_g for r in result.ticks)
    assert mig == sum(r.migration_g for r in result.ticks)


def test_scanned_ledger_matches():
    j, ts, te = _trio(12, scenario_kw=dict(n_services=8), observed=True)
    _, tr, er = assert_replay(j, ts, te, 12)
    _assert_ledger_is_records(ts.obs, tr)
    assert_same_observed(j, ts)
    assert [(e.emissions_g, e.migration_g) for e in ts.obs.ledger.entries] \
        == [(e.emissions_g, e.migration_g) for e in te.obs.ledger.entries]
    reg = ts.obs.registry
    # the in-scan accumulator is the committed records' sum, bit for bit
    acc = 0.0
    for r in tr.ticks:
        acc = acc + r.emissions_g
    assert reg.value("scan.cum.emissions_g") == acc
    assert reg.value("runtime.migrations") == \
        sum(r.migrations for r in tr.ticks)
    assert [s.name for s in ts.obs.tracer.spans] == [
        "run_scanned", "scan.stage", "scan.fused", "scan.commit"]


def test_scanned_disabled_obs_adds_zero_carry_arrays(monkeypatch):
    """Without a registry the replay carries exactly the four decision
    arrays and 14 ys; a registry adds one of each, a watchtower one more
    to the scan, split off before the commit."""
    seen, fused = {}, {}
    orig, orig_fn = megaloop._commit, megaloop._scan_fn

    def spy(runtime, st, carry_out, ys, *a, **kw):
        seen["carry"], seen["ys"] = len(carry_out), len(ys)
        return orig(runtime, st, carry_out, ys, *a, **kw)

    def spy_fn(kind, with_metrics=False, with_watch=False):
        fn = orig_fn(kind, with_metrics=with_metrics, with_watch=with_watch)

        def wrapped(carry0, xs, consts, wconsts):
            carry_out, ys = fn(carry0, xs, consts, wconsts)
            fused["carry"], fused["ys"] = len(carry_out), len(ys)
            return carry_out, ys
        return wrapped

    monkeypatch.setattr(megaloop, "_commit", spy)
    monkeypatch.setattr(megaloop, "_scan_fn", spy_fn)
    app, infra = _scenario(n_services=8)
    cases = (
        (dict(), (4, 14), (4, 14)),
        (dict(observed=True), (5, 15), (5, 15)),
        (dict(watch=lambda o: o.Watchtower()), (5, 15), (4, 14)),
        (dict(observed=True, watch=lambda o: o.Watchtower()), (6, 16),
         (5, 15)),
    )
    for kw, in_scan, at_commit in cases:
        rt = _make("port", app, infra, 8, **kw)
        rt.run_scanned(START, 8)
        assert rt.last_scanned_fallback is None
        assert (fused["carry"], fused["ys"]) == in_scan
        assert (seen["carry"], seen["ys"]) == at_commit


def test_drift_fallback_records_event_and_matches():
    j, ts, te = _trio(8, observed=True)
    for rt in (j, ts, te):
        rt.workload = _DriftingWorkload(rt.workload, START + 3)
    _, tr, _ = assert_replay(
        j, ts, te, 8, fallback="engine structural key drifted mid-trace")
    [ev] = ts.scanned_fallbacks
    assert isinstance(ev, tcontinuum.FallbackEvent)
    [rev] = [e for e in ts.obs.registry.events
             if e["name"] == "runtime.scanned_fallback"]
    assert rev["tick"] == ev.tick and rev["reason"] == ev.reason
    _assert_ledger_is_records(ts.obs, tr)
    assert_same_observed(j, ts)


def test_jsonl_round_trip_carries_fault_events_and_emergency_ledger():
    events = lambda fe: [  # noqa: E731
        fe("node_outage", "wind-north-0", START + 6, 4),
        fe("capacity_derate", "wind-north-1", START + 8, 3, 0.5)]
    j, ts, te = _trio(16, scenario_kw=dict(n_services=6), faults=events,
                      observed=True)
    _, tr, _ = assert_replay(
        j, ts, te, 16,
        fallback=tcontinuum.FallbackReason.FAULT_CAPACITY_DERATE)
    assert any(r.evicted > 0 for r in tr.ticks)
    assert any(r.emergency for r in tr.ticks)
    back = tcontinuum.ContinuumResult.from_jsonl(tr.to_jsonl())
    assert back == tr
    assert_same_observed(j, ts)


# ---------------------------------------------------------------------------
# tests/test_watch.py
# ---------------------------------------------------------------------------

LANES = ("ci_mean", "ci_var", "e_mean", "e_var", "g_mean", "g_var", "cpos",
         "cneg")


def _alerts(watch):
    return [(a.t, a.name, a.source, a.target, a.zone, a.value)
            for a in watch.alerts]


def assert_same_watch(j, ts, te):
    """The replay's alerts, budget, detector state and store: equal to
    the port's eager watch with no tolerance, to the reference replay's
    within the reference's 1e-12 on the lanes."""
    assert _alerts(ts.watch) == _alerts(te.watch)
    assert ts.watch.alerts == to_port(j.watch.alerts)
    assert ts.watch.budget_spent_g == te.watch.budget_spent_g \
        == j.watch.budget_spent_g
    se, ss, sj = te.watch._state, ts.watch._state, j.watch._state
    assert (ss.n, ss.budget) == (se.n, se.budget) == (sj.n, sj.budget)
    for lane in LANES:
        np.testing.assert_array_equal(getattr(ss, lane), getattr(se, lane),
                                      err_msg=lane)
        np.testing.assert_allclose(getattr(ss, lane), getattr(sj, lane),
                                   rtol=1e-12, atol=1e-12, err_msg=lane)
    assert ts.watch.store.names() == te.watch.store.names()
    for name in te.watch.store.names():
        np.testing.assert_array_equal(ts.watch.store.window(name, 10 ** 6),
                                      te.watch.store.window(name, 10 ** 6))
    assert ts.watch.report() == te.watch.report()


def test_watched_replay_matches():
    watch = lambda o: o.Watchtower(slos=[o.SLO(  # noqa: E731
        "run-budget", "carbon_budget", target=1e9, window_h=24)])
    j, ts, te = _trio(18, scenario_kw=dict(n_services=6), watch=watch)
    _, tr, _ = assert_replay(j, ts, te, 18)
    assert_same_watch(j, ts, te)
    acc = 0.0
    for r in tr.ticks:
        acc = acc + (r.emissions_g + r.migration_g)
    assert ts.watch.budget_spent_g == acc == ts.watch.slo.spent("run-budget")


def test_fault_edges_alert_once_on_the_replay():
    events = lambda fe: [  # noqa: E731
        fe("node_outage", "wind-north-0", START + 8, 6),
        fe("zone_blackout", "wind-north", START + 12, 5),
        fe("telemetry_dropout", "", START + 20, 2)]
    j, ts, te = _trio(28, scenario_kw=dict(n_services=6), faults=events,
                      watch=lambda o: o.Watchtower())
    assert_replay(j, ts, te, 28)
    assert_same_watch(j, ts, te)
    by = {}
    for a in ts.watch.alerts:
        by.setdefault((a.name, a.target), []).append(a.t)
    assert by[("node_down", "wind-north-0")] == [START + 8]
    assert by[("feed_stale", "wind-north")] == [START + 12]
    assert by[("telemetry_stale", "")] == [START + 20]


def test_armed_watch_falls_back_loudly_and_matches():
    spike_t = START + 18
    j, ts, te = _trio(24, scenario_kw=dict(n_services=6),
                      watch=lambda o: o.Watchtower(o.WatchConfig(
                          mode="arm")))
    for rt in (j, ts, te):
        rt.carbon = _SpikedCarbon(rt.carbon, "wind-north", spike_t)
    ts.obs = tobs.Observability()
    _, tr, _ = assert_replay(j, ts, te, 24,
                             fallback=tcontinuum.FallbackReason.WATCH_ARMED)
    [ev] = ts.scanned_fallbacks
    assert ev.reason is tcontinuum.FallbackReason.WATCH_ARMED
    assert _alerts(ts.watch) == _alerts(te.watch)
    assert ts.watch.alerts == to_port(j.watch.alerts)
    assert any(r.evicted > 0 for r in tr.ticks)


# ---------------------------------------------------------------------------
# the planner's per-branch warm state, and the device rule
# ---------------------------------------------------------------------------


def _captured_plan_args(backend, monkeypatch):
    """The arguments ``GreenScheduler.plan`` hands ``plan_branches`` for a
    warm-started synthetic problem over three branches."""
    inputs = synth(24, 6, seed=2, links=3)
    problem = PlacementProblem.build(*inputs, backend=backend)
    sched = TScheduler(TSchedConfig(emission_weight=0.25), device="cpu")
    first = sched.plan(problem)
    assign = first.assignment(0)
    assign.pop(sorted(assign)[0])
    ci = problem.lowering.ci[None, :] * np.array([[1.0], [0.75], [1.5]])
    seen = []
    real = tscheduler.plan_branches

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(tscheduler, "plan_branches", spy)
    sched.plan(problem.with_scenarios(ScenarioBatch(ci=ci))
               .with_warm_start(assign))
    monkeypatch.setattr(tscheduler, "plan_branches", real)
    [args] = seen
    return list(args), first


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        dataclasses.astuple(a), dataclasses.astuple(b)))


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_plan_branches_per_branch_warm_state(backend, monkeypatch):
    """Warm state expanded to ``[B, S]`` / ``[B, N]`` gives the shared
    form's bits; branches with different warm states plan as each does
    alone (what each Monte Carlo reality's incumbent relies on)."""
    args, first = _captured_plan_args(backend, monkeypatch)
    B = args[1].shape[0]
    shared = tscheduler.plan_branches(*args)
    expanded = list(args)
    for i in range(5, 10):
        expanded[i] = args[i].expand(B, *args[i].shape).clone()
    assert _same(tscheduler.plan_branches(*expanded), shared)
    # branch 1 starts from scratch instead: the other branches keep the
    # shared form's results, branch 1 gets the cold plan's
    cold = list(args)
    cold[5:10] = [torch.zeros_like(a) for a in args[5:10]]
    alone = tscheduler.plan_branches(*cold)
    mixed = list(expanded)
    for i in range(5, 10):
        mixed[i] = expanded[i].clone()
        mixed[i][1] = cold[i]
    out = tscheduler.plan_branches(*mixed)
    for field in ("placed", "fcur", "ncur", "skipped", "infeas", "fail_s",
                  "ls_steps"):
        got, want = getattr(out, field), getattr(shared, field)
        assert torch.equal(got[[0, 2]], want[[0, 2]]), field
        assert torch.equal(got[1], getattr(alone, field)[1]), field


def test_run_scanned_without_a_card_raises(monkeypatch):
    """The replay runs on the scheduler's device: the default scheduler's
    is the card, and there is none here."""
    app, infra = _scenario()
    tapp, tinfra = to_port(app), to_port(infra)
    rt = tcontinuum.ContinuumRuntime(
        tapp, tinfra,
        tcontinuum.CarbonTrace(tcontinuum.REGION_PRESETS, hours=60, seed=0),
        tcontinuum.WorkloadTrace(tapp, seed=0),
        config=tcontinuum.RuntimeConfig(scenarios=4),
        pipeline=TPipeline(device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.run_scanned(START, 4)
    assert rt.last_scanned_fallback is None and rt.current is None
