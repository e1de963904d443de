"""The port's fleet planner and fleet runtime against the JAX package's.

Every case of tests/test_fleet.py that runs in one process is here,
asserting what the reference asserts, against the port on the CPU; each
also plans or runs the same fleet with the JAX package and compares with
no tolerance: decisions, notes, emissions, capacity reports and
``FleetStats`` (all but ``plan_time_s`` and ``compiles``, which read the
clock and each package's process-wide compile cache), and for
``FleetRuntime`` every tick record field but the timings and
``compiles``, the final assignments, the ledger, the bills and the
watchtower's alerts.  ``compiles`` is held to the warm rule: a warm
replan and warm ticks record none.  The metrics-endpoint cases run
against ``repro_torch.obs``.

Beyond the reference's cases: float fleets (``emission_weight=0.3``),
a sparse waterfill fleet whose shared S ``_fleet_dims`` bumps, a warm
start the waterfill rejects, chunked fleets with phantom apps, a
degenerate app, ``FleetRuntime`` under each coupling, under faults and
with per-tenant SLOs, and ``plan_branches`` with per-row tensors against
separate calls.
"""
import dataclasses
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import repro.continuum as jcontinuum
import repro.faults as jfaults
import repro.fleet as jfleet
import repro.obs as jobs
import repro_torch.continuum as tcontinuum
import repro_torch.faults as tfaults
import repro_torch.fleet as tfleet
import repro_torch.obs as tobs
from repro.core.lowering import ScenarioBatch
from repro.core.problem import BucketSpec as JBucket
from repro.core.problem import PlacementProblem
from repro.core.scheduler import GreenScheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JSchedConfig
from repro.core.types import Application
from repro_torch.core import scheduler as tscheduler
from repro_torch.core.problem import PlacementProblem as TProblem
from repro_torch.core.scheduler import GreenScheduler as TScheduler
from repro_torch.core.scheduler import SchedulerConfig as TSchedConfig
from repro_torch.fleet import planner as tplanner
from repro_torch.obs.registry import MetricsRegistry, metrics_scope

from test_fleet import _fleet_problems, _shared_infra, _tenant_app
from test_sparse_lowering import synth_dyadic
from test_torch_continuum import TIMING
from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)

DYADIC, FLOAT = 0.25, 0.3       # emission weights (test_fleet.py's _sched)


def _scheds(emission_weight=DYADIC):
    return (JScheduler(JSchedConfig(emission_weight=emission_weight)),
            TScheduler(TSchedConfig(emission_weight=emission_weight),
                       device="cpu"))


def _fleets(probs, **kw):
    """The same FleetProblem in both packages."""
    return (jfleet.FleetProblem(apps=tuple(probs), **kw),
            tfleet.FleetProblem(apps=tuple(to_port(list(probs))), **kw))


def plan_both(probs, emission_weight=DYADIC, bucket=None, **kw):
    """plan_many of one fleet with the JAX package and, carried across,
    with the port on the CPU."""
    jf, tf = _fleets(probs, **kw)
    js, ts = _scheds(emission_weight)
    opts = {} if bucket is None else dict(bucket=bucket)
    jres = jfleet.plan_many(jf, js, **opts)
    if bucket is not None:
        opts["bucket"] = to_port(bucket)
    tres = tfleet.plan_many(tf, ts, **opts)
    assert_same_fleet(jres, tres)
    return jres, tres


def _stats(stats):
    d = stats.to_dict()
    d.pop("plan_time_s")
    d.pop("compiles")
    return d


def _assert_same_capacity(a, b):
    assert b.node_ids == a.node_ids
    for name in ("cpu_load", "ram_load", "cpu_cap", "ram_cap"):
        x, y = getattr(a, name), getattr(b, name)
        assert y.dtype == x.dtype, name
        np.testing.assert_array_equal(y, x, err_msg=name)
    assert b.violations == a.violations
    assert b.summary() == a.summary()


def assert_same_fleet(jres, tres):
    """Decisions, notes, emissions, capacity and stats, no tolerance."""
    assert tres.coupling == jres.coupling
    assert len(tres) == len(jres)
    for i, (a, b) in enumerate(zip(jres.results, tres.results)):
        assert to_port(a.plans) == b.plans, i
        for name in ("placed", "fcur", "ncur", "emissions_g"):
            x, y = getattr(a, name), getattr(b, name)
            assert y.dtype == x.dtype and y.shape == x.shape, (i, name)
            np.testing.assert_array_equal(y, x, err_msg=f"{i} {name}")
        assert (a.stats is None) == (b.stats is None), i
        if a.stats is not None:
            for name in ("backend", "shape", "padded_shape", "signature",
                         "bucketed"):
                assert getattr(b.stats, name) == getattr(a.stats, name), \
                    (i, name)
    np.testing.assert_array_equal(tres.emissions_g, jres.emissions_g)
    assert tres.total_emissions_g == jres.total_emissions_g
    assert tres.feasible.tolist() == jres.feasible.tolist()
    assert tres.assignments() == jres.assignments()
    assert tres.infeasible_apps() == jres.infeasible_apps()
    _assert_same_capacity(jres.capacity, tres.capacity)
    assert _stats(tres.stats) == _stats(jres.stats)


def _assert_same_plan(pf, sf, tag=""):
    assert pf.feasible == sf.feasible, tag
    assert pf.notes == sf.notes, tag
    if pf.feasible:
        assert pf.placements == sf.placements, tag
        assert pf.skipped_services == sf.skipped_services, tag
        assert pf.total_emissions_g == sf.total_emissions_g, tag


# ---------------------------------------------------------------------------
# uncoupled parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_uncoupled_matches_sequential(backend):
    probs, names = _fleet_problems(5, backend=backend)
    _, res = plan_both(probs, names=names)
    _, sched = _scheds()
    seq = [sched.plan(p) for p in to_port(probs)]
    assert len(res) == 5
    for nm, r, s in zip(names, res.results, seq):
        _assert_same_plan(r.plans[0], s.plans[0], nm)
        if r.plans[0].feasible:
            assert float(r.emissions_g[0]) == float(s.emissions_g[0]), nm
    finite = np.isfinite(res.emissions_g)
    assert finite.tolist() == res.feasible.tolist()
    assert res.stats.calls >= 1
    assert res.stats.apps == 5
    assert res.stats.devices == 1 and not res.stats.sharded


def test_single_app_fleet_matches_plan():
    probs, _ = _fleet_problems(1)
    _, sched = _scheds()
    solo = sched.plan(to_port(probs[0]))
    _, res = plan_both(probs[:1])
    _assert_same_plan(res.results[0].plans[0], solo.plans[0])
    assert res.fleet.names == ("app0",)
    st = res.results[0].stats
    assert st.device == "cpu" and st.greedy_steps == st.padded_shape[1]
    assert st.local_search_steps == solo.stats.local_search_steps


def test_empty_fleet():
    _, res = plan_both(())
    assert len(res) == 0
    assert res.total_emissions_g == 0.0
    assert res.capacity.violations == 0
    assert res.assignments() == {}


# ---------------------------------------------------------------------------
# coupled capacity
# ---------------------------------------------------------------------------


def test_waterfill_never_overcommits():
    probs, names = _fleet_problems(5)
    prio = tuple(float(5 - i) for i in range(5))
    _, res = plan_both(probs, names=names, priority=prio,
                       coupling="waterfill")
    cap = res.capacity
    assert cap.violations == 0
    assert (cap.cpu_load <= cap.cpu_cap + 1e-9).all()
    assert (cap.ram_load <= cap.ram_cap + 1e-9).all()
    _, unc = plan_both(probs, names=names)
    assert unc.capacity.violations > 0
    top = res.fleet.waterfill_order()[0]
    _, sched = _scheds()
    solo = sched.plan(to_port(probs[top]))
    _assert_same_plan(res.results[top].plans[0], solo.plans[0], "top")


def test_waterfill_priority_reorders_winners():
    probs, names = _fleet_problems(3)
    _, lo = plan_both(probs, names=names, priority=(3.0, 2.0, 1.0),
                      coupling="waterfill")
    _, hi = plan_both(probs, names=names, priority=(1.0, 2.0, 3.0),
                      coupling="waterfill")
    assert lo.fleet.waterfill_order() == [0, 1, 2]
    assert hi.fleet.waterfill_order() == [2, 1, 0]
    assert lo.capacity.violations == 0
    assert hi.capacity.violations == 0


def test_price_coupling_reports_residuals():
    probs, names = _fleet_problems(4)
    _, res = plan_both(probs, names=names, coupling="price", price_rounds=3)
    assert res.coupling == "price"
    assert 1 <= res.stats.price_rounds <= 3
    assert res.capacity.violations >= 0
    for r in res.results:
        assert r.plans[0] is not None


@pytest.mark.parametrize("coupling", ["none", "waterfill", "price"])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_float_fleet_matches(backend, coupling):
    """Float objective terms (emission weight 0.3): the port's batched
    rows still take the JAX program's bits."""
    probs, names = _fleet_problems(5, backend=backend, base_seed=2000)
    prio = tuple(float(i % 3) for i in range(5))
    _, res = plan_both(probs, FLOAT, names=names, priority=prio,
                       coupling=coupling)
    if coupling == "waterfill":
        assert res.capacity.violations == 0


def test_sparse_waterfill_bumps_the_shared_s():
    """An app sitting on its S bucket boundary (S=8) with exactly its
    bucket's 8 COO edges needs no phantom edge alone, but the fleet's
    padded L is 16: ``_fleet_dims`` bumps the shared S one bucket so the
    phantom edges point at a phantom service."""
    _, infra, _, _, _ = synth_dyadic(0)
    probs = []
    for seed, S, links in ((3004, 8, 8), (3001, 6, 14), (3002, 7, 9)):
        app, _, comp, comm, cs = synth_dyadic(
            seed, n_services=S, n_links=links)
        probs.append(PlacementProblem.build(app, infra, comp, comm, cs,
                                            backend="sparse"))
    tprobs = to_port(probs)
    bucket = tplanner.BucketSpec()
    per_app = [bucket.pad_dims(p.lowering.S, p.lowering.F, p.lowering.N,
                               p.lowering.comm.n_links, 1)[0]
               for p in tprobs]
    dims = tplanner._fleet_dims(tprobs, bucket)
    assert tprobs[0].lowering.comm.n_links == 8 and per_app[0] == 8
    assert dims[0] > max(per_app)
    _, res = plan_both(probs, coupling="waterfill")
    assert res.capacity.violations == 0
    assert all(r.stats.padded_shape[1:] == dims for r in res.results)


def test_waterfill_rejects_warm_starts_taken_by_predecessors():
    """Each app warm-started from its own uncoupled plan: once the
    higher-priority tenants have claimed the room, a later warm start no
    longer fits the remaining capacity and is rebuilt from scratch."""
    probs, names = _fleet_problems(5)
    js, _ = _scheds()
    unc = jfleet.plan_many(jfleet.FleetProblem(apps=tuple(probs)), js)
    warm = [p.with_warm_start(r.assignment(0)) if r.plans[0].feasible
            else p for p, r in zip(probs, unc.results)]
    _, res = plan_both(warm, names=names,
                       priority=tuple(float(5 - i) for i in range(5)),
                       coupling="waterfill")
    notes = [r.plans[0].notes for r in res.results]
    assert any(tplanner._WF_WARM_NOTE in n for n in notes)
    assert res.capacity.violations == 0


@pytest.mark.parametrize("coupling", ["none", "waterfill", "price"])
def test_chunked_fleet_with_phantom_apps(coupling):
    """max_batch=4 over 9 apps, the app axis padded to 4: the last chunk
    of each group carries inert phantom apps."""
    probs, names = _fleet_problems(9)
    jf, tf = _fleets(probs, names=names, coupling=coupling, price_rounds=2)
    js, ts = _scheds()
    jres = jfleet.plan_many(jf, js, bucket=JBucket(a=(4,)), max_batch=4)
    res = tfleet.plan_many(tf, ts, bucket=to_port(JBucket(a=(4,))),
                           max_batch=4)
    assert_same_fleet(jres, res)
    assert res.stats.padded_apps > 0
    assert res.stats.calls > res.stats.groups


@pytest.mark.parametrize("coupling", ["none", "waterfill"])
def test_degenerate_app_takes_the_host_path(coupling):
    probs, _ = _fleet_problems(3)
    _, infra, _, _, _ = synth_dyadic(0)
    empty = PlacementProblem.build(Application("empty", ()), infra, {}, {},
                                   [])
    _, res = plan_both(probs[:1] + [empty] + probs[1:], coupling=coupling)
    r = res.results[1]
    assert r.plans[0].feasible and r.plans[0].placements == ()
    assert r.stats is None


# ---------------------------------------------------------------------------
# compile-cache economics
# ---------------------------------------------------------------------------


def test_warm_fleet_replan_compiles_nothing():
    probs, names = _fleet_problems(4)
    _, sched = _scheds()
    fleet = tfleet.FleetProblem(apps=tuple(to_port(probs)), names=names)
    tfleet.plan_many(fleet, sched)
    with metrics_scope() as scope:
        res = tfleet.plan_many(fleet, sched)
    assert scope.delta("planner.compile.misses") == 0
    assert scope.delta("planner.compile.calls") == res.stats.calls
    assert res.stats.compiles == 0

    wf = tfleet.FleetProblem(apps=tuple(to_port(probs)), names=names,
                             coupling="waterfill")
    tfleet.plan_many(wf, sched)
    with metrics_scope() as scope:
        res2 = tfleet.plan_many(wf, sched)
    assert scope.delta("planner.compile.misses") == 0
    assert res2.stats.compiles == 0


# ---------------------------------------------------------------------------
# validation and the device rule
# ---------------------------------------------------------------------------


def test_fleet_validation_errors():
    probs, names = _fleet_problems(2)
    probs = to_port(probs)
    FP = tfleet.FleetProblem
    with pytest.raises(ValueError, match="unknown coupling"):
        FP(apps=tuple(probs), coupling="auction")
    with pytest.raises(ValueError, match="unique"):
        FP(apps=tuple(probs), names=("a", "a"))
    with pytest.raises(ValueError, match="2 names for"):
        FP(apps=(probs[0],), names=names)
    with pytest.raises(ValueError, match="priorities for"):
        FP(apps=tuple(probs), priority=(1.0,))
    with pytest.raises(ValueError, match="ScenarioBatch"):
        FP(apps=(probs[0].with_scenarios(to_port(ScenarioBatch(
            ci=np.ones((2, probs[0].lowering.N))))), probs[1]))
    _, other_infra, _, _, _ = synth_dyadic(77)
    app, _, comp, comm, cs = synth_dyadic(1001, n_services=6)
    alien = TProblem.build(*to_port((app, other_infra, comp, comm, cs)))
    with pytest.raises(ValueError, match="share one Infrastructure"):
        FP(apps=(probs[0], alien))


def test_plan_many_without_a_card_raises(monkeypatch):
    """The default scheduler plans on the card, and there is none."""
    probs, _ = _fleet_problems(2)
    fleet = tfleet.FleetProblem(apps=tuple(to_port(probs)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfleet.plan_many(fleet)


# ---------------------------------------------------------------------------
# plan_branches with per-row problem tensors
# ---------------------------------------------------------------------------


def _rows(backend):
    """The per-row arguments of one fleet chunk (float inputs, apps of
    different real sizes padded to one shape) as plan_many stacks
    them, on the CPU."""
    probs, _ = _fleet_problems(8, backend=backend, base_seed=2000)
    cfg = TSchedConfig(emission_weight=FLOAT)
    bucket = tplanner.BucketSpec()
    groups = {}
    for i, p in enumerate(to_port(probs)):
        prep = tplanner._prep_app(i, p, cfg, bucket)
        groups.setdefault(prep.dims, []).append(prep)
    preps = max(groups.values(), key=len)
    assert len(preps) >= 3 and len({p.low.S for p in preps}) > 1
    shared, stacked = tplanner._chunk_args(preps, len(preps), None)
    (ci, ci_mean, cpu_cap, ram_cap, cost), rows = tplanner._on_device(
        backend, shared, stacked, torch.device("cpu"))
    ms = rows[-1].clone()
    ms[1] = 3                       # one row stops early
    return (backend, ci, ci_mean, cpu_cap, ram_cap, cost, rows[:-1], cfg,
            ms)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        dataclasses.astuple(a), dataclasses.astuple(b)))


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_plan_branches_rows_equal_separate_calls(backend):
    """A stacked problems in one call equal A separate B=1 calls bit for
    bit, each row at its own local-search bound."""
    kind, ci, ci_mean, cpu_cap, ram_cap, cost, rows, cfg, ms = \
        _rows(backend)
    infra = (ci, ci_mean, cpu_cap, ram_cap, cost)
    out = tplanner._plan_rows(kind, *infra, rows, cfg, cfg.green_penalty,
                              ms)
    assert out[6][1] == 3
    for i in range(rows[0].shape[0]):
        alone = tplanner._plan_rows(kind, *infra, [r[i:i + 1] for r in rows],
                                    cfg, cfg.green_penalty, int(ms[i]))
        for k, (got, want) in enumerate(zip(out, alone)):
            np.testing.assert_array_equal(got[i:i + 1], want,
                                          err_msg=f"row {i} output {k}")


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_plan_branches_shared_form_is_the_expanded_one(backend):
    """One app's tensors shared by three branches (the form
    GreenScheduler.plan passes) give the bits of their explicit
    per-row copies."""
    kind, ci, ci_mean, cpu_cap, ram_cap, cost, rows, cfg, ms = \
        _rows(backend)
    B = 3
    scale = torch.tensor([[1.0], [0.75], [1.5]], dtype=torch.float64)
    ci_b = ci * scale
    head = [r[0:1].expand(B, *r.shape[1:]) for r in rows[:2]]
    shared = [r[0] for r in rows[2:]]
    argc = 2 if kind == "dense" else 4

    def call(tail, steps):
        P, A, sf, cpur, ramr, must = tail[5 + argc:]
        return tscheduler.plan_branches(
            kind, ci_b, torch.full((B,), ci_mean, dtype=torch.float64),
            *head, *tail[:5], tuple(tail[5:5 + argc]), P, A, sf, cpur,
            ramr, cpu_cap, ram_cap, must, cost, cfg.money_weight,
            cfg.pref_weight, cfg.emission_weight, cfg.green_penalty, steps)

    want = call(shared, int(ms[0]))
    copies = [x.expand(B, *x.shape).clone() for x in shared]
    assert _same(call(copies, int(ms[0])), want)
    assert _same(call(copies, ms[0].expand(B).clone()), want)


# ---------------------------------------------------------------------------
# fleet runtime + per-tenant billing
# ---------------------------------------------------------------------------


def _tenants(pkg, n=3, hours=24, seed=3):
    """test_fleet.py's tenants in package ``pkg`` (its continuum and
    fleet modules): tenant i runs 3 + i services."""
    cont, fleet = pkg
    out = []
    for i in range(n):
        app = _tenant_app(f"t{i}", 3 + i)
        if cont is tcontinuum:
            app = to_port(app)
        out.append(fleet.FleetApp(
            f"tenant{i}", app, cont.WorkloadTrace(app, seed=i, noise=0.0),
            priority=float(n - i)))
    return out, cont.CarbonTrace(cont.REGION_PRESETS, hours=hours, seed=seed)


def runtime_pair(coupling="waterfill", n=3, hours=24, faults=None,
                 watch=None, **cfg):
    """The same FleetRuntime in both packages, observed; the port's on
    the CPU."""
    infra = _shared_infra()
    out = []
    for pkg, f_mod, o_mod in (((jcontinuum, jfleet), jfaults, jobs),
                              ((tcontinuum, tfleet), tfaults, tobs)):
        fas, carbon = _tenants(pkg, n, hours)
        inf = infra if pkg[0] is jcontinuum else to_port(infra)
        config = pkg[0].RuntimeConfig(
            horizon_h=4, faults=faults(f_mod, inf) if faults else None,
            **cfg)
        kw = dict(coupling=coupling, obs=o_mod.Observability(),
                  watch=watch(o_mod) if watch else None)
        if pkg[0] is tcontinuum:
            kw["device"] = "cpu"
        out.append(pkg[1].FleetRuntime(fas, inf, carbon, config=config,
                                       **kw))
    return out


def _record(rec):
    d = dataclasses.asdict(rec)
    for k in TIMING + ("compiles",):
        d.pop(k)
    return d


def _alerts(watch):
    return [(a.t, a.name, a.source, a.target, a.zone, a.value)
            for a in watch.alerts]


def assert_same_fleet_run(j, t, jres, tres):
    assert len(tres.ticks) == len(jres.ticks)
    for a, b in zip(jres.ticks, tres.ticks):
        assert b.t == a.t
        assert {k: _record(r) for k, r in b.records.items()} == \
            {k: _record(r) for k, r in a.records.items()}, a.t
        _assert_same_capacity(a.capacity, b.capacity)
        _assert_same_capacity(a.planned_capacity, b.planned_capacity)
        assert _stats(b.plan_stats) == _stats(a.plan_stats)
        assert (b.emissions_g, b.migration_g, b.violations) == \
            (a.emissions_g, a.migration_g, a.violations)
    assert sorted(tres.results) == sorted(jres.results)
    for name, a in jres.results.items():
        b = tres.results[name]
        assert b.final_assignment == a.final_assignment, name
        assert [_record(r) for r in b.ticks] == \
            [_record(r) for r in a.ticks], name
    assert tres.summary() == jres.summary()
    assert tres.total_emissions_g == jres.total_emissions_g
    jl, tl = j.obs.ledger, t.obs.ledger
    assert len(tl.entries) == len(jl.entries)
    for a, b in zip(jl.entries, tl.entries):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(y, x, err_msg=f.name)
            else:
                assert y == to_port(x), f.name
    assert tobs.billing_report(tl) == jobs.billing_report(jl)
    assert tobs.render_billing(tobs.billing_report(tl)) == \
        jobs.render_billing(jobs.billing_report(jl))
    assert t.placement_violations == to_port(j.placement_violations)
    if j.watch is not None:
        assert _alerts(t.watch) == _alerts(j.watch)
        assert t.watch.report() == j.watch.report()


def _plain_sum(values):
    """Left-to-right float sum, the ledger's order (the builtin ``sum``
    of Python 3.12 compensates its rounding, so it may differ)."""
    total = 0.0
    for v in values:
        total += v
    return total


def _assert_bills_decompose(frt, res):
    rep = tobs.billing_report(frt.obs.ledger)
    assert set(rep) == set(res.results)
    for name, r in res.results.items():
        acct = _plain_sum(t.emissions_g + t.migration_g for t in r.ticks)
        assert rep[name]["total"] == acct, name
        assert rep[name]["ticks"] == float(len(r.ticks))
    return rep


def test_fleet_runtime_waterfill_and_billing():
    j, t = runtime_pair()
    jres, res = j.run(0, 3), t.run(0, 3)
    assert_same_fleet_run(j, t, jres, res)

    assert len(res.ticks) == 3
    assert set(res.results) == {"tenant0", "tenant1", "tenant2"}
    for fr in res.ticks:
        assert fr.planned_capacity.violations == 0
        assert fr.capacity.violations == 0
    # warm ticks plan only shapes tick 0 planned
    assert res.ticks[1].compiles == 0
    assert res.ticks[2].compiles == 0
    assert res.total_emissions_g > 0
    for name, r in res.results.items():
        assert len(r.ticks) == 3
        assert all(tk.replanned for tk in r.ticks)
    rep = _assert_bills_decompose(t, res)
    assert sum(rep[n]["total"] for n in res.results) == sum(
        sum(tk.emissions_g + tk.migration_g for tk in r.ticks)
        for r in res.results.values())
    table = tobs.render_billing(rep)
    assert "tenant0" in table and "total_g" in table
    summary = res.summary()
    assert summary["apps"] == 3
    assert summary["violations"] == 0


@pytest.mark.parametrize("coupling", ["none", "price"])
def test_fleet_runtime_other_couplings_match(coupling):
    j, t = runtime_pair(coupling)
    jres, res = j.run(0, 4), t.run(0, 4)
    assert_same_fleet_run(j, t, jres, res)
    _assert_bills_decompose(t, res)
    assert all(fr.compiles == 0 for fr in res.ticks[1:])


def _faults(f_mod, infra):
    return f_mod.FaultTrace.generate(
        [n.node_id for n in infra.nodes],
        ("solar-south", "wind-north", "coal-east"), 24, seed=0,
        capacity_derates=1)


def test_faulty_fleet_matches():
    """Outages, a zone blackout and a capacity derate under the shared
    infrastructure: evictions, emergencies (the whole fleet adopts its
    coupled plan at once) and the summed-load capacity check."""
    j, t = runtime_pair(hours=48, faults=_faults, emergency_replan=True)
    jres, res = j.run(0, 24), t.run(0, 24)
    assert_same_fleet_run(j, t, jres, res)
    recs = [r for fr in res.ticks for r in fr.records.values()]
    assert any(r.emergency for r in recs)
    assert any(r.evicted for r in recs)
    for fr in res.ticks:
        if any(r.emergency for r in fr.records.values()):
            assert all(r.emergency for r in fr.records.values())
    assert sum(fr.violations for fr in res.ticks) == 0
    _assert_bills_decompose(t, res)
    assert [e for e in t.obs.registry.events
            if e["name"] == "fault.emergency_replan"]


def _tenant_slos(o):
    return o.Watchtower(slos=(
        [o.SLO(f"tenant{i}-budget", "carbon_budget", target=40.0 * (i + 1),
               window_h=6, tenant=f"tenant{i}") for i in range(3)]
        + [o.SLO("fleet-budget", "carbon_budget", target=150.0,
                 window_h=6)]))


def test_fleet_watchtower_with_tenant_slos_matches():
    j, t = runtime_pair(hours=32, watch=_tenant_slos)
    jres, res = j.run(0, 8), t.run(0, 8)
    assert_same_fleet_run(j, t, jres, res)
    assert t.watch.alerts
    rep = _assert_bills_decompose(t, res)
    for name in res.results:
        assert t.watch.slo.spent(f"{name}-budget") == rep[name]["total"]


def test_fleet_runtime_rejects_duplicate_names():
    infra = to_port(_shared_infra())
    carbon = tcontinuum.CarbonTrace(tcontinuum.REGION_PRESETS, hours=4,
                                    seed=0)
    app = to_port(_tenant_app("x", 2))
    wl = tcontinuum.WorkloadTrace(app, seed=0)
    with pytest.raises(ValueError, match="unique"):
        tfleet.FleetRuntime([tfleet.FleetApp("a", app, wl),
                             tfleet.FleetApp("a", app, wl)],
                            infra, carbon, device="cpu")


# ---------------------------------------------------------------------------
# metrics endpoint (repro_torch.obs.serve_metrics)
# ---------------------------------------------------------------------------


def test_serve_metrics_scrapes_live_registry():
    reg = MetricsRegistry()
    reg.inc("fleet.test.counter", 3.0)
    with tobs.serve_metrics(reg, port=0) as server:
        url = f"http://127.0.0.1:{server.port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        assert "repro_fleet_test_counter_total 3\n" in body
        reg.inc("fleet.test.counter", 1.0)
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        assert "repro_fleet_test_counter_total 4\n" in body
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=1)


def test_serve_metrics_fixed_port_retries_until_free():
    reg = MetricsRegistry()
    reg.inc("fleet.test.counter", 7.0)
    first = tobs.serve_metrics(reg, port=0)
    port = first.port
    closer = threading.Timer(0.15, first.close)
    closer.start()
    try:
        second = tobs.serve_metrics(reg, port=port, retries=10,
                                    backoff_s=0.02)
    finally:
        closer.join()
    try:
        assert second.port == port
        url = f"http://127.0.0.1:{port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        assert "repro_fleet_test_counter_total 7\n" in body
    finally:
        second.close()


def test_serve_metrics_fixed_port_exhausts_retries():
    reg = MetricsRegistry()
    with tobs.serve_metrics(reg, port=0) as first:
        t0 = time.perf_counter()
        with pytest.raises(OSError):
            tobs.serve_metrics(reg, port=first.port, retries=2,
                               backoff_s=0.01)
        assert time.perf_counter() - t0 >= 0.03


def test_metrics_server_close_is_idempotent():
    reg = MetricsRegistry()
    server = tobs.serve_metrics(reg, port=0)
    server.close()
    server.close()
