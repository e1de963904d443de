"""The port's continuum loop against the JAX package's, on the CPU.

The carbon and workload traces, the what-if planner and
``ContinuumRuntime.run`` are driven with the same inputs in both packages
(the port's pipeline and planner on ``device="cpu"``) and compared with no
tolerance: the traces are float64 numpy in both, the planner decides in
float64 and the ensemble pricing stays numpy on the host.  Every
``TickRecord`` field must be equal except the wall-clock timings and
``compiles`` (each package's process-wide planner cache has seen other
problems before), and so must the final assignment, ``summary()`` and
``to_jsonl()`` once those fields are zeroed.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.continuum import (
    REGION_PRESETS as J_PRESETS,
    CarbonTrace as JCarbon,
    ContinuumRuntime as JRuntime,
    RuntimeConfig as JConfig,
    WhatIfPlanner as JWhatIf,
    WorkloadTrace as JWorkload,
)
from repro.continuum import whatif as jwhatif
from repro.core.lowering import ScenarioBatch as JBatch
from repro.core.lowering import lower as jlower
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
from repro.core.problem import BucketSpec as JBucket
from repro.core.problem import PlacementProblem as JProblem
from repro.core.scheduler import GreenScheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JSchedConfig
from repro.core.types import (
    Application,
    Flavour,
    FlavourRequirements,
    Infrastructure,
    Node,
    NodeCapabilities,
    Service,
    ServiceRequirements,
    Subnet,
)
from repro_torch.continuum import (
    REGION_PRESETS as T_PRESETS,
    CarbonTrace as TCarbon,
    ContinuumResult as TResult,
    ContinuumRuntime as TRuntime,
    RuntimeConfig as TConfig,
    WhatIfPlanner as TWhatIf,
    WorkloadTrace as TWorkload,
)
from repro_torch.continuum import whatif as twhatif
from repro_torch.core.pipeline import GreenConstraintPipeline as TPipeline
from repro_torch.core.scheduler import GreenScheduler as TScheduler
from repro_torch.core.scheduler import SchedulerConfig as TSchedConfig

from benchmarks.continuum_loop import build_scenario
from test_continuum import _app, _infra
from test_scheduler_equivalence import synth
from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)

DATA = os.path.join(os.path.dirname(__file__), "data")
TIMING = ("rebuild_s", "replan_s", "constraint_s", "tick_fused_s")


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def test_region_presets_are_the_reference_ones():
    assert to_port(dict(J_PRESETS)) == dict(T_PRESETS)


def _assert_same_trace(j, t, ticks, horizon=6, B=5):
    assert sorted(t._series) == sorted(j._series)
    assert t.hours == j.hours
    regions = sorted(j._series)
    node_regions = (regions * 2)[:6]
    for r in regions:
        np.testing.assert_array_equal(t.series(r), j.series(r))
    for tick in ticks:
        for r in regions:
            assert t.history_signal(tick)(r) == j.history_signal(tick)(r)
            assert (t.forecast_signal(tick, horizon)(r)
                    == j.forecast_signal(tick, horizon)(r))
        for name, args in (("now", ()), ("future_matrix", (horizon,)),
                           ("scenario_matrix", (horizon, B))):
            a = getattr(j, name)(node_regions, tick, *args)
            b = getattr(t, name)(node_regions, tick, *args)
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("seed,hours", [(0, 80), (5, 120), (11, 217)])
def test_carbon_trace_matches(seed, hours):
    _assert_same_trace(JCarbon(J_PRESETS, hours=hours, seed=seed),
                       TCarbon(T_PRESETS, hours=hours, seed=seed),
                       ticks=(0, 23, 40, hours - 30))


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (9, dict(drift_per_h=0.01, noise=0.0)), (3, dict(noise=0.3))])
def test_workload_trace_monitoring_matches(seed, kw):
    app = build_scenario()[0]
    j = JWorkload(app, seed=seed, **kw)
    t = TWorkload(to_port(app), seed=seed, **kw)
    for tick in (0, 24, 30, 48, 200):
        assert t.monitoring(tick) == to_port(j.monitoring(tick))


# the from_csv cases of tests/test_carbon_csv.py: the text of a CSV file
# (or a committed fixture) and the keyword arguments it is read with
CSV_CASES = {
    "fixture": ("electricitymaps_sample.csv", {}),
    "gapped_aliased": ("electricitymaps_gapped.csv",
                       dict(aliases={"DE-LU": "DE"})),
    "gapped_raw": ("electricitymaps_gapped.csv", dict(fill_gaps=False)),
    "header_variants": (
        "timestamp,region,carbon_intensity\n"
        "2024-01-01T02:00:00,z1,300\n2024-01-01T00:00:00,z1,100\n"
        "2024-01-01T01:00:00,z1,200\n2024-01-01T00:00:00,z2,50\n"
        "2024-01-01T01:00:00,z2,\n2024-01-01T01:00:00,z2,60\n", {}),
    "ragged_starts": (
        "timestamp,zone,ci\n"
        "2024-01-01T00:00:00,A,10\n2024-01-01T01:00:00,A,11\n"
        "2024-01-01T02:00:00,A,12\n2024-01-01T03:00:00,A,13\n"
        "2024-01-01T02:00:00,B,20\n2024-01-01T03:00:00,B,21\n"
        "2024-01-01T04:00:00,B,22\n2024-01-01T05:00:00,B,23\n", {}),
    "epoch_gap": ("timestamp,zone,ci\n3600,A,10\n7200,A,20\n14400,A,40\n",
                  {}),
    "disjoint": ("timestamp,zone,ci\n2024-01-01T00:00:00,A,10\n"
                 "2024-01-02T00:00:00,B,20\n", {}),
    "no_timestamp": ("when,zone,carbon_intensity\nx,z,1\n", {}),
    "no_intensity": ("timestamp,zone,stuff\nx,z,1\n", {}),
    "alias_collision": ("timestamp,zone,ci\n2024-01-01T00:00:00,DE-LU,100\n"
                        "2024-01-01T00:00:00,DE,110\n",
                        dict(aliases={"DE-LU": "DE"})),
    "non_integer_gap": ("timestamp,zone,ci\n2024-01-01T00:00:00,A,10\n"
                        "2024-01-01T01:00:00,A,11\n"
                        "2024-01-01T03:30:00,A,12\n", {}),
}


def _from_csv(cls, path, kw):
    try:
        return cls.from_csv(path, **kw), None
    except ValueError as exc:
        return None, str(exc)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_carbon_trace_from_csv_matches(case, tmp_path):
    text, kw = CSV_CASES[case]
    if text.endswith(".csv"):
        path = os.path.join(DATA, text)
    else:
        path = str(tmp_path / f"{case}.csv")
        with open(path, "w") as fh:
            fh.write(text)
    (j, jerr), (t, terr) = (_from_csv(JCarbon, path, kw),
                            _from_csv(TCarbon, path, kw))
    assert terr == jerr
    if j is not None:
        _assert_same_trace(j, t, ticks=range(min(j.hours, 31)),
                           horizon=3, B=4)


# ---------------------------------------------------------------------------
# what-if planning
# ---------------------------------------------------------------------------


def _ci_batch(N, B, seed):
    # tests/test_whatif.py's exactly-representable branch intensities
    return np.random.default_rng(seed).integers(64, 40000, size=(B, N)) / 64.0


def _jsched(cfg=None):
    return JScheduler(cfg or JSchedConfig(emission_weight=1.0))


def _tsched(cfg=None):
    return TScheduler(cfg or TSchedConfig(emission_weight=1.0), device="cpu")


def _assert_same_whatif(jr, tr):
    assert [to_port(p) for p in jr.plans] == tr.plans
    for name in ("emissions_g", "expected_g"):
        a, b = getattr(jr, name), getattr(tr, name)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert tr.best_index == jr.best_index
    assert tr.best_expected_g == jr.best_expected_g


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("path", ["evaluate", "evaluate_sequential"])
def test_whatif_matches(seed, path):
    app, infra, comp, comm, cs = synth(seed)
    low = jlower(app, infra, comp, comm)
    jproblem = JProblem(lowering=low, constraints=tuple(cs)).with_scenarios(
        JBatch(ci=_ci_batch(low.N, 5, seed)))
    jr = getattr(JWhatIf(_jsched()), path)(jproblem)
    tr = getattr(TWhatIf(_tsched()), path)(to_port(jproblem))
    _assert_same_whatif(jr, tr)
    if path == "evaluate":
        assert tr.plan_stats.device == "cpu"
        # batched and sequential agree within the port as well
        ts = TWhatIf(_tsched()).evaluate_sequential(to_port(jproblem))
        assert tr.best_index == ts.best_index
        assert [p.placements for p in tr.plans] == \
            [p.placements for p in ts.plans]


def _feasible_synth():
    for seed in range(10):
        app, infra, comp, comm, cs = synth(seed)
        plan = JScheduler(JSchedConfig.green()).plan(
            JProblem.build(app, infra, comp, comm, cs)).plan
        if plan.feasible and len(plan.placements) >= 3:
            return (app, infra, comp, comm, cs), plan
    raise AssertionError("no feasible synth problem found")


def test_ensemble_emissions_matches():
    inputs, plan = _feasible_synth()
    low = jlower(*inputs[:4])
    E = np.stack([low.E * (1.0 + 0.5 * b) for b in range(4)])
    scen = JBatch(ci=_ci_batch(low.N, 4, 2), E=E)
    assign = jwhatif.plan_assignment(plan)
    jarr = jwhatif.assignment_arrays(low, assign)
    tlow = to_port(low)
    tarr = twhatif.assignment_arrays(tlow, to_port(assign))
    for a, b in zip(jarr, tarr):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    jem = jwhatif.ensemble_emissions(low, [jarr, jarr], scen)
    tem = twhatif.ensemble_emissions(tlow, [tarr, tarr], to_port(scen))
    np.testing.assert_array_equal(tem, jem)


def _two_on_one_node():
    svc = lambda i: Service(f"s{i}", flavours=(  # noqa: E731
        Flavour("f0", FlavourRequirements(cpu=2.0, ram_gb=1.0)),))
    app = Application("a", (svc(0), svc(1)))
    infra = Infrastructure("i", tuple(
        Node(f"n{k}", carbon=100.0,
             capabilities=NodeCapabilities(cpu=3.0, ram_gb=8.0))
        for k in range(2)))
    comp = {("s0", "f0"): 1.0, ("s1", "f0"): 1.0}
    return (app, infra, comp, {}, ()), {"s0": ("f0", "n0"),
                                        "s1": ("f0", "n0")}


def _private_on_public():
    app = Application("a", (Service(
        "s0", flavours=(Flavour("f0", FlavourRequirements(cpu=1.0)),),
        requirements=ServiceRequirements(subnet=Subnet.PRIVATE)),))
    infra = Infrastructure("i", (
        Node("pub", carbon=50.0,
             capabilities=NodeCapabilities(subnet=Subnet.PUBLIC)),
        Node("prv", carbon=400.0,
             capabilities=NodeCapabilities(subnet=Subnet.PRIVATE))))
    return (app, infra, {("s0", "f0"): 1.0}, {}, ()), {"s0": ("f0", "pub")}


def _warm_case(kind):
    """tests/test_whatif.py's warm starts: accepted, rejected (unknown
    node, capacity, subnet) and partial."""
    if kind == "capacity":
        return _two_on_one_node()
    if kind == "subnet":
        return _private_on_public()
    inputs, plan = _feasible_synth()
    init = jwhatif.plan_assignment(plan)
    sid = sorted(init)[0]
    if kind == "unknown_node":
        init[sid] = (init[sid][0], "no-such-node")
    elif kind == "partial":
        del init[sid]
    return inputs, init


@pytest.mark.parametrize("kind", ["accepted", "unknown_node", "capacity",
                                  "subnet", "partial"])
@pytest.mark.parametrize("B", [1, 3])
def test_whatif_warm_start_matches(kind, B):
    inputs, init = _warm_case(kind)
    low = jlower(*inputs[:4])
    jproblem = JProblem(lowering=low, constraints=tuple(inputs[4]))
    scen = JBatch(ci=_ci_batch(low.N, B, 9))
    jr = JWhatIf(_jsched()).evaluate(jproblem, scenarios=scen, initial=init)
    tr = TWhatIf(_tsched()).evaluate(to_port(jproblem),
                                     scenarios=to_port(scen),
                                     initial=to_port(init))
    _assert_same_whatif(jr, tr)
    rejected = [any("warm start rejected" in n or "capacity exceeded" in n
                    for n in p.notes) for p in tr.plans]
    assert all(rejected) == (kind in ("unknown_node", "capacity", "subnet"))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _strip(rec):
    d = dataclasses.asdict(rec)
    for k in TIMING + ("compiles",):
        d.pop(k)
    return d


def _zeroed(result):
    return dataclasses.replace(result, ticks=[
        dataclasses.replace(r, compiles=0, **{k: 0.0 for k in TIMING})
        for r in result.ticks])


def assert_same_run(jres, tres):
    assert [_strip(r) for r in tres.ticks] == [_strip(r) for r in jres.ticks]
    assert tres.final_assignment == jres.final_assignment
    assert tres.summary() == jres.summary()
    assert _zeroed(tres).to_jsonl() == _zeroed(jres).to_jsonl()
    assert TResult.from_jsonl(tres.to_jsonl()) == tres


def runtimes(app, infra, carbon, workload, config=None, pipeline_kw=None,
             sched_kw=None):
    """The same runtime in both packages: JAX planner, and the port's
    pipeline and planner on the CPU.  ``carbon``/``workload`` build a
    package's trace from its module namespace."""
    config, pipeline_kw, sched_kw = config or {}, pipeline_kw or {}, \
        sched_kw or dict(emission_weight=1.0)
    bucket = config.get("bucket")
    j = JRuntime(
        app, infra, carbon(JCarbon, J_PRESETS), workload(JWorkload, app),
        config=JConfig(**config), pipeline=JPipeline(**pipeline_kw),
        planner=JWhatIf(JScheduler(JSchedConfig(**sched_kw))))
    tconfig = dict(config, bucket=to_port(bucket)) if bucket else config
    tapp = to_port(app)
    t = TRuntime(
        tapp, to_port(infra), carbon(TCarbon, T_PRESETS),
        workload(TWorkload, tapp), config=TConfig(**tconfig),
        pipeline=TPipeline(device="cpu", **pipeline_kw),
        planner=TWhatIf(TScheduler(TSchedConfig(**sched_kw), device="cpu")))
    return j, t


CONFIGS = {
    "adaptive": dict(scenarios=4, hysteresis_g=30.0),
    "static": dict(replan_every=10 ** 9),
    "oracle": dict(oracle=True, hysteresis_g=0.0, horizon_h=1),
    "single_forecast": dict(scenarios=4, use_whatif=False),
    "telemetry_window3": dict(scenarios=4, hysteresis_g=30.0,
                              telemetry_window=3),
    "full_relower": dict(scenarios=4, hysteresis_g=30.0,
                         delta_replanning=False),
    "auto_bucket": dict(scenarios=4, hysteresis_g=30.0, auto_bucket_after=4),
}
# test_continuum.py's small app (scenarios=3 as its runtimes use) and the
# continuum benchmark's scenario (48 ticks, B=4)
SCENES = {
    "small": (lambda: (_app(), _infra()), 16, dict(scenarios=3)),
    "bench": (build_scenario, 48, {}),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_runtime_run_matches(scene, config):
    make, ticks, base = SCENES[scene]
    app, infra = make()
    cfg = dict(base, **CONFIGS[config])
    j, t = runtimes(
        app, infra,
        lambda cls, presets: cls(presets, hours=24 + ticks + 25, seed=0),
        lambda cls, a: cls(a, seed=0), config=cfg)
    assert_same_run(j.run(24, ticks), t.run(24, ticks))
    if config == "auto_bucket":
        assert t.auto_bucket == to_port(j.auto_bucket)
        # the bucketed scheduler keeps the injected one's device
        assert t.planner.scheduler.device == "cpu"
        assert t.planner.scheduler.config.bucket == t.auto_bucket


def test_runtime_explicit_bucket_keeps_device():
    app, infra = build_scenario()
    bucket = JBucket(s=(16,), n=(8,), b=(4,))
    j, t = runtimes(
        app, infra, lambda cls, p: cls(p, hours=24 + 8 + 25, seed=1),
        lambda cls, a: cls(a, seed=1),
        config=dict(scenarios=4, hysteresis_g=30.0, bucket=bucket))
    assert t.planner.scheduler.device == "cpu"
    assert_same_run(j.run(24, 8), t.run(24, 8))
    assert t.last_result.plan_stats.bucketed


def _divergent_carbon(cls, _presets):
    # test_continuum.py's oracle-vs-static trace: one region ramps clean
    region = cls.__module__.split(".")[0]
    from importlib import import_module
    profile = import_module(region + ".continuum").RegionProfile
    tr = cls({"steady": profile(300.0, 0.0, 0.0, 0.0),
              "ramper": profile(500.0, 0.0, 0.0, 0.0)}, hours=80)
    tr._series["ramper"][40:] = 60.0
    return tr


@pytest.mark.parametrize("config", ["static", "oracle"])
def test_runtime_divergent_trace_matches(config):
    app, infra = _app(4), _infra(regions=("steady", "ramper"), per=2)
    j, t = runtimes(app, infra, _divergent_carbon,
                    lambda cls, a: cls(a, seed=1, noise=0.0),
                    config=dict(CONFIGS[config], scenarios=3))
    assert_same_run(j.run(24, 30), t.run(24, 30))


@pytest.mark.parametrize("restart_g", [0.0, 0.25, 50.0])
def test_runtime_flavour_flap_matches(restart_g):
    """test_continuum.py's near-tied flavours, damped by the restart
    charge or not."""
    from test_continuum import _TieBreakerTrace

    class PortTieBreaker(_TieBreakerTrace):
        def monitoring(self, t):
            return to_port(super().monitoring(t))

    app = Application("flap", (Service("svc", flavours=(
        Flavour("f0", FlavourRequirements(cpu=1.0)),
        Flavour("f1", FlavourRequirements(cpu=1.0)))),))
    infra = Infrastructure("flap", (Node(
        "only", region="flat", cost_per_cpu_hour=0.5,
        capabilities=NodeCapabilities(cpu=4.0)),))

    def carbon(cls, _presets):
        from importlib import import_module
        profile = import_module(
            cls.__module__.split(".")[0] + ".continuum").RegionProfile
        return cls({"flat": profile(100.0, 0.0, 12.0, 0.0)}, hours=60)

    def workload(cls, a):
        return (_TieBreakerTrace if cls is JWorkload else PortTieBreaker)(a)

    j, t = runtimes(app, infra, carbon, workload,
                    config=dict(scenarios=1, hysteresis_g=0.0,
                                migration_g=0.0, restart_g=restart_g),
                    sched_kw=dict(emission_weight=1.0, pref_weight=0.0,
                                  use_green_constraints=False))
    jres, tres = j.run(24, 10), t.run(24, 10)
    assert_same_run(jres, tres)
    if restart_g == 0.0:
        assert sum(r.restarts for r in tres.ticks[1:]) >= 3


def test_runtime_csv_trace_matches():
    """test_carbon_csv.py's recorded, gapped and aliased trace driving the
    loop."""
    path = os.path.join(DATA, "electricitymaps_gapped.csv")
    app = Application("t", tuple(
        Service(f"svc{i}", flavours=(
            Flavour("f", FlavourRequirements(cpu=1.0)),)) for i in range(2)))
    infra = Infrastructure("t", tuple(
        Node(f"{z}-0", region=z, capabilities=NodeCapabilities(cpu=8.0))
        for z in ("DE", "FR")))
    j, t = runtimes(app, infra,
                    lambda cls, _p: cls.from_csv(path,
                                                 aliases={"DE-LU": "DE"}),
                    lambda cls, a: cls(a, seed=0),
                    config=dict(scenarios=2, horizon_h=2))
    assert_same_run(j.run(6, 4), t.run(6, 4))


def test_kb_memory_decay_matches_through_ticks():
    """test_continuum.py's KB decay: the same knowledge base, tick by
    tick, as an avoided node turns clean."""
    def carbon(cls, _presets):
        from importlib import import_module
        profile = import_module(
            cls.__module__.split(".")[0] + ".continuum").RegionProfile
        tr = cls({"clean": profile(100.0, 0.0, 0.0, 0.0),
                  "dirty-then-clean": profile(900.0, 0.0, 0.0, 0.0),
                  "dirty-later": profile(150.0, 0.0, 0.0, 0.0)}, hours=100)
        tr._series["dirty-then-clean"][40:] = 100.0
        tr._series["dirty-later"][40:] = 900.0
        return tr

    app = Application("t", (Service("svc", flavours=(
        Flavour("f0", FlavourRequirements(cpu=1.0)),)),))
    infra = _infra(regions=("clean", "dirty-then-clean", "dirty-later"),
                   per=1)
    j, t = runtimes(app, infra, carbon,
                    lambda cls, a: cls(a, seed=0, noise=0.0),
                    config=dict(scenarios=3), pipeline_kw=dict(alpha=0.5))
    j.pipeline.gatherer.window = t.pipeline.gatherer.window = 1
    for tick in range(38, 50):
        assert _strip(t.tick(tick)) == _strip(j.tick(tick))
        jkb, tkb = j.pipeline.kb.to_kb(), t.pipeline.kb.to_kb()
        assert list(tkb.ck) == list(jkb.ck)
        assert [(c.em, c.mu, c.t) for c in tkb.ck.values()] == \
            [(c.em, c.mu, c.t) for c in jkb.ck.values()]


def fan_in_scenario(links=8):
    """The continuum benchmark's scenario with ``configs/synth.py``-style
    fan-in: link j (1..links) of service i goes to service
    ``i + 1 + (j - 1) * (S // links)`` (mod S), so each service has
    ``links`` links in and out, and the dense communication sums of the
    planner's one-hot products meet several non-zero terms.  "small"
    ranks first, so the traffic the workload trace draws from each
    service's first flavour leaves the flavour the planner runs (as in
    chip_smoke.py's fan-in week)."""
    app, infra = build_scenario()
    S = len(app.services)
    step = S // links
    ids = [s.component_id for s in app.services]
    fan = tuple(
        type(app.links[0])(ids[i], ids[(i + 1 + (j - 1) * step) % S])
        for i in range(S) for j in range(1, links + 1))
    services = tuple(dataclasses.replace(s, flavours_order=("small", "large"))
                     for s in app.services)
    return dataclasses.replace(app, services=services, links=fan), infra


@pytest.mark.parametrize("config", ["adaptive", "oracle"])
def test_runtime_fan_in_week_matches(config):
    """Two days of the fan-in continuum (8 links into each of the 12
    services, dense) in both packages: the planner's multi-term
    communication sums decide alike."""
    app, infra = fan_in_scenario()
    ticks = 48
    cfg = dict(CONFIGS[config], scenarios=8) if config == "adaptive" \
        else CONFIGS[config]
    j, t = runtimes(
        app, infra,
        lambda cls, presets: cls(presets, hours=24 + ticks + 25, seed=0),
        lambda cls, a: cls(a, seed=0), config=cfg)
    jres, tres = j.run(24, ticks), t.run(24, ticks)
    assert_same_run(jres, tres)
    low = t.pipeline._lowering_cache[2]
    assert low.comm.kind == "dense" and low.comm.n_links == 8 * 12
    assert all(r.replanned for r in tres.ticks)
