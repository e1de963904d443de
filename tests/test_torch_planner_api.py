"""The port's planner API against the JAX package's, on the CPU: shape
bucketing, warm starts, degenerate shapes, the compile-cache accounting,
``PlacementProblem``/``PlanResult`` and the device policy.

Decisions are compared with no tolerance (``assert_same_decisions``).  On
the dyadic problems of tests/test_bucketing.py every sum is exact, so the
port's bucketed plan must also equal its own unpadded plan bit for bit,
as the JAX package's does.
"""
import numpy as np
import pytest
import torch

from repro.core import lowering as jlowering
from repro.core import scheduler as jscheduler
from repro.core.problem import BucketSpec as JBucketSpec
from repro.core.problem import PlacementProblem as JProblem
from repro.core.types import (
    Application,
    Flavour,
    FlavourRequirements,
    Infrastructure,
    Node,
    NodeCapabilities,
    Service,
)
from repro_torch.core import problem as tproblem
from repro_torch.core import scheduler as tscheduler
from repro_torch.obs.registry import metrics_scope

from test_sparse_lowering import synth_dyadic
from test_torch_planner import (  # noqa: F401  (x64 is an autouse fixture)
    check,
    make_cfg,
    to_port,
    x64,
)

PROFILES = ("green", "mixed_dyadic", "oracle")
BACKENDS = ("dense", "sparse")


def _port_plan(problem, profile, **over):
    return tscheduler.GreenScheduler(
        make_cfg(tscheduler, profile, **over), device="cpu").plan(problem)


def _bucketed_and_exact(jproblem, profile, bucket=None):
    """The bucketed plans of both packages must agree, and the port's
    bucketed plan must equal its exact one (dyadic inputs)."""
    bucket = bucket if bucket is not None else JBucketSpec()
    jres, tres = check(jproblem, profile, bucket=bucket)
    assert tres.stats.bucketed
    exact = _port_plan(to_port(jproblem), profile)
    for name in ("placed", "fcur", "ncur", "emissions_g"):
        np.testing.assert_array_equal(getattr(tres, name),
                                      getattr(exact, name))
    assert tres.plans == exact.plans
    return jres, tres


# ---------------------------------------------------------------------------
# bucketing (tests/test_bucketing.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("seed", range(6))
def test_bucketed_matches(seed, profile, backend):
    _bucketed_and_exact(JProblem.build(*synth_dyadic(seed), backend=backend),
                        profile)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(3))
def test_bucketed_scenario_batch_matches(seed, backend):
    problem = JProblem.build(*synth_dyadic(seed), backend=backend)
    rng = np.random.default_rng(seed)
    ci_b = rng.integers(64, 40000, size=(3, problem.lowering.N)) / 64.0
    # B=3 pads to the B=4 bucket: a phantom branch replays branch 0
    jres, tres = _bucketed_and_exact(
        problem.with_scenarios(jlowering.ScenarioBatch(ci=ci_b)),
        "oracle")
    assert tres.B == 3 and tres.stats.padded_shape[0] == 4


def test_bucketed_scenario_E_override_matches():
    problem = JProblem.build(*synth_dyadic(1))
    low = problem.lowering
    rng = np.random.default_rng(7)
    ci_b = rng.integers(64, 40000, size=(3, low.N)) / 64.0
    E_b = np.stack([low.E * (2.0 ** b) for b in range(3)])
    _bucketed_and_exact(problem.with_scenarios(
        jlowering.ScenarioBatch(ci=ci_b, E=E_b)), "oracle")


@pytest.mark.parametrize("backend", BACKENDS)
def test_bucketed_warm_start_matches(backend):
    problem = JProblem.build(*synth_dyadic(2), backend=backend)
    init = jscheduler.GreenScheduler(make_cfg(jscheduler, "green")).plan(
        problem).assignment(0)
    _bucketed_and_exact(problem.with_warm_start(init), "green")


def _degenerate_cases():
    svc = Service("s0", flavours=(Flavour("f0", FlavourRequirements(cpu=1.0)),))
    opt = Service("s1", must_deploy=False,
                  flavours=(Flavour("f0", FlavourRequirements(cpu=1.0)),))
    node = Node("n0", carbon=100.0, capabilities=NodeCapabilities(cpu=4.0))
    return {
        "no_services": (Application("a", ()), Infrastructure("i", (node,))),
        "no_nodes": (Application("a", (svc,)), Infrastructure("i", ())),
        "no_nodes_optional": (Application("a", (opt, svc)),
                              Infrastructure("i", ())),
        "optional_only": (Application("a", (opt,)), Infrastructure("i", ())),
        "neither": (Application("a", ()), Infrastructure("i", ())),
    }


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("case", sorted(_degenerate_cases()))
def test_degenerate_shapes_match(case, bucketed):
    app, infra = _degenerate_cases()[case]
    problem = JProblem.build(app, infra, {}, {})
    over = {"bucket": JBucketSpec()} if bucketed else {}
    jres, tres = check(problem, "green", **over)
    assert tres.stats is None and jres.stats is None


# ---------------------------------------------------------------------------
# warm start: accepted, and each of _warm_start_state's four rejections
# ---------------------------------------------------------------------------


def _warm_starts():
    problem = JProblem.build(*synth_dyadic(2))
    init = jscheduler.GreenScheduler(make_cfg(jscheduler, "green")).plan(
        problem).assignment(0)
    sid, (fname, nid) = sorted(init.items())[0]
    low = problem.lowering
    # a (flavour, node) cell the static mask forbids for one service
    stat = jscheduler._static_feasibility(low)
    s, f, n = map(int, np.argwhere(~stat)[0])
    bad_cell = (low.service_ids[s], (low.flavour_names[s][f],
                                     low.node_ids[n]))
    # every service the mask allows on one node, over its capacity
    crowd = None
    for j in range(low.N):
        on_j = [i for i in range(low.S) if stat[i, 0, j]]
        if (low.cpu_req[on_j, 0].sum() > low.cpu_cap[j]
                or low.ram_req[on_j, 0].sum() > low.ram_cap[j]):
            crowd = {low.service_ids[i]: (low.flavour_names[i][0],
                                          low.node_ids[j]) for i in on_j}
            break
    assert crowd is not None
    return problem, {
        "accepted": init,
        "accepted_partial": dict(sorted(init.items())[:3]),
        "unknown_node": {**init, sid: (fname, "no-such-node")},
        "unknown_service": {"no-such-service": (fname, nid)},
        "unknown_flavour": {**init, sid: ("no-such-flavour", nid)},
        "mask": {**init, bad_cell[0]: bad_cell[1]},
        "capacity": crowd,
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["accepted", "accepted_partial",
                                  "unknown_node", "unknown_service",
                                  "unknown_flavour", "mask", "capacity"])
def test_warm_start_matches(case, backend):
    _, starts = _warm_starts()
    problem = JProblem.build(*synth_dyadic(2), backend=backend)
    jres, tres = check(problem.with_warm_start(starts[case]), "green")
    notes = tres.plans[0].notes
    if case.startswith("accepted"):
        assert notes == ()
    else:
        assert len(notes) == 1 and notes[0].startswith("warm start rejected")
        low = to_port(problem.lowering)
        _, reason = tscheduler._warm_start_state(
            low, tscheduler._static_feasibility(low), starts[case])
        _, jreason = jscheduler._warm_start_state(
            problem.lowering, jscheduler._static_feasibility(
                problem.lowering), starts[case])
        assert reason == jreason and reason in notes[0]
        assert case.split("_")[-1] in reason


# ---------------------------------------------------------------------------
# PlacementProblem / PlanResult (tests/test_problem_api.py's cases)
# ---------------------------------------------------------------------------


def test_plan_result_matches_and_round_trips():
    problem = JProblem.build(*synth_dyadic(1))
    jres, tres = check(problem, "green")
    assert isinstance(tres, tproblem.PlanResult)
    assert tres.B == 1 and len(tres) == 1 and tres.plan is tres.plans[0]
    assert tres.assignment(0) == jres.assignment(0)
    assert tres.assignment(0) == {
        p.service: (p.flavour, p.node) for p in tres.plan.placements}
    for a, b in zip(tres.arrays(0), jres.arrays(0)):
        np.testing.assert_array_equal(a, b)
    # the problem's identity travels with it
    assert to_port(problem) == to_port(problem)
    assert to_port(problem).fingerprint != to_port(
        problem.with_warm_start({})).fingerprint


def test_identical_branches_and_b1_scenario_match():
    problem = JProblem.build(*synth_dyadic(1))
    low = problem.lowering
    tiled = problem.with_scenarios(
        jlowering.ScenarioBatch(ci=np.tile(low.ci, (3, 1))))
    jres, tres = check(tiled, "green")
    with pytest.raises(ValueError):
        _ = tres.plan
    assert all(p.placements == tres.plans[0].placements for p in tres.plans)
    unbatched = _port_plan(to_port(problem), "oracle")
    batched = _port_plan(to_port(problem.with_scenarios(
        jlowering.ScenarioBatch(ci=low.ci[None, :]))), "oracle")
    assert unbatched.plan == batched.plans[0]


def test_plan_takes_only_a_problem():
    app, infra, comp, comm, cs = to_port(synth_dyadic(1))
    sched = tscheduler.GreenScheduler(device="cpu")
    with pytest.raises(TypeError, match="PlacementProblem"):
        sched.plan(app)
    with pytest.raises(TypeError):
        sched.plan(app, infra, comp, comm, cs)


def test_bucket_spec_matches():
    for spec in (JBucketSpec(), JBucketSpec.grid(s=(25, 50, 200), n=(25, 100))):
        tspec = to_port(spec)
        for dims in ((9, 3, 8, None, 1), (0, 1, 0, None, 1),
                     (16, 2, 8, 10, 1), (30, 2, 60, None, 1),
                     (500, 2, 300, None, 3)):
            assert tspec.pad_dims(*dims) == spec.pad_dims(*dims)
    shapes = [(10, 1, 4, None, 1)] * 5 + [(16, 1, 4, None, 1),
                                          (100, 1, 4, 64, 2)]
    for k in (1, 2, 3):
        assert to_port(JBucketSpec.from_observed(shapes, k)) \
            == tproblem.BucketSpec.from_observed(shapes, k)


# ---------------------------------------------------------------------------
# compile-cache accounting: a signature's first call is a miss, later
# calls are hits; nothing is compiled
# ---------------------------------------------------------------------------


def test_shapes_in_one_bucket_share_one_signature():
    bucket = tproblem.BucketSpec.grid(s=(13,), f=(3,), n=(11,), l=(17,),
                                      b=(2,))
    sched = tscheduler.GreenScheduler(
        make_cfg(tscheduler, "green", bucket=None), device="cpu")
    sched.config.bucket = bucket
    sigs, compiled = set(), 0
    for n_services, n_nodes in ((5, 7), (7, 9), (9, 11), (11, 8)):
        problem = to_port(JProblem.build(
            *synth_dyadic(0, n_services=n_services, n_nodes=n_nodes),
            backend="sparse"))
        stats = sched.plan(problem).stats
        assert isinstance(stats, tproblem.PlanStats)
        assert stats.padded_shape == (2, 13, 3, 11, 17)
        sigs.add(stats.signature)
        compiled += stats.compiled
    assert len(sigs) == 1 and compiled <= 1


def test_plan_stats_and_registry():
    problem = to_port(JProblem.build(*synth_dyadic(5)))
    with metrics_scope() as scope:
        r1 = _port_plan(problem, "green")
        r2 = _port_plan(problem, "green")
    assert r1.stats.shape == r1.stats.padded_shape
    assert r2.stats.signature == r1.stats.signature
    assert not r2.stats.compiled and r2.stats.compile_time_s == 0.0
    assert r2.stats.plan_time_s > 0.0 and r2.stats.cache_hits >= 1
    assert r2.stats.device == "cpu"
    assert r2.stats.greedy_steps == problem.lowering.S
    assert scope.delta("planner.compile.calls") == 2
    assert scope.delta("planner.compile.hits") >= 1
    assert scope.delta("planner.compile.misses") <= 1
    stats = tscheduler.compile_cache_stats()
    assert stats["calls"] >= 2 and stats["distinct_signatures"] >= 1


# ---------------------------------------------------------------------------
# device policy: the card by default, the CPU only when asked for
# ---------------------------------------------------------------------------


def test_scheduler_without_a_card_raises(monkeypatch):
    problem = to_port(JProblem.build(*synth_dyadic(1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscheduler.GreenScheduler().plan(problem)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscheduler.GreenScheduler(device="cuda").plan(problem)
    assert _port_plan(problem, "green").plan.feasible
