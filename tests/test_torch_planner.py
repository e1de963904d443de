"""The port's float64 planner against the JAX package's, on the CPU.

Every case builds its problem with the JAX package, carries it across to
the port with :func:`to_port` (the same objects and arrays, rebuilt from
``repro_torch.core.types``), plans it with both ``GreenScheduler``s under
the same profile, and asserts equal decisions with no tolerance: placed,
flavour and node per service, skipped services, feasibility, the failing
service, emissions.  The cases are the problem sets of
tests/test_scheduler.py, test_scheduler_equivalence.py,
test_sparse_lowering.py (dyadic), test_bucketing.py and
test_problem_api.py, boutique's scenarios, and the scalability
benchmark's synthetic problems at small sizes, over both communication
backends, at B=1 and B>1.

The JAX planner imports ``jax.experimental.enable_x64``, which this jax
release no longer has; the ``x64`` fixture installs it as an alias of
``jax.enable_x64(True)`` for the test's duration only.
"""
import dataclasses
import enum
import importlib

import jax
import jax.experimental
import numpy as np
import pytest

from repro.configs import boutique as jboutique
from repro.core import lowering as jlowering
from repro.core import scheduler as jscheduler
from repro.core.energy import EnergyEstimator, EnergyMixGatherer
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
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
from repro_torch.configs import synth as port_synth
from repro_torch.core import lowering as tlowering
from repro_torch.core import scheduler as tscheduler

from benchmarks.scheduler_scalability import synth as synth_bench
from test_scheduler_equivalence import synth as synth_random
from test_sparse_lowering import synth_dyadic


# ---------------------------------------------------------------------------
# carrying problems across, running both planners
# ---------------------------------------------------------------------------


def _twin_class(cls, source, target):
    module = cls.__module__
    assert module == source or module.startswith(source + "."), module
    twin = importlib.import_module(target + module[len(source):])
    return getattr(twin, cls.__name__)


def _carry(obj, source, target):
    if isinstance(obj, enum.Enum):
        return _twin_class(type(obj), source, target)[obj.name]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _twin_class(type(obj), source, target)
        return cls(**{f.name: _carry(getattr(obj, f.name), source, target)
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_carry(x, source, target) for x in obj)
    if isinstance(obj, list):
        return [_carry(x, source, target) for x in obj]
    if isinstance(obj, dict):
        return {_carry(k, source, target): _carry(v, source, target)
                for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj


def to_port(obj):
    """Rebuild a ``repro`` object (types, lowerings, problems, plans) as its
    ``repro_torch`` twin, field by field; arrays are copied as they are."""
    return _carry(obj, "repro", "repro_torch")


def to_ref(obj):
    """Rebuild a ``repro_torch`` object as its ``repro`` twin (the inverse
    of :func:`to_port`), for problems only the port's generators make."""
    return _carry(obj, "repro_torch", "repro")


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def make_cfg(module, profile, **over):
    """The same profile in either package's ``SchedulerConfig``."""
    cls = module.SchedulerConfig
    if profile.startswith("mixed"):
        # "mixed" as in test_scheduler_equivalence; "mixed_dyadic" keeps
        # every objective term exact, as in test_sparse_lowering
        cfg = cls(emission_weight=0.25 if profile == "mixed_dyadic" else 0.3)
    else:
        cfg = getattr(cls, profile)()
    for k, v in over.items():
        if k == "bucket" and v is not None:
            v = v if module is jscheduler else to_port(v)
        setattr(cfg, k, v)
    return cfg


def plan_both(jproblem, profile, **over):
    """Plan one JAX-built problem with the JAX planner and, carried across,
    with the port's planner on the CPU."""
    jres = jscheduler.GreenScheduler(
        make_cfg(jscheduler, profile, **over)).plan(jproblem)
    tres = tscheduler.GreenScheduler(
        make_cfg(tscheduler, profile, **over), device="cpu").plan(
            to_port(jproblem))
    return jres, tres


def assert_same_decisions(jres, tres):
    for name in ("placed", "fcur", "ncur", "emissions_g"):
        a, b = getattr(jres, name), getattr(tres, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert len(jres.plans) == len(tres.plans)
    for b, (pj, pt) in enumerate(zip(jres.plans, tres.plans)):
        # feasibility, placements, skipped services, emissions and the
        # notes (which name the failing service) in one comparison
        assert to_port(pj) == pt, b
    if jres.stats is not None:
        for name in ("backend", "shape", "padded_shape", "signature",
                     "bucketed"):
            assert getattr(tres.stats, name) == getattr(jres.stats, name)


def check(jproblem, profile, **over):
    jres, tres = plan_both(jproblem, profile, **over)
    assert_same_decisions(jres, tres)
    return jres, tres


def _build(inputs, backend="auto"):
    return JProblem.build(*inputs, backend=backend)


# ---------------------------------------------------------------------------
# lowering: both packages produce the same arrays
# ---------------------------------------------------------------------------


def _assert_lowering_equal(jl, tl):
    assert type(tl).__name__ == type(jl).__name__
    for f in dataclasses.fields(jl):
        a, b = getattr(jl, f.name), getattr(tl, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        elif dataclasses.is_dataclass(a):
            _assert_lowering_equal(a, b)
        else:
            assert a == b, f.name


LOWER_CASES = {
    **{f"random{seed}": (lambda seed=seed: synth_random(seed))
       for seed in (0, 3, 7)},
    **{f"dyadic{seed}": (lambda seed=seed: synth_dyadic(seed))
       for seed in (0, 4)},
    "synth50x25": lambda: synth_bench(50, 25),
}


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("case", sorted(LOWER_CASES))
def test_lower_matches(case, backend):
    inputs = LOWER_CASES[case]()
    app, infra, comp, comm, cs = inputs
    jl = jlowering.lower(app, infra, comp, comm, backend=backend)
    tl = tlowering.lower(*to_port((app, infra, comp, comm)), backend=backend)
    _assert_lowering_equal(jl, tl)
    for a, b in zip(jlowering.lower_constraints(jl, cs),
                    tlowering.lower_constraints(tl, to_port(cs))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # padding, scenario materialization and emissions pricing
    L = jl.comm.n_links + 3 if backend == "sparse" else None
    _assert_lowering_equal(
        jlowering.pad_lowering(jl, jl.S + 2, jl.F + 1, jl.N + 3, L),
        tlowering.pad_lowering(tl, tl.S + 2, tl.F + 1, tl.N + 3, L))
    rng = np.random.default_rng(0)
    ci_b = rng.uniform(10, 600, size=(3, jl.N))
    E_b = jl.E[None] * rng.uniform(0.5, 2.0, size=(3, 1, 1))
    for E in (None, E_b):
        jm = jlowering.ScenarioBatch(ci=ci_b, E=E).materialize(jl)
        tm = tlowering.ScenarioBatch(ci=ci_b, E=E).materialize(tl)
        for a, b in zip(jm, tm):
            assert np.array_equal(a, b)
    placed = rng.random((3, jl.S)) < 0.8
    fcur = rng.integers(0, jl.F, size=(3, jl.S))
    ncur = rng.integers(0, jl.N, size=(3, jl.S))
    assert np.array_equal(
        jlowering.batched_lowered_emissions(jl, placed, fcur, ncur, ci_b),
        tlowering.batched_lowered_emissions(tl, placed, fcur, ncur, ci_b))


def test_port_synth_is_the_benchmark_generator():
    for S, N in ((50, 25), (200, 100)):
        assert port_synth.synth(S, N) == to_port(synth_bench(S, N))
    app, infra, comp, comm, cs = port_synth.to_dyadic(port_synth.synth(50, 25))
    grid = [n.carbon for n in infra.nodes] + [n.cost_per_cpu_hour
                                             for n in infra.nodes]
    grid += list(comp.values()) + list(comm.values())
    grid += [c.weight for c in cs] + [c.memory_weight for c in cs]
    assert all((v * 256).is_integer() for v in grid)
    carbon = [n.carbon for n in infra.nodes]
    assert (sum(carbon) / len(carbon) * 256).is_integer()


@pytest.mark.parametrize("S,links", [(50, 4), (2000, 8)])
def test_port_synth_fan_in(S, links):
    """``links=k``: k links out of every service, k/F out of every
    (service, flavour) and k into every service, none to itself."""
    from collections import Counter

    _, _, _, comm, _ = port_synth.synth(S, 20, links=links)
    assert len(comm) == S * links
    assert all(src != dst for src, _, dst in comm)
    assert set(Counter((src, f) for src, f, _ in comm).values()) \
        == {links // port_synth.FLAVOURS}
    assert set(Counter(dst for _, _, dst in comm).values()) == {links}


# ---------------------------------------------------------------------------
# planner decisions: (case, backend, profile)
# ---------------------------------------------------------------------------


def _boutique_inputs(n, use_kb=False):
    """Scenario n's enriched problem and its constraints, as
    tests/test_scheduler.py builds them."""
    app, infra, mon = jboutique.scenario(n)
    out = JPipeline().run(app, infra, mon, use_kb=use_kb)
    return out.app, out.infra, out.computation, out.communication, \
        out.constraints


def _scenario5_heavy_traffic():
    """tests/test_scheduler.py's affinity case: the un-enriched app, the
    enriched infra and scenario 5's x15000 traffic profiles."""
    app, infra, mon = jboutique.scenario(5)
    est = EnergyEstimator()
    infra = EnergyMixGatherer().enrich(infra)
    out = JPipeline().run(app, infra, mon, use_kb=False)
    return (app, infra, est.computation_profiles(mon),
            est.communication_profiles(mon), out.constraints)


def _one_node(*services):
    return (Application("a", services),
            Infrastructure("i", (Node("n", carbon=10.0, capabilities=(
                NodeCapabilities(cpu=4.0))),)), {}, {}, ())


def _infeasible_mandatory():
    return _one_node(Service("big", flavours=(
        Flavour("f", requirements=FlavourRequirements(cpu=128.0)),)))


def _optional_skipped():
    return _one_node(
        Service("must", flavours=(
            Flavour("f", requirements=FlavourRequirements(cpu=3.0)),)),
        Service("opt", must_deploy=False, flavours=(
            Flavour("f", requirements=FlavourRequirements(cpu=3.0)),)))


def _single_service():
    svc = Service("solo", flavours=(
        Flavour("f0", FlavourRequirements(cpu=1.0)),
        Flavour("f1", FlavourRequirements(cpu=0.5))))
    infra = Infrastructure("i", (
        Node("n0", carbon=128.0, capabilities=NodeCapabilities(cpu=4.0)),
        Node("n1", carbon=64.0, capabilities=NodeCapabilities(cpu=4.0))))
    return (Application("a", (svc,)), infra,
            {("solo", "f0"): 2.0, ("solo", "f1"): 4.0},
            {("solo", "f0", "solo"): 8.0}, ())


def _empty_communication():
    app, infra, comp, _, cs = synth_dyadic(3)
    return app, infra, comp, {}, cs


RANDOM_PROFILES = ("baseline", "green", "mixed", "oracle")
DYADIC_PROFILES = ("green", "mixed_dyadic", "oracle")
BACKENDS = ("dense", "sparse")

# (case id, builder, profiles, extra config)
CASE_SETS = (
    # test_scheduler_equivalence.py: synth(seed), all four profiles
    [(f"random{seed}", lambda seed=seed: synth_random(seed),
      RANDOM_PROFILES, {}) for seed in range(15)]
    # test_sparse_lowering.py / test_bucketing.py: the dyadic suite
    + [(f"dyadic{seed}", lambda seed=seed: synth_dyadic(seed),
        DYADIC_PROFILES, {}) for seed in range(10)]
    # boutique, the paper's case study (test_scheduler*.py)
    + [(f"boutique{n}", lambda n=n: _boutique_inputs(n),
        RANDOM_PROFILES, {}) for n in range(1, 6)]
    + [("boutique5_heavy_traffic", _scenario5_heavy_traffic, ("green",),
        {"green_penalty": 50.0}),
       ("infeasible_mandatory", _infeasible_mandatory, ("green",), {}),
       ("optional_skipped", _optional_skipped, ("green",), {}),
       ("single_service", _single_service, ("mixed_dyadic",), {}),
       ("empty_communication", _empty_communication, ("green",), {})]
    # the scalability benchmark's generator at small sizes, its rounds
    + [(f"bench{S}x{N}", lambda S=S, N=N: synth_bench(S, N),
        ("green", "oracle"), {"local_search_rounds": 2})
       for S, N in ((50, 25), (200, 100))]
    # the port's generator with fan-in (four links per service), float and
    # dyadic: several terms in every communication sum
    + [(f"fanin{S}x{N}", lambda S=S, N=N: to_ref(
        port_synth.synth(S, N, links=4)),
        ("green", "mixed", "oracle"), {"local_search_rounds": 2})
       for S, N in ((50, 25), (200, 100))]
    + [(f"fanin_dyadic{S}x{N}", lambda S=S, N=N: to_ref(
        port_synth.to_dyadic(port_synth.synth(S, N, links=4))),
        DYADIC_PROFILES, {"local_search_rounds": 2})
       for S, N in ((50, 25), (200, 100))]
)
CASES = {name: (build, over) for name, build, _, over in CASE_SETS}
DECISION_PARAMS = [(name, backend, profile)
                   for name, _, profiles, _ in CASE_SETS
                   for profile in profiles for backend in BACKENDS]
_INPUTS = {}


def _inputs(name):
    if name not in _INPUTS:
        _INPUTS[name] = CASES[name][0]()
    return _INPUTS[name]


@pytest.mark.parametrize("case,backend,profile", DECISION_PARAMS)
def test_planner_decisions_match(case, backend, profile):
    jres, tres = check(_build(_inputs(case), backend), profile,
                       **CASES[case][1])
    assert tres.stats.greedy_steps == jres.placed.shape[1]


SCENARIO_CASES = ["dyadic0", "dyadic3", "random2", "boutique1",
                  "bench50x25", "bench200x100", "fanin_dyadic50x25"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", SCENARIO_CASES)
def test_planner_scenario_batch_matches(case, backend):
    """B=4 what-if branches with per-branch carbon (and, for the first
    two, per-branch energy profiles), emission-weighted so the branches
    differ."""
    problem = _build(_inputs(case), backend)
    low = problem.lowering
    rng = np.random.default_rng(len(case))
    ci_b = rng.integers(64, 40000, size=(4, low.N)) / 64.0
    E_b = None
    if case.startswith("dyadic"):
        E_b = np.stack([low.E * (2.0 ** b) for b in range(4)])
    problem = problem.with_scenarios(jlowering.ScenarioBatch(ci=ci_b, E=E_b))
    jres, tres = check(problem, "mixed_dyadic",
                       **CASES[case][1])
    assert tres.B == 4 and len(tres.stats.local_search_steps) == 4
