"""The port's constraint pipeline against the JAX package's, on the CPU.

``GreenConstraintPipeline.run`` over several iterations of boutique, so the
knowledge base carries over, gives the same constraints, Prolog text,
explainability report and KB files in both packages; ``problem_for``
resolves its lowering by the same path (cache hit, delta substitution,
full lower) to the same arrays; and ``plan`` returns the same deployment
plan, with the port planning on the CPU.  Also the Eq. 5 quantile's
``"torch"`` backend and the device policy of ``plan``.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from repro.configs import boutique as jboutique
from repro.core import adapter as jadapter
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
from repro.core.scheduler import GreenScheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JConfig
from repro.learn.engine import quantile_inf_tensor as jquantile
from repro_torch.configs import boutique as tboutique
from repro_torch.core import adapter as tadapter
from repro_torch.core.pipeline import GreenConstraintPipeline as TPipeline
from repro_torch.core.scheduler import GreenScheduler as TScheduler
from repro_torch.core.scheduler import SchedulerConfig as TConfig
from repro_torch.learn.engine import quantile_inf_tensor as tquantile

from test_torch_planner import (  # noqa: F401  (x64 is an autouse fixture)
    _assert_lowering_equal,
    assert_same_decisions,
    to_port,
    x64,
)

# scenario per iteration: 1 lowers in full, 1 again is a cache hit, 3 moves
# one node's carbon (delta substitution), 4 one energy profile (delta),
# 2 swaps the infrastructure (full lower)
SCENARIOS = (1, 1, 3, 4, 2)
PATHS = ("full_lowers", "cache_hits", "delta_substitutions",
         "delta_substitutions", "full_lowers")


def test_port_boutique_is_the_reference_case_study():
    for n in range(1, 6):
        assert tboutique.scenario(n) == to_port(jboutique.scenario(n))


def _assert_same_output(jout, tout):
    assert to_port(list(jout.constraints)) == list(tout.constraints)
    assert tout.prolog == jout.prolog
    assert tout.dicts == jout.dicts
    assert tout.report.render() == jout.report.render()
    assert to_port((jout.app, jout.infra, jout.computation,
                    jout.communication)) == (
        tout.app, tout.infra, tout.computation, tout.communication)


@pytest.mark.parametrize("engine", ["array", "reference", "parity"])
@pytest.mark.parametrize("use_kb", [True, False])
def test_pipeline_runs_match(engine, use_kb, tmp_path):
    jp = JPipeline(engine=engine)
    tp = TPipeline(engine=engine, device="cpu")
    for it, n in enumerate(SCENARIOS):
        jout = jp.run(*jboutique.scenario(n), use_kb=use_kb)
        tout = tp.run(*tboutique.scenario(n), use_kb=use_kb)
        _assert_same_output(jout, tout)
        assert tp.constraint_stats["path"] == jp.constraint_stats["path"]
        for key in ("mode", "candidates", "rescored", "instantiated",
                    "reused", "fresh", "retrieved", "constraints"):
            assert tp.constraint_stats.get(key) == jp.constraint_stats.get(key)
        jprob, tprob = jp.problem_for(jout), tp.problem_for(tout)
        _assert_lowering_equal(jprob.lowering, tprob.lowering)
        assert to_port(list(jprob.constraints)) == list(tprob.constraints)
        assert tp.lowering_stats == jp.lowering_stats
        assert tp.lowering_stats[PATHS[it]] == jp.lowering_stats[PATHS[it]]
        jres = JScheduler(JConfig.green()).plan(jprob)
        tres = TScheduler(TConfig.green(), device="cpu").plan(tprob)
        assert_same_decisions(jres, tres)
    assert tp.lowering_stats == {"cache_hits": 1, "delta_substitutions": 2,
                                 "full_lowers": 2}
    # the knowledge base the iterations built, as its JSON files
    jkb, tkb = tmp_path / "jax", tmp_path / "port"
    jp.kb.save(str(jkb))
    tp.kb.save(str(tkb))
    names = sorted(os.listdir(jkb))
    assert names == sorted(os.listdir(tkb))
    match, mismatch, errors = filecmp.cmpfiles(jkb, tkb, names, shallow=False)
    assert not mismatch and not errors, mismatch


def test_pipeline_without_delta_substitution_matches():
    jp = JPipeline(delta_substitution=False)
    tp = TPipeline(delta_substitution=False, device="cpu")
    for n in SCENARIOS:
        jprob = jp.problem_for(jp.run(*jboutique.scenario(n)))
        tprob = tp.problem_for(tp.run(*tboutique.scenario(n)))
        _assert_lowering_equal(jprob.lowering, tprob.lowering)
    assert tp.lowering_stats == jp.lowering_stats == {
        "cache_hits": 1, "delta_substitutions": 0, "full_lowers": 4}


def test_pipeline_telemetry_window_matches():
    jp = JPipeline(telemetry_window=3)
    tp = TPipeline(telemetry_window=3, device="cpu")
    for n in SCENARIOS:
        _assert_same_output(jp.run(*jboutique.scenario(n)),
                            tp.run(*tboutique.scenario(n)))


@pytest.mark.parametrize("warm", [False, True])
def test_pipeline_plan_matches(warm):
    jp, tp = JPipeline(), TPipeline(device="cpu")
    initial = None
    for n in (1, 3, 4):
        jplan, jout = jp.plan(*jboutique.scenario(n), initial=initial)
        tplan, tout = tp.plan(*tboutique.scenario(n), initial=initial)
        _assert_same_output(jout, tout)
        assert to_port(jplan) == tplan
        assert tplan.feasible
        if warm:
            initial = {p.service: (p.flavour, p.node)
                       for p in tplan.placements}
    # an explicit scheduler overrides the default
    jplan, _ = jp.plan(*jboutique.scenario(2),
                       scheduler=JScheduler(JConfig.oracle()))
    tplan, _ = tp.plan(*tboutique.scenario(2),
                       scheduler=TScheduler(TConfig.oracle(), device="cpu"))
    assert to_port(jplan) == tplan


def test_adapter_dialects_match():
    jout = JPipeline().run(*jboutique.scenario(5))
    tout = TPipeline(device="cpu").run(*tboutique.scenario(5))
    assert tadapter.to_json(tout.constraints) == jadapter.to_json(
        jout.constraints)
    assert tadapter.to_kubernetes(tout.constraints) == jadapter.to_kubernetes(
        jout.constraints)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.8, 1.0])
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_quantile_torch_backend_matches(n, alpha):
    rng = np.random.default_rng(n)
    values = np.round(rng.uniform(0, 50, size=n), 1)   # with ties
    want = jquantile(values, alpha, backend="jax")
    assert tquantile(values, alpha, backend="torch", device="cpu") == want
    assert tquantile(values, alpha) == want


def test_engine_torch_tau_backend_matches():
    jp = JPipeline()
    tp = TPipeline(device="cpu")
    for n in SCENARIOS:
        jout = jp.run(*jboutique.scenario(n))
        if tp._engine is None:
            tp._ensure_engine()
        tp._engine.tau_backend, tp._engine.tau_device = "torch", "cpu"
        _assert_same_output(jout, tp.run(*tboutique.scenario(n)))


def test_pipeline_plan_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = TPipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.plan(*tboutique.scenario(1))
    assert pipe.iteration == 0          # raised before the constraint pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tquantile(np.arange(3.0), 0.5, backend="torch")
    plan, _ = TPipeline(device="cpu").plan(*tboutique.scenario(1))
    assert plan.feasible
