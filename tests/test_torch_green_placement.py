"""The port's green placement against the JAX package's, on the CPU.

The cases of tests/test_green_placement.py and the ``run_continuum`` smoke
of tests/test_continuum.py run through both packages' ``GreenPlacement``
(the port's with ``device="cpu"``): the plans, the generated constraints
(kind, targets, impact, weights, explanation) and the ``stats`` must be
equal with no tolerance, and so must every tick record but its timings
and ``compiles``.  The ``x64`` fixture aliases the reference planner's
missing ``jax.experimental.enable_x64`` for each test's duration.
"""
import dataclasses

import pytest
import torch

from repro.launch import green_placement as jgp
from repro_torch.launch import green_placement as tgp

from test_green_placement import ROOF_DECODE, ROOF_TRAIN
from test_torch_continuum import assert_same_run
from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)


def _jobs(m):
    return [
        m.JobSpec("train-a", "yi-9b", "train_4k", {"perf": ROOF_TRAIN}),
        m.JobSpec("prefill", "yi-9b", "prefill_32k",
                  {"perf": {"compute_s": 0.37, "memory_s": 2.5,
                            "collective_s": 1.15}}, steps_per_h=900.0),
        m.JobSpec("decode", "yi-9b", "decode_32k", {"perf": ROOF_DECODE},
                  steps_per_h=3.6e6),
    ]


def _pods(m):
    return [
        m.PodSpec("clean", "france", carbon=16.0, cost_per_chip_hour=1.3),
        m.PodSpec("mid", "finland", carbon=120.0, cost_per_chip_hour=1.1),
        m.PodSpec("dirty", "texas", carbon=410.0, cost_per_chip_hour=0.8),
    ]


def _traffic(m):
    return [m.TrafficSpec("prefill", "decode", gb_per_h=7200.0),
            m.TrafficSpec("train-a", "prefill", gb_per_h=40.0)]


def _fleet_full(m):
    jobs = [m.JobSpec(f"train-{i}", "yi-9b", "train_4k", {"perf": ROOF_TRAIN})
            for i in range(5)]
    jobs.append(m.JobSpec("opt", "yi-9b", "train_4k", {"perf": ROOF_TRAIN},
                          must_deploy=False))
    return jobs, [m.PodSpec("only", "france", carbon=16.0)]


# the four placements of tests/test_green_placement.py, by package module
CASES = {
    "avoids_dirty_pod": lambda m: (_jobs(m), _pods(m), ()),
    "affinity_colocates": lambda m: (_jobs(m), _pods(m), _traffic(m)),
    "fleet_full_infeasible": lambda m: (*_fleet_full(m), ()),
    "fleet_full_drops_optional": lambda m: (
        _fleet_full(m)[0][:4] + _fleet_full(m)[0][-1:], _fleet_full(m)[1], ()),
}


def test_fleet_model_constants_are_the_reference_ones():
    for name in ("CHIP_IDLE_WATTS", "CHIP_BUSY_WATTS", "CHIPS_PER_POD",
                 "K_DCN_KWH_PER_GB", "JOBS_PER_POD"):
        assert getattr(tgp, name) == getattr(jgp, name), name


@pytest.mark.parametrize("roof,steps", [
    (ROOF_TRAIN, 3600.0), (ROOF_DECODE, 3.6e6), (ROOF_TRAIN, 10.0),
    ({"compute_s": 0.0, "memory_s": 0.0, "collective_s": 0.0}, 1.0)])
def test_job_energy_matches(roof, steps):
    assert tgp.job_energy_kwh(roof, steps) == jgp.job_energy_kwh(roof, steps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_functions_match(case):
    jjobs, jpods, jtraffic = CASES[case](jgp)
    tjobs, tpods, ttraffic = CASES[case](tgp)
    assert tgp.build_application(tjobs, ttraffic) == \
        to_port(jgp.build_application(jjobs, jtraffic))
    assert tgp.build_infrastructure(tpods) == \
        to_port(jgp.build_infrastructure(jpods))
    assert tgp.build_monitoring(tjobs, ttraffic) == \
        to_port(jgp.build_monitoring(jjobs, jtraffic))


def place_both(case):
    jplan, jout, jstats = jgp.GreenPlacement().place(*CASES[case](jgp))
    tplan, tout, tstats = tgp.GreenPlacement(device="cpu").place(
        *CASES[case](tgp))
    return (jplan, jout, jstats), (tplan, tout, tstats)


@pytest.mark.parametrize("case", sorted(CASES))
def test_place_matches_jax(case):
    (jplan, jout, jstats), (tplan, tout, tstats) = place_both(case)
    assert tplan == to_port(jplan)
    assert [(c.kind, c.key()) for c in tout.constraints] == \
        [(c.kind, c.key()) for c in jout.constraints]
    assert list(tout.constraints) == to_port(list(jout.constraints))
    assert tstats == jstats


def test_place_decisions_hold_the_reference_assertions():
    """The port's plans satisfy what tests/test_green_placement.py asserts
    of the reference's."""
    _, (plan, out, stats) = place_both("avoids_dirty_pod")
    placed = {p.service: p.node for p in plan.placements}
    assert plan.feasible and placed["train-a"] != "dirty"
    assert stats["saved_frac"] > 0.0
    assert any(c.kind == "avoidNode" for c in out.constraints)
    _, (plan, out, _) = place_both("affinity_colocates")
    placed = {p.service: p.node for p in plan.placements}
    assert any(c.kind == "affinity" for c in out.constraints)
    assert placed["prefill"] == placed["decode"]
    _, (plan, _, _) = place_both("fleet_full_infeasible")
    assert not plan.feasible
    _, (plan, _, _) = place_both("fleet_full_drops_optional")
    assert plan.feasible and plan.skipped_services == ("opt",)


def _continuum_inputs(m):
    roof = {"tuned": {"compute_s": 1.0, "memory_s": 2.0,
                      "collective_s": 0.5},
            "default": {"compute_s": 1.3, "memory_s": 2.6,
                        "collective_s": 0.6}}
    jobs = [m.JobSpec(f"job{i}", "yi-9b", "train_4k", roofline=roof,
                      flavours_order=("tuned", "default"), steps_per_h=100.0)
            for i in range(3)]
    pods = [m.PodSpec("pod-ss", "solar-south"),
            m.PodSpec("pod-wn", "wind-north")]
    return jobs, pods, [m.TrafficSpec("job0", "job1", gb_per_h=20.0)]


@pytest.mark.parametrize("ticks", [6, 24])
def test_run_continuum_matches_jax(ticks):
    jres = jgp.GreenPlacement().run_continuum(*_continuum_inputs(jgp),
                                              ticks=ticks)
    tres = tgp.GreenPlacement(device="cpu").run_continuum(
        *_continuum_inputs(tgp), ticks=ticks)
    assert len(tres.ticks) == ticks and len(tres.final_assignment) == 3
    assert tres.total_emissions_g > 0
    assert_same_run(jres, tres)


def test_cpu_placement_keeps_every_planner_on_the_cpu(monkeypatch):
    """With ``device="cpu"``: the default pipeline, the green and baseline
    schedulers and run_continuum's planner are all on the CPU, and place
    and run_continuum run with the card reported absent."""
    built = []

    class Recording(tgp.GreenScheduler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(tgp, "GreenScheduler", Recording)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gp = tgp.GreenPlacement(device="cpu")
    assert gp.pipeline.device == "cpu" and gp.scheduler.device == "cpu"
    plan, _, _ = gp.place(*CASES["avoids_dirty_pod"](tgp))
    assert plan.feasible
    res = gp.run_continuum(*_continuum_inputs(tgp), ticks=2)
    assert len(res.ticks) == 2
    # the green scheduler, place's baseline, run_continuum's planner
    assert len(built) == 3
    assert [s.device for s in built] == ["cpu"] * 3
    assert [s.config for s in built[:2]] == [
        tgp.SchedulerConfig.green(), tgp.SchedulerConfig.baseline()]
    assert built[2].config == dataclasses.replace(
        tgp.SchedulerConfig.green(), emission_weight=1.0)


def test_placement_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.GreenPlacement()
