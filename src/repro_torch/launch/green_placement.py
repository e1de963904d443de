"""Green placement: the paper's constraint pipeline driving accelerator-pod
job placement — the framework-level integration (beyond-paper layer).

Port of ``repro.launch.green_placement``.  Mapping:
  service s    -> a JOB: one (arch x shape) cell (train step or serve step)
  flavour f    -> an execution flavour of the job (dtype/remat/microbatch
                  tuning variants with different energy profiles)
  node n       -> a pod of accelerators in a region with a carbon intensity
  monitoring   -> the job's roofline record: its compute, memory and
                  collective seconds per step give computation energy;
                  the traffic between jobs gives communication energy
                  (Eq. 13 with k = the pod-to-pod wire's intensity)

The SAME GreenConstraintPipeline and GreenScheduler used for the paper's
case study run here unchanged — AvoidNode keeps carbon-hungry jobs off
dirty-grid pods, Affinity co-locates chatty jobs (e.g. disaggregated
prefill/decode pairs exchanging KV caches) on one pod so their traffic
stays inside it.

Every planner here (the green scheduler, the baseline plan ``place``
prices against, ``run_continuum``'s what-if planner) and the default
pipeline run on ``GreenPlacement.device``: the card by default, raising
when there is none; the CPU only with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.core.energy import EnergyEstimator
from repro_torch.core.library import ConstraintLibrary
from repro_torch.core.pipeline import GeneratorOutput, GreenConstraintPipeline
from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig, plan_emissions
from repro_torch.core.types import (
    Application,
    CommunicationLink,
    DeploymentPlan,
    EnergySample,
    Flavour,
    FlavourRequirements,
    Infrastructure,
    MonitoringData,
    Node,
    NodeCapabilities,
    Service,
    TrafficSample,
)

# The fleet model of the reference, copied so that decisions match.  These
# constants describe the pods being PLACED (v5e-class chips: idle floor +
# MXU-utilisation-scaled dynamic power, 256 chips a pod), not the card the
# planner runs on.
CHIP_IDLE_WATTS = 75.0
CHIP_BUSY_WATTS = 250.0
CHIPS_PER_POD = 256
# Pod-to-pod transmission intensity (kWh/GB) — Eq. 13's k.
K_DCN_KWH_PER_GB = 0.001875
# Jobs a pod can host concurrently (chip-slice multiplexing) — what makes
# Affinity co-location (prefill+decode on one pod) physically possible.
JOBS_PER_POD = 4


@dataclass(frozen=True)
class PodSpec:
    """An accelerator pod in a region."""

    pod_id: str
    region: str
    carbon: Optional[float] = None        # pinned CI, else from the signal
    cost_per_chip_hour: float = 1.2
    chips: int = CHIPS_PER_POD
    # Hourly CI forecast (hour 0 = now) for the TimeShift module.
    carbon_forecast: Tuple[float, ...] = ()


@dataclass(frozen=True)
class JobSpec:
    """One schedulable job: an (arch x shape) cell with tuning flavours.

    ``roofline`` maps flavour name -> the roofline record of the cell under
    that tuning (``compute_s``, ``memory_s``, ``collective_s`` per step: the
    monitoring source).  ``steps_per_h`` scales per-step energy to the
    observation window.
    """

    job_id: str
    arch: str
    shape: str
    roofline: Mapping[str, Mapping]       # flavour -> roofline dict
    flavours_order: Tuple[str, ...] = ()
    steps_per_h: float = 3600.0
    must_deploy: bool = True
    # Batch jobs (training, offline eval) tolerate postponement; serving
    # jobs are time-critical (0).  Feeds the TimeShift module.
    delay_tolerance_h: int = 0


@dataclass(frozen=True)
class TrafficSpec:
    """Cross-job traffic (e.g. prefill -> decode KV-cache handoff)."""

    source: str
    target: str
    gb_per_h: float


def job_energy_kwh(roof: Mapping, steps_per_h: float,
                   chips: int = CHIPS_PER_POD) -> float:
    """Computation energy of one job over an hour window.

    Step time is the dominant roofline term of the cell; dynamic power
    scales with compute utilisation (compute_s / step_s), on top of the
    idle floor for the busy fraction of the window — the same
    hardware-agnostic statistical profile role as Eq. 1.
    """
    step_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    if step_s <= 0:
        return 0.0
    util = roof["compute_s"] / step_s
    busy_frac = min(step_s * steps_per_h, 3600.0) / 3600.0
    watts = CHIP_IDLE_WATTS + (CHIP_BUSY_WATTS - CHIP_IDLE_WATTS) \
        * util * busy_frac
    return chips * watts / 1000.0


def _order(job: JobSpec) -> Tuple[str, ...]:
    return job.flavours_order or tuple(job.roofline)


def build_application(jobs: Sequence[JobSpec],
                      traffic: Sequence[TrafficSpec]) -> Application:
    services = []
    for j in jobs:
        order = _order(j)
        services.append(Service(
            component_id=j.job_id,
            description=f"{j.arch} x {j.shape}",
            must_deploy=j.must_deploy,
            flavours=tuple(
                Flavour(f, requirements=FlavourRequirements(cpu=1.0))
                for f in order
            ),
            flavours_order=order,
            delay_tolerance_h=j.delay_tolerance_h,
        ))
    links = tuple(CommunicationLink(t.source, t.target) for t in traffic)
    return Application("tpu-fleet", tuple(services), links)


def build_infrastructure(pods: Sequence[PodSpec]) -> Infrastructure:
    nodes = tuple(
        Node(
            node_id=p.pod_id,
            region=p.region,
            carbon=p.carbon,
            carbon_forecast=p.carbon_forecast,
            cost_per_cpu_hour=p.cost_per_chip_hour,
            capabilities=NodeCapabilities(cpu=float(JOBS_PER_POD),
                                          ram_gb=1024.0),
        )
        for p in pods
    )
    return Infrastructure("pods", nodes)


def build_monitoring(jobs: Sequence[JobSpec],
                     traffic: Sequence[TrafficSpec],
                     window_h: int = 24) -> MonitoringData:
    """Synthesise the monitoring window from the jobs' roofline records."""
    energy = []
    tr = []
    for j in jobs:
        for f in _order(j):
            kwh = job_energy_kwh(j.roofline[f], j.steps_per_h)
            for t in range(window_h):
                energy.append(EnergySample(j.job_id, f, kwh, t=t))
    flavour_of = {j.job_id: _order(j)[0] for j in jobs}
    for ts in traffic:
        for t in range(window_h):
            tr.append(TrafficSample(
                source=ts.source, source_flavour=flavour_of[ts.source],
                target=ts.target, request_volume=ts.gb_per_h,
                request_size_gb=1.0, t=t,
            ))
    return MonitoringData(energy=tuple(energy), traffic=tuple(tr))


@dataclass
class GreenPlacement:
    """End-to-end: jobs + pods + grid signal -> constraints + placement.

    ``device`` is where every planner and the default pipeline run: None
    means the card (raising here when there is none), ``"cpu"`` the CPU.
    """

    pipeline: Optional[GreenConstraintPipeline] = None
    scheduler: Optional[GreenScheduler] = None
    device: Optional[str] = None

    def __post_init__(self):
        resolve_device(self.device)
        if self.scheduler is None:
            self.scheduler = GreenScheduler(SchedulerConfig.green(),
                                            device=self.device)
        if self.pipeline is None:
            # alpha = 0.5: a pod fleet has orders of magnitude fewer
            # jobs/links than a 100-service microservice app, and Eq. 5
            # keeps only ~floor(n(1-alpha)) candidates — with the paper's
            # 0.8 a 2-link fleet can never produce an Affinity constraint.
            # Sect. 5.6's threshold trade-off favours a lower quantile on
            # small candidate spaces.  Training fleets get the TimeShift
            # batch extension: train jobs are delay-tolerant by nature.
            self.pipeline = GreenConstraintPipeline(
                estimator=EnergyEstimator(k_kwh_per_gb=K_DCN_KWH_PER_GB),
                alpha=0.5, library=ConstraintLibrary.with_batch_extension(),
                device=self.device)

    def place(
        self,
        jobs: Sequence[JobSpec],
        pods: Sequence[PodSpec],
        traffic: Sequence[TrafficSpec] = (),
        carbon_signal=None,
    ) -> Tuple[DeploymentPlan, GeneratorOutput, Dict[str, float]]:
        app = build_application(jobs, traffic)
        infra = build_infrastructure(pods)
        if carbon_signal is not None:
            self.pipeline.gatherer.signal = carbon_signal
        mon = build_monitoring(jobs, traffic)

        out = self.pipeline.run(app, infra, mon)

        # The pipeline folds the enriched descriptions and Eq. 1/2
        # profiles into ONE PlacementProblem; both schedulers share it.
        app, infra_e = out.app, out.infra
        comp, comm = out.computation, out.communication
        problem = self.pipeline.problem_for(out)
        plan = self.scheduler.plan(problem).plan

        baseline = GreenScheduler(SchedulerConfig.baseline(),
                                  device=self.device).plan(problem).plan
        a_g = {p.service: (p.flavour, p.node) for p in plan.placements}
        a_b = {p.service: (p.flavour, p.node) for p in baseline.placements}
        stats = {
            "green_g_per_window": plan_emissions(app, infra_e, a_g, comp, comm),
            "baseline_g_per_window": plan_emissions(app, infra_e, a_b, comp,
                                                    comm),
        }
        stats["saved_frac"] = 1.0 - (
            stats["green_g_per_window"]
            / max(stats["baseline_g_per_window"], 1e-12))
        return plan, out, stats

    def run_continuum(
        self,
        jobs: Sequence[JobSpec],
        pods: Sequence[PodSpec],
        traffic: Sequence[TrafficSpec] = (),
        *,
        carbon_trace=None,
        start: int = 24,
        ticks: int = 168,
        runtime_config=None,
    ):
        """Drive the pod fleet through the continuum adaptive loop.

        Same job->service / pod->node mapping as :meth:`place`, but instead
        of one static placement the :class:`ContinuumRuntime` replans each
        tick against the pods' regional carbon traces — batched what-if
        over forecast ensembles, warm-started local search, hysteresis
        switching — with its planner on ``device``.  Returns the
        :class:`ContinuumResult`.
        """
        from repro_torch.continuum import (
            CarbonTrace, ContinuumRuntime, REGION_PRESETS, RuntimeConfig,
            WhatIfPlanner, WorkloadTrace,
        )

        app = build_application(jobs, traffic)
        # seed flavour energies from the rooflines so the workload trace
        # drifts around the REAL per-flavour profiles instead of a flat
        # cpu-proportional default
        app = app.with_services([
            dataclasses.replace(svc, flavours=tuple(
                fl.with_energy(job_energy_kwh(j.roofline[fl.name],
                                              j.steps_per_h))
                for fl in svc.flavours))
            for j, svc in zip(jobs, app.services)
        ])
        infra = build_infrastructure(pods)
        # a pinned PodSpec.carbon would freeze the Energy Mix Gatherer for
        # the whole run (enrich skips nodes whose carbon is already set);
        # in the continuum the TRACE is the carbon authority for every pod
        infra = infra.with_nodes([
            dataclasses.replace(n, carbon=None, carbon_forecast=())
            for n in infra.nodes
        ])
        if carbon_trace is None:
            regions = {p.region for p in pods}
            missing = regions - set(REGION_PRESETS)
            if missing:
                raise ValueError(
                    f"no carbon trace and no preset for regions {missing}")
            carbon_trace = CarbonTrace(
                {r: REGION_PRESETS[r] for r in regions},
                hours=start + ticks + 24)
        workload = WorkloadTrace(app, base_kwh_per_cpu=CHIP_IDLE_WATTS
                                 * CHIPS_PER_POD / 1000.0)
        # the green profile's objective is CI-blind; what-if branches only
        # diverge when the emission term is priced, so ensure it is
        cfg = dataclasses.replace(
            self.scheduler.config,
            emission_weight=max(self.scheduler.config.emission_weight, 1.0))
        runtime = ContinuumRuntime(
            app, infra, carbon_trace, workload,
            config=runtime_config or RuntimeConfig(),
            pipeline=self.pipeline,
            planner=WhatIfPlanner(GreenScheduler(cfg, device=self.device)),
        )
        return runtime.run(start=start, ticks=ticks)
