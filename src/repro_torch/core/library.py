"""Constraint Library (Sect. 4.2).

Each constraint type is a self-contained module that knows how to
  * enumerate candidate constraints and their estimated impact Em,
  * instantiate the constraint artefact,
  * produce the human-readable explanation used by the Explainability
    Generator (Sect. 4.6).

The library is modular and extensible: registering a new module adds a new
constraint type with no changes to the generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .types import (
    Affinity,
    Application,
    AvoidNode,
    Constraint,
    Infrastructure,
    Node,
    Service,
    Subnet,
    TimeShift,
)

# The paper's Table 1 energies are labelled kWh but its §5.4 savings numbers
# imply a /1000 scale (Wh) when multiplied by gCO2eq/kWh.  Weights are
# scale-invariant (Eq. 11 normalises); the report scale below makes the
# printed savings match the paper's Explainability Report exactly.
REPORT_SCALE = 1e-3


@dataclass(frozen=True)
class Candidate:
    """A potential constraint with its estimated environmental impact Em
    (gCO2eq over the observation window)."""

    impact_g: float
    payload: Tuple


def subnet_compatible(service: Service, node: Node) -> bool:
    """Network-placement compatibility (Sect. 4.3): a private service cannot
    be deployed on a public node."""
    want = service.requirements.subnet
    if want == Subnet.ANY:
        return True
    return want == node.capabilities.subnet


class ConstraintModule:
    """Interface for a Constraint Library module."""

    name: str = "abstract"

    def candidates(
        self,
        app: Application,
        infra: Infrastructure,
        computation: Mapping[Tuple[str, str], float],
        communication: Mapping[Tuple[str, str, str], float],
        flavour_scope: str,
    ) -> List[Candidate]:
        raise NotImplementedError

    def instantiate(
        self,
        cand: Candidate,
        app: Application,
        infra: Infrastructure,
        iteration: int,
    ) -> Constraint:
        raise NotImplementedError


def _scoped_flavours(service: Service, flavour_scope: str) -> Sequence[str]:
    """Which flavours of a service generate constraints.

    ``current`` — only the flavour currently deployed / preferred (the
    paper's experiments constrain the monitored configuration, hence e.g.
    only ``frontend large`` appears in Scenario 1);
    ``all`` — every flavour with an energy profile.
    """
    if flavour_scope == "current":
        return (service.flavours_order[0],)
    return tuple(f.name for f in service.flavours)


class AvoidNodeModule(ConstraintModule):
    """Definition 1 / Eq. 3:
    highConsumptionService(s, f, n) if energyProfile(s,f) * carbon(n) > tau.
    """

    name = "avoidNode"

    def candidates(self, app, infra, computation, communication, flavour_scope):
        out: List[Candidate] = []
        for svc in app.services:
            for fname in _scoped_flavours(svc, flavour_scope):
                profile = computation.get((svc.component_id, fname))
                if profile is None:
                    continue  # never observed -> no data-driven constraint
                for node in infra.nodes:
                    if node.carbon is None or not subnet_compatible(svc, node):
                        continue
                    impact = profile * node.carbon
                    out.append(
                        Candidate(impact, (svc.component_id, fname,
                                           node.node_id, profile))
                    )
        return out

    def instantiate(self, cand, app, infra, iteration):
        service, flavour, node_id, profile = cand.payload
        node = infra.node(node_id)
        savings = _avoid_savings(profile, node, infra)
        text = (
            f'An "AvoidNode" constraint was generated for the deployment of '
            f'the "{service}" service in the "{flavour}" flavour on the '
            f'"{node_id}" node. This decision was driven by the high resource '
            f'consumption of the selected flavour combined with the poor '
            f'energy mix of the target node.\n'
            f'The estimated emissions savings resulting from avoiding this '
            f'deployment range between {savings[1]:.2f} gCO2eq and '
            f'{savings[0]:.2f} gCO2eq.'
        )
        return AvoidNode(
            service=service,
            flavour=flavour,
            node=node_id,
            impact_g=cand.impact_g,
            generated_at=iteration,
            explanation=text,
            savings_range_g=savings,
        )


def _avoid_savings(
    profile_kwh: float, node: Node, infra: Infrastructure
) -> Tuple[float, float]:
    """Savings range (Sect. 5.4): lower bound = relocating to the next-worse
    node, upper bound = relocating to the optimal (lowest-CI) node."""
    assert node.carbon is not None
    others = sorted(
        {n.carbon for n in infra.nodes
         if n.carbon is not None and n.carbon < node.carbon},
        reverse=True,
    )
    if not others:  # already the greenest node: nothing to gain
        return (0.0, 0.0)
    next_worse, best = others[0], others[-1]
    lo = profile_kwh * (node.carbon - next_worse) * REPORT_SCALE
    hi = profile_kwh * (node.carbon - best) * REPORT_SCALE
    return (lo, hi)


class AffinityModule(ConstraintModule):
    """Definition 2 / Eq. 4:
    highConsumptionConnection(s, f, z) if energyProfile(s,f,z) > tau.

    The impact Em of an affinity constraint is the expected emission of the
    transmission, i.e. the communication energy priced at the infrastructure's
    mean carbon intensity (the wire crosses the grid, not a single node).
    """

    name = "affinity"

    def candidates(self, app, infra, computation, communication, flavour_scope):
        cis = [n.carbon for n in infra.nodes if n.carbon is not None]
        mean_ci = sum(cis) / len(cis) if cis else 0.0
        scoped = {
            s.component_id: set(_scoped_flavours(s, flavour_scope))
            for s in app.services
        }
        out: List[Candidate] = []
        for (s, f, z), energy in communication.items():
            if s == z:  # dif(s, z)
                continue
            if f not in scoped.get(s, set()):
                continue
            out.append(Candidate(energy * mean_ci, (s, f, z, energy)))
        return out

    def instantiate(self, cand, app, infra, iteration):
        s, f, z, energy = cand.payload
        # Savings range: co-location removes the inter-node traffic entirely
        # (upper bound = priced at the dirtiest node's CI, lower at the
        # greenest's).
        cis = sorted(n.carbon for n in infra.nodes if n.carbon is not None)
        lo = energy * cis[0] * REPORT_SCALE if cis else 0.0
        hi = energy * cis[-1] * REPORT_SCALE if cis else 0.0
        text = (
            f'An "Affinity" constraint was generated between the "{s}" '
            f'service in the "{f}" flavour and the "{z}" service. This '
            f'decision was driven by the high volume of data exchanged '
            f'between the two services, whose transmission would generate '
            f'significant energy consumption if deployed on separate nodes.\n'
            f'The estimated emissions savings resulting from co-locating '
            f'these services range between {lo:.2f} gCO2eq and '
            f'{hi:.2f} gCO2eq.'
        )
        return Affinity(
            service=s,
            flavour=f,
            other=z,
            impact_g=cand.impact_g,
            generated_at=iteration,
            explanation=text,
            savings_range_g=(lo, hi),
        )


class TimeShiftModule(ConstraintModule):
    """Batch-processing extension (Definition 3, the paper's §6 future
    work): for a delay-tolerant service, postponing execution to the
    within-tolerance minimum of the node's carbon-intensity forecast.

    highConsumptionWindow(s, f, n) if
      energyProfile(s, f) * (carbon(n) - min_{t <= tolerance} forecast(n, t))
          > tau
    The impact Em is the expected emission saving of the shift itself.
    """

    name = "timeShift"

    def candidates(self, app, infra, computation, communication,
                   flavour_scope):
        out: List[Candidate] = []
        for svc in app.services:
            if svc.delay_tolerance_h <= 0:
                continue
            for fname in _scoped_flavours(svc, flavour_scope):
                profile = computation.get((svc.component_id, fname))
                if profile is None:
                    continue
                for node in infra.nodes:
                    if node.carbon is None or not node.carbon_forecast:
                        continue
                    if not subnet_compatible(svc, node):
                        continue
                    horizon = node.carbon_forecast[
                        : svc.delay_tolerance_h + 1]
                    best_t = min(range(len(horizon)), key=horizon.__getitem__)
                    gain_ci = node.carbon - horizon[best_t]
                    if best_t == 0 or gain_ci <= 0:
                        continue
                    impact = profile * gain_ci
                    out.append(Candidate(
                        impact,
                        (svc.component_id, fname, node.node_id, profile,
                         best_t, gain_ci),
                    ))
        return out

    def instantiate(self, cand, app, infra, iteration):
        service, flavour, node_id, profile, shift_h, gain_ci = cand.payload
        saving = profile * gain_ci * REPORT_SCALE
        text = (
            f'A "TimeShift" constraint was generated for the execution of '
            f'the "{service}" service in the "{flavour}" flavour on the '
            f'"{node_id}" node. The service is delay-tolerant and the '
            f'node\'s carbon-intensity forecast reaches its minimum in '
            f'{shift_h} hour(s).\n'
            f'The estimated emissions savings resulting from postponing '
            f'this execution amount to {saving:.2f} gCO2eq.'
        )
        return TimeShift(
            service=service,
            flavour=flavour,
            node=node_id,
            shift_h=shift_h,
            impact_g=cand.impact_g,
            generated_at=iteration,
            explanation=text,
            savings_range_g=(saving, saving),
        )


@dataclass
class ConstraintLibrary:
    """Registry of constraint modules (extensible, Sect. 4.2)."""

    modules: Dict[str, ConstraintModule] = field(default_factory=dict)

    @classmethod
    def default(cls) -> "ConstraintLibrary":
        lib = cls()
        lib.register(AvoidNodeModule())
        lib.register(AffinityModule())
        return lib

    @classmethod
    def with_batch_extension(cls) -> "ConstraintLibrary":
        """default() + the TimeShift batch-processing module (§6)."""
        lib = cls.default()
        lib.register(TimeShiftModule())
        return lib

    def register(self, module: ConstraintModule) -> None:
        self.modules[module.name] = module

    def __iter__(self):
        return iter(self.modules.values())
