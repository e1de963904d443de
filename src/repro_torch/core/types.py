"""Domain model for the Green-aware Constraint Generator.

Mirrors Sect. 3.2 of the paper: Application Description (services, flavours,
requirements), Infrastructure Description (nodes: capabilities + profile),
and the constraint/deployment-plan artefacts exchanged with the scheduler.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple


class Subnet(enum.Enum):
    PUBLIC = "public"
    PRIVATE = "private"
    ANY = "any"


@dataclass(frozen=True)
class FlavourRequirements:
    """Flavour-level requirements: compute resources + QoS (Sect. 3.2)."""

    cpu: float = 1.0          # vCPUs
    ram_gb: float = 1.0
    storage_gb: float = 0.0
    availability: float = 0.0  # minimum availability in [0, 1]


@dataclass(frozen=True)
class Flavour:
    name: str
    requirements: FlavourRequirements = field(default_factory=FlavourRequirements)
    # Energy property, filled in by the Energy Estimator (kWh per observation
    # window).  ``None`` until estimated.
    energy_kwh: Optional[float] = None

    def with_energy(self, energy_kwh: float) -> "Flavour":
        return dataclasses.replace(self, energy_kwh=energy_kwh)


@dataclass(frozen=True)
class ServiceRequirements:
    """Service-level (flavour-independent) requirements."""

    subnet: Subnet = Subnet.ANY
    needs_firewall: bool = False
    needs_ssl: bool = False


@dataclass(frozen=True)
class Service:
    component_id: str
    description: str = ""
    must_deploy: bool = True
    flavours: Tuple[Flavour, ...] = ()
    # Preference list over flavour names; first entry = most preferred.
    flavours_order: Tuple[str, ...] = ()
    requirements: ServiceRequirements = field(default_factory=ServiceRequirements)
    # Batch-processing extension (the paper's §6 future work): how many
    # hours the service's execution may be postponed.  0 = time-critical.
    delay_tolerance_h: int = 0

    def __post_init__(self) -> None:
        if not self.flavours_order and self.flavours:
            object.__setattr__(
                self, "flavours_order", tuple(f.name for f in self.flavours)
            )

    def flavour(self, name: str) -> Flavour:
        for f in self.flavours:
            if f.name == name:
                return f
        raise KeyError(f"{self.component_id}: unknown flavour {name!r}")

    @property
    def preferred_flavour(self) -> Flavour:
        return self.flavour(self.flavours_order[0])


@dataclass(frozen=True)
class CommunicationLink:
    """Directed communication s -> z with its QoS requirements and the
    communication-energy property estimated by the Energy Estimator."""

    source: str
    target: str
    max_latency_ms: Optional[float] = None
    min_availability: float = 0.0
    # Filled by the Energy Estimator (kWh per observation window, Eq. 13).
    energy_kwh: Optional[float] = None

    def with_energy(self, energy_kwh: float) -> "CommunicationLink":
        return dataclasses.replace(self, energy_kwh=energy_kwh)


@dataclass(frozen=True)
class Application:
    """Application description A (Sect. 3.2)."""

    name: str
    services: Tuple[Service, ...]
    links: Tuple[CommunicationLink, ...] = ()

    def service(self, component_id: str) -> Service:
        for s in self.services:
            if s.component_id == component_id:
                return s
        raise KeyError(f"unknown service {component_id!r}")

    def with_services(self, services: Sequence[Service]) -> "Application":
        return dataclasses.replace(self, services=tuple(services))

    def with_links(self, links: Sequence[CommunicationLink]) -> "Application":
        return dataclasses.replace(self, links=tuple(links))


@dataclass(frozen=True)
class NodeCapabilities:
    cpu: float = 64.0
    ram_gb: float = 256.0
    storage_gb: float = 1024.0
    bandwidth_gbps: float = 10.0
    availability: float = 0.999
    firewall: bool = True
    ssl: bool = True
    subnet: Subnet = Subnet.PUBLIC


@dataclass(frozen=True)
class Node:
    """Infrastructure node: capabilities + profile (Sect. 3.2)."""

    node_id: str
    capabilities: NodeCapabilities = field(default_factory=NodeCapabilities)
    cost_per_cpu_hour: float = 0.0
    # Carbon intensity in gCO2eq/kWh, enriched by the Energy Mix Gatherer.
    carbon: Optional[float] = None
    region: Optional[str] = None
    # Hourly CI forecast (gCO2eq/kWh, hour 0 = now), enriched by the
    # Energy Mix Gatherer when the grid signal provides one.  Consumed by
    # the TimeShift constraint module (batch-processing extension).
    carbon_forecast: Tuple[float, ...] = ()

    def with_carbon(self, carbon: float) -> "Node":
        return dataclasses.replace(self, carbon=carbon)

    def with_forecast(self, forecast: Sequence[float]) -> "Node":
        return dataclasses.replace(self, carbon_forecast=tuple(forecast))


@dataclass(frozen=True)
class Infrastructure:
    name: str
    nodes: Tuple[Node, ...]

    def node(self, node_id: str) -> Node:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise KeyError(f"unknown node {node_id!r}")

    def with_nodes(self, nodes: Sequence[Node]) -> "Infrastructure":
        return dataclasses.replace(self, nodes=tuple(nodes))


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


def _fmt_weight(w: float) -> str:
    """Paper notation: three decimals, trailing zeros stripped, but always at
    least one decimal (``1.0``, ``0.636``)."""
    s = f"{w:.3f}".rstrip("0")
    return s + "0" if s.endswith(".") else s


@dataclass(frozen=True)
class Constraint:
    """A generated green-aware constraint.

    ``impact_g`` is the estimated environmental footprint Em (gCO2eq per
    observation window) that motivated the constraint; ``weight`` is the
    normalised importance w_i assigned by the Constraints Ranker;
    ``memory_weight`` is the KB validity weight mu.
    """

    kind: str = "abstract"         # "avoidNode" | "affinity" | extensions
    impact_g: float = 0.0
    weight: float = 1.0
    memory_weight: float = 1.0
    generated_at: int = 0          # iteration counter (KB timestamp t)
    explanation: str = ""
    # Estimated savings range [min, max] in gCO2eq if the constraint holds.
    savings_range_g: Tuple[float, float] = (0.0, 0.0)

    def key(self) -> Tuple[Any, ...]:
        raise NotImplementedError


@dataclass(frozen=True)
class AvoidNode(Constraint):
    """avoidNode(d(s, f), n)  — Definition 1."""

    service: str = ""
    flavour: str = ""
    node: str = ""
    kind: str = "avoidNode"

    def key(self) -> Tuple[Any, ...]:
        return ("avoidNode", self.service, self.flavour, self.node)

    def render(self) -> str:
        return (
            f"avoidNode(d({self.service}, {self.flavour}), "
            f"{self.node}, {_fmt_weight(self.weight)})."
        )


@dataclass(frozen=True)
class Affinity(Constraint):
    """affinity(d(s, f), d(z, _)) — Definition 2."""

    service: str = ""
    flavour: str = ""
    other: str = ""
    kind: str = "affinity"

    def key(self) -> Tuple[Any, ...]:
        return ("affinity", self.service, self.flavour, self.other)

    def render(self) -> str:
        return (
            f"affinity(d({self.service}, {self.flavour}), "
            f"d({self.other}, _), {_fmt_weight(self.weight)})."
        )


@dataclass(frozen=True)
class TimeShift(Constraint):
    """timeShift(d(s, f), n, t) — batch-processing extension (Definition 3).

    Suggests postponing the execution of delay-tolerant service s (flavour
    f) on node n by ``shift_h`` hours, where the node's carbon-intensity
    forecast reaches its within-tolerance minimum.  This implements the
    paper's §6 future work as a third Constraint Library module.
    """

    service: str = ""
    flavour: str = ""
    node: str = ""
    shift_h: int = 0
    kind: str = "timeShift"

    def key(self) -> Tuple[Any, ...]:
        return ("timeShift", self.service, self.flavour, self.node)

    def render(self) -> str:
        return (
            f"timeShift(d({self.service}, {self.flavour}), {self.node}, "
            f"{self.shift_h}, {_fmt_weight(self.weight)})."
        )


# ---------------------------------------------------------------------------
# Deployment plan (output of the scheduler)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Placement:
    service: str
    flavour: str
    node: str


@dataclass(frozen=True)
class DeploymentPlan:
    placements: Tuple[Placement, ...]
    skipped_services: Tuple[str, ...] = ()   # optional services left out
    total_emissions_g: float = 0.0
    feasible: bool = True
    notes: Tuple[str, ...] = ()

    def node_of(self, service: str) -> Optional[str]:
        for p in self.placements:
            if p.service == service:
                return p.node
        return None

    def flavour_of(self, service: str) -> Optional[str]:
        for p in self.placements:
            if p.service == service:
                return p.flavour
        return None


# ---------------------------------------------------------------------------
# Monitoring records (input to the Energy Estimator)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnergySample:
    """One monitored computation-energy observation (Kepler analogue)."""

    service: str
    flavour: str
    energy_kwh: float
    t: int = 0


@dataclass(frozen=True)
class TrafficSample:
    """One monitored communication observation (Istio analogue):
    request volume (requests per hour) and request size (GB)."""

    source: str
    source_flavour: str
    target: str
    request_volume: float
    request_size_gb: float
    t: int = 0


@dataclass(frozen=True)
class MonitoringData:
    energy: Tuple[EnergySample, ...] = ()
    traffic: Tuple[TrafficSample, ...] = ()
