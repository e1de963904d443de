"""Case study (Sect. 5.1): Google Online Boutique, extended with flavours.

Table 1 energy profiles, Table 2 (Europe) and Table 3 (US) infrastructures,
plus the synthetic traffic matrix used to derive communication energy
profiles (the paper's Istio measurements are not published; we use a
deterministic, documented stand-in whose *relative* magnitudes match the
paper's narrative: communication impacts are negligible next to computation
in the baseline and become dominant under the Scenario-5 x15000 traffic
amplification).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.core.types import (
    Application,
    CommunicationLink,
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

# --------------------------------------------------------------------------
# Table 1: services, flavours, energy profiles (kWh per observation window)
# --------------------------------------------------------------------------

TABLE1: Dict[str, List[Tuple[str, float]]] = {
    "frontend":       [("large", 1981.0), ("medium", 1585.0), ("tiny", 1189.0)],
    "checkout":       [("large", 134.0), ("tiny", 107.0)],
    "recommendation": [("large", 539.0), ("tiny", 431.0)],
    "productcatalog": [("large", 989.0), ("tiny", 791.0)],
    "ad":             [("tiny", 251.0)],
    "cart":           [("tiny", 546.0)],
    "shipping":       [("tiny", 98.0)],
    "currency":       [("tiny", 881.0)],
    "payment":        [("tiny", 34.0)],
    "email":          [("tiny", 50.0)],
}

# Resource requirements per flavour size (for the scheduler baseline).
_REQS = {
    "large": FlavourRequirements(cpu=2.0, ram_gb=4.0),
    "medium": FlavourRequirements(cpu=1.0, ram_gb=2.0),
    "tiny": FlavourRequirements(cpu=0.5, ram_gb=1.0),
}

# Online Boutique call graph: (source, target, requests/hour, GB/request).
# Deterministic stand-in for the Istio monitoring feed.
TRAFFIC: List[Tuple[str, str, float, float]] = [
    ("frontend", "productcatalog", 36000.0, 5.0e-4),   # product pages+images
    ("frontend", "cart",           12000.0, 5.0e-5),
    ("frontend", "recommendation", 18000.0, 2.0e-4),
    ("frontend", "currency",       24000.0, 2.0e-5),
    ("frontend", "ad",             18000.0, 1.0e-4),
    ("frontend", "checkout",        1200.0, 5.0e-5),
    ("frontend", "shipping",        6000.0, 2.0e-5),
    ("checkout", "payment",         1200.0, 1.0e-5),
    ("checkout", "email",           1200.0, 1.0e-4),
    ("checkout", "shipping",        1200.0, 2.0e-5),
    ("checkout", "currency",        2400.0, 2.0e-5),
    ("checkout", "cart",            1200.0, 5.0e-5),
    ("checkout", "productcatalog",  1200.0, 5.0e-4),
    ("recommendation", "productcatalog", 18000.0, 1.0e-3),
]


def build_application() -> Application:
    services = []
    for sid, flavs in TABLE1.items():
        flavours = tuple(
            Flavour(name, requirements=_REQS[name]) for name, _ in flavs
        )
        services.append(
            Service(
                component_id=sid,
                description=f"Online Boutique {sid} service",
                must_deploy=True,
                flavours=flavours,
                flavours_order=tuple(name for name, _ in flavs),
            )
        )
    links = tuple(
        CommunicationLink(source=s, target=z) for s, z, _, _ in TRAFFIC
    )
    return Application(name="online-boutique", services=services, links=links)


# --------------------------------------------------------------------------
# Tables 2 & 3: infrastructures (CI in gCO2eq/kWh)
# --------------------------------------------------------------------------

EUROPE_CI = {
    "france": 16.0, "spain": 88.0, "germany": 132.0,
    "greatbritain": 213.0, "italy": 335.0,
}
US_CI = {
    "washington": 244.0, "california": 235.0, "texas": 231.0,
    "florida": 570.0, "newyork": 236.0, "arizona": 229.0,
}


# Hourly cost per vCPU: dirtier regions tend to be cheaper (brown energy is
# cheap), which is what makes an environment-blind cost-driven baseline
# scheduler pile work onto high-CI nodes.
COSTS = {
    "france": 0.120, "spain": 0.095, "germany": 0.085,
    "greatbritain": 0.065, "italy": 0.050,
    "washington": 0.100, "california": 0.110, "texas": 0.070,
    "florida": 0.045, "newyork": 0.105, "arizona": 0.075,
}


def _infra(name: str, table: Dict[str, float]) -> Infrastructure:
    nodes = tuple(
        Node(node_id=nid, carbon=ci, region=nid,
             cost_per_cpu_hour=COSTS[nid],
             capabilities=NodeCapabilities(cpu=6.0, ram_gb=12.0))
        for nid, ci in table.items()
    )
    return Infrastructure(name=name, nodes=nodes)


def europe_infrastructure() -> Infrastructure:
    return _infra("europe", EUROPE_CI)


def us_infrastructure() -> Infrastructure:
    return _infra("us", US_CI)


# --------------------------------------------------------------------------
# Monitoring data synthesis
# --------------------------------------------------------------------------


def build_monitoring(
    n_samples: int = 24,
    jitter: float = 0.05,
    traffic_multiplier: float = 1.0,
    energy_overrides: Dict[Tuple[str, str], float] | None = None,
) -> MonitoringData:
    """Synthesise a monitoring window whose per-(s,f) MEAN equals Table 1
    exactly (samples come in +/-delta pairs), so Eq. 1 reproduces the paper's
    profiles bit-for-bit while still exercising the averaging path."""
    overrides = energy_overrides or {}
    energy: List[EnergySample] = []
    for sid, flavs in TABLE1.items():
        for fname, base in flavs:
            value = overrides.get((sid, fname), base)
            for i in range(n_samples // 2):
                d = value * jitter * (0.2 + 0.8 * (i / max(1, n_samples // 2)))
                energy.append(EnergySample(sid, fname, value + d, t=2 * i))
                energy.append(EnergySample(sid, fname, value - d, t=2 * i + 1))
    traffic: List[TrafficSample] = []
    for s, z, vol, size in TRAFFIC:
        src_flavour = TABLE1[s][0][0]  # monitored = preferred flavour
        for i in range(n_samples):
            traffic.append(
                TrafficSample(
                    source=s, source_flavour=src_flavour, target=z,
                    request_volume=vol * traffic_multiplier,
                    request_size_gb=size, t=i,
                )
            )
    return MonitoringData(energy=tuple(energy), traffic=tuple(traffic))


# --------------------------------------------------------------------------
# Scenario builders (Sect. 5.3)
# --------------------------------------------------------------------------


def scenario(n: int):
    """Returns (application, infrastructure, monitoring) for scenario n."""
    app = build_application()
    if n == 1:
        return app, europe_infrastructure(), build_monitoring()
    if n == 2:
        return app, us_infrastructure(), build_monitoring()
    if n == 3:
        infra = europe_infrastructure()
        nodes = [
            node.with_carbon(376.0) if node.node_id == "france" else node
            for node in infra.nodes
        ]
        return app, infra.with_nodes(nodes), build_monitoring()
    if n == 4:
        mon = build_monitoring(
            energy_overrides={("frontend", "large"): 481.0}
        )
        return app, europe_infrastructure(), mon
    if n == 5:
        return app, europe_infrastructure(), build_monitoring(
            traffic_multiplier=15000.0
        )
    raise ValueError(f"unknown scenario {n}")
