"""Energy Estimator and Energy Mix Gatherer (Sect. 4.1 / Sect. 3.1).

The Energy Estimator enriches the Application Description with
  * computation energy profiles  energyProfile(s, f)      (Eq. 1)
  * communication energy profiles energyProfile(s, f, z)  (Eq. 2)
derived from monitoring data.  Communication energy uses the transmission
model of Eq. 13:  kWh = requestVolume * requestSize * k, with k the
transmission-network electricity intensity (kWh/GB).

The Energy Mix Gatherer enriches the Infrastructure Description with carbon
intensity, averaging the grid signal over a recent observation window.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from .types import (
    Application,
    CommunicationLink,
    Infrastructure,
    MonitoringData,
    Node,
)

# Transmission network electricity intensity, kWh/GB.  Aslan et al. [39]
# report 0.06 kWh/GB in 2015 halving every ~2 years; the 2025 extrapolation
# used by the paper is ~0.06 / 2**5.
K_TRANSMISSION_KWH_PER_GB_2025 = 0.06 / 2 ** 5  # 0.001875


@dataclass
class EnergyEstimator:
    """Computes hardware-agnostic statistical energy profiles (Sect. 4.1)."""

    k_kwh_per_gb: float = K_TRANSMISSION_KWH_PER_GB_2025

    def computation_profiles(
        self, monitoring: MonitoringData
    ) -> Dict[Tuple[str, str], float]:
        """Eq. 1: mean energy per (service, flavour)."""
        sums: Dict[Tuple[str, str], float] = defaultdict(float)
        counts: Dict[Tuple[str, str], int] = defaultdict(int)
        for sample in monitoring.energy:
            key = (sample.service, sample.flavour)
            sums[key] += sample.energy_kwh
            counts[key] += 1
        return {k: sums[k] / counts[k] for k in sums}

    def communication_profiles(
        self, monitoring: MonitoringData
    ) -> Dict[Tuple[str, str, str], float]:
        """Eq. 2 with the Eq. 13 transmission model: mean kWh per
        (source, source_flavour, target)."""
        sums: Dict[Tuple[str, str, str], float] = defaultdict(float)
        counts: Dict[Tuple[str, str, str], int] = defaultdict(int)
        for s in monitoring.traffic:
            key = (s.source, s.source_flavour, s.target)
            sums[key] += s.request_volume * s.request_size_gb * self.k_kwh_per_gb
            counts[key] += 1
        return {k: sums[k] / counts[k] for k in sums}

    def enrich(
        self, app: Application, monitoring: MonitoringData
    ) -> Application:
        """Returns the application with the ``energy`` property filled in for
        every observed flavour and communication link."""
        comp = self.computation_profiles(monitoring)
        comm = self.communication_profiles(monitoring)

        services = []
        for svc in app.services:
            flavours = tuple(
                f.with_energy(comp[(svc.component_id, f.name)])
                if (svc.component_id, f.name) in comp
                else f
                for f in svc.flavours
            )
            services.append(dataclasses.replace(svc, flavours=flavours))
        app = app.with_services(services)

        # Communication links: aggregate over source flavours is NOT done —
        # Eq. 2 keeps the source flavour.  The Application links carry the
        # profile of the *currently monitored* flavour; the full per-flavour
        # map is available via communication_profiles().
        links = []
        for link in app.links:
            candidates = [
                v for (s, f, z), v in comm.items()
                if s == link.source and z == link.target
            ]
            links.append(
                link.with_energy(sum(candidates) / len(candidates))
                if candidates else link
            )
        return app.with_links(links)


# ---------------------------------------------------------------------------
# Energy Mix Gatherer
# ---------------------------------------------------------------------------

CarbonSignal = Callable[[str], Sequence[float]]
"""Maps a region/node id to a recent carbon-intensity time series
(gCO2eq/kWh), newest last — the Grid Carbon Intensity service."""


@dataclass
class EnergyMixGatherer:
    """Enriches nodes with carbon intensity averaged over a recent window.

    Carbon intensity can also be pinned explicitly by the DevOps engineer
    (e.g. a solar-powered edge node): a node whose ``carbon`` is already set
    is left untouched.

    When a ``forecast`` signal is available (hour 0 = now), it is attached
    to the node for the TimeShift module (batch-processing extension);
    absent a dedicated forecast, the recent daily cycle of the historical
    signal serves as a persistence forecast.
    """

    signal: Optional[CarbonSignal] = None
    window: int = 24  # observations (e.g. hours) averaged
    forecast: Optional[CarbonSignal] = None
    forecast_from_history: bool = True

    def enrich(self, infra: Infrastructure) -> Infrastructure:
        nodes = []
        for node in infra.nodes:
            if self.forecast is not None and not node.carbon_forecast:
                node = node.with_forecast(
                    self.forecast(node.region or node.node_id))
            if node.carbon is not None or self.signal is None:
                nodes.append(node)
                continue
            series = list(self.signal(node.region or node.node_id))
            if not series:
                raise ValueError(
                    f"no carbon signal for node {node.node_id!r}"
                )
            recent = series[-self.window:]
            node = node.with_carbon(sum(recent) / len(recent))
            if not node.carbon_forecast and self.forecast_from_history \
                    and len(series) >= self.window:
                # persistence forecast: replay the last daily cycle
                node = node.with_forecast(recent)
            nodes.append(node)
        return infra.with_nodes(nodes)


def static_signal(table: Mapping[str, float]) -> CarbonSignal:
    """A Grid Carbon Intensity service backed by a static table."""
    return lambda region: [table[region]]
