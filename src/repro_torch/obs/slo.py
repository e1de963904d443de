"""Declarative carbon SLOs with SRE-style multi-window burn-rate alerts.

An :class:`SLO` declares a sustainability objective over a period
(``window_h`` ticks, one tick == one hour in the continuum traces):

* ``carbon_budget``     — at most ``target`` gCO2 consumed per period
  (operational emissions + migration charges);
* ``intensity_ceiling`` — mean grid carbon intensity of the nodes the
  run sees stays at or below ``target`` gCO2/kWh;
* ``churn_limit``       — at most ``target`` service migrations per
  period (plan stability).

Evaluation follows the SRE burn-rate recipe: a *burn rate* of 1.0 means
"consuming exactly the budget over the period"; the engine computes it
over a **fast** and a **slow** trailing window and fires only when BOTH
exceed ``burn_threshold`` — the fast window gives the ≤1-tick reaction,
the slow window suppresses single-tick blips.  Alerts are
edge-triggered: one :class:`AlertEvent` per excursion, re-armed when
the burn drops back below threshold.

Everything here is plain-Python float arithmetic over committed
per-tick records, so the eager loop and the post-scan replay of
``run_scanned`` feed it *identical* samples in *identical* order — and
budget accounting (``spent``) is the plain ordered sum
``acc += emissions_g + migration_g``, the exact reduction
:func:`repro_torch.obs.export.billing_report` uses per tenant, making
per-tenant SLO spend bit-equal to the ledger bill.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["SLO", "AlertEvent", "SLOEngine", "SLO_KINDS"]

SLO_KINDS = ("carbon_budget", "intensity_ceiling", "churn_limit")


@dataclass(frozen=True)
class SLO:
    """One declarative objective; see module docstring for kinds."""

    name: str
    kind: str                    # one of SLO_KINDS
    target: float                # g / (g/kWh) / migrations per window_h
    window_h: int = 24           # period the target is defined over
    fast_window_h: int = 1       # reaction window (ticks)
    slow_window_h: int = 6       # confirmation window (ticks)
    burn_threshold: float = 1.0  # both windows must burn >= this
    tenant: str = ""             # "" == whole run; else a fleet app name
    severity: str = "page"

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {SLO_KINDS}")
        if self.target <= 0:
            raise ValueError("SLO target must be > 0")
        if self.fast_window_h < 1 or self.slow_window_h < self.fast_window_h:
            raise ValueError("need 1 <= fast_window_h <= slow_window_h")
        if self.window_h < 1:
            raise ValueError("window_h must be >= 1")


@dataclass
class AlertEvent:
    """Structured alert — detectors and the SLO engine both emit these."""

    t: int
    name: str                    # e.g. "slo_burn", "ci_anomaly", "node_down"
    source: str                  # "slo" | "ewma" | "cusum" | "liveness" | "freshness"
    severity: str = "warning"
    target: str = ""             # slo/node/service/zone the alert points at
    zone: str = ""               # carbon zone, when attributable
    value: float = 0.0
    threshold: float = 0.0
    detail: str = ""

    def as_attrs(self) -> Dict[str, object]:
        return {
            "tick": self.t, "source": self.source,
            "severity": self.severity, "target": self.target,
            "zone": self.zone, "value": float(self.value),
            "threshold": float(self.threshold), "detail": self.detail,
        }


class _SloState:
    __slots__ = ("samples", "spent", "firing", "burn")

    def __init__(self, slo: SLO):
        self.samples = deque(maxlen=slo.slow_window_h)
        self.spent = 0.0         # cumulative, budgets only (ordered sum)
        self.firing = False
        self.burn: Tuple[float, float] = (0.0, 0.0)


class SLOEngine:
    """Evaluates a set of SLOs against per-tick samples."""

    def __init__(self, slos: Sequence[SLO] = ()):
        self.slos: Tuple[SLO, ...] = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError("SLO names must be unique")
        self._state: Dict[str, _SloState] = {
            s.name: _SloState(s) for s in self.slos}

    # -- accessors ---------------------------------------------------------

    def spent(self, name: str) -> float:
        """Cumulative budget consumption for a ``carbon_budget`` SLO."""
        return self._state[name].spent

    def burn_rates(self, name: str) -> Tuple[float, float]:
        """Latest (fast, slow) burn rates for an SLO."""
        return self._state[name].burn

    def for_tenant(self, tenant: str) -> Tuple[SLO, ...]:
        return tuple(s for s in self.slos if s.tenant == tenant)

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _mean(samples: deque, n: int) -> float:
        win = list(samples)[-n:] if n < len(samples) else list(samples)
        return sum(win) / len(win) if win else 0.0

    def observe(self, t: int, *, consumption_g: float = 0.0,
                ci_mean: float = 0.0, migrations: int = 0,
                tenant: str = "") -> List[AlertEvent]:
        """Feed one tick's samples to every SLO scoped to ``tenant``.

        Returns the alerts that *fired* this tick (edge-triggered).
        """
        out: List[AlertEvent] = []
        for slo in self.slos:
            if slo.tenant != tenant:
                continue
            st = self._state[slo.name]
            if slo.kind == "carbon_budget":
                x = consumption_g
                # ordered float sum == billing_report's per-tenant reduction
                st.spent = st.spent + x
                rate_target = slo.target / slo.window_h
            elif slo.kind == "churn_limit":
                x = float(migrations)
                rate_target = slo.target / slo.window_h
            else:  # intensity_ceiling: target IS the per-tick ceiling
                x = ci_mean
                rate_target = slo.target
            st.samples.append(x)
            fast = self._mean(st.samples, slo.fast_window_h) / rate_target
            slow = self._mean(st.samples, slo.slow_window_h) / rate_target
            st.burn = (fast, slow)
            firing = (fast >= slo.burn_threshold
                      and slow >= slo.burn_threshold)
            if firing and not st.firing:
                out.append(AlertEvent(
                    t=t, name="slo_burn", source="slo",
                    severity=slo.severity, target=slo.name,
                    value=min(fast, slow), threshold=slo.burn_threshold,
                    detail=(f"kind={slo.kind} tenant={slo.tenant or '-'} "
                            f"fast={fast:.3f} slow={slow:.3f}")))
            st.firing = firing
        return out
