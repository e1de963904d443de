"""Constraint Generator (Sect. 4.3).

Evaluates every candidate (service, flavour, node) / (service, flavour,
service) combination against the adaptive threshold tau (Eq. 5) and
instantiates the surviving constraints.  tau is the alpha-quantile of the
observed impact distribution of each constraint type; with alpha = 0.8 only
the 20% most impactful constraints are retained (Pareto principle).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .energy import EnergyEstimator
from .library import Candidate, ConstraintLibrary
from .types import Application, Constraint, Infrastructure, MonitoringData


def quantile_inf(values: Sequence[float], alpha: float) -> float:
    """Eq. 5: q_alpha = inf{ x | F(x) >= alpha } for the empirical CDF."""
    if not values:
        return math.inf
    xs = sorted(values)
    n = len(xs)
    # Smallest sample index i (0-based) with (i + 1) / n >= alpha.
    i = max(0, math.ceil(alpha * n) - 1)
    return xs[i]


@dataclass
class ConstraintGenerator:
    library: ConstraintLibrary = field(default_factory=ConstraintLibrary.default)
    estimator: EnergyEstimator = field(default_factory=EnergyEstimator)
    alpha: float = 0.8
    # "current": constrain the monitored/preferred flavour of each service
    # (matches the paper's scenarios); "all": every observed flavour.
    flavour_scope: str = "current"
    # Which impact distribution Eq. 5 quantiles over:
    # "candidates" — the candidate (s,f,n)/(s,f,z) impacts (literal reading
    #   of 'the observed impacts': F is the CDF of what the generator saw);
    # "profiles"  — the per-service / per-communication EXPECTED impacts
    #   (profile x mean CI; matches Sect. 4.3's 'impact of all services and
    #   communications observed in the monitoring history' and reproduces
    #   Table 4's super-linear count growth).
    tau_scope: str = "candidates"

    def generate(
        self,
        app: Application,
        infra: Infrastructure,
        monitoring: MonitoringData,
        iteration: int = 0,
    ) -> List[Constraint]:
        computation = self.estimator.computation_profiles(monitoring)
        communication = self.estimator.communication_profiles(monitoring)

        constraints: List[Constraint] = []
        for module in self.library:
            cands = module.candidates(
                app, infra, computation, communication, self.flavour_scope
            )
            if not cands:
                continue
            if self.tau_scope == "profiles":
                tau = quantile_inf(
                    self._profile_impacts(
                        module.name, infra, computation, communication),
                    self.alpha,
                )
            else:
                tau = quantile_inf([c.impact_g for c in cands], self.alpha)
            for cand in cands:
                if cand.impact_g > tau:
                    constraints.append(
                        module.instantiate(cand, app, infra, iteration)
                    )
        constraints.sort(key=lambda c: -c.impact_g)
        return constraints

    @staticmethod
    def _profile_impacts(module_name, infra, computation, communication):
        """Expected impact per service/communication: profile x mean CI."""
        cis = [n.carbon for n in infra.nodes if n.carbon is not None]
        mean_ci = sum(cis) / len(cis) if cis else 0.0
        if module_name == "affinity":
            return [v * mean_ci for v in communication.values()]
        return [v * mean_ci for v in computation.values()]

    def tau_for(
        self,
        app: Application,
        infra: Infrastructure,
        monitoring: MonitoringData,
        module_name: str,
        alpha: Optional[float] = None,
    ) -> float:
        """Expose tau for analysis (threshold study, Sect. 5.6)."""
        computation = self.estimator.computation_profiles(monitoring)
        communication = self.estimator.communication_profiles(monitoring)
        module = self.library.modules[module_name]
        cands = module.candidates(
            app, infra, computation, communication, self.flavour_scope
        )
        return quantile_inf(
            [c.impact_g for c in cands], self.alpha if alpha is None else alpha
        )
