"""Constraint Adapter (Sect. 3.1): reformats constraints into the syntax of
the target scheduler.  Three built-in dialects:

* ``prolog`` — the paper's notation, e.g.
  ``avoidNode(d(frontend, large), italy, 1.0).``
* ``json``  — a generic structured form consumed by ``core.scheduler`` and by
  the framework's green placement layer (``launch/green_placement``);
* ``kubernetes`` — scheduling fragments for a real K8s scheduler:
  AvoidNode -> weighted node anti-affinity, Affinity -> pod affinity,
  TimeShift -> a suspended-Job annotation (consumed by e.g. Kueue).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from .types import Affinity, AvoidNode, Constraint, TimeShift


def to_prolog(constraints: Sequence[Constraint]) -> str:
    return "\n".join(c.render() for c in constraints)  # type: ignore[attr-defined]


def to_json(constraints: Sequence[Constraint]) -> str:
    return json.dumps([_one(c) for c in constraints], indent=1)


def to_dicts(constraints: Sequence[Constraint]) -> List[Dict[str, Any]]:
    return [_one(c) for c in constraints]


def _one(c: Constraint) -> Dict[str, Any]:
    base = {
        "kind": c.kind,
        "weight": round(c.weight, 6),
        "memory_weight": round(c.memory_weight, 6),
        "impact_g": c.impact_g,
        "savings_range_g": list(c.savings_range_g),
    }
    if isinstance(c, AvoidNode):
        base.update(service=c.service, flavour=c.flavour, node=c.node)
    elif isinstance(c, Affinity):
        base.update(service=c.service, flavour=c.flavour, other=c.other)
    elif isinstance(c, TimeShift):
        base.update(service=c.service, flavour=c.flavour, node=c.node,
                    shift_h=c.shift_h)
    return base


# ---------------------------------------------------------------------------
# Kubernetes dialect
# ---------------------------------------------------------------------------


def to_kubernetes(constraints: Sequence[Constraint]) -> Dict[str, Dict]:
    """Per-service scheduling fragments to merge into pod specs.

    * AvoidNode -> ``preferredDuringSchedulingIgnoredDuringExecution`` node
      anti-affinity; the paper's weight w in [0.1, 1] maps to the K8s
      preference weight in [1, 100];
    * Affinity -> preferred pod affinity on the topology key
      ``kubernetes.io/hostname`` toward the partner service;
    * TimeShift -> annotations a queueing controller (Kueue et al.)
      understands: suspend + not-before timestamp offset.
    """
    out: Dict[str, Dict] = {}

    def spec(service: str) -> Dict:
        return out.setdefault(service, {
            "affinity": {}, "annotations": {},
        })

    def k8s_weight(c: Constraint) -> int:
        return max(1, min(100, round(100 * c.weight * c.memory_weight)))

    for c in constraints:
        if isinstance(c, AvoidNode):
            s = spec(c.service)
            node_aff = s["affinity"].setdefault("nodeAffinity", {})
            prefs = node_aff.setdefault(
                "preferredDuringSchedulingIgnoredDuringExecution", [])
            prefs.append({
                "weight": k8s_weight(c),
                "preference": {
                    "matchExpressions": [{
                        "key": "kubernetes.io/hostname",
                        "operator": "NotIn",
                        "values": [c.node],
                    }],
                },
            })
        elif isinstance(c, Affinity):
            s = spec(c.service)
            pod_aff = s["affinity"].setdefault("podAffinity", {})
            prefs = pod_aff.setdefault(
                "preferredDuringSchedulingIgnoredDuringExecution", [])
            prefs.append({
                "weight": k8s_weight(c),
                "podAffinityTerm": {
                    "labelSelector": {
                        "matchLabels": {"app": c.other},
                    },
                    "topologyKey": "kubernetes.io/hostname",
                },
            })
        elif isinstance(c, TimeShift):
            s = spec(c.service)
            s["annotations"].update({
                "greenops/suspend": "true",
                "greenops/not-before-offset-hours": str(c.shift_h),
                "greenops/reason-node": c.node,
                "greenops/weight": f"{c.weight * c.memory_weight:.3f}",
            })
    return out


class KubernetesAdapter:
    """Kubernetes dialect with an attached scrape endpoint lifecycle.

    Wraps :func:`to_kubernetes` with the in-cluster serving surface: a
    sidecar-style Prometheus endpoint (``repro_torch.obs.serve_metrics``) that
    starts with the adapter and stops with it.  ``metrics_port=0``
    (default) binds an ephemeral port — read it back from
    ``adapter.metrics_port`` after :meth:`start`; a fixed port inherits
    the bind-retry/backoff behaviour of ``MetricsServer`` so a restarted
    adapter survives the previous socket's TIME_WAIT.  ``start`` and
    ``close`` are both idempotent, and the adapter is a context manager::

        with KubernetesAdapter(metrics_port=9100) as ad:
            frags = ad.render(constraints)
            ... # scrape http://127.0.0.1:9100/metrics while deploying
    """

    def __init__(self, registry=None, metrics_port: int = 0,
                 host: str = "127.0.0.1", retries: int = 5,
                 backoff_s: float = 0.05) -> None:
        # Lazy obs import: core must stay importable without pulling the
        # observability stack into every constraint-engine user.
        if registry is None:
            from ..obs import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self._port_arg = int(metrics_port)
        self._host = host
        self._retries = retries
        self._backoff_s = backoff_s
        self._server = None

    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def metrics_port(self) -> Optional[int]:
        """Bound port while running, else None."""
        return self._server.port if self._server is not None else None

    def start(self) -> "KubernetesAdapter":
        if self._server is None:
            from ..obs import serve_metrics
            self._server = serve_metrics(
                self.registry, port=self._port_arg, host=self._host,
                retries=self._retries, backoff_s=self._backoff_s)
        return self

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()

    def __enter__(self) -> "KubernetesAdapter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def render(self, constraints: Sequence[Constraint]) -> Dict[str, Dict]:
        """Per-service K8s fragments; counts rendered constraints into
        the adapter registry by kind."""
        for c in constraints:
            self.registry.inc("adapter.constraints", labels={"kind": c.kind})
        return to_kubernetes(constraints)
