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
from typing import Any, Dict, List, Sequence

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
