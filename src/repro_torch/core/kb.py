"""Knowledge Base and KB Enricher (Sect. 4.4).

KB = <SK, IK, NK, CK>  (Eq. 6)

SK : (s, f)    -> <Em_max, Em_min, Em_avg>, t      (Eq. 7)
IK : (s, f, z) -> <Em_max, Em_min, Em_avg>, t      (Eq. 8)
NK : n         -> <CI_max, CI_min, CI_avg>, t      (Eq. 9)
CK : c         -> <Em, mu>, t                      (Eq. 10)

The KB is persisted as a collection of JSON files (one per section), matching
the paper's semi-structured data store.  mu is the memory weight: constraints
not regenerated for several iterations decay until they are forgotten.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from .types import Affinity, AvoidNode, Constraint, Infrastructure, TimeShift


@dataclass
class Stats:
    max: float
    min: float
    avg: float
    count: int = 1
    t: int = 0

    def update(self, value: float, t: int) -> None:
        self.max = max(self.max, value)
        self.min = min(self.min, value)
        # Running mean over all observations ever ingested.
        self.avg = (self.avg * self.count + value) / (self.count + 1)
        self.count += 1
        self.t = t

    @classmethod
    def fresh(cls, value: float, t: int) -> "Stats":
        return cls(max=value, min=value, avg=value, count=1, t=t)


@dataclass
class StoredConstraint:
    constraint: Constraint
    em: float
    mu: float
    t: int


def _constraint_to_json(c: Constraint) -> Dict:
    d = dataclasses.asdict(c)
    d["__type__"] = type(c).__name__
    return d


def _constraint_from_json(d: Dict) -> Constraint:
    kind = d.pop("__type__")
    d["savings_range_g"] = tuple(d.get("savings_range_g", (0.0, 0.0)))
    cls = {"AvoidNode": AvoidNode, "Affinity": Affinity,
           "TimeShift": TimeShift}[kind]
    return cls(**d)


@dataclass
class KnowledgeBase:
    sk: Dict[Tuple[str, str], Stats] = field(default_factory=dict)
    ik: Dict[Tuple[str, str, str], Stats] = field(default_factory=dict)
    nk: Dict[str, Stats] = field(default_factory=dict)
    ck: Dict[Tuple, StoredConstraint] = field(default_factory=dict)

    # -- persistence (semi-structured JSON store) ---------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        def dump(name: str, obj) -> None:
            tmp = os.path.join(path, name + ".tmp")
            with open(tmp, "w") as fh:
                json.dump(obj, fh, indent=1)
            os.replace(tmp, os.path.join(path, name))

        dump("sk.json", [[list(k), dataclasses.asdict(v)]
                         for k, v in self.sk.items()])
        dump("ik.json", [[list(k), dataclasses.asdict(v)]
                         for k, v in self.ik.items()])
        dump("nk.json", [[k, dataclasses.asdict(v)]
                         for k, v in self.nk.items()])
        dump("ck.json", [
            {"constraint": _constraint_to_json(sc.constraint),
             "em": sc.em, "mu": sc.mu, "t": sc.t}
            for sc in self.ck.values()
        ])

    @classmethod
    def load(cls, path: str) -> "KnowledgeBase":
        kb = cls()
        def read(name: str):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return []
            with open(p) as fh:
                return json.load(fh)

        kb.sk = {tuple(k): Stats(**v) for k, v in read("sk.json")}
        kb.ik = {tuple(k): Stats(**v) for k, v in read("ik.json")}
        kb.nk = {k: Stats(**v) for k, v in read("nk.json")}
        for row in read("ck.json"):
            c = _constraint_from_json(row["constraint"])
            kb.ck[c.key()] = StoredConstraint(c, row["em"], row["mu"], row["t"])
        return kb


@dataclass
class KBEnricher:
    """Keeps the KB current and retrieves still-valid past constraints.

    * newly (re)generated constraints get mu = 1;
    * constraints not regenerated this iteration decay mu <- mu * decay;
    * constraints with mu below ``forget`` are dropped from CK;
    * ``retrieve`` returns past constraints with mu >= valid that were NOT
      regenerated, so they can complement the new set.
    """

    decay: float = 0.8
    forget: float = 0.3
    valid: float = 0.5

    def update(
        self,
        kb: KnowledgeBase,
        new_constraints: List[Constraint],
        computation: Mapping[Tuple[str, str], float],
        communication: Mapping[Tuple[str, str, str], float],
        infra: Infrastructure,
        iteration: int,
    ) -> List[Constraint]:
        """Ingest fresh knowledge; returns new + still-valid past constraints
        (each past constraint annotated with its decayed memory weight)."""
        # SK / IK: energy profiles.
        for key, v in computation.items():
            if key in kb.sk:
                kb.sk[key].update(v, iteration)
            else:
                kb.sk[key] = Stats.fresh(v, iteration)
        for key, v in communication.items():
            if key in kb.ik:
                kb.ik[key].update(v, iteration)
            else:
                kb.ik[key] = Stats.fresh(v, iteration)
        # NK: node carbon intensity.
        for node in infra.nodes:
            if node.carbon is None:
                continue
            if node.node_id in kb.nk:
                kb.nk[node.node_id].update(node.carbon, iteration)
            else:
                kb.nk[node.node_id] = Stats.fresh(node.carbon, iteration)

        # CK: memory-weight bookkeeping.
        fresh_keys = {c.key() for c in new_constraints}
        for c in new_constraints:
            kb.ck[c.key()] = StoredConstraint(c, c.impact_g, 1.0, iteration)
        for key in list(kb.ck):
            if key in fresh_keys:
                continue
            sc = kb.ck[key]
            sc.mu *= self.decay
            if sc.mu < self.forget:
                del kb.ck[key]

        return list(new_constraints) + self.retrieve(kb, exclude=fresh_keys)

    def retrieve(
        self, kb: KnowledgeBase, exclude: Optional[set] = None
    ) -> List[Constraint]:
        exclude = exclude or set()
        out = []
        for key, sc in kb.ck.items():
            if key in exclude or sc.mu < self.valid:
                continue
            out.append(
                dataclasses.replace(sc.constraint, memory_weight=sc.mu)
            )
        return out
