"""ArrayKB: columnar Knowledge Base (Sect. 4.4, array-native).

The reference :class:`~repro_torch.core.kb.KnowledgeBase` stores Eq. 6's four
sections as Python dicts of per-key ``Stats`` objects and decays CK memory
weights one constraint at a time.  At continuum scale (S ~ 1k services,
N ~ 200 nodes, tens of thousands of live constraints) that object walk is
a per-tick cost; ``ArrayKB`` holds the same knowledge columnar:

  SK : (s, f)    -> max/min/avg/count/t column tensors   (Eq. 7)
  IK : (s, f, z) -> max/min/avg/count/t column tensors   (Eq. 8)
  NK : n         -> max/min/avg/count/t column tensors   (Eq. 9)
  CK : c         -> em/mu/t columns + constraint refs    (Eq. 10)

so one tick's enrichment is a handful of vectorized scatter updates
(``update_profiles``) and one masked multiply for the mu-decay
(``enrich``) instead of O(keys + constraints) Python loops.

Bit-compatibility with the JSON store: every update applies the *same*
float operations as ``Stats.update`` / ``KBEnricher.update`` elementwise,
rows keep dict insertion-order semantics (update-in-place keeps position,
new keys append, forgotten constraints are compressed out), and
``to_kb``/``from_kb``/``save``/``load`` round-trip value-exactly against
:class:`~repro_torch.core.kb.KnowledgeBase` and its JSON files.  The sections
are exposed through read-only mapping views (``kb.sk[key].avg``,
``kb.ck[key].mu``, ...) so code written against the reference KB reads an
``ArrayKB`` unchanged.
"""
from __future__ import annotations

import math
from collections.abc import Mapping as _MappingABC
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.kb import KnowledgeBase, Stats, StoredConstraint
from repro_torch.core.types import Constraint


def clone_constraint(c: Constraint, **updates) -> Constraint:
    """O(1 dict copy) clone of a frozen Constraint, bypassing ``__init__``.

    ``dataclasses.replace`` re-runs the generated ``__init__`` (and
    ``__post_init__``) per call; on the constraint-engine hot path tens of
    thousands of clones per tick only ever swap ``weight`` /
    ``memory_weight`` / ``generated_at``, so a raw ``__dict__`` copy is
    the same object at a fraction of the cost.  Field values are shared
    by reference (all Constraint fields are immutable)."""
    new = object.__new__(type(c))
    d = dict(c.__dict__)
    d.update(updates)
    object.__setattr__(new, "__dict__", d)
    return new


# ---------------------------------------------------------------------------
# columnar stats
# ---------------------------------------------------------------------------


def _f64(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=np.float64)


def _i64(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=np.int64)


@dataclass
class ArrayStats:
    """Columnar twin of :class:`~repro_torch.core.kb.Stats`: row i holds the
    max/min/avg/count/t of key i of the owning section."""

    max: np.ndarray = field(default_factory=_f64)
    min: np.ndarray = field(default_factory=_f64)
    avg: np.ndarray = field(default_factory=_f64)
    count: np.ndarray = field(default_factory=_i64)
    t: np.ndarray = field(default_factory=_i64)

    def __len__(self) -> int:
        return self.max.size

    def update_rows(self, idx: np.ndarray, values: np.ndarray,
                    t: int) -> None:
        """Vectorized Eq. 7-9 update: elementwise identical to
        ``Stats.update`` (running mean over all observations ever
        ingested)."""
        self.max[idx] = np.maximum(self.max[idx], values)
        self.min[idx] = np.minimum(self.min[idx], values)
        cnt = self.count[idx]
        self.avg[idx] = (self.avg[idx] * cnt + values) / (cnt + 1)
        self.count[idx] = cnt + 1
        self.t[idx] = t

    def append_rows(self, values: np.ndarray, t: int) -> None:
        """``Stats.fresh`` for a batch of new keys."""
        n = values.size
        self.max = np.concatenate([self.max, values])
        self.min = np.concatenate([self.min, values])
        self.avg = np.concatenate([self.avg, values])
        self.count = np.concatenate([self.count, np.ones(n, np.int64)])
        self.t = np.concatenate([self.t, np.full(n, t, np.int64)])

    def take(self, keep: np.ndarray) -> None:
        for name in ("max", "min", "avg", "count", "t"):
            setattr(self, name, getattr(self, name)[keep])

    def row(self, i: int) -> Stats:
        """Detached :class:`Stats` copy of row i (reads don't alias the
        columns; mutating the returned object does not write back)."""
        return Stats(max=float(self.max[i]), min=float(self.min[i]),
                     avg=float(self.avg[i]), count=int(self.count[i]),
                     t=int(self.t[i]))


class KeyedStats(_MappingABC):
    """One KB section: ordered keys + :class:`ArrayStats` columns, with a
    read-only ``Mapping[key, Stats]`` view matching the reference KB."""

    def __init__(self, keys: Optional[List] = None,
                 stats: Optional[ArrayStats] = None) -> None:
        self.keys_list: List = list(keys or [])
        self.index: Dict = {k: i for i, k in enumerate(self.keys_list)}
        self.stats = stats if stats is not None else ArrayStats()

    # -- vectorized Eq. 7-9 -------------------------------------------------

    def update(self, items, t: int) -> None:
        """One observation per key this tick: scatter-update existing rows,
        append new keys in encounter order (dict insertion semantics)."""
        rows: List[int] = []
        vals: List[float] = []
        new_vals: List[float] = []
        index = self.index
        keys_list = self.keys_list
        for k, v in items:
            r = index.get(k)
            if r is None:
                index[k] = len(keys_list)
                keys_list.append(k)
                new_vals.append(v)
            else:
                rows.append(r)
                vals.append(v)
        if rows:
            self.stats.update_rows(np.asarray(rows, np.int64),
                                   np.asarray(vals, np.float64), t)
        if new_vals:
            self.stats.append_rows(np.asarray(new_vals, np.float64), t)

    # -- mapping view -------------------------------------------------------

    def __getitem__(self, key) -> Stats:
        return self.stats.row(self.index[key])

    def __iter__(self) -> Iterator:
        return iter(self.keys_list)

    def __len__(self) -> int:
        return len(self.keys_list)

    def __contains__(self, key) -> bool:
        return key in self.index


class CKSection(_MappingABC):
    """CK (Eq. 10): ordered constraint keys + em/mu/t columns + refs to the
    stored constraint objects.

    Stored objects may carry a stale ``generated_at`` (the engine reuses
    cached instances across ticks); the ``t`` column records the true
    storage iteration and every read path (``__getitem__``, ``retrieve``,
    ``to_kb``) re-stamps it, so views are value-identical to the reference
    KB's freshly-instantiated stored constraints.
    """

    def __init__(self) -> None:
        self.keys_list: List[Tuple] = []
        self.index: Dict[Tuple, int] = {}
        self.objs: List[Constraint] = []
        self.em: np.ndarray = _f64()
        self.mu: np.ndarray = _f64()
        self.t: np.ndarray = _i64()

    # -- enrichment primitives (KBEnricher.update, vectorized) --------------

    def upsert(self, keys: Sequence[Tuple], ems: Sequence[float],
               objs: Sequence[Constraint], t: int) -> np.ndarray:
        """(Re)store this tick's fresh constraints with mu = 1; returns the
        row indices of the fresh set."""
        rows = np.empty(len(keys), np.int64)
        index, keys_list, obj_list = self.index, self.keys_list, self.objs
        n_new = 0
        for j, k in enumerate(keys):
            r = index.get(k)
            if r is None:
                r = len(keys_list)
                index[k] = r
                keys_list.append(k)
                obj_list.append(objs[j])
                n_new += 1
            else:
                obj_list[r] = objs[j]
            rows[j] = r
        if n_new:
            grow = np.zeros(n_new)
            self.em = np.concatenate([self.em, grow])
            self.mu = np.concatenate([self.mu, grow])
            self.t = np.concatenate([self.t, np.zeros(n_new, np.int64)])
        self.em[rows] = np.asarray(ems, np.float64)
        self.mu[rows] = 1.0
        self.t[rows] = t
        return rows

    def decay(self, fresh_rows: np.ndarray, decay: float,
              forget: float) -> None:
        """mu <- mu * decay for constraints not regenerated this tick;
        forget (compress out) rows whose mu drops below ``forget``."""
        n = len(self.keys_list)
        others = np.ones(n, dtype=bool)
        others[fresh_rows] = False
        self.mu[others] = self.mu[others] * decay
        drop = others & (self.mu < forget)
        if drop.any():
            keep = ~drop
            self.em, self.mu, self.t = \
                self.em[keep], self.mu[keep], self.t[keep]
            kept = np.nonzero(keep)[0].tolist()
            self.keys_list = [self.keys_list[i] for i in kept]
            self.objs = [self.objs[i] for i in kept]
            self.index = {k: i for i, k in enumerate(self.keys_list)}

    def retrieve(self, fresh_keys: Sequence[Tuple], valid: float):
        """Still-valid past constraints that were NOT regenerated, in CK
        order, as ``(em, base_obj, mu, t)`` descriptors (the engine clones
        ``memory_weight``/``generated_at`` in at materialization time)."""
        exclude = set(fresh_keys)
        out = []
        mu, em, t, objs = self.mu, self.em, self.t, self.objs
        sel = np.nonzero(mu >= valid)[0]
        for r in sel.tolist():
            if self.keys_list[r] in exclude:
                continue
            out.append((float(em[r]), objs[r], float(mu[r]), int(t[r])))
        return out

    # -- mapping view -------------------------------------------------------

    def __getitem__(self, key) -> StoredConstraint:
        r = self.index[key]
        t = int(self.t[r])
        obj = self.objs[r]
        if obj.generated_at != t:
            obj = clone_constraint(obj, generated_at=t)
        return StoredConstraint(obj, float(self.em[r]), float(self.mu[r]), t)

    def __iter__(self) -> Iterator:
        return iter(self.keys_list)

    def __len__(self) -> int:
        return len(self.keys_list)

    def __contains__(self, key) -> bool:
        return key in self.index


# ---------------------------------------------------------------------------
# the KB
# ---------------------------------------------------------------------------


@dataclass
class ArrayKB:
    """KB = <SK, IK, NK, CK> (Eq. 6) with columnar sections."""

    sk: KeyedStats = field(default_factory=KeyedStats)
    ik: KeyedStats = field(default_factory=KeyedStats)
    nk: KeyedStats = field(default_factory=KeyedStats)
    ck: CKSection = field(default_factory=CKSection)

    # -- one tick of enrichment --------------------------------------------

    def update_profiles(self, computation, communication, nodes,
                        iteration: int) -> None:
        """Eq. 7-9: ingest this tick's energy/communication profiles and
        node carbon intensities (vectorized ``Stats`` updates).

        Non-finite values are skipped: a telemetry dropout delivers
        NaN-valued samples with real identities (so structural keys stay
        stable), and those must hold the stored Stats rather than poison
        their means — both the eager engine and the scanned KB replay
        ingest through here, so the filter keeps the two paths in
        lockstep."""
        self.sk.update(
            ((k, v) for k, v in computation.items() if math.isfinite(v)),
            iteration)
        self.ik.update(
            ((k, v) for k, v in communication.items() if math.isfinite(v)),
            iteration)
        self.nk.update(
            ((n.node_id, n.carbon) for n in nodes
             if n.carbon is not None and math.isfinite(n.carbon)),
            iteration)

    def enrich(self, fresh_keys: Sequence[Tuple],
               fresh_ems: Sequence[float],
               fresh_objs: Sequence[Constraint],
               iteration: int, decay: float, forget: float,
               valid: float):
        """Eq. 10 memory-weight bookkeeping, identical to
        ``KBEnricher.update``'s CK pass: fresh constraints (re)stored with
        mu = 1, everything else decays / is forgotten, and the still-valid
        non-regenerated remainder is returned for the merged ranking."""
        rows = self.ck.upsert(fresh_keys, fresh_ems, fresh_objs, iteration)
        self.ck.decay(rows, decay, forget)
        return self.ck.retrieve(fresh_keys, valid)

    # -- interop with the JSON KnowledgeBase --------------------------------

    @classmethod
    def from_kb(cls, kb: KnowledgeBase) -> "ArrayKB":
        out = cls()
        for section, src in (("sk", kb.sk), ("ik", kb.ik), ("nk", kb.nk)):
            ks = getattr(out, section)
            ks.keys_list = list(src.keys())
            ks.index = {k: i for i, k in enumerate(ks.keys_list)}
            n = len(ks.keys_list)
            ks.stats = ArrayStats(
                max=np.array([src[k].max for k in ks.keys_list],
                             np.float64).reshape(n),
                min=np.array([src[k].min for k in ks.keys_list],
                             np.float64).reshape(n),
                avg=np.array([src[k].avg for k in ks.keys_list],
                             np.float64).reshape(n),
                count=np.array([src[k].count for k in ks.keys_list],
                               np.int64).reshape(n),
                t=np.array([src[k].t for k in ks.keys_list],
                           np.int64).reshape(n))
        ck = out.ck
        ck.keys_list = list(kb.ck.keys())
        ck.index = {k: i for i, k in enumerate(ck.keys_list)}
        ck.objs = [kb.ck[k].constraint for k in ck.keys_list]
        n = len(ck.keys_list)
        ck.em = np.array([kb.ck[k].em for k in ck.keys_list],
                         np.float64).reshape(n)
        ck.mu = np.array([kb.ck[k].mu for k in ck.keys_list],
                         np.float64).reshape(n)
        ck.t = np.array([kb.ck[k].t for k in ck.keys_list],
                        np.int64).reshape(n)
        return out

    def to_kb(self) -> KnowledgeBase:
        """Materialize a reference :class:`KnowledgeBase`, value-exact
        (keys in section order, floats/ints as Python scalars so the JSON
        dump is byte-compatible)."""
        kb = KnowledgeBase()
        for section in ("sk", "ik", "nk"):
            ks: KeyedStats = getattr(self, section)
            dst = getattr(kb, section)
            for i, k in enumerate(ks.keys_list):
                dst[k] = ks.stats.row(i)
        for k in self.ck.keys_list:
            kb.ck[k] = self.ck[k]
        return kb

    def save(self, path: str) -> None:
        """Persist as the reference KB's JSON files (same schema/bytes)."""
        self.to_kb().save(path)

    @classmethod
    def load(cls, path: str) -> "ArrayKB":
        return cls.from_kb(KnowledgeBase.load(path))
