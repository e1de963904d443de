"""ConstraintEngine: the array-native generate -> enrich -> rank pass.

Replaces the per-candidate Python walk of ``ConstraintGenerator`` +
``KBEnricher`` + ``ConstraintRanker`` (Sect. 4.3-4.5) with tensor programs
over the whole candidate grid, producing **bit-identical** constraints
(same objects field-for-field: ids, impacts, Eq. 11/12 weights, savings
ranges, explanation text, ordering).

Tensor <-> paper-symbol map (S services, F scoped flavour slots per the
``flavour_scope`` rule, N nodes, L observed communication edges):

  ``prof[s, f]``   energyProfile(s, f)        — Eq. 1 (NaN = unobserved)
  ``ci[n]``        C(n)                       — node carbon intensity
                   (NaN = unknown; such nodes generate no candidates)
  ``I[s, f, n]``   = prof[s, f] * ci[n]       — Definition 1 / Eq. 3
                   candidate impacts for ALL (s, f, n) in one product
  ``e[l]``         energyProfile(s, f, z)     — Eq. 2 per observed edge
  ``Ia[l]``        = e[l] * mean(ci)          — Definition 2 / Eq. 4
  ``tau``          Eq. 5 inf-quantile of the masked impact tensor
                   (an O(C) selection — ``np.partition`` — or a float64
                   ``torch.sort`` on ``tau_device`` with
                   ``tau_backend="torch"``; both pick the exact order
                   statistic ``sorted(x)[ceil(a*n)-1]``)
  ``w``            Eq. 11/12 ranking weights as masked array ops
  SK/IK/NK/CK     Eq. 6-10 columnar stats (:class:`~repro_torch.learn.kb_array.
                  ArrayKB`), vectorized updates + mu-decay

Candidate cells are enumerated row-major (service-major, then flavour,
then node; edges in communication-map order), exactly the reference
generator's loop nest, so stable sorts tie-break identically.

**Incremental mode** (``incremental=True``, the default): the engine keeps
the impact tensor, the per-candidate constraint objects, and the savings
context from the previous tick, and re-scores only the *dirty* candidates
— rows whose Eq. 1 profile moved, columns whose carbon intensity (or
savings context: the next-worse/optimal relocation targets that price the
explanation's savings range) moved, and edges whose Eq. 2 profile or the
infrastructure mean CI moved.  tau, the survivor mask, and the Eq. 11/12
weights are always recomputed from the (incrementally-updated) full
tensor — they are global order statistics — so the incremental pass is
*identical* to the full pass by construction, it just skips re-deriving
per-candidate values and explanation strings that cannot have changed.
Structural drift (services/flavours/nodes appearing or leaving, the edge
set changing, new library modules) is detected by a cheap structural key
and triggers a full rebuild for that tick.

Constraint modules other than the built-in AvoidNode/Affinity pair (e.g.
the TimeShift batch extension, or user modules) are delegated to their
reference ``candidates``/``instantiate`` implementations per tick, in
library order — the library stays extensible, extension modules just
don't get the array fast path.

The explanation strings and savings formulas intentionally mirror
``repro_torch.core.library`` character-for-character;
tests/test_torch_pipeline.py holds this engine to the JAX package's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.generator import ConstraintGenerator, quantile_inf
from repro_torch.core.library import (
    REPORT_SCALE,
    AffinityModule,
    AvoidNodeModule,
    ConstraintLibrary,
    TimeShiftModule,
    _scoped_flavours,
    subnet_compatible,
)
from repro_torch.core.types import (
    Affinity,
    Application,
    AvoidNode,
    Constraint,
    Infrastructure,
    TimeShift,
)

from repro_torch.obs.registry import REGISTRY as _REGISTRY

from .constraint_set import ConstraintSet
from .kb_array import ArrayKB


def quantile_inf_tensor(values: np.ndarray, alpha: float,
                        backend: str = "numpy",
                        device: Optional[str] = None) -> float:
    """Eq. 5 over a tensor of observed impacts: the exact order statistic
    ``sorted(x)[max(0, ceil(alpha * n) - 1)]`` (``inf{x | F(x) >= alpha}``
    for the empirical CDF) — bit-identical to
    :func:`repro_torch.core.generator.quantile_inf`, computed as an O(C)
    selection instead of a Python sort."""
    values = np.asarray(values)
    n = values.size
    if n == 0:
        return math.inf
    i = max(0, math.ceil(alpha * n) - 1)
    if backend == "torch":
        from repro_torch import resolve_device

        t = torch.as_tensor(values, dtype=torch.float64,
                            device=resolve_device(device))
        return float(torch.sort(t).values[i])
    return float(np.partition(values, i)[i])


# ---------------------------------------------------------------------------
# result / stats
# ---------------------------------------------------------------------------


@dataclass
class EngineStats:
    """One tick of constraint-pass telemetry."""

    mode: str             # "rebuild" | "full" | "incremental"
    candidates: int       # candidate cells/edges considered (Eq. 3/4 grid)
    rescored: int         # cells whose impact was recomputed this tick
    instantiated: int     # constraint objects built from scratch
    reused: int           # surviving candidates served from the object cache
    fresh: int            # constraints over tau (generator output size)
    retrieved: int        # still-valid past constraints merged from CK
    constraints: int      # ranked output size (after Eq. 12 discard)
    elapsed_s: float


@dataclass
class EngineResult:
    constraints: List[Constraint]
    stats: EngineStats


class _Part:
    """One module's fresh-constraint batch, in candidate-enumeration
    order: impacts + cached keys + base objects."""

    __slots__ = ("em", "keys", "objs", "candidates", "rescored",
                 "instantiated", "reused")

    def __init__(self, em, keys, objs, candidates, rescored, instantiated,
                 reused):
        self.em = em
        self.keys = keys
        self.objs = objs
        self.candidates = candidates
        self.rescored = rescored
        self.instantiated = instantiated
        self.reused = reused


class _Cache:
    """Structure + per-tick value state for the incremental pass."""

    __slots__ = (
        "skey", "sids", "scoped", "S", "Fsc", "nids", "N",
        "svalid", "sub_flat", "sf_pos",
        "edge_keys", "e_src", "e_fl", "e_dst", "e_ok", "keys_af",
        "prof", "carbon", "mean_ci", "nw", "has_below", "best",
        "impacts", "obj_av", "key_av",
        "evals", "impacts_a", "obj_af", "cmin", "cmax",
    )


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass
class ConstraintEngine:
    """Array-native constraint learning over monitoring profiles."""

    library: ConstraintLibrary = field(
        default_factory=ConstraintLibrary.default)
    kb: ArrayKB = field(default_factory=ArrayKB)
    alpha: float = 0.8                 # Eq. 5 quantile level
    flavour_scope: str = "current"     # generator semantics ("current"|"all")
    tau_scope: str = "candidates"      # "candidates" | "profiles"
    # Eq. 11/12 (ConstraintRanker)
    impact_floor_g: float = 0.0
    attenuation: float = 0.75
    discard_below: float = 0.1
    # Eq. 10 (KBEnricher)
    decay: float = 0.8
    forget: float = 0.3
    valid: float = 0.5
    # dirty-mask incremental re-scoring (False = re-derive everything)
    incremental: bool = True
    tau_backend: str = "numpy"         # "numpy" | "torch"
    tau_device: Optional[str] = None   # the "torch" backend's device

    last_stats: Optional[EngineStats] = field(
        default=None, repr=False, compare=False)
    _cache: Optional[_Cache] = field(
        default=None, repr=False, compare=False)

    def _quantile(self, values) -> float:
        return quantile_inf_tensor(values, self.alpha, self.tau_backend,
                                   self.tau_device)

    # -- public entrypoints -------------------------------------------------

    def run(
        self,
        app: Application,
        infra: Infrastructure,
        computation: Mapping[Tuple[str, str], float],
        communication: Mapping[Tuple[str, str, str], float],
        iteration: int,
        use_kb: bool = True,
    ) -> EngineResult:
        """One constraint pass: generate (Eq. 3-5) -> enrich (Eq. 6-10)
        -> rank (Eq. 11/12), vectorized."""
        t0 = time.perf_counter()
        skey = self._structural_key(app, infra, communication)
        cache = self._cache
        rebuilt = cache is None or cache.skey != skey
        if rebuilt:
            cache = self._build_structure(skey, app, infra, communication)
            self._cache = cache
        full = rebuilt or not self.incremental
        rescored = self._refresh_values(cache, infra, computation,
                                        communication, full)

        parts: List[_Part] = []
        for module in self.library:
            if type(module) is AvoidNodeModule:
                part = self._avoid_pass(cache, computation, iteration)
            elif type(module) is AffinityModule:
                part = self._affinity_pass(cache, communication, iteration)
            elif type(module) is TimeShiftModule:
                part = self._timeshift_pass(cache, app, infra, computation,
                                            communication, iteration)
            else:
                part = self._delegate_pass(module, app, infra, computation,
                                           communication, iteration)
            if part is not None:
                parts.append(part)

        # fresh set, sorted by -impact (stable, enumeration-order ties),
        # exactly ConstraintGenerator.generate's final sort
        if parts:
            em_all = np.concatenate([p.em for p in parts])
            keys_all = np.concatenate([p.keys for p in parts])
            objs_all = np.concatenate([p.objs for p in parts])
            order = np.argsort(-em_all, kind="stable")
            fresh_em = em_all[order]
            fresh_keys = keys_all[order]
            fresh_objs = objs_all[order]
        else:
            fresh_em = np.zeros(0)
            fresh_keys = np.zeros(0, object)
            fresh_objs = np.zeros(0, object)

        # KB enrichment (Eq. 6-10)
        if use_kb:
            self.kb.update_profiles(computation, communication, infra.nodes,
                                    iteration)
            retrieved = self.kb.enrich(
                fresh_keys.tolist(), fresh_em.tolist(), fresh_objs.tolist(),
                iteration, self.decay, self.forget, self.valid)
        else:
            retrieved = []

        constraints = self._rank(fresh_em, fresh_objs, retrieved, iteration)

        stats = EngineStats(
            mode="rebuild" if rebuilt else
                 ("incremental" if self.incremental else "full"),
            candidates=sum(p.candidates for p in parts),
            rescored=rescored + sum(p.rescored for p in parts),
            instantiated=sum(p.instantiated for p in parts),
            reused=sum(p.reused for p in parts),
            fresh=int(fresh_em.size),
            retrieved=len(retrieved),
            constraints=len(constraints),
            elapsed_s=time.perf_counter() - t0,
        )
        self.last_stats = stats
        _REGISTRY.inc("engine.passes", labels={"mode": stats.mode})
        _REGISTRY.observe("engine.pass_s", stats.elapsed_s)
        return EngineResult(constraints=constraints, stats=stats)

    def run_from_monitoring(self, app, infra, monitoring, iteration,
                            use_kb: bool = True,
                            telemetry=None) -> EngineResult:
        """Convenience front-end: ingest raw ``MonitoringData`` through a
        :class:`~repro_torch.learn.telemetry.TelemetryBuffer` (per-tick profiles
        are bit-identical to the EnergyEstimator's) and run the pass."""
        from .telemetry import TelemetryBuffer

        if telemetry is None:
            telemetry = TelemetryBuffer(window=1)
        telemetry.ingest(iteration, monitoring, infra)
        return self.run(app, infra,
                        telemetry.computation_profiles(),
                        telemetry.communication_profiles(),
                        iteration, use_kb=use_kb)

    # -- structure ----------------------------------------------------------

    def _structural_key(self, app, infra, communication) -> Tuple:
        """Everything the candidate grids depend on EXCEPT the per-tick
        drifting values (profiles, carbon intensities): service/flavour
        identities and scope, subnet compatibility inputs, node identities,
        the communication edge set (keys, in order), and the module line-up.
        """
        return (
            tuple((s.component_id,
                   tuple(_scoped_flavours(s, self.flavour_scope)),
                   s.requirements.subnet)
                  for s in app.services),
            tuple((n.node_id, n.capabilities.subnet) for n in infra.nodes),
            tuple(communication.keys()),
            tuple((m.name, type(m) is AvoidNodeModule,
                   type(m) is AffinityModule,
                   type(m) is TimeShiftModule) for m in self.library),
            self.flavour_scope,
            self.tau_scope,
        )

    def _build_structure(self, skey, app, infra, communication) -> _Cache:
        c = _Cache()
        c.skey = skey
        services, nodes = app.services, infra.nodes
        c.sids = [s.component_id for s in services]
        c.scoped = [tuple(_scoped_flavours(s, self.flavour_scope))
                    for s in services]
        c.S = len(services)
        c.Fsc = max((len(f) for f in c.scoped), default=0) or 1
        c.nids = [n.node_id for n in nodes]
        c.N = len(nodes)

        c.svalid = np.zeros(c.S * c.Fsc, dtype=bool)
        c.sf_pos = {}
        for i, flavours in enumerate(c.scoped):
            for f, fname in enumerate(flavours):
                pos = i * c.Fsc + f
                c.svalid[pos] = True
                c.sf_pos[(c.sids[i], fname)] = pos

        sub = np.zeros((c.S, c.N), dtype=bool)
        for i, svc in enumerate(services):
            for j, node in enumerate(nodes):
                sub[i, j] = subnet_compatible(svc, node)
        c.sub_flat = np.repeat(sub, c.Fsc, axis=0)   # [S*Fsc, N]

        c.edge_keys = tuple(communication.keys())
        L = len(c.edge_keys)
        c.e_src = [k[0] for k in c.edge_keys]
        c.e_fl = [k[1] for k in c.edge_keys]
        c.e_dst = [k[2] for k in c.edge_keys]
        scoped_set = {sid: set(fl) for sid, fl in zip(c.sids, c.scoped)}
        c.e_ok = np.array(
            [s != z and f in scoped_set.get(s, _EMPTY)
             for s, f, z in c.edge_keys], dtype=bool)
        c.keys_af = np.empty(L, object)
        for l, (s, f, z) in enumerate(c.edge_keys):
            c.keys_af[l] = ("affinity", s, f, z)

        c.prof = None
        c.carbon = None
        c.impacts = None
        c.obj_av = np.empty(c.S * c.Fsc * c.N, object)
        c.key_av = np.empty(c.S * c.Fsc * c.N, object)
        c.evals = None
        c.impacts_a = np.zeros(L)
        c.obj_af = np.empty(L, object)
        c.cmin = c.cmax = c.mean_ci = 0.0
        c.nw = c.best = c.has_below = None
        return c

    # -- per-tick values + dirty masks --------------------------------------

    def _refresh_values(self, c: _Cache, infra, computation, communication,
                        full: bool) -> int:
        """Rebuild the drifting value tensors, update the impact tensor on
        the dirty slabs only (unless ``full``), and invalidate the cached
        constraint objects whose inputs moved.  Returns the number of
        re-scored candidate cells."""
        S, Fsc, N = c.S, c.Fsc, c.N
        prof = np.full(S * Fsc, np.nan)
        sf_pos = c.sf_pos
        for key, v in computation.items():
            p = sf_pos.get(key)
            if p is not None:
                prof[p] = v
        carbon = np.array(
            [n.carbon if n.carbon is not None else np.nan
             for n in infra.nodes], dtype=float) if N else np.zeros(0)
        # infrastructure mean CI, same accumulation order as the reference
        cis = [n.carbon for n in infra.nodes if n.carbon is not None]
        mean_ci = sum(cis) / len(cis) if cis else 0.0
        # savings context (Sect. 5.4): for each node, the next-worse and
        # the optimal (lowest-CI) relocation targets strictly below it
        distinct = np.unique(np.asarray(cis, dtype=float)) if cis \
            else np.zeros(0)
        pos = np.searchsorted(
            distinct, np.where(np.isnan(carbon), -np.inf, carbon), "left") \
            if N else np.zeros(0, np.int64)
        has_below = pos > 0
        nw = np.where(has_below,
                      distinct[np.maximum(pos - 1, 0)] if distinct.size
                      else 0.0, np.nan)
        best = float(distinct[0]) if distinct.size else 0.0
        cmin = float(distinct[0]) if distinct.size else None
        cmax = float(distinct[-1]) if distinct.size else None

        I = c.impacts
        O = c.obj_av
        if full or I is None or c.prof is None:
            c.impacts = (prof.reshape(S * Fsc, 1) * carbon[None, :]) \
                if N else np.zeros((S * Fsc, 0))
            O[:] = None
            c.obj_af[:] = None
            rescored = S * Fsc * N + len(c.edge_keys)
        else:
            dirty_sf = ~((prof == c.prof)
                         | (np.isnan(prof) & np.isnan(c.prof)))
            dirty_n = ~((carbon == c.carbon)
                        | (np.isnan(carbon) & np.isnan(c.carbon)))
            # savings context drift invalidates explanations even when the
            # candidate's own impact is unchanged
            ctx_n = dirty_n | (has_below != c.has_below) \
                | ~((nw == c.nw) | (np.isnan(nw) & np.isnan(c.nw)))
            if best != c.best:
                ctx_n = ctx_n | has_below
            rows = np.nonzero(dirty_sf)[0]
            cols = np.nonzero(dirty_n)[0]
            if rows.size:
                I[rows] = prof[rows, None] * carbon[None, :]
            if cols.size:
                I[:, cols] = prof[:, None] * carbon[cols][None, :]
            rescored = int(rows.size) * N \
                + (S * Fsc - int(rows.size)) * int(cols.size)
            Om = O.reshape(S * Fsc, N)
            if rows.size:
                Om[rows] = None
            ccols = np.nonzero(ctx_n)[0]
            if ccols.size:
                Om[:, ccols] = None
            # affinity: impact rides on mean CI, savings on the CI extremes
            evals_moved = not np.array_equal(
                np.fromiter(communication.values(), float,
                            count=len(c.edge_keys)), c.evals) \
                if c.evals is not None else True
            if mean_ci != c.mean_ci or cmin != c.cmin or cmax != c.cmax:
                c.obj_af[:] = None
                rescored += len(c.edge_keys)
            elif evals_moved:
                new_evals = np.fromiter(communication.values(), float,
                                        count=len(c.edge_keys))
                dirty_a = new_evals != c.evals
                c.obj_af[dirty_a] = None
                rescored += int(dirty_a.sum())

        c.prof = prof
        c.carbon = carbon
        c.mean_ci = mean_ci
        c.nw, c.has_below, c.best = nw, has_below, best
        c.cmin, c.cmax = cmin, cmax
        c.evals = np.fromiter(communication.values(), float,
                              count=len(c.edge_keys))
        c.impacts_a = c.evals * mean_ci
        return rescored

    # -- AvoidNode (Definition 1 / Eq. 3) ------------------------------------

    def _avoid_survivors(self, c: _Cache, computation
                         ) -> Optional[Tuple[np.ndarray, int]]:
        """Tau + survivor selection over the avoid grid, no object work:
        ``(flat cell indices, candidate count)`` or ``None`` when the grid
        is empty.  Shared by the per-tick pass and the megaloop staging
        pre-pass (which must not materialize constraint objects)."""
        I = c.impacts                                      # [S*Fsc, N]
        mask = (c.svalid[:, None] & ~np.isnan(c.prof)[:, None]
                & ~np.isnan(c.carbon)[None, :] & c.sub_flat)
        n_cand = int(mask.sum())
        if n_cand == 0:
            return None
        if self.tau_scope == "profiles":
            vals = np.fromiter(computation.values(), float) * c.mean_ci
            tau = self._quantile(vals)
        else:
            tau = self._quantile(I[mask])
        surv = mask & (I > tau)
        return np.nonzero(surv.ravel())[0], n_cand

    def _avoid_pass(self, c: _Cache, computation, iteration
                    ) -> Optional[_Part]:
        surv = self._avoid_survivors(c, computation)
        if surv is None:
            return None
        idx, n_cand = surv
        I = c.impacts
        if idx.size == 0:
            return _Part(np.zeros(0), np.zeros(0, object),
                         np.zeros(0, object), n_cand, 0, 0, 0)

        obj_arr, key_arr = c.obj_av, c.key_av
        cur = obj_arr[idx]
        need = idx[np.equal(cur, None)]
        if need.size:
            self._instantiate_avoid(c, need, iteration)
        kneed = idx[np.equal(key_arr[idx], None)]
        if kneed.size:
            N, Fsc = c.N, c.Fsc
            for flat in kneed.tolist():
                sf, n = divmod(flat, N)
                s, f = divmod(sf, Fsc)
                key_arr[flat] = ("avoidNode", c.sids[s], c.scoped[s][f],
                                 c.nids[n])
        return _Part(I.ravel()[idx], key_arr[idx], obj_arr[idx],
                     n_cand, 0, int(need.size),
                     int(idx.size - need.size))

    def _instantiate_avoid(self, c: _Cache, need: np.ndarray,
                           iteration: int) -> None:
        """Build AvoidNode objects for the dirty surviving candidates.

        The text and savings formulas mirror
        ``AvoidNodeModule.instantiate`` / ``_avoid_savings`` exactly
        (asserted by the parity suite); objects are built through
        ``object.__new__`` because tens of thousands of dataclass
        ``__init__`` calls per tick are the reference path's bottleneck.
        """
        N, Fsc = c.N, c.Fsc
        ems = c.impacts.ravel()[need].tolist()
        sf_idx = (need // N).tolist()
        n_idx = (need % N).tolist()
        profs = c.prof[need // N].tolist()
        carb = c.carbon[need % N].tolist()
        nws = c.nw[need % N].tolist()
        hbs = c.has_below[need % N].tolist()
        best = c.best
        obj_arr = c.obj_av
        sids, scoped, nids = c.sids, c.scoped, c.nids
        for j, flat in enumerate(need.tolist()):
            s, f = divmod(sf_idx[j], Fsc)
            n = n_idx[j]
            sid, fname, nid = sids[s], scoped[s][f], nids[n]
            p = profs[j]
            if hbs[j]:
                cn = carb[j]
                lo = p * (cn - nws[j]) * REPORT_SCALE
                hi = p * (cn - best) * REPORT_SCALE
            else:
                lo = hi = 0.0
            text = (
                f'An "AvoidNode" constraint was generated for the '
                f'deployment of the "{sid}" service in the "{fname}" '
                f'flavour on the "{nid}" node. This decision was driven '
                f'by the high resource consumption of the selected '
                f'flavour combined with the poor energy mix of the '
                f'target node.\n'
                f'The estimated emissions savings resulting from avoiding '
                f'this deployment range between {hi:.2f} gCO2eq and '
                f'{lo:.2f} gCO2eq.'
            )
            obj = object.__new__(AvoidNode)
            object.__setattr__(obj, "__dict__", {
                "kind": "avoidNode", "impact_g": ems[j], "weight": 1.0,
                "memory_weight": 1.0, "generated_at": iteration,
                "explanation": text, "savings_range_g": (lo, hi),
                "service": sid, "flavour": fname, "node": nid})
            obj_arr[flat] = obj

    # -- Affinity (Definition 2 / Eq. 4) -------------------------------------

    def _affinity_survivors(self, c: _Cache
                            ) -> Optional[Tuple[np.ndarray, int]]:
        """Tau + survivor selection over the observed edges, no object
        work: ``(edge indices, candidate count)`` or ``None``."""
        Ia = c.impacts_a
        mask = c.e_ok
        n_cand = int(mask.sum())
        if n_cand == 0:
            return None
        if self.tau_scope == "profiles":
            vals = c.evals * c.mean_ci
            tau = self._quantile(vals)
        else:
            tau = self._quantile(Ia[mask])
        surv = mask & (Ia > tau)
        return np.nonzero(surv)[0], n_cand

    def _affinity_pass(self, c: _Cache, communication, iteration
                       ) -> Optional[_Part]:
        surv = self._affinity_survivors(c)
        if surv is None:
            return None
        idx, n_cand = surv
        Ia = c.impacts_a
        if idx.size == 0:
            return _Part(np.zeros(0), np.zeros(0, object),
                         np.zeros(0, object), n_cand, 0, 0, 0)
        obj_arr = c.obj_af
        need = idx[np.equal(obj_arr[idx], None)]
        if need.size:
            self._instantiate_affinity(c, need, iteration)
        return _Part(Ia[idx], c.keys_af[idx], obj_arr[idx],
                     n_cand, 0, int(need.size), int(idx.size - need.size))

    def _instantiate_affinity(self, c: _Cache, need: np.ndarray,
                              iteration: int) -> None:
        """Build Affinity objects for the dirty surviving edges; mirrors
        ``AffinityModule.instantiate`` character-for-character."""
        obj_arr = c.obj_af
        Ia = c.impacts_a
        ems = Ia[need].tolist()
        evs = c.evals[need].tolist()
        cmin, cmax = c.cmin, c.cmax
        for j, l in enumerate(need.tolist()):
            s, f, z = c.e_src[l], c.e_fl[l], c.e_dst[l]
            e = evs[j]
            lo = e * cmin * REPORT_SCALE if cmin is not None else 0.0
            hi = e * cmax * REPORT_SCALE if cmax is not None else 0.0
            text = (
                f'An "Affinity" constraint was generated between the '
                f'"{s}" service in the "{f}" flavour and the "{z}" '
                f'service. This decision was driven by the high '
                f'volume of data exchanged between the two services, '
                f'whose transmission would generate significant '
                f'energy consumption if deployed on separate nodes.\n'
                f'The estimated emissions savings resulting from '
                f'co-locating these services range between '
                f'{lo:.2f} gCO2eq and {hi:.2f} gCO2eq.'
            )
            obj = object.__new__(Affinity)
            object.__setattr__(obj, "__dict__", {
                "kind": "affinity", "impact_g": ems[j], "weight": 1.0,
                "memory_weight": 1.0, "generated_at": iteration,
                "explanation": text, "savings_range_g": (lo, hi),
                "service": s, "flavour": f, "other": z})
            obj_arr[l] = obj

    # -- TimeShift (Definition 3, batch-processing extension) ----------------

    def _timeshift_survivors(self, c: _Cache, app, infra, computation,
                             communication
                             ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, int]]:
        """Array-native ``highConsumptionWindow`` candidate math: for every
        (s, f, n) cell, the within-tolerance first minimum of the node's
        carbon-intensity forecast as a prefix-cummin/cum-argmin, then tau
        and survivor selection — no object work.  Returns
        ``(flat indices, impacts, shift hours, candidate count)`` or
        ``None`` when the module yields no candidates.  Values are
        recomputed every tick (forecasts drift freely); the enumeration
        order (service-major, flavour, node) and every float product
        mirror ``TimeShiftModule.candidates`` exactly."""
        S, Fsc, N = c.S, c.Fsc, c.N
        tol = np.fromiter((s.delay_tolerance_h for s in app.services),
                          np.int64, count=S) if S else np.zeros(0, np.int64)
        if N == 0 or S == 0 or not (tol > 0).any():
            return None
        fcs = [n.carbon_forecast if (n.carbon is not None
                                     and n.carbon_forecast) else ()
               for n in infra.nodes]
        fclen = np.fromiter((len(f) for f in fcs), np.int64, count=N)
        H = int(fclen.max())
        if H == 0:
            return None
        # first prefix-minimum per node: run_min[n, h] = min(fc[n, :h+1]),
        # run_arg[n, h] = FIRST index achieving it (strict-< improvement,
        # exactly Python min()'s tie-breaking)
        fc = np.full((N, H), np.inf)
        for j, f in enumerate(fcs):
            fc[j, : len(f)] = f
        run_min = np.minimum.accumulate(fc, axis=1)
        improved = np.ones((N, H), dtype=bool)
        improved[:, 1:] = fc[:, 1:] < run_min[:, :-1]
        run_arg = np.maximum.accumulate(
            np.where(improved, np.arange(H)[None, :], -1), axis=1)
        # horizon = forecast[: tol+1] clipped to the forecast length
        hidx = np.minimum(tol[:, None],
                          np.maximum(fclen[None, :] - 1, 0))     # [S, N]
        cols = np.broadcast_to(np.arange(N)[None, :], (S, N))
        best_t = run_arg[cols, hidx]                             # [S, N]
        minv = run_min[cols, hidx]                               # [S, N]
        gain = c.carbon[None, :] - minv                          # [S, N]
        ok_sn = ((tol[:, None] > 0) & (fclen[None, :] > 0)
                 & ~np.isnan(c.carbon)[None, :]
                 & (best_t > 0) & (gain > 0))
        mask = (c.svalid[:, None] & ~np.isnan(c.prof)[:, None]
                & c.sub_flat & np.repeat(ok_sn, Fsc, axis=0))
        n_cand = int(mask.sum())
        if n_cand == 0:
            return None
        I = c.prof.reshape(S * Fsc, 1) * np.repeat(gain, Fsc, axis=0)
        if self.tau_scope == "profiles":
            tau = quantile_inf(
                ConstraintGenerator._profile_impacts(
                    "timeShift", infra, computation, communication),
                self.alpha)
        else:
            tau = self._quantile(I[mask])
        surv = mask & (I > tau)
        idx = np.nonzero(surv.ravel())[0]
        if idx.size == 0:
            return idx, np.zeros(0), np.zeros(0, np.int64), n_cand
        ems = I.ravel()[idx]
        shifts = best_t.ravel()[(idx // N) // Fsc * N + idx % N]
        return idx, ems, shifts, n_cand

    def _timeshift_pass(self, c: _Cache, app, infra, computation,
                        communication, iteration) -> Optional[_Part]:
        surv = self._timeshift_survivors(c, app, infra, computation,
                                         communication)
        if surv is None:
            return None
        idx, ems, shifts, n_cand = surv
        if idx.size == 0:
            return _Part(np.zeros(0), np.zeros(0, object),
                         np.zeros(0, object), n_cand, n_cand, 0, 0)
        keys, objs = self._instantiate_timeshift(c, idx, ems, shifts,
                                                 iteration)
        return _Part(ems, keys, objs, n_cand, n_cand, int(idx.size), 0)

    def _instantiate_timeshift(self, c: _Cache, idx: np.ndarray,
                               ems: np.ndarray, shifts: np.ndarray,
                               iteration: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Build TimeShift keys/objects for the surviving cells; text and
        savings mirror ``TimeShiftModule.instantiate`` exactly."""
        N, Fsc = c.N, c.Fsc
        keys = np.empty(idx.size, object)
        objs = np.empty(idx.size, object)
        sids, scoped, nids = c.sids, c.scoped, c.nids
        em_l = ems.tolist()
        sh_l = shifts.tolist()
        for j, flat in enumerate(idx.tolist()):
            sf, n = divmod(flat, N)
            s, f = divmod(sf, Fsc)
            sid, fname, nid = sids[s], scoped[s][f], nids[n]
            shift_h = sh_l[j]
            saving = em_l[j] * REPORT_SCALE
            text = (
                f'A "TimeShift" constraint was generated for the execution '
                f'of the "{sid}" service in the "{fname}" flavour on the '
                f'"{nid}" node. The service is delay-tolerant and the '
                f'node\'s carbon-intensity forecast reaches its minimum in '
                f'{shift_h} hour(s).\n'
                f'The estimated emissions savings resulting from postponing '
                f'this execution amount to {saving:.2f} gCO2eq.'
            )
            obj = object.__new__(TimeShift)
            object.__setattr__(obj, "__dict__", {
                "kind": "timeShift", "impact_g": em_l[j], "weight": 1.0,
                "memory_weight": 1.0, "generated_at": iteration,
                "explanation": text, "savings_range_g": (saving, saving),
                "service": sid, "flavour": fname, "node": nid,
                "shift_h": shift_h})
            keys[j] = ("timeShift", sid, fname, nid)
            objs[j] = obj
        return keys, objs

    # -- extension modules: reference semantics, per tick --------------------

    def _delegate_pass(self, module, app, infra, computation, communication,
                       iteration) -> Optional[_Part]:
        cands = module.candidates(app, infra, computation, communication,
                                  self.flavour_scope)
        if not cands:
            return None
        if self.tau_scope == "profiles":
            tau = quantile_inf(
                ConstraintGenerator._profile_impacts(
                    module.name, infra, computation, communication),
                self.alpha)
        else:
            tau = quantile_inf([cd.impact_g for cd in cands], self.alpha)
        objs = [module.instantiate(cd, app, infra, iteration)
                for cd in cands if cd.impact_g > tau]
        n = len(objs)
        em = np.array([o.impact_g for o in objs], dtype=float)
        keys = np.empty(n, object)
        oarr = np.empty(n, object)
        for i, o in enumerate(objs):
            keys[i] = o.key()
            oarr[i] = o
        return _Part(em, keys, oarr, len(cands), len(cands), n, 0)

    # -- Eq. 11/12 ranking ---------------------------------------------------

    def _rank(self, fresh_em: np.ndarray, fresh_objs: np.ndarray,
              retrieved, iteration: int) -> ConstraintSet:
        nf = int(fresh_em.size)
        if retrieved:
            em = np.concatenate(
                [fresh_em, np.array([r[0] for r in retrieved])])
        else:
            em = fresh_em
        if em.size == 0:
            return ConstraintSet.empty()
        max_em = em.max()
        if max_em <= 0:
            return ConstraintSet.empty()
        w = em / max_em
        w = np.where(em < self.impact_floor_g, w * self.attenuation, w)
        kept = np.nonzero(~(w < self.discard_below))[0]
        order = kept[np.argsort(-w[kept], kind="stable")]
        base = np.empty(em.size, dtype=object)
        base[:nf] = fresh_objs
        mw = np.ones(em.size)
        gat = np.full(em.size, iteration, np.int64)
        if retrieved:
            base[nf:] = [r[1] for r in retrieved]
            mw[nf:] = [r[2] for r in retrieved]
            gat[nf:] = [r[3] for r in retrieved]
        return ConstraintSet(base[order], w[order], mw[order], gat[order])


_EMPTY: frozenset = frozenset()
