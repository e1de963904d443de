"""The fused trace replay: stage the trace on the host, roll the decision
tick on the device.

:meth:`~repro_torch.continuum.loop.ContinuumRuntime.run_scanned` replays
the same adaptive loop as the eager ``run``, but the per-tick host tier
(pipeline, lowering tiers, numpy pricing, planner set-up) runs once for the
whole trace instead of once per tick.  The split of labour:

**Host staging** (exact numpy, one pass over the trace, no objects):
  * monitoring/carbon ingestion and profile estimation per tick —
    every per-tick random stream is keyed by ``t`` alone, so the whole
    trace can be materialized up front without perturbing a single draw;
  * the array constraint engine's refresh -> tau -> survivor pass on a
    COPY of the live cache (incremental dirty-masking continues
    bit-exactly from the runtime's state);
  * a columnar simulation of the KB's constraint section (upsert ->
    decay -> retrieve) over a fixed cell universe, carrying only the
    ``(em, mu, t)`` value columns — constraint OBJECTS are never built
    during staging;
  * the ranking pass (Eq. 11/12) and the lowering of the kept
    constraints into sparse ``(index, value)`` scatter lists for the
    planner's penalty tensors;
  * the lowering cache tiers (cache-hit / delta-substitution / full)
    mirrored against a local cache, producing per-tick ``E``/``order``/
    edge-energy tensors.

**The device scan** (float64 torch on the scheduler's device): the staged
tensors move to the device once; a host loop over the T ticks runs, per
tick, fault eviction -> warm-start validation -> the branch planner
(:func:`~repro_torch.core.scheduler.plan_branches`, B branches on its
leading axis) -> ensemble pricing -> hysteresis/restart switch rule ->
per-tick emissions, all on the device.  The host reads one flag a tick
(whether any reality plans) and never runs the planner on a tick that
does not plan.  The per-tick outputs are stacked on the device and copied
to the host once, after the last tick.  Every reduction of the pricing
and of the emissions runs in numpy's pairwise order (:func:`_np_sum`),
so the replay's expected savings and switch decisions carry the eager
loop's bits, and the card's the CPU's.

**Commit** (host, after the scan): per-tick records with authoritative
emissions accounting, the KB's constraint section reconstructed from
the columnar simulation (objects instantiated GROUPED by the tick that
last refreshed them, against restored engine-cache snapshots — value-
identical to what the eager loop would have stored), engine/lowering
caches handed back so a later eager ``tick`` continues seamlessly.

Anything the staged scan cannot replay exactly (non-native library
modules, bucketed planners, mid-trace structural drift, …) raises
:class:`_Fallback` during staging — staging never mutates live state, so
``run_scanned`` then replays the eager loop on the same device and
reports the reason in ``runtime.last_scanned_fallback``.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.library import (
    AffinityModule,
    AvoidNodeModule,
    TimeShiftModule,
)
from repro_torch.core.lowering import (
    lower,
    lowered_emissions,
    substitute_profiles,
)
from repro_torch.core.pipeline import GeneratorOutput, _structural_key
from repro_torch.core.problem import PlacementProblem
from repro_torch.core.scheduler import (
    COMPILE_CACHE,
    _segment_sum,
    _static_feasibility,
    plan_branches,
)
from repro_torch.core.types import Affinity, AvoidNode
from repro_torch.faults import check_placement

from .loop import FallbackReason
from .whatif import assignment_arrays

__all__ = ["run_scanned", "monte_carlo_emissions"]


class _Fallback(Exception):
    """Raised during staging when the trace cannot be replayed fused.

    ``reason`` MUST be a :class:`~repro_torch.continuum.loop.FallbackReason`
    member (the closed enum of documented reasons — a str subclass, so
    it still compares equal to its stable string); ``tick``/``detail``
    carry the trigger context into the structured
    ``runtime.scanned_fallbacks`` event list.
    """

    def __init__(self, reason: FallbackReason, tick: Optional[int] = None,
                 detail: str = "") -> None:
        if not isinstance(reason, FallbackReason):
            raise TypeError(
                "fallback reason must be a FallbackReason member, "
                f"got {reason!r}")
        super().__init__(str(reason))
        self.reason = reason
        self.tick = tick
        self.detail = detail


def _skey_digest(skey) -> str:
    """Short stable digest of an engine structural key (the full key is
    O(S) tuples — too big for an event record)."""
    import hashlib
    return hashlib.sha1(repr(skey).encode()).hexdigest()[:12]


# Columns of the in-scan metric rows ([T, M] in ys, cumulative [M] in
# the carry), committed to the attached registry post-scan.
SCAN_METRICS: Tuple[str, ...] = (
    "planned", "warm_start_rejected", "switched", "migrations",
    "restarts", "migration_g", "expected_saving_g", "emissions_g",
)


# ---------------------------------------------------------------------------
# engine-cache plumbing
# ---------------------------------------------------------------------------


def _copy_cache(c):
    """Copy of an engine ``_Cache`` that staging can mutate freely.

    Structure/value arrays are shared by reference — ``_refresh_values``
    REPLACES them wholesale — except ``impacts``, which it updates in
    place on the dirty slabs.  Object caches start empty: staging never
    instantiates, and the commit phase rebuilds exactly the objects the
    final KB needs.
    """
    d = type(c)()
    for slot in type(c).__slots__:
        setattr(d, slot, getattr(c, slot))
    if d.impacts is not None:
        d.impacts = d.impacts.copy()
    d.obj_av = np.empty(d.S * d.Fsc * d.N, object)
    d.key_av = np.empty(d.S * d.Fsc * d.N, object)
    d.obj_af = np.empty(len(d.edge_keys), object)
    return d


def _restore_snapshot(c, snap) -> None:
    """Point the cache's drifting value arrays at a staged tick snapshot
    and recompute the impact tensors (bit-equal: same elementwise
    products the incremental refresh writes slab-by-slab)."""
    (prof, carbon, nw, has_below, best, cmin, cmax, mean_ci, evals) = snap
    c.prof, c.carbon, c.nw, c.has_below, c.best = (
        prof, carbon, nw, has_below, best)
    c.cmin, c.cmax, c.mean_ci, c.evals = cmin, cmax, mean_ci, evals
    c.impacts = prof.reshape(-1, 1) * carbon[None, :]
    c.impacts_a = evals * mean_ci


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


class _Staged:
    """Everything the scan + commit phases need, produced in one host
    pass over the trace (plain attribute bag)."""


def _stage(runtime, start: int, T: int) -> _Staged:
    cfg = runtime.config
    pipe = runtime.pipeline
    if pipe.engine != "array":
        raise _Fallback(FallbackReason.ENGINE_NOT_ARRAY,
                        detail=f"engine {pipe.engine!r}")
    sched = getattr(runtime.planner, "scheduler", None)
    scfg = getattr(sched, "config", None)
    if scfg is None:
        raise _Fallback(FallbackReason.NO_SCHEDULER_CONFIG)
    if scfg.bucket is not None or cfg.bucket is not None \
            or cfg.auto_bucket_after:
        raise _Fallback(FallbackReason.BUCKETED_PLANNER)
    eng = pipe._ensure_engine()
    for module in eng.library:
        if type(module) not in (AvoidNodeModule, AffinityModule,
                                TimeShiftModule):
            raise _Fallback(FallbackReason.NON_NATIVE_MODULE,
                            detail=f"module {module.name!r}")
    faults = cfg.faults
    if faults is not None and faults.has_derates(start, T):
        # capacity derates rewrite the cpu/ram capacity tensors mid-trace
        # — genuinely structural for the fused program (every other fault
        # kind stays array-native); fall back loudly
        raise _Fallback(FallbackReason.FAULT_CAPACITY_DERATE, tick=start)

    app, infra = runtime.app, runtime.infra
    # with a fault schedule these are the DEGRADED views (dark zones →
    # persistence + widened scenarios, dropout ticks → NaN samples);
    # without one they alias the raw traces.  ``now``/``future_matrix``
    # delegate to the raw trace either way (truthful accounting).
    carbon, workload = runtime._carbon_view, runtime._workload_view
    node_regions = runtime._node_regions
    gatherer, estimator = pipe.gatherer, pipe.estimator
    iter0 = pipe.iteration
    use_kb = bool(cfg.use_kb)
    use_green = bool(scfg.use_green_constraints)

    # telemetry pooling mirror: deep-copy the live ring buffer so staging
    # stays side-effect free (the staged buffer is handed back at commit)
    window = int(getattr(pipe, "telemetry_window", 1) or 1)
    buf = None
    if window > 1:
        from repro_torch.learn.telemetry import TelemetryBuffer
        live_buf = getattr(pipe, "_telemetry", None)
        if live_buf is not None and live_buf.window == window:
            buf = copy.deepcopy(live_buf)
        else:
            buf = TelemetryBuffer(window=window)

    st = _Staged()
    st.T, st.iter0 = T, iter0
    st.eng, st.use_kb, st.use_green = eng, use_kb, use_green
    st.buf, st.window = buf, window

    scache = None
    lcache = pipe._lowering_cache
    lows: List[object] = []
    snaps: List[Tuple] = []
    ts_store: Dict[int, Tuple] = {}
    path_counts = {"cache_hit": 0, "delta": 0, "full": 0}
    paths: List[str] = []
    dirty: List[int] = []
    ncons: List[int] = []
    p_idx_t: List[np.ndarray] = []
    p_val_t: List[np.ndarray] = []
    a_idx_t: List[np.ndarray] = []
    a_val_t: List[np.ndarray] = []
    ek_t: List[np.ndarray] = []
    E_t: List[np.ndarray] = []
    order_t: List[np.ndarray] = []
    ci_b_t: List[np.ndarray] = []
    ci_mean_t: List[np.ndarray] = []
    ci_now_t: List[np.ndarray] = []
    replan_t: List[bool] = []
    alive_t: List[np.ndarray] = []
    comps: List[dict] = []
    commus: List[dict] = []
    infras: List[object] = []

    for k in range(T):
        t = start + k
        it = iter0 + k + 1

        # -- tick ingestion: identical hook/profile sequence to tick() --
        gatherer.signal = carbon.history_signal(t)
        gatherer.forecast = carbon.forecast_signal(t, cfg.horizon_h)
        mon = workload.monitoring(t)
        infra_e = gatherer.enrich(infra)
        app_e = estimator.enrich(app, mon)
        comp = estimator.computation_profiles(mon)
        commu = estimator.communication_profiles(mon)
        if buf is not None:
            buf.ingest(it, mon, infra_e)
            comp = buf.computation_profiles(last=window)
            commu = buf.communication_profiles(last=window)
        comps.append(comp)
        commus.append(commu)
        infras.append(infra_e)

        # telemetry-dropout hold: the engine below keeps the NaN view
        # (fresh constraints come up empty, KB mu-decays), but the
        # LOWERING prices the last clean window's profiles — the same
        # estimator direct path the eager tick's _held_output applies
        app_low, comp_low, commu_low = app_e, comp, commu
        if faults is not None and workload.stale(t, window):
            monf = workload.lowering_monitoring(t, window)
            app_low = estimator.enrich(app, monf)
            comp_low = estimator.computation_profiles(monf)
            commu_low = estimator.communication_profiles(monf)

        # -- constraint engine: refresh + survivors on the staged cache --
        skey = eng._structural_key(app_e, infra_e, commu)
        if k == 0:
            live = eng._cache
            rebuilt = live is None or live.skey != skey
            scache = (eng._build_structure(skey, app_e, infra_e, commu)
                      if rebuilt else _copy_cache(live))
            full = rebuilt or not eng.incremental
            st.mode0 = "rebuild" if rebuilt else (
                "incremental" if eng.incremental else "full")
            U_av = scache.S * scache.Fsc * scache.N
            Ln = len(scache.edge_keys)
            st.U_av, st.Ln = U_av, Ln
        else:
            if skey != scache.skey:
                raise _Fallback(
                    FallbackReason.ENGINE_KEY_DRIFT,
                    tick=t,
                    detail=f"structural key {_skey_digest(scache.skey)} "
                           f"-> {_skey_digest(skey)}")
            full = not eng.incremental
        rescored = eng._refresh_values(scache, infra_e, comp, commu, full)

        cells_parts: List[np.ndarray] = []
        em_parts: List[np.ndarray] = []
        ts_ncand = 0
        for module in eng.library:
            if type(module) is AvoidNodeModule:
                surv = eng._avoid_survivors(scache, comp)
                if surv is not None:
                    idx, _ = surv
                    cells_parts.append(idx)
                    em_parts.append(scache.impacts.ravel()[idx])
            elif type(module) is AffinityModule:
                surv = eng._affinity_survivors(scache)
                if surv is not None:
                    idx, _ = surv
                    cells_parts.append(U_av + idx)
                    em_parts.append(scache.impacts_a[idx])
            else:
                surv = eng._timeshift_survivors(
                    scache, app_e, infra_e, comp, commu)
                if surv is not None:
                    idx, ems, shifts, n_cand = surv
                    ts_ncand = n_cand
                    if idx.size:
                        cells_parts.append(U_av + Ln + idx)
                        em_parts.append(ems)
                        ts_store[k] = (idx, ems, shifts)
        dirty.append(int(rescored) + int(ts_ncand))
        if em_parts:
            cells_c = np.concatenate(cells_parts)
            em_c = np.concatenate(em_parts)
            order = np.argsort(-em_c, kind="stable")
            fresh_cells = cells_c[order]
            fresh_em = em_c[order]
        else:
            fresh_cells = np.zeros(0, np.int64)
            fresh_em = np.zeros(0)
        # snapshot the tick's drifting value arrays (replaced wholesale by
        # _refresh_values, so references stay valid) for grouped object
        # instantiation at commit time
        snaps.append((scache.prof, scache.carbon, scache.nw,
                      scache.has_below, scache.best, scache.cmin,
                      scache.cmax, scache.mean_ci, scache.evals))

        # -- lowering tiers against a LOCAL cache mirror -----------------
        out = GeneratorOutput(constraints=(), app=app_low, infra=infra_e,
                              computation=comp_low, communication=commu_low)
        key = ("auto", PlacementProblem.cache_key(out))
        if lcache is not None and lcache[0] == key:
            low = lcache[2]
            path = "cache_hit"
        else:
            skey_l = ("auto", _structural_key(out)) \
                if pipe.delta_substitution else None
            if lcache is not None and skey_l is not None \
                    and lcache[1] == skey_l:
                low = substitute_profiles(
                    lcache[2], app_low, infra_e, comp_low, commu_low)
                path = "delta"
            else:
                low = lower(app_low, infra_e, comp_low, commu_low,
                            backend="auto")
                path = "full"
            lcache = (key, skey_l, low)
        paths.append(path)
        path_counts[path] += 1
        lows.append(low)

        if k == 0:
            S, F, N = low.S, low.F, low.N
            if S == 0 or N == 0:
                raise _Fallback(FallbackReason.DEGENERATE_SHAPE)
            kind = low.comm.kind
            st.kind, st.S, st.F, st.N = kind, S, F, N
            struct0 = (kind, low.service_ids, low.node_ids,
                       low.flavour_names)
            stat = {
                "cpu_req": low.cpu_req, "ram_req": low.ram_req,
                "cpu_cap": low.cpu_cap, "ram_cap": low.ram_cap,
                "must": low.must, "cost": low.cost, "valid": low.valid,
                "compat": low.compat, "avail_cap": low.avail_cap,
                "avail_req": low.avail_req,
            }
            if kind == "dense":
                de = np.nonzero(low.comm.has_link)
                has_link0 = low.comm.has_link
            else:
                sp0 = (low.comm.src, low.comm.fidx, low.comm.dst)
            _classify_kb(st, scache, low)
            if runtime.current is not None:
                try:
                    p0, f0, n0 = assignment_arrays(low, runtime.current)
                except (KeyError, ValueError) as exc:
                    raise _Fallback(FallbackReason.STALE_ASSIGNMENT,
                                    detail=str(exc))
                has0 = True
            else:
                p0 = np.zeros(S, bool)
                f0 = np.zeros(S, np.int64)
                n0 = np.zeros(S, np.int64)
                has0 = False
            st.carry0 = (p0, f0.astype(np.int64), n0.astype(np.int64),
                         np.asarray(has0))
        else:
            if (low.comm.kind, low.service_ids, low.node_ids,
                    low.flavour_names) != struct0:
                raise _Fallback(FallbackReason.LOWERING_STRUCTURE_DRIFT,
                                tick=t)
            for name, arr in stat.items():
                if not np.array_equal(getattr(low, name), arr):
                    raise _Fallback(FallbackReason.LOWERED_TENSOR_DRIFT,
                                    tick=t, detail=name)
            if kind == "dense":
                if not np.array_equal(low.comm.has_link, has_link0):
                    raise _Fallback(FallbackReason.DENSE_LINK_DRIFT,
                                    tick=t)
            else:
                if not (np.array_equal(low.comm.src, sp0[0])
                        and np.array_equal(low.comm.fidx, sp0[1])
                        and np.array_equal(low.comm.dst, sp0[2])):
                    raise _Fallback(FallbackReason.SPARSE_EDGE_DRIFT,
                                    tick=t)
        ek_t.append(np.asarray(
            low.comm.K[de] if kind == "dense" else low.comm.k, float))
        E_t.append(np.asarray(low.E, float))
        order_t.append(np.asarray(low.order, np.int64))

        # -- KB columnar simulation + ranking + penalty staging ----------
        if use_kb:
            fr = np.zeros(st.U, bool)
            fr[fresh_cells] = True
            newly = ~st.pres[fresh_cells]
            nc = fresh_cells[newly]
            st.otick[nc] = k
            st.orank[nc] = np.nonzero(newly)[0]
            st.em_u[fresh_cells] = fresh_em
            st.mu_u[fresh_cells] = 1.0
            st.tcol[fresh_cells] = it
            others = st.pres & ~fr
            st.mu_u[others] *= eng.decay
            drop = others & (st.mu_u < eng.forget)
            st.pres = (st.pres | fr) & ~drop
            retr = st.pres & ~fr & (st.mu_u >= eng.valid)
            retr_cells = np.nonzero(retr)[0]
            st.ex_mu[st.ex_alive] *= eng.decay
            st.ex_alive &= st.ex_mu >= eng.forget
            ex_r = np.nonzero(st.ex_alive & (st.ex_mu >= eng.valid))[0]
            mem_em = np.concatenate(
                [fresh_em, st.em_u[retr_cells], st.ex_em[ex_r]])
            mem_mw = np.concatenate(
                [np.ones(fresh_em.size), st.mu_u[retr_cells],
                 st.ex_mu[ex_r]])
            tgt_p = np.concatenate(
                [st.univ_p[fresh_cells], st.univ_p[retr_cells],
                 st.ex_p[ex_r]])
            tgt_a = np.concatenate(
                [st.univ_a[fresh_cells], st.univ_a[retr_cells],
                 st.ex_a[ex_r]])
        else:
            mem_em, mem_mw = fresh_em, np.ones(fresh_em.size)
            tgt_p = st.univ_p[fresh_cells]
            tgt_a = st.univ_a[fresh_cells]

        ncons_k = 0
        p_i = np.zeros(0, np.int64)
        p_v = np.zeros(0)
        a_i = np.zeros(0, np.int64)
        a_v = np.zeros(0)
        if mem_em.size:
            max_em = mem_em.max()
            if max_em > 0:
                w = mem_em / max_em
                w = np.where(mem_em < eng.impact_floor_g,
                             w * eng.attenuation, w)
                kept = ~(w < eng.discard_below)
                ncons_k = int(kept.sum())
                if use_green:
                    eff = w * mem_mw
                    selp = kept & (tgt_p >= 0)
                    p_i, p_v = tgt_p[selp], eff[selp]
                    sela = kept & (tgt_a >= 0)
                    a_i, a_v = tgt_a[sela], eff[sela]
        ncons.append(ncons_k)
        p_idx_t.append(p_i)
        p_val_t.append(p_v)
        a_idx_t.append(a_i)
        a_val_t.append(a_v)

        # -- forecast ensemble + true-CI tensors -------------------------
        if cfg.oracle:
            ci_b = carbon.future_matrix(node_regions, t, cfg.horizon_h)
        else:
            ci_b = carbon.scenario_matrix(
                node_regions, t, cfg.horizon_h,
                cfg.scenarios if cfg.use_whatif else 1)
        ci_b = np.asarray(ci_b, float)
        ci_b_t.append(ci_b)
        ci_mean_t.append(ci_b.mean(axis=1))
        ci_now_t.append(np.asarray(
            carbon.now(node_regions, t), float))
        replan_t.append(t % max(cfg.replan_every, 1) == 0)
        # node liveness rides the scan as a [T, N] mask (all-ones without
        # a schedule — the program shape is fault-agnostic); dead nodes
        # are masked from static feasibility in-step, exactly what the
        # eager tick's mask_unavailable(avail_cap := -1) achieves
        alive_t.append(np.asarray(faults.alive_at(t), bool)
                       if faults is not None else np.ones(low.N, bool))

    st.scache, st.snaps, st.ts_store = scache, snaps, ts_store
    st.lows, st.lcache = lows, lcache
    st.paths, st.path_counts = paths, path_counts
    st.dirty, st.ncons = dirty, ncons
    st.ci_now = np.stack(ci_now_t)
    st.alive = np.stack(alive_t)
    st.comps, st.commus, st.infras = comps, commus, infras
    st.B = ci_b_t[0].shape[0]

    Kp = max((a.size for a in p_idx_t), default=0)
    Ka = max((a.size for a in a_idx_t), default=0)
    st.xs = (
        np.asarray(replan_t, bool),
        _pad2(p_idx_t, T, Kp, np.int64),
        _pad2(p_val_t, T, Kp, np.float64),
        _pad2(a_idx_t, T, Ka, np.int64),
        _pad2(a_val_t, T, Ka, np.float64),
        np.stack(E_t),
        np.stack(order_t),
        np.stack(ci_b_t),
        np.stack(ci_mean_t),
        np.stack(ek_t),
        st.ci_now,
        st.alive,
    )
    low0 = lows[0]
    comm_static = ((de[0].astype(np.int64), de[1].astype(np.int64),
                    de[2].astype(np.int64), has_link0)
                   if kind == "dense"
                   else (sp0[0].astype(np.int64), sp0[1].astype(np.int64),
                         sp0[2].astype(np.int64)))
    st.consts = (
        _static_feasibility(low0),
        np.asarray(low0.cpu_req, float), np.asarray(low0.ram_req, float),
        np.asarray(low0.cpu_cap, float), np.asarray(low0.ram_cap, float),
        low0.must, np.asarray(low0.cost, float),
        comm_static,
        np.float64(scfg.money_weight), np.float64(scfg.pref_weight),
        np.float64(scfg.emission_weight), np.float64(scfg.green_penalty),
        np.float64(0.0 if cfg.oracle else cfg.hysteresis_g),
        np.float64(cfg.horizon_h),
        np.float64(cfg.migration_g), np.float64(cfg.restart_g),
        np.int64(scfg.local_search_rounds * max(1, st.S)),
        np.asarray(bool(cfg.warm_start)),
        np.asarray(bool(cfg.emergency_replan)),
    )
    return st


def _pad2(arrs: List[np.ndarray], T: int, K: int, dtype) -> np.ndarray:
    out = np.zeros((T, K), dtype)
    for i, a in enumerate(arrs):
        out[i, :a.size] = a
    return out


def _classify_kb(st: _Staged, scache, low0) -> None:
    """Fixed-universe KB layout + penalty-tensor targets.

    Cells ``[0, U_av)`` are the avoid grid, ``[U_av, U_av+L)`` the
    observed affinity edges, ``[U_av+L, 2*U_av+L)`` the time-shift grid.
    Live KB rows that resolve to a cell seed the value columns; the rest
    (stale structure, foreign keys) become append-only "extras" that can
    decay and be retrieved but never refreshed.  ``univ_p``/``univ_a``
    map each cell to its flat slot in the planner's P/A penalty tensors
    (-1 = writes nothing), mirroring ``lower_constraints`` skip rules.
    """
    U_av, Ln = st.U_av, st.Ln
    N, Fsc = scache.N, scache.Fsc
    U = 2 * U_av + Ln
    st.U = U
    sidx, nidx = low0.service_index(), low0.node_index()
    Fl, Nl = low0.F, low0.N

    def p_target(sid, fname, nid):
        i, j = sidx.get(sid), nidx.get(nid)
        if i is None or j is None:
            return -1
        try:
            f = low0.flavour_names[i].index(fname)
        except ValueError:
            return -1
        return (i * Fl + f) * Nl + j

    univ_p = np.full(U, -1, np.int64)
    univ_a = np.full(U, -1, np.int64)
    for u in np.nonzero(scache.svalid)[0].tolist():
        s, f = divmod(u, Fsc)
        # resolve the node axis in one strip per valid (s, f) row
        i = sidx.get(scache.sids[s])
        if i is None:
            continue
        try:
            fl = low0.flavour_names[i].index(scache.scoped[s][f])
        except ValueError:
            continue
        for n, nid in enumerate(scache.nids):
            j = nidx.get(nid)
            if j is not None:
                univ_p[u * N + n] = (i * Fl + fl) * Nl + j
    for l, (s, _f, z) in enumerate(scache.edge_keys):
        i, j = sidx.get(s), sidx.get(z)
        if i is not None and j is not None:
            univ_a[U_av + l] = i * low0.S + j

    em_u = np.zeros(U)
    mu_u = np.zeros(U)
    pres = np.zeros(U, bool)
    tcol = np.zeros(U, np.int64)
    otick = np.full(U, -1, np.int64)
    orank = np.zeros(U, np.int64)
    cell_obj0: Dict[int, object] = {}
    ex_keys: List[object] = []
    ex_objs: List[object] = []
    ex_em: List[float] = []
    ex_mu: List[float] = []
    ex_t: List[int] = []
    ex_rank: List[int] = []
    ex_p: List[int] = []
    ex_a: List[int] = []

    if st.use_kb:
        nidx_eng = {nid: j for j, nid in enumerate(scache.nids)}
        af_index = {kk: l for l, kk in enumerate(scache.keys_af.tolist())}
        ck = st.eng.kb.ck
        for r, kk in enumerate(ck.keys_list):
            cell = None
            kind0 = kk[0] if isinstance(kk, tuple) and kk else None
            if kind0 in ("avoidNode", "timeShift") and len(kk) == 4:
                p = scache.sf_pos.get((kk[1], kk[2]))
                j = nidx_eng.get(kk[3])
                if p is not None and j is not None:
                    cell = p * N + j + (0 if kind0 == "avoidNode"
                                        else U_av + Ln)
            elif kind0 == "affinity":
                cell = af_index.get(kk)
                if cell is not None:
                    cell += U_av
            if cell is None:
                obj = ck.objs[r]
                ex_keys.append(kk)
                ex_objs.append(obj)
                ex_em.append(float(ck.em[r]))
                ex_mu.append(float(ck.mu[r]))
                ex_t.append(int(ck.t[r]))
                ex_rank.append(r)
                if isinstance(obj, AvoidNode):
                    ex_p.append(p_target(obj.service, obj.flavour,
                                         obj.node))
                    ex_a.append(-1)
                elif isinstance(obj, Affinity):
                    i, j = sidx.get(obj.service), sidx.get(obj.other)
                    ex_a.append(i * low0.S + j
                                if i is not None and j is not None else -1)
                    ex_p.append(-1)
                else:
                    ex_p.append(-1)
                    ex_a.append(-1)
            else:
                em_u[cell] = ck.em[r]
                mu_u[cell] = ck.mu[r]
                pres[cell] = True
                tcol[cell] = ck.t[r]
                orank[cell] = r
                cell_obj0[cell] = ck.objs[r]

    st.em_u, st.mu_u, st.pres, st.tcol = em_u, mu_u, pres, tcol
    st.otick, st.orank, st.cell_obj0 = otick, orank, cell_obj0
    st.ex_keys, st.ex_objs = ex_keys, ex_objs
    st.ex_em = np.asarray(ex_em, float)
    st.ex_mu = np.asarray(ex_mu, float)
    st.ex_t = np.asarray(ex_t, np.int64)
    st.ex_rank = np.asarray(ex_rank, np.int64)
    st.ex_alive = np.ones(len(ex_keys), bool)
    st.ex_p = np.asarray(ex_p, np.int64)
    st.ex_a = np.asarray(ex_a, np.int64)
    st.univ_p, st.univ_a = univ_p, univ_a

    if st.use_green:
        # lower_constraints SETS penalty slots in ranked order (later
        # overwrites earlier); the fused program scatter-ADDS.  The two
        # agree only when every writable slot has a single writer.  The
        # avoid grid is injective by construction; affinity targets can
        # collide when distinct (s, f, z) edges share (s, z).
        cand_a = np.concatenate([
            univ_a[U_av:U_av + Ln][
                scache.e_ok | pres[U_av:U_av + Ln]],
            st.ex_a,
        ])
        cand_a = cand_a[cand_a >= 0]
        if np.unique(cand_a).size != cand_a.size:
            raise _Fallback(FallbackReason.AFFINITY_SLOT_COLLISION)
        cand_p = np.concatenate([univ_p, st.ex_p])
        cand_p = cand_p[cand_p >= 0]
        if np.unique(cand_p).size != cand_p.size:
            raise _Fallback(FallbackReason.AVOID_SLOT_COLLISION)


# ---------------------------------------------------------------------------
# the device scan
# ---------------------------------------------------------------------------


# numpy's add.reduce: pairwise within a buffer of this many elements, the
# buffers summed in turn; blocks of at most 128 take eight accumulators
_NP_BUFSIZE = 8192
_NP_BLOCK = 128


def _leaf_sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of a row of at most 128 elements (the last
    axis): eight accumulators over blocks of 8, combined as a tree, the
    tail added in turn; below 8 elements, a plain left-to-right sum."""
    n = x.shape[-1]
    if n < 8:
        return _seq_sum(x)
    m = n - n % 8
    r = x[..., 0:8]
    for i in range(8, m, 8):
        r = r + x[..., i:i + 8]
    r = r[..., 0::2] + r[..., 1::2]
    r = r[..., 0::2] + r[..., 1::2]
    res = r[..., 0] + r[..., 1]
    for i in range(m, n):
        res = res + x[..., i]
    return res


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis (numpy's order where the
    reduced axis is not the innermost in memory)."""
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    res = x[..., 0]
    for i in range(1, n):
        res = res + x[..., i]
    return res


class _SumTree:
    """The add tree of numpy's ``add.reduce`` over a contiguous row of n
    elements, as a program: leaves grouped by length (each group summed
    at once by :func:`_leaf_sum`), internal nodes grouped by height (each
    level one gather and one add)."""

    def __init__(self, n: int) -> None:
        leaves: List[Tuple[int, int, int]] = []     # (node, offset, length)
        nodes: List[Tuple[int, int, int, int]] = []  # (node, left, right, h)
        height: List[int] = []

        def new(h: int) -> int:
            height.append(h)
            return len(height) - 1

        def join(lhs: int, rhs: int) -> int:
            nid = new(1 + max(height[lhs], height[rhs]))
            nodes.append((nid, lhs, rhs, height[nid]))
            return nid

        def pairwise(off: int, m: int) -> int:
            if m <= _NP_BLOCK:
                nid = new(0)
                leaves.append((nid, off, m))
                return nid
            half = m // 2
            half -= half % 8
            return join(pairwise(off, half), pairwise(off + half, m - half))

        root = None
        for off in range(0, n, _NP_BUFSIZE):
            part = pairwise(off, min(_NP_BUFSIZE, n - off))
            root = part if root is None else join(root, part)
        self.root, self.size = root, len(height)
        self.leaf_groups = []
        for length in sorted({ln for _, _, ln in leaves}):
            group = [(nid, off) for nid, off, ln in leaves if ln == length]
            ids = torch.tensor([g[0] for g in group])
            idx = torch.tensor([g[1] for g in group])[:, None] \
                + torch.arange(length)
            self.leaf_groups.append((ids, idx))
        self.levels = []
        for h in sorted({nd[3] for nd in nodes}):
            level = [nd for nd in nodes if nd[3] == h]
            self.levels.append(tuple(torch.tensor([nd[i] for nd in level])
                                     for i in range(3)))
        self._on: Dict[torch.device, "_SumTree"] = {}

    def on(self, dev: torch.device) -> "_SumTree":
        """This program with its index tensors on ``dev``."""
        if dev.type == "cpu":
            return self
        tree = self._on.get(dev)
        if tree is None:
            tree = copy.copy(self)
            tree.leaf_groups = [(i.to(dev), j.to(dev))
                                for i, j in self.leaf_groups]
            tree.levels = [tuple(t.to(dev) for t in lv)
                           for lv in self.levels]
            self._on[dev] = tree
        return tree


_SUM_TREES: Dict[int, _SumTree] = {}


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's order for a contiguous row
    (``np.add.reduce``: pairwise inside buffers of 8192, the buffers in
    turn), as elementwise adds.  No reduction kernel runs, so the bits
    are numpy's on any device."""
    n = x.shape[-1]
    if n <= _NP_BLOCK:
        return _leaf_sum(x)
    tree = _SUM_TREES.get(n)
    if tree is None:
        tree = _SUM_TREES[n] = _SumTree(n)
    tree = tree.on(x.device)
    vals = x.new_empty(x.shape[:-1] + (tree.size,))
    for ids, idx in tree.leaf_groups:
        vals[..., ids] = _leaf_sum(x[..., idx])
    for out, lhs, rhs in tree.levels:
        vals[..., out] = vals[..., lhs] + vals[..., rhs]
    return vals[..., tree.root]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root (correctly rounded, as numpy's and CUDA's): torch's
    vectorized CPU kernel is not (it can be an ulp off), so on the CPU the
    few detector lanes take Python's."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.tensor([math.sqrt(v) for v in x.reshape(-1).tolist()],
                        dtype=x.dtype).view(x.shape)


def _roll(kind: str, with_metrics: bool, with_watch: bool, carry0, xs,
          consts, wconsts):
    """Roll the decision tick over the staged trace for M carbon realities
    at once (the leading axis of the carry and of the carbon tensors).

    ``carry0`` is ``(placed[M, S], fcur[M, S], ncur[M, S], has[M])`` plus,
    with metrics, the ``[M, len(SCAN_METRICS)]`` accumulator and, with a
    watch, the detector lane tuple (each lane with a leading M).  ``xs``
    is the staged per-tick tuple with ``replan`` as a host bool array and
    every other entry a device tensor with a leading T; the carbon tensors
    ``ci_b [T, M, B, N]``, ``ci_mean [T, M, B]`` and ``ci_now [T, M, N]``
    carry the reality axis.  Returns ``(carry_out, ys)``, the ys stacked
    over T on the device.  All M x B branches of a planning tick go to ONE
    :func:`plan_branches` call, each reality's incumbent repeated over its
    B branches as per-branch warm state."""
    (stat_feas, cpu_req, ram_req, cpu_cap, ram_cap, must, cost,
     comm_static, money_w, pref_w, emission_w, green_pen, hyst_eff,
     horizon_h, migration_g, restart_g, max_steps, warm_en,
     emerg_en) = consts
    (replan, p_idx, p_val, a_idx, a_val, E_t, order_t, ci_b_t, ci_mean_t,
     ek_t, ci_now_t, alive_t) = xs
    S, F, N = stat_feas.shape
    dev = stat_feas.device
    f64 = torch.float64
    placed_c, fcur_c, ncur_c, has_c = carry0[:4]
    M = has_c.shape[0]
    B = ci_b_t.shape[2]
    s_ix = torch.arange(S, device=dev)
    m_ix = torch.arange(M, device=dev)
    zi = torch.zeros(M, dtype=torch.int64, device=dev)
    zf = torch.zeros(M, dtype=f64, device=dev)
    no = torch.zeros(M, dtype=torch.bool, device=dev)
    metrics_acc = carry0[4] if with_metrics else None
    lanes = carry0[-1] if with_watch else None
    if with_watch:
        alpha, eps, ck, ch = (float(c) for c in wconsts)
    rows: List[Tuple] = []
    wrows: List[Tuple] = []

    for k in range(len(replan)):
        E, order, ek = E_t[k], order_t[k], ek_t[k]
        ci_b, ci_mean_b, ci_now = ci_b_t[k], ci_mean_t[k], ci_now_t[k]
        alive = alive_t[k]
        # dead nodes leave static feasibility exactly as the eager
        # mask_unavailable does (avail_cap = -1 kills every (s, f)
        # column on a down node, nothing else changes)
        stat_feas_t = stat_feas & alive[None, None, :]
        if kind == "dense":
            de_s, de_f, de_d, has_link = comm_static
            K = torch.zeros((S, F, S), dtype=f64, device=dev).index_put_(
                (de_s, de_f, de_d), ek)
            comm_args = (K, has_link)
        else:
            esrc, ef, edst = comm_static
            comm_args = (esrc, ef, edst, ek)

        def pair_many(p, f, n, single=None):
            # [..., P] — the comm backend's pairwise_energy in numpy's
            # order: the dense [P, S, S] product is contiguous (pairwise
            # over S*S); the sparse [P, L] one is strided unless numpy
            # priced ONE assignment (``single``: True, or a [M] mask of
            # the realities where it did), so it sums left to right
            if kind == "dense":
                Ksel = K[s_ix[:, None], f[..., :, None], s_ix[None, :]]
                linked = has_link[s_ix[:, None], f[..., :, None],
                                  s_ix[None, :]]
                pay = (linked & p[..., :, None] & p[..., None, :]
                       & (n[..., :, None] != n[..., None, :]))
                return _np_sum((Ksel * pay).flatten(-2))
            pay = (p[..., esrc] & p[..., edst] & (f[..., esrc] == ef)
                   & (n[..., esrc] != n[..., edst]))
            w = ek * pay
            if single is True:
                return _np_sum(w)
            seq = _seq_sum(w)
            if single is None:
                return seq
            return torch.where(single[:, None], _np_sum(w), seq)

        def expected_of(p, f, n, single):
            # [M, P, B] — ensemble_emissions: plan p of each reality
            # priced under each of its B forecast branches.  numpy lays
            # the [B, P, S] computation product out with B innermost, so
            # with B > 1 its sum over S runs left to right
            P_ = p.shape[1]
            Esel = E[s_ix, f]                                   # [M, P, S]
            cisel = ci_b[:, :, None, :].expand(M, B, P_, N).gather(
                3, n[:, None].expand(M, B, P_, S))              # [M, B, P, S]
            prod = p[:, None] * Esel[:, None] * cisel
            comp = _seq_sum(prod) if B > 1 else _np_sum(prod)  # [M, B, P]
            commE = pair_many(p, f, n, single)                  # [M, P]
            return (comp.transpose(1, 2)
                    + commE[..., None] * ci_mean_b[:, None, :])

        # fault eviction BEFORE planning: a dead node takes its services
        # down with it — the incumbent shrinks now (so no branch bills a
        # dead node) and, when enabled, re-placement is an emergency that
        # bypasses the hysteresis gate
        node_up = alive[ncur_c]
        n_evicted = (placed_c & ~node_up).sum(1)
        placed_c = placed_c & node_up
        emergency = (has_c & (n_evicted > 0)) if emerg_en else no
        # the one host read of the tick: does any reality plan?
        do_plan = ~has_c | emergency
        if replan[k]:
            do_plan = torch.ones_like(has_c)
            plans = True
        else:
            plans = bool(do_plan.any())

        if plans:
            # warm start: re-validate the incumbent against this tick's
            # masks/capacities (all-or-nothing, like _warm_start_state's
            # reject-and-rebuild); loads in the planner's fixed-order sum
            feas_w = (stat_feas_t[s_ix, fcur_c, ncur_c] | ~placed_c).all(1)
            slot = (m_ix[:, None] * N + ncur_c).reshape(-1)
            cpu_l = _segment_sum(M * N, slot, torch.where(
                placed_c, cpu_req[s_ix, fcur_c], 0.0).reshape(-1)).view(M, N)
            ram_l = _segment_sum(M * N, slot, torch.where(
                placed_c, ram_req[s_ix, fcur_c], 0.0).reshape(-1)).view(M, N)
            ok = (has_c & feas_w & (cpu_l <= cpu_cap).all(1)
                  & (ram_l <= ram_cap).all(1)) if warm_en else no
            warm_rej = has_c & ~ok if warm_en else no
            okc = ok[:, None]
            P = _segment_sum(S * F * N, p_idx[k], p_val[k]).view(S, F, N)
            A = _segment_sum(S * S, a_idx[k], a_val[k]).view(S, S)
            out = plan_branches(
                kind, ci_b.reshape(M * B, N), ci_mean_b.reshape(M * B),
                E.expand(M * B, S, F), order.expand(M * B, S),
                *(w.repeat_interleave(B, dim=0) for w in (
                    placed_c & okc, torch.where(okc, fcur_c, 0),
                    torch.where(okc, ncur_c, 0),
                    torch.where(okc, cpu_l, 0.0),
                    torch.where(okc, ram_l, 0.0))),
                comm_args, P, A, stat_feas_t, cpu_req, ram_req, cpu_cap,
                ram_cap, must, cost, money_w, pref_w, emission_w,
                green_pen, max_steps)
            placed_b = out.placed.view(M, B, S)
            fcur_b = out.fcur.view(M, B, S)
            ncur_b = out.ncur.view(M, B, S)
            infeas_b = out.infeas.view(M, B)
            # numpy prices only the feasible plans: one of them alone
            # makes its sparse product contiguous
            single = (~infeas_b).sum(1) == 1 if B > 1 else True
            em = expected_of(placed_b, fcur_b, ncur_b, single)  # [M, B, B]
            em = torch.where(infeas_b[:, :, None], torch.inf, em)
            expected = _np_sum(em) / B
            best = expected.argmin(1)
            feasible = ~infeas_b[m_ix, best]
            cand_p = placed_b[m_ix, best]
            cand_f = fcur_b[m_ix, best]
            cand_n = ncur_b[m_ix, best]
            cur_em = expected_of(placed_c[:, None], fcur_c[:, None],
                                 ncur_c[:, None], True)[:, 0]   # [M, B]
            cur_expected = _np_sum(cur_em) / B
            both = cand_p & placed_c
            same = ((cand_p == placed_c)
                    & (~both | ((cand_f == fcur_c)
                                & (cand_n == ncur_c)))).all(1)
            moved = ((cand_p & (~placed_c | (cand_n != ncur_c))).sum(1)
                     + (placed_c & ~cand_p).sum(1))
            flapped = (both & (cand_n == ncur_c)
                       & (cand_f != fcur_c)).sum(1)
            cost_sw = (migration_g * moved.to(f64)
                       + restart_g * flapped.to(f64))
            saving = (cur_expected - expected[m_ix, best]) * horizon_h
            adopt = feasible & ~has_c & do_plan
            consider = feasible & has_c & ~same & do_plan
            # emergency = the eager gate's force flag: evacuating a dead
            # node must never lose to flap damping, but the migration/
            # restart fees are still counted and billed
            do_switch = consider & ((saving > cost_sw + hyst_eff)
                                    | emergency)
            take = (adopt | do_switch)[:, None]
            placed2 = torch.where(take, cand_p, placed_c)
            f2 = torch.where(take, torch.where(cand_p, cand_f, 0), fcur_c)
            n2 = torch.where(take, torch.where(cand_p, cand_n, 0), ncur_c)
            has2 = has_c | adopt
            switched = adopt | do_switch
            migs = torch.where(adopt, cand_p.sum(1),
                               torch.where(do_switch, moved, 0))
            rsts = torch.where(do_switch, flapped, 0)
            mgc = torch.where(do_switch, cost_sw, 0.0)
            sav = torch.where(consider, saving, 0.0)
            wrj = warm_rej & do_plan
        else:
            placed2, f2, n2, has2 = placed_c, fcur_c, ncur_c, has_c
            switched, migs, rsts, mgc, sav, wrj = no, zi, zi, zf, zf, no

        # per-tick operational emissions of the ACTIVE assignment, in
        # lowered_emissions' order (the commit recomputes the record on
        # the host; this value feeds monte_carlo_emissions and the lanes)
        comp_n = _np_sum(placed2 * E[s_ix, f2] * ci_now.gather(1, n2))
        commE_n = pair_many(placed2[:, None], f2[:, None], n2[:, None],
                            True)[:, 0]
        em_tick = torch.where(has2 & placed2.any(1),
                              comp_n + commE_n * (_np_sum(ci_now) / N), 0.0)
        rows.append((do_plan, wrj, switched, migs, rsts, mgc, sav, placed2,
                     f2, n2, has2, em_tick, n_evicted, emergency))
        placed_c, fcur_c, ncur_c, has_c = placed2, f2, n2, has2
        if with_metrics:
            # [M] per-tick metric row (column order: SCAN_METRICS),
            # accumulated in the carry and stacked per tick
            m = torch.stack([
                do_plan.to(f64), wrj.to(f64), switched.to(f64),
                migs.to(f64), rsts.to(f64), mgc, sav, em_tick], dim=1)
            metrics_acc = metrics_acc + m
            rows[-1] = rows[-1] + (m,)
        if with_watch:
            # watchtower detector lanes: pure readers of the decision
            # outputs, in the expression order of the numpy mirror
            # (repro_torch.obs.watch._ewma_update / observe_tick)
            (ci_m, ci_v, e_m, e_v, g_m, g_v, cpos, cneg, n_w,
             budget) = lanes
            d_ci = ci_now - ci_m
            z_ci = d_ci / _sqrt(ci_v + eps)
            ci_m2 = ci_m + alpha * d_ci
            ci_v2 = (1.0 - alpha) * (ci_v + alpha * d_ci * d_ci)
            e_sel = placed2 * E[s_ix, f2]
            d_e = e_sel - e_m
            z_e = d_e / _sqrt(e_v + eps)
            e_m2 = e_m + alpha * d_e
            e_v2 = (1.0 - alpha) * (e_v + alpha * d_e * d_e)
            # CUSUM on the standardized per-tick emissions total — the
            # pre-reset accumulators are stacked (so the post-scan
            # threshold pass sees the peak), the reset applies in-carry
            d_g = em_tick - g_m
            u = d_g / _sqrt(g_v + eps)
            g_m2 = g_m + alpha * d_g
            g_v2 = (1.0 - alpha) * (g_v + alpha * d_g * d_g)
            cpos_pre = torch.clamp(cpos + u - ck, min=0.0)
            cneg_pre = torch.clamp(cneg - u - ck, min=0.0)
            fired = (cpos_pre > ch) | (cneg_pre > ch)
            budget2 = budget + (em_tick + mgc)
            lanes = (ci_m2, ci_v2, e_m2, e_v2, g_m2, g_v2,
                     torch.where(fired, 0.0, cpos_pre),
                     torch.where(fired, 0.0, cneg_pre), n_w + 1.0, budget2)
            wrows.append((z_ci, z_e, u, cpos_pre, cneg_pre, n_w, budget2))

    carry_out = (placed_c, fcur_c, ncur_c, has_c)
    ys = tuple(torch.stack(col) for col in zip(*rows))
    if with_metrics:
        carry_out = carry_out + (metrics_acc,)
    if with_watch:
        carry_out = carry_out + (lanes,)
        ys = ys + (tuple(torch.stack(col) for col in zip(*wrows)),)
    return carry_out, ys


def _scan_fn(kind: str, with_metrics: bool = False,
             with_watch: bool = False):
    """The whole-trace program for one comm kind and metrics/watch flags:
    ``fn(carry0, xs, consts, wconsts) -> (carry_out, ys)`` over one carbon
    reality, the tensors already on the device (:func:`_to_device`).

    ``with_metrics=True`` additionally threads a cumulative metric
    accumulator (columns :data:`SCAN_METRICS`) through the carry and
    stacks the per-tick metric row into the ys; the registry commit
    happens after the scan returns.  The default program carries zero
    extra arrays, so a disabled registry costs the replay nothing.

    ``with_watch=True`` threads the watchtower's detector state (EWMA
    mean/var for ci and per-service energy, the CUSUM accumulators, the
    tick count and budget counter — one nested tuple, lane order fixed
    by :meth:`repro_torch.obs.Watchtower.scan_carry`) as the LAST carry
    element, and stacks the per-tick pre-threshold row
    ``(z_ci[N], z_e[S], u, cpos_pre, cneg_pre, n_before, budget)`` as
    the LAST ys element.  The detector lanes read the decision outputs
    but never feed back, so decisions stay bit-identical to the
    detached program; thresholding/alerting happens post-scan in
    ``Watchtower.commit_scan``.  The detector constants travel in the
    ``wconsts`` argument (``()`` when unused).
    """
    def fn(carry0, xs, consts, wconsts):
        one = lambda a: a[None]                     # noqa: E731
        carry = tuple(one(c) for c in carry0[:4])
        if with_metrics:
            carry = carry + (one(carry0[4]),)
        if with_watch:
            carry = carry + (tuple(one(c) for c in carry0[-1]),)
        xs = xs[:7] + (xs[7][:, None], xs[8][:, None], xs[9],
                       xs[10][:, None], xs[11])
        carry_out, ys = _roll(kind, with_metrics, with_watch, carry, xs,
                              consts, wconsts)
        first = lambda a: a[0]                      # noqa: E731
        carry = tuple(first(c) for c in carry_out[:4])
        if with_metrics:
            carry = carry + (first(carry_out[4]),)
        if with_watch:
            carry = carry + (tuple(first(c) for c in carry_out[-1]),)
        dec = tuple(y[:, 0] for y in ys[:15 if with_metrics else 14])
        if with_watch:
            dec = dec + (tuple(y[:, 0] for y in ys[-1]),)
        return carry, dec

    return fn


def _to_device(st: _Staged, dev: torch.device):
    """The staged ``(carry0, xs, consts)`` as device tensors (float64,
    int64, bool; scalars stay host numbers, ``replan`` a host array)."""
    def put(a):
        return torch.tensor(np.asarray(a), device=dev)

    carry0 = tuple(put(c) for c in st.carry0)
    xs = (np.asarray(st.xs[0], bool),) + tuple(put(x) for x in st.xs[1:])
    c = st.consts
    consts = tuple(put(a) for a in c[:7]) + (tuple(put(a) for a in c[7]),) \
        + tuple(float(v) for v in c[8:16]) + (int(c[16]), bool(c[17]),
                                               bool(c[18]))
    return carry0, xs, consts


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


def _commit(runtime, st: _Staged, carry_out, ys, start: int,
            stage_s: float, scan_s: float, obs=None, *,
            device: torch.device):
    from .loop import ContinuumResult, TickRecord

    pipe = runtime.pipeline
    eng = st.eng
    cfg = runtime.config
    T = st.T
    (did_plan, warm_rej, switched, migs, rsts, mig_g, sav,
     placed_y, f_y, n_y, has_y, _em_y, evicted_y, emerg_y) = ys[:14]
    # the metric rows ride at ys[14] exactly when a registry is attached
    # (with_metrics == obs is not None); a watch-only scan also has a
    # 15th ys element — the detector row tuple — so length alone cannot
    # distinguish the variants
    metrics = ys[14] if obs is not None else None

    # keyed by device type, like the planner's own signatures: the first
    # replay of a shape on the card and on the CPU each count once
    sig = (device.type, "megaloop", st.kind, T, st.B, st.S, st.F, st.N,
           st.xs[9].shape[1], metrics is not None)
    compiled = COMPILE_CACHE.record(sig, scan_s)

    per_tick = (stage_s + scan_s) / T
    records: List = []
    viols_t: List[list] = []
    for k in range(T):
        if bool(has_y[k]):
            em = lowered_emissions(
                st.lows[k], placed_y[k], f_y[k].astype(np.int64),
                n_y[k].astype(np.int64), ci=st.ci_now[k])
        else:
            em = 0.0
        # post-plan invariants, same gate as the eager tick: every
        # committed assignment sits on live nodes within capacity
        viols: list = []
        if cfg.validate_placements and bool(has_y[k]) \
                and bool(np.any(placed_y[k])):
            viols = check_placement(
                st.lows[k], placed_y[k], f_y[k].astype(np.int64),
                n_y[k].astype(np.int64),
                alive=st.alive[k] if cfg.faults is not None else None,
                t=start + k)
            runtime.placement_violations.extend(viols)
        viols_t.append(viols)
        records.append(TickRecord(
            t=start + k,
            emissions_g=float(em),
            migration_g=float(mig_g[k]),
            migrations=int(migs[k]),
            replanned=bool(did_plan[k]),
            switched=bool(switched[k]),
            expected_saving_g=float(sav[k]),
            n_constraints=int(st.ncons[k]),
            warm_start_rejected=bool(warm_rej[k]),
            restarts=int(rsts[k]),
            rebuild_s=0.0,
            replan_s=scan_s / T,
            lowering_path=st.paths[k],
            compiles=(1 if compiled and k == 0 else 0),
            constraint_s=stage_s / T,
            dirty_candidates=int(st.dirty[k]),
            tick_fused_s=per_tick,
            evicted=int(evicted_y[k]),
            emergency=bool(emerg_y[k]),
            violations=len(viols),
        ))

    # KB: replay the profile sections tick-by-tick, then rebuild the
    # constraint section from the columnar simulation
    if st.use_kb:
        for k in range(T):
            eng.kb.update_profiles(
                st.comps[k], st.commus[k], st.infras[k].nodes,
                st.iter0 + k + 1)
        _reconstruct_ck(st, eng)

    # engine cache handoff: final-tick values, empty object caches (a
    # later eager tick re-instantiates on demand — value-identical
    # constraints, only the `reused` telemetry counter differs)
    scache = st.scache
    _restore_snapshot(scache, st.snaps[-1])
    scache.obj_av = np.empty(st.U_av, object)
    scache.key_av = np.empty(st.U_av, object)
    scache.obj_af = np.empty(st.Ln, object)
    eng._cache = scache

    pipe.iteration = st.iter0 + T
    pipe.lowering_stats["cache_hits"] += st.path_counts["cache_hit"]
    pipe.lowering_stats["delta_substitutions"] += st.path_counts["delta"]
    pipe.lowering_stats["full_lowers"] += st.path_counts["full"]
    pipe._lowering_cache = st.lcache
    pipe.constraint_stats = {
        "path": "array",
        "constraint_s": stage_s / T,
        "mode": st.mode0,
        "rescored": st.dirty[-1],
        "constraints": st.ncons[-1],
    }
    if st.buf is not None:
        pipe._telemetry = st.buf

    if obs is not None:
        _commit_obs(runtime, st, carry_out, ys, start, stage_s, scan_s,
                    obs, records, viols_t)

    placed_T, f_T, n_T, has_T = carry_out[:4]
    low0 = st.lows[0]
    if bool(has_T):
        runtime.current = {
            low0.service_ids[s]: (
                low0.flavour_names[s][int(f_T[s])],
                low0.node_ids[int(n_T[s])])
            for s in range(st.S) if placed_T[s]
        }
    else:
        runtime.current = None
    # the scanned path prices plans inside the fused program; there is no
    # WhatIfResult object to surface
    runtime.last_result = None

    return ContinuumResult(ticks=records,
                           final_assignment=dict(runtime.current or {}))


def _commit_obs(runtime, st: _Staged, carry_out, ys, start: int,
                stage_s: float, scan_s: float, obs, records,
                viols_t) -> None:
    """Post-scan observability commit: fold the in-scan metric tensor
    into the run's registry and replay the trace into the emissions
    ledger.  All reductions here mirror the eager tick's accounting
    bit-for-bit (same mask expressions, same fee arithmetic), so the
    ledger sums equal the TickRecord totals on the fused path too."""
    from repro_torch.obs.ledger import _flavour_name

    reg = obs.registry
    T = st.T
    # obs is always attached here, so the metric rows always ride at
    # ys[14] (a trailing watch row tuple may follow — never metrics)
    metrics = ys[14]
    (did_plan, warm_rej, switched, migs, rsts, mig_g, sav,
     placed_y, f_y, n_y, has_y, _em_y, evicted_y, emerg_y) = ys[:14]

    reg.inc("runtime.ticks", T)
    if metrics is not None:
        col = {name: metrics[:, i] for i, name in enumerate(SCAN_METRICS)}
        reg.inc("runtime.replans", float(col["planned"].sum()))
        reg.inc("runtime.warm_start_rejected",
                float(col["warm_start_rejected"].sum()))
        reg.inc("runtime.switches", float(col["switched"].sum()))
        reg.inc("runtime.migrations", float(col["migrations"].sum()))
        reg.inc("runtime.restarts", float(col["restarts"].sum()))
        cum = carry_out[4]
        for i, name in enumerate(SCAN_METRICS):
            reg.gauge(f"scan.cum.{name}", float(cum[i]))
    for path, n in st.path_counts.items():
        if n:
            reg.inc("lowering.path", n, labels={"path": path})
    reg.observe("stage.stage_s", stage_s)
    reg.observe("stage.scan_s", scan_s)
    reg.observe_many("tick.emissions_g", [r.emissions_g for r in records])
    reg.observe_many("tick.saving_g",
                     [r.expected_saving_g for r in records])

    # ---- ledger replay: walk the committed per-tick assignments,
    # re-deriving moved/flapped with the SAME mask expressions the device
    # step uses (integer counts — exact), and charging fees with the
    # identical mul/mul/add sequence (fee * moved + fee * flapped)
    mig_fee = float(runtime.config.migration_g)
    restart_fee = float(runtime.config.restart_g)
    zones = runtime._node_regions
    p_prev = np.asarray(st.carry0[0], bool)
    f_prev = np.asarray(st.carry0[1], np.int64)
    n_prev = np.asarray(st.carry0[2], np.int64)
    has_prev = bool(st.carry0[3])
    faults = runtime.config.faults
    for k in range(T):
        low = st.lows[k]
        if faults is not None:
            # eviction happened before the gate: diff against the SHRUNK
            # incumbent (leaving a dead node is not a billed move),
            # exactly like the eager tick whose `current` lost the
            # stranded services before hysteresis_gate ran
            p_prev = p_prev & st.alive[k][n_prev]
        p2 = np.asarray(placed_y[k], bool)
        fk = np.asarray(f_y[k], np.int64)
        nk = np.asarray(n_y[k], np.int64)
        hask = bool(has_y[k])
        moved = 0
        flapped = 0
        cells: List[Tuple[str, str, str, float]] = []
        if bool(switched[k]) and has_prev:
            # a charged switch (adoptions are free, like the eager loop)
            moved_mask = p2 & (~p_prev | (nk != n_prev))
            removed_mask = p_prev & ~p2
            flapped_mask = (p2 & p_prev & (nk == n_prev)
                            & (fk != f_prev))
            moved = int(moved_mask.sum() + removed_mask.sum())
            flapped = int(flapped_mask.sum())
            for s in np.nonzero(moved_mask)[0]:
                cells.append((
                    low.service_ids[s],
                    _flavour_name(low.flavour_names, int(s), int(fk[s])),
                    low.node_ids[int(nk[s])], mig_fee))
            for s in np.nonzero(removed_mask)[0]:
                cells.append((
                    low.service_ids[s],
                    _flavour_name(low.flavour_names, int(s),
                                  int(f_prev[s])),
                    low.node_ids[int(n_prev[s])], mig_fee))
            for s in np.nonzero(flapped_mask)[0]:
                cells.append((
                    low.service_ids[s],
                    _flavour_name(low.flavour_names, int(s), int(fk[s])),
                    low.node_ids[int(nk[s])], restart_fee))
        obs.ledger.record(
            start + k, low,
            p2 if hask else None,
            fk if hask else None,
            nk if hask else None,
            st.ci_now[k] if hask else None,
            zones=zones, moved=moved, flapped=flapped,
            migration_fee_g=mig_fee, restart_fee_g=restart_fee,
            mig_cells=tuple(cells))
        if faults is not None:
            runtime._record_fault_events(
                obs, start + k, int(evicted_y[k]), bool(emerg_y[k]),
                viols_t[k])
        p_prev, f_prev, n_prev = p2, fk, nk
        has_prev = hask or has_prev


def _reconstruct_ck(st: _Staged, eng) -> None:
    """Rebuild the KB constraint section IN PLACE from the columnar
    simulation: survivors ordered exactly as the eager upsert/decay
    sequence would have left them, objects instantiated grouped by the
    tick that last refreshed them (against that tick's restored value
    snapshot — bit-equal impacts, identical text)."""
    scache = st.scache
    U_av, Ln, N, Fsc = st.U_av, st.Ln, scache.N, scache.Fsc
    iter0 = st.iter0
    scache.obj_av = np.empty(U_av, object)
    scache.key_av = np.empty(U_av, object)
    scache.obj_af = np.empty(Ln, object)

    cells = np.nonzero(st.pres)[0]
    e_ids = np.nonzero(st.ex_alive)[0]
    tick_all = np.concatenate(
        [st.otick[cells], np.full(e_ids.size, -1, np.int64)])
    rank_all = np.concatenate([st.orank[cells], st.ex_rank[e_ids]])
    order = np.lexsort((rank_all, tick_all))
    nu = cells.size

    # instantiate surviving cells freshed during the trace, grouped by
    # their last-fresh tick
    ts_objs: Dict[int, object] = {}
    by_k: Dict[int, List[int]] = {}
    freshed = st.tcol[cells] > iter0
    for pos in np.nonzero(freshed)[0].tolist():
        u = int(cells[pos])
        by_k.setdefault(int(st.tcol[u]) - iter0 - 1, []).append(u)
    for kk in sorted(by_k):
        _restore_snapshot(scache, st.snaps[kk])
        us = np.asarray(sorted(by_k[kk]), np.int64)
        it_k = iter0 + kk + 1
        av = us[us < U_av]
        if av.size:
            eng._instantiate_avoid(scache, av, it_k)
        afm = us[(us >= U_av) & (us < U_av + Ln)]
        if afm.size:
            eng._instantiate_affinity(scache, afm - U_av, it_k)
        tsm = us[us >= U_av + Ln]
        if tsm.size:
            idx_k, ems_k, shifts_k = st.ts_store[kk]
            flats = tsm - U_av - Ln
            j = np.searchsorted(idx_k, flats)
            _, objs_ts = eng._instantiate_timeshift(
                scache, flats, ems_k[j], shifts_k[j], it_k)
            for u, o in zip(tsm.tolist(), list(objs_ts)):
                ts_objs[u] = o

    def cell_key(u: int):
        if u < U_av:
            sf, n = divmod(u, N)
            s, f = divmod(sf, Fsc)
            return ("avoidNode", scache.sids[s], scache.scoped[s][f],
                    scache.nids[n])
        if u < U_av + Ln:
            return scache.keys_af[u - U_av]
        v = u - U_av - Ln
        sf, n = divmod(v, N)
        s, f = divmod(sf, Fsc)
        return ("timeShift", scache.sids[s], scache.scoped[s][f],
                scache.nids[n])

    keys_f: List[object] = []
    objs_f: List[object] = []
    em_f: List[float] = []
    mu_f: List[float] = []
    t_f: List[int] = []
    for pos in order.tolist():
        if pos < nu:
            u = int(cells[pos])
            keys_f.append(cell_key(u))
            if st.tcol[u] > iter0:
                if u < U_av:
                    obj = scache.obj_av[u]
                elif u < U_av + Ln:
                    obj = scache.obj_af[u - U_av]
                else:
                    obj = ts_objs[u]
            else:
                obj = st.cell_obj0[u]
            objs_f.append(obj)
            em_f.append(float(st.em_u[u]))
            mu_f.append(float(st.mu_u[u]))
            t_f.append(int(st.tcol[u]))
        else:
            e = int(e_ids[pos - nu])
            keys_f.append(st.ex_keys[e])
            objs_f.append(st.ex_objs[e])
            em_f.append(float(st.ex_em[e]))
            mu_f.append(float(st.ex_mu[e]))
            t_f.append(int(st.ex_t[e]))

    # mutate the live section in place — pipeline/engine hold references
    ck = eng.kb.ck
    ck.keys_list = keys_f
    ck.index = {kk: i for i, kk in enumerate(keys_f)}
    ck.objs = objs_f
    ck.em = np.asarray(em_f, np.float64)
    ck.mu = np.asarray(mu_f, np.float64)
    ck.t = np.asarray(t_f, np.int64)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _device(runtime) -> torch.device:
    """The device the replay runs on: the runtime scheduler's (the card
    unless the scheduler was given another)."""
    sched = getattr(runtime.planner, "scheduler", None)
    return resolve_device(getattr(sched, "device", None))


def _host(a):
    """Device tensors (nested in tuples) as numpy arrays; the copy waits
    for the device."""
    if isinstance(a, tuple):
        return tuple(_host(x) for x in a)
    return a.cpu().numpy()


def run_scanned(runtime, start: int, ticks: int):
    """Replay ``runtime.run(start, ticks)`` as one staged pass over the
    trace and one device scan (:func:`_roll`) on the runtime scheduler's
    device.  Decisions, per-tick emissions, and the learned KB are
    bit-identical to the eager loop's (the ensemble pricing runs on the
    device in numpy's summation order; parity is asserted by the test
    suite).  Falls back to the eager loop, on the same device, and
    records why in ``runtime.last_scanned_fallback`` whenever the trace
    uses a feature the staged scan does not replay."""
    from .loop import ContinuumResult, FallbackEvent

    ticks = int(ticks)
    runtime.last_scanned_fallback = None
    obs = runtime.obs if (getattr(runtime, "obs", None) is not None
                          and runtime.obs.enabled) else None
    if ticks <= 0:
        return ContinuumResult(
            ticks=[], final_assignment=dict(runtime.current or {}))
    dev = _device(runtime)          # fail before the staging pass
    watch = getattr(runtime, "watch", None)
    gatherer = runtime.pipeline.gatherer
    saved = (gatherer.signal, gatherer.forecast)
    t0 = time.perf_counter()
    try:
        if watch is not None and watch.armed:
            # armed feedback (alert -> zone evacuation -> replan) is
            # data-dependent control flow the staged scan cannot
            # express; observe-mode watchers ride the scan natively
            raise _Fallback(FallbackReason.WATCH_ARMED, tick=start)
        st = _stage(runtime, start, ticks)
    except _Fallback as fb:
        runtime.last_scanned_fallback = fb.reason
        ev = FallbackEvent(
            tick=fb.tick if fb.tick is not None else start,
            reason=fb.reason, detail=fb.detail)
        runtime.scanned_fallbacks.append(ev)
        if obs is not None:
            obs.registry.inc("runtime.scanned_fallbacks")
            obs.registry.event("runtime.scanned_fallback", tick=ev.tick,
                               reason=ev.reason, detail=ev.detail)
        st = None
    finally:
        # never leak the trace's closures — restored BEFORE any eager
        # fallback replay (which re-points and re-restores them itself)
        gatherer.signal, gatherer.forecast = saved
    if st is None:
        return runtime.run(start, ticks)
    stage_s = time.perf_counter() - t0

    with_metrics = obs is not None
    with_watch = watch is not None
    fn = _scan_fn(st.kind, with_metrics, with_watch)
    t1 = time.perf_counter()
    carry0, xs, consts = _to_device(st, dev)
    if with_metrics:
        # metric accumulator rides the carry; zero host work per tick
        carry0 = carry0 + (torch.zeros(len(SCAN_METRICS),
                                       dtype=torch.float64, device=dev),)
    if with_watch:
        # detector state rides LAST in the carry; the per-tick anomaly
        # row is stacked as the last ys element
        carry0 = carry0 + (tuple(
            torch.tensor(np.asarray(c, np.float64), device=dev)
            for c in watch.scan_carry(st.N, st.S)),)
    wconsts = watch.scan_consts() if with_watch else ()
    carry_out, ys = fn(carry0, xs, consts, wconsts)
    # the ys and the final carry come to the host once, after the last
    # tick; the commit reads numpy
    wys = _host(ys[-1]) if with_watch else None
    ys = _host(ys[:15 if with_metrics else 14])
    wcarry = _host(carry_out[-1]) if with_watch else None
    carry_out = _host(carry_out[:5 if with_metrics else 4])
    scan_s = time.perf_counter() - t1
    result = _commit(runtime, st, carry_out, ys, start, stage_s, scan_s,
                     obs=obs, device=dev)
    if with_watch:
        # threshold the stacked detector statistics and replay
        # liveness/freshness/SLO evaluation — same host code, same
        # per-tick order as the eager observe_tick
        watch.commit_scan(runtime, st, result.ticks, wys, wcarry,
                          start, obs=obs)
    if obs is not None:
        t_end = time.perf_counter()
        tr = obs.tracer
        tid = tr.add("run_scanned", t0, t_end, ticks=ticks)
        tr.add("scan.stage", t0, t0 + stage_s, parent=tid)
        tr.add("scan.fused", t1, t1 + scan_s, parent=tid)
        tr.add("scan.commit", t1 + scan_s, t_end, parent=tid)
    return result


def monte_carlo_emissions(runtime, start: int, ticks: int, ci_scales):
    """Price the whole adaptive trace under ``len(ci_scales)``
    multiplicative carbon-intensity perturbations in ONE device scan.

    The trace is staged once; only the carbon tensors (forecast
    ensemble, pairwise mean, true instantaneous CI) carry the reality
    axis — every sample replays the full adaptive loop (planning,
    hysteresis, switching) under its own carbon reality, with its own
    incumbent: each planning tick plans all M x B branches in one
    :func:`plan_branches` call.  Returns ``(totals, per_tick)``: total
    emissions (operational + migration charges) per sample ``[M]`` and
    per-tick operational emissions ``[M, T]``.  Read-only: the runtime is
    left untouched (staging works on copies; nothing is committed back).
    """
    ticks = int(ticks)
    if ticks <= 0:
        raise ValueError("monte_carlo_emissions needs ticks > 0")
    dev = _device(runtime)
    gatherer = runtime.pipeline.gatherer
    saved = (gatherer.signal, gatherer.forecast)
    try:
        st = _stage(runtime, start, ticks)
    except _Fallback as fb:
        raise ValueError(
            f"trace cannot be staged for the fused loop: {fb.reason}")
    finally:
        gatherer.signal, gatherer.forecast = saved

    scales = np.asarray(ci_scales, float).reshape(-1)
    M = scales.size
    (replan, p_i, p_v, a_i, a_v, E, order,
     ci_b, ci_mean, ek, ci_now, alive) = st.xs
    staged = copy.copy(st)
    staged.xs = (replan, p_i, p_v, a_i, a_v, E, order,
                 ci_b[:, None] * scales[None, :, None, None],
                 ci_mean[:, None] * scales[None, :, None],
                 ek,
                 ci_now[:, None] * scales[None, :, None],
                 alive)
    carry0, xs, consts = _to_device(staged, dev)
    carry0 = tuple(c.expand(M, *c.shape).clone() for c in carry0)
    _, ys = _roll(st.kind, False, False, carry0, xs, consts, ())
    em = ys[11].T.cpu().numpy()          # [M, T] operational
    mig = ys[5].T.cpu().numpy()          # [M, T] migration/restart charges
    totals = em.sum(axis=1) + mig.sum(axis=1)
    assert totals.shape == (M,)
    return totals, em
