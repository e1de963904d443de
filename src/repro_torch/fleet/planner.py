"""``plan_many``: the whole fleet as a few batched planner calls.

Planning A tenants sequentially costs A planner calls per tick, each a
few thousand launches that leave the card idle between them.
``plan_many`` instead pads every app into the pow2 bucket grid
(:class:`~repro_torch.core.problem.BucketSpec`, with its ``a`` apps
axis), groups apps by padded shape, and plans each group as ONE
:func:`~repro_torch.core.scheduler.plan_branches` call with the apps on
its row axis: every per-app tensor (E, order, warm state, communication,
penalties, masks, requirements, must-deploy, local-search bound) carries
``[A]``, and only the infrastructure (carbon, capacities, costs) is
shared.  Phantom rows that pad the app axis are inert.  The planner's
body is the single-app one, so a row decides as ``GreenScheduler.plan``
decides for that app alone.

Coupling over the SHARED node capacity (see ``fleet.problem``):

* ``"none"``      — each app sees the full capacity.  Results are
  bit-identical to per-app ``GreenScheduler.plan`` calls whenever the
  arithmetic is exact.
* ``"waterfill"`` — a host loop over the (priority-sorted) apps, one
  ``plan_branches`` call each (B=1) against the capacity REMAINING after
  its predecessors, with the warm start revalidated against it.  Zero
  over-commit by construction.
* ``"price"``     — a few rounds of the uncoupled call with per-node
  CPU/RAM shadow prices folded into the constraint-penalty tensors
  (``green_pen * P_eff == green_pen * P + lam . req`` via an effective
  penalty scale), prices raised on over-committed nodes between rounds.
  Keeps full app parallelism; residual violations are reported.

Everything runs on the scheduler's device (the CUDA card unless the
scheduler names another).  The app axis splits over the ranks of a
``torch.distributed`` process group, the counterpart of the JAX package's
``shard_map`` over its devices: when a group with ``world > 1`` is open
(every rank calling ``plan_many`` on the same fleet), each uncoupled or
priced chunk is padded to a multiple of the world (at least one row per
rank), each rank plans its contiguous slice of the padded rows with one
``plan_branches`` call on its own device, and the rows are all-gathered in
app order.  ``FleetStats.devices`` is the world size and ``sharded`` is
True once a chunk split, as the JAX package sets them.  With no group, or
a world of one (one card), the whole chunk is one call on one device.
The waterfill stays one host loop, as in the JAX package.  Decisions,
notes, emissions, capacity reports and stats equal the JAX package's
``repro.fleet.plan_many``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.lowering import (
    LoweredProblem,
    batched_lowered_emissions,
    lower_constraints,
    pad_lowering,
)
from ..core.problem import (
    BucketSpec,
    PlacementProblem,
    PlanResult,
    PlanStats,
    _round_up,
)
from ..core.scheduler import (
    COMPILE_CACHE,
    GreenScheduler,
    _pad1,
    _static_feasibility,
    _warm_start_state,
    plan_branches,
    plans_from_arrays,
)
from .problem import (
    FleetProblem,
    FleetResult,
    FleetStats,
    _CAP_EPS,
    empty_capacity_report,
    fleet_capacity_report,
)

__all__ = ["plan_many"]

_WF_WARM_NOTE = ("warm start rejected (capacity claimed by "
                 "higher-priority tenants); rebuilt from scratch")

_F64, _I64, _B8 = torch.float64, torch.int64, torch.bool
# dtypes of a chunk's stacked arguments (see _chunk_args), in order
_HEAD_DTYPES = (_F64, _I64) + (_B8, _I64, _I64, _F64, _F64)
_COMM_DTYPES = {"dense": (_F64, _B8), "sparse": (_I64, _I64, _I64, _F64)}
_TAIL_DTYPES = (_F64, _F64, _B8, _F64, _F64, _B8, _I64)


# ---------------------------------------------------------------------------
# Per-app preparation and chunk stacking
# ---------------------------------------------------------------------------


@dataclass
class _Prep:
    """One app, lowered+padded and ready to stack into an [A, ...] chunk."""

    idx: int                      # position in fleet.apps
    problem: PlacementProblem
    low: LoweredProblem           # real
    plow: LoweredProblem          # padded to the group dims
    dims: Tuple                   # (S_pad, F_pad, N_pad, L_pad)
    notes: List[str]
    warm: Tuple[np.ndarray, ...]  # padded 5-tuple
    order_pad: np.ndarray         # [S_pad]
    stat_feas: np.ndarray         # [S_pad, F_pad, N_pad] bool
    P: Optional[np.ndarray]       # None -> zero penalties
    A: Optional[np.ndarray]
    max_steps: int
    bucketed: bool
    out: Optional[Tuple[np.ndarray, ...]] = None
    ls_steps: int = 0
    extra_note: str = ""
    sig: Optional[Tuple] = None
    plan_time_s: float = 0.0
    compiled: bool = False


def _prep_app(idx: int, problem: PlacementProblem, cfg, bucket: BucketSpec,
              dims: Optional[Tuple] = None) -> _Prep:
    low = problem.lowering
    S, F, N = low.S, low.F, low.N
    L = low.comm.n_links if low.comm.kind == "sparse" else None

    notes: List[str] = []
    stat_feas_real = _static_feasibility(low)
    warm = None
    initial = problem.initial_assignment
    if initial is not None:
        warm, err = _warm_start_state(low, stat_feas_real, initial)
        if warm is None:
            notes.append(
                f"warm start rejected ({err}); rebuilt from scratch")
    if warm is None:
        warm = (np.zeros(S, dtype=bool), np.zeros(S, dtype=np.int64),
                np.zeros(S, dtype=np.int64), np.zeros(N), np.zeros(N))

    if dims is None:
        S_p, F_p, N_p, L_p, _ = bucket.pad_dims(S, F, N, L, 1)
        dims = (S_p, F_p, N_p, L_p)
    S_p, F_p, N_p, L_p = dims
    bucketed = dims != (S, F, N, L)
    plow = pad_lowering(low, S_p, F_p, N_p, L_p) if bucketed else low
    stat_feas = stat_feas_real if plow is low else _static_feasibility(plow)
    constraints = problem.constraints if cfg.use_green_constraints else ()
    P = A = None
    if constraints:
        P, A = lower_constraints(plow, constraints)
    order_pad = np.concatenate(
        [low.order, np.arange(S, S_p, dtype=low.order.dtype)]) \
        if S_p > S else low.order
    warm = (_pad1(warm[0], S_p), _pad1(warm[1], S_p), _pad1(warm[2], S_p),
            _pad1(warm[3], N_p), _pad1(warm[4], N_p))
    return _Prep(
        idx=idx, problem=problem, low=low, plow=plow, dims=dims,
        notes=notes, warm=warm, order_pad=order_pad, stat_feas=stat_feas,
        P=P, A=A,
        max_steps=cfg.local_search_rounds * max(1, S), bucketed=bucketed)


def _fleet_dims(probs: List[PlacementProblem],
                bucket: BucketSpec) -> Tuple:
    """One padded shape covering every app, so the waterfill's chunks
    stack alike.  When any app needs phantom COO edges, the shared S
    must exceed that app's real S so the phantom edges can point at a
    phantom service (same invariant ``BucketSpec.pad_dims`` enforces per
    problem)."""
    kinds = {p.lowering.comm.kind for p in probs}
    if len(kinds) > 1:
        raise ValueError(
            "waterfill coupling needs one communication backend across "
            f"the fleet, got {sorted(kinds)} — relower the apps with an "
            "explicit backend= choice")
    sparse = kinds.pop() == "sparse"
    S_p = F_p = N_p = 0
    L_p: Optional[int] = 0 if sparse else None
    for p in probs:
        low = p.lowering
        L = low.comm.n_links if sparse else None
        s, f, n, l, _ = bucket.pad_dims(low.S, low.F, low.N, L, 1)
        S_p, F_p, N_p = max(S_p, s), max(F_p, f), max(N_p, n)
        if sparse:
            L_p = max(L_p, l)
    if sparse and any(
            L_p > p.lowering.comm.n_links and S_p <= p.lowering.S
            for p in probs):
        S_p = _round_up(S_p + 1, bucket.s, bucket.s_floor)
    return (S_p, F_p, N_p, L_p)


def _chunk_args(chunk: List[_Prep], A_chunk: int,
                penalties: Optional[List[Tuple[np.ndarray, np.ndarray]]]):
    """Stack one chunk of same-shape preps into the planner's argument
    arrays, padding the app axis to ``A_chunk`` with INERT phantom apps:
    all-False feasibility and must masks (nothing placeable, nothing
    mandatory), zero warm state — a phantom row places nothing, consumes
    no capacity, and stays feasible."""
    base = chunk[0]
    plow = base.plow
    S_p, F_p, N_p, _ = base.dims
    pad = A_chunk - len(chunk)
    zeros_P = np.zeros((S_p, F_p, N_p))
    zeros_A = np.zeros((S_p, S_p))
    no_feas = np.zeros((S_p, F_p, N_p), dtype=bool)
    no_must = np.zeros(S_p, dtype=bool)
    zero_warm = (np.zeros(S_p, dtype=bool), np.zeros(S_p, dtype=np.int64),
                 np.zeros(S_p, dtype=np.int64), np.zeros(N_p),
                 np.zeros(N_p))

    def stack(rows, phantom):
        if pad:
            rows = list(rows) + [phantom] * pad
        return np.stack(rows)

    if penalties is None:
        P_rows = [p.P if p.P is not None else zeros_P for p in chunk]
        A_rows = [p.A if p.A is not None else zeros_A for p in chunk]
    else:
        P_rows = [pen[0] for pen in penalties]
        A_rows = [pen[1] for pen in penalties]

    comm_cols = list(zip(*(p.plow.comm.planner_args() for p in chunk)))
    stacked = (
        (stack([p.plow.E for p in chunk], plow.E),
         stack([p.order_pad for p in chunk], base.order_pad))
        + tuple(stack([p.warm[i] for p in chunk], zero_warm[i])
                for i in range(5))
        + tuple(stack(col, col[0]) for col in comm_cols)
        + (stack(P_rows, zeros_P),
           stack(A_rows, zeros_A),
           stack([p.stat_feas for p in chunk], no_feas),
           stack([p.plow.cpu_req for p in chunk], plow.cpu_req),
           stack([p.plow.ram_req for p in chunk], plow.ram_req),
           stack([np.asarray(p.plow.must, dtype=bool) for p in chunk],
                 no_must),
           np.array([p.max_steps for p in chunk]
                    + [base.max_steps] * pad, dtype=np.int64))
    )
    ci_mean = float(np.asarray(base.low.ci).mean()) if base.low.N else 0.0
    shared = (np.asarray(plow.ci, dtype=float), ci_mean,
              np.asarray(plow.cpu_cap, dtype=float),
              np.asarray(plow.ram_cap, dtype=float),
              np.asarray(plow.cost, dtype=float))
    return shared, stacked


def _on_device(kind: str, shared, stacked, dev: torch.device):
    """One chunk's arguments as tensors on ``dev``, each moved once."""
    dtypes = _HEAD_DTYPES + _COMM_DTYPES[kind] + _TAIL_DTYPES
    ci, ci_mean, cpu_cap, ram_cap, cost = shared

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return ((put(ci, _F64), ci_mean, put(cpu_cap, _F64),
             put(ram_cap, _F64), put(cost, _F64)),
            tuple(put(a, d) for a, d in zip(stacked, dtypes)))


def _plan_rows(kind: str, ci, ci_mean: float, cpu_cap, ram_cap, cost,
               rows, cfg, green_pen: float, max_steps):
    """One ``plan_branches`` call over the stacked app rows ``rows``
    (E, order, warm state, comm, P, A, stat_feas, cpu_req, ram_req,
    must; anything after them is ignored) with local-search bound
    ``max_steps``, against the shared infrastructure; returns the seven
    outputs on the host."""
    argc = len(_COMM_DTYPES[kind])
    E, order = rows[:2]
    B = E.shape[0]
    P, A, sf, cpur, ramr, must = rows[7 + argc:13 + argc]
    out = plan_branches(
        kind, ci.expand(B, -1),
        torch.full((B,), ci_mean, dtype=_F64, device=ci.device),
        E, order, *rows[2:7], rows[7:7 + argc], P, A, sf, cpur, ramr,
        cpu_cap, ram_cap, must, cost, float(cfg.money_weight),
        float(cfg.pref_weight), float(cfg.emission_weight),
        float(green_pen), max_steps)
    return [t.cpu().numpy() for t in (
        out.placed, out.fcur, out.ncur, out.skipped, out.infeas,
        out.fail_s, out.ls_steps)]


def _app_world() -> Tuple[int, int]:
    """(world size, rank) of the open process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _plan_rows_split(kind: str, ci, ci_mean: float, cpu_cap, ram_cap, cost,
                     rows, cfg, green_pen: float, n_dev: int, rank: int):
    """``_plan_rows`` of this rank's contiguous slice of the padded app
    rows, then every rank's slice all-gathered in rank (= app) order."""
    per = rows[0].shape[0] // n_dev
    mine = tuple(r[rank * per:(rank + 1) * per] for r in rows)
    outs = _plan_rows(kind, ci, ci_mean, cpu_cap, ram_cap, cost, mine, cfg,
                      green_pen, mine[-1])
    parts = [None] * n_dev
    dist.all_gather_object(parts, outs)
    return [np.concatenate(cols) for cols in zip(*parts)]


def _chunks(seq: List[_Prep], size: int):
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def _account(stats: FleetStats, chunk: List[_Prep], A_chunk: int,
             sig: Tuple, dev: torch.device, dt: float) -> None:
    """Book one chunk's call: the compile cache (per device type, under
    the JAX package's signature) and the fleet and per-app stats."""
    compiled = COMPILE_CACHE.record((dev.type,) + sig, dt)
    stats.calls += 1
    stats.compiles += int(compiled)
    stats.plan_time_s += dt
    stats.padded_apps += A_chunk - len(chunk)
    for prep in chunk:
        prep.sig, prep.plan_time_s, prep.compiled = sig, dt, compiled


# ---------------------------------------------------------------------------
# Execution modes
# ---------------------------------------------------------------------------


def _run_group(kind: str, preps: List[_Prep], bucket: BucketSpec, cfg,
               max_batch: int, dev: torch.device, stats: FleetStats,
               green_pen: Optional[float] = None,
               penalties: Optional[List] = None) -> None:
    """Run one same-shape group through the uncoupled planner, one call
    per chunk of the app axis; writes each prep's ``out`` row in place."""
    gp = cfg.green_penalty if green_pen is None else green_pen
    n_dev, rank = _app_world()
    pos = 0
    for chunk in _chunks(preps, max_batch):
        pens = penalties[pos:pos + len(chunk)] if penalties else None
        pos += len(chunk)
        A_real = len(chunk)
        A_chunk = bucket.pad_apps(A_real)
        use_shard = n_dev > 1
        if use_shard:
            A_chunk = max(A_chunk, n_dev)
            if A_chunk % n_dev:
                use_shard = False
        sig = ("fleet", kind, A_chunk) + chunk[0].dims + (
            (n_dev,) if use_shard else ())
        args = _chunk_args(chunk, A_chunk, pens)
        t0 = time.perf_counter()
        (ci, ci_mean, cpu_cap, ram_cap, cost), rows = _on_device(
            kind, *args, dev)
        if use_shard:
            outs = _plan_rows_split(kind, ci, ci_mean, cpu_cap, ram_cap, cost,
                                    rows, cfg, gp, n_dev, rank)
        else:
            outs = _plan_rows(kind, ci, ci_mean, cpu_cap, ram_cap, cost, rows,
                              cfg, gp, rows[-1])
        _account(stats, chunk, A_chunk, sig, dev, time.perf_counter() - t0)
        stats.sharded = stats.sharded or use_shard
        for i, prep in enumerate(chunk):
            prep.out = tuple(o[i] for o in outs[:6])
            prep.ls_steps = int(outs[6][i])


def _run_waterfill(fleet: FleetProblem, preps: List[_Prep],
                   bucket: BucketSpec, cfg, max_batch: int,
                   dev: torch.device, stats: FleetStats) -> None:
    """Priority-ordered waterfill over all apps (one shared padded shape):
    a host loop of B=1 planner calls, chunked along the app axis as the
    JAX package's scan is (one call and one signature per chunk in the
    stats).  The node-load carry stays float64 numpy on the host and adds
    each app's S placed requirements in index order, as XLA's serial
    scatter does, so its sums do not depend on scheduling."""
    kind = preps[0].low.comm.kind
    by_idx = {p.idx: p for p in preps}
    ordered = [by_idx[i] for i in fleet.waterfill_order() if i in by_idx]
    N_p = preps[0].dims[2]
    cpu_used = np.zeros(N_p)
    ram_used = np.zeros(N_p)
    for chunk in _chunks(ordered, max_batch):
        A_real = len(chunk)
        A_chunk = bucket.pad_apps(A_real)
        sig = ("fleet_wf", kind, A_chunk) + chunk[0].dims
        # the chunk's real rows only: a phantom app places nothing
        shared, stacked = _chunk_args(chunk, A_real, None)
        cpu_cap, ram_cap = shared[2], shared[3]
        t0 = time.perf_counter()
        (ci, ci_mean, _, _, cost), rows = _on_device(kind, shared, stacked,
                                                     dev)
        for i, prep in enumerate(chunk):
            rem_cpu = cpu_cap - cpu_used
            rem_ram = ram_cap - ram_used
            wp, wf, wn, wcpu, wram = prep.warm
            ok = bool((wcpu <= rem_cpu).all() & (wram <= rem_ram).all())
            app = [r[i:i + 1] for r in rows]
            if not ok:
                # predecessors took the warm start's room: rebuild cold
                app[2:7] = [torch.zeros_like(r) for r in app[2:7]]
            placed, fcur, ncur, skipped, infeas, fail_s, ls = (
                o[0] for o in _plan_rows(
                    kind, ci, ci_mean, torch.tensor(rem_cpu, device=dev),
                    torch.tensor(rem_ram, device=dev), cost, app, cfg,
                    cfg.green_penalty, prep.max_steps))
            # an infeasible app deploys nothing -> consumes nothing
            use = placed & ~infeas
            for used, req in ((cpu_used, prep.plow.cpu_req),
                              (ram_used, prep.plow.ram_req)):
                np.add.at(used, ncur, np.where(
                    use, np.take_along_axis(req, fcur[:, None], 1)[:, 0],
                    0.0))
            prep.out = (placed, fcur, ncur, skipped, infeas, fail_s)
            prep.ls_steps = int(ls)
            if bool(wp.any()) and not ok:
                prep.extra_note = _WF_WARM_NOTE
        _account(stats, chunk, A_chunk, sig, dev, time.perf_counter() - t0)


def _loads_from_preps(preps: List[_Prep], N: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Fleet-total per-node loads from the current (real-sliced) planner
    outputs — the price iteration's subgradient input."""
    cpu = np.zeros(N)
    ram = np.zeros(N)
    for p in preps:
        placed, fcur, ncur = (a[:p.low.S] for a in p.out[:3])
        infeas = bool(p.out[4])
        if infeas or not placed.any():
            continue
        sel_cpu = np.take_along_axis(
            p.low.cpu_req, fcur[:, None], axis=1)[:, 0]
        sel_ram = np.take_along_axis(
            p.low.ram_req, fcur[:, None], axis=1)[:, 0]
        cpu += np.bincount(ncur[placed], weights=sel_cpu[placed],
                           minlength=N)
        ram += np.bincount(ncur[placed], weights=sel_ram[placed],
                           minlength=N)
    return cpu, ram


def _price_penalties(prep: _Prep, lam_cpu: np.ndarray, lam_ram: np.ndarray,
                     gp: float, gp_eff: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold per-node shadow prices into the app's penalty tensors.

    The planner scores ``green_pen * P`` — with ``green_pen`` replaced by
    ``gp_eff`` and ``P`` by ``(gp * P + lam . req) / gp_eff``, the scored
    term is exactly ``gp * P + lam_cpu[n] * cpu_req + lam_ram[n] *
    ram_req``: the original constraint penalties plus the Lagrangian
    capacity prices.  ``gp_eff = gp or 1`` keeps the fold well-defined
    when green constraints are off (gp == 0)."""
    plow = prep.plow
    lamc = _pad1(lam_cpu, plow.N)
    lamr = _pad1(lam_ram, plow.N)
    P0 = prep.P if prep.P is not None else 0.0
    P_eff = (gp * P0
             + lamc[None, None, :] * plow.cpu_req[:, :, None]
             + lamr[None, None, :] * plow.ram_req[:, :, None]) / gp_eff
    A0 = prep.A if prep.A is not None \
        else np.zeros((plow.S, plow.S))
    return P_eff, A0 * (gp / gp_eff)


def _run_price(fleet: FleetProblem, groups: Dict[Tuple, List[_Prep]],
               bucket: BucketSpec, cfg, max_batch: int, dev: torch.device,
               stats: FleetStats) -> None:
    ref = fleet.apps[0].lowering
    N = ref.N
    cpu_cap = np.asarray(ref.cpu_cap, dtype=float)
    ram_cap = np.asarray(ref.ram_cap, dtype=float)
    gp = cfg.green_penalty
    gp_eff = gp if gp != 0.0 else 1.0
    lam_cpu = np.zeros(N)
    lam_ram = np.zeros(N)
    all_preps = [p for preps in groups.values() for p in preps]
    for _ in range(max(1, fleet.price_rounds)):
        for (kind, *_dims), preps in groups.items():
            pens = [_price_penalties(p, lam_cpu, lam_ram, gp, gp_eff)
                    for p in preps]
            _run_group(kind, preps, bucket, cfg, max_batch, dev, stats,
                       green_pen=gp_eff, penalties=pens)
        stats.price_rounds += 1
        cpu_load, ram_load = _loads_from_preps(all_preps, N)
        exc_cpu = np.maximum(cpu_load - cpu_cap, 0.0)
        exc_ram = np.maximum(ram_load - ram_cap, 0.0)
        if (exc_cpu <= _CAP_EPS).all() and (exc_ram <= _CAP_EPS).all():
            break
        lam_cpu += fleet.price_step * exc_cpu
        lam_ram += fleet.price_step * exc_ram


# ---------------------------------------------------------------------------
# Result materialization
# ---------------------------------------------------------------------------


def _finalize(prep: _Prep, dev: torch.device) -> PlanResult:
    """Slice one app's padded planner row back to its real shape and build
    the same B=1 :class:`PlanResult` the sequential path would — shared
    emissions reduction (``batched_lowered_emissions`` on the REAL
    lowering) and shared plan construction (``plans_from_arrays``)."""
    low = prep.low
    S = low.S
    placed, fcur, ncur, skipped, infeas, fail_s = prep.out
    placed_b = np.asarray(placed[:S], dtype=bool)[None]
    fcur_b = np.asarray(fcur[:S])[None]
    ncur_b = np.asarray(ncur[:S])[None]
    skipped_b = np.asarray(skipped[:S], dtype=bool)[None]
    infeas_b = np.asarray([bool(infeas)])
    fail_b = np.asarray([int(fail_s)])
    em_b = batched_lowered_emissions(
        low, placed_b, fcur_b, ncur_b,
        ci=np.asarray(low.ci, dtype=float)[None])
    notes = list(prep.notes)
    if prep.extra_note:
        notes.append(prep.extra_note)
    plans = plans_from_arrays(
        low, notes, placed_b, fcur_b, ncur_b, skipped_b, infeas_b,
        fail_b, low.order[None], em_b)
    L = low.comm.n_links if low.comm.kind == "sparse" else None
    stats = PlanStats(
        backend=low.comm.kind,
        shape=(1, S, low.F, low.N, L),
        padded_shape=(prep.sig[2],) + prep.dims,
        signature=prep.sig, bucketed=prep.bucketed,
        compiled=prep.compiled,
        compile_time_s=prep.plan_time_s if prep.compiled else 0.0,
        plan_time_s=prep.plan_time_s,
        cache_hits=COMPILE_CACHE.hits, cache_misses=COMPILE_CACHE.misses,
        device=str(dev), greedy_steps=prep.dims[0],
        local_search_steps=(prep.ls_steps,))
    return PlanResult(
        problem=prep.problem, plans=plans, placed=placed_b, fcur=fcur_b,
        ncur=ncur_b,
        emissions_g=np.where(plans[0].feasible, em_b, np.inf),
        stats=stats)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def plan_many(fleet: FleetProblem,
              scheduler: Optional[GreenScheduler] = None, *,
              bucket: Optional[BucketSpec] = None,
              max_batch: int = 256) -> FleetResult:
    """Plan every app of a :class:`FleetProblem` in batched planner calls.

    ``scheduler`` supplies the objective configuration and the device
    (defaults to a fresh ``GreenScheduler()``: the card, raising without
    one); ``bucket`` the shape grid for both the per-app dims and the
    app axis (defaults to the scheduler's bucket, else pow2).
    ``max_batch`` bounds apps per call, trading peak memory against the
    number of calls.

    Returns a :class:`FleetResult` with one B=1 ``PlanResult`` per app
    (same order as ``fleet.apps``), per-app emissions, the shared-node
    :class:`CapacityReport`, and call telemetry on ``.stats``.
    """
    scheduler = scheduler if scheduler is not None else GreenScheduler()
    dev = resolve_device(scheduler.device)
    cfg = scheduler.config
    bucket = bucket if bucket is not None else (
        cfg.bucket if cfg.bucket is not None else BucketSpec())
    A = fleet.A
    stats = FleetStats(apps=A)
    results: List[Optional[PlanResult]] = [None] * A

    if A == 0:
        return FleetResult(
            fleet=fleet, results=[], emissions_g=np.zeros(0),
            capacity=empty_capacity_report(),
            coupling=fleet.coupling, stats=stats)

    stats.devices = _app_world()[0]

    # Shape-degenerate apps (no services / no nodes) take the scheduler's
    # host path — nothing to batch, nothing consumed.
    batched: List[Tuple[int, PlacementProblem]] = []
    for i, p in enumerate(fleet.apps):
        if p.lowering.S == 0 or p.lowering.N == 0:
            results[i] = scheduler.plan(p)
        else:
            batched.append((i, p))

    if batched:
        if fleet.coupling == "waterfill":
            dims = _fleet_dims([p for _, p in batched], bucket)
            preps = [_prep_app(i, p, cfg, bucket, dims)
                     for i, p in batched]
            stats.groups = 1
            _run_waterfill(fleet, preps, bucket, cfg, max_batch, dev, stats)
        else:
            preps = [_prep_app(i, p, cfg, bucket) for i, p in batched]
            groups: Dict[Tuple, List[_Prep]] = {}
            for prep in preps:
                key = (prep.low.comm.kind,) + prep.dims
                groups.setdefault(key, []).append(prep)
            stats.groups = len(groups)
            if fleet.coupling == "price":
                _run_price(fleet, groups, bucket, cfg, max_batch, dev, stats)
            else:
                for (kind, *_dims), grp in groups.items():
                    _run_group(kind, grp, bucket, cfg, max_batch, dev, stats)
        for prep in preps:
            results[prep.idx] = _finalize(prep, dev)

    emissions = np.array([float(r.emissions_g[0]) for r in results])
    capacity = fleet_capacity_report(fleet, results)
    return FleetResult(
        fleet=fleet, results=results, emissions_g=emissions,
        capacity=capacity, coupling=fleet.coupling, stats=stats)
