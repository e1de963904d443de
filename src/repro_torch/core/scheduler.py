"""Constraint-aware deployment scheduler (array-native core).

The paper delegates plan generation to an external constraint-based scheduler
([36]); we implement one as the required baseline so the whole pipeline is
runnable end-to-end.  The scheduler minimises a weighted objective

  J(assign) = money_weight   * monetary cost
            + pref_weight    * flavour-preference penalty (flavoursOrder)
            + emission_weight* emissions(assign)            [oracle only]
            + green_penalty  * sum over violated green constraints of
                               w_i * mu_i                   (soft constraints)

subject to hard requirements: subnet compatibility, node capacities
(CPU/RAM), availability.  Optional services may be dropped when no feasible
placement exists.

Two implementations share the objective:

* ``GreenScheduler`` — the array-native core with ONE public entrypoint:
  ``plan(problem: PlacementProblem) -> PlanResult``.  It runs in float64
  torch on one device (the CUDA card unless the caller names another).
  Greedy construction is a host loop over the service order and
  best-improvement local search a host loop over the ``[S, F, N]``
  single-relocation move grid; every step is a handful of tensor ops over
  an explicit leading axis of scenario branches, so an unbatched problem
  is simply B=1 on the same path (:func:`plan_branches`).  Pairwise
  communication terms come from the lowering's pluggable backend: dense
  ``[S, F, S]`` products (``DenseLowering``) or COO segment sums
  (``SparseCommLowering``).  With a ``SchedulerConfig.bucket``
  (:class:`~repro_torch.core.problem.BucketSpec`), problem shapes are
  rounded up to bucket boundaries and padded with masked-out phantom
  entries; the planner compile cache tracks hits/misses per bucket
  signature (``compile_cache_stats()``), and every ``PlanResult`` carries
  its call's telemetry on ``.stats``.  Its decisions are those of the JAX
  package's ``GreenScheduler`` on the same problem.
* ``ReferenceScheduler`` — the legacy object-walking greedy +
  first-improvement local search, retained verbatim for equivalence testing
  and old-vs-new benchmarking.  ``reference_objective`` exposes its
  objective for any assignment.

Three standard profiles:
  * ``baseline``  — QoS/cost-driven, environment-blind (what today's
    schedulers do; the paper's motivation);
  * ``green``     — baseline + the generated green constraints;
  * ``oracle``    — directly minimises emissions (upper bound on savings).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .library import subnet_compatible
from .lowering import (
    LoweredProblem,
    ScenarioBatch,
    batched_lowered_emissions,
    lower_constraints,
    pad_lowering,
)
from .problem import BucketSpec, PlacementProblem, PlanResult, PlanStats
from .. import resolve_device
from ..obs.registry import REGISTRY as _REGISTRY
from .types import (
    Affinity,
    Application,
    AvoidNode,
    Constraint,
    DeploymentPlan,
    Infrastructure,
    Placement,
    Service,
)

# Improvement threshold shared by both local searches (a move must beat the
# incumbent by more than this to be taken).
_EPS = 1e-12


@dataclass
class SchedulerConfig:
    money_weight: float = 1.0
    pref_weight: float = 1.0
    emission_weight: float = 0.0
    green_penalty: float = 5.0
    use_green_constraints: bool = True
    local_search_rounds: int = 50
    # Shape buckets: when set, problem shapes are rounded up to the
    # spec's bucket boundaries and the tensors padded with masked-out
    # phantom entries, so every shape in a bucket shares one planner
    # signature (None = exact shapes, one signature per shape).
    bucket: Optional[BucketSpec] = None

    @classmethod
    def baseline(cls) -> "SchedulerConfig":
        return cls(use_green_constraints=False)

    @classmethod
    def green(cls) -> "SchedulerConfig":
        return cls(use_green_constraints=True)

    @classmethod
    def oracle(cls) -> "SchedulerConfig":
        return cls(money_weight=0.0, pref_weight=0.0, emission_weight=1.0,
                   use_green_constraints=False)


# ---------------------------------------------------------------------------
# Array-native scheduler (torch, float64, an explicit leading branch axis)
# ---------------------------------------------------------------------------

# The local search tests "has every branch stopped?" on the host once per
# this many steps.  A stopped branch changes nothing (its updates are
# masked off), so the check's period moves no result — it only bounds the
# device-to-host syncs to one per 16 steps.
STOP_CHECK_EVERY = 16


def _segment_sum(size: int, index, values):
    """``zeros(size).at[index].add(values)`` in an order that does not
    depend on scheduling: on the CPU ``index_add_`` walks the updates in
    order; on CUDA ``index_put_(accumulate=True)`` sorts the indices first
    and adds each segment without atomics, so two runs give the same
    bits."""
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    if values.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def _onehot(placed_f, ncur, N: int):
    """``onehot[b, z, n]`` = 1 iff service z of branch b is placed on n."""
    ar_n = torch.arange(N, device=ncur.device)
    return (ncur[:, :, None] == ar_n) * placed_f[:, :, None]


def _finish_move_deltas(score, onehot, stat_feas, cpu_req, ram_req,
                        cpu_cap, ram_cap, placed, fcur, ncur,
                        cpu_load, ram_load):
    """Backend-independent tail of the move-grid evaluation: subtract the
    incumbent's score, mask capacity-infeasible cells (with the service's
    own load removed), unplaced services, and the incumbent cell.

    ``score`` is ``[B, S, F, N]``; the assignment and loads carry ``[B]``;
    masks, requirements and capacities are shared by every branch."""
    B, S, F, N = score.shape
    dev = score.device
    cur = score.gather(2, fcur[:, :, None, None].expand(B, S, 1, N))[:, :, 0]
    cur = cur.gather(2, ncur[:, :, None])[:, :, 0]              # [B, S]
    delta = score - cur[:, :, None, None]

    ar_s = torch.arange(S, device=dev)[None, :]
    own_cpu = cpu_req[ar_s, fcur]                               # [B, S]
    own_ram = ram_req[ar_s, fcur]
    cpu_wo = cpu_load[:, None, :] - own_cpu[:, :, None] * onehot
    ram_wo = ram_load[:, None, :] - own_ram[:, :, None] * onehot
    feas = (stat_feas[None]
            & (cpu_wo[:, :, None, :] + cpu_req[None, :, :, None]
               <= cpu_cap)
            & (ram_wo[:, :, None, :] + ram_req[None, :, :, None]
               <= ram_cap))
    mask = feas & placed[:, :, None, None]
    incumbent = ((torch.arange(F, device=dev)[:, None]
                  == fcur[:, :, None, None])
                 & (torch.arange(N, device=dev)
                    == ncur[:, :, None, None]))
    mask = mask & ~incumbent
    return torch.where(mask, delta, torch.inf)


def _dense_move_score(static, W, placed, fcur, ncur):
    """Move-grid score[b, s, f, n] = J-contribution of s at (f, n), dense
    ``W[b, s, f, z]``."""
    B, S, F, N = static.shape
    placed_f = placed.to(static.dtype)
    onehot = _onehot(placed_f, ncur, N)                          # [B, S, N]

    # outgoing links s -> z: pay W[s, f, z] unless z sits on the target node
    t_out = (W * placed_f[:, None, None, :]).sum(-1)             # [B, S, F]
    out = t_out[..., None] - torch.bmm(
        W.reshape(B, S * F, S), onehot).view(B, S, F, N)
    # incoming links z -> s under z's *current* flavour
    Wf = W.gather(2, fcur[:, :, None, None].expand(B, S, 1, S))[:, :, 0]
    Wf = Wf * placed_f[:, :, None]                               # [B, Z, S]
    inn = Wf.sum(1)[:, :, None] - torch.bmm(Wf.transpose(1, 2), onehot)
    return static + out + inn[:, :, None, :], onehot


def _sparse_move_score(static, esrc, ef, edst, w, placed, fcur, ncur):
    """Same score as :func:`_dense_move_score` from a COO edge list — all
    pairwise terms are O(B L) segment sums instead of O(B S^2 F N)
    products.  ``w`` is ``[B, L]``; the edge columns are shared."""
    B, S, F, N = static.shape
    dev = static.device
    placed_f = placed.to(static.dtype)
    onehot = _onehot(placed_f, ncur, N)
    boff = torch.arange(B, device=dev)[:, None]

    w_out = (w * placed_f[:, edst]).reshape(-1)                  # [B L]
    flat_sf = esrc * F + ef
    t_out = _segment_sum(
        B * S * F, (boff * (S * F) + flat_sf).reshape(-1),
        w_out).view(B, S, F)
    colloc = _segment_sum(
        B * S * F * N,
        (boff * (S * F * N) + flat_sf * N + ncur[:, edst]).reshape(-1),
        w_out).view(B, S, F, N)
    out = t_out[..., None] - colloc

    w_in = (w * placed_f[:, esrc] * (ef == fcur[:, esrc])).reshape(-1)
    inn_sum = _segment_sum(
        B * S, (boff * S + edst).reshape(-1), w_in).view(B, S)
    in_colloc = _segment_sum(
        B * S * N, (boff * (S * N) + edst * N + ncur[:, esrc]).reshape(-1),
        w_in).view(B, S, N)
    inn = inn_sum[..., None] - in_colloc
    return static + out + inn[:, :, None, :], onehot


@dataclass
class PlannerOutput:
    """What :func:`plan_branches` returns: the per-branch decisions as
    device tensors, and each branch's local-search iterations (the greedy
    takes one step per service)."""

    placed: torch.Tensor        # [B, S] bool
    fcur: torch.Tensor          # [B, S] int64
    ncur: torch.Tensor          # [B, S] int64
    skipped: torch.Tensor       # [B, S] bool
    infeas: torch.Tensor        # [B] bool
    fail_s: torch.Tensor        # [B] int64, -1 where no mandatory failure
    ls_steps: torch.Tensor      # [B] int64 local-search iterations run


def plan_branches(kind: str, ci, ci_mean, E, order, w_placed, w_fcur,
                  w_ncur, w_cpu, w_ram, comm_args, P, A, stat_feas,
                  cpu_req, ram_req, cpu_cap, ram_cap, must, cost,
                  money_w: float, pref_w: float, emission_w: float,
                  green_pen: float, max_steps: int) -> PlannerOutput:
    """The planner over B scenario branches, for communication storage
    ``kind`` ("dense" | "sparse").

    Only ``ci [B, N]``, ``ci_mean [B]``, ``E [B, S, F]`` and
    ``order [B, S]`` carry the branch axis; the warm-start state
    (``w_*``), the communication tensors (dense: ``K, has_link``; sparse:
    the COO ``src, fidx, dst, k``), the penalties ``P, A``, the masks,
    requirements, capacities and costs are shared.  Every tensor lives on
    one device in float64 / int64 / bool.

    Per branch: greedy construction walks the branch's service order, and
    best-improvement local search takes the best single relocation of the
    ``[S, F, N]`` move grid while it beats the incumbent by more than
    ``_EPS``, for at most ``max_steps`` steps.  A branch whose search has
    stopped (or whose construction failed) keeps its state while others
    go on.  Scoring, row-major tie-breaks (flavour rank, then node index),
    the improvement threshold and the must-deploy bailout are those of
    the JAX package's ``planner_single``.
    """
    B, S, F = E.shape
    N = ci.shape[1]
    dev, dt = ci.device, ci.dtype
    ar_b = torch.arange(B, device=dev)
    ar_s = torch.arange(S, device=dev)
    static = (money_w * cost[None, None, :] * cpu_req[:, :, None]
              + pref_w * torch.arange(F, dtype=dt, device=dev)[:, None]
              + emission_w * E[..., None] * ci[:, None, None, :]
              + green_pen * P)                                  # [B, S, F, N]
    # the branch's REAL mean CI, passed explicitly: phantom bucket nodes
    # must not dilute the pairwise-transmission pricing
    wK = emission_w * ci_mean                                   # [B]
    if kind == "dense":
        K, has_link = comm_args
        W = (wK[:, None, None, None] * K
             + green_pen * A[:, None, :] * has_link)            # [B, S, F, S]

        def greedy_comm(s, placed_f, fcur, ncur, onehot):
            w_out = W[ar_b, s] * placed_f[:, None, :]           # [B, F, S]
            colloc = torch.bmm(w_out, onehot)                   # [B, F, N]
            v_in = W[ar_b[:, None], ar_s, fcur, s[:, None]] * placed_f
            in_colloc = torch.bmm(v_in[:, None, :], onehot)[:, 0]
            return ((w_out.sum(2)[:, :, None] - colloc)
                    + (v_in.sum(1)[:, None] - in_colloc)[:, None, :])

        def move_score(placed, fcur, ncur):
            return _dense_move_score(static, W, placed, fcur, ncur)
    elif kind == "sparse":
        esrc, ef, edst, ek = comm_args
        w = wK[:, None] * ek + green_pen * A[esrc, edst]        # [B, L]
        boff = ar_b[:, None]

        def greedy_comm(s, placed_f, fcur, ncur, onehot):
            w_eff = (w * (esrc == s[:, None])
                     * placed_f[:, edst]).reshape(-1)           # [B L]
            t_out = _segment_sum(
                B * F, (boff * F + ef).reshape(-1), w_eff).view(B, F)
            colloc = _segment_sum(
                B * F * N, (boff * (F * N) + ef * N
                            + ncur[:, edst]).reshape(-1),
                w_eff).view(B, F, N)
            w_in = (w * ((edst == s[:, None]) & (ef == fcur[:, esrc]))
                    * placed_f[:, esrc])                        # [B, L]
            in_colloc = _segment_sum(
                B * N, (boff * N + ncur[:, esrc]).reshape(-1),
                w_in.reshape(-1)).view(B, N)
            return ((t_out[:, :, None] - colloc)
                    + (w_in.sum(1)[:, None] - in_colloc)[:, None, :])

        def move_score(placed, fcur, ncur):
            return _sparse_move_score(static, esrc, ef, edst, w, placed,
                                      fcur, ncur)
    else:
        raise ValueError(f"unknown planner kind {kind!r}")

    placed = w_placed[None].expand(B, S).clone()
    fcur = w_fcur[None].expand(B, S).clone()
    ncur = w_ncur[None].expand(B, S).clone()
    cpu_load = w_cpu[None].expand(B, N).clone()
    ram_load = w_ram[None].expand(B, N).clone()
    skipped = torch.zeros(B, S, dtype=torch.bool, device=dev)
    infeas = torch.zeros(B, dtype=torch.bool, device=dev)
    fail_s = torch.full((B,), -1, dtype=order.dtype, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    # -- greedy construction: one step per position of each branch's order
    for k in range(S):
        s = order[:, k]                                         # [B]
        feas = (stat_feas[s]
                & (cpu_load[:, None, :] + cpu_req[s][:, :, None] <= cpu_cap)
                & (ram_load[:, None, :] + ram_req[s][:, :, None]
                   <= ram_cap))                                 # [B, F, N]
        placed_f = placed.to(dt)
        onehot = _onehot(placed_f, ncur, N)
        score = static[ar_b, s] + greedy_comm(s, placed_f, fcur, ncur,
                                              onehot)
        score = torch.where(feas, score, torch.inf)
        any_feas = feas.view(B, -1).any(1)
        kk = score.view(B, -1).argmin(1)   # row-major: flavour, node
        f, n = kk // N, kk % N
        placed_s = placed[ar_b, s]
        fresh = ~infeas & ~placed_s
        do = any_feas & fresh
        placed[ar_b, s] = placed_s | do
        fcur[ar_b, s] = torch.where(do, f, fcur[ar_b, s])
        ncur[ar_b, s] = torch.where(do, n, ncur[ar_b, s])
        # a branch that places nothing still adds 0.0 at node n
        cpu_load[ar_b, n] = cpu_load[ar_b, n] + torch.where(
            do, cpu_req[s, f], zero)
        ram_load[ar_b, n] = ram_load[ar_b, n] + torch.where(
            do, ram_req[s, f], zero)
        must_s = must[s]
        new_fail = ~any_feas & fresh & must_s
        skipped[ar_b, s] = skipped[ar_b, s] | (~any_feas & fresh & ~must_s)
        fail_s = torch.where(new_fail & (fail_s < 0), s, fail_s)
        infeas = infeas | new_fail

    # -- best-improvement local search; infeasible branches skip it
    done = infeas.clone()
    ls_steps = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(max_steps):
        if t % STOP_CHECK_EVERY == 0 and bool(done.all()):
            break
        active = ~done
        score, onehot = move_score(placed, fcur, ncur)
        delta = _finish_move_deltas(
            score, onehot, stat_feas, cpu_req, ram_req, cpu_cap, ram_cap,
            placed, fcur, ncur, cpu_load, ram_load).view(B, -1)
        kk = delta.argmin(1)
        improve = delta.gather(1, kk[:, None])[:, 0] < -_EPS
        s = kk // (F * N)
        f = (kk % (F * N)) // N
        n = kk % N
        do = improve & active
        old_f, old_n = fcur[ar_b, s], ncur[ar_b, s]
        # the reference's order: old node -cpu, -ram; new node +cpu, +ram
        cpu_load[ar_b, old_n] = cpu_load[ar_b, old_n] + torch.where(
            do, -cpu_req[s, old_f], zero)
        ram_load[ar_b, old_n] = ram_load[ar_b, old_n] + torch.where(
            do, -ram_req[s, old_f], zero)
        cpu_load[ar_b, n] = cpu_load[ar_b, n] + torch.where(
            do, cpu_req[s, f], zero)
        ram_load[ar_b, n] = ram_load[ar_b, n] + torch.where(
            do, ram_req[s, f], zero)
        fcur[ar_b, s] = torch.where(do, f, old_f)
        ncur[ar_b, s] = torch.where(do, n, old_n)
        ls_steps = ls_steps + active
        done = done | (active & ~improve)
    return PlannerOutput(placed, fcur, ncur, skipped, infeas, fail_s,
                         ls_steps)


# ---------------------------------------------------------------------------
# Planner compile cache: one entry per (device type, backend kind, padded
# program shape); the last two are the signature under which the JAX
# package compiles its programs.  The torch planner compiles nothing; it
# keeps the same hit/miss accounting so PlanResult.stats and the registry
# read the same, per device, so a plan on the card and its twin on the CPU
# account alike.
# ---------------------------------------------------------------------------


class PlannerCompileCache:
    """Counters over the planner's program signatures.

    A *miss* is a signature this process has never planned on that device
    type before (the first call of a padded shape on the card, or on the
    CPU); every later call of it there is a *hit*.
    Nothing is compiled: a miss's ``compile_time_s`` is that first call's
    plan time.  ``reset_counters()`` zeroes the windowed counters but
    keeps the signature registry: replanning a known shape after a reset
    is still a hit.
    """

    def __init__(self) -> None:
        self.signatures: Dict[Tuple, Dict[str, float]] = {}
        self.reset_counters()

    def reset_counters(self) -> None:
        self.calls = 0
        self.hits = 0
        self.misses = 0
        self.compile_time_s = 0.0

    def record(self, sig: Tuple, plan_time_s: float) -> bool:
        """Account one planner call; returns True when it compiled.

        Every call is mirrored onto the global metrics registry
        (``planner.compile.{calls,hits,misses,time_s}``) — read those
        with ``repro_torch.obs.metrics_scope`` for bleed-free deltas instead
        of resetting these process-global counters.
        """
        self.calls += 1
        _REGISTRY.inc("planner.compile.calls")
        entry = self.signatures.get(sig)
        if entry is None:
            self.misses += 1
            self.compile_time_s += plan_time_s
            self.signatures[sig] = {"calls": 1,
                                    "compile_time_s": plan_time_s}
            _REGISTRY.inc("planner.compile.misses")
            _REGISTRY.inc("planner.compile.time_s", plan_time_s)
            return True
        self.hits += 1
        _REGISTRY.inc("planner.compile.hits")
        entry["calls"] += 1
        return False

    def stats(self) -> Dict[str, float]:
        return {
            "calls": self.calls,
            "hits": self.hits,
            "misses": self.misses,
            "compile_time_s": self.compile_time_s,
            "distinct_signatures": len(self.signatures),
        }


COMPILE_CACHE = PlannerCompileCache()


def compile_cache_stats() -> Dict[str, float]:
    """Snapshot of the planner compile cache (counts since the last
    ``reset_compile_cache_counters`` call; ``distinct_signatures`` is
    process-lifetime)."""
    return COMPILE_CACHE.stats()


def reset_compile_cache_counters() -> None:
    """Zero the windowed hit/miss/compile-time counters (the signature
    registry — what decides hit vs miss — is kept)."""
    COMPILE_CACHE.reset_counters()


def plans_from_arrays(
    low: LoweredProblem,
    notes: Sequence[str],
    placed_b: np.ndarray,   # [B, S] bool (already sliced to real S)
    fcur_b: np.ndarray,     # [B, S]
    ncur_b: np.ndarray,     # [B, S]
    skipped_b: np.ndarray,  # [B, S] bool
    infeas_b: np.ndarray,   # [B] bool
    fail_b: np.ndarray,     # [B] int — first mandatory failure, -1 if none
    order_b: np.ndarray,    # [B, S] greedy construction order
    em_b: np.ndarray,       # [B] emissions (grams)
) -> List[DeploymentPlan]:
    """Materialize one :class:`DeploymentPlan` per branch row from sliced
    planner output arrays — the object-construction tail of
    ``GreenScheduler.plan``."""
    S = low.S
    plans: List[DeploymentPlan] = []
    for b in range(placed_b.shape[0]):
        if infeas_b[b]:
            sid = low.service_ids[int(fail_b[b])]
            plans.append(DeploymentPlan(
                placements=(),
                feasible=False,
                notes=tuple(notes) + (f"no feasible node for {sid}",),
            ))
            continue
        assign = {
            low.service_ids[s]: (
                low.flavour_names[s][int(fcur_b[b, s])],
                low.node_ids[int(ncur_b[b, s])])
            for s in range(S) if placed_b[b, s]
        }
        plans.append(DeploymentPlan(
            placements=tuple(
                Placement(sid, f, n)
                for sid, (f, n) in sorted(assign.items())),
            skipped_services=tuple(
                low.service_ids[int(s)] for s in order_b[b]
                if skipped_b[b, s]),
            total_emissions_g=float(em_b[b]),
            feasible=True,
            notes=tuple(notes),
        ))
    return plans


def _pad1(a: np.ndarray, size: int) -> np.ndarray:
    """Pad a 1-D array with zeros (False / 0) up to ``size``."""
    if a.shape[0] == size:
        return a
    out = np.zeros(size, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _static_feasibility(low: LoweredProblem) -> np.ndarray:
    """Load-independent feasibility mask [S, F, N]: real flavour slot,
    subnet compatibility, availability."""
    return (low.valid[:, :, None]
            & low.compat[:, None, :]
            & (low.avail_cap[None, None, :] >= low.avail_req[:, :, None]))


def _warm_start_state(
    low: LoweredProblem,
    stat_feas: np.ndarray,
    initial: Mapping[str, Tuple[str, str]],
) -> Tuple[Optional[Tuple], Optional[str]]:
    """Validate an initial assignment against the lowered masks.

    Returns ``((placed, fcur, ncur, cpu_load, ram_load), None)`` when every
    entry names a known (service, flavour, node), passes the static
    feasibility mask, and the accumulated loads respect node capacities;
    otherwise ``(None, reason)`` so the caller can reject-and-rebuild.
    """
    S, N = low.S, low.N
    sidx, nidx = low.service_index(), low.node_index()
    placed = np.zeros(S, dtype=bool)
    fcur = np.zeros(S, dtype=np.int64)
    ncur = np.zeros(S, dtype=np.int64)
    cpu_load = np.zeros(N)
    ram_load = np.zeros(N)
    for sid, (fname, nid) in initial.items():
        s, n = sidx.get(sid), nidx.get(nid)
        if s is None or n is None:
            return None, f"unknown service/node {sid!r} -> {nid!r}"
        try:
            f = low.flavour_names[s].index(fname)
        except ValueError:
            return None, f"unknown flavour {fname!r} of {sid!r}"
        if not stat_feas[s, f, n]:
            return None, f"{sid!r} infeasible on {nid!r} (mask)"
        placed[s] = True
        fcur[s], ncur[s] = f, n
        cpu_load[n] += low.cpu_req[s, f]
        ram_load[n] += low.ram_req[s, f]
    if (cpu_load > low.cpu_cap).any() or (ram_load > low.ram_cap).any():
        return None, "capacity exceeded"
    return (placed, fcur, ncur, cpu_load, ram_load), None


@dataclass
class GreenScheduler:
    """Array-native greedy + vectorized best-improvement local search.

    One public entrypoint: ``plan(problem: PlacementProblem)`` returns a
    :class:`~repro_torch.core.problem.PlanResult` with one plan per scenario
    branch (B=1 when the problem carries no scenario batch).  The problem
    object bundles everything the planner needs — lowering (dense or
    sparse communication backend), constraints, optional what-if
    scenarios, optional warm start.

    The planner runs in float64 on ``device``: the CUDA card by default
    (raising when there is none), the CPU only when the caller passes
    ``device="cpu"``.
    """

    config: SchedulerConfig = field(default_factory=SchedulerConfig)
    device: Optional[str] = None

    def plan(self, problem: PlacementProblem) -> PlanResult:
        """Plan a deployment: ``plan(problem) -> PlanResult``.

        Scenarios and warm start travel on the problem
        (``problem.with_scenarios(...)`` / ``problem.with_warm_start(...)``).
        A warm start maps service -> (flavour, node); it is verified
        against the capacity / subnet / availability masks first, rejected
        as a whole on any violation, and the plan rebuilt greedily from
        scratch (noted on the returned plan).
        """
        if not isinstance(problem, PlacementProblem):
            raise TypeError(
                "GreenScheduler.plan takes a PlacementProblem; the old "
                "positional plan(app, infra, computation, communication, "
                "...) and plan_batch forms were removed — build a problem "
                "with PlacementProblem.build(...) or pipeline."
                "problem_for(out) instead")
        return self._plan_problem(problem)

    # -- the one real planning path ----------------------------------------

    def _plan_problem(self, problem: PlacementProblem) -> PlanResult:
        cfg = self.config
        dev = resolve_device(self.device)
        low = problem.lowering
        constraints = problem.constraints if cfg.use_green_constraints \
            else ()
        scenarios = problem.scenarios
        if scenarios is None:
            scenarios = ScenarioBatch(
                ci=np.asarray(low.ci, dtype=float)[None, :])
        S, N = low.S, low.N
        B = scenarios.B

        notes: List[str] = []
        warm = None
        stat_feas_real = None
        initial = problem.initial_assignment
        if initial is not None:
            stat_feas_real = _static_feasibility(low)
            warm, err = _warm_start_state(low, stat_feas_real, initial)
            if warm is None:
                notes.append(
                    f"warm start rejected ({err}); rebuilt from scratch")
        if warm is None:
            warm = (np.zeros(S, dtype=bool), np.zeros(S, dtype=np.int64),
                    np.zeros(S, dtype=np.int64), np.zeros(N), np.zeros(N))

        if S == 0 or N == 0:
            return self._degenerate_result(problem, low, scenarios, notes)
        ci_b, E_b, order_b = scenarios.materialize(low)
        # the pairwise-transmission mean CI, per branch, over REAL nodes
        # (the planner takes it explicitly so bucket padding can't skew it)
        ci_mean_b = np.asarray(ci_b, dtype=float).mean(axis=1)

        # -- shape bucketing: round (S, F, N, L, B) up to the configured
        # bucket boundaries and pad with masked-out phantom entries so one
        # compiled program serves every shape in the bucket; results are
        # sliced back to the real [B, :S] below.
        F = low.F
        L = low.comm.n_links if low.comm.kind == "sparse" else None
        shape = (B, S, F, N, L)
        plow, bucketed = low, False
        if cfg.bucket is not None:
            S_p, F_p, N_p, L_p, B_p = cfg.bucket.pad_dims(S, F, N, L, B)
            bucketed = (S_p, F_p, N_p, L_p, B_p) != (S, F, N, L, B)
            plow = pad_lowering(low, S_p, F_p, N_p, L_p)
            if B_p > B:
                # phantom branches replay branch 0; sliced away afterwards
                rep = np.repeat(ci_b[:1], B_p - B, axis=0)
                ci_b = np.concatenate([ci_b, rep], axis=0)
                ci_mean_b = np.concatenate(
                    [ci_mean_b, np.repeat(ci_mean_b[:1], B_p - B)])
                E_b = np.concatenate(
                    [E_b, np.repeat(E_b[:1], B_p - B, axis=0)], axis=0)
                order_b = np.concatenate(
                    [order_b, np.repeat(order_b[:1], B_p - B, axis=0)],
                    axis=0)
            if N_p > N:
                ci_b = np.concatenate(
                    [ci_b, np.zeros((ci_b.shape[0], N_p - N))], axis=1)
            if S_p > S or F_p > F:
                E_pad = np.zeros((E_b.shape[0], S_p, F_p))
                E_pad[:, :S, :F] = E_b
                E_b = E_pad
                # phantom services go LAST in every branch's greedy order
                order_b = np.concatenate([
                    order_b,
                    np.broadcast_to(
                        np.arange(S, S_p, dtype=order_b.dtype),
                        (order_b.shape[0], S_p - S))], axis=1)
            warm = (
                _pad1(warm[0], S_p), _pad1(warm[1], S_p),
                _pad1(warm[2], S_p), _pad1(warm[3], N_p),
                _pad1(warm[4], N_p))
        padded_shape = (ci_b.shape[0], plow.S, plow.F, plow.N,
                        plow.comm.n_links if plow.comm.kind == "sparse"
                        else None)

        P, A = lower_constraints(plow, constraints)
        # reuse the warm-start validation mask when the lowering wasn't
        # padded (the mask is O(S*F*N) — twice per tick would be real)
        stat_feas = stat_feas_real if (plow is low
                                       and stat_feas_real is not None) \
            else _static_feasibility(plow)

        sig = (plow.comm.kind,) + padded_shape
        # float64 keeps branch plans bit-comparable across batch sizes and
        # backends: a float32 downcast would drown the _EPS improvement
        # threshold in rounding noise and let the local search ping-pong
        # on near-ties.
        t0 = time.perf_counter()

        def put(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        f64, i64, b8 = torch.float64, torch.int64, torch.bool
        comm_dtypes = ((f64, b8) if plow.comm.kind == "dense"
                       else (i64, i64, i64, f64))
        out = plan_branches(
            plow.comm.kind, put(ci_b, f64), put(ci_mean_b, f64),
            put(E_b, f64), put(order_b, i64),
            put(warm[0], b8), put(warm[1], i64), put(warm[2], i64),
            put(warm[3], f64), put(warm[4], f64),
            tuple(put(a, d) for a, d in zip(plow.comm.planner_args(),
                                            comm_dtypes)),
            put(P, f64), put(A, f64), put(stat_feas, b8),
            put(plow.cpu_req, f64), put(plow.ram_req, f64),
            put(plow.cpu_cap, f64), put(plow.ram_cap, f64),
            put(plow.must, b8), put(plow.cost, f64),
            float(cfg.money_weight), float(cfg.pref_weight),
            float(cfg.emission_weight), float(cfg.green_penalty),
            cfg.local_search_rounds * max(1, S),
        )
        placed_b, fcur_b, ncur_b, skipped_b, infeas_b, fail_b, ls_b = (
            t.cpu().numpy()[:B] for t in (
                out.placed, out.fcur, out.ncur, out.skipped, out.infeas,
                out.fail_s, out.ls_steps))
        plan_time_s = time.perf_counter() - t0
        compiled = COMPILE_CACHE.record((dev.type,) + sig, plan_time_s)
        cc = COMPILE_CACHE
        stats = PlanStats(
            backend=plow.comm.kind, shape=shape, padded_shape=padded_shape,
            signature=sig, bucketed=bucketed, compiled=compiled,
            compile_time_s=plan_time_s if compiled else 0.0,
            plan_time_s=plan_time_s, cache_hits=cc.hits,
            cache_misses=cc.misses, device=str(dev),
            greedy_steps=plow.S,
            local_search_steps=tuple(int(v) for v in ls_b))
        # slice phantom services away; phantom branches already dropped
        placed_b = placed_b[:, :S]
        fcur_b = fcur_b[:, :S]
        ncur_b = ncur_b[:, :S]
        skipped_b = skipped_b[:, :S]
        ci_b = ci_b[:B, :N]
        E_b = E_b[:B, :S, :F]
        order_b = order_b[:B, :S]
        em_b = batched_lowered_emissions(
            low, placed_b, fcur_b, ncur_b, ci=ci_b,
            E=E_b if scenarios.E is not None else None)

        plans = plans_from_arrays(
            low, notes, placed_b, fcur_b, ncur_b, skipped_b, infeas_b,
            fail_b, order_b, em_b)
        feas_mask = np.array([p.feasible for p in plans])
        return PlanResult(
            problem=problem, plans=plans, placed=placed_b, fcur=fcur_b,
            ncur=ncur_b,
            emissions_g=np.where(feas_mask, em_b, np.inf),
            stats=stats)

    def _degenerate_result(self, problem, low, scenarios, notes) -> PlanResult:
        """Host-side path for shape-degenerate problems (no services or no
        nodes) — mirrors the greedy semantics with an empty candidate set:
        optional services are skipped in construction order, the first
        mandatory service makes the whole plan infeasible."""
        skipped: List[str] = []
        fail_sid: Optional[str] = None
        if low.N == 0:
            for s in map(int, low.order):
                if low.must[s]:
                    fail_sid = low.service_ids[s]
                    break
                skipped.append(low.service_ids[s])
        if fail_sid is not None:
            plan = DeploymentPlan(
                placements=(), feasible=False,
                notes=tuple(notes) + (f"no feasible node for {fail_sid}",))
        else:
            plan = DeploymentPlan(
                placements=(), skipped_services=tuple(skipped),
                total_emissions_g=0.0, feasible=True, notes=tuple(notes))
        B, S = scenarios.B, low.S
        return PlanResult(
            problem=problem, plans=[plan] * B,
            placed=np.zeros((B, S), dtype=bool),
            fcur=np.zeros((B, S), dtype=np.int64),
            ncur=np.zeros((B, S), dtype=np.int64),
            emissions_g=np.zeros(B) if plan.feasible
            else np.full(B, np.inf))


# ---------------------------------------------------------------------------
# Legacy reference implementation (object-walking), kept for equivalence
# testing and old-vs-new benchmarking.
# ---------------------------------------------------------------------------


def _constraint_maps(
    constraints: Sequence[Constraint],
) -> Tuple[Dict[Tuple[str, str, str], float], Dict[Tuple[str, str], float]]:
    avoid: Dict[Tuple[str, str, str], float] = {}
    affinity: Dict[Tuple[str, str], float] = {}
    for c in constraints:
        if isinstance(c, AvoidNode):
            avoid[(c.service, c.flavour, c.node)] = c.weight * c.memory_weight
        elif isinstance(c, Affinity):
            affinity[(c.service, c.other)] = c.weight * c.memory_weight
    return avoid, affinity


def _flavour_energy(
    svc: Service, fname: str, computation: Mapping[Tuple[str, str], float]
) -> float:
    v = computation.get((svc.component_id, fname))
    if v is not None:
        return v
    e = svc.flavour(fname).energy_kwh
    return e if e is not None else 0.0


def reference_objective(
    app: Application,
    infra: Infrastructure,
    computation: Mapping[Tuple[str, str], float],
    communication: Mapping[Tuple[str, str, str], float],
    constraints: Sequence[Constraint],
    config: SchedulerConfig,
    assign: Mapping[str, Tuple[str, str]],
) -> float:
    """The legacy object-walking objective J(assign) — ground truth for
    equivalence tests of the array-native scheduler."""
    cfg = config
    if not cfg.use_green_constraints:
        constraints = ()
    avoid, affinity = _constraint_maps(constraints)
    mean_ci = _mean_ci(infra)
    money = pref = emissions = green = 0.0
    for sid, (fname, nid) in assign.items():
        svc = app.service(sid)
        node = infra.node(nid)
        req = svc.flavour(fname).requirements
        money += node.cost_per_cpu_hour * req.cpu
        pref += svc.flavours_order.index(fname)
        if cfg.emission_weight:
            ci = node.carbon if node.carbon is not None else mean_ci
            emissions += _flavour_energy(svc, fname, computation) * ci
        g = avoid.get((sid, fname, nid))
        if g:
            green += g
    for (s, f, z), e in communication.items():
        if s in assign and z in assign and assign[s][0] == f:
            if assign[s][1] != assign[z][1]:
                if cfg.emission_weight:
                    emissions += e * mean_ci
                g = affinity.get((s, z))
                if g:
                    green += g
    return (cfg.money_weight * money
            + cfg.pref_weight * pref
            + cfg.emission_weight * emissions
            + cfg.green_penalty * green)


@dataclass
class ReferenceScheduler:
    """The original pure-Python scheduler: greedy construction with full
    objective recomputation per candidate + first-improvement local search.
    O(S^2*F*N*(S+L)) per greedy pass — retained as the correctness and
    performance reference for ``GreenScheduler``."""

    config: SchedulerConfig = field(default_factory=SchedulerConfig)

    def plan(
        self,
        app: Application,
        infra: Infrastructure,
        computation: Mapping[Tuple[str, str], float],
        communication: Mapping[Tuple[str, str, str], float],
        constraints: Sequence[Constraint] = (),
    ) -> DeploymentPlan:
        cfg = self.config
        if not cfg.use_green_constraints:
            constraints = ()
        nodes = list(infra.nodes)

        def objective(assign: Dict[str, Tuple[str, str]]) -> float:
            return reference_objective(
                app, infra, computation, communication, constraints, cfg,
                assign)

        def feasible(svc: Service, fname: str, nid: str,
                     load: Dict[str, Tuple[float, float]]) -> bool:
            node = infra.node(nid)
            if not subnet_compatible(svc, node):
                return False
            req = svc.flavour(fname).requirements
            used_cpu, used_ram = load.get(nid, (0.0, 0.0))
            if used_cpu + req.cpu > node.capabilities.cpu:
                return False
            if used_ram + req.ram_gb > node.capabilities.ram_gb:
                return False
            if node.capabilities.availability < req.availability:
                return False
            return True

        # --- greedy construction: heaviest services first, best (flavour,
        # node) by the objective; flavoursOrder breaks ties.
        order = sorted(
            app.services,
            key=lambda s: -max(
                (_flavour_energy(s, f.name, computation)
                 for f in s.flavours), default=0.0
            ),
        )
        assign: Dict[str, Tuple[str, str]] = {}
        load: Dict[str, Tuple[float, float]] = {}
        skipped: List[str] = []
        for svc in order:
            best: Optional[Tuple[float, int, int, str, str]] = None
            for pref_rank, fname in enumerate(svc.flavours_order):
                for k, node in enumerate(nodes):
                    if not feasible(svc, fname, node.node_id, load):
                        continue
                    trial = dict(assign)
                    trial[svc.component_id] = (fname, node.node_id)
                    cand = (objective(trial), pref_rank, k, fname,
                            node.node_id)
                    if best is None or cand < best:
                        best = cand
            if best is None:
                if svc.must_deploy:
                    return DeploymentPlan(
                        placements=(),
                        feasible=False,
                        notes=(f"no feasible node for {svc.component_id}",),
                    )
                skipped.append(svc.component_id)
                continue
            _, _, _, fname, nid = best
            assign[svc.component_id] = (fname, nid)
            req = svc.flavour(fname).requirements
            cpu, ram = load.get(nid, (0.0, 0.0))
            load[nid] = (cpu + req.cpu, ram + req.ram_gb)

        # --- first-improvement local search over single relocations.
        for _ in range(cfg.local_search_rounds):
            improved = False
            base = objective(assign)
            for sid in list(assign):
                svc = app.service(sid)
                cur = assign[sid]
                for fname in svc.flavours_order:
                    for node in nodes:
                        if (fname, node.node_id) == cur:
                            continue
                        load2 = _load_without(app, assign, sid)
                        if not feasible(svc, fname, node.node_id, load2):
                            continue
                        trial = dict(assign)
                        trial[sid] = (fname, node.node_id)
                        c = objective(trial)
                        if c + _EPS < base:
                            assign, base, improved = trial, c, True
            if not improved:
                break

        placements = tuple(
            Placement(sid, f, n) for sid, (f, n) in sorted(assign.items())
        )
        return DeploymentPlan(
            placements=placements,
            skipped_services=tuple(skipped),
            total_emissions_g=plan_emissions(
                app, infra, assign, computation, communication
            ),
            feasible=True,
        )


def _mean_ci(infra: Infrastructure) -> float:
    cis = [n.carbon for n in infra.nodes if n.carbon is not None]
    return sum(cis) / len(cis) if cis else 0.0


def _load_without(
    app: Application, assign: Dict[str, Tuple[str, str]], skip: str
) -> Dict[str, Tuple[float, float]]:
    load: Dict[str, Tuple[float, float]] = {}
    for sid, (fname, nid) in assign.items():
        if sid == skip:
            continue
        req = app.service(sid).flavour(fname).requirements
        cpu, ram = load.get(nid, (0.0, 0.0))
        load[nid] = (cpu + req.cpu, ram + req.ram_gb)
    return load


def plan_emissions(
    app: Application,
    infra: Infrastructure,
    assign: Dict[str, Tuple[str, str]],
    computation: Mapping[Tuple[str, str], float],
    communication: Mapping[Tuple[str, str, str], float],
) -> float:
    """True emissions (g) of a plan: computation + inter-node transmission."""
    mean_ci = _mean_ci(infra)
    total = 0.0
    for sid, (fname, nid) in assign.items():
        node = infra.node(nid)
        ci = node.carbon if node.carbon is not None else mean_ci
        e = computation.get((sid, fname))
        if e is None:
            fe = app.service(sid).flavour(fname).energy_kwh
            e = fe if fe is not None else 0.0
        total += e * ci
    for (s, f, z), e in communication.items():
        if s in assign and z in assign and assign[s][0] == f:
            if assign[s][1] != assign[z][1]:
                total += e * mean_ci
    return total


def plan_cost(app: Application, infra: Infrastructure,
              assign: Dict[str, Tuple[str, str]]) -> float:
    return sum(
        infra.node(nid).cost_per_cpu_hour
        * app.service(sid).flavour(fname).requirements.cpu
        for sid, (fname, nid) in assign.items()
    )
