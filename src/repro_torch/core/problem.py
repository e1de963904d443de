"""PlacementProblem: the one artefact the planner consumes.

The paper's adaptive loop (Fig. 1) replans every observation window, which
only scales when the planner's input is a cheap-to-rebuild, cheap-to-batch
value.  ``PlacementProblem`` is that value: an immutable bundle of the enriched app/infra lowering (Eq. 1/2 profiles, capacities,
masks — any :class:`~repro_torch.core.lowering.LoweredProblem`, dense or sparse
communication backend), the ranked green constraints, an optional
``ScenarioBatch`` of what-if forecast branches, and an optional warm-start
assignment.  Built once per tick via :meth:`PlacementProblem.
from_generator_output` and handed to the single scheduler entrypoint
``GreenScheduler.plan(problem) -> PlanResult``.

Its arrays stay numpy on the host; the planner moves them to its device
per call.  Being content-hashable (:attr:`fingerprint`), a problem is its
own cache key for lowering reuse across adaptive-loop iterations.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .lowering import LoweredProblem, ScenarioBatch, lower
from .types import Application, Constraint, DeploymentPlan, Infrastructure

Assignment = Mapping[str, Tuple[str, str]]
FrozenAssignment = Tuple[Tuple[str, Tuple[str, str]], ...]


def _round_up(x: int, grid: Tuple[int, ...], floor: int) -> int:
    """Smallest bucket boundary >= x: the next grid value when a grid is
    given (values beyond the grid stay exact — no padding), else the next
    power of two at or above ``floor``."""
    if x <= 0:
        return 0
    if grid:
        for g in grid:
            if g >= x:
                return g
        return x
    p = max(floor, 1)
    while p < x:
        p *= 2
    return p


@dataclass(frozen=True)
class BucketSpec:
    """Shape-bucket boundaries for the planner's compile cache.

Every distinct ``(B, S, F, N, L)`` problem shape is a distinct planner
    signature in the compile cache (the JAX package compiles one XLA
    program per signature; this port compiles nothing but keeps the same
    signatures and hit/miss accounting).  A ``BucketSpec`` rounds each
    dimension UP to a bucket boundary; the problem tensors are padded with masked-out phantom
    services/flavours/nodes/edges (zero energy, all-False feasibility
    masks, zero-weight COO edges) so every shape inside a bucket reuses
    ONE compiled program.  Phantom entries can never be placed, never
    carry objective weight, and never perturb tie-breaks (real cells keep
    their relative row-major order), so bucketed plans match the unpadded
    path decision-for-decision — bit-identical whenever the arithmetic is
    exact (see tests/test_bucketing.py's dyadic suite).

    Per-dimension boundaries are either an explicit ascending grid (tuned
    to a workload envelope; shapes beyond the last grid value fall back to
    exact — no padding) or, when the grid is empty, powers of two with a
    per-dimension floor.  ``L`` only keys sparse-comm programs (the dense
    backend's tensors carry no edge axis).
    """

    s: Tuple[int, ...] = ()     # services
    f: Tuple[int, ...] = ()     # flavour slots
    n: Tuple[int, ...] = ()     # nodes
    l: Tuple[int, ...] = ()     # COO comm edges (sparse backend only)
    b: Tuple[int, ...] = ()     # scenario branches
    a: Tuple[int, ...] = ()     # fleet apps (plan_many batching axis)
    s_floor: int = 8
    n_floor: int = 8
    l_floor: int = 8
    a_floor: int = 1

    def __post_init__(self) -> None:
        for name in ("s", "f", "n", "l", "b", "a"):
            grid = tuple(getattr(self, name))
            if any(g <= 0 for g in grid) or list(grid) != sorted(set(grid)):
                raise ValueError(
                    f"BucketSpec.{name} must be a strictly ascending "
                    f"positive grid, got {grid!r}")
            object.__setattr__(self, name, grid)

    @classmethod
    def grid(cls, s=(), f=(), n=(), l=(), b=(), a=()) -> "BucketSpec":
        """Explicit bucket boundaries per dimension (ascending)."""
        return cls(s=tuple(s), f=tuple(f), n=tuple(n), l=tuple(l),
                   b=tuple(b), a=tuple(a))

    @classmethod
    def from_observed(cls, shapes, max_buckets: int = 3) -> "BucketSpec":
        """Derive bucket boundaries from observed shape traffic.

        ``shapes`` is a sequence of observed ``(S, F, N, L, B)`` problem
        shapes (``L`` may be None for the dense comm backend).  Per
        dimension, up to ``max_buckets`` boundaries are chosen from the
        observed values — always including the maximum, so every observed
        shape fits a bucket — minimizing the total padding waste
        ``sum_over_observations(boundary(v) - v)``.  Dimensions with at
        most ``max_buckets`` distinct values get exact boundaries (zero
        waste); repeated values weight the objective, so the hot shapes
        land on a boundary.  This replaces hand-tuning ``BucketSpec.grid``
        after a warmup window (``RuntimeConfig.auto_bucket_after``).
        """
        rows = [tuple(sh) for sh in shapes]
        if not rows:
            raise ValueError("from_observed needs at least one shape")
        if any(len(r) != 5 for r in rows):
            raise ValueError(
                "shapes must be (S, F, N, L, B) tuples (L may be None)")
        cols = list(zip(*rows))

        def grid(values) -> Tuple[int, ...]:
            vals = [int(v) for v in values if v is not None and v > 0]
            if not vals:
                return ()
            return _waste_minimizing_boundaries(vals, max_buckets)

        return cls(s=grid(cols[0]), f=grid(cols[1]), n=grid(cols[2]),
                   l=grid(cols[3]), b=grid(cols[4]))

    def pad_dims(self, S: int, F: int, N: int, L: Optional[int],
                 B: int) -> Tuple[int, int, int, Optional[int], int]:
        """Bucketed ``(S, F, N, L, B)``.  ``L`` is None for the dense comm
        backend.  When phantom edges are needed (L padded) but S sits
        exactly on its boundary, S is bumped one bucket up: phantom edges
        must point at a phantom service so their affinity gather is
        provably zero."""
        S_pad = _round_up(S, self.s, self.s_floor)
        F_pad = _round_up(F, self.f, 1)
        N_pad = _round_up(N, self.n, self.n_floor)
        B_pad = _round_up(B, self.b, 1)
        L_pad = None
        if L is not None:
            L_pad = _round_up(L, self.l, self.l_floor)
            if L_pad > L and S_pad == S:
                S_pad = _round_up(S + 1, self.s, self.s_floor)
        return S_pad, F_pad, N_pad, L_pad, B_pad

    def pad_apps(self, A: int) -> int:
        """Bucketed app count for the fleet planner's ``[A, ...]`` batch
        axis (``plan_many``): the ``a`` grid, or powers of two at or
        above ``a_floor``.  Phantom apps are inert (nothing placeable)
        and their rows are dropped after planning."""
        return _round_up(A, self.a, self.a_floor)


def _waste_minimizing_boundaries(values, max_buckets: int
                                 ) -> Tuple[int, ...]:
    """Choose <= ``max_buckets`` boundaries from the observed values
    (always including the max) minimizing total round-up padding,
    count-weighted.  Exact DP over the distinct values: dp[c][i] = min
    waste covering the i smallest distinct values with c boundaries, the
    i-th being one."""
    from collections import Counter

    pairs = sorted(Counter(values).items())
    u = [v for v, _ in pairs]
    w = [c for _, c in pairs]
    k = len(u)
    if k <= max_buckets:
        return tuple(u)

    def seg(a: int, b: int) -> int:
        # values u[a..b] all round up to boundary u[b]
        return sum(w[x] * (u[b] - u[x]) for x in range(a, b + 1))

    INF = float("inf")
    dp = [[INF] * k for _ in range(max_buckets + 1)]
    choice = [[-1] * k for _ in range(max_buckets + 1)]
    for i in range(k):
        dp[1][i] = seg(0, i)
    for c in range(2, max_buckets + 1):
        for i in range(c - 1, k):
            best, arg = INF, -1
            for j in range(c - 2, i):
                v = dp[c - 1][j] + seg(j + 1, i)
                if v < best:
                    best, arg = v, j
            dp[c][i], choice[c][i] = best, arg
    c = min(range(1, max_buckets + 1), key=lambda cc: dp[cc][k - 1])
    bounds = []
    i = k - 1
    while c >= 1 and i >= 0:
        bounds.append(u[i])
        i = choice[c][i]
        c -= 1
    return tuple(sorted(bounds))


@dataclass(frozen=True)
class PlanStats:
    """Per-call planner telemetry carried on ``PlanResult.stats``.

    ``signature`` is the compile-cache key — the communication-backend
    kind plus the (possibly bucket-padded) ``(B, S, F, N, L)`` program
    shape.  ``compiled`` is True when this call built the program for
    the first time in this process (``compile_time_s`` then includes
    that first execution; the torch planner compiles nothing, so a miss
    marks only a first call).  The cumulative ``cache_hits``/``cache_misses``
    counters snapshot the process-wide planner compile cache after this
    call.
    """

    backend: str
    shape: Tuple[int, int, int, int, Optional[int]]        # (B, S, F, N, L)
    padded_shape: Tuple[int, int, int, int, Optional[int]]
    signature: Tuple
    bucketed: bool
    compiled: bool
    compile_time_s: float
    plan_time_s: float
    cache_hits: int
    cache_misses: int
    # where and how far the planner ran: the device, the greedy steps (one
    # per padded service) and each branch's local-search iterations
    device: str = ""
    greedy_steps: int = 0
    local_search_steps: Tuple[int, ...] = ()

    def metric_labels(self) -> Dict[str, str]:
        """Label set for registry metrics derived from this call."""
        return {"backend": self.backend,
                "bucketed": str(bool(self.bucketed)).lower()}

    def to_metrics(self) -> Dict[str, float]:
        """Flat ``metric name -> value`` view of this call (the numeric
        fields under their registry names) for exporters and per-tick
        recording."""
        return {
            "planner.plan_s": self.plan_time_s,
            "planner.compile_s": self.compile_time_s,
            "planner.compiled": float(self.compiled),
            "planner.batch": float(self.shape[0]),
        }


def _freeze_initial(initial) -> Optional[FrozenAssignment]:
    if initial is None:
        return None
    if isinstance(initial, tuple):
        return initial
    return tuple(sorted((sid, (str(f), str(n)))
                        for sid, (f, n) in dict(initial).items()))


@dataclass(frozen=True, eq=False)
class PlacementProblem:
    """One immutable placement problem: lowering + constraints
    (+ optional scenario batch and warm start)."""

    lowering: LoweredProblem
    constraints: Tuple[Constraint, ...] = ()
    scenarios: Optional[ScenarioBatch] = None
    initial: Optional[FrozenAssignment] = None

    def __post_init__(self) -> None:
        # Lazy columnar constraint views (repro_torch.learn.ConstraintSet — duck-
        # typed on ``entries`` to keep core import-free of learn) ride
        # through un-tupled so consumers can stay on the column fast path;
        # anything else is frozen into a tuple as before.
        c = self.constraints
        if not isinstance(c, tuple) and not hasattr(c, "entries"):
            object.__setattr__(self, "constraints", tuple(c))
        object.__setattr__(self, "initial", _freeze_initial(self.initial))

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        app: Optional[Application],
        infra: Optional[Infrastructure],
        computation: Mapping[Tuple[str, str], float],
        communication: Mapping[Tuple[str, str, str], float],
        constraints: Sequence[Constraint] = (),
        *,
        scenarios: Optional[ScenarioBatch] = None,
        initial: Optional[Assignment] = None,
        backend: str = "auto",
        lowered: Optional[LoweredProblem] = None,
    ) -> "PlacementProblem":
        """Lower an object-model problem (or wrap an existing lowering)."""
        low = lowered if lowered is not None else lower(
            app, infra, computation, communication, backend=backend)
        return cls(lowering=low, constraints=tuple(constraints),
                   scenarios=scenarios, initial=initial)

    @classmethod
    def from_generator_output(
        cls,
        out,
        *,
        scenarios: Optional[ScenarioBatch] = None,
        initial: Optional[Assignment] = None,
        backend: str = "auto",
        lowered: Optional[LoweredProblem] = None,
    ) -> "PlacementProblem":
        """One pipeline tick -> one problem (the Fig. 1 hand-off): the
        enriched app/infra and Eq. 1/2 profiles threaded through a
        :class:`~repro_torch.core.pipeline.GeneratorOutput` plus its ranked
        constraints."""
        return cls.build(
            out.app, out.infra, out.computation, out.communication,
            out.constraints, scenarios=scenarios, initial=initial,
            backend=backend, lowered=lowered)

    @staticmethod
    def cache_key(out) -> Tuple:
        """Hashable identity of the *lowering inputs* of a
        ``GeneratorOutput`` — what :meth:`from_generator_output` would
        lower.  Application/Infrastructure are frozen dataclasses, so value
        equality covers every lowered tensor (capacities, costs, subnets,
        flavour requirements, carbon) and a stale lowering can never be
        reused.  Constraints are deliberately excluded: they drift with KB
        memory decay every tick without invalidating the lowering."""
        return (
            out.app,
            out.infra,
            tuple(sorted(out.computation.items())),
            tuple(sorted(out.communication.items())),
        )

    # -- derived views ------------------------------------------------------

    @property
    def B(self) -> int:
        """Scenario-branch count priced by one ``plan`` call (1 when no
        scenario batch is attached)."""
        return 1 if self.scenarios is None else self.scenarios.B

    @property
    def initial_assignment(self) -> Optional[Dict[str, Tuple[str, str]]]:
        return None if self.initial is None else dict(self.initial)

    def with_scenarios(
        self, scenarios: Optional[ScenarioBatch]
    ) -> "PlacementProblem":
        return dataclasses.replace(self, scenarios=scenarios)

    def with_warm_start(
        self, initial: Optional[Assignment]
    ) -> "PlacementProblem":
        return dataclasses.replace(self, initial=_freeze_initial(initial))

    def with_constraints(
        self, constraints: Sequence[Constraint]
    ) -> "PlacementProblem":
        return dataclasses.replace(self, constraints=tuple(constraints))

    def with_lowering(self, lowering: LoweredProblem) -> "PlacementProblem":
        """This problem over a substituted lowering — e.g. a fault-masked
        availability vector (``repro_torch.core.lowering.mask_unavailable``).
        Constraints/scenarios/warm-start carry over untouched."""
        return dataclasses.replace(self, lowering=lowering)

    # -- identity -----------------------------------------------------------

    @property
    def fingerprint(self) -> str:
        """Content hash over every tensor and static field — the problem's
        identity for caches (computed lazily, memoised; problems are
        immutable so it never goes stale)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha256()
            _hash_dataclass(h, self.lowering)
            for c in self.constraints:
                h.update(repr(c).encode())
            if self.scenarios is not None:
                _hash_dataclass(h, self.scenarios)
            h.update(repr(self.initial).encode())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def __hash__(self) -> int:
        return hash(self.fingerprint)

    def __eq__(self, other) -> bool:
        return (isinstance(other, PlacementProblem)
                and self.fingerprint == other.fingerprint)


def _hash_dataclass(h, obj) -> None:
    h.update(type(obj).__name__.encode())
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        h.update(f.name.encode())
        if v is None:
            h.update(b"\x00")
        elif isinstance(v, np.ndarray):
            h.update(str(v.shape).encode())
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif dataclasses.is_dataclass(v):
            _hash_dataclass(h, v)
        else:
            h.update(repr(v).encode())


@dataclass
class PlanResult:
    """What ``GreenScheduler.plan(problem)`` returns: one deployment plan
    per scenario branch plus the tensor-form assignments (reusable for
    pricing without re-walking the plan objects)."""

    problem: PlacementProblem
    plans: List[DeploymentPlan]
    placed: np.ndarray       # [B, S] bool
    fcur: np.ndarray         # [B, S] flavour slot per service
    ncur: np.ndarray         # [B, S] node index per service
    emissions_g: np.ndarray  # [B] branch emissions (inf where infeasible)
    stats: Optional[PlanStats] = None  # compile-cache/timing telemetry

    @property
    def B(self) -> int:
        return len(self.plans)

    @property
    def plan(self) -> DeploymentPlan:
        """The single plan of an unbatched problem (B must be 1)."""
        if len(self.plans) != 1:
            raise ValueError(
                f"PlanResult holds {len(self.plans)} scenario-branch plans; "
                "use .plans (or index a branch) instead of .plan")
        return self.plans[0]

    def assignment(self, b: int = 0) -> Dict[str, Tuple[str, str]]:
        low = self.problem.lowering
        return {
            low.service_ids[s]: (
                low.flavour_names[s][int(self.fcur[b, s])],
                low.node_ids[int(self.ncur[b, s])])
            for s in range(low.S) if self.placed[b, s]
        }

    def arrays(self, b: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.placed[b], self.fcur[b], self.ncur[b]

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[DeploymentPlan]:
        return iter(self.plans)
