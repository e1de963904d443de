"""Lowering: Application/Infrastructure/constraints -> array tensors.

The object model in :mod:`repro_torch.core.types` mirrors the paper's Sect. 3.2
artefacts; this module lowers them once into an array-native substrate
(`LoweredProblem`) so the scheduler can score *all* candidate placements in
batched array ops instead of re-walking Python objects per candidate.

Tensor <-> paper-symbol map (S services, F flavour slots, N nodes):

  ``E[s, f]``      energyProfile(s, f)        — Eq. 1 computation profile
                   (kWh per observation window; falls back to the
                   Energy-Estimator-enriched ``Flavour.energy_kwh``).
  ``K[s, f, z]``   energyProfile(s, f, z)     — Eq. 2 communication profile
                   under the Eq. 13 transmission model
                   (kWh = requestVolume * requestSize * k), keyed by
                   (source service, source flavour, target service).
  ``ci[n]``        C(n)                       — carbon intensity of node n
                   (gCO2eq/kWh, Energy Mix Gatherer; missing values are
                   filled with the infrastructure mean as in the scheduler).
  ``P[s, f, n]``   avoidNode(d(s, f), n, w)   — Definition 1 soft-constraint
                   penalty w_i * mu_i.
  ``A[s, z]``      affinity(d(s, _), d(z, _)) — Definition 2 soft-constraint
                   penalty w_i * mu_i (flavour-independent, as consumed by
                   the scheduler objective).
  ``cost[n]``      monetary cost per CPU-hour of node n.
  ``cpu_req/ram_req/avail_req[s, f]``  flavour requirements (Sect. 3.2).
  ``cpu_cap/ram_cap/avail_cap[n]``     node capabilities.
  ``compat[s, n]`` subnet compatibility mask (Sect. 4.3).
  ``valid[s, f]``  True where flavour slot f is a real flavour of s
                   (slot order = ``flavours_order``, so the slot index *is*
                   the flavoursOrder preference rank).
  ``must[s]``      mandatory-deployment flag.
  ``order[s]``     greedy construction order (heaviest profile first,
                   stable — identical to the reference scheduler's).

Communication storage is a pluggable backend (``LoweredProblem.comm``):

* :class:`DenseLowering` — ``K``/``has_link`` as dense ``[S, F, S]``
  tensors (the original layout; pairwise scoring is one einsum).
* :class:`SparseCommLowering` — the same links as a COO edge list
  ``(src, fidx, dst, k)`` with segment-sum pairwise scoring.  Real
  communication graphs carry O(S) links, so this keeps memory *and* the
  move-grid pairwise work O(L) instead of O(S^2 F) — the dense layout's
  ``[S, F, S]`` tensors and its O(S^2 F N) move-grid einsum are the
  scaling cliff at S >= ~2k (and the scenario axis multiplies both by B).

``lower(..., backend="auto")`` picks the backend by the dense element
count ``S * F * S`` against :data:`SPARSE_AUTO_THRESHOLD`.

Everything is plain NumPy on the host; the scheduler moves the arrays to
its device as float64 / int64 / bool tensors per planning call.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import ClassVar, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .library import subnet_compatible
from .types import (
    Affinity,
    Application,
    AvoidNode,
    Constraint,
    Infrastructure,
)

# Dense-element count of K[S, F, S] above which ``backend="auto"`` switches
# to the COO edge-list storage.  The guard is not only the three [S, F, S]
# tensors (K, has_link, and the scheduler's derived W — ~32 MB each in f64
# at the threshold) but the O(S^2 * F * N) move-grid einsum they imply,
# which the scenario axis multiplies by B.
SPARSE_AUTO_THRESHOLD = 4_000_000


def _as_batched(placed, fcur, ncur):
    """Normalize assignment arrays to ``[B, S]``; returns (arrays, squeeze)."""
    placed = np.asarray(placed, dtype=bool)
    fcur = np.asarray(fcur)
    ncur = np.asarray(ncur)
    if placed.ndim == 1:
        return placed[None], fcur[None], ncur[None], True
    return placed, fcur, ncur, False


@dataclass
class DenseLowering:
    """Dense ``[S, F, S]`` communication storage (the original layout)."""

    K: np.ndarray          # [S, F, S] communication energy (kWh/window)
    has_link: np.ndarray   # [S, F, S] bool — entry present in the comm map

    kind: ClassVar[str] = "dense"

    @property
    def n_links(self) -> int:
        return int(self.has_link.sum())

    def planner_args(self) -> Tuple[np.ndarray, ...]:
        """Arrays handed to the planner for this storage kind."""
        return (self.K, self.has_link)

    def densify(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.K, self.has_link

    def pairwise_energy(self, placed, fcur, ncur):
        """Cross-node communication energy (kWh) of assignment(s).

        Accepts ``[S]`` arrays (returns a float) or ``[B, S]`` arrays
        (returns ``[B]``): links pay iff both endpoints are placed, the
        source runs the link's flavour, and the endpoints sit on
        different nodes — exactly the reference scheduler's rule.
        """
        placed, fcur, ncur, squeeze = _as_batched(placed, fcur, ncur)
        B, S = placed.shape
        if S == 0:
            out = np.zeros(B)
            return float(out[0]) if squeeze else out
        s_ix = np.arange(S)
        Ksel = self.K[s_ix[None, :, None], fcur[:, :, None],
                      s_ix[None, None, :]]
        linked = self.has_link[s_ix[None, :, None], fcur[:, :, None],
                               s_ix[None, None, :]]
        pay = (linked & placed[:, :, None] & placed[:, None, :]
               & (ncur[:, :, None] != ncur[:, None, :]))       # [B, S, S]
        out = (Ksel * pay).sum((1, 2))
        return float(out[0]) if squeeze else out


@dataclass
class SparseCommLowering:
    """COO edge-list communication storage with segment-sum scoring.

    One row per (source service, source flavour, target service) entry of
    the communication profile, sorted by ``(src, fidx, dst)`` so segment
    sums accumulate in a deterministic order.
    """

    S: int
    F: int
    src: np.ndarray        # [L] int — source service index
    fidx: np.ndarray       # [L] int — source flavour slot
    dst: np.ndarray        # [L] int — target service index
    k: np.ndarray          # [L] float — link energy (kWh/window)

    kind: ClassVar[str] = "sparse"

    @property
    def n_links(self) -> int:
        return int(self.k.size)

    def planner_args(self) -> Tuple[np.ndarray, ...]:
        return (self.src, self.fidx, self.dst, self.k)

    def densify(self) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize the dense ``(K, has_link)`` twin (debug/tests only —
        defeats the point at the scales this backend exists for)."""
        K = np.zeros((self.S, self.F, self.S))
        has_link = np.zeros((self.S, self.F, self.S), dtype=bool)
        K[self.src, self.fidx, self.dst] = self.k
        has_link[self.src, self.fidx, self.dst] = True
        return K, has_link

    def pairwise_energy(self, placed, fcur, ncur):
        placed, fcur, ncur, squeeze = _as_batched(placed, fcur, ncur)
        B = placed.shape[0]
        if self.k.size == 0 or placed.shape[1] == 0:
            out = np.zeros(B)
            return float(out[0]) if squeeze else out
        pay = (placed[:, self.src] & placed[:, self.dst]
               & (fcur[:, self.src] == self.fidx[None, :])
               & (ncur[:, self.src] != ncur[:, self.dst]))     # [B, L]
        out = (self.k[None, :] * pay).sum(1)
        return float(out[0]) if squeeze else out


@dataclass
class LoweredProblem:
    """Array-native form of one placement problem (constraints excluded —
    lower those separately with :func:`lower_constraints` so a cached
    lowering can be reused across adaptive-loop iterations)."""

    service_ids: Tuple[str, ...]
    node_ids: Tuple[str, ...]
    flavour_names: Tuple[Tuple[str, ...], ...]   # per service, order = rank

    # application-side tensors
    E: np.ndarray          # [S, F] computation energy (kWh/window)
    comm: object           # DenseLowering | SparseCommLowering
    cpu_req: np.ndarray    # [S, F]
    ram_req: np.ndarray    # [S, F]
    avail_req: np.ndarray  # [S, F]
    valid: np.ndarray      # [S, F] bool
    must: np.ndarray       # [S] bool
    order: np.ndarray      # [S] int — greedy construction order

    # infrastructure-side tensors
    ci: np.ndarray         # [N] carbon intensity, mean-filled
    mean_ci: float
    cost: np.ndarray       # [N]
    cpu_cap: np.ndarray    # [N]
    ram_cap: np.ndarray    # [N]
    avail_cap: np.ndarray  # [N]
    compat: np.ndarray     # [S, N] bool

    @property
    def S(self) -> int:
        return len(self.service_ids)

    @property
    def F(self) -> int:
        return self.E.shape[1] if self.E.ndim == 2 else 0

    @property
    def N(self) -> int:
        return len(self.node_ids)

    # Dense views of the communication profile, whatever the backend —
    # cheap passthrough for DenseLowering, an explicit materialization for
    # SparseCommLowering (debug/equivalence-test use only at scale).
    @property
    def K(self) -> np.ndarray:
        return self.comm.densify()[0]

    @property
    def has_link(self) -> np.ndarray:
        return self.comm.densify()[1]

    def service_index(self) -> Dict[str, int]:
        return {sid: i for i, sid in enumerate(self.service_ids)}

    def node_index(self) -> Dict[str, int]:
        return {nid: j for j, nid in enumerate(self.node_ids)}


def lower(
    app: Application,
    infra: Infrastructure,
    computation: Mapping[Tuple[str, str], float],
    communication: Mapping[Tuple[str, str, str], float],
    backend: str = "auto",
) -> LoweredProblem:
    """Lower the object-model problem into array tensors.

    ``backend`` selects the communication storage: ``"dense"``,
    ``"sparse"``, or ``"auto"`` (sparse when ``S * F * S`` exceeds
    :data:`SPARSE_AUTO_THRESHOLD`).

    Communication entries whose source/target is not an application service,
    or whose flavour is not in the source's ``flavours_order``, can never
    contribute to the objective (the reference scheduler requires both
    endpoints assigned and the source's assigned flavour to match) and are
    dropped.  Self-links are zeroed for the same reason.
    """
    services = app.services
    nodes = infra.nodes
    S, N = len(services), len(nodes)
    F = max((len(s.flavours_order) for s in services), default=0)
    F = max(F, 1)  # keep arrays 2-D even for flavourless services

    service_ids = tuple(s.component_id for s in services)
    node_ids = tuple(n.node_id for n in nodes)
    flavour_names = tuple(s.flavours_order for s in services)

    cpu_req = np.zeros((S, F))
    ram_req = np.zeros((S, F))
    avail_req = np.zeros((S, F))
    valid = np.zeros((S, F), dtype=bool)
    must = np.array([s.must_deploy for s in services], dtype=bool)

    for i, svc in enumerate(services):
        for f, fname in enumerate(svc.flavours_order):
            fl = svc.flavour(fname)
            cpu_req[i, f] = fl.requirements.cpu
            ram_req[i, f] = fl.requirements.ram_gb
            avail_req[i, f] = fl.requirements.availability
            valid[i, f] = True
    E, order = _profile_tensors(services, computation, F)
    comm = _build_comm(S, F, _comm_edges(services, communication), backend)

    ci, mean_ci = _carbon_tensors(nodes)
    cost = np.array([n.cost_per_cpu_hour for n in nodes], dtype=float)
    cpu_cap = np.array([n.capabilities.cpu for n in nodes], dtype=float)
    ram_cap = np.array([n.capabilities.ram_gb for n in nodes], dtype=float)
    avail_cap = np.array(
        [n.capabilities.availability for n in nodes], dtype=float)

    compat = np.zeros((S, N), dtype=bool)
    for i, svc in enumerate(services):
        for j, node in enumerate(nodes):
            compat[i, j] = subnet_compatible(svc, node)

    return LoweredProblem(
        service_ids=service_ids,
        node_ids=node_ids,
        flavour_names=flavour_names,
        E=E, comm=comm,
        cpu_req=cpu_req, ram_req=ram_req, avail_req=avail_req,
        valid=valid, must=must, order=order,
        ci=ci, mean_ci=mean_ci, cost=cost,
        cpu_cap=cpu_cap, ram_cap=ram_cap, avail_cap=avail_cap,
        compat=compat,
    )


def _build_comm(S: int, F: int, edges: Sequence[Tuple[int, int, int, float]],
                backend: str):
    if backend == "auto":
        backend = "sparse" if S * F * S > SPARSE_AUTO_THRESHOLD else "dense"
    if backend == "sparse":
        if edges:
            src, fidx, dst, k = (np.array(col) for col in zip(*edges))
        else:
            src = fidx = dst = np.zeros(0, dtype=np.int64)
            k = np.zeros(0)
        return SparseCommLowering(
            S=S, F=F, src=src.astype(np.int64), fidx=fidx.astype(np.int64),
            dst=dst.astype(np.int64), k=k.astype(float))
    if backend != "dense":
        raise ValueError(f"unknown lowering backend {backend!r}")
    K = np.zeros((S, F, S))
    has_link = np.zeros((S, F, S), dtype=bool)
    for i, f, j, e in edges:
        K[i, f, j] = e
        has_link[i, f, j] = True
    return DenseLowering(K=K, has_link=has_link)


def _comm_edges(
    services, communication: Mapping[Tuple[str, str, str], float],
) -> List[Tuple[int, int, int, float]]:
    """One filtering pass over the communication map -> sorted COO edges;
    sorted so both backends see the links in the same deterministic
    order.  Entries with unknown endpoints, unknown source flavours, or
    self-links can never contribute to the objective and are dropped."""
    sidx = {s.component_id: i for i, s in enumerate(services)}
    edges: List[Tuple[int, int, int, float]] = []
    for (s, fname, z), e in communication.items():
        i, j = sidx.get(s), sidx.get(z)
        if i is None or j is None or i == j:
            continue
        try:
            f = services[i].flavours_order.index(fname)
        except ValueError:
            continue
        edges.append((i, f, j, float(e)))
    edges.sort()
    return edges


def _profile_tensors(
    services, computation: Mapping[Tuple[str, str], float], F: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(E[S, F], order[S])`` — the per-tick drifting application tensors
    (shared by :func:`lower` and :func:`substitute_profiles` so the delta
    fast path is bit-identical to a full re-lowering)."""
    S = len(services)
    E = np.zeros((S, F))
    max_profile = np.zeros(S)  # greedy-order key: max energy over flavours
    for i, svc in enumerate(services):
        for f, fname in enumerate(svc.flavours_order):
            fl = svc.flavour(fname)
            e = computation.get((svc.component_id, fname))
            if e is None:
                e = fl.energy_kwh if fl.energy_kwh is not None else 0.0
            E[i, f] = e
        # the reference greedy keys on *all* flavours, not just ordered ones
        profiles = []
        for fl in svc.flavours:
            e = computation.get((svc.component_id, fl.name))
            if e is None:
                e = fl.energy_kwh if fl.energy_kwh is not None else 0.0
            profiles.append(e)
        max_profile[i] = max(profiles, default=0.0)
    # stable sort, heaviest first — matches sorted(key=-max_energy)
    order = np.argsort(-max_profile, kind="stable")
    return E, order


def _carbon_tensors(nodes) -> Tuple[np.ndarray, float]:
    """``(ci[N], mean_ci)`` — mean-filled carbon intensities."""
    cis = [n.carbon for n in nodes if n.carbon is not None]
    mean_ci = float(sum(cis) / len(cis)) if cis else 0.0
    ci = np.array(
        [n.carbon if n.carbon is not None else mean_ci for n in nodes],
        dtype=float,
    ) if len(nodes) else np.zeros(0)
    return ci, mean_ci


def substitute_profiles(
    low: LoweredProblem,
    app: Application,
    infra: Infrastructure,
    computation: Mapping[Tuple[str, str], float],
    communication: Optional[Mapping[Tuple[str, str, str], float]] = None,
) -> LoweredProblem:
    """Delta fast path: rebuild ONLY the per-tick drifting VALUE tensors —
    ``E``/``order`` (computation profiles), ``ci``/``mean_ci`` (carbon
    intensities), and optionally the communication energies ``K``/``k``
    (same edge structure, new values) — into an existing lowering.

    Every structural tensor (requirements, capacities, subnet/validity
    masks) is shared by reference with ``low``, so this is
    O(S*F + N + L) instead of the full O(S*(F + N) + S*N) object walk of
    :func:`lower` (the subnet-compatibility matrix alone is S*N Python
    calls).  The caller is responsible for structural identity: same
    services, flavours, requirements, nodes (up to their carbon values),
    subnets, and communication KEYS as the run that produced ``low`` —
    the pipeline's delta cache checks exactly that before calling here.
    The result is bit-identical to a full re-lowering of the same inputs
    (:func:`_profile_tensors` / :func:`_carbon_tensors` /
    :func:`_comm_edges` are shared with :func:`lower`).
    """
    E, order = _profile_tensors(app.services, computation, low.F)
    ci, mean_ci = _carbon_tensors(infra.nodes)
    fields = dict(E=E, order=order, ci=ci, mean_ci=mean_ci)
    if communication is not None:
        fields["comm"] = _build_comm(
            low.S, low.F, _comm_edges(app.services, communication),
            low.comm.kind)
    return replace(low, **fields)


def pad_lowering(
    low: LoweredProblem, S_pad: int, F_pad: int, N_pad: int,
    L_pad: Optional[int] = None,
) -> LoweredProblem:
    """Pad a lowering to bucket dimensions with masked-out phantom
    services/flavours/nodes/edges.

    Phantom entries are inert by construction, so the padded problem plans
    identically to the unpadded one (then slice the planner outputs back
    to the real ``[B, :S]``):

    * phantom services: zero energy, ``valid``/``must`` False, zero
      requirements — statically infeasible everywhere, optional, skipped
      by the greedy with no effect on loads; appended to the END of the
      construction ``order`` so real services keep their relative order;
    * phantom flavour slots: ``valid`` False — masked in every candidate
      grid;
    * phantom nodes: ``compat`` False for every service, zero capacity,
      zero cost/CI — never feasible, never loaded, and the pairwise mean
      CI stays the REAL mean (``mean_ci`` is threaded through unchanged;
      the planner takes the branch mean as an explicit argument rather
      than averaging the padded ``ci``);
    * phantom edges (sparse backend): zero weight, endpoints at the last
      (phantom) service index so the affinity gather ``A[src, dst]`` is
      provably zero — requires ``S_pad > S`` whenever ``L_pad > L``
      (``BucketSpec.pad_dims`` guarantees it).

    Real cells keep their row-major relative order inside every padded
    grid, so argmin tie-breaks are unchanged; with exact (e.g. dyadic)
    arithmetic the padded plan is bit-identical to the unpadded one.
    """
    S, F, N = low.S, low.F, low.N
    if (S_pad, F_pad, N_pad) == (S, F, N) and (
            L_pad is None or low.comm.kind != "sparse"
            or L_pad == low.comm.n_links):
        return low
    if S_pad < S or F_pad < F or N_pad < N:
        raise ValueError(
            f"pad_lowering cannot shrink: ({S}, {F}, {N}) -> "
            f"({S_pad}, {F_pad}, {N_pad})")

    def pad(a: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
        out = np.zeros(shape, dtype=a.dtype)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return out

    comm = low.comm
    if comm.kind == "dense":
        comm = DenseLowering(
            K=pad(comm.K, (S_pad, F_pad, S_pad)),
            has_link=pad(comm.has_link, (S_pad, F_pad, S_pad)))
    else:
        L = comm.n_links
        L_pad = L if L_pad is None else L_pad
        if L_pad < L:
            raise ValueError(f"pad_lowering cannot drop edges: {L} -> "
                             f"{L_pad}")
        if L_pad > L and S_pad <= S:
            raise ValueError(
                "phantom edges need a phantom service endpoint "
                f"(S_pad={S_pad} must exceed S={S} when L_pad={L_pad} > "
                f"L={L})")
        phantom = S_pad - 1  # unplaceable: zero affinity, zero pay
        comm = SparseCommLowering(
            S=S_pad, F=F_pad,
            src=np.concatenate([
                comm.src, np.full(L_pad - L, phantom, dtype=np.int64)]),
            fidx=np.concatenate([
                comm.fidx, np.zeros(L_pad - L, dtype=np.int64)]),
            dst=np.concatenate([
                comm.dst, np.full(L_pad - L, phantom, dtype=np.int64)]),
            k=np.concatenate([comm.k, np.zeros(L_pad - L)]))

    return replace(
        low,
        service_ids=low.service_ids + tuple(
            f"__pad_s{i}" for i in range(S, S_pad)),
        node_ids=low.node_ids + tuple(
            f"__pad_n{j}" for j in range(N, N_pad)),
        flavour_names=low.flavour_names + ((),) * (S_pad - S),
        E=pad(low.E, (S_pad, F_pad)),
        comm=comm,
        cpu_req=pad(low.cpu_req, (S_pad, F_pad)),
        ram_req=pad(low.ram_req, (S_pad, F_pad)),
        avail_req=pad(low.avail_req, (S_pad, F_pad)),
        valid=pad(low.valid, (S_pad, F_pad)),
        must=pad(low.must, (S_pad,)),
        order=np.concatenate([
            low.order, np.arange(S, S_pad, dtype=low.order.dtype)]),
        ci=pad(low.ci, (N_pad,)),
        cost=pad(low.cost, (N_pad,)),
        cpu_cap=pad(low.cpu_cap, (N_pad,)),
        ram_cap=pad(low.ram_cap, (N_pad,)),
        avail_cap=pad(low.avail_cap, (N_pad,)),
        compat=pad(low.compat, (S_pad, N_pad)),
    )


def mask_unavailable(
    low: LoweredProblem,
    alive: np.ndarray,
    derate: Optional[np.ndarray] = None,
) -> LoweredProblem:
    """Fault-mask a lowering: dead nodes are removed from the feasible
    set via the EXISTING availability path — ``avail_cap`` is forced
    below any requirement (requirements are non-negative, so ``-1.0``
    fails ``avail_cap >= avail_req`` for every flavour slot) and the
    static feasibility mask zeroes every (s, f, dead-node) cell.
    Optional ``derate`` scales per-node cpu/ram capacity (brownouts).
    Returns ``low`` unchanged when nothing is masked."""
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (low.N,):
        raise ValueError(
            f"alive mask must be [{low.N}], got {alive.shape}")
    repl = {}
    if not alive.all():
        repl["avail_cap"] = np.where(
            alive, np.asarray(low.avail_cap, dtype=float), -1.0)
    if derate is not None:
        d = np.asarray(derate, dtype=float)
        if d.shape != (low.N,):
            raise ValueError(
                f"derate must be [{low.N}], got {d.shape}")
        repl["cpu_cap"] = np.asarray(low.cpu_cap, dtype=float) * d
        repl["ram_cap"] = np.asarray(low.ram_cap, dtype=float) * d
    return replace(low, **repl) if repl else low


@dataclass
class ScenarioBatch:
    """B what-if branches over one :class:`LoweredProblem`.

    Each branch re-prices the same placement problem under a different
    forecast: ``ci[b, n]`` replaces the lowered carbon intensities and
    (optionally) ``E[b, s, f]`` replaces the computation profiles — the two
    inputs the adaptive loop's forecasts actually vary.  Everything else
    (requirements, capacities, constraint penalties) is shared, so the
    whole batch is priced by one planner call over a leading branch axis
    (``GreenScheduler.plan``).

    When ``E`` varies, the greedy construction order is recomputed per
    branch exactly as :func:`lower` does; this assumes ``flavours_order``
    covers every flavour (the default), since the scenario axis only
    carries ordered flavour slots.
    """

    ci: np.ndarray                 # [B, N]
    E: Optional[np.ndarray] = None  # [B, S, F]; None -> shared low.E

    @property
    def B(self) -> int:
        return self.ci.shape[0]

    def materialize(
        self, low: LoweredProblem
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense per-branch ``(ci[B,N], E[B,S,F], order[B,S])`` tensors."""
        ci = np.asarray(self.ci, dtype=float)
        if ci.ndim != 2 or ci.shape[1] != low.N:
            raise ValueError(f"scenario ci must be [B, {low.N}]")
        if self.E is None:
            E = np.broadcast_to(low.E, (self.B,) + low.E.shape)
            order = np.broadcast_to(low.order, (self.B, low.S))
            return ci, E, order
        E = np.asarray(self.E, dtype=float)
        if E.shape != (self.B,) + low.E.shape:
            raise ValueError(
                f"scenario E must be [B, {low.S}, {low.F}]")
        # per-branch greedy order, same key + stable tie-break as lower()
        max_profile = np.where(low.valid[None], E, -np.inf).max(axis=2)
        max_profile = np.where(np.isfinite(max_profile), max_profile, 0.0)
        order = np.argsort(-max_profile, axis=1, kind="stable")
        return ci, E, order


def lowered_emissions(
    low: LoweredProblem,
    placed: np.ndarray,
    fcur: np.ndarray,
    ncur: np.ndarray,
    ci: Optional[np.ndarray] = None,
    E: Optional[np.ndarray] = None,
) -> float:
    """True emissions (g) of a tensor-form assignment — the array twin of
    ``scheduler.plan_emissions`` (computation at the hosting node's CI +
    cross-node transmission at the mean CI), evaluated against an optional
    scenario ``ci`` / ``E`` override."""
    if not placed.any():
        return 0.0
    ci = low.ci if ci is None else np.asarray(ci, dtype=float)
    E = low.E if E is None else np.asarray(E, dtype=float)
    mean_ci = float(ci.mean()) if ci.size else 0.0
    sel_E = np.take_along_axis(E, fcur[:, None], axis=1)[:, 0]
    comp = float((placed * sel_E * ci[ncur]).sum())
    return comp + low.comm.pairwise_energy(placed, fcur, ncur) * mean_ci


def batched_lowered_emissions(
    low: LoweredProblem,
    placed: np.ndarray,   # [B, S] bool
    fcur: np.ndarray,     # [B, S]
    ncur: np.ndarray,     # [B, S]
    ci: np.ndarray,       # [B, N]
    E: Optional[np.ndarray] = None,  # [B, S, F]
) -> np.ndarray:
    """``[B]`` — :func:`lowered_emissions` of branch b's assignment under
    branch b's ci/E, as one broadcasted op (the per-branch Python loop
    dominates what-if wall time otherwise)."""
    B, S = placed.shape
    if S == 0 or not placed.any():
        return np.zeros(B)
    E = np.broadcast_to(low.E, (B,) + low.E.shape) if E is None \
        else np.asarray(E, dtype=float)
    Esel = np.take_along_axis(E, fcur[:, :, None], axis=2)[:, :, 0]
    cisel = np.take_along_axis(ci, ncur, axis=1)              # [B, S]
    comp = (placed * Esel * cisel).sum(axis=1)
    commE = low.comm.pairwise_energy(placed, fcur, ncur)      # [B]
    return comp + commE * ci.mean(axis=1)


def lower_constraints(
    low: LoweredProblem, constraints: Sequence[Constraint]
) -> Tuple[np.ndarray, np.ndarray]:
    """Lower soft green constraints to penalty tensors ``(P, A)``.

    ``P[s, f, n]`` — AvoidNode penalty w_i * mu_i; ``A[s, z]`` — Affinity
    penalty w_i * mu_i.  Later constraints with the same key overwrite
    earlier ones, matching the reference scheduler's dict construction.
    Constraints referencing unknown services/flavours/nodes are ignored
    (they could never fire in the reference objective either).
    """
    S, F, N = low.S, low.F, low.N
    P = np.zeros((S, F, N))
    A = np.zeros((S, S))
    sidx = low.service_index()
    nidx = low.node_index()
    # Lazy columnar sets (repro_torch.learn.ConstraintSet) expose (base, weight,
    # memory_weight) triples without cloning a Constraint per row — the
    # base objects carry the identity fields, the columns the penalties.
    entries = getattr(constraints, "entries", None)
    items = entries() if entries is not None else (
        (c, c.weight, c.memory_weight) for c in constraints)
    for c, w, mw in items:
        if isinstance(c, AvoidNode):
            i, j = sidx.get(c.service), nidx.get(c.node)
            if i is None or j is None:
                continue
            try:
                f = low.flavour_names[i].index(c.flavour)
            except ValueError:
                continue
            P[i, f, j] = w * mw
        elif isinstance(c, Affinity):
            i, j = sidx.get(c.service), sidx.get(c.other)
            if i is None or j is None:
                continue
            A[i, j] = w * mw
    return P, A
