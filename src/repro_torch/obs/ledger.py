"""Per-service / per-node / per-zone emissions ledger.

``TickRecord.emissions_g`` is a single float per tick — enough to gate
parity, useless for answering "which service / node / zone is burning
the carbon?".  The ledger attributes every tick's operational emissions
and migration charges down to (service, flavour, node, zone) cells
**without breaking bit-parity with the totals**:

* computation cells are the literal ``placed * sel_E * ci[ncur]``
  product array from :func:`repro_torch.core.lowering.lowered_emissions` —
  summing them with the same ``.sum()`` reduction over the same buffer
  reproduces the record's computation term bit-for-bit;
* communication cells are stored in **energy units** (kWh) — the
  per-link / per-pair ``K * pay`` products of
  ``comm.pairwise_energy`` — and scaled by ``mean_ci`` only *after*
  summing, because ``sum(k_i * mean_ci) != sum(k_i) * mean_ci`` in
  floating point while ``lowered_emissions`` computes the latter;
* migration charges keep the loop's exact arithmetic
  ``migration_g * moved + restart_g * flapped`` for the tick total,
  alongside one charge cell per moved/flapped service (per-cell sums
  are exactly decomposable for dyadic fees — the defaults 2.0 / 0.5 —
  since repeated addition of a dyadic float is exact at these counts).

So for every tick: ``entry.emissions_g == TickRecord.emissions_g`` and
``entry.migration_g == TickRecord.migration_g``, bitwise, on both the
eager and the fused-scan path.  The ``by_*`` aggregations are plain
float sums across ticks (reporting-grade, no bit guarantee — the bit
guarantee is per-tick).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LedgerEntry", "EmissionsLedger", "MigrationCharge"]

# (service_id, flavour_name, node_id, grams) — one charged move/restart
MigrationCharge = Tuple[str, str, str, float]


def _flavour_name(flavour_names: Tuple[Tuple[str, ...], ...],
                  s: int, f: int) -> str:
    names = flavour_names[s] if s < len(flavour_names) else ()
    return names[f] if 0 <= f < len(names) else f"f{f}"


@dataclass
class LedgerEntry:
    """One tick's fully attributed emissions.

    ``comp_cells[s]`` is in grams; ``comm_cells`` is in kWh (dense:
    ``[S, S]`` pair grid, sparse: ``[L]`` per-link) and converts to
    grams via ``* mean_ci`` — deferred to the reductions so the tick
    total stays bit-equal to ``lowered_emissions``.
    """

    t: int
    service_ids: Tuple[str, ...]
    node_ids: Tuple[str, ...]
    flavour_names: Tuple[Tuple[str, ...], ...]
    zones: Tuple[str, ...]              # per node, parallel to node_ids
    placed: np.ndarray                  # [S] bool
    fcur: np.ndarray                    # [S] int
    ncur: np.ndarray                    # [S] int
    comp_cells: np.ndarray              # [S] grams
    comm_kind: str                      # "dense" | "sparse"
    comm_cells: np.ndarray              # [S, S] or [L], kWh
    comm_src: Optional[np.ndarray]      # [L] source index (sparse only)
    mean_ci: float
    moved: int = 0
    flapped: int = 0
    migration_fee_g: float = 0.0
    restart_fee_g: float = 0.0
    mig_cells: Tuple[MigrationCharge, ...] = ()
    # Multi-tenant attribution: which application/tenant this tick's
    # entry belongs to ("" for single-app runs).  The fleet runtime
    # records one entry per app per tick into a SHARED ledger, and
    # ``billing_report`` groups on this tag.
    app: str = ""

    # -- bit-exact tick totals ----------------------------------------------

    @property
    def emissions_g(self) -> float:
        """Operational grams — bit-equal to ``lowered_emissions`` on the
        same assignment (same buffers, same reduction order)."""
        if not self.placed.any():
            return 0.0
        comp = float(self.comp_cells.sum())
        return comp + float(self.comm_cells.sum()) * self.mean_ci

    @property
    def migration_g(self) -> float:
        """Migration grams — the loop's exact charge arithmetic."""
        return (self.migration_fee_g * self.moved
                + self.restart_fee_g * self.flapped)

    # -- attribution views --------------------------------------------------

    def comm_g_by_source(self) -> np.ndarray:
        """``[S]`` communication grams attributed to the link source."""
        S = len(self.service_ids)
        if self.comm_kind == "dense":
            per_src = self.comm_cells.sum(axis=1)
        else:
            per_src = np.bincount(
                self.comm_src, weights=self.comm_cells, minlength=S) \
                if self.comm_cells.size else np.zeros(S)
        return per_src * self.mean_ci

    def service_g(self) -> Dict[str, float]:
        """Grams per service: computation + sourced communication +
        this tick's migration charges."""
        comm_g = self.comm_g_by_source()
        out = {}
        for s, sid in enumerate(self.service_ids):
            g = float(self.comp_cells[s]) + float(comm_g[s])
            if g or self.placed[s]:
                out[sid] = g
        for sid, _fl, _nid, g in self.mig_cells:
            out[sid] = out.get(sid, 0.0) + g
        return out

    def cells(self) -> Iterator[Tuple[str, str, str, str, str, float]]:
        """``(service, flavour, node, zone, kind, grams)`` rows:
        one ``comp`` row per placed service, one ``comm`` row per
        service with sourced traffic, one ``migration`` row per
        charge."""
        comm_g = self.comm_g_by_source()
        nidx = {nid: j for j, nid in enumerate(self.node_ids)}
        for s, sid in enumerate(self.service_ids):
            if not self.placed[s]:
                continue
            n = int(self.ncur[s])
            fl = _flavour_name(self.flavour_names, s, int(self.fcur[s]))
            nid = self.node_ids[n]
            zone = self.zones[n] if n < len(self.zones) else ""
            yield (sid, fl, nid, zone, "comp", float(self.comp_cells[s]))
            if comm_g[s]:
                yield (sid, fl, nid, zone, "comm", float(comm_g[s]))
        for sid, fl, nid, g in self.mig_cells:
            j = nidx.get(nid)
            zone = self.zones[j] if j is not None and j < len(self.zones) \
                else ""
            yield (sid, fl, nid, zone, "migration", g)


class EmissionsLedger:
    """Append-only sequence of :class:`LedgerEntry`, one per tick."""

    def __init__(self) -> None:
        self.entries: List[LedgerEntry] = []

    def __len__(self) -> int:
        return len(self.entries)

    def record(
        self,
        t: int,
        low,                              # LoweredProblem
        placed: Optional[np.ndarray],
        fcur: Optional[np.ndarray],
        ncur: Optional[np.ndarray],
        ci: Optional[np.ndarray],
        zones: Sequence[str] = (),
        moved: int = 0,
        flapped: int = 0,
        migration_fee_g: float = 0.0,
        restart_fee_g: float = 0.0,
        mig_cells: Tuple[MigrationCharge, ...] = (),
        app: str = "",
    ) -> LedgerEntry:
        """Attribute one tick.  ``placed``/``fcur``/``ncur`` are the
        assignment arrays the loop's accounting used (``None`` for a
        tick with no deployment); ``ci`` the carbon intensities the
        emissions were charged at; ``app`` the tenant tag for
        multi-tenant (fleet) ledgers."""
        S = low.S
        if placed is None:
            placed = np.zeros(S, dtype=bool)
            fcur = np.zeros(S, dtype=np.int64)
            ncur = np.zeros(S, dtype=np.int64)
        placed = np.asarray(placed, dtype=bool)
        fcur = np.asarray(fcur)
        ncur = np.asarray(ncur)
        ci_arr = np.asarray(ci, dtype=float) if ci is not None \
            else np.zeros(low.N)
        mean_ci = float(ci_arr.mean()) if ci_arr.size else 0.0

        if S and placed.any():
            # The exact product array lowered_emissions reduces for its
            # computation term; keeping the buffer keeps the bit-parity.
            sel_E = np.take_along_axis(low.E, fcur[:, None], axis=1)[:, 0]
            comp_cells = placed * sel_E * ci_arr[ncur]
            comm_kind, comm_cells, comm_src = _comm_cells(
                low.comm, placed, fcur, ncur)
        else:
            comp_cells = np.zeros(S)
            comm_kind = getattr(low.comm, "kind", "dense")
            comm_cells = np.zeros((S, S)) if comm_kind == "dense" \
                else np.zeros(0)
            comm_src = None if comm_kind == "dense" \
                else np.zeros(0, dtype=np.int64)

        entry = LedgerEntry(
            t=t,
            service_ids=low.service_ids,
            node_ids=low.node_ids,
            flavour_names=low.flavour_names,
            zones=tuple(zones),
            placed=placed, fcur=fcur, ncur=ncur,
            comp_cells=comp_cells,
            comm_kind=comm_kind, comm_cells=comm_cells, comm_src=comm_src,
            mean_ci=mean_ci,
            moved=int(moved), flapped=int(flapped),
            migration_fee_g=float(migration_fee_g),
            restart_fee_g=float(restart_fee_g),
            mig_cells=tuple(mig_cells),
            app=str(app),
        )
        self.entries.append(entry)
        return entry

    # -- cross-tick aggregation (reporting-grade float sums) ----------------

    def totals(self) -> Tuple[float, float]:
        """(operational grams, migration grams) over all ticks."""
        return (sum(e.emissions_g for e in self.entries),
                sum(e.migration_g for e in self.entries))

    def by_service(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            for sid, g in e.service_g().items():
                out[sid] = out.get(sid, 0.0) + g
        return out

    def by_node(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            for _sid, _fl, nid, _zone, _kind, g in e.cells():
                out[nid] = out.get(nid, 0.0) + g
        return out

    def by_zone(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            for _sid, _fl, _nid, zone, _kind, g in e.cells():
                out[zone] = out.get(zone, 0.0) + g
        return out


def _comm_cells(comm, placed: np.ndarray, fcur: np.ndarray,
                ncur: np.ndarray):
    """The per-pair / per-link ``K * pay`` product array (kWh) that
    ``comm.pairwise_energy`` reduces — same masks, same buffers, so
    ``cells.sum()`` is bit-equal to the scalar it returns."""
    if comm.kind == "dense":
        S = placed.shape[0]
        s_ix = np.arange(S)
        p_b, f_b, n_b = placed[None], fcur[None], ncur[None]
        Ksel = comm.K[s_ix[None, :, None], f_b[:, :, None],
                      s_ix[None, None, :]]
        linked = comm.has_link[s_ix[None, :, None], f_b[:, :, None],
                               s_ix[None, None, :]]
        pay = (linked & p_b[:, :, None] & p_b[:, None, :]
               & (n_b[:, :, None] != n_b[:, None, :]))
        return "dense", (Ksel * pay)[0], None
    if comm.k.size == 0 or placed.shape[0] == 0:
        return "sparse", np.zeros(0), np.zeros(0, dtype=np.int64)
    pay = (placed[None, comm.src] & placed[None, comm.dst]
           & (fcur[None, comm.src] == comm.fidx[None, :])
           & (ncur[None, comm.src] != ncur[None, comm.dst]))
    return "sparse", (comm.k[None, :] * pay)[0], comm.src
