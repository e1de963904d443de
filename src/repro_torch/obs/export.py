"""Exporters: Prometheus text exposition, JSONL event/span logs, and a
human-readable green-audit run report.

All output is deterministic for a given registry state — metric and
label rows are emitted in sorted order and floats use Python's
shortest-round-trip repr — so the Prometheus exposition is
golden-file-testable and the JSONL logs round-trip exactly.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .ledger import EmissionsLedger
from .registry import MetricsRegistry
from .trace import Tracer

__all__ = [
    "prometheus_text",
    "events_jsonl",
    "events_from_jsonl",
    "render_report",
    "billing_report",
    "render_billing",
    "serve_metrics",
    "MetricsServer",
]

_PREFIX = "repro_"


def _mangle(name: str) -> str:
    """``planner.compile.hits`` -> ``repro_planner_compile_hits``."""
    return _PREFIX + name.replace(".", "_").replace("-", "_")


def _fmt(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition format: backslash first,
    then double-quote and newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal
    in HELP text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _labels(key: Tuple, extra: Optional[List[Tuple[str, str]]] = None
            ) -> str:
    pairs = list(key) + (extra or [])
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (v0.0.4) of every metric in the
    registry.  Counters get the ``_total`` suffix; histograms expose
    cumulative ``_bucket{le=...}`` rows plus ``_sum`` / ``_count``."""
    lines: List[str] = []

    def type_line(name: str, kind: str, mangled: str) -> None:
        meta = registry.meta(name)
        if meta.get("help"):
            lines.append(f"# HELP {mangled} {_escape_help(meta['help'])}")
        lines.append(f"# TYPE {mangled} {kind}")

    by_name: Dict[str, List[Tuple[Tuple, float]]] = {}
    for (name, key), v in registry.counters().items():
        by_name.setdefault(name, []).append((key, v))
    for name in sorted(by_name):
        mangled = _mangle(name) + "_total"
        type_line(name, "counter", mangled)
        for key, v in sorted(by_name[name]):
            lines.append(f"{mangled}{_labels(key)} {_fmt(v)}")

    by_name = {}
    for (name, key), v in registry.gauges().items():
        by_name.setdefault(name, []).append((key, v))
    for name in sorted(by_name):
        mangled = _mangle(name)
        type_line(name, "gauge", mangled)
        for key, v in sorted(by_name[name]):
            lines.append(f"{mangled}{_labels(key)} {_fmt(v)}")

    hists: Dict[str, List[Tuple[Tuple, object]]] = {}
    for (name, key), h in registry.histograms().items():
        hists.setdefault(name, []).append((key, h))
    for name in sorted(hists):
        mangled = _mangle(name)
        type_line(name, "histogram", mangled)
        for key, h in sorted(hists[name], key=lambda kv: kv[0]):
            for le, count in h.cumulative():
                lines.append(
                    f"{mangled}_bucket{_labels(key, [('le', le)])} "
                    f"{count}")
            lines.append(f"{mangled}_sum{_labels(key)} {_fmt(h.sum)}")
            lines.append(f"{mangled}_count{_labels(key)} {h.count}")

    return "\n".join(lines) + ("\n" if lines else "")


def events_jsonl(registry: MetricsRegistry) -> str:
    """Registry events as JSONL, one event object per line."""
    return "".join(
        json.dumps(e, sort_keys=True, default=str) + "\n"
        for e in registry.events)


def events_from_jsonl(text: str) -> List[Dict[str, object]]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def billing_report(
    ledger: EmissionsLedger,
    apps: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-tenant carbon bill from a (possibly multi-tenant) ledger.

    Rolls the ledger's (service, flavour, node, zone) cells up to one row
    per tenant: gCO2 split into ``comp`` / ``comm`` / ``migration`` plus
    the ``total`` and the number of ledger ``ticks`` that contributed.
    Tenants are resolved from the entries' ``app`` tag (what the fleet
    runtime records); for untagged single-app ledgers an optional
    ``apps`` mapping ``tenant -> [service ids]`` attributes cells by
    service ownership instead (unmatched services land on ``"?"``).

    Because each fleet tick records one tagged entry per app, a fully
    tagged tenant's ``total`` is computed as the plain float sum of its
    own bit-exact per-tick totals (``LedgerEntry.emissions_g +
    migration_g``, each bit-equal to the tick's accounted emissions) in
    tick order — identical addends, identical order, so a tenant's bill
    equals its runtime-accounted emissions bitwise.  The
    comp/comm/migration *split* is a cell-level rollup (reporting-grade:
    the addends regroup across services, so ``comp + comm + migration``
    may differ from ``total`` in the last ulp).
    """
    svc_owner: Dict[str, str] = {}
    if apps:
        for tenant, sids in apps.items():
            for sid in sids:
                svc_owner[sid] = tenant
    out: Dict[str, Dict[str, float]] = {}
    seen_ticks: Dict[str, set] = {}
    exact: Dict[str, float] = {}
    mixed: set = set()
    for e in ledger.entries:
        for sid, _fl, _nid, _zone, kind, g in e.cells():
            tenant = e.app or svc_owner.get(sid, "?")
            row = out.setdefault(tenant, {
                "comp": 0.0, "comm": 0.0, "migration": 0.0,
                "total": 0.0, "ticks": 0.0})
            row[kind] = row.get(kind, 0.0) + g
            row["total"] += g
            if not e.app:
                mixed.add(tenant)
        if e.app:
            exact[e.app] = exact.get(e.app, 0.0) \
                + e.emissions_g + e.migration_g
            seen_ticks.setdefault(e.app, set()).add(e.t)
    for tenant, total in exact.items():
        if tenant in out and tenant not in mixed:
            out[tenant]["total"] = total
    for tenant, ticks in seen_ticks.items():
        if tenant in out:
            out[tenant]["ticks"] = float(len(ticks))
    return out


def render_billing(report: Dict[str, Dict[str, float]]) -> str:
    """Fixed-width text table of a :func:`billing_report` result, tenants
    sorted by descending total."""
    lines = [f"{'tenant':<16}{'comp_g':>12}{'comm_g':>12}"
             f"{'migration_g':>12}{'total_g':>12}{'ticks':>7}"]
    for tenant, row in sorted(report.items(),
                              key=lambda kv: -kv[1]["total"]):
        lines.append(
            f"{tenant:<16}{row.get('comp', 0.0):>12.3f}"
            f"{row.get('comm', 0.0):>12.3f}"
            f"{row.get('migration', 0.0):>12.3f}"
            f"{row['total']:>12.3f}{int(row.get('ticks', 0)):>7}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Long-lived Prometheus scrape endpoint over a registry.

    Serves the text exposition of :func:`prometheus_text` at ``/metrics``
    (and ``/``) from a daemon thread; the registry is read live on every
    scrape.  Stop with :meth:`close` (idempotent, also a context
    manager).

    Binding a FIXED port retries with exponential backoff while the
    address is in use (``retries`` attempts, starting at ``backoff_s``
    and doubling) — a restarting scraper endpoint routinely races the
    previous process's socket through TIME_WAIT/shutdown.  Any other
    bind error, or exhausting the budget, raises immediately.
    Ephemeral binding (``port=0``) never collides and never retries."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", retries: int = 5,
                 backoff_s: float = 0.05) -> None:
        import errno
        import time as _time
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading

        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = prometheus_text(reg).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # quiet by default
                pass

        self.registry = registry
        self._closed = False
        attempt = 0
        while True:
            try:
                self._httpd = ThreadingHTTPServer((host, port), Handler)
                break
            except OSError as exc:
                if (exc.errno != errno.EADDRINUSE or port == 0
                        or attempt >= retries):
                    raise
                _time.sleep(backoff_s * (2 ** attempt))
                attempt += 1
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0`` ephemeral binding)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        """Graceful shutdown: stop serving, release the socket, join the
        thread.  Safe to call more than once (context-manager exit after
        an explicit close is a no-op)."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(registry: MetricsRegistry, port: int = 0,
                  host: str = "127.0.0.1", retries: int = 5,
                  backoff_s: float = 0.05) -> MetricsServer:
    """Start a Prometheus scrape endpoint for ``registry``.

        server = serve_metrics(REGISTRY, port=9100)
        ... # scrape http://127.0.0.1:9100/metrics
        server.close()

    ``port=0`` binds an ephemeral port (read it back from
    ``server.port``).  A fixed port retries an in-use bind ``retries``
    times with exponential backoff starting at ``backoff_s`` (see
    :class:`MetricsServer`).  The server runs on a daemon thread and
    reads the registry live, so metrics written after startup appear on
    the next scrape."""
    return MetricsServer(registry, port=port, host=host, retries=retries,
                         backoff_s=backoff_s)


def render_report(
    result,                                # ContinuumResult (duck-typed)
    ledger: Optional[EmissionsLedger] = None,
    registry: Optional[MetricsRegistry] = None,
    tracer: Optional[Tracer] = None,
    top: int = 5,
) -> str:
    """Human-readable green audit of one continuum run.

    Works from the ``ContinuumResult`` alone; an attached ledger adds
    per-service / per-zone attribution, a registry adds fallback events
    and cache counters, a tracer adds stage-latency rollups.
    """
    ticks = list(result.ticks)
    T = len(ticks)
    lines: List[str] = []
    lines.append(f"== Green audit: {T} ticks ==")
    op = sum(r.emissions_g for r in ticks)
    mig = sum(r.migration_g for r in ticks)
    lines.append(
        f"emissions: {result.total_emissions_g:.3f} g "
        f"(operational {op:.3f} g + migration {mig:.3f} g)")
    lines.append(
        "decisions: "
        f"{sum(1 for r in ticks if r.replanned)} replans, "
        f"{sum(1 for r in ticks if r.switched)} switches, "
        f"{sum(r.migrations for r in ticks)} migrations, "
        f"{sum(r.restarts for r in ticks)} restarts, "
        f"{sum(1 for r in ticks if r.warm_start_rejected)} "
        "warm-start rejections")
    paths: Dict[str, int] = {}
    for r in ticks:
        paths[r.lowering_path] = paths.get(r.lowering_path, 0) + 1
    lines.append("lowering paths: " + ", ".join(
        f"{k}={v}" for k, v in sorted(paths.items())))
    compiles = sum(r.compiles for r in ticks)
    lines.append(f"planner compiles during run: {compiles}")

    if ledger is not None and len(ledger):
        lines.append("")
        lines.append("-- attribution (ledger) --")
        svc = sorted(ledger.by_service().items(),
                     key=lambda kv: -kv[1])[:top]
        lines.append("top services (g): " + ", ".join(
            f"{sid}={g:.3f}" for sid, g in svc))
        zones = sorted(ledger.by_zone().items(), key=lambda kv: -kv[1])
        lines.append("zones (g): " + ", ".join(
            f"{z or '?'}={g:.3f}" for z, g in zones))

    if registry is not None:
        fb = [e for e in registry.events
              if e.get("name") == "runtime.scanned_fallback"]
        if fb:
            lines.append("")
            lines.append("-- fallback events --")
            for e in fb:
                lines.append(
                    f"tick {e.get('tick')}: {e.get('reason')}"
                    + (f" ({e.get('detail')})" if e.get("detail") else ""))

    if tracer is not None and tracer.spans:
        lines.append("")
        lines.append("-- stage latency (span rollup) --")
        agg: Dict[str, Tuple[int, float]] = {}
        for s in tracer.spans:
            n, tot = agg.get(s.name, (0, 0.0))
            agg[s.name] = (n + 1, tot + s.duration_s)
        for name in sorted(agg):
            n, tot = agg[name]
            lines.append(
                f"{name}: n={n} total={tot * 1e3:.2f} ms "
                f"mean={tot / n * 1e3:.3f} ms")

    return "\n".join(lines) + "\n"
