"""Live operations plane: metrics registry + Prometheus exporter.

Port of ``commefficient_tpu/telemetry/live.py`` (``LiveRegistry`` :89
and its text rendering :144, ``LiveMetricsSink`` :184, ``LiveServer``
:289, the process-wide plane :333-376): the same series, labels and
text, so one record stream renders the same scrape in both packages.

Everything the post-hoc ledger records is derived per round anyway;
this module keeps a live, in-process view of it and serves the view
in Prometheus text exposition format so an operator can watch a
running trainer or job service instead of waiting for the run to end.

Three parts:

``LiveRegistry``   — thread-safe counters / gauges / rolling-window
                     summaries, labeled; renders the text exposition
                     under its lock (the exporter thread only ever
                     READS a snapshot — it can never mutate run
                     state).
``LiveMetricsSink``— an ordinary telemetry sink (``write``/``close``)
                     that derives registry updates from the records
                     flowing through the fan-out: round seconds,
                     clients/s, wire bytes, staleness, backlog, ε
                     spend, fairness probes, alarm fire counts, SLO
                     burn, critical-path buckets.
``LiveServer``     — a localhost-only stdlib ``http.server`` thread
                     with ``/metrics`` and ``/healthz``. Off by
                     default; armed by ``--live_port``.

This module is the package's only socket owner, and with
``--live_port`` unset nothing here is ever constructed: the telemetry
no-op fast path is untouched.
"""

from __future__ import annotations

import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: metric namespace prefix on every exported series
PREFIX = "commeff_"

#: lock-confinement declarations: every write to / iteration over
#: these attrs sits inside ``with <lock>:`` lexically
#: (tests/test_torch_slo_live.py scans for it). The
#: registry maps are mutated by round-loop threads and iterated by
#: the exporter thread; ``_PLANE`` is the process-wide singleton the
#: daemon and its jobs race to initialise.
_LOCK_MAP = {
    "_counters": "_lock",
    "_gauges": "_lock",
    "_summaries": "_lock",
    "_labels": "_lock",
    "_PLANE": "_PLANE_LOCK",
}

#: rolling samples kept per summary series (quantiles are over this
#: window; _sum/_count are whole-run)
SUMMARY_WINDOW = 256

#: quantiles exported per summary series
QUANTILES = (0.5, 0.95, 1.0)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _labels_key(labels) -> tuple:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _quantile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


class LiveRegistry:
    """Thread-safe metric store. Writers are the round loop (via
    ``LiveMetricsSink``); the only other toucher is the exporter
    thread, which takes the same lock and renders — strictly
    read-only by construction."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {labels_key: value}; labels_key -> labels dict
        self._counters = {}
        self._gauges = {}
        # name -> {labels_key: (deque window, sum, count)}
        self._summaries = {}
        self._labels = {}

    def counter_add(self, name: str, value, labels=None):
        key = _labels_key(labels)
        with self._lock:
            self._labels[key] = dict(labels or {})
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value, labels=None):
        key = _labels_key(labels)
        with self._lock:
            self._labels[key] = dict(labels or {})
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value, labels=None):
        """One sample into a rolling-window summary series."""
        key = _labels_key(labels)
        with self._lock:
            self._labels[key] = dict(labels or {})
            series = self._summaries.setdefault(name, {})
            window, total, count = series.get(
                key, (deque(maxlen=SUMMARY_WINDOW), 0.0, 0))
            window.append(float(value))
            series[key] = (window, total + float(value), count + 1)

    def snapshot(self) -> dict:
        """Deep-copied view for renderers/tests — mutating it cannot
        touch live state."""
        with self._lock:
            return {
                "counters": {n: {k: v for k, v in s.items()}
                             for n, s in self._counters.items()},
                "gauges": {n: {k: v for k, v in s.items()}
                           for n, s in self._gauges.items()},
                "summaries": {
                    n: {k: (list(w), t, c)
                        for k, (w, t, c) in s.items()}
                    for n, s in self._summaries.items()},
                "labels": dict(self._labels),
            }

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the whole
        registry."""
        snap = self.snapshot()
        labels_of = snap["labels"]
        out = []
        for name in sorted(snap["counters"]):
            out.append(f"# TYPE {name} counter")
            for key in sorted(snap["counters"][name]):
                out.append(f"{name}{_label_str(labels_of[key])} "
                           f"{snap['counters'][name][key]:g}")
        for name in sorted(snap["gauges"]):
            out.append(f"# TYPE {name} gauge")
            for key in sorted(snap["gauges"][name]):
                out.append(f"{name}{_label_str(labels_of[key])} "
                           f"{snap['gauges'][name][key]:g}")
        for name in sorted(snap["summaries"]):
            out.append(f"# TYPE {name} summary")
            for key in sorted(snap["summaries"][name]):
                window, total, count = snap["summaries"][name][key]
                svals = sorted(window)
                base = dict(labels_of[key])
                for q in QUANTILES:
                    ql = dict(base, quantile=f"{q:g}")
                    out.append(f"{name}{_label_str(ql)} "
                               f"{_quantile(svals, q):g}")
                out.append(f"{name}_sum{_label_str(base)} {total:g}")
                out.append(f"{name}_count{_label_str(base)} {count}")
        return "\n".join(out) + "\n"


#: keys copied from a round's probe dict straight to labeled gauges
_PROBE_GAUGES = (
    "async_staleness_mean", "async_staleness_max", "async_backlog",
    "async_buffer_occupancy", "job_active", "job_ran",
    "job_backlog_total", "job_backlog_max", "job_starved_rounds",
    "job_occupancy_min",
)


class LiveMetricsSink:
    """Telemetry sink deriving live metrics from the record stream.

    ``labels`` ride on every series this sink writes (``job``,
    ``process``, ``run`` — the run key fragment); one registry serves
    many sinks, so a daemon's J job sinks interleave into one labeled
    scrape."""

    def __init__(self, registry: LiveRegistry, labels=None):
        self.registry = registry
        self.labels = {k: str(v) for k, v in (labels or {}).items()}
        self._workers = None

    def write(self, rec):
        kind = rec.get("kind")
        if kind == "meta":
            plan = rec.get("plan") or {}
            w = plan.get("num_workers")
            if w:
                self._workers = int(w)
            return
        if kind == "summary":
            fired = rec.get("alarm_fired") or {}
            for rule, n in fired.items():
                # totals already streamed per round; summary is the
                # authoritative end-of-run count, so gauge it
                self.registry.gauge_set(
                    PREFIX + "alarms_run_total", float(n),
                    dict(self.labels, rule=str(rule)))
            return
        if kind != "round":
            return
        reg, labels = self.registry, self.labels
        reg.counter_add(PREFIX + "rounds_total", 1, labels)
        spans = rec.get("spans") or {}
        round_s = float(sum(spans.values())) if spans else 0.0
        if round_s > 0:
            reg.observe(PREFIX + "round_seconds", round_s, labels)
            if self._workers:
                reg.gauge_set(PREFIX + "clients_per_s",
                              self._workers / round_s, labels)
        for key, metric in (("uplink_bytes", "uplink_bytes_total"),
                            ("downlink_bytes",
                             "downlink_bytes_total")):
            v = rec.get(key)
            if v:
                reg.counter_add(PREFIX + metric, float(v), labels)
        probes = rec.get("probes") or {}
        for key in _PROBE_GAUGES:
            v = probes.get(key)
            if v is not None:
                reg.gauge_set(PREFIX + key, float(v), labels)
        for key, v in probes.items():
            if key.startswith("slo_burn_") and v is not None:
                reg.gauge_set(PREFIX + "slo_burn", float(v),
                              dict(labels,
                                   objective=key[len("slo_burn_"):]))
        eps = rec.get("dp_epsilon")
        if eps is not None:
            reg.gauge_set(PREFIX + "dp_epsilon", float(eps), labels)
        causal = rec.get("causal")
        if isinstance(causal, dict):
            # --causal_trace runs export the round's critical-path
            # bucket attribution (seconds per bucket)
            from commefficient_tpu_torch.telemetry.critpath import \
                critical_path
            crit = critical_path(causal, rec.get("device_time"))
            if crit is not None:
                for b, s in crit["buckets"].items():
                    if s > 0:
                        reg.gauge_set(PREFIX + "critpath_seconds",
                                      float(s),
                                      dict(labels, bucket=str(b)))
        for alarm in rec.get("alarms") or []:
            reg.counter_add(
                PREFIX + "alarms_total", 1,
                dict(labels, rule=str(alarm.get("rule"))))

    def close(self):
        pass  # the registry (and server) outlive any one run


class _Handler(BaseHTTPRequestHandler):
    registry = None  # bound per-server via subclassing

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.split("?")[0] == "/metrics":
            body = self.registry.render().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?")[0] == "/healthz":
            body, ctype = b"ok\n", "text/plain; charset=utf-8"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class LiveServer:
    """Localhost-only exporter thread. ``port=0`` binds an ephemeral
    port (tests); the bound port is ``self.port``."""

    def __init__(self, registry: LiveRegistry, port: int,
                 host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="live-metrics-exporter")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None


# --- process-wide plane ------------------------------------------------
# One registry + at most one server per process: a job service
# attaches J job sinks (distinct labels) to the same scrape endpoint.

_PLANE = {"registry": None, "server": None}
_PLANE_LOCK = threading.Lock()


def live_registry() -> LiveRegistry:
    with _PLANE_LOCK:
        if _PLANE["registry"] is None:
            _PLANE["registry"] = LiveRegistry()
        return _PLANE["registry"]


def ensure_server(port: int) -> LiveServer:
    """The process's exporter, started on first call. A later call
    with a different port keeps the first server (one scrape endpoint
    per process; the daemon and its jobs share it)."""
    reg = live_registry()
    with _PLANE_LOCK:
        if _PLANE["server"] is None:
            _PLANE["server"] = LiveServer(reg, port)
        return _PLANE["server"]


def shutdown_plane():
    """Stop the exporter and drop the registry (tests; a fresh plane
    per test keeps scrapes deterministic)."""
    with _PLANE_LOCK:
        server = _PLANE["server"]
        _PLANE["server"] = None
        _PLANE["registry"] = None
    if server is not None:
        server.close()


def attach_live_plane(telemetry, cfg, labels=None, runs_dir=""):
    """Arm the live plane on one run's telemetry per its Config.

    ``--live_port`` > 0 starts (or joins) the process exporter and
    attaches a :class:`LiveMetricsSink`; ``--flightrec_rounds`` > 0
    attaches a flight recorder. Returns ``(sink, recorder)`` — both
    None (and the telemetry fan-out untouched, preserving the
    disabled fast path) when neither knob is armed."""
    port = int(getattr(cfg, "live_port", 0) or 0)
    ring = int(getattr(cfg, "flightrec_rounds", 0) or 0)
    sink = None
    if port > 0:
        ensure_server(port)
        sink = LiveMetricsSink(live_registry(), labels)
        telemetry.add_sink(sink)
    recorder = None
    if ring > 0:
        from commefficient_tpu_torch.telemetry.flightrec import \
            FlightRecorder
        recorder = FlightRecorder(cfg, ring, labels=labels,
                                  runs_dir=runs_dir)
        telemetry.add_sink(recorder)
    return sink, recorder
