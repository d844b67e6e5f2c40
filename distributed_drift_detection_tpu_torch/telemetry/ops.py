"""The live ops plane: a dependency-free HTTP server + crash flight
recorder for the serving daemon.

The port's own copy of the JAX package's ``telemetry/ops.py``.

Until now the live ``MetricsRegistry`` only ever reached disk at run end
(``metrics.write_exports``) — useless to an operator watching a daemon
*now*. :class:`OpsServer` is a threaded stdlib ``http.server`` exposing
three read-only endpoints (``--ops-port``; loopback by default, like the
ingress):

=============  ==========================================================
``/metrics``   the live registry in Prometheus text exposition format —
               **byte-identical** to what ``write_exports`` would put in
               the ``.prom`` file for the same registry state (both call
               ``MetricsRegistry.to_prometheus_text``; pinned by tests)
``/healthz``   the scriptable liveness contract: HTTP 200 while healthy
               (serving or draining), 503 while any SLO alert is firing
               or the ingress poisoned the batcher; the JSON body names
               the reasons
``/statusz``   one JSON snapshot of the daemon: run id, row/chunk
               accounting, queue depth, AOT/compile-cache state, live
               latency percentiles, last-verdict age, active alerts,
               and the serve-pipeline section (stage busy shares +
               dominant stage)
``/fleetz``    aggregators only (``fleetz_fn``; the tenant router and
               sweep scheduler): the merged fleet view — summed rows/s,
               max per-stage busy share, per-backend bottleneck. A
               plain daemon 404s here.
``/incidentz`` incident-plane daemons only (``incidentz_fn``): bundle
               count, open-alert count, and the latest incident
               manifest. A pre-incident daemon 404s here; the collector
               treats that as "no incident plane", never as down.
=============  ==========================================================

Handlers never *write* daemon state: the server is constructed with
three read-only callables and the GIL makes the scalar reads atomic;
the one mutable structure it renders — the registry — is snapshotted
defensively (a scrape racing a metric insertion retries, never crashes
the daemon or the scrape).

:class:`FlightRecorder` is the crash story: a bounded ring of the most
recent run-log events (installed as the ``EventLog`` tap), dumped to
``<run-log stem>.flightrec.jsonl`` only when the daemon dies — the last
N events an operator needs first, next to the artifact they came from,
without re-reading a multi-GB log. Each dumped line is a verbatim,
already-schema-valid event, so :func:`read_flight_record` is just
``read_events`` with torn-tail tolerance; a clean drain leaves **no**
dump (its absence is the clean-exit signal CI asserts).
:meth:`FlightRecorder.event_age_s` exposes the ring's staleness for
ad-hoc probes (the SLO ``stall_s`` rule itself reads the serve loop's
own liveness stamp, which also works without a run log).

No jax anywhere here; stdlib + the sibling telemetry modules only.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .events import read_events

FLIGHTREC_SUFFIX = ".flightrec.jsonl"

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class FlightRecorder:
    """Bounded ring buffer of recent events + the last-emit clock."""

    def __init__(self, capacity: int = 256, *, clock=time.monotonic):
        self._buf: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._last_mono = clock()

    def record(self, event: dict) -> None:
        """The ``EventLog.tap`` hook: remember one emitted event.

        ``alert`` events ride in the ring but do NOT advance the
        staleness clock: the SLO evaluator emits them from its own
        thread, so counting them as liveness would let a stall-shaped
        alert reset the very staleness that fired it (fire → emit →
        "fresh event" → resolve → re-fire, forever)."""
        with self._lock:
            self._buf.append(event)
            if event.get("type") != "alert":
                self._last_mono = self._clock()

    def event_age_s(self) -> float:
        """Monotonic seconds since the last recorded event — the SLO
        ``stall_s`` snapshot value."""
        with self._lock:
            return max(self._clock() - self._last_mono, 0.0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def dump(self, path: str) -> "str | None":
        """Write the ring to ``path`` (one event per line, verbatim);
        returns the path actually written, or ``None`` when the ring is
        empty (no file — an empty dump would read as evidence).

        Collision-safe for multi-dump runs: if ``path`` already exists
        (an earlier dump in the same process lifetime — the incident
        plane may dump the ring many times before a crash does), the
        write lands at ``<stem>-2{suffix}``, ``-3``, ... instead of
        overwriting evidence. The compound ``.flightrec.jsonl`` suffix is
        kept intact so the registry's sidecar skip still recognizes the
        renamed dump, and a first dump keeps the bare name — the crash
        path's "absence = clean exit" CI signal is untouched.
        Best-effort by contract: called from crash paths, it must not
        mask the original error."""
        with self._lock:
            events = list(self._buf)
        if not events:
            return None
        if path.endswith(FLIGHTREC_SUFFIX):
            base, ext = path[: -len(FLIGHTREC_SUFFIX)], FLIGHTREC_SUFFIX
        else:
            base, ext = os.path.splitext(path)
        k = 1
        while os.path.exists(path):
            k += 1
            path = f"{base}-{k}{ext}"
        try:
            with open(path, "x") as fh:
                for e in events:
                    fh.write(json.dumps(e) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            return None
        return path


def read_flight_record(path: str) -> list[dict]:
    """Parse a flight-recorder dump: schema-valid events, tolerating a
    torn trailing line (the dump may itself have died mid-write)."""
    return read_events(path, allow_partial_tail=True)


class _OpsHandler(BaseHTTPRequestHandler):
    server: "OpsServer"

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = self.server.metrics_text().encode()
                code, ctype = 200, PROM_CONTENT_TYPE
            elif path == "/healthz":
                code, payload = self.server.health_fn()
                body = (json.dumps(payload) + "\n").encode()
                ctype = "application/json"
            elif path in ("/statusz", "/"):
                body = (
                    json.dumps(self.server.status_fn(), indent=1) + "\n"
                ).encode()
                code, ctype = 200, "application/json"
            elif path == "/fleetz" and self.server.fleetz_fn is not None:
                # aggregators only (router/scheduler): the merged fleet
                # view; a plain daemon keeps 404-ing here
                body = (
                    json.dumps(self.server.fleetz_fn(), indent=1) + "\n"
                ).encode()
                code, ctype = 200, "application/json"
            elif path == "/incidentz" and self.server.incidentz_fn is not None:
                # incident-plane daemons only: bundle count + latest
                # manifest; a pre-incident daemon keeps 404-ing here (the
                # collector treats that as "no incident plane", not down)
                body = (
                    json.dumps(self.server.incidentz_fn(), indent=1) + "\n"
                ).encode()
                code, ctype = 200, "application/json"
            else:
                body = b'{"error": "not found"}\n'
                code, ctype = 404, "application/json"
        except Exception as e:  # a broken snapshot must not kill the thread
            body = (json.dumps({"error": repr(e)}) + "\n").encode()
            code, ctype = 500, "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass  # scraper already gone

    def log_message(self, *args) -> None:  # quiet: scrapes are not news
        pass


class OpsServer(ThreadingHTTPServer):
    """The ops listener (one daemon accept thread, one per request).

    ``metrics_fn`` → the exposition text (or ``None`` for an empty
    registry); ``health_fn`` → ``(http status, JSON payload)``;
    ``status_fn`` → the ``/statusz`` JSON dict. ``port=0`` requests an
    OS-assigned port (read :attr:`port` after construction).
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(
        self,
        host: str,
        port: int,
        *,
        metrics_fn,
        health_fn,
        status_fn,
        fleetz_fn=None,
        incidentz_fn=None,
    ):
        super().__init__((host, port), _OpsHandler)
        self._metrics_fn = metrics_fn
        self.health_fn = health_fn
        self.status_fn = status_fn
        # Optional merged fleet view (``/fleetz``): set by aggregators
        # (the tenant router, the sweep scheduler); None = 404, so a
        # plain daemon's ops surface is unchanged.
        self.fleetz_fn = fleetz_fn
        # Optional incident index (``/incidentz``): set by daemons with
        # an IncidentRecorder; None = 404 (pre-incident daemons).
        self.incidentz_fn = incidentz_fn
        self._thread: "threading.Thread | None" = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def metrics_text(self) -> str:
        """Render the registry (the exporters snapshot their dicts, so a
        scrape racing a first-use metric insertion is safe; any other
        failure becomes the handler's 500)."""
        text = self._metrics_fn()
        return text if text is not None else "\n"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.serve_forever, name="serve-ops", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
