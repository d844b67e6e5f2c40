"""The HTTP ops plane — the part of the JAX package's ``telemetry/ops.py``
the sweep scheduler serves with ``--ops-port``: ``/metrics`` (the
Prometheus text), ``/healthz`` (200/503 with a JSON reason list),
``/statusz`` (a JSON snapshot) and ``/fleetz`` (an aggregator's merged
fleet view). The serving daemon's flight recorder and incident index wait
for ROADMAP A12 and A15. Pure stdlib."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


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
    ):
        super().__init__((host, port), _OpsHandler)
        self._metrics_fn = metrics_fn
        self.health_fn = health_fn
        self.status_fn = status_fn
        # Optional merged fleet view (``/fleetz``): set by aggregators
        # (the tenant router, the sweep scheduler); None = 404, so a
        # plain daemon's ops surface is unchanged.
        self.fleetz_fn = fleetz_fn
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
