"""Prometheus HTTP exporter — serve the registry on ``GET /metrics``.

Port of ``bevy_ggrs_tpu/telemetry/prometheus.py``.  A tiny stdlib
``ThreadingHTTPServer`` wrapper so any long-lived process can expose the
metrics registry to a Prometheus scraper with one call:

    from bevy_ggrs_tpu_torch.telemetry import start_http_exporter
    exporter = start_http_exporter(port=9464)
    ...
    exporter.close()

The handler renders :meth:`MetricsRegistry.render_prometheus` per scrape —
no caching, no extra thread work between scrapes.  ``GET /qos`` serves the
JSON lobby-health snapshot from :mod:`.qos`, refreshing the ``lobby_qos_score`` gauges as a
side effect so the next ``/metrics`` scrape carries them too.
``GET /trace`` serves a bounded Chrome-trace JSON snapshot of the process
timeline + flight recorder (:mod:`.trace`) — save it and drop it straight
into ui.perfetto.dev (``?n=`` caps the per-stream event count, default
``TRACE_DEFAULT_EVENTS``)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry, registry as _default_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
QOS_CONTENT_TYPE = "application/json; charset=utf-8"

# /trace response bound: events taken from the tail of EACH source stream
# (timeline + flight ring); a scraper polling a busy server must never pull
# an unbounded 64Ki-event body
TRACE_DEFAULT_EVENTS = 2048
TRACE_MAX_EVENTS = 16384


class MetricsExporter:
    """Background HTTP server exposing one registry (see module docstring)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 extra_json_routes: Optional[
                     Dict[str, Callable[[], dict]]] = None):
        reg = registry if registry is not None else _default_registry()
        # path -> zero-arg callable returning a JSON-able payload; checked
        # BEFORE the builtin paths so a caller can override them (the fleet
        # exporter replaces /qos with the fleet-wide worst-N view and adds
        # /fleet — fleet/observe.py).  Callables run on handler threads and
        # must be thread-safe.
        extra = dict(extra_json_routes or {})

        class Handler(BaseHTTPRequestHandler):
            """Per-scrape request handler (``/metrics`` + ``/`` index)."""

            def do_GET(self):  # noqa: N802 (stdlib naming)
                """Serve exposition text (``/metrics``) or QoS JSON (``/qos``)."""
                path, _, query = self.path.partition("?")
                if path in extra:
                    body = json.dumps(
                        extra[path](), default=repr
                    ).encode("utf-8")
                    ctype = QOS_CONTENT_TYPE
                elif path == "/qos":
                    from .qos import update_qos_gauges

                    body = json.dumps(update_qos_gauges(reg)).encode("utf-8")
                    ctype = QOS_CONTENT_TYPE
                elif path == "/trace":
                    from .trace import chrome_trace

                    n = TRACE_DEFAULT_EVENTS
                    for part in query.split("&"):
                        if part.startswith("n="):
                            try:
                                n = int(part[2:])
                            except ValueError:
                                pass
                    n = max(1, min(n, TRACE_MAX_EVENTS))
                    body = json.dumps(
                        chrome_trace(max_events=n), default=repr
                    ).encode("utf-8")
                    ctype = QOS_CONTENT_TYPE
                elif path in ("/metrics", "/"):
                    body = reg.render_prometheus().encode("utf-8")
                    ctype = CONTENT_TYPE
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                """Silence per-request stderr logging."""

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ggrs-metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0``)."""
        return self._server.server_address[1]

    def close(self) -> None:
        """Stop serving and release the socket."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def start_http_exporter(port: int = 0, host: str = "127.0.0.1",
                        registry: Optional[MetricsRegistry] = None,
                        extra_json_routes: Optional[
                            Dict[str, Callable[[], dict]]] = None,
                        ) -> MetricsExporter:
    """Start a :class:`MetricsExporter`; returns it (``.port``, ``.close()``)."""
    return MetricsExporter(port=port, host=host, registry=registry,
                           extra_json_routes=extra_json_routes)
