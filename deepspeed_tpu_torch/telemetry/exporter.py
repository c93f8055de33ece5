"""Stdlib-only HTTP exporter.

Serves the registry and span recorder to operators:

- ``GET /metrics``  → Prometheus text exposition (scrape target)
- ``GET /healthz``  → 200 ``{"status": "ok"}`` (liveness probe)
- ``GET /trace``    → Chrome-trace JSON of the recorded spans
- ``GET /flight``   → trigger a flight-recorder dump, return its JSON + path
  (404 unless ``telemetry.flight_recorder.enabled``)

Runs a daemon ``ThreadingHTTPServer``; ``port=0`` binds an ephemeral port
(the bound address is on ``.address`` after ``start()``).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepspeed_tpu_torch.utils.logging import logger


class TelemetryHTTPServer:

    def __init__(self, registry, spans=None, host="127.0.0.1", port=0):
        self._registry = registry
        self._spans = spans
        self._host = host
        self._port = port
        self._server = None
        self._thread = None

    @property
    def address(self):
        """(host, port) once started."""
        return self._server.server_address if self._server else None

    @property
    def url(self):
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self):
        registry, spans = self._registry, self._spans

        class Handler(BaseHTTPRequestHandler):

            def _send(self, code, body, content_type):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    self._send(200, registry.render_prometheus(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._send(200, json.dumps({"status": "ok"}), "application/json")
                elif path == "/trace" and spans is not None:
                    self._send(200, json.dumps(spans.chrome_trace()), "application/json")
                elif path == "/flight":
                    from deepspeed_tpu_torch import telemetry
                    recorder = telemetry.get_flight_recorder()
                    if recorder is None:
                        self._send(404, json.dumps(
                            {"error": "flight recorder not enabled "
                                      "(telemetry.flight_recorder.enabled)"}),
                                   "application/json")
                    else:
                        dump_path, doc = recorder.dump("http", return_doc=True)
                        self._send(200, json.dumps({"path": dump_path,
                                                    "dump": doc}, default=str),
                                   "application/json")
                else:
                    self._send(404, json.dumps({"error": f"no route {path}"}),
                               "application/json")

            def log_message(self, fmt, *args):
                ...  # scrapes must not spam the training log

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dstpu-telemetry-http", daemon=True)
        self._thread.start()
        logger.info(f"telemetry: serving /metrics /healthz /trace on {self.url}")
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None


def start_http_server(registry, spans=None, host="127.0.0.1", port=0):
    return TelemetryHTTPServer(registry, spans=spans, host=host, port=port).start()


def scrape_metrics(url, timeout=5.0):
    """GET ``url`` (a /metrics endpoint or a bare host:port) and return the
    parsed families — the ``dstpu_report --metrics-url`` backend."""
    import urllib.request

    from deepspeed_tpu_torch.telemetry.registry import parse_prometheus_text

    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        text = resp.read().decode()
    return parse_prometheus_text(text)
