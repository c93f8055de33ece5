"""Unified telemetry: metrics registry + span recorder + HTTP exporter.

One process-wide layer that every subsystem feeds (training engine step
metrics, per-collective latency/bytes, inference batch/token occupancy) and
that an operator can scrape (``/metrics``), tail (JSONL event stream) or load
into a trace viewer (Chrome-trace export).

Hot-path contract: when telemetry is disabled (the default) instrumented call
sites perform exactly one boolean check (``telemetry.state.active``) and
nothing else — no registry lookups, no allocations. The registry counts its
own API calls so tests can enforce this.

Port of ``deepspeed_tpu/telemetry/__init__.py``, with the metric time-series
store (``timeseries.py``) and the SLO engine (``slo.py``), which a session
builds from ``timeseries``/``slo`` and stops at close, and the fleet trace
collector (``collector.py``).

Usage::

    from deepspeed_tpu_torch import telemetry
    session = telemetry.configure(TelemetryConfig(enabled=True, ...))
    telemetry.get_registry().counter('my_total').inc()  # catalog new names!
    session.close()
"""

import threading

from deepspeed_tpu_torch.telemetry import compile_watch as compile_watch
from deepspeed_tpu_torch.telemetry.collector import TraceCollector
from deepspeed_tpu_torch.telemetry.config import (FlightRecorderConfig, SLOConfig,
                                                  SLOObjectiveConfig, TelemetryConfig,
                                                  TelemetryHTTPConfig, TimeSeriesConfig)
from deepspeed_tpu_torch.telemetry.exporter import (TelemetryHTTPServer, scrape_metrics,
                                                    start_http_server)
from deepspeed_tpu_torch.telemetry.flight_recorder import FlightRecorder
from deepspeed_tpu_torch.telemetry.registry import (Counter, Gauge, Histogram, MetricsRegistry,
                                                    parse_prometheus_text)
from deepspeed_tpu_torch.telemetry.slo import SLOEngine
from deepspeed_tpu_torch.telemetry.spans import (Span, SpanRecorder, TracingTimers,
                                                 current_trace, new_span_id, new_trace_id,
                                                 now_us, trace_context)
from deepspeed_tpu_torch.telemetry.timeseries import TimeSeriesStore
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "TelemetryConfig", "TelemetryHTTPConfig", "FlightRecorderConfig", "MetricsRegistry",
    "TimeSeriesConfig", "SLOConfig", "SLOObjectiveConfig", "TimeSeriesStore",
    "SLOEngine", "TraceCollector",
    "Counter", "Gauge", "Histogram", "SpanRecorder", "Span", "TracingTimers",
    "TelemetryHTTPServer", "TelemetrySession", "FlightRecorder", "configure",
    "shutdown", "get_registry", "get_span_recorder", "get_flight_recorder",
    "get_timeseries", "get_slo_engine",
    "is_active", "record_comm_op", "wrap_timers", "start_http_server", "scrape_metrics",
    "parse_prometheus_text", "state", "now_us", "new_trace_id", "new_span_id",
    "trace_context", "current_trace", "compile_watch",
]

# comm-op latencies live well under the default buckets' top decades; bytes
# need their own scale
_COMM_BYTES_BUCKETS = (1024.0, 16384.0, 131072.0, 1048576.0, 8388608.0,
                       67108864.0, 536870912.0, 4294967296.0)


class _TelemetryState:
    """The one boolean the hot paths check, plus the live sinks behind it."""

    def __init__(self):
        self.active = False
        self.registry = None
        self.spans = None
        self.session = None
        self.flight_recorder = None
        self.timeseries = None
        self.slo = None
        self._lock = threading.RLock()
        self._comm_metrics = {}


state = _TelemetryState()


def get_registry():
    """The process-wide registry (created on first use; exists independently
    of whether telemetry is active so tests can count calls while disabled)."""
    with state._lock:
        if state.registry is None:
            state.registry = MetricsRegistry()
        return state.registry


def get_span_recorder():
    return state.spans


def get_flight_recorder():
    """The active :class:`FlightRecorder` (None unless configured)."""
    return state.flight_recorder


def get_timeseries():
    """The active :class:`TimeSeriesStore` (None unless configured)."""
    return state.timeseries


def get_slo_engine():
    """The active :class:`SLOEngine` (None unless configured)."""
    return state.slo


def is_active():
    return state.active


def _process_index():
    """This process's rank when ``torch.distributed`` is initialised, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class TelemetrySession:

    def __init__(self, config: TelemetryConfig):
        self.config = config
        self.registry = get_registry()
        self.spans = SpanRecorder(max_spans=config.max_spans)
        self.spans.drop_counter = self.registry.counter(
            "spans_dropped_total",
            "Spans dropped from the ring buffer past max_spans")
        self.server = None
        self._closed = False
        # metrics/spans record on every rank (cheap, local); the export
        # surfaces — file sinks and the HTTP port — are process-0-only by
        # default, like the monitor backends, so multi-process runs don't
        # interleave one JSONL file or collide on a fixed port.
        self.exporting = config.all_ranks or _process_index() == 0
        if config.jsonl_path and self.exporting:
            self.registry.open_jsonl(config.jsonl_path)
        if config.http.enabled and self.exporting:
            self.server = start_http_server(self.registry, spans=self.spans,
                                            host=config.http.host, port=config.http.port)
        self.compile_watch = (compile_watch.install(self.registry, spans=self.spans)
                              if config.compile_watch else None)
        self.flight_recorder = None
        if config.flight_recorder.enabled:
            if config.flight_recorder.watchdog_enabled and self.compile_watch is None:
                # without wrapped-call occupancy the watchdog cannot tell a
                # long watched call from a wedged loop and will false-positive
                logger.warning(
                    "telemetry: flight-recorder watchdog is on but compile_watch "
                    "is off — a loop blocked in a long watched call gets no stall "
                    f"amnesty; raise watchdog_stall_s "
                    f"(={config.flight_recorder.watchdog_stall_s}s) past your "
                    "longest engine call or re-enable compile_watch")
            self.flight_recorder = FlightRecorder(config.flight_recorder,
                                                  self.registry,
                                                  spans=self.spans).install()
        self.timeseries = None
        self.slo = None
        if config.timeseries.enabled or config.slo.enabled:
            # the SLO engine reads windowed deltas from the store, so
            # enabling SLOs implies the sampler even without timeseries
            ts_cfg = config.timeseries
            self.timeseries = TimeSeriesStore(
                self.registry, interval_s=ts_cfg.interval_s,
                retention_points=ts_cfg.retention_points,
                families=ts_cfg.families or None)
            if config.slo.enabled:
                self.slo = SLOEngine(config.slo, self.timeseries, self.registry)
            self.timeseries.start()
        state.spans = self.spans
        state.flight_recorder = self.flight_recorder
        state.timeseries = self.timeseries
        state.slo = self.slo
        state.session = self
        state.active = True

    @property
    def metrics_url(self):
        return self.server.url + "/metrics" if self.server else None

    def flush(self):
        """Write the Chrome trace (if configured). JSONL is flushed per event."""
        if self.config.trace_path and self.exporting:
            self.spans.export_chrome_trace(self.config.trace_path)
            logger.info(f"telemetry: wrote Chrome trace to {self.config.trace_path} "
                        f"({len(self.spans)} spans; open in chrome://tracing or Perfetto)")

    def close(self):
        """Idempotent; a session displaced by a newer configure() was already
        closed and must not touch the (shared) registry's current sinks."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self.timeseries is not None:
            self.timeseries.stop()
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self.compile_watch is not None:
            compile_watch.uninstall(self.compile_watch)
            self.compile_watch = None
        if state.session is self:
            self.registry.close_jsonl()
            state.active = False
            state.session = None
            state.spans = None
            state.timeseries = None
            state.slo = None
            if state.flight_recorder is self.flight_recorder:
                state.flight_recorder = None
            with state._lock:
                state._comm_metrics.clear()
        self.flight_recorder = None


def configure(config) -> TelemetrySession:
    """Activate telemetry from a :class:`TelemetryConfig` (or a raw dict).
    Reconfiguring closes the previous session's sinks; the registry (and its
    accumulated metrics) persists across sessions."""
    if isinstance(config, dict):
        config = TelemetryConfig.from_dict(config)
    if state.session is not None:
        state.session.close()
    return TelemetrySession(config)


def shutdown():
    if state.session is not None:
        state.session.close()


def wrap_timers(timers):
    """Wrap a timers object so start/stop pairs emit spans (engine fwd/bwd/step)."""
    return TracingTimers(timers, state.spans) if state.spans is not None else timers


def record_comm_op(op_name, latency_s, size_bytes):
    """One collective's telemetry: latency/bytes histograms, op counter and a
    span. Called from ``comm.timed_op`` only when ``state.active``."""
    with state._lock:
        metrics = state._comm_metrics.get(op_name)
        if metrics is None:
            registry = get_registry()
            labels = {"op": op_name}
            metrics = (
                registry.histogram("comm_op_latency_seconds",
                                   "Per-collective wall latency", labels=labels),
                registry.histogram("comm_op_bytes", "Per-collective message size",
                                   labels=labels, buckets=_COMM_BYTES_BUCKETS),
                registry.counter("comm_ops_total", "Collectives executed", labels=labels),
            )
            state._comm_metrics[op_name] = metrics
    lat_hist, bytes_hist, counter = metrics
    lat_hist.observe(latency_s)
    bytes_hist.observe(size_bytes)
    counter.inc()
    spans = state.spans  # snapshot: a concurrent close() may null the field
    if spans is not None:
        end = now_us()
        dur = int(latency_s * 1e6)
        spans.record(op_name, cat="comm", ts_us=end - dur, dur_us=dur,
                     args={"bytes": int(size_bytes)})
