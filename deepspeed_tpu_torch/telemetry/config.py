"""Telemetry config block (``"telemetry": {...}`` in the master JSON config).

Port of ``deepspeed_tpu/telemetry/config.py`` as dataclasses on
``runtime/config_utils.py`` (the reference's blocks are pydantic models), with
the same fields and defaults. One switch for the metrics registry, span
recorder and HTTP exporter.
"""

from dataclasses import dataclass
from typing import List, Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field


@dataclass
class TelemetryHTTPConfig(DeepSpeedConfigModel):
    """Serving endpoint for scrapes: ``/metrics`` (Prometheus text),
    ``/healthz`` (liveness) and ``/trace`` (Chrome-trace JSON)."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0
    """0 = ephemeral; the bound port is logged and available on the session."""


@dataclass
class FlightRecorderConfig(DeepSpeedConfigModel):
    """Crash flight recorder: signal/atexit/watchdog-triggered black-box JSON
    dumps (last-N spans, recent events, metrics snapshot, live scheduler
    state). See ``telemetry/flight_recorder.py``."""

    enabled: bool = False

    dir: str = "flight_recorder"
    """Dump directory (created on first dump; filenames carry pid + trigger)."""

    max_spans: int = 4096
    """How many of the most recent spans each dump includes."""

    signal_enabled: bool = True
    """Install a SIGUSR1 handler (``kill -USR1 <pid>`` dumps without stopping
    the process). Requires enabling telemetry from the main thread."""

    dump_on_exit: bool = False
    """Also dump at interpreter exit (atexit)."""

    watchdog_enabled: bool = True
    """Run the heartbeat watchdog thread: components under watch (the serving
    scheduler loop) that stop beating for ``watchdog_stall_s`` trigger one
    dump per stall episode + the ``serving_stalled_total`` metric."""

    watchdog_stall_s: float = 10.0
    """Heartbeat age that counts as a stall."""

    watchdog_hard_stall_s: float = 300.0
    """Stall budget granted while the process is inside a watched engine call
    (see ``compile_watch.wrap``); past this it counts as stalled regardless."""

    watchdog_poll_s: float = 1.0
    """How often the watchdog checks heartbeat ages."""


@dataclass
class TimeSeriesConfig(DeepSpeedConfigModel):
    """Metric time-series history: fixed-interval snapshots of selected
    registry families into bounded rings, so windowed percentiles/rates
    ("p99 TTFT over the last minute") are computable locally. Memory is
    ``retention_points`` points per family; wall coverage is
    ``interval_s * retention_points`` seconds (defaults: 1s × 600 = 10 min).
    See ``telemetry/timeseries.py``."""

    enabled: bool = False
    interval_s: float = 1.0
    """Sampling resolution (seconds between snapshots)."""

    retention_points: int = 600
    """Ring capacity per family; oldest points drop beyond this."""

    families: List[str] = config_field(default_factory=list)
    """Registry families to sample; empty = the curated serving/fleet
    default set (``timeseries.DEFAULT_FAMILIES``)."""


@dataclass
class SLOObjectiveConfig(DeepSpeedConfigModel):
    """One declarative SLO: a metric objective, its target, and the
    fast/slow burn-rate windows it is evaluated over."""

    name: str = ""
    """Label for metrics/events/status docs (defaults to the metric kind)."""

    metric: str = "ttft"
    """Objective kind: ``ttft`` | ``itl`` | ``e2e`` (latency percentile
    objectives), ``error_rate``, ``goodput``, or ``perf_drift``
    (observed-vs-predicted dispatch-time drift events per dispatch)."""

    target_s: float = 1.0
    """Latency bound (seconds) an observation must meet — latency kinds."""

    target_ratio: float = 0.99
    """Promised good fraction; the error budget is ``1 - target_ratio``."""

    fast_window_s: float = 60.0
    """Fast burn window (quick detection)."""

    slow_window_s: float = 300.0
    """Slow burn window (blip filtering); both must burn to alert."""

    burn_threshold: float = 2.0
    """Burn-rate level that counts as a breach in both windows."""


@dataclass
class SLOConfig(DeepSpeedConfigModel):
    """SLO burn-rate engine over the time-series store (which a session
    builds for it even without ``timeseries.enabled``); breaches bump
    ``slo_breaches_total``, emit a registry event and fire one
    flight-recorder dump per episode."""

    enabled: bool = False
    objectives: List[SLOObjectiveConfig] = config_field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        self.objectives = [SLOObjectiveConfig.from_dict(o) if isinstance(o, dict) else o
                           for o in self.objectives]


@dataclass
class TelemetryConfig(DeepSpeedConfigModel):
    enabled: bool = False

    jsonl_path: Optional[str] = None
    """Append-mode JSONL event sink (one JSON object per line). None = no
    file sink."""

    trace_path: Optional[str] = None
    """Chrome-trace (``chrome://tracing`` / Perfetto) JSON written on
    ``flush()`` / session close. None = spans stay scrape-only (``/trace``)."""

    max_spans: int = 65536
    """Span ring-buffer capacity; oldest spans are dropped beyond this."""

    all_ranks: bool = False
    """Metrics/spans always record on every rank; file sinks and the HTTP
    endpoint open on process 0 only unless this is set."""

    compile_watch: bool = True
    """Install the compile watch (``compile_*`` metrics). The port compiles
    no programs, so it sees no compile events; its wrapped-call occupancy
    still gives the flight-recorder watchdog its stall amnesty."""

    http: TelemetryHTTPConfig = config_field(default_factory=TelemetryHTTPConfig)

    flight_recorder: FlightRecorderConfig = config_field(default_factory=FlightRecorderConfig)

    timeseries: TimeSeriesConfig = config_field(default_factory=TimeSeriesConfig)

    slo: SLOConfig = config_field(default_factory=SLOConfig)
