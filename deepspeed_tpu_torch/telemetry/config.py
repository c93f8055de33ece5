"""Telemetry config block (``"telemetry": {...}`` in the master JSON config).

Port of ``deepspeed_tpu/telemetry/config.py`` as dataclasses on
``runtime/config_utils.py`` (the reference's blocks are pydantic models), with
the same fields and defaults. One switch for the metrics registry, span
recorder and HTTP exporter.

The metric time-series store and the SLO engine are ROADMAP A6: a config that
enables ``timeseries`` or ``slo`` raises ``NotImplementedError``.
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
    """Metric time-series history (ROADMAP A6; refused when enabled)."""

    enabled: bool = False
    interval_s: float = 1.0
    retention_points: int = 600
    families: List[str] = config_field(default_factory=list)


@dataclass
class SLOObjectiveConfig(DeepSpeedConfigModel):
    """One declarative SLO (the SLO engine is ROADMAP A6)."""

    name: str = ""
    metric: str = "ttft"
    target_s: float = 1.0
    target_ratio: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0


@dataclass
class SLOConfig(DeepSpeedConfigModel):
    """SLO burn-rate engine (ROADMAP A6; refused when enabled)."""

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

    def __post_init__(self):
        super().__post_init__()
        for name in ("timeseries", "slo"):
            if getattr(self, name).enabled:
                raise NotImplementedError(f"telemetry.{name} is not ported to deepspeed_tpu_torch yet "
                                          f"(see ROADMAP.md A6)")
