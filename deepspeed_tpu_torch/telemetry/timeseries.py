"""Bounded in-memory metric time series.

Port of ``deepspeed_tpu/telemetry/timeseries.py`` (host Python; copied).

The registry's counters and histograms are cumulative-since-start, so
``/v1/stats`` percentiles cannot answer "what was p99 TTFT in the *last
minute*". This module closes that gap without a Prometheus server: a
:class:`TimeSeriesStore` takes fixed-interval snapshots of selected registry
families into per-family ring buffers and computes windowed reads from point
*deltas* — counter rates, and histogram percentiles interpolated over the
bucket-count difference between the first and last point inside the window
(the local equivalent of ``histogram_quantile(rate(...[1m]))``).

Aggregation is per *family*: label sets are summed elementwise at sample
time, matching how the SLO engine and the sparkline report consume them.
A family spec may carry a split label — ``"serving_tenant_tokens_total{tenant}"``
— which instead keeps one series per value of that label (series are named
``family{label="value"}``); the per-tenant cost families ride this, bounded
upstream by the ledger's top-K tenant label cap.

Zero-cost contract: nothing here runs unless a telemetry session with
``timeseries.enabled`` starts the sampler thread; instrumented hot paths are
untouched (the store only *reads* the registry, off the request path).
"""

import threading
import time
from collections import deque

# sampled when the config lists no explicit families: the serving/fleet
# signals an operator actually pages on (latency, volume, errors, pressure)
DEFAULT_FAMILIES = (
    "serving_ttft_seconds",
    "serving_inter_token_seconds",
    "serving_e2e_latency_seconds",
    "serving_queue_depth",
    "serving_in_flight_requests",
    "serving_admissions_total",
    "serving_completions_total",
    "serving_failures_total",
    "serving_timeouts_total",
    "serving_rejections_total",
    "serving_shed_admission_total",
    "serving_shed_queue_total",
    "serving_brownout_stage",
    "fleet_queue_depth",
    "fleet_kv_pressure",
    "fleet_requests_total",
    "fleet_routing_failures_total",
    "fleet_global_queue_depth",
    "fleet_global_queue_expired_total",
    "slo_burn_rate",
    # cost attribution plane: per-tenant billed tokens (split per tenant,
    # label cardinality bounded by the ledger's top-K cap), fair-share sheds,
    # device-seconds burn, and the predicted-vs-observed drift surface
    "serving_tenant_tokens_total{tenant}",
    "serving_fair_share_sheds_total",
    "serving_cost_device_seconds_total",
    "perf_observed_dispatch_seconds",
    "perf_drift_events_total",
)


class _HistPoint:
    """One histogram sample: cumulative (count, sum, per-bucket counts)."""

    __slots__ = ("count", "sum", "bucket_counts")

    def __init__(self, count, total, bucket_counts):
        self.count = count
        self.sum = total
        self.bucket_counts = bucket_counts


def _interp_quantile(q, count, buckets, bucket_counts):
    """Linear-interpolation quantile over non-cumulative bucket counts —
    the same estimate :meth:`Histogram.quantile` computes, applied to a
    windowed delta instead of the cumulative state."""
    if count <= 0:
        return None
    target = q * count
    cum, prev_le = 0, 0.0
    for le, n in zip(buckets, bucket_counts):
        cum += n
        if cum >= target and n > 0:
            frac = (target - (cum - n)) / n
            return prev_le + (le - prev_le) * min(1.0, max(0.0, frac))
        prev_le = le
    return float(buckets[-1])


def bad_fraction(count, buckets, bucket_counts, threshold):
    """Fraction of observations strictly above ``threshold``, interpolating
    inside the bucket that straddles it (the SLO engine's latency read)."""
    if count <= 0:
        return 0.0
    good, prev_le = 0.0, 0.0
    for le, n in zip(buckets, bucket_counts):
        if le <= threshold:
            good += n
        else:
            if prev_le < threshold:
                good += n * (threshold - prev_le) / (le - prev_le)
            break
        prev_le = le
    return max(0.0, min(1.0, 1.0 - good / count))


class TimeSeriesStore:
    """Fixed-interval snapshots of registry families in bounded rings.

    ``tick()`` is driven by the owned sampler thread (``start()``) or called
    directly by tests; ``on_tick`` callbacks (the SLO engine) run after each
    sample with the store as argument.
    """

    def __init__(self, registry, interval_s=1.0, retention_points=600,
                 families=None):
        self._registry = registry
        self.interval_s = float(interval_s)
        self.retention_points = int(retention_points)
        self.families = tuple(families) if families else DEFAULT_FAMILIES
        # "family" samples the label-set sum; "family{label}" keeps one
        # series per value of that label instead
        self._plain = set()
        self._split = {}  # family -> split label key
        for fam in self.families:
            if fam.endswith("}") and "{" in fam:
                base, label = fam[:-1].split("{", 1)
                self._split[base] = label
            else:
                self._plain.add(fam)
        self._lock = threading.Lock()
        self._series = {}  # family -> {"kind", "buckets", "points": deque((t, value))}
        self._on_tick = []
        self._thread = None
        self._stop = threading.Event()
        self.ticks = 0

    # ------------------------------------------------------------- sampling --
    def _sample_families(self):
        """Aggregate each selected family across its label sets. Reads the
        registry under its lock (like ``samples()``) — not a counted call."""
        out = {}
        with self._registry._lock:
            for (name, _), metric in self._registry._metrics.items():
                if name in self._plain:
                    key = name
                else:
                    label = self._split.get(name)
                    if label is None:
                        continue
                    key = f'{name}{{{label}="{metric.labels.get(label, "")}"}}'
                if metric.kind == "histogram":
                    prev = out.get(key)
                    if prev is None:
                        out[key] = ("histogram", metric.buckets,
                                    _HistPoint(metric.count, metric.sum,
                                               list(metric.bucket_counts)))
                    else:
                        point = prev[2]
                        point.count += metric.count
                        point.sum += metric.sum
                        for i, n in enumerate(metric.bucket_counts):
                            point.bucket_counts[i] += n
                else:
                    prev = out.get(key)
                    value = metric.value + (prev[2] if prev else 0.0)
                    out[key] = (metric.kind, None, value)
        return out

    def tick(self, now=None):
        now = time.time() if now is None else now
        sampled = self._sample_families()
        with self._lock:
            for name, (kind, buckets, value) in sampled.items():
                series = self._series.get(name)
                if series is None:
                    series = {"kind": kind, "buckets": buckets,
                              "points": deque(maxlen=self.retention_points)}
                    self._series[name] = series
                series["points"].append((now, value))
            self.ticks += 1
        for hook in list(self._on_tick):
            try:
                hook(self)
            except Exception:  # a broken hook must not kill the sampler
                pass

    def on_tick(self, hook):
        self._on_tick.append(hook)

    # --------------------------------------------------------------- reads --
    def _window_points(self, name, window_s):
        series = self._series.get(name)
        if series is None or not series["points"]:
            return None, []
        points = list(series["points"])
        if window_s is not None:
            horizon = points[-1][0] - window_s
            points = [p for p in points if p[0] >= horizon]
        return series, points

    def last(self, name):
        with self._lock:
            series, points = self._window_points(name, None)
        if not points:
            return None
        return points[-1][1]

    def window_delta(self, name, window_s):
        """Counter/gauge delta over the window: last - first (None with
        fewer than two points)."""
        with self._lock:
            series, points = self._window_points(name, window_s)
        if len(points) < 2:
            return None
        return points[-1][1] - points[0][1]

    def window_rate(self, name, window_s):
        """Counter increase per second over the window."""
        with self._lock:
            series, points = self._window_points(name, window_s)
        if len(points) < 2:
            return None
        dt = points[-1][0] - points[0][0]
        if dt <= 0:
            return None
        return (points[-1][1] - points[0][1]) / dt

    def window_hist_delta(self, name, window_s):
        """Histogram delta over the window: (count, sum, bucket_counts,
        buckets), all non-cumulative. None without two points."""
        with self._lock:
            series, points = self._window_points(name, window_s)
            if len(points) < 2 or series["kind"] != "histogram":
                return None
            first, last = points[0][1], points[-1][1]
            counts = [max(0, b - a) for a, b in
                      zip(first.bucket_counts, last.bucket_counts)]
            return (max(0, last.count - first.count),
                    max(0.0, last.sum - first.sum),
                    counts, series["buckets"])

    def window_percentile(self, name, q, window_s):
        """q-th percentile of the observations made inside the window."""
        delta = self.window_hist_delta(name, window_s)
        if delta is None:
            return None
        count, _, counts, buckets = delta
        return _interp_quantile(q, count, buckets, counts)

    def window_bad_fraction(self, name, threshold, window_s):
        """Fraction of window observations above ``threshold`` seconds."""
        delta = self.window_hist_delta(name, window_s)
        if delta is None:
            return None
        count, _, counts, buckets = delta
        if count == 0:
            return 0.0
        return bad_fraction(count, buckets, counts, threshold)

    # -------------------------------------------------------------- export --
    def snapshot(self, max_points=None, window_s=60.0):
        """JSON doc for ``/v1/fleet/timeseries`` / the probe rollup. Scalar
        series export ``[t, value]`` points; histograms export
        ``[t, count, sum]`` plus windowed p50/p95/p99 so consumers never need
        the bucket layout."""
        doc = {"interval_s": self.interval_s,
               "retention_points": self.retention_points,
               "window_s": window_s, "ticks": self.ticks, "series": {}}
        with self._lock:
            names = sorted(self._series)
        for name in names:
            with self._lock:
                series, points = self._window_points(name, None)
                if series is None:
                    continue
                kind = series["kind"]
                points = list(points)
            if max_points is not None and len(points) > max_points:
                points = points[-max_points:]
            if kind == "histogram":
                entry = {"kind": kind,
                         "points": [[round(t, 3), p.count, p.sum]
                                    for t, p in points]}
                for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    entry[key] = self.window_percentile(name, q, window_s)
                entry["rate"] = self.window_rate_hist_count(name, window_s)
            else:
                entry = {"kind": kind,
                         "points": [[round(t, 3), v] for t, v in points]}
                if kind == "counter":
                    entry["rate"] = self.window_rate(name, window_s)
            doc["series"][name] = entry
        return doc

    def window_rate_hist_count(self, name, window_s):
        """Observation rate (events/s) of a histogram family in the window."""
        delta = self.window_hist_delta(name, window_s)
        if delta is None:
            return None
        count = delta[0]
        with self._lock:
            _, points = self._window_points(name, window_s)
        if len(points) < 2:
            return None
        dt = points[-1][0] - points[0][0]
        return count / dt if dt > 0 else None

    # ------------------------------------------------------------- sampler --
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dstpu-timeseries")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass  # sampling must never take the process down
