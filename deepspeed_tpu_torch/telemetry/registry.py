"""Process-wide metrics registry.

Counter / gauge / histogram primitives with two export surfaces:

- Prometheus text exposition (``render_prometheus``) — what the HTTP
  exporter serves on ``/metrics`` and ``bin/dstpu_report --metrics-url``
  scrapes back.
- A JSONL event sink (``open_jsonl`` + ``event``) — an append-only stream of
  one JSON object per line, the tail-able counterpart (loss/lr/samples-per-sec
  step events, monitor events).

Everything is thread-safe (the HTTP exporter scrapes from its own thread) and
counts its own API calls (``api_calls``) so tests can prove the disabled hot
path performs zero telemetry work beyond a boolean check.
"""

import json
import re
import threading
import time
from collections import deque

# in-memory tail of recent event() records kept for the flight recorder's
# black-box dump (bounded; independent of whether a JSONL file sink is open)
RECENT_EVENTS_KEPT = 256

# latency-flavored default buckets (seconds), Prometheus-style
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels):
    return tuple(sorted((labels or {}).items()))


def _format_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, registry, name, help_text, labels):
        self._registry = registry
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help_text, labels):
        super().__init__(registry, name, help_text, labels)
        self.value = 0.0

    def inc(self, amount=1):
        with self._registry._lock:
            self._registry.api_calls += 1
            self.value += amount

    def samples(self):
        return [(self.name, self.labels, self.value)]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help_text, labels):
        super().__init__(registry, name, help_text, labels)
        self.value = 0.0

    def set(self, value):
        with self._registry._lock:
            self._registry.api_calls += 1
            self.value = float(value)

    def inc(self, amount=1):
        with self._registry._lock:
            self._registry.api_calls += 1
            self.value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def samples(self):
        return [(self.name, self.labels, self.value)]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help_text, labels, buckets=None):
        super().__init__(registry, name, help_text, labels)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, value):
        with self._registry._lock:
            self._registry.api_calls += 1
            self.count += 1
            self.sum += value
            # per-bucket counts; render-time cumulation produces the
            # Prometheus cumulative ``le`` semantics
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self.bucket_counts[i] += 1
                    break

    def quantile(self, q):
        """Bucket-based quantile estimate (the ``histogram_quantile`` a
        Prometheus server would compute, done locally): linear interpolation
        inside the bucket holding the q-th observation. A read, like
        ``samples()`` — not a counted telemetry call.

        Edge cases are pinned, not left to bucket math:

        - no observations: returns None for every q;
        - ``q == 0``: the lower edge of the first non-empty bucket (the
          distribution's known lower bound);
        - ``q == 1``: the upper bound (``le``) of the last non-empty bucket —
          or the last finite bucket's bound when observations landed past it
          (the overflow tail's true upper edge is unknown, so the estimate
          clamps there, same as any tail quantile)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._registry._lock:
            count = self.count
            bucket_counts = list(self.bucket_counts)
        if count == 0:
            return None
        if q == 0.0:
            prev_le = 0.0
            for le, n in zip(self.buckets, bucket_counts):
                if n > 0:
                    return prev_le
                prev_le = le
            return float(self.buckets[-1])  # every observation overflowed
        if q == 1.0:
            last_le = None
            for le, n in zip(self.buckets, bucket_counts):
                if n > 0:
                    last_le = float(le)
            if last_le is None or count > sum(bucket_counts):
                return float(self.buckets[-1])  # overflow tail: clamp
            return last_le
        target = q * count
        cum, prev_le = 0, 0.0
        for le, n in zip(self.buckets, bucket_counts):
            cum += n
            if cum >= target and n > 0:
                frac = (target - (cum - n)) / n
                return prev_le + (le - prev_le) * min(1.0, max(0.0, frac))
            prev_le = le
        return float(self.buckets[-1])

    def samples(self):
        out, cum = [], 0
        for le, n in zip(self.buckets, self.bucket_counts):
            cum += n
            out.append((self.name + "_bucket", {**self.labels, "le": repr(float(le))}, cum))
        out.append((self.name + "_bucket", {**self.labels, "le": "+Inf"}, self.count))
        out.append((self.name + "_sum", self.labels, self.sum))
        out.append((self.name + "_count", self.labels, self.count))
        return out


_KIND_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}  # (name, label_key) -> metric
        self._families = {}  # name -> (kind, help)
        self.api_calls = 0
        self._jsonl = None
        self._jsonl_path = None
        self.recent_events = deque(maxlen=RECENT_EVENTS_KEPT)

    # ------------------------------------------------------------- creation --
    def _get_or_create(self, kind, name, help_text, labels, buckets=None):
        buckets = tuple(sorted(buckets)) if buckets is not None else None
        key = (name, _label_key(labels))
        with self._lock:
            metric = self._metrics.get(key)
            if metric is not None:
                if metric.kind != kind:
                    raise ValueError(f"metric {name!r} already registered as {metric.kind}, "
                                     f"requested {kind}")
                if buckets is not None and buckets != metric.buckets:
                    raise ValueError(f"histogram {name!r}{labels or ''} already registered "
                                     f"with buckets {metric.buckets}")
                return metric
            fam = self._families.get(name)
            if fam is not None and fam["kind"] != kind:
                raise ValueError(f"metric family {name!r} is {fam['kind']}, requested {kind}")
            if kind == "histogram":
                # one bucket layout per family: label-sets must stay
                # aggregatable (histogram_quantile over labels); a later
                # instrument without explicit buckets inherits the family's
                fam_buckets = fam["buckets"] if fam else None
                if buckets is not None and fam_buckets is not None and buckets != fam_buckets:
                    raise ValueError(f"histogram family {name!r} uses buckets {fam_buckets}; "
                                     f"all label-sets must share one layout")
                metric = Histogram(self, name, help_text or (fam["help"] if fam else ""),
                                   labels, buckets=buckets or fam_buckets)
            else:
                metric = _KIND_CLS[kind](self, name, help_text or (fam["help"] if fam else ""),
                                         labels)
            if fam is None:
                self._families[name] = {"kind": kind, "help": help_text,
                                        "buckets": getattr(metric, "buckets", None)}
            self._metrics[key] = metric
            return metric

    def counter(self, name, help_text="", labels=None):
        return self._get_or_create("counter", name, help_text, labels)

    def gauge(self, name, help_text="", labels=None):
        return self._get_or_create("gauge", name, help_text, labels)

    def histogram(self, name, help_text="", labels=None, buckets=None):
        return self._get_or_create("histogram", name, help_text, labels, buckets=buckets)

    # ------------------------------------------------------------ jsonl sink --
    def open_jsonl(self, path):
        import os
        with self._lock:
            self.close_jsonl()
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._jsonl = open(path, "a")
            self._jsonl_path = path

    def close_jsonl(self):
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None
                self._jsonl_path = None

    def event(self, name, **fields):
        """Append one JSONL event (no-op without an open sink, but still a
        counted telemetry call — the hot path must not reach here disabled)."""
        with self._lock:
            self.api_calls += 1
            record = {"ts": time.time(), "event": name}
            record.update(fields)
            self.recent_events.append(record)
            if self._jsonl is None:
                return
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    # -------------------------------------------------------------- export --
    def render_prometheus(self):
        lines = []
        with self._lock:
            by_family = {}
            for (name, _), metric in sorted(self._metrics.items()):
                by_family.setdefault(name, []).append(metric)
            for name, metrics in by_family.items():
                fam = self._families[name]
                kind, help_text = fam["kind"], fam["help"]
                if help_text:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
                for metric in metrics:
                    for sample_name, labels, value in metric.samples():
                        lines.append(f"{sample_name}{_format_labels(labels)} {value}")
        return "\n".join(lines) + "\n"

    def recent_events_snapshot(self):
        """Copy of the recent-events ring (the flight recorder's read path —
        a bare ``list(deque)`` would race concurrent ``event()`` appends)."""
        with self._lock:
            return list(self.recent_events)

    def snapshot(self):
        """{name: [(labels, value)]} over scalar samples (for reports/tests)."""
        out = {}
        with self._lock:
            for (_, _), metric in self._metrics.items():
                for sample_name, labels, value in metric.samples():
                    out.setdefault(sample_name, []).append((dict(labels), value))
        return out


def parse_prometheus_text(text):
    """Inverse of ``render_prometheus`` (used by ``dstpu_report --metrics-url``
    and the tests): {family: {"type", "help", "samples": [(labels, value)]}}."""
    families = {}
    sample_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)$")
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')

    def family_for(name):
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base in families and families[base]["type"] == "histogram":
                return families[base]
        return families.setdefault(name, {"type": "untyped", "help": "", "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": "untyped", "help": "", "samples": []})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            families.setdefault(name, {"type": "untyped", "help": "", "samples": []})["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            continue
        name, _, label_body, value = m.groups()
        labels = dict(label_re.findall(label_body or ""))
        family_for(name)["samples"].append((name, labels, float(value)))
    return families
