"""Fleet trace collector: Dapper-style cross-process span assembly.

A request routed through the fleet carries ONE trace id, but its spans land
in N per-process ring buffers (the router's recorder plus one per replica
subprocess). The :class:`TraceCollector` pulls those rings together:

- the router's own :class:`SpanRecorder` (and any LocalReplica, which shares
  the same process-global recorder — deduplicated by recorder identity) is
  read in-process at offset zero;
- each subprocess replica is drained over the wire via
  ``GET /trace/export?since_us=`` with a clock-offset estimate from the pull
  round-trip: spans are stamped with the *remote* ``now_us()`` (a
  per-process monotonic clock), so the collector samples its own clock
  before (t0) and after (t1) the pull and corrects every remote timestamp
  by ``offset = remote_now - (t0 + t1) / 2``.

Merged spans are stored keyed by trace id (bounded, oldest trace evicted)
and export as one Chrome-trace/Perfetto document in which each source keeps
its own ``pid`` — the first place a router→prefill→handoff→decode timeline
is visible across real process boundaries.

Port of ``deepspeed_tpu/telemetry/collector.py`` (host Python, unchanged in
behaviour).
"""

import os
import threading
from collections import OrderedDict

from deepspeed_tpu_torch.telemetry.spans import now_us

# re-pull lookback: a span is recorded at its *end*, so a pull at T can miss
# spans that started before T and finish after; the next pull re-reads this
# far behind the remote high-water mark and dedupe-by-span-id absorbs the
# overlap
LOOKBACK_US = 10_000_000


class TraceCollector:
    """Merges per-process span rings into one per-trace store."""

    def __init__(self, max_traces=512, metrics=None):
        self.max_traces = int(max_traces)
        self._metrics = metrics  # FleetMetrics or None (telemetry disabled)
        self._lock = threading.Lock()
        # trace_id -> {(pid, span_id): event dict (corrected, chrome-trace)}
        self._traces = OrderedDict()
        self._sources = {}  # source key -> {"since_us", "offset_us", "pid"}
        self.spans_collected = 0
        self.collections = 0

    # ------------------------------------------------------------- pulling --
    def collect(self, recorder=None, replicas=()):
        """One collection round: drain the local recorder plus every replica.

        ``replicas`` is an iterable of fleet Replica objects exposing
        ``collect_spans(since_us)``; local ones that share ``recorder``'s
        ring are skipped (their spans are already in it).
        """
        seen_recorders = set()
        if recorder is not None:
            seen_recorders.add(id(recorder))
            self._ingest("local", recorder.export_since(
                self._next_since("local")), offset_us=0)
        for replica in replicas:
            shared = getattr(replica, "span_recorder", None)
            if shared is not None and id(shared) in seen_recorders:
                continue
            if shared is not None:
                seen_recorders.add(id(shared))
            key = f"replica:{replica.id}"
            t0 = now_us()
            try:
                doc = replica.collect_spans(self._next_since(key))
            except Exception:
                continue  # an unreachable replica skips this round
            t1 = now_us()
            if not doc:
                continue
            offset = 0
            if shared is None and "now_us" in doc:
                offset = int(doc["now_us"]) - (t0 + t1) // 2
            self._ingest(key, doc, offset_us=offset)
        with self._lock:
            self.collections += 1
        if self._metrics is not None:
            self._metrics.trace_collections.inc()

    def _next_since(self, key):
        source = self._sources.get(key)
        return source["since_us"] if source else 0

    def _ingest(self, key, doc, offset_us):
        spans = doc.get("spans") or []
        pid = int(doc.get("pid", os.getpid()))
        ingested = 0
        with self._lock:
            self._sources[key] = {
                "since_us": max(0, int(doc.get("now_us", 0)) - LOOKBACK_US),
                "offset_us": offset_us,
                "pid": pid,
                "dropped": int(doc.get("dropped", 0)),
            }
            for span in spans:
                trace_id = span.get("trace_id")
                if trace_id is None:
                    continue  # only request traces are assembled fleet-wide
                store = self._traces.get(trace_id)
                if store is None:
                    store = self._traces[trace_id] = {}
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)
                event = {"name": span["name"], "cat": span.get("cat", "default"),
                         "ph": "X", "ts": int(span["ts_us"]) - offset_us,
                         "dur": int(span.get("dur_us", 0)), "pid": pid,
                         "args": dict(span.get("args") or {},
                                      trace_id=trace_id,
                                      span_id=span.get("span_id"),
                                      parent_id=span.get("parent_id"),
                                      source=key)}
                dedupe = (pid, span.get("span_id"))
                if dedupe not in store:
                    ingested += 1
                store[dedupe] = event
            self.spans_collected += ingested
        if ingested and self._metrics is not None:
            self._metrics.trace_spans_collected.inc(ingested)

    # -------------------------------------------------------------- export --
    def trace_ids(self):
        with self._lock:
            return list(self._traces)

    def spans_for(self, trace_id):
        """Corrected events of one trace, sorted by timestamp."""
        with self._lock:
            store = self._traces.get(trace_id, {})
            return sorted((dict(e) for e in store.values()),
                          key=lambda e: e["ts"])

    def chrome_trace(self, trace_id=None):
        """Merged Chrome-trace doc (``/v1/fleet/trace``): every source keeps
        its own pid so Perfetto shows one track group per process; per-trace
        tids give each request a named thread within each process."""
        with self._lock:
            traces = ({trace_id: self._traces.get(trace_id, {})}
                      if trace_id is not None else dict(self._traces))
            events = [dict(e) for store in traces.values()
                      for e in store.values()]
            sources = {key: dict(s) for key, s in self._sources.items()}
        events.sort(key=lambda e: e["ts"])
        trace_tids, pids = {}, {}
        for event in events:
            tid = trace_tids.setdefault(event["args"]["trace_id"],
                                        len(trace_tids) + 1)
            event["tid"] = tid
            pids.setdefault(event["pid"], event["args"].get("source"))
        meta = [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": source or f"pid {pid}"}}
                for pid, source in pids.items()]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": f"request {tid_trace}"}}
                 for pid in pids
                 for tid_trace, tid in trace_tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "collector": {"sources": sources,
                              "spans_collected": self.spans_collected,
                              "collections": self.collections,
                              "traces": len(traces)}}

    def describe(self):
        with self._lock:
            return {"traces": len(self._traces),
                    "spans_collected": self.spans_collected,
                    "collections": self.collections,
                    "sources": {k: dict(s) for k, s in self._sources.items()}}
