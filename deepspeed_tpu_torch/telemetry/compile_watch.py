"""Recompilation watch.

Port of ``deepspeed_tpu/telemetry/compile_watch.py`` with its API and metric
names. The JAX package listens to ``jax.monitoring`` for XLA backend
compiles; the port runs eager PyTorch and compiles no programs, so no compile
event arrives and ``compile_cache_misses_total``/``compile_seconds_total``
stay at zero. What still works as in the reference:

- ``wrap(site, key, fn)`` counts a cache entry at its creation site and marks
  the calling thread as inside a watched call while ``fn`` runs; the flight
  recorder's watchdog grants such a thread its hard-stall budget;
- ``note_bucket(bucket)`` counts ragged batches landing in a pad bucket not
  among the last few distinct buckets (``compile_bucket_switches_total``);
- ``_record_compile(seconds)`` records one compile (metrics, an
  ``xla_compile`` span, a JSONL event) for whatever reports one.

Hot-path contract: when telemetry is disabled ``get()`` is None and every call
site is a single global-read + None check.
"""

import threading
from collections import OrderedDict
from contextvars import ContextVar

from deepspeed_tpu_torch.telemetry.spans import now_us

# ambient (site, key) while a wrapped jit callable executes
_SITE_CTX: ContextVar = ContextVar("dstpu_compile_site", default=None)

# wrapped-call occupancy BY THREAD, module-global (like _SITE_CTX) so a
# telemetry reconfigure mid-call cannot strand the in-flight occupancy on a
# displaced watch: the flight-recorder watchdog uses this to tell "this
# loop's thread is blocked in a long watched call" apart from a genuinely
# wedged loop — per-thread, so a co-located trainer's watched calls grant no
# amnesty to a wedged serving loop
_OCCUPANCY_LOCK = threading.Lock()
_ACTIVE_THREADS = {}  # thread ident -> wrapped-call depth

_WATCH = None  # the active CompileWatch, None when telemetry is disabled

METRIC_NAMES = ("compile_cache_misses_total", "compile_seconds_total",
                "compile_cache_entries", "compile_bucket_switches_total")


def get():
    """The active watch (None disabled) — the one check on hot paths."""
    return _WATCH


class CompileWatch:
    """Compile accounting on one registry + span recorder pair."""

    def __init__(self, registry, spans=None):
        self._registry = registry
        self._spans = spans
        self._lock = threading.Lock()
        self._site_metrics = {}  # site -> (misses counter, seconds counter, entries gauge)
        self._recent_buckets = OrderedDict()  # LRU of the last distinct buckets
        self._bucket_switches = registry.counter(
            "compile_bucket_switches_total",
            "Ragged batches landing in a pad bucket not recently seen")

    def _metrics_for(self, site):
        with self._lock:
            m = self._site_metrics.get(site)
            if m is None:
                labels = {"site": site}
                m = (self._registry.counter(
                         "compile_cache_misses_total",
                         "XLA backend compiles (jit cache misses)", labels=labels),
                     self._registry.counter(
                         "compile_seconds_total",
                         "Cumulative XLA backend compile wall seconds", labels=labels),
                     self._registry.gauge(
                         "compile_cache_entries",
                         "Live jit cache entries created at this site", labels=labels))
                self._site_metrics[site] = m
        return m

    # ------------------------------------------------------------- listener --
    def _record_compile(self, seconds):
        ctx = _SITE_CTX.get()
        site, key = ctx if ctx is not None else ("other", None)
        misses, secs, _ = self._metrics_for(site)
        misses.inc()
        secs.inc(seconds)
        end = now_us()
        dur = int(seconds * 1e6)
        args = {"site": site}
        if key is not None:
            args["key"] = repr(key)
        if self._spans is not None:
            self._spans.record("xla_compile", cat="compile", ts_us=end - dur,
                               dur_us=dur, args=args)
        self._registry.event("xla_compile", seconds=seconds, **args)

    # ------------------------------------------------------------ site hooks --
    def wrap(self, site, key, fn):
        """Wrap a fresh jit cache entry: counts it, and makes (site, key)
        ambient during every call so compiles inside attribute here."""
        self._metrics_for(site)[2].inc()

        def watched(*args, **kwargs):
            # check the ACTIVE watch, not the one that built this wrapper:
            # jit-cache entries outlive telemetry sessions, and a disabled
            # process pays one global read and nothing else (occupancy itself
            # is module-global, so it also survives a reconfigure mid-call)
            if _WATCH is None:
                return fn(*args, **kwargs)
            token = _SITE_CTX.set((site, key))
            ident = threading.get_ident()
            with _OCCUPANCY_LOCK:
                _ACTIVE_THREADS[ident] = _ACTIVE_THREADS.get(ident, 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                with _OCCUPANCY_LOCK:
                    depth = _ACTIVE_THREADS[ident] - 1
                    if depth:
                        _ACTIVE_THREADS[ident] = depth
                    else:
                        del _ACTIVE_THREADS[ident]
                _SITE_CTX.reset(token)

        return watched

    @staticmethod
    def in_wrapped_call(thread_ident=None) -> bool:
        """True while a wrapped jit callable is executing — on the given
        thread, or on any thread when ``thread_ident`` is None."""
        if thread_ident is None:
            return bool(_ACTIVE_THREADS)
        return thread_ident in _ACTIVE_THREADS

    # buckets tracked before a re-entry counts as churn: SplitFuse steadily
    # alternates prefill and decode buckets (already compiled — not churn),
    # and a serving process cycles through only a handful of live buckets
    _RECENT_BUCKET_WINDOW = 8

    def note_bucket(self, bucket):
        """Called by RaggedBatchWrapper.finalize with the padded
        (tokens, sequences, blocks) bucket of each batch. A bucket absent
        from the recently-seen window counts as a switch — churn that
        predicts a recompile — while alternating between live buckets does
        not (the very first bucket is the baseline, not a switch)."""
        with self._lock:
            switched = bucket not in self._recent_buckets and bool(self._recent_buckets)
            self._recent_buckets[bucket] = None
            self._recent_buckets.move_to_end(bucket)
            if len(self._recent_buckets) > self._RECENT_BUCKET_WINDOW:
                self._recent_buckets.popitem(last=False)
        if switched:
            self._bucket_switches.inc()


def install(registry, spans=None):
    """Activate the watch (TelemetrySession does this when telemetry turns
    on). Returns the watch; replaces any previous one."""
    global _WATCH
    _WATCH = CompileWatch(registry, spans=spans)
    return _WATCH


def uninstall(watch=None):
    """Deactivate (a no-op if ``watch`` is given and is no longer active)."""
    global _WATCH
    if watch is None or _WATCH is watch:
        _WATCH = None
