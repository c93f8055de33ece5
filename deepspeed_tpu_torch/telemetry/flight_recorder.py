"""Crash flight recorder: a signal-, atexit-, and watchdog-triggered
black-box dump.

When a serving process hangs or dies, the operator's first question is "what
was the scheduler doing?" — and the answer must not require the process to be
healthy enough to serve ``/metrics``. The recorder keeps everything needed for
a post-mortem in memory and dumps it as one parseable JSON file on demand:

- the last-N spans (with trace ids, so the dump joins against request traces),
- the registry's recent JSONL events and a full metrics snapshot,
- every registered *state provider*'s live view (the serving scheduler
  registers queue depths, per-request states and KV occupancy).

Triggers:

- ``SIGUSR1`` (``kill -USR1 <pid>``) — dump without stopping the process;
- ``dump()`` — the API trigger (also exposed as ``GET /flight`` on the
  telemetry HTTP endpoint);
- ``atexit`` (opt-in ``dump_on_exit``) — a last snapshot on interpreter exit;
- the **watchdog** — components under watch call ``heartbeat(name)`` from
  their progress loop; a watchdog thread fires one dump per stall episode
  when a heartbeat goes stale past ``watchdog_stall_s`` and, for the serving
  scheduler channel, increments the ``serving_stalled_total`` metric.

Dumps are written atomically (tmp + rename) to ``config.dir`` with the pid,
a sequence number and the trigger in the filename.
"""

import atexit
import json
import os
import signal
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

# heartbeat-channel prefix the serving scheduler registers under (one channel
# per scheduler instance, e.g. "serving_scheduler:0"); the watchdog maps a
# stall on any such channel to the serving_stalled_total metric
SERVING_SCHEDULER_CHANNEL = "serving_scheduler"

METRIC_NAMES = ("flight_recorder_dumps_total", "serving_stalled_total")


class FlightRecorder:

    def __init__(self, config, registry, spans=None):
        self._config = config
        self._registry = registry
        self._spans = spans
        self._lock = threading.Lock()
        self._providers = {}          # name -> callable() -> JSON-able state
        self._heartbeats = {}         # name -> (last beat monotonic s, owner thread ident)
        self._stalled = set()         # channels already dumped this episode
        self._dump_seq = 0
        self._dump_metrics = {}       # trigger -> counter
        self._stall_counter = registry.counter(
            "serving_stalled_total",
            "Watchdog detections of a stalled serving scheduler loop")
        self._prev_sigusr1 = None
        self._atexit_hook = None
        self._watchdog = None
        self._watchdog_stop = threading.Event()
        self._closed = False

    # -------------------------------------------------------------- install --
    def install(self):
        """Arm the signal/atexit/watchdog triggers (idempotent-safe to skip
        pieces that cannot arm: SIGUSR1 needs the main thread)."""
        if self._config.signal_enabled:
            try:
                self._prev_sigusr1 = signal.signal(signal.SIGUSR1, self._on_signal)
            except ValueError:  # not the main thread: API/watchdog still work
                logger.warning("flight recorder: SIGUSR1 handler needs the main "
                               "thread; signal trigger disabled")
        if self._config.dump_on_exit:
            self._atexit_hook = lambda: self._safe_dump("atexit")
            atexit.register(self._atexit_hook)
        if self._config.watchdog_enabled:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="dstpu-flight-watchdog",
                                              daemon=True)
            self._watchdog.start()
        return self

    def close(self):
        """Disarm every trigger and restore the previous SIGUSR1 handler."""
        if self._closed:
            return
        self._closed = True
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
        if self._prev_sigusr1 is not None:
            try:
                # restore only if the handler is still OURS: a newer recorder
                # may have installed over us, and stomping its live handler
                # with our (possibly SIG_DFL) predecessor would turn the
                # documented `kill -USR1` dump into process termination
                if signal.getsignal(signal.SIGUSR1) == self._on_signal:
                    signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except ValueError:  # pragma: no cover - non-main-thread close
                pass
            self._prev_sigusr1 = None
        if self._atexit_hook is not None:
            atexit.unregister(self._atexit_hook)
            self._atexit_hook = None

    # ------------------------------------------------------------ providers --
    def register_provider(self, name, fn):
        """Register a live-state callable included in every dump under
        ``state[name]`` (the serving scheduler registers its queue/request/KV
        view here). Re-registering a name replaces it."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name):
        with self._lock:
            self._providers.pop(name, None)

    # ------------------------------------------------------------ heartbeats --
    def watch_heartbeat(self, name):
        """Put ``name`` under watchdog watch; the owner must now call
        ``heartbeat(name)`` at least every ``watchdog_stall_s`` seconds."""
        with self._lock:
            self._heartbeats[name] = (time.monotonic(), None)
            self._stalled.discard(name)

    def unwatch_heartbeat(self, name):
        with self._lock:
            self._heartbeats.pop(name, None)
            self._stalled.discard(name)

    def heartbeat(self, name):
        """Record liveness (called from the owner's progress loop; the
        calling thread is remembered so the watchdog attributes in-compile
        amnesty to this loop's thread, not to any watched call anywhere)."""
        self._heartbeats[name] = (time.monotonic(), threading.get_ident())

    @staticmethod
    def _in_wrapped_engine_call(thread_ident=None) -> bool:
        from deepspeed_tpu_torch.telemetry import compile_watch
        watch = compile_watch.get()
        return watch is not None and watch.in_wrapped_call(thread_ident)

    def _watchdog_loop(self):
        poll = max(0.01, self._config.watchdog_poll_s)
        stall = self._config.watchdog_stall_s
        hard = max(stall, self._config.watchdog_hard_stall_s)
        while not self._watchdog_stop.wait(poll):
            now = time.monotonic()
            with self._lock:
                beats = dict(self._heartbeats)
            for name, (last, ident) in beats.items():
                age = now - last
                if age <= stall:
                    with self._lock:
                        self._stalled.discard(name)  # episode over: re-arm
                    continue
                # a loop blocked inside a (long) watched engine call is busy, not
                # wedged — grant ITS thread the hard-stall budget before
                # declaring it (a channel that never heartbeat carries no
                # owner and falls back to any-thread occupancy)
                if age <= hard and self._in_wrapped_engine_call(ident):
                    continue
                with self._lock:
                    # re-check under the lock: a concurrent unwatch_heartbeat
                    # (scheduler stop) must not get a dump re-added for it
                    if name not in self._heartbeats or name in self._stalled:
                        continue
                    self._stalled.add(name)          # one dump per stall episode
                if name.split(":", 1)[0] == SERVING_SCHEDULER_CHANNEL:
                    self._stall_counter.inc()
                logger.error(f"flight recorder: heartbeat '{name}' stale for "
                             f"{age:.1f}s (> {stall}s); dumping")
                self._safe_dump(f"watchdog_{name.split(':', 1)[0]}")

    # ----------------------------------------------------------------- dump --
    def _on_signal(self, signum, frame):
        # the handler runs on the main thread between bytecodes — dumping
        # inline would self-deadlock on self._lock if the interrupted code
        # holds it (register_provider, an API dump); a worker thread just
        # waits its turn
        threading.Thread(target=self._safe_dump, args=("sigusr1", ),
                         name="dstpu-flight-sigusr1", daemon=True).start()

    def _safe_dump(self, trigger):
        try:
            return self.dump(trigger)
        except Exception:  # pragma: no cover - a failing dump must never take
            # down the process it is meant to post-mortem
            logger.exception("flight recorder: dump failed")
            return None

    def dump(self, trigger="api", return_doc=False):
        """Write one black-box JSON dump; returns its path — or
        ``(path, doc)`` with ``return_doc`` so callers serving the dump over
        HTTP need not re-read and re-parse the file just written."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            providers = dict(self._providers)
            beats = dict(self._heartbeats)
        doc = {
            "meta": {"version": 1, "ts": time.time(), "pid": os.getpid(),
                     "trigger": trigger, "seq": seq},
            "heartbeats_age_s": {name: time.monotonic() - last
                                 for name, (last, _) in beats.items()},
            "spans": (self._spans.tail(self._config.max_spans)
                      if self._spans is not None else []),
            "spans_dropped": (self._spans.dropped
                              if self._spans is not None else 0),
            "events": self._registry.recent_events_snapshot(),
            "metrics": self._registry.snapshot(),
            "state": {},
        }
        for name, fn in providers.items():
            try:
                doc["state"][name] = fn()
            except Exception as e:  # a wedged provider must not block the dump
                doc["state"][name] = {"error": f"provider raised: {e!r}"}
        out_dir = os.path.abspath(self._config.dir)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"flight_{os.getpid()}_{seq:04d}_{trigger}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        counter = self._dump_metrics.get(trigger)
        if counter is None:
            counter = self._registry.counter("flight_recorder_dumps_total",
                                             "Flight-recorder dumps written",
                                             labels={"trigger": trigger})
            self._dump_metrics[trigger] = counter
        counter.inc()
        logger.info(f"flight recorder: wrote {path} ({trigger})")
        return (path, doc) if return_doc else path
