"""Per-layer execution tracer.

Port of ``deepspeed_tpu/inference/v2/tracer.py`` with its API and summary
schema (``Tracer``, ``BatchTraceSummary``, ``RECORD_NAMES``, ``record``,
``set_tracer``/``get_tracer``, the ring of ``max_batches``,
``batch_summaries``, ``drain_summaries``, spans under ``cat="inference"``
carrying ``batch_id`` and ``uids``). A traced forward records ``embed``, per
layer ``attn`` and ``ffn``, then ``unembed``.

How a phase is timed follows the engine's device, chosen when the tracer is
built:

- **CUDA**: ``record(name)`` records a ``torch.cuda.Event(enable_timing=True)``
  pair on the current stream and does not synchronize, as the upstream
  tracer timed phases. The traced forward resolves its events with one wait
  on its last event (:meth:`Tracer.resolve`), and ``batch_summaries`` /
  ``drain_summaries`` resolve whatever is still pending, so no caller sees an
  unresolved time. Span timestamps sit on the device's timeline: one host
  timestamp taken with an anchor event at ``init_batch``, plus each phase's
  elapsed time from that anchor, so the phases of one batch never overlap.
- **CPU**: ``perf_counter`` around each phase, as the JAX package times its
  segmented forward (eager CPU ops finish before they return).

With tracing off (no tracer set, the default) ``record`` is one global read
and creates no event.

Memory: traces accumulate in a bounded ring buffer (``max_batches``, default
1024) so long-running serving cannot leak; consumers should prefer
``drain_summaries()`` which frees what it returns. When a ``span_recorder``
is attached (engine-owned telemetry session) — or, without one, while a
globally-configured session is active — every recorded phase also emits a
Chrome-trace span under the ``inference`` category.
"""

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List

import torch

from deepspeed_tpu_torch.telemetry import get_span_recorder as _tel_get_spans
from deepspeed_tpu_torch.telemetry import now_us

RECORD_NAMES = ["attn", "ffn", "moe_a2a_1", "moe_a2a_2", "moe_ffn", "moe_a2a_3"]

DEFAULT_MAX_TRACE_BATCHES = 1024


@dataclass
class BatchTraceHolder:
    batch_id: int
    num_layers: int
    is_empty_run: bool
    seen_tokens: Any = field(default_factory=list)
    in_flight_tokens: Any = field(default_factory=list)
    traces: Any = field(default_factory=list)  # (name, elapsed_us)
    uids: Any = field(default_factory=list)  # constituent request/sequence uids
    uids_view: Any = None  # one frozen copy shared by all this batch's spans
    # CUDA timing: the anchor event and the host time taken with it, and the
    # (name, start, end) event pairs not yet resolved into ``traces``
    anchor: Any = None
    anchor_us: int = 0
    pending: Any = field(default_factory=list)


@dataclass
class BatchTraceSummary:
    batch_id: int
    is_empty_run: bool
    num_layers: int
    seen_tokens: List[int]
    in_flight_tokens: List[int]
    record_names: List[str]
    record_exec_times: Any  # [num_layers][len(record_names)] in us
    embed: int
    unembed: int
    uids: List[int] = field(default_factory=list)


def _timing_event():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class Tracer:

    def __init__(self, max_batches: int = DEFAULT_MAX_TRACE_BATCHES, span_recorder=None, device="cpu"):
        self._batch_counter = 0
        # ring buffer: long-running serving must not grow host memory per
        # batch; past capacity the oldest unconsumed trace is dropped
        self._batch_traces = deque(maxlen=max(1, max_batches))
        self._cur: BatchTraceHolder = None
        self.span_recorder = span_recorder
        self.uses_events = torch.device(device).type == "cuda"

    @property
    def pending_batches(self) -> int:
        return len(self._batch_traces)

    def init_batch(self, is_empty_run: bool, num_layers: int) -> None:
        self._cur = BatchTraceHolder(self._batch_counter, num_layers, is_empty_run)
        if self.uses_events:
            self._cur.anchor = _timing_event()
            self._cur.anchor_us = now_us()
        self._batch_counter += 1
        self._batch_traces.append(self._cur)

    def add_sequence(self, seq_desc) -> None:
        self._cur.seen_tokens.append(seq_desc.seen_tokens)
        self._cur.in_flight_tokens.append(seq_desc.in_flight_tokens)
        # descriptors are duck-typed here; -1 marks one with no engine uid
        self._cur.uids.append(int(getattr(seq_desc, "tracking_id", -1)))

    def add_trace(self, name: str, elapsed_us: int, ts_us: int = None) -> None:
        if self._cur is None:
            return
        self._append(self._cur, name, elapsed_us, ts_us)

    def add_events(self, name: str, start, end) -> None:
        """A phase timed by a recorded CUDA event pair, resolved later."""
        if self._cur is None:
            return
        self._cur.pending.append((name, start, end))

    def _append(self, bt: BatchTraceHolder, name: str, elapsed_us: int, ts_us) -> None:
        bt.traces.append((name, elapsed_us))
        # the recorder bound at construction (engine-owned session) — or a
        # globally-configured session's, resolved per record like engine_v2's
        # span fallback, so the process-wide-configure pattern gets per-layer
        # phases too; disabled telemetry pays one global read
        spans = self.span_recorder if self.span_recorder is not None else _tel_get_spans()
        if spans is not None:
            # uids join each per-layer phase against the serving request
            # traces composed into this ragged batch; snapshot ONCE on the
            # first phase (sequences are all inserted before the forward
            # runs) — num_layers * len(RECORD_NAMES) spans share the copy
            uids = bt.uids_view
            if uids is None:
                uids = bt.uids_view = [int(u) for u in bt.uids]
            spans.record(name, cat="inference", ts_us=ts_us, dur_us=elapsed_us,
                         args={"batch_id": bt.batch_id, "uids": uids})

    def resolve(self) -> None:
        """Turn every pending event pair into its phase time: one wait on the
        last event of each batch that has any."""
        for bt in self._batch_traces:
            if bt.pending:
                self._resolve(bt)

    def _resolve(self, bt: BatchTraceHolder) -> None:
        pending, bt.pending = bt.pending, []
        pending[-1][2].synchronize()
        for name, start, end in pending:
            # both ends from the one anchor: a phase ends where the next begins
            t0 = bt.anchor_us + int(bt.anchor.elapsed_time(start) * 1000)
            t1 = bt.anchor_us + int(bt.anchor.elapsed_time(end) * 1000)
            self._append(bt, name, t1 - t0, t0)

    def _summarize(self, bt: BatchTraceHolder) -> BatchTraceSummary:
        if bt.pending:
            self._resolve(bt)
        traces = list(bt.traces)
        embed = unembed = 0
        if not bt.is_empty_run and traces:
            if traces and traces[0][0] == "embed":
                embed = traces.pop(0)[1]
            if traces and traces[-1][0] == "unembed":
                unembed = traces.pop()[1]
        name_idx = {n: i for i, n in enumerate(RECORD_NAMES)}
        per_layer = max(1, len(traces) // max(1, bt.num_layers))
        exec_times = []
        for li in range(bt.num_layers):
            row = [0] * len(RECORD_NAMES)
            for name, us in traces[li * per_layer:(li + 1) * per_layer]:
                if name in name_idx:
                    row[name_idx[name]] = us
            exec_times.append(row)
        return BatchTraceSummary(batch_id=bt.batch_id,
                                 is_empty_run=bt.is_empty_run,
                                 num_layers=bt.num_layers,
                                 seen_tokens=bt.seen_tokens,
                                 in_flight_tokens=bt.in_flight_tokens,
                                 record_names=RECORD_NAMES,
                                 record_exec_times=exec_times,
                                 embed=embed,
                                 unembed=unembed,
                                 uids=list(bt.uids))

    def batch_summaries(self):
        """Summaries of everything still buffered (non-destructive)."""
        for bt in self._batch_traces:
            yield self._summarize(bt)

    def drain_summaries(self) -> List[BatchTraceSummary]:
        """Summarize AND free the consumed traces — the long-running-serving
        consumption API (a periodic drain keeps the ring from ever dropping)."""
        out = []
        while self._batch_traces:
            bt = self._batch_traces.popleft()
            out.append(self._summarize(bt))
            if bt is self._cur:
                self._cur = None
        return out


_TRACER = None


def set_tracer(tracer) -> None:
    global _TRACER
    _TRACER = tracer


def get_tracer():
    return _TRACER


@contextmanager
def record(name: str):
    """Time a phase (no-op when tracing is disabled): a CUDA event pair on a
    CUDA tracer, resolved later; host time on a CPU tracer."""
    tracer = _TRACER
    if tracer is None:
        yield
        return
    if tracer.uses_events:
        start = _timing_event()
        try:
            yield
        finally:
            tracer.add_events(name, start, _timing_event())
        return
    t0 = time.perf_counter()
    ts0 = now_us()
    try:
        yield
    finally:
        tracer.add_trace(name, int((time.perf_counter() - t0) * 1e6), ts_us=ts0)
