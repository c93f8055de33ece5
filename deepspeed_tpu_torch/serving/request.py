"""Request lifecycle primitives for the serving layer.

Port of ``deepspeed_tpu/serving/request.py`` (host Python; ``now_us`` comes
from the port's telemetry), with every speculative field the scheduler
reads (``spec_drafted``, ``spec_accepted`` and the ``_spec_*`` drafter state).

Reference role: DeepSpeed-MII's ``RaggedRequest``/``RaggedRequestMsg`` (the
request objects FastGen's persistent deployment schedules); here the request
additionally owns a thread-safe streaming output channel so time-to-first-token
is a real, observable event — the scheduler thread pushes tokens as they are
sampled and any number of consumer threads (an SSE handler, ``generate()``)
iterate them live.

State machine::

    QUEUED -> PREFILL -> DECODE -> DONE
       \\         \\         \\---> CANCELLED | FAILED | TIMED_OUT
        \\         \\--------------^
         \\------------------------^

Terminal transitions happen on the scheduler thread only (engine state — KV
blocks, sequence descriptors — is freed there); ``cancel()`` from any thread
just raises a flag the scheduler honors on its next tick.
"""

import itertools
import queue
import threading
import time
from enum import Enum
from typing import Iterator, List, Optional

import numpy as np

from deepspeed_tpu_torch.serving.overload import (DEFAULT_PRIORITY, validate_priority,
                                            validate_tenant)
from deepspeed_tpu_torch.telemetry import now_us


class RequestState(Enum):
    QUEUED = 0
    PREFILL = 1
    DECODE = 2
    DONE = 3
    CANCELLED = 4
    FAILED = 5
    TIMED_OUT = 6


TERMINAL_STATES = frozenset(
    {RequestState.DONE, RequestState.CANCELLED, RequestState.FAILED, RequestState.TIMED_OUT})

_END = object()

# process-unique steal handles (request.handle): the fleet router addresses a
# victim's in-flight request across the HTTP boundary by handle, never by uid
# (uids are per-scheduler and unassigned until admission)
_HANDLE_IDS = itertools.count()


class TokenStream:
    """Thread-safe single-producer token channel: the scheduler ``put()``s,
    consumers iterate (blocking) or poll ``get(timeout)``. Closing wakes every
    consumer; iteration then stops."""

    def __init__(self):
        self._q = queue.SimpleQueue()
        self._closed = threading.Event()

    def put(self, token: int) -> None:
        self._q.put(token)

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._q.put(_END)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token, or None once the stream is closed and drained.
        Raises ``queue.Empty`` on timeout."""
        item = self._q.get(timeout=timeout)
        if item is _END:
            self._q.put(_END)  # keep the sentinel for other/later consumers
            return None
        return item

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is _END:
                self._q.put(_END)
                return
            yield item


class Request:
    """One generation request: prompt in, token stream out.

    ``deadline_s`` is a *relative* budget from submission; the scheduler
    enforces the absolute ``deadline`` (monotonic clock) at every tick and
    mid-decode. ``max_new_tokens``/``eos_token_id``/``temperature``/``seed``
    are per-request sampling parameters (the seed feeds a private numpy
    stream so concurrent requests sample independently).
    """

    def __init__(self,
                 prompt,
                 max_new_tokens: int = 64,
                 temperature: float = 0.0,
                 eos_token_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 seed: int = 0,
                 priority: str = DEFAULT_PRIORITY,
                 tenant: Optional[str] = None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.deadline_s = deadline_s
        self.seed = int(seed)
        self.priority = validate_priority(priority)
        # tenant identity for the cost-attribution plane: the scheduler
        # normalizes None to the configured default tenant at submission;
        # cost is the per-request ledger accumulator
        # (telemetry.ledger.RequestCost), None while telemetry is off — the
        # zero-cost contract makes every charging site one None check
        self.tenant = validate_tenant(tenant)
        self.cost = None

        self.uid: Optional[int] = None  # assigned at admission by the scheduler
        # stable cross-thread identity from birth: the work-stealing path
        # must address a request while it is still QUEUED (uid is None)
        self.handle: str = f"r{next(_HANDLE_IDS)}"
        # distributed-tracing identity: the scheduler assigns both when a
        # telemetry session is active; every lifecycle span parents under
        # root_span_id and the HTTP layer returns trace_id to the client.
        # A request arriving through the fleet router inherits its trace_id
        # and parents its root under the router's span (parent_span_id).
        self.trace_id: Optional[str] = None
        self.root_span_id: Optional[int] = None
        self.parent_span_id: Optional[int] = None
        # fleet KV handoff: a handoff-requested request exports its engine
        # state as a portable payload when it finishes DONE (prefill role);
        # a resume request carries a peer's payload in and enters DECODE
        # directly once the scheduler imports it (decode role)
        self.handoff_requested = False
        self.handoff_payload: Optional[bytes] = None
        self._resume_payload: Optional[bytes] = None
        self._resume_header: Optional[dict] = None
        self._resume_kv = None  # parsed KV view into _resume_payload
        # tiered KV parking: a park-requested request exports a v2 park frame
        # at finish (length OR eos — a new turn can continue either) for the
        # router's park store; a rehydrate request carries a parked frame in
        # PLUS the new turn's full prompt and enters PREFILL for the suffix
        # only (the parked turns' KV imports, zero prefill for cached turns)
        self.park_requested = False
        self.park_payload: Optional[bytes] = None
        self._rehydrate = False
        self.kv_tier_source: Optional[str] = None  # tier the KV was served from
        self.tokens: List[int] = []
        # prompt tokens served from the prefix cache at admission (0 = cold);
        # surfaced in /v1/stats rows and the final response doc so clients and
        # the loadgen can split latency by hit/miss
        self.cached_tokens = 0
        # the prompt's chained block digests, hashed once at admission and
        # extended (never recomputed) at each publish point
        self._prefix_digests = None
        self.stream = TokenStream()
        self.error: Optional[str] = None
        self.finish_reason: Optional[str] = None  # "eos" | "length" | "context"
        # overload control (serving/overload.py): shed_reason marks a request
        # dropped before any engine work (admission estimate or queue shed);
        # retry_after_s rides the 429/SSE error so clients back off
        # proportionally; degraded_mode lists every brownout degradation
        # applied (clamped budget, disabled speculation) — never silent
        self.shed_reason: Optional[str] = None
        self.retry_after_s: Optional[float] = None
        self.degraded_mode: List[str] = []
        # speculative decoding (inference/v2/spec/): per-request drafting
        # stats and the acceptance EWMA driving the adaptive k. The EWMA is
        # the drafter state a fleet handoff carries so a decode-role peer
        # continues adaptation where the donor stopped.
        self.spec_drafted = 0     # draft tokens proposed into verify feeds
        self.spec_accepted = 0    # of those, accepted by the target model
        self.decode_steps = 0     # decode dispatches this request consumed

        self.arrival_s = time.monotonic()
        self.arrival_us = now_us()  # span-clock arrival (perf_counter domain)
        self.deadline = (self.arrival_s + deadline_s) if deadline_s is not None else None
        self.first_token_s: Optional[float] = None
        self.finished_s: Optional[float] = None

        self._state = RequestState.QUEUED
        self._state_lock = threading.Lock()
        self._done = threading.Event()
        self._cancel_requested = threading.Event()

        # scheduler-private bookkeeping (touched on the scheduler thread only)
        self._fed = 0                 # prompt tokens already put() into the engine
        self._next: Optional[int] = None  # next decode input token
        self._deferred = 0            # consecutive ticks skipped under pressure
        self._last_touch_s = self.arrival_s  # eviction coldness ordering
        self._last_token_s: Optional[float] = None  # ITL measurement
        self._rng: Optional[np.random.Generator] = None
        self._spec_ewma: Optional[float] = None  # acceptance EWMA (None = cold)
        # drafting history buffer (prompt + generated), grown incrementally by
        # the scheduler so per-step drafting copies O(new tokens), not O(all)
        self._spec_history: Optional[np.ndarray] = None
        self._spec_history_len = 0
        # learned / auto drafter state (scheduler thread only): the target's
        # hidden state behind the next decode input (valid only while
        # _spec_hidden_pos equals the current history length), the per-drafter
        # acceptance EWMAs "auto" arbitrates over (carried across handoffs),
        # the drafter that built the in-flight feed, and the in-flight
        # TokenTree awaiting verify (None = linear/plain feed this tick)
        self._spec_hidden: Optional[np.ndarray] = None
        self._spec_hidden_pos = -1
        self._spec_ewmas: dict = {}
        self._spec_last_drafter: Optional[str] = None
        self._spec_tree = None
        # client-requested drafter pin (``submit(drafter=...)``): overrides
        # "auto" arbitration for THIS request — the loadgen's A/B lever
        self._spec_drafter_pin: Optional[str] = None

    # ----------------------------------------------------------------- state --
    @property
    def state(self) -> RequestState:
        return self._state

    @property
    def finished(self) -> bool:
        return self._state in TERMINAL_STATES

    def _set_state(self, state: RequestState) -> None:
        with self._state_lock:
            if self._state in TERMINAL_STATES:
                return  # terminal states are sticky
            self._state = state
            if state in TERMINAL_STATES:
                self.finished_s = time.monotonic()
                self.stream.close()
                self._done.set()

    def cancel(self) -> None:
        """Request cancellation (any thread); the scheduler finalizes — frees
        the sequence's KV blocks — on its next tick."""
        self._cancel_requested.set()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested.is_set()

    # ----------------------------------------------------------------- waits --
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block for completion and return the generated tokens. FAILED raises
        (the scheduler's error message); CANCELLED/TIMED_OUT return the tokens
        produced before the cut — the caller can inspect ``state``."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.uid} not finished within {timeout}s")
        if self._state is RequestState.FAILED:
            raise RuntimeError(self.error or "request failed")
        return list(self.tokens)

    # ----------------------------------------------------------------- stats --
    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    def __repr__(self):
        return (f"Request(uid={self.uid}, state={self._state.name}, "
                f"prompt={self.prompt.size}t, generated={len(self.tokens)}t)")
