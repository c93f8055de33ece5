"""Stdlib HTTP front-end for the serving scheduler.

Port of ``deepspeed_tpu/serving/server.py``: the same routes, status codes,
headers and body shapes, ``POST /v1/steal`` (the fleet's work stealing)
included.

In the style of ``telemetry/exporter.py`` (daemon ``ThreadingHTTPServer``,
ephemeral-port support), serving the request lifecycle instead of metrics:

- ``POST /v1/generate`` — JSON body::

      {"prompt": [1, 2, 3],            // token ids (required, non-empty)
       "max_new_tokens": 64,           // optional, server default otherwise
       "temperature": 0.0,             // optional
       "eos_token_id": 2,              // optional
       "deadline_s": 2.0,              // optional per-request deadline
       "seed": 0,                      // optional sampling seed
       "stream": true}                 // optional: SSE token streaming

  Non-streaming responses are one JSON object
  ``{"tokens": [...], "state": "DONE", "finish_reason": "length", ...}``.
  Streaming responses are Server-Sent Events (``text/event-stream``): one
  ``data: {"token": N, "index": I}`` event per generated token as it is
  sampled (TTFT is real), then a final ``data: {"done": true, "state": ...,
  "tokens": [...]}`` event. A dropped connection cancels the request (its KV
  blocks return to the pool on the next scheduler tick).

  Backpressure: queue-full in ``reject`` mode returns **429**; ``block`` mode
  stalls the handler thread until the queue drains. During shutdown new
  requests get **503**.

- ``POST /v1/resume`` — fleet decode-role continuation: the body carries a
  base64 ``payload`` (a peer engine's ``export_sequence`` product) instead of
  a prompt; the sequence enters DECODE directly and streams/returns exactly
  like ``/v1/generate``. A resume body carrying BOTH a payload and a
  ``prompt`` is the *rehydrate* form: the payload is a parked v2 frame whose
  token history the prompt strictly extends — the parked turns' KV imports
  and only the new suffix prefills. Both POST routes accept ``handoff`` and
  ``park`` flags (export this request's state at DONE; the base64 payload is
  returned in the final JSON / SSE ``done`` event as ``handoff`` / ``park``)
  and adopt an upstream trace from the
  ``X-DSTPU-Trace-Id`` / ``X-DSTPU-Parent-Span`` request headers, so the
  fleet router's hop parents the replica's request track.
- ``GET /v1/stats`` — scheduler + engine occupancy JSON: per-request rows
  (uid, state, tenant, cost-to-date, age, trace id), p50/p95/p99
  TTFT/ITL/e2e, the ``usage`` rollup and the predicted-vs-observed ``perf``
  join when telemetry is active.
- ``GET /v1/usage`` — the cost-attribution document: ledger totals, the
  per-tenant rollup, pricing, and the fair-share posture
  (``{"enabled": false}`` with telemetry off). Requests carry a tenant
  identity via the JSON ``tenant`` field or the ``X-DSTPU-Tenant`` header;
  unlabeled traffic bills to the configured default tenant.
- ``GET /healthz`` — liveness (same contract as the telemetry exporter).

With a telemetry session active every request is traced end-to-end: the
``X-DSTPU-Trace-Id`` response header (both response modes) and the ``uid``/
``trace_id`` fields of the final JSON / SSE ``done`` event let a client join
its request against the exported Chrome trace / flight-recorder dump.

``stop()`` drains gracefully: admission stops (503), in-flight requests run to
completion bounded by ``config.drain_timeout_s``, stragglers are CANCELLED,
then the listener shuts down.
"""

import base64
import itertools
import json
import math
import os
import queue
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.ragged.handoff import \
    CONTENT_TYPE as HANDOFF_CONTENT_TYPE
from deepspeed_tpu_torch.serving.config import (DEFAULT_MAX_RESUME_BODY_BYTES,
                                                ServingConfig)
from deepspeed_tpu_torch.serving.overload import validate_priority, validate_tenant
from deepspeed_tpu_torch.serving.request import Request
from deepspeed_tpu_torch.serving.scheduler import (AdmissionRejected, QueueFullError,
                                                   SchedulerStopped, ServingScheduler)
from deepspeed_tpu_torch.utils.logging import logger

_MAX_BODY_BYTES = 8 << 20  # an 8 MiB prompt is already ~2M tokens of JSON
# a resume body carries a base64 KV-handoff payload — real-model KV runs to
# hundreds of MB (the fleet handoff histogram buckets reach 1 GiB) and base64
# adds 4/3, so the prompt cap would 400 every non-toy handoff
_MAX_RESUME_BODY_BYTES = DEFAULT_MAX_RESUME_BODY_BYTES


TRACE_HEADER = "X-DSTPU-Trace-Id"
# the fleet router's span id: a replica's request root parents under it so
# router → prefill replica → decode replica renders as ONE Perfetto track
PARENT_SPAN_HEADER = "X-DSTPU-Parent-Span"
# priority class (interactive | batch) — header form; the JSON body's
# "priority" field wins when both are present
PRIORITY_HEADER = "X-DSTPU-Priority"
# cost-attribution tenant identity — header form; the JSON body's "tenant"
# field wins when both are present (same precedence as priority)
TENANT_HEADER = "X-DSTPU-Tenant"
# fleet data motion: the request's steal handle (sent up-front on SSE
# responses so the router can address a live request), the generation params
# riding a binary-transport resume POST, the client's handoff-return
# negotiation ("ref" = stash the frame server-side, return a claim-once
# handoff_ref instead of base64-in-JSON), and the already-streamed token
# count on an exported-steal response
HANDLE_HEADER = "X-DSTPU-Request-Handle"
PARAMS_HEADER = "X-DSTPU-Params"
HANDOFF_TRANSPORT_HEADER = "X-DSTPU-Handoff-Transport"
STEAL_SENT_HEADER = "X-DSTPU-Steal-Sent"


def request_priority(handler, doc: dict) -> Optional[str]:
    """The request's priority class from the JSON ``priority`` field (wins)
    or the ``X-DSTPU-Priority`` header; None = scheduler default. Raises
    ``ValueError`` on an unknown class (callers answer 400)."""
    raw = doc.get("priority") or handler.headers.get(PRIORITY_HEADER) or None
    return validate_priority(raw) if raw is not None else None


def request_tenant(handler, doc: dict) -> Optional[str]:
    """The request's tenant identity from the JSON ``tenant`` field (wins) or
    the ``X-DSTPU-Tenant`` header; None = the scheduler's default tenant.
    Raises ``ValueError`` on a malformed identifier (callers answer 400)."""
    raw = doc.get("tenant") or handler.headers.get(TENANT_HEADER) or None
    return validate_tenant(raw)


def retry_after_header(seconds: float) -> str:
    """HTTP ``Retry-After`` is integer seconds; round up so a client never
    retries before the estimate says there is room."""
    return str(max(1, math.ceil(seconds)))


_PAYLOAD_KEY_RE = re.compile(rb'"payload"\s*:\s*"')
_DECODE_CHUNK = 1 << 20


def read_resume_body(rfile, length: int) -> dict:
    """Stream a base64 ``/v1/resume`` JSON body off the socket, decoding the
    ``payload`` string incrementally so peak memory is ~1x the decoded
    payload — the old read-then-parse-then-decode path held wire bytes
    (4/3x) + the parsed str (4/3x) + the decoded bytes (1x) simultaneously,
    a ~3.7x peak on a multi-hundred-MB handoff. The payload value must be a
    contiguous base64 string with no JSON escapes, which is exactly what
    ``_request_doc`` and the fleet router emit."""
    skeleton = bytearray()  # the JSON doc with the payload value spliced out
    raw = bytearray()       # decoded payload (amortized growth, ~1x)
    b64_tail = b""          # undecoded remainder (4-char alignment carry)
    in_payload = False
    found = False
    remaining = length
    search_from = 0
    while remaining > 0:
        chunk = rfile.read(min(_DECODE_CHUNK, remaining))
        if not chunk:
            raise ValueError("resume body truncated mid-read")
        remaining -= len(chunk)
        while chunk:
            if not in_payload:
                skeleton += chunk
                chunk = b""
                if found:
                    continue
                m = _PAYLOAD_KEY_RE.search(skeleton, search_from)
                if m is None:
                    # the key marker may straddle the next chunk boundary:
                    # back the resume point up by the marker's width
                    search_from = max(0, len(skeleton) - 16)
                    continue
                found = True
                in_payload = True
                chunk = bytes(skeleton[m.end():])
                del skeleton[m.end():]  # keep the opening quote; value moves out
            else:
                end = chunk.find(b'"')
                data, chunk = (chunk, b"") if end < 0 else \
                    (chunk[:end], chunk[end:])  # chunk resumes AT the close quote
                if b64_tail:
                    data = b64_tail + data
                    b64_tail = b""
                if end < 0:
                    cut = len(data) - (len(data) & 3)
                    b64_tail = data[cut:]
                    data = data[:cut]
                else:
                    in_payload = False
                raw += base64.b64decode(data)  # binascii.Error IS a ValueError
    if in_payload or b64_tail:
        raise ValueError("resume body truncated inside the payload string")
    doc = json.loads(bytes(skeleton))
    if not isinstance(doc, dict):
        raise ValueError("resume body must be a JSON object")
    if not found:
        raise KeyError("payload")
    # hand the bytearray over as-is: a bytes() copy here would undo the whole
    # streaming exercise (1x decoded + 1x copy = the 2x peak again); the
    # scheduler treats the payload as immutable and nobody else holds it
    doc["payload"] = raw
    return doc


def parse_request_body(handler, resume: bool, max_bytes: Optional[int] = None) -> dict:
    """Read + validate a ``/v1/generate`` | ``/v1/resume`` JSON body from an
    http.server request handler — the single wire-format authority, shared by
    :class:`ServingServer` and the fleet router (whose contract is that a
    client cannot tell it from a single replica). Returns the parsed doc,
    with ``doc["payload"]`` decoded to bytes for resume. A resume POST with
    ``Content-Type: application/x-dstpu-handoff`` carries the raw frame as
    the whole body (zero-copy: no base64, no JSON buffer) with the
    generation params in the ``X-DSTPU-Params`` header; ``doc["_transport"]``
    records which wire form arrived. Raises ``ValueError``/``KeyError``/
    ``TypeError`` on malformed input (callers answer 400)."""
    if max_bytes is None:
        max_bytes = _MAX_RESUME_BODY_BYTES if resume else _MAX_BODY_BYTES
    length = int(handler.headers.get("Content-Length", 0))
    if not 0 < length <= max_bytes:
        raise ValueError(f"body length {length} out of bounds")
    if resume:
        ctype = (handler.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == HANDOFF_CONTENT_TYPE:
            doc = json.loads(handler.headers.get(PARAMS_HEADER) or "{}")
            if not isinstance(doc, dict):
                raise ValueError(f"{PARAMS_HEADER} must be a JSON object")
            doc["payload"] = handler.rfile.read(length)
            doc["_transport"] = "binary"
            return doc
        # fleet decode-role continuation, base64 compatibility form: the body
        # carries a peer engine's export_sequence payload instead of a prompt
        doc = read_resume_body(handler.rfile, length)
        doc["_transport"] = "base64"
        return doc
    doc = json.loads(handler.rfile.read(length))
    prompt = doc["prompt"]
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    return doc


def _request_doc(req: Request, raw_handoff: bool = False,
                 handoff_ref: Optional[str] = None) -> dict:
    """The final response document (JSON body, SSE ``done`` event): the
    reference's fields in its order."""
    doc = {
        "uid": req.uid,
        "handle": req.handle,
        "tokens": list(req.tokens),
        "n_tokens": len(req.tokens),
        "cached_tokens": req.cached_tokens,
        "decode_steps": req.decode_steps,
        "state": req.state.name,
        "finish_reason": req.finish_reason,
        "error": req.error,
        "ttft_s": req.ttft_s,
        "e2e_s": req.e2e_s,
        "trace_id": req.trace_id,
        "priority": req.priority,
        "tenant": req.tenant,
    }
    if req.cost is not None:
        # the per-request bill (telemetry active): device-seconds by phase,
        # priced token work, KV block-seconds by tier, wire bytes by channel,
        # and the cache/spec savings — same shape as the /v1/usage rollup rows
        doc["cost"] = req.cost.to_dict()
    if req.spec_drafted:
        # speculative decoding rode this request: drafted/accepted let a
        # client compute acceptance rate and tokens-per-step without
        # scraping /v1/stats; "drafter" is which drafter family served the
        # request (the last one used, under auto arbitration)
        doc["spec"] = {"drafted": req.spec_drafted,
                       "accepted": req.spec_accepted,
                       "drafter": req._spec_last_drafter or "prompt_lookup"}
    if req.degraded_mode:
        # brownout degradations applied to THIS request — never silent
        doc["degraded_mode"] = list(req.degraded_mode)
    if req.retry_after_s is not None:
        # shed disposition: the queue-drain-derived backoff rides the final
        # doc (and the SSE done/error event) so streaming clients see it too
        doc["retry_after_s"] = req.retry_after_s
    if req.handoff_payload is not None:
        # fleet prefill→decode handoff: the exported KV/generation state, for
        # POST /v1/resume on a decode-role peer. An in-process leg (fleet
        # LocalReplica) keeps the bytes raw; a client that negotiated the
        # binary transport gets a claim-once ref (GET /v1/handoff/<ref>
        # returns the raw frame — zero base64 tax); everyone else gets the
        # base64-in-JSON compatibility form.
        if handoff_ref is not None:
            doc["handoff_ref"] = handoff_ref
        else:
            doc["handoff"] = (req.handoff_payload if raw_handoff else
                              base64.b64encode(req.handoff_payload).decode())
    if req.park_payload is not None:
        # tiered KV parking: the v2 park frame, for the router's park store
        # (an in-process fleet leg keeps the bytes raw). A direct client can
        # hold it and rehydrate the next turn via /v1/resume with a prompt.
        doc["park"] = (req.park_payload if raw_handoff else
                       base64.b64encode(req.park_payload).decode())
    if req._rehydrate:
        # the returning-turn receipt: the cached turns' KV was imported (zero
        # prefill for them) from this tier
        doc["rehydrated"] = True
        doc["park_tier"] = req.kv_tier_source
    return doc


class ServingServer:
    """HTTP front-end over a :class:`ServingScheduler` (constructed outside so
    the same scheduler can also be driven programmatically)."""

    def __init__(self, scheduler: ServingScheduler,
                 host: Optional[str] = None, port: Optional[int] = None):
        self._scheduler = scheduler
        cfg: ServingConfig = scheduler._config
        self._host = host if host is not None else cfg.host
        self._port = port if port is not None else cfg.port
        self._server = None
        self._thread = None
        self._draining = threading.Event()
        # claim-once binary handoff returns: a client that negotiated
        # "X-DSTPU-Handoff-Transport: ref" gets a handoff_ref in the final
        # doc and fetches the raw frame from GET /v1/handoff/<ref> — the
        # frame never pays the base64 tax. Bounded so unclaimed refs (a
        # router that died between the done event and the claim) cannot
        # accumulate payload-sized garbage.
        self._handoff_store: dict = {}
        self._handoff_lock = threading.Lock()
        self._handoff_ids = itertools.count()

    def _stash_handoff(self, payload: bytes) -> str:
        with self._handoff_lock:
            ref = f"h{next(self._handoff_ids)}"
            self._handoff_store[ref] = payload
            while len(self._handoff_store) > 32:
                self._handoff_store.pop(next(iter(self._handoff_store)))
        return ref

    def _claim_handoff(self, ref: str) -> Optional[bytes]:
        with self._handoff_lock:
            return self._handoff_store.pop(ref, None)

    @property
    def scheduler(self) -> ServingScheduler:
        return self._scheduler

    @property
    def address(self):
        """(host, port) once started."""
        return self._server.server_address if self._server else None

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # ----------------------------------------------------------------- start --
    def start(self) -> "ServingServer":
        scheduler, draining = self._scheduler, self._draining
        outer = self
        cfg: ServingConfig = scheduler._config

        class Handler(BaseHTTPRequestHandler):

            def _send_bytes(self, code, payload, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", HANDOFF_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _send_json(self, code, doc, trace_id=None, retry_after=None):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if trace_id is not None:
                    self.send_header(TRACE_HEADER, trace_id)
                if retry_after is not None:
                    # drain-rate-derived backoff: well-behaved clients retry
                    # proportionally instead of hammering a saturated server
                    self.send_header("Retry-After", retry_after_header(retry_after))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/v1/stats":
                    self._send_json(200, scheduler.stats())
                elif path == "/v1/usage":
                    # cost attribution: ledger totals + per-tenant rollup +
                    # fair-share posture ({"enabled": false} w/o telemetry)
                    self._send_json(200, scheduler.usage())
                elif path.startswith("/v1/handoff/"):
                    # claim-once binary handoff fetch (the "ref" transport's
                    # second half): the raw frame, exactly once
                    payload = outer._claim_handoff(path.rsplit("/", 1)[1])
                    if payload is None:
                        self._send_json(404, {"error": "no such handoff ref "
                                                       "(already claimed?)"})
                    else:
                        self._send_bytes(200, payload)
                elif path == "/healthz":
                    # readiness-gated liveness: "starting" until the scheduler
                    # loop ticks (a supervisor registers a replica only on
                    # "ok" — see fleet/supervisor.py), "draining" on the way
                    # out; fleet probes treat anything but "ok" as
                    # not-dispatchable
                    if draining.is_set():
                        status = "draining"
                    else:
                        status = "ok" if scheduler.ready else "starting"
                    self._send_json(200, {"status": status})
                elif path == "/trace/export":
                    # fleet trace collection: drain this process's span ring
                    # for the router-side TraceCollector (since_us is in OUR
                    # clock; now_us in the reply lets the puller estimate the
                    # offset from its round-trip)
                    since_us = 0
                    query = self.path.partition("?")[2]
                    for part in query.split("&"):
                        if part.startswith("since_us="):
                            try:
                                since_us = int(part.split("=", 1)[1])
                            except ValueError:
                                pass
                    recorder = telemetry.get_span_recorder()
                    if recorder is None:
                        self._send_json(200, {"now_us": telemetry.now_us(),
                                              "pid": os.getpid(),
                                              "dropped": 0, "spans": []})
                    else:
                        self._send_json(200, recorder.export_since(since_us))
                else:
                    self._send_json(404, {"error": f"no route {path}"})

            def _upstream_trace(self):
                """(trace_id, parent_span_id) from the request headers — the
                fleet router's trace context, adopted so router → replica
                renders as one parented Perfetto track."""
                trace_id = self.headers.get(TRACE_HEADER) or None
                parent = self.headers.get(PARENT_SPAN_HEADER)
                try:
                    parent_span_id = int(parent) if parent else None
                except ValueError:
                    parent_span_id = None
                return trace_id, parent_span_id

            def _small_json_body(self, cap: int = 1 << 20) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= cap:
                    raise ValueError(f"body length {length} out of bounds")
                doc = json.loads(self.rfile.read(length))
                if not isinstance(doc, dict):
                    raise ValueError("body must be a JSON object")
                return doc

            def _steal(self):
                """Fleet work-stealing victim side: move the addressed
                request off this replica. An exported continuation goes out
                as the raw binary frame (zero-copy), with the count of
                already-streamed tokens in a header."""
                try:
                    doc = self._small_json_body()
                    handle = doc["handle"]
                    if not isinstance(handle, str):
                        raise ValueError("'handle' must be a string")
                except (KeyError, ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    out = scheduler.request_steal(handle)
                except (SchedulerStopped, TimeoutError) as e:
                    self._send_json(503, {"error": str(e)})
                    return
                if out["status"] == "exported":
                    self._send_bytes(200, out["payload"],
                                     headers=((STEAL_SENT_HEADER,
                                               str(out["sent"])),))
                else:
                    self._send_json(200, {"status": out["status"]})

            def _prefix_export(self):
                """Peer prefix-fetch donor side: the deepest cached KV run
                along the posted digest chain, as a raw binary frame."""
                try:
                    doc = self._small_json_body()
                    digests = [bytes.fromhex(d) for d in doc["digests"]]
                    min_blocks = int(doc.get("min_blocks") or 1)
                except (KeyError, ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    payload = scheduler.export_prefix(digests,
                                                      min_blocks=min_blocks,
                                                      timeout=2.0)
                except (SchedulerStopped, TimeoutError) as e:
                    self._send_json(503, {"error": str(e)})
                    return
                if payload is None:
                    self._send_json(404, {"error": f"no cached path at least "
                                                   f"{min_blocks} blocks deep"})
                else:
                    self._send_bytes(200, payload)

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                # steal + prefix export stay routable while draining: they
                # move state OUT of this replica, admitting nothing
                if path == "/v1/steal":
                    self._steal()
                    return
                if path == "/v1/prefix/export":
                    self._prefix_export()
                    return
                if path not in ("/v1/generate", "/v1/resume"):
                    self._send_json(404, {"error": f"no route {path}"})
                    return
                if draining.is_set():
                    self._send_json(503, {"error": "server is draining"},
                                    retry_after=scheduler.retry_after_s())
                    return
                trace_id, parent_span_id = self._upstream_trace()
                resume = path == "/v1/resume"
                try:
                    doc = parse_request_body(
                        self, resume=resume,
                        max_bytes=cfg.max_resume_body_bytes if resume else None)
                except (KeyError, ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    # wrongly-typed optional fields (string temperature, ...)
                    # raise here and fall through to the 400 below
                    common = dict(max_new_tokens=doc.get("max_new_tokens"),
                                  temperature=float(doc.get("temperature") or 0.0),
                                  eos_token_id=doc.get("eos_token_id"),
                                  deadline_s=doc.get("deadline_s"),
                                  seed=int(doc.get("seed") or 0),
                                  trace_id=trace_id,
                                  parent_span_id=parent_span_id,
                                  handoff=bool(doc.get("handoff")),
                                  park=bool(doc.get("park")),
                                  priority=request_priority(self, doc),
                                  drafter=doc.get("drafter"),
                                  tenant=request_tenant(self, doc))
                    if path == "/v1/resume":
                        # a resume body MAY carry a prompt: the rehydrate form
                        # (parked session returning with its next turn)
                        req = scheduler.submit_resume(doc["payload"],
                                                      prompt=doc.get("prompt"),
                                                      **common)
                    else:
                        req = scheduler.submit(doc["prompt"], **common)
                except AdmissionRejected as e:
                    # overload control said no before any engine work: the
                    # cheap rejection, with the drain-rate-derived backoff
                    self._send_json(429, {"error": str(e),
                                          "retry_after_s": e.retry_after_s},
                                    retry_after=e.retry_after_s)
                    return
                except QueueFullError as e:
                    self._send_json(429, {"error": str(e),
                                          "queue_depth": scheduler.queue_depth},
                                    retry_after=scheduler.retry_after_s())
                    return
                except SchedulerStopped as e:
                    self._send_json(503, {"error": str(e)},
                                    retry_after=scheduler.retry_after_s())
                    return
                except (ValueError, TypeError) as e:
                    # wrongly-typed optional fields (null temperature, string
                    # max_new_tokens, ...) are client errors, not handler crashes
                    self._send_json(400, {"error": str(e)})
                    return
                ref_mode = (self.headers.get(HANDOFF_TRANSPORT_HEADER)
                            or "").strip().lower() == "ref"
                if doc.get("stream"):
                    self._stream_sse(req, ref_mode=ref_mode)
                else:
                    req.wait()  # terminal by deadline/max_new_tokens/cancel
                    if req.shed_reason is not None or (
                            req.retry_after_s is not None and not req.tokens):
                        # shed (or deadline-expired) before any engine work:
                        # to the client this IS an admission rejection — 429
                        self._send_json(429, _request_doc(req),
                                        trace_id=req.trace_id,
                                        retry_after=req.retry_after_s)
                    else:
                        self._send_json(200, self._final_doc(req, ref_mode),
                                        trace_id=req.trace_id)

            def _final_doc(self, req, ref_mode):
                if ref_mode and req.handoff_payload is not None:
                    return _request_doc(
                        req, handoff_ref=outer._stash_handoff(req.handoff_payload))
                return _request_doc(req)

            def _stream_sse(self, req, ref_mode=False):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if req.trace_id is not None:
                    # the trace id is known at admission, so streaming clients
                    # get it up-front (it repeats in the final `done` event)
                    self.send_header(TRACE_HEADER, req.trace_id)
                # the steal handle goes out before the first token: the fleet
                # router must be able to address a request that is still
                # queued or mid-decode
                self.send_header(HANDLE_HEADER, req.handle)
                self.end_headers()
                try:
                    i = 0
                    while True:
                        try:
                            tok = req.stream.get(timeout=cfg.sse_keepalive_s)
                        except queue.Empty:
                            # no token yet (queue wait, long prefill): an SSE
                            # comment keeps the socket demonstrably alive, so
                            # a fleet router's read budget measures death,
                            # never load (SSE parsers ignore ':' lines)
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        if tok is None:  # stream closed and drained: terminal
                            break
                        self.wfile.write(
                            f"data: {json.dumps({'token': tok, 'index': i})}\n\n".encode())
                        self.wfile.flush()
                        i += 1
                    self.wfile.write(
                        f"data: {json.dumps({'done': True, **self._final_doc(req, ref_mode)})}\n\n".encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # client went away: cancel so the sequence's KV blocks
                    # return to the pool on the next scheduler tick
                    req.cancel()

            def log_message(self, fmt, *args):
                ...  # request logging must not spam the serving log

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dstpu-serving-http", daemon=True)
        self._thread.start()
        logger.info(f"serving: /v1/generate /v1/resume /v1/stats /v1/usage "
                    f"/healthz on {self.url}")
        return self

    # ------------------------------------------------------------------ stop --
    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop admitting (503), drain in-flight bounded by
        the drain timeout, then close the listener. Idempotent."""
        if self._server is None:
            return
        self._draining.set()
        self._scheduler.stop(drain=drain, timeout=timeout)
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        self._thread = None

    def __enter__(self):
        return self.start() if self._server is None else self

    def __exit__(self, *exc):
        self.stop(drain=False)
