"""Port parity: the fleet (router, replicas, manager) of deepspeed_tpu_torch
against deepspeed_tpu's, side by side over HTTP.

Each case builds the same fleet in both packages: the JAX replicas over the
JAX engine and the port's over the port's engine, from one set of weights
(the reference's tiny f32 Llama, carried across by ``models/convert.py``),
with explicit replica ids so rendezvous hashing and least-loaded ties pick
the same replica. Clients talk to the router's HTTP front end; in the
disaggregated and work-stealing cases the replicas are ``ServingServer``
upstreams too (``HttpReplica``: binary resume bodies, claim-once handoff
refs, ``POST /v1/steal``). Greedy tokens, leg attribution, the fleet stats'
deterministic counters and every decision must be equal. Handoff and park
frames must reach their importer byte for byte as their exporter wrote them,
with the reference's header (the KV checksum aside: each engine's KV is its
own f32 rounding, ``tests/test_torch_handoff.py``).

Timing-dependent paths are pinned, never raced: a replica's scheduler is
held by ``chip_smoke._FleetGate`` (its ``step`` only services control calls,
so a steal or a prefix export is answered while its batches wait), a death is a kill of a
gated replica, and a hedge fires against a replica that cannot answer.
Mirrors ``tests/unit/fleet/test_{router,disagg,data_motion,park,overload,
faults}.py``. Every HTTP client and thread wait has a timeout.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from chip_smoke import _FleetGate as _Gate
from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu import serving as jserving
from deepspeed_tpu.fleet import router as jrouter
from deepspeed_tpu.inference.v2.ragged import handoff as j_handoff
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch import serving as tserving
from deepspeed_tpu_torch.fleet import router as trouter
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged import handoff as t_handoff
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from tests.test_torch_serving import _jax_engine, _prompts, clear_jax_caches, fresh_telemetry, setup  # noqa: F401

WAIT_S = 60  # bound on every HTTP exchange and thread wait
BLOCK = 16
PKGS = ("jax", "torch")


def _ns(pkg, setup):
    """The package's fleet, serving and handoff modules and an engine
    factory over the shared weights."""
    if pkg == "jax":
        return types.SimpleNamespace(fleet=jfleet, serving=jserving, router=jrouter, handoff=j_handoff,
                                     engine=lambda **kw: _jax_engine(setup, **kw))
    _, _, cfg, params = setup

    def engine(num_blocks=64, block_size=BLOCK, **mgr_kw):
        mgr_kw.setdefault("max_context", 512)
        mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=num_blocks),
                                   **mgr_kw)
        return build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=BLOCK),
                            device="cpu")

    return types.SimpleNamespace(fleet=tfleet, serving=tserving, router=trouter, handoff=t_handoff, engine=engine)


class _Fleet:
    """One package's fleet: a manager over local replicas (or ServingServer
    upstreams) with ids ``<role>-<i>``, and a started HTTP router."""

    def __init__(self, ns, roles, upstream=False, serving=None, **config):
        self.ns = ns
        config.setdefault("probe_ttl_s", 0.0)
        config.setdefault("drain_timeout_s", 10.0)
        self.config = ns.fleet.FleetConfig(**config)
        serving = serving or {}
        self.manager = ns.fleet.ReplicaManager(engine_factory=ns.engine, config=self.config,
                                               serving_config=ns.serving.ServingConfig(**serving))
        self.servers, self.scheds = [], {}
        counts = {}
        for role in roles:
            rid = f"{role}-{counts.setdefault(role, 0)}"
            counts[role] += 1
            if upstream:
                sched = ns.serving.ServingScheduler(ns.engine(), ns.serving.ServingConfig(heartbeat_enabled=True,
                                                                                          **serving))
                server = ns.serving.ServingServer(sched).start()
                self.servers.append(server)
                self.manager.add_upstream(server.url, role=role, replica_id=rid)
            else:
                sched = self.manager.add_local(role=role, replica_id=rid).scheduler
            self.scheds[rid] = sched
        self.router = ns.fleet.FleetRouter(self.manager).start()
        self.url = self.router.url

    def replica(self, rid):
        return self.manager.get(rid)

    def close(self):
        self.router.stop(drain=False)
        self.manager.close()
        for server in self.servers:
            server.stop(drain=False)
            server.scheduler._engine.close()


@pytest.fixture
def fleets():
    made = []

    def make(ns, roles, **kw):
        fleet = _Fleet(ns, roles, **kw)
        made.append(fleet)
        return fleet

    yield make
    for fleet in made:
        fleet.close()


def _post(url, doc, headers=None):
    """(status, json doc, response headers) of one POST; SSE answers come back
    as their list of events."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=WAIT_S)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        raw = resp.read()
        status = resp.status if hasattr(resp, "status") else resp.code
        if resp.headers.get("Content-Type") == "text/event-stream":
            body = [json.loads(ln[len(b"data: "):]) for ln in raw.split(b"\n") if ln.startswith(b"data: ")]
        else:
            body = json.loads(raw)
        return status, body, dict(resp.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def _legs(doc):
    return [(leg["replica"], leg["kind"], leg["n_tokens"]) for leg in doc.get("legs", [])]


def _served(doc):
    """The deterministic face of a final document."""
    return dict(tokens=doc.get("tokens"), state=doc.get("state"), finish=doc.get("finish_reason"),
                legs=_legs(doc), cached=doc.get("cached_tokens"), degraded=doc.get("degraded"),
                stolen=doc.get("stolen"), parked=doc.get("parked"), error=doc.get("error"))


def _stats(fleet, counters=("requests", "degraded", "hedged", "hedge_wins", "deadline_cuts", "cache_route_hits",
                            "cache_route_misses", "steals", "steal_attempts")):
    doc = _get(fleet.url + "/v1/fleet/stats")
    rows = {r["id"]: (r["role"], r["state"], r["dispatches"], r["failures"], (r["breaker"] or {}).get("state"))
            for r in doc["replicas"]}
    router = {k: doc["router"][k] for k in counters}
    return dict(replicas=rows, roles=doc["roles"], router=router)


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


class _Frames:
    """Every handoff/park frame a scheduler exported, and every payload a
    scheduler was asked to resume."""

    def __init__(self):
        self.exported, self.resumed = [], []

    def watch(self, sched):
        inner_resume = sched.submit_resume

        def exporter(inner):
            def export(req):
                payload = inner(req)
                self.exported.append(bytes(payload))
                return payload
            return export

        def resume(payload, *args, **kw):
            self.resumed.append(bytes(payload))
            return inner_resume(payload, *args, **kw)

        sched._export_handoff = exporter(sched._export_handoff)
        sched._export_park = exporter(sched._export_park)
        sched.submit_resume = resume

    def headers(self, ns):
        out = []
        for frame in self.exported:
            header = ns.handoff.unpack(frame)[0]
            header.pop("kv_crc32")
            header.pop("uid")
            out.append(header)
        return out


def _side_by_side(setup, scenario):
    runs = {pkg: scenario(_ns(pkg, setup)) for pkg in PKGS}
    assert runs["torch"] == runs["jax"]
    return runs["torch"]


# ------------------------------------------------------------------- mixed --
def test_mixed_serving_equals_the_reference(setup, fleets):
    prompts = _prompts(40, (9, 23, 31))

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"))
        out = []
        status, doc, _ = _post(fleet.url + "/v1/generate", {"prompt": prompts[0], "max_new_tokens": 6})
        out.append((status, _served(doc), "handoff" in doc))
        status, events, hdr = _post(fleet.url + "/v1/generate",
                                    {"prompt": prompts[1], "max_new_tokens": 5, "stream": True})
        *toks, final = events
        out.append((status, [e["token"] for e in toks] == final["tokens"], [e["index"] for e in toks],
                    _served(final)))
        status, doc, _ = _post(fleet.url + "/v1/generate",
                               {"prompt": prompts[2], "max_new_tokens": 4, "temperature": 0.7, "seed": 11},
                               headers={"X-DSTPU-Session": "abc", "X-DSTPU-Priority": "batch"})
        out.append((status, _served(doc)))
        out.append(_post(fleet.url + "/v1/generate", {"prompt": []})[0])
        out.append(_post(fleet.url + "/v1/nope", {})[0])
        out.append(_post(fleet.url + "/v1/generate", {"prompt": [1, 2], "priority": "urgent"})[0])
        out.append(_get(fleet.url + "/healthz"))
        agg = _get(fleet.url + "/v1/stats")
        out.append((agg["replicas"], agg["queue_depth"], agg["counters"]["requests"]))
        out.append(_stats(fleet))
        return out

    run = _side_by_side(setup, scenario)
    assert run[0][1]["state"] == "DONE" and run[0][2] is False and run[1][1] is True
    assert run[-1]["router"]["requests"] == 3


# ---------------------------------------------------------------- affinity --
def test_affinity_equals_the_reference(setup, fleets):
    keys = [f"session-{i}" for i in range(8)]
    prompt = _prompts(41, (12, ))[0]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed", "mixed"))
        picks = []
        for k in keys:
            doc = _post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 2},
                        headers={"X-DSTPU-Session": k})[1]
            picks.append(_legs(doc)[0][0])
        ids = [r.id for r in fleet.manager.replicas()]
        predicted = [max(ids, key=lambda rid: ns.router._rendezvous_score(k, rid)) for k in keys]
        victim = picks[0]
        fleet.manager.drain(victim)
        after = [_legs(_post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 2, "session": k})[1])
                 [0][0] for k in keys]
        return picks, predicted, victim, after, _stats(fleet)

    picks, predicted, victim, after, _ = _side_by_side(setup, scenario)
    assert picks == predicted and len(set(picks)) > 1
    assert all(a == p for a, p in zip(after, picks) if p != victim) and victim not in after


# ----------------------------------------------------------------- failover --
def test_retry_on_503_and_backpressure_equal_the_reference(setup, fleets):
    prompt = _prompts(42, (10, ))[0]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"), breaker={"failure_threshold": 2})
        bad = fleet.replica("mixed-0")
        refusals = {"status": 503}

        def refuse(*args, **kw):
            raise ns.fleet.ReplicaUnavailable("injected refusal", status=refusals["status"])

        bad.dispatch = refuse
        out = [_served(_post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 3})[1])
               for _ in range(3)]  # the second refusal trips mixed-0's breaker
        out.append(_stats(fleet))
        refusals["status"] = 429  # mixed-0 is behind its open breaker: mixed-1 answers 429
        fleet.replica("mixed-1").dispatch = refuse
        status, doc, hdr = _post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 3})
        out.append((status, "Retry-After" in hdr, sorted(doc)))
        return out

    run = _side_by_side(setup, scenario)
    assert [leg[0] for leg in run[0]["legs"]] == ["mixed-1"]
    assert run[3]["replicas"]["mixed-0"][3:] == (2, "OPEN")
    assert run[4][0] == 429


# ------------------------------------------------------ disaggregated serving --
def test_disaggregated_serving_and_decode_death_equal_the_reference(setup, fleets):
    """One prefill and two decode upstreams: prefill + first token on the
    prefill replica, the frame claimed by ref and resumed as a raw body on a
    decode replica. Then decode-0 dies after 3 streamed decode tokens and the
    router re-dispatches the buffered frame to decode-1, skipping the tokens
    already sent: the client sees every token once."""
    prompts = _prompts(43, (17, 33, 40, 25))

    def scenario(ns):
        fleet = fleets(ns, ("prefill", "decode", "decode"), upstream=True, breaker={"failure_threshold": 1})
        frames = _Frames()
        for sched in fleet.scheds.values():
            frames.watch(sched)
        out = []
        for p in prompts[:3]:
            status, events, _ = _post(fleet.url + "/v1/generate", {"prompt": p, "max_new_tokens": 8, "stream": True})
            *toks, final = events
            out.append((status, [e["token"] for e in toks] == final["tokens"], _served(final)))
        gate = _Gate(fleet.scheds["decode-0"], after=3)
        result = {}
        client = threading.Thread(target=lambda: result.update(
            doc=_post(fleet.url + "/v1/generate", {"prompt": prompts[3], "max_new_tokens": 10, "stream": True})),
            daemon=True)
        client.start()
        assert gate.holding.wait(WAIT_S)
        fleet.scheds["decode-0"].kill("test kill")
        client.join(WAIT_S)
        status, events, _ = result["doc"]
        *toks, final = events
        out.append((status, [e["token"] for e in toks], _served(final)))
        out.append(_stats(fleet))
        out.append((len(frames.exported), frames.resumed == frames.exported + frames.exported[-1:],
                    frames.headers(ns)))
        return out

    run = _side_by_side(setup, scenario)
    for status, consistent, doc in run[:3]:
        assert status == 200 and consistent and [k for _, k, _ in doc["legs"]] == ["prefill", "decode"]
        assert len(doc["tokens"]) == 8
    status, streamed, final = run[3]
    assert streamed == final["tokens"] and len(streamed) == 10
    assert [leg[:2] for leg in final["legs"]] == [("prefill-0", "prefill"), ("decode-1", "decode")]
    assert run[4]["replicas"]["decode-0"][4] == "OPEN"
    assert run[5][0] == 4 and run[5][1]  # every frame reached its importer byte for byte


# ----------------------------------------------------------- work stealing --
def test_steals_queued_and_exported_equal_the_reference(setup, fleets):
    """Two mixed upstreams; mixed-0 is hot (gated). A request still queued on
    it is stolen back and re-granted from scratch on mixed-1; a request that
    has its first token (held off the stream) is exported mid-decode over
    ``POST /v1/steal`` and resumed on mixed-1."""
    prompts = _prompts(44, (14, 21))

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"), upstream=True,
                       steal={"enabled": True, "wait_budget_s": 0.05, "load_ratio": 1.5})
        out = []
        for p, gate_kw in zip(prompts, (dict(after=0), dict(after=1, hold_stream=True))):
            gate = _Gate(fleet.scheds["mixed-0"], **gate_kw)
            status, doc, _ = _post(fleet.url + "/v1/generate", {"prompt": p, "max_new_tokens": 6})
            gate.open.set()
            out.append((status, _served(doc)))
        out.append(_stats(fleet))
        out.append([s.stats()["counters"]["steals"] for s in fleet.scheds.values()])
        return out

    run = _side_by_side(setup, scenario)
    (s1, queued), (s2, exported), stats, steals = run
    assert s1 == s2 == 200 and queued["stolen"] and exported["stolen"]
    assert [k for _, k, _ in queued["legs"]] == ["steal-victim", "steal"] and queued["legs"][0][2] == 0
    assert exported["legs"][0][2] == 1 and len(exported["tokens"]) == 6
    assert stats["router"]["steals"] == stats["router"]["steal_attempts"] == 2 and steals == [2, 0]


# ------------------------------------------------------------ park/rehydrate --
def test_park_and_rehydrate_equal_the_reference(setup, fleets):
    prompt = _prompts(45, (20, ))[0]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"), park={"enabled": True})
        frames = _Frames()
        for sched in fleet.scheds.values():
            frames.watch(sched)
        hdr = {"X-DSTPU-Session": "chat-1"}
        out = []
        first = _post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 5}, headers=hdr)[1]
        turn2 = prompt + first["tokens"] + [3, 1, 4, 1]
        second = _post(fleet.url + "/v1/generate", {"prompt": turn2, "max_new_tokens": 5}, headers=hdr)[1]
        diverged = _post(fleet.url + "/v1/generate", {"prompt": [7] + turn2, "max_new_tokens": 3}, headers=hdr)[1]
        third = _post(fleet.url + "/v1/generate", {"prompt": [7] + turn2 + diverged["tokens"] + [2],
                                                   "max_new_tokens": 3}, headers=hdr)[1]
        fleet.router.set_faults(ns.fleet.FaultConfig(enabled=True, seed=1, park_store_corrupt_p=1.0))
        fourth = _post(fleet.url + "/v1/generate", {"prompt": [7] + turn2 + diverged["tokens"] + [2]
                                                    + third["tokens"] + [9], "max_new_tokens": 3}, headers=hdr)[1]
        for doc in (first, second, diverged, third, fourth):
            out.append(_served(doc))
        park = _get(fleet.url + "/v1/fleet/stats")["router"]["park"]
        park.pop("inventory")
        # the banked bytes are the last frame's; its header holds the KV
        # checksum in decimal, whose width differs between the packages
        park["bytes"] = park["bytes"] == len(frames.exported[-1])
        out.append(park)
        # the rehydrate legs imported the very frames the router banked
        out.append((len(frames.exported), frames.resumed[0] == frames.exported[0],
                    frames.resumed[1] == frames.exported[2], frames.headers(ns)))
        return out

    run = _side_by_side(setup, scenario)
    first, second, diverged, third, fourth, park, frames = run
    assert first["parked"] and [k for _, k, _ in second["legs"]] == ["rehydrate"]
    assert second["cached"] == len(prompt) + 5 - 1 and [k for _, k, _ in diverged["legs"]] == ["serve"]
    assert [k for _, k, _ in third["legs"]] == ["rehydrate"] and [k for _, k, _ in fourth["legs"]] == ["serve"]
    assert park["rehydrate_hits"] == 3 and park["rehydrate_misses"] == 1 and park["corrupt_rejects"] == 1
    assert frames[1] and frames[2]


# ------------------------------------------------------- peer prefix fetch --
def _pin_key(router_mod, target, other):
    for i in range(1000):
        k = f"pin{i}"
        if router_mod._rendezvous_score(k, target) > router_mod._rendezvous_score(k, other):
            return k
    raise AssertionError("rendezvous never favoured the target")


def test_peer_prefix_fetch_equals_the_reference(setup, fleets):
    """Replica A serves a 3-block shared prompt; a turn on the same prefix
    pinned to B imports those blocks from A (3 x 16 prefill tokens avoided,
    exactly); then a frame corrupted by the fault injector is refused at
    import and the request is served cold."""
    rng = np.random.default_rng(46)
    prefixes = [rng.integers(0, 256, 3 * BLOCK).tolist() for _ in range(2)]
    suffixes = [rng.integers(0, 256, 6).tolist() for _ in range(4)]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"), serving={"prefix_cache": ns.serving.PrefixCacheConfig(enabled=True)})
        out = []
        for i, prefix in enumerate(prefixes):
            if i == 1:
                fleet.router.set_faults(ns.fleet.FaultConfig(enabled=True, seed=5, peer_fetch_corrupt_p=1.0))
            warm = _post(fleet.url + "/v1/generate", {"prompt": prefix + suffixes[2 * i], "max_new_tokens": 2})[1]
            holder = _legs(warm)[0][0]
            cold = "mixed-1" if holder == "mixed-0" else "mixed-0"
            doc = _post(fleet.url + "/v1/generate", {"prompt": prefix + suffixes[2 * i + 1], "max_new_tokens": 4,
                                                     "routing": "hash",
                                                     "session": _pin_key(ns.router, cold, holder)})[1]
            counters = fleet.scheds[cold].stats()["counters"]
            out.append((_served(warm), _served(doc),
                        {k: counters[k] for k in ("peer_fetch_hits", "peer_fetch_blocks", "peer_fetch_rejects",
                                                  "prefix_hits", "prefix_tokens_saved")}))
        out.append(_stats(fleet))
        return out

    run = _side_by_side(setup, scenario)
    (_, fetched, c1), (_, corrupt, c2), _ = run
    assert fetched["cached"] == 3 * BLOCK and c1["peer_fetch_hits"] == 1 and c1["peer_fetch_blocks"] == 3
    assert corrupt["cached"] == 0 and corrupt["state"] == "DONE" and c2["peer_fetch_rejects"] == 1


# ----------------------------------------------------------------- hedging --
def test_hedging_equals_the_reference(setup, fleets):
    """mixed-0 cannot answer (gated): the hedge budget expires, the request
    is dispatched again on mixed-1, which wins; the loser is cancelled."""
    prompt = _prompts(47, (15, ))[0]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"), hedge={"enabled": True, "ttft_budget_s": 0.05})
        gate = _Gate(fleet.scheds["mixed-0"])
        doc = _post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 5})[1]
        gate.open.set()
        _wait(lambda: fleet.scheds["mixed-0"].n_active == 0 and fleet.scheds["mixed-0"].queue_depth == 0,
              "the hedge loser to be cancelled")
        return _served(doc), _stats(fleet), fleet.scheds["mixed-0"].stats()["counters"]["cancelled"]

    doc, stats, cancelled = _side_by_side(setup, scenario)
    assert [r for r, _, _ in doc["legs"]] == ["mixed-1"] and doc["legs"][0][1] == "hedge"
    assert stats["router"]["hedged"] == stats["router"]["hedge_wins"] == 1 and cancelled == 1


# ------------------------------------------------------------ global queue --
def test_global_queue_equals_the_reference(setup, fleets):
    """One replica, one slot: queued requests are granted interactive before
    batch (the batch request's deadline is the earliest), earliest deadline
    first within a class; a full queue answers 429, and a deadline
    that passes in the queue answers 429 with nothing dispatched."""
    prompts = _prompts(48, (8, 9, 10, 11, 12))

    def scenario(ns):
        fleet = fleets(ns, ("mixed", ), global_queue={"max_inflight_per_replica": 1, "capacity": 3})
        sched = fleet.scheds["mixed-0"]
        gate = _Gate(sched)
        order = []
        inner = sched.submit
        sched.submit = lambda prompt, **kw: (order.append(len(prompt)), inner(prompt, **kw))[1]
        results, threads = {}, []

        def send(key, body):
            t = threading.Thread(target=lambda: results.update({key: _post(fleet.url + "/v1/generate", body)}),
                                 daemon=True)
            t.start()
            threads.append(t)
            _wait(lambda: len(order) + fleet.router._gq.depth == len(threads), f"{key} to queue")

        send("first", {"prompt": prompts[0], "max_new_tokens": 2})
        send("batch", {"prompt": prompts[1], "max_new_tokens": 2, "priority": "batch", "deadline_s": 30.0})
        send("late", {"prompt": prompts[2], "max_new_tokens": 2, "deadline_s": 50.0})
        expired = _post(fleet.url + "/v1/generate", {"prompt": prompts[4], "max_new_tokens": 2, "deadline_s": 0.01})
        send("early", {"prompt": prompts[3], "max_new_tokens": 2, "deadline_s": 40.0})
        full = _post(fleet.url + "/v1/generate", {"prompt": prompts[4], "max_new_tokens": 2})
        gate.open.set()
        for t in threads:
            t.join(WAIT_S)
        gq = fleet.router._gq.describe()
        gq.pop("retry_after_s")
        return (order, {k: (v[0], _served(v[1])) for k, v in results.items()}, (full[0], "Retry-After" in full[2]),
                (expired[0], "Retry-After" in expired[2]), gq)

    order, results, full, expired, gq = _side_by_side(setup, scenario)
    assert order == [8, 11, 10, 9] and all(s == 200 for s, _ in results.values())
    assert full == expired == (429, True) and gq["grants"] == 4 and gq["expired"] == 1


# ------------------------------------------------------------------- drain --
def test_drain_equals_the_reference(setup, fleets):
    prompt = _prompts(49, (9, ))[0]

    def scenario(ns):
        fleet = fleets(ns, ("mixed", "mixed"))
        gate = _Gate(fleet.scheds["mixed-0"], after=2)
        result = {}
        client = threading.Thread(target=lambda: result.update(
            doc=_post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 5})), daemon=True)
        client.start()
        assert gate.holding.wait(WAIT_S)
        drainer = threading.Thread(target=fleet.router.drain, kwargs={"timeout": WAIT_S}, daemon=True)
        drainer.start()
        _wait(lambda: fleet.router._draining.is_set(), "the router to drain")
        refused = _post(fleet.url + "/v1/generate", {"prompt": prompt, "max_new_tokens": 2})
        health = _get(fleet.url + "/healthz")
        gate.open.set()  # the in-flight request finishes inside the drain budget
        drainer.join(WAIT_S)
        client.join(WAIT_S)
        return (refused[0], refused[1], health, result["doc"][0], _served(result["doc"][1]),
                [r.state.name for r in fleet.manager.replicas()])

    refused, body, health, status, doc, states = _side_by_side(setup, scenario)
    assert refused == 503 and health == {"status": "draining"} and status == 200
    assert doc["state"] == "DONE" and len(doc["tokens"]) == 5 and states == ["DOWN", "DOWN"]
