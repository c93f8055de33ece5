"""Port parity: the fleet's engine-free pieces in deepspeed_tpu_torch against
deepspeed_tpu.

Every case runs the same script on both packages and holds the port to the
reference exactly: decisions, schedules, orders, counters and exposition
names are equal, never close. Clocks are stand-ins advanced by hand (the
breaker's ``clock``, the park store's and the collector's module clocks), so
no case depends on wall time.

- ``elasticity.compute_elastic_config`` over a grid of configs, errors too;
- the fleet config dataclasses against the pydantic models: defaults, every
  bound and literal rejected, nested blocks from dicts, ``DSTPU_FAULTS``;
- ``backoff_delay`` and the circuit breaker's state sequence;
- the ``FaultInjector``'s schedule, fault shapes and report for each seed;
- rendezvous scores; ``GlobalQueue`` grant order, expiry and capacity;
- ``ParkStore`` LRU, TTL, byte budget and refusals; ``FleetMetrics`` names;
- ``TraceCollector`` merges, dedupe and clock correction;
- ``FleetAutoscaler`` decisions from a scripted stream of probe signals.
"""

import dataclasses
import json
import struct
import threading
import time
import typing
import zlib

import numpy as np
import pytest

from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.elasticity import elasticity as jel
from deepspeed_tpu.fleet import breaker as jbreaker
from deepspeed_tpu.fleet import config as jconfig
from deepspeed_tpu.fleet import faults as jfaults
from deepspeed_tpu.fleet import global_queue as jgq
from deepspeed_tpu.fleet import metrics as jmetrics
from deepspeed_tpu.fleet import park_store as jpark
from deepspeed_tpu.fleet import policy as jpolicy
from deepspeed_tpu.fleet import router as jrouter
from deepspeed_tpu.inference.v2.ragged import handoff as j_handoff
from deepspeed_tpu.telemetry import collector as jcollector
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.elasticity import elasticity as tel
from deepspeed_tpu_torch.fleet import breaker as tbreaker
from deepspeed_tpu_torch.fleet import config as tconfig
from deepspeed_tpu_torch.fleet import faults as tfaults
from deepspeed_tpu_torch.fleet import global_queue as tgq
from deepspeed_tpu_torch.fleet import metrics as tmetrics
from deepspeed_tpu_torch.fleet import park_store as tpark
from deepspeed_tpu_torch.fleet import policy as tpolicy
from deepspeed_tpu_torch.fleet import router as trouter
from deepspeed_tpu_torch.telemetry import collector as tcollector

WAIT_S = 30  # bound on every thread join and queue wait


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tel_ in (jtel, ttel):
        tel_.shutdown()
        tel_.state.registry = None
    yield
    for tel_ in (jtel, ttel):
        tel_.shutdown()
        tel_.state.registry = None


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args, **kw), None
    except Exception as e:  # the reference's errors are part of its contract
        return None, (type(e).__name__, str(e))


# ------------------------------------------------------------- elasticity --
ELASTIC_CASES = [
    dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6], min_gpus=1, max_gpus=10000),
    dict(max_train_batch_size=1000, micro_batch_sizes=[1, 2, 3], min_gpus=2, max_gpus=64),
    dict(max_train_batch_size=512, micro_batch_sizes=[8], min_gpus=1, max_gpus=32, prefer_larger_batch_size=False),
    dict(max_train_batch_size=96, micro_batch_sizes=[3, 5], min_gpus=1, max_gpus=16),
    dict(max_train_batch_size=10000, micro_batch_sizes=[8, 12, 16, 17], min_gpus=32, max_gpus=1500),
    dict(max_train_batch_size=256, micro_batch_sizes=[2, 4], version=0.2, num_gpus_per_node=8, min_gpus=8,
         max_gpus=64),
    dict(max_train_batch_size=1024, micro_batch_sizes=[4, 8], version=0.2, num_gpus_per_node=4,
         model_parallel_size=2, min_gpus=4, max_gpus=128),
    dict(max_train_batch_size=64, micro_batch_sizes=[128]),  # micro larger than the max
    dict(max_train_batch_size=64, micro_batch_sizes=[0]),  # not a positive int
    dict(max_train_batch_size=64, micro_batch_sizes=[4], version=0.3),
    dict(max_train_batch_size=64, micro_batch_sizes=[4], min_gpus=8, max_gpus=2),
    dict(micro_batch_sizes=[4]),
    dict(max_train_batch_size=256, micro_batch_sizes=[2, 4], version=0.2, num_gpus_per_node=6,
         model_parallel_size=4),
]


@pytest.mark.parametrize("case", range(len(ELASTIC_CASES)))
def test_compute_elastic_config_equals_the_reference(case):
    block = dict(ELASTIC_CASES[case], enabled=True)
    for world in (0, 1, 4, 8, 12, 16, 24, 64):
        for micro in (False, True):
            got = _outcome(tel.compute_elastic_config, {"elasticity": block}, world_size=world,
                           return_microbatch=micro)
            want = _outcome(jel.compute_elastic_config, {"elasticity": block}, world_size=world,
                            return_microbatch=micro)
            assert got == want, (block, world, micro)
    assert tel.elasticity_enabled({"elasticity": block}) is jel.elasticity_enabled({"elasticity": block})


# ---------------------------------------------------------------- configs --
BLOCKS = ("GlobalQueueConfig", "HedgeConfig", "CacheRouteConfig", "StealConfig", "ParkConfig", "AutoscaleConfig",
          "SupervisorConfig", "FleetConfig")


def _block(module, name):
    return getattr(module, name, None) or getattr({"BreakerConfig": jbreaker, "FaultConfig": jfaults}[name]
                                                  if module is jconfig else
                                                  {"BreakerConfig": tbreaker, "FaultConfig": tfaults}[name], name)


def _dump(cfg):
    return cfg.model_dump() if hasattr(cfg, "model_dump") else dataclasses.asdict(cfg)


def _bad_values(field, typ):
    """Values the field's bounds or literal must reject."""
    out = []
    step = 1 if isinstance(field.default, int) and not isinstance(field.default, bool) else 0.5
    for key, delta in (("gt", 0), ("ge", -step), ("lt", 0), ("le", step)):
        bound = field.metadata.get(key)
        if bound is not None:
            out.append(bound + delta)
    if typing.get_origin(typ) is typing.Literal:
        out.append("no-such-value")
    return out


@pytest.mark.parametrize("name", BLOCKS + ("BreakerConfig", "FaultConfig"))
def test_config_defaults_and_rejections_equal_the_reference(name):
    jcls, tcls = _block(jconfig, name), _block(tconfig, name)
    assert _dump(tcls()) == _dump(jcls())
    assert [f.name for f in dataclasses.fields(tcls)] == list(jcls.model_fields)
    hints = typing.get_type_hints(tcls)
    checked = 0
    for f in dataclasses.fields(tcls):
        for bad in _bad_values(f, hints[f.name]):
            with pytest.raises(ValueError):
                jcls(**{f.name: bad})
            with pytest.raises(ValueError):
                tcls(**{f.name: bad})
            checked += 1
    assert checked > 0


def test_fleet_config_nested_blocks_and_role_tuples():
    doc = {"probe_ttl_s": 0.0, "hedge": {"enabled": True, "ttft_budget_s": 0.1},
           "breaker": {"failure_threshold": 1}, "faults": {"enabled": True, "seed": 3, "http_5xx_p": 0.5},
           "park": {"enabled": True, "max_bytes": 4096}, "prefix_cache": {"enabled": True},
           "prefix_cache_roles": ["prefill"], "speculative": {"enabled": True, "max_draft_tokens": 2},
           "overload": {"admission_control": False}, "kv_transport": "base64"}
    got, want = tconfig.FleetConfig.from_dict(doc), jconfig.FleetConfig(**doc)
    assert isinstance(got.hedge, tconfig.HedgeConfig) and isinstance(got.faults, tfaults.FaultConfig)
    assert got.prefix_cache_roles == ("prefill", )
    assert {k: v for k, v in _dump(got).items() if k not in ("prefix_cache", "speculative", "overload")} == \
        {k: v for k, v in _dump(want).items() if k not in ("prefix_cache", "speculative", "overload")}
    for key in ("prefix_cache", "speculative", "overload"):
        assert {k: v for k, v in _dump(getattr(got, key)).items() if k in doc[key]} == doc[key]
    for bad in ({"prefix_cache_roles": ["router"]}, {"kv_transport": "carrier-pigeon"},
                {"hedge": {"deadline_frac": 0}}, {"breaker": {"failure_threshold": 0}}):
        with pytest.raises(ValueError):
            jconfig.FleetConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.FleetConfig.from_dict(bad)
    env = json.dumps({"enabled": True, "seed": 7, "replica_kill_p": 0.02})
    assert _dump(tfaults.config_from_env(env)) == _dump(jfaults.config_from_env(env))
    assert tfaults.config_from_env("") is None and tfaults.injector_from_env('{"allow_remote": true}') is None
    with pytest.raises(ValueError):
        tfaults.config_from_env("{not json")


# ----------------------------------------------------------------- breaker --
def test_backoff_delay_equals_the_reference():
    rng = np.random.default_rng(0)
    for attempt in range(-1, 12):
        for base, cap, jitter, mult in ((0.02, 0.5, 0.25, 2.0), (0.5, 30.0, 0.1, 3.0), (1.0, 1.0, 0.0, 1.0)):
            u = float(rng.random())
            for draw in (None, u):
                assert tbreaker.backoff_delay(attempt, base, cap, jitter, draw, mult) == \
                    jbreaker.backoff_delay(attempt, base, cap, jitter, draw, mult)


BREAKER_SCRIPT = ["fail", "fail", "allow", "fail", "allow", "tick:1.0", "allow", "tick:1.5", "state", "try",
                  "try", "fail", "state", "tick:2.0", "try", "tick:2.5", "try", "release", "try", "ok", "state",
                  "fail", "probe_ok", "fail", "fail", "state", "tick:2.0", "probe_ok", "state", "fail", "fail",
                  "fail", "probe_fail", "tick:100", "allow", "try", "ok", "describe"]


def _run_breaker(mod, config_kw):
    clock = [0.0]
    seen = []
    b = mod.CircuitBreaker(mod.BreakerConfig(**config_kw), clock=lambda: clock[0],
                           on_transition=lambda br, old, new: seen.append((old.name, new.name)))
    out = []
    for op in BREAKER_SCRIPT:
        if op.startswith("tick:"):
            clock[0] += float(op[5:])
            continue
        out.append({"fail": lambda: b.record_failure(), "ok": lambda: b.record_success(),
                    "allow": b.allow, "try": b.try_acquire, "release": b.release,
                    "probe_ok": b.record_probe_success, "probe_fail": lambda: b.record_failure(trial=False),
                    "state": lambda: b.state.name, "describe": b.describe}[op]())
    return out, seen


@pytest.mark.parametrize("config_kw", [{}, dict(failure_threshold=1, open_cooldown_s=0.5, cooldown_multiplier=3.0,
                                                max_cooldown_s=4.0, half_open_max_probes=2),
                                       dict(enabled=False)], ids=["default", "tight", "disabled"])
def test_breaker_state_sequence_on_a_fake_clock_equals_the_reference(config_kw):
    assert _run_breaker(tbreaker, config_kw) == _run_breaker(jbreaker, config_kw)


# ------------------------------------------------------------------ faults --
def _frame(n_tokens=32, version=1, extra=None):
    kv = np.arange(2 * 1 * 2 * 16 * 1 * 4, dtype=np.float32).reshape((2, 1, 2, 16, 1, 4))
    raw = kv.tobytes()
    header = {"version": version, "uid": 7, "seen_tokens": n_tokens, "tokens": list(range(n_tokens)),
              "extra": extra or {},
              "cache": {"block_size": 16, "num_layers": 1, "kv_heads": 1, "head_dim": 4, "dtype": "float32"},
              "kv": {"shape": list(kv.shape), "dtype": "float32"}, "kv_crc32": zlib.crc32(raw) & 0xFFFFFFFF}
    hdr = json.dumps(header).encode()
    return j_handoff.MAGIC + struct.pack("<I", len(hdr)) + hdr + raw


def _fault_run(mod, seed):
    cfg = mod.FaultConfig(enabled=True, seed=seed, dispatch_delay_p=0.3, connect_reset_p=0.2, http_5xx_p=0.1,
                          http_5xx_burst=3, stream_truncate_p=0.4, handoff_corrupt_p=0.5, replica_kill_p=0.05,
                          peer_fetch_corrupt_p=0.5, steal_race_p=0.5, park_store_corrupt_p=0.5, demote_race_p=0.3,
                          decode_stall_p=0.2, decode_stall_replica="r1", overload_burst_p=0.1)
    inj = mod.FaultInjector(cfg)
    out = {p: [inj.schedule(p, 40, scope) for scope in (None, "r0", "r1")] for p in mod.POINTS}
    out["fired"] = [(p, s, inj.fire(p, s)) for p in mod.POINTS for s in ("r0", "r1", None) for _ in range(5)]
    out["shapes"] = [(inj.delay_s(n, "r0"), inj.stall_s(n, "r1"), inj.truncate_after(n, "r0"),
                      inj.stalls_replica("r0"), inj.stalls_replica("r1")) for n in range(8)]
    frame = _frame()
    out["corrupt"] = [inj.corrupt(frame, n, s, point=p) for n in range(6) for s in ("r0", None)
                      for p in ("handoff_corrupt", "peer_fetch_corrupt")]
    out["report"] = inj.report()
    with pytest.raises(ValueError) as err:
        inj.would_fire("no_such_point", 0)
    out["unknown"] = str(err.value).split(" (know")[0]
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_fault_injector_schedule_and_shapes_equal_the_reference(seed):
    got, want = _fault_run(tfaults, seed), _fault_run(jfaults, seed)
    assert got == want
    # every corrupted frame is refused at unpack, the port's as the reference's
    for bad in got["corrupt"]:
        with pytest.raises(ValueError):
            j_handoff.unpack(bad)
        from deepspeed_tpu_torch.inference.v2.ragged import handoff as t_handoff
        with pytest.raises(ValueError):
            t_handoff.unpack(bad)


def test_rendezvous_scores_equal_the_reference():
    keys = [f"session-{i}" for i in range(50)] + ["", "ü-ключ", "x" * 300]
    ids = [f"{role}-{i}" for role in ("mixed", "prefill", "decode") for i in range(5)]
    for k in keys:
        assert [trouter._rendezvous_score(k, r) for r in ids] == [jrouter._rendezvous_score(k, r) for r in ids]


# ------------------------------------------------------------- global queue --
class _Rep:

    def __init__(self, rid, load=0):
        self.id, self.load = rid, load


def _pick(candidates, session_key, pool=None, deadline=None, hint=None):
    return min(candidates, key=lambda r: (r.load, r.id))


def _queue_run(mod):
    reps = [_Rep("a"), _Rep("b", load=1)]
    gq = mod.GlobalQueue(max_inflight=1, capacity=4, pick=_pick)
    events = []
    first = [gq.acquire(lambda: reps, priority="interactive", timeout_s=WAIT_S).id,
             gq.acquire(lambda: reps, priority="interactive", timeout_s=WAIT_S).id]
    # both slots held: the next four queue, and grant in (priority, deadline,
    # arrival) order as slots free
    order = []
    lock = threading.Lock()

    def waiter(tag, **kw):
        try:
            r = gq.acquire(lambda: reps, timeout_s=WAIT_S, **kw)
            with lock:
                order.append((tag, r.id))
        except Exception as e:
            with lock:
                order.append((tag, type(e).__name__))

    specs = [("batch", dict(priority="batch")), ("late", dict(priority="interactive", deadline_s=25.0)),
             ("plain", dict(priority="interactive")), ("early", dict(priority="interactive", deadline_s=20.0))]
    threads = []
    for tag, kw in specs:
        t = threading.Thread(target=waiter, args=(tag, ), kwargs=kw, daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + WAIT_S
        while gq.depth < len(threads):
            assert time.monotonic() < deadline
            time.sleep(0.001)
    events.append(("full", _outcome(gq.acquire, lambda: reps, timeout_s=WAIT_S)[1][0]))
    for i in range(len(specs)):
        held = [rid for rid in ("a", "b") if gq.slots_in_use(rid)]
        with lock:
            n = len(order)
        gq.release(held[0] if i % 2 == 0 else held[-1])
        deadline = time.monotonic() + WAIT_S
        while True:
            with lock:
                if len(order) > n:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
    for t in threads:
        t.join(WAIT_S)
    events.append(("phantoms", gq.inject_phantoms(3, hold_s=0.0), gq.depth))
    # a phantom is never granted and expires at the next pump; a deadline'd
    # entry behind full slots expires loudly
    expired = _outcome(gq.acquire, lambda: reps, deadline_s=0.05, timeout_s=WAIT_S)[1][0]
    events.append(("expired", expired, gq.depth))
    doc = gq.describe()
    doc.pop("retry_after_s")
    return first, order, events, doc


def test_global_queue_order_expiry_and_full_equal_the_reference():
    got, want = _queue_run(tgq), _queue_run(jgq)
    assert got == want
    assert [tag for tag, _ in got[1]] == ["early", "late", "plain", "batch"]


# ----------------------------------------------------------------- park store --
class _Clock:

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _park_run(mod, cfg_mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    tier = {"tier": {"v": 1, "source": "host"}}
    frames = {n: _frame(n_tokens=n, version=2, extra=tier) for n in (20, 24, 28, 32)}
    size = len(frames[20])
    store = mod.ParkStore(cfg_mod.ParkConfig(enabled=True, max_sessions=3, max_bytes=3 * size + 10, ttl_s=50.0))
    log = []
    for key, n in (("a", 20), ("b", 24), ("c", 28)):
        log.append(store.put(key, frames[n], replica_id="r0"))
        clock.t += 1.0
    log.append(store.put("bad", frames[20][:-3]))  # truncated: refused at validation
    log.append(store.put("v1", _frame(n_tokens=20)))  # not a park frame
    hit = store.match("a", list(range(20)) + [5, 6])  # touches a: b is now the coldest
    log.append(hit is not None and (hit.tokens, hit.seen_tokens, hit.tier_source, hit.replica_id))
    log.append(store.put("d", frames[32]))  # over both caps: b drops
    log.append(sorted(s["session"] for s in store.stats()["inventory"]))
    log.append(store.match("c", list(range(28))) is None)  # not longer than the history: diverged
    log.append(store.match("zzz", [1, 2, 3]) is None)  # never parked: not a miss
    clock.t += 60.0
    log.append(store.match("d", list(range(40))) is None)  # expired
    store.reject("a")
    store.drop("nothing")
    log.append(len(store))
    stats = store.stats()
    for s in stats["inventory"]:
        s.pop("age_s")
    return log, stats


def test_park_store_lru_expiry_and_budget_equal_the_reference(monkeypatch):
    got = _park_run(tpark, tconfig, monkeypatch)
    want = _park_run(jpark, jconfig, monkeypatch)
    assert got == want
    assert got[1]["evictions"] >= 1 and got[1]["corrupt_rejects"] == 3


# ------------------------------------------------------------------- metrics --
def test_fleet_metrics_exposition_equals_the_reference():
    outs = []
    for tel_, metrics_mod in ((jtel, jmetrics), (ttel, tmetrics)):
        assert metrics_mod.FleetMetrics.maybe_create() is None  # no session: nothing registered
        session = tel_.configure({"enabled": True})
        m = metrics_mod.FleetMetrics.maybe_create()
        m.requests.inc(3)
        m.handoff_bytes.observe(524288)
        m.global_queue_depth.set(2)
        outs.append(tel_.get_registry().render_prometheus())
        session.close()
    assert outs[1] == outs[0]
    assert outs[0].count("# TYPE fleet_") == 46


# ----------------------------------------------------------------- collector --
class _SpanReplica:

    def __init__(self, rid, docs, shared=None):
        self.id, self._docs, self.span_recorder = rid, list(docs), shared
        self.calls = []

    def collect_spans(self, since_us=0):
        self.calls.append(since_us)
        if not self._docs:
            raise ConnectionError("gone")
        return self._docs.pop(0)


def _span(name, ts, trace="t1", sid=1, parent=None, dur=5):
    return {"name": name, "cat": "fleet", "ts_us": ts, "dur_us": dur, "trace_id": trace, "span_id": sid,
            "parent_id": parent, "args": {"k": name}}


def _collector_run(mod, monkeypatch):
    ticks = iter(range(1000, 100000, 10))
    monkeypatch.setattr(mod, "now_us", lambda: next(ticks))
    local = type("Rec", (), {})()
    local_docs = [{"now_us": 50, "pid": 1, "dropped": 0, "spans": [_span("route", 10), _span("untraced", 12,
                                                                                                trace=None)]},
                  {"now_us": 90, "pid": 1, "dropped": 0, "spans": [_span("route", 10), _span("late", 60, sid=9)]}]
    local.export_since = lambda since: local_docs.pop(0)
    remote = _SpanReplica("decode-0", [
        {"now_us": 20_000, "pid": 2, "dropped": 1, "spans": [_span("request", 19_000, sid=2, parent=1)]},
        {"now_us": 30_000, "pid": 2, "dropped": 1, "spans": [_span("request", 19_000, sid=2, parent=1),
                                                             _span("request", 29_000, trace="t2", sid=3)]}])
    shared = _SpanReplica("prefill-0", [], shared=local)
    dead = _SpanReplica("gone-0", [])
    coll = mod.TraceCollector(max_traces=2)
    for _ in range(2):
        coll.collect(recorder=local, replicas=[shared, remote, dead])
    return (coll.trace_ids(), coll.spans_for("t1"), coll.chrome_trace(), coll.chrome_trace("t2"), coll.describe(),
            remote.calls, shared.calls, dead.calls)


def test_trace_collector_merges_equal_the_reference(monkeypatch):
    got, want = _collector_run(tcollector, monkeypatch), _collector_run(jcollector, monkeypatch)
    assert got == want
    assert got[0] == ["t1", "t2"] and got[6] == []  # the shared ring is read once, as the recorder


# ---------------------------------------------------------------- autoscaler --
class _StubReplica:

    def __init__(self, rid, role):
        self.id, self.role, self.doc = rid, role, {}

    def probe(self, max_age_s=0.0):
        return self.doc

    @property
    def load(self):
        return int(self.doc.get("queue_depth", 0)) + int(self.doc.get("active", 0))


class _StubManager:
    """The manager surface the autoscaler drives, over scripted probe docs."""

    def __init__(self, cfg_mod, role, n):
        self.config = cfg_mod.FleetConfig(probe_ttl_s=0.0)
        self._role = role
        self.pool = [_StubReplica(f"{role}-{i}", role) for i in range(n)]
        self.next_id = n
        self.pending = 0
        self.log = []

    def sweep_probes(self, max_age_s=None):
        return [r.doc for r in self.pool]

    def replicas(self, role=None, available_only=False):
        return [r for r in self.pool if role is None or r.role == role]

    def pending_replicas(self, role=None):
        return self.pending

    def add_local(self, role="mixed"):
        r = _StubReplica(f"{role}-{self.next_id}", role)
        self.next_id += 1
        self.pool.append(r)
        self.log.append(("add", r.id))
        return r

    def drain(self, replica_id):
        self.pool = [r for r in self.pool if r.id != replica_id]
        self.log.append(("drain", replica_id))


def _signals():
    """A scripted signal stream: (queue per replica, active, free fraction,
    healthy) for each tick, with a pending restart partway."""
    busy = [(8, 2, 0.5, True)] * 4 + [(0, 0, 0.05, True)] * 3 + [(1, 1, 0.5, True)] * 2
    idle = [(0, 0, 1.0, True)] * 12
    sick = [(0, 0, 1.0, False)] * 2
    return busy + idle + sick + idle


def _autoscale_run(pol_mod, cfg_mod, ds_config, capacity):
    mgr = _StubManager(cfg_mod, "decode", 2)
    cfg = cfg_mod.AutoscaleConfig(min_replicas=2, max_replicas=6, role="decode", sustain_ticks=2,
                                  scale_down_idle_ticks=3, interval_s=0.5)
    scaler = pol_mod.FleetAutoscaler(mgr, config=cfg, ds_config=ds_config,
                                     capacity_fn=(lambda: capacity) if capacity else None)
    out = []
    for i, (q, a, free, healthy) in enumerate(_signals()):
        mgr.pending = 1 if i == 20 else 0
        for r in mgr.pool:
            r.doc = {"healthy": healthy, "queue_depth": q, "active": a, "kv_free_frac": free}
        if i == 22:
            mgr.pool = mgr.pool[:1]  # a member quarantined: below the floor
        out.append((scaler.step(), len(mgr.pool), scaler.observe()["replicas"]))
    return out, mgr.log


@pytest.mark.parametrize("ds_config,capacity", [
    (None, None), (None, 3),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 48, "micro_batch_sizes": [2, 4], "min_gpus": 1,
                     "max_gpus": 6}}, None)], ids=["free", "capacity", "elastic"])
def test_autoscaler_decisions_equal_the_reference(ds_config, capacity):
    got = _autoscale_run(tpolicy, tconfig, ds_config, capacity)
    want = _autoscale_run(jpolicy, jconfig, ds_config, capacity)
    assert got == want
    assert {d for d, _, _ in got[0]} >= {"up", "down"}


def test_package_exports_equal_the_reference():
    assert tfleet.__all__ == jfleet.__all__
    assert typing.get_args(tconfig.ReplicaRole) == typing.get_args(jconfig.ReplicaRole)
    assert tfaults.POINTS == jfaults.POINTS
