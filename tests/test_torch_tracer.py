"""Port parity: the per-layer tracer of deepspeed_tpu_torch against deepspeed_tpu's.

The same script (a prefill put, decode puts, a verify, a tree verify and an
empty run) goes through the JAX engine and the port's with
``trace_enabled``. Their batch summaries must be equal in everything but the
times, and so must the per-phase spans (names, batch ids, uids). The rest
covers the ring and ``drain_summaries``, ``close`` deregistering the tracer,
``record`` with tracing off, and the CUDA-event bookkeeping (event pairs
resolved with one wait, spans placed on the anchor's timeline), which is
driven on the CPU with stand-in events that count their calls; the card's
own tests are in ``tests/test_torch_cuda_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2 import tracer as j_tracer
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.inference.v2.spec import TokenTree as JTokenTree
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference.v2 import engine_v2 as t_engine_v2
from deepspeed_tpu_torch.inference.v2 import tracer as t_tracer
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.inference.v2.spec import TokenTree
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

PHASES = ("embed", "attn", "ffn", "unembed")


@pytest.fixture(autouse=True)
def fresh_state():
    for tel in (jtel, ttel):
        tel.shutdown()
        tel.state.registry = None
    yield
    for tel in (jtel, ttel):
        tel.shutdown()
        tel.state.registry = None
    j_tracer.set_tracer(None)
    t_tracer.set_tracer(None)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    return jcfg, jparams, port_config(jcfg), port_params(jcfg, jparams)


def _engine(setup, pkg, **kw):
    jcfg, jparams, cfg, params = setup
    if pkg == "jax":
        mgr = j_mc.DSStateManagerConfig(memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE, size=64),
                                        max_context=512)
        return j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(
            state_manager=mgr, kv_block_size=16, **kw))
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=64), max_context=512)
    return build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16, **kw),
                        device="cpu")


def _script(engine, pkg):
    """Prefill (two sequences), two decode puts, a linear verify, a tree
    verify and an empty run."""
    tree = (JTokenTree if pkg == "jax" else TokenTree)([5, 6, 7, 8], [-1, 0, 0, 1])
    rng = np.random.default_rng(3)
    engine.put([0, 1], [rng.integers(0, 256, 9), rng.integers(0, 256, 4)])
    engine.put([0, 1], [[3], [4]])
    engine.put([1, 0], [[9], [2]])
    engine.verify([0], [[1, 2, 3]])
    engine.verify_tree([1], [tree])
    engine.empty_run()


def _masked(summary):
    """A summary with every time replaced by whether it is zero."""
    doc = dataclasses.asdict(summary)
    doc["record_exec_times"] = [[t == 0 for t in row] for row in doc["record_exec_times"]]
    doc["embed"], doc["unembed"] = doc["embed"] == 0, doc["unembed"] == 0
    return doc


def _phase_spans(spans):
    return [s for s in spans if s["cat"] == "inference" and s["name"] in PHASES]


@pytest.mark.parametrize("engine_owned", [True, False], ids=["engine_session", "global_session"])
def test_traced_summaries_and_spans_equal_the_jax_engine(setup, engine_owned):
    got = {}
    for pkg, tel in (("jax", jtel), ("port", ttel)):
        session = None if engine_owned else tel.configure({"enabled": True})
        engine = _engine(setup, pkg, trace_enabled=True, telemetry={"enabled": True} if engine_owned else {})
        try:
            _script(engine, pkg)
            spans = _phase_spans(tel.get_span_recorder().tail(1000))
            got[pkg] = ([_masked(s) for s in engine.tracer.drain_summaries()],
                        [(s["name"], s["args"]) for s in spans])
        finally:
            engine.close()
            if session is not None:
                session.close()
    assert got["port"] == got["jax"]
    summaries, spans = got["port"]
    layers = setup[2].num_hidden_layers
    assert [s["is_empty_run"] for s in summaries] == [False] * 5 + [True]
    assert [s["uids"] for s in summaries] == [[0, 1], [0, 1], [1, 0], [0], [1], []]
    assert summaries[0]["seen_tokens"] == [0, 0] and summaries[0]["in_flight_tokens"] == [9, 4]
    # the traced forwards (the three puts) timed every phase; the verify
    # forwards are untraced, as in the JAX package
    for s in summaries[:3]:
        assert not s["embed"] and not s["unembed"]
        assert all(row[:2] == [False, False] for row in s["record_exec_times"])
    for s in summaries[3:5]:
        assert s["embed"] and s["unembed"] and all(all(row) for row in s["record_exec_times"])
    assert len(spans) == 3 * (2 * layers + 2) + 2 * layers + 2
    assert spans[:2 * layers + 2] == ([("embed", {"batch_id": 0, "uids": [0, 1]})]
                                      + [(n, {"batch_id": 0, "uids": [0, 1]}) for _ in range(layers)
                                         for n in ("attn", "ffn")] + [("unembed", {"batch_id": 0, "uids": [0, 1]})])
    assert {args["batch_id"] for _, args in spans[-(2 * layers + 2):]} == {5}


def test_traced_tokens_equal_untraced(setup):
    """Tracing adds records around the same ops: logits bitwise unchanged."""
    out = []
    for trace in (False, True):
        engine = _engine(setup, "port", trace_enabled=trace)
        logits = [engine.put([0, 1], [np.arange(9), np.arange(4)]), engine.put([0, 1], [[3], [4]])]
        out.append(torch.cat(logits))
        engine.close()
    assert torch.equal(out[0], out[1])


def test_phase_spans_are_ordered_within_a_batch(setup):
    session = ttel.configure({"enabled": True})
    engine = _engine(setup, "port", trace_enabled=True)
    engine.put([0], [np.arange(12)])
    engine.put([0], [[4]])
    spans = _phase_spans(ttel.get_span_recorder().tail(1000))
    for batch in (0, 1):
        ts = [s["ts_us"] for s in spans if s["args"]["batch_id"] == batch]
        assert len(ts) == 2 * engine.model.num_layers + 2 and ts == sorted(ts)
    engine.close()
    session.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ring_bounds_and_drain(setup, pkg):
    engine = _engine(setup, pkg, trace_enabled=True, max_trace_batches=2)
    engine.put([0], [np.arange(5)])
    for tok in range(3):
        engine.put([0], [[tok]])
    tracer = engine.tracer
    assert tracer.pending_batches == 2
    assert [s.batch_id for s in tracer.batch_summaries()] == [2, 3]
    assert [s.batch_id for s in tracer.drain_summaries()] == [2, 3]
    assert tracer.pending_batches == 0 and tracer.drain_summaries() == []
    engine.put([0], [[7]])
    (summary, ) = tracer.drain_summaries()
    assert summary.batch_id == 4 and summary.seen_tokens == [8]
    engine.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_close_deregisters_only_its_own_tracer(setup, pkg):
    mod = j_tracer if pkg == "jax" else t_tracer
    first = _engine(setup, pkg, trace_enabled=True)
    assert mod.get_tracer() is first.tracer
    second = _engine(setup, pkg, trace_enabled=True)
    first.close()
    assert mod.get_tracer() is second.tracer  # not the first engine's to clear
    second.close()
    assert mod.get_tracer() is None
    untraced = _engine(setup, pkg)
    assert untraced.tracer is None and mod.get_tracer() is None
    untraced.close()


def test_tracer_api_edge_cases_match_the_jax_tracer():
    """The JAX package's own tracer unit cases, through both tracers."""

    class Seq:
        seen_tokens, in_flight_tokens, tracking_id = 4, 1, 7

    out = []
    for mod in (j_tracer, t_tracer):
        tr = mod.Tracer(max_batches=8)
        tr.init_batch(is_empty_run=True, num_layers=2)
        tr.init_batch(is_empty_run=False, num_layers=2)
        tr.add_sequence(Seq())
        for _ in range(2):
            tr.add_trace("attn", 10)
            tr.add_trace("ffn", 20)
        tr.init_batch(is_empty_run=False, num_layers=3)  # claims 3 layers, records 2
        tr.add_trace("embed", 5)
        tr.add_trace("attn", 10)
        tr.add_trace("attn", 11)
        tr.add_trace("unembed", 7)
        out.append([dataclasses.asdict(s) for s in tr.drain_summaries()])
        tr.add_trace("attn", 1)  # the drained batch must not resurrect
        assert tr.pending_batches == 0
    assert out[0] == out[1]


def test_record_is_a_no_op_with_tracing_off(monkeypatch):
    t_tracer.set_tracer(None)
    monkeypatch.setattr(t_tracer, "_timing_event", lambda: pytest.fail("an event was created"))
    monkeypatch.setattr(t_tracer.time, "perf_counter", lambda: pytest.fail("a timer was read"))
    with t_tracer.record("attn"):
        pass


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: its time is a host counter, and it
    counts the records and waits made on it."""
    clock = 0.0
    log = None

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 0.25  # ms a record advances the stream
        self.t = _FakeEvent.clock
        _FakeEvent.log.append("record")

    def synchronize(self):
        _FakeEvent.log.append("synchronize")

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CPU engine that believes it is on the card: ``device`` reads cuda,
    and every CUDA event is a counting stand-in."""
    _FakeEvent.clock, _FakeEvent.log = 0.0, []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: _FakeEvent.log.append("device_sync"))
    monkeypatch.setattr(t_engine_v2.InferenceEngineV2, "device", property(lambda self: torch.device("cuda")))
    return _FakeEvent.log


def test_untraced_put_without_observer_creates_no_event_or_wait(setup, fake_cuda):
    engine = _engine(setup, "port")
    engine.put([0, 1], [np.arange(9), np.arange(4)])
    engine.put([0, 1], [[3], [4]])
    engine.decode_loop([0, 1], [[5], [6]], 2)
    assert fake_cuda == []
    seen = []
    engine.dispatch_observer = lambda *args: seen.append(args)
    engine.put([0, 1], [[1], [2]])
    # the observer's seconds end after one event recorded and waited on
    assert fake_cuda == ["record", "synchronize"] and len(seen) == 1
    engine.close()


def test_cuda_tracer_records_event_pairs_and_resolves_with_one_wait(setup, fake_cuda):
    session = ttel.configure({"enabled": True})
    engine = _engine(setup, "port", trace_enabled=True)
    engine.tracer.uses_events = True  # the engine's model is on the CPU
    layers = engine.model.num_layers
    engine.put([0, 1], [np.arange(9), np.arange(4)])
    # an anchor, two events a phase, and one wait for the whole forward
    assert fake_cuda == ["record"] * (1 + 2 * (2 * layers + 2)) + ["synchronize"]
    engine.verify([0], [[1, 2]])  # untraced forward: its anchor only
    assert fake_cuda.count("record") == 2 + 2 * (2 * layers + 2) and fake_cuda.count("synchronize") == 1
    (put, verify) = engine.tracer.drain_summaries()
    # each record advances the stand-in clock 0.25 ms: every phase lasts 250 us
    assert put.embed == put.unembed == 250
    assert all(row[:2] == [250, 250] for row in put.record_exec_times)
    assert verify.embed == 0 and all(not any(row) for row in verify.record_exec_times)
    spans = _phase_spans(ttel.get_span_recorder().tail(1000))
    assert len(spans) == 2 * layers + 2
    # on the anchor's timeline: phase i starts 0.25 ms after the anchor plus
    # 0.5 ms per earlier phase, so consecutive phases abut and never overlap
    starts = [s["ts_us"] - spans[0]["ts_us"] for s in spans]
    assert starts == [500 * i for i in range(2 * layers + 2)]
    assert all(a["ts_us"] + a["dur_us"] <= b["ts_us"] for a, b in zip(spans, spans[1:]))
    assert all(s["args"]["uids"] == [0, 1] for s in spans)
    engine.close()
    session.close()


def test_cuda_summaries_resolve_pending_events(fake_cuda):
    tr = t_tracer.Tracer(device="cuda")
    t_tracer.set_tracer(tr)
    tr.init_batch(is_empty_run=False, num_layers=1)
    for name in PHASES[:3]:
        with t_tracer.record(name):
            pass
    assert "synchronize" not in fake_cuda  # nothing resolved yet
    (summary, ) = list(tr.batch_summaries())
    assert fake_cuda.count("synchronize") == 1 and summary.embed == 250
    assert summary.record_exec_times[0][:2] == [250, 250]
    (again, ) = tr.drain_summaries()  # already resolved: no second wait
    assert fake_cuda.count("synchronize") == 1 and again == summary
