"""Port parity: deepspeed_tpu_torch.telemetry against deepspeed_tpu.telemetry.

The same sequence of counter, gauge and histogram operations on both
registries must render identical Prometheus text; spans, Chrome traces,
JSONL events, the HTTP exporter's responses and flight-recorder dumps must
carry the reference's fields. The port's engine records the reference's
``inference_*`` families and ``put``/``decode_loop`` spans. What belongs to
ROADMAP A6 (the fleet trace collector) raises.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.telemetry import compile_watch as j_cw
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.telemetry import compile_watch as t_cw
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

BOTH = pytest.mark.parametrize("tel", [jtel, ttel], ids=["jax", "port"])


def _reset(tel):
    tel.shutdown()
    tel.state.registry = None


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    """This file builds and drops many JAX engines: leave the worker's JAX
    caches as a fresh process has them, so no compiled program of these
    tests can stand in for a later file's first compile."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def fresh_telemetry():
    """Telemetry state is process-global in each package: every test starts
    and ends with no session and a fresh registry on both sides."""
    for tel in (jtel, ttel):
        _reset(tel)
    yield
    for tel in (jtel, ttel):
        _reset(tel)


def _ops_labels(reg):
    reg.counter("ops_total", "ops", labels={"op": "all_reduce"}).inc(3)
    reg.counter("ops_total", "ops", labels={"op": "all_gather"}).inc()
    reg.gauge("free_blocks", "blocks").set(11)
    reg.gauge("free_blocks", "blocks").dec(2)


def _ops_histograms(reg):
    h = reg.histogram("lat_seconds", "lat", buckets=(0.01, 1.0))
    for v in (0.002, 0.5, 3.0):
        h.observe(v)
    d = reg.histogram("serving_ttft_seconds", "Submission to first generated token")
    for v in np.random.default_rng(0).exponential(0.05, 50):
        d.observe(float(v))
    reg.histogram("bytes", "b", labels={"op": "x"}, buckets=(10.0, 100.0)).observe(50)
    reg.histogram("bytes", labels={"op": "y"}).observe(500)  # inherits the family's layout


def _ops_serving_families(reg):
    """Every family the port's serving metrics register, touched once."""
    if reg.__class__.__module__.startswith("deepspeed_tpu_torch"):
        from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    else:
        from deepspeed_tpu.serving.metrics import ServingMetrics
    m = ServingMetrics(reg)
    m.queue_depth.set(3)
    m.ttft.observe(0.02)
    m.itl.observe(0.004)
    m.e2e.observe(1.5)
    m.admissions.inc()
    m.evictions.inc(2)


@pytest.mark.parametrize("ops", [_ops_labels, _ops_histograms, _ops_serving_families],
                         ids=["labels", "histograms", "serving_families"])
def test_same_operations_render_identical_prometheus_text(ops):
    regs = [jtel.MetricsRegistry(), ttel.MetricsRegistry()]
    for reg in regs:
        ops(reg)
    texts = [reg.render_prometheus() for reg in regs]
    assert texts[0] == texts[1]
    assert ttel.parse_prometheus_text(texts[1]) == jtel.parse_prometheus_text(texts[0])
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].api_calls == regs[1].api_calls


def test_histogram_quantiles_and_family_checks_match():
    hists = []
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        h = reg.histogram("lat_seconds", "lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.05, 0.5, 5.0):
            h.observe(v)
        hists.append(h)
        with pytest.raises(ValueError):
            reg.gauge("lat_seconds")
        with pytest.raises(ValueError):
            reg.histogram("lat_seconds", labels={"a": "b"}, buckets=(1.0, 2.0))
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert hists[0].quantile(q) == hists[1].quantile(q)
    assert (jtel.MetricsRegistry().histogram("h").quantile(0.5)
            is ttel.MetricsRegistry().histogram("h").quantile(0.5) is None)


def test_jsonl_events_carry_the_reference_fields(tmp_path):
    records = []
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        path = tmp_path / f"{tel.__name__}.jsonl"
        reg.open_jsonl(str(path))
        reg.event("train_step", loss=1.5, step=3)
        reg.close_jsonl()
        rec = json.loads(path.read_text().strip())
        assert rec.pop("ts") > 0
        records.append((rec, [{k: v for k, v in e.items() if k != "ts"} for e in reg.recent_events_snapshot()]))
    assert records[0] == records[1]


@BOTH
def test_span_records_have_the_reference_fields(tel):
    rec = tel.SpanRecorder(max_spans=4)
    plain = rec.record("put", cat="inference", ts_us=10, dur_us=5, args={"tokens": 3})
    with tel.trace_context("abcd", 7):
        child = rec.record("prefill", cat="serving", ts_us=20, dur_us=1)
    with rec.span("outer", cat="serving", trace_id="ffff"):
        time.sleep(0.001)
    assert plain.to_dict() == {"name": "put", "cat": "inference", "ts_us": 10, "dur_us": 5,
                               "args": {"tokens": 3}}
    d = child.to_dict()
    assert set(d) == {"name", "cat", "ts_us", "dur_us", "trace_id", "span_id", "parent_id"}
    assert (d["trace_id"], d["parent_id"]) == ("abcd", 7) and d["span_id"] > 0
    trace = rec.chrome_trace()
    assert set(trace) == {"traceEvents", "displayTimeUnit", "spansDropped"}
    meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta} == {"request abcd", "request ffff"}
    for _ in range(5):
        rec.record("x")
    assert len(rec) == 4 and rec.dropped == 4  # 8 recorded into a ring of 4
    doc = rec.export_since(0)
    assert set(doc) == {"now_us", "pid", "dropped", "spans"}


def test_span_and_trace_exports_match_field_for_field():
    docs = []
    for tel in (jtel, ttel):
        rec = tel.SpanRecorder()
        rec.record("queued", cat="serving", ts_us=100, dur_us=4, trace_id="t1", span_id=5, parent_id=2,
                   args={"uid": 0})
        rec.record("put", cat="inference", ts_us=102, dur_us=3, args={"sequences": 1})
        trace = rec.chrome_trace()
        for e in trace["traceEvents"]:
            e.pop("pid")
        docs.append((rec.tail(10), trace))
    assert docs[0] == docs[1]


def test_exporter_http_responses_match(tmp_path):
    bodies = []
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        reg.counter("req_total", "requests").inc(2)
        spans = tel.SpanRecorder()
        spans.record("put", cat="inference", ts_us=1, dur_us=2)
        srv = tel.start_http_server(reg, spans=spans)
        try:
            got = {}
            for path in ("/metrics", "/healthz", "/trace", "/flight", "/nope"):
                try:
                    with urllib.request.urlopen(srv.url + path, timeout=10) as resp:
                        got[path] = (resp.status, resp.headers["Content-Type"], resp.read())
                except urllib.error.HTTPError as e:
                    got[path] = (e.code, e.headers["Content-Type"], e.read())
            trace = json.loads(got["/trace"][2])
            for e in trace["traceEvents"]:
                e.pop("pid")
            got["/trace"] = got["/trace"][:2] + (trace, )
            got["scrape"] = tel.scrape_metrics(srv.url)
        finally:
            srv.stop()
        bodies.append(got)
    assert bodies[0] == bodies[1]
    assert bodies[1]["/healthz"][0] == 200 and bodies[1]["/flight"][0] == 404


def test_session_configure_close_and_flight_dump(tmp_path):
    docs = []
    for tel in (jtel, ttel):
        session = tel.configure({"enabled": True, "compile_watch": True,
                                 "flight_recorder": {"enabled": True, "dir": str(tmp_path / tel.__name__),
                                                     "signal_enabled": False, "watchdog_enabled": False}})
        assert tel.is_active() and tel.get_span_recorder() is session.spans
        tel.get_registry().counter("serving_admissions_total", "Requests accepted into the queue").inc()
        session.spans.record("put", cat="inference", dur_us=1)
        recorder = tel.get_flight_recorder()
        recorder.register_provider("serving_scheduler:0", lambda: {"queue_depth": 0})
        path, doc = recorder.dump("api", return_doc=True)
        assert json.load(open(path))["meta"]["trigger"] == "api"
        docs.append(doc)
        session.close()
        session.close()  # idempotent
        assert not tel.is_active() and tel.get_flight_recorder() is None
    j, t = docs
    assert set(j) == set(t) and set(j["meta"]) == set(t["meta"])
    assert j["state"] == t["state"]
    assert [s["name"] for s in j["spans"]] == [s["name"] for s in t["spans"]]
    assert j["metrics"] == t["metrics"]


def test_compile_watch_bucket_switches_and_occupancy_match():
    counts = []
    for tel, cw in ((jtel, j_cw), (ttel, t_cw)):
        session = tel.configure({"enabled": True})
        watch = cw.get()
        for bucket in [(8, 1, 1), (16, 2, 1), (8, 1, 1)] + [(2 ** i, 1, 1) for i in range(5, 15)] + [(8, 1, 1)]:
            watch.note_bucket(bucket)
        seen = []
        wrapped = watch.wrap("forward", (8, 1, 1), lambda: seen.append(watch.in_wrapped_call()))
        wrapped()
        assert seen == [True] and not watch.in_wrapped_call()
        counts.append(tel.get_registry().snapshot())
        session.close()
        assert cw.get() is None
    assert counts[0] == counts[1]


def test_process_index_is_zero_without_torch_distributed():
    assert ttel._process_index() == 0


def test_a6_pieces_are_refused():
    """The fleet trace collector is ROADMAP A6; the time-series store and the
    SLO engine (A6 until they were ported with the cost plane) build from a
    config and stop with their session."""
    with pytest.raises(NotImplementedError, match="A6"):
        ttel.TraceCollector
    assert ttel.TimeSeriesStore.__module__ == "deepspeed_tpu_torch.telemetry.timeseries"
    assert ttel.SLOEngine.__module__ == "deepspeed_tpu_torch.telemetry.slo"
    for block in ("timeseries", "slo"):
        session = ttel.configure({"enabled": True, block: {"enabled": True, "interval_s": 60.0}
                                  if block == "timeseries" else {"enabled": True}})
        assert ttel.get_timeseries() is not None
        assert (ttel.get_slo_engine() is not None) == (block == "slo")
        session.close()
        assert ttel.get_timeseries() is None and ttel.get_slo_engine() is None


# ------------------------------------------------------------ the engine --
@pytest.fixture(scope="module")
def engines_setup():
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    return jcfg, jparams, port_config(jcfg), port_params(jcfg, jparams)


def _engine_pair(setup, telemetry_block):
    jcfg, jparams, cfg, params = setup
    jmgr = j_mc.DSStateManagerConfig(memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE, size=64),
                                     max_context=512)
    jeng = j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(
        state_manager=jmgr, kv_block_size=16, telemetry=telemetry_block))
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=64), max_context=512)
    teng = build_engine(params, cfg, RaggedInferenceEngineConfig(
        state_manager=mgr, kv_block_size=16, telemetry=telemetry_block), device="cpu")
    return jeng, teng


def _drive(engine, prompts):
    engine.put([0, 1], prompts)
    engine.decode_loop([0, 1], [[3], [4]], 2)
    engine.empty_run()


def _inference_families(snapshot):
    return {k: v for k, v in snapshot.items() if k.startswith("inference_")}


@pytest.mark.parametrize("engine_owned", [True, False], ids=["engine_session", "global_session"])
def test_engine_records_the_reference_inference_families_and_spans(engines_setup, engine_owned):
    jcfg = engines_setup[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 9), rng.integers(0, jcfg.vocab_size, 4)]
    block = ({"enabled": True, "http": {"enabled": True, "port": 0}} if engine_owned else {})
    out = []
    for tel, i in ((jtel, 0), (ttel, 1)):
        session = None if engine_owned else tel.configure({"enabled": True})
        engine = _engine_pair(engines_setup, block)[i]
        try:
            _drive(engine, prompts)
            spans = tel.get_span_recorder().tail(10)
            if engine_owned:
                with urllib.request.urlopen(engine.metrics_url, timeout=10) as resp:
                    fams = tel.parse_prometheus_text(resp.read().decode())
                assert fams["inference_tokens_total"]["samples"][0][2] == 17.0  # 13 + 2 x 2
            out.append((_inference_families(tel.get_registry().snapshot()),
                        [(s["name"], s["cat"], s["args"]) for s in spans
                         if s["name"] in ("put", "decode_loop")]))
        finally:
            engine.close()
            if session is not None:
                session.close()
    assert out[0] == out[1]
    assert [name for name, _, _ in out[1][1]] == ["put", "decode_loop"]
    assert out[1][0]["inference_empty_runs_total"][0][1] == 1


def test_engine_telemetry_off_costs_no_registry_call(engines_setup):
    _, teng = _engine_pair(engines_setup, {})
    _drive(teng, [np.arange(5), np.arange(3)])
    assert ttel.get_registry().api_calls == 0 and ttel.get_span_recorder() is None
    teng.close()


def test_dispatch_observer_sees_every_dispatch(engines_setup):
    _, teng = _engine_pair(engines_setup, {})
    seen = []
    teng.dispatch_observer = lambda kind, n_seqs, n_tokens, s: seen.append((kind, n_seqs, n_tokens, s >= 0))
    _drive(teng, [np.arange(5), np.arange(3)])
    assert seen == [("put", 2, 8, True), ("decode_loop", 2, 4, True)]
    teng.close()
