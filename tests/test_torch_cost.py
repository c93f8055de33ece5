"""Port parity: the cost plane of deepspeed_tpu_torch against deepspeed_tpu's.

- The JAX package's ledger and observed-ledger unit scripts
  (``tests/unit/telemetry/test_ledger.py``) run on both packages: the same
  documents come out.
- Both schedulers side by side with the cost plane on (a telemetry session,
  the default ``CostConfig``), fed the same dispatch seconds through their
  engines' observers and the same clock: usage documents, request rows, the
  final documents' ``cost`` and the ``/v1/usage`` bytes are equal, with
  every priced field held to its own side's ``PriceBook``; the bills
  conserve (tenants sum to the aggregate, billed plus amnesty seconds to the
  observed ones).
- ROADMAP C5: the JAX package prices Llama-2-7B at the fallback (its
  ``PriceBook`` reads ``num_layers``, which ``LlamaConfig`` does not have);
  the port prices it analytically.
- The JAX package's serving-path cost and drift tests, on the port.
"""

import json
import threading
import time
import urllib.request

import pytest

from deepspeed_tpu import serving as jserving
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.perf import observed as j_observed
from deepspeed_tpu.serving import scheduler as j_scheduler_mod
from deepspeed_tpu.telemetry import ledger as j_ledger
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.perf import chip_specs
from deepspeed_tpu_torch.perf import observed as t_observed
from deepspeed_tpu_torch.serving import RequestState, ServingConfig, ServingScheduler, ServingServer
from deepspeed_tpu_torch.serving import scheduler as t_scheduler_mod
from deepspeed_tpu_torch.serving.config import CostConfig
from deepspeed_tpu_torch.telemetry import ledger as t_ledger
from tests.test_torch_serving import (WAIT_S, _jax_engine, _mask, _run_until, clear_jax_caches,  # noqa: F401
                                      fresh_telemetry, make_engine, setup)

PKGS = {"jax": (j_ledger, j_observed, jtel), "port": (t_ledger, t_observed, ttel)}


class _Req:
    """The slice of Request the ledger touches."""

    def __init__(self, tenant=None):
        self.tenant = tenant
        self.cost = None


# ------------------------------------------------- the JAX unit scripts, twice --
def _pricebook(ledger, observed, reg):

    class Cfg:
        hidden_size = 64
        num_layers = 2
        vocab_size = 256
        intermediate_size = 128

    book = ledger.PriceBook.from_model_config(Cfg())
    params = 2 * (4 * 64 * 64 + 3 * 64 * 128) + 256 * 64
    assert book.source == "analytic" and book.flops_per_token == book.bytes_per_token == 2.0 * params
    fallback = ledger.PriceBook()
    assert fallback.source == "fallback" and fallback.flops(10) == 10 * fallback.flops_per_token
    bad = [ledger.PriceBook.from_model_config(c).source for c in (None, object())]
    assert bad == ["fallback", "fallback"]
    return book.to_dict(), fallback.to_dict()


def _request_cost(ledger, observed, reg):
    cost = ledger.RequestCost(ledger.PriceBook())
    cost.tokens["prefill"] = 100
    cost.tokens["decode"] = 20
    cost.device_seconds = 0.25
    cost.kv_block_seconds["device"] = 3.0
    cost.wire_bytes["handoff"] = 512
    row = cost.compact_row()
    assert row == {"billed_tokens": 120, "device_ms": 250.0, "kv_block_s": 3.0, "wire_bytes": 512}
    return cost.to_dict(), row


def _tenant_rollup(ledger, observed, reg):
    rollup = ledger.TenantRollup(max_tenants=2)
    buckets = []
    for tenant in ("a", "b", "c", "d"):
        cost = ledger.RequestCost(ledger.PriceBook())
        cost.tokens["decode"] = 10
        buckets.append(rollup.fold(tenant, cost))
    assert buckets == ["a", "b", ledger.OTHER_TENANT, ledger.OTHER_TENANT]
    doc = rollup.doc()
    assert sum(row["tokens"]["billed"] for row in doc.values()) == 40
    return doc


def _charge_dispatch(ledger, observed, reg):
    book = ledger.CostLedger(reg, ledger.PriceBook())
    a, b = _Req("a"), _Req("b")
    book.begin(a)
    book.begin(b)
    book.charge_dispatch([(a.cost, "prefill", 30), (b.cost, "prefill", 10)], seconds=0.4, amnesty_s=0.04)
    assert a.cost.device_seconds == pytest.approx(0.3) and b.cost.device_seconds == pytest.approx(0.1)
    assert a.cost.amnesty_seconds == pytest.approx(0.03)
    assert book.totals.device_seconds == pytest.approx(0.4) and book.totals.dispatches == 1
    return a.cost.to_dict(), b.cost.to_dict(), book.usage_doc()


def _kv_touch(ledger, observed, reg):
    book = ledger.CostLedger(reg, ledger.PriceBook())
    req = _Req()
    book.begin(req)
    book.touch_kv(req.cost, blocks=4, tier="device", now_s=10.0)
    book.touch_kv(req.cost, blocks=2, tier="host", now_s=12.0)
    book.finalize(req, now_s=15.0)
    assert req.cost.kv_block_seconds == {"device": pytest.approx(8.0), "host": pytest.approx(6.0)}
    assert book.totals.kv_block_seconds == req.cost.kv_block_seconds
    return book.usage_doc()


def _conservation(ledger, observed, reg):
    book = ledger.CostLedger(reg, ledger.PriceBook(), max_tenants=2)
    for i, tenant in enumerate(("a", "b", "c", "a", None)):
        req = _Req(tenant)
        book.begin(req)
        book.charge_dispatch([(req.cost, "prefill", 7 + i)], seconds=0.01)
        book.charge_dispatch([(req.cost, "decode", 3)], seconds=0.002)
        book.charge_wire(req.cost, "handoff", 100 + i)
        book.charge_spec(req.cost, drafted=4, accepted=2)
        book.finalize(req, now_s=float(i))
    doc = book.usage_doc()
    rows, totals = doc["tenants"].values(), doc["totals"]
    for phase in ledger.PHASES + ("billed", ):
        assert sum(r["tokens"][phase] for r in rows) == totals["tokens"][phase]
    assert sum(r["requests"] for r in rows) == totals["requests"] == 5
    assert sum(r["speculative"]["accepted"] for r in rows) == totals["speculative"]["accepted"] == 10
    assert set(doc["tenants"]) == {"a", "b", ledger.OTHER_TENANT}
    return doc


def _tenant_top_k(ledger, observed, reg):
    book = ledger.CostLedger(reg, ledger.PriceBook(), max_tenants=16, tenant_metric_top_k=2)
    for tenant in ("a", "b", "c", "d"):
        req = _Req(tenant)
        book.begin(req)
        book.charge_dispatch([(req.cost, "decode", 5)], seconds=0.001)
        book.finalize(req, now_s=0.0)
    assert set(book._tenant_m) == {"a", "b", ledger.OTHER_TENANT}
    return book.usage_doc(), reg.snapshot()["serving_tenant_tokens_total"]


def _buckets_and_programs(ledger, observed, reg):
    pf = observed.PerfObservedLedger.program_for
    return ([observed._bucket(n) for n in (1, 2, 3, 8, 9, 100)],
            [pf("decode_loop", 4, 4), pf("verify", 2, 10), pf("verify_tree", 1, 16), pf("put", 2, 50),
             pf("put", 4, 4)])


def _amnesty(ledger, observed, reg):
    perf = observed.PerfObservedLedger(reg, ledger.PriceBook(), chip="cpu-host", baseline_dispatches=2)
    assert perf.observe("decode_loop", 4, 4, 0.5) == 0.5  # first sight: all amnesty
    assert perf.observe("decode_loop", 4, 4, 0.01) == 0.0
    (row, ) = perf.doc()["programs"]
    assert row["dispatches"] == 1 and row["ratio"] == pytest.approx(0.01 / row["predicted_s"])
    return perf.doc()


def _drift(ledger, observed, reg):
    perf = observed.PerfObservedLedger(reg, ledger.PriceBook(), chip="cpu-host", drift_factor=4.0,
                                       drift_consecutive=3, baseline_dispatches=2)
    perf.observe("decode_loop", 4, 4, 1.0)  # amnesty
    for seconds in (0.01, 0.01, 0.1, 0.1):  # a baseline, then two slow ones
        perf.observe("decode_loop", 4, 4, seconds)
    assert perf.doc()["programs"][0]["drift_events"] == 0
    perf.observe("decode_loop", 4, 4, 0.1)  # the third in a row
    counter = reg.counter("perf_drift_events_total", labels={"program": "paged_decode_step"})
    assert counter.value == 1
    perf.observe("decode_loop", 4, 4, 0.01)  # a fast one resets the run
    perf.observe("decode_loop", 4, 4, 0.1)
    assert counter.value == 1
    events = [{k: v for k, v in e.items() if k not in ("ts", "time")}
              for e in reg.recent_events_snapshot() if e.get("event") == "perf_drift"]
    return perf.doc(), events


def _explicit_predictions(ledger, observed, reg):
    perf = observed.PerfObservedLedger(reg, ledger.PriceBook(), chip="cpu-host", baseline_dispatches=1)
    perf.load_predictions({"paged_decode_step": 0.02})
    perf.observe("decode_loop", 4, 4, 1.0)
    perf.observe("decode_loop", 4, 4, 0.04)
    (row, ) = perf.doc()["programs"]
    assert row["predicted_s"] == 0.02 and row["ratio"] == pytest.approx(2.0)
    return perf.doc()


SCRIPTS = (_pricebook, _request_cost, _tenant_rollup, _charge_dispatch, _kv_touch, _conservation, _tenant_top_k,
           _buckets_and_programs, _amnesty, _drift, _explicit_predictions)


@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__.strip("_") for s in SCRIPTS])
def test_ledger_scripts_give_the_jax_documents(script):
    out = {pkg: script(ledger, observed, tel.MetricsRegistry()) for pkg, (ledger, observed, tel) in PKGS.items()}
    assert out["port"] == out["jax"]


def test_observed_ledger_prices_against_the_h100_by_default():
    book = t_ledger.PriceBook.from_model_config(LlamaConfig.llama2_7b())
    perf = t_observed.PerfObservedLedger(ttel.MetricsRegistry(), book)
    perf.observe("put", 1, 768, 1.0)
    perf.observe("put", 1, 768, 0.2)
    (row, ) = perf.doc()["programs"]
    h100 = chip_specs.get_chip_spec()
    assert perf.doc()["chip"] == "h100" == chip_specs.DEFAULT_CHIP == CostConfig().perf_chip
    assert (h100.peak_bf16_flops, h100.hbm_bytes_per_s, h100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    # a full weight read per token: a 1,024-token bucket "predicted" at the
    # bytes bound of 1,024 weight reads
    assert row["bucket"] == 1024 and row["predicted_s"] == pytest.approx(book.bytes(1024) / 3.35e12)
    assert set(chip_specs.CHIP_SPECS) == {"h100", "cpu-host"}
    with pytest.raises(KeyError, match="unknown chip"):
        chip_specs.get_chip_spec("v5e")


def test_c5_llama_is_priced_analytically_only_in_the_port():
    jbook = j_ledger.PriceBook.from_model_config(JLlamaConfig.llama2_7b())
    book = t_ledger.PriceBook.from_model_config(LlamaConfig.llama2_7b())
    assert jbook.source == "fallback" and jbook.flops_per_token == 2e6
    cfg = LlamaConfig.llama2_7b()
    h, inter = cfg.hidden_size, cfg.intermediate_size
    params = cfg.num_hidden_layers * (4 * h * h + 3 * h * inter) + cfg.vocab_size * h
    assert book.source == "analytic" and book.flops_per_token == book.bytes_per_token == 2.0 * params
    # a config that names the field num_layers is priced the same by both
    stub = type("Stub", (), dict(hidden_size=h, num_layers=cfg.num_hidden_layers, vocab_size=cfg.vocab_size,
                                 intermediate_size=inter))()
    assert j_ledger.PriceBook.from_model_config(stub).to_dict() == book.to_dict()


# -------------------------------------------------- schedulers side by side --
class _Clock:
    """The schedulers' ``time`` module with a hand-advanced ``monotonic``: KV
    block-seconds then count ticks, the same in both packages."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _priced(doc, book, chip):
    """``doc`` with every priced field checked against ``book`` (and the
    perf rows against ``chip``) and replaced by what does not depend on the
    price: a perf row's ratios become the seconds they were taken from."""
    if isinstance(doc, list):
        return [_priced(v, book, chip) for v in doc]
    if not isinstance(doc, dict):
        return doc
    out = {}
    for key, value in doc.items():
        if key == "pricing":
            assert value == book.to_dict()
            value = "<priced>"
        elif key in ("flops", "hbm_bytes"):
            billed = doc["tokens"]["billed"]
            assert value == (book.flops(billed) if key == "flops" else book.bytes(billed))
            value = "<priced>"
        elif key == "predicted_s":
            bucket = doc["bucket"]
            assert value == max(book.flops(bucket) / chip.peak_bf16_flops,
                                book.bytes(bucket) / chip.hbm_bytes_per_s, 1e-12)
            value = "<priced>"
        elif key in ("ratio", "baseline_ratio") and value is not None:
            value = round(value * doc["predicted_s"], 12)
        else:
            value = _priced(value, book, chip)
        out[key] = value
    return out


def _http(url, path, body=None, headers=None):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode() if body is not None else None,
                                 method="POST" if body is not None else "GET",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return resp.read()


def _cost_run(pkg, setup, make_engine, monkeypatch, config):
    """One package's run: three requests submitted in-process (tenant "a",
    a prefix hit for tenant "b", and one with no tenant), then one over HTTP
    with the tenant in the header and one with it in the JSON body, all on a
    hand-stepped scheduler whose clock advances one second a tick and whose
    engine reports 1 ms a fed token plus 0.1 ms a sequence per dispatch."""
    tel = jtel if pkg == "jax" else ttel
    session = tel.configure({"enabled": True})
    clock = _Clock()
    monkeypatch.setattr(j_scheduler_mod if pkg == "jax" else t_scheduler_mod, "time", clock)
    if pkg == "jax":
        engine = _jax_engine(setup)
        sched = jserving.ServingScheduler(engine, jserving.ServingConfig(**config), start=False)
        server_cls = jserving.ServingServer
    else:
        engine = make_engine()
        sched = ServingScheduler(engine, ServingConfig(**config), start=False)
        server_cls = ServingServer
    observed = []
    inner = engine.dispatch_observer

    def observer(kind, n_seqs, n_tokens, seconds):
        seconds = 1e-3 * n_tokens + 1e-4 * n_seqs
        observed.append(seconds)
        inner(kind, n_seqs, n_tokens, seconds)

    engine.dispatch_observer = observer
    rows = []

    def tick():
        clock.t += 1.0
        sched.step()
        rows.append([r["cost"] for r in sched.stats()["requests"]])

    pattern = [11, 12, 13, 14, 15, 16]
    prompt = (pattern * 7)[:40]
    reqs = [sched.submit(prompt, max_new_tokens=6, tenant="a")]
    for _ in range(3):
        tick()
    reqs.append(sched.submit(prompt[:32] + [3, 4, 5], max_new_tokens=5, tenant="b"))
    reqs.append(sched.submit(list(range(40, 49)), max_new_tokens=4))
    for _ in range(200):
        if all(r.finished for r in reqs):
            break
        tick()
    server = server_cls(sched, host="127.0.0.1", port=0).start()
    finals = []
    try:
        for body, headers in (({"prompt": pattern * 3, "max_new_tokens": 5}, {"X-DSTPU-Tenant": "hdr"}),
                              ({"prompt": [7, 8, 9, 10], "max_new_tokens": 4, "tenant": "json"}, None)):
            out = []
            client = threading.Thread(target=lambda: out.append(_http(server.url, "/v1/generate", body, headers)))
            client.start()
            deadline = time.monotonic() + WAIT_S
            while client.is_alive() and time.monotonic() < deadline:
                if sched.queue_depth or sched.stats()["active"]["total"]:
                    tick()
                else:
                    time.sleep(0.002)
            client.join(timeout=WAIT_S)
            assert not client.is_alive() and out
            # times, handles and trace ids differ by nature (as in the serving parity tests)
            finals.append({k: v for k, v in _mask(json.loads(out[0])).items() if k != "trace_id"})
        usage_bytes = _http(server.url, "/v1/usage")
        stats = sched.stats()
    finally:
        server.stop(drain=False)
        sched.stop(drain=False)
        engine.close()
    book = sched._ledger.pricebook
    run = dict(usage=json.loads(usage_bytes), usage_bytes=usage_bytes, finals=finals, rows=rows,
               costs=[r.cost.to_dict() for r in reqs], tenants=[r.tenant for r in reqs],
               states=[r.state.name for r in reqs], perf=stats["perf"], observed=observed,
               counters=stats["counters"], book=book)
    session.close()
    return run


@pytest.fixture
def cost_runs(setup, make_engine, monkeypatch):
    config = dict(prefix_cache={"enabled": True}, speculative={"enabled": True, "drafter": "prompt_lookup"},
                  cost={"perf_chip": "cpu-host", "perf_baseline_dispatches": 2})
    return {pkg: _cost_run(pkg, setup, make_engine, monkeypatch, config) for pkg in ("jax", "port")}


def test_usage_rows_and_wire_bytes_equal_the_jax_scheduler(cost_runs):
    jax_run, port_run = cost_runs["jax"], cost_runs["port"]
    assert jax_run["book"].source == "fallback" and port_run["book"].source == "analytic"  # C5
    chip = chip_specs.get_chip_spec("cpu-host")
    for key in ("usage", "finals", "rows", "costs", "perf"):
        assert _priced(port_run[key], port_run["book"], chip) == _priced(jax_run[key], jax_run["book"], chip), key
    # /v1/usage byte for byte once each side's prices are put back as text
    as_text = [json.dumps(_priced(json.loads(r["usage_bytes"]), r["book"], chip)) for r in (jax_run, port_run)]
    assert as_text[0] == as_text[1]
    for key in ("observed", "counters", "tenants", "states"):
        assert port_run[key] == jax_run[key], key
    counters = port_run["counters"]
    assert counters["prefix_hits"] >= 1 and counters["spec_drafted"] > 0
    assert port_run["tenants"] == ["a", "b", "default"]
    assert [f["tenant"] for f in port_run["finals"]] == ["hdr", "json"]


def test_bills_conserve(cost_runs):
    run = cost_runs["port"]
    usage, totals = run["usage"], run["usage"]["totals"]
    tenants = usage["tenants"]
    assert set(tenants) == {"a", "b", "default", "hdr", "json"}
    for field in ("prefill", "decode", "verify", "tree_verify", "billed"):
        assert sum(t["tokens"][field] for t in tenants.values()) == totals["tokens"][field]
    # (a request's "dispatches" counts each dispatch it rode, so a batch of
    # two tenants counts twice there: not a conserved field)
    assert sum(t["requests"] for t in tenants.values()) == totals["requests"] == 5
    for group, key in (("saved_tokens", "prefix"), ("saved_tokens", "spec"), ("speculative", "drafted"),
                       ("speculative", "accepted")):
        assert sum(t[group][key] for t in tenants.values()) == totals[group][key]
    for field in ("device_seconds", "amnesty_seconds"):
        assert sum(t[field] for t in tenants.values()) == pytest.approx(totals[field], rel=1e-9)
    assert totals["saved_tokens"]["prefix"] >= 32 and totals["saved_tokens"]["spec"] > 0
    # every observed second was billed to a request, as device time or amnesty
    assert totals["device_seconds"] + totals["amnesty_seconds"] == pytest.approx(sum(run["observed"]), rel=1e-9)
    assert totals["amnesty_seconds"] > 0 and totals["device_seconds"] > 0
    # each request's final bill folds into its own tenant's row
    for final in run["finals"]:
        row = tenants[final["tenant"]]
        assert row["requests"] == 1 and final["cost"]["tokens"] == row["tokens"]
        assert final["cost"]["device_seconds"] == pytest.approx(row["device_seconds"], abs=2e-6)
    assert sum(c["tokens"]["billed"] for c in run["costs"]) + sum(
        f["cost"]["tokens"]["billed"] for f in run["finals"]) == totals["tokens"]["billed"]
    # a request row's cost-to-date grows as the request runs
    assert any(row and row[0]["kv_block_s"] > 0 and row[0]["device_ms"] > 0 for row in run["rows"])


def test_a_dropped_charge_breaks_conservation(setup, make_engine, monkeypatch):
    """Control: a ledger that drops one decode charge of tenant "a" no longer
    sums the observed seconds, and its tenant rows no longer match what the
    requests were billed."""
    original = t_ledger.CostLedger.charge_dispatch
    dropped = []

    def drop_one(self, members, seconds, amnesty_s=0.0):
        if not dropped and members and members[0][1] == "decode" and seconds > 0:
            dropped.append(seconds)
            return
        original(self, members, seconds, amnesty_s)

    monkeypatch.setattr(t_ledger.CostLedger, "charge_dispatch", drop_one)
    config = dict(prefix_cache={"enabled": True}, speculative={"enabled": True, "drafter": "prompt_lookup"})
    run = _cost_run("port", setup, make_engine, monkeypatch, config)
    totals = run["usage"]["totals"]
    assert dropped
    assert totals["device_seconds"] + totals["amnesty_seconds"] != pytest.approx(sum(run["observed"]), rel=1e-9)


def test_perf_block_names_the_h100_and_amnesties_each_first_sight(make_engine):
    ttel.configure({"enabled": True})
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(cost=CostConfig(perf_baseline_dispatches=2)), start=False)
    sights = []
    inner = engine.dispatch_observer
    engine.dispatch_observer = lambda *a: sights.append(a[:3]) or inner(*a)
    try:
        for _ in range(2):
            reqs = [sched.submit(list(range(9)), max_new_tokens=6) for _ in range(2)]
            _run_until(sched, lambda: all(r.finished for r in reqs))
        perf = sched.stats()["perf"]
        assert perf["chip"] == "h100"
        seen = {}
        for kind, n_seqs, n_tokens in sights:
            key = (t_observed.PerfObservedLedger.program_for(kind, n_seqs, n_tokens), t_observed._bucket(n_tokens))
            seen[key] = seen.get(key, 0) + 1
        assert {(r["program"], r["bucket"]): r["dispatches"] + 1 for r in perf["programs"]} == seen
        assert {r["program"] for r in perf["programs"]} >= {"prefix_suffix_prefill", "paged_decode_step"}
        usage = sched.usage()
        assert usage["pricing"]["source"] == "analytic" and usage["totals"]["amnesty_seconds"] > 0
    finally:
        sched.stop(drain=False)


def test_cost_plane_zero_cost_when_disabled(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    try:
        reqs = [sched.submit(list(range(9)), max_new_tokens=2, tenant=t) for t in ("a", "b", None)]
        _run_until(sched, lambda: all(r.finished for r in reqs))
        assert all(r.state is RequestState.DONE and r.cost is None for r in reqs)
        assert reqs[2].tenant == "default"
        assert sched.usage() == {"enabled": False} and sched.stats()["perf"] is None
        assert engine.dispatch_observer is None
        assert ttel.get_registry().api_calls == 0
    finally:
        sched.stop(drain=False)


def test_cost_disabled_with_telemetry_builds_no_ledger(make_engine):
    ttel.configure({"enabled": True})
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(cost=CostConfig(enabled=False)), start=False)
    req = sched.submit([1, 2, 3], max_new_tokens=2)
    _run_until(sched, lambda: req.finished)
    assert req.cost is None and sched.usage() == {"enabled": False} and engine.dispatch_observer is None
    sched.stop(drain=False)


def test_stop_detaches_the_observer(make_engine):
    ttel.configure({"enabled": True})
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    assert engine.dispatch_observer == sched._on_dispatch
    sched.stop(drain=False)
    assert engine.dispatch_observer is None
    again = ServingScheduler(engine, ServingConfig(), start=False)
    assert engine.dispatch_observer == again._on_dispatch
    again.kill()
    assert engine.dispatch_observer is None


def _drift_arm(make_engine, inject_delay_s):
    """The JAX package's chaos-gate arm, with the engine reporting 1 ms a fed
    token plus 0.1 ms a sequence (a steady card, whatever the CPU's load),
    and ``inject_delay_s`` added to every dispatch after the baseline."""
    ttel.shutdown()
    ttel.state.registry = None
    ttel.configure({"enabled": True})
    engine = make_engine()
    cfg = ServingConfig(cost=CostConfig(perf_baseline_dispatches=2, perf_drift_consecutive=2, perf_drift_factor=4.0))
    sched = ServingScheduler(engine, cfg, start=False)
    inner, delay = engine.dispatch_observer, [0.0]
    engine.dispatch_observer = lambda k, n, t, s: inner(k, n, t, 1e-3 * t + 1e-4 * n + delay[0])
    try:
        warm = sched.submit(list(range(9)), max_new_tokens=8)
        _run_until(sched, lambda: warm.finished)
        assert any(r["baseline_ratio"] is not None for r in sched.stats()["perf"]["programs"])
        delay[0] = inject_delay_s
        slow = sched.submit(list(range(9)), max_new_tokens=8)
        _run_until(sched, lambda: slow.finished)
        drift = sum(r["drift_events"] for r in sched.stats()["perf"]["programs"])
        events = [e for e in ttel.get_registry().recent_events_snapshot() if e.get("event") == "perf_drift"]
        return drift, events
    finally:
        sched.stop(drain=False)


def test_injected_slowdown_raises_a_drift_event_and_the_control_stays_quiet(make_engine):
    assert _drift_arm(make_engine, 0.0) == (0, [])
    drift, events = _drift_arm(make_engine, 0.25)
    assert drift >= 1 and events and events[-1]["ratio"] > events[-1]["baseline"]
    assert events[-1]["program"] in ("paged_decode_step", "prefix_suffix_prefill")
