"""Port parity: the metric time-series store and the SLO engine of
deepspeed_tpu_torch against deepspeed_tpu's.

The same registry operations and the same hand-driven ticks go to both
packages' ``TimeSeriesStore`` and ``SLOEngine``: the snapshots, the SLO
statuses, breach signals and breach counts must be equal tick for tick, for
every objective kind. The JAX package's own store and engine cases run on
both packages. Then two schedulers side by side with
``overload.slo_pressure``: an ITL objective the engine cannot meet lifts the
brownout stage in both at the same ticks, and a loose one does not.
"""

import glob
import os

import numpy as np
import pytest

from deepspeed_tpu import serving as jserving
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.telemetry import slo as j_slo
from deepspeed_tpu.telemetry import timeseries as j_timeseries
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler
from deepspeed_tpu_torch.telemetry import slo as t_slo
from deepspeed_tpu_torch.telemetry import timeseries as t_timeseries
from tests.test_torch_serving import (_jax_engine, clear_jax_caches, fresh_telemetry, make_engine,  # noqa: F401
                                      setup)

PKGS = {"jax": (jtel, j_timeseries, j_slo), "port": (ttel, t_timeseries, t_slo)}
LAT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0)
OBJECTIVES = {
    "ttft": dict(metric="ttft", target_s=0.1, target_ratio=0.9),
    "itl": dict(metric="itl", target_s=0.05, target_ratio=0.95),
    "e2e": dict(metric="e2e", target_s=0.5, target_ratio=0.9),
    "error_rate": dict(metric="error_rate", target_ratio=0.95),
    "goodput": dict(metric="goodput", target_ratio=0.9),
    "perf_drift": dict(metric="perf_drift", target_ratio=0.99),
}


def _drive(pkg, objective, ticks=24):
    """One package's store and engine under a seeded load with a bad burst
    in ticks 8-13; returns per tick the status, breach signal, breach count
    and the store's snapshot."""
    tel, timeseries, slo = PKGS[pkg]
    reg = tel.MetricsRegistry()
    hists = {name: reg.histogram(name, name, buckets=LAT_BUCKETS)
             for name in ("serving_ttft_seconds", "serving_inter_token_seconds", "serving_e2e_latency_seconds",
                          "perf_observed_dispatch_seconds")}
    counters = {name: reg.counter(name, name)
                for name in ("serving_completions_total", "serving_failures_total", "serving_timeouts_total",
                             "serving_rejections_total", "serving_shed_admission_total", "serving_shed_queue_total",
                             "perf_drift_events_total")}
    store = timeseries.TimeSeriesStore(reg, interval_s=1.0, retention_points=32)
    spec = dict(name=objective["metric"], fast_window_s=3.0, slow_window_s=9.0, burn_threshold=2.0, **objective)
    engine = slo.SLOEngine(tel.SLOConfig(enabled=True, objectives=[spec]), store, reg)
    rng = np.random.default_rng(11)
    out = []
    for t in range(ticks):
        burst = 8 <= t < 14
        for hist in hists.values():
            for _ in range(int(rng.integers(5, 15))):
                hist.observe(float(rng.uniform(0.2, 0.9) if burst and rng.random() < 0.7 else rng.uniform(0, 0.04)))
        counters["serving_completions_total"].inc(int(rng.integers(5, 10)))
        if burst:
            counters["serving_failures_total"].inc(int(rng.integers(1, 4)))
            counters["serving_shed_admission_total"].inc(int(rng.integers(2, 6)))
            counters["perf_drift_events_total"].inc()
        store.tick(now=float(t))
        out.append((engine.status(), engine.breach_signal(), engine.in_breach(),
                    reg.counter("slo_breaches_total").value, store.snapshot(max_points=8, window_s=4.0)))
    return out


@pytest.mark.parametrize("kind", list(OBJECTIVES))
def test_statuses_equal_tick_for_tick(kind):
    jax_run, port_run = _drive("jax", OBJECTIVES[kind]), _drive("port", OBJECTIVES[kind])
    assert port_run == jax_run
    breaching = [in_breach for _, _, in_breach, _, _ in port_run]
    assert any(breaching[8:14]) and not any(breaching[:8]) and not breaching[-1]
    assert port_run[-1][3] >= 1  # at least one episode counted


def _burn_engine(pkg, **objective):
    tel, timeseries, slo = PKGS[pkg]
    reg = tel.MetricsRegistry()
    hist = reg.histogram("serving_ttft_seconds", "ttft", buckets=(0.1, 0.5, 1.0))
    spec = dict(name="ttft", metric="ttft", target_s=0.1, target_ratio=0.9, fast_window_s=10.0, slow_window_s=30.0,
                burn_threshold=2.0, **objective)
    store = timeseries.TimeSeriesStore(reg, interval_s=1.0)
    return slo.SLOEngine(tel.SLOConfig(enabled=True, objectives=[spec]), store, reg), store, hist, reg


@pytest.mark.parametrize("pkg", list(PKGS))
def test_burn_rates_and_episodes_as_the_jax_unit_cases(pkg):
    engine, store, hist, reg = _burn_engine(pkg)
    store.tick(now=0.0)
    assert engine.breach_signal() == 0.0 and not engine.in_breach()  # no traffic burns nothing
    for value in [0.05] * 8 + [0.9] * 2:  # 2 bad of 10 over a 0.1 budget: burn 2
        hist.observe(value)
    store.tick(now=1.0)
    (obj, ) = engine.status()["objectives"]
    assert obj["fast_burn"] == pytest.approx(2.0, rel=0.01) and obj["slow_burn"] == pytest.approx(2.0, rel=0.01)
    for _ in range(20):
        hist.observe(0.9)
    store.tick(now=2.0)
    assert engine.in_breach() and engine.breach_signal() == 1.0
    breaches = reg.counter("slo_breaches_total")
    store.tick(now=13.0)
    store.tick(now=13.5)  # the fast window drains: the episode closes
    assert not engine.in_breach() and breaches.value == 1
    for _ in range(20):
        hist.observe(0.9)
    store.tick(now=14.0)
    assert engine.in_breach() and breaches.value == 2


@pytest.mark.parametrize("pkg", list(PKGS))
def test_windowed_store_reads_as_the_jax_unit_cases(pkg):
    tel, timeseries, _ = PKGS[pkg]
    reg = tel.MetricsRegistry()
    c = reg.counter("req_total", "requests", labels={"op": "a"})
    reg.counter("req_total", "requests", labels={"op": "b"}).inc(1)
    h = reg.histogram("lat_seconds", "lat", buckets=(0.1, 0.5, 1.0))
    store = timeseries.TimeSeriesStore(reg, interval_s=1.0, retention_points=4,
                                       families=("req_total", "lat_seconds"))
    for _ in range(100):
        h.observe(0.05)
    for t in range(5):
        c.inc(10)
        store.tick(now=float(t))
    for _ in range(10):
        h.observe(0.9)
    store.tick(now=5.0)
    assert store.last("req_total") == 51 and store.window_delta("req_total", 2.0) == 10
    assert 0.5 < store.window_percentile("lat_seconds", 0.5, window_s=1.5) <= 1.0
    assert store.window_bad_fraction("lat_seconds", 0.5, 1.5) == pytest.approx(1.0)
    assert len(store.snapshot()["series"]["req_total"]["points"]) == 4
    assert timeseries.bad_fraction(10, (0.1, 0.5, 1.0), [0, 10, 0], 0.3) == pytest.approx(0.5)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_session_builds_and_stops_the_store_and_engine(pkg, tmp_path):
    tel = PKGS[pkg][0]
    session = tel.configure({"enabled": True,
                             "flight_recorder": {"enabled": True, "dir": str(tmp_path), "watchdog_enabled": False,
                                                 "signal_enabled": False},
                             "timeseries": {"interval_s": 60.0},
                             "slo": {"enabled": True, "objectives": [OBJECTIVES["ttft"]]}})
    try:
        store = tel.get_timeseries()
        assert store is not None  # SLOs imply the store without timeseries.enabled
        hist = tel.get_registry().histogram("serving_ttft_seconds", "ttft", buckets=(0.1, 0.5, 1.0))
        store.tick(now=0.0)
        for _ in range(20):
            hist.observe(0.9)
        store.tick(now=1.0)
        store.tick(now=2.0)  # the same episode: one dump
        assert len(glob.glob(os.path.join(str(tmp_path), "*slo_breach*.json"))) == 1
        assert tel.get_slo_engine().status()["in_breach"]
    finally:
        session.close()
    assert tel.get_timeseries() is None and tel.get_slo_engine() is None
    assert store._thread is None  # the sampler thread stopped with the session


def _pressure_run(pkg, setup, make_engine, target_s):
    """A hand-stepped scheduler with ``slo_pressure`` under an ITL objective
    of ``target_s``; the store ticks once a scheduler tick, one second
    apart. The engine serves the same requests once before, with telemetry
    off, so that no gap in the measured run holds a JAX compile (a gap past
    the histogram's last bucket, 2.5 s, counts as bad against any target).
    Returns the brownout stage and the SLO's breach after each tick."""
    tel = PKGS[pkg][0]
    objective = dict(name="itl", metric="itl", target_s=target_s, target_ratio=0.99, fast_window_s=5.0,
                     slow_window_s=20.0, burn_threshold=2.0)
    config = dict(decode_chunk=1, overload={"slo_pressure": True})
    engine = _jax_engine(setup) if pkg == "jax" else make_engine()
    scheduler_cls = jserving.ServingScheduler if pkg == "jax" else ServingScheduler
    config_cls = jserving.ServingConfig if pkg == "jax" else ServingConfig
    prompts = [list(range(5 + i, 14 + i)) for i in range(3)]
    tel.shutdown()
    warm = scheduler_cls(engine, config_cls(**config), start=False)
    for prompt in prompts:
        warm.submit(prompt, max_new_tokens=12)
    warm.stop(drain=True)
    # the sampler thread's interval is an hour: only the test ticks the store
    tel.configure({"enabled": True, "timeseries": {"interval_s": 3600.0},
                   "slo": {"enabled": True, "objectives": [objective]}})
    sched = scheduler_cls(engine, config_cls(**config), start=False)
    store = tel.get_timeseries()
    trace = []
    try:
        reqs = [sched.submit(prompt, max_new_tokens=12) for prompt in prompts]
        for t in range(40):
            if all(r.finished for r in reqs):
                break
            sched.step()
            store.tick(now=float(t))
            trace.append((sched.stats()["overload"]["brownout_stage"], tel.get_slo_engine().in_breach()))
        assert all(r.finished for r in reqs)
        tokens = [list(r.tokens) for r in reqs]
    finally:
        sched.stop(drain=False)
        tel.shutdown()
    return trace, tokens


def test_slo_pressure_lifts_brownout_like_the_jax_scheduler(setup, make_engine):
    jax_run, port_run = _pressure_run("jax", setup, make_engine, 1e-6), _pressure_run("port", setup, make_engine, 1e-6)
    assert port_run == jax_run
    stages = [stage for stage, _ in port_run[0]]
    assert max(stages) >= 1 and any(breach for _, breach in port_run[0])


def test_slo_pressure_control_with_a_loose_objective(setup, make_engine):
    jax_run, port_run = _pressure_run("jax", setup, make_engine, 10.0), _pressure_run("port", setup, make_engine, 10.0)
    assert port_run == jax_run
    assert all(stage == 0 and not breach for stage, breach in port_run[0])
