"""Training telemetry and the prefetching loader on the port, on the CPU:
the mirrors of tests/unit/telemetry/test_engine_telemetry.py (the same event
fields and gauge names; zero telemetry calls when it is off) and of
tests/unit/runtime/test_prefetch.py's five cases, on the MLP of
tests/test_torch_training.py."""

import json
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.runtime.dataloader import FusedHostBatch, PrefetchingLoader, StagedBatch
from deepspeed_tpu_torch.utils.timer import NoopTimer, SynchronizedWallClockTimer
from tests.test_torch_training import HIDDEN, SimpleModel, _random_batches


def _engine(tmp_path=None, telemetry_enabled=False, micro=8, gas=1, extra=None):
    config = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **(extra or {})}
    if telemetry_enabled:
        config["telemetry"] = {"enabled": True, "jsonl_path": str(tmp_path / "metrics.jsonl"),
                               "trace_path": str(tmp_path / "trace.json")}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config=config, device="cpu")
    return engine


def test_enabled_engine_emits_jsonl_and_chrome_trace(tmp_path):
    engine = _engine(tmp_path, telemetry_enabled=True)
    batches = _random_batches(4, 8)
    losses = []
    try:
        # micro-step API steps (fwd/bwd/step spans), then the fused path
        for batch in batches[:3]:
            loss = engine.forward(batch)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        losses.append(float(engine.train_batch(batch=batches[3])))
        assert isinstance(engine.timers._inner, SynchronizedWallClockTimer)
    finally:
        engine.destroy()  # flushes the trace and the JSONL sink
    assert telemetry.state.active is False

    events = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    steps = [e for e in events if e["event"] == "train_step"]
    assert len(steps) == 4
    assert all("loss" in e and "lr" in e for e in steps)
    assert [e["loss"] for e in steps] == losses and [e["step"] for e in steps] == [1, 2, 3, 4]
    assert any("samples_per_sec" in e for e in steps[1:])
    assert all("grad_norm" in e and "skipped_steps" in e and "samples" in e for e in steps)

    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    names = [e["name"] for e in evs]
    # collectives (the reference's all_reduce span) come with ROADMAP A8
    assert {"fwd_microstep", "bwd_microstep", "step_microstep", "train_batch"} <= set(names)
    assert names.count("train_batch") == 1 and names.count("step_microstep") == 3
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    assert all(e["ph"] == "X" for e in evs)
    assert {"engine"} <= {e["cat"] for e in evs} <= {"engine", "comm", "compile"}


def test_enabled_engine_populates_registry_gauges(tmp_path):
    engine = _engine(tmp_path, telemetry_enabled=True)
    try:
        for batch in _random_batches(2, 8):
            loss = engine.train_batch(batch=batch)
        snap = telemetry.get_registry().snapshot()
        assert snap["train_global_steps"][0][1] == 2
        assert snap["train_samples_total"][0][1] >= 2 * engine.train_batch_size()
        assert snap["train_loss"][0][1] == float(loss) > 0
        for name in ("train_lr", "train_grad_norm", "train_skipped_steps", "train_samples_per_sec"):
            assert name in snap, name
    finally:
        engine.destroy()
    assert telemetry.state.active is False


def test_disabled_hot_path_makes_zero_telemetry_calls(monkeypatch):
    """Off (the default), the engine's hot paths make no telemetry call
    beyond a boolean check, as the registry's own call counter shows."""
    probe = telemetry.MetricsRegistry()
    monkeypatch.setattr(telemetry.state, "registry", probe)
    engine = _engine()
    assert telemetry.state.active is False
    batches = _random_batches(3, 8)
    loss = engine.forward(batches[0])
    engine.backward(loss)
    engine.step()
    engine.train_batch(batch=batches[1])
    assert probe.api_calls == 0
    assert telemetry.state.spans is None
    # the default timers stayed no-op (no span wrapper, no synchronize)
    assert isinstance(engine.timers, NoopTimer) and not engine.tput_timer.config.synchronized


# ------------------------------------------------------------------ prefetching --
def _pf_engine(gas=2, extra=None):
    return _engine(micro=16, gas=gas, extra=extra)


def test_prefetch_matches_direct():
    """The same batches through PrefetchingLoader and directly give the same
    losses and final parameters, bit for bit."""
    batches = _random_batches(4, 32)  # gas 2 x micro 16
    eng_a = _pf_engine()
    direct = [float(eng_a.train_batch(batch=b)) for b in batches]
    eng_b = _pf_engine()
    prefetched = []
    for staged in PrefetchingLoader(batches, eng_b, depth=2):
        assert isinstance(staged, StagedBatch) and staged.tree[0].shape == (2, 16, HIDDEN)
        prefetched.append(float(eng_b.train_batch(batch=staged)))
    assert prefetched == direct
    for name, p in eng_a.params.items():
        assert torch.equal(p, eng_b.params[name]), name


def test_prefetch_via_data_iter():
    """train_batch(data_iter=...) takes the pre-staged batches."""
    eng = _pf_engine()
    it = iter(PrefetchingLoader(_random_batches(3, 32), eng, depth=1))
    for _ in range(3):
        assert np.isfinite(float(eng.train_batch(data_iter=it)))
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_runs_ahead():
    """The worker stages batches while the consumer is busy; close() stops
    it mid-epoch without hanging."""
    eng = _pf_engine()
    pf = PrefetchingLoader(_random_batches(4, 32), eng, depth=2)
    it = iter(pf)
    next(it)
    deadline = time.monotonic() + 5.0
    while it._q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert it._q.qsize() >= 1, "the worker should have staged ahead"
    thread = it._thread
    pf.close()
    assert not thread.is_alive()


def test_prefetch_with_curriculum_defers_staging():
    """The curriculum's difficulty belongs to the step that consumes a
    batch: the worker yields host batches (FusedHostBatch), train_batch
    stages them, and the run equals the direct one."""
    curriculum = {"curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": HIDDEN, "max_difficulty": HIDDEN,
        "schedule_type": "fixed_linear", "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}}
    batches = _random_batches(4, 32)
    eng_a = _pf_engine(extra=curriculum)
    direct = [float(eng_a.train_batch(batch=b)) for b in batches]
    eng_b = _pf_engine(extra=curriculum)
    it = iter(PrefetchingLoader(batches, eng_b, depth=2))
    first = next(it)
    assert isinstance(first, FusedHostBatch), "curriculum runs must not pre-stage"
    prefetched = [float(eng_b.train_batch(batch=first))] + [float(eng_b.train_batch(batch=b)) for b in it]
    assert prefetched == direct


def test_prefetch_surfaces_loader_errors():

    class Boom:

        def __iter__(self):
            raise RuntimeError("bad dataset")

        def __len__(self):
            return 0

    it = iter(PrefetchingLoader(Boom(), _pf_engine()))
    with pytest.raises(RuntimeError, match="bad dataset"):
        next(it)


def test_timers_match_reference_on_the_same_clock(monkeypatch):
    """utils/timer.py against the JAX package's on one scripted clock: the
    named timers' elapsed and mean, and the throughput timer's counts and
    running samples/s (warm-up steps before start_step left out)."""
    from deepspeed_tpu.utils import timer as jtimer
    from deepspeed_tpu_torch.utils import timer as ttimer

    def run(mod):
        ticks = iter(np.cumsum(np.arange(1, 100, dtype=np.float64) * 0.01))
        monkeypatch.setattr(mod.time, "time", lambda: float(next(ticks)))
        timers = mod.SynchronizedWallClockTimer()
        for _ in range(3):
            timers("fwd").start()
            timers("fwd").stop()
        cfg = type("cfg", (), {"enabled": True})()
        tput = mod.ThroughputTimer(cfg, batch_size=8, start_step=2, logging_fn=lambda msg: None)
        for _ in range(5):
            tput.start()
            tput.stop(global_step=True)
        return (timers("fwd").mean(), timers("fwd").elapsed(), tput.global_step_count, tput.micro_step_count,
                tput.avg_samples_per_sec(), mod.NoopTimer()("x").elapsed())

    assert run(ttimer) == pytest.approx(run(jtimer), rel=1e-12)


def test_config_reads_the_training_feature_blocks_as_the_reference():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    blocks = {"train_batch_size": 8, "steps_per_print": 5, "wall_clock_breakdown": True,
              "progressive_layer_drop": {"enabled": True, "theta": 0.4}, "eigenvalue": {"enabled": True},
              "curriculum_learning": {"enabled": True, "min_difficulty": 8, "max_difficulty": 16},
              "data_efficiency": {"enabled": True, "data_sampling": {"enabled": True}},
              "compression_training": {"sparse_pruning": {"shared_parameters": {"enabled": True}}},
              "telemetry": {"enabled": True, "max_spans": 128}}
    fields = ("steps_per_print", "wall_clock_breakdown", "pld_enabled", "progressive_layer_drop", "eigenvalue_enabled",
              "curriculum_enabled_legacy", "curriculum_params_legacy", "data_efficiency_config", "compression_config")
    for cfg in (blocks, {"train_batch_size": 8}):
        port, ref = DeepSpeedConfig(dict(cfg)), JConfig(dict(cfg))
        assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        assert (port.telemetry_config.enabled, port.telemetry_config.max_spans) == \
            (ref.telemetry_config.enabled, ref.telemetry_config.max_spans)
