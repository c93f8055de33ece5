"""Port parity: deepspeed_tpu_torch.serving against deepspeed_tpu.serving.

Side by side: the JAX ``ServingScheduler`` over the JAX engine and the
port's over the port's engine get the same weights (the reference's tiny f32
Llama, carried across by ``models/convert.py``), the same prompts (numpy
seeds) and the same submits and ticks (``start=False``, stepped by hand). The
per-tick token counts and states, the token streams, finish reasons and every
scheduler counter must be equal, with and without KV pressure.

Sampled streams must be equal too. Both schedulers draw on the host from
``numpy.random.default_rng(seed)`` over the f32 logits, which agree within
1e-4 (``tests/test_torch_engine.py``, TOL): a draw can only differ where its
uniform variate lands within that of a boundary of the cumulative
distribution, which these seeds do not hit.

The HTTP servers get the same bodies on ephemeral ports; their JSON and SSE
bytes must be equal with only ``MASKED`` fields replaced (and SSE keepalive
comments, which only timing decides, dropped). The rest mirrors
``tests/unit/serving/test_{request,scheduler,server,overload}.py`` on the
port's engine (one test per ported path; repeats are parametrised), and
checks that every A5/A6 path raises, naming its queue item. Every wait on a
thread has a timeout.
"""

import json
import queue
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu import serving as jserving
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.serving import request as j_request
from deepspeed_tpu_torch import serving as tserving
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.models.llama import LlamaModel
from deepspeed_tpu_torch.serving import (AdmissionRejected, BrownoutController, QueueFullError, RateEstimator,
                                         RequestState, SchedulerStopped, ServingConfig, ServingScheduler,
                                         ServingServer)
from deepspeed_tpu_torch.serving import request as t_request
from deepspeed_tpu_torch.serving.config import CostConfig, OverloadConfig
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

MAX_STEPS = 400  # safety bound for manual stepping loops
WAIT_S = 60  # bound on every wait for a thread or a request
# fields of a response document that hold times, ids drawn from a
# process-wide counter (each package numbers its request handles itself), or
# the smoothed overload pressure, which decays with every idle tick of the
# background loop and so with wall time
MASKED = ("ttft_s", "e2e_s", "handle", "age_s", "uptime_s", "rate_tokens_per_s", "retry_after_s", "pressure")


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    """This file builds and drops many JAX engines: leave the worker's JAX
    caches as a fresh process has them, so no compiled program of these
    tests can stand in for a later file's first compile."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tel in (jtel, ttel):
        tel.shutdown()
        tel.state.registry = None
    yield
    for tel in (jtel, ttel):
        tel.shutdown()
        tel.state.registry = None


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    cfg = port_config(jcfg)
    params = port_params(jcfg, jparams)
    return jcfg, jparams, cfg, params


@pytest.fixture
def make_engine(setup):
    """Port engine factory with a small, test-controllable KV pool; every
    engine built through it is closed at teardown."""
    _, _, cfg, params = setup
    engines = []

    def _make(num_blocks=64, block_size=16, **mgr_kw):
        mgr_kw.setdefault("max_context", 512)
        mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=num_blocks),
                                   **mgr_kw)
        engine = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=block_size),
                              device="cpu")
        engines.append(engine)
        return engine

    yield _make
    for engine in engines:
        engine.close()


def _jax_engine(setup, num_blocks=64, block_size=16, **mgr_kw):
    jcfg, jparams, _, _ = setup
    mgr_kw.setdefault("max_context", 512)
    mgr = j_mc.DSStateManagerConfig(memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE,
                                                                    size=num_blocks), **mgr_kw)
    return j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(state_manager=mgr,
                                                                                      kv_block_size=block_size))


def _run_until(sched, pred, max_steps=MAX_STEPS):
    for _ in range(max_steps):
        if pred():
            return
        sched.step()
    raise AssertionError(f"predicate not reached in {max_steps} steps")


def _greedy(setup, prompt, n):
    """The port's dense f32 model, greedy: the tokens serving must give."""
    _, _, cfg, params = setup
    model = LlamaModel(cfg)
    model.load_state_dict(params)
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            out.append(int(model(torch.tensor([toks]))[0, -1].argmax()))
            toks.append(out[-1])
    return out


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


# ------------------------------------------------------------- side by side --
def _side_by_side(setup, script, engine_kw=None, config_kw=None):
    """Apply ``script`` (("submit", kwargs) and ("step", n) entries) to the
    JAX scheduler and the port's, then step both until every request has
    finished. Returns, per package, the per-tick trace of (tokens so far,
    state) for every request, the requests and the final counters."""
    engine_kw, config_kw = engine_kw or {}, config_kw or {}
    runs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            engine = _jax_engine(setup, **engine_kw)
            sched = jserving.ServingScheduler(engine, jserving.ServingConfig(**config_kw), start=False)
        else:
            _, _, cfg, params = setup
            kw = dict(engine_kw)
            nb, bs = kw.pop("num_blocks", 64), kw.pop("block_size", 16)
            kw.setdefault("max_context", 512)
            mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=nb), **kw)
            engine = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=bs),
                                  device="cpu")
            sched = ServingScheduler(engine, ServingConfig(**config_kw), start=False)
        reqs, trace = [], []

        def tick():
            sched.step()
            trace.append([(len(r.tokens), r.state.name) for r in reqs])

        for op, arg in script:
            if op == "submit":
                reqs.append(sched.submit(**arg))
            elif op == "cancel":
                reqs[arg].cancel()
            else:
                for _ in range(arg):
                    tick()
        for _ in range(MAX_STEPS):
            if all(r.finished for r in reqs):
                break
            tick()
        assert all(r.finished for r in reqs), f"{pkg}: requests did not finish"
        counters = sched.stats()["counters"]
        sched.stop(drain=False)
        runs.append(dict(trace=trace, tokens=[list(r.tokens) for r in reqs],
                         states=[r.state.name for r in reqs], finish=[r.finish_reason for r in reqs],
                         errors=[r.error for r in reqs], counters=counters, free=engine.free_blocks,
                         tracked=engine._state_manager.n_tracked_sequences))
        engine.close()
    return runs


def _submit(prompt, **kw):
    return ("submit", dict(prompt=prompt, **kw))


SCENARIOS = {
    # two requests submitted a tick apart (continuous admission) and a third
    # later, one of them ending on an eos token
    "overlapping_greedy": (lambda p: [_submit(p[0], max_new_tokens=6), ("step", 1),
                                      _submit(p[1], max_new_tokens=4), ("step", 2),
                                      _submit(p[2], max_new_tokens=5, eos_token_id=7)],
                           (13, 5, 21), {}, {}),
    # decode-only ticks run K=4 steps through decode_loop; the cap cuts
    # mid-chunk
    "chunked_decode": (lambda p: [_submit(p[0], max_new_tokens=7), _submit(p[1], max_new_tokens=10)],
                       (9, 17), {}, {"decode_chunk": 4}),
    # 40- and 30-token prompts through a 16-token budget: Dynamic SplitFuse
    # chunks, decode-first, and a cancel mid-prefill
    "splitfuse_and_cancel": (lambda p: [_submit(p[0], max_new_tokens=3), _submit(p[1], max_new_tokens=4),
                                        _submit(p[2], max_new_tokens=3), ("step", 2), ("cancel", 2)],
                             (40, 30, 33), {"max_ragged_batch_size": 16}, {}),
    # sampled requests with their own seeds beside a greedy one; chunking is
    # on but sampled members keep every tick on the put path
    "sampled": (lambda p: [_submit(p[0], max_new_tokens=6, temperature=0.8, seed=42),
                           _submit(p[1], max_new_tokens=6, temperature=1.0, seed=7),
                           _submit(p[2], max_new_tokens=6)],
                (9, 14, 5), {}, {"decode_chunk": 4}),
    # two 64-token prompts fill an 8-block pool: decode past the block
    # boundary evicts and restores in turn
    "kv_pressure": (lambda p: [_submit(p[0], max_new_tokens=3), _submit(p[1], max_new_tokens=3)],
                    (64, 64), {"num_blocks": 8, "max_context": 128}, {}),
    # a 62-token prompt in a 4-block pool: the prefill chunk halves
    "prefill_shrinks": (lambda p: [_submit(p[0], max_new_tokens=2)], (62, ), {"num_blocks": 4}, {}),
    # the context window cuts generation ("context"), on both decode paths
    "context_cut": (lambda p: [_submit(p[0], max_new_tokens=100), _submit(p[1], max_new_tokens=100)],
                    (30, 29), {"max_context": 32}, {}),
    "context_cut_chunked": (lambda p: [_submit(p[0], max_new_tokens=100)], (29, ), {"max_context": 32},
                            {"decode_chunk": 4}),
    # permanently infeasible requests fail at admission with the same errors
    "infeasible": (lambda p: [_submit([1] * 600, max_new_tokens=1), _submit([1] * 100, max_new_tokens=1),
                              _submit(p[0], max_new_tokens=2)],
                   (6, ), {"num_blocks": 4}, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_side_by_side_streams_states_and_counters(setup, name):
    script, lens, engine_kw, config_kw = SCENARIOS[name]
    prompts = _prompts(len(name), lens)
    jax_run, port_run = _side_by_side(setup, script(prompts), engine_kw, config_kw)
    assert port_run == jax_run
    assert port_run["tracked"] == 0 and port_run["free"] == engine_kw.get("num_blocks", 64)
    if name == "kv_pressure":
        assert port_run["counters"]["evictions"] >= 2  # both directions thrashed
        unpressured = _side_by_side(setup, script(prompts), {"max_context": 128}, config_kw)[1]
        assert unpressured["counters"]["evictions"] == 0
        assert port_run["tokens"] == unpressured["tokens"]
    if name == "overlapping_greedy":
        assert port_run["tokens"][0] == _greedy(setup, prompts[0], 6)
    if name.startswith("context_cut"):
        assert set(port_run["finish"]) == {"context"}


def test_sampled_requests_are_reproducible_despite_cobatching(make_engine):
    """temperature>0 output depends only on (prompt, seed), never on what
    else is in flight."""
    prompt, other = _prompts(11, (9, 14))

    def run(with_companion):
        sched = ServingScheduler(make_engine(), ServingConfig(decode_chunk=4), start=False)
        req = sched.submit(prompt, max_new_tokens=5, temperature=1.0, seed=42)
        if with_companion:
            sched.submit(other, max_new_tokens=5, temperature=0.7, seed=7)
        _run_until(sched, lambda: req.finished)
        sched.stop(drain=False)
        return req.result(timeout=1)

    assert run(with_companion=False) == run(with_companion=True)


# ----------------------------------------------------------------- generate --
def test_generate_greedy_and_sampled_match_the_jax_generate(setup, make_engine):
    prompts = _prompts(5, (4, 11, 19))
    for kw in ({}, {"decode_chunk": 3}, {"temperature": 0.9, "seed": 5}):
        want = j_factory.generate(_jax_engine(setup), prompts, max_new_tokens=5, **kw)
        engine = make_engine()
        assert generate(engine, prompts, max_new_tokens=5, **kw) == want, kw
        assert engine.serving_scheduler is None and engine.free_blocks == 64
    assert generate(make_engine(), [], max_new_tokens=3) == []


def test_generate_wrapper_joins_attached_scheduler(setup, make_engine):
    engine = make_engine()
    prompt = list(range(8))
    sched = ServingScheduler(engine, ServingConfig())
    try:
        out = generate(engine, [prompt], max_new_tokens=4)
        assert out[0] == _greedy(setup, prompt, 4)
        assert engine.serving_scheduler is sched  # still attached and running
        assert sched.stats()["counters"]["completed"] == 1
    finally:
        sched.stop(drain=False)


def test_generate_wrapper_raises_on_infeasible_prompt(make_engine):
    engine = make_engine(num_blocks=4, block_size=16)
    with pytest.raises(RuntimeError, match="KV blocks"):
        generate(engine, [[1] * 100], max_new_tokens=2)
    assert engine.serving_scheduler is None  # wrapper detached its scheduler


def test_generate_on_shared_scheduler_cancels_orphans_on_error(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(queue_capacity=1), start=False)
    with pytest.raises(QueueFullError):
        generate(engine, [[1, 2], [3, 4], [5, 6]], max_new_tokens=4)
    sched.step()  # honors the cancel flags
    assert sched.n_active == 0 and sched.queue_depth == 0
    assert sched.stats()["counters"]["cancelled"] == 1
    sched.stop(drain=False)


# --------------------------------------------------------------- scheduler --
def test_overlapping_requests_stream_per_request(setup, make_engine):
    engine = make_engine()
    p1, p2 = _prompts(0, (13, 5))
    sched = ServingScheduler(engine, ServingConfig())
    try:
        r1 = sched.submit(p1, max_new_tokens=6)
        assert r1.stream.get(timeout=WAIT_S) == r1.tokens[0]  # streamed live
        r2 = sched.submit(p2, max_new_tokens=4)
        out1, out2 = r1.result(timeout=WAIT_S), r2.result(timeout=WAIT_S)
    finally:
        sched.stop(drain=False)
    assert out1 == _greedy(setup, p1, 6) and out2 == _greedy(setup, p2, 4)
    assert r1.ttft_s is not None and r1.ttft_s <= r1.e2e_s
    assert engine._state_manager.n_tracked_sequences == 0


def test_cancel_mid_prefill_frees_kv_blocks(make_engine):
    engine = make_engine(max_ragged_batch_size=16)  # 40-token prompt = 3 chunks
    free0 = engine.free_blocks
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    req = sched.submit(list(range(40)), max_new_tokens=8)
    sched.step()
    assert req.state is RequestState.PREFILL and req._fed == 16
    assert engine.free_blocks < free0
    req.cancel()
    sched.step()
    assert req.state is RequestState.CANCELLED
    assert engine.free_blocks == free0 and engine._state_manager.n_tracked_sequences == 0
    assert req.result(timeout=1) == []
    sched.stop(drain=False)


def test_deadline_expiry_during_decode_frees_kv(make_engine):
    engine = make_engine()
    free0 = engine.free_blocks
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    req = sched.submit(list(range(9)), max_new_tokens=1000, deadline_s=3600.0)
    _run_until(sched, lambda: req.state is RequestState.DECODE and len(req.tokens) >= 2)
    produced = list(req.tokens)
    req.deadline = time.monotonic() - 1.0  # the clock runs out mid-decode
    sched.step()
    assert req.state is RequestState.TIMED_OUT and engine.free_blocks == free0
    assert req.result(timeout=1) == produced
    assert sched.stats()["counters"]["timed_out"] == 1
    sched.stop(drain=False)


def test_queued_request_past_deadline_never_touches_engine(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    req = sched.submit([1, 2, 3], max_new_tokens=4, deadline_s=0.001)
    time.sleep(0.01)
    sched.step()
    assert req.state is RequestState.TIMED_OUT and req.uid is None
    sched.stop(drain=False)


def test_backpressure_reject_mode(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(queue_capacity=2), start=False)
    sched.submit([1], max_new_tokens=1)
    sched.submit([2], max_new_tokens=1)
    with pytest.raises(QueueFullError):
        sched.submit([3], max_new_tokens=1)
    assert sched.stats()["counters"]["rejected"] == 1
    sched.stop(drain=False)


def test_backpressure_block_mode_unblocks_on_admission(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(queue_capacity=1, backpressure="block"), start=False)
    sched.submit([1, 2], max_new_tokens=1)
    admitted = []
    t = threading.Thread(target=lambda: admitted.append(sched.submit([3, 4], max_new_tokens=1)), daemon=True)
    t.start()
    time.sleep(0.15)
    assert t.is_alive() and not admitted  # genuinely blocked on the full queue
    sched.step()  # admission drains the queue -> submitter wakes
    t.join(timeout=10)
    assert not t.is_alive() and len(admitted) == 1
    _run_until(sched, lambda: all(r.finished for r in admitted) and sched.n_active == 0)
    sched.stop(drain=False)


def test_capacity_check_uses_pool_size_not_construction_free(make_engine):
    engine = make_engine(num_blocks=8, block_size=16)
    engine.put([999], [np.arange(90) % 256])  # warmup holds 6 of 8 blocks
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    engine.flush(999)
    req = sched.submit(list(np.arange(100) % 256), max_new_tokens=2)
    _run_until(sched, lambda: req.finished)
    assert req.state is RequestState.DONE  # 7 blocks: fits the 8-block pool
    sched.stop(drain=False)


def test_stop_drains_in_flight_requests(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig())
    reqs = [sched.submit(list(range(5 + i)), max_new_tokens=3) for i in range(3)]
    sched.stop(drain=True, timeout=WAIT_S)
    assert all(r.state is RequestState.DONE for r in reqs)
    assert sched.stats()["counters"]["completed"] == 3
    assert engine._state_manager.n_tracked_sequences == 0
    with pytest.raises(SchedulerStopped):
        sched.submit([1], max_new_tokens=1)


def test_stop_without_drain_cancels_everything(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    reqs = [sched.submit([1, 2], max_new_tokens=5) for _ in range(2)]
    sched.stop(drain=False)
    assert all(r.state is RequestState.CANCELLED and r.stream.closed for r in reqs)


def test_one_scheduler_per_engine_and_close_stops_it(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    with pytest.raises(RuntimeError, match="already has an attached"):
        ServingScheduler(engine, ServingConfig(), start=False)
    sched.stop(drain=False)
    ServingScheduler(engine, ServingConfig(), start=False).stop(drain=False)  # detached on stop
    running = ServingScheduler(engine, ServingConfig())
    engine.close()
    assert engine.serving_scheduler is None and running._stopped
    engine.close()  # idempotent


def test_serving_metrics_zero_cost_when_disabled(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    req = sched.submit([1, 2, 3], max_new_tokens=2)
    _run_until(sched, lambda: req.finished)
    sched.stop(drain=False)
    assert ttel.get_registry().api_calls == 0  # not one registry touch


def test_serving_metrics_spans_and_stats_match_the_reference(setup, make_engine):
    """With a telemetry session on, both schedulers record the same metric
    samples (times aside), the same spans and the same latency block. The
    port refuses the cost ledger (A5), so its run has cost.enabled=False."""
    got = []
    for pkg in ("jax", "port"):
        tel = jtel if pkg == "jax" else ttel
        session = tel.configure({"enabled": True})
        if pkg == "jax":
            sched = jserving.ServingScheduler(_jax_engine(setup), jserving.ServingConfig(), start=False)
        else:
            sched = ServingScheduler(make_engine(), ServingConfig(cost=CostConfig(enabled=False)), start=False)
        done = sched.submit([1, 2, 3, 4], max_new_tokens=3)
        _run_until(sched, lambda: done.finished)
        # drop capacity so the reject counter fires too (the pydantic config
        # validates assignments; the dataclass does not)
        if pkg == "jax":
            sched._config = sched._config.model_copy(update={"queue_capacity": 0})
        else:
            sched._config.queue_capacity = 0
        with pytest.raises(Exception, match="capacity"):
            sched.submit([1], max_new_tokens=1)
        stats = sched.stats()
        sched.stop(drain=False)
        snap = tel.get_registry().snapshot()
        # the reference's ledger families (serving_cost_*, serving_tenant_*)
        # are A5's
        counts = {k: v for k, v in snap.items() if k.startswith("serving_") and not k.endswith(("_sum", "_bucket"))
                  and not k.startswith(("serving_cost_", "serving_tenant_"))}
        spans = [(s["name"], s["cat"], s.get("parent_id") is not None)
                 for s in tel.get_span_recorder().tail(100) if s["cat"] == "serving"]
        got.append((counts, spans, sorted(stats["latency"]), done.trace_id is not None))
        session.close()
    assert got[0] == got[1]
    counts = got[1][0]
    assert counts["serving_completions_total"][0][1] == 1
    assert counts["serving_rejections_total"][0][1] == 1
    assert counts["serving_inter_token_seconds_count"][0][1] == 2  # 3 tokens -> 2 gaps


def test_idle_heartbeat_runs_empty_batches(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(heartbeat_enabled=True, heartbeat_interval_s=0.0))
    try:
        deadline = time.monotonic() + 30
        while sched.stats()["counters"]["heartbeats"] < 2:
            assert time.monotonic() < deadline, "no heartbeat within 30s"
            time.sleep(0.01)
    finally:
        sched.stop(drain=False)


def test_kill_fails_everything_terminal_and_frees_kv(make_engine):
    from deepspeed_tpu_torch.serving.scheduler import KILLED_ERROR_PREFIX
    engine = make_engine()
    free0 = engine.free_blocks
    sched = ServingScheduler(engine, ServingConfig())
    active = sched.submit(list(range(9)), max_new_tokens=500)
    deadline = time.monotonic() + WAIT_S
    while active.first_token_s is None:  # mid-decode, KV held
        assert time.monotonic() < deadline
        time.sleep(0.005)
    queued = sched.submit([1, 2, 3], max_new_tokens=5)
    sched.kill("injected fault")
    for req in (active, queued):
        assert req.state is RequestState.FAILED and req.error.startswith(KILLED_ERROR_PREFIX)
        assert req.stream.closed
    assert engine._state_manager.n_tracked_sequences == 0 and engine.free_blocks == free0
    assert not sched.ready
    with pytest.raises(SchedulerStopped):
        sched.submit([1], max_new_tokens=1)
    sched.kill()
    sched.stop(drain=False)


def test_ready_gates_on_the_loop_ticking(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig())
    deadline = time.monotonic() + 30
    while not sched.ready:
        assert time.monotonic() < deadline, "scheduler never became ready"
        time.sleep(0.001)
    sched.stop(drain=False)
    assert not sched.ready
    manual = ServingScheduler(make_engine(), ServingConfig(), start=False)
    assert manual.ready
    manual.stop(drain=False)


def test_flight_recorder_sees_the_scheduler(make_engine, tmp_path):
    ttel.configure({"enabled": True, "flight_recorder": {"enabled": True, "dir": str(tmp_path),
                                                         "signal_enabled": False, "watchdog_enabled": False}})
    sched = ServingScheduler(make_engine(), ServingConfig(cost=CostConfig(enabled=False)), start=False)
    req = sched.submit(list(range(6)), max_new_tokens=3)
    sched.step()
    _, doc = ttel.get_flight_recorder().dump("api", return_doc=True)
    (state, ) = doc["state"].values()
    assert state["requests"][0]["uid"] == req.uid and state["requests"][0]["offloaded"] is False
    sched.stop(drain=False)


# ----------------------------------------------------------- engine offload --
def test_offload_restore_is_bit_exact_and_counts_its_cost(setup):
    _, _, cfg, params = setup
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=16), max_context=256)
    engine = build_engine(params, dataclass_replace(cfg, dtype=torch.bfloat16),
                          RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16), device="cpu")
    engine.put([0, 1], [np.arange(40) % 256, np.arange(20) % 256])
    sm, kv = engine._state_manager, engine._state_manager.kv_cache
    seq = sm.get_sequence(0)
    before = kv.cache[:, :, torch.from_numpy(seq.kv_blocks)].clone()
    free = engine.free_blocks
    engine.offload_sequence(0)
    assert engine.is_offloaded(0) and seq.kv_tier == "host" and engine.free_blocks == free + 3
    assert kv.tier_stats()["host_blocks"] == 3
    # a touch must first re-allocate the 3 offloaded blocks
    assert engine.query(0, 1, engine.free_blocks) == (1, 3)
    engine._restore_offloaded([0])
    assert not engine.is_offloaded(0) and seq.kv_tier == "device"
    after = kv.cache[:, :, torch.from_numpy(seq.kv_blocks)]
    assert after.dtype == torch.bfloat16 and torch.equal(after.view(torch.int16), before.view(torch.int16))
    engine.offload_sequence(0)
    engine.flush(0)  # flushing an offloaded sequence drops its payload
    assert kv.tier_stats()["host_entries"] == 0 and engine.free_blocks == 16 - 2


def dataclass_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def test_offload_restore_continues_like_the_jax_engine(setup):
    """Offload a sequence, touch it (transparent restore), and decode: the
    logits equal the JAX engine's through the same steps."""
    _, _, cfg, params = setup
    prompts = _prompts(2, (33, 17))
    outs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            engine = _jax_engine(setup, num_blocks=16, max_context=256)
            put = lambda u, t: np.asarray(engine.put(u, t))
        else:
            mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=16),
                                       max_context=256)
            engine = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16),
                                  device="cpu")
            put = lambda u, t: engine.put(u, t).numpy()
        logits = [put([0, 1], prompts)]
        engine.offload_sequence(0)
        engine.offload_sequence(1)
        logits.append(put([0, 1], [[int(np.argmax(r))] for r in logits[-1]]))
        engine.offload_sequence(1)
        logits.append(put([0, 1], [[int(np.argmax(r))] for r in logits[-1]]))
        outs.append(logits)
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ request --
REQUEST_MODULES = pytest.mark.parametrize("mod", [j_request, t_request], ids=["jax", "port"])


@REQUEST_MODULES
def test_token_stream_iterates_gets_and_closes(mod):
    s = mod.TokenStream()
    for t in (5, 7, 9):
        s.put(t)
    s.close()
    assert list(s) == [5, 7, 9] and list(s) == []
    s = mod.TokenStream()
    with pytest.raises(queue.Empty):
        s.get(timeout=0.01)
    s.put(3)
    assert s.get(timeout=1) == 3
    s.close()
    assert s.get(timeout=1) is None and s.get(timeout=1) is None  # sentinel persists


@REQUEST_MODULES
def test_token_stream_blocking_consumer_wakes_on_close(mod):
    s, got = mod.TokenStream(), []
    t = threading.Thread(target=lambda: got.extend(s), daemon=True)
    t.start()
    s.put(1)
    s.put(2)
    s.close()
    t.join(timeout=5)
    assert not t.is_alive() and got == [1, 2]


@REQUEST_MODULES
def test_request_validation_states_results_and_deadline(mod):
    with pytest.raises(ValueError, match="at least one token"):
        mod.Request([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        mod.Request([1], max_new_tokens=0)
    req = mod.Request([1, 2], max_new_tokens=4)
    assert req.state is mod.RequestState.QUEUED and not req.finished
    req._set_state(mod.RequestState.PREFILL)
    req._set_state(mod.RequestState.CANCELLED)
    assert req.finished and req.stream.closed
    req._set_state(mod.RequestState.DONE)  # must not resurrect
    assert req.state is mod.RequestState.CANCELLED
    req = mod.Request([1], max_new_tokens=2)
    with pytest.raises(TimeoutError):
        req.result(timeout=0.01)
    req.error = "boom"
    req._set_state(mod.RequestState.FAILED)
    with pytest.raises(RuntimeError, match="boom"):
        req.result(timeout=1)
    req = mod.Request([1], deadline_s=100.0)
    assert req.deadline == pytest.approx(req.arrival_s + 100.0)
    assert mod.Request([1]).deadline is None


# ----------------------------------------------------------------- overload --
OVERLOAD = pytest.mark.parametrize("srv", [jserving, tserving], ids=["jax", "port"])


def _warm(sched, tokens_per_s=100.0, batches=6):
    for i in range(batches):
        sched._rate.observe(int(tokens_per_s), now=float(i))
    assert sched._rate.rate == pytest.approx(tokens_per_s)


def _force_stage(sched, stage, pin=False):
    thresholds = sched._brownout._thresholds
    target = 1.0 if stage >= len(thresholds) else (
        (thresholds[stage - 1] + thresholds[stage]) / 2 if stage else 0.0)
    for _ in range(60):
        sched._brownout.update(target)
    assert sched._brownout.stage == stage
    if pin:
        sched._brownout.update = lambda pressure: stage


@OVERLOAD
def test_overload_primitives(srv):
    from importlib import import_module
    overload = import_module(srv.__name__ + ".overload")
    assert overload.validate_priority(None) == "interactive"
    assert overload.validate_priority("batch") == "batch"
    with pytest.raises(ValueError, match="unknown priority"):
        overload.validate_priority("platinum")
    est = srv.RateEstimator(alpha=0.5, min_samples=3)
    assert est.rate is None and est.seconds_for(100) is None
    for now in (0.0, 1.0, 2.0):
        est.observe(50, now=now)
    assert est.rate is None
    est.observe(50, now=3.0)
    assert est.warm and est.rate == pytest.approx(50.0) and est.seconds_for(100) == pytest.approx(2.0)
    est.observe(0, now=4.0)
    est.observe(10, now=2.5)
    assert est.rate == pytest.approx(50.0)
    ctl = srv.BrownoutController(thresholds=(0.4, 0.6, 0.8), hysteresis=0.15, alpha=1.0)
    assert [ctl.update(p) for p in (0.1, 0.45, 0.65, 0.85, 0.7, 0.6, 0.0)] == [0, 1, 2, 3, 3, 2, 0]
    assert ctl.transitions == 5
    with pytest.raises(ValueError, match="ascending"):
        srv.BrownoutController(thresholds=(0.8, 0.6, 0.9))
    with pytest.raises(ValueError, match="ascending"):
        srv.OverloadConfig(brownout_stage_thresholds=(0.9, 0.5, 0.95))


def test_serving_config_checks_match_the_reference():
    for bad in ({"queue_capacity": 0}, {"backpressure": "drop"}, {"default_deadline_s": float("nan")},
                {"default_deadline_s": -1.0}, {"port": 70000}, {"decode_chunk": 0}):
        with pytest.raises(ValueError):
            jserving.ServingConfig(**bad)
        with pytest.raises(ValueError):
            ServingConfig(**bad)
    with pytest.raises(ValueError, match="positive number"):
        ServingConfig(default_deadline_s=float("nan"))
    with pytest.raises(ValueError, match="max_ngram"):
        tserving.SpeculativeConfig(min_ngram=3, max_ngram=2)
    assert tserving.SpeculativeConfig.from_dict({"drafter": "auto"}).drafter == "auto"
    j, t = jserving.ServingConfig(), ServingConfig()
    for name in ("queue_capacity", "backpressure", "default_max_new_tokens", "drain_timeout_s", "decode_chunk",
                 "sse_keepalive_s", "max_resume_body_bytes"):
        assert getattr(j, name) == getattr(t, name)
    assert tuple(j.overload.brownout_stage_thresholds) == t.overload.brownout_stage_thresholds
    cfg = ServingConfig.from_dict({"overload": {"brownout_stage_thresholds": [0.5, 0.6, 0.7]}, "decode_chunk": 4})
    assert cfg.overload.brownout_stage_thresholds == (0.5, 0.6, 0.7) and cfg.decode_chunk == 4


def test_admission_rejects_unmeetable_deadline_and_cold_estimator_admits(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    try:
        assert sched.submit(list(range(9)), max_new_tokens=500, deadline_s=0.001) is not None  # cold
        sched.stop(drain=False)
        sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
        _warm(sched, tokens_per_s=100.0)
        with pytest.raises(AdmissionRejected) as exc:
            sched.submit(list(range(9)), max_new_tokens=200, deadline_s=0.05)
        assert exc.value.retry_after_s >= sched._config.overload.retry_after_floor_s
        assert sched.stats()["counters"]["shed_admission"] == 1
        assert sched.queue_depth == 0 and sched.n_active == 0
        req = sched.submit(list(range(9)), max_new_tokens=3, deadline_s=30.0)
        _run_until(sched, lambda: req.state is RequestState.DONE)
    finally:
        sched.stop(drain=False)


@pytest.mark.parametrize("enabled", [True, False], ids=["priority_order", "fifo_control"])
def test_admission_order(make_engine, enabled):
    engine = make_engine(max_tracked_sequences=1)  # serialize admission
    sched = ServingScheduler(engine, ServingConfig(overload=OverloadConfig(enabled=enabled)), start=False)
    try:
        if not enabled:
            _warm(sched)  # a warm estimator, yet no admission gate
        b1 = sched.submit(list(range(9)), max_new_tokens=2, priority="batch")
        b2 = sched.submit(list(range(5)), max_new_tokens=2, priority="batch")
        i1 = sched.submit(list(range(7)), max_new_tokens=2, priority="interactive")
        if enabled:
            _run_until(sched, lambda: i1.state is RequestState.DONE)
            assert b2.state is not RequestState.DONE
        else:
            _run_until(sched, lambda: b1.state is RequestState.DONE)
            assert i1.state is not RequestState.DONE  # FIFO: batch went first
            assert sched.submit([1, 2], max_new_tokens=500, deadline_s=0.001).shed_reason is None
        _run_until(sched, lambda: all(r.state is RequestState.DONE for r in (b1, b2, i1)))
    finally:
        sched.stop(drain=False)


def test_queue_shed_under_pressure_lowest_priority_first(make_engine):
    engine = make_engine(max_tracked_sequences=1)
    cfg = ServingConfig(queue_capacity=4, overload=OverloadConfig(admission_control=False))
    sched = ServingScheduler(engine, cfg, start=False)
    try:
        _warm(sched, tokens_per_s=10.0)
        reqs = [sched.submit(list(range(9)), max_new_tokens=40, deadline_s=6.0, priority=p)
                for p in ("interactive", "batch", "batch")]
        for _ in range(30):
            sched._brownout.update(1.0)
        sched._shed_queued(now=reqs[0].arrival_s)
        shed = [r for r in reqs if r.shed_reason is not None]
        assert shed, "nothing shed under provable overload"
        for r in shed:
            assert r.state is RequestState.FAILED and r.retry_after_s > 0
            assert r.tokens == [] and r._fed == 0
        if len(shed) < len(reqs):
            assert all(r.priority == "batch" for r in shed)
        assert sched.stats()["counters"]["shed_queue"] == len(shed)
    finally:
        sched.stop(drain=False)


def test_brownout_stages_clamp_disable_chunking_reject_and_recover(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(decode_chunk=4), start=False)
    try:
        prompt = list(range(9))
        base = sched.submit(prompt, max_new_tokens=5)
        _run_until(sched, lambda: base.state is RequestState.DONE)
        _force_stage(sched, 1)
        clamp = sched._config.overload.brownout_clamp_max_new_tokens
        batch = sched.submit(prompt, max_new_tokens=clamp + 50, priority="batch")
        inter = sched.submit(prompt, max_new_tokens=clamp + 50, priority="interactive")
        assert batch.max_new_tokens == clamp and batch.degraded_mode == ["max_new_tokens_clamped"]
        assert inter.max_new_tokens == clamp + 50 and not inter.degraded_mode
        for r in (batch, inter):
            r.cancel()
        sched.step()
        before = sched.stats()["counters"]["batches"]
        _force_stage(sched, 2, pin=True)
        req = sched.submit(prompt, max_new_tokens=5)
        assert "speculative_disabled" in req.degraded_mode
        _run_until(sched, lambda: req.state is RequestState.DONE)
        assert req.tokens == base.tokens  # degraded, not different
        assert sched.stats()["counters"]["batches"] - before > 2  # one token per step now
        del sched._brownout.update  # unpin
        _force_stage(sched, 3)
        with pytest.raises(AdmissionRejected, match="stage 3"):
            sched.submit(prompt, max_new_tokens=2, priority="batch")
        assert sched.stats()["counters"]["brownout_rejected"] == 1
        _force_stage(sched, 0)
        req = sched.submit(prompt, max_new_tokens=2, priority="batch")
        _run_until(sched, lambda: req.state is RequestState.DONE)
        doc = sched.stats()["overload"]
        assert doc["enabled"] and doc["brownout_stage"] == 0 and doc["retry_after_s"] >= 0
    finally:
        sched.stop(drain=False)


# ------------------------------------------------------------------- server --
def _post(url, doc, timeout=WAIT_S, headers=None, path="/v1/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse_events(resp):
    return [json.loads(line.decode().strip()[len("data: "):]) for line in resp
            if line.decode().startswith("data: ")]


def _mask(doc):
    if isinstance(doc, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


def _exchange(url, method, path, body=None, headers=None):
    """(status, content type, masked body) of one request; SSE bodies come
    back as their list of raw data lines, each masked."""
    data = json.dumps(body).encode() if body is not None and not isinstance(body, bytes) else body
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=WAIT_S)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        ctype = resp.headers["Content-Type"]
        raw = resp.read()
    status = resp.status if hasattr(resp, "status") else resp.code
    if ctype == "text/event-stream":
        # ": keepalive" comments depend on timing alone, like the masked fields
        lines = [ln for ln in raw.split(b"\n") if ln and not ln.startswith(b":")]
        return status, ctype, [json.dumps(_mask(json.loads(ln[len(b"data: "):]))) for ln in lines]
    return status, ctype, json.dumps(_mask(json.loads(raw)))


EXCHANGES = (
    ("POST", "/v1/generate", {"prompt": list(range(7)), "max_new_tokens": 5}),
    ("POST", "/v1/generate", {"prompt": list(range(3, 14)), "max_new_tokens": 6, "stream": True}),
    ("POST", "/v1/generate", {"prompt": [5, 9, 200], "max_new_tokens": 4, "temperature": 0.8, "seed": 3,
                              "priority": "batch", "tenant": "acme"}),
    ("POST", "/v1/generate", {"prompt": [1, 2, 3], "max_new_tokens": 40, "eos_token_id": 0, "stream": True}),
    ("GET", "/v1/stats", None),
    ("GET", "/v1/usage", None),
    ("GET", "/healthz", None),
    ("GET", "/v1/nope", None),
    ("POST", "/v1/nope", {}),
    ("POST", "/v1/generate", {}),
    ("POST", "/v1/generate", {"prompt": []}),
    ("POST", "/v1/generate", {"prompt": [1, "x"]}),
    ("POST", "/v1/generate", {"prompt": [1], "max_new_tokens": 0}),
    ("POST", "/v1/generate", {"prompt": [1], "temperature": "hot"}),
    ("POST", "/v1/generate", {"prompt": [1], "priority": "gold"}),
    ("POST", "/v1/generate", {"prompt": [1], "drafter": "oracle"}),
    ("POST", "/v1/generate", {"prompt": [1] * 600}),
)


def test_server_responses_equal_the_reference_bytes(setup, make_engine):
    """Each body, in turn, to the JAX server and to the port's: status,
    content type and body bytes equal, with MASKED fields replaced."""
    servers = {"jax": jserving.ServingServer(jserving.ServingScheduler(_jax_engine(setup),
                                                                       jserving.ServingConfig())).start(),
               "port": ServingServer(ServingScheduler(make_engine(), ServingConfig())).start()}
    try:
        for method, path, body in EXCHANGES:
            got = {k: _exchange(srv.url, method, path, body) for k, srv in servers.items()}
            assert got["port"] == got["jax"], (method, path, body)
        stats = json.loads(_exchange(servers["port"].url, "GET", "/v1/stats")[2])
        assert stats["counters"]["completed"] == 4 and stats["counters"]["failed"] == 1
    finally:
        for srv in servers.values():
            srv.stop(drain=False)


@pytest.fixture
def server(make_engine):
    engine = make_engine()
    srv = ServingServer(ServingScheduler(engine, ServingConfig())).start()
    yield srv, engine
    srv.stop(drain=False)


def test_generate_json_sse_stats_and_health(server, setup):
    srv, engine = server
    prompt = list(range(11))
    with _post(srv.url, {"prompt": prompt, "max_new_tokens": 6, "stream": True}) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        *tokens, final = _sse_events(resp)
    assert [e["index"] for e in tokens] == list(range(6))
    assert final["done"] is True and final["state"] == "DONE"
    assert [e["token"] for e in tokens] == final["tokens"] == _greedy(setup, prompt, 6)
    with _post(srv.url, {"prompt": prompt, "max_new_tokens": 6}) as resp:
        doc = json.loads(resp.read())
    assert resp.status == 200 and doc["tokens"] == final["tokens"]
    assert doc["finish_reason"] == "length" and doc["ttft_s"] <= doc["e2e_s"]
    stats = json.loads(urllib.request.urlopen(srv.url + "/v1/stats", timeout=10).read())
    assert stats["counters"]["completed"] == 2 and stats["engine"]["tracked_sequences"] == 0
    assert json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read()) == {"status": "ok"}


def test_queue_full_returns_429_in_reject_mode(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(queue_capacity=1), start=False)
    srv = ServingServer(sched).start()
    results = {}

    def first():
        try:
            with _post(srv.url, {"prompt": [1, 2]}) as resp:
                results["first"] = json.loads(resp.read())
        except Exception as e:  # cancelled at shutdown is fine too
            results["first"] = e

    t = threading.Thread(target=first, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while sched.queue_depth < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url, {"prompt": [3, 4]})
        assert e.value.code == 429 and json.loads(e.value.read())["queue_depth"] == 1
        assert int(e.value.headers["Retry-After"]) >= 1
    finally:
        srv.stop(drain=False)  # cancels the queued request; its handler returns
    t.join(timeout=10)
    assert not t.is_alive()


def test_draining_server_returns_503_with_retry_after(server):
    srv, _ = server
    srv._draining.set()  # what stop() flips first, observed before teardown
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.url, {"prompt": [1, 2]})
    assert e.value.code == 503 and int(e.value.headers["Retry-After"]) >= 1
    assert json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read()) == {"status": "draining"}


def test_http_priority_header_brownout_429_and_degraded_doc(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    srv = ServingServer(sched).start()
    try:
        _warm(sched, tokens_per_s=10.0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"prompt": list(range(9)), "max_new_tokens": 400, "deadline_s": 0.05})
        assert exc.value.code == 429 and int(exc.value.headers["Retry-After"]) >= 1
        assert json.loads(exc.value.read())["retry_after_s"] > 0
        _force_stage(sched, 3)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.url, {"prompt": [1, 2], "max_new_tokens": 2}, headers={"X-DSTPU-Priority": "batch"})
        assert exc.value.code == 429
        _force_stage(sched, 1, pin=True)
        clamp = sched._config.overload.brownout_clamp_max_new_tokens
        holder = {}

        def post():
            with _post(srv.url, {"prompt": list(range(9)), "max_new_tokens": clamp + 10,
                                 "priority": "batch"}) as resp:
                holder["doc"] = json.loads(resp.read())

        t = threading.Thread(target=post, daemon=True)
        t.start()
        deadline = time.monotonic() + WAIT_S
        while "doc" not in holder and time.monotonic() < deadline:
            sched.step()
            time.sleep(0.001)
        t.join(timeout=10)
        doc = holder["doc"]
        assert doc["priority"] == "batch" and doc["degraded_mode"] == ["max_new_tokens_clamped"]
        assert doc["n_tokens"] == clamp
    finally:
        srv.stop(drain=False)


def test_client_disconnect_cancels_request_and_frees_kv(server):
    srv, engine = server
    free0 = engine.free_blocks
    resp = _post(srv.url, {"prompt": list(range(10)), "max_new_tokens": 100000, "stream": True})
    for line in resp:
        if line.decode().strip().startswith("data: "):
            break
    sock = resp.fp.raw._sock if hasattr(resp.fp, "raw") else None
    resp.close()
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    deadline = time.monotonic() + WAIT_S
    while srv.scheduler.stats()["counters"]["cancelled"] < 1 or engine.free_blocks != free0:
        assert time.monotonic() < deadline, "disconnect did not cancel the request and free its KV"
        time.sleep(0.01)
    assert engine._state_manager.n_tracked_sequences == 0


def test_graceful_drain_and_healthz_readiness(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(drain_timeout_s=WAIT_S))
    srv = ServingServer(sched).start()
    deadline = time.monotonic() + 30
    while json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read())["status"] != "ok":
        assert time.monotonic() < deadline, "never became ready"
    req = sched.submit(list(range(6)), max_new_tokens=4)
    url = srv.url
    srv.stop(drain=True)
    assert req.state is RequestState.DONE and len(req.tokens) == 4
    assert engine._state_manager.n_tracked_sequences == 0
    with pytest.raises(OSError):  # listener is really down
        urllib.request.urlopen(url + "/healthz", timeout=1)


# ---------------------------------------------------------------- refusals --
@pytest.mark.parametrize("config,item", [
    ({"prefix_cache": {"enabled": True}}, "A5"),
    ({"speculative": {"enabled": True}}, "A5"),
    ({"kv_tiers": {"enabled": True}}, "A5"),
    ({"overload": {"slo_pressure": True}}, "A6"),
], ids=["prefix_cache", "speculative", "kv_tiers", "slo_pressure"])
def test_unported_serving_configs_are_refused(make_engine, config, item):
    engine = make_engine()
    with pytest.raises(NotImplementedError, match=item):
        ServingScheduler(engine, ServingConfig.from_dict(config), start=False)
    assert engine.serving_scheduler is None


def test_cost_ledger_with_telemetry_is_refused(make_engine):
    ttel.configure({"enabled": True})
    with pytest.raises(NotImplementedError, match="A5"):
        ServingScheduler(make_engine(), ServingConfig(), start=False)
    ServingScheduler(make_engine(), ServingConfig(cost=CostConfig(enabled=False)), start=False).stop()


def test_unported_scheduler_calls_are_refused(make_engine):
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
    engine = make_engine()
    sched = ServingScheduler(engine, ServingConfig(), start=False)
    for call, item in ((lambda: sched.submit([1], handoff=True), "A5"), (lambda: sched.submit([1], park=True), "A5"),
                       (lambda: sched.submit_resume(b"x"), "A5"), (lambda: sched.export_prefix([b"d"]), "A5"),
                       (lambda: sched.request_steal("r0"), "A6"),
                       (lambda: engine._state_manager.kv_cache.configure_tiering("/nowhere"), "A5"),
                       (lambda: make_engine(offload=True), "A5")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    assert sched.queue_depth == 0 and isinstance(engine._state_manager.kv_cache, BlockedKVCache)
    sched.stop(drain=False)


@pytest.mark.parametrize("method,path,body,item", [
    ("POST", "/v1/resume", {"payload": "AAAA"}, "A5"),
    ("POST", "/v1/generate", {"prompt": [1, 2], "handoff": True}, "A5"),
    ("POST", "/v1/generate", {"prompt": [1, 2], "park": True}, "A5"),
    ("POST", "/v1/prefix/export", {"digests": []}, "A5"),
    ("GET", "/v1/handoff/h0", None, "A5"),
    ("POST", "/v1/steal", {"handle": "r0"}, "A6"),
], ids=["resume", "handoff_flag", "park_flag", "prefix_export", "handoff_ref", "steal"])
def test_unported_routes_answer_400_naming_the_item(server, method, path, body, item):
    srv, _ = server
    status, ctype, doc = _exchange(srv.url, method, path, body)
    assert status == 400 and ctype == "application/json"
    assert list(json.loads(doc)) == ["error"] and f"ROADMAP.md {item}" in json.loads(doc)["error"]
    assert srv.scheduler.stats()["counters"]["submitted"] == 0
