"""Port parity: speculative decoding under the serving scheduler and server.

Side by side, as ``tests/test_torch_serving.py``: the JAX ``ServingScheduler``
over the JAX engine and the port's over the port's get the same weights, the
same draft heads and the same submits, stepped by hand. Per tick, each
request's token count and state, and at the end the token streams and every
scheduler counter (the ``spec_*`` ones included) must be equal, for the
prompt-lookup drafter (linear verify, with and without the prefix trie,
greedy and sampled, beside SplitFuse prefill), the learned drafter (token
trees) and ``auto``. Handoff frames carry ``extra["spec"]`` equal to the
JAX package's byte for byte, and the HTTP ``spec`` field equals the JAX
server's.

The rest mirrors ``tests/unit/serving/test_speculative.py`` on the port:
greedy and sampled output with speculation on equals output with it off,
token for token; the two CPU timing gates of the reference become gates on
dispatch counts, which are deterministic; adaptive k, the rollback soak and
handoff. The learned drafter's cases are in
``tests/test_torch_spec_serving_learned.py``.
"""

import json
import math
import threading
import time

import numpy as np
import pytest

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2.ragged import handoff as j_handoff
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.serving import (PrefixCacheConfig, ServingConfig, ServingScheduler, ServingServer,
                                         SpeculativeConfig)
from tests.test_torch_serving import (_exchange, _jax_engine, _run_until, clear_jax_caches,  # noqa: F401
                                      fresh_telemetry, make_engine, setup)

MAX_STEPS = 600
WAIT_S = 60


def _spec_config(k=4, prefix=True, **spec_kw):
    return ServingConfig(speculative=SpeculativeConfig(enabled=True, max_draft_tokens=k, **spec_kw),
                         prefix_cache=PrefixCacheConfig(enabled=prefix))


def _spec_dict(k=4, prefix=True, **spec_kw):
    return {"speculative": dict(enabled=True, max_draft_tokens=k, **spec_kw), "prefix_cache": {"enabled": prefix}}


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


# ----------------------------------------------------------------- engines --
def _engine(pkg, setup_or_perm, num_blocks=64, block_size=16, **mgr_kw):
    """An engine of either package over the fixture's weights."""
    if len(setup_or_perm) == 5:
        jcfg, jparams, params = setup_or_perm[:3]
    else:
        jcfg, jparams, _, params = setup_or_perm
    mgr_kw.setdefault("max_context", 512)
    if pkg == "jax":
        return _jax_engine((jcfg, jparams, None, None), num_blocks, block_size, **mgr_kw)
    from tests.torch_port_helpers import port_config
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=num_blocks), **mgr_kw)
    return build_engine(params, port_config(jcfg), RaggedInferenceEngineConfig(state_manager=mgr,
                                                                               kv_block_size=block_size),
                        device="cpu")


# ------------------------------------------------------------- side by side --
def _side_by_side(fixture, script, config, engine_kw=None):
    """Apply ``script`` (("submit", kwargs) and ("step", n) entries) to the JAX
    scheduler and the port's, each built from the ``config`` dict, then step
    both until every request has finished. Returns per package the per-tick
    (tokens so far, state) of every request, the streams, the counters, the
    stats' speculative block and each request's drafter state."""
    runs = []
    for pkg in ("jax", "port"):
        engine = _engine(pkg, fixture, **(engine_kw or {}))
        if pkg == "jax":
            sched = jserving.ServingScheduler(engine, jserving.ServingConfig(**config), start=False)
        else:
            sched = ServingScheduler(engine, ServingConfig.from_dict(config), start=False)
        reqs, trace = [], []
        for op, arg in script:
            if op == "submit":
                reqs.append(sched.submit(**arg))
            else:
                for _ in range(arg):
                    sched.step()
                    trace.append([(len(r.tokens), r.state.name) for r in reqs])
        for _ in range(MAX_STEPS):
            if all(r.finished for r in reqs):
                break
            sched.step()
            trace.append([(len(r.tokens), r.state.name) for r in reqs])
        assert all(r.finished for r in reqs), f"{pkg}: requests did not finish"
        stats = sched.stats()
        sched.stop(drain=False)
        runs.append(dict(trace=trace, tokens=[list(r.tokens) for r in reqs], counters=stats["counters"],
                         spec=stats["speculative"], finish=[r.finish_reason for r in reqs],
                         drafter=[(r.spec_drafted, r.spec_accepted, r.decode_steps, r._spec_ewma,
                                   dict(r._spec_ewmas), r._spec_last_drafter) for r in reqs],
                         tracked=engine._state_manager.n_tracked_sequences))
        engine.close()
    return runs


def _submit(prompt, **kw):
    return ("submit", dict(prompt=prompt, **kw))


REPEAT = [5, 6, 7] * 8
LOOKUP_SCENARIOS = {
    # cold (self-lookup) then warm (a full prefix hit, trie-mined drafts)
    "greedy_cold_then_warm": (lambda v: [_submit(_prompt(v, 16, 3), max_new_tokens=12), ("step", 14),
                                         _submit(_prompt(v, 16, 3), max_new_tokens=12)],
                              _spec_dict(k=3), {"block_size": 4}),
    "sampled_cold_then_warm": (lambda v: [_submit(_prompt(v, 16, 3), max_new_tokens=10, temperature=0.8, seed=77),
                                          ("step", 14),
                                          _submit(_prompt(v, 16, 3), max_new_tokens=10, temperature=0.8, seed=77)],
                               _spec_dict(k=3), {"block_size": 4}),
    # pattern-free text: k backs off to 0, with probes
    "adversarial": (lambda v: [_submit(_prompt(v, 19, 11), max_new_tokens=40)],
                    _spec_dict(k=4, prefix=False, probe_interval=8), {}),
    # a repetitive prompt beside SplitFuse prefill chunks under a small
    # draft budget: verify and put share ticks
    "budget_beside_prefill": (lambda v: [_submit(REPEAT, max_new_tokens=16), ("step", 2),
                                         _submit(_prompt(v, 40, 4), max_new_tokens=6),
                                         _submit(REPEAT[:14], max_new_tokens=9, temperature=0.9, seed=5)],
                              _spec_dict(k=4, prefix=False, draft_token_budget=3), {"max_ragged_batch_size": 16}),
}


@pytest.mark.parametrize("name", list(LOOKUP_SCENARIOS))
def test_side_by_side_prompt_lookup(setup, name):
    script, config, engine_kw = LOOKUP_SCENARIOS[name]
    jax_run, port_run = _side_by_side(setup, script(setup[0].vocab_size), config, engine_kw)
    assert port_run == jax_run
    assert port_run["tracked"] == 0 and port_run["counters"]["spec_steps"] > 0
    if name.endswith("warm"):  # trie-mined drafts of the request's own repeat
        assert port_run["counters"]["spec_accepted"] > 0


# --------------------------------------------------------- token identity --
def test_token_identical_greedy_and_sampled_spec_on_vs_off(make_engine, setup):
    """Cold (self-lookup) and warm (trie-mined drafts over a full prefix hit)
    runs emit exactly the spec-off tokens, greedy and sampled."""
    prompt = _prompt(setup[0].vocab_size, 16, 3)
    for kw in (dict(max_new_tokens=12), dict(max_new_tokens=10, temperature=0.8, seed=77)):
        off = ServingScheduler(make_engine(block_size=4), ServingConfig(), start=False)
        on_engine = make_engine(block_size=4)
        on = ServingScheduler(on_engine, _spec_config(k=3), start=False)
        try:
            ref = off.submit(prompt, **kw)
            _run_until(off, lambda: ref.finished)
            cold = on.submit(prompt, **kw)
            _run_until(on, lambda: cold.finished)
            warm = on.submit(prompt, **kw)
            _run_until(on, lambda: warm.finished)
            assert cold.result() == ref.result() == warm.result(), kw
            assert warm.spec_accepted > 0  # the warm repeat really speculated
            assert warm.decode_steps < kw["max_new_tokens"] - 1
        finally:
            off.stop(drain=False)
            on.stop(drain=False)
        assert on_engine.free_blocks + on._prefix_cache.n_blocks == 64


# ------------------------------------------------------------- dispatch gates --
def test_repeated_prompt_verify_dispatch_gate(make_engine, setup):
    """The reference's repeated-prompt CPU timing gate, as dispatch counts:
    the trie-drafted warm request emits N tokens in 1 prefill step plus at
    most ceil((N-1)/(1+k)) fully accepted verify dispatches, equal to
    spec-off; the third run costs the same dispatches (steady state)."""
    engine = make_engine(block_size=4)
    K, N = 4, 13
    sched = ServingScheduler(engine, _spec_config(k=K), start=False)
    ref_sched = ServingScheduler(make_engine(block_size=4), ServingConfig(), start=False)
    prompt = _prompt(setup[0].vocab_size, 16, 3)
    try:
        ref = ref_sched.submit(prompt, max_new_tokens=N)
        _run_until(ref_sched, lambda: ref.finished)
        seed_req = sched.submit(prompt, max_new_tokens=N)  # the publisher
        _run_until(sched, lambda: seed_req.finished)
        assert seed_req.result() == ref.result()
        batch0 = sched._counters["batches"]
        warm = sched.submit(prompt, max_new_tokens=N)
        _run_until(sched, lambda: warm.finished)
        batch1 = sched._counters["batches"]
        assert warm.result() == ref.result()
        decode_dispatches = batch1 - batch0 - 1
        assert decode_dispatches <= math.ceil((N - 1) / (1 + K)), (decode_dispatches, N, K)
        assert warm.spec_drafted > 0 and warm.spec_accepted == warm.spec_drafted  # 100% acceptance
        assert (N - 1) / decode_dispatches > 1.0
        # control: spec-off costs one dispatch a token
        assert ref_sched._counters["batches"] - 1 == N - 1 > decode_dispatches
        warm2 = sched.submit(prompt, max_new_tokens=N)
        _run_until(sched, lambda: warm2.finished)
        assert warm2.result() == ref.result()
        assert sched._counters["batches"] - batch1 == batch1 - batch0  # steady state
    finally:
        sched.stop(drain=False)
        ref_sched.stop(drain=False)
    assert engine.free_blocks + sched._prefix_cache.n_blocks == engine._state_manager.kv_cache.num_blocks


def test_adversarial_random_tokens_dispatch_gate(make_engine, setup):
    """The reference's adversarial CPU timing gate, as dispatch counts:
    pattern-free text costs at most 5% extra engine batches over spec-off,
    because adaptive k backs off to 0; the output is identical."""
    N = 24
    prompt = _prompt(setup[0].vocab_size, 17, 9)
    off = ServingScheduler(make_engine(), ServingConfig(), start=False)
    on = ServingScheduler(make_engine(), ServingConfig(speculative=SpeculativeConfig(enabled=True,
                                                                                      max_draft_tokens=4)),
                          start=False)
    try:
        ref = off.submit(prompt, max_new_tokens=N)
        _run_until(off, lambda: ref.finished)
        req = on.submit(prompt, max_new_tokens=N)
        _run_until(on, lambda: req.finished)
        assert req.result() == ref.result()
        assert on._counters["batches"] <= math.ceil(1.05 * off._counters["batches"])
        assert req._spec_ewma is not None and req._spec_ewma < 0.3
        assert req.spec_drafted < N  # far below the N * k_max of a drafter that never backs off
    finally:
        off.stop(drain=False)
        on.stop(drain=False)


def test_acceptance_ewma_adapts_and_probes(make_engine, setup):
    sched = ServingScheduler(make_engine(), ServingConfig(speculative=SpeculativeConfig(
        enabled=True, max_draft_tokens=4, probe_interval=8)), start=False)
    try:
        rep = sched.submit(REPEAT, max_new_tokens=16)
        _run_until(sched, lambda: rep.finished)
        assert rep.spec_drafted > 0
        adv = sched.submit(_prompt(setup[0].vocab_size, 19, 11), max_new_tokens=40)
        _run_until(sched, lambda: adv.finished)
        assert adv._spec_ewma is not None and adv._spec_ewma < 0.3
        assert adv.spec_drafted <= 16  # the first optimistic feeds and the probes
        stats = sched.stats()["speculative"]
        assert stats["enabled"] and stats["verify_steps"] > 0 and stats["rollback_tokens"] > 0
        assert stats["drafter"] == "prompt_lookup" and "tree" not in stats
    finally:
        sched.stop(drain=False)


def test_rollback_soak_pool_balance_exact(make_engine, setup):
    """Concurrent submitters over shared repetitive prompts, cancellations
    mid-flight, a pool small enough for trie evictions: every verify
    rollback and every cancel leaves the allocator exactly balanced."""
    vocab = setup[0].vocab_size
    engine = make_engine(num_blocks=24)
    sched = ServingScheduler(engine, _spec_config(k=3))
    prefixes = [_prompt(vocab, 32, 100 + g) for g in range(3)]
    requests, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(4):
            req = sched.submit(prefixes[int(rng.integers(3))] + rng.integers(0, vocab, 8).tolist(),
                               max_new_tokens=6)
            with lock:
                requests.append(req)
            if rng.random() < 0.3:
                time.sleep(float(rng.random()) * 0.01)
                req.cancel()

    threads = [threading.Thread(target=client, args=(s, )) for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    deadline = time.monotonic() + 120
    for req in requests:
        assert req.wait(timeout=max(0.1, deadline - time.monotonic())), req
    kv = engine._state_manager.kv_cache
    assert engine.free_blocks + sched._prefix_cache.n_blocks == kv.num_blocks
    assert engine._state_manager.n_tracked_sequences == 0
    sched.stop(drain=False)
    assert engine.free_blocks == kv.num_blocks


# ------------------------------------------------------------------ handoff --
def _frame_header(frame):
    header, _ = j_handoff.unpack(frame)
    header.pop("kv_crc32", None)
    return header


def test_handoff_carries_drafter_state_equal_to_the_reference(setup, make_engine):
    """A drafting request handed off mid-stream: the frame's ``extra["spec"]``
    equals the JAX scheduler's byte for byte, the recipient adopts it before
    any step, and the continuation equals the request served whole. A JAX
    frame resumes on the port the same way."""
    prompt = REPEAT
    heads, frames = {}, {}
    for pkg in ("jax", "port"):
        engine = _engine(pkg, setup)
        donor = (jserving.ServingScheduler(engine, jserving.ServingConfig(**_spec_dict(k=3, prefix=False)),
                                           start=False) if pkg == "jax"
                 else ServingScheduler(engine, _spec_config(k=3, prefix=False), start=False))
        heads[pkg] = donor.submit(prompt, max_new_tokens=6, handoff=True)
        _run_until(donor, lambda: heads[pkg].finished)
        frames[pkg] = heads[pkg].handoff_payload
        donor.stop(drain=False)
        engine.close()
    assert heads["port"].spec_drafted > 0
    spec = {pkg: _frame_header(f)["extra"]["spec"] for pkg, f in frames.items()}
    assert json.dumps(spec["port"]) == json.dumps(spec["jax"])
    assert _frame_header(frames["port"]) == _frame_header(frames["jax"])

    whole_s = ServingScheduler(make_engine(), ServingConfig(), start=False)
    whole = whole_s.submit(prompt, max_new_tokens=12)
    _run_until(whole_s, lambda: whole.finished)
    whole_s.stop(drain=False)
    for pkg in ("port", "jax"):
        recipient = ServingScheduler(make_engine(), _spec_config(k=3, prefix=False), start=False)
        tail = recipient.submit_resume(frames[pkg], max_new_tokens=6)
        head = heads[pkg]
        assert (tail._spec_ewma, tail.spec_drafted, tail.spec_accepted, tail.decode_steps) == \
            (head._spec_ewma, head.spec_drafted, head.spec_accepted, head.decode_steps)
        _run_until(recipient, lambda: tail.finished)
        assert head.result() + tail.result() == whole.result()
        recipient.stop(drain=False)


# ----------------------------------------------------- config and the server --
def test_speculative_config_validation_matches_the_reference():
    for bad in (dict(max_draft_tokens=0), dict(min_ngram=3, max_ngram=2), dict(draft_token_budget=0),
                dict(drafter="oracle"), dict(num_draft_heads=9), dict(accept_alpha=0)):
        with pytest.raises(Exception):
            jserving.SpeculativeConfig(**bad)
        with pytest.raises(ValueError):
            SpeculativeConfig(**bad)
    for doc in ({"enabled": True, "max_draft_tokens": 6}, {"enabled": True, "drafter": "auto"}):
        cfg = ServingConfig.from_dict({"speculative": doc}).speculative
        assert cfg.enabled and {k: getattr(cfg, k) for k in doc} == doc
        assert cfg == SpeculativeConfig(**doc)


def test_stats_report_none_when_disabled(make_engine):
    sched = ServingScheduler(make_engine(), ServingConfig(), start=False)
    try:
        assert sched.stats()["speculative"] is None
    finally:
        sched.stop(drain=False)


SPEC_EXCHANGES = (
    ("POST", "/v1/generate", {"prompt": REPEAT, "max_new_tokens": 9}),
    ("POST", "/v1/generate", {"prompt": REPEAT, "max_new_tokens": 9}),  # trie-mined drafts
    ("POST", "/v1/generate", {"prompt": REPEAT[:15], "max_new_tokens": 7, "stream": True}),
    ("POST", "/v1/generate", {"prompt": REPEAT[:12], "max_new_tokens": 6, "temperature": 0.8, "seed": 3}),
    ("POST", "/v1/generate", {"prompt": [9, 1, 200], "max_new_tokens": 3, "drafter": "learned"}),
    ("GET", "/v1/stats", None),
)


def test_server_spec_field_equals_the_reference_bytes(setup, make_engine):
    """With speculation on, every response document (its ``spec`` field
    included) and the stats document equal the JAX server's, masked fields
    replaced."""
    config = _spec_dict(k=3)
    servers = {"jax": jserving.ServingServer(jserving.ServingScheduler(_jax_engine(setup),
                                                                       jserving.ServingConfig(**config))).start(),
               "port": ServingServer(ServingScheduler(make_engine(), ServingConfig.from_dict(config))).start()}
    try:
        for method, path, body in SPEC_EXCHANGES:
            got = {k: _exchange(srv.url, method, path, body) for k, srv in servers.items()}
            assert got["port"] == got["jax"], (method, path, body)
        first = json.loads(_exchange(servers["port"].url, *SPEC_EXCHANGES[0][:2], SPEC_EXCHANGES[0][2])[2])
        assert first["spec"]["drafter"] == "prompt_lookup" and first["spec"]["accepted"] > 0
    finally:
        for srv in servers.values():
            srv.stop(drain=False)
