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

The rest mirrors ``tests/unit/serving/test_speculative.py`` and
``test_spec_learned.py`` on the port: greedy and sampled output with
speculation on equals output with it off, token for token; the two CPU
timing gates of the reference become gates on dispatch counts, which are
deterministic; adaptive k, the rollback soak, brownout, handoff and the
drafter pin. The learned-drafter cases run on the reference's
permutation-walk fixture (attention and MLP outputs zeroed, the lm_head
rewritten so that greedy decoding walks one 256-cycle), where prompt lookup
can never match and distilled heads draft perfectly.
"""

import copy
import json
import math
import threading
import time

import jax
import numpy as np
import pytest

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2.ragged import handoff as j_handoff
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.inference.v2.spec.distill import self_distill
from deepspeed_tpu_torch.inference.v2.spec.learned import MedusaDraftHead
from deepspeed_tpu_torch.serving import (PrefixCacheConfig, ServingConfig, ServingScheduler, ServingServer,
                                         SpeculativeConfig)
from tests.test_torch_serving import (_exchange, _jax_engine, _run_until, clear_jax_caches,  # noqa: F401
                                      fresh_telemetry, make_engine, setup)
from tests.torch_port_helpers import port_params

MAX_STEPS = 600
WAIT_S = 60


def _spec_config(k=4, prefix=True, **spec_kw):
    return ServingConfig(speculative=SpeculativeConfig(enabled=True, max_draft_tokens=k, **spec_kw),
                         prefix_cache=PrefixCacheConfig(enabled=prefix))


def _spec_dict(k=4, prefix=True, **spec_kw):
    return {"speculative": dict(enabled=True, max_draft_tokens=k, **spec_kw), "prefix_cache": {"enabled": prefix}}


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


# ---------------------------------------------------------------- fixtures --
@pytest.fixture(scope="module")
def perm_setup(setup):
    """(jcfg, jparams, port params, order, perm): the permutation-walk model.
    With attention and MLP outputs zeroed, position t's residual is
    embed(tok_t), and the rewritten lm_head makes perm[current] the greedy
    argmax by a wide margin."""
    jcfg, jparams, _, _ = setup
    m = copy.deepcopy(jax.tree.map(np.asarray, jparams)["model"])
    for name, layer in m.items():
        if name.startswith("layers_"):
            layer["self_attn"]["o_proj"]["kernel"] = np.zeros_like(layer["self_attn"]["o_proj"]["kernel"])
            layer["mlp"]["down_proj"]["kernel"] = np.zeros_like(layer["mlp"]["down_proj"]["kernel"])
    rng = np.random.default_rng(5)
    V, H = jcfg.vocab_size, jcfg.hidden_size
    order = rng.permutation(V)  # one V-cycle: every walked token is distinct
    perm = np.empty(V, np.int64)
    perm[order] = np.roll(order, -1)
    emb = m["embed_tokens"]["embedding"]
    hn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    W = np.zeros((H, V), np.float32)
    W[:, perm] = hn.T * 8.0
    m["lm_head"]["kernel"] = W
    jp = {"model": m}
    return jcfg, jp, port_params(jcfg, jp), order, perm


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


@pytest.fixture(scope="module")
def distilled(perm_setup, tmp_path_factory):
    """Draft heads self-distilled by the port from the permutation model's own
    greedy generations, once for the module: (path, loss trace)."""
    engine = _engine("port", perm_setup)
    try:
        order = perm_setup[3]
        prompts = [[int(t) for t in order[i * 32:i * 32 + 8]] for i in range(6)]
        head, losses = self_distill(engine, prompts=prompts, num_heads=3, max_new_tokens=40, steps=400, lr=5e-3,
                                    seed=0)
    finally:
        engine.close()
    path = tmp_path_factory.mktemp("spec_heads") / "perm_heads.npz"
    head.save(str(path))
    return str(path), losses


def _cycle_prompt(order, start=100, n=8):
    return [int(t) for t in order[start:start + n]]


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


LEARNED_SCENARIOS = {
    "learned_greedy": (dict(drafter="learned"), dict(max_new_tokens=16)),
    "learned_sampled": (dict(drafter="learned"), dict(max_new_tokens=12, temperature=0.8, seed=77)),
    "auto_greedy": (dict(drafter="auto"), dict(max_new_tokens=20)),
    "auto_pinned_lookup": (dict(drafter="auto"), dict(max_new_tokens=10, drafter="prompt_lookup")),
}


@pytest.mark.parametrize("name", list(LEARNED_SCENARIOS))
def test_side_by_side_learned_and_auto(perm_setup, distilled, name):
    spec_kw, submit_kw = LEARNED_SCENARIOS[name]
    path, _ = distilled
    prompt = _cycle_prompt(perm_setup[3])
    config = {"speculative": dict(enabled=True, max_draft_tokens=3, draft_head_path=path, **spec_kw)}
    script = [_submit(prompt, **submit_kw), ("step", 3), _submit(_cycle_prompt(perm_setup[3], 40), **submit_kw)]
    jax_run, port_run = _side_by_side(perm_setup, script, config)
    assert port_run == jax_run
    assert port_run["counters"]["spec_tree_nodes"] > 0 and port_run["tracked"] == 0


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


# ----------------------------------------------------------------- brownout --
def _force_stage(sched, stage):
    """Drive the brownout controller to ``stage`` and pin it there."""
    thresholds = sched._brownout._thresholds
    target = 1.0 if stage >= len(thresholds) else ((thresholds[stage - 1] + thresholds[stage]) / 2 if stage else 0.0)
    for _ in range(60):
        sched._brownout.update(target)
    assert sched._brownout.stage == stage
    sched._brownout.update = lambda pressure: stage


def test_brownout_stage2_zeroes_the_draft_budget(make_engine, perm_setup, distilled):
    """Stage 2 stops drafting, linear and tree, without touching a request's
    max_new_tokens; degraded, not different."""
    lookup = ServingScheduler(make_engine(), _spec_config(k=4, prefix=False), start=False)
    tree_engine = _engine("port", perm_setup)
    tree = ServingScheduler(tree_engine, ServingConfig(speculative=SpeculativeConfig(
        enabled=True, drafter="learned", max_draft_tokens=3, draft_head_path=distilled[0])), start=False)
    try:
        for sched, prompt in ((lookup, REPEAT), (tree, _cycle_prompt(perm_setup[3]))):
            base = sched.submit(prompt, max_new_tokens=8)
            _run_until(sched, lambda: base.finished)
            assert base.spec_drafted > 0  # stage 0: speculation on
            assert sched is lookup or base.spec_accepted > 0
            nodes = sched._counters["spec_tree_nodes"]
            _force_stage(sched, 2)
            req = sched.submit(prompt, max_new_tokens=8)
            assert "speculative_disabled" in req.degraded_mode and req.max_new_tokens == 8
            _run_until(sched, lambda: req.finished)
            assert req.spec_drafted == 0 and req.decode_steps == 7  # one token a dispatch again
            assert req.tokens == base.tokens
            assert sched._counters["spec_tree_nodes"] == nodes
    finally:
        lookup.stop(drain=False)
        tree.stop(drain=False)
        tree_engine.close()


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


def test_handoff_preserves_learned_drafter_state_and_drops_a_foreign_heads(perm_setup, distilled, tmp_path):
    """Between two schedulers with the same head the per-drafter EWMAs and the
    head id ride the frame; a recipient with another head drops only the
    learned EWMA. Both continuations equal the request served whole."""
    jcfg = perm_setup[0]
    path, _ = distilled
    other = tmp_path / "other_heads.npz"
    MedusaDraftHead.fresh(jcfg.hidden_size, jcfg.vocab_size, num_heads=3, seed=9).save(str(other))
    prompt = _cycle_prompt(perm_setup[3])
    cfg = lambda p: ServingConfig(speculative=SpeculativeConfig(enabled=True, drafter="auto", max_draft_tokens=3,
                                                                draft_head_path=p))
    engines = [_engine("port", perm_setup) for _ in range(4)]
    try:
        whole_s = ServingScheduler(engines[0], ServingConfig(), start=False)
        whole = whole_s.submit(prompt, max_new_tokens=16)
        _run_until(whole_s, lambda: whole.finished)
        whole_s.stop(drain=False)
        donor = ServingScheduler(engines[1], cfg(path), start=False)
        head = donor.submit(prompt, max_new_tokens=8, handoff=True)
        _run_until(donor, lambda: head.finished)
        donor.stop(drain=False)
        assert head.spec_accepted > 0 and head._spec_ewmas.get("learned") is not None
        assert _frame_header(head.handoff_payload)["extra"]["spec"]["head_id"] == MedusaDraftHead.load(path).head_id
        for engine, heads_path, keeps_learned in ((engines[2], path, True), (engines[3], str(other), False)):
            recipient = ServingScheduler(engine, cfg(heads_path), start=False)
            tail = recipient.submit_resume(head.handoff_payload, max_new_tokens=8)
            want = {k: v for k, v in head._spec_ewmas.items() if v is not None and (keeps_learned or k != "learned")}
            assert tail._spec_ewmas == want and tail.spec_accepted == head.spec_accepted
            _run_until(recipient, lambda: tail.finished)
            assert head.result() + tail.result() == whole.result()
            recipient.stop(drain=False)
    finally:
        for engine in engines:
            engine.close()


# ------------------------------------------------------------ learned drafter --
def test_self_distill_learns_the_permutation(perm_setup, distilled):
    """The loss trace collapses, and the saved heads predict perm^(2+h) from
    the hidden state of token v, embed(v)."""
    jcfg, jparams, _, _, perm = perm_setup
    path, losses = distilled
    assert losses[-1] < losses[0] and losses[-1] < 0.1
    head = MedusaDraftHead.load(path)
    lp = head.head_log_probs(jparams["model"]["embed_tokens"]["embedding"].astype(np.float32))
    for h in range(head.num_heads):
        targ = np.arange(jcfg.vocab_size)
        for _ in range(2 + h):
            targ = perm[targ]
        assert (np.argmax(lp[h], axis=-1) == targ).mean() > 0.5


def test_learned_acceptance_strictly_beats_prompt_lookup(perm_setup, distilled):
    """On the cycle walk prompt lookup accepts nothing and pays a dispatch a
    token; the learned heads land the same tokens in strictly fewer
    dispatches at more than one token a step; greedy and sampled output
    equals spec-off, cold and warm."""
    prompt = _cycle_prompt(perm_setup[3])
    engines = []

    def run(cfg, n=20, **kw):
        engines.append(_engine("port", perm_setup))
        sched = ServingScheduler(engines[-1], cfg, start=False)
        try:
            reqs = [sched.submit(prompt, max_new_tokens=n, **kw) for _ in range(2)]  # cold, then beside it
            _run_until(sched, lambda: all(r.finished for r in reqs))
        finally:
            sched.stop(drain=False)
        assert engines[-1].free_blocks == 64
        return reqs[0]

    learned_cfg = ServingConfig(speculative=SpeculativeConfig(enabled=True, drafter="learned", max_draft_tokens=3,
                                                              draft_head_path=distilled[0]))
    try:
        off = run(ServingConfig())
        lookup = run(ServingConfig(speculative=SpeculativeConfig(enabled=True, max_draft_tokens=3)))
        learned = run(learned_cfg)
        assert off.result() == lookup.result() == learned.result()
        assert lookup.spec_accepted == 0 < learned.spec_accepted
        assert learned.decode_steps < lookup.decode_steps
        assert len(learned.tokens) / learned.decode_steps > 1.0
        sampled = dict(n=12, temperature=0.8, seed=77)
        assert run(learned_cfg, **sampled).result() == run(ServingConfig(), **sampled).result()
    finally:
        for engine in engines:
            engine.close()


def test_auto_arbitration_and_drafter_pins(perm_setup, distilled):
    """auto races both drafters and settles on the learned heads without
    changing the tokens; a learned pin never explores prompt lookup, an
    unknown pin fails at submit; the stats document names each drafter."""
    prompt = _cycle_prompt(perm_setup[3])
    engine = _engine("port", perm_setup)
    sched = ServingScheduler(engine, ServingConfig(speculative=SpeculativeConfig(
        enabled=True, drafter="auto", max_draft_tokens=3, draft_head_path=distilled[0])), start=False)
    try:
        with pytest.raises(ValueError):
            sched.submit(prompt, max_new_tokens=4, drafter="medusa")
        free = sched.submit(prompt, max_new_tokens=20)
        _run_until(sched, lambda: free.finished)
        assert free._spec_ewmas["learned"] > free._spec_ewmas["prompt_lookup"] and free.spec_accepted > 0
        assert sched._counters["spec_drafter_switches"] >= 1
        pinned = sched.submit(prompt, max_new_tokens=20, drafter="learned")
        _run_until(sched, lambda: pinned.finished)
        assert pinned._spec_last_drafter == "learned" and "prompt_lookup" not in pinned._spec_ewmas
        assert pinned.result() == free.result()
        doc = sched.stats()["speculative"]
        assert doc["drafter"] == "auto" and doc["head_id"] == MedusaDraftHead.load(distilled[0]).head_id
        assert doc["drafters"]["learned"]["accepted"] > 0 and doc["tree"]["nodes"] > 0
    finally:
        sched.stop(drain=False)
        engine.close()


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
