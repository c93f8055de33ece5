"""Port parity: the prefix cache (``ragged/prefix_cache.py``) and its
scheduler paths in deepspeed_tpu_torch against deepspeed_tpu.

The trie: the same scripts of ``publish``/``acquire``/``release``/``evict``/
``demote``/``clear`` (the cases of ``tests/unit/inference/v2/test_prefix_cache.py``)
run on both packages' ``PrefixCache`` over both packages' ``BlockedKVCache``,
and after every step the digests, the trie's shape, each node's block,
tier, LRU clock and tokens, the allocator's reference counts, the free
count, the hit and the stats document must be equal. Promoted blocks must
hold the bytes they were demoted with.

The scheduler: both packages' ``ServingScheduler`` with the prefix cache on
run tick for tick (``tests/test_torch_serving.py``'s ``_side_by_side``) on a
shared prefix, a fully cached prompt (the copy-on-write fork), a multi-turn
follow-up, ``min_prefix_blocks``, ``max_blocks``, trie eviction and tier
demotion under KV pressure; per-tick states, token streams, finish reasons
and every counter compare exactly. Logits of a forked, fully cached prompt
compare at the serving tests' f32 tolerance. The rest mirrors
``tests/unit/serving/test_prefix_cache.py`` on the port's engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged import kv_cache as j_kv
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.inference.v2.ragged import prefix_cache as j_pc
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as t_kv
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as t_mc
from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache as t_pc
from deepspeed_tpu_torch.serving import PrefixCacheConfig, RequestState, ServingConfig, ServingScheduler
from tests.test_torch_serving import (_jax_engine, _prompts, _run_until, _side_by_side, _submit, make_engine,  # noqa: F401
                                      setup)

BS = 4  # the reference's tiny block size: scripts spell out block boundaries
POOL = 32
LAYERS, KVH, D = 1, 1, 8
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 logits, as tests/test_torch_engine.py


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    yield
    jax.clear_caches()


def _caches(seed=0):
    """Both packages' caches over one geometry, holding the same random
    contents (so demote/promote and fork move real bytes)."""
    jcache = j_kv.BlockedKVCache(j_mc.KVCacheConfig(block_size=BS, cache_shape=(LAYERS, KVH, D), cache_dtype="float32"),
                                 j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE, size=POOL))
    tcache = t_kv.BlockedKVCache(t_mc.KVCacheConfig(block_size=BS, cache_shape=(LAYERS, KVH, D), cache_dtype="float32"),
                                 t_mc.MemoryConfig(mode=t_mc.AllocationMode.ALLOCATE, size=POOL), "cpu")
    data = np.random.default_rng(seed).standard_normal(tuple(tcache.cache.shape)).astype(np.float32)
    jcache.set_cache(jnp.asarray(data))
    tcache.cache.copy_(torch.from_numpy(data))
    return jcache, tcache


def _trie_state(pc, kv) -> dict:
    nodes = {}
    for node in pc._by_digest.values():
        nodes[node.digest] = (node.parent.digest, node.block, node.tier, node.last_touch,
                              sorted(node.children), None if node.tokens is None else node.tokens.tolist())
    refs = [kv.ref_count(b) for b in range(kv.num_blocks)]
    return dict(nodes=nodes, root=sorted(pc._root.children), refs=refs, free=kv.free_blocks, stats=pc.stats(),
                clock=pc._clock)


def _device_bytes(kv, blocks):
    if not len(blocks):
        return np.zeros(0, np.float32)
    cache = kv.cache
    if isinstance(cache, torch.Tensor):
        return cache[:, :, torch.tensor(blocks, dtype=torch.long)].numpy()
    return np.asarray(cache[:, :, jnp.asarray(blocks)])


def _run_script(script, pc_kw):
    """Apply ``script`` to both tries; returns per-step (result, state) for
    each package, plus the bytes of every block a promoted hit maps."""
    out = []
    for pkg in ("jax", "port"):
        jcache, tcache = _caches()
        kv = jcache if pkg == "jax" else tcache
        pc = (j_pc if pkg == "jax" else t_pc).PrefixCache(kv, **pc_kw)
        allocs, hits, steps = {}, {}, []
        for op, *args in script:
            if op == "publish":  # name, tokens, committed: a finished sequence's blocks
                name, toks, committed = args
                allocs[name] = kv.reserve((len(toks) + BS - 1) // BS)
                result = pc.publish(np.asarray(toks), allocs[name], committed_tokens=committed)
            elif op == "flush":
                kv.free(allocs.pop(args[0]))
                result = None
            elif op == "acquire":
                name, toks = args
                hit = pc.acquire(np.asarray(toks))
                hits[name] = hit.blocks
                result = (list(map(int, hit.blocks)), hit.tokens, _device_bytes(kv, hit.blocks).tolist())
            elif op == "release":
                pc.release(hits.pop(args[0]))
                result = None
            elif op == "record":
                pc.record_hit(*args)
                result = None
            elif op == "evict":
                result = pc.evict(*args)
            elif op == "demote":
                result = pc.demote(*args)
            elif op == "clear":
                result = pc.clear()
            elif op == "continuation":
                result = pc.lookup_continuation(np.asarray(args[0]), args[1]).tolist()
            elif op == "catalog":
                result = pc.digest_catalog(args[0])
            elif op == "export":
                blocks, toks = pc.export_nodes(pc.chain(np.asarray(args[0])))
                result = (list(map(int, blocks)), toks.tolist())
            else:
                raise ValueError(op)
            steps.append((op, result, _trie_state(pc, kv)))
        out.append(steps)
    return out


A8, B8 = list(range(8)), list(range(100, 108))
SCRIPTS = {
    # tests/unit/inference/v2/test_prefix_cache.py, step for step
    "publish_then_match_longest_prefix": ({}, [("publish", "s", list(range(10)), 10), ("flush", "s"),
                                               ("acquire", "h", list(range(9))), ("release", "h")]),
    "divergent_block_does_not_match": ({}, [("publish", "s", A8, 8), ("flush", "s"),
                                            ("acquire", "h", list(range(4)) + [99] * 4), ("release", "h"),
                                            ("acquire", "x", [99] * 4 + list(range(4, 8)))]),
    "min_prefix_blocks_gates_short_hits": ({"min_prefix_blocks": 2}, [("publish", "s", list(range(4)), 4),
                                                                      ("flush", "s"),
                                                                      ("acquire", "h", list(range(4)))]),
    "committed_cap_excludes_overrun_blocks": ({}, [("publish", "s", A8, 5)]),
    "eviction_skips_chains_shared_by_live_sequences": ({}, [("publish", "a", A8, 8), ("publish", "b", B8, 8),
                                                            ("flush", "a"), ("flush", "b"), ("acquire", "h", A8),
                                                            ("evict", 10), ("acquire", "x", B8), ("release", "h"),
                                                            ("evict", 10)]),
    "eviction_is_lru_ordered": ({}, [("publish", "a", list(range(4)), 4), ("flush", "a"),
                                     ("publish", "b", list(range(100, 104)), 4), ("flush", "b"),
                                     ("acquire", "t", list(range(4))), ("release", "t"), ("evict", 1),
                                     ("acquire", "x", list(range(100, 104))), ("acquire", "h", list(range(4))),
                                     ("release", "h")]),
    "shared_leaves_are_not_evictable": ({}, [("publish", "s", A8, 8), ("flush", "s"), ("acquire", "h", A8),
                                             ("evict", 4), ("release", "h"), ("evict", 4)]),
    "max_blocks_cap_evicts_lru_to_publish": ({"max_blocks": 2}, [("publish", "a", A8, 8), ("flush", "a"),
                                                                 ("publish", "b", B8, 8), ("flush", "b"),
                                                                 ("acquire", "x", A8), ("acquire", "h", B8),
                                                                 ("release", "h")]),
    "publish_at_cap_never_evicts_its_own_walk_path": ({"max_blocks": 1}, [("publish", "a", list(range(4)), 4),
                                                                          ("flush", "a"), ("publish", "e", A8, 8),
                                                                          ("flush", "e"), ("acquire", "h", A8),
                                                                          ("release", "h")]),
    "clear_releases_only_trie_refs": ({}, [("publish", "s", A8, 8), ("acquire", "h", A8), ("flush", "s"),
                                           ("clear", ), ("release", "h")]),
    # the tier ladder under the trie: demote (interior nodes too), promote on
    # the next acquire that walks through, a demoted node dropped by clear
    "demote_then_promote_on_hit": ({}, [("publish", "s", list(range(12)), 12), ("flush", "s"), ("demote", 2),
                                        ("acquire", "h", list(range(12))), ("release", "h"), ("demote", 5),
                                        ("evict", 1), ("clear", )]),
    "demote_skips_shared_blocks": ({}, [("publish", "s", A8, 8), ("acquire", "h", list(range(4))), ("flush", "s"),
                                        ("demote", 4), ("release", "h"), ("demote", 4), ("acquire", "g", A8),
                                        ("release", "g")]),
    # accounting, the drafter's read, the fleet's catalog and export
    "record_hit_counts_applied_hits": ({}, [("publish", "s", A8, 8), ("flush", "s"), ("acquire", "h", A8),
                                            ("record", 2, 8), ("release", "h")]),
    "lookup_continuation_mines_the_trie": ({}, [("publish", "s", list(range(16)), 16), ("flush", "s"),
                                                ("continuation", list(range(6)), 5),
                                                ("continuation", list(range(8)), 20),
                                                ("continuation", [5, 4, 3], 4), ("continuation", list(range(6)), 0)]),
    "digest_catalog_and_export_nodes": ({}, [("publish", "a", A8, 8), ("publish", "b", B8, 8), ("flush", "a"),
                                             ("flush", "b"), ("acquire", "h", A8), ("release", "h"),
                                             ("catalog", 3), ("catalog", 0), ("export", list(range(10))),
                                             ("demote", 4), ("export", A8)]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_trie_scripts_match_the_reference_step_for_step(name):
    pc_kw, script = SCRIPTS[name]
    jax_steps, port_steps = _run_script(script, pc_kw)
    for (op, jres, jstate), (_, tres, tstate) in zip(jax_steps, port_steps):
        assert tres == jres, (name, op)
        assert tstate == jstate, (name, op)
    assert port_steps[-1][2]["stats"] == jax_steps[-1][2]["stats"]


@pytest.mark.parametrize("seed", range(3))
def test_digest_chain_is_the_reference_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 32000, int(rng.integers(1, 300)))
    for bs in (4, 16, 64):
        want = j_pc.digest_chain(toks, bs)
        assert t_pc.digest_chain(toks, bs) == want
        assert t_pc.digest_chain(toks, bs, base=want[:2]) == want
    assert t_pc.DIGEST_HEX == j_pc.DIGEST_HEX


def test_fork_blocks_copies_content_isolates_writes_and_consumes_nothing_on_failure():
    jcache, tcache = _caches(seed=3)
    for kv in (jcache, tcache):
        (src, ) = kv.reserve(1)
        (dst, ) = kv.fork_blocks([src])
        assert dst != src and kv.ref_count(dst) == 1
        np.testing.assert_array_equal(_device_bytes(kv, [dst]), _device_bytes(kv, [src]))
    np.testing.assert_array_equal(_device_bytes(tcache, [0, 1]), _device_bytes(jcache, [0, 1]))
    tcache.cache[:, :, 1] = 9.0  # a write through the fork leaves the source untouched
    np.testing.assert_array_equal(_device_bytes(tcache, [0]), _device_bytes(jcache, [0]))
    held = tcache.reserve(tcache.free_blocks)
    free = tcache.free_blocks
    with pytest.raises(ValueError):
        tcache.fork_blocks([0])
    assert tcache.free_blocks == free
    tcache.free(held)


# ------------------------------------------------------------ side by side --
def _cfg(**pc):
    pc.setdefault("enabled", True)
    return {"prefix_cache": pc}


def _shared(p, extra):
    """Prompts over a shared 40-token prefix (two full 16-token blocks)."""
    return [p[0][:40] + q for q in extra]


SCHEDULER_SCENARIOS = {
    # a publisher, then three prompts over its prefix a tick apart, then a
    # burst of the same three
    "shared_prefix": (lambda p: [_submit(p[0], max_new_tokens=4), ("step", 4)] +
                      [_submit(q, max_new_tokens=5) for q in _shared(p, [p[1][:5], p[2][:9], p[3][:3]])] +
                      [("step", 6)] + [_submit(q, max_new_tokens=3) for q in _shared(p, [p[1][:5], p[2][:9]])],
                      (40, 16, 16, 16), {}, _cfg()),
    # the prompt is exactly the cached blocks: the last one forks
    # copy-on-write and the last token is fed again
    "fully_cached": (lambda p: [_submit(p[0], max_new_tokens=4), ("step", 8), _submit(p[0][:32], max_new_tokens=6),
                                _submit(p[0][:32], max_new_tokens=6)], (40, ), {}, _cfg()),
    # a two-block match under min_prefix_blocks=3 prefills cold
    "min_prefix_blocks": (lambda p: [_submit(p[0], max_new_tokens=3), ("step", 5),
                                     _submit(p[0][:36] + p[1][:7], max_new_tokens=3),
                                     _submit(p[0] + p[1][:20], max_new_tokens=3)],
                          (50, 30), {}, _cfg(min_prefix_blocks=3)),
    # the trie may pin two blocks: later publishes evict LRU leaves
    "max_blocks": (lambda p: [_submit(p[0], max_new_tokens=3), ("step", 5), _submit(p[1], max_new_tokens=3),
                              ("step", 5), _submit(p[0][:40], max_new_tokens=3)],
                   (48, 48), {}, _cfg(max_blocks=2)),
    # an 8-block pool: trie leaves go before live sequences are offloaded
    "kv_pressure": (lambda p: [_submit(p[0], max_new_tokens=3), ("step", 4), _submit(p[1], max_new_tokens=3),
                               _submit(p[0][:48] + p[2][:5], max_new_tokens=3)],
                    (64, 64, 8), {"num_blocks": 8, "max_context": 128}, _cfg()),
    # the same pressure with the tier ladder on: trie nodes demote to the
    # host tier instead of being evicted, and promote back on a hit
    "kv_pressure_tiers": (lambda p: [_submit(p[0], max_new_tokens=3), ("step", 4), _submit(p[1], max_new_tokens=3),
                                     ("step", 5), _submit(p[0][:48] + p[2][:5], max_new_tokens=3)],
                          (64, 64, 8), {"num_blocks": 8, "max_context": 128},
                          dict(_cfg(), kv_tiers={"enabled": True})),
}


@pytest.mark.parametrize("name", list(SCHEDULER_SCENARIOS))
def test_scheduler_side_by_side_with_the_prefix_cache(setup, name):
    script, lens, engine_kw, config_kw = SCHEDULER_SCENARIOS[name]
    prompts = _prompts(len(name) + 100, lens)
    jax_run, port_run = _side_by_side(setup, script(prompts), engine_kw, config_kw)
    assert port_run == jax_run
    assert port_run["tracked"] == 0 and port_run["free"] == engine_kw.get("num_blocks", 64)
    counters = port_run["counters"]
    if name in ("shared_prefix", "fully_cached", "kv_pressure_tiers"):
        assert counters["prefix_hits"] > 0
    if name == "min_prefix_blocks":
        assert counters["prefix_hits"] == 1  # only the three-block match applies
    if name == "kv_pressure":
        assert counters["prefix_evictions"] > 0
    if name == "kv_pressure_tiers":
        assert counters["tier_demotions"] > 0 and counters["prefix_evictions"] == 0
    # the cache changes no token: the same prompts with the cache off
    plain = _side_by_side(setup, script(prompts), engine_kw, {})[1]
    assert port_run["tokens"] == plain["tokens"]


def test_multi_turn_hits_the_history_published_at_finalize(setup):
    """Turn 2 is turn 1's prompt, its served tokens and a new tail: both
    packages serve the full blocks of turn 1's history from the cache."""
    p = _prompts(7, (29, 16))
    first = _side_by_side(setup, [_submit(p[0], max_new_tokens=12)], {}, _cfg())[0]["tokens"][0]
    script = [_submit(p[0], max_new_tokens=12), ("step", 20), _submit(p[0] + first + p[1][:6], max_new_tokens=4)]
    jax_run, port_run = _side_by_side(setup, script, {}, _cfg())
    assert port_run == jax_run
    assert port_run["counters"]["prefix_tokens_saved"] == 32  # (29 + 12 - 1) // 16 blocks of 16


def test_forked_full_hit_logits_match_the_reference(setup, make_engine):
    """The fully cached prompt's re-fed token: a put over a forked block,
    logits against the JAX engine's at the f32 tolerance."""
    prompt = _prompts(21, (32, ))[0]
    rows = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            from deepspeed_tpu import serving as jserving
            engine = _jax_engine(setup)
            sched = jserving.ServingScheduler(engine, jserving.ServingConfig(**_cfg()), start=False)
        else:
            engine = make_engine()
            sched = ServingScheduler(engine, ServingConfig(prefix_cache=PrefixCacheConfig(enabled=True)), start=False)
        first = sched.submit(prompt, max_new_tokens=2)
        _run_until(sched, lambda: first.finished)
        uid = 10**6
        hit = sched._prefix_cache.acquire(prompt)
        blocks = list(hit.blocks)
        blocks[-1] = int(engine._state_manager.kv_cache.fork_blocks([blocks[-1]])[0])
        sched._prefix_cache.release([hit.blocks[-1]])
        engine._state_manager.create_cached_sequence(uid, blocks, len(prompt) - 1)
        logits = engine.put([uid], [np.asarray(prompt[-1:])])
        rows.append(np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits, np.float32))
        engine.flush(uid)
        sched.stop(drain=False)
        assert engine.free_blocks == 64
    np.testing.assert_allclose(rows[1], rows[0], **TOL)


# ------------------------------------------ mirrors of the serving unit tests --
def _cached(**kw):
    return ServingConfig(prefix_cache=PrefixCacheConfig(enabled=True, **kw))


def test_full_hit_schedules_only_the_last_token(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, _cached(), start=False)
    prompt = _prompts(3, (64, ))[0]
    seed = sched.submit(prompt, max_new_tokens=3)
    _run_until(sched, lambda: seed.finished)
    fed = []
    inner = engine.put
    engine.put = lambda uids, toks, **kw: (fed.append([len(t) for t in toks]), inner(uids, toks, **kw))[1]
    req = sched.submit(prompt, max_new_tokens=3)
    _run_until(sched, lambda: req.finished)
    assert fed[0] == [1] and req.cached_tokens == 63 and req.result() == seed.result()
    sched.stop(drain=False)
    assert engine.free_blocks == 64


def test_failed_cow_fork_degrades_and_leaks_no_references(make_engine):
    engine = make_engine(num_blocks=8)
    sched = ServingScheduler(engine, _cached(), start=False)
    prompt = _prompts(4, (32, ))[0]
    seed = sched.submit(prompt, max_new_tokens=2)
    _run_until(sched, lambda: seed.finished)
    kv = engine._state_manager.kv_cache
    kv.fork_blocks = lambda src: (_ for _ in ()).throw(RuntimeError("injected fork failure"))
    req = sched.submit(prompt, max_new_tokens=2)
    _run_until(sched, lambda: req.finished)
    assert req.state is RequestState.DONE and req.result() == seed.result()
    sched.stop(drain=False)
    assert engine.free_blocks == 8
    assert all(kv.ref_count(b) == 0 for b in range(8))


def test_stats_report_the_prefix_cache_and_none_when_disabled(make_engine):
    engine = make_engine()
    sched = ServingScheduler(engine, _cached(digest_catalog_limit=2), start=False)
    p = _prompts(5, (40, ))[0]
    for _ in range(2):
        r = sched.submit(p, max_new_tokens=2)
        _run_until(sched, lambda: r.finished)
    doc = sched.stats()["prefix_cache"]
    assert doc["hits"] == 1 and doc["block_size"] == 16 and len(doc["digests"]) == 2
    assert sched.prefix_digest_catalog() == doc["digests"]
    sched.stop(drain=False)
    plain = ServingScheduler(make_engine(), ServingConfig(), start=False)
    assert plain.stats()["prefix_cache"] is None and plain.prefix_digest_catalog() is None
    plain.stop(drain=False)


@pytest.mark.parametrize("field,value", [("max_blocks", 0), ("min_prefix_blocks", 0), ("digest_catalog_limit", -1)])
def test_prefix_cache_config_bounds(field, value):
    with pytest.raises(ValueError):
        PrefixCacheConfig(**{field: value})
