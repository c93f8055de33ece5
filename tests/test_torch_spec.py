"""Port parity: speculative decoding's mechanism on deepspeed_tpu_torch against deepspeed_tpu.

The cases of ``tests/unit/inference/v2/test_spec.py`` and ``test_spec_tree.py``
(drafters, trie mining, rollback, the linear ``verify`` feed, token trees,
``verify_tree``, ``compact_accepted``), each run through both packages on
the same inputs: the JAX package's tiny f32 Llama, carried across by
``models/convert.py``, prompts and draft tokens from numpy seeds, the JAX
engine on the CPU. Logits, hidden states and the compacted cache must agree
within ``TOL`` (f32 on both sides, as ``tests/test_torch_engine.py``); token
ids, drafts, tree shapes, sequence descriptors and pool balances exactly.

Tree verify is held to the port's own linear ``verify`` within ``TREE_TOL``,
not bit for bit: the port scores a tree under a mask over the shared history
(``transformer_base._tree_visibility``), where the JAX package gathers a
per-query view to make a chain bitwise equal to the linear feed on XLA (and
under jax 0.9 on the CPU even that differs by about 2e-6).

Then the port alone: sampled ``decode_loop`` (the same generator seed gives
the same tokens, another seed other tokens, temperature towards 0 the greedy
tokens, and a chi-square test of ``sample_categorical`` against ``softmax(l /
T)``), the learned drafter's heads across packages byte for byte, and
``spec.distill``. The two cases that need the card, B1 on a multi-token
verify feed against its plain version and stale KV behind B1 after a
rollback, are in ``tests/test_torch_cuda_kernels.py`` (which imports the port
only, as the card's machine has no jax).
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2 import spec as j_spec
from deepspeed_tpu.inference.v2.ragged import kv_cache as j_kv
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.inference.v2.ragged import prefix_cache as j_pc
from deepspeed_tpu.inference.v2.spec import distill as j_distill
from deepspeed_tpu_torch.inference.v2 import spec as t_spec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.model_implementations.transformer_base import sample_categorical
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as t_kv
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as t_mc
from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache as t_pc
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.inference.v2.spec import distill as t_distill
from deepspeed_tpu_torch.inference.v2.spec import TokenTree
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

# f32 on both sides; XLA's and torch's CPU matmuls sum in different orders
TOL = dict(rtol=1e-4, atol=1e-4)
# the port's tree verify against its own linear verify: the same f32 ops on
# differently shaped operands (Qm rows of the largest tree against T rows)
TREE_TOL = dict(rtol=1e-5, atol=1e-5)
PACKAGES = ("jax", "port")


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    return jcfg, jparams, port_config(jcfg), port_params(jcfg, jparams)


@pytest.fixture
def make(setup):
    """``make(pkg, blocks=64)``: an engine of either package over the same
    weights, pool and block size (16)."""
    jcfg, jparams, cfg, params = setup

    def _make(pkg, blocks=64):
        if pkg == "jax":
            mgr = j_mc.DSStateManagerConfig(memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE,
                                                                            size=blocks), max_context=512)
            return j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(state_manager=mgr,
                                                                                              kv_block_size=16))
        mgr = t_mc.DSStateManagerConfig(memory_config=t_mc.MemoryConfig(mode=t_mc.AllocationMode.ALLOCATE,
                                                                        size=blocks), max_context=512)
        return build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16),
                            device="cpu")

    return _make


def _logits(engine, uids, prompts):
    out = engine.put(uids, prompts)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _prefill_argmax(engine, prompt, uid=0):
    return int(np.argmax(_logits(engine, [uid], [prompt])[0]))


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _greedy_reference(engine, prompt, n):
    out = [_prefill_argmax(engine, prompt)]
    while len(out) < n:
        out.append(int(np.argmax(_logits(engine, [0], [[out[-1]]])[0])))
    return out


def _seq(engine, uid=0):
    seq = engine._state_manager.get_sequence(uid)
    return seq.seen_tokens, seq.kv_blocks.tolist()


# ----------------------------------------------------------------- drafter --
@pytest.mark.parametrize("history,k,want", [
    ([1, 2, 3, 4, 5, 1, 2, 3], 4, [4, 5, 1, 2]),  # suffix [1,2,3] occurred at 0
    ([1, 2, 9, 1, 2, 7, 1, 2], 3, [7, 1, 2]),  # the most recent [1,2] wins
    ([1, 2, 3, 4, 5, 6, 1, 2], 2, [3, 4]),  # capped at k
    ([7, 8, 9, 10], 4, []),  # no pattern
    ([5], 4, []),  # too short for any n-gram
    ([1, 2, 3, 1, 2, 3], 0, []),  # k=0 never proposes
], ids=["longest_ngram", "most_recent", "caps_at_k", "no_pattern", "too_short", "k0"])
def test_self_lookup_drafts_equal_the_reference(history, k, want):
    for spec in (j_spec, t_spec):
        got = spec.PromptLookupDrafter(min_ngram=1, max_ngram=3).draft(history, k)
        assert got.dtype == np.int32 and got.tolist() == want


def test_drafter_validates_ngram_bounds():
    for spec in (j_spec, t_spec):
        with pytest.raises(ValueError):
            spec.PromptLookupDrafter(min_ngram=3, max_ngram=2)
        with pytest.raises(ValueError):
            spec.PromptLookupDrafter(min_ngram=0)


def test_self_lookup_on_random_histories_equals_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(200):
        hist = rng.integers(0, 6, int(rng.integers(1, 40)))
        k = int(rng.integers(0, 6))
        lo = int(rng.integers(1, 4))
        hi = lo + int(rng.integers(0, 3))
        assert (t_spec.PromptLookupDrafter(lo, hi).draft(hist, k).tolist() ==
                j_spec.PromptLookupDrafter(lo, hi).draft(hist, k).tolist())


# -------------------------------------------------------------- trie mining --
def _tries():
    """Both packages' tries over a 4-token-block cache of 32 blocks."""
    jkv = j_kv.BlockedKVCache(j_mc.KVCacheConfig(block_size=4, cache_shape=(1, 1, 4), cache_dtype="float32",
                                                 max_blocks_per_allocation_group=64),
                              j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE, size=32))
    tkv = t_kv.BlockedKVCache(t_mc.KVCacheConfig(block_size=4, cache_shape=(1, 1, 4), cache_dtype="float32",
                                                 max_blocks_per_allocation_group=64),
                              t_mc.MemoryConfig(mode=t_mc.AllocationMode.ALLOCATE, size=32), "cpu")
    return (j_pc.PrefixCache(jkv), jkv), (t_pc.PrefixCache(tkv), tkv)


@pytest.mark.parametrize("published,committed,history,k,want", [
    (np.arange(100, 114), 12, np.arange(100, 106), 5, [106, 107, 108, 109, 110]),  # mid-block tail
    (np.arange(100, 114), 12, np.arange(100, 108), 3, [108, 109, 110]),  # at a block boundary
    (np.arange(100, 114), 12, np.arange(100, 112), 3, []),  # past the committed region
    (np.arange(100, 112), 12, [100, 101, 102, 103, 999], 4, []),  # divergent history
    (np.arange(100, 112), 12, [55, 56, 57, 58, 59], 4, []),
], ids=["mid_block", "block_boundary", "past_committed", "divergent", "unknown"])
def test_trie_lookup_continuation_equals_the_reference(published, committed, history, k, want):
    for pc, kv in _tries():
        pc.publish(np.asarray(published, np.int32), kv.reserve(3), committed_tokens=committed)
        assert pc.lookup_continuation(np.asarray(history), k).tolist() == want


def test_trie_lookup_takes_no_references_and_leaves_lru_untouched():
    for pc, kv in _tries():
        blocks = kv.reserve(2)
        pc.publish(np.arange(8, dtype=np.int32), blocks, committed_tokens=8)
        touches = {n.digest: n.last_touch for n in pc._by_digest.values()}
        refs = {int(b): kv.ref_count(int(b)) for b in blocks}
        assert pc.lookup_continuation(np.arange(5), 3).tolist() == [5, 6, 7]
        assert {n.digest: n.last_touch for n in pc._by_digest.values()} == touches
        assert {int(b): kv.ref_count(int(b)) for b in blocks} == refs


def test_drafter_prefers_trie_over_self_lookup():
    hist = np.asarray([1, 2, 3, 1, 2, 3, 1, 2], np.int32)
    for (pc, kv), spec in zip(_tries(), (j_spec, t_spec)):
        pc.publish(np.asarray([1, 2, 3, 1, 2, 3, 1, 2, 50, 60, 70, 80], np.int32), kv.reserve(3),
                   committed_tokens=12)
        assert spec.PromptLookupDrafter(prefix_cache=pc).draft(hist, 2).tolist() == [50, 60]


# ------------------------------------------------------- descriptor rollback --
def test_sequence_descriptor_rollback_bounds():
    seq = DSSequenceDescriptor(0)
    seq.pre_forward(5)
    with pytest.raises(RuntimeError):  # in-flight tokens: not rollbackable
        seq.rollback(1)
    seq.post_forward()
    seq.rollback(2)
    assert seq.seen_tokens == 3
    with pytest.raises(ValueError):
        seq.rollback(4)  # more than committed
    with pytest.raises(ValueError):
        seq.rollback(-1)
    seq.rollback(0)
    assert seq.seen_tokens == 3


# ------------------------------------------------------------ engine verify --
def test_verify_fully_accepted_feed_matches_the_reference_and_sequential_decode(make, setup):
    """Oracle drafts: each verify step emits k+1 tokens of the sequential
    greedy continuation; per-position logits agree with the JAX engine's."""
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 24, 0)
    ref = _greedy_reference(make("port"), prompt, 9)
    runs = {}
    for pkg in PACKAGES:
        engine = make(pkg)
        out = [_prefill_argmax(engine, prompt)]
        rows_seen, seens = [], []
        while len(out) < 9:
            feed = np.asarray([out[-1]] + ref[len(out):len(out) + 3], np.int32)
            rows = engine.verify([0], [feed])[0]
            assert rows.shape == (feed.size, vocab) and rows.dtype == np.float32
            engine.rollback(0, 0)
            out.extend(int(np.argmax(r)) for r in rows)
            rows_seen.append(rows)
            seens.append(_seq(engine))
        runs[pkg] = (out[:9], rows_seen, seens)
    assert runs["port"][0] == runs["jax"][0] == ref
    assert runs["port"][2] == runs["jax"][2]
    for got, want in zip(runs["port"][1], runs["jax"][1]):
        np.testing.assert_allclose(got, want, **TOL)


def test_verify_greedy_returns_device_argmax_ids(make, setup):
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 20, 1)
    feeds = {}
    for greedy in (False, True):
        engine = make("port")
        t1 = _prefill_argmax(engine, prompt)
        out = engine.verify([0], [np.asarray([t1, 3, 9, 4], np.int32)], greedy=greedy)[0]
        feeds[greedy] = out
    assert feeds[True].dtype == np.int32 and feeds[True].shape == (4, )
    np.testing.assert_array_equal(feeds[True], np.argmax(feeds[False], axis=-1))
    jengine = make("jax")
    t1 = _prefill_argmax(jengine, prompt)
    np.testing.assert_array_equal(feeds[True],
                                  jengine.verify([0], [np.asarray([t1, 3, 9, 4], np.int32)], greedy=True)[0][:4])


def test_verify_rejection_rolls_back_and_continues_exactly(make, setup):
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 24, 0)
    ref = _greedy_reference(make("port"), prompt, 3)
    states = {}
    for pkg in PACKAGES:
        engine = make(pkg)
        t1 = _prefill_argmax(engine, prompt)
        assert t1 == ref[0]
        bad = np.asarray([t1, (ref[1] + 1) % vocab, 7, 9], np.int32)  # only the input position survives
        emitted = int(np.argmax(engine.verify([0], [bad])[0][0]))
        engine.rollback(0, bad.size - 1)
        assert engine._state_manager.get_sequence(0).seen_tokens == prompt.size + 1
        assert emitted == ref[1]
        # the stale KV is overwritten by the correct token's write
        nxt = _logits(engine, [0], [[emitted]])
        assert int(np.argmax(nxt[0])) == ref[2]
        states[pkg] = (_seq(engine), nxt)
    assert states["port"][0] == states["jax"][0]
    np.testing.assert_allclose(states["port"][1], states["jax"][1], **TOL)


def test_verify_batches_multiple_sequences_with_ragged_widths(make, setup):
    vocab = setup[0].vocab_size
    rng = np.random.default_rng(1)
    p0, p1 = rng.integers(0, vocab, 20), rng.integers(0, vocab, 12)
    runs = {}
    for pkg in PACKAGES:
        engine = make(pkg)
        logits = _logits(engine, [0, 1], [p0, p1])
        n0, n1 = int(np.argmax(logits[0])), int(np.argmax(logits[1]))
        rows = engine.verify([0, 1], [np.asarray([n0, 1, 2], np.int32), np.asarray([n1], np.int32)])
        assert rows[0].shape == (3, vocab) and rows[1].shape == (1, vocab)
        assert engine._state_manager.get_sequence(0).seen_tokens == p0.size + 3
        assert engine._state_manager.get_sequence(1).seen_tokens == p1.size + 1
        runs[pkg] = rows
    for got, want in zip(runs["port"], runs["jax"]):
        np.testing.assert_allclose(got, want, **TOL)


def test_decode_loop_multi_token_feed_contract(make, setup):
    """Multi-token entries run the greedy verify feed; misuse raises."""
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 24, 0)
    ref = _greedy_reference(make("port"), prompt, 4)
    engine = make("port")
    t1 = _prefill_argmax(engine, prompt)
    out = engine.decode_loop([0], [np.asarray([t1] + ref[1:3], np.int32)], 1)
    assert isinstance(out, list) and out[0].shape == (3, )
    assert out[0].tolist() == ref[1:4]  # oracle drafts: the greedy continuation
    engine.rollback(0, 0)
    with pytest.raises(ValueError, match="one step"):
        engine.decode_loop([0], [np.asarray([1, 2], np.int32)], 2)
    with pytest.raises(ValueError, match="greedy"):
        engine.decode_loop([0], [np.asarray([1, 2], np.int32)], 1, temperature=0.5,
                           generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="at least one"):
        engine.decode_loop([0], [np.asarray([], np.int32)], 1)
    engine.flush(0)


def test_engine_rollback_validates_uid(make):
    engine = make("port")
    with pytest.raises(ValueError, match="unknown uid"):
        engine.rollback(404, 1)
    engine.rollback(404, 0)  # 0 is a no-op even for unknown uids


def test_verify_spans_observer_and_telemetry(make):
    """verify and verify_tree report to the dispatch observer, record a span
    and write the inference_* families, as the reference's do."""
    from deepspeed_tpu_torch import telemetry as ttel
    ttel.shutdown()
    ttel.state.registry = None
    ttel.configure({"enabled": True})
    try:
        engine = make("port")
        seen = []
        engine.dispatch_observer = lambda *a: seen.append(a[:3])
        t1 = _prefill_argmax(engine, np.arange(9))
        engine.verify([0], [np.asarray([t1, 1, 2], np.int32)])
        engine.verify_tree([0], [TokenTree([1, 2, 3], [-1, 0, 0])])
        assert seen == [("put", 1, 9), ("verify", 1, 3), ("verify_tree", 1, 3)]
        names = [s["name"] for s in ttel.get_span_recorder().tail(10)]
        assert names.count("verify") == 1 and names.count("verify_tree") == 1
        snap = ttel.get_registry().snapshot()
        assert sum(v for _, v in snap["inference_tokens_total"]) == 15
        assert sum(v for _, v in snap["inference_batches_total"]) == 3
    finally:
        ttel.shutdown()
        ttel.state.registry = None


# --------------------------------------------------------------- container --
def test_token_tree_chain_and_validation():
    t = TokenTree.chain([5, 6, 7])
    assert t.size == 3 and t.is_chain and t.max_depth == 2
    assert t.parents.tolist() == [-1, 0, 1] and t.depths.tolist() == [0, 1, 2]
    t = TokenTree([1, 2, 3, 4], [-1, 0, 0, 1])  # root -> {a, b}, a -> c
    assert not t.is_chain and t.max_depth == 2
    assert t.children(0) == [1, 2] and t.children(1) == [3]
    assert t.child_with_token(0, 3) == 2 and t.child_with_token(0, 9) is None
    assert repr(t) == repr(j_spec.TokenTree([1, 2, 3, 4], [-1, 0, 0, 1]))
    with pytest.raises(ValueError, match="root"):
        TokenTree([1, 2], [0, 0])
    with pytest.raises(ValueError, match="topological"):
        TokenTree([1, 2, 3], [-1, 2, 0])
    with pytest.raises(ValueError):
        TokenTree([], [])
    with pytest.raises(ValueError, match="depths"):
        TokenTree([1, 2], [-1, 0], depths=[0, 2])


def test_ragged_wrapper_packs_and_rejects_tree_metadata():
    w = RaggedBatchWrapper(t_mc.DSStateManagerConfig())
    seq = DSSequenceDescriptor(0)
    with pytest.raises(ValueError, match="align"):
        w.insert_sequence(seq, [1, 2, 3], tree=([-1, 0], [0, 1]))
    with pytest.raises(ValueError, match="root"):
        w.insert_sequence(seq, [1, 2], tree=([0, 0], [1, 1]))
    with pytest.raises(ValueError, match="topological"):
        w.insert_sequence(seq, [1, 2, 3], tree=([-1, 2, 0], [0, 1, 1]))
    assert w.current_tokens == 0  # a rejected insert leaves the wrapper clean
    w.insert_sequence(DSSequenceDescriptor(1), [4, 5])  # a linear feed rides as a chain
    w.insert_sequence(seq, [1, 2, 3], tree=([-1, 0, 0], [0, 1, 1]))
    batch = w.finalize()
    from deepspeed_tpu.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper as JWrapper
    from deepspeed_tpu.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor as JSeq
    jw = JWrapper(j_mc.DSStateManagerConfig())
    jw.insert_sequence(JSeq(1), [4, 5])
    jw.insert_sequence(JSeq(0), [1, 2, 3], tree=([-1, 0, 0], [0, 1, 1]))
    jbatch = jw.finalize()
    np.testing.assert_array_equal(batch["tree_meta"], jbatch["tree_meta"])
    np.testing.assert_array_equal(batch["tok_meta"], jbatch["tok_meta"])
    assert batch["tree_meta"][:, :5].tolist() == [[-1, 0, -1, 0, 0], [0, 1, 0, 1, 1]]
    w.clear()
    w.insert_sequence(seq, [1, 2])
    assert "tree_meta" not in w.finalize()  # linear batches pack what they always did


# ------------------------------------------------------------- tree verify --
def test_chain_tree_verify_matches_linear_verify_and_the_reference(make, setup):
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 24, 0)
    lin = make("port")
    t1 = _prefill_argmax(lin, prompt)
    feed = np.asarray([t1, 3, 9, 4], np.int32)
    lin_rows = lin.verify([0], [feed])[0]
    outs = {}
    for pkg in PACKAGES:
        tre = make(pkg)
        assert _prefill_argmax(tre, prompt) == t1
        tree = (j_spec if pkg == "jax" else t_spec).TokenTree.chain(feed)
        outs[pkg] = tre.verify_tree([0], [tree])[0]
        assert outs[pkg]["rows"].shape == (4, vocab) and outs[pkg]["hidden"].shape == (4, setup[0].hidden_size)
        assert tre._state_manager.get_sequence(0).seen_tokens == prompt.size + 4
    np.testing.assert_allclose(outs["port"]["rows"], lin_rows, **TREE_TOL)
    np.testing.assert_allclose(outs["port"]["rows"], outs["jax"]["rows"], **TOL)
    np.testing.assert_allclose(outs["port"]["hidden"], outs["jax"]["hidden"], **TOL)


def test_tree_greedy_ids_match_logits_argmax(make, setup):
    prompt = _prompt(setup[0].vocab_size, 16, 1)
    outs = {}
    for pkg, greedy in (("port", False), ("port", True), ("jax", True)):
        eng = make(pkg)
        t1 = _prefill_argmax(eng, prompt)
        tree = (j_spec if pkg == "jax" else t_spec).TokenTree([t1, 1, 2, 3, 4], [-1, 0, 0, 1, 2])
        outs[pkg, greedy] = eng.verify_tree([0], [tree], greedy=greedy)[0]
    got = outs["port", True]
    assert got["rows"] is None and got["ids"].dtype == np.int32 and got["ids"].shape == (5, )
    np.testing.assert_array_equal(got["ids"], np.argmax(outs["port", False]["rows"], axis=-1))
    np.testing.assert_array_equal(got["ids"], outs["jax", True]["ids"][:5])
    np.testing.assert_allclose(got["hidden"], outs["port", False]["hidden"], rtol=0, atol=0)


def test_sibling_branches_are_mutually_invisible(make, setup):
    """Each branch of a tree scores as if fed alone as a chain."""
    prompt = _prompt(setup[0].vocab_size, 20, 2)
    eng = make("port")
    t1 = _prefill_argmax(eng, prompt)
    tree = TokenTree([t1, 7, 11, 3, 5], [-1, 0, 1, 0, 3])  # root -> {7 -> 11, 3 -> 5}
    rows = eng.verify_tree([0], [tree])[0]["rows"]
    for chain_nodes in ([0, 1, 2], [0, 3, 4]):
        ref = make("port")
        assert _prefill_argmax(ref, prompt) == t1
        ref_rows = ref.verify([0], [tree.tokens[chain_nodes]])[0]
        np.testing.assert_allclose(rows[chain_nodes], ref_rows, **TREE_TOL)
    # control: the same tree as a chain (siblings see each other) scores otherwise
    chain = make("port")
    _prefill_argmax(chain, prompt)
    leaky = chain.verify([0], [tree.tokens])[0]
    assert not np.allclose(leaky[3:], rows[3:], **TREE_TOL)


def test_ragged_multi_sequence_tree_packing_matches_solo_and_the_reference(make, setup):
    vocab = setup[0].vocab_size
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, n) for n in (20, 12, 9)]
    shapes = [([7, 11, 3, 5], [-1, 0, 1, 0, 3]), ([2, 4], [-1, 0, 0]), ([8], [-1, 0])]
    outs = {}
    for pkg in PACKAGES:
        spec = j_spec if pkg == "jax" else t_spec
        eng = make(pkg)
        logits = _logits(eng, [0, 1, 2], prompts)
        nxt = [int(np.argmax(logits[i])) for i in range(3)]
        trees = [spec.TokenTree([n] + toks, par) for n, (toks, par) in zip(nxt, shapes)]
        outs[pkg] = eng.verify_tree([0, 1, 2], trees)
        for i, (prompt, tree) in enumerate(zip(prompts, trees)):
            assert eng._state_manager.get_sequence(i).seen_tokens == prompt.size + tree.size
            if pkg == "port":
                solo = make("port")
                assert _prefill_argmax(solo, prompt) == nxt[i]
                ref = solo.verify_tree([0], [tree])[0]
                np.testing.assert_allclose(outs[pkg][i]["rows"], ref["rows"], **TREE_TOL)
                np.testing.assert_allclose(outs[pkg][i]["hidden"], ref["hidden"], **TREE_TOL)
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got["rows"], want["rows"], **TOL)
        np.testing.assert_allclose(got["hidden"], want["hidden"], **TOL)


def test_tree_mask_rows_are_bounded_by_the_largest_tree(make):
    """The port's tree mask has Qm = the largest tree of the batch, not the
    token bucket (the reference's per-query view of Qm = T rows would take
    tens of GB at Llama-2-7B width)."""
    w = RaggedBatchWrapper(t_mc.DSStateManagerConfig())
    for uid, (seen, tree) in enumerate(((20, TokenTree([1, 2, 3], [-1, 0, 0])),
                                        (9, TokenTree.chain([4, 5, 6, 7, 8])))):
        seq = DSSequenceDescriptor(uid)
        seq.pre_forward(seen)
        seq.post_forward()
        seq.extend_kv_cache([2 * uid, 2 * uid + 1])
        w.insert_sequence(seq, tree.tokens, tree=(tree.parents, tree.depths))
    batch = w.finalize()
    assert batch["tok_meta"].shape[1] == 8
    visible, Qm = make("port").model._tree_visibility(batch["tok_meta"], batch["seq_meta"], batch["tree_meta"])
    assert Qm == 5 and visible.shape == (8, 5, 4 * 16)
    assert visible[0, 2, 20:23].tolist() == [True, False, True]  # the root and itself, not the sibling
    assert visible[0, :3, :20].all() and not visible[0, :3, 23:].any() and not visible[0, 3:].any()
    assert visible[1, 4, :14].all() and not visible[1, 3, 13] and not visible[2:].any()


# ------------------------------------------------------------- compaction --
def test_compact_accepted_repacks_branch_and_decode_continues(make, setup):
    """Accept the second branch of a tree (nodes at non-contiguous slots):
    the accepted KV moves to contiguous slots, the rest truncates, and
    decode continues as after a linear feed of the accepted tokens. The
    compacted cache equals the JAX package's."""
    vocab = setup[0].vocab_size
    prompt = _prompt(vocab, 24, 4)
    ref = make("port")
    t1 = _prefill_argmax(ref, prompt)
    a, b = 3, 5
    ref_rows = ref.verify([0], [np.asarray([t1, a, b], np.int32)])[0]
    ref_out = [int(np.argmax(ref_rows[-1]))]
    for _ in range(3):
        ref_out.append(int(np.argmax(_logits(ref, [0], [[ref_out[-1]]])[0])))
    caches = {}
    for pkg in PACKAGES:
        eng = make(pkg)
        assert _prefill_argmax(eng, prompt) == t1
        tree = (j_spec if pkg == "jax" else t_spec).TokenTree([t1, 7, 11, a, b], [-1, 0, 1, 0, 3])
        out = eng.verify_tree([0], [tree])[0]
        if pkg == "port":
            np.testing.assert_allclose(out["rows"][[0, 3, 4]], ref_rows, **TREE_TOL)
        assert eng.compact_accepted(0, tree.size, [3, 4]) == 2
        seen, blocks = _seq(eng)
        assert seen == prompt.size + 3  # t1, a, b committed
        cache = eng._state_manager.kv_cache.cache
        cache = cache.numpy() if isinstance(cache, torch.Tensor) else np.asarray(cache)
        flat = cache[:, :, blocks].transpose(0, 1, 2, 4, 3, 5).reshape(cache.shape[0], 2, -1, *cache.shape[3:4],
                                                                         cache.shape[5])
        caches[pkg] = flat[:, :, :seen]  # every committed slot, compacted ones included
        tree_out = [int(np.argmax(out["rows"][4]))]
        for _ in range(3):
            tree_out.append(int(np.argmax(_logits(eng, [0], [[tree_out[-1]]])[0])))
        assert tree_out == ref_out
    np.testing.assert_allclose(caches["port"], caches["jax"], **TOL)


def test_compact_accepted_chain_path_moves_no_kv(make, setup, monkeypatch):
    prompt = _prompt(setup[0].vocab_size, 16, 5)
    eng = make("port")
    t1 = _prefill_argmax(eng, prompt)
    tree = TokenTree([t1, 1, 2, 3], [-1, 0, 1, 2])
    eng.verify_tree([0], [tree])
    calls = []
    monkeypatch.setattr(eng.model, "compact_kv", lambda *a: calls.append(a))
    assert eng.compact_accepted(0, tree.size, [1, 2]) == 1
    assert calls == []  # contiguous path: pure rollback
    assert eng._state_manager.get_sequence(0).seen_tokens == prompt.size + 3


def test_compact_kv_gathers_before_it_scatters(make):
    """Overlapping source and destination pairs (a chain shifted by one)
    read the pre-copy cache."""
    eng = make("port")
    eng.put([0], [np.arange(40)])
    seq = eng._state_manager.get_sequence(0)
    cache = eng._state_manager.kv_cache.cache
    before = cache.clone()
    eng.model.compact_kv(seq, [20, 21, 22], [21, 22, 23])
    bs = 16
    slot = lambda c, p: c[:, :, int(seq.kv_blocks[p // bs]), :, p % bs]
    for src, dst in ((20, 21), (21, 22), (22, 23)):
        torch.testing.assert_close(slot(cache, dst), slot(before, src), rtol=0, atol=0)
    torch.testing.assert_close(slot(cache, 20), slot(before, 20), rtol=0, atol=0)


def test_compact_accepted_validates_path(make, setup):
    eng = make("port")
    t1 = _prefill_argmax(eng, _prompt(setup[0].vocab_size, 8, 6))
    eng.verify_tree([0], [TokenTree([t1, 1, 2], [-1, 0, 0])])
    with pytest.raises(ValueError, match="ascending"):
        eng.compact_accepted(0, 3, [2, 1])
    with pytest.raises(ValueError, match="ascending"):
        eng.compact_accepted(0, 3, [0])  # the root is not part of the path
    with pytest.raises(ValueError, match="unknown uid"):
        eng.compact_accepted(404, 3, [])
    assert eng.compact_accepted(0, 3, []) == 2  # nothing accepted


def test_tree_rollback_soak_pool_balance_matches_the_reference(make, setup):
    """Interleaved tree verifies, compactions and flushes over several
    sequences never leak KV blocks; descriptors equal the JAX engine's."""
    vocab = setup[0].vocab_size
    states = {}
    for pkg in PACKAGES:
        spec = j_spec if pkg == "jax" else t_spec
        eng = make(pkg)
        total = eng._state_manager.kv_cache.num_blocks
        rng = np.random.default_rng(7)
        trace = []
        for round_ in range(4):
            uids = [10 + round_ * 3 + i for i in range(3)]
            prompts = [rng.integers(0, vocab, int(rng.integers(5, 40))) for _ in uids]
            logits = _logits(eng, uids, prompts)
            trees = [spec.TokenTree([int(np.argmax(logits[i])), 7, 11, 3, 5], [-1, 0, 1, 0, 3])
                     for i in range(len(uids))]
            eng.verify_tree(uids, trees)
            for i, uid in enumerate(uids):
                n_accept = int(rng.integers(0, 3))
                eng.compact_accepted(uid, trees[i].size, [[], [3], [3, 4]][n_accept])
                assert eng._state_manager.get_sequence(uid).seen_tokens == prompts[i].size + 1 + n_accept
                trace.append(_seq(eng, uid))
            for uid in uids:
                eng.flush(uid)
            assert eng.free_blocks == total
        assert eng._state_manager.n_tracked_sequences == 0
        states[pkg] = trace
    assert states["port"] == states["jax"]


# ---------------------------------------------------------- sampled decode --
def _sampled(make, prompt, n, temperature, seed, gen=True):
    eng = make("port")
    t1 = _prefill_argmax(eng, prompt)
    g = torch.Generator().manual_seed(seed) if gen else None
    return eng.decode_loop([0], [[t1]], n, temperature=temperature, generator=g)[0].tolist()


def test_sampled_decode_loop_is_seeded_and_tends_to_greedy(make, setup):
    prompt = _prompt(setup[0].vocab_size, 12, 8)
    a = _sampled(make, prompt, 16, 1.0, 3)
    assert a == _sampled(make, prompt, 16, 1.0, 3)  # same generator seed, same tokens
    assert a != _sampled(make, prompt, 16, 1.0, 4)  # another seed differs
    eng = make("port")
    t1 = _prefill_argmax(eng, prompt)
    greedy = eng.decode_loop([0], [[t1]], 16)[0].tolist()
    assert _sampled(make, prompt, 16, 1e-7, 3) == greedy  # temperature -> 0: greedy
    assert a != greedy
    with pytest.raises(ValueError, match="torch.Generator"):
        _sampled(make, prompt, 2, 0.5, 0, gen=False)


def test_sampled_decode_loop_rejects_a_generator_on_another_device(make, monkeypatch):
    from deepspeed_tpu_torch.inference.v2.model_implementations import transformer_base as tb

    class _Cuda:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="lives on cuda"):
        tb._check_generator(_Cuda(), torch.device("cpu"))
    tb._check_generator(torch.Generator(), torch.device("cpu"))


def test_sample_categorical_matches_softmax_distribution():
    """Chi-square goodness of fit of 20,000 draws from one fixed row against
    softmax(l / T), at p = 0.001 (critical value of chi2 with 15 degrees of
    freedom: 37.70); a control row with the argmin forced in must fail."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=16).astype(np.float32) * 2)
    T, N = 0.7, 20000
    draws = sample_categorical(logits.expand(N, 16), T, torch.Generator().manual_seed(11))
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=16)
    p = torch.softmax(logits.double() / T, -1).numpy()
    chi2 = float(((counts - N * p) ** 2 / (N * p)).sum())
    assert chi2 < 37.70, chi2
    control = counts.copy()
    control[int(np.argmin(p))] += 500  # 500 extra draws of the least likely token
    assert float(((control - N * p) ** 2 / (N * p)).sum()) > 37.70


# ------------------------------------------------------------ learned heads --
def test_medusa_heads_are_byte_compatible_across_packages(tmp_path):
    t_head = t_spec.MedusaDraftHead.fresh(64, 256, num_heads=3, seed=4)
    j_head = j_spec.MedusaDraftHead.fresh(64, 256, num_heads=3, seed=4)
    assert t_head.head_id == j_head.head_id == "medusa-s4-3x64v256"
    t_head.save(tmp_path / "t.npz")
    j_head.save(tmp_path / "j.npz")
    assert (tmp_path / "t.npz").read_bytes() == (tmp_path / "j.npz").read_bytes()
    for head, load in ((t_head, j_spec.MedusaDraftHead.load), (j_head, t_spec.MedusaDraftHead.load)):
        back = load((tmp_path / "t.npz").read_bytes())
        assert back.head_id == head.head_id
        for p, q in zip(back.params, head.params):
            for k in p:
                np.testing.assert_array_equal(p[k], q[k])
    hidden = np.random.default_rng(2).normal(size=(5, 64)).astype(np.float32)
    targets = np.random.default_rng(3).integers(0, 256, (3, 5))
    tl, tg = t_head.loss_and_grads(hidden, targets)
    jl, jg = j_head.loss_and_grads(hidden, targets)
    assert tl == jl
    for a, b in zip(tg, jg):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("k,width,budget", [(3, 2, 8), (2, 3, 6), (1, 2, 4), (3, 1, 8), (0, 2, 8)])
def test_learned_draft_trees_equal_the_reference(k, width, budget):
    hidden = np.random.default_rng(k * 10 + width).normal(size=64).astype(np.float32)
    trees = []
    for spec in (j_spec, t_spec):
        drafter = spec.LearnedDrafter(spec.MedusaDraftHead.fresh(64, 256, num_heads=3, seed=1), width=width,
                                      node_budget=budget)
        trees.append(drafter.draft_tree(hidden, 42, k))
    if k == 0:
        assert trees == [None, None]
        return
    for field in ("tokens", "parents", "depths"):
        np.testing.assert_array_equal(getattr(trees[1], field), getattr(trees[0], field))
    assert trees[1].size <= budget and trees[1].max_depth <= k


def test_learned_drafter_validates_its_arguments():
    head = t_spec.MedusaDraftHead.fresh(8, 16, num_heads=1)
    with pytest.raises(ValueError):
        t_spec.LearnedDrafter(head, width=0)
    with pytest.raises(ValueError):
        t_spec.LearnedDrafter(head, node_budget=1)
    with pytest.raises(ValueError):
        t_spec.MedusaDraftHead([], "x")
    with pytest.raises(ValueError):
        t_spec.MedusaDraftHead.fresh(8, 16, num_heads=0)


# ------------------------------------------------------------ distillation --
def test_collect_hidden_and_dataset_match_the_reference(make, setup):
    """Teacher-forced hidden states through each package's verify_tree, in
    chunks smaller than the sequences; the pairs the trainer sees."""
    vocab = setup[0].vocab_size
    seqs = [_prompt(vocab, 21, 20).tolist(), _prompt(vocab, 9, 21).tolist()]
    hid = {pkg: (j_distill if pkg == "jax" else t_distill).collect_hidden(make(pkg), seqs, chunk=8)
           for pkg in PACKAGES}
    for got, want, s in zip(hid["port"], hid["jax"], seqs):
        assert got.shape == (len(s), setup[0].hidden_size)
        np.testing.assert_allclose(got, want, **TOL)
    X, Y = t_distill.make_dataset(seqs, hid["port"], 3)
    jX, jY = j_distill.make_dataset(seqs, hid["port"], 3)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    with pytest.raises(ValueError, match="too short"):
        t_distill.make_dataset([[1, 2, 3]], [np.zeros((3, 4))], 3)


def test_self_distill_trains_on_the_port(make):
    eng = make("port")
    head, losses = t_distill.self_distill(eng, num_heads=2, max_new_tokens=12, num_prompts=2, prompt_len=6,
                                          steps=30, lr=5e-3)
    assert head.num_heads == 2 and len(losses) == 30 and losses[-1] < losses[0]
    assert eng._state_manager.n_tracked_sequences == 0 and eng.free_blocks == 64
    same = j_distill.train(j_spec.MedusaDraftHead.fresh(64, 256, num_heads=2, seed=0),
                           *t_distill.make_dataset([list(range(20))], [np.ones((20, 64), np.float32)], 2), steps=3)
    assert same == t_distill.train(t_spec.MedusaDraftHead.fresh(64, 256, num_heads=2, seed=0),
                                   *t_distill.make_dataset([list(range(20))], [np.ones((20, 64), np.float32)], 2),
                                   steps=3)


def test_distill_main_writes_heads_and_refuses_a_checkpoint(tmp_path, capsys):
    out = tmp_path / "heads.npz"
    assert t_distill.main(["--out", str(out), "--heads", "1", "--steps", "3", "--max-new-tokens", "8",
                           "--num-prompts", "1", "--device", "cpu"]) == 0
    head = j_spec.MedusaDraftHead.load(str(out))  # the reference loads it
    assert head.num_heads == 1 and "saved" in capsys.readouterr().out
    # a checkpoint directory goes through build_hf_engine (refused until the HF loader was ported)
    from deepspeed_tpu_torch.inference.checkpoint import save_hf_checkpoint
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig.tiny(dtype=torch.float32, max_position_embeddings=64)
    save_hf_checkpoint(str(tmp_path / "ckpt"), init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    assert t_distill.main(["--out", str(tmp_path / "ckpt_heads.npz"), "--checkpoint", str(tmp_path / "ckpt"),
                           "--heads", "1", "--steps", "3", "--max-new-tokens", "8", "--num-prompts", "1",
                           "--device", "cpu"]) == 0
    assert j_spec.MedusaDraftHead.load(str(tmp_path / "ckpt_heads.npz")).num_heads == 1
