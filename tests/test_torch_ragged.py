"""Port parity: the ragged KV substrate (allocator, sequences, state manager,
batch wrapper and configs) of deepspeed_tpu_torch against deepspeed_tpu.

This is host logic, so everything must be identical: block ids, free lists,
refcounts, and the packed ``tok_meta``/``seq_meta`` arrays of each bucket.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged import blocked_allocator as j_alloc
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_cfg
from deepspeed_tpu.inference.v2.ragged import ragged_manager as j_mgr
from deepspeed_tpu.inference.v2.ragged import ragged_wrapper as j_wrap
from deepspeed_tpu_torch.inference.v2 import config_v2 as t_config
from deepspeed_tpu_torch.inference.v2.ragged import blocked_allocator as t_alloc
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as t_cfg
from deepspeed_tpu_torch.inference.v2.ragged import ragged_manager as t_mgr
from deepspeed_tpu_torch.inference.v2.ragged import ragged_wrapper as t_wrap


def _outcome(fn, *args):
    try:
        out = fn(*args)
        return ("ok", None if out is None else np.asarray(out).tolist())
    except ValueError as e:
        return ("ValueError", str(e))


def test_allocator_matches_reference_op_for_op():
    rng = np.random.default_rng(0)
    a, b = j_alloc.BlockedAllocator(24), t_alloc.BlockedAllocator(24)
    live = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(0, 8))
            ra, rb = _outcome(a.allocate, n), _outcome(b.allocate, n)
            if ra[0] == "ok":
                live.extend(ra[1])
        elif op == 1 and live:
            blk = live.pop(int(rng.integers(0, len(live))))
            ra, rb = _outcome(a.free, [blk]), _outcome(b.free, [blk])
        elif op == 2 and live:
            blk = live[int(rng.integers(0, len(live)))]
            ra, rb = _outcome(a.incref, [blk]), _outcome(b.incref, [blk])
            live.append(blk)
        else:  # double free / out of range must raise the same way
            blk = int(rng.integers(-2, 27))
            ra, rb = _outcome(a.free, [blk]), _outcome(b.free, [blk])
            if ra[0] == "ok":
                live.remove(blk)
        assert ra == rb
        assert a.free_blocks == b.free_blocks and a._head == b._head
        np.testing.assert_array_equal(a._next, b._next)
        np.testing.assert_array_equal(a._refs, b._refs)


@pytest.mark.parametrize("n", list(range(0, 300, 7)) + [64, 65, 128, 129, 768])
def test_bucket_helpers_match(n):
    assert t_wrap.to_padded(n) == j_wrap.to_padded(n)
    assert t_wrap._pad_to(n, 8) == j_wrap._pad_to(n, 8)
    assert t_wrap._pow2_pad(n, 4) == j_wrap._pow2_pad(n, 4)


def _put_host_side(mgr, wrapper, uids, counts, bs):
    """engine.put without the forward: allocate, insert, finalize, commit."""
    wrapper.clear()
    for uid, n in zip(uids, counts):
        seq = mgr.get_or_create_sequence(uid)
        need = (seq.seen_tokens + n + bs - 1) // bs - seq.cur_allocated_blocks
        if need > 0:
            seq.extend_kv_cache(mgr.allocate_blocks(need))
        seq.pre_forward(n)
        wrapper.insert_sequence(seq, np.arange(n) % 97 + uid)
    batch = wrapper.finalize()
    for uid in uids:
        mgr.get_sequence(uid).post_forward()
    return batch


def test_state_manager_and_buckets_match_after_same_puts():
    bs = 16
    j_sm = j_cfg.DSStateManagerConfig(memory_config=j_cfg.MemoryConfig(mode=j_cfg.AllocationMode.ALLOCATE,
                                                                       size=40), max_context=256)
    t_sm = t_cfg.DSStateManagerConfig(memory_config=t_cfg.MemoryConfig(mode=t_cfg.AllocationMode.ALLOCATE,
                                                                       size=40), max_context=256)
    j_kv = j_cfg.KVCacheConfig(block_size=bs, cache_shape=(2, 2, 8), cache_dtype="float32")
    t_kv = t_cfg.KVCacheConfig(block_size=bs, cache_shape=(2, 2, 8), cache_dtype="float32")
    jm, tm = j_mgr.DSStateManager(j_sm, j_kv), t_mgr.DSStateManager(t_sm, t_kv, "cpu")
    jw, tw = j_wrap.RaggedBatchWrapper(j_sm, block_size=bs), t_wrap.RaggedBatchWrapper(t_sm)
    assert tuple(tm.kv_cache.cache.shape) == tuple(jm.kv_cache.cache.shape) == (2, 2, 40, 2, bs, 8)

    script = [("put", [0, 1, 2], [17, 5, 33]), ("put", [0, 1, 2], [1, 1, 1]), ("flush", 1),
              ("put", [3, 0], [70, 1]), ("put", [2, 3, 4, 5, 6, 7, 8, 9, 10], [1] * 8 + [40]),
              ("flush", 0), ("put", [11], [1]), ("flush", 3), ("put", [2, 4], [100, 1])]
    for step in script:
        if step[0] == "flush":
            jm.flush_sequence(step[1])
            tm.flush_sequence(step[1])
            continue
        _, uids, counts = step
        jb = _put_host_side(jm, jw, uids, counts, bs)
        tb = _put_host_side(tm, tw, uids, counts, bs)
        for key in ("tok_meta", "seq_meta"):
            assert jb[key].shape == tb[key].shape, key  # the same (T, S, MB) bucket
            np.testing.assert_array_equal(jb[key], tb[key])
        assert (jb["n_tokens"], jb["n_seqs"]) == (tb["n_tokens"], tb["n_seqs"])
        assert jm.free_blocks == tm.free_blocks
        assert sorted(jm.tracked_sequences) == sorted(tm.tracked_sequences)
        for uid, seq in jm.tracked_sequences.items():
            np.testing.assert_array_equal(seq.kv_blocks, tm.get_sequence(uid).kv_blocks)
            assert seq.seen_tokens == tm.get_sequence(uid).seen_tokens
        ja, ta = jm.kv_cache._allocator, tm.kv_cache._allocator
        np.testing.assert_array_equal(ja._next, ta._next)
        np.testing.assert_array_equal(ja._refs, ta._refs)
        assert ja._head == ta._head


def test_empty_batch_matches():
    j_sm, t_sm = j_cfg.DSStateManagerConfig(), t_cfg.DSStateManagerConfig()
    jb = j_wrap.RaggedBatchWrapper(j_sm, block_size=64).finalize()
    tb = t_wrap.RaggedBatchWrapper(t_sm).finalize()
    for key in ("tok_meta", "seq_meta"):
        np.testing.assert_array_equal(jb[key], tb[key])


def test_configs_keep_fields_defaults_and_aliases():
    t = t_config.RaggedInferenceEngineConfig.from_dict(
        {"tp": {"tp_size": 1}, "manager": {"max_context": 100, "memory_config": {"mode": "allocate", "size": 9}},
         "kv_block_size": "auto", "use_paged_kernel": False})
    assert t.state_manager.max_context == 100 and t.kv_block_size == 64
    assert t.state_manager.memory_config.mode is t_cfg.AllocationMode.ALLOCATE
    assert t.tensor_parallel.tp_size == 1 and t.use_paged_kernel is False
    d = t_cfg.DSStateManagerConfig()
    j = j_cfg.DSStateManagerConfig()
    for name in ("max_tracked_sequences", "max_ragged_batch_size", "max_ragged_sequence_count", "max_context"):
        assert getattr(d, name) == getattr(j, name)
    assert t_config.RaggedInferenceEngineConfig().kv_block_size == 64
    with pytest.raises(ValueError, match="must be > 0"):
        t_cfg.DSStateManagerConfig(max_context=0)
    with pytest.raises(ValueError, match="no field"):
        t_config.RaggedInferenceEngineConfig.from_dict({"kv_blok_size": 16})


def test_reserve_mode_sizes_the_pool_in_bytes():
    kv = t_cfg.KVCacheConfig(block_size=16, cache_shape=(2, 2, 8), cache_dtype="bfloat16")
    block_bytes = 16 * 2 * 2 * 2 * 8 * 2
    mgr = t_mgr.DSStateManager(t_cfg.DSStateManagerConfig(memory_config=t_cfg.MemoryConfig(size=10 * block_bytes)),
                               kv, "cpu")
    assert mgr.kv_cache.num_blocks == 10
    assert mgr.kv_cache.cache.dtype == torch.bfloat16
