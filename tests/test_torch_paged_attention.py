"""Port parity: deepspeed_tpu_torch.ops.paged_attention against the Pallas kernel.

On the CPU the port's wrapper runs its plain torch version, which is held
here to ``deepspeed_tpu.ops.pallas.paged_attention.paged_attention_update``
run in interpret mode (as tests/unit/ops/test_paged_attention.py runs it).
The cache must come out exactly equal; the output agrees to f32 rounding
(online softmax in the kernel, one full softmax in the plain version). The
CUDA kernel's partition of the context into splits, with partial softmax
states merged in split order, is held here too, through
``paged_attention_update_split``; the kernel itself is held to the plain
version on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import paged_attention_update as pallas_update
from deepspeed_tpu_torch.ops.paged_attention import (SPLIT_POSITIONS, paged_attention_geometry,
                                                     paged_attention_smem_bytes, paged_attention_update,
                                                     paged_attention_update_plain, paged_attention_update_split,
                                                     split_positions)

# f32 both sides: an online softmax over 8-block chunks against one full
# softmax differs by a few ulps of the largest term
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(kind, kvh, seed=0):
    """Cache, tables and a token mix as numpy arrays (int32 metadata)."""
    rng = np.random.default_rng(seed)
    L, NB, bs, D, H = 2, 12, 16, 128, 4
    S, MB = 3, 4
    cache = rng.normal(size=(L, 2, NB, kvh, bs, D)).astype(np.float32)
    table = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    if kind == "mixed":
        # tests/unit/ops/test_paged_attention.py: a decode token at pos 20, a
        # mid-prefill token, a fresh token, padding rows (seq clamps to S-1)
        seq = np.array([0, 1, 2] + [3] * 13, np.int32)
        pos = np.array([20, 7, 0] + [0] * 13, np.int32)
        valid = np.array([1, 1, 1] + [0] * 13, np.int32)
    elif kind == "chunk":
        # a multi-token chunk of one sequence crossing a block boundary (each
        # token must see the chunk's earlier inserts), a decode token of
        # another sequence whose table ends in -1 entries, and padding rows
        table[1, 2:] = -1
        seq = np.array([0] * 12 + [1, 2, 2, 2], np.int32)
        pos = np.array(list(range(10, 22)) + [25, 0, 0, 0], np.int32)
        valid = np.array([1] * 13 + [0, 0, 0], np.int32)
    else:  # all invalid: no output, no cache write
        seq = np.array([0, 1] + [2] * 14, np.int32)
        pos = np.array([20, 7] + [0] * 14, np.int32)
        valid = np.zeros(16, np.int32)
    T = seq.size
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    k_new = rng.normal(size=(T, kvh, D)).astype(np.float32)
    v_new = rng.normal(size=(T, kvh, D)).astype(np.float32)
    return q, k_new, v_new, cache, table, seq, pos, valid


@pytest.mark.parametrize("kind", ["mixed", "chunk", "all_invalid"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_plain_matches_pallas_interpret(kind, kvh):
    q, k_new, v_new, cache0, table, seq, pos, valid = _case(kind, kvh)
    jcache = jnp.asarray(cache0)
    tcache = torch.from_numpy(cache0.copy())
    launches = paged_attention_update.launches
    # one layer (the second, so the layer offset is exercised) and one token
    # count for every case: each distinct shape is an interpret-mode compile
    li = 1
    want, jcache = pallas_update(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jcache, li,
                                 jnp.asarray(table), jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(valid))
    got, tcache2 = paged_attention_update(*map(torch.from_numpy, (q, k_new, v_new)), tcache, li,
                                          *map(torch.from_numpy, (table, seq, pos, valid)))
    assert tcache2 is tcache  # updated in place, as the JAX kernel aliases it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got.numpy()[valid == 0].any()
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))
    if kind == "all_invalid":
        np.testing.assert_array_equal(tcache.numpy(), cache0)
    assert paged_attention_update.launches == launches  # the CPU runs no kernel


def test_plain_version_checks_its_inputs():
    q, k_new, v_new, cache, table, seq, pos, valid = map(torch.from_numpy, _case("mixed", 2))
    with pytest.raises(ValueError, match="does not fit"):
        paged_attention_update_plain(q[:, :3], k_new, v_new, cache, 0, table, seq, pos, valid)
    with pytest.raises(ValueError, match="k_new"):
        paged_attention_update_plain(q, k_new[:2], v_new, cache, 0, table, seq, pos, valid)
    with pytest.raises(ValueError, match="layer_idx"):
        paged_attention_update_plain(q, k_new, v_new, cache, 2, table, seq, pos, valid)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention_update(q.to("meta"), k_new, v_new, cache, 0, table, seq, pos, valid)


def test_shared_memory_need():
    # header (mbarriers, flag) + two stages of 64 K and 64 V rows + the eight
    # consumer warps' merge area (f32 acc [heads, D], m, l); the block size
    # does not enter: a stage copies whatever cache blocks its positions span
    stages = lambda pos, row: 2 * 2 * pos * row
    merge = lambda heads, D: 4 * 8 * heads * (D + 2)
    # Llama-2-7B in bf16 (MHA): one query head a block; three blocks fit an SM's 228 KB
    assert paged_attention_smem_bytes(128, 1, 2) == 128 + stages(64, 256) + merge(1, 128)
    assert 3 * (paged_attention_smem_bytes(128, 1, 2) + 1024) <= 233472
    # GQA with 4 query heads per KV head: all four in one block
    geo = paged_attention_geometry(128, 4, 2)
    assert (geo["heads"], geo["head_groups"], geo["smem"]) == (4, 1, 128 + stages(64, 256) + merge(4, 128))
    # 2 query heads a KV head: a block of 2; 3: a block of 4 (one idle); 8: two blocks of 4
    assert [paged_attention_geometry(128, r, 2)["heads"] for r in (2, 3, 8)] == [2, 4, 4]
    # f32 rows of 512 bytes: each lane reads two 16-byte chunks, four heads a block at most
    geo = paged_attention_geometry(128, 8, 4)
    assert (geo["lp"], geo["cpl"], geo["heads"], geo["head_groups"]) == (16, 2, 4, 2)
    assert geo["smem"] == 128 + stages(64, 512) + merge(4, 128)
    # D = 64 in bf16: groups of 8 lanes; D = 96: 12 chunks in groups of 16 lanes
    assert (paged_attention_geometry(64, 1, 2)["lp"], paged_attention_geometry(96, 1, 2)["lp"]) == (8, 16)
    # the widest rows the kernel takes (2048 bytes): stages of 16 positions so that two fit
    geo = paged_attention_geometry(1024, 1, 2)
    assert (geo["cpl"], geo["heads"], geo["stage_pos"]) == (8, 1, 16)
    assert geo["smem"] == 128 + stages(16, 2048) + merge(1, 1024) <= 232448
    for D, itemsize in ((1032, 2), (100, 2)):  # over 2048 bytes; not a multiple of 16 bytes
        with pytest.raises(ValueError, match="multiple of 16"):
            paged_attention_geometry(D, 1, itemsize)


def test_split_positions_grow_only_for_a_large_workspace():
    # a decode step of 32 tokens x 32 KV heads over a 4096-position table: 256
    assert split_positions(32 * 32, 4096, 1, 128) == SPLIT_POSITIONS
    # a 512-token prefill forced onto the kernel: 16 splits of 256 would take
    # 136 MiB of partials, 4 splits of 1024 take 34 MiB (8 of 512: 68 MiB)
    assert split_positions(512 * 32, 4096, 1, 128) == 1024
    assert split_positions(10**6, 4096, 4, 128) == 4096  # one split, however large


def _split_case(bs, kvh, seed):
    """Sequences whose contexts end on a split edge, one position past it,
    two splits exactly, at a single position, and over three splits with a
    -1 table tail behind them; then padding rows (seq past the last)."""
    rng = np.random.default_rng(seed)
    L, D, H, span = 2, 32, 4, SPLIT_POSITIONS
    last_pos = [span - 1, span, 2 * span - 1, 0, 2 * span + 90]
    MB = -(-(max(last_pos) + 1) // bs) + 2  # table wider than any context: -1 tails
    need = [p // bs + 1 for p in last_pos]
    NB = sum(need) + 3
    perm = rng.permutation(NB)
    table = np.full((len(last_pos), MB), -1, np.int32)
    at = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[at:at + n]
        at += n
    seq = np.array(list(range(len(last_pos))) + [len(last_pos)] * 3, np.int32)
    pos = np.array(last_pos + [0] * 3, np.int32)
    valid = np.array([1] * len(last_pos) + [0] * 3, np.int32)
    T = seq.size
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return f(T, H, D), f(T, kvh, D), f(T, kvh, D), f(L, 2, NB, kvh, bs, D), table, seq, pos, valid


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("kvh", [4, 1], ids=["mha", "gqa"])
def test_split_partition_matches_pallas_and_plain(bs, kvh):
    q, k_new, v_new, cache0, table, seq, pos, valid = _split_case(bs, kvh, seed=bs + kvh)
    jcache = jnp.asarray(cache0)
    want, jcache = pallas_update(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jcache, 1,
                                 jnp.asarray(table), jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(valid))
    args = lambda cache: (*map(torch.from_numpy, (q, k_new, v_new)), cache, 1, *map(torch.from_numpy,
                                                                                     (table, seq, pos, valid)))
    c_split, c_plain = torch.from_numpy(cache0.copy()), torch.from_numpy(cache0.copy())
    got, _ = paged_attention_update_split(*args(c_split))
    plain, _ = paged_attention_update_plain(*args(c_plain))
    np.testing.assert_array_equal(c_split.numpy(), np.asarray(jcache))
    np.testing.assert_array_equal(c_split.numpy(), c_plain.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got.numpy()[valid == 0].any()
    # the splits are real: a context one position past the edge has two, and
    # its second split (one position) moves the output
    one_split, _ = paged_attention_update_split(*args(torch.from_numpy(cache0.copy())), span=4 * SPLIT_POSITIONS)
    assert not torch.equal(one_split, got)
    np.testing.assert_allclose(one_split.numpy(), got.numpy(), **TOL)
