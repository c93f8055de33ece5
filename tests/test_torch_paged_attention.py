"""Port parity: deepspeed_tpu_torch.ops.paged_attention against the Pallas kernel.

On the CPU the port's wrapper runs its plain torch version, which is held
here to ``deepspeed_tpu.ops.pallas.paged_attention.paged_attention_update``
run in interpret mode (as tests/unit/ops/test_paged_attention.py runs it).
The cache must come out exactly equal; the output agrees to f32 rounding
(online softmax in the kernel, one full softmax in the plain version). The
CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import paged_attention_update as pallas_update
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention_smem_bytes, paged_attention_update,
                                                     paged_attention_update_plain)

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
    # Llama-2-7B at kv_block_size 64 in bf16: K and V tiles of 64 x 128 x 2
    # bytes plus f32 q, accumulator, scores and three per-head scalars
    assert paged_attention_smem_bytes(64, 128, 1, 2) == 2 * 64 * 128 * 2 + 4 * (2 * 128 + 64 + 3)
    assert paged_attention_smem_bytes(16, 128, 4, 2) == 2 * 16 * 128 * 2 + 4 * (2 * 4 * 128 + 4 * 16 + 12)
