"""The port's hand-written CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip elsewhere. They import the port only, so on a machine without jax they
run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.paged_attention import paged_attention_update, paged_attention_update_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(H, KVH, bs, D, dtype, dev, seed=0):
    """A multi-token chunk crossing blocks, decode tokens (one with -1 table
    tails), padding rows pointing past the last sequence."""
    rng = np.random.default_rng(seed)
    S, MB, L = 4, 8, 2
    NB = S * MB + 3
    table = rng.permutation(NB)[:S * MB].reshape(S, MB).astype(np.int32)
    table[2, 3:] = -1
    seq = np.array([0] * 12 + [1, 2] + [3, 3], np.int32)
    pos = np.array(list(range(bs - 5, bs + 7)) + [MB * bs - 1, 3 * bs - 2] + [0, 0], np.int32)
    valid = np.array([1] * 14 + [0, 0], np.int32)
    T = seq.size
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    i = lambda a: torch.from_numpy(a).to(dev)
    return (f(T, H, D), f(T, KVH, D), f(T, KVH, D), f(L, 2, NB, KVH, bs, D), 1, i(table), i(seq), i(pos),
            i(valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("H,KVH,bs", [(4, 4, 16), (8, 2, 64)], ids=["mha_bs16", "gqa_bs64"])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, H, KVH, bs):
    q, k_new, v_new, cache, li, table, seq, pos, valid = _case(H, KVH, bs, 128, dtype, cuda_device)
    c_kernel, c_plain = cache.clone(), cache.clone()
    before = paged_attention_update.launches
    got, out_cache = paged_attention_update(q, k_new, v_new, c_kernel, li, table, seq, pos, valid)
    want, _ = paged_attention_update_plain(q, k_new, v_new, c_plain, li, table, seq, pos, valid)
    torch.cuda.synchronize()
    assert out_cache is c_kernel and paged_attention_update.launches == before + 2
    assert torch.equal(c_kernel, c_plain)  # the insert writes the same bits
    assert not got[valid == 0].any()
    # both round an f32 result to dtype: at most about one ulp apart
    tol = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 1e-5}[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paged_attention_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    q, k_new, v_new, cache, li, table, seq, pos, valid = _case(4, 4, 16, 128, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="share"):
        paged_attention_update(q.float(), k_new, v_new, cache, li, table, seq, pos, valid)
    with pytest.raises(TypeError, match="int32"):
        paged_attention_update(q, k_new, v_new, cache, li, table.long(), seq, pos, valid)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_update(q.transpose(0, 1).contiguous().transpose(0, 1), k_new, v_new, cache, li, table,
                               seq, pos, valid)
