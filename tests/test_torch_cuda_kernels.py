"""The port's hand-written CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip elsewhere. They import the port only, so on a machine without jax they
run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.paged_attention import (SPLIT_POSITIONS, kernel_geometry, paged_attention_geometry,
                                                     paged_attention_update, paged_attention_update_plain)


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


def _context_case(H, KVH, bs, D, dtype, dev, lasts, seed=0):
    """One decode token per sequence, at each position of ``lasts``; tables
    of distinct random blocks up to it, then -1; two padding rows."""
    rng = np.random.default_rng(seed)
    MB = max(lasts) // bs + 2
    need = [p // bs + 1 for p in lasts]
    NB = sum(need) + 2
    perm = rng.permutation(NB)
    table = np.full((len(lasts), MB), -1, np.int32)
    at = 0
    for s, n in enumerate(need):
        table[s, :n] = perm[at:at + n]
        at += n
    seq = np.array(list(range(len(lasts))) + [len(lasts)] * 2, np.int32)
    pos = np.array(list(lasts) + [0, 0], np.int32)
    valid = np.array([1] * len(lasts) + [0, 0], np.int32)
    T = seq.size
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    i = lambda a: torch.from_numpy(a).to(dev)
    return (f(T, H, D), f(T, KVH, D), f(T, KVH, D), f(2, 2, NB, KVH, bs, D), 1, i(table), i(seq), i(pos), i(valid))


# contexts of one position, one split exactly, one position past it, two
# splits exactly, and 4000 positions (16 splits)
SPLIT_CONTEXTS = (0, SPLIT_POSITIONS - 1, SPLIT_POSITIONS, 2 * SPLIT_POSITIONS - 1, 3999)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("H,KVH,bs", [(4, 4, 16), (8, 2, 64)], ids=["mha_bs16", "gqa_bs64"])
def test_paged_attention_split_contexts_match_plain_and_repeat(cuda_device, dtype, D, H, KVH, bs):
    q, k_new, v_new, cache, li, table, seq, pos, valid = _context_case(H, KVH, bs, D, dtype, cuda_device,
                                                                       SPLIT_CONTEXTS)
    c_kernel, c_again, c_plain = cache.clone(), cache.clone(), cache.clone()
    before = paged_attention_update.launches
    got, _ = paged_attention_update(q, k_new, v_new, c_kernel, li, table, seq, pos, valid)
    again, _ = paged_attention_update(q, k_new, v_new, c_again, li, table, seq, pos, valid)
    want, _ = paged_attention_update_plain(q, k_new, v_new, c_plain, li, table, seq, pos, valid)
    torch.cuda.synchronize()
    assert paged_attention_update.launches == before + 4
    assert torch.equal(c_kernel, c_plain) and torch.equal(c_again, c_plain)
    assert torch.equal(got, again)  # the splits merge in a fixed order: bit for bit the same
    assert not got[valid == 0].any()
    tol = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 1e-5}[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paged_attention_geometry_mirrors_the_kernel(cuda_device):
    for D, rep, itemsize in ((128, 1, 2), (128, 4, 2), (64, 1, 2), (96, 8, 2), (128, 8, 4), (256, 2, 2),
                             (1024, 1, 2), (8, 3, 2)):
        assert kernel_geometry(D, rep, itemsize) == paged_attention_geometry(D, rep, itemsize), (D, rep, itemsize)


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


def _flash_inputs(B, S, H, KVH, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    return f(B, S, H, D), f(B, S, KVH, D), f(B, S, KVH, D), f(B, S, H, D)


def _tile_rms(x, tile=64):
    """[B, S, H, 1]: the rms of x over the ``tile`` positions and D values
    around each element (a kernel block's tile of one head)."""
    B, S, H, D = x.shape
    n = -(-S // tile)
    sq = torch.zeros((B, n * tile, H), device=x.device)
    sq[:, :S] = x.float().square().sum(dim=-1)
    rows = torch.full((n, ), float(tile), device=x.device)
    rows[-1] = S - (n - 1) * tile
    ms = sq.reshape(B, n, tile, H).sum(dim=2) / (rows[None, :, None] * D)
    return ms.sqrt().repeat_interleave(tile, dim=1)[:, :S, :, None]


def _scale(x):
    """The size of the terms summed into each element of x [B, S, H, D]: the
    larger of its row's rms and its tile's (a row that is a cancellation has
    a small rms of its own; a row at the edge of a tile can be larger than
    the tile's rms)."""
    return torch.maximum(x.float().square().mean(dim=-1, keepdim=True).sqrt(), _tile_rms(x))


def _tol_use(got, want):
    """Largest share of its allowance any element uses (at most 1 passes):
    P and dS are rounded to the 16-bit type before their products, an error
    that scales with the terms summed (an element near 0, or a whole row, can
    be their cancellation), so with the tile; every output is rounded once
    more, an error that scales with the element."""
    want = want.float()
    allowed = 2**-6 * _scale(want) + 2**-7 * want.abs()
    return ((got.float() - want).abs() / allowed.clamp(min=1e-30)).max().item()


def _assert_near(got, want, name):
    assert _tol_use(got, want) <= 1.0, f"{name}: max abs err {(got.float() - want.float()).abs().max().item()}"
    # the check rejects the output with its last quarter of positions 6% off
    control = got.float().clone()
    control[:, control.shape[1] * 3 // 4:] *= 1 + 2**-4
    assert _tol_use(control, want) > 1.0, f"{name}: the check passes a 6% error"


FLASH_CASES = [(2, 200, 4, 2, 64, True), (1, 128, 2, 2, 128, False), (1, 300, 8, 2, 128, True)]
FLASH_IDS = ["gqa_S200_D64_causal", "mha_S128_D128_full", "gqa_S300_D128_causal"]
# the edges of the 128-row and 64-row tiles of the three kernels (forward:
# q and K/V 128; dK/dV: keys 128, q 64; dQ: q 128, K/V 64): one position,
# one short of a tile, one tile, one past it; MHA and GQA with 4 query
# heads per KV head
for _S in (1, 63, 64, 65, 127, 128, 129):
    for _D in (64, 128):
        for _rep in (1, 4):
            for _causal in (True, False):
                FLASH_CASES.append((2, _S, 4, 4 // _rep, _D, _causal))
                FLASH_IDS.append(f"edge_S{_S}_D{_D}_rep{_rep}_{'causal' if _causal else 'full'}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,KVH,D,causal", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_kernels_match_plain(cuda_device, dtype, B, S, H, KVH, D, causal):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(B, S, H, KVH, D, dtype, cuda_device)
    scale = D**-0.5
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g, scale, causal)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, scale, causal)
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    assert out.dtype == dtype and dk.shape == k.shape and lse.shape == (B, H, S)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)  # f32 on both sides
    checked = (("out", out, want_out), ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2]))
    if S == 1:
        # one key: p = 1 and ds = dO.v - delta = 0, so dq and dk are nothing
        # but f32 summation noise on both sides, and the element rule, which
        # scales with the terms summed, has no terms to scale with
        for name, got in (("dq", dq), ("dk", dk)):
            assert got.float().abs().max().item() <= 2**-10, f"{name} of a single key is not 0"
        checked = checked[::3]
    for name, got, exp in checked:
        _assert_near(got, exp, name)


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(2, 130, 4, 4, 128, torch.bfloat16, cuda_device, seed=1)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = fa.flash_attention_bwd_dq.launches
    (fa.flash_attention(q, k, v, 0.1, True) * g).sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dq.launches == before + 1
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, _ = _flash_inputs(1, 64, 2, 2, 128, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_fwd(q.float(), k.float(), v.float(), 1.0, True)
    # head_dim 96 runs, zero-padded to the 128-wide kernel
    q96, k96, v96 = (t[..., :96].contiguous() for t in (q, k, v))
    out, lse = fa.flash_attention_fwd(q96, k96, v96, 96**-0.5, True)
    want_out, want_lse = fa.flash_attention_fwd_plain(q96, k96, v96, 96**-0.5, True)
    assert out.shape == q96.shape and out.is_contiguous()
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    _assert_near(out, want_out, "out")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(*(torch.cat([t, t[..., :32]], dim=-1) for t in (q, k, v)), 1.0, True)  # 160
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 1.0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 80, 32])
def test_flash_attention_padded_head_dim_matches_plain(cuda_device, D):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(2, 200, 8, 2, D, torch.bfloat16, cuda_device, seed=D)
    scale = D**-0.5
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, scale, True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, scale, True)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale, True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, scale, True)
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    for name, x, exp in (("out", out, want_out), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                         ("dv", got[2], want[2])):
        assert x.shape == exp.shape and x.is_contiguous()
        _assert_near(x, exp, name)


def _sparse_layout(kind, H, S, lb):
    from chip_smoke import bsa_layout  # one builder for the card's checks here and in the smoke run
    return bsa_layout(kind, H, S, lb)


def _sparse_inputs(B, H, S, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(dev, dtype) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,B,H,S,lb,D", [("fixed", 2, 4, 256, 16, 64), ("bigbird", 1, 4, 512, 64, 128),
                                             ("bigbird", 1, 2, 1040, 16, 128), ("empty_rows", 2, 4, 80, 16, 64),
                                             ("bigbird", 1, 2, 384, 128, 64), ("bigbird", 1, 16, 4096, 64, 128),
                                             ("bigbird", 2, 4, 2064, 16, 64)],
                         ids=["fixed_lb16_D64", "bigbird_lb64_D128", "bigbird_lb16_S1040", "empty_rows_S80",
                              "bigbird_lb128_D64", "bigbird_bench_S4096_split", "bigbird_lb16_S2064_split"])
def test_block_sparse_kernel_matches_plain(cuda_device, dtype, kind, B, H, S, lb, D):
    """Against the plain version; the last two cases split their global rows
    (64 steps into 2 chunks; 33 into 2, with partial steps and a ragged S).
    Every case: a second run gives the same bits, and every split-row counter
    is back at zero after the launch."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    q, k, v = _sparse_inputs(B, H, S, D, dtype, cuda_device)
    layout = _sparse_layout(kind, H, S, lb)
    plan = bsa.get_plan(layout, S, lb)
    if S >= 2048:
        assert plan.n_rows > 0  # the global rows are split
    before = bsa.block_sparse_attention_fwd.launches
    got = bsa.block_sparse_attention_fwd(q, k, v, plan, D**-0.5)
    want = bsa.block_sparse_attention_fwd_plain(q, k, v, layout, lb, D**-0.5)
    torch.cuda.synchronize()
    assert bsa.block_sparse_attention_fwd.launches == before + 1 and got.dtype == dtype
    assert all(not counters.any() for counters, _ in bsa._WORKSPACES.values())
    _assert_near(got.transpose(1, 2), want.transpose(1, 2), "out")  # [B, S, H, D] for the tile rule
    empty = torch.from_numpy(np.repeat(~layout.any(-1), lb, axis=1)).to(cuda_device)  # [H, S] rows attending nothing
    assert not got[:, empty].any()  # exactly zero
    again = bsa.block_sparse_attention_fwd(q, k, v, plan, D**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(again, got)  # the chunks merge in a fixed order


@pytest.mark.cuda
def test_sparse_self_attention_runs_the_kernel_forward_and_backward(cuda_device):
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig, SparseSelfAttention
    q, k, v = (t.requires_grad_() for t in _sparse_inputs(1, 4, 512, 128, torch.bfloat16, cuda_device, seed=1))
    attn = SparseSelfAttention(BigBirdSparsityConfig(num_heads=4, block=64, num_random_blocks=2))
    before = bsa.block_sparse_attention_fwd.launches
    (attn(q, k, v).float()**2).mean().backward()
    torch.cuda.synchronize()
    assert bsa.block_sparse_attention_fwd.launches == before + 1
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = bsa.block_sparse_attention_fwd_plain(*ref, attn.get_layout(512), 64, 128**-0.5)
    (out**2).mean().backward()
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        assert ((got.float() - want.grad).norm() / want.grad.norm()).item() < 0.02


@pytest.mark.cuda
def test_block_sparse_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    q, k, v = _sparse_inputs(1, 2, 128, 128, torch.bfloat16, cuda_device)
    layout = _sparse_layout("bigbird", 2, 128, 16)
    plan = bsa.get_plan(layout, 128, 16)
    before = bsa.block_sparse_attention_fwd.launches
    with pytest.raises(TypeError, match="share"):
        bsa.block_sparse_attention_fwd(q.float(), k.float(), v.float(), plan, 0.1)
    with pytest.raises(TypeError, match="share"):
        bsa.block_sparse_attention(q.float(), k.float(), v.float(), layout, 16)
    with pytest.raises(ValueError, match="head_dim"):
        bsa.block_sparse_attention_fwd(*(torch.cat([t, t[..., :32]], dim=-1) for t in (q, k, v)), plan, 0.1)  # 160
    # head_dim 96 runs, zero-padded to the 128-wide kernel
    q96, k96, v96 = (t[..., :96].contiguous() for t in (q, k, v))
    got = bsa.block_sparse_attention_fwd(q96, k96, v96, plan, 96**-0.5)
    want = bsa.block_sparse_attention_fwd_plain(q96, k96, v96, layout, 16, 96**-0.5)
    assert got.shape == q96.shape and got.is_contiguous()
    _assert_near(got.transpose(1, 2), want.transpose(1, 2), "out")
    assert bsa.block_sparse_attention_fwd.launches == before + 1
    before += 1
    with pytest.raises(ValueError, match="contiguous"):
        bsa.block_sparse_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, plan, 0.1)

    class NoSteps(bsa.BlockSparsePlan):  # lists the C function refuses: max_steps 0
        def tiles(self, device):
            t = dict(super().tiles(device))
            t["steps"] = t["steps"][:, :, :0]
            return t

    with pytest.raises(RuntimeError, match="launch failed"):
        bsa.block_sparse_attention_fwd(q, k, v, NoSteps(layout, 128, 16, plan.block_q, plan.block_k), 0.1)
    assert bsa.block_sparse_attention_fwd.launches == before


@pytest.mark.cuda
def test_serving_scheduler_launches_the_paged_kernel_from_its_thread(cuda_device):
    """The port's scheduler serves a tiny bf16 Llama on the card: its decode
    puts launch the paged kernel (B1) from the scheduler's own thread, the
    kernel's split counters are back at zero afterwards, and generate() run
    on a worker thread gives the bits of generate() on the main thread."""
    import threading

    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
    from deepspeed_tpu_torch.inference.v2.model_implementations import transformer_base
    from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                         MemoryConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.serving import RequestState, ServingConfig, ServingScheduler

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device,
                         dtype=torch.bfloat16)
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=64), max_context=512)
    engine = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16),
                          device=cuda_device)
    prompts = [list(np.random.default_rng(i).integers(0, cfg.vocab_size, n)) for i, n in enumerate((5, 19, 40))]
    threads = []
    inner = transformer_base.paged_attention_update

    def spy(*args, **kw):
        threads.append(threading.current_thread().name)
        return inner(*args, **kw)

    transformer_base.paged_attention_update = spy
    try:
        before = pa.paged_attention_update.launches
        sched = ServingScheduler(engine, ServingConfig(decode_chunk=4))
        try:
            reqs = [sched.submit(p, max_new_tokens=9) for p in prompts]
            outs = [r.result(timeout=120) for r in reqs]
        finally:
            sched.stop(drain=False)
        assert all(r.state is RequestState.DONE for r in reqs)
        assert all(len(o) == 9 and all(0 <= t < cfg.vocab_size for t in o) for o in outs)
        assert pa.paged_attention_update.launches > before
        assert threads and set(threads) == {"dstpu-serving-scheduler"}
        torch.cuda.synchronize()
        for counters, _ in pa._WORKSPACES.values():
            assert int(counters.abs().sum()) == 0
        assert engine.free_blocks == 64

        threads.clear()
        box = {}
        worker = threading.Thread(target=lambda: box.update(out=generate(engine, prompts, max_new_tokens=9,
                                                                         decode_chunk=4)),
                                  name="worker")
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and set(threads) == {"worker"}
        assert box["out"] == generate(engine, prompts, max_new_tokens=9, decode_chunk=4)
    finally:
        transformer_base.paged_attention_update = inner
