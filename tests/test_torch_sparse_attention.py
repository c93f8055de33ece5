"""The port's block-sparse attention against the JAX package's.

JAX runs on the CPU with the Pallas kernel in interpret mode, as
tests/unit/ops/test_block_sparse_attention.py runs it; the port runs its plain
forward, which is what its wrapper does on CPU tensors, and its torch-op
backward. Inputs come from numpy seeds. Layouts and block lists must be
bit-identical; the forward, in f32, agrees within the JAX tests' 2e-5 and the
gradients within their 2e-4. The kernel's own tile lists, which only the card
consumes, are checked against a brute-force token mask and by walking them
as the kernel does.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, DenseSparsityConfig,
                                                      FixedSparsityConfig, LocalSlidingWindowSparsityConfig,
                                                      SparseSelfAttention, layout_to_dense_mask,
                                                      sparse_self_attention)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

# the package's __init__ exports a function of the module's name
jssa = importlib.import_module("deepspeed_tpu.ops.sparse_attention.sparse_self_attention")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

# (config class, kwargs): every class, with the options that change the layout
CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=3, block=16)),
    "fixed_bi": ("FixedSparsityConfig", dict(num_heads=2, block=16)),
    "fixed_uni": ("FixedSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional")),
    "fixed_horizontal": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4, num_global_blocks=2,
                                                     horizontal_global_attention=True)),
    "fixed_patterns": ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                                   num_local_blocks=4, num_different_global_patterns=4)),
    "fixed_uni_per_head": ("FixedSparsityConfig", dict(num_heads=3, block=32, different_layout_per_head=True,
                                                       num_local_blocks=3, num_different_global_patterns=2,
                                                       attention="unidirectional")),
    "bigbird_bi": ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2)),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional")),
    "bigbird_per_head_seed7": ("BigBirdSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                                             num_random_blocks=3, num_sliding_window_blocks=5,
                                                             num_global_blocks=2, seed=7)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, global_block_indices=[0, 5])),
    "bslongformer_ends_uni": ("BSLongformerSparsityConfig",
                              dict(num_heads=2, block=16, global_block_indices=[0, 4],
                                   global_block_end_indices=[2, 6], attention="unidirectional")),
    "variable": ("VariableSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=1,
                                                local_window_blocks=[2, 4], global_block_indices=[0])),
    "variable_ends_horizontal_seed3": ("VariableSparsityConfig",
                                       dict(num_heads=3, block=16, different_layout_per_head=True,
                                            num_random_blocks=2, local_window_blocks=[1, 3],
                                            global_block_indices=[1, 6], global_block_end_indices=[3, 7],
                                            horizontal_global_attention=True, seed=3)),
    "variable_uni": ("VariableSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                                    local_window_blocks=[3], attention="unidirectional", seed=5)),
    "window_uni": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16)),
    "window_bi": ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=4,
                                                           attention="bidirectional")),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layouts_equal_jax_bit_for_bit(name):
    cls, kw = CONFIGS[name]
    jcfg, tcfg = getattr(jsc, cls)(**kw), getattr(tsc, cls)(**kw)
    # several calls on one config: a held generator must advance alike
    for seq_len in (kw["block"] * 8, kw["block"] * 10, kw["block"] * 8):
        want, got = jcfg.make_layout(seq_len), tcfg.make_layout(seq_len)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


BAD = {
    "fixed_local_not_divisible": ("FixedSparsityConfig", dict(num_heads=1, num_local_blocks=3, num_global_blocks=2), None),
    "fixed_attention": ("FixedSparsityConfig", dict(num_heads=1, attention="causal"), None),
    "fixed_uni_horizontal": ("FixedSparsityConfig", dict(num_heads=1, attention="unidirectional",
                                                         horizontal_global_attention=True), None),
    "fixed_patterns_shared": ("FixedSparsityConfig", dict(num_heads=2, num_different_global_patterns=2), None),
    "fixed_too_many_patterns": ("FixedSparsityConfig", dict(num_heads=2, different_layout_per_head=True,
                                                            num_different_global_patterns=5), None),
    "bigbird_attention": ("BigBirdSparsityConfig", dict(num_heads=1, attention="causal"), None),
    "bigbird_random": ("BigBirdSparsityConfig", dict(num_heads=1, num_random_blocks=9), 128),
    "bigbird_window": ("BigBirdSparsityConfig", dict(num_heads=1, num_sliding_window_blocks=9), 128),
    "bigbird_global": ("BigBirdSparsityConfig", dict(num_heads=1, num_global_blocks=9), 128),
    "bslongformer_ends": ("BSLongformerSparsityConfig", dict(num_heads=1, global_block_indices=[0, 3],
                                                             global_block_end_indices=[2]), None),
    "variable_uni_horizontal": ("VariableSparsityConfig", dict(num_heads=1, attention="unidirectional",
                                                               horizontal_global_attention=True), None),
    "seq_not_divisible": ("DenseSparsityConfig", dict(num_heads=1, block=16), 100),
    "window_too_wide": ("LocalSlidingWindowSparsityConfig", dict(num_heads=1, num_sliding_window_blocks=9), 128),
}


@pytest.mark.parametrize("name", list(BAD))
def test_bad_arguments_raise_as_in_jax(name):
    cls, kw, seq_len = BAD[name]

    def error(module):
        try:
            cfg = getattr(module, cls)(**kw)
            if seq_len is not None:
                cfg.make_layout(seq_len)
        except (ValueError, NotImplementedError) as e:
            return type(e), str(e)
        return None

    want = error(jsc)
    assert want is not None
    assert error(tsc) == want


@pytest.mark.parametrize("S,LB", [(64, 16), (128, 16), (192, 16), (320, 32), (256, 64), (1024, 64), (80, 16)])
def test_block_lists_and_block_choice_equal_jax(S, LB):
    rng = np.random.default_rng(S + LB)
    nb = S // LB
    layout = rng.random((3, nb, nb)) < 0.3
    layout[1, 1] = False  # an empty row
    for block_q in (64, 128, 256):
        for block_k in (64, 128, 256):
            if block_q % LB or block_k % LB:
                continue
            want = _jax_blocks(S, LB, block_q, block_k)
            assert tbsa.choose_blocks(S, LB, block_q, block_k) == want
            got_lists = tbsa.build_block_lists(layout, S, LB, *want)
            idx, counts, _ = jbsa.build_block_lists(layout, S, LB, *want)  # and the TPU's cell bitfield
            assert len(got_lists) == 2
            for got, exp in zip(got_lists, (idx, counts)):
                assert got.dtype == exp.dtype
                np.testing.assert_array_equal(got, exp)


def _jax_blocks(S, LB, block_q, block_k):
    """The (bq, bk) the JAX package's block_sparse_attention picks, read off
    the geometry key of the core it caches."""
    jbsa._CORE_CACHE.clear()
    x = jnp.zeros((1, 1, S, 8), jnp.float32)
    jax.eval_shape(lambda a: jbsa.block_sparse_attention(a, a, a, np.ones((1, S // LB, S // LB), bool), LB,
                                                         block_q=block_q, block_k=block_k), x)
    (key, ) = jbsa._CORE_CACHE
    jbsa._CORE_CACHE.clear()
    return key[3], key[4]


# ------------------------------------------------------------------ forward --
B, H, D, LB = 2, 4, 32, 16


def _qkv(S, seed, D=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))


def _empty_row_layout(S):
    nb = S // LB
    layout = np.zeros((H, nb, nb), bool)
    layout[0] = np.eye(nb, dtype=bool)  # head 0: diagonal only
    layout[1, :, 0] = True  # head 1: every row attends block 0 but row 2, which attends nothing
    layout[1, 2, :] = False
    layout[2, :, -1] = True  # head 2: the last block; head 3 attends nothing at all
    return layout


LAYOUTS = {
    "bigbird": lambda S: jsc.BigBirdSparsityConfig(num_heads=H, block=LB, num_random_blocks=1,
                                                   num_sliding_window_blocks=3, num_global_blocks=1).make_layout(S),
    "fixed": lambda S: jsc.FixedSparsityConfig(num_heads=H, block=LB).make_layout(S),
    "window": lambda S: jsc.LocalSlidingWindowSparsityConfig(num_heads=H, block=LB,
                                                             num_sliding_window_blocks=2).make_layout(S),
    "variable": lambda S: jsc.VariableSparsityConfig(num_heads=H, block=LB, different_layout_per_head=True,
                                                     num_random_blocks=1, local_window_blocks=[2, 3],
                                                     global_block_indices=[1]).make_layout(S),
    "bslongformer": lambda S: jsc.BSLongformerSparsityConfig(num_heads=H, block=LB,
                                                             global_block_indices=[0, 5]).make_layout(S),
    "dense": lambda S: jsc.DenseSparsityConfig(num_heads=H, block=LB).make_layout(S),
    "empty_rows": _empty_row_layout,
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_forward_and_grads_match_pallas(name):
    S = 128
    q, k, v = _qkv(S, seed=len(name))
    layout = LAYOUTS[name](S)

    def jloss(q, k, v):
        return (jbsa.block_sparse_attention(q, k, v, layout, LB) ** 2).sum()

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = np.asarray(jbsa.block_sparse_attention(jq, jk, jv, layout, LB))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tbsa.block_sparse_attention(tq, tk, tv, layout, LB)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, **FWD_TOL)
    for got, want, nm in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL, err_msg=f"d{nm}")
    if name == "empty_rows":
        got = out.detach().numpy()
        assert not got[:, 1, 2 * LB:3 * LB].any() and not got[:, 3].any()  # exactly zero


def _staggered_layout(S):
    """Head h attends the first h + 1 KV blocks of 64 tokens (head 3: blocks
    0 and 2): at 64 x 64 blocks the heads' step counts differ, so a q-block
    pads the shorter lists with dead steps that repeat their last live
    block, after one live step or more."""
    nb = S // LB
    layout = np.zeros((H, nb, nb), bool)
    for h in range(3):
        layout[h, :, :(h + 1) * 4] = True
    layout[3, :, :4] = layout[3, :, 8:12] = True
    return layout


@pytest.mark.parametrize("S,block_q,block_k,name", [(192, 64, 64, "bigbird"), (256, 128, 256, "bigbird"),
                                                    (96, 256, 256, "bigbird"), (192, 64, 64, "staggered")])
def test_other_block_sizes_match_pallas(S, block_q, block_k, name):
    q, k, v = _qkv(S, seed=S, D=16)
    layout = _staggered_layout(S) if name == "staggered" else LAYOUTS[name](S)

    def jloss(q, k, v):
        return (jbsa.block_sparse_attention(q, k, v, layout, LB, block_q=block_q, block_k=block_k)**2).sum()

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = jbsa.block_sparse_attention(jq, jk, jv, layout, LB, block_q=block_q, block_k=block_k)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tbsa.block_sparse_attention(tq, tk, tv, layout, LB, block_q=block_q, block_k=block_k)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    for got, want, nm in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL, err_msg=f"d{nm}")


def test_backward_equals_autograd_of_the_plain_forward():
    """The torch-op backward against autograd through the plain forward's
    own torch ops: the two share the lists but not the formulas."""
    S = 96
    q, k, v = _qkv(S, seed=9, D=16)
    g = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    layout = _empty_row_layout(S)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tbsa.block_sparse_attention_fwd_plain(tq, tk, tv, layout, LB, 0.3)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    plan = tbsa.get_plan(layout, S, LB)
    got = tbsa.block_sparse_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out.detach(), torch.from_numpy(g),
                                          plan, 0.3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_cpu_wrapper_runs_the_plain_version_and_plans_are_cached():
    S = 80  # not a multiple of the kernel's 64-row tile
    q, k, v = (torch.from_numpy(x) for x in _qkv(S, seed=11, D=16))
    layout = _empty_row_layout(S)
    plan = tbsa.get_plan(layout, S, LB)
    assert tbsa.get_plan(layout.astype(np.int64), S, LB) is plan
    assert plan.blocks("cpu") is plan.blocks(torch.device("cpu"))
    launches = tbsa.block_sparse_attention_fwd.launches
    out = tbsa.block_sparse_attention_fwd(q, k, v, plan, 0.25)
    assert torch.equal(out, tbsa.block_sparse_attention_fwd_plain(q, k, v, layout, LB, 0.25))
    assert tbsa.block_sparse_attention_fwd.launches == launches
    with pytest.raises(ValueError, match="plan"):
        tbsa.block_sparse_attention_fwd(q[:, :2], k[:, :2], v[:, :2], plan, 0.25)
    with pytest.raises(ValueError, match="must tile"):
        tbsa.block_sparse_attention(q[:, :, :72], k[:, :, :72], v[:, :, :72], layout, LB)


# -------------------------------------------------------- the kernel's lists --
TILE = tbsa.KERNEL_TILE


def _token_mask(layout, lb):
    return np.repeat(np.repeat(np.asarray(layout, bool), lb, axis=1), lb, axis=2)


TILE_CASES = {
    "lb16_S1040": (1040, 16),  # 4 x 4 cells per tile pair, a ragged last tile
    "lb16_S80": (80, 16),
    "lb48_S192": (192, 48),  # cells that straddle tiles
    "lb64_S512": (512, 64),  # a tile inside one cell
    "lb128_S640": (640, 128),
}


def _random_layout(S, lb, heads, density, seed):
    rng = np.random.default_rng(seed)
    layout = rng.random((heads, S // lb, S // lb)) < density
    layout[0, 0] = True  # a global row
    layout[1, -1] = False  # an empty row
    return layout


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_lists_match_the_token_mask(name):
    S, lb = TILE_CASES[name]
    layout = _random_layout(S, lb, 2, 0.25, S)
    steps, counts = tbsa.build_tile_lists(layout, S, lb)
    tok = _token_mask(layout, lb)
    nt = -(-S // TILE)
    assert counts.shape == (2, nt) and steps.shape[:2] == (2, nt)
    for h in range(2):
        for qt in range(nt):
            want_ids, want_partial = [], []
            for kt in range(nt):
                blk = tok[h, qt * TILE:(qt + 1) * TILE, kt * TILE:(kt + 1) * TILE]
                if blk.any():
                    want_ids.append(kt)
                    want_partial.append(int(not blk.all()))
            n = counts[h, qt]
            assert n == len(want_ids)
            assert (steps[h, qt, :n] >> 1).tolist() == want_ids
            assert (steps[h, qt, :n] & 1).tolist() == want_partial


@pytest.mark.parametrize("split_steps", [1, 3, 16])
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_work_items_cover_every_live_step_once(name, split_steps):
    S, lb = TILE_CASES[name]
    layout = _random_layout(S, lb, 3, 0.25, S + split_steps)
    layout[2] = False  # a head that attends nothing
    _, counts = tbsa.build_tile_lists(layout, S, lb)
    items, n_rows, n_slots = tbsa.build_work_items(counts, split_steps)
    assert items.dtype == np.int32 and items.shape[1] == len(tbsa.ITEM_FIELDS)
    assert np.all(np.diff(items[:, 3]) <= 0)  # longest first
    seen = np.zeros(counts.shape, np.int64)
    rows, slots = set(), set()
    for h, qt in np.ndindex(*counts.shape):
        mine = items[(items[:, 0] == h) & (items[:, 1] == qt)]
        mine = mine[np.argsort(mine[:, 4])]
        n, k = int(counts[h, qt]), len(mine)
        assert k == max(1, -(-n // split_steps))  # an empty list is one item of 0 steps
        assert mine[:, 4].tolist() == list(range(k)) and set(mine[:, 5].tolist()) == {k}
        # chunks are contiguous, at most split_steps long, and cover the list once
        assert mine[0, 2] == 0 and np.all(mine[1:, 2] == mine[:-1, 2] + mine[:-1, 3])
        assert mine[:, 3].sum() == n and mine[:, 3].max() <= split_steps
        assert mine[:, 3].max() - mine[:, 3].min() <= 1
        seen[h, qt] = mine[:, 3].sum()
        if k > 1:
            assert len(set(mine[:, 6].tolist())) == 1 and len(set(mine[:, 7].tolist())) == 1
            rows.add(int(mine[0, 6]))
            slots.update(range(mine[0, 7], mine[0, 7] + k))
        else:
            assert mine[0, 6] == -1 and mine[0, 7] == -1
    np.testing.assert_array_equal(seen, counts)
    assert rows == set(range(n_rows)) and slots == set(range(n_slots))  # rows and slots are dense, none shared
    assert (counts == 0).any() and (n_rows > 0) == (counts.max() > split_steps)


def test_bench_layouts_split_only_their_global_rows():
    """bench.py's sparse leg: at both BigBird densities only the 16 global
    rows are cut, into 4 chunks of 32 steps each (2,096 items), or into 8
    of 16 (2,160) at the sweep's 16."""
    for nr, nw in ((1, 3), (4, 9)):
        layout = BigBirdSparsityConfig(num_heads=16, block=64, num_random_blocks=nr, num_sliding_window_blocks=nw,
                                       num_global_blocks=1).make_layout(8192)
        plan = tbsa.get_plan(layout, 8192, 64)
        assert plan.split_steps == tbsa.SPLIT_STEPS == 32 and plan.tile_counts.max() == 128
        for split_steps, n_items, chunks in ((32, 2096, 4), (16, 2160, 8)):
            items, n_rows, n_slots = tbsa.build_work_items(plan.tile_counts, split_steps)
            assert len(items) == n_items and (n_rows, n_slots) == (16, 16 * chunks)
            split = items[items[:, 5] > 1]
            assert set(split[:, 1].tolist()) == {0} and set(split[:, 3].tolist()) == {split_steps}
            assert np.all(items[:len(split), 5] == chunks)  # launched first


def _walk_work_items(q, k, v, layout, lb, scale, split_steps):
    """The CUDA kernel's algorithm over build_tile_lists and
    build_work_items, in f64 numpy: each item walks its chunk of steps with
    an online softmax, masking cells only on partial steps, with the guarded
    exp; a whole list writes its rows (the 1e-30 floor, zero rows), a chunk
    of a split row keeps (m, l, acc) in its slot, and the chunks of each
    split row merge in split order. Rows it never writes stay NaN."""
    Bq, Hq, S, _ = q.shape
    steps, counts = tbsa.build_tile_lists(layout, S, lb)
    items, _, n_slots = tbsa.build_work_items(counts, split_steps)
    neg = tbsa.NEG_INF
    out = np.full(q.shape, np.nan)
    slots = [None] * n_slots

    def finish(m, l, acc):
        return np.where((m > neg / 2)[..., None], acc / np.maximum(l, 1e-30)[..., None], 0.0)

    for h, qt, step0, n, split, n_split, _, slot0 in items:
        rows = np.arange(qt * TILE, min(qt * TILE + TILE, S))
        m = np.full((Bq, len(rows)), neg)
        l = np.zeros((Bq, len(rows)))
        acc = np.zeros((Bq, len(rows), q.shape[-1]))
        for entry in steps[h, qt, step0:step0 + n]:
            kt, partial = entry >> 1, entry & 1
            cols = np.arange(kt * TILE, min(kt * TILE + TILE, S))
            s = np.einsum("bqd,bkd->bqk", q[:, h, rows], k[:, h, cols]) * scale
            if partial:
                s = np.where(layout[h][rows // lb][:, cols // lb][None], s, neg)
            m_new = np.maximum(m, s.max(-1))
            live = m_new > neg / 2
            p = np.where(live[..., None], np.exp(s - m_new[..., None]), 0.0)
            alpha = np.where(live, np.exp(m - m_new), 1.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + np.einsum("bqk,bkd->bqd", p, v[:, h, cols])
            m = m_new
        if n_split == 1:
            out[:, h, rows] = finish(m, l, acc)
            continue
        slots[slot0 + split] = (m, l, acc)
        chunks = slots[slot0:slot0 + n_split]
        if all(c is not None for c in chunks):  # the last chunk of the row merges
            m_top = np.max([c[0] for c in chunks], axis=0)
            w = [np.where(m_top > neg / 2, np.exp(c[0] - m_top), 0.0) for c in chunks]
            out[:, h, rows] = finish(m_top, sum(c[1] * wc for c, wc in zip(chunks, w)),
                                     sum(c[2] * wc[..., None] for c, wc in zip(chunks, w)))
    return out


@pytest.mark.parametrize("name", ["lb16_S80", "lb48_S192", "lb64_S512"])
def test_walking_the_tile_lists_gives_the_plain_output(name):
    S, lb = TILE_CASES[name]
    rng = np.random.default_rng(S + 1)
    layout = rng.random((H, S // lb, S // lb)) < 0.3
    layout[0, 0] = True
    layout[1, 1] = False
    layout[3] = False  # a head that attends nothing
    q, k, v = (rng.normal(size=(1, H, S, 16)) for _ in range(3))
    want = tbsa.block_sparse_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), layout, lb, 0.25)
    for split_steps in (1, 2, tbsa.SPLIT_STEPS):  # every list split into single steps; pairs; none split
        got = _walk_work_items(q, k, v, layout, lb, 0.25, split_steps)
        np.testing.assert_allclose(got, want.numpy(), **FWD_TOL)  # the plain version computes in f32
        assert not got[:, 3].any()


def _split_layout(S, lb):
    """Random cells with a global row in head 0; head 1's first q tile
    attends exactly its first 8 K/V tiles (a list of 8) from its first cell
    row, while its third cell row attends nothing (dead rows inside a split
    row once lb < 64); head 3 attends nothing."""
    layout = _random_layout(S, lb, H, 0.15, S + lb)
    rows0 = -(-TILE // lb)  # cell rows that touch q tile 0
    layout[1, :rows0] = False
    layout[1, 0, :8 * TILE // lb] = True
    layout[3] = False
    return layout


SPLIT_CASES = [(80, 16, 1), (1040, 16, 4), (1040, 16, 8), (1056, 48, 3), (1088, 64, 4)]


@pytest.mark.parametrize("S,lb,split_steps", SPLIT_CASES, ids=[f"lb{lb}_S{S}_split{n}" for S, lb, n in SPLIT_CASES])
def test_split_version_matches_plain_and_pallas(S, lb, split_steps):
    """block_sparse_attention_fwd_split, the kernel's items and merge in
    torch ops, against the plain version and the Pallas kernel (interpret
    mode), on layouts whose global row is cut into chunks."""
    layout = _split_layout(S, lb)
    plan = tbsa.BlockSparsePlan(layout, S, lb, *tbsa.choose_blocks(S, lb), split_steps=split_steps)
    counts = plan.tile_counts
    assert plan.n_rows > 0 and counts[0, 0] > split_steps  # the global row is split
    if S > 80:
        assert counts[1, 0] == 8  # a list of 8: an exact multiple of 1, 2, 4 and 8
    q, k, v = _qkv(S, seed=S + split_steps, D=16)
    scale = 0.3
    got = tbsa.block_sparse_attention_fwd_split(*(torch.from_numpy(x) for x in (q, k, v)), layout, lb, scale,
                                                split_steps)
    want = tbsa.block_sparse_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), layout, lb, scale)
    jout = np.asarray(jbsa.block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v)), layout, lb, scale))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), jout, **FWD_TOL)
    dead = np.repeat(~layout.any(-1), lb, axis=1)  # [H, S] rows attending nothing
    assert dead[1].any() and not got.numpy()[:, dead].any()  # exactly zero, inside a split row too
    assert not got[:, 3].any()


# ------------------------------------------------- sparse_self_attention --
def test_masked_branch_matches_jax_with_masks():
    S = 64
    q, k, v = _qkv(S, seed=12)
    layout = LAYOUTS["fixed"](S)
    rng = np.random.default_rng(13)
    kpm = rng.random((B, S)) < 0.8
    kpm[1] = False  # a batch row with every key padded: its rows output zeros
    attn = np.tril(np.ones((S, S), bool))
    for kw in (dict(), dict(key_padding_mask=kpm), dict(attn_mask=attn),
               dict(key_padding_mask=kpm.astype(np.float32), attn_mask=attn.astype(np.int32))):
        want = jssa.sparse_self_attention(*(jnp.asarray(x) for x in (q, k, v)), layout, LB, impl="masked", **kw)
        got = sparse_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), layout, LB, impl="masked", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not got[1].any()


def test_routing_matches_jax():
    S = 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(S, seed=14))
    layout = LAYOUTS["bigbird"](S)
    kpm = np.ones((B, S), bool)
    kpm[:, -8:] = False
    # auto: the kernel without masks, the masked branch with one
    torch.testing.assert_close(sparse_self_attention(q, k, v, layout, LB),
                               tbsa.block_sparse_attention(q, k, v, layout, LB), rtol=0, atol=0)
    torch.testing.assert_close(sparse_self_attention(q, k, v, layout, LB, key_padding_mask=kpm),
                               sparse_self_attention(q, k, v, layout, LB, key_padding_mask=kpm, impl="masked"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout only") as got:
        sparse_self_attention(q, k, v, layout, LB, attn_mask=np.ones((S, S), bool), impl="kernel")
    with pytest.raises(ValueError) as want:
        jssa.sparse_self_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), layout,
                                   LB, attn_mask=np.ones((S, S), bool), impl="kernel")
    assert str(got.value) == str(want.value)


def test_dense_mask_matches_jax():
    layout = LAYOUTS["variable"](64)
    np.testing.assert_array_equal(layout_to_dense_mask(layout, LB).numpy(),
                                  np.asarray(jssa.layout_to_dense_mask(layout, LB)))


@pytest.mark.parametrize("impl", ["kernel", "masked"])
def test_dense_layout_matches_full_attention(impl):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 64, 8)).astype(np.float32)) for _ in range(3))
    lay = DenseSparsityConfig(num_heads=2, block=16).make_layout(64)
    out = sparse_self_attention(q, k, v, lay, block=16, impl=impl)
    ref = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8), dim=-1) @ v
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["kernel", "masked"])
def test_sparse_attention_honors_layout(impl):
    """Tokens in unattended blocks must not influence the output."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1, 64, 8)).astype(np.float32)) for _ in range(3))
    lay = LocalSlidingWindowSparsityConfig(num_heads=1, block=16, num_sliding_window_blocks=1).make_layout(64)
    out1 = sparse_self_attention(q, k, v, lay, block=16, impl=impl)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 48:], v2[:, :, 48:] = 99.0, 99.0  # a block row 0 never attends
    out2 = sparse_self_attention(q, k2, v2, lay, block=16, impl=impl)
    assert torch.equal(out1[:, :, :16], out2[:, :, :16])


def test_sparse_self_attention_module_and_padding():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 64, 8)).astype(np.float32)) for _ in range(3))
    attn = SparseSelfAttention(FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2))
    assert list(attn.parameters()) == [] and attn.max_seq_length == 2048
    out = attn(q, k, v)
    assert out.shape == (2, 2, 64, 8) and attn.get_layout(64) is attn.get_layout(64)
    kpm = np.ones((2, 64), bool)
    kpm[:, 32:] = False
    out_pad = attn(q, k, v, key_padding_mask=torch.from_numpy(kpm))
    assert torch.isfinite(out_pad).all() and not torch.allclose(out, out_pad)


def test_module_matches_jax_module_with_gradients():
    """SparseSelfAttention on a BigBird config, the slice's entry point, at a
    small size: output and gradients against the JAX module's."""
    S = 128
    q, k, v = _qkv(S, seed=15)
    kw = dict(num_heads=H, block=LB, num_random_blocks=2, num_sliding_window_blocks=3, num_global_blocks=1, seed=4)
    jattn = jssa.SparseSelfAttention(jsc.BigBirdSparsityConfig(**kw))
    tattn = SparseSelfAttention(BigBirdSparsityConfig(**kw))

    def jloss(q, k, v):
        return jnp.mean(jattn(q, k, v)**2)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout = jattn(jq, jk, jv)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tattn(tq, tk, tv)
    (out**2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-7)
