"""Block-sparse flash attention over ``[B, H, S, D]``, forward and backward.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``. A layout
``[H, nb, nb]`` marks the cells of ``layout_block`` x ``layout_block`` tokens
that each head attends; time and memory follow the attended cells, not S^2.

- Host geometry, as the JAX package computes it: :func:`choose_blocks` picks
  its ``(block_q, block_k)`` and :func:`build_block_lists` its per-(head,
  q-block) lists of attended KV blocks. They fix the structure of the
  backward and of the plain forward.
- The forward wrapper :func:`block_sparse_attention_fwd` launches the
  hand-written kernel of ``csrc/block_sparse_attention.cu`` (replacing the
  Pallas kernel ``_sparse_fwd_kernel``) on CUDA tensors, on the current
  stream, or raises; there is no fallback. On CPU tensors it runs the plain
  version :func:`block_sparse_attention_fwd_plain`. The kernel walks lists of
  its own 64-row tiles (:func:`build_tile_lists`), not the JAX package's
  blocks, whose sizes and 32-cell bitfield are limits of the TPU, cut into
  work items (:func:`build_work_items`): a list longer than the plan's
  ``split_steps`` runs as several chunks whose partial softmaxes the last
  chunk merges. :func:`block_sparse_attention_fwd_split` is that algorithm
  in torch ops.
- The backward :func:`block_sparse_attention_bwd` is ``_sparse_bwd_manual``
  in torch ops over the JAX geometry's lists, on the CPU and on the card
  alike: the JAX package computes it in XLA, not in a kernel.

:func:`block_sparse_attention` is differentiable. A :class:`BlockSparsePlan`
holds one layout's lists at one geometry and their device copies; plans are
cached, so a layout's lists are built and copied to the card once, not once
per call. The forward wrapper counts its kernel launches in ``.launches``.
"""

import ctypes
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.ops.flash_attention import HEAD_DIMS, kernel_head_dim, pad_head_dim

NEG_INF = -1e30
KERNEL_TILE = 64  # rows of the kernel's q and KV tiles (csrc/block_sparse_attention.cu kTile)
# a (head, q tile) list longer than this is cut into chunks, at the least
# (BlockSparsePlan.split_steps); bench.py's BigBird layouts then split only
# their global rows, 128 steps into 4 chunks. On an H100, chunks of 32 or 64
# ran fastest at bench.py's low density (no cut: 36% slower, 8: 13%), and
# every length from 32 up within 1% at the high one (PERF.md gives the sweep)
SPLIT_STEPS = 32
# a work item: head, q tile, first step, steps, split, splits, split row
# (-1 unless splits > 1), first workspace slot of the row's chunks (-1 too)
ITEM_FIELDS = ("head", "q_tile", "step0", "steps", "split", "splits", "row", "slot0")
_DTYPE_CODE = {torch.float16: 1, torch.bfloat16: 2}
_PLAN_CACHE = {}
_PLAN_CACHE_SIZE = 64  # bounded: layouts are few and static in practice


def build_block_lists(layout, seq_len: int, layout_block: int, block_q: int, block_k: int):
    """layout [H, nb, nb] (cells of ``layout_block`` tokens) → per-(head,
    q-block) attended KV-block lists, as the JAX package builds them.

    Returns (idx [H, nqb, max_steps] int32, counts [H, nqb] int32). Steps
    past a row's count repeat its last live index. (The JAX package also
    returns each block pair's cells as an int32 bitfield for the TPU kernel;
    the plain forward and the backward here read the cells from the layout.)
    """
    layout = np.asarray(layout, bool)
    H = layout.shape[0]
    nb = seq_len // layout_block
    assert layout.shape[1] == nb and layout.shape[2] == nb, \
        f"layout {layout.shape} does not tile seq_len {seq_len} at block {layout_block}"
    assert block_q % layout_block == 0 and block_k % layout_block == 0, \
        "kernel blocks must be multiples of the layout block"
    nqb, nkb = seq_len // block_q, seq_len // block_k
    rq, rk = block_q // layout_block, block_k // layout_block
    coarse = layout.reshape(H, nqb, rq, nkb, rk).any(axis=(2, 4))  # [H, nqb, nkb]
    counts = coarse.sum(-1).astype(np.int32)
    max_steps = max(1, int(counts.max()))
    idx = np.zeros((H, nqb, max_steps), np.int32)
    for h in range(H):
        for qi in range(nqb):
            ids = np.nonzero(coarse[h, qi])[0]
            idx[h, qi, :len(ids)] = ids
            if len(ids):
                idx[h, qi, len(ids):] = ids[-1]
    return idx, counts


def choose_blocks(seq_len: int, layout_block: int, block_q: int = 256, block_k: int = 256):
    """The JAX package's ``(block_q, block_k)`` for ``seq_len``: multiples of
    the layout block that divide ``seq_len``, shrunk until a block pair holds
    at most 32 layout cells."""
    S, lb = seq_len, layout_block
    bq = max(lb, (min(block_q, S) // lb) * lb)
    while S % bq:
        bq -= lb
    bk = max(lb, (min(block_k, S) // lb) * lb)
    while S % bk:
        bk -= lb
    while (bq // lb) * (bk // lb) > 32:
        if bk >= bq and bk > lb:
            bk = max(lb, bk // 2 // lb * lb)
        else:
            bq = max(lb, bq // 2 // lb * lb)
        while S % bq:
            bq -= lb
        while S % bk:
            bk -= lb
    return bq, bk


def build_tile_lists(layout, seq_len: int, layout_block: int, tile: int = KERNEL_TILE):
    """The kernel's lists: for each (head, q tile of ``tile`` rows), the KV
    tiles that hold an attended cell, in increasing order.

    Returns (steps [H, nt, max_steps] int32, counts [H, nt] int32). A step
    is ``kv_tile * 2 + partial``; ``partial`` is 1 when some layout cell the
    tile pair covers is off, so the kernel reads the cell mask inside it from
    the layout. Entries past a row's count are unused. Any ``seq_len`` works:
    the last tile may be ragged, and cells need not align with tiles.
    """
    layout = np.asarray(layout, bool)
    H, nb = layout.shape[0], seq_len // layout_block
    if layout.shape[1:] != (nb, nb) or nb * layout_block != seq_len:
        raise ValueError(f"layout {layout.shape} does not tile seq_len {seq_len} at block {layout_block}")
    nt = -(-seq_len // tile)
    start = np.arange(nt) * tile
    lo = start // layout_block  # first and one past the last cell each tile touches
    hi = (np.minimum(start + tile, seq_len) - 1) // layout_block + 1
    # cells on in each rectangle of cells, from 2-D prefix sums of the layout
    pre = np.zeros((H, nb + 1, nb + 1), np.int64)
    pre[:, 1:, 1:] = layout.cumsum(1).cumsum(2)
    r0, r1, c0, c1 = lo[:, None], hi[:, None], lo[None, :], hi[None, :]
    on = pre[:, r1, c1] - pre[:, r0, c1] - pre[:, r1, c0] + pre[:, r0, c0]  # [H, nt, nt]
    attended, partial = on > 0, on < (r1 - r0) * (c1 - c0)
    counts = attended.sum(-1).astype(np.int32)
    max_steps = max(1, int(counts.max()))
    ids = np.argsort(~attended, axis=-1, kind="stable")[..., :max_steps]
    steps = (ids * 2 + np.take_along_axis(partial, ids, -1)).astype(np.int32)
    return steps, counts


def choose_split_steps(counts):
    """The plan's chunk length: SPLIT_STEPS, or the median length of the
    lists that have a step where that is longer, so that only lists longer
    than most are cut (a dense layout's lists are all long and none needs
    cutting to balance the card)."""
    live = np.asarray(counts)[np.asarray(counts) > 0]
    return max(SPLIT_STEPS, int(np.ceil(np.median(live)))) if live.size else SPLIT_STEPS


def build_work_items(counts, split_steps: int):
    """The kernel's work items over the lists of :func:`build_tile_lists`.

    Each (head, q tile) list of n steps becomes ``k = max(1, ceil(n /
    split_steps))`` items, contiguous chunks of near-equal length (the first
    ``n % k`` one step longer), in split order; a list with no step is one
    item of 0 steps, which writes its zero rows. A list cut into k > 1
    chunks is a split row: it gets the next row index (its counter) and k
    workspace slots, one per chunk, from the next free one. Items are sorted
    by decreasing steps, ties in (head, q tile, split) order: the kernel
    launches the longest first.

    Returns (items [n_items, len(ITEM_FIELDS)] int32, n_rows, n_slots).
    """
    counts = np.asarray(counts)
    if split_steps < 1:
        raise ValueError(f"split_steps must be at least 1, got {split_steps}")
    H, nt = counts.shape
    items, n_rows, n_slots = [], 0, 0
    for h in range(H):
        for qt in range(nt):
            n = int(counts[h, qt])
            k = max(1, -(-n // split_steps))
            row, slot0 = (n_rows, n_slots) if k > 1 else (-1, -1)
            if k > 1:
                n_rows, n_slots = n_rows + 1, n_slots + k
            step0 = 0
            for c in range(k):
                size = n // k + (c < n % k)
                items.append((h, qt, step0, size, c, k, row, slot0))
                step0 += size
    items = np.asarray(items, np.int32).reshape(-1, len(ITEM_FIELDS))
    items = items[np.argsort(-items[:, 3], kind="stable")]
    return items, n_rows, n_slots


class BlockSparsePlan:
    """One layout's lists at one sequence length and geometry, built on the
    host, with their copies on each device, made at first use:
    :meth:`blocks` for the plain forward and the backward (the JAX package's
    ``block_q`` x ``block_k`` blocks), :meth:`tiles` for the kernel. The
    kernel's tile lists and work items (cut at ``split_steps``, by default
    :func:`choose_split_steps` of the lists) are built here, on the host."""

    def __init__(self, layout, seq_len: int, layout_block: int, block_q: int, block_k: int, split_steps=None):
        self.layout = np.asarray(layout, bool)
        self.seq_len, self.layout_block = seq_len, layout_block
        self.block_q, self.block_k = block_q, block_k
        self.idx, self.counts = build_block_lists(self.layout, seq_len, layout_block, block_q, block_k)
        self.steps, self.tile_counts = build_tile_lists(self.layout, seq_len, layout_block)
        self.split_steps = choose_split_steps(self.tile_counts) if split_steps is None else int(split_steps)
        self.items, self.n_rows, self.n_slots = build_work_items(self.tile_counts, self.split_steps)
        self._blocks, self._tiles = {}, {}

    @property
    def num_heads(self):
        return self.layout.shape[0]

    def blocks(self, device):
        """Per q-block: (ids [H, ms] int64, cells [H, ms, rq, rk] bool), ``ms``
        the most live steps of any head in this q-block (at least 1), cells
        the layout cells of each step's block pair, off on dead steps."""
        device = torch.device(device)
        if device not in self._blocks:
            H, lb = self.num_heads, self.layout_block
            nqb, nkb = self.seq_len // self.block_q, self.seq_len // self.block_k
            rq, rk = self.block_q // lb, self.block_k // lb
            lay_q = self.layout.reshape(H, nqb, rq, nkb, rk)
            per_q = []
            for qi in range(nqb):
                ms = max(1, int(self.counts[:, qi].max()))
                ids = self.idx[:, qi, :ms]
                live = np.arange(ms)[None] < self.counts[:, qi, None]
                cells = np.stack([lay_q[h, qi].transpose(1, 0, 2)[ids[h]] for h in range(H)])
                cells &= live[:, :, None, None]
                per_q.append((torch.from_numpy(ids.astype(np.int64)).to(device),
                              torch.from_numpy(cells).to(device)))
            self._blocks[device] = per_q
        return self._blocks[device]

    def tiles(self, device):
        """The kernel's lists on ``device``: int32 ``steps`` [H, nt,
        max_steps] (:func:`build_tile_lists`), ``items`` [n_items, 8]
        (:func:`build_work_items`) and the layout as uint8 ``cells`` [H, nb,
        nb]."""
        device = torch.device(device)
        if device not in self._tiles:
            host = dict(steps=self.steps, items=self.items, cells=self.layout.astype(np.uint8))
            self._tiles[device] = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                   for name, a in host.items()}
        return self._tiles[device]


def get_plan(layout, seq_len: int, layout_block: int, block_q: int = 256, block_k: int = 256):
    """The cached :class:`BlockSparsePlan` of ``layout`` at ``seq_len``, with
    the JAX package's blocks for ``(block_q, block_k)``. The lists do not
    depend on the scale or on the device (a plan keeps a copy per device), so
    neither is part of the key."""
    if seq_len % layout_block:
        raise ValueError(f"seq {seq_len} must tile layout_block {layout_block}")
    lay = np.asarray(layout, bool)
    bq, bk = choose_blocks(seq_len, layout_block, block_q, block_k)
    key = (lay.shape, lay.tobytes(), seq_len, layout_block, bq, bk)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = BlockSparsePlan(lay, seq_len, layout_block, bq, bk)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_SIZE:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
    return plan


def _check(q, k, v, plan):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"expected q, k, v of one shape [B, H, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must lie on one device")
    B, H, S, D = q.shape
    if H != plan.num_heads or S != plan.seq_len:
        raise ValueError(f"the plan is for {plan.num_heads} heads and seq {plan.seq_len}; got H={H}, S={S}")
    return B, H, S, D


def _gather(x, ids):
    """x [B, H, n, bk, D], ids [H, m] → [B, H, m, bk, D]: head h's blocks ids[h]."""
    heads = torch.arange(x.shape[1], device=x.device)[:, None]
    return x[:, heads, ids]


def _cell_mask(cells, lb):
    """cells [H, m, rq, rk] → the token mask [H, m, rq * lb, rk * lb]."""
    H, m, rq, rk = cells.shape
    return cells[:, :, :, None, :, None].expand(H, m, rq, lb, rk, lb).reshape(H, m, rq * lb, rk * lb)


def _blocked_kv(x, plan):
    B, H, S, D = x.shape
    return x.float().reshape(B, H, S // plan.block_k, plan.block_k, D)


def _fwd_plain(q, k, v, plan, scale):
    B, H, S, D = _check(q, k, v, plan)
    qf, kb, vb = q.float(), _blocked_kv(k, plan), _blocked_kv(v, plan)
    outs = []
    for qi, (ids, cells) in enumerate(plan.blocks(q.device)):
        mask = _cell_mask(cells, plan.layout_block)[None]  # [1, H, ms, bq, bk]
        q_blk = qf[:, :, qi * plan.block_q:(qi + 1) * plan.block_q]
        s = torch.einsum("bhqd,bhmkd->bhmqk", q_blk, _gather(kb, ids)) * scale
        s = s.masked_fill(~mask, NEG_INF)
        # [B, H, 1, bq, 1] over (steps, keys); the softmax does not depend on
        # it, so autograd through this function need not either
        m = s.amax(dim=(2, 4), keepdim=True).detach()
        # the guarded exp: a row with no attended cell keeps p = 0
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=(2, 4)).clamp(min=1e-30)
        o = torch.einsum("bhmqk,bhmkd->bhqd", p, _gather(vb, ids)) / l[..., None]
        # rows with no attended cell anywhere output zeros
        outs.append(torch.where(m[:, :, 0] > NEG_INF / 2, o, 0.0))
    return torch.cat(outs, dim=2).to(q.dtype)


def block_sparse_attention_fwd_plain(q, k, v, layout, layout_block, scale):
    """B5's function in torch ops, f32 throughout: for each q-block of the
    JAX geometry, the attended KV blocks gathered, the layout cells masked,
    a guarded softmax with ``l`` floored at 1e-30, and zeros for rows that
    attend nothing. Returns ``out`` [B, H, S, D] in q's dtype."""
    return _fwd_plain(q, k, v, get_plan(layout, q.shape[2], layout_block), scale)


def block_sparse_attention_fwd_split(q, k, v, layout, layout_block, scale, split_steps=None):
    """B5's algorithm in torch ops, f32: the kernel's work items (the plan's,
    or cut at ``split_steps``) walked in launch order, each chunk's 64-row
    tile through its K/V tiles with an online softmax (the cell mask on
    partial steps and past S, the guarded exp), a whole list writing its
    rows, a chunk of a split row keeping f32 (m, l, acc); then each split
    row's chunks merged in split order (a row dead in every chunk writes
    zeros). Returns ``out`` [B, H, S, D] in q's dtype."""
    S = q.shape[2]
    plan = get_plan(layout, S, layout_block)
    if split_steps is not None and split_steps != plan.split_steps:
        plan = BlockSparsePlan(plan.layout, S, layout_block, plan.block_q, plan.block_k, split_steps)
    _check(q, k, v, plan)
    qf, kf, vf = q.float(), k.float(), v.float()
    lay = torch.from_numpy(plan.layout).to(q.device)
    out = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    chunks = {}  # (head, q tile) of a split row -> {split: (m, l, acc)}
    for h, qt, step0, n, split, n_split, _, _ in plan.items.tolist():
        rows = torch.arange(qt * KERNEL_TILE, min(S, (qt + 1) * KERNEL_TILE), device=q.device)
        m = torch.full((q.shape[0], len(rows)), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((q.shape[0], len(rows), q.shape[3]), device=q.device)
        for entry in plan.steps[h, qt, step0:step0 + n].tolist():
            cols = torch.arange((entry >> 1) * KERNEL_TILE, min(S, ((entry >> 1) + 1) * KERNEL_TILE), device=q.device)
            s = torch.einsum("bqd,bkd->bqk", qf[:, h, rows], kf[:, h, cols]) * scale
            if entry & 1:
                s = s.masked_fill(~lay[h][rows // layout_block][:, cols // layout_block], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            live = m_new > NEG_INF / 2
            p = torch.where(live[..., None], torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.where(live, torch.exp(m - m_new), 1.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vf[:, h, cols])
            m = m_new
        if n_split == 1:
            out[:, h, rows] = _finish(m, l, acc)
        else:
            chunks.setdefault((h, qt), {})[split] = (m, l, acc)
    for (h, qt), parts in chunks.items():
        m, l, acc = (torch.stack([parts[c][i] for c in range(len(parts))]) for i in range(3))
        m_top = m.amax(0)
        w = torch.where(m_top > NEG_INF / 2, torch.exp(m - m_top), 0.0)  # the guarded exp across chunks
        rows = slice(qt * KERNEL_TILE, min(S, (qt + 1) * KERNEL_TILE))
        out[:, h, rows] = _finish(m_top, (l * w).sum(0), (acc * w[..., None]).sum(0))
    return out.to(q.dtype)


def _finish(m, l, acc):
    """acc / l, l floored at 1e-30, and zeros for rows with nothing attended."""
    return torch.where((m > NEG_INF / 2)[..., None], acc / l.clamp(min=1e-30)[..., None], 0.0)


def block_sparse_attention_bwd(q, k, v, out, dout, plan, scale):
    """``(dq, dk, dv)`` of the block-sparse attention, in torch ops over the
    plan's JAX blocks (the JAX package's ``_sparse_bwd_manual``): per q-block,
    the softmax recomputed over the same steps, ``delta = rowsum(dO * out)``,
    ``dv = p^T dO``, ``ds = p (dO v^T - delta)``, ``dq = ds k scale``,
    ``dk = ds^T q scale``. dK and dV are summed per head with ``index_add_``,
    which adds repeated indices (a q-block's dead steps repeat its last live
    block, with p = 0 there). Gradients in their inputs' dtypes."""
    B, H, S, D = _check(q, k, v, plan)
    bq, bk, lb = plan.block_q, plan.block_k, plan.layout_block
    nkb = S // bk
    qf, gf = q.float(), dout.float()
    kb, vb = _blocked_kv(k, plan), _blocked_kv(v, plan)
    delta = (gf * out.float()).sum(dim=-1)  # [B, H, S]
    dq = []
    dk = torch.zeros((B, H * nkb, bk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    head_base = torch.arange(H, device=q.device)[:, None] * nkb
    for qi, (ids, cells) in enumerate(plan.blocks(q.device)):
        rows = slice(qi * bq, (qi + 1) * bq)
        q_blk, g_blk, d_blk = qf[:, :, rows], gf[:, :, rows], delta[:, :, rows, None]
        k_sel, v_sel = _gather(kb, ids), _gather(vb, ids)
        mask = _cell_mask(cells, lb)[None]
        s = torch.einsum("bhqd,bhmkd->bhmqk", q_blk, k_sel) * scale
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=(2, 4), keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        p = p / p.sum(dim=(2, 4), keepdim=True).clamp(min=1e-30)
        dv_q = torch.einsum("bhmqk,bhqd->bhmkd", p, g_blk)
        dp = torch.einsum("bhqd,bhmkd->bhmqk", g_blk, v_sel)
        ds = p * (dp - d_blk[:, :, None])
        dq.append(torch.einsum("bhmqk,bhmkd->bhqd", ds, k_sel) * scale)
        dk_q = torch.einsum("bhmqk,bhqd->bhmkd", ds, q_blk) * scale
        flat = (head_base + ids).reshape(-1)  # [H * ms] rows of dk viewed as [B, H * nkb, bk, D]
        dk.index_add_(1, flat, dk_q.reshape(B, -1, bk, D))
        dv.index_add_(1, flat, dv_q.reshape(B, -1, bk, D))
    return (torch.cat(dq, dim=2).to(q.dtype), dk.reshape(B, H, S, D).to(k.dtype),
            dv.reshape(B, H, S, D).to(v.dtype))


def _lib():
    lib = builder.load("block_sparse_attention")
    if not getattr(lib, "_dstt_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out, steps, items, cells, part, counters; dtype, B, H, S, D, lb, nt, max_steps, n_items,
        # n_rows, n_slots; scale; stream
        lib.dstt_block_sparse_fwd.argtypes = [vp] * 9 + [i32] * 11 + [ctypes.c_float, vp]
        lib.dstt_block_sparse_fwd.restype = i32
        lib.dstt_block_sparse_error_string.argtypes = [i32]
        lib.dstt_block_sparse_error_string.restype = ctypes.c_char_p
        lib._dstt_typed = True
    return lib


_WORKSPACES = {}  # (device, stream) -> (counters int32, partials f32), grown as needed


def _workspace(device, stream, n_counters, n_part):
    """Per-stream split-row counters (zero between launches: the last chunk
    of each row resets its own) and f32 partials. Launches on one stream run
    in order, so they share one workspace."""
    counters, partials = _WORKSPACES.get((device, stream), (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1), dtype=torch.int32, device=device)
    if partials is None or partials.numel() < n_part:
        partials = torch.empty(max(n_part, 1), dtype=torch.float32, device=device)
    _WORKSPACES[(device, stream)] = (counters, partials)
    return counters, partials


def block_sparse_attention_fwd(q, k, v, plan, scale):
    """B5: ``out`` [B, H, S, D] in q's dtype. CUDA tensors launch the kernel
    over ``plan.tiles``, one launch a call; CPU tensors run the plain
    version."""
    B, H, S, D = _check(q, k, v, plan)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, plan, scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention_fwd runs on cuda or cpu tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block_sparse_attention_fwd: q, k and v must share one of {list(_DTYPE_CODE)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel_head_dim(D)  # raises past the widest kernel
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads it by TMA)")
    if D not in HEAD_DIMS:  # zero-padded to the kernel's width (ops/flash_attention.py)
        return block_sparse_attention_fwd(*pad_head_dim(q, k, v), plan, scale)[..., :D].contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    t = plan.tiles(q.device)
    lib = _lib()
    part_floats = (D // 2 + 4) * 128  # a chunk's partial (csrc/block_sparse_attention.cu Layout::kPartFloats)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters, partials = _workspace(q.device, stream, B * plan.n_rows, B * plan.n_slots * part_floats)
        rc = lib.dstt_block_sparse_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                       t["steps"].data_ptr(), t["items"].data_ptr(), t["cells"].data_ptr(),
                                       partials.data_ptr(), counters.data_ptr(), _DTYPE_CODE[q.dtype], B, H, S, D,
                                       plan.layout_block, t["steps"].shape[1], t["steps"].shape[2],
                                       t["items"].shape[0], plan.n_rows, plan.n_slots, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"block-sparse attention launch failed: "
                           f"{lib.dstt_block_sparse_error_string(rc).decode()} (code {rc})")
    block_sparse_attention_fwd.launches += 1
    return out


block_sparse_attention_fwd.launches = 0


class _BlockSparseAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, plan, scale):
        out = block_sparse_attention_fwd(q, k, v, plan, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.plan, ctx.scale = plan, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, out, dout, ctx.plan, ctx.scale)
        return dq, dk, dv, None, None


def block_sparse_attention(q, k, v, layout, layout_block: int, scale=None, block_q: int = 256,
                           block_k: int = 256):
    """q/k/v: [B, H, S, D]; layout: [H, nb, nb] host array of boolean cells
    of ``layout_block`` tokens. Returns [B, H, S, D]; differentiable.
    ``block_q``/``block_k`` set the JAX package's blocks, which the backward
    walks (see :func:`choose_blocks`)."""
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    plan = get_plan(layout, S, layout_block, block_q, block_k)
    return _BlockSparseAttention.apply(q, k, v, plan, float(scale))
