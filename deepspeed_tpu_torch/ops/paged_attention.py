"""Paged attention with KV insert, for one layer of the ragged cache.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py::paged_attention_update``
(the Pallas kernel ``_kernel``). Same signature and return value: ``q [T, H,
D]``, ``k_new``/``v_new [T, KVH, D]``, ``cache [L, 2, NB, KVH, bs, D]``,
``block_table [S, MB]`` int32 and per-token ``token_seq``/``token_pos``/
``token_valid [T]`` int32; returns ``(out [T, H, D] in q's dtype, cache)``.

The JAX kernel donates and aliases the cache; here the cache is updated in
place and the same tensor is returned.

- On CUDA tensors :func:`paged_attention_update` launches the hand-written
  kernels of ``csrc/paged_attention.cu`` (insert, then attention) on the
  current stream, or raises.
- On CPU tensors it runs :func:`paged_attention_update_plain`, the same
  function in torch ops.
- :func:`paged_attention_update_split` computes it as the kernel partitions
  it (splits of ``SPLIT_POSITIONS`` positions, partial softmax states merged
  in split order), so the CPU tests hold the partition itself to the Pallas
  kernel; :func:`paged_attention_geometry` mirrors the kernel's launch
  geometry and shared memory.
"""

import ctypes
import math
import threading

import torch

from deepspeed_tpu_torch.ops import builder

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
# the kernel's launch geometry (csrc/paged_attention.cu: layout())
STAGES = 2  # stages of K/V rows in flight
STAGE_POSITIONS = 64  # positions a stage holds, when two stages fit
CONSUMER_WARPS = 8
HEADER_BYTES = 128  # mbarriers and the last-block flag
MAX_ROW_BYTES = 2048  # largest head_dim x itemsize the kernel takes
SPLIT_POSITIONS = 256  # positions of one split of a token's context
WORKSPACE_BYTES = 64 * 2**20  # partial (m, l, acc) of all splits, at most; longer splits beyond


def paged_attention_geometry(head_dim: int, rep: int, itemsize: int) -> dict:
    """The attention kernel's launch geometry (``layout()`` in the .cu
    source): ``chunks`` 16-byte vectors per K/V row; groups of ``lp`` lanes
    own one position at a time, each lane ``cpl`` chunks of the row; a block
    serves ``heads`` of the ``rep`` query heads of its KV head (the next
    power of two of ``rep``, at most what a lane's registers hold;
    ``head_groups`` blocks per KV head); a stage holds ``stage_pos``
    positions; ``smem`` bytes of dynamic shared memory: the header, the
    stages' K and V rows and the consumer warps' merge area (f32 acc, m and
    l per head). Raises for a row the kernel does not take."""
    row = head_dim * itemsize
    if row % 16 or row > MAX_ROW_BYTES or rep < 1:
        raise ValueError(f"head_dim {head_dim} x {itemsize} bytes: the kernel takes rows of a multiple of 16 bytes, "
                         f"at most {MAX_ROW_BYTES}")
    chunks = row // 16
    lp = 1
    while lp < chunks and lp < 16:
        lp *= 2
    cpl = 1
    while cpl * lp < chunks:
        cpl *= 2
    max_heads = max(1, min(4, 32 // (cpl * (16 // itemsize))))
    heads = 1
    while heads < rep and heads < max_heads:
        heads *= 2
    merge = 4 * CONSUMER_WARPS * heads * (head_dim + 2)
    smem = lambda pos: HEADER_BYTES + STAGES * 2 * pos * row + merge
    stage_pos = STAGE_POSITIONS
    while stage_pos > 1 and smem(stage_pos) > SMEM_LIMIT:
        stage_pos //= 2
    return dict(chunks=chunks, lp=lp, cpl=cpl, heads=heads, head_groups=-(-rep // heads), stage_pos=stage_pos,
                smem=smem(stage_pos))


def paged_attention_smem_bytes(head_dim: int, rep: int, itemsize: int) -> int:
    """Dynamic shared memory of the attention kernel (see
    :func:`paged_attention_geometry`); it does not depend on the block size,
    since a stage copies whatever blocks its positions fall in."""
    return paged_attention_geometry(head_dim, rep, itemsize)["smem"]


def split_positions(n_items: int, max_positions: int, heads: int, head_dim: int) -> int:
    """Positions of one split: ``SPLIT_POSITIONS``, doubled while the f32
    partials of ``n_items`` (token, KV head, head group) items over
    ``max_positions`` would outgrow ``WORKSPACE_BYTES`` (a long prefill
    forced onto the kernel) or the grid's 65535 splits."""
    span = SPLIT_POSITIONS
    while True:
        n_split = -(-max_positions // span)
        if n_split == 1 or (n_split <= 65535 and n_items * n_split * heads * (head_dim + 2) * 4 <= WORKSPACE_BYTES):
            return span
        span *= 2


def _check(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos, token_valid):
    if q.dim() != 3 or cache.dim() != 6 or block_table.dim() != 2:
        raise ValueError(f"expected q [T,H,D], cache [L,2,NB,KVH,bs,D], block_table [S,MB]; got "
                         f"{tuple(q.shape)}, {tuple(cache.shape)}, {tuple(block_table.shape)}")
    T, H, D = q.shape
    L, two, NB, KVH, bs, Dc = cache.shape
    if two != 2 or Dc != D or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(cache.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (T, KVH, D):
            raise ValueError(f"{name} {tuple(t.shape)} != {(T, KVH, D)}")
    for name, t in (("token_seq", token_seq), ("token_pos", token_pos), ("token_valid", token_valid)):
        if tuple(t.shape) != (T, ):
            raise ValueError(f"{name} {tuple(t.shape)} != {(T, )}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {L})")
    tensors = (q, k_new, v_new, cache, block_table, token_seq, token_pos, token_valid)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: {sorted({str(t.device) for t in tensors})}")


def _insert(k_new, v_new, cache, layer_idx, table, seq, pos, valid):
    """Every valid token's K/V into block max(table[seq, min(pos // bs,
    MB - 1)], 0), slot pos % bs; returns the layer's K and V views
    ``[NB, KVH, bs, D]``."""
    kc, vc = cache[layer_idx, 0], cache[layer_idx, 1]
    bs, MB = cache.shape[4], table.shape[1]
    own = table[seq, (pos // bs).clamp(max=MB - 1)].clamp(min=0)[valid]
    off = (pos % bs)[valid]
    kc[own, :, off] = k_new[valid].to(cache.dtype)
    vc[own, :, off] = v_new[valid].to(cache.dtype)
    return kc, vc


def paged_attention_update_plain(q, k_new, v_new, cache, layer_idx, block_table, token_seq,
                                 token_pos, token_valid):
    """The kernel's function in torch ops: every valid token's K/V is written
    first, then each token attends its sequence's positions ``0..pos`` in f32
    (a full softmax where the kernel keeps an online one)."""
    _check(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos, token_valid)
    T, H, D = q.shape
    _, _, NB, KVH, bs, _ = cache.shape
    S, MB = block_table.shape
    rep = H // KVH
    table = block_table.long()
    seq = token_seq.long().clamp(max=S - 1)
    pos = token_pos.long()
    valid = token_valid > 0

    kc, vc = _insert(k_new, v_new, cache, layer_idx, table, seq, pos, valid)

    # attend: positions p <= pos within the first nblocks table entries
    KV = MB * bs
    hist = table.clamp(min=0)[seq]  # [T, MB]; -1 reads block 0, masked by position
    k = kc[hist].permute(0, 2, 1, 3, 4).reshape(T, KVH, KV, D).float()
    v = vc[hist].permute(0, 2, 1, 3, 4).reshape(T, KVH, KV, D).float()
    qf = q.float().reshape(T, KVH, rep, D) * (1.0 / math.sqrt(D))
    nblocks = torch.where(valid, (pos // bs + 1).clamp(max=MB), torch.zeros_like(pos))
    kv_pos = torch.arange(KV, device=q.device)
    mask = (kv_pos[None, :] <= pos[:, None]) & (kv_pos[None, :] < (nblocks * bs)[:, None])
    mask = mask[:, None, None, :]  # [T, 1, 1, KV]
    logits = torch.einsum("tgrd,tgkd->tgrk", qf, k).masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    out = torch.einsum("tgrk,tgkd->tgrd", p, v) / p.sum(-1, keepdim=True).clamp(min=1e-20)
    out = out.masked_fill(~valid[:, None, None, None], 0.0)
    return out.reshape(T, H, D).to(q.dtype), cache


def paged_attention_update_split(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos,
                                 token_valid, span=SPLIT_POSITIONS):
    """The kernel's partition of the work, in torch ops: the inserts, then
    for each valid token and KV head the attended positions ``0..last`` cut
    into splits of ``span`` positions, each split's partial ``(m, l, acc)``
    in f32 (its max score, its sum of ``exp(s - m)``, and that sum over V
    rows), and the partials merged in split order, as the kernel's last
    block merges them. A context of one split is normalised directly."""
    _check(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos, token_valid)
    T, H, D = q.shape
    _, _, NB, KVH, bs, _ = cache.shape
    S, MB = block_table.shape
    rep = H // KVH
    table = block_table.long()
    seq = token_seq.long().clamp(max=S - 1)
    pos = token_pos.long()
    valid = token_valid > 0
    kc, vc = _insert(k_new, v_new, cache, layer_idx, table, seq, pos, valid)

    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for t in torch.nonzero(valid).flatten().tolist():
        p = int(pos[t])
        last = min(p, min(p // bs + 1, MB) * bs - 1)
        blocks = table[seq[t], :last // bs + 1].clamp(min=0)
        k = kc[blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)[:, :last + 1].float()  # [KVH, n, D]
        v = vc[blocks].permute(1, 0, 2, 3).reshape(KVH, -1, D)[:, :last + 1].float()
        qf = q[t].float().reshape(KVH, rep, D) * scale
        parts = []
        for start in range(0, last + 1, span):
            s = torch.einsum("grd,gnd->grn", qf, k[:, start:start + span])
            m = s.amax(dim=-1)
            e = torch.exp(s - m[..., None])
            parts.append((m, e.sum(dim=-1), torch.einsum("grn,gnd->grd", e, v[:, start:start + span])))
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:
            mt = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            l = torch.zeros_like(mt)
            acc = torch.zeros_like(qf)
            for m, ls, accs in parts:
                f = torch.exp(m - mt)
                l = l + ls * f
                acc = acc + accs * f[..., None]
        out[t] = (acc / l.clamp(min=1e-20)[..., None]).reshape(H, D)
    return out.to(q.dtype), cache


def _lib():
    lib = builder.load("paged_attention")
    if not getattr(lib, "_dstt_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.dstt_paged_kv_insert.argtypes = [vp, vp, vp, i32, vp, i64, vp, vp, vp] + [i32] * 8 + [vp]
        lib.dstt_paged_kv_insert.restype = i32
        lib.dstt_paged_attention.argtypes = ([vp, vp, vp, i32, vp, vp, vp, i64, vp, vp, vp] + [i32] * 11 +
                                             [ctypes.c_float, vp])
        lib.dstt_paged_attention.restype = i32
        lib.dstt_paged_attention_geometry.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.dstt_paged_attention_geometry.restype = i32
        lib.dstt_error_string.argtypes = [i32]
        lib.dstt_error_string.restype = ctypes.c_char_p
        lib._dstt_typed = True
    return lib


def kernel_geometry(head_dim: int, rep: int, itemsize: int) -> dict:
    """The geometry the built kernel computes for itself (CUDA machines
    only), to hold :func:`paged_attention_geometry` to."""
    lib = _lib()
    vals = (ctypes.c_int * 7)()
    _raise_on(lib, lib.dstt_paged_attention_geometry(head_dim, rep, itemsize, vals), "paged attention geometry")
    return dict(zip(("chunks", "lp", "cpl", "heads", "head_groups", "stage_pos", "smem"), vals))


def _raise_on(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dstt_error_string(code).decode()} (code {code})")


_WORKSPACES = {}  # (device, stream) -> (counters int32, partials f32), grown as needed
_WORKSPACES_LOCK = threading.Lock()  # also makes the launch count's increments whole


def _workspace(device, stream, n_items, n_part):
    """Per-stream split counters (zero between launches: the last block of
    each item resets its own) and f32 partials. Launches on one stream run
    in order, so they share one workspace, whichever host thread enqueues
    them: several serving schedulers in one process (the fleet's in-process
    replicas) all launch on their threads' default stream. The lock makes
    the look-up-and-grow one step; a launch keeps the tensors it was given
    alive until it returns, and the caching allocator reuses a replaced
    buffer only for later work on the same stream."""
    with _WORKSPACES_LOCK:
        counters, partials = _WORKSPACES.get((device, stream), (None, None))
        if counters is None or counters.numel() < n_items:
            counters = torch.zeros(n_items, dtype=torch.int32, device=device)
        if partials is None or partials.numel() < n_part:
            partials = torch.empty(n_part, dtype=torch.float32, device=device)
        _WORKSPACES[(device, stream)] = (counters, partials)
    return counters, partials


def paged_attention_update(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos,
                           token_valid):
    """Fused KV insert + blocked attention for one layer (see module doc).
    ``paged_attention_update.launches`` counts the CUDA kernel launches (two
    per call: insert, attention)."""
    if q.device.type == "cpu":
        return paged_attention_update_plain(q, k_new, v_new, cache, layer_idx, block_table, token_seq,
                                            token_pos, token_valid)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_update runs on cuda or cpu tensors, not {q.device}")
    _check(q, k_new, v_new, cache, layer_idx, block_table, token_seq, token_pos, token_valid)
    T, H, D = q.shape
    _, _, NB, KVH, bs, _ = cache.shape
    S, MB = block_table.shape
    if q.dtype != cache.dtype or cache.dtype not in _DTYPE_CODE:
        raise TypeError(f"q {q.dtype} and cache {cache.dtype} must share one of {list(_DTYPE_CODE)}")
    if cache.data_ptr() % 16:
        raise ValueError("the cache must be 16-byte aligned (the kernel copies 16-byte vectors)")
    geo = paged_attention_geometry(D, H // KVH, cache.element_size())
    for name, t in (("q", q), ("cache", cache), ("token_seq", token_seq), ("token_pos", token_pos),
                    ("token_valid", token_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("block_table", block_table), ("token_seq", token_seq), ("token_pos", token_pos),
                    ("token_valid", token_valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if block_table.stride(1) != 1:
        raise ValueError("block_table rows must be contiguous")
    if T == 0:
        return q.new_empty((0, H, D)), cache
    k_new = k_new.to(cache.dtype).contiguous()
    v_new = v_new.to(cache.dtype).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    code = _DTYPE_CODE[cache.dtype]
    meta = (block_table.data_ptr(), block_table.stride(0), token_seq.data_ptr(), token_pos.data_ptr(),
            token_valid.data_ptr())
    n_items = T * KVH * geo["head_groups"]
    span = split_positions(n_items, MB * bs, geo["heads"], D)
    n_split = -(-(MB * bs) // span)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters, partials = _workspace(q.device, stream, n_items, n_items * n_split * geo["heads"] * (D + 2))
        rc = lib.dstt_paged_kv_insert(k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(), code, *meta, T,
                                      layer_idx, NB, KVH, bs, D, S, MB, stream)
        _raise_on(lib, rc, "paged KV insert")
        with _WORKSPACES_LOCK:
            paged_attention_update.launches += 1
        rc = lib.dstt_paged_attention(q.data_ptr(), cache.data_ptr(), out.data_ptr(), code, partials.data_ptr(),
                                      counters.data_ptr(), *meta, T, H, layer_idx, NB, KVH, bs, D, S, MB, n_split,
                                      span, 1.0 / math.sqrt(D), stream)
        _raise_on(lib, rc, "paged attention")
        with _WORKSPACES_LOCK:
            paged_attention_update.launches += 1
    return out, cache


paged_attention_update.launches = 0
