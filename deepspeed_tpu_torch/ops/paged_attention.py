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
"""

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops import builder

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100


def paged_attention_smem_bytes(block_size: int, head_dim: int, rep: int, itemsize: int) -> int:
    """Dynamic shared memory of the attention kernel (``smem_bytes`` in the
    .cu source): K and V tiles in the cache dtype, f32 q, accumulator,
    scores and per-head running max, sum and rescale."""
    return 2 * block_size * head_dim * itemsize + 4 * (2 * rep * head_dim + rep * block_size + 3 * rep)


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

    # insert: block max(table[seq, min(pos//bs, MB-1)], 0), slot pos % bs
    kc, vc = cache[layer_idx, 0], cache[layer_idx, 1]  # views [NB, KVH, bs, D]
    own = table[seq, (pos // bs).clamp(max=MB - 1)].clamp(min=0)[valid]
    off = (pos % bs)[valid]
    kc[own, :, off] = k_new[valid].to(cache.dtype)
    vc[own, :, off] = v_new[valid].to(cache.dtype)

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


def _lib():
    lib = builder.load("paged_attention")
    if not getattr(lib, "_dstt_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.dstt_paged_kv_insert.argtypes = [vp, vp, vp, i32, vp, i64, vp, vp, vp] + [i32] * 8 + [vp]
        lib.dstt_paged_kv_insert.restype = i32
        lib.dstt_paged_attention.argtypes = ([vp, vp, vp, i32, vp, i64, vp, vp, vp] + [i32] * 9 +
                                             [ctypes.c_float, vp])
        lib.dstt_paged_attention.restype = i32
        lib.dstt_error_string.argtypes = [i32]
        lib.dstt_error_string.restype = ctypes.c_char_p
        lib._dstt_typed = True
    return lib


def _raise_on(lib, code, what):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dstt_error_string(code).decode()} (code {code})")


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
    if (D * cache.element_size()) % 16 or cache.data_ptr() % 16:
        raise ValueError(f"head_dim {D} x {cache.element_size()} bytes must be a multiple of 16 "
                         "bytes and the cache 16-byte aligned (the kernel stages 16-byte vectors)")
    smem = paged_attention_smem_bytes(bs, D, H // KVH, cache.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel needs {smem} bytes of shared memory > {SMEM_LIMIT} "
                         f"(kv_block_size={bs}, head_dim={D})")
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dstt_paged_kv_insert(k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(), code, *meta, T,
                                      layer_idx, NB, KVH, bs, D, S, MB, stream)
        _raise_on(lib, rc, "paged KV insert")
        paged_attention_update.launches += 1
        rc = lib.dstt_paged_attention(q.data_ptr(), cache.data_ptr(), out.data_ptr(), code, *meta, T, H,
                                      layer_idx, NB, KVH, bs, D, S, MB, 1.0 / math.sqrt(D), stream)
        _raise_on(lib, rc, "paged attention")
        paged_attention_update.launches += 1
    return out, cache


paged_attention_update.launches = 0
