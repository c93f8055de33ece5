"""Flash attention, forward and backward, over ``[B, S, H, D]``.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``: ``flash_attention(q,
k, v, scale, causal)`` is differentiable; k and v may have fewer heads (GQA:
query head ``h`` reads KV head ``h // (H // KVH)``). Its forward saves
``(q, k, v, out, lse)``; its backward computes ``delta = rowsum(dO * out)``
in f32 with a torch op (the JAX package computes it in XLA, outside its
kernels) and then runs the dK/dV and dQ kernels over the saved lse.

- On CUDA tensors the three wrappers launch the hand-written kernels of
  ``csrc/flash_attention.cu`` (replacing the Pallas kernels ``_fwd_kernel``,
  ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``) on the current stream, or
  raise; there is no fallback. All three copy tiles by TMA and multiply
  with wgmma. They are built for head_dim 64 and 128; a smaller head_dim
  runs zero-padded to the next of the two (:func:`pad_head_dim`), which
  changes no product and no softmax, and its outputs are sliced back.
- On CPU tensors :func:`flash_attention_fwd` and :func:`flash_attention_bwd`,
  which the autograd Function calls, run the plain versions
  :func:`flash_attention_fwd_plain` (the blockwise online softmax of
  ``_blockwise_attention_ref``) and :func:`flash_attention_bwd_plain`
  (``_flash_bwd_manual`` over the saved lse). The dK/dV and dQ wrappers take
  CUDA tensors only.

``lse`` is f32 ``[B, H, S]``; ``out`` and the gradients keep their inputs'
dtypes (dq in q's, dk and dv in k's). Each wrapper counts its kernel launches
in ``.launches``.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from deepspeed_tpu_torch.ops import builder

NEG_INF = -1e30
PLAIN_BLOCK = 256  # KV positions per step of the plain versions
_DTYPE_CODE = {torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128)


def kernel_head_dim(D: int) -> int:
    """The width the kernels run head_dim ``D`` at: the smallest of
    ``HEAD_DIMS`` that holds it. Raises past the largest."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"head_dim {D} over {HEAD_DIMS[-1]}: the kernels are built for head_dim {HEAD_DIMS}")


def pad_head_dim(*tensors):
    """The tensors with their last (head) dim zero-padded to
    :func:`kernel_head_dim`: a zero column of q and k adds nothing to a
    score, of v or dO nothing to an output, and the padded columns of every
    output are zero. The caller slices outputs back with ``[..., :D]`` and
    keeps its own ``scale``."""
    D = tensors[0].shape[-1]
    width = kernel_head_dim(D)
    return tuple(torch.nn.functional.pad(t, (0, width - D)) for t in tensors)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected [B, S, H, D] tensors; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if tuple(k.shape) != (B, S, KVH, D) or tuple(v.shape) != tuple(k.shape) or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)} / v {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must lie on one device")
    return B, S, H, KVH, D


def _expand(x, H):
    """Repeat KV heads so head h of the result is KV head h // rep."""
    return x if x.shape[2] == H else x.repeat_interleave(H // x.shape[2], dim=2)


def _fold(dx, KVH):
    """Sum the gradients of the repeated heads back onto their KV head (f32)."""
    B, S, H, D = dx.shape
    return dx if H == KVH else dx.reshape(B, S, KVH, H // KVH, D).sum(dim=3)


def _logits(qf, kf, start, stop, scale, causal):
    """``[B, H, S, stop - start]`` f32 scores of KV positions start..stop-1."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, start:stop]) * scale
    if causal:
        S = qf.shape[1]
        q_pos = torch.arange(S, device=qf.device)[:, None]
        k_pos = torch.arange(start, stop, device=qf.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, scale, causal):
    """The forward kernel's function in torch ops, f32 throughout: an online
    softmax over KV blocks of ``PLAIN_BLOCK`` positions. Returns ``(out in
    q's dtype, lse f32 [B, H, S])``."""
    B, S, H, KVH, D = _check(q, k, v)
    qf, kf, vf = q.float(), _expand(k, H).float(), _expand(v, H).float()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for start in range(0, S, PLAIN_BLOCK):
        stop = min(start + PLAIN_BLOCK, S)
        s = _logits(qf, kf, start, stop, scale, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf[:, start:stop])
        m = m_new
    l = l.clamp(min=1e-30)
    out = (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return out, m + torch.log(l)


def attention_delta(dout, out):
    """``rowsum(dO * out)`` in f32, ``[B, H, S]``."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal):
    """The backward kernels' function in torch ops, f32 throughout, over the
    forward's ``lse``: returns ``(dq, dk, dv)``."""
    B, S, H, KVH, D = _check(q, k, v)
    delta = attention_delta(dout, out)
    qf, kf, vf = q.float(), _expand(k, H).float(), _expand(v, H).float()
    gf = dout.to(q.dtype).float()
    dq = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, S, PLAIN_BLOCK):
        stop = min(start + PLAIN_BLOCK, S)
        s = _logits(qf, kf, start, stop, scale, causal)
        p = torch.exp(s - lse[..., None])  # masked: exp(NEG_INF - lse) = 0
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf))
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf[:, start:stop])
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf[:, start:stop])
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    dk = _fold(torch.cat(dks, dim=1), KVH)
    dv = _fold(torch.cat(dvs, dim=1), KVH)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = builder.load("flash_attention")
    if not getattr(lib, "_dstt_typed", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i32] * 5 + [f32, i32, vp]  # B, S, H, KVH, D, scale, causal, stream
        lib.dstt_flash_fwd.argtypes = [vp] * 5 + [i32] + shape
        lib.dstt_flash_fwd.restype = i32
        lib.dstt_flash_bwd_dkv.argtypes = [vp] * 8 + [i32] + shape
        lib.dstt_flash_bwd_dkv.restype = i32
        lib.dstt_flash_bwd_dq.argtypes = [vp] * 7 + [i32] + shape
        lib.dstt_flash_bwd_dq.restype = i32
        lib.dstt_flash_error_string.argtypes = [i32]
        lib.dstt_flash_error_string.restype = ctypes.c_char_p
        lib._dstt_typed = True
    return lib


def _cuda_args(what, q, k, v, *rest, lse=None, delta=None):
    """Check what the kernels take; return the shape arguments."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got tensors on {q.device}")
    B, S, H, KVH, D = _check(q, k, v)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in (k, v, *rest)):
        raise TypeError(f"{what}: q, k, v{' and dout' if rest else ''} must share one of "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel_head_dim(D)  # raises past the widest kernel
    for name, t in (("q", q), ("k", k), ("v", v), *((("dout", t) for t in rest))):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA and the kernels' 16-byte loads need it)")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [B, H, S] = {(B, H, S)}")
    return B, S, H, KVH, D


def _launch(lib, fn, what, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dstt_flash_error_string(rc).decode()} (code {rc})")


def flash_attention_fwd(q, k, v, scale, causal):
    """Forward kernel (B2): ``(out [B, S, H, D] in q's dtype, lse f32 [B, H, S])``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale, causal)
    B, S, H, KVH, D = _cuda_args("flash_attention_fwd", q, k, v)
    if D not in HEAD_DIMS:
        out, lse = flash_attention_fwd(*pad_head_dim(q, k, v), scale, causal)
        return out[..., :D].contiguous(), lse
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return out, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(lib, lib.dstt_flash_fwd, "flash attention forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, KVH, D, float(scale), int(causal),
                stream)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal):
    """dK/dV kernel (B3), CUDA tensors only: ``(dk, dv)`` in k's dtype,
    summed over the query heads that share each KV head."""
    B, S, H, KVH, D = _cuda_args("flash_attention_bwd_dkv", q, k, v, dout, lse=lse, delta=delta)
    if D not in HEAD_DIMS:
        dk, dv = flash_attention_bwd_dkv(*pad_head_dim(q, k, v, dout), lse, delta, scale, causal)
        return dk[..., :D].contiguous(), dv[..., :D].contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if S == 0 or B == 0:
        return dk, dv
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(lib, lib.dstt_flash_bwd_dkv, "flash attention dK/dV", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _DTYPE_CODE[q.dtype], B, S, H, KVH, D, float(scale), int(causal), stream)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal):
    """dQ kernel (B4), CUDA tensors only: dq in q's dtype."""
    B, S, H, KVH, D = _cuda_args("flash_attention_bwd_dq", q, k, v, dout, lse=lse, delta=delta)
    if D not in HEAD_DIMS:
        return flash_attention_bwd_dq(*pad_head_dim(q, k, v, dout), lse, delta, scale, causal)[..., :D].contiguous()
    dq = torch.empty_like(q)
    if S == 0 or B == 0:
        return dq
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(lib, lib.dstt_flash_bwd_dq, "flash attention dQ", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H,
                KVH, D, float(scale), int(causal), stream)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, scale, causal):
    """``(dq, dk, dv)``: the plain backward on the CPU; on CUDA, delta in a
    torch op, then the dK/dV kernel and the dQ kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal)
    dout = dout.to(q.dtype).contiguous()
    delta = attention_delta(dout, out)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    return flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, causal), dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels' outputs carry no autograd history, so a derivative of the
    backward would drop the attention's second-order terms without a word:
    the backward is ``once_differentiable``, and a second derivative raises,
    as the JAX package's ``custom_vjp`` does under ``jax.jvp``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale=1.0, causal=True):
    """Differentiable flash attention over ``[B, S, H, D]`` (see module doc)."""
    return _FlashAttention.apply(q, k, v, scale, causal)
