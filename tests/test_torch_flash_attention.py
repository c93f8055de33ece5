"""The port's flash attention against the JAX package's Pallas kernels.

JAX runs on the CPU with Pallas in interpret mode (as
tests/unit/ops/test_flash_attention.py runs it); ``jax.grad`` of its
``flash_attention`` runs the hand backward ``_flash_bwd_pallas`` interpreted.
The port runs its plain versions, which is what its wrappers do on CPU
tensors. Inputs come from numpy seeds; everything is f32 with the JAX
tests' tolerance (rtol = atol = 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    g = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, g


CASES = [
    # (B, S, H, KVH, D, causal)
    (2, 128, 2, 2, 16, True),
    (1, 96, 4, 2, 16, False),
    (1, 300, 4, 1, 16, True),
    (1, 128, 2, 2, 128, False),
    (1, 96, 4, 2, 128, True),
    # one past the kernels' 128-row tiles, and one short of two
    (1, 129, 4, 2, 16, True),
    (1, 129, 4, 1, 64, False),
    (1, 255, 4, 1, 16, False),
    (1, 255, 4, 2, 64, True),
]


@pytest.mark.parametrize("B,S,H,KVH,D,causal", CASES,
                         ids=[f"S{c[1]}_H{c[2]}_KVH{c[3]}_D{c[4]}_{'causal' if c[5] else 'full'}" for c in CASES])
def test_forward_and_grads_match_pallas(B, S, H, KVH, D, causal):
    q, k, v, g = _inputs(B, S, H, KVH, D, seed=S + D)
    scale = 1.0 / np.sqrt(D)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, scale, causal) * g)

    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal)
    jdq, jdk, jdv = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, scale, causal)
    (out * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, want in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_lse_matches_pallas_saved_lse():
    B, S, H, D = 1, 300, 2, 16
    q, k, v, _ = _inputs(B, S, H, H, D, seed=3)
    scale = 0.25
    _, jlse = jfa._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True, save_lse=True)
    _, lse = tfa.flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale,
                                           True)
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S), np.asarray(jlse)[..., 0], **TOL)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    B, S, H, KVH, D = 1, 70, 4, 2, 16
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(B, S, H, KVH, D, seed=5))
    counts = (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, 0.3, True)
    want_out, want_lse = tfa.flash_attention_fwd_plain(q, k, v, 0.3, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g, 0.3, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, 0.3, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].shape == (B, S, KVH, D)
    # the backward kernels' own wrappers take CUDA tensors only
    delta = tfa.attention_delta(g, out)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, 0.3, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, 0.3, True)
    assert counts == (tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd_dkv.launches,
                      tfa.flash_attention_bwd_dq.launches)


@pytest.mark.parametrize("D", [96, 80])
def test_padded_head_dim_matches_pallas(D):
    # the CUDA wrappers run a head_dim under 128 zero-padded to the kernels'
    # width: here the same padding goes around the plain versions, and the
    # sliced results are held to the Pallas kernels at the unpadded D
    B, S, H, KVH, causal = 1, 130, 4, 2, True
    q, k, v, g = _inputs(B, S, H, KVH, D, seed=D)
    scale = 1.0 / np.sqrt(D)  # the caller's, not the padded width's

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, scale, causal) * g)

    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout = jfa.flash_attention(jq, jk, jv, scale, causal)
    rep = lambda x: jnp.repeat(x, H // KVH, axis=2)  # the lse call takes one KV head per query head
    _, jlse = jfa._flash_fwd_pallas(jq, rep(jk), rep(jv), scale, causal, save_lse=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    qp, kp, vp, gp = tfa.pad_head_dim(*(torch.from_numpy(x) for x in (q, k, v, g)))
    assert qp.shape[-1] == tfa.kernel_head_dim(D) == 128 and not qp[..., D:].any()
    out, lse = tfa.flash_attention_fwd_plain(qp, kp, vp, scale, causal)
    grads = tfa.flash_attention_bwd_plain(qp, kp, vp, out, lse, gp, scale, causal)
    for x in (out, *grads):
        assert not x[..., D:].any()  # the padded columns of every output are zero
    np.testing.assert_allclose(out[..., :D].numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S), np.asarray(jlse)[..., 0], **TOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got[..., :D].numpy(), np.asarray(want), **TOL)


def test_kernel_head_dim():
    assert [tfa.kernel_head_dim(D) for D in (1, 16, 64, 65, 80, 96, 128)] == [64, 64, 64, 128, 128, 128, 128]
    with pytest.raises(ValueError, match="head_dim 160"):
        tfa.kernel_head_dim(160)
