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
