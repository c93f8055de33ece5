"""Port parity for Ulysses sequence parallelism (``sequence/layer.py``,
``LlamaConfig.sequence_parallel`` and the engine's ``seq`` axis) over gloo
gangs of 2 and 4 ranks, one rank a sequence slice.

The reference side is the JAX package on its virtual CPU mesh: its
``DistributedAttention`` under ``jit`` on a ``seq`` mesh of as many devices
(the sharding flips GSPMD lowers to all-to-alls), and its engine training
``LlamaConfig.tiny(sequence_parallel=True)`` on that mesh. Inputs are
numpy draws from fixed seeds, f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.sequence.layer import DistributedAttention as JDistributedAttention
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import to_flax_params
from tests import torch_parallel_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params
from tests.unit.sequence.test_ulysses import _attn as jattn

# the reference test's tolerance for the output; the gradients (two more
# products and the softmax's backward) to 1e-5 relative
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LR = 3e-3
STEPS = 2
# as tests/test_torch_zero.py (f32, summation order, Adam's sign flips)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def gangs():
    made = {2: Gang(2), 4: Gang(4)}
    yield made
    for g in made.values():
        g.close()


def _reference_attention(q, k, v, w, sp, causal):
    """The reference's DistributedAttention on a ``seq`` mesh of ``sp``
    CPU devices, under ``jit``: the output and the gradients of
    ``sum(out * w)``."""
    jgroups.initialize_mesh(sequence_parallel_size=sp, devices=jax.devices()[:sp], force=True)
    seq = NamedSharding(jgroups.get_mesh(), P(None, "seq", None, None))
    local = (lambda a, b, c: jllama.causal_attention(a, b, c, scale=q.shape[-1]**-0.5)) if causal else jattn
    dist_attn = JDistributedAttention(local)

    @jax.jit
    def f(q, k, v):
        q, k, v = (jax.lax.with_sharding_constraint(x, seq) for x in (q, k, v))
        return jnp.sum(dist_attn(q, k, v) * w), dist_attn(q, k, v)

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(*(jnp.asarray(x) for x in (q, k, v)))
    jgroups.destroy_mesh()
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("sp,kv_heads,causal", [(2, 8, False), (4, 8, False), (4, 2, True)],
                         ids=["sp2", "sp4", "sp4_kv2_gqa_repeat"])
def test_distributed_attention_matches_the_reference(gangs, sp, kv_heads, causal):
    """The reference's ``test_distributed_attention_matches_local`` shape
    (B 2, S 16, H 8, D 4) at sp 2 and 4, with the gradients of each rank's
    slice; and 2 KV heads over 4 ranks, which do not divide: the port
    repeats K/V to the 8 query heads (GSPMD pads the dimension), which is
    the same causal GQA attention."""
    B, S, H, D = 2, 16, 8, 4
    rng = np.random.default_rng(sp + kv_heads)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, kv_heads, D)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)
    want, (dq, dk, dv) = _reference_attention(q, k, v, w, sp, causal)
    res = gangs[sp].run(sc.ulysses_attention, q, k, v, w, causal)
    s = S // sp
    for r, got in enumerate(res):
        rows = slice(r * s, (r + 1) * s)
        np.testing.assert_allclose(got["out"], want[:, rows], **ATTN_TOL)
        for name, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(got[name], ref[:, rows], **GRAD_TOL, err_msg=name)


def _config(sp):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "sequence_parallel_size": sp,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": 1}}


def _batches(vocab, seq=32, seed=9):
    """Global batches with ``-100`` on a span inside the first half of the
    sequence only (sequence rank 0's slice at sp 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, size=(4, seq + 1))
        labels = ids[:, 1:].copy()
        labels[:, 2:seq // 2 - 1] = -100
        out.append((ids[:, :-1].astype(np.int32), labels.astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def trained():
    """The JAX engine with ``sequence_parallel`` on a ``seq`` mesh of 2
    devices (one run), and the port's inputs."""
    jcfg = jax_tiny(num_key_value_heads=2, sequence_parallel=True)
    jparams = jax_params(jcfg)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(sequence_parallel_size=2, devices=jax.devices()[:2], force=True)
    engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                               config=_config(2))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    jgroups.destroy_mesh()
    pcfg = port_config(jcfg)
    fields = {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__ if f != "dtype"}
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    return pcfg, fields, state, batches, losses, params


def test_train_batch_with_sequence_parallel_matches_the_reference_engine(gangs, trained):
    """``LlamaConfig.tiny(sequence_parallel=True)`` through the port's
    engine at sp 2 (each rank 16 of the 32 positions, the masked span in
    rank 0's half): the losses and the gathered masters after 2 steps equal
    the reference engine's on its ``seq`` mesh, on both ranks."""
    pcfg, fields, state, batches, want_losses, want_params = trained
    assert fields["sequence_parallel"]
    res = gangs[2].run(sc.train_llama, fields, state, _config(2), batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    for g, w in zip(got, want_params):
        diff = np.abs(g - w)
        assert np.mean(diff <= 0.01 * LR + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= STEPS * LR, diff.max()


def test_rope_at_local_positions_misses_the_reference(gangs, trained):
    """The control of RoPE's offset: rank 1 taking positions 0..15 for its
    slice (16..31 of the sequence) moves the loss off the reference's."""
    _, fields, state, batches, want_losses, _ = trained
    res = gangs[2].run(sc.train_llama, fields, state, _config(2), batches, True, True)
    assert not np.allclose(res[0]["losses"], want_losses, **LOSS_TOL)


def test_heads_that_do_not_divide_raise(gangs):
    """6 query heads over 4 sequence ranks: the all-to-all cannot split
    them, and the port raises rather than pad."""
    q = np.zeros((1, 8, 6, 4), np.float32)
    with pytest.raises(Exception, match="6 heads do not divide over 4"):
        gangs[4].run(sc.ulysses_attention, q, q, q, q)
