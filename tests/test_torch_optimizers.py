"""Port parity for the optimizers: each of deepspeed_tpu_torch's optimizers
against its class in deepspeed_tpu, on the CPU.

Each optimizer runs ``init`` and 5 ``update``s on one random parameter tree
with 5 random gradient trees, through the JAX class and the port class, in
f32. The 1-bit optimizers freeze after step 2 (``freeze_step`` /
``var_freeze_step``), so steps 3-5 run their compressed phase, and 0/1
Adam's intervals double from the first refresh on, so its variance refresh
and local-step sync both run. Then two optimizers the engine drives
differently from Adam (Lamb's per-tensor trust ratio, 1-bit Adam's frozen
variance and compressed momentum) take 3 engine steps of a tiny Llama
against the JAX engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad as JAdagrad
from deepspeed_tpu.ops.adam.fused_adam import DeepSpeedCPUAdam as JCPUAdam, FusedAdam as JAdam
from deepspeed_tpu.ops.adam.onebit_adam import OnebitAdam as JOnebitAdam
from deepspeed_tpu.ops.adam.zero_one_adam import ZeroOneAdam as JZeroOneAdam
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb
from deepspeed_tpu.ops.lamb.onebit_lamb import OnebitLamb as JOnebitLamb
from deepspeed_tpu.ops.lion.fused_lion import FusedLion as JLion
from deepspeed_tpu.ops.sgd.sgd import SGD as JSGD
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models.convert import to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import DeepSpeedCPUAdam, FusedAdam
from deepspeed_tpu_torch.ops.adam.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.ops.adam.zero_one_adam import ZeroOneAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.lamb.onebit_lamb import OnebitLamb
from deepspeed_tpu_torch.ops.lion.fused_lion import FusedLion
from deepspeed_tpu_torch.ops.sgd.sgd import SGD
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

LR = 1e-2
# f32 on both sides, the same arithmetic in the same order; XLA may fuse a
# multiply-add and sums a norm or a mean in another order, so an entry may
# differ by a few ulps of the tensor's largest entry
REL_TOL = 1e-6

CASES = {
    "adamw": (JAdam, FusedAdam, dict(weight_decay=0.01)),
    "adam_l2": (JAdam, FusedAdam, dict(weight_decay=0.01, adam_w_mode=False)),
    "cpuadam": (JCPUAdam, DeepSpeedCPUAdam, dict(weight_decay=0.01)),
    "lamb": (JLamb, FusedLamb, dict(weight_decay=0.01)),
    "lamb_no_bias_correction": (JLamb, FusedLamb, dict(bias_correction=False, max_coeff=0.5)),
    "lion": (JLion, FusedLion, dict(weight_decay=0.1)),
    "adagrad": (JAdagrad, DeepSpeedCPUAdagrad, dict(weight_decay=0.01)),
    "sgd_nesterov": (JSGD, SGD, dict(momentum=0.9, weight_decay=0.01, nesterov=True)),
    "sgd": (JSGD, SGD, dict(weight_decay=0.01)),
    "onebitadam": (JOnebitAdam, OnebitAdam, dict(freeze_step=2, weight_decay=0.01)),
    "onebitlamb": (JOnebitLamb, OnebitLamb, dict(freeze_step=2, weight_decay=0.01)),
    "zerooneadam": (JZeroOneAdam, ZeroOneAdam, dict(var_freeze_step=2, weight_decay=0.01, var_update_scaler=1,
                                                    local_step_scaler=1)),
}

SHAPES = {"embed": (32, 16), "layer.weight": (16, 16), "layer.bias": (16, ), "norm": (16, ), "conv": (4, 4, 3)}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.max(np.abs(want))), np.finfo(np.float32).tiny) if want.size else 1.0
    err = float(np.max(np.abs(got.astype(np.float64) - want))) if want.size else 0.0
    assert err <= REL_TOL * scale, f"{what}: max err {err} against {REL_TOL} x {scale}"


def _state_leaves(state):
    """(field, name, value) of a NamedTuple state of scalars, dicts and Nones."""
    for field, value in state._asdict().items():
        if isinstance(value, dict):
            for name, t in value.items():
                yield f"{field}/{name}", t
        elif value is not None:
            yield field, value


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    jcls, tcls, kw = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    params["layer.bias"][:4] = 0.0  # zero entries: sign(0) and a zero norm where it matters
    grads = [{k: rng.normal(scale=0.1, size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(5)]
    jopt, topt = jcls(lr=LR, **kw), tcls(lr=LR, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert type(ts).__name__ == type(js).__name__ and ts._fields == js._fields
    for i, g in enumerate(grads):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(LR))
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, LR)
        for name in SHAPES:
            _close(tp[name].numpy(), jp[name], f"step {i + 1} {name}")
        jleaves = dict(_state_leaves(js))
        tleaves = dict(_state_leaves(ts))
        assert set(tleaves) == set(jleaves)
        for key, t in tleaves.items():
            _close(t.numpy(), jleaves[key], f"step {i + 1} state {key}")


def test_sgd_without_momentum_keeps_no_buffer():
    state = SGD(lr=LR).init({"w": torch.zeros(3)})
    assert state.momentum_buf is None


# ------------------------------------------------------ against the JAX engine --
def _batch(vocab, n, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(n, S + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.mark.parametrize("optimizer", [{"type": "Lamb", "params": {"lr": 3e-3, "weight_decay": 0.01}},
                                       {"type": "OnebitAdam", "params": {"lr": 3e-3, "freeze_step": 2}}],
                         ids=["lamb", "onebitadam"])
def test_engine_matches_jax_engine(optimizer):
    """3 train_batch steps of a tiny Llama in f32 through both engines."""
    jcfg = jax_tiny(num_key_value_heads=2, use_flash_attention=False)
    jparams = jax_params(jcfg)
    gas, micro, steps = 2, 2, 3
    batches = [_batch(jcfg.vocab_size, gas * micro, 16, seed=20 + i) for i in range(steps)]
    config = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
              "optimizer": optimizer, "zero_optimization": {"stage": 2}}

    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                config=config)
    jlosses = [float(jengine.train_batch(batch=b)) for b in batches]
    pcfg = port_config(jcfg)
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(pcfg),
                                                       model_parameters=port_params(jcfg, jparams), config=config,
                                                       device="cpu")
    assert type(opt).__name__ == type(jengine.optimizer).__name__
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    # f32 on both sides: the losses agree to the matmuls' summation order
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=2e-5)
    assert engine.get_global_grad_norm() == pytest.approx(jengine.get_global_grad_norm(), rel=1e-4)
    got = jax.tree.leaves(to_flax_params(engine.params, pcfg))
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jengine.params))]
    lr = optimizer["params"]["lr"]
    # as test_torch_training's AdamW case: an Adam-like update divides by
    # sqrt(v) ~ |g|, so a weight whose gradient is near zero carries that
    # gradient's relative error times one lr step; Lamb scales each tensor's
    # step by its trust ratio (at most max_coeff = 10). 1-bit Adam's step 3
    # is compressed: an entry whose error-compensated momentum is within
    # rounding of 0 may take the other sign, and then moves by twice the
    # tensor's mean |momentum| over its own sqrt(v); at most 0.1% of a
    # tensor's entries may do so
    flips = 1e-3 if optimizer["type"] == "OnebitAdam" else 0.0
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g))
        off = ~np.isclose(g, w, rtol=1e-4, atol=0.1 * lr)
        assert off.mean() <= flips, (off.sum(), np.abs(g - w).max())
    jengine.destroy()
