"""Port parity for training: LlamaForCausalLM and the engine of
deepspeed_tpu_torch against deepspeed_tpu's, on the CPU.

Both sides get the same weights (the JAX init through from_flax_params) and
the same token batches from numpy seeds. JAX runs its Pallas flash kernels in
interpret mode; the port runs the kernels' plain versions (its wrappers do on
CPU tensors). The JAX engine is built on a one-device mesh, so its
data-parallel size (and hence its batch) is the port's. The remaining cases
mirror tests/unit/runtime/test_engine.py on the port alone, with a small MLP.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models.convert import to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, cross_entropy_loss
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import dynamic_loss_scale_state, update_scale
from deepspeed_tpu_torch.utils.groups import TopologyError
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

# f32 on both sides; XLA's and torch's CPU matmuls sum in different orders
# (~1e-6 relative per op) through two layers, the unembedding and the softmax
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch(vocab, B, S, seed, ignore=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, S + 1))
    labels = ids[:, 1:].copy()
    labels[:, :ignore] = -100
    return ids[:, :-1].astype(np.int32), labels.astype(np.int32)


def _jax_cfg(kvh, flash, policy):
    return jax_tiny(num_key_value_heads=kvh, use_flash_attention=flash, remat=policy is not None,
                    remat_policy=policy or "nothing")


@pytest.mark.parametrize("policy", [None, "nothing", "dots"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_causal_lm_loss_and_grads_match_jax(kvh, flash, policy):
    jcfg = _jax_cfg(kvh, flash, policy)
    jparams = jax_params(jcfg)
    ids, labels = _batch(jcfg.vocab_size, 2, 24, seed=kvh, ignore=3)
    jloss_fn = lambda p: jllama.LlamaForCausalLM(jcfg).apply({"params": p}, (ids, labels))
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams)  # one compile, not an op at a time

    model = LlamaForCausalLM(port_config(jcfg))
    model.load_state_dict(port_params(jcfg, jparams))
    loss = model((torch.from_numpy(ids), torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    got = to_flax_params({n: p.grad for n, p in model.named_parameters()}, port_config(jcfg))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=jax.tree_util.keystr(path), **GRAD_TOL)


def test_cross_entropy_ignores_labels_and_is_zero_when_all_are_ignored():
    logits = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, -100, 3, 4, -100], [-100, 0, 6, 2, 5]])
    want = jllama.cross_entropy_loss(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(cross_entropy_loss(logits, labels).item(), float(want), rtol=1e-6)
    assert cross_entropy_loss(logits, torch.full_like(labels, -100)).item() == 0.0


def test_dots_policy_saves_the_projections_and_recomputes_attention(monkeypatch):
    """Under "dots" the backward reruns no matrix product of the forward but
    does rerun the flash forward, as jax's dots_with_no_batch_dims_saveable
    does; under "nothing" it reruns both."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = {"fwd": 0}
    plain = fa.flash_attention_fwd_plain

    def counting(*args):
        calls["fwd"] += 1
        return plain(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", counting)

    class CountMM(TorchDispatchMode):

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    jcfg = _jax_cfg(2, True, None)
    ids, labels = (torch.from_numpy(x) for x in _batch(jcfg.vocab_size, 2, 16, seed=0))
    counts = {}
    for policy in (None, "nothing", "dots"):
        cfg = dataclasses.replace(port_config(jcfg), remat=policy is not None, remat_policy=policy or "nothing")
        model = LlamaForCausalLM(cfg)
        calls["fwd"] = 0
        loss = model((ids, labels))
        fwd_calls = calls["fwd"]
        with CountMM() as mm:
            loss.backward()
        counts[policy] = (fwd_calls, calls["fwd"] - fwd_calls, mm.n)
    layers = jcfg.num_hidden_layers
    assert counts[None][:2] == (layers, 0)
    assert counts["nothing"][:2] == (layers, layers) and counts["dots"][:2] == (layers, layers)
    # "nothing" reruns 6 of the 7 projections of each block: no backward
    # formula reads down_proj's output, so the non-reentrant recompute stops
    # before it; "dots" reruns none
    assert counts["nothing"][2] == counts[None][2] + 6 * layers
    assert counts["dots"][2] == counts[None][2]


LR = 3e-3


def _ds_config(gas, micro, bf16=False, clip=1.0):
    cfg = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "gradient_clipping": clip,
        "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": LR,
                                                       "warmup_num_steps": 3, "warmup_type": "linear"}},
        "zero_optimization": {"stage": 3},
    }
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _engines_side_by_side(bf16, flash):
    jcfg = _jax_cfg(2, flash, "dots" if flash else None)
    jparams = jax_params(jcfg)
    gas, micro, steps = 2, 2, 3
    batches = [_batch(jcfg.vocab_size, gas * micro, 16, seed=10 + i, ignore=1) for i in range(steps)]
    config = _ds_config(gas, micro, bf16=bf16)

    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jcfg_run = dataclasses.replace(jcfg, dtype=jnp.bfloat16) if bf16 else jcfg
    jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg_run), model_parameters=jparams,
                                                config=config)
    jlosses = [float(jengine.train_batch(batch=b)) for b in batches]

    pcfg = port_config(jcfg)
    pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16) if bf16 else pcfg
    engine, _, _, sched = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(pcfg),
                                                         model_parameters=port_params(jcfg, jparams),
                                                         config=config, device="cpu")
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    assert engine.global_steps == steps and sched.last_batch_iteration == steps
    assert engine.get_lr() == pytest.approx(jengine.get_lr())
    got = jax.tree.leaves(to_flax_params(engine.params, pcfg))
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jengine.params))]
    init = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    return losses, jlosses, got, want, init, engine, jengine


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash_dots"])
def test_engine_matches_jax_engine_f32(flash):
    losses, jlosses, got, want, init, engine, jengine = _engines_side_by_side(bf16=False, flash=flash)
    # f32 on both sides: the losses agree to summation order. Adam divides
    # by sqrt(v) ~ |g|, so a parameter's update carries the relative error of
    # its gradient, times lr, into the weights: where a gradient is near zero
    # that error is large, so a weight may differ by up to 1% of one lr step
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=2e-5)
    assert engine.get_global_grad_norm() == pytest.approx(jengine.get_global_grad_norm(), rel=1e-4)
    for g, w, p0 in zip(got, want, init):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0.01 * LR)
        assert not np.array_equal(g, p0)


def test_engine_matches_jax_engine_bf16():
    losses, jlosses, got, want, init, _, _ = _engines_side_by_side(bf16=True, flash=False)
    # bf16 compute (8 significant bits) over f32 masters on both sides; the
    # two frameworks round at other places, so losses agree to ~1e-2
    # relative. Each weight moves at most about one lr per Adam step; 99% of
    # each tensor's weights agree to a third of an lr step, and the rest
    # (gradients near zero, whose sign the rounding may flip) within 3 lr
    np.testing.assert_allclose(losses, jlosses, rtol=1e-2)
    for g, w, p0 in zip(got, want, init):
        diff = np.abs(g - w)
        assert np.mean(diff <= LR / 3) >= 0.99 and diff.max() <= 3 * LR, diff.max()


# --------------------------------------------------------- port-only mirrors --
HIDDEN = 16


class SimpleModel(torch.nn.Module):
    """tests/unit/simple_model.py's MLP regression: two Dense+ReLU, a Dense to 1, MSE."""

    def __init__(self, hidden=HIDDEN, nlayers=2, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.layers = torch.nn.ModuleList(torch.nn.Linear(hidden, hidden) for _ in range(nlayers))
        self.head = torch.nn.Linear(hidden, 1)

    def forward(self, batch):
        x, y = batch
        x = x.to(self.head.weight.dtype)  # the engine runs the module in its compute dtype
        for layer in self.layers:
            x = torch.relu(layer(x))
        return ((self.head(x).squeeze(-1) - y)**2).mean()


def _random_batches(n, batch_size, seed=123):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(HIDDEN, )).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch_size, HIDDEN)).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


def _engine(micro=8, gas=1, extra=None, stage=0):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 0.01, "weight_decay": 0.0}},
           "zero_optimization": {"stage": stage}}
    cfg.update(extra or {})
    return deepspeed_tpu_torch.initialize(model=SimpleModel(), config=cfg, device="cpu")


def test_train_batch_fast_path_matches_micro_loop():
    """Mirror of test_engine.py:120, with GAS 2."""
    batches = _random_batches(3, 16)
    e1, _, _, _ = _engine(micro=8, gas=2, stage=2)
    for b in batches:
        e1.train_batch(batch=b)
    e2, _, _, _ = _engine(micro=8, gas=2, stage=2)
    for x, y in batches:
        for half in range(2):
            sl = slice(half * 8, (half + 1) * 8)
            e2.backward(e2.forward((x[sl], y[sl])))
            e2.step()
    assert e1.global_steps == e2.global_steps == 3
    for name in e1.params:
        torch.testing.assert_close(e1.params[name], e2.params[name], rtol=1e-6, atol=1e-7)


def test_fp16_dynamic_loss_scale_skips_on_overflow():
    """Mirror of test_engine.py:157."""
    engine, _, _, _ = _engine(extra={"fp16": {"enabled": True, "initial_scale_power": 4, "hysteresis": 2}})
    scale0 = engine.loss_scale
    assert scale0 == 2.0**4
    before = {k: v.clone() for k, v in engine.params.items()}
    x = np.full((8, HIDDEN), 1e30, dtype=np.float32)  # overflows in fp16 compute
    y = np.ones((8, ), dtype=np.float32)
    engine.backward(engine.forward((x, y)))
    engine.step()
    assert engine.get_skipped_steps() == 1 and engine.loss_scale == scale0  # hysteresis consumed
    assert not engine.was_step_applied()
    assert all(torch.equal(before[k], v) for k, v in engine.params.items())
    engine.backward(engine.forward((x, y)))
    engine.step()
    assert engine.get_skipped_steps() == 2 and engine.loss_scale == scale0 / 2.0
    bx = np.random.default_rng(0).normal(size=(8, HIDDEN)).astype(np.float32)
    engine.backward(engine.forward((bx, y)))
    engine.step()
    assert engine.get_skipped_steps() == 2 and engine.was_step_applied()


def test_gradient_clipping_applied():
    """Mirror of test_engine.py:193: the reported norm is the pre-clip norm,
    and the applied gradient is clipped (Adam's first moment after one step
    is (1 - beta1) times the clipped gradient)."""
    clip = 1e-4
    engine, _, _, _ = _engine(extra={"gradient_clipping": clip})
    engine.backward(engine.forward(_random_batches(1, 8)[0]))
    engine.step()
    assert engine.get_global_grad_norm() > clip
    m = engine.opt_state.exp_avg
    m_norm = float(torch.sqrt(sum((t.double()**2).sum() for t in m.values())))
    assert m_norm == pytest.approx((1 - 0.9) * clip, rel=1e-3)


def test_lr_scheduler_integration():
    """Mirror of test_engine.py:274."""
    engine, _, _, sched = _engine(extra={"scheduler": {"type": "WarmupLR", "params": {
        "warmup_max_lr": 0.1, "warmup_num_steps": 5, "warmup_type": "linear"}}})
    assert sched is not None
    lrs = []
    for b in _random_batches(6, 8):
        engine.train_batch(batch=b)
        lrs.append(engine.get_lr()[0])
    assert lrs[-1] == pytest.approx(0.1)


def test_fp16_overflow_does_not_advance_lr_schedule():
    """Mirror of test_engine.py:291."""
    engine, _, _, sched = _engine(extra={
        "fp16": {"enabled": True, "initial_scale_power": 4, "hysteresis": 1},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 0.01,
                                                     "warmup_num_steps": 10}}})
    it0 = sched.last_batch_iteration
    x = np.full((8, HIDDEN), 1e30, dtype=np.float32)
    y = np.ones((8, ), dtype=np.float32)
    engine.backward(engine.forward((x, y)))
    engine.step()
    assert engine.get_skipped_steps() == 1 and sched.last_batch_iteration == it0
    bx = np.random.default_rng(0).normal(size=(8, HIDDEN)).astype(np.float32)
    engine.backward(engine.forward((bx, y)))
    engine.step()
    assert sched.last_batch_iteration == it0 + 1


def test_eval_forward_deterministic_no_grads():
    """Mirror of test_engine.py:319."""
    engine, _, _, _ = _engine()
    bx = np.random.default_rng(0).normal(size=(8, HIDDEN)).astype(np.float32)
    y = np.ones((8, ), dtype=np.float32)
    engine.eval()
    l1, l2 = float(engine.forward((bx, y))), float(engine.forward((bx, y)))
    assert l1 == l2 and engine._cached_loss is None
    engine.train()
    l3 = engine.forward((bx, y))
    assert l3.requires_grad
    engine.backward(l3)
    engine.step()
    assert engine.global_steps == 1


def test_loss_scale_update_matches_jax():
    from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
    kw = dict(scale_window=3, min_scale=1.0, delayed_shift=2)
    js, ts = jls.dynamic_loss_scale_state(5, delayed_shift=2), dynamic_loss_scale_state(5, delayed_shift=2)
    for overflow in (True, False, True, True, False, False, False, False, True):
        js = jls.update_scale(js, jnp.asarray(overflow), **kw)
        ts = update_scale(ts, torch.tensor(overflow), **kw)
        assert (float(ts.cur_scale), int(ts.good_steps), int(ts.hysteresis)) == \
            (float(js.cur_scale), int(js.good_steps), int(js.hysteresis))


def test_batch_triangle_and_config_errors():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
    cfg = DeepSpeedConfig({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4})
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu, cfg.gradient_accumulation_steps) == (32, 4, 8)
    cfg = DeepSpeedConfig({"train_batch_size": 32, "gradient_accumulation_steps": 2})
    assert cfg.train_micro_batch_size_per_gpu == 16
    with pytest.raises(DeepSpeedConfigError, match="bf16 and fp16"):
        DeepSpeedConfig({"train_batch_size": 8, "bf16": {"enabled": True}, "fp16": {"enabled": True}})
    with pytest.raises(AssertionError, match="batch"):
        DeepSpeedConfig({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 2})
    cfg = DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 0, "offload_optimizer": {"device": "cpu"}}})
    assert cfg.zero_config.param_persistence_threshold == 0 and cfg.zero_config.overlap_comm
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config=cfg._param_dict, device="cpu")
    try:
        assert engine.zero_cpu_offload() and not engine.zero_has_nvme_offload()
        assert engine.zero_partial_offload() == 1.0
    finally:
        engine.destroy()
    with pytest.raises(ValueError, match="ratio"):
        DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {"offload_optimizer": {"device": "cpu",
                                                                                           "ratio": 1.5}}})


@pytest.mark.parametrize("key,value,error", [
    ("tensor_parallel_size", 2, TopologyError),
    # the id it had while a plain module's pipe size raised NotImplementedError
    pytest.param("pipeline_parallel_size", 2, TopologyError, id="pipeline_parallel_size-2-NotImplementedError"),
    ("zero_optimization", {"stage": 2, "zero_quantized_weights": True}, ValueError),
    ("sequence_parallel_size", 2, TopologyError),
    ("optimizer", {"type": "NoSuchOptimizer", "params": {"lr": 0.1}}, ValueError),
    ("expert_parallel_size", 2, TopologyError)])
def test_unported_features_raise(key, value, error):
    """Nothing of these is left unported: an unknown optimizer raises the
    reference's ValueError, and so does a ZeRO stage the quantized-weight
    knobs cannot serve. Sequence, tensor, expert and pipe ranks (a plain
    module is replicated over the pipe ranks) are ported: in a world of one
    rank their axis of 2 cannot be laid out, and the rank mesh raises its
    TopologyError (their runs across ranks:
    tests/test_torch_{ulysses,tp,moe_train_ep,pipe_composed}.py)."""
    match = {ValueError: "Unknown optimizer|qwZ|stage 3",
             TopologyError: "not divisible by mp\\*pp\\*ep\\*sp = 2"}[error]
    with pytest.raises(error, match=match):
        deepspeed_tpu_torch.initialize(model=SimpleModel(), config={"train_batch_size": 8, key: value},
                                       device="cpu")


@pytest.mark.parametrize("key,value,built", [
    ("progressive_layer_drop", {"enabled": True, "theta": 0.5, "gamma": 0.001}, "progressive_layer_drop"),
    ("eigenvalue", {"enabled": True, "max_iter": 10}, "eigenvalue"),
    ("curriculum_learning", {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
                             "max_difficulty": 16, "schedule_type": "fixed_linear",
                             "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}},
     "curriculum_scheduler"),
    ("compression_training", {"weight_quantization": {"shared_parameters": {"enabled": True},
                                                      "different_groups": {"g": {"modules": ["*"]}}}},
     "compression_scheduler"),
    ("telemetry", {"enabled": True}, "_telemetry")])
def test_ported_training_features_initialize(key, value, built):
    """The five blocks of ROADMAP A7's second half build their part of the
    engine instead of raising."""
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config={"train_batch_size": 8, key: value},
                                                     device="cpu")
    try:
        assert getattr(engine, built) is not None
    finally:
        engine.destroy()


def test_activation_checkpointing_api():
    checkpointing.reset()
    assert not checkpointing.is_configured()
    checkpointing.configure(deepspeed_config={"train_batch_size": 1,
                                              "activation_checkpointing": {"partition_activations": True}})
    assert checkpointing.is_configured() and checkpointing._policy() == "dots"
    layer = torch.nn.Linear(4, 4)
    x = torch.randn(3, 4, requires_grad=True)
    checkpointing.checkpoint(lambda t: torch.tanh(layer(t)), x).sum().backward()
    want = torch.autograd.grad(torch.tanh(layer(x)).sum(), x)[0]
    torch.testing.assert_close(x.grad, want)
    checkpointing.reset()
    assert checkpointing._policy() == "nothing"


def test_dataloader_and_repeating_loader():
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    data = [(np.full((HIDDEN, ), i, np.float32), np.float32(i)) for i in range(20)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(), training_data=data, device="cpu",
        config={"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 0.01}}})
    assert len(loader) == 2 and engine.optimizer.adam_w_mode
    it = RepeatingLoader(loader)
    for _ in range(3):
        assert np.isfinite(float(engine.train_batch(data_iter=it)))
    assert engine.global_steps == 3 and engine.micro_steps == 6
