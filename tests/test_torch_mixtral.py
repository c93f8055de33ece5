"""Port parity for ``models/mixtral.py`` (Mixtral's causal LM): the loss and
its gradients, the flax ↔ torch converter, and ``train_batch`` at world 1
against the JAX package's engine, at ``MixtralConfig.tiny`` in f32; and the
same training on two data ranks (a gloo gang of 2, ``tests/torch_gang.py``),
whose gate is global over both ranks' tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import expert_slice, mixtral_from_flax, mixtral_to_flax
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, init_params, param_shapes
from tests import torch_parallel_scenarios as psc
from tests.torch_gang import Gang
from tests.torch_port_helpers import to_numpy_tree

LR = 3e-3
# f32 on both sides: the loss to summation order; gradients through the
# gate's softmax, two attention layers and the experts to ~1e-5 relative
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32)
    _, jparams = jmixtral.init_params(jcfg)
    return jcfg, to_numpy_tree(jparams)


def _cfg(**kw):
    return MixtralConfig.tiny(dtype=torch.float32, **kw)


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, :2] = -100
    return ids, labels


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    """The reference's loss and gradients on the grad cases' batch, once
    (both cases hold the port to the same ones), compiled whole."""
    jcfg, jparams = setup
    ids, labels = _batch(jcfg.vocab_size, 2, 16, seed=1)
    jmodel = jmixtral.MixtralForCausalLM(jcfg)
    return ids, labels, jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, (jnp.asarray(ids), jnp.asarray(labels)))))(jparams)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_gradients_match_jax_grad(setup, jax_loss_and_grads, remat):
    """CE + 0.01 × Σ l_aux and its gradient with respect to every parameter
    (the routers through the aux loss and the combine weights), with and
    without the port's per-block recomputation (the reference's tiny config
    has none)."""
    jcfg, jparams = setup
    ids, labels, (jloss, jgrads) = jax_loss_and_grads
    cfg = _cfg(remat=remat)
    model = MixtralForCausalLM(cfg)
    model.load_state_dict(mixtral_from_flax(jparams, cfg))
    loss = model((torch.from_numpy(ids).long(), torch.from_numpy(labels).long()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    grads = mixtral_to_flax({n: p.grad for n, p in model.named_parameters()}, cfg)
    want = to_numpy_tree(jgrads)
    assert jax.tree.structure(grads) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=jax.tree_util.keystr(path))


def test_converter_round_trips_bitwise_and_slices_experts(setup):
    """flax → torch → flax is the same tree bit for bit; ``expert_slice``
    keeps a rank's experts and everything else, and refuses experts that do
    not divide over the ranks; a tree of another shape is refused."""
    jcfg, jparams = setup
    cfg = _cfg()
    state = mixtral_from_flax(jparams, cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == param_shapes(cfg)
    back = mixtral_to_flax(state, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == np.float32 and np.array_equal(a.view(np.uint32), np.asarray(b).view(np.uint32))
    part = expert_slice(state, rank=1, ep=2)
    assert set(part) == set(state)
    for name, t in part.items():
        if name.endswith(("experts.wi", "experts.wo")):
            assert torch.equal(t, state[name][2:4])
        else:
            assert t is state[name]
    with pytest.raises(ValueError, match="do not divide"):
        expert_slice(state, rank=0, ep=3)
    with pytest.raises(ValueError, match="does not fit|shape"):
        mixtral_from_flax(jparams, _cfg(num_local_experts=2))


def test_init_params_slices_draw_the_whole_models_experts():
    """A rank's ``init_params(experts=...)`` holds exactly its slice of the
    weights the whole model draws from the same seed."""
    cfg = _cfg(num_hidden_layers=1)
    whole = init_params(cfg, device="cpu")
    part = init_params(cfg, device="cpu", experts=(2, 4))
    assert set(part) == set(whole)
    for name, t in part.items():
        want = whole[name][2:4] if name.endswith(("experts.wi", "experts.wo")) else whole[name]
        assert torch.equal(t, want), name


def _ds_config():
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": LR,
                                                       "warmup_num_steps": 3, "warmup_type": "linear"}},
        "zero_optimization": {"stage": 3},
    }


class _NoGatingRng:
    """The reference model behind a duck-typed ``apply``: the JAX engine
    hands it no ``gating`` rng, so its MoE layers train without noise."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, batch):
        return self.module.apply(variables, batch)


def _port_engine(jparams, noise):
    """The port's engine; without ``noise`` its gates get no seeds (none is
    handed to the reference model behind ``_NoGatingRng`` either)."""
    cfg = _cfg()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=MixtralForCausalLM(cfg),
                                                     model_parameters=mixtral_from_flax(jparams, cfg),
                                                     config=_ds_config(), device="cpu")
    if not noise:
        engine._seed_gates = lambda: None
    return engine, cfg


def _train(engine, batches):
    return [float(engine.train_batch(batch=tuple(torch.from_numpy(x).long() for x in b))) for b in batches]


def test_train_batch_matches_the_jax_engine_at_world_1(setup):
    """Three ``train_batch`` steps (GAS 2, ZeRO 3, AdamW) from the same
    weights, the gates' noise off on both sides (C16): the losses to
    summation order, and the masters as ``tests/test_torch_training.py``
    holds a Llama's (99.5% of each tensor within 1% of an lr step, every one
    within 3 lr)."""
    jcfg, jparams = setup
    batches = [_batch(jcfg.vocab_size, 4, 16, seed=10 + i) for i in range(3)]
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=_NoGatingRng(jmixtral.MixtralForCausalLM(jcfg)),
                                                model_parameters=jparams, config=_ds_config())
    jlosses = [float(jengine.train_batch(batch=b)) for b in batches]
    engine, cfg = _port_engine(jparams, noise=False)
    losses = _train(engine, batches)
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    got = jax.tree.leaves(mixtral_to_flax(engine.params, cfg))
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jengine.params))]
    for g, w, p0 in zip(got, want, jax.tree.leaves(jparams)):
        diff = np.abs(g - w)
        assert np.mean(diff <= 0.01 * LR + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= 3 * LR, diff.max()
        assert not np.array_equal(g, p0)


def test_train_batch_gating_noise_is_deterministic(setup):
    """With the noise on (the default, as the reference engine hands its
    MoE a gating rng), top-2's sampled second expert moves the losses off
    the noiseless run, and two engines from the same weights train the same
    losses bit for bit (each layer's noise drawn from a seed, and again the
    same when remat recomputes the block)."""
    _, jparams = setup
    batches = [_batch(256, 4, 16, seed=20 + i) for i in range(2)]
    noisy = _train(_port_engine(jparams, noise=True)[0], batches)
    assert noisy == _train(_port_engine(jparams, noise=True)[0], batches)
    assert noisy != _train(_port_engine(jparams, noise=False)[0], batches)


def test_moe_model_on_two_data_ranks_is_refused(setup):
    """The run this test once saw refused (a MoE model on two data ranks)
    now trains: three ``train_batch`` steps of the global batch over a gang
    of 2 (GAS 2, ZeRO 3, both ranks holding every expert), the gates' noise
    off, equal the JAX engine's at world 1 as
    :func:`test_train_batch_matches_the_jax_engine_at_world_1` holds them:
    the gate is global over both ranks' tokens, as the reference's. The
    name is kept so that the test's id stays the same across the change."""
    jcfg, jparams = setup
    batches = [_batch(jcfg.vocab_size, 8, 16, seed=40 + i) for i in range(3)]
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)
    config = dict(_ds_config(), train_micro_batch_size_per_gpu=4)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=_NoGatingRng(jmixtral.MixtralForCausalLM(jcfg)),
                                                model_parameters=jparams, config=config)
    jlosses = [float(jengine.train_batch(batch=b)) for b in batches]
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jengine.params))]
    jgroups.destroy_mesh()
    cfg = _cfg()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    gang = Gang(2)
    try:
        res = gang.run(psc.train_mixtral, fields, state, dict(_ds_config(), train_micro_batch_size_per_gpu=2),
                       batches)
    finally:
        gang.close()
    for r in res:
        np.testing.assert_allclose(r["losses"], jlosses, **LOSS_TOL)
    got = jax.tree.leaves(mixtral_to_flax({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, cfg))
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        assert np.mean(diff <= 0.01 * LR + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= 3 * LR, diff.max()
