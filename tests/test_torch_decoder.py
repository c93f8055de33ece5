"""Port parity for the decoder family (``models/decoder.py``) and its ragged
engine (``inference/v2/model_implementations/decoder_v2.py``): OPT, Falcon,
Phi, GPT-J and GPT-NeoX at ``DecoderConfig.tiny`` in f32, the weights the
reference's tree with every leaf drawn from a numpy seed (biases and norms
included), against the JAX package's ``DecoderModel`` and its
``DecoderV2Model`` engine; Bloom refused, and GPT-Neo refused (C23) where the
reference serves logits that differ from its own training forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_factory import build_engine as jbuild_engine
from deepspeed_tpu.inference.v2.ragged import manager_configs as jmc
from deepspeed_tpu.models import decoder as jdecoder
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.model_implementations.decoder_v2 import DecoderV2Model
from deepspeed_tpu_torch.inference.v2.model_implementations.registry import model_cls_for, supported_model_types
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as mc
from deepspeed_tpu_torch.models import decoder as tdecoder
from deepspeed_tpu_torch.models.convert import decoder_from_flax, decoder_to_flax
from tests.torch_port_helpers import to_numpy_tree  # noqa: F401  (one torch thread a worker)

SERVED = ("opt", "falcon", "phi", "gptj", "gpt_neox")
# f32 on both sides: the reference's own tolerance for its engines
# (tests/unit/inference/v2/test_model_breadth.py)
TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
NEO_LOCAL = dict(attention_layers=("global", "local"), window_size=4)


def jax_config(variant, **kw):
    return jdecoder.DecoderConfig.tiny(variant, dtype=jnp.float32, **kw)


def port_config(variant, **kw):
    return tdecoder.DecoderConfig.tiny(variant, dtype=torch.float32, **kw)


def seeded_tree(jcfg, seed):
    """The reference's param tree (its structure from flax's own ``init``,
    traced abstractly) with every leaf drawn from a numpy seed: weights and
    biases normal(0, 0.1), LayerNorm scales 1 + that."""
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jdecoder.DecoderForCausalLM(jcfg).init(jax.random.PRNGKey(0), (ids, ids)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (float(path[-1].key == "scale") + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        shapes["params"])


@pytest.fixture(scope="module")
def trees():
    out = {v: seeded_tree(jax_config(v), seed) for seed, v in enumerate(SERVED + ("gpt_neo", "bloom"))}
    out["gpt_neo_local"] = seeded_tree(jax_config("gpt_neo", **NEO_LOCAL), 9)
    return out


def _ids(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("variant,kw", [(v, {}) for v in SERVED + ("gpt_neo", "bloom")] + [("gpt_neo", NEO_LOCAL)],
                         ids=list(SERVED + ("gpt_neo", "bloom")) + ["gpt_neo_local"])
def test_causal_lm_matches_reference(trees, variant, kw):
    """``DecoderForCausalLM``'s logits and loss against the reference's, and
    the converter both ways, bit for bit."""
    tree = trees["gpt_neo_local" if kw else variant]
    jcfg, cfg = jax_config(variant, **kw), port_config(variant, **kw)
    state = decoder_from_flax(tree, cfg)
    back = decoder_to_flax(state, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels[:, :3] = -100
    want_logits = jdecoder.DecoderModel(jcfg).apply({"params": tree["model"]}, jnp.asarray(ids))
    want_loss = jdecoder.DecoderForCausalLM(jcfg).apply({"params": tree}, (jnp.asarray(ids), jnp.asarray(labels)))
    model = tdecoder.DecoderForCausalLM(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        logits = tdecoder.DecoderModel.forward(model, torch.from_numpy(ids).long())
        loss = model((torch.from_numpy(ids).long(), torch.from_numpy(labels).long()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **MODEL_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **MODEL_TOL)


def test_init_params_draws_from_the_generator():
    cfg = port_config("phi")
    a = tdecoder.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tdecoder.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert set(a) == set(tdecoder.param_shapes(cfg)) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(a[k].dtype == torch.float32 and tuple(a[k].shape) == s for k, s in tdecoder.param_shapes(cfg).items())
    assert torch.equal(a["layers.0.input_layernorm.weight"], torch.ones(cfg.hidden_size))
    assert not a["layers.0.self_attn.q_proj.bias"].any() and a["lm_head.weight"].std() > 0


def _jax_engine(jcfg, tree):
    jgroups.initialize_mesh(force=True)
    mgr = jmc.DSStateManagerConfig(memory_config=jmc.MemoryConfig(mode=jmc.AllocationMode.ALLOCATE, size=64),
                                   max_context=128)
    return jbuild_engine(tree, jcfg, JEngineConfig(state_manager=mgr, kv_block_size=16))


def _port_engine(cfg, state, **kw):
    mgr = mc.DSStateManagerConfig(memory_config=mc.MemoryConfig(mode=mc.AllocationMode.ALLOCATE, size=64),
                                  max_context=128)
    return build_engine(state, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16, **kw),
                        device="cpu")


def _put_then_decode(engine, prompt, steps=2):
    """A 13-token put, then ``steps`` greedy decode puts: every put's logits."""
    rows = [np.asarray(engine.put([0], [prompt]))[0]]
    for _ in range(steps):
        rows.append(np.asarray(engine.put([0], [np.asarray([int(np.argmax(rows[-1]))], np.int32)]))[0])
    return np.stack(rows)


@pytest.fixture(scope="module")
def jax_rows(trees):
    """The reference's engine on each served variant, run once: its logits
    on the 13-token put and 2 decode puts."""
    return {v: _put_then_decode(_jax_engine(jax_config(v), trees[v]), _ids(256, 13, i)) for i, v in enumerate(SERVED)}


@pytest.mark.parametrize("paged", [None, True], ids=["auto", "b1_plain"])
@pytest.mark.parametrize("variant", SERVED)
def test_ragged_engine_matches_reference_engine(trees, jax_rows, variant, paged):
    """The port's ``DecoderV2Model`` engine against the reference's on the same
    converted weights, and against its own dense forward on the whole
    context; ``b1_plain`` runs every put through B1's plain version (the
    kernel's function on the CPU), ``auto`` through the gather branch."""
    cfg = port_config(variant)
    state = decoder_from_flax(trees[variant], cfg)
    engine = _port_engine(cfg, state, use_paged_kernel=paged)
    assert type(engine.model) is DecoderV2Model
    prompt = _ids(256, 13, SERVED.index(variant))
    rows = _put_then_decode(engine, prompt)
    np.testing.assert_allclose(rows, jax_rows[variant], **TOL)
    ctx = np.concatenate([prompt, np.argmax(rows[:-1], axis=-1).astype(np.int32)])
    model = tdecoder.DecoderModel(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        dense = model(torch.from_numpy(ctx[None]).long())[0].numpy()
    np.testing.assert_allclose(rows, dense[[12, 13, 14]], **TOL)


def test_registry_resolves_the_family():
    """As the reference's registry: each served type by name, Bloom not
    registered (and GPT-Neo reaching ``DecoderV2Model`` by its config class)."""
    assert set(SERVED) <= set(supported_model_types()) and not {"bloom", "gpt_neo"} & set(supported_model_types())
    for variant in SERVED + ("gpt_neo", ):
        assert model_cls_for(port_config(variant)) is DecoderV2Model


def test_bloom_is_refused(trees):
    cfg = port_config("bloom")
    with pytest.raises(NotImplementedError, match="ALiBi"):
        _port_engine(cfg, decoder_from_flax(trees["bloom"], cfg))


@pytest.mark.parametrize("kw", [{}, NEO_LOCAL], ids=["unscaled", "unscaled_local"])
def test_gpt_neo_is_refused_c23(trees, kw):
    """C23: the reference's ragged engine serves GPT-Neo with logits that
    differ from its own training forward (it scales every score and applies
    no local window); the port refuses it and names C23."""
    tree = trees["gpt_neo_local" if kw else "gpt_neo"]
    jcfg, cfg = jax_config("gpt_neo", **kw), port_config("gpt_neo", **kw)
    prompt = _ids(256, 13, 5)
    served = np.asarray(_jax_engine(jcfg, tree).put([0], [prompt]))[0]
    dense = np.asarray(jdecoder.DecoderModel(jcfg).apply({"params": tree["model"]}, jnp.asarray(prompt[None])))[0, -1]
    assert np.abs(served - dense).max() > 0.5
    with pytest.raises(NotImplementedError, match="C23"):
        _port_engine(cfg, decoder_from_flax(tree, cfg))
    # a scaled model with a local layer is refused too
    local = port_config("opt", **NEO_LOCAL)
    with pytest.raises(NotImplementedError, match="C23"):
        _port_engine(local, tdecoder.init_params(local, torch.Generator().manual_seed(0), device="cpu"))
