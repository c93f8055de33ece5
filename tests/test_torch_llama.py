"""Port parity: deepspeed_tpu_torch.models.llama against deepspeed_tpu.models.llama.

Same weights (the JAX init, carried across by from_flax_params) and the same
token ids from a numpy seed; f32 on the CPU on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_flax_params
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

# f32 on both sides; only the summation order of XLA's and torch's CPU
# matmuls differs, worth a few ulps per op over two layers
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(num_key_value_heads=4),  # MHA
    dict(num_key_value_heads=2),  # GQA
    dict(num_key_value_heads=2, sliding_window=5, model_type="mistral"),
    dict(num_key_value_heads=2, attention_bias=True, model_type="qwen2"),
], ids=["mha", "gqa", "sliding_window", "qkv_bias"])
def test_llama_logits_match_jax(kw):
    jcfg = jax_tiny(**kw)
    jparams = jax_params(jcfg, seed=1)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jllama.LlamaModel(jcfg).apply({"params": jparams["model"]}, jnp.asarray(ids)))

    model = tllama.LlamaModel(port_config(jcfg))
    model.load_state_dict(port_params(jcfg, jparams))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_rotary_tables_and_rotation_match_jax():
    cos_j, sin_j = jllama.rotary_embedding(64, 16, 10000.0, jnp.float32)
    cos_t, sin_t = tllama.rotary_embedding(64, 16, 10000.0)
    # f32 pow/cos/sin of two libraries: an ulp or two on arguments up to 63 rad
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=0, atol=1e-5)
    x = np.random.default_rng(1).normal(size=(2, 64, 3, 16)).astype(np.float32)
    want = np.asarray(jllama.apply_rotary(jnp.asarray(x), cos_j, sin_j))
    got = tllama.apply_rotary(torch.from_numpy(x), cos_t, sin_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_from_flax_params_layouts():
    jcfg = jax_tiny()
    tree = to_numpy_tree(jax_params(jcfg))
    cfg = port_config(jcfg)
    nested = from_flax_params(tree, cfg)
    q = tree["model"]["layers_1"]["self_attn"]["q_proj"]["kernel"]  # flax Dense [in, out]
    np.testing.assert_array_equal(nested["layers.1.self_attn.q_proj.weight"].numpy(), q.T)
    np.testing.assert_array_equal(nested["embed_tokens.weight"].numpy(),
                                  tree["model"]["embed_tokens"]["embedding"])  # [V, hidden] as is
    # lm_head at the root (llama_v2.py:30 accepts both layouts)
    root = dict(tree)
    root["model"] = {k: v for k, v in tree["model"].items() if k != "lm_head"}
    root["lm_head"] = tree["model"]["lm_head"]
    flat = from_flax_params(root, cfg)
    assert set(flat) == set(nested)
    for k in nested:
        np.testing.assert_array_equal(flat[k].numpy(), nested[k].numpy())
    with pytest.raises(ValueError, match="does not fit"):
        from_flax_params(tree, port_config(jax_tiny(num_hidden_layers=3)))


def test_init_params_seeded_and_loadable():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    a = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tllama.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    model = tllama.LlamaModel(cfg)
    model.load_state_dict(a)  # keys and shapes are exactly the module's
    assert a["norm.weight"].eq(1).all()
    seven = tllama.LlamaConfig.llama2_7b()
    assert (seven.hidden_size, seven.intermediate_size, seven.num_hidden_layers, seven.num_attention_heads,
            seven.num_key_value_heads, seven.vocab_size) == (4096, 11008, 32, 32, 32, 32000)
    n = sum(int(np.prod(s)) for s in tllama.param_shapes(seven).values())
    assert n == 6_738_415_616  # Llama-2-7B, untied lm_head
