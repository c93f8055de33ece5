"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Both packages get the same inputs: the JAX package's own ``init_params``
makes the weights, ``deepspeed_tpu_torch.models.convert.from_flax_params``
carries them across, and token ids, block tables and tensors come from
numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import from_flax_params


def jax_tiny(**kw):
    return jllama.LlamaConfig.tiny(dtype=jnp.float32, **kw)


def port_config(jcfg) -> tllama.LlamaConfig:
    """The port's LlamaConfig with the JAX config's shape fields, in f32."""
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    return tllama.LlamaConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})


def jax_params(jcfg, seed=0):
    """``{"model": ...}`` param tree of the JAX LlamaModel (lm_head inside)."""
    model = jllama.LlamaModel(jcfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return {"model": params}


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jcfg, jparams):
    return from_flax_params(to_numpy_tree(jparams), port_config(jcfg))
