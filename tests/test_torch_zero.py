"""Port parity for the ZeRO stages across ranks: the placement rule and the
engine's data-parallel training at stages 0-3 over a gloo gang of 2 ranks
(``tests/test_torch_zero_world4.py`` runs the engine over 4, and
``tests/test_torch_zero_partition.py`` holds the partitioning surface:
units, accessors, the f32 export).

Both sides start from the JAX package's ``init_params`` (through
``from_flax_params``) and train on the same global batches from numpy
seeds. The JAX engine runs on a sub-mesh of as many CPU devices as the
gang has ranks (``groups.initialize_mesh(devices=jax.devices()[:G])``), so
the data-parallel degree, the batch split and every placement are the
same; rank ``i`` holds what device ``i`` holds there. The gang is built
once for the module (``tests/torch_gang.py``).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.zero.policy import ZeroShardingPolicy as JaxPolicy
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import reference_names, to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy, port_dim, reference_shape
from tests import torch_gang_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

LR = 3e-3
STEPS = 3
# f32 on both sides; gloo and XLA sum the ranks' gradients in other orders
# and the two frameworks' matmuls differ at ~1e-6 relative: the losses agree
# to summation order. Adam's update carries its gradient's relative error, so
# where a gradient is near zero (its sign may flip) a weight can move by up
# to a whole lr step differently each step: 99.5% of each tensor's weights
# agree to 1% of an lr step, and every one within STEPS lr steps
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


def _assert_params_close(got, want):
    diff = np.abs(got - want)
    near = diff <= 0.01 * LR + 1e-4 * np.abs(want)
    assert near.mean() >= 0.995 and diff.max() <= STEPS * LR, (near.mean(), diff.max())


@pytest.fixture(scope="module")
def gang():
    g = Gang(2)
    yield g
    g.close()


def _jcfg():
    return jax_tiny(num_key_value_heads=2)


def _fields(pcfg):
    return {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg) if f.name != "dtype"}


def _batches(vocab, global_batch, steps, seed=7, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, size=(global_batch, seq + 1))
        out.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)))
    return out


def _config(stage, world, gas=2, micro=2, threshold=0):
    return {"train_batch_size": gas * micro * world, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": threshold}}


# ------------------------------------------------------------------- policy --
@pytest.mark.parametrize("threshold", [0, 10**9], ids=["threshold0", "threshold_large"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("degree", [2, 4])
def test_policy_places_every_parameter_as_the_reference(degree, stage, threshold):
    """For every parameter of ``LlamaConfig.tiny()``: sharded or replicated,
    and the sharded dimension, of the parameter, the gradient buffer and the
    optimizer state, equal the JAX policy's PartitionSpec under the
    converter's layout map (a Linear weight transposed)."""
    jcfg = _jcfg()
    pcfg = port_config(jcfg)
    jgroups.initialize_mesh(devices=jax.devices()[:degree], force=True)
    thr = threshold if stage >= 3 else 0
    jpol = JaxPolicy(stage=stage, mesh=jgroups.get_mesh(), persistence_threshold=thr)
    pmesh = types.SimpleNamespace(shape={"pipe": 1, "data": degree, "hpz": 1, "expert": 1, "seq": 1, "model": 1})
    ppol = ZeroShardingPolicy(stage, mesh=pmesh, persistence_threshold=thr)
    names = reference_names(LlamaForCausalLM(pcfg))
    jtree = dict(jax.tree_util.tree_leaves_with_path(jax_params(jcfg)))
    jshapes = {".".join(k.key for k in path): leaf.shape for path, leaf in jtree.items()}
    sharded = 0
    for pname, (jname, transposed) in names.items():
        shape = jshapes[jname]
        assert reference_shape(dict(LlamaForCausalLM(pcfg).named_parameters())[pname].shape, transposed) == shape
        for jfn, pfn in ((jpol.param_spec, ppol.param_dim), (jpol.grad_spec, ppol.grad_dim),
                         (jpol.opt_spec, ppol.opt_dim)):
            spec = tuple(jfn(shape)) + (None, ) * (len(shape) - len(tuple(jfn(shape))))
            jdim = next((d for d, e in enumerate(spec) if e is not None), None)
            assert pfn(shape) == jdim, (pname, jfn.__name__)
            assert port_dim(pfn(shape), len(shape), transposed) == port_dim(jdim, len(shape), transposed)
            sharded += jdim is not None
    if stage == 0 or (stage == 3 and threshold):
        assert sharded == 0 if stage == 0 else True
    else:
        assert sharded > 0


# ------------------------------------------------------------------- engine --
def make_jax_runs():
    """The JAX engine's runs, one a (degree, stage), each made once."""
    jcfg = _jcfg()
    jparams = jax_params(jcfg)
    cache = {}

    def run(degree, stage):
        if (degree, stage) not in cache:
            batches = _batches(jcfg.vocab_size, 4 * degree, STEPS)
            jgroups.initialize_mesh(devices=jax.devices()[:degree], force=True)
            engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg),
                                                       model_parameters=jparams, config=_config(stage, degree))
            losses = [float(engine.train_batch(batch=b)) for b in batches]
            cache[(degree, stage)] = dict(losses=losses, norm=engine.get_global_grad_norm(), params=engine.params,
                                          opt=engine.opt_state, batches=batches)
            jgroups.destroy_mesh()
        return cache[(degree, stage)]

    return jcfg, jparams, run


@pytest.fixture(scope="module")
def jax_runs():
    return make_jax_runs()


def _device_shard(leaf, rank):
    dev = jax.devices()[rank]
    return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_engine_matches_the_jax_engine_on_a_sub_mesh(gang, jax_runs, stage):
    """Three ``train_batch`` steps of the global batch at ZeRO ``stage``
    over 2 ranks (4: ``tests/test_torch_zero_world4.py``): per-step losses,
    the global norm and the whole masters agree with the JAX engine on 2
    devices, every rank holds exactly the masters and optimizer state device
    ``rank`` holds there, and all ranks gather the same masters."""
    check_engine_against_jax(gang, jax_runs, 2, stage)


def check_engine_against_jax(gang, jax_runs, degree, stage):
    jcfg, jparams, run = jax_runs
    ref = run(degree, stage)
    pcfg = port_config(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    res = gang.run(sc.train_llama, _fields(pcfg), state, _config(stage, degree), ref["batches"])
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"], **LOSS_TOL)
        assert r["norms"][-1] == pytest.approx(ref["norm"], rel=1e-4)
    for a, b in zip(res[0]["full"].values(), res[-1]["full"].values()):
        assert np.array_equal(a, b)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(ref["params"]))]
    for g, w in zip(got, want):
        _assert_params_close(g, w)
    jleaves = jax.tree.leaves(ref["params"])
    for r in res:
        local = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in r["local"].items()}, pcfg))
        for g, leaf in zip(local, jleaves):
            shard = _device_shard(leaf, r["rank"])
            assert g.shape == shard.shape
            _assert_params_close(g, shard)
        # the optimizer's first moment: the same chunk as device `rank`'s
        if stage >= 1:
            moments = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in r["opt"].items()
                       if k.startswith("exp_avg/")}
            mine = jax.tree.leaves(to_flax_params(moments, pcfg))
            for g, leaf in zip(mine, jax.tree.leaves(ref["opt"].exp_avg)):
                shard = _device_shard(leaf, r["rank"])
                assert g.shape == shard.shape
                np.testing.assert_allclose(g, shard, rtol=2e-3, atol=1e-6)
