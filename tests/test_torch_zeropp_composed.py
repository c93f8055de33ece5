"""Port parity for ZeRO++'s secondary partitions composed with the model,
sequence and expert axes, over one gloo gang of 4 ranks
(``tests/torch_gang.py``) that runs every scenario of the file
(``tests/torch_composed_scenarios.py``).

- hpZ 2 x tensor 2 of a tiny Llama at ZeRO 3, against the reference engine
  on its (data 1, hpz 2, model 2) mesh with AutoTP's placements;
- MiCS 2 x sequence 2 of a tiny Llama at ZeRO 3, against the reference
  engine on its (hpz 2, seq 2) mesh with ``sequence_parallel`` on;
- MiCS 2 x expert 2 of a tiny Mixtral at ZeRO 3 with capacity binding,
  against the reference engine at world 1 on the global batches (GSPMD
  makes the sharded run the same function), the gates' drops equal to the
  port's world-1 run's; and so hpZ 2 x expert 2 x data 2 over a gang of
  8, where the masters move between hpZ's layout and the optimizer's;
- each rank's stage-3 partition of every parameter against the reference
  policy's ``_add_zero_axes`` on the same mesh: the secondary group less
  the axes the parameter's TP/EP placement takes.

f32 on both sides; the gates' noise is off on both (C16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.module_inject.auto_tp import auto_tp_specs as jauto_tp_specs
from deepspeed_tpu.runtime.zero.policy import ZeroShardingPolicy as JZeroShardingPolicy
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import mixtral_from_flax, mixtral_to_flax, reference_names, to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.module_inject import auto_tp_specs
from deepspeed_tpu_torch.runtime.zero.policy import port_dim
from tests import torch_composed_scenarios as sc
from tests.test_torch_composed_train import CAPACITY, LOSS_TOL, _batches, _ds_config, _fields, _masters_close
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree


@pytest.fixture(scope="module")
def gang():
    g = Gang(4, timeout=300.0)
    yield g
    g.close()


def _local_shapes(names, shapes, base_specs, mesh_kw, policy_kw, world=4):
    """Each parameter's stage-3 partition shape (the port's layout) as the
    reference policy places it on ``mesh_kw``'s ``world`` devices over its
    base (TP/EP) placement."""
    from jax.sharding import PartitionSpec as P
    jgroups.initialize_mesh(devices=jax.devices()[:world], force=True, **mesh_kw)
    try:
        policy = JZeroShardingPolicy(3, persistence_threshold=0, **policy_kw)
        sizes = dict(jgroups.get_mesh().shape)
        out = {}
        for name, (_, transposed) in names.items():
            whole = shapes[name]
            ref = tuple(reversed(whole)) if transposed else tuple(whole)
            spec = tuple(policy.param_spec(ref, base_specs.get(name, P())))
            spec = spec + (None, ) * (len(ref) - len(spec))
            local = [n // int(np.prod([sizes[a] for a in ((e, ) if isinstance(e, str) else e)])) if e else n
                     for n, e in zip(ref, spec)]
            out[name] = tuple(reversed(local)) if transposed else tuple(local)
        return out
    finally:
        jgroups.destroy_mesh()


def _tp_base_specs(model):
    """AutoTP's placements of ``model`` as the reference's specs (its
    layout: a ``Linear`` weight transposed)."""
    from jax.sharding import PartitionSpec as P
    names = reference_names(model)
    out = {}
    for name, spec in auto_tp_specs(model).items():
        if spec is None:
            continue
        p = model.get_parameter(name)
        dim = port_dim(spec[1], p.ndim, names[name][1])
        out[name] = P(*[spec[0] if d == dim else None for d in range(p.ndim)])
    return out


def _llama_reference(mesh_kw, config, **cfg_kw):
    jcfg = jax_tiny(num_key_value_heads=2, **cfg_kw)
    jparams = jax_params(jcfg)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(devices=jax.devices()[:4], force=True, **mesh_kw)
    try:
        specs = jauto_tp_specs(jparams) if mesh_kw.get("model_parallel_size", 1) > 1 else None
        engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                   config=config, param_specs=specs)
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    finally:
        jgroups.destroy_mesh()
    pcfg = port_config(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    return pcfg, state, batches, losses, params


LLAMA_CASES = {
    # the port's config, the reference's mesh, its policy's secondary knob
    "hpz2xtp2": (dict(tensor_parallel_size=2, zero_hpz_partition_size=2),
                 dict(model_parallel_size=2, secondary_partition_size=2), {}, "param_axes"),
    "mics2xsp2": (dict(sequence_parallel_size=2, mics_shard_size=2),
                  dict(sequence_parallel_size=2, secondary_partition_size=2), dict(sequence_parallel=True),
                  "zero_axes"),
}


def _zero3(knobs):
    """``_ds_config(3, ...)`` with the ZeRO++ knob inside the ZeRO block."""
    knobs = dict(knobs)
    zkeys = {k: knobs.pop(k) for k in ("zero_hpz_partition_size", "mics_shard_size") if k in knobs}
    cfg = _ds_config(3, **knobs)
    cfg["zero_optimization"].update(zkeys)
    return cfg


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_secondary_partition_across_the_axes_matches_the_reference(gang, case):
    """hpZ beside tensor ranks, MiCS beside sequence ranks: the losses on
    every rank and the gathered masters equal the reference engine's on its
    mesh, and each rank's stage-3 partition of every parameter has the
    reference policy's shape (hpZ's parameters over the hpz group, never on
    the tensor-parallel dimension; MiCS's within hpz x seq)."""
    knobs, mesh_kw, cfg_kw, policy_key = LLAMA_CASES[case]
    config = _zero3(knobs)
    pcfg, state, batches, want, params = _llama_reference(mesh_kw, config, **cfg_kw)
    res = gang.run(sc.train, "llama", _fields(pcfg), state, config, batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
    _masters_close(jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()},
                                                  pcfg)), params)
    model = LlamaForCausalLM(pcfg)
    base = _tp_base_specs(model) if "tensor_parallel_size" in knobs else {}
    shapes = {k: v.shape for k, v in state.items()}
    want_shapes = _local_shapes(reference_names(model), shapes, base, mesh_kw,
                                {policy_key: jgroups.SECONDARY_PARTITION_AXES})
    for r in res:
        assert r["shapes"] == want_shapes
    assert any(want_shapes[k] != shapes[k] for k in shapes)


def _mixtral_reference(gas):
    """The JAX engine at world 1 and ZeRO 3 on the global batches in ``gas``
    micro-batches, its gates without noise, capacity binding, and the
    port's world-1 drops (``tests/test_torch_composed_train.py``'s
    fixture)."""
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32, capacity_factor=CAPACITY)
    _, jparams = jmixtral.init_params(jcfg)
    jparams = to_numpy_tree(jparams)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)

    class NoGatingRng:

        def __init__(self, module):
            self.module = module

        def apply(self, variables, batch):
            return self.module.apply(variables, batch)

    try:
        engine, _, _, _ = deepspeed_tpu.initialize(model=NoGatingRng(jmixtral.MixtralForCausalLM(jcfg)),
                                                   model_parameters=jparams,
                                                   config=dict(_ds_config(3), gradient_accumulation_steps=gas))
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    finally:
        jgroups.destroy_mesh()
    cfg = MixtralConfig.tiny(dtype=torch.float32, capacity_factor=CAPACITY)
    fields = _fields(cfg)
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    world1 = sc.train("mixtral", fields, state, dict(_ds_config(), gradient_accumulation_steps=gas), batches)
    return cfg, fields, state, batches, losses, params, world1


@pytest.fixture(scope="module")
def mixtral():
    """``_mixtral_reference`` at GAS 2 (one run for the file)."""
    return _mixtral_reference(2)


def _bank_specs(names):
    """The expert banks' reference placement, ``P('expert')``."""
    from jax.sharding import PartitionSpec as P
    return {n: P("expert", None, None) for n in names if n.endswith(("experts.wi", "experts.wo"))}


def test_mics_across_expert_ranks_matches_the_reference(gang, mixtral):
    """MiCS 2 x expert 2 at ZeRO 3 (capacity binding): the losses on every
    rank and every gate's drops equal world 1's and the reference's, the
    gathered masters within AdamW's limit, and each rank's partitions the
    reference policy's on the (hpz 2, expert 2) mesh: a dense parameter
    within hpz x expert, an expert bank (placed ``P('expert')``) within
    hpz alone."""
    cfg, fields, state, batches, want, params, world1 = mixtral
    config = _zero3(dict(expert_parallel_size=2, mics_shard_size=2))
    res = gang.run(sc.train, "mixtral", fields, state, config, batches)
    assert sum(world1["drops"]) > 0
    for r in res:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
        assert r["drops"] == world1["drops"]
    _masters_close(jax.tree.leaves(mixtral_to_flax({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, cfg)),
                   params)
    names = reference_names(MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32)))
    want_shapes = _local_shapes(names, {k: v.shape for k, v in state.items()}, _bank_specs(names),
                                dict(expert_parallel_size=2, secondary_partition_size=2),
                                {"zero_axes": jgroups.SECONDARY_PARTITION_AXES})
    for r in res:
        assert r["shapes"] == want_shapes


def test_hpz_across_expert_ranks_matches_the_reference():
    """hpZ 2 x expert 2 x data 2 at ZeRO 3 over 8 ranks (a gang of its own,
    one micro-batch a step: a row a rank), capacity binding. A dense
    parameter's hpZ group (hpz x expert) is not its ZeRO group (data x hpz
    x expert), nor a bank's (hpz) its own (data x hpz), so each step moves
    the masters between the two layouts, a bank's within its own groups
    (``relayout``). The losses on every rank and every gate's drops equal
    world 1's and the reference's, the gathered masters within AdamW's
    limit, and each rank's partitions the reference policy's on the
    (data 2, hpz 2, expert 2) mesh: a dense parameter within hpz x expert,
    a bank within hpz alone."""
    cfg, fields, state, batches, want, params, world1 = _mixtral_reference(1)
    config = dict(_zero3(dict(expert_parallel_size=2, zero_hpz_partition_size=2)), gradient_accumulation_steps=1)
    gang = Gang(8, timeout=300.0)
    try:
        res = gang.run(sc.train, "mixtral", fields, state, config, batches)
    finally:
        gang.close()
    assert sum(world1["drops"]) > 0
    for r in res:
        assert r["relayout"]
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
        assert r["drops"] == world1["drops"]
    _masters_close(jax.tree.leaves(mixtral_to_flax({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, cfg)),
                   params)
    names = reference_names(MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32)))
    want_shapes = _local_shapes(names, {k: v.shape for k, v in state.items()}, _bank_specs(names),
                                dict(expert_parallel_size=2, secondary_partition_size=2),
                                {"param_axes": jgroups.SECONDARY_PARTITION_AXES}, world=8)
    for r in res:
        assert r["shapes"] == want_shapes
