"""Port parity for training across the composed model-parallel axes: a Llama
at tensor 2 x sequence 2, and a Mixtral at tensor 2, at sequence 2 and at
expert 2 under ZeRO 3 (each beside 2 data ranks), over one gloo gang of 4
ranks (``tests/torch_gang.py``) that runs every scenario of the file
(``tests/torch_composed_scenarios.py``).

The reference side is the JAX package: its engine on the Llama's own mesh
(``seq`` 2 x ``model`` 2, ``sequence_parallel`` on, AutoTP's placements),
its engine at world 1 on the global batch for the Mixtral (GSPMD makes the
sharded run the same function, whose gate is global over the batch), and
its ``ZeroShardingPolicy._add_zero_axes`` for the placement of each rank's
stage-3 partitions. Each global batch masks a span of labels in the first
data rank's rows and the first sequence rank's half (C18's case). Capacity
binds in every MoE case, so a gate over each rank's own tokens (the
control) drops other assignments than the global gate, whose drops equal
world 1's. f32 on both sides; the gates' noise is off on both (C16).
"""

import dataclasses

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
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from tests import torch_composed_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

LR = 3e-3
STEPS = 2
# the losses to summation order (f32), as tests/test_torch_tp.py holds them
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
CAPACITY = 0.5  # binds: every gate drops assignments


@pytest.fixture(scope="module")
def gang():
    g = Gang(4, timeout=300.0)
    yield g
    g.close()


def _ds_config(stage=1, **axes):
    return dict({"train_batch_size": 8, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
                 "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}, **axes)


def _batches(vocab, seq=16, seed=9):
    """Global batches of 8 rows with ``-100`` on a span of rows 0-1 (data
    rank 0's) inside the first half of the sequence (sequence rank 0's)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, size=(8, seq + 1))
        labels = ids[:, 1:].copy()
        labels[:2, 2:seq // 2 - 1] = -100
        out.append((ids[:, :-1].astype(np.int32), labels.astype(np.int32)))
    return out


def _masters_close(got, want):
    """``tests/test_torch_ulysses.py``'s limit on the masters after the
    steps: 99.5% of each tensor within 1% of an lr step, every element
    within ``STEPS`` lr."""
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        assert np.mean(diff <= 0.01 * LR + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= STEPS * LR, diff.max()


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("dtype",
                                                                                             "sequence_parallel")}


# ---------------------------------------------------------- Llama, TP x SP --
@pytest.fixture(scope="module")
def llama():
    """The JAX engine with ``sequence_parallel`` on a ``seq`` 2 x ``model``
    2 mesh of 4 devices, AutoTP placing the parameters (one run)."""
    jcfg = jax_tiny(num_key_value_heads=2, sequence_parallel=True)
    jparams = jax_params(jcfg)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(sequence_parallel_size=2, model_parallel_size=2, devices=jax.devices()[:4], force=True)
    engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                               config=_ds_config(), param_specs=jauto_tp_specs(jparams))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    jgroups.destroy_mesh()
    pcfg = port_config(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    return pcfg, _fields(pcfg), state, batches, losses, params


@pytest.mark.parametrize("stage", [1, 3], ids=["zero1", "zero3"])
def test_tp_x_sp_llama_matches_the_reference_on_its_mesh(gang, llama, stage):
    """Tensor 2 x sequence 2 over the 4 ranks (each rank half the heads of
    half the sequence; the all-to-all runs over the sequence group on the
    rank's 2 of the 4 heads, its one KV head repeated): the losses on every
    rank and the gathered masters equal the reference's on its mesh; at
    ZeRO 3 each tensor-parallel shard is partitioned again over the
    sequence ranks, on a dimension its tensor-parallel placement leaves
    free, as the reference's ``_add_zero_axes`` places it."""
    pcfg, fields, state, batches, want_losses, want_params = llama
    res = gang.run(sc.train, "llama", fields, state, _ds_config(stage, tensor_parallel_size=2,
                                                                sequence_parallel_size=2), batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
    _masters_close(jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg)),
                   want_params)
    # q_proj [64, 64] column-parallel: the rank's [32, 64], at ZeRO 3 cut
    # again on its input features; o_proj row-parallel: [64, 32], at ZeRO 3
    # on its output features, never on the tensor-parallel dimension (C20)
    shapes = res[0]["shapes"]
    assert (shapes["layers.0.self_attn.q_proj.weight"], shapes["layers.0.self_attn.o_proj.weight"]) == \
        (((32, 32), (32, 32)) if stage == 3 else ((32, 64), (64, 32)))


# ------------------------------------------------------------- Mixtral ------
@pytest.fixture(scope="module")
def mixtral():
    """The JAX engine at world 1 and ZeRO 3 on the global batches, its gates
    without noise, capacity binding (one run), and the port's world-1
    drops."""
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32, capacity_factor=CAPACITY)
    _, jparams = jmixtral.init_params(jcfg)
    jparams = to_numpy_tree(jparams)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)

    class NoGatingRng:  # no gating rng, so no noise (tests/test_torch_mixtral.py)

        def __init__(self, module):
            self.module = module

        def apply(self, variables, batch):
            return self.module.apply(variables, batch)

    engine, _, _, _ = deepspeed_tpu.initialize(model=NoGatingRng(jmixtral.MixtralForCausalLM(jcfg)),
                                               model_parameters=jparams, config=_ds_config(3))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    jgroups.destroy_mesh()
    cfg = MixtralConfig.tiny(dtype=torch.float32, capacity_factor=CAPACITY)
    fields = _fields(cfg)
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    world1 = sc.train("mixtral", fields, state, _ds_config(), batches)
    return cfg, fields, state, batches, losses, params, world1


MOE_MESHES = {
    "dp2xtp2": dict(tensor_parallel_size=2),
    "dp2xsp2": dict(sequence_parallel_size=2),
    "tp2xsp2": dict(tensor_parallel_size=2, sequence_parallel_size=2),
    "dp2xep2_zero3": dict(expert_parallel_size=2, stage=3),
}


@pytest.mark.parametrize("mesh", list(MOE_MESHES))
def test_moe_model_across_the_composed_axes_matches_the_reference(gang, mixtral, mesh):
    """A tiny Mixtral over the 4 ranks: the losses on every rank and the
    gathered masters equal the reference engine's, and every gate's drops
    equal world 1's (the gate is global over the data, expert and sequence
    ranks' tokens and never counts a model rank's copy twice)."""
    cfg, fields, state, batches, want_losses, want_params, world1 = mixtral
    kw = dict(MOE_MESHES[mesh])
    res = gang.run(sc.train, "mixtral", fields, state, _ds_config(kw.pop("stage", 1), **kw), batches)
    assert sum(world1["drops"]) > 0  # capacity binds
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
        assert r["drops"] == world1["drops"]
    np.testing.assert_allclose(world1["losses"], want_losses, **LOSS_TOL)
    _masters_close(jax.tree.leaves(mixtral_to_flax({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, cfg)),
                   want_params)


def test_gate_over_each_ranks_own_tokens_misses_world_1(gang, mixtral):
    """The control: at sequence 2 with each rank gating its own tokens
    (a quarter of the batch), the drops differ from the global gate's."""
    _, fields, state, batches, _, _, world1 = mixtral
    res = gang.run(sc.train, "mixtral", fields, state, _ds_config(sequence_parallel_size=2), batches, True)
    assert any(r["drops"] != world1["drops"] for r in res)


def test_expert_banks_at_zero_3_take_the_reference_placement(gang, mixtral):
    """Expert 2 x data 2 at ZeRO 3: every rank's stage-3 partition of every
    parameter has the shape the reference's ``_add_zero_axes`` gives it on a
    (data 2, expert 2) mesh, an expert bank's base placement
    ``P('expert', None, None)``: the bank is partitioned over the data
    (expert-data) ranks only, on its first free dimension, and a rank holds
    a quarter of world 1's bank state."""
    _, fields, state, batches, _, _, _ = mixtral
    res = gang.run(sc.train, "mixtral", fields, state, _ds_config(3, expert_parallel_size=2), batches[:1])
    jgroups.initialize_mesh(expert_parallel_size=2, devices=jax.devices()[:4], force=True)
    try:
        policy = JZeroShardingPolicy(3, persistence_threshold=0)
        sizes = dict(jgroups.get_mesh().shape)
        from jax.sharding import PartitionSpec as P
        names = reference_names(MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32)))
        for name, (_, transposed) in names.items():
            whole = state[name].shape
            ref = tuple(reversed(whole)) if transposed else whole
            bank = name.endswith(("experts.wi", "experts.wo"))
            spec = tuple(policy.param_spec(ref, P("expert", None, None) if bank else P()))
            spec = spec + (None, ) * (len(ref) - len(spec))
            local = [n // int(np.prod([sizes[a] for a in ((e, ) if isinstance(e, str) else e)])) if e else n
                     for n, e in zip(ref, spec)]
            want = tuple(reversed(local)) if transposed else tuple(local)
            for r in res:
                assert r["shapes"][name] == want, (name, r["shapes"][name], want, spec)
            if bank:
                assert np.prod(want) * 4 == np.prod(whole)
    finally:
        jgroups.destroy_mesh()


# ------------------------------------------------------------------ the mesh --
@pytest.mark.parametrize("sizes", [dict(expert=2, seq=2, model=2), dict(data=2, seq=2, model=2),
                                   dict(data=2, expert=2, model=2)],
                         ids=["ep2xsp2xtp2", "dp2xsp2xtp2", "dp2xep2xtp2"])
def test_rank_mesh_lays_ranks_out_as_the_reference(sizes):
    """Three axes above 1 at once over 8 ranks: the port's rank grid is the
    reference's ``initialize_mesh`` device grid (rank ``r`` where device
    ``r`` is), and so is every group the engines ask for (the model ranks
    of one slot neighbours, then the sequence, expert and data ranks)."""
    from deepspeed_tpu_torch.utils import groups
    jgroups.initialize_mesh(devices=jax.devices()[:8], force=True, data_parallel_size=sizes.get("data", 1),
                            **{f"{'sequence' if a == 'seq' else a}_parallel_size": n
                               for a, n in sizes.items() if a != "data"})
    try:
        want = np.vectorize(lambda d: d.id)(jgroups.get_mesh().devices)
    finally:
        jgroups.destroy_mesh()
    mesh = groups.RankMesh(np.arange(8).reshape(groups.MeshTopology(**sizes).shape), 0)
    np.testing.assert_array_equal(mesh.devices, want)
    names = list(groups.MESH_AXES)
    for axes in [(groups.MODEL_AXIS, ), (groups.SEQ_AXIS, ), (groups.EXPERT_AXIS, ), groups.SEQ_DATA_PARALLEL_AXES,
                 groups.EXPERT_ZERO_AXES, groups.DATA_PARALLEL_AXES]:
        moved = np.moveaxis(want, [names.index(a) for a in axes], range(want.ndim - len(axes), want.ndim))
        ref = moved.reshape(-1, int(np.prod([want.shape[names.index(a)] for a in axes])))
        assert sorted(mesh._slices(axes)) == sorted(map(list, ref)), axes
