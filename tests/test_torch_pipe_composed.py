"""Port parity for the pipeline composed with the mesh's other axes, over
one gloo gang of 4 ranks (``tests/torch_gang.py``) that runs every scenario
of the file (``tests/torch_pipe_scenarios.py``).

The reference side is the JAX package's ``PipelineEngine`` on its own mesh
of 4 CPU devices: (pipe 2, model 2), (pipe 2, seq 2), (pipe 2, expert 2)
and (pipe 2, data 2), the same weights (the reference's initial tree
through ``models/convert.pipeline_params_from_flax``) and the same global
batches. Its ``shard_map`` splits the batch over ``DATA_PARALLEL_AXES``
only, so the model and sequence ranks run the stage on the same
micro-batches and the expert ranks are data ranks; the port holds the
losses on every rank, the norm and every master to it, at ZeRO 1 to 3.
A plain module under ``pipeline_parallel_size`` 2 is held to the
reference's base engine on (pipe 2, data 2), which replicates it over the
pipe ranks. f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.convert import to_flax_params
from tests import torch_composed_scenarios as csc
from tests import torch_gang_scenarios as gsc
from tests import torch_pipe_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

HIDDEN = 16
LR = 1e-2
STEPS = 2
# the same math in another order (XLA's scan against the stages' separate
# programs): tests/test_torch_pipe.py's limits on the losses and the norm
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def gang():
    g = Gang(4, timeout=300.0)
    yield g
    g.close()


def _cfg(stage, **axes):
    return dict({"train_batch_size": 8, "gradient_accumulation_steps": 4, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": LR}},
                 "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}, **axes)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(HIDDEN, )).astype(np.float32)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(8, HIDDEN)).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


def _masters_close(got, want, lr=LR):
    """``tests/test_torch_pipe.py``'s limit on the masters after the steps:
    99.5% of each tensor within 1% of an lr step, every element within 3 lr
    (Adam carries a gradient's rounding into its step)."""
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        near = diff <= 0.01 * lr + 1e-4 * np.abs(w)
        assert near.mean() >= 0.995 and diff.max() <= 3 * lr, (near.mean(), diff.max())


def _reference_pipeline_engine(stage, moe=False, example=(jnp.ones((2, HIDDEN)), jnp.ones((2, )))):
    """The reference's PipelineEngine of the tests' mlp (in, 4 blocks, out;
    ``moe``: each block ``x + MoE(x)``, top-1 over 4 experts) on the mesh
    already made."""
    import flax.linen as nn
    from deepspeed_tpu.moe.layer import MoE

    class InProj(nn.Module):

        @nn.compact
        def __call__(self, x):
            return nn.Dense(HIDDEN)(x)

    class Block(nn.Module):

        @nn.compact
        def __call__(self, x):
            return x + nn.tanh(nn.Dense(HIDDEN)(x))

    class OutProj(nn.Module):

        @nn.compact
        def __call__(self, x):
            return nn.Dense(1)(x)

    class MoEBlock(nn.Module):

        @nn.compact
        def __call__(self, x):
            return x + MoE(HIDDEN, num_experts=4, ffn_hidden_size=2 * HIDDEN, k=1, capacity_factor=1.0,
                           min_capacity=2)(x)[0]

    def mse(out, labels):
        return jnp.mean((out.squeeze(-1) - labels)**2)

    layers = [jmodule.LayerSpec(InProj)] + [jmodule.LayerSpec(MoEBlock if moe else Block) for _ in range(4)] + \
        [jmodule.LayerSpec(OutProj)]
    module = jmodule.PipelineModule(layers=layers, num_stages=2, loss_fn=mse)
    engine, _, _, _ = deepspeed_tpu.initialize(model=module, config=_cfg(stage), rng_seed=7, example_batch=example)
    return engine


def _reference_pipeline(mesh_kw, stage):
    """The reference's PipelineEngine on a mesh of 4 devices: its initial
    tree, the losses, the last norm and the masters after the steps."""
    jgroups.initialize_mesh(pipe_parallel_size=2, devices=jax.devices()[:4], force=True, **mesh_kw)
    try:
        engine = _reference_pipeline_engine(stage)
        p0 = jax.tree.map(np.asarray, jax.device_get(engine.params))
        losses = [float(engine.train_batch(batch=b)) for b in _batches()]
        params = jax.tree.map(np.asarray, jax.device_get(engine.params))
        return p0, losses, engine.get_global_grad_norm(), params
    finally:
        jgroups.destroy_mesh()


# the port's axes, the reference's mesh, the ZeRO stage
PIPE_MESHES = {
    "pp2xtp2_zero1": (dict(tensor_parallel_size=2), dict(model_parallel_size=2), 1),
    "pp2xsp2_zero2": (dict(sequence_parallel_size=2), dict(sequence_parallel_size=2), 2),
    "pp2xep2_zero3": (dict(expert_parallel_size=2), dict(expert_parallel_size=2), 3),
    "pp2xdp2_zero3": ({}, {}, 3),
}


@pytest.fixture(scope="module")
def model_run(gang):
    """The reference and the port at (pipe 2, model 2), ZeRO 1: the first
    case, whose port run the ``param_specs`` case is held to."""
    axes, mesh_kw, stage = PIPE_MESHES["pp2xtp2_zero1"]
    p0, losses, norm, params = _reference_pipeline(mesh_kw, stage)
    module = gsc.pipeline_module("mlp", 2, HIDDEN)
    state = {k: v.numpy() for k, v in convert.pipeline_params_from_flax(p0, module).items()}
    res = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(stage, **axes), _batches())
    return state, (p0, losses, norm, params), res


@pytest.mark.parametrize("mesh", list(PIPE_MESHES))
def test_pipeline_across_the_axes_matches_the_reference_on_its_mesh(gang, model_run, mesh):
    """Two stages beside model, sequence, expert or data ranks: the losses
    on every rank and the last norm equal the reference's, and every
    master (the stages' whole masters put together) is within the pipeline
    tests' limit of the reference's. The ranks that share a stage hold it
    alike: model and sequence ranks bitwise equal masters (the same
    micro-batches), and at ZeRO 3 each rank holds half its stage's
    parameter and optimizer bytes, exactly."""
    axes, mesh_kw, stage = PIPE_MESHES[mesh]
    if mesh == "pp2xtp2_zero1":
        _, (p0, want, norm, params), res = model_run
    else:
        p0, want, norm, params = _reference_pipeline(mesh_kw, stage)
        module = gsc.pipeline_module("mlp", 2, HIDDEN)
        state = {k: v.numpy() for k, v in convert.pipeline_params_from_flax(p0, module).items()}
        res = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(stage, **axes), _batches())
    assert [r["stage"] for r in res] == [0, 0, 1, 1]
    for r in res:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
        assert r["norms"][-1] == pytest.approx(norm, rel=1e-4)
    module = gsc.pipeline_module("mlp", 2, HIDDEN)
    full = {**res[0]["full"], **res[2]["full"]}
    got = convert.pipeline_params_to_flax({k: torch.from_numpy(v) for k, v in full.items()}, module)
    _masters_close(jax.tree.leaves(got), jax.tree.leaves(params))
    for a, b in ((res[0], res[1]), (res[2], res[3])):  # the two ranks of a stage
        if axes:
            for k in a["full"]:
                np.testing.assert_array_equal(a["full"][k], b["full"][k])
        if stage == 3:
            # every tensor with an even dimension is halved (OutProj's one
            # bias stays whole); f32 masters and their f32 compute copy
            local = 0
            for k, v in a["full"].items():
                n = int(np.prod(v.shape))
                assert int(np.prod(a["shapes"][k])) == (n // 2 if any(d % 2 == 0 for d in v.shape) else n), k
                local += int(np.prod(a["shapes"][k]))
            assert a["bytes"]["params"] == local * 8 and a["bytes"] == b["bytes"]


def test_param_specs_with_a_pipeline_module_are_dropped(gang, model_run):
    """``initialize(param_specs=..., model=PipelineModule)`` is accepted and
    does what the reference does with it, nothing: the losses and masters
    of (pipe 2, model 2) bitwise those of the same run without it."""
    state, _, want = model_run
    specs = {"layers.1.Dense_0.weight": ("model", 0), "layers.4.Dense_0.weight": ("model", 1)}
    res = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(1, tensor_parallel_size=2), _batches(), specs)
    for r, w in zip(res, want):
        assert r["losses"] == w["losses"]
        for k in w["full"]:
            np.testing.assert_array_equal(r["full"][k], w["full"][k])


def test_plain_module_is_replicated_over_the_pipe_ranks(gang):
    """A tiny Llama (not a PipelineModule) under ``pipeline_parallel_size``
    2 over the 4 ranks (pipe 2 x data 2): the reference's base engine on
    that mesh replicates it over the pipe ranks and splits the batch over
    the data ranks; the port's losses on every rank equal it, the gathered
    masters are within AdamW's limit, and the two pipe ranks of a data
    slot hold bitwise equal masters."""
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, jcfg.vocab_size, (8, 16)).astype(np.int32),
                rng.integers(0, jcfg.vocab_size, (8, 16)).astype(np.int32)) for _ in range(STEPS)]
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}}, "zero_optimization": {"stage": 1}}
    jgroups.initialize_mesh(pipe_parallel_size=2, devices=jax.devices()[:4], force=True)
    try:
        engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                   config=cfg)
        want = [float(engine.train_batch(batch=b)) for b in batches]
        params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    finally:
        jgroups.destroy_mesh()
    pcfg = port_config(jcfg)
    fields = {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__ if f not in ("dtype", "sequence_parallel")}
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    res = gang.run(csc.train, "llama", fields, state, dict(cfg, pipeline_parallel_size=2), batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=2e-5, atol=2e-5)
    _masters_close(jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()},
                                                  pcfg)), params, lr=3e-3)
    for a, b in ((res[0], res[2]), (res[1], res[3])):
        for k in a["full"]:
            np.testing.assert_array_equal(a["full"][k], b["full"][k])


def _moe_state(p0):
    """The reference's {pre, stack, post} tree of the MoE pipeline as the
    port's state dict (``torch_pipe_scenarios.MoEBlock``'s names; a Dense
    kernel transposed)."""
    out = {}
    for i, leaf in ((0, p0["pre"]["0"]["Dense_0"]), (5, p0["post"]["0"]["Dense_0"])):
        out[f"layers.{i}.Dense_0.weight"] = np.ascontiguousarray(leaf["kernel"].T)
        out[f"layers.{i}.Dense_0.bias"] = leaf["bias"]
    moe = p0["stack"]["MoE_0"]
    for b in range(4):
        out[f"layers.{b + 1}.moe.gate"] = moe["gate"][b]
        out[f"layers.{b + 1}.moe.experts.wi"] = moe["ExpertFFN_0"]["wi"][b]
        out[f"layers.{b + 1}.moe.experts.wo"] = moe["ExpertFFN_0"]["wo"][b]
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def moe_reference():
    """The reference's MoE pipeline at (pipe 2, data 2), ZeRO 1, one run:
    its initial tree, batches, losses, last norm and masters."""
    jgroups.initialize_mesh(pipe_parallel_size=2, devices=jax.devices()[:4], force=True)
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(8, 8, HIDDEN)).astype(np.float32), rng.normal(size=(8, 8)).astype(np.float32))
               for _ in range(STEPS)]
    try:
        engine = _reference_pipeline_engine(1, moe=True, example=(jnp.ones((2, 8, HIDDEN)), jnp.ones((2, 8))))
        p0 = jax.tree.map(np.asarray, jax.device_get(engine.params))
        losses = [float(engine.train_batch(batch=b)) for b in batches]
        return p0, batches, losses, engine.get_global_grad_norm(), jax.tree.map(np.asarray,
                                                                                jax.device_get(engine.params))
    finally:
        jgroups.destroy_mesh()


@pytest.mark.parametrize("mesh_kw", [{}, dict(expert_parallel_size=2)], ids=["pp2xdp2", "pp2xep2"])
def test_moe_inside_a_stage_gates_each_ranks_tokens(gang, moe_reference, mesh_kw):
    """A stage of MoE blocks (top-1 over 4 experts, capacity binding: 8
    tokens a rank and micro-batch, 2 slots an expert) beside 2 data or
    expert ranks: inside the reference's ``shard_map`` each gate sees its
    own rank's tokens and every rank holds every expert, and so does the
    port's stage (its engine sets each ``MoE.groups`` to none). The
    losses and the norm equal the reference's at (pipe 2, data 2), the
    masters within the pipeline tests' limit. The reference itself raises
    at (pipe 2, expert 2) (its expert bank's sharding constraint names an
    axis its ``shard_map`` made manual: ROADMAP C21), where its expert
    ranks are data ranks of the stage as well: the port's run there is
    held to the same (pipe 2, data 2) run."""
    p0, batches, want, norm, params = moe_reference
    res = gang.run(sc.pipe_train, "moe", 2, HIDDEN, _moe_state(p0), _cfg(1, **mesh_kw), batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
        assert r["norms"][-1] == pytest.approx(norm, rel=1e-4)
    got = _moe_state(params)
    full = {**res[0]["full"], **res[2]["full"]}
    _masters_close([full[k] for k in got], [got[k] for k in got])


def test_tied_layers_at_zero_3_match_the_reference_executor(gang):
    """An embedding tied to its transposed use on the last stage (its
    ``forward_fn`` reads the weight outside the module's forward) at
    (pipe 2, data 2), ZeRO 3, one SGD step (lr 1, no clipping): the tied
    module stays whole on both holders (no unit gathers it: ROADMAP C22),
    the middle layer is partitioned over the data ranks, and the loss and
    each master's step equal the reference ``ScheduleExecutor``'s over the
    same stage functions with the tied group [0, 1] (its ``_reduce_tied``
    summing both stages' gradients), divided by the micro-batches, within
    ``tests/test_torch_pipe.py``'s limits; the tied weight bitwise equal
    on both stages."""
    from deepspeed_tpu.runtime.pipe.executor import ScheduleExecutor
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(HIDDEN, HIDDEN)) * 0.3).astype(np.float32)
    mid = (rng.normal(size=(HIDDEN, HIDDEN)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(8, HIDDEN)).astype(np.float32)
    ys = rng.normal(size=(8, HIDDEN)).astype(np.float32)
    M = _cfg(3)["gradient_accumulation_steps"]

    def s0(p, x):
        return jnp.tanh((x @ p["w"]) @ p["mid"])

    def s1(p, x):
        return x @ p["w"].T

    def mse(y, label):
        return jnp.mean((y - label)**2)

    tree = {"w": jnp.asarray(w), "mid": jnp.asarray(mid)}
    ex = ScheduleExecutor([s0, s1], [tree, tree], mse, micro_batches=M, tied_groups=[[0, 1]])
    rows = len(xs) // M
    loss, grads = ex.train_batch([xs[rows * i:rows * (i + 1)] for i in range(M)],
                                 [ys[rows * i:rows * (i + 1)] for i in range(M)])
    cfg = dict(_cfg(3), gradient_clipping=0.0, optimizer={"type": "SGD", "params": {"lr": 1.0}})
    z3 = gang.run(sc.pipe_train, "tied", 2, HIDDEN, {"tied.emb.w": w, "layers.1.w": mid}, cfg, [(xs, ys)])
    assert z3[0]["shapes"] == {"tied.emb.w": (HIDDEN, HIDDEN), "layers.1.w": (HIDDEN // 2, HIDDEN)}
    assert z3[2]["shapes"] == {"tied.emb.w": (HIDDEN, HIDDEN)}
    for r in z3:
        assert r["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    for start, key, got in ((w, "w", "tied.emb.w"), (mid, "mid", "layers.1.w")):
        np.testing.assert_allclose(start - z3[0]["full"][got], np.asarray(grads[0][key]) / M, rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(z3[0]["full"]["tied.emb.w"], z3[2]["full"]["tied.emb.w"])
