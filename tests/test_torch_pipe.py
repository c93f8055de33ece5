"""Port parity for the pipeline engine, its instruction streams and
``TiledLinear``.

- The port's ``TrainSchedule``, ``InferenceSchedule`` and
  ``DataParallelSchedule`` give the reference's instruction streams, for
  micro-batches {1, 2, 4, 7} x stages {1, 2, 3, 4} x every stage (exact).
- ``partition_uniform`` / ``partition_balanced`` and
  ``PipelineModule.partition_layers`` give the reference's boundaries
  (exact).
- ``PipelineEngine`` at 2 stages, one gloo rank a stage
  (``tests/torch_gang.py``), against the reference's ``PipelineEngine`` on
  a 2-stage sub-mesh: the same initial weights (the reference's, through
  ``models/convert.pipeline_params_from_flax``), the same batches; per-step
  losses, the global norm and the masters. With a ``TiedLayerSpec`` (an
  embedding used again, transposed, on the last stage), against the
  reference's ``ScheduleExecutor`` with the tied group, its
  ``_reduce_tied`` summing both stages' gradients.
- ``TiledLinear`` and its tile conversions against the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.runtime.pipe.executor import ScheduleExecutor
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.pipe import module as tmodule
from deepspeed_tpu_torch.runtime.pipe import schedule as tsched
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling
from tests import torch_gang_scenarios as sc
from tests.torch_gang import Gang
from tests import torch_port_helpers  # noqa: F401  (one torch thread a process)

HIDDEN = 16
LR = 1e-2
# f32 on both sides, the same math in another order (XLA's scan against
# the stages' separate programs): the losses and norms agree to f32
# rounding; Adam carries a gradient's relative error into its step, so the
# masters are held as tests/test_torch_zero.py holds them
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)


def _stream(schedule):
    return [[(type(c).__name__, dict(c.kwargs)) for c in cmds] for cmds in schedule.steps()]


@pytest.mark.parametrize("micro", [1, 2, 4, 7])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_instruction_streams_equal_the_reference(micro, stages):
    """Every stage's train and inference streams, and the data-parallel one,
    instruction for instruction (class and buffer), with the buffer counts."""
    for s in range(stages):
        for name in ("TrainSchedule", "InferenceSchedule", "DataParallelSchedule"):
            mine, ref = getattr(tsched, name)(micro, stages, s), getattr(jsched, name)(micro, stages, s)
            assert _stream(mine) == _stream(ref), (name, micro, stages, s)
            assert mine.num_pipe_buffers() == ref.num_pipe_buffers()
    t = tsched.TrainSchedule(micro, stages, stages - 1)
    assert [t.work_at(k) for k in range(2 * (micro + stages))] == \
        [jsched.TrainSchedule(micro, stages, stages - 1).work_at(k) for k in range(2 * (micro + stages))]
    assert repr(tsched.ForwardPass(3)) == repr(jsched.ForwardPass(3)) == "ForwardPass(buffer_id=3)"


def test_partitions_equal_the_reference():
    rng = np.random.default_rng(0)
    for n in range(0, 13):
        for parts in range(1, 6):
            assert tmodule.partition_uniform(n, parts) == jmodule.partition_uniform(n, parts)
    for _ in range(40):
        weights = list(rng.integers(1, 20, size=int(rng.integers(1, 12))))
        parts = int(rng.integers(1, 5))
        assert tmodule.partition_balanced(weights, parts) == jmodule.partition_balanced(weights, parts)
    specs = [tmodule.LayerSpec(torch.nn.Linear, 4, 4) for _ in range(7)]
    jspecs = [jmodule.LayerSpec(object) for _ in range(7)]
    for method in ("uniform", "parameters", "type:linear"):
        mine = tmodule.PipelineModule(specs, num_stages=3).partition_layers(method=method)
        ref = jmodule.PipelineModule(jspecs, num_stages=3).partition_layers(method=method if method != "type:linear"
                                                                            else "type:object")
        assert mine == ref, method


# ---------------------------------------------------------------- engines --
def _cfg(gas=4, micro=2, opt=None, clip=0.0):
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas, "gradient_clipping": clip,
            "optimizer": opt or {"type": "AdamW", "params": {"lr": LR}}, "zero_optimization": {"stage": 0}}


def _batches(n, bs, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(HIDDEN, )).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bs, HIDDEN)).astype(np.float32)
        out.append((x, (x @ w).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def gang():
    g = Gang(2)
    yield g
    g.close()


@pytest.fixture(scope="module")
def reference_run():
    """The reference's PipelineEngine on 2 stages (data 1): its initial
    params, per-step losses, norm and final params."""
    import flax.linen as nn

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

    def mse(out, labels):
        return jnp.mean((out.squeeze(-1) - labels)**2)

    jgroups.initialize_mesh(pipe_parallel_size=2, devices=jax.devices()[:2], force=True)
    layers = [jmodule.LayerSpec(InProj)] + [jmodule.LayerSpec(Block) for _ in range(4)] + \
        [jmodule.LayerSpec(OutProj)]
    module = jmodule.PipelineModule(layers=layers, num_stages=2, loss_fn=mse)
    engine, _, _, _ = deepspeed_tpu.initialize(model=module, config=_cfg(clip=1.0), rng_seed=7,
                                               example_batch=(jnp.ones((2, HIDDEN)), jnp.ones((2, ))))
    p0 = jax.tree.map(np.asarray, jax.device_get(engine.params))
    batches = _batches(3, 8)
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    out = dict(p0=p0, batches=batches, losses=losses, norm=engine.get_global_grad_norm(),
               params=jax.tree.map(np.asarray, jax.device_get(engine.params)),
               eval=float(engine.eval_batch(batch=batches[0])))
    jgroups.destroy_mesh()
    return out


def test_pipeline_engine_matches_the_reference(gang, reference_run):
    """Two stages, GAS 4, AdamW with clipping: per-step losses (the same on
    both ranks), the last norm and every master against the reference's
    PipelineEngine; ``eval_batch`` after training; forward, backward and
    step raise PipelineError; every call is an accumulation boundary."""
    ref = reference_run
    module = sc.pipeline_module("mlp", 2, HIDDEN)
    state = {k: v.numpy() for k, v in convert.pipeline_params_from_flax(ref["p0"], module).items()}
    res = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(clip=1.0), ref["batches"], True)
    assert [r["stage"] for r in res] == [0, 1]
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"], **LOSS_TOL)
        assert r["norms"][-1] == pytest.approx(ref["norm"], rel=1e-4)
        assert r["raised"] == [True, True, True] and r["boundary"]
        # eval_batch runs after the third step on the port, after the
        # reference's third step too
        assert r["eval"] == pytest.approx(ref["eval"], rel=1e-4)
    # a header and a tensor for each activation, one gradient each way
    assert res[0]["sends"] == 3 * 4 * 2 and res[0]["recvs"] == 3 * 4
    assert res[1]["recvs"] == 3 * 4 * 2 and res[1]["sends"] == 3 * 4
    params = {**res[0]["params"], **res[1]["params"]}
    got = convert.pipeline_params_to_flax({k: torch.from_numpy(v) for k, v in params.items()}, module)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref["params"])):
        diff = np.abs(g - w)
        near = diff <= 0.01 * LR + 1e-4 * np.abs(w)
        assert near.mean() >= 0.995 and diff.max() <= 3 * LR, (near.mean(), diff.max())


def test_tied_layer_gradients_match_the_reference_executor(gang):
    """An embedding tied to its transposed use on the last stage: one SGD
    step (lr 1, no clipping) gives each stage's gradient of the mean loss;
    it equals the reference ScheduleExecutor's (tied group [0, 1], its
    ``_reduce_tied``) over the same stage functions, divided by the
    micro-batches, and both stages hold the same tied weight after."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(HIDDEN, HIDDEN)) * 0.3).astype(np.float32)
    mid = (rng.normal(size=(HIDDEN, HIDDEN)) * 0.3).astype(np.float32)
    M = 4
    xs = rng.normal(size=(M * 2, HIDDEN)).astype(np.float32)
    ys = rng.normal(size=(M * 2, HIDDEN)).astype(np.float32)

    def s0(p, x):
        return jnp.tanh((x @ p["w"]) @ p["mid"])

    def s1(p, x):
        return x @ p["w"].T

    def mse(y, label):
        return jnp.mean((y - label)**2)

    tree = {"w": jnp.asarray(w), "mid": jnp.asarray(mid)}
    ex = ScheduleExecutor([s0, s1], [tree, tree], mse, micro_batches=M, tied_groups=[[0, 1]])
    loss, grads = ex.train_batch([xs[2 * i:2 * i + 2] for i in range(M)], [ys[2 * i:2 * i + 2] for i in range(M)])
    state = {"tied.emb.w": w, "layers.1.w": mid}
    cfg = _cfg(gas=M, micro=2, opt={"type": "SGD", "params": {"lr": 1.0}})
    res = gang.run(sc.pipe_train, "tied", 2, HIDDEN, state, cfg, [(xs, ys)])
    for r in res:
        assert r["losses"][0] == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_allclose(w - res[0]["params"]["tied.emb.w"], np.asarray(grads[0]["w"]) / M, rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mid - res[0]["params"]["layers.1.w"], np.asarray(grads[0]["mid"]) / M, rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(res[0]["params"]["tied.emb.w"], res[1]["params"]["tied.emb.w"])


def test_pipeline_weight_layouts_round_trip(reference_run):
    """The reference's {pre, stack, post} tree -> the port's names -> back,
    bit for bit; and a LlamaModel state through the Llama pipeline's
    layout and back."""
    module = sc.pipeline_module("mlp", 2, HIDDEN)
    state = convert.pipeline_params_from_flax(reference_run["p0"], module)
    assert set(state) == {f"layers.{i}.Dense_0.{leaf}" for i in range(6) for leaf in ("weight", "bias")}
    back = convert.pipeline_params_to_flax(state, module)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(reference_run["p0"])):
        np.testing.assert_array_equal(a, b)
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    llama = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = convert.llama_state_from_pipeline(convert.pipeline_state_from_llama(llama, cfg), cfg)
    assert set(again) == set(llama) and all(torch.equal(again[k], llama[k]) for k in llama)


# ------------------------------------------------------------- TiledLinear --
@pytest.mark.parametrize("splits", [(1, 1), (2, 4), (4, 2)])
def test_tiled_linear_matches_the_reference(splits):
    """The reference's TiledLinear params carried across: outputs within f32
    rounding; the tile conversions and ``copy_params_from`` bit for bit."""
    ins, outs = splits
    jmod = jtiling.TiledLinear(features=24, in_splits=ins, out_splits=outs)
    x = np.random.default_rng(2).normal(size=(3, 5, 16)).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["bias"] = np.random.default_rng(3).normal(size=params["bias"].shape).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = ttiling.TiledLinear(16, 24, in_splits=ins, out_splits=outs)
    mod.load_state_dict(convert.tiled_linear_from_flax(params))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k, v in convert.tiled_linear_to_flax(mod.state_dict()).items():
        np.testing.assert_array_equal(v, params[k])
    dense = np.random.default_rng(4).normal(size=(16, 24)).astype(np.float32)
    tiles = ttiling.dense_kernel_to_tiles(torch.from_numpy(dense), ins, outs)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiling.dense_kernel_to_tiles(dense, ins, outs)))
    np.testing.assert_array_equal(ttiling.tiles_to_dense_kernel(tiles).numpy(), dense)
    lin = torch.nn.Linear(16, 24)
    mod.copy_params_from(lin)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), lin(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    from deepspeed_tpu_torch.runtime import zero
    assert zero.TiledLinear is ttiling.TiledLinear
