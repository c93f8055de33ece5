"""Port parity for compression training and the eigenvalue probe: the
compression primitives, the engines' masters after each technique's offset,
redundancy_clean, student_initialization, the scheduler's state, its
eigenvalue gate, the Hessian-vector product and power iteration, and the
faults C8 (a second derivative through the flash kernels raises), C9 (a
resume keeps the techniques that already fired) and C10 (a second
derivative does not go through activation recomputation), each against
deepspeed_tpu on the CPU from the same numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.compression import basic_layer as jbl
from deepspeed_tpu.compression import compress as jcompress
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JEigenvalue
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.compression import basic_layer as tbl
from deepspeed_tpu_torch.compression import compress as tcompress
from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler
from deepspeed_tpu_torch.models.convert import from_flax_params, reference_names, to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, block_hvp
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

# f32 on both sides. A transform of bitwise-equal inputs differs only where
# a mean or a sum is taken in another order (the 1- and 2-bit scales, the
# L1 norms of row and head pruning): a few ulps
F32_ROUNDING = dict(rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("bits,symmetric,per_channel", [(8, True, True), (8, False, True), (4, True, False),
                                                        (4, False, False), (2, True, True), (2, True, False),
                                                        (1, True, True), (1, True, False)])
def test_fake_quantize_matches_reference(bits, symmetric, per_channel):
    w = np.random.default_rng(bits).normal(size=(48, 16)).astype(np.float32)
    w[0, :] = 0.0
    got = tbl.fake_quantize(torch.from_numpy(w), bits=bits, symmetric=symmetric, per_channel=per_channel)
    want = np.asarray(jbl.fake_quantize(w, bits=bits, symmetric=symmetric, per_channel=per_channel))
    np.testing.assert_allclose(got.numpy(), want, **F32_ROUNDING)
    assert got.dtype == torch.float32
    if symmetric:  # zeros (pruned weights) stay zero
        assert not got[0].any()


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5])
def test_prune_masks_match_reference(ratio):
    w = np.random.default_rng(7).normal(size=(32, 24)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(tbl.row_prune_mask(torch.from_numpy(w), ratio, axis=axis).numpy(),
                                      np.asarray(jbl.row_prune_mask(w, ratio, axis=axis)))
    keep = tbl.head_prune_mask(torch.from_numpy(w), ratio, num_heads=4)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jbl.head_prune_mask(w, ratio, num_heads=4)))
    np.testing.assert_array_equal(tbl.apply_head_mask(torch.from_numpy(w), keep, 4).numpy(),
                                  np.asarray(jbl.apply_head_mask(w, np.asarray(keep.numpy()), 4)))


def _technique(offset, groups_):
    return {"shared_parameters": {"enabled": True, "schedule_offset": offset},
            "different_groups": {f"g{i}": {"params": p, "modules": m} for i, (m, p) in enumerate(groups_)}}


COMPRESSION = {
    "weight_quantization": _technique(1, [(["*q_proj*"], {"target_bits": 8}), (["*k_proj*"], {"target_bits": 2}),
                                          (["*v_proj*"], {"target_bits": 1})]),
    "sparse_pruning": _technique(2, [(["*down_proj*"], {"dense_ratio": 0.5})]),
    "row_pruning": _technique(2, [(["*gate_proj*"], {"row_sparsity": 0.25})]),
    "head_pruning": _technique(3, [(["*layers_1.self_attn.q_proj*"], {"num_heads": 4, "head_sparsity": 0.5})]),
}
SGD_LR = 1e-2


@pytest.fixture(scope="module")
def compression_runs():
    """The same tiny Llama, weights and batches through both engines with
    every technique configured (plain SGD, so that the masters the
    transforms see agree to rounding): the masters in the JAX tree after each
    step, and the port's masters just before each transform."""
    jcfg = jax_tiny(num_key_value_heads=4)
    jparams = jax_params(jcfg)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(4):
        ids = rng.integers(0, jcfg.vocab_size, size=(4, 17))
        batches.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)))
    config = {"train_micro_batch_size_per_gpu": 4, "optimizer": {"type": "SGD", "params": {"lr": SGD_LR}},
              "compression_training": COMPRESSION}
    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                config=config)
    pcfg = port_config(jcfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(pcfg),
                                                     model_parameters=port_params(jcfg, jparams), config=config,
                                                     device="cpu")
    before = {}
    apply = engine.apply_compression_transform

    def spy(sub_cfg):
        before[engine.global_steps] = ({k: v.clone() for k, v in engine.params.items()}, sub_cfg)
        apply(sub_cfg)

    engine.apply_compression_transform = spy
    out = {"port": [], "ref": [], "losses": [], "before": before, "cfg": pcfg, "engine": engine,
           "jengine": jengine}
    for b in batches:
        out["losses"].append((float(engine.train_batch(batch=b)), float(jengine.train_batch(batch=b))))
        out["port"].append(to_flax_params(engine.params, pcfg))
        out["ref"].append(to_numpy_tree(jax.device_get(jengine.params)))
    return out


def _leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_engine_masters_match_jax_engine_after_each_step(compression_runs, step):
    r = compression_runs
    np.testing.assert_allclose(*r["losses"][step], rtol=1e-5)
    for (path, got), (_, want) in zip(_leaves_with_paths(r["port"][step]), _leaves_with_paths(r["ref"][step])):
        np.testing.assert_allclose(got, want, err_msg=path, rtol=1e-5, atol=1e-7)


def test_each_technique_fires_at_its_offset_only(compression_runs):
    r = compression_runs
    assert sorted(r["before"]) == [1, 2, 3]
    fired = {step: sorted(cfg["compression_training"]) for step, (_, cfg) in r["before"].items()}
    assert fired == {1: ["weight_quantization"], 2: ["row_pruning", "sparse_pruning"], 3: ["head_pruning"]}
    # right after each offset (the next SGD step moves every weight again):
    # 8 bits, at most 256 levels a channel; 2 bits {-a, 0, a}; 1 bit {-a, a}
    after = {step: r["port"][step - 1]["model"] for step in (1, 2, 3)}
    for i in range(2):
        attn = after[1][f"layers_{i}"]["self_attn"]
        for name, levels in (("q_proj", 256), ("k_proj", 3), ("v_proj", 2)):
            assert max(len(np.unique(c)) for c in attn[name]["kernel"].T) <= levels, name
        mlp = after[2][f"layers_{i}"]["mlp"]
        assert np.mean(mlp["down_proj"]["kernel"] == 0) >= 0.5
        assert np.sum(~mlp["gate_proj"]["kernel"].any(axis=1)) == 16  # a quarter of 64 rows
    heads = after[3]["layers_1"]["self_attn"]["q_proj"]["kernel"].reshape(64, 4, 16)
    assert [bool(heads[:, h].any()) for h in range(4)].count(False) == 2
    assert all(r["port"][0]["model"]["layers_0"]["self_attn"]["q_proj"]["kernel"].T.any(axis=1))  # no head yet


@pytest.mark.parametrize("step", [1, 2, 3])
def test_transform_equals_reference_init_compression_on_the_same_masters(compression_runs, step):
    """The masters right after a transform are the JAX package's
    init_compression of the port's own masters just before it."""
    r = compression_runs
    masters, sub_cfg = r["before"][step]
    want = jcompress.init_compression(to_flax_params(masters, r["cfg"]), sub_cfg)
    got = to_flax_params({k: v for k, v in _masters_after(r, step).items()}, r["cfg"])
    for (path, g), (_, w) in zip(_leaves_with_paths(got), _leaves_with_paths(want)):
        np.testing.assert_allclose(g, w, err_msg=path, **F32_ROUNDING)


def _masters_after(r, step):
    """The port's init_compression of the masters before ``step``'s
    transform, under the engine's layout (what the engine applied)."""
    masters, sub_cfg = r["before"][step]
    return tcompress.init_compression(masters, sub_cfg, layout=reference_names(r["engine"].module))


def test_redundancy_clean_matches_reference(compression_runs):
    r = compression_runs
    params = _masters_after(r, 2)  # right after row pruning (training moves the pruned rows again)
    got = tcompress.redundancy_clean(params, {"compression_training": COMPRESSION},
                                     layout=reference_names(r["engine"].module))
    want = jcompress.redundancy_clean(to_flax_params(params, r["cfg"]), {"compression_training": COMPRESSION})
    for i in range(2):
        w = want["model"][f"layers_{i}"]["mlp"]["gate_proj"]["kernel"]
        g = got[f"layers.{i}.mlp.gate_proj.weight"]
        assert w.shape == (48, 128) and tuple(g.shape) == (128, 48)  # rows of the kernel: columns of the weight
        np.testing.assert_array_equal(g.T.numpy(), np.asarray(w))
    assert got["layers.0.mlp.up_proj.weight"] is params["layers.0.mlp.up_proj.weight"]


def test_student_initialization_matches_reference():
    t_cfg, s_cfg = jax_tiny(num_hidden_layers=4), jax_tiny(num_hidden_layers=2)
    teacher, student = jax_params(t_cfg, seed=0), jax_params(s_cfg, seed=1)
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "module_name_prefix": "model.layers", "teacher_layer": [1, 3],
        "other_module_name": ["model.embed_tokens", "model.norm", "model.lm_head"]}}}
    want = jcompress.student_initialization(student, teacher, cfg)
    # nested trees of tensors, as the JAX package takes its tree
    as_torch = lambda tree: jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), tree)
    got = tcompress.student_initialization(as_torch(student), as_torch(teacher), cfg)
    for (pg, g), (pw, w) in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)):
        assert jax.tree_util.keystr(pg) == jax.tree_util.keystr(pw)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # state_dict-keyed dicts of the port's models, named through their layouts
    s_model, t_model = LlamaForCausalLM(port_config(s_cfg)), LlamaForCausalLM(port_config(t_cfg))
    flat = tcompress.student_initialization(port_params(s_cfg, student), port_params(t_cfg, teacher), cfg,
                                            layout=reference_names(s_model), teacher_layout=reference_names(t_model))
    for (path, g), (_, w) in zip(_leaves_with_paths(to_flax_params(flat, port_config(s_cfg))),
                                 _leaves_with_paths(want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
    assert tcompress.student_initialization(student, teacher, {}) is student
    with pytest.raises(KeyError, match="layer_reduction"):
        tcompress.student_initialization(as_torch(student), as_torch(teacher), {"compression_training": {
            "layer_reduction": {"enabled": True, "module_name_prefix": "model.layers", "teacher_layer": [0, 1, 2]}}})


def test_scheduler_state_roundtrip():
    cfg = {"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 2, "frequency": 3},
        "different_groups": {"g": {"params": {"target_bits": 4}, "modules": ["*"]}}}}}
    a = CompressionScheduler(cfg)
    a.techniques["weight_quantization"]["active"] = True
    a.techniques["weight_quantization"]["last_applied"] = 5
    a.training_steps = 6
    b = CompressionScheduler(cfg)
    b.load_state_dict(a.state_dict())
    assert b.training_steps == 6
    assert b.techniques["weight_quantization"]["active"]
    assert b.techniques["weight_quantization"]["last_applied"] == 5
    assert b.state_dict() == a.state_dict()


# ------------------------------------------------------------------ eigenvalue --
def test_eigenvalue_quadratic():
    """For loss = 0.5 xᵀ A x the Hessian is A: power iteration finds each
    block's dominant eigenvalue (then scales the max to 1.0), as
    tests/unit/runtime/test_small_features.py checks the JAX package."""
    A = torch.diag(torch.tensor([4.0, 1.0, 0.25]))
    B = torch.diag(torch.tensor([8.0, 2.0]))
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    ev = Eigenvalue(max_iter=200, tol=1e-6)
    out = ev.compute_eigenvalue(lambda p, batch: 0.5 * p["a"] @ A @ p["a"] + 0.5 * p["b"] @ B @ p["b"], params,
                                batch=None)
    np.testing.assert_allclose(out["b"], 1.0, rtol=1e-3)
    np.testing.assert_allclose(out["a"], 0.5, rtol=1e-3)
    np.testing.assert_allclose([ev.last_raw["a"], ev.last_raw["b"]], [4.0, 8.0], rtol=1e-3)
    assert all(ev.last_converged.values())


def _two_block_problem():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.normal(size=(32, 3)).astype(np.float32)
    params = {"a": {"kernel": rng.normal(size=(6, 5)).astype(np.float32) * 0.5,
                    "bias": rng.normal(size=(5, )).astype(np.float32) * 0.1},
              "b": {"kernel": rng.normal(size=(5, 3)).astype(np.float32) * 0.5,
                    "bias": rng.normal(size=(3, )).astype(np.float32) * 0.1}}

    def jloss(p, batch):
        h = jnp.tanh(batch[0] @ p["a"]["kernel"] + p["a"]["bias"])
        return jnp.mean((h @ p["b"]["kernel"] + p["b"]["bias"] - batch[1])**2)

    def tloss(p, batch):
        h = torch.tanh(batch[0] @ p["a"]["kernel"] + p["a"]["bias"])
        return ((h @ p["b"]["kernel"] + p["b"]["bias"] - batch[1])**2).mean()

    tparams = jax.tree.map(torch.from_numpy, params)
    return params, (jnp.asarray(x), jnp.asarray(y)), jloss, tparams, (torch.from_numpy(x), torch.from_numpy(y)), tloss


def test_converged_eigenvalues_match_reference_within_two_tol():
    params, jbatch, jloss, tparams, tbatch, tloss = _two_block_problem()
    tol = 1e-4
    want = JEigenvalue(max_iter=2000, tol=tol).compute_eigenvalue(jloss, params, jbatch)
    ev = Eigenvalue(max_iter=2000, tol=tol)
    got = ev.compute_eigenvalue(tloss, tparams, tbatch)
    assert all(ev.last_converged.values())
    for block in ("a", "b"):
        assert abs(got[block] - want[block]) <= 2 * tol, (block, got, want)
        # the raw value against the block's largest-magnitude eigenvalue (dense Hessian)
        flat, unravel = ravel_pytree(params[block])
        hess = jax.hessian(lambda f: jloss({**params, block: unravel(f)}, jbatch))(flat)
        eigs = np.linalg.eigvalsh(np.asarray(hess, np.float64))
        top = eigs[np.argmax(np.abs(eigs))]
        # on the stopping rule's scale, tol·max(|λ|, 1)
        assert abs(ev.last_raw[block] - top) <= 2 * tol * max(abs(top), 1.0), (block, ev.last_raw[block], top)


@pytest.fixture(scope="module")
def llama_hvp_case():
    jcfg = jax_tiny(num_key_value_heads=2)
    jparams = jax_params(jcfg)
    rng = np.random.default_rng(12)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 17))
    batch = (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    v = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), to_numpy_tree(jparams))
    return jcfg, jparams, batch, v


def _port_loss(model):
    def loss_fn(p, batch):
        return functional_call(model, p["model"], (batch, ))
    return loss_fn


def test_hvp_matches_reference_jvp_of_grad(llama_hvp_case):
    jcfg, jparams, batch, v = llama_hvp_case
    jloss = lambda p: jllama.LlamaForCausalLM(jcfg).apply({"params": p}, batch)
    want = jax.jvp(jax.grad(jloss), (jparams, ), (v, ))[1]
    pcfg = port_config(jcfg)
    model = LlamaForCausalLM(pcfg)
    params = port_params(jcfg, jparams)
    pv = from_flax_params(v, pcfg)
    names = sorted(params)
    hv = block_hvp(_port_loss(model), "model")({"model": params}, tuple(map(torch.from_numpy, batch)),
                                              [pv[n] for n in names])
    got = to_flax_params(dict(zip(names, hv)), pcfg)
    g = np.concatenate([x.ravel() for _, x in _leaves_with_paths(got)])
    w = np.concatenate([np.asarray(x).ravel() for _, x in _leaves_with_paths(want)])
    # f32 on both sides, summed in other orders: 1e-5 of the product's norm
    assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), np.linalg.norm(g - w) / np.linalg.norm(w)


def _llama_engine(jcfg, jparams, extra=None, **cfg_kw):
    pcfg = dataclasses.replace(port_config(jcfg), **cfg_kw)
    config = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              **(extra or {})}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(pcfg),
                                                     model_parameters=port_params(jcfg, jparams), config=config,
                                                     device="cpu")
    return engine


def test_loss_curvature_raises_through_the_flash_kernels_in_both_packages(llama_hvp_case):
    """C8: the flash kernels have no second derivative. The JAX package's
    custom_vjp raises under jax.jvp; the port's once_differentiable backward
    raises in the HVP, where it used to drop the attention's second-order
    terms."""
    jcfg, jparams, batch, _ = llama_hvp_case
    fcfg = dataclasses.replace(jcfg, use_flash_attention=True)
    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(fcfg), model_parameters=jparams,
                                                config={"train_micro_batch_size_per_gpu": 2})
    jengine.forward(batch)
    with pytest.raises(Exception):
        jengine.loss_curvature()
    engine = _llama_engine(jcfg, jparams, use_flash_attention=True)
    engine.forward(tuple(map(torch.from_numpy, batch)))
    with pytest.raises(RuntimeError, match="once_differentiable"):
        engine.loss_curvature()
    # the same model with plain attention probes to a finite value
    plain = _llama_engine(jcfg, jparams)
    plain.forward(tuple(map(torch.from_numpy, batch)))
    jplain, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                               config={"train_micro_batch_size_per_gpu": 2})
    jplain.forward(batch)
    assert plain.loss_curvature() == jplain.loss_curvature() == 1.0  # one block ("model"), scaled to 1
    eig = plain._eig_state[0]
    assert list(eig.last_raw) == ["model"] and np.isfinite(eig.last_raw["model"]) and eig.last_iters["model"] <= 8


def test_c10_loss_curvature_does_not_differentiate_twice_through_recomputation(llama_hvp_case):
    """C10: a second derivative through torch.utils.checkpoint raises under
    the "dots" policy (jax.checkpoint composes with jax.jvp, so the JAX
    engine probes a remat model). loss_curvature turns recomputation off: an
    engine under either policy probes the values of one without remat."""
    jcfg, jparams, batch, v = llama_hvp_case
    tb = tuple(map(torch.from_numpy, batch))
    raws = {}
    for policy in (None, "nothing", "dots"):
        engine = _llama_engine(jcfg, jparams, remat=policy is not None, remat_policy=policy or "nothing")
        engine.forward(tb)
        engine.loss_curvature()
        raws[policy] = engine._eig_state[0].last_raw["model"]
    assert raws["nothing"] == pytest.approx(raws[None], rel=1e-5) and raws["dots"] == pytest.approx(raws[None],
                                                                                                rel=1e-5)
    # the control: the same product with recomputation left on raises
    pcfg = port_config(jcfg)
    params = port_params(jcfg, jparams)
    pv = from_flax_params(v, pcfg)
    model = LlamaForCausalLM(dataclasses.replace(pcfg, remat=True, remat_policy="dots"))
    model.load_state_dict(params)
    with pytest.raises(RuntimeError, match="backward an extra time"):
        block_hvp(_port_loss(model), "model")({"model": params}, tb, [pv[n] for n in sorted(params)])
    # the JAX engine probes the remat model
    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(dataclasses.replace(jcfg, remat=True, remat_policy="dots")),
        model_parameters=jparams, config={"train_micro_batch_size_per_gpu": 2})
    jengine.forward(batch)
    assert jengine.loss_curvature() == 1.0


def _mlp_engine(extra):
    from tests.test_torch_training import SimpleModel
    config = {"train_micro_batch_size_per_gpu": 16, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **extra}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config=config, device="cpu")
    return engine


def test_eigenvalue_gate_defers_activation():
    """eigenvalue_gated quantization waits for curvature below the
    threshold: with an impossible threshold it never fires, with a huge one
    it fires at the offset (tests/unit/compression/test_compression_scheduler.py)."""
    from tests.test_torch_training import _random_batches

    def run(threshold):
        eng = _mlp_engine({"compression_training": {"weight_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 1, "eigenvalue_gated": True,
                                  "eigenvalue_threshold": threshold},
            "different_groups": {"g": {"params": {"target_bits": 4}, "modules": ["*"]}}}}})
        fired = []
        orig = eng.apply_compression_transform
        eng.apply_compression_transform = lambda c: (fired.append(eng.global_steps), orig(c))
        for b in _random_batches(4, 16):
            eng.train_batch(batch=b)
        return fired, eng

    fired, eng = run(1e-30)
    assert fired == [] and eng.compression_scheduler._last_curvature == 1.0
    assert sorted(eng._eig_state[0].last_raw) == ["head", "layers"]  # the first name components
    assert run(1e30)[0] == [1]


def test_eigenvalue_config_block_and_accessors():
    eng = _mlp_engine({"eigenvalue": {"enabled": True, "max_iter": 10, "tol": 1e-2, "layer_name": "layers"}})
    assert eng.eigenvalue is not None and eng.eigenvalue.max_iter == 10
    assert (eng.eigenvalue_enabled(), eng.eigenvalue_max_iter(), eng.eigenvalue_tol(), eng.eigenvalue_layer_name(),
            eng.eigenvalue_stability()) == (True, 10, 1e-2, "layers", 1e-6)
    assert eng.loss_curvature() is None  # no batch seen yet


def test_c9_resume_does_not_fire_a_once_only_technique_again(tmp_path):
    """C9: the JAX package's checkpoint does not carry the compression
    scheduler's state, so a resumed run applies a once-only technique again.
    The port saves it in host_state.pkl: the resumed run equals the one that
    never stopped, and (the control) a checkpoint without it does not."""
    import pickle
    from tests.test_torch_training import _random_batches
    comp = {"compression_training": {"weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"g": {"params": {"target_bits": 4}, "modules": ["*layers*"]}}}}}
    batches = _random_batches(5, 16)
    a = _mlp_engine(comp)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path))
    for b in batches[2:]:
        a.train_batch(batch=b)
    resumed = _mlp_engine(comp)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.compression_scheduler.techniques["weight_quantization"]["active"]
    for b in batches[2:]:
        resumed.train_batch(batch=b)
    for name in a.params:
        assert torch.equal(a.params[name], resumed.params[name]), name
    # the control: the same tag without the scheduler's state fires again at step 3
    host = tmp_path / "global_step2" / "host_state.pkl"
    state = pickle.loads(host.read_bytes())
    state["compression_scheduler"] = None
    host.write_bytes(pickle.dumps(state))
    control = _mlp_engine({**comp, "checkpoint": {"verify_on_load": False}})  # its file CRC changed
    control.load_checkpoint(str(tmp_path), tag="global_step2")
    fired = []
    orig = control.apply_compression_transform
    control.apply_compression_transform = lambda c: (fired.append(control.global_steps), orig(c))
    for b in batches[2:]:
        control.train_batch(batch=b)
    assert fired == [3]
    assert any(not torch.equal(a.params[n], control.params[n]) for n in a.params)
