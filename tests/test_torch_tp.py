"""Port parity for tensor parallelism (``module_inject/{auto_tp,layers}.py``,
the engine's ``model`` axis, and the ragged engine under ``tp_size``) over
gloo gangs of 2 and 4 ranks, one rank a model (or data x model) slot.

The reference side is the JAX package: ``auto_tp_specs`` on the flax trees
(the converter maps the port's names and layouts onto them), its engine at
world 1 on the same global batch (GSPMD makes the tensor-parallel run the
same result, which ``tests/unit/module_inject/test_auto_tp.py`` checks), and
its ragged engine on a ``model=2`` mesh as ``tests/unit/inference/v2/
test_tp_inference.py::test_tp_llama_matches_single`` builds it. f32 on
both sides.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.v2.engine_factory import build_engine as jbuild_engine
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.module_inject.auto_tp import auto_tp_specs as jauto_tp_specs
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
from deepspeed_tpu_torch.models.convert import mixtral_to_flax, to_flax_params
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.module_inject import auto_tp_specs
from tests import torch_parallel_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import port_config, port_params, to_numpy_tree
from tests.unit.inference.v2.test_tp_inference import _ecfg as jecfg

# the reference tests' limits: test_tp_training_parity's masters after 2
# AdamW steps, test_tp_llama_matches_single's logits
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=3e-4, atol=3e-4)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def gangs():
    made = {2: Gang(2), 4: Gang(4)}
    yield made
    for g in made.values():
        g.close()


@pytest.fixture(scope="module")
def llama():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    _, raw = jllama.init_params(jcfg)
    jparams = to_numpy_tree(raw)
    pcfg = port_config(jcfg)
    fields = {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__ if f != "dtype"}
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    return jcfg, jparams, pcfg, fields, state, raw


# ------------------------------------------------------------- auto_tp_specs --
def _as_reference_specs(specs, shapes, to_flax):
    """The port's placements in the reference's layout: each parameter's
    marker tensor (its index along the placed dim, negative on the expert
    axis) goes through the converter, and the dim along which the marker
    varies there is the reference's dim."""
    markers = {}
    for name, shape in shapes.items():
        m = torch.zeros(shape)
        if specs[name] is not None:
            axis, dim = specs[name]
            idx = torch.arange(1, shape[dim] + 1, dtype=torch.float32) * (1 if axis == "model" else -1)
            m = m + idx.reshape([-1 if d == dim else 1 for d in range(len(shape))])
        markers[name] = m
    out = {}
    for path, arr in jtu.tree_flatten_with_path(to_flax(markers))[0]:
        varying = [d for d in range(arr.ndim) if arr.shape[d] > 1 and np.ptp(arr, axis=d).any()]
        spec = [None] * arr.ndim
        for d in varying:
            spec[d] = "model" if arr.max() > 0 else "expert"
        out[jtu.keystr(path)] = tuple(spec)
    return out


def _reference_specs(params):
    """The reference's specs of its tree as ``init`` returns it (in call
    order: a ``jax.tree.map`` copy sorts the keys, which AutoTP reads)."""
    return {jtu.keystr(k): tuple(v) + (None, ) * (np.ndim(leaf) - len(tuple(v)))
            for (k, v), leaf in zip(jtu.tree_flatten_with_path(jauto_tp_specs(params))[0], jax.tree.leaves(params))}


def test_auto_tp_specs_match_the_reference_on_llama(llama):
    """``test_llama_matches_hand_written``: q/k/v/gate/up and lm_head
    column-parallel, o/down row-parallel, the embedding on its features,
    norms replicated; name for name against the reference's specs of the
    converted flax tree."""
    _, _, pcfg, _, _, raw = llama
    model = LlamaForCausalLM(pcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = _as_reference_specs(auto_tp_specs(model), shapes, lambda sd: to_flax_params(sd, pcfg))
    want = _reference_specs(raw)
    assert got == want
    assert sum(s != (None, ) * len(s) for s in got.values()) == 2 * 7 + 2


def test_auto_tp_specs_mha_ends_the_row_at_o_proj():
    """Multi-head attention (as many KV heads as query heads): q, k and v
    all project to the residual width. The reference's scan marks k
    row-parallel, which is no Megatron layout; the port's refinement marks
    o, the last of the run, and k column-parallel like q and v. Everything
    else is the reference's, name for name."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, num_key_value_heads=4)
    _, raw = jllama.init_params(jcfg)
    pcfg = port_config(jcfg)
    model = LlamaForCausalLM(pcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = _as_reference_specs(auto_tp_specs(model), shapes, lambda sd: to_flax_params(sd, pcfg))
    want = _reference_specs(raw)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == {f"['model']['layers_{i}']['self_attn']['k_proj']['kernel']" for i in range(2)}
    for i in range(2):
        attn = f"['model']['layers_{i}']['self_attn']"
        assert want[f"{attn}['k_proj']['kernel']"] == ("model", None)
        assert [got[f"{attn}['{p}']['kernel']"] for p in ("q_proj", "k_proj", "v_proj", "o_proj")] == \
            [(None, "model")] * 3 + [("model", None)]


def test_auto_tp_specs_match_the_reference_on_mixtral():
    """``test_mixtral_expert_banks_and_attention``: the banks on the expert
    axis, the router replicated, attention column/row-parallel."""
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32)
    _, jparams = jmixtral.init_params(jcfg)
    cfg = MixtralConfig.tiny(dtype=torch.float32)
    model = MixtralForCausalLM(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = _as_reference_specs(auto_tp_specs(model), shapes, lambda sd: mixtral_to_flax(sd, cfg))
    want = _reference_specs(jparams)
    assert got == want
    assert got["['layers_0']['block_sparse_moe']['ExpertFFN_0']['wi']"] == ("expert", None, None)
    assert got["['layers_0']['block_sparse_moe']['gate']"] == (None, None)


# ------------------------------------------------------------------ training --
def _ds_config(tp, micro, stage):
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 1, "tensor_parallel_size": tp,
            "gradient_clipping": 1.0, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": stage}}


@pytest.fixture(scope="module")
def reference_training(llama):
    """``test_tp_training_parity``'s Llama leg: two AdamW steps of one
    8-row batch, by the JAX engine at world 1."""
    jcfg, jparams, _, _, _, _ = llama
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, size=(8, 16)).astype(np.int32)
    batch = (ids, ids.copy())
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)
    engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                               config=_ds_config(1, 8, 0))
    losses = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    norm = engine.get_global_grad_norm()
    jgroups.destroy_mesh()
    return batch, losses, params, norm


@pytest.mark.parametrize("world,stage", [(2, 0), (4, 1), (4, 2), (4, 3)],
                         ids=["tp2_zero0", "dp2xtp2_zero1", "dp2xtp2_zero2", "dp2xtp2_zero3"])
def test_tp_training_matches_the_reference(gangs, llama, reference_training, world, stage):
    """``test_tp_training_parity`` at tp 2 (clipped at norm 1), alone and
    under 2 data ranks at ZeRO 1-3 (ZeRO partitions each rank's local shards
    over the data ranks): the losses and the global norm, and the gathered
    masters within the reference test's limits; every rank holds half of
    each placed tensor."""
    _, _, pcfg, fields, state, _ = llama
    batch, want_losses, want_params, want_norm = reference_training
    res = gangs[world].run(sc.train_llama_tp, fields, state, _ds_config(2, 8 // (world // 2), stage), [batch] * 2)
    assert want_norm > 1.0  # the clip binds: the global norm over the shards decides the step
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
        assert r["norm"] == pytest.approx(want_norm, rel=1e-4)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    for g, w in zip(got, want_params):
        np.testing.assert_allclose(g, w, **PARAM_TOL)
    specs = res[0]["specs"]
    if stage < 3:
        for name, spec in specs.items():
            if spec is not None:
                assert res[0]["local"][name].shape[spec[1]] * 2 == res[0]["full"][name].shape[spec[1]], name


# ------------------------------------------------------------- the TP engine --
SEQS = {0: np.random.default_rng(0).integers(0, 256, 19), 1: np.random.default_rng(1).integers(0, 256, 7)}


def test_tp_put_matches_the_reference_tp_engine(gangs, llama):
    """``test_tp_llama_matches_single``: the put logits of a TP=2 engine
    against the reference's TP=2 engine (on a ``model=2`` mesh), rtol/atol
    3e-4; each rank holds 2 of the 4 query heads and 1 of the 2 KV heads,
    and its KV cache is that wide."""
    jcfg, jparams, _, fields, state, _ = llama
    jgroups.initialize_mesh(model_parallel_size=2, devices=jax.devices()[:2], force=True)
    want = np.asarray(jbuild_engine({"model": jparams["model"]}, jcfg, jecfg(tp=2)).put(list(SEQS),
                                                                                       list(SEQS.values())))
    jgroups.destroy_mesh()
    res = gangs[2].run(sc.tp_put, fields, state, list(SEQS), [s.tolist() for s in SEQS.values()])
    np.testing.assert_allclose(res[0]["logits"], want, **LOGIT_TOL)
    for r in res:
        assert r["heads"] == (2, 1)
        assert r["cache_shape"][-3] == 1


def test_tp_generate_matches_one_rank_and_the_follower_keeps_step(gangs, llama):
    """Greedy ``generate`` of three prompts on rank 0 (its serving scheduler
    the only one), rank 1 following every engine call under the gang's
    timeout: the tokens equal a one-rank engine's."""
    _, _, pcfg, fields, state, _ = llama
    prompts = [SEQS[0].tolist(), SEQS[1].tolist(), list(range(3, 40))]
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode="allocate", size=64), max_context=512)
    one = build_engine({k: torch.from_numpy(v) for k, v in state.items()}, pcfg,
                       RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16), device="cpu")
    want = generate(one, prompts, max_new_tokens=6)
    res = gangs[2].run(sc.tp_generate, fields, state, prompts, 6)
    assert res[0] == want
    assert isinstance(res[1], int) and res[1] >= 6  # the follower's repeated calls


def test_tp_generate_short_of_kv_blocks_keeps_step(gangs, llama):
    """Chunked greedy ``generate`` on a pool too small for a chunk: each
    ``decode_loop`` of 4 steps raises KVCacheLimitExceeded on both ranks
    and rank 0's scheduler falls back to single steps, which rank 1 must
    follow (a follower that stops at the error leaves rank 0 waiting, and
    the gang's timeout fails the test). Two prompts of 30 tokens hold 2 of
    the 4 blocks of 16 each; the tokens equal a one-rank engine's on the
    same pool."""
    _, _, pcfg, fields, state, _ = llama
    prompts = [SEQS[0].tolist() + list(range(11)), list(range(5, 35))]
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode="allocate", size=4), max_context=512)
    one = build_engine({k: torch.from_numpy(v) for k, v in state.items()}, pcfg,
                       RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16), device="cpu")
    want = generate(one, prompts, max_new_tokens=3, decode_chunk=4)
    res = gangs[2].run(sc.tp_generate, fields, state, prompts, 3, 4, 4)
    assert res[0] == want
    assert [len(t) for t in want] == [3, 3]
    assert isinstance(res[1], int) and res[1] >= 3


# ------------------------------------------------------ Mixtral, TP and TP x EP --
@pytest.fixture(scope="module")
def mixtral():
    """A tiny Mixtral from the reference's ``init_params`` (f32), its
    requests for two expert ranks, and a one-rank port engine's logits and
    greedy tokens for each rank's requests (the dense path at the same
    capacity factor, 4.0: nothing drops)."""
    from deepspeed_tpu_torch.models.convert import mixtral_from_flax
    from tests import torch_composed_scenarios as csc
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32)
    _, jparams = jmixtral.init_params(jcfg)
    jparams = to_numpy_tree(jparams)
    cfg = MixtralConfig.tiny(dtype=torch.float32)
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f not in ("dtype", "sequence_parallel")}
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    requests = [{0: SEQS[0].tolist(), 1: list(range(3, 12))}, {2: SEQS[1].tolist() + list(range(40, 45))}]
    one = csc._tp_ep_engine(fields, state, 1, 1)
    want = []
    for seqs in requests:
        logits = one.put(list(seqs), [np.asarray(t) for t in seqs.values()]).numpy()
        one.flush_all()
        want.append((logits, generate(one, [list(t) for t in seqs.values()], max_new_tokens=6)))
    one.close()
    return jcfg, jparams, fields, state, requests, want


def test_tp_mixtral_serves_as_one_rank(gangs, mixtral):
    """A Mixtral at TP 2 without expert parallelism: each rank holds 2 of
    the 4 query heads and 1 of the 2 KV heads and every expert's bank
    whole; rank 0's put logits equal one rank's within the reference's TP
    limit and its greedy tokens equal one rank's, rank 1 following."""
    _, _, fields, state, requests, want = mixtral
    from tests import torch_composed_scenarios as csc
    res = gangs[2].run(csc.tp_ep_serve, fields, state, 2, 1, requests[:1], 6)
    np.testing.assert_allclose(res[0]["logits"], want[0][0], **LOGIT_TOL)
    assert res[0]["tokens"] == want[0][1]
    assert res[1]["follows"] >= 6
    for r in res:
        assert r["heads"] == (2, 1) and r["bank"] == (4, 64, 256)


@pytest.mark.parametrize("key,value,item", [("expert_parallel", {"enabled": True, "replica_num": 2}, "A8 item 5"),
                                            ("quantization", {"enabled": True}, "A9")],
                         ids=["tp_x_ep", "tp_x_quantization"])
def test_tp_engine_refusals_remain(gangs, llama, mixtral, key, value, item):
    """TP with weight quantization still raises, naming its ROADMAP item.
    TP with expert parallelism is ported, and its case is now the
    reference's ``test_tp_plus_ep_mixtral``: a Mixtral at TP 2 x EP 2 over
    the 4 ranks (each expert rank's two model ranks hold its 2 experts
    whole and half the heads), each expert rank's leader putting its own
    requests; the logits equal the reference's engine on a (model 2,
    expert 2) mesh, which puts every request in one batch, within
    rtol/atol 3e-4, and each leader's greedy tokens equal one rank's. The
    name is kept so that the test's id stays the same across the change."""
    if key == "expert_parallel":
        jcfg, jparams, fields, state, requests, want = mixtral
        from tests import torch_composed_scenarios as csc
        every = {u: np.asarray(t) for seqs in requests for u, t in seqs.items()}
        jgroups.initialize_mesh(model_parallel_size=2, expert_parallel_size=2, devices=jax.devices()[:4], force=True)
        ref = np.asarray(jbuild_engine(jparams, jcfg, jecfg(tp=2, ep=2)).put(list(every), list(every.values())))
        jgroups.destroy_mesh()
        res = gangs[4].run(csc.tp_ep_serve, fields, state, 2, 2, requests, 6)
        leaders = [r for r in res if "logits" in r]
        assert sorted(r["ep_rank"] for r in leaders) == [0, 1]
        for r in leaders:
            rows = [list(every).index(u) for u in requests[r["ep_rank"]]]
            np.testing.assert_allclose(r["logits"], ref[rows], **LOGIT_TOL)
            assert r["tokens"] == want[r["ep_rank"]][1]
            assert r["dropped"] == 0
        for r in res:
            assert r["heads"] == (2, 1) and r["bank"] == (2, 64, 256)
        return
    _, _, _, fields, state, _ = llama
    for msg in gangs[2].run(sc.tp_refusal, fields, state, key, value):
        assert msg is not None and item in msg


def _moe_ds(extra):
    return dict({"train_batch_size": 8, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, **extra)


@pytest.fixture(scope="module")
def moe_world1(mixtral):
    """Two steps of the tiny Mixtral at capacity 0.5 (binding) on one rank,
    in this process: the losses, drops and masters the lifted training
    cases are held to, and their inputs."""
    from tests import torch_composed_scenarios as csc
    _, _, fields, state, _, _ = mixtral
    fields = dict(fields, capacity_factor=0.5)
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 256, (8, 16)).astype(np.int32), rng.integers(0, 256, (8, 16)).astype(np.int32))
               for _ in range(2)]
    return fields, state, batches, csc.train("mixtral", fields, state, _moe_ds({}), batches)


@pytest.mark.parametrize("kind,extra,what", [
    ("mixtral", {"tensor_parallel_size": 2}, "tensor parallelism of a MoE model"),
    ("mixtral", {"sequence_parallel_size": 2}, "sequence parallelism of a MoE model"),
    ("mixtral", {"expert_parallel_size": 2, "zero_optimization": {"stage": 3,
                                                                  "stage3_param_persistence_threshold": 0}},
     "expert parallelism at ZeRO stage 3"),
    ("llama", {"tensor_parallel_size": 2, "zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
     "tensor parallelism with offload"),
    ("llama", {"sequence_parallel_size": 2, "zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
     "sequence parallelism with qgZ"),
    ("llama", {"tensor_parallel_size": 2, "zero_optimization": {"stage": 3, "mics_shard_size": 2}},
     "tensor parallelism with hpZ/MiCS"),
], ids=["tp_moe", "sp_moe", "ep_zero3", "tp_offload", "sp_qgz", "tp_mics"])
def test_training_refusals_remain(gangs, llama, moe_world1, kind, extra, what):
    """What stays refused in training names A8 item 5. TP of a MoE model,
    Ulysses of a MoE model and expert ranks at ZeRO 3 are ported, and each
    of their cases now trains two steps of a tiny Mixtral over the gang of 2
    (capacity binding): the losses on both ranks and every gate's drops
    equal one rank's, and the gathered masters within AdamW's limit (99.5%
    of each tensor within 1% of an lr step, every element within 2 lr;
    ``tests/test_torch_composed_train.py`` holds the same runs at 4 ranks to
    the JAX engine). The name
    is kept so that the test's id stays the same across the change."""
    if kind == "mixtral":
        from tests import torch_composed_scenarios as csc
        fields, state, batches, one = moe_world1
        res = gangs[2].run(csc.train, "mixtral", fields, state, _moe_ds(extra), batches)
        assert sum(one["drops"]) > 0
        for r in res:
            np.testing.assert_allclose(r["losses"], one["losses"], **LOSS_TOL)
            assert r["drops"] == one["drops"]
        for name, w in one["full"].items():  # AdamW's limit of tests/test_torch_composed_train.py
            diff = np.abs(res[0]["full"][name] - w)
            assert np.mean(diff <= 1e-5 + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= 2e-3, name
        return
    _, _, _, fields, _, _ = llama
    ds = dict({"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, **extra)
    for msg in gangs[2].run(sc.refusal, kind, fields, ds):
        assert msg is not None and what in msg and "A8 item 5" in msg
