"""Port parity for expert-parallel MoE serving (the fork's disaggregated EP
and simulated gating), mirroring ``tests/unit/inference/v2/test_moe_ep.py``.

The reference runs one SPMD program over an expert axis of the 8-device CPU
mesh, each device owning a slice of the flat tokens; the port runs one
process a rank, here a gloo gang of 4 (``tests/torch_gang.py``, built once
for the module), each rank fed the reference's token slice or its own
requests. Weights come from the reference's ``init_params`` at
``MixtralConfig.tiny`` in f32, through ``models.convert.mixtral_from_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import DeepSpeedEPConfig as JEPConfig
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_factory import build_engine as jbuild_engine
from deepspeed_tpu.inference.v2.modules import moe as jmoe
from deepspeed_tpu.inference.v2.ragged.manager_configs import AllocationMode
from deepspeed_tpu.inference.v2.ragged.manager_configs import DSStateManagerConfig as JManagerConfig
from deepspeed_tpu.inference.v2.ragged.manager_configs import MemoryConfig as JMemoryConfig
from deepspeed_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from deepspeed_tpu.models.mixtral import init_params as jinit_params
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.modules import moe as tmoe
from deepspeed_tpu_torch.models.convert import mixtral_from_flax
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from tests import torch_moe_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import to_numpy_tree

EP = 4
# f32 on both sides; the two frameworks' matmuls round apart at ~1e-6 of
# the logits' scale (the reference's own EP test allows 3e-4)
LOGITS_TOL = dict(rtol=3e-4, atol=3e-4)
# one MoE layer: products of f32 rows, the weights cast and summed
MOE_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def gang():
    g = Gang(EP, timeout=180.0)
    yield g
    g.close()


@pytest.fixture(scope="module")
def setup():
    jcfg = JMixtralConfig.tiny(dtype=jnp.float32)
    _, jparams = jinit_params(jcfg)
    jparams = to_numpy_tree(jparams)
    cfg = MixtralConfig.tiny(dtype=torch.float32)
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    return jcfg, jparams, cfg, state, fields


@pytest.fixture(autouse=True)
def clean_gating():
    yield
    jmoe.disable_simulated_gating()
    tmoe.disable_simulated_gating()


def _jengine_config(capacity_factor=2.0, **kw):
    mgr = JManagerConfig(memory_config=JMemoryConfig(mode=AllocationMode.ALLOCATE, size=64), max_context=512)
    return JEngineConfig(state_manager=mgr, kv_block_size=16,
                         expert_parallel=JEPConfig(enabled=False, capacity_factor=capacity_factor), **kw)


def _jengine(jparams, jcfg, **kw):
    jgroups.initialize_mesh(force=True)  # 8 devices, no expert axis: the dense path
    return jbuild_engine(jparams, jcfg, _jengine_config(**kw))


def _engine(state, cfg, capacity_factor=2.0, **kw):
    return build_engine({k: torch.from_numpy(v) for k, v in state.items()}, cfg,
                        sc.engine_config(0, capacity_factor=capacity_factor, **kw), device="cpu")


def _batch(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, vocab, n) for u, n in enumerate(lengths)}


def _bank(jparams, layer=0):
    lp = jparams[f"layers_{layer}"]["block_sparse_moe"]
    return lp["gate"], lp["ExpertFFN_0"]["wi"], lp["ExpertFFN_0"]["wo"]


# ------------------------------------------------------------------ one rank --
def test_put_logits_match_the_reference_engine(setup):
    """One ragged put of three sequences at one rank: the port's engine
    against the reference's dense engine (the default capacity factor, 2.0)."""
    jcfg, jparams, cfg, state, _ = setup
    seqs = _batch(cfg.vocab_size, (13, 5, 24))
    ref = np.asarray(_jengine(jparams, jcfg).put(list(seqs), list(seqs.values())))
    got = _engine(state, cfg).put(list(seqs), list(seqs.values())).numpy()
    np.testing.assert_allclose(got, ref, **LOGITS_TOL)


@pytest.mark.parametrize("capacity_factor,valid", [(2.0, 32), (0.5, 32), (0.5, 21)],
                         ids=["roomy", "capacity_binds", "binds_with_padding"])
def test_dense_forward_matches_the_reference(setup, capacity_factor, valid):
    """``RaggedMoE``'s one-rank path against ``_dense_forward``: the same
    slots and drops where capacity binds (C = 8 for 64 assignments over 4
    experts), padding tokens taking no slot."""
    _, jparams, _, _, _ = setup
    gate, wi, wo = _bank(jparams)
    h = np.random.default_rng(11).normal(size=(32, gate.shape[0])).astype(np.float32)
    tv = np.arange(32) < valid
    jm = jmoe.RaggedMoE(num_experts=4, top_k=2, capacity_factor=capacity_factor)
    ref = np.asarray(jm._dense_forward(jnp.asarray(h), gate, wi, wo, jnp.asarray(tv), jax.nn.silu, None))
    tm = tmoe.RaggedMoE(num_experts=4, top_k=2, capacity_factor=capacity_factor)
    got = tm(torch.from_numpy(h), torch.from_numpy(gate), torch.from_numpy(wi), torch.from_numpy(wo),
             token_valid=torch.from_numpy(tv)).numpy()
    np.testing.assert_allclose(got, ref, **MOE_TOL)
    assert (int(tm.dropped) > 0) == (capacity_factor < 1), int(tm.dropped)
    assert int(tm.expert_counts.sum()) + int(tm.dropped) == 2 * valid


def test_top_k_ties_take_the_lower_index(setup):
    """A zero router makes every expert tie: ``jax.lax.top_k`` takes experts 0
    and 1 for every token, and so does the port (argmax, first index)."""
    _, jparams, _, _, _ = setup
    _, wi, wo = _bank(jparams)
    gate = np.zeros((wi.shape[1], 4), np.float32)
    probs = torch.softmax(torch.zeros(6, 4), dim=-1)
    _, picks = tmoe.RaggedMoE(num_experts=4)._top_k(probs)
    _, jpicks = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(jpicks))
    assert picks.tolist() == [[0, 1]] * 6
    h = np.random.default_rng(2).normal(size=(16, wi.shape[1])).astype(np.float32)
    jm = jmoe.RaggedMoE(num_experts=4, top_k=2, capacity_factor=2.0)
    ref = np.asarray(jm._dense_forward(jnp.asarray(h), gate, wi, wo, None, jax.nn.silu, None))
    got = tmoe.RaggedMoE(num_experts=4, top_k=2, capacity_factor=2.0)(
        torch.from_numpy(h), torch.from_numpy(gate), torch.from_numpy(wi), torch.from_numpy(wo)).numpy()
    np.testing.assert_allclose(got, ref, **MOE_TOL)


def test_engine_refuses_only_tensor_parallelism_and_quantization(setup):
    """EP and simulated gating build; weight quantization still raises,
    naming its item. Tensor parallelism of a MoE model is ported (its
    parity runs in ``tests/test_torch_tp.py``), so TP 2 in a world of one
    rank raises naming the world, as a Llama's does; a replica count that
    is not the world's raises. The name is kept so that the test's id
    stays the same across the change."""
    _, _, cfg, state, _ = setup
    _engine(state, cfg, simulated_gating=True).close()
    eng = build_engine({k: torch.from_numpy(v) for k, v in state.items()}, cfg, sc.engine_config(1), device="cpu")
    assert eng.expert_parallel_group is None and eng.leave_expert_group() == 0
    for key, value, error, match in (("tensor_parallel", {"tp_size": 2}, ValueError, "tp_size 2 != the comm world's 1"),
                                     ("quantization", {"enabled": True}, NotImplementedError, "A9")):
        config = sc.engine_config(0)
        config = dataclasses.replace(config, **{key: type(getattr(config, key))(**value)})
        with pytest.raises(error, match=match):
            InferenceEngineV2(eng.model, config)
    with pytest.raises(ValueError, match="replica_num 2"):
        build_engine({k: torch.from_numpy(v) for k, v in state.items()}, cfg, sc.engine_config(2), device="cpu")


# -------------------------------------------------------------- 4 gloo ranks --
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0], ids=["roomy", "capacity_binds"])
def test_ep_forward_on_4_ranks_matches_the_reference_ep_forward(setup, gang, capacity_factor):
    """Each rank owns the reference's token slice (8 of 32) and one expert:
    the two all-to-alls against ``_ep_forward`` on a 4-device expert mesh,
    the same C from the count exchange, the same drops where capacity binds
    (C = 4 for a rank's 16 assignments)."""
    _, jparams, _, _, _ = setup
    gate, wi, wo = _bank(jparams, layer=1)
    h = np.random.default_rng(11).normal(size=(32, gate.shape[0])).astype(np.float32)
    jgroups.initialize_mesh(expert_parallel_size=EP, force=True)
    jm = jmoe.RaggedMoE(num_experts=4, top_k=2, capacity_factor=capacity_factor)
    ref = np.asarray(jm(jnp.asarray(h), gate, wi, wo, mesh=jgroups.get_mesh()))
    results = gang.run(sc.ragged_moe_ep, h, gate, wi, wo, capacity_factor)
    np.testing.assert_allclose(np.concatenate([out for out, _ in results]), ref, **MOE_TOL)
    dropped = sum(d for _, d in results)
    assert (dropped > 0) == (capacity_factor < 2), dropped


def test_ep_engines_on_4_ranks_match_the_reference_dense_engine(setup, gang):
    """Each rank serves its own sequences (different buckets and token
    counts) through an EP engine at capacity factor 4.0: no assignment is
    dropped, and every rank's logits equal the reference dense engine's for
    the same sequences in one batch."""
    jcfg, jparams, cfg, state, fields = setup
    lengths = [(13, 5), (24, ), (3, 9, 1), (40, )]
    rng = np.random.default_rng(4)
    seqs_by_rank, uid = [], 0
    for lens in lengths:
        seqs_by_rank.append({uid + i: rng.integers(0, cfg.vocab_size, n) for i, n in enumerate(lens)})
        uid += len(lens)
    every = {u: t for seqs in seqs_by_rank for u, t in seqs.items()}
    ref = np.asarray(_jengine(jparams, jcfg, capacity_factor=4.0).put(list(every), list(every.values())))
    results = gang.run(sc.ep_put, state, fields, seqs_by_rank)
    row = 0
    for seqs, (out, dropped, _) in zip(seqs_by_rank, results):
        np.testing.assert_allclose(out, ref[row:row + len(seqs)], **LOGITS_TOL)
        assert dropped == 0
        row += len(seqs)


def test_ep_generate_on_4_ranks_equals_one_rank(setup, gang):
    """``generate`` on every rank at once, with uneven work: each rank's
    greedy tokens equal a one-rank engine's, and the ranks done first keep
    the busy ones in step with empty forwards while leaving."""
    _, _, cfg, state, fields = setup
    rng = np.random.default_rng(5)
    prompts_by_rank = [[rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
                       for lens in ((7, ), (12, 30), (4, 4, 20), (2, 60))]
    new_tokens = (2, 6, 4, 8)
    results = gang.run(sc.ep_generate, state, fields, prompts_by_rank, new_tokens)
    for (tokens, dense, _), prompts, n in zip(results, prompts_by_rank, new_tokens):
        assert tokens == dense and [len(t) for t in tokens] == [n] * len(prompts)
    runs = [r for _, _, r in results]
    assert runs[0] > 1 and runs[3] == 1, runs  # the first done ran on; the last one forward


def test_ep_decode_and_empty_runs_leave_the_cache_bitwise(setup, gang):
    """Rank 0 decodes by puts with an ``empty_run`` between each (the others
    leave at once, their empty forwards in step): each empty run leaves the
    KV cache bitwise, and the tokens and last logits equal the reference
    dense engine decoding the same way."""
    jcfg, jparams, _, state, fields = setup
    ctx = np.random.default_rng(3).integers(0, jcfg.vocab_size, 9).tolist()
    results = gang.run(sc.ep_decode_with_empty_runs, state, fields, ctx, 3)
    out, got_ctx, same = results[0]
    assert results[1:] == [None] * (EP - 1) and same == [True] * 3
    jeng = _jengine(jparams, jcfg, capacity_factor=4.0)
    jctx = list(ctx)
    jout = np.asarray(jeng.put([0], [np.asarray(jctx)]))
    for _ in range(3):
        jeng.empty_run()
        jctx.append(int(np.argmax(jout[0])))
        jout = np.asarray(jeng.put([0], [np.asarray(jctx[-1:])]))
    assert got_ctx == jctx
    np.testing.assert_allclose(out, jout, **LOGITS_TOL)


def test_idle_rank_heartbeats_while_another_decodes(setup, gang):
    """Rank 0 serves nothing; its scheduler's heartbeat sends ``empty_run``
    while rank 1 prefills and decodes 4 steps, within the gang's timeout;
    rank 1's tokens equal a one-rank engine's."""
    _, _, cfg, state, fields = setup
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, 11).tolist()
    results = gang.run(sc.ep_heartbeat, state, fields, prompt, 4)
    heartbeats, (tokens, dense) = results[0], results[1]
    assert tokens == dense and len(tokens) == 5
    assert heartbeats >= 5  # a prefill and 4 decode forwards, each paired with a heartbeat


def test_experts_that_do_not_divide_over_the_ranks_are_refused(setup, gang):
    """C17: the reference shards the dense compute when E % ep != 0; one
    process a rank cannot, so the build raises (6 experts over 4 ranks)."""
    _, _, _, _, fields = setup
    messages = gang.run(sc.ep_build_indivisible, dict(fields, num_local_experts=6))
    assert all(m is not None and "do not divide over 4" in m for m in messages), messages


# ------------------------------------------------------------ simulated gating --
@pytest.mark.parametrize("temperature", [0.25, 1.0, 4.0])
def test_simulated_expert_probs_equal_the_reference(temperature):
    for layer in range(3):
        for E in (4, 8):
            got = tmoe.simulated_expert_probs(layer, E, temperature=temperature).numpy()
            want = np.asarray(jmoe.simulated_expert_probs(layer, E, temperature=temperature))
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_simulated_routing_is_deterministic_and_not_the_routers(setup):
    """The simulated router: the same probabilities for the same (layer,
    seed, rank), others for another of any, routing unlike the real router,
    and first choices distributed as ``simulated_expert_probs`` (4 sigma a
    bin over 4,000 tokens). The draws are torch's, not ``jax.random``'s
    (ROADMAP C16), so the engine's logits are held only to differ from the
    real router's."""
    jcfg, jparams, cfg, state, _ = setup
    gate, _, _ = _bank(jparams)
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(4000, gate.shape[0])).astype(np.float32))
    gate = torch.from_numpy(gate)
    moe = tmoe.RaggedMoE(num_experts=4, layer_id=1)
    real = moe._router_probs(h, gate)
    tmoe.enable_simulated_gating(0.5)
    sim = moe._router_probs(h, gate, gate_seed=7, replica=1)
    assert torch.equal(sim, moe._router_probs(h, gate, gate_seed=7, replica=1))
    for other in (moe._router_probs(h, gate, gate_seed=8, replica=1), moe._router_probs(h, gate, gate_seed=7),
                  tmoe.RaggedMoE(num_experts=4, layer_id=2)._router_probs(h, gate, gate_seed=7, replica=1)):
        assert not torch.equal(sim, other)
    assert (sim.argmax(-1) != real.argmax(-1)).float().mean() > 0.3
    p = tmoe.simulated_expert_probs(1, 4).double()
    share = torch.bincount(sim.argmax(-1), minlength=4).double() / 4000
    assert ((share - p).abs() <= 4 * (p * (1 - p) / 4000).sqrt() + 1 / 4000).all(), (share, p)

    seqs = _batch(cfg.vocab_size, (16, ), seed=5)
    sim_engine = _engine(state, cfg, simulated_gating=True, simulated_gating_temperature=0.5)
    assert tmoe.simulated_gating_enabled()
    sim_logits = sim_engine.put(list(seqs), list(seqs.values())).numpy()
    tmoe.disable_simulated_gating()
    real_logits = _engine(state, cfg).put(list(seqs), list(seqs.values())).numpy()
    assert not np.allclose(sim_logits, real_logits, atol=1e-3)
