"""Port parity: the ragged v2 engine of deepspeed_tpu_torch against deepspeed_tpu's.

Both engines get the same weights (the JAX init through from_flax_params),
the same prompts and the same engine settings, in f32 on the CPU. For each
attention branch (``use_paged_kernel`` True: the kernel's plain version on
the CPU, False: the gather path) the port's ``put`` logits must match the
JAX engine run with the same setting, and its greedy ``generate`` tokens
must be identical. The remaining cases mirror
tests/unit/inference/v2/test_engine_v2.py on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError, SchedulingResult
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_params
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

# f32 on both sides; XLA's and torch's CPU matmuls sum in different orders
# (~1e-6 relative per op), compounded over two layers and the unembedding
TOL = dict(rtol=1e-4, atol=1e-4)

PROMPTS = {0: 17, 1: 5, 2: 33}  # uid -> prompt length, prefilled in one put
GEN_PROMPTS = (4, 11)
N_DECODE, N_NEW = 3, 5


def _port_config(num_blocks=64, block_size=16, use_paged_kernel=None, max_context=512, **kw):
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=num_blocks),
                               max_context=max_context, **kw)
    return RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=block_size,
                                       use_paged_kernel=use_paged_kernel)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    jparams = jax_params(jcfg)
    rng = np.random.default_rng(0)
    prompts = {u: rng.integers(0, jcfg.vocab_size, n) for u, n in PROMPTS.items()}
    gen_prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in GEN_PROMPTS]
    return jcfg, jparams, port_config(jcfg), port_params(jcfg, jparams), prompts, gen_prompts


def _scenario(put, argmax, flush_all, gen, prompts, gen_prompts):
    """Prefill three sequences in one put, decode N_DECODE steps one put each,
    then (all flushed) greedy-generate two more prompts, and again with the
    third token of the first as the eos token."""
    logits = [put(list(prompts), list(prompts.values()))]
    for _ in range(N_DECODE):
        nxt = argmax(logits[-1])
        logits.append(put(list(prompts), [np.asarray([t]) for t in nxt]))
    flush_all()
    tokens = gen(gen_prompts, None)
    return logits, tokens, gen(gen_prompts, int(tokens[0][2]))


@pytest.fixture(scope="module")
def jax_run(setup):
    """The scenario on the JAX engine, once per attention branch."""
    runs = {}

    def run(kernel):
        if kernel not in runs:
            jcfg, jparams, _, _, prompts, gen_prompts = setup
            mgr = j_mc.DSStateManagerConfig(
                memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE, size=64), max_context=512)
            eng = j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(
                state_manager=mgr, kv_block_size=16, use_paged_kernel=kernel))
            runs[kernel] = _scenario(lambda u, t: np.asarray(eng.put(u, t)), lambda lg: np.argmax(lg, -1),
                                     eng.flush_all,
                                     lambda p, eos: j_factory.generate(eng, p, max_new_tokens=N_NEW,
                                                                       eos_token_id=eos),
                                     prompts, gen_prompts)
        return runs[kernel]

    return run


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "paged_kernel"])
def test_put_logits_and_greedy_generate_match_jax_engine(setup, jax_run, kernel):
    _, _, cfg, params, prompts, gen_prompts = setup
    eng = build_engine(params, cfg, _port_config(use_paged_kernel=kernel), device="cpu")
    got_logits, *got_tokens = _scenario(
        lambda u, t: eng.put(u, t).numpy(), lambda lg: np.argmax(lg, -1), eng.flush_all,
        lambda p, eos: generate(eng, p, max_new_tokens=N_NEW, eos_token_id=eos, decode_chunk=2), prompts,
        gen_prompts)
    want_logits, *want_tokens = jax_run(kernel)
    for step, (got, want) in enumerate(zip(got_logits, want_logits)):
        assert got.shape == want.shape == (len(prompts), cfg.vocab_size)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {step}")
    for got, want in zip(got_tokens, want_tokens):  # without and with eos
        assert got == [[int(t) for t in toks] for toks in want]
    assert len(got_tokens[1][0]) == 3 and got_tokens[1][0][-1] == got_tokens[0][0][2]
    assert eng.free_blocks == 64  # generate flushed its sequences


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "paged_kernel"])
def test_decode_loop_matches_host_loop_and_reference_model(setup, kernel):
    """decode_loop (device-resident greedy loop) gives exactly the tokens of
    put+argmax per step, which are the full-context model's greedy tokens."""
    _, _, cfg, params, prompts, _ = setup
    uids, toks = list(prompts), list(prompts.values())
    eng_a = build_engine(params, cfg, _port_config(use_paged_kernel=kernel), device="cpu")
    cur = eng_a.put(uids, toks).argmax(-1).numpy()
    host = []
    for _ in range(4):
        cur = eng_a.put(uids, [np.array([c]) for c in cur]).argmax(-1).numpy()
        host.append(cur)
    host = np.stack(host, axis=1)

    eng_b = build_engine(params, cfg, _port_config(use_paged_kernel=kernel), device="cpu")
    first = eng_b.put(uids, toks).argmax(-1).numpy()
    dev = eng_b.decode_loop(uids, [np.array([c]) for c in first], 4)
    assert dev.shape == (3, 4)
    np.testing.assert_array_equal(dev, host)
    for uid in uids:
        sa, sb = eng_a._state_manager.get_sequence(uid), eng_b._state_manager.get_sequence(uid)
        assert (sa.seen_tokens, sa.cur_allocated_blocks) == (sb.seen_tokens, sb.cur_allocated_blocks)

    model = LlamaModel(cfg)
    model.load_state_dict(params)
    with torch.no_grad():
        for i, uid in enumerate(uids):
            ctx = list(prompts[uid]) + [int(first[i])]
            for t in dev[i]:
                assert int(model(torch.tensor([ctx]))[0, -1].argmax()) == t
                ctx.append(int(t))


def test_kernel_branch_matches_gather_branch_on_sequence_crossing_blocks(setup):
    _, _, cfg, params, _, _ = setup
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 21)  # 21 tokens: bucket 32
    outs = {}
    for kernel in (False, True):
        eng = build_engine(params, cfg, _port_config(use_paged_kernel=kernel), device="cpu")
        logits = [eng.put([0], [prompt]).numpy()]
        for _ in range(3):
            logits.append(eng.put([0], [np.asarray([int(np.argmax(logits[-1][0]))])]).numpy())
        outs[kernel] = (logits, eng._state_manager.kv_cache.cache.clone())
    # f32, two softmax orders (one full, one online in the kernel's order)
    for a, b in zip(outs[False][0], outs[True][0]):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-5)
    # layer 0's K/V come straight from the embeddings: written identically;
    # later layers' K/V carry the attention rounding of the layers below
    assert torch.equal(outs[False][1][0], outs[True][1][0])
    torch.testing.assert_close(outs[False][1], outs[True][1], rtol=3e-5, atol=3e-5)


def test_padding_tokens_never_corrupt_last_block(setup):
    _, _, cfg, params, _, _ = setup
    for kernel in (False, True):
        eng = build_engine(params, cfg, _port_config(num_blocks=8, use_paged_kernel=kernel, max_context=128),
                           device="cpu")
        eng.put([0], [np.asarray([1, 2, 3])])
        last_before = eng._state_manager.kv_cache.cache[:, :, -1].clone()
        eng.put([0], [np.asarray([4])])  # decode bucket pads 1 token to 8
        assert torch.equal(eng._state_manager.kv_cache.cache[:, :, -1], last_before)
        before = eng._state_manager.kv_cache.cache.clone()
        eng.empty_run()  # every validity flag false: no write
        assert torch.equal(eng._state_manager.kv_cache.cache, before)


def test_scheduling_limits_flush_and_query(setup):
    _, _, cfg, params, _, _ = setup
    eng = build_engine(params, cfg, _port_config(num_blocks=4, max_ragged_batch_size=32,
                                                 max_ragged_sequence_count=2), device="cpu")
    assert eng.can_schedule([0], [80]) == SchedulingResult.KVCacheLimitExceeded
    assert eng.can_schedule([0, 1, 2], [1, 1, 1]) == SchedulingResult.BatchSequenceLimitExceeded
    assert eng.can_schedule([0, 1], [32, 16]) == SchedulingResult.BatchTokenLimitExceeded
    assert eng.can_schedule([0], [16]) == SchedulingResult.Success
    with pytest.raises(SchedulingError):
        eng.put([0], [np.arange(64) % cfg.vocab_size])

    eng = build_engine(params, cfg, _port_config(num_blocks=8), device="cpu")
    free0 = eng.free_blocks
    eng.put([7], [np.arange(40) % cfg.vocab_size])
    assert eng.free_blocks == free0 - 3  # ceil(40/16)
    assert eng.query(7, 10, eng.free_blocks) == (10, 1)
    assert eng.get_remaining_block_capacity(7) == 8
    eng.flush(7)
    assert eng.free_blocks == free0 and eng._state_manager.get_sequence(7) is None


def test_decode_loop_validation_and_budgets(setup):
    _, _, cfg, params, _, _ = setup
    eng = build_engine(params, cfg, _port_config(max_ragged_batch_size=64), device="cpu")
    eng.put([0], [np.arange(5) % cfg.vocab_size])
    with pytest.raises(NotImplementedError, match="verify"):
        eng.decode_loop([0], [np.array([1, 2])], 1)
    with pytest.raises(ValueError, match="n_steps"):
        eng.decode_loop([0], [np.array([1])], 0)
    with pytest.raises(NotImplementedError, match="sampled"):
        eng.decode_loop([0], [np.array([1])], 2, temperature=1.0)
    free_before = eng.free_blocks
    with pytest.raises(SchedulingError):
        eng.decode_loop([0], [np.array([1])], 510)  # 515 > max_context 512
    assert eng.free_blocks == free_before  # nothing leaked
    # n_steps counts against the KV blocks, not the ragged token budget
    assert eng.decode_loop([0], [np.array([1])], 70).shape == (1, 70)


def test_kv_cache_dtype_follows_model_dtype(setup):
    _, _, cfg, params, _, _ = setup
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"), (torch.float16, "float16")):
        eng = build_engine(params, dataclasses.replace(cfg, dtype=dtype), _port_config(), device="cpu")
        assert eng.model.kv_cache_config().cache_dtype == name
        assert eng._state_manager.kv_cache.cache.dtype == dtype


def test_unported_features_are_refused(setup):
    _, _, cfg, params, _, _ = setup
    for field, value in (("trace_enabled", True), ("simulated_gating", True)):
        ec = dataclasses.replace(_port_config(), **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_engine(params, cfg, ec, device="cpu")
    ec = RaggedInferenceEngineConfig.from_dict({"tp": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        build_engine(params, cfg, ec, device="cpu")
    eng = build_engine(params, cfg, _port_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="scheduler"):
        generate(eng, [[1, 2]], temperature=0.7)


def test_output_projection_bias_is_applied():
    """attention_out_bias (internlm): the engine adds o_proj's bias as the
    dense model does. The JAX engine drops it (ROADMAP.md section C), so
    this is held to the port's own dense model."""
    cfg = LlamaConfig.tiny(dtype=torch.float32, attention_out_bias=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for i in range(cfg.num_hidden_layers):
        params[f"layers.{i}.self_attn.o_proj.bias"].fill_(0.5)
    model = LlamaModel(cfg)
    model.load_state_dict(params)
    ids = np.arange(9) % cfg.vocab_size
    eng = build_engine(params, cfg, _port_config(), device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(ids)[None])[0, -1]
    torch.testing.assert_close(eng.put([0], [ids])[0], want, rtol=1e-5, atol=1e-5)  # f32, same ops
