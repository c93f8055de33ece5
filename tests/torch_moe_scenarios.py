"""Expert-parallel scenarios that the ranks of a ``tests/torch_gang.py`` gang
run (no jax here): each rank is one EP rank of the port, fed its slice of the
tokens or its own requests, and returns numpy for the test to hold against
the JAX package."""

import time

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.v2.config_v2 import DeepSpeedEPConfig, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, generate
from deepspeed_tpu_torch.inference.v2.modules.moe import ExpertGroupSync, RaggedMoE
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler
from deepspeed_tpu_torch.utils import groups

HEARTBEAT_WAIT_S = 60.0


def _sync():
    world = comm.get_world_size()
    groups.initialize_mesh(expert_parallel_size=world, force=True)
    return ExpertGroupSync(groups.get_group(groups.EXPERT_AXIS), "cpu")


def ragged_moe_ep(h, gate, wi, wo, capacity_factor):
    """``RaggedMoE`` on this rank's equal slice of ``h [T, M]`` and its
    experts of the full banks; returns this rank's rows and its dropped
    assignments."""
    sync = _sync()
    r, ep = sync.rank, sync.size
    Tl, El = h.shape[0] // ep, wi.shape[0] // ep
    moe = RaggedMoE(num_experts=wi.shape[0], top_k=2, capacity_factor=capacity_factor)
    out = moe(torch.from_numpy(h[r * Tl:(r + 1) * Tl]), torch.from_numpy(gate),
              torch.from_numpy(wi[r * El:(r + 1) * El]), torch.from_numpy(wo[r * El:(r + 1) * El]), sync=sync)
    return out.numpy(), int(moe.dropped)


def engine_config(ep, capacity_factor=4.0, **kw):
    """The reference tests' engine: a 64-block pool of 16-token blocks."""
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode="allocate", size=64), max_context=512)
    return RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16,
                                       expert_parallel=DeepSpeedEPConfig(enabled=ep > 0, replica_num=max(ep, 1),
                                                                         capacity_factor=capacity_factor),
                                       **kw)


def _params(state):
    return {k: torch.from_numpy(v) for k, v in state.items()}


def _cfg(cfg_fields):
    return MixtralConfig(dtype=torch.float32, **cfg_fields)


def _ep_engine(state, cfg_fields):
    return build_engine(_params(state), _cfg(cfg_fields), engine_config(comm.get_world_size()), device="cpu")


def ep_put(state, cfg_fields, seqs_by_rank):
    """Each rank puts its own sequences through an EP engine in one forward,
    then leaves the group; returns the logits, the dropped assignments and
    the empty forwards run while leaving."""
    engine = _ep_engine(state, cfg_fields)
    seqs = seqs_by_rank[comm.get_rank()]
    out = engine.put(list(seqs), [np.asarray(t) for t in seqs.values()]).numpy()
    dropped = sum(int(m.dropped) for m in engine.model.moes)
    return out, dropped, engine.leave_expert_group()


def ep_generate(state, cfg_fields, prompts_by_rank, new_tokens_by_rank):
    """Each rank serves its prompts through ``generate`` on an EP engine (for
    its own number of new tokens), then leaves; also the same prompts on a
    one-rank engine holding every expert. Returns both token lists and the
    empty forwards run while leaving."""
    engine = _ep_engine(state, cfg_fields)
    prompts = prompts_by_rank[comm.get_rank()]
    new_tokens = new_tokens_by_rank[comm.get_rank()]
    tokens = generate(engine, prompts, max_new_tokens=new_tokens)
    runs = engine.leave_expert_group()
    dense = build_engine(_params(state), _cfg(cfg_fields), engine_config(0), device="cpu")
    return tokens, generate(dense, prompts, max_new_tokens=new_tokens), runs


def ep_decode_with_empty_runs(state, cfg_fields, ctx, steps):
    """Rank 0 decodes ``ctx`` greedily by puts with an ``empty_run`` between
    each, its KV cache compared bitwise across each empty run; the other
    ranks leave at once (their empty forwards pair with rank 0's). Rank 0
    returns its last logits, the tokens and whether every cache was equal."""
    engine = _ep_engine(state, cfg_fields)
    if comm.get_rank() != 0:
        engine.leave_expert_group()
        return None
    ctx = list(ctx)
    out = engine.put([0], [np.asarray(ctx)])
    same = []
    for _ in range(steps):
        before = engine._state_manager.kv_cache.cache.clone()
        engine.empty_run()
        same.append(torch.equal(engine._state_manager.kv_cache.cache, before))
        nxt = int(out[0].argmax())
        ctx.append(nxt)
        out = engine.put([0], [np.asarray([nxt])])
    engine.leave_expert_group()
    return out.numpy(), ctx, same


def ep_heartbeat(state, cfg_fields, prompt, steps):
    """Rank 0 is idle behind a serving scheduler on its own thread, whose
    heartbeat (on by default under EP) sends ``empty_run``; rank 1 prefills
    ``prompt`` and runs a ``steps``-step ``decode_loop``, then leaves; any
    other rank leaves at once. Rank 0 asks to leave at once and waits, with
    a timeout, for the group to stop.
    Returns rank 0's heartbeat count, rank 1's tokens and a one-rank
    engine's."""
    engine = _ep_engine(state, cfg_fields)
    if comm.get_rank() > 1:
        engine.leave_expert_group()
        return None
    if comm.get_rank() == 0:
        sched = ServingScheduler(engine, ServingConfig(heartbeat_interval_s=0.0), start=True)
        engine.model.ep_sync.request_leave()
        deadline = time.monotonic() + HEARTBEAT_WAIT_S
        while not engine.model.ep_sync.stopped:
            if time.monotonic() > deadline:
                raise TimeoutError("the expert group did not stop within the heartbeat wait")
            time.sleep(0.01)
        heartbeats = sched.stats()["counters"]["heartbeats"]
        sched.stop()
        return heartbeats

    def run(eng):
        first = int(eng.put([0], [np.asarray(prompt)])[0].argmax())
        return [first] + eng.decode_loop([0], [[first]], steps)[0].tolist()

    tokens = run(engine)
    engine.leave_expert_group()
    dense = build_engine(_params(state), _cfg(cfg_fields), engine_config(0), device="cpu")
    return tokens, run(dense)


def ep_build_indivisible(cfg_fields):
    """An EP engine whose experts do not divide over the ranks: the build
    raises (ROADMAP C17); returns the message."""
    from deepspeed_tpu_torch.models.mixtral import init_params

    cfg = _cfg(cfg_fields)
    try:
        build_engine(init_params(cfg, device="cpu"), cfg, engine_config(comm.get_world_size()), device="cpu")
    except ValueError as e:
        return str(e)
    return None
