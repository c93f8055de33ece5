"""Port parity for MoE training across ranks: the gate global over the
data-parallel ranks' tokens, the dispatched buffer moved to the experts'
ranks and back (``moe/sharded_moe.py``), each rank's experts
(``moe/layer.py``), and the engine's expert axis, over gloo gangs of 2
(expert 2) and 4 (data 2 x expert 2) ranks.

The reference side is the JAX package on the global batch: its ``MoE``
under ``jax.value_and_grad``, and its engine at world 1 (its gate is global
over the batch under GSPMD, so the sharded run is the same function).
Capacity binds in every case, so a gate of each rank's own tokens would
drop other tokens. f32 on both sides; noise is off on both (ROADMAP C16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import mixtral_from_flax, mixtral_to_flax
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from tests import torch_parallel_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import to_numpy_tree

S, M, E, F_HID = 32, 16, 4, 32
# one MoE forward and its gradients, f32 (tests/test_torch_moe.py's limits)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 3e-3
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
MESHES = {2: dict(expert_parallel_size=2), 4: dict(expert_parallel_size=2)}


@pytest.fixture(scope="module")
def gangs():
    made = {2: Gang(2), 4: Gang(4)}
    yield made
    for g in made.values():
        g.close()


CASES = {
    "top2_swiglu": dict(k=2, capacity_factor=0.5, gated=True),
    "top1": dict(k=1, capacity_factor=0.5),
    "top1_no_drop": dict(k=1, capacity_factor=0.5, drop_tokens=False),
    "top1_used_token": dict(k=1, capacity_factor=0.5),
    "top2_eval": dict(k=2, capacity_factor=4.0, eval_capacity_factor=0.5, gated=True),
}


@pytest.mark.parametrize("world", [2, 4], ids=["ep2", "dp2xep2"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_the_reference_on_the_global_batch(gangs, world, case):
    """The ranks' rows of the output and of the input's gradient, ``l_aux``
    and ``exp_counts`` on every rank, the router's gradient summed over the
    data ranks and each expert's over its expert-data ranks, against the
    reference ``MoE`` and ``jax.grad`` of ``sum(out * w) + 0.5 · l_aux`` on
    all 32 tokens."""
    kw = dict(CASES[case])
    training = case != "top2_eval"
    gated = kw.pop("gated", False)
    jkw = dict(kw, activation=jax.nn.silu) if gated else dict(kw)
    jmod = jlayer.MoE(hidden_size=M, num_experts=E, ffn_hidden_size=F_HID, min_capacity=2, gated=gated, **jkw)
    rng = np.random.default_rng(len(case) + world)
    x = rng.normal(size=(S, M)).astype(np.float32)
    w = rng.normal(size=(S, M)).astype(np.float32)
    used = (np.arange(S) % 3 != 0).astype(np.float32) if case == "top1_used_token" else None
    params = to_numpy_tree(jmod.init(jax.random.PRNGKey(world), jnp.asarray(x))["params"])
    uj = None if used is None else jnp.asarray(used)
    (_, (jout, jaux, jcounts)), (jgrads, jx) = jax.value_and_grad(
        lambda p, xx: _jloss(jmod, p, xx, w, uj, training), argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    state = {"gate": params["gate"], "experts.wi": params["ExpertFFN_0"]["wi"],
             "experts.wo": params["ExpertFFN_0"]["wo"]}
    moe_kw = dict(hidden_size=M, num_experts=E, ffn_hidden_size=F_HID, min_capacity=2, gated=gated, silu=gated, **kw)
    res = gangs[world].run(sc.moe_layer, MESHES[world], moe_kw, state, x, w, used, 0.5, training)

    # capacity binds: the reference drops assignments of the global batch
    logits = x @ params["gate"]
    gate_kw = dict(capacity_factor=kw.get("eval_capacity_factor" if not training else "capacity_factor", 1.0),
                   min_capacity=2)
    gate = jsm.top1gating(jnp.asarray(logits), used_token=uj, drop_tokens=kw.get("drop_tokens", True),
                          **gate_kw) if kw["k"] == 1 else jsm.top2gating(jnp.asarray(logits), **gate_kw)
    kept = float(np.asarray(gate[2]).sum())
    if kw.get("drop_tokens", True):
        assert kept < float(np.asarray(jcounts).sum())

    n = len(res)
    s = S // n
    for r in res:
        rows = slice(r["dp_rank"] * s, (r["dp_rank"] + 1) * s)
        np.testing.assert_allclose(r["out"], np.asarray(jout)[rows], **MOE_TOL)
        np.testing.assert_allclose(r["x_grad"], np.asarray(jx)[rows], **MOE_TOL)
        np.testing.assert_allclose(r["l_aux"], float(jaux), **MOE_TOL)
        np.testing.assert_array_equal(r["counts"], np.asarray(jcounts))
    np.testing.assert_allclose(sum(r["grads"]["gate"] for r in res), jgrads["gate"], **MOE_TOL)
    ep = MESHES[world]["expert_parallel_size"]
    per = E // ep
    for bank in ("wi", "wo"):
        total = np.zeros_like(jgrads["ExpertFFN_0"][bank])
        for r in res:
            total[r["ep_rank"] * per:(r["ep_rank"] + 1) * per] += r["grads"][f"experts.{bank}"]
        np.testing.assert_allclose(total, jgrads["ExpertFFN_0"][bank], **MOE_TOL, err_msg=bank)


def _jloss(jmod, p, x, w, used, training):
    out, l_aux, counts = jmod.apply({"params": p}, x, used_token=used, training=training)
    return jnp.sum(out * w) + 0.5 * l_aux, (out, l_aux, counts)


# ------------------------------------------------------------------- engine --
class _NoGatingRng:
    """The reference model behind a duck-typed ``apply``: the JAX engine
    hands it no ``gating`` rng, so its MoE layers train without noise."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, batch):
        return self.module.apply(variables, batch)


def _ds_config(world, ep, stage):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "expert_parallel_size": ep,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage}}


def _batches(vocab, steps=3, seed=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        labels = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        labels[:2, :10] = -100  # the first data rank's rows only
        out.append((ids, labels))
    return out


@pytest.fixture(scope="module")
def mixtral():
    """``MixtralConfig.tiny`` at capacity factor 0.5 (capacity binds), and
    the JAX engine's 3 steps at world 1 on the global batches."""
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32, capacity_factor=0.5)
    _, jparams = jmixtral.init_params(jcfg)
    jparams = to_numpy_tree(jparams)
    batches = _batches(jcfg.vocab_size)
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)
    engine, _, _, _ = deepspeed_tpu.initialize(model=_NoGatingRng(jmixtral.MixtralForCausalLM(jcfg)),
                                               model_parameters=jparams, config=_ds_config(1, 1, 0))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    want = [np.asarray(p) for p in jax.tree.leaves(jax.device_get(engine.params))]
    norm = engine.get_global_grad_norm()
    jgroups.destroy_mesh()
    cfg = MixtralConfig.tiny(dtype=torch.float32, capacity_factor=0.5)
    fields = {f: getattr(cfg, f) for f in MixtralConfig.__dataclass_fields__ if f != "dtype"}
    state = {k: v.numpy() for k, v in mixtral_from_flax(jparams, cfg).items()}
    return cfg, fields, state, batches, losses, want, norm


def check_mixtral_training(res, mixtral):
    cfg, _, _, _, want_losses, want, want_norm = mixtral
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
        assert r["norm"] == pytest.approx(want_norm, rel=1e-4)  # the clip at 1.0 over every rank's experts
    got = jax.tree.leaves(mixtral_to_flax({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, cfg))
    for g, w in zip(got, want):
        diff = np.abs(g - w)
        assert np.mean(diff <= 0.01 * LR + 1e-4 * np.abs(w)) >= 0.995 and diff.max() <= 3 * LR, diff.max()


@pytest.mark.parametrize("world,stage", [(2, 1), (4, 2)], ids=["ep2_zero1", "dp2xep2_zero2"])
def test_train_batch_with_expert_parallel_matches_the_reference_engine(gangs, mixtral, world, stage):
    """Three ``train_batch`` steps of ``MixtralConfig.tiny`` with experts on
    2 expert ranks (alone, and under 2 data ranks, ZeRO 1 and 2 over the
    expert-data group for the banks): the losses and the gathered masters
    equal the reference engine's at world 1; each rank holds 2 of the 4
    experts."""
    _, fields, state, batches, _, _, _ = mixtral
    res = gangs[world].run(sc.train_mixtral, fields, state, _ds_config(world, 2, stage), batches)
    check_mixtral_training(res, mixtral)
    for r in res:
        assert r["local"]["layers.0.block_sparse_moe.experts.wi"].shape[0] == 2


def test_experts_that_do_not_divide_raise(gangs, mixtral):
    """4 experts over 4 expert ranks build; over 3 they cannot (a world of 4
    with ``expert_parallel_size`` 4 and a model of 6 experts raises)."""
    _, fields, state, batches, _, _, _ = mixtral
    with pytest.raises(Exception, match="6 experts do not divide over 4"):
        gangs[4].run(sc.train_mixtral, dict(fields, num_local_experts=6), {}, _ds_config(4, 4, 1), batches[:1])
