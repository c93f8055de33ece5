"""Port parity for the MoE layer (``deepspeed_tpu_torch/moe``): the gates,
``MoE``'s forward and parameter gradients, PR-MoE's residual mix and the
optimizer group splitter, against ``deepspeed_tpu/moe`` on the same numpy
inputs in f32.

Noise is off (no generator, no rng) wherever the two are compared; the
noisy gates draw from torch generators where the reference draws from
``jax.random`` (ROADMAP C16) and are held to determinism and to their
distribution instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe import utils as jutils
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.moe import utils as tutils
from tests.torch_port_helpers import to_numpy_tree

S, E, M, F_HID = 16, 4, 16, 32
# f32 softmax and sums on both sides: weights and the aux loss agree to a
# few ulps; masks, slots and counts exactly
GATE_TOL = dict(rtol=1e-5, atol=1e-7)
# one MoE forward (two products) and its gradients, f32
MOE_TOL = dict(rtol=1e-4, atol=1e-5)


def _logits(seed, tie=False):
    rng = np.random.default_rng(seed)
    if tie:  # few distinct values: rows whose maximum repeats
        return rng.integers(0, 3, (S, E)).astype(np.float32)
    return rng.normal(size=(S, E)).astype(np.float32)


def _check_gate(got, want):
    l_aux, combine, dispatch, counts = (t.numpy() for t in got)
    jl_aux, jcombine, jdispatch, jcounts = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(dispatch, jdispatch)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_allclose(combine, jcombine, **GATE_TOL)
    np.testing.assert_allclose(l_aux, jl_aux, **GATE_TOL)


@pytest.mark.parametrize("case", ["capacity_binds", "no_drop", "used_token", "tie"])
def test_top1gating_matches_the_reference(case):
    logits = _logits(1, tie=case == "tie")
    kw = dict(capacity_factor=1.0, min_capacity=2)
    if case == "no_drop":
        kw["drop_tokens"] = False
    used = (np.arange(S) % 3 != 0).astype(np.float32) if case == "used_token" else None
    got = tsm.top1gating(torch.from_numpy(logits), used_token=None if used is None else torch.from_numpy(used), **kw)
    want = jsm.top1gating(jnp.asarray(logits), used_token=None if used is None else jnp.asarray(used), **kw)
    _check_gate(got, want)
    if case == "capacity_binds":
        assert got[2].sum() < S  # the case drops tokens


@pytest.mark.parametrize("case", ["roomy", "capacity_binds", "tie"])
def test_top2gating_matches_the_reference(case):
    logits = _logits(2, tie=case == "tie")
    cf = 0.5 if case == "capacity_binds" else 1.0
    got = tsm.top2gating(torch.from_numpy(logits), capacity_factor=cf, min_capacity=2)
    want = jsm.top2gating(jnp.asarray(logits), capacity_factor=cf, min_capacity=2)
    _check_gate(got, want)
    if case == "capacity_binds":
        assert got[2].sum() < 2 * S


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("training", [True, False], ids=["train_capacity", "eval_capacity"])
def test_topk_gate_matches_the_reference(k, training):
    """``capacity_factor`` in training, ``eval_capacity_factor`` otherwise."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(S, M)).astype(np.float32)
    wg = rng.normal(size=(M, E)).astype(np.float32)
    kw = dict(k=k, capacity_factor=0.5, eval_capacity_factor=2.0, min_capacity=2)
    got = tsm.TopKGate(M, E, **kw)(torch.from_numpy(wg), torch.from_numpy(x), training=training)
    want = jsm.TopKGate(M, E, **kw)(jnp.asarray(wg), jnp.asarray(x), training=training)
    _check_gate(got, want)
    assert got[1].shape[-1] == want[1].shape[-1]  # the capacity of the mode


def _moe_pair(k, gated, residual, **kw):
    """The reference MoE and its params, and the port's with the same
    weights."""
    act = dict(activation=jax.nn.silu) if gated else {}
    jmod = jlayer.MoE(hidden_size=M, num_experts=E, ffn_hidden_size=F_HID, k=k, use_residual=residual, gated=gated,
                      **act, **kw)
    x0 = jnp.zeros((2, S // 2, M), jnp.float32)
    params = to_numpy_tree(jmod.init(jax.random.PRNGKey(k + 2 * gated), x0)["params"])
    tmod = tlayer.MoE(hidden_size=M, num_experts=E, ffn_hidden_size=F_HID, k=k, use_residual=residual, gated=gated,
                      **(dict(activation=F.silu) if gated else {}), **kw)
    tmod.load_state_dict({name: torch.tensor(np.asarray(arr)) for name, arr in _to_port(params)})
    return jmod, params, tmod


_DENSE = {"Dense_0": "residual_in", "Dense_1": "residual_out", "Dense_2": "coefficient"}


def _to_port(params):
    """(port name, array) for each leaf of a reference MoE tree."""
    yield "gate", params["gate"]
    yield "experts.wi", params["ExpertFFN_0"]["wi"]
    yield "experts.wo", params["ExpertFFN_0"]["wo"]
    for flax_name, port in _DENSE.items():
        if flax_name in params:
            yield f"{port}.weight", params[flax_name]["kernel"].T
            yield f"{port}.bias", params[flax_name]["bias"]


@pytest.mark.parametrize("k,gated,residual,training", [(1, False, False, True), (2, True, False, True),
                                                       (1, False, True, True), (2, True, True, False)],
                         ids=["top1_gelu", "top2_swiglu", "top1_pr_moe", "top2_pr_moe_eval"])
def test_moe_forward_and_gradients_match_jax_grad(k, gated, residual, training):
    """``(out, l_aux, exp_counts)`` and the gradients of ``sum(out * w) +
    l_aux`` with respect to every parameter (the gate through the aux loss
    and the combine weights; PR-MoE's dense MLP and mix)."""
    kw = dict(capacity_factor=1.0, eval_capacity_factor=1.5, min_capacity=2)
    jmod, params, tmod = _moe_pair(k, gated, residual, **kw)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S // 2, M)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p):
        out, l_aux, _ = jmod.apply({"params": p}, jnp.asarray(x), training=training)
        return jnp.sum(out * w) + l_aux, (out, l_aux)

    (jval, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    _, _, jcounts = jmod.apply({"params": params}, jnp.asarray(x), training=training)
    tmod.train(training)
    out, l_aux, counts = tmod(torch.from_numpy(x))
    loss = (out * torch.from_numpy(w)).sum() + l_aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(l_aux.item(), float(jaux), **MOE_TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    grads = dict(tmod.named_parameters())
    for name, want in _to_port(to_numpy_tree(jgrads)):
        np.testing.assert_allclose(grads[name].grad.numpy(), want, **MOE_TOL, err_msg=name)


def test_pr_moe_mixes_the_dense_mlp():
    """PR-MoE: the output is the learned softmax mix of the experts' and the
    dense MLP's; zeroing the mix's weights and biasing it wholly to the
    dense side leaves the dense MLP alone, on both sides."""
    jmod, params, tmod = _moe_pair(1, False, True, capacity_factor=1.0, min_capacity=2)
    params["Dense_2"]["kernel"] = np.zeros_like(params["Dense_2"]["kernel"])
    params["Dense_2"]["bias"] = np.array([-30.0, 30.0], np.float32)
    tmod.load_state_dict({name: torch.tensor(np.asarray(a)) for name, a in _to_port(params)})
    x = np.random.default_rng(6).normal(size=(S, M)).astype(np.float32)
    out, _, _ = tmod(torch.from_numpy(x))
    dense = tmod.residual_out(tlayer.gelu_tanh(tmod.residual_in(torch.from_numpy(x))))
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(), **MOE_TOL)
    jout, _, _ = jmod.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **MOE_TOL)


def test_group_splitter_matches_the_reference_groups():
    """Expert parameters go to a ``<name>_moe`` group (``moe_group_<i>``
    unnamed) with ``moe: True`` and the input group's other keys; a group is
    made only where it has parameters. The port's structural marker names
    the reference's expert-sharded leaves."""
    jmod, params, tmod = _moe_pair(2, True, True, capacity_factor=1.0)
    specs = jlayer.expert_param_specs(params)
    port_of = dict(_to_port({**params}))
    flax_name = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        names = [p.key for p in path]
        port = {"gate": "gate", "wi": "experts.wi", "wo": "experts.wo"}.get(names[-1]) or \
            f"{_DENSE[names[0]]}.{'weight' if names[-1] == 'kernel' else 'bias'}"
        assert port in port_of
        flax_name[port] = "/".join(names)
    marked = tlayer.expert_param_specs(tmod)
    want_marked = {"/".join(p.key for p in path): jutils.is_moe_param_spec(s)
                   for path, s in jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda s: s is None or
                                                                      hasattr(s, "index"))}
    assert {flax_name[n]: v for n, v in marked.items()} == want_marked
    assert all(tutils.is_moe_param(p) == marked[n] for n, p in tmod.named_parameters())

    dense_only = {k: v for k, v in params.items() if k.startswith("Dense")}
    dense_specs = {k: v for k, v in specs.items() if k.startswith("Dense")}
    jgroups = jutils.split_params_into_different_moe_groups_for_optimizer(
        [{"params": params, "param_specs": specs, "name": "g", "lr": 0.1},
         {"params": params, "param_specs": specs, "weight_decay": 0.0},
         {"params": dense_only, "param_specs": dense_specs, "name": "d"}])
    named = dict(tmod.named_parameters())
    dense_params = [p for n, p in named.items() if n.startswith(("residual", "coefficient"))]
    tgroups = tutils.split_params_into_different_moe_groups_for_optimizer(
        [{"params": list(named.values()), "name": "g", "lr": 0.1},
         {"params": list(named.values()), "weight_decay": 0.0}, {"params": dense_params, "name": "d"}])
    name_of = {id(p): n for n, p in named.items()}
    assert len(tgroups) == len(jgroups) == 5
    for tg, jg in zip(tgroups, jgroups):
        assert {k: v for k, v in tg.items() if k != "params"} == {k: v for k, v in jg.items() if k != "params"}
        leaves = {"/".join(p.key for p in path) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(jg["params"], is_leaf=lambda x: x is None) if leaf is not None}
        assert {flax_name[name_of[id(p)]] for p in tg["params"]} == leaves


# ----------------------------------------------------------------- the noise --
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_noisy_gates_are_deterministic_and_follow_their_distribution():
    """C16: RSample's first choice is a draw from softmax(logits) (4 sigma a
    bin over 4,000 tokens of one row), RTS keeps as many tokens an expert as
    the positional order and picks them at random, Jitter moves the input
    within 1%, the second expert's Gumbel sample never repeats the first;
    each the same for the same seed and different for another."""
    row = np.array([1.0, 0.2, -0.5, 0.7], np.float32)
    logits = torch.from_numpy(np.tile(row, (4000, 1)))
    a = tsm.top1gating(logits, noisy_gate_policy="RSample", generator=_gen(0), drop_tokens=False)
    b = tsm.top1gating(logits, noisy_gate_policy="RSample", generator=_gen(0), drop_tokens=False)
    c = tsm.top1gating(logits, noisy_gate_policy="RSample", generator=_gen(1), drop_tokens=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[2], c[2])
    p = torch.softmax(torch.from_numpy(row).double(), 0)
    share = a[3].double() / 4000
    assert ((share - p).abs() <= 4 * (p * (1 - p) / 4000).sqrt()).all(), (share, p)

    logits = torch.from_numpy(_logits(7))
    plain = tsm.top1gating(logits, capacity_factor=1.0, min_capacity=2)
    rts = tsm.top1gating(logits, capacity_factor=1.0, min_capacity=2, generator=_gen(0))
    assert torch.equal(rts[2].sum((0, 2)), plain[2].sum((0, 2)))
    assert torch.equal(rts[2], tsm.top1gating(logits, capacity_factor=1.0, min_capacity=2, generator=_gen(0))[2])
    assert not torch.equal(rts[2], plain[2])

    x = torch.from_numpy(np.random.default_rng(8).normal(size=(S, M)).astype(np.float32))
    jit = tsm.multiplicative_jitter(x, _gen(0))
    assert torch.equal(jit, tsm.multiplicative_jitter(x, _gen(0))) and not torch.equal(jit, x)
    assert ((jit - x).abs() <= 1e-2 * x.abs() * (1 + 1e-6)).all()

    two = tsm.top2gating(logits, capacity_factor=4.0, generator=_gen(0))
    assert torch.equal(two[2], tsm.top2gating(logits, capacity_factor=4.0, generator=_gen(0))[2])
    per_expert = two[2].sum(2)  # [S, E]: each token's two experts, distinct
    assert (per_expert <= 1).all() and (per_expert.sum(1) == 2).all()
    assert not torch.equal(two[2], tsm.top2gating(logits, capacity_factor=4.0)[2])
