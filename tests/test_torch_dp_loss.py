"""The loss of a data-parallel step is the reference's global token mean
(ROADMAP C18).

The reference's ``train_batch`` applies the loss to the whole global
micro-batch (sharded over the data axes), and ``cross_entropy_loss``
divides the valid tokens' summed log-likelihood by the count of valid
tokens in that whole batch. The port's ranks each see their chunk; the
engine sums the count of valid labels over the ranks before the forward,
so each rank's loss is its share of the global mean. Here the labels are
masked in rank 0's half of every micro-batch only, so the ranks hold
different counts: at ZeRO stages 0-3 over a gloo gang of 2, the losses and
the masters after 2 steps equal the JAX engine's at world 1 on the global
batch. With every label valid the repaired step is, bit for bit, the step
of each rank's own mean.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import to_flax_params
from tests import torch_parallel_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

LR = 3e-3
STEPS = 2
GAS, MICRO, WORLD, SEQ = 2, 2, 2, 16
# f32 on both sides; as tests/test_torch_zero.py: the losses to summation
# order, 99.5% of each tensor's weights within 1% of an lr step of the
# reference and every one within STEPS lr steps (Adam's sign flips near 0)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


def _assert_params_close(got, want):
    diff = np.abs(got - want)
    near = diff <= 0.01 * LR + 1e-4 * np.abs(want)
    assert near.mean() >= 0.995 and diff.max() <= STEPS * LR, (near.mean(), diff.max())


def _config(stage, world):
    return {"train_batch_size": GAS * MICRO * world, "gradient_accumulation_steps": GAS, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}


def _batches(vocab, masked, seed=5):
    """Global batches ``[GAS * MICRO * WORLD, SEQ]``; ``masked``: in each
    micro-batch, rank 0's rows carry ``-100`` on most positions (a rank's
    rows are its contiguous ``MICRO`` of the micro-batch's ``MICRO * WORLD``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, vocab, size=(GAS * MICRO * WORLD, SEQ + 1))
        labels = ids[:, 1:].copy()
        if masked:
            for g in range(GAS):
                rank0 = slice(g * MICRO * WORLD, g * MICRO * WORLD + MICRO)
                labels[rank0, 3:] = -100
        out.append((ids[:, :-1].astype(np.int32), labels.astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def gang():
    g = Gang(WORLD)
    yield g
    g.close()


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(num_key_value_heads=2)
    jparams = jax_params(jcfg)
    pcfg = port_config(jcfg)
    fields = {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__ if f != "dtype"}
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    return jcfg, jparams, pcfg, fields, state


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine at world 1 on the masked global batches (one run)."""
    jcfg, jparams, _, _, _ = models
    batches = _batches(jcfg.vocab_size, masked=True)
    jgroups.initialize_mesh(devices=jax.devices()[:1], force=True)
    engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                               config=_config(0, 1))
    losses = [float(engine.train_batch(batch=b)) for b in batches]
    params = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(engine.params))]
    jgroups.destroy_mesh()
    return batches, losses, params


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_masked_loss_and_masters_match_the_global_token_mean(gang, models, reference, stage):
    """Labels masked unevenly across the ranks: every rank's losses and the
    gathered masters after 2 steps equal the reference's global token mean
    at world 1; the mean of each rank's own mean (the port before the
    repair) misses it."""
    _, _, pcfg, fields, state = models
    batches, want_losses, want_params = reference
    res = gang.run(sc.train_llama, fields, state, _config(stage, WORLD), batches)
    for r in res:
        np.testing.assert_allclose(r["losses"], want_losses, **LOSS_TOL)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    for g, w in zip(got, want_params):
        _assert_params_close(g, w)
    if stage == 0:  # the control: each rank's own mean
        before = gang.run(sc.train_llama, fields, state, _config(stage, WORLD), batches, False)
        assert not np.allclose(before[0]["losses"], want_losses, **LOSS_TOL)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_every_label_valid_is_unchanged_bit_for_bit(gang, models, stage):
    """With every label valid each rank holds as many, the share's factor
    is exactly 1, and the losses, the global norm and the masters equal the
    run of each rank's own mean bit for bit."""
    jcfg, _, _, fields, state = models
    batches = _batches(jcfg.vocab_size, masked=False)
    repaired = gang.run(sc.train_llama, fields, state, _config(stage, WORLD), batches)
    before = gang.run(sc.train_llama, fields, state, _config(stage, WORLD), batches, False)
    for a, b in zip(repaired, before):
        assert a["losses"] == b["losses"] and a["norm"] == b["norm"]
        for name in a["full"]:
            assert np.array_equal(a["full"][name], b["full"][name]), name
