"""The ZeRO partitioning surface over gloo gangs of 2 and 4 ranks: a rank's
partitioned state bytes and the units that release their parameters, the
``tensor_fragment`` accessors and ``GatheredParameters``, the f32 export of
a world-2 checkpoint, the batch triangle, checkpoint tag validation, the
micro-step API over global batches and ``register_external_parameter``
(``tests/test_torch_zero.py`` holds the placement rule and the engine
against the JAX engine). The gangs are built once for the module
(``tests/torch_gang.py``).
"""

import dataclasses

import numpy as np
import pytest

from tests import torch_gang_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

LR = 3e-3


@pytest.fixture(scope="module")
def gangs():
    made = {2: Gang(2), 4: Gang(4)}
    yield made
    for g in made.values():
        g.close()


def _jcfg():
    return jax_tiny(num_key_value_heads=2)


def _fields(pcfg):
    return {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg) if f.name != "dtype"}


def _batches(vocab, global_batch, steps, seed=7, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, size=(global_batch, seq + 1))
        out.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)))
    return out


def _config(stage, world, gas=2, micro=2, threshold=0):
    return {"train_batch_size": gas * micro * world, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": threshold}}


# --------------------------------------------------------- the partitioning --
def _port_setup():
    jcfg = _jcfg()
    pcfg = port_config(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jax_params(jcfg)).items()}
    return jcfg, pcfg, state


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_partitioned_state_bytes_and_released_parameters(gangs, stage):
    """Each rank holds about half the training state a world of one holds
    for what its stage partitions (stage 3: at most 0.55 of params + grads
    + optimizer), and at stage 3 the module's parameters hold no storage
    between steps: the units gather them per layer."""
    jcfg, pcfg, state = _port_setup()
    batches = _batches(jcfg.vocab_size, 8, 1)
    two = gangs[2].run(sc.stage3_memory, _fields(pcfg), state, _config(stage, 2), batches)
    one = sc.stage3_memory(_fields(pcfg), state, _config(stage, 1), [tuple(x[:4] for x in b) for b in batches])
    for r in two:
        ratio = {k: r["bytes"][k] / one["bytes"][k] for k in one["bytes"]}
        assert ratio["optimizer"] <= 0.55
        assert ratio["grads"] <= (0.55 if stage >= 2 else 1.0)
        assert ratio["params"] <= (0.55 if stage == 3 else 1.0)
        if stage == 3:
            assert sum(r["bytes"].values()) <= 0.55 * sum(one["bytes"].values())
            assert r["held"] == 0 and r["units"] == jcfg.num_hidden_layers + 3
        else:
            assert r["held"] == one["held"] and r["units"] == 0


@pytest.mark.parametrize("stage", [1, 3])
def test_tensor_fragment_accessors_across_ranks(gangs, stage):
    """The ``safe_get_full_*`` accessors return the whole tensor on every
    rank (a partitioned one put together), the local one the rank's chunk,
    a ``safe_set_full_*`` round trip holds, the gradient accessor is None
    outside an accumulation window, and ``GatheredParameters`` writes an
    edit back through the partitioning."""
    jcfg, pcfg, state = _port_setup()
    name = "layers.0.mlp.gate_proj.weight"
    res = gangs[2].run(sc.accessors, _fields(pcfg), state, _config(stage, 2), _batches(jcfg.vocab_size, 8, 1), name)
    a, b = res
    assert np.array_equal(a["full"], b["full"]) and a["full"].shape == state[name].shape
    if stage == 3:
        # the JAX kernel [in, out] is chunked on `in`: the port's [out, in] on dim 1
        chunks = np.split(a["full"], 2, axis=1)
        assert np.array_equal(a["local"], chunks[0]) and np.array_equal(b["local"], chunks[1])
    else:
        assert np.array_equal(a["local"], a["full"])
    assert np.array_equal(a["exp_avg"], b["exp_avg"]) and a["exp_avg"].shape == state[name].shape
    assert a["grad_outside"] is None
    assert a["grad_inside"].shape == state[name].shape and np.array_equal(a["grad_inside"], b["grad_inside"])
    np.testing.assert_array_equal(a["after_set"], a["full"] * 0.5)
    np.testing.assert_array_equal(a["exp_avg_after_set"], np.ones_like(a["full"]))
    np.testing.assert_array_equal(a["gathered"], a["full"] * 0.5)
    np.testing.assert_array_equal(a["after_update"], a["full"])


def test_zero_to_fp32_puts_a_world2_checkpoint_together(gangs, tmp_path):
    """A stage-3 save over two ranks exports to one f32 state dict equal,
    bit for bit, to the masters the ranks gathered."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import convert_zero_checkpoint_to_fp32_state_dict
    jcfg, pcfg, state = _port_setup()
    saved = gangs[2].run(sc.save_after_training, _fields(pcfg), state, _config(3, 2),
                         _batches(jcfg.vocab_size, 8, 2), str(tmp_path / "ck"))
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path / "ck"), str(tmp_path / "fp32.npz"))
    got = np.load(out)
    assert sorted(got.files) == sorted(saved[0]["full"])
    for k, v in saved[0]["full"].items():
        assert np.array_equal(got[k], v)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_triangle_counts_the_data_parallel_ranks(gangs, world):
    """``train_batch_size = micro × GAS × dp`` over the ranks (the
    reference's ``set_train_batch_size`` invariant), derived or refused."""
    ok = gangs[world].run(sc.batch_triangle, {"train_batch_size": 16, "gradient_accumulation_steps": 2})
    assert ok == [(16, 8 // world, 2)] * world
    derived = gangs[world].run(sc.batch_triangle, {"train_micro_batch_size_per_gpu": 2,
                                                   "gradient_accumulation_steps": 3})
    assert derived == [(2 * 3 * world, 2, 3)] * world
    # valid for one rank, not for `world`
    bad = gangs[world].run(sc.batch_triangle, {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 4,
                                               "gradient_accumulation_steps": 4})
    assert all(r.startswith("AssertionError") and f"* {world}" in r for r in bad)


@pytest.mark.parametrize("mode", ["Warn", "Fail", "Ignore"])
def test_checkpoint_tag_validation_over_ranks(gangs, mode, tmp_path):
    """Ranks saving different tags: Warn logs the mismatch on the ranks
    whose tag differs from rank 0's, Fail raises there, Ignore checks
    nothing."""
    _, pcfg, state = _port_setup()
    res = gangs[2].run(sc.tag_validation, _fields(pcfg), state, mode, str(tmp_path))
    assert res[0] == ("ok", [])
    if mode == "Warn":
        assert res[1][0] == "ok" and len(res[1][1]) == 1
    elif mode == "Fail":
        assert res[1][0].startswith("raised") and "not consistent" in res[1][0]
    else:
        assert res[1] == ("ok", [])


@pytest.mark.parametrize("stage", [0, 3])
def test_micro_step_api_and_eval_take_the_global_batch(gangs, stage):
    """``forward``/``backward``/``step`` over global micro-batches train as
    ``train_batch`` does (the masters agree with a world of one on the same
    batches), eval returns the gang's mean loss, and ``deepspeed_io``
    loads global micro-batches of ``micro × dp`` rows."""
    jcfg, pcfg, state = _port_setup()
    batches = _batches(jcfg.vocab_size, 8, 2)
    two = gangs[2].run(sc.micro_api, _fields(pcfg), state, _config(stage, 2), batches)
    one = sc.micro_api(_fields(pcfg), state, _config(stage, 1, micro=4), batches)
    for r in two:
        np.testing.assert_allclose(r["evals"], one["evals"], rtol=1e-5)
        assert r["io_batch"] == one["io_batch"] == 4
        for k, v in one["full"].items():
            np.testing.assert_allclose(r["full"][k], v, rtol=1e-4, atol=0.01 * LR)


def test_external_parameter_is_gathered_by_the_unit_that_reads_it(gangs):
    """A head reading the embedding's weight (tied): registered with
    ``register_external_parameter``, the head's unit gathers it too at stage
    3, and the gang trains as one rank does (the gradient reaches the
    embedding through both units)."""
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 32, size=(8, 6)), rng.integers(0, 32, size=(8, 6))) for _ in range(3)]
    two = gangs[2].run(sc.train_tied, 3, batches)
    one = sc.train_tied(3, batches)
    assert two[0]["units"] == 3 and one["units"] == 0
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for k, v in one["full"].items():
            np.testing.assert_allclose(r["full"][k], v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stage", [0, 2, 3])
def test_a_nan_on_one_rank_skips_the_step_on_every_rank(gangs, stage):
    """The finite gate is the gang's: a NaN in one rank's rows skips the
    step on every rank (the masters unchanged, one skipped step each), and
    the next clean step applies everywhere."""
    for r in gangs[2].run(sc.nan_on_one_rank, stage, 1):
        assert r == ((1, True), True, True)


def test_an_async_gang_save_loads_at_world_one(gangs, tmp_path):
    """``nebula.enabled`` over two ranks: each rank commits on its thread
    (files, then its seal; rank 0 awaits the seals, then the manifest), and
    the tag loads at world 1 bit for bit."""
    jcfg, pcfg, state = _port_setup()
    config = dict(_config(3, 2), nebula={"enabled": True})
    saved = gangs[2].run(sc.save_after_training, _fields(pcfg), state, config, _batches(jcfg.vocab_size, 8, 1),
                         str(tmp_path / "ck"))[0]
    assert (tmp_path / "ck" / "global_step1" / "MANIFEST.json").exists()
    got = sc.load_and_report(_fields(pcfg), state, _config(3, 1, micro=4), str(tmp_path / "ck"))
    assert got["steps"] == 1
    for k, v in saved["full"].items():
        assert np.array_equal(got["full"][k], v)


@pytest.mark.parametrize("stage", [0, 3])
def test_curvature_probe_is_the_global_batchs_on_every_rank(gangs, stage):
    """``loss_curvature`` over two ranks, each holding half the batch,
    averages each Hessian product over them: every rank finds the raw top
    eigenvalue one rank finds on the whole batch (f32, to summation
    order)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    batch = (x, (x[:, 0] * 0.5 - x[:, 1]).astype(np.float32))
    one = sc.curvature(stage, batch)
    for raw in gangs[2].run(sc.curvature, stage, batch):
        assert raw.keys() == one.keys()
        for k in one:
            assert raw[k] == pytest.approx(one[k], rel=1e-4), k
