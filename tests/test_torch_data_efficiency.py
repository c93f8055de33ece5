"""Port parity for the data-efficiency tier and progressive layer drop: the
curriculum schedules and sampler, the memory-mapped dataset and the data
analyzer's index files, random-LTD, PLD, and the engine's curriculum
truncation, each against deepspeed_tpu on the CPU from the same numpy
seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline import CurriculumScheduler as JCurriculumScheduler
from deepspeed_tpu.runtime.data_pipeline import DeepSpeedDataSampler as JDataSampler
from deepspeed_tpu.runtime.data_pipeline import data_routing as jltd
from deepspeed_tpu.runtime.data_pipeline import data_sampling as jds
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.data_pipeline import CurriculumScheduler, DeepSpeedDataSampler
from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as tltd
from deepspeed_tpu_torch.runtime.data_pipeline import data_sampling as tds
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params

SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 10, "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 16, "max_difficulty": 128, "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 12, "difficulty_step": 8, "root_degree": 2}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 3, "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 2, 3], "max_step": [3, 6]}},
    "custom": {"min_difficulty": 4, "max_difficulty": 40, "schedule_type": "custom"},
}


def _custom(step):
    return min(40, 4 + 3 * step)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_curriculum_schedule_matches_reference_step_for_step(kind):
    port, ref = CurriculumScheduler(dict(SCHEDULES[kind])), JCurriculumScheduler(dict(SCHEDULES[kind]))
    if kind == "custom":
        port.set_custom_get_difficulty(_custom)
        ref.set_custom_get_difficulty(_custom)
    got = [(port.get_difficulty(s), port.update_difficulty(s)) for s in range(20)]
    want = [(ref.get_difficulty(s), ref.update_difficulty(s)) for s in range(20)]
    assert got == want
    assert port.get_state() == ref.get_state()
    other = CurriculumScheduler(dict(SCHEDULES[kind]))
    other.set_state(port.get_state())
    assert other.get_current_difficulty() == port.get_current_difficulty()


@pytest.mark.parametrize("dp", [1, 2])
def test_data_sampler_matches_reference_batch_for_batch(dp):
    difficulties = np.random.default_rng(3).integers(1, 65, size=200)
    for rank in range(dp):
        port = DeepSpeedDataSampler(difficulties, 8, CurriculumScheduler(dict(SCHEDULES["fixed_linear"])),
                                    data_parallel_rank=rank, data_parallel_size=dp, seed=7)
        ref = JDataSampler(difficulties, 8, JCurriculumScheduler(dict(SCHEDULES["fixed_linear"])),
                           data_parallel_rank=rank, data_parallel_size=dp, seed=7)
        for step in range(12):
            got, want = port.next_batch(), ref.next_batch()
            np.testing.assert_array_equal(got, want)
            limit = port.scheduler.get_current_difficulty()
            # the pool falls back to the easiest samples when too few qualify
            assert np.all(difficulties[got] <= max(limit, np.sort(difficulties)[7])), step
        assert len(port) == len(ref) and port.state_dict() == ref.state_dict()
    resumed = DeepSpeedDataSampler(difficulties, 8, CurriculumScheduler(dict(SCHEDULES["fixed_linear"])),
                                   data_parallel_rank=dp - 1, data_parallel_size=dp, seed=0)
    resumed.load_state_dict(port.state_dict())
    np.testing.assert_array_equal(resumed.next_batch(), port.next_batch())


def _samples(dtype, n=40, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, size=int(rng.integers(1, 30))).astype(dtype) for _ in range(n)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64, np.float32])
def test_mmap_dataset_files_are_byte_equal_and_cross_readable(tmp_path, dtype):
    samples = _samples(dtype)
    for pkg, prefix in ((tds, tmp_path / "port"), (jds, tmp_path / "ref")):
        b = pkg.MMapIndexedDatasetBuilder(str(prefix), dtype=dtype)
        b.add_items(samples[:30])
        b.finalize()
        extra = pkg.MMapIndexedDatasetBuilder(str(prefix) + "_extra", dtype=dtype)
        extra.add_items(samples[30:])
        extra.finalize()
        merged = pkg.MMapIndexedDatasetBuilder(str(prefix) + "_merged", dtype=dtype)
        merged.merge_file(str(prefix))
        merged.merge_file(str(prefix) + "_extra")
        merged.finalize()
    for suffix in ("", "_extra", "_merged"):
        for ext in (".bin", ".idx"):
            assert _read(f"{tmp_path}/port{suffix}{ext}") == _read(f"{tmp_path}/ref{suffix}{ext}"), suffix + ext
    # each package reads the other's files
    for reader, prefix in ((tds.MMapIndexedDataset, "ref_merged"), (jds.MMapIndexedDataset, "port_merged")):
        ds = reader(str(tmp_path / prefix))
        assert len(ds) == len(samples) and ds.dtype == np.dtype(dtype)
        for i, s in enumerate(samples):
            np.testing.assert_array_equal(ds[i], s)
            assert ds.num_tokens(i) == s.size
        np.testing.assert_array_equal(ds[-1], samples[-1])
    assert tds.MMapIndexedDataset.exists(str(tmp_path / "ref")) and not tds.MMapIndexedDataset.exists(
        str(tmp_path / "none"))


def _npz_members(path):
    """The arrays of an .npz, by name, as raw .npy bytes: the zip container
    stamps each member with the time it was written, so only the members are
    compared byte for byte."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("workers,threads", [(1, 1), (2, 3)])
def test_data_analyzer_index_files_are_byte_equal(tmp_path, workers, threads):
    samples = _samples(np.int32, n=57, seed=11)
    b = tds.MMapIndexedDatasetBuilder(str(tmp_path / "corpus"))
    b.add_items(samples)
    b.finalize()
    metrics = (["seqlen", "vocab"], [lambda s: int(s.size), lambda s: np.bincount(s, minlength=100)],
               ["single_value_per_sample", "accumulate_value_over_samples"])
    out = {}
    for name, pkg in (("port", tds), ("ref", jds)):
        ds = pkg.MMapIndexedDataset(str(tmp_path / "corpus"))
        analyzer = pkg.DataAnalyzer(ds, *metrics, save_path=str(tmp_path / name), num_workers=workers,
                                    num_threads=threads)
        out[name] = analyzer.run_map_reduce()
    for m in ("seqlen", "vocab"):
        np.testing.assert_array_equal(out["port"][m], out["ref"][m])
    files = sorted(f for f in os.listdir(tmp_path / "ref") if os.path.isfile(tmp_path / "ref" / f))
    assert files == sorted(f for f in os.listdir(tmp_path / "port") if os.path.isfile(tmp_path / "port" / f))
    assert "seqlen_metric_to_sample.npz" in files and "vocab_accumulated.npy" in files
    for f in files:
        port, ref = tmp_path / "port" / f, tmp_path / "ref" / f
        if f.endswith(".npz"):
            assert _npz_members(port) == _npz_members(ref), f
        else:
            assert _read(port) == _read(ref), f
    for w in range(workers):
        for t in range(threads):
            for m in ("seqlen", "vocab"):
                name = f"worker_{w}/{m}_thread{t}.npy"
                assert _read(tmp_path / "port" / name) == _read(tmp_path / "ref" / name), name
    # the sampler's difficulties, read by either package from the other's files
    np.testing.assert_array_equal(tds.DataAnalyzer.load_difficulties(str(tmp_path / "ref"), "seqlen"),
                                  jds.DataAnalyzer.load_difficulties(str(tmp_path / "port"), "seqlen"))
    np.testing.assert_array_equal(tds.DataAnalyzer.get_metric_value_percentiles(str(tmp_path / "ref"), "seqlen"),
                                  jds.DataAnalyzer.get_metric_value_percentiles(str(tmp_path / "port"), "seqlen"))


def test_random_ltd_schedule_matches_reference():
    kw = dict(min_value=128, max_value=1024, require_steps=100, increase_step=16, total_layer_num=12,
              random_ltd_layer_num=10, global_batch_size=4)
    port, ref = tltd.RandomLTDScheduler(**kw), jltd.RandomLTDScheduler(**kw)
    assert [port.get_value(s) for s in range(0, 220, 7)] == [ref.get_value(s) for s in range(0, 220, 7)]
    assert [port.update_seq(s) for s in range(30)] == [ref.update_seq(s) for s in range(30)]
    assert port.state_dict() == ref.state_dict()
    assert tltd.RandomLTDScheduler(**kw).get_total_layer_tokens(10) == \
        jltd.RandomLTDScheduler(**kw).get_total_layer_tokens(10)
    other = tltd.RandomLTDScheduler(**kw)
    other.load_state_dict(port.state_dict())
    assert other.get_current_seq() == port.get_current_seq()


def test_random_ltd_gather_scatter_match_reference():
    x = np.random.default_rng(0).normal(size=(2, 16, 8)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(2, 6, 8)).astype(np.float32)
    idx = tltd.random_token_indices(torch.Generator().manual_seed(3), 16, 6)
    assert idx.shape == (6, ) and bool(torch.all(idx[1:] > idx[:-1]))  # sorted and unique
    jidx = jnp.asarray(idx.numpy())
    xt = torch.tensor(x, requires_grad=True)
    part = tltd.gather_tokens(xt, idx)
    np.testing.assert_array_equal(part.detach().numpy(), np.asarray(jltd.gather_tokens(jnp.asarray(x), jidx)))
    out = tltd.scatter_tokens(xt, part * 2.0, idx)
    want = jltd.scatter_tokens(jnp.asarray(x), jltd.gather_tokens(jnp.asarray(x), jidx) * 2.0, jidx)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    # the backward is autograd's own: equal to jax's VJP of the same function
    (out * torch.tensor(np.repeat(w[:, :1], 16, axis=1))).sum().backward()
    jgrad = jax.grad(lambda h: jnp.sum(jltd.scatter_tokens(h, jltd.gather_tokens(h, jidx) * 2.0, jidx) *
                                       jnp.repeat(jnp.asarray(w[:, :1]), 16, axis=1)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    np.testing.assert_array_equal(x, xt.detach().numpy())  # scatter leaves its input alone


def test_pld_theta_matches_reference_to_1e_12():
    port, ref = tpld.ProgressiveLayerDrop(theta=0.5, gamma=0.001), jpld.ProgressiveLayerDrop(theta=0.5, gamma=0.001)
    assert port.get_theta() == ref.get_theta() == 1.0
    for step in list(range(0, 50)) + [100, 1000, 10000]:
        port.update_state(step)
        ref.update_state(step)
        assert abs(port.get_theta() - ref.get_theta()) <= 1e-12
        assert abs(port.get_theta() - ((1 - 0.5) * np.exp(-0.001 * step) + 0.5)) <= 1e-12
    assert port.get_state() == ref.get_state()
    for i in range(12):
        assert tpld.keep_prob(i, 12, 0.7) == jpld.keep_prob(i, 12, 0.7)


def test_pld_layer_drop_keep_skip_and_eval():
    x = torch.ones(4, 8, requires_grad=True)
    fn = lambda t: t * 2.0
    torch.testing.assert_close(tpld.layer_drop(fn, x, None, 0.0), x * 2)  # eval: always runs
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(tpld.layer_drop(fn, x, g, 1.0), x * 2)
    assert tpld.layer_drop(fn, x, g, 0.0) is x
    tpld.layer_drop(fn, x, g, 1.0).sum().backward()
    assert torch.all(x.grad == 2.0)
    # a keep probability of 0.3 keeps about 30% of 2000 draws, from the host generator
    kept = sum(tpld.layer_drop(lambda t: t + 1, torch.zeros(()), g, 0.3).item() for _ in range(2000))
    assert 0.25 < kept / 2000 < 0.35


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 24,
              "schedule_type": "fixed_linear", "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 8}}


@pytest.fixture(scope="module")
def curriculum_runs():
    """The same tiny Llama and batches through both engines with the legacy
    curriculum block: a train_batch per step (five steps, three lengths),
    then the micro-step API for one more step."""
    jcfg = jax_tiny(num_key_value_heads=2)
    jparams = jax_params(jcfg)
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(6):
        ids = rng.integers(0, jcfg.vocab_size, size=(4, 25))
        batches.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)))
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 3e-3}}, "curriculum_learning": dict(CURRICULUM)}
    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                config=config)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(port_config(jcfg)),
                                                     model_parameters=port_params(jcfg, jparams), config=config,
                                                     device="cpu")
    lengths = []
    engine.module.register_forward_pre_hook(lambda m, args: lengths.append(args[0][0].shape[1]))
    out = {"port": [], "ref": [], "lengths": lengths}
    for b in batches[:5]:
        out["ref"].append(float(jengine.train_batch(batch=b)))
        out["port"].append(float(engine.train_batch(batch=b)))
    for eng, key in ((jengine, "ref"), (engine, "port")):
        for half in (slice(0, 2), slice(2, 4)):
            loss = eng.forward(tuple(x[half] for x in batches[5]))
            eng.backward(loss)
            eng.step()
        out[key + "_micro"] = float(loss.detach()) if isinstance(loss, torch.Tensor) else float(loss)
        out[key + "_difficulty"] = eng.curriculum_scheduler.get_current_difficulty()
    return out


def test_engine_curriculum_truncates_as_the_jax_engine(curriculum_runs):
    r = curriculum_runs
    # difficulty at global step t + 1: 8 + (t + 1) / 3 * 16, floored to 8
    assert r["lengths"][:10] == [8, 8, 16, 16, 24, 24, 24, 24, 24, 24]
    np.testing.assert_allclose(r["port"], r["ref"], rtol=2e-5, atol=2e-5)


def test_engine_curriculum_micro_step_api_matches(curriculum_runs):
    r = curriculum_runs
    assert r["lengths"][10:] == [24, 24] and r["port_difficulty"] == r["ref_difficulty"] == 24
    np.testing.assert_allclose(r["port_micro"], r["ref_micro"], rtol=2e-5, atol=2e-5)
