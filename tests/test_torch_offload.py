"""Port parity for ZeRO-Offload: the optimizer state at rest in host memory
(``offload_optimizer.device: cpu``) or on disk (``nvme``), the update on the
host.

- Three ``train_batch`` steps of the tiny Llama at ZeRO stage 2 with CPU
  and with NVMe offload, at world 1 (this process) and world 2 (a gloo gang,
  ``tests/torch_gang.py``), against the reference's engine with the same
  offload on as many CPU devices: per-step losses, the global norm and the
  masters (f32 on both sides: the losses to summation order, the masters
  as ``tests/test_torch_zero.py`` holds them). On the CPU the host update is
  the device update, so the port's offloaded masters equal its own run
  without offload bit for bit, and NVMe's equal CPU offload's.
- Between steps the state rests off the engine's tensors on disk (NVMe: stubs
  only) or in host memory; a checkpoint saved under offload reloads bit for
  bit and the next step agrees bit for bit; the swapper's round trip is
  bitwise, it counts its requests, and ``destroy`` closes it; without the
  native aio engine it raises.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import to_flax_params
from deepspeed_tpu_torch.runtime.swap_tensor import NvmeSwappedLeaf, PartitionedOptimizerSwapper
from deepspeed_tpu_torch.utils import groups
from tests import torch_gang_scenarios as sc
from tests.test_torch_zero import LOSS_TOL, _assert_params_close, _batches, _fields, _jcfg
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, port_config, port_params

STEPS = 3


def _config(world, offload, stage=2):
    return {"train_batch_size": 4 * world, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "offload_optimizer": offload}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = _jcfg()
    jparams = jax_params(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    cache = {}

    def reference(world, device):
        """The reference engine's run with ``device`` offload on ``world``
        CPU devices (each made once)."""
        if (world, device) not in cache:
            off = {"device": device}
            if device == "nvme":
                off["nvme_path"] = str(tmp_path_factory.mktemp(f"jax_nvme{world}"))
            batches = _batches(jcfg.vocab_size, 4 * world, STEPS)
            jgroups.initialize_mesh(devices=jax.devices()[:world], force=True)
            engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                       config=_config(world, off))
            losses = [float(engine.train_batch(batch=b)) for b in batches]
            cache[(world, device)] = dict(losses=losses, norm=engine.get_global_grad_norm(), batches=batches,
                                          params=jax.tree.map(np.asarray, jax.device_get(engine.params)))
            engine.destroy()
            jgroups.destroy_mesh()
        return cache[(world, device)]

    return jcfg, state, reference, tmp_path_factory


@pytest.fixture(scope="module")
def gang():
    g = Gang(2)
    yield g
    g.close()


def _check_against_reference(res, ref, pcfg):
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"], **LOSS_TOL)
        assert r["norms"][-1] == pytest.approx(ref["norm"], rel=1e-4)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    for g, w in zip(got, jax.tree.leaves(ref["params"])):
        _assert_params_close(g, w)


def _offload(device, where):
    return {"device": device, "nvme_path": str(where)} if device == "nvme" else {"device": device}


@pytest.mark.parametrize("device", ["cpu", "nvme"])
@pytest.mark.parametrize("world", [1, 2])
def test_offload_matches_the_reference_engine(gang, setup, world, device):
    """CPU and NVMe offload at ZeRO-2 against the reference's engine with
    the same offload; the state rests off the device, and on disk only as
    stubs; the masters equal the port's own run without offload bit for
    bit (on the CPU the host update is the device update)."""
    jcfg, state, reference, tmp = setup
    ref = reference(world, device)
    pcfg = port_config(jcfg)
    cfg = _config(world, _offload(device, tmp.mktemp(f"nvme{world}")))
    plain = _config(world, None)
    if world == 1:
        groups.destroy_mesh()
        res = [sc.train_llama_plus(_fields(pcfg), state, cfg, ref["batches"])]
        base = [sc.train_llama_plus(_fields(pcfg), state, plain, ref["batches"])]
    else:
        res = gang.run(sc.train_llama_plus, _fields(pcfg), state, cfg, ref["batches"])
        base = gang.run(sc.train_llama_plus, _fields(pcfg), state, plain, ref["batches"])
    _check_against_reference(res, ref, pcfg)
    for r, b in zip(res, base):
        assert r["cpu_offload"] == (device == "cpu") and r["nvme"] == (device == "nvme")
        assert r["rest"]["device"] == 0
        if device == "nvme":
            assert r["rest"]["host"] == 0 and r["rest"]["disk"] == r["bytes"]["optimizer"] > 0
        for k in r["full"]:
            assert np.array_equal(r["full"][k], b["full"][k]), k
        for k in r["opt"]:
            assert np.array_equal(r["opt"][k], b["opt"][k]), k


def test_whole_tensor_optimizer_offload_updates_where_it_can_gather(gang, setup):
    """LAMB reads whole tensors, so over a partitioned state (ZeRO 1, two
    ranks) it gathers the state over the ranks: the offloaded state is
    staged to the engine's device for the update (the reference's
    choreography path), and the masters equal the run without offload bit
    for bit."""
    jcfg, state, _, _ = setup
    pcfg = port_config(jcfg)
    batches = _batches(jcfg.vocab_size, 8, 2)
    cfg = dict(_config(2, {"device": "cpu"}, stage=1), optimizer={"type": "Lamb", "params": {"lr": 1e-3}})
    plain = dict(_config(2, None, stage=1), optimizer={"type": "Lamb", "params": {"lr": 1e-3}})
    res = gang.run(sc.train_llama_plus, _fields(pcfg), state, cfg, batches)
    base = gang.run(sc.train_llama_plus, _fields(pcfg), state, plain, batches)
    for r, b in zip(res, base):
        assert r["cpu_offload"] and not r["host_compute"] and b["host_compute"] is False
        assert r["rest"]["device"] == 0 and r["rest"]["host"] > 0
        assert r["losses"] == b["losses"] and all(np.array_equal(r["full"][k], b["full"][k]) for k in r["full"])


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_checkpoint_under_offload_reloads_bitwise(setup, device, tmp_path):
    """Save after two steps under offload, load into a new engine: masters
    and optimizer state bit for bit, the reloaded state at rest where the
    plan keeps it, and the next step equal on both engines."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    jcfg, state, _, _ = setup
    pcfg = port_config(jcfg)
    batches = _batches(jcfg.vocab_size, 4, 3)

    def make(swap):
        # one swap directory an engine: its files are its rank's
        cfg = _config(1, _offload(device, tmp_path / swap))
        groups.destroy_mesh()
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(LlamaConfig(dtype=torch.float32,
                                                                                           **_fields(pcfg))),
                                                         model_parameters={k: torch.from_numpy(v)
                                                                           for k, v in state.items()},
                                                         config=cfg, device="cpu")
        return engine

    a = make("swap_a")
    for b in batches[:2]:
        a.train_batch(batch=tuple(torch.from_numpy(x) for x in b))
    a.save_checkpoint(str(tmp_path / "ck"))
    b_eng = make("swap_b")
    b_eng.load_checkpoint(str(tmp_path / "ck"))
    view = lambda e: e._offload.checkpoint_view(e.opt_state)
    for (fa, va), (fb, vb) in zip(view(a)._asdict().items(), view(b_eng)._asdict().items()):
        if isinstance(va, dict):
            assert all(torch.equal(va[n], vb[n]) for n in va), fa
        else:
            assert torch.equal(va, vb), fa
    assert all(torch.equal(a.params[k], b_eng.params[k]) for k in a.params)
    if device == "nvme":
        assert all(isinstance(t, NvmeSwappedLeaf) for t in b_eng.opt_state.exp_avg.values())
    la = float(a.train_batch(batch=tuple(torch.from_numpy(x) for x in batches[2])))
    lb = float(b_eng.train_batch(batch=tuple(torch.from_numpy(x) for x in batches[2])))
    assert la == lb and all(torch.equal(a.params[k], b_eng.params[k]) for k in a.params)
    for e in (a, b_eng):
        e.destroy()
    if device == "nvme":
        assert a._offload.swapper.aio is None, "destroy closes the swapper"


def test_swapper_round_trip_is_bitwise(tmp_path):
    """A state tree of several dtypes (the int32 step, f32 moments, a bf16
    leaf, a 0-d tensor) out to disk and back: bit for bit, as stubs between,
    with one write and one read a tensor through a pool of 2 buffers."""
    from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState
    g = torch.Generator().manual_seed(0)
    st = AdamState(step=torch.tensor(7, dtype=torch.int32),
                   exp_avg={"a": torch.randn(33, 7, generator=g), "b": torch.randn(5, generator=g).to(torch.bfloat16)},
                   exp_avg_sq={"a": torch.rand(33, 7, generator=g), "b": torch.rand([], generator=g)})
    sw = PartitionedOptimizerSwapper(str(tmp_path), buffer_count=2, rank=3)
    stubs = sw.swap_out(st)
    assert all(isinstance(x, NvmeSwappedLeaf) for x in [stubs.step, *stubs.exp_avg.values(),
                                                         *stubs.exp_avg_sq.values()])
    assert all(os.path.basename(x.path).endswith("_rank3.bin") for x in stubs.exp_avg.values())
    for back in (sw.swap_in(stubs), sw.materialize_host(stubs)):
        assert torch.equal(back.step, st.step)
        for f in ("exp_avg", "exp_avg_sq"):
            for n, t in getattr(st, f).items():
                got = getattr(back, f)[n]
                assert got.dtype == t.dtype and torch.equal(got, t)
    assert sw.stats["writes"] == 5 and sw.stats["reads"] == 10
    assert sw.stats["bytes_out"] == sum(x.nbytes for x in [stubs.step, *stubs.exp_avg.values(),
                                                           *stubs.exp_avg_sq.values()])
    sw.close()
    assert sw.aio is None


def test_nvme_without_the_native_engine_raises(monkeypatch, tmp_path):
    """A failure to build or load the aio engine raises; it never becomes
    CPU offload or a Python thread pool."""
    from deepspeed_tpu_torch.ops.aio import aio_op
    monkeypatch.setattr(aio_op, "_native_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native async-IO"):
        PartitionedOptimizerSwapper(str(tmp_path))


def test_cpuadam_implies_offload_and_the_config_surface():
    """The cpuadam optimizer implies offload (reference engine.py:327);
    ``ratio`` and the ``cpu_offload`` alias are read as the reference
    reads them (the alias only warns)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from tests.test_torch_training import SimpleModel
    groups.destroy_mesh()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config={
        "train_batch_size": 8, "optimizer": {"type": "CPUAdam", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 1, "cpu_offload": True, "offload_optimizer": {"device": "none",
                                                                                     "ratio": 0.25}}},
        device="cpu")
    try:
        assert engine.zero_cpu_offload() and engine.zero_use_cpu_optimizer()
        assert engine.zero_partial_offload() == 0.25
        assert engine._config.zero_config.cpu_offload is True
        assert engine.swap_tensor_config().block_size == 1048576
    finally:
        engine.destroy()
    cfg = DeepSpeedConfig({"train_batch_size": 8, "zero_optimization": {"cpu_offload": True}})
    assert cfg.zero_config.offload_optimizer is None
