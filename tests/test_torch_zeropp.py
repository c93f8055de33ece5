"""Port parity for ZeRO++: qwZ, qgZ, the compressed collectives, hpZ and
MiCS.

- qwZ's int8 and int4 payloads and scales for a rank's shard equal the
  reference's quantization of the same shard bit for bit, through the
  converter's transpose: the weight the reference's ``make_qwz_cast``
  all-gathers and dequantizes on a 2-device mesh equals the port's
  dequantized gather of the two ranks' payloads exactly, the nibble packing
  is the reference's ``_pack_nibbles`` on the same values, and the pack
  dimension is the reference's ``_nibble_pack_dim``.
- qgZ's int8 reduce-scatter: with one rank contributing, each rank's chunk
  is exactly its dequantized int8 blocks, and equals the reference's
  ``quantized_reduce_scatter`` bit for bit; with both, the sum holds to f32
  summation order. The 1-bit ``compressed_allreduce`` with its error
  feedback over two rounds matches the reference's.
- The engines at world 2 (qwZ at stage 3 in int8 and int4, qgZ at stages 1
  and 2) and at world 4 (hpZ and MiCS with a secondary group of 2, the
  reference's ``data 2 x hpz 2`` mesh) against the reference's engine with
  the same knobs on as many CPU devices; each rank's placement against the
  rule; the bytes the comms logger counts against the exact run's.
- The raises of the reference's engine (qwZ below stage 3, the
  nontrainable knob, int3, an hpZ size the data degree does not divide),
  and qgZ's fallback where it does not apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.comm import compressed as jcompressed
from deepspeed_tpu.runtime.zero import qwz as jqwz
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models.convert import to_flax_params
from deepspeed_tpu_torch.runtime.zero import qwz as tqwz
from deepspeed_tpu_torch.utils import groups
from tests import torch_gang_scenarios as sc
from tests.test_torch_zero import LOSS_TOL, _assert_params_close, _batches, _fields, _jcfg
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, port_config, port_params

LR = 3e-3


def _config(world, stage, **zero):
    return {"train_batch_size": 4 * world, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0, **zero}}


# ------------------------------------------------------------------- qwZ --
class _Part:
    """The partitioner fields the qwZ gather reads, for one tensor."""

    def __init__(self, name, shape, transposed, master):
        self.shapes = {name: tuple(shape)}
        self.transposed = {name: transposed}
        self.masters = {name: master}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("ref_shape,transposed", [((32, 48), True), ((64, 32), False), ((32, 15), True)],
                         ids=["linear", "embedding", "odd_linear"])
def test_qwz_payloads_and_scales_equal_the_reference(bits, ref_shape, transposed):
    """Two ranks' shards of one weight (sharded on the reference's dim 0):
    the dequantized gather equals the reference's qwZ cast exactly, the
    packing equals ``_pack_nibbles``, the pack dim ``_nibble_pack_dim``
    (None where no free dim is even: int8 on the wire)."""
    w_ref = np.random.default_rng(0).normal(size=ref_shape).astype(np.float32)
    mesh = jgroups.initialize_mesh(devices=jax.devices()[:2], force=True)
    sharding = {"w": NamedSharding(mesh, P("data", None))}
    cast = jqwz.make_qwz_cast(sharding, mesh, jnp.float32, zero_axes=("data", ), bits=bits, threshold=0)
    want = np.asarray(jax.jit(cast)({"w": jax.device_put(jnp.asarray(w_ref), sharding["w"])})["w"])
    jgroups.destroy_mesh()

    w = torch.from_numpy(w_ref.T.copy() if transposed else w_ref)
    dim = 1 if transposed else 0
    gather = tqwz.QuantizedWeightGather(_Part("w", w.shape, transposed, w), torch.float32, bits=bits)
    chunks = torch.chunk(w, 2, dim=dim)
    payloads = [gather.payload("w", c, dim) for c in chunks]
    pack = payloads[0][2]
    ref_pack = jqwz._nibble_pack_dim(ref_shape, 0, P("data", None), mesh) if bits == 4 else None
    assert pack == (None if ref_pack is None else (1 - ref_pack if transposed else ref_pack))
    q_full = torch.cat([p[0] for p in payloads], dim=dim)
    s_full = torch.cat([p[1] for p in payloads], dim=dim)
    assert q_full.dtype == torch.int8 and s_full.dtype == torch.float32
    if pack is not None:
        assert q_full.shape[pack] * 2 == w.shape[pack]
        q_full = tqwz.unpack_nibbles(q_full, pack)
    got = (q_full.float() * s_full).numpy()
    np.testing.assert_array_equal(got.T if transposed else got, want)
    if pack is not None:  # the packing itself, against the reference's function
        q, _ = tqwz.quantize_shard(chunks[0], dim, bits)
        ref_packed = np.asarray(jqwz._pack_nibbles(jnp.asarray(q.numpy().T if transposed else q.numpy()), ref_pack))
        mine = tqwz.pack_nibbles(q, pack).numpy()
        np.testing.assert_array_equal(mine.T if transposed else mine, ref_packed)
        np.testing.assert_array_equal(tqwz.unpack_nibbles(tqwz.pack_nibbles(q, pack), pack).numpy(), q.numpy())


# ------------------------------------------------------ compressed comm --
@pytest.fixture(scope="module")
def gang():
    g = Gang(2)
    yield g
    g.close()


@pytest.fixture(scope="module")
def gang4():
    g = Gang(4)
    yield g
    g.close()


def _reference_qrs(xs, block):
    mesh = jgroups.initialize_mesh(devices=jax.devices()[:2], force=True)
    out = np.asarray(jcompressed.quantized_reduce_scatter(jnp.asarray(xs), axis_name="data", mesh=mesh,
                                                          block=block))
    jgroups.destroy_mesh()
    return out


@pytest.mark.parametrize("n,block", [(2048, 512), (2000, 512), (1536, 128)])
def test_qgz_reduce_scatter_blocks_equal_the_reference(gang, n, block):
    """One contributor: each rank's chunk is its int8 blocks times their
    scales exactly, bit for bit the reference's (padding to whole blocks
    included). Two: the sum within f32 summation order."""
    rng = np.random.default_rng(n)
    xs = np.stack([rng.normal(size=n).astype(np.float32) * 3, np.zeros(n, np.float32)])
    got = np.concatenate(gang.run(sc.quantized_reduce_scatter_case, xs, block))
    np.testing.assert_array_equal(got, _reference_qrs(xs, block))
    xs[1] = rng.normal(size=n).astype(np.float32)
    got = np.concatenate(gang.run(sc.quantized_reduce_scatter_case, xs, block))
    np.testing.assert_allclose(got, _reference_qrs(xs, block), rtol=1e-6, atol=1e-6)
    assert np.abs(got - xs.sum(0)).max() <= 2 * np.abs(xs).max() / 127  # int8 error


def test_compressed_allreduce_matches_the_reference(gang):
    """Two rounds of the 1-bit all-reduce of one tensor with per-rank worker
    and server error feedback: output and both errors against the
    reference's (its per-tensor L1 means in another summation order)."""
    rng = np.random.default_rng(5)
    n, N = 2, 1024
    x = rng.normal(size=N).astype(np.float32)
    we = rng.normal(size=(n, N)).astype(np.float32) * 0.1
    se = rng.normal(size=(n, N // n)).astype(np.float32) * 0.1
    res = gang.run(sc.compressed_allreduce_case, x, we, se, 2)
    mesh = jgroups.initialize_mesh(devices=jax.devices()[:2], force=True)
    out, jwe, jse = jnp.asarray(x), jnp.asarray(we.reshape(-1)), jnp.asarray(se.reshape(-1))
    for _ in range(2):
        out, jwe, jse = jcompressed.compressed_allreduce(jnp.asarray(x), jwe, jse, axis_name="data", mesh=mesh)
    jgroups.destroy_mesh()
    for r, (o, w_err, s_err) in enumerate(res):
        np.testing.assert_allclose(o, np.asarray(out), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(w_err, np.asarray(jwe).reshape(n, N)[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s_err, np.asarray(jse).reshape(n, N // n)[r], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- engines --
@pytest.fixture(scope="module")
def runs():
    jcfg = _jcfg()
    jparams = jax_params(jcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}
    cache = {}

    def reference(world, stage, secondary=1, **zero):
        key = (world, stage, secondary, tuple(sorted(zero.items())))
        if key not in cache:
            batches = _batches(jcfg.vocab_size, 4 * world, 3)
            jgroups.initialize_mesh(devices=jax.devices()[:world], secondary_partition_size=secondary, force=True)
            engine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                       config=_config(world, stage, **zero))
            losses = [float(engine.train_batch(batch=b)) for b in batches]
            cache[key] = dict(losses=losses, norm=engine.get_global_grad_norm(), batches=batches,
                              params=jax.tree.map(np.asarray, jax.device_get(engine.params)),
                              qwz=engine._qwz, qgz=engine._qgz)
            engine.destroy()
            jgroups.destroy_mesh()
        return cache[key]

    return jcfg, state, reference


@pytest.fixture(scope="module")
def exact_runs(gang, runs):
    """The port's exact run at world 2 and a stage on the reference's
    batches (``train_llama_plus``), once a stage: what the quantized runs
    of the stage are held against."""
    jcfg, state, reference = runs
    cache = {}

    def exact(stage, batches):
        if stage not in cache:
            cache[stage] = gang.run(sc.train_llama_plus, _fields(port_config(jcfg)), state, _config(2, stage),
                                    batches)
        return cache[stage]

    return exact


def _held_to(res, ref, pcfg, loss_tol=LOSS_TOL):
    for r in res:
        np.testing.assert_allclose(r["losses"], ref["losses"], **loss_tol)
    for a, b in zip(res[0]["full"].values(), res[-1]["full"].values()):
        assert np.array_equal(a, b)
    got = jax.tree.leaves(to_flax_params({k: torch.from_numpy(v) for k, v in res[0]["full"].items()}, pcfg))
    for g, w in zip(got, jax.tree.leaves(ref["params"])):
        _assert_params_close(g, w)


@pytest.mark.parametrize("bits", [8, 4])
def test_qwz_engine_matches_the_reference_qwz(gang, runs, exact_runs, bits):
    """qwZ at stage 3 over 2 ranks against the reference's qwZ engine: the
    first step's loss to f32 rounding (both quantize the same masters), the
    later ones within a quantization level's effect (a weight rounding the
    other way after a step that differed in the last bits: 1e-3), the
    masters as the exact runs are held; quantized gathers ran, the result
    is not the exact run's, and the all-gathers moved about a quarter
    (int8) or an eighth (int4) of the exact run's f32 bytes."""
    jcfg, state, reference = runs
    ref = reference(2, 3, zero_quantized_weights=True, zero_quantized_weights_bits=bits)
    assert ref["qwz"]
    pcfg = port_config(jcfg)
    cfg = _config(2, 3, zero_quantized_weights=True, zero_quantized_weights_bits=bits)
    res = gang.run(sc.train_llama_plus, _fields(pcfg), state, cfg, ref["batches"])
    exact = exact_runs(3, ref["batches"])
    for r in res:
        assert r["losses"][0] == pytest.approx(ref["losses"][0], rel=2e-5)
    _held_to(res, ref, pcfg, loss_tol=dict(rtol=1e-3, atol=1e-3))
    for r, e in zip(res, exact):
        assert r["qwz_gathers"] > 0
        assert r["losses"] != e["losses"]
        ratio = r["comm_bytes"]["all_gather_into_tensor"] / e["comm_bytes"]["all_gather_into_tensor"]
        assert ratio < (0.3 if bits == 8 else 0.2), ratio


@pytest.mark.parametrize("stage", [1, 2])
def test_qgz_engine_matches_the_reference_qgz(gang, runs, exact_runs, stage):
    """qgZ over 2 ranks against the reference's qgZ engine: its int8 blocks
    are the reference's, so the losses agree to f32 summation order; the
    int8 all-to-all moves a quarter of the bytes the exact run's gradient
    collectives do, plus the f32 block scales. The f32 sum is then
    all-gathered (the reference's layout): at stage 2, GAS 2, with the
    masters' all-gather after the step in both runs, a rank sends (2 (1/8 +
    1/2) + 1/2) / (2 / 2 + 1/2) = 7/6 of the exact run's bytes (ring counts
    at world 2: an all-gather sends its input chunk, a reduce-scatter or an
    all-to-all half its input, an all-reduce its input)."""
    jcfg, state, reference = runs
    ref = reference(2, stage, zero_quantized_gradients=True)
    assert ref["qgz"]
    pcfg = port_config(jcfg)
    res = gang.run(sc.train_llama_plus, _fields(pcfg), state, _config(2, stage, zero_quantized_gradients=True),
                   ref["batches"])
    exact = exact_runs(stage, ref["batches"])
    _held_to(res, ref, pcfg)
    for r, e in zip(res, exact):
        assert r["qgz"] and r["losses"] != e["losses"]
        if stage == 2:
            ratio = r["comm_bytes"]["all_to_all_single"] / e["comm_bytes"]["reduce_scatter_tensor"]
            assert 0.25 < ratio < 0.27, ratio
            sent = [sum(b * {"reduce_scatter_tensor": 0.5, "all_to_all_single": 0.5}.get(op, 1)
                        for op, b in run["comm_bytes"].items()) for run in (r, e)]
            assert 7 / 6 < sent[0] / sent[1] < 7 / 6 + 0.01, sent


@pytest.mark.parametrize("knob", ["zero_hpz_partition_size", "mics_shard_size"])
def test_hpz_and_mics_match_the_reference_at_world_4(gang4, runs, knob):
    """A secondary group of 2 at stage 3 over 4 ranks against the
    reference's engine on its ``data 2 x hpz 2`` mesh: losses and masters;
    hpZ shards the parameters over the hpz pair only and the optimizer
    state over all four, MiCS shards everything within the pair (so each
    rank holds half of every sharded tensor's state, not a quarter)."""
    jcfg, state, reference = runs
    ref = reference(4, 3, secondary=2, **{knob: 2})
    pcfg = port_config(jcfg)
    res = gang4.run(sc.train_llama_plus, _fields(pcfg), state, _config(4, 3, **{knob: 2}), ref["batches"])
    _held_to(res, ref, pcfg)
    full = {k: v.size for k, v in res[0]["full"].items()}
    for r in res:
        hpz_pair = [r["rank"] - r["rank"] % 2, r["rank"] - r["rank"] % 2 + 1]
        assert r["param_group"] == hpz_pair
        assert r["zero_group"] == (hpz_pair if knob == "mics_shard_size" else [0, 1, 2, 3])
        for name, dim in r["param_dim"].items():
            assert r["local"][name].size == (full[name] // 2 if dim is not None else full[name])
        opt_degree = 2 if knob == "mics_shard_size" else 4
        for name, dim in r["opt_dim"].items():
            assert r["opt"][f"exp_avg/{name}"].size == (full[name] // opt_degree if dim is not None else full[name])


def test_zeropp_raises_as_the_reference(runs):
    """qwZ below stage 3 (ValueError), the nontrainable knob
    (NotImplementedError), int3 (ValueError), and an hpZ size the data
    degree does not divide (TopologyError), in both packages; qgZ where it
    does not apply falls back to the exact reduction in both."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    jcfg, state, _ = runs
    pcfg = port_config(jcfg)
    cases = [({"stage": 2, "zero_quantized_weights": True}, ValueError, "stage 3"),
             ({"stage": 3, "zero_quantized_nontrainable_weights": True}, NotImplementedError, "nontrainable"),
             ({"stage": 3, "zero_quantized_weights": True, "zero_quantized_weights_bits": 3}, ValueError, "bits"),
             ({"stage": 3, "zero_hpz_partition_size": 3}, groups.TopologyError, None)]
    jparams = jax_params(jcfg)
    for zero, error, match in cases:
        cfg = {"train_batch_size": 4, "zero_optimization": {"stage3_param_persistence_threshold": 0, **zero}}
        groups.destroy_mesh()
        terr = groups.TopologyError if error is groups.TopologyError else error
        with pytest.raises(terr, match=match):
            deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(LlamaConfig(dtype=torch.float32, **_fields(pcfg))),
                                           config=cfg, device="cpu")
        jgroups.initialize_mesh(devices=jax.devices()[:2] if "hpz" not in str(zero) else jax.devices()[:8],
                                force=True)
        jerr = jgroups.TopologyError if error is groups.TopologyError else error
        with pytest.raises(jerr, match=match):
            deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                     config=dict(cfg, train_batch_size=8 if "hpz" in str(zero) else 4))
        jgroups.destroy_mesh()
    groups.destroy_mesh()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(LlamaConfig(dtype=torch.float32, **_fields(pcfg))),
        config={"train_batch_size": 4, "zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
        device="cpu")
    assert engine._qgz is None and engine.communication_data_type() == torch.float32
    engine.destroy()
    groups.destroy_mesh()
