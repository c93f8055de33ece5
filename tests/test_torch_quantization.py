"""Port parity for weight quantization (``inference/v2/quantization.py``) and
the quantized ragged engine: int8 values, packed int4 words and f32 scales
bit for bit the reference's at 8 and 4 bits, in f32 and bf16 (the port's
Linear weights are the reference's kernels transposed), the ``min_size``
exclusions and the int4 fallback to int8; a quantized engine against the
reference's quantized engine; TP > 1 refused; and C24: a quantized
``serialize`` directory, which the reference cannot load back quantized,
loads back quantized in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import quantization as jq
from deepspeed_tpu.inference.v2 import config_v2 as jconfig
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_factory import build_engine as jbuild_engine
from deepspeed_tpu.inference.v2.engine_factory import build_engine_from_ds_checkpoint as jbuild_from_ds
from deepspeed_tpu.inference.v2.ragged import manager_configs as jmc
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.inference.v2 import quantization as tq
from deepspeed_tpu_torch.inference.v2 import config_v2 as tconfig
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, build_engine_from_ds_checkpoint
from deepspeed_tpu_torch.inference.v2.model_implementations.llama_v2 import LlamaV2Model
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as mc
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

TOL = dict(rtol=2e-4, atol=2e-4)  # f32 engines on the same weights (test_model_breadth.py's)
MIN_SIZE = 1024  # the tiny model's norms and the small case stay full precision
C24_MIN_SIZE = 128  # the scales of the MLP and lm_head ([1, 128] and [1, 256]) reach it
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (port name, reference-layout shape, transposed in the port)
LEAVES = (
    ("layers.0.self_attn.q_proj.weight", (64, 96), True),  # a Linear: [in, out] there, [out, in] here
    ("layers.0.mlp.odd.weight", (12, 128), True),  # contraction axis 12: int4 falls back to int8
    ("layers.0.block_sparse_moe.experts.wi", (4, 64, 96), False),  # an expert bank, as it is
    ("embed_tokens.weight", (256, 64), False),  # the embedding, along the vocabulary
    ("layers.0.small.weight", (16, 16), True),  # under min_size: kept
    ("layers.0.input_layernorm.weight", (2048, ), False),  # one dimension: kept
)


def _torch(a):
    """A reference array (numpy or jax, bf16 included) as a torch tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _reference_layout(node, transposed):
    return {k: (v.t().contiguous() if transposed and v.dim() == 2 else v) for k, v in node.items()}


def _leaves(jdtype, seed=0):
    """Reference-layout arrays with a zero channel (the scale's 1e-12 floor)
    and a channel of exact halves after scaling (round half to even)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, _ in LEAVES:
        a = rng.normal(size=shape).astype(np.float32)
        if len(shape) >= 2 and shape[-2] >= 8:
            a[..., :, 0] = 0.0
            a[..., :6, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # int8: scale 1
            a[..., :6, 2] = [7.0, 0.5, 1.5, 2.5, -0.5, -3.5]  # int4: scale 1
        out[name] = jnp.asarray(a, jdtype)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_are_the_references_bit_for_bit(bits, dtype):
    jdtype, tdtype = DTYPES[dtype]
    arrays = _leaves(jdtype)
    want_q = jq.quantize_tree(arrays, min_size=MIN_SIZE, bits=bits)
    want_d = jq.dequantize_tree(want_q)
    port_in = {name: (_torch(arrays[name]).t().contiguous() if tr else _torch(arrays[name]))
               for name, _, tr in LEAVES}
    got_q = tq.quantize_tree(port_in, min_size=MIN_SIZE, bits=bits)
    got_d = tq.dequantize_tree(got_q)
    for name, shape, tr in LEAVES:
        kept = len(shape) < 2 or int(np.prod(shape)) < MIN_SIZE
        assert tq.is_quantized_leaf(got_q[name]) != kept, name
        if kept:
            assert got_q[name] is port_in[name]
            continue
        want = {k: _torch(v) for k, v in want_q[name].items()}
        key = tq.Q4KEY if bits == 4 and name != "layers.0.mlp.odd.weight" else tq.QKEY
        assert set(want) == set(got_q[name]) == {key, tq.SKEY, tq.DKEY}, name
        got = _reference_layout(got_q[name], tr)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (name, k)
        d = got_d[name].t() if tr else got_d[name]
        assert d.dtype == tdtype and torch.equal(d, _torch(want_d[name])), name
        # the quantized leaf at rest: 1 byte, or half a byte, a weight plus the scales
        per = 0.5 if key == tq.Q4KEY else 1.0
        assert tq.tree_nbytes(got_q[name]) == int(np.prod(shape) * per) + got_q[name][tq.SKEY].numel() * 4 + \
            port_in[name].element_size()


def test_already_quantized_leaves_stay_as_they_are_c24():
    arrays = {name: _torch(a) for name, a in _leaves(jnp.float32).items()}
    once = tq.quantize_tree(arrays, min_size=MIN_SIZE, bits=8)
    twice = tq.quantize_tree(once, min_size=MIN_SIZE, bits=8)
    for name in once:
        assert twice[name] is once[name]
    with pytest.raises(NotImplementedError, match="bits"):
        tq.quantize_tree(arrays, bits=2)


def _quant(pkg, bits, min_size=MIN_SIZE):
    cls = jconfig.QuantizationConfig if pkg == "jax" else tconfig.QuantizationConfig
    return {"quantization": cls(enabled=True, bits=bits, min_size=min_size)}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_tiny()
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(lambda a: a + 0.02 * rng.normal(size=a.shape).astype(np.float32),
                           to_numpy_tree(jax_params(jcfg)))
    return jcfg, jparams, port_config(jcfg), port_params(jcfg, jparams)


def _rows(engine, prompt, steps=2):
    rows = [np.asarray(engine.put([0], [prompt]))[0]]
    for _ in range(steps):
        rows.append(np.asarray(engine.put([0], [np.asarray([int(np.argmax(rows[-1]))], np.int32)]))[0])
    return np.stack(rows)


def _jconfig(**kw):
    mgr = jmc.DSStateManagerConfig(memory_config=jmc.MemoryConfig(mode=jmc.AllocationMode.ALLOCATE, size=64),
                                   max_context=128)
    return JEngineConfig(state_manager=mgr, kv_block_size=16, **kw)


def _tconfig(**kw):
    mgr = mc.DSStateManagerConfig(memory_config=mc.MemoryConfig(mode=mc.AllocationMode.ALLOCATE, size=64),
                                  max_context=128)
    return RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16, **kw)


PROMPT = np.random.default_rng(7).integers(0, 256, 13).astype(np.int32)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_matches_the_reference_quantized_engine(setup, bits):
    jcfg, jparams, cfg, params = setup
    jgroups.initialize_mesh(force=True)
    want = _rows(jbuild_engine(jparams, jcfg, _jconfig(**_quant("jax", bits))), PROMPT)
    engine = build_engine(params, cfg, _tconfig(**_quant("port", bits)), device="cpu")
    stored = dict(engine.model._params.items())
    assert tq.is_quantized_leaf(stored["layers.0.mlp.up_proj.weight"])
    assert not tq.is_quantized_leaf(stored["layers.0.input_layernorm.weight"])
    assert tq.tree_nbytes(stored) < tq.tree_nbytes(params) * (0.35 if bits == 8 else 0.25)
    got = _rows(engine, PROMPT)
    np.testing.assert_allclose(got, want, **TOL)
    # the quantization moves the logits: a full-precision engine differs
    plain = _rows(build_engine(params, cfg, _tconfig(), device="cpu"), PROMPT)
    assert np.abs(plain - got).max() > 1e-3


def test_quantization_at_tp_above_1_is_refused(setup):
    _, _, cfg, params = setup
    config = _tconfig(tensor_parallel=tconfig.DeepSpeedTPConfig(tp_size=2), **_quant("port", 8))
    with pytest.raises(NotImplementedError, match="TP>1"):
        LlamaV2Model(params, cfg, config, "cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_serialize_loads_back_quantized_c24(setup, tmp_path, bits):
    """C24. The reference's quantized serialize directory, loaded with the
    same quantization, raises in its first forward (its scale leaves of
    ``min_size`` elements or more are quantized again); the port loads it back quantized, the stored leaves
    unchanged, and serves the reference's reload without quantization. The
    port's own directory round-trips the same way."""
    jcfg, jparams, cfg, params = setup
    jgroups.initialize_mesh(force=True)
    jengine = jbuild_engine(jparams, jcfg, _jconfig(**_quant("jax", bits, C24_MIN_SIZE)))
    jdir = str(tmp_path / "jax")
    jengine.serialize(jdir)
    jgroups.initialize_mesh(force=True)
    with pytest.raises(TypeError):
        jbuild_from_ds(jdir, _jconfig(**_quant("jax", bits, C24_MIN_SIZE))).put([0], [PROMPT])
    jgroups.initialize_mesh(force=True)
    want = _rows(jbuild_from_ds(jdir, _jconfig()), PROMPT)

    engine = build_engine_from_ds_checkpoint(jdir, _tconfig(**_quant("port", bits, C24_MIN_SIZE)), device="cpu")
    stored = dict(engine.model._params.items())
    ref_q = to_numpy_tree(jengine.model._params)["model"]["layers_0"]["mlp"]["up_proj"]["kernel"]
    leaf = stored["layers.0.mlp.up_proj.weight"]
    key = tq.Q4KEY if bits == 4 else tq.QKEY
    assert torch.equal(leaf[key].t(), _torch(ref_q[key])) and torch.equal(leaf[tq.SKEY].t(), _torch(ref_q[tq.SKEY]))
    np.testing.assert_allclose(_rows(engine, PROMPT), want, **TOL)

    # the port's own quantized directory: back quantized, bit for bit, in both
    tdir = str(tmp_path / "port")
    build_engine(params, cfg, _tconfig(**_quant("port", bits, C24_MIN_SIZE)), device="cpu").serialize(tdir)
    again = build_engine_from_ds_checkpoint(tdir, _tconfig(**_quant("port", bits, C24_MIN_SIZE)), device="cpu")
    for name, node in dict(again.model._params.items()).items():
        if tq.is_quantized_leaf(node):
            assert all(torch.equal(node[k], stored[name][k]) for k in node), name
    np.testing.assert_allclose(_rows(again, PROMPT), want, **TOL)
    jgroups.initialize_mesh(force=True)
    np.testing.assert_allclose(_rows(jbuild_from_ds(tdir, _jconfig()), PROMPT), want, **TOL)
