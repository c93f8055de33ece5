"""Port parity for weights from disk: ``inference/checkpoint.py`` (the HF
loader and the hand-written safetensors reader and writer), the serialize
directory both ways (``InferenceEngineV2.serialize``,
``engine_factory.build_engine_from_ds_checkpoint``), ``build_hf_engine``'s
routing, and ``--checkpoint`` in ``bin/dstpu_replica.py`` and
``spec/distill.py`` on the CPU.

Tiny HF directories are written here by ``transformers`` and read by
``safetensors`` (neither is on the machine with the card, which is why the
port reads the format itself); the reference's ``load_hf_checkpoint`` reads
the same directories."""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import checkpoint as jckpt
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_factory import build_engine as jbuild_engine
from deepspeed_tpu.inference.v2.engine_factory import build_engine_from_ds_checkpoint as jbuild_from_ds
from deepspeed_tpu.inference.v2.ragged import manager_configs as jmc
from deepspeed_tpu.models import decoder as jdecoder
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.inference import checkpoint as tckpt
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import (build_engine, build_engine_from_ds_checkpoint,
                                                             build_hf_engine, generate, load_ds_checkpoint)
from deepspeed_tpu_torch.inference.v2.ragged import manager_configs as mc
from deepspeed_tpu_torch.models import decoder as tdecoder
from deepspeed_tpu_torch.models.convert import decoder_from_flax, mixtral_from_flax, state_from_reference_leaves
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from tests.test_torch_decoder import seeded_tree
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.torch import load_file, save_file  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
HF_MODELS = {
    "llama": lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(**TINY)),
    "mistral": lambda: transformers.MistralForCausalLM(transformers.MistralConfig(sliding_window=8, **TINY)),
    "qwen2": lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**TINY)),
    "mixtral": lambda: transformers.MixtralForCausalLM(
        transformers.MixtralConfig(num_local_experts=4, num_experts_per_tok=2, **TINY)),
}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _reference_state(tree):
    """A reference tree as the port's ``state_dict``, bit for bit."""
    return state_from_reference_leaves({tuple(k.key for k in path): _torch(v)
                                        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})


def _hf_dir(root, kind, dtype, safe=True, shard=None):
    torch.manual_seed(0)
    model = HF_MODELS[kind]().to(dtype)
    path = os.path.join(root, f"{kind}_{str(dtype)[6:]}_{'st' if safe else 'bin'}{'_sharded' if shard else ''}")
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(path, safe_serialization=safe, **kw)
    # both loaders read the dtype from ``torch_dtype``, the key transformers
    # wrote before 4.56 (newer releases write ``dtype``, which both ignore)
    with open(os.path.join(path, "config.json")) as f:
        doc = json.load(f)
    doc["torch_dtype"] = str(dtype).removeprefix("torch.")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(doc, f)
    return path


@pytest.fixture(scope="module")
def hf_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("hf"))


CASES = [("llama", torch.float32, True, None), ("llama", torch.bfloat16, True, None),
         ("llama", torch.float16, False, None), ("llama", torch.float32, True, "40KB"),
         ("mistral", torch.bfloat16, True, None), ("qwen2", torch.float32, True, None),
         ("mixtral", torch.bfloat16, True, None)]


@pytest.mark.parametrize("kind,dtype,safe,shard", CASES,
                         ids=["llama_f32", "llama_bf16", "llama_f16_bin", "llama_f32_sharded", "mistral_bf16",
                              "qwen2_f32", "mixtral_bf16"])
def test_load_hf_checkpoint_is_the_references_bit_for_bit(hf_root, kind, dtype, safe, shard):
    """The port's ``(state_dict, config)`` against the reference's tree,
    converted (kernels transposed back, Mixtral's banks as they are)."""
    path = _hf_dir(hf_root, kind, dtype, safe, shard)
    if shard:
        assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    want_tree, jcfg = jckpt.load_hf_checkpoint(path)
    state, cfg = tckpt.load_hf_checkpoint(path)
    want = _reference_state(want_tree)
    assert set(state) == set(want)
    for name in want:
        assert state[name].dtype == want[name].dtype == dtype and torch.equal(state[name], want[name]), name
    assert type(cfg).__name__ == type(jcfg).__name__ and cfg.dtype == dtype
    for field in ("vocab_size", "hidden_size", "num_hidden_layers", "num_key_value_heads", "rope_theta",
                  "model_type", "sliding_window", "attention_bias", "num_local_experts"):
        if hasattr(jcfg, field):
            assert getattr(cfg, field) == getattr(jcfg, field), field


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
            "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(), "i32": torch.arange(-6, 6, dtype=torch.int32),
            "i64": torch.arange(10, dtype=torch.int64).reshape(2, 5), "i8": torch.arange(-8, 8, dtype=torch.int8),
            "u8": torch.arange(9, dtype=torch.uint8), "flag": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}


def test_safetensors_reader_and_writer_against_the_library(tmp_path):
    """The reader equals ``safe_open`` on a file the library wrote, and the
    library loads the writer's file, for every dtype the formats share."""
    tensors = _tensors()
    save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    got = tckpt.read_safetensors(str(tmp_path / "lib.safetensors"))
    with safe_open(str(tmp_path / "lib.safetensors"), framework="pt") as f:
        assert set(got) == set(f.keys())
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape and torch.equal(got[name], want)
    tckpt.write_safetensors(str(tmp_path / "port.safetensors"), tensors, {"format": "pt"})
    back = load_file(str(tmp_path / "port.safetensors"))
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    with safe_open(str(tmp_path / "port.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_sharded_reader_reads_the_index(hf_root):
    path = _hf_dir(hf_root, "llama", torch.bfloat16, True, "40KB")
    with open(os.path.join(path, "model.safetensors.index.json")) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    assert len(files) > 1
    got = dict(tckpt._iterate_hf_tensors(path))
    want = {}
    for name in files:
        with safe_open(os.path.join(path, name), framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_save_hf_checkpoint_round_trips_in_both_packages(tmp_path, kind):
    """The port's writer: ``load_hf_checkpoint`` of both packages reads its
    directory back bit for bit, and ``transformers`` loads it."""
    if kind == "llama":
        cfg = LlamaConfig.tiny(model_type="qwen2", attention_bias=True)
        params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        params = {k: v + 0.01 if k.endswith("bias") else v for k, v in params.items()}
    else:
        from deepspeed_tpu_torch.models.mixtral import init_params as mixtral_init
        cfg = MixtralConfig.tiny()
        params = mixtral_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    tckpt.save_hf_checkpoint(str(tmp_path), params, cfg)
    state, cfg2 = tckpt.load_hf_checkpoint(str(tmp_path))
    assert cfg2 == dataclasses.replace(cfg, remat=cfg2.remat) and set(state) == set(params)  # HF has no remat
    assert all(torch.equal(state[k], params[k]) for k in params)
    ref = _reference_state(jckpt.load_hf_checkpoint(str(tmp_path))[0])
    assert all(torch.equal(ref[k], params[k]) for k in params)
    hf = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path), torch_dtype=torch.bfloat16)
    assert torch.equal(hf.model.embed_tokens.weight, params["embed_tokens.weight"])


# ----------------------------------------------------- serialize directories --
def _jconfig():
    mgr = jmc.DSStateManagerConfig(memory_config=jmc.MemoryConfig(mode=jmc.AllocationMode.ALLOCATE, size=64),
                                   max_context=128)
    return JEngineConfig(state_manager=mgr, kv_block_size=16)


def _tconfig():
    mgr = mc.DSStateManagerConfig(memory_config=mc.MemoryConfig(mode=mc.AllocationMode.ALLOCATE, size=64),
                                  max_context=128)
    return RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16)


def _models(kind):
    """``(reference tree, reference config, port state, port config)`` in f32."""
    rng = np.random.default_rng(3)
    noisy = lambda tree: jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
                                      to_numpy_tree(tree))
    if kind == "llama":
        jcfg = jax_tiny()
        tree = noisy(jax_params(jcfg))
        return tree, jcfg, port_params(jcfg, tree), port_config(jcfg)
    if kind == "mixtral":
        jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32)
        tree = noisy(jmixtral.init_params(jcfg)[1])
        cfg = MixtralConfig.tiny(dtype=torch.float32)
        return tree, jcfg, mixtral_from_flax(tree, cfg), cfg
    jcfg = jdecoder.DecoderConfig.tiny(kind, dtype=jnp.float32)
    tree = seeded_tree(jcfg, 3)
    cfg = tdecoder.DecoderConfig.tiny(kind, dtype=torch.float32)
    return tree, jcfg, decoder_from_flax(tree, cfg), cfg


PROMPT = np.random.default_rng(11).integers(0, 256, 13).astype(np.int32)


@pytest.mark.parametrize("kind", ["llama", "mixtral", "opt", "falcon"])
def test_serialize_directories_load_in_the_other_package(tmp_path, kind):
    """A directory the reference's engine wrote builds a port engine with
    the same logits and the same weights; one the port wrote builds a
    reference engine with the same logits. C25: the reference writes a
    Mixtral engine's config as its attention's ``LlamaConfig``, which the
    port refuses to load over expert banks; the port writes the
    ``MixtralConfig``, which the reference loads."""
    tree, jcfg, state, cfg = _models(kind)
    jgroups.initialize_mesh(force=True)
    jengine = jbuild_engine(tree, jcfg, _jconfig())
    want = np.asarray(jengine.put([0], [PROMPT]))[0]
    jengine.serialize(str(tmp_path / "jax"))
    if kind == "mixtral":
        with open(tmp_path / "jax" / "ds_model_config.json") as f:
            assert json.load(f)["config_class"] == "deepspeed_tpu.models.llama.LlamaConfig"
        with pytest.raises(ValueError, match="C25"):
            build_engine_from_ds_checkpoint(str(tmp_path / "jax"), _tconfig(), device="cpu")
    else:
        port = build_engine_from_ds_checkpoint(str(tmp_path / "jax"), _tconfig(), device="cpu")
        assert type(port.model.config) is type(cfg) and port.model.config == cfg
        loaded = dict(port.model._params.items())
        assert set(loaded) == set(state) and all(torch.equal(loaded[k], state[k]) for k in state)
        np.testing.assert_allclose(np.asarray(port.put([0], [PROMPT]))[0], want, **TOL)

    build_engine(state, cfg, _tconfig(), device="cpu").serialize(str(tmp_path / "port"))
    with open(tmp_path / "port" / "ds_model_config.json") as f:
        assert json.load(f)["config_class"] == f"{type(jcfg).__module__}.{type(jcfg).__qualname__}"
    again = build_engine_from_ds_checkpoint(str(tmp_path / "port"), _tconfig(), device="cpu")
    assert again.model.model_config == cfg
    np.testing.assert_allclose(np.asarray(again.put([0], [PROMPT]))[0], want, **TOL)
    jgroups.initialize_mesh(force=True)
    jagain = jbuild_from_ds(str(tmp_path / "port"), _jconfig())
    np.testing.assert_allclose(np.asarray(jagain.put([0], [PROMPT]))[0], want, **TOL)


def test_serialize_keeps_bf16_bit_for_bit(tmp_path):
    """bf16 goes to disk as a ``u2`` view with the logical dtype in the
    metadata, both ways."""
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    build_engine(params, cfg, _tconfig(), device="cpu").serialize(str(tmp_path))
    with open(tmp_path / "metadata_rank0.json") as f:
        assert {m["dtype"] for m in json.load(f)} == {"bfloat16"}
    with np.load(tmp_path / "params_rank0.npz") as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.uint16)}
    state, cfg2 = load_ds_checkpoint(str(tmp_path))
    assert cfg2 == cfg and all(state[k].dtype == torch.bfloat16 and torch.equal(state[k], params[k]) for k in params)
    jgroups.initialize_mesh(force=True)
    jtree = to_numpy_tree(jbuild_from_ds(str(tmp_path), _jconfig()).model._params)
    assert np.asarray(jtree["model"]["embed_tokens"]["embedding"]).dtype == jnp.bfloat16
    assert torch.equal(_torch(jtree["model"]["embed_tokens"]["embedding"]), params["embed_tokens.weight"])


def test_build_hf_engine_routes_and_refuses(hf_root, tmp_path):
    """An HF directory builds the engine ``build_engine`` builds on the
    loaded weights (the same logits); a serialize directory goes to the DS
    loader; a legacy pickle directory and an unknown config class are
    refused."""
    path = _hf_dir(hf_root, "llama", torch.float32, True, None)
    params, cfg = tckpt.load_hf_checkpoint(path)
    want = build_engine(params, cfg, _tconfig(), device="cpu").put([0], [PROMPT % 128])
    engine = build_hf_engine(path, _tconfig(), device="cpu")
    assert torch.equal(engine.put([0], [PROMPT % 128]), want)
    engine.serialize(str(tmp_path / "ds"))
    assert torch.equal(build_hf_engine(str(tmp_path / "ds"), _tconfig(), device="cpu").put([0], [PROMPT % 128]),
                       want)
    (tmp_path / "pkl").mkdir()
    (tmp_path / "pkl" / "ds_model_config.pkl").write_bytes(b"")
    with pytest.raises(ValueError, match="legacy pickle"):
        build_hf_engine(str(tmp_path / "pkl"), device="cpu")
    doc = json.loads((tmp_path / "ds" / "ds_model_config.json").read_text())
    doc["config_class"] = "os.path.Whatever"
    (tmp_path / "ds" / "ds_model_config.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="refusing config class"):
        build_hf_engine(str(tmp_path / "ds"), device="cpu")


def test_dstpu_replica_serves_a_checkpoint_over_http(hf_root, tmp_path):
    """``python -m deepspeed_tpu_torch.bin.dstpu_replica --checkpoint DIR
    --device cpu`` answers a request with the tokens of an in-process
    engine on the same directory."""
    path = _hf_dir(hf_root, "llama", torch.float32, True, None)
    port_file = str(tmp_path / "r.port")
    args = ["--checkpoint", path, "--num-blocks", "32", "--max-context", "128"]
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_replica", "--device", "cpu",
                             "--port-file", port_file] + args, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(port_file):
            assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read().decode()[-2000:]
            time.sleep(0.05)
        with open(port_file) as f:
            host, port = f.read().split()
        body = json.dumps({"prompt": [1, 2, 3, 4, 5, 6], "max_new_tokens": 6}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            served = json.loads(r.read())["tokens"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    from deepspeed_tpu_torch.bin import dstpu_replica
    engine = dstpu_replica.build_engine_from_args(dstpu_replica.parser().parse_args(["--device", "cpu"] + args))
    try:
        want = generate(engine, [[1, 2, 3, 4, 5, 6]], max_new_tokens=6)[0]
    finally:
        engine.close()
    assert served == [int(t) for t in want]
