"""HF checkpoint loading, and the safetensors format read and written by hand.

Port of ``deepspeed_tpu/inference/checkpoint.py``: ``load_hf_checkpoint``
reads an HF directory of a llama, mistral, qwen2 or mixtral model
(``config.json``, then ``*.safetensors`` shards, or ``pytorch_model*.bin``
through ``torch.load(weights_only=True)``) into ``(state_dict, config)`` of
``models/llama.py`` / ``models/mixtral.py``, in the checkpoint's dtype
(``torch_dtype``; bf16 when absent). HF's ``Linear.weight [out, in]`` is the
port's layout as it is; Mixtral's router is transposed to ``gate [M, E]``
and its experts stacked into the banks ``wi [E, M, 2F]`` (w1 | w3) and
``wo [E, F, M]``, as the reference stacks them. A tied model (no
``lm_head.weight``) unembeds with the embedding.

The machine with the card has neither ``safetensors`` nor ``transformers``,
so the format is read and written here: an 8-byte little-endian header
length, a JSON header of ``{name: {dtype, shape, data_offsets}}`` (and
``__metadata__``), then the raw bytes, which become tensors through
``torch.frombuffer`` (bf16 included, which numpy lacks). A sharded
checkpoint's ``model.safetensors.index.json`` names its files.
:func:`save_hf_checkpoint` writes a llama-family or Mixtral ``state_dict``
as an HF directory (``config.json`` and ``model.safetensors``).
"""

import json
import os
import struct
from typing import Dict, Iterator, Tuple

import torch

from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over one
    buffer of the file's bytes."""
    with open(path, "rb") as f:
        (n, ) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor], metadata: Dict[str, str] = None) -> None:
    """``tensors`` as one ``.safetensors`` file (in name order, the header
    padded with spaces to 8 bytes, as the reference library writes it)."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    if metadata:
        header["__metadata__"] = metadata
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(memoryview(raw) if len(raw) else b"")


def _iterate_hf_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every shard: the files a safetensors index
    names, else every ``.safetensors`` file, else every ``.bin``."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            st_files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for name in st_files:
            yield from read_safetensors(os.path.join(path, name)).items()
        return
    bin_files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no .safetensors or .bin weights under {path}")
    for name in bin_files:
        yield from torch.load(os.path.join(path, name), map_location="cpu", weights_only=True).items()


def _model_config_from_hf(cfg: dict):
    arch = (cfg.get("architectures") or [""])[0].lower()
    model_type = cfg.get("model_type", "").lower()
    common = dict(dtype=_TORCH_DTYPES.get(cfg.get("torch_dtype", "bfloat16"), torch.bfloat16),
                  vocab_size=cfg["vocab_size"],
                  hidden_size=cfg["hidden_size"],
                  intermediate_size=cfg["intermediate_size"],
                  num_hidden_layers=cfg["num_hidden_layers"],
                  num_attention_heads=cfg["num_attention_heads"],
                  num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
                  max_position_embeddings=cfg.get("max_position_embeddings", 4096),
                  rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
                  rope_theta=cfg.get("rope_theta", 1e4))
    if "mixtral" in model_type or "mixtral" in arch:
        return MixtralConfig(num_local_experts=cfg.get("num_local_experts", 8),
                             num_experts_per_tok=cfg.get("num_experts_per_tok", 2), **common)
    if model_type == "mistral" or "mistral" in arch:
        return LlamaConfig(model_type="mistral", sliding_window=cfg.get("sliding_window") or 0, **common)
    if model_type == "qwen2" or "qwen2" in arch:
        return LlamaConfig(model_type="qwen2", attention_bias=True, **common)
    if model_type == "llama" or "llama" in arch:
        return LlamaConfig(**common)
    raise ValueError(f"unsupported HF model_type: {model_type!r}")


def _map_hf_name(name: str):
    """HF tensor name → ``(state_dict name, transposed)``; an expert's
    ``("__expert__", layer, expert, w1|w2|w3)``; None to skip."""
    name = name.removeprefix("model.")
    if name in ("embed_tokens.weight", "norm.weight", "lm_head.weight"):
        return name, False
    if not name.startswith("layers."):
        return None
    _, li, *rest = name.split(".")
    if rest[0] in ("input_layernorm", "post_attention_layernorm", "self_attn", "mlp"):
        return name, False
    if rest[0] == "block_sparse_moe":
        if rest[1] == "gate":
            return f"layers.{li}.block_sparse_moe.gate", True
        return ("__expert__", li, int(rest[2]), rest[3]), True
    return None


def load_hf_checkpoint(path: str):
    """``(state_dict, model config)`` of an HF llama/mistral/qwen2/mixtral
    directory, on the CPU in the checkpoint's dtype (module doc)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = _model_config_from_hf(json.load(f))
    params: Dict[str, torch.Tensor] = {}
    experts: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}
    for name, t in _iterate_hf_tensors(path):
        mapped = _map_hf_name(name)
        if mapped is None:
            continue
        key, transposed = mapped
        t = t.to(cfg.dtype)
        if transposed and t.dim() == 2:
            t = t.t()
        if isinstance(key, tuple):
            _, li, e, w = key
            experts.setdefault((li, w), {})[e] = t
        else:
            params[key] = t.contiguous()
    if "lm_head.weight" not in params and "embed_tokens.weight" in params:
        params["lm_head.weight"] = params["embed_tokens.weight"]  # tied: unembed with the embedding
    n = getattr(cfg, "num_local_experts", 0)
    for li in sorted({li for li, _ in experts}, key=int):
        stack = lambda w: torch.stack([experts[(li, w)][e] for e in range(n)])
        params[f"layers.{li}.block_sparse_moe.experts.wi"] = torch.cat([stack("w1"), stack("w3")], dim=-1)
        params[f"layers.{li}.block_sparse_moe.experts.wo"] = stack("w2")
    return params, cfg


def save_hf_checkpoint(path: str, params, cfg) -> None:
    """Write a llama-family or Mixtral ``state_dict`` as an HF directory
    (``config.json`` and ``model.safetensors``) that :func:`load_hf_checkpoint`
    reads back bit for bit."""
    os.makedirs(path, exist_ok=True)
    tensors = {}
    for name, t in params.items():
        if name.endswith("block_sparse_moe.gate"):
            tensors[f"model.{name}.weight"] = t.t()
        elif name.endswith("block_sparse_moe.experts.wi"):
            F = t.shape[-1] // 2
            pre = "model." + name.removesuffix("experts.wi")
            for e in range(t.shape[0]):
                tensors[f"{pre}experts.{e}.w1.weight"] = t[e, :, :F].t()
                tensors[f"{pre}experts.{e}.w3.weight"] = t[e, :, F:].t()
        elif name.endswith("block_sparse_moe.experts.wo"):
            pre = "model." + name.removesuffix("experts.wo")
            for e in range(t.shape[0]):
                tensors[f"{pre}experts.{e}.w2.weight"] = t[e].t()
        else:
            tensors[name if name == "lm_head.weight" else f"model.{name}"] = t
    write_safetensors(os.path.join(path, "model.safetensors"), tensors, {"format": "pt"})
    mixtral = isinstance(cfg, MixtralConfig)
    model_type = "mixtral" if mixtral else cfg.model_type
    doc = dict(architectures=[{"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
                               "qwen2": "Qwen2ForCausalLM", "mixtral": "MixtralForCausalLM"}[model_type]],
               model_type=model_type, torch_dtype=str(cfg.dtype).removeprefix("torch."),
               vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
               num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
               num_key_value_heads=cfg.num_key_value_heads, max_position_embeddings=cfg.max_position_embeddings,
               rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, tie_word_embeddings=False)
    if mixtral:
        doc.update(num_local_experts=cfg.num_local_experts, num_experts_per_tok=cfg.num_experts_per_tok)
    elif cfg.model_type == "mistral":
        doc["sliding_window"] = cfg.sliding_window or None
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(doc, f, indent=2)
