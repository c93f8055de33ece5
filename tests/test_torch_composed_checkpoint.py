"""Port parity for checkpoints of tensor-parallel, sequence-parallel and
expert-parallel shards (``runtime/checkpoint_engine``, the engine's
``_gather_entry``/``_localize_entry``): a tag saved across such ranks holds
every array in its global layout, as a world-1 tag does, and loads at
another mesh or at world 1 bit for bit. One gloo gang of 4 ranks
(``tests/torch_gang.py``) runs every scenario of the file
(``tests/torch_composed_scenarios.py``); the world-1 engines run in the test
process.

The reference side is the JAX package's own case,
``tests/unit/checkpoint/test_universal.py::test_moe_cross_mesh_reshard``:
a tiny Mixtral at ZeRO 2 saved on (data 2, expert 2) and restored on
(data 2, seq 2, model 2) there, every leaf bit for bit, the step count
kept, and one more step finite. The port's gang has 4 ranks, so it restores
on (seq 2, model 2). f32; the gates' noise is off (C16).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu_torch.models.convert import mixtral_from_flax
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import MANIFEST_FILE
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint
from tests import torch_composed_scenarios as sc
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params, to_numpy_tree

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def gang():
    g = Gang(4, timeout=300.0)
    yield g
    g.close()


def _ds_config(stage, **axes):
    return dict({"train_batch_size": 8, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
                 "zero_optimization": {"stage": stage}}, **axes)


def _batches(vocab, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(8, 17))
        out.append((ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)))
    return out


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("dtype",
                                                                                             "sequence_parallel")}


def _assert_same_state(got, want):
    for tree in want:
        assert set(got[tree]) == set(want[tree]), tree
        for key in want[tree]:
            np.testing.assert_array_equal(got[tree][key], want[tree][key], err_msg=f"{tree}/{key}")


def _manifest_arrays(path):
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        return json.load(f)["arrays"]


def test_moe_cross_mesh_reshard(gang, tmp_path):
    """The reference's case at four ranks: a tiny Mixtral trained 3 steps at
    ZeRO 2 on (data 2, expert 2), each rank holding 2 of the 4 experts,
    saved; restored on (seq 2, model 2), where every rank holds every
    expert and half the heads: every leaf of the masters and the optimizer
    state bit for bit, ``global_steps`` kept, one more step finite. The tag
    holds the global layout (one file a tree, no rank files), and a world-1
    engine restores it bit for bit too."""
    jcfg = jmixtral.MixtralConfig.tiny(dtype=jnp.float32)
    _, jparams = jmixtral.init_params(jcfg)
    cfg = MixtralConfig.tiny(dtype=torch.float32)
    fields = _fields(cfg)
    state = {k: v.numpy() for k, v in mixtral_from_flax(to_numpy_tree(jparams), cfg).items()}
    batches = _batches(cfg.vocab_size, 4, seed=0)
    save = str(tmp_path)
    saved = gang.run(sc.train, "mixtral", fields, state, _ds_config(2, expert_parallel_size=2), batches[:3], False,
                     save, "cross")
    for r in saved[1:]:
        _assert_same_state(r["state"], saved[0]["state"])
    assert sorted(os.listdir(os.path.join(save, "cross", "state"))) == ["opt_state.pt", "params.pt",
                                                                       "scale_state.pt"]
    restored = gang.run(sc.resume, "mixtral", fields, state, _ds_config(2, sequence_parallel_size=2,
                                                                         tensor_parallel_size=2), save, "cross",
                        batches[3])
    for r in restored:
        _assert_same_state(r["state"], saved[0]["state"])
        assert r["steps"] == saved[0]["steps"] == 3
        assert np.isfinite(r["loss"])
    one = sc.resume("mixtral", fields, state, _ds_config(2), save, "cross", batches[3])
    _assert_same_state(one["state"], saved[0]["state"])
    np.testing.assert_allclose(restored[0]["loss"], one["loss"], **LOSS_TOL)


def test_tp_tag_loads_at_world_1_bitwise(gang, tmp_path):
    """A tiny Llama trained 2 steps at tensor 2 x data 2 (ZeRO 1) and
    saved: a world-1 engine restores every array bit for bit and its next
    step's loss is the gang's next step's; the world-1 engine's own save of
    the restored state has the same per-array CRC32s in its manifest as
    the gang's tag, and ``zero_to_fp32`` gives the same f32 state dict
    from both tags, equal to the gang's gathered masters."""
    jcfg = jax_tiny(num_key_value_heads=2)
    pcfg = port_config(jcfg)
    fields = _fields(pcfg)
    state = {k: v.numpy() for k, v in port_params(jcfg, jax_params(jcfg)).items()}
    batches = _batches(pcfg.vocab_size, 3, seed=5)
    save = str(tmp_path)
    tp = _ds_config(1, tensor_parallel_size=2)
    saved = gang.run(sc.train, "llama", fields, state, tp, batches[:2], False, save, "tp")
    assert saved[0]["shapes"]["layers.0.self_attn.q_proj.weight"] == (32, 64)
    nxt = gang.run(sc.resume, "llama", fields, state, tp, save, "tp", batches[2])
    one = sc.resume("llama", fields, state, _ds_config(1), save, "tp", batches[2])
    _assert_same_state(one["state"], saved[0]["state"])
    assert one["steps"] == 2
    for r in nxt:
        np.testing.assert_allclose(r["loss"], one["loss"], **LOSS_TOL)

    # the world-1 engine saves the restored state as it loaded it
    w1 = sc.training_engine("llama", fields, state, _ds_config(1))
    w1.load_checkpoint(save, tag="tp")
    w1.save_checkpoint(save, tag="world1")
    w1.destroy()
    got, want = _manifest_arrays(os.path.join(save, "tp")), _manifest_arrays(os.path.join(save, "world1"))
    assert got == want and len(got) == sum(len(t) for t in saved[0]["state"].values())
    sd_tp = get_fp32_state_dict_from_zero_checkpoint(save, tag="tp")
    sd_w1 = get_fp32_state_dict_from_zero_checkpoint(save, tag="world1")
    assert set(sd_tp) == set(sd_w1) == set(saved[0]["full"])
    for name, arr in sd_tp.items():
        np.testing.assert_array_equal(arr, sd_w1[name])
        np.testing.assert_array_equal(arr, saved[0]["full"][name])
