"""Port parity for the checkpoints of pipeline stages and of hpZ / MiCS
partitions, over one gloo gang of 4 ranks (``tests/torch_gang.py``) that
runs every scenario of the file (``tests/torch_pipe_scenarios.py``,
``tests/torch_composed_scenarios.py``).

Both kinds save in the global layout, every array whole (a tied layer and
a chunk that repeats across replica groups once), so a tag loads bitwise
on another mesh and at world 1:

- a pipeline tag of (pipe 2, data 2) at ZeRO 2 loads into a one-stage
  engine at world 1 and back at (pipe 2, model 2), masters, moments and
  loss scale bitwise, and the steps kept; its arrays, stacked as the
  reference's ``PipelineEngine`` stacks its layers
  (``models/convert.pipeline_params_to_flax``), hold that engine's own
  per-array CRC32s of a save of the same state (the tag's, after 2 steps,
  given to that engine);
- an hpZ tag (hpZ 2 x tensor 2, ZeRO 3) and a MiCS tag (MiCS 2 x data 2,
  ZeRO 2) of a tiny Llama load at world 1 bitwise, and each at the other's
  mesh;
- ``utils/zero_to_fp32`` gives from each tag the state dict it gives from
  a world-1 tag of the same state.
"""

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.checkpoint_engine.engine import read_manifest as jread_manifest
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import read_state, tensor_crc32
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint
from tests import torch_composed_scenarios as csc
from tests import torch_gang_scenarios as gsc
from tests import torch_pipe_scenarios as sc
from tests.test_torch_composed_train import _batches as _token_batches
from tests.test_torch_composed_train import _ds_config, _fields
from tests.test_torch_pipe_composed import HIDDEN, _batches, _cfg, _reference_pipeline_engine
from tests.torch_gang import Gang
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params


@pytest.fixture(scope="module")
def gang():
    g = Gang(4, timeout=300.0)
    yield g
    g.close()


def _union(a, b):
    return {tree: {**a[tree], **b[tree]} for tree in a}


def _assert_states_equal(got, want):
    for tree in ("params", "opt_state", "scale_state"):
        assert set(got[tree]) == set(want[tree]), tree
        for k in want[tree]:
            np.testing.assert_array_equal(got[tree][k], want[tree][k], err_msg=f"{tree}/{k}")


def _world1(build, load_dir, tag, save_dir):
    """``build()``'s engine at world 1 (in this process): the tag loaded,
    its whole state and steps, then saved again as a world-1 tag."""
    groups.destroy_mesh()
    engine = build()
    try:
        engine.load_checkpoint(load_dir, tag=tag)
        out = dict(state=csc.whole_state(engine), steps=engine.global_steps, scale=engine.loss_scale)
        engine.save_checkpoint(save_dir, tag="world1")
    finally:
        engine.destroy()
        groups.destroy_mesh()
    return out


def _fp32_equal(a_dir, a_tag, b_dir, b_tag):
    a = get_fp32_state_dict_from_zero_checkpoint(str(a_dir), a_tag)
    b = get_fp32_state_dict_from_zero_checkpoint(str(b_dir), b_tag)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------ pipeline --
@pytest.fixture(scope="module")
def pipe_tags(gang, tmp_path_factory):
    """The port's gang at (pipe 2, data 2), ZeRO 2, from the reference's
    (pipe 2, data 2) PipelineEngine's initial weights: a tag after the
    steps; then that engine given the tag's state (its arrays stacked as
    the reference stacks its layers, its step counts) and saved, and the
    manifest of that save."""
    root = tmp_path_factory.mktemp("pipe_ckpt")
    module = gsc.pipeline_module("mlp", 2, HIDDEN)
    jgroups.initialize_mesh(pipe_parallel_size=2, devices=jax.devices()[:4], force=True)
    try:
        engine = _reference_pipeline_engine(2)
        p0 = jax.tree.map(np.asarray, jax.device_get(engine.params))
        state = {k: v.numpy() for k, v in convert.pipeline_params_from_flax(p0, module).items()}
        res = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(2), _batches(), None, str(root / "port"))
        trees = _stacked_trees(read_state(str(root / "port" / "trained")), module)
        put = lambda old, new: jax.device_put(np.asarray(new, dtype=old.dtype), old.sharding)
        engine.params = jax.tree.map(put, engine.params, trees["params"])
        opt = engine.opt_state
        engine.opt_state = opt._replace(step=put(opt.step, trees["step"]),
                                        **{m: jax.tree.map(put, getattr(opt, m), trees[m])
                                           for m in ("exp_avg", "exp_avg_sq")})
        engine.global_steps = res[0]["steps"]
        engine.save_checkpoint(str(root / "jax"), tag="trained")
        manifest = jread_manifest(str(root / "jax" / "trained"))
    finally:
        jgroups.destroy_mesh()
    return root, state, manifest, res


def _stacked_trees(saved, module):
    """A port pipeline tag's masters and moments as the reference's
    {pre, stack, post} trees, and the optimizer's step."""
    trees = {"params": convert.pipeline_params_to_flax(saved["params"], module),
             "step": saved["opt_state"]["step"].numpy()}
    for moment in ("exp_avg", "exp_avg_sq"):
        flat = {k.partition("/")[2]: t for k, t in saved["opt_state"].items() if k.startswith(moment + "/")}
        trees[moment] = convert.pipeline_params_to_flax(flat, module)
    return trees


def test_pipeline_tag_holds_the_reference_pipeline_crcs(pipe_tags):
    """The port's tag after 2 steps, its stages' files merged and the
    stack's layers stacked as the reference stacks them: every parameter
    and moment array (none of them zero, the two moments unequal) has the
    CRC32 that the reference PipelineEngine's manifest gives the same leaf
    of a save of that state (a Dense kernel through the port's CRC of the
    transposed tensor, which the converter takes), and so has the
    optimizer's step."""
    root, _, manifest, res = pipe_tags
    module = gsc.pipeline_module("mlp", 2, HIDDEN)
    trees = _stacked_trees(read_state(str(root / "port" / "trained")), module)
    ref = manifest["arrays"]
    assert manifest["global_steps"] == res[0]["steps"] == 2
    assert tensor_crc32(torch.from_numpy(trees["step"])) == ref["['opt_state']['step']"]["crc32"]
    checked = 0
    for tree in ("params", "exp_avg", "exp_avg_sq"):
        prefix = ("params", ) if tree == "params" else ("opt_state", tree)
        for path, leaf in jtu.tree_flatten_with_path(trees[tree])[0]:
            key = "".join(f"[{p!r}]" for p in prefix) + jtu.keystr(path)
            assert np.any(leaf != 0), key
            assert tensor_crc32(torch.from_numpy(np.ascontiguousarray(leaf))) == ref[key]["crc32"], key
            checked += 1
    assert checked == 3 * len(jax.tree.leaves(trees["params"]))
    assert all(ref[k.replace("exp_avg_sq", "exp_avg")] != ref[k] for k in ref if "exp_avg_sq" in k)


def test_pipeline_tag_loads_at_one_stage_and_at_another_mesh(gang, pipe_tags, tmp_path):
    """The (pipe 2, data 2) tag after 2 steps: a one-stage engine at world 1
    takes every entry (masters, moments, the loss scale) bitwise and the
    step count; a (pipe 2, model 2) gang takes its stages' entries bitwise;
    ``zero_to_fp32`` of the tag equals that of the world-1 engine's save."""
    root, state, _, res = pipe_tags
    want = _union(res[0]["state"], res[2]["state"])
    one = _world1(lambda: sc.pipe_engine("mlp", 1, HIDDEN, state, _cfg(2)), str(root / "port"), "trained", tmp_path)
    _assert_states_equal(one["state"], want)
    assert one["steps"] == res[0]["steps"] == 2
    back = gang.run(sc.pipe_train, "mlp", 2, HIDDEN, state, _cfg(2, tensor_parallel_size=2), [], None, None,
                    (str(root / "port"), "trained"))
    _assert_states_equal(_union(back[0]["loaded"], back[2]["loaded"]), want)
    assert all(r["loaded_steps"] == 2 and r["loaded_scale"] == one["scale"] for r in back)
    _fp32_equal(root / "port", "trained", tmp_path, "world1")


# ---------------------------------------------------------------- hpZ / MiCS --
def _zero(stage, **knobs):
    axes = {k: knobs.pop(k) for k in ("tensor_parallel_size", "sequence_parallel_size") if k in knobs}
    cfg = _ds_config(stage, **axes)
    cfg["zero_optimization"].update(knobs)
    return cfg


SECONDARY = {
    "hpz2xtp2_zero3": _zero(3, tensor_parallel_size=2, zero_hpz_partition_size=2),
    "mics2xdp2_zero2": _zero(2, mics_shard_size=2),
}


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_tiny(num_key_value_heads=2)
    jparams = jax_params(jcfg)
    pcfg = port_config(jcfg)
    return _fields(pcfg), {k: v.numpy() for k, v in port_params(jcfg, jparams).items()}, _token_batches(jcfg.vocab_size)


@pytest.mark.parametrize("case", list(SECONDARY))
def test_secondary_partition_tag_loads_at_world_1_and_at_the_other_mesh(gang, llama, case, tmp_path):
    """An hpZ or MiCS tag after 2 steps: a world-1 engine takes every entry
    bitwise, the other secondary mesh's gang too (hpZ's tag at MiCS,
    MiCS's at hpZ x TP), and ``zero_to_fp32`` of the tag equals that of
    the world-1 engine's save."""
    fields, state, batches = llama
    saved = gang.run(csc.train, "llama", fields, state, SECONDARY[case], batches, False, str(tmp_path), case)
    want = saved[0]["state"]
    for r in saved:
        _assert_states_equal(r["state"], want)
    one = _world1(lambda: csc.training_engine("llama", fields, state, _ds_config(1)), str(tmp_path), case,
                  tmp_path / "one")
    _assert_states_equal(one["state"], want)
    assert one["steps"] == saved[0]["steps"]
    other = next(c for c in SECONDARY if c != case)
    res = gang.run(csc.resume, "llama", fields, state, SECONDARY[other], str(tmp_path), case, batches[0])
    for r in res:
        _assert_states_equal(r["state"], want)
        assert r["steps"] == saved[0]["steps"]
    _fp32_equal(tmp_path, case, tmp_path / "one", "world1")
