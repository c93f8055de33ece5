"""The gang on the port: checkpoints across world sizes, the launcher, the
multi-node runners and the gang's liveness documents.

A save at world 2 loads bit for bit at world 1 and grows back (the contract
of the reference's ``tests/unit/runtime/test_cross_world_checkpoint.py``),
over a gloo gang built once for the module (``tests/torch_gang.py``); a
save at world 1 loads at world 2 under every stage. The launcher spawns one
child a slot with the environment contract; the runners only render
commands (no ssh is opened).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.elasticity import DSElasticAgent
from deepspeed_tpu_torch.elasticity.gang import GangHeartbeat, read_heartbeats
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params
from tests import torch_gang_scenarios as sc
from tests.torch_gang import Gang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- across world sizes --
@pytest.fixture(scope="module")
def gang2():
    g = Gang(2)
    yield g
    g.close()


def _cfg_fields():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}, cfg


def _state(cfg):
    return {k: v.numpy() for k, v in init_params(cfg, torch.Generator().manual_seed(0), device="cpu").items()}


def _batches(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, cfg.vocab_size, size=(8, 17))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _ds(stage):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 0.01}},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}


@pytest.mark.parametrize("stage", [1, 3])
def test_save_world2_load_world1_bitwise_and_grow_back(gang2, tmp_path, stage):
    """Saved at world 2 (each rank its chunks, rank 0 also the whole
    tensors, then each its seal; rank 0 the manifest last), loaded at world 1: the masters and the optimizer state
    are the gathered world-2 ones bit for bit, and two independent resumes
    agree bit for bit. The world-1 continuation's tag then loads back at
    world 2: each rank holds exactly its chunk, and training goes on."""
    fields, cfg = _cfg_fields()
    state, batches = _state(cfg), _batches(cfg, 6)
    ckdir = tmp_path / "ck"
    saved = gang2.run(sc.save_after_training, fields, state, _ds(stage), batches[:2], str(ckdir))[0]
    assert (ckdir / "global_step2" / "MANIFEST.json").exists()
    assert sorted(os.listdir(ckdir / "global_step2" / ".seals")) == ["rank0.sealed", "rank1.sealed"]
    # rank 1 writes only its chunks; rank 0 also writes the whole tensors, once
    files = {r: {n: torch.load(ckdir / "global_step2" / "state" / f"rank{r}" / f"{n}.pt", weights_only=True)
                 for n in ("params", "opt_state")} for r in (0, 1)}
    assert set(files[1]["params"]) == (set(files[0]["params"]) if stage == 3 else set())
    assert set(files[1]["opt_state"]) < set(files[0]["opt_state"])  # the step count is whole
    for n, t in files[1]["opt_state"].items():
        assert t.numel() * 2 == saved["exp_avg"][n.split("/", 1)[1]].size
    copy = tmp_path / "ck_b"
    shutil.copytree(ckdir, copy)
    a = sc.load_and_report(fields, state, _ds(stage), str(ckdir), batches[2:4], save_dir=str(ckdir))
    b = sc.load_and_report(fields, state, _ds(stage), str(copy), batches[2:4])
    assert a["steps"] == 2
    for k in saved["full"]:
        assert np.array_equal(a["full"][k], saved["full"][k])
        assert np.array_equal(a["exp_avg"][k], saved["exp_avg"][k])
        assert np.array_equal(a["after"][k], b["after"][k])
    assert a["losses"] == b["losses"]
    grown = gang2.run(sc.load_and_report, fields, state, _ds(stage), str(ckdir), batches[4:6])
    for r in grown:
        assert r["steps"] == 4 and r["path"].endswith("global_step4")
        for k, full in a["after"].items():
            dim = r["param_dim"][k]
            want = full if dim is None else np.split(full, 2, axis=dim)[r["rank"]]
            assert np.array_equal(r["local"][k], want)
    assert grown[0]["losses"] == grown[1]["losses"] and len(grown[0]["losses"]) == 2


def test_world1_save_loads_at_world2_for_every_stage(gang2, tmp_path):
    """A save at world 1 (the single-process layout) loads at world 2 under
    stages 0-3: each rank's masters are its chunk of the saved ones, bit
    for bit."""
    fields, cfg = _cfg_fields()
    state, batches = _state(cfg), _batches(cfg, 1)
    saved = sc.save_after_training(fields, state, _ds(2), batches, str(tmp_path / "ck"))
    for stage in (0, 1, 2, 3):
        for r in gang2.run(sc.load_and_report, fields, state, _ds(stage), str(tmp_path / "ck")):
            for k, full in saved["full"].items():
                assert np.array_equal(r["full"][k], full)
                dim = r["param_dim"][k]
                want = full if dim is None else np.split(full, 2, axis=dim)[r["rank"]]
                assert np.array_equal(r["local"][k], want)


# ------------------------------------------------------ launcher and the CLI --
ENV_DUMP = r"""
import json, os, sys
keys = ["DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID", "DSTPU_JOB_ID", "RANK", "LOCAL_RANK",
        "WORLD_SIZE", "LOCAL_SIZE", "MASTER_ADDR", "MASTER_PORT"]
with open(os.path.join(sys.argv[1], f"env{os.environ['RANK']}.json"), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
"""


def test_launch_exports_the_contract_to_one_child_a_slot(tmp_path):
    from deepspeed_tpu_torch.launcher.launch import decode_world_info, encode_world_info
    script = tmp_path / "dump.py"
    script.write_text(ENV_DUMP)
    info = encode_world_info({"localhost": [0, 1]})
    assert decode_world_info(info) == {"localhost": [0, 1]}
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch", "--world_info", info,
                        "--master_port", "29611", str(script), str(tmp_path)], env=env, cwd=REPO, timeout=120,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    docs = [json.loads((tmp_path / f"env{i}.json").read_text()) for i in range(2)]
    for i, d in enumerate(docs):
        assert d["DSTPU_PROCESS_ID"] == d["RANK"] == d["LOCAL_RANK"] == str(i)
        assert d["DSTPU_NUM_PROCESSES"] == d["WORLD_SIZE"] == d["LOCAL_SIZE"] == "2"
        assert d["DSTPU_COORDINATOR"] == "127.0.0.1:29611" and d["MASTER_PORT"] == "29611"
    assert docs[0]["DSTPU_JOB_ID"] == docs[1]["DSTPU_JOB_ID"]


def test_runners_build_commands_without_a_cluster(tmp_path):
    """The multi-node runners only render commands (no ssh is opened)."""
    import argparse
    from deepspeed_tpu_torch.launcher.multinode_runner import LocalRunner, PDSHRunner, SlurmRunner, SSHRunner
    from deepspeed_tpu_torch.launcher.runner import _world_info, fetch_hostfile, parse_resource_filter
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("worker-0 slots=2\nworker-1 slots=2\n")
    pool = fetch_hostfile(str(hostfile))
    active = parse_resource_filter(pool, include_str="worker-0:1@worker-1")
    assert active == {"worker-0": [1], "worker-1": [0, 1]}
    world = _world_info(active)
    assert world == {"worker-0": [0], "worker-1": [1, 2]}
    args = argparse.Namespace(user_script="train.py", user_args=["--x", "1"], master_addr="worker-0",
                              master_port=29500, module=False, no_python=False, slurm_comment="")
    env = {"PYTHONPATH": "/src", "NCCL_DEBUG": "INFO", "UNRELATED": "x"}
    pdsh = PDSHRunner(args, world).get_cmd(env, active)
    assert pdsh[:6] == ["pdsh", "-S", "-f", "1024", "-w", "worker-0,worker-1"]
    assert "deepspeed_tpu_torch.launcher.launch" in pdsh and "export NCCL_DEBUG=INFO;" in pdsh
    assert not any("UNRELATED" in a for a in pdsh)
    ssh = SSHRunner(args, world).get_cmd(env, active)
    assert len(ssh) == 2 and ssh[0][:4] == ["ssh", "-o", "StrictHostKeyChecking=no", "worker-0"]
    srun = SlurmRunner(args, world).get_cmd(env, active)
    assert srun[:5] == ["srun", "--nodes", "2", "--ntasks-per-node", "1"] and "$SLURM_NODEID" in srun[-1]
    local = LocalRunner(args, {"localhost": [0, 1]}).get_cmd(env, active)
    assert local[2:4] == ["-m", "deepspeed_tpu_torch.launcher.launch"] and local[-3:] == ["train.py", "--x", "1"]


def test_heartbeats_and_gang_state_documents(tmp_path):
    gang_dir = tmp_path / "gang"
    GangHeartbeat(str(gang_dir), 0).beat(step=5, phase="step")
    GangHeartbeat(str(gang_dir), 1).beat(step=4, phase="save")
    beats = read_heartbeats(str(gang_dir))
    assert beats[0]["step"] == 5 and beats[1]["phase"] == "save" and beats[0]["age_s"] >= 0
    from deepspeed_tpu_torch.elasticity import read_gang_state as read_state, write_gang_state
    write_gang_state(str(gang_dir), {"phase": "running", "world": 2})
    doc = read_state(str(gang_dir))
    assert doc["world"] == 2 and "updated_unix" in doc
    agent = DSElasticAgent(["true"], num_processes=4, ds_config={
        "elasticity": {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 4, "version": 0.1}})
    valid = agent.valid_world_sizes()
    assert valid and max(valid) <= 4 and agent.next_world_size(3) == max(n for n in valid if n <= 3)


def test_dstpu_elastic_prints_the_reference_batch_math(tmp_path, capsys):
    """``python -m deepspeed_tpu_torch.bin.dstpu_elastic``: the final batch
    size, the valid world sizes and the micro-batch, as the JAX package's
    ``compute_elastic_config`` computes them."""
    from deepspeed_tpu.elasticity import compute_elastic_config as jcompute
    from deepspeed_tpu_torch.bin import dstpu_elastic
    cfg = {"elasticity": {"enabled": True, "max_train_batch_size": 2000, "micro_batch_sizes": [2, 4, 6],
                          "min_gpus": 1, "max_gpus": 10000, "version": 0.1}}
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(cfg))
    assert dstpu_elastic.main(["-c", str(path), "-w", "8"]) == 0
    out = capsys.readouterr().out
    batch, valid, micro = jcompute(cfg, world_size=8, return_microbatch=True)
    assert f"final_batch_size .... {batch}" in out and f"valid_chips ......... {valid}" in out
    assert f"micro_batch_size .... {micro}" in out
    assert dstpu_elastic.main(["-c", str(path)]) == 0
    assert f"final_batch_size .... {batch}" in capsys.readouterr().out
