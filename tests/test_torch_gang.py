"""The gang on the port under the elastic agent: the rank-scoped fault
points, ``DSElasticAgent`` and ``dstpu_train``
(``tests/test_torch_gang_checkpoint.py`` holds checkpoints across world
sizes, the launcher and the heartbeat documents).

- The fault cases make the reference's own assertions
  (``tests/unit/aux/test_gang_fault_tolerance.py``) on real process gangs
  of the port under ``DSElasticAgent``: a rank SIGKILLed at a step is torn
  down, relaunched and shrunk, and the resumed run ends bitwise where an
  uninterrupted run from the same checkpoint ends; a hung rank is found by
  its stale heartbeat; a rank that dies mid-save leaves a torn tag that the
  resume skips loudly. The JAX gangs are not launched again here (the
  reference's own tests run them).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from deepspeed_tpu_torch.elasticity import DSElasticAgent, ElasticAgentError
from deepspeed_tpu_torch.elasticity.gang import read_gang_state
from deepspeed_tpu_torch.runtime.faults import TrainFaultConfig, TrainFaultInjector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The training program of a gang rank: data a pure function of the global
# step, one checkpoint a step, resume from the newest good tag at start (the
# reference harness's program, on the port's tiny Llama). A relaunched life
# takes the next coordinator port, so it never races a dying one's socket.
GANG_SCRIPT = r"""
import json, os
nproc = int(os.environ.get("DSTPU_NUM_PROCESSES", "1") or 1)
if nproc > 1:
    base = int(os.environ["DSTPU_PORT_BASE"])
    life = int(os.environ.get("DSTPU_ELASTIC_RESTART", "0") or 0)
    os.environ["DSTPU_COORDINATOR"] = f"127.0.0.1:{base + life}"
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params

comm.init_distributed(dist_backend="gloo", verbose=False)
cfg = LlamaConfig.tiny(dtype=torch.float32)


def batch_for_step(step):
    rng = np.random.default_rng(1000 + step)
    ids = rng.integers(0, cfg.vocab_size, size=(8, 17))
    return ids[:, :-1], ids[:, 1:]


config = {"train_batch_size": 8, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "AdamW", "params": {"lr": 0.01}},
          "zero_optimization": {"stage": int(os.environ.get("DSTPU_GANG_STAGE", "3")),
                                "stage3_param_persistence_threshold": 0},
          "checkpoint": {"verify_arrays_on_load": True, "gang_seal_timeout_s": 20.0}}
engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(cfg), config=config, device="cpu",
                                                 model_parameters=init_params(cfg, torch.Generator().manual_seed(0),
                                                                              device="cpu"))
ckdir = os.environ["DSTPU_GANG_CKPT"]
path, _ = engine.load_checkpoint(ckdir)
print(f"GANG life={os.environ.get('DSTPU_RESTART_COUNT', '0')} world={comm.get_world_size()} "
      f"resumed_step={engine.global_steps} from={'fresh' if path is None else path}", flush=True)
total = int(os.environ.get("DSTPU_TOTAL_STEPS", "6"))
loss = None
while engine.global_steps < total:
    loss = engine.train_batch(batch=batch_for_step(engine.global_steps))
    engine.save_checkpoint(ckdir)
full = engine.full_params()
if comm.get_rank() == 0 and os.environ.get("DSTPU_GANG_MARKER"):
    with open(os.environ["DSTPU_GANG_MARKER"], "w") as f:
        json.dump({"world": comm.get_world_size(), "final_step": engine.global_steps,
                   "loss": None if loss is None else f"{float(loss):.17g}"}, f)
out = os.environ.get("DSTPU_FINAL_PARAMS")
if out and comm.get_rank() == 0:
    np.savez(out, **{k: v.numpy() for k, v in full.items()})
engine.destroy()
print("GANG done", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _script(tmp_path):
    path = tmp_path / "gang_train.py"
    path.write_text(GANG_SCRIPT)
    return str(path)


def _env(ckpt_dir, total_steps, **extra):
    env = os.environ.copy()
    for k in ("DSTPU_TRAIN_FAULTS", "DSTPU_GANG_DIR", "DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES",
              "DSTPU_PROCESS_ID", "DSTPU_RESTART_COUNT", "DSTPU_ELASTIC_RESTART"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OPENBLAS_NUM_THREADS"] = "1"  # one BLAS thread a rank: the test workers share the cores
    env["DSTPU_PORT_BASE"] = str(_free_port())
    env["DSTPU_GANG_CKPT"] = str(ckpt_dir)
    env["DSTPU_TOTAL_STEPS"] = str(total_steps)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _agent(script, env, tmp_path, **kw):
    kw.setdefault("num_processes", 2)
    kw.setdefault("monitor_interval", 0.1)
    kw.setdefault("term_grace_s", 2.0)
    kw.setdefault("gang_dir", str(tmp_path / "gang"))
    return DSElasticAgent([sys.executable, script], env=env, **kw)


def _marker(path):
    with open(path) as f:
        return json.load(f)


def _npz_equal(a, b):
    a, b = np.load(a), np.load(b)
    return sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)


def _run_world1(script, env, timeout=240):
    env = dict(env, DSTPU_NUM_PROCESSES="1", DSTPU_PROCESS_ID="0")
    r = subprocess.run([sys.executable, script], env=env, timeout=timeout, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


# ------------------------------------------------------ the agent's faults --
def test_kill_rank_shrinks_and_resumes_bitwise(tmp_path):
    """Rank 1 SIGKILLed after step 3, every life. Life 0 (world 2) crashes
    and is relaunched at the same world; life 1 crashes the same way, the
    crash budget is spent and the world shrinks to 1; life 2 never fires the
    rank-1 kill and completes. The final loss and masters equal, bit for
    bit, an uninterrupted world-1 run resumed from the same last sealed
    checkpoint."""
    script = _script(tmp_path)
    ckdir, marker, params = tmp_path / "ck", tmp_path / "marker.json", tmp_path / "params.npz"
    env = _env(ckdir, 6, DSTPU_GANG_MARKER=marker, DSTPU_FINAL_PARAMS=params)
    env["DSTPU_TRAIN_FAULTS"] = json.dumps({"enabled": True, "kill_rank_at_steps": [3], "kill_rank": 1,
                                            "only_first_life": False})
    agent = _agent(script, env, tmp_path, max_restarts=4, max_crashes=2, crash_window_s=600.0)
    assert agent.run() == 0
    assert agent.restart_count == 2, "one same-world retry, then the shrink"
    assert agent.world == 1
    assert agent.last_shrink and agent.last_shrink["from"] == 2 and agent.last_shrink["to"] == 1
    doc = _marker(marker)
    assert doc["world"] == 1 and doc["final_step"] == 6 and doc["loss"] is not None
    kinds = [ev["kind"] for ev in read_gang_state(agent.gang_dir)["events"]]
    assert kinds.count("crash") == 2 and "shrink" in kinds and kinds[-1] == "done"

    # the uninterrupted run at the resumed configuration, from the same last
    # sealed checkpoint (global_step2: the step-3 kill fires in train_batch,
    # before the save of step 3)
    ctrl = tmp_path / "ctrl_ck"
    ctrl.mkdir()
    shutil.copytree(ckdir / "global_step2", ctrl / "global_step2")
    (ctrl / "latest").write_text("global_step2")
    ctrl_marker, ctrl_params = tmp_path / "ctrl_marker.json", tmp_path / "ctrl_params.npz"
    r = _run_world1(script, _env(ctrl, 6, DSTPU_GANG_MARKER=ctrl_marker, DSTPU_FINAL_PARAMS=ctrl_params))
    assert "resumed_step=2" in r.stdout
    assert _marker(ctrl_marker)["loss"] == doc["loss"], "the resumed final loss must equal the uninterrupted one"
    assert _npz_equal(params, ctrl_params), "the resumed final masters must equal the uninterrupted ones"


def test_hung_rank_is_found_by_its_heartbeat_and_recovered(tmp_path):
    """Rank 1 sleeps inside step 2 (a wedged collective's shape): its
    process stays alive and rank 0 blocks in the next collective, so only
    the heartbeat watchdog sees it. It is found within the staleness
    deadline (not the 300 s sleep), the gang is torn down, and the relaunch
    (the hang suppressed on a restarted life) completes at the same world."""
    script = _script(tmp_path)
    ckdir, marker = tmp_path / "ck", tmp_path / "marker.json"
    env = _env(ckdir, 4, DSTPU_GANG_MARKER=marker)
    env["DSTPU_TRAIN_FAULTS"] = json.dumps({"enabled": True, "hang_rank_at_steps": [2], "hang_rank": 1,
                                            "hang_seconds": 300.0})
    agent = _agent(script, env, tmp_path, max_restarts=2, hang_timeout_s=8.0)
    t0 = time.monotonic()
    assert agent.run() == 0
    assert time.monotonic() - t0 < 150.0, "the watchdog must beat the 300 s hang by a wide margin"
    assert agent.restart_count == 1
    hangs = [ev for ev in read_gang_state(agent.gang_dir)["events"] if ev["kind"] == "hang"]
    assert hangs and "stale" in hangs[0]["detail"]
    doc = _marker(marker)
    assert doc["world"] == 2 and doc["final_step"] == 4


def test_death_during_save_leaves_a_torn_tag_that_resume_skips_loudly(tmp_path):
    """Rank 1 SIGKILLs itself between writing its files and its seal on the
    third save (tag global_step3): rank 0 never seals over the missing shard
    (no MANIFEST.json), and a resume at world 1 walks past the torn tag
    loudly to the newest verified-good one."""
    script = _script(tmp_path)
    ckdir = tmp_path / "ck"
    env = _env(ckdir, 6)
    env["DSTPU_TRAIN_FAULTS"] = json.dumps({"enabled": True, "die_during_save_at": [2], "die_during_save_rank": 1})
    agent = _agent(script, env, tmp_path, max_restarts=0)
    with pytest.raises(ElasticAgentError):
        agent.run()
    torn = ckdir / "global_step3"
    assert torn.is_dir(), "the ranks' files were written before the death"
    assert (torn / "state" / "rank1").is_dir() and not (torn / ".seals" / "rank1.sealed").exists()
    assert not (torn / "MANIFEST.json").exists(), "a mid-save rank death must never be sealed over"
    assert (ckdir / "global_step2" / "MANIFEST.json").exists()
    os.unlink(ckdir / "latest")
    r = _run_world1(script, _env(ckdir, 4))
    assert "resumed_step=2" in r.stdout, "must land on the newest good tag"
    assert "TORN" in r.stdout + r.stderr, "the fallback must be loud"


def test_rank_chaos_schedule_is_seed_deterministic():
    """The same seed gives the same gang-wide schedule, and the rank is a
    scope: only the targeted rank fires, while ``die_during_save`` still
    consumes the event index on every rank (the reference's assertions)."""
    cfg = dict(enabled=True, seed=7, kill_rank_at_step_p=0.3, kill_rank=1, hang_rank_at_step_p=0.2, hang_rank=0,
               die_during_save_p=0.5, die_during_save_rank=1, only_first_life=False)
    a = TrainFaultInjector(TrainFaultConfig(**cfg))
    b = TrainFaultInjector(TrainFaultConfig(**cfg))
    for point in ("kill_rank_at_step", "hang_rank_at_step", "die_during_save"):
        assert a.schedule(point, 64) == b.schedule(point, 64)
        assert a.schedule(point, 64), f"p>0 must fire somewhere in 64 ({point})"
    other = TrainFaultInjector(TrainFaultConfig(**{**cfg, "seed": 8}))
    assert any(a.schedule(p, 64) != other.schedule(p, 64) for p in ("kill_rank_at_step", "die_during_save"))
    step = a.schedule("kill_rank_at_step", 64)[0]
    fresh = TrainFaultInjector(TrainFaultConfig(**cfg))
    assert fresh.fire_step_rank("kill_rank_at_step", step, 0) is None
    assert fresh.fire_step_rank("kill_rank_at_step", step, 1) == step
    save_idx = a.schedule("die_during_save", 64)[0]
    fresh = TrainFaultInjector(TrainFaultConfig(**cfg))
    for _ in range(save_idx):
        assert fresh.fire_rank("die_during_save", 0) is None
    assert fresh.fire_rank("die_during_save", 0) is None, "wrong rank: no fire"
    fresh2 = TrainFaultInjector(TrainFaultConfig(**cfg))
    for _ in range(save_idx):
        fresh2.fire_rank("die_during_save", 1)
    assert fresh2.fire_rank("die_during_save", 1) == save_idx


def test_the_schedule_equals_the_reference_injectors():
    """The port's rank-scoped schedule is the JAX package's, event for event."""
    from deepspeed_tpu.runtime.faults import TrainFaultConfig as JCfg
    from deepspeed_tpu.runtime.faults import TrainFaultInjector as JInj
    cfg = dict(enabled=True, seed=11, kill_rank_at_step_p=0.25, kill_rank=1, hang_rank_at_step_p=0.1,
               die_during_save_p=0.4, die_during_save_rank=1, only_first_life=False)
    mine, ref = TrainFaultInjector(TrainFaultConfig(**cfg)), JInj(JCfg(**cfg))
    for point in ("kill_rank_at_step", "hang_rank_at_step", "die_during_save"):
        assert mine.schedule(point, 128) == ref.schedule(point, 128)
    for rank in (0, 1):
        assert [mine.fire_rank("die_during_save", rank) for _ in range(20)] == \
            [ref.fire_rank("die_during_save", rank) for _ in range(20)]


def test_lethal_rank_points_suppressed_on_restarted_lives(monkeypatch):
    cfg = TrainFaultConfig(enabled=True, kill_rank_at_steps=[3], kill_rank=1, die_during_save_at=[0],
                           die_during_save_rank=1)
    monkeypatch.setenv("DSTPU_RESTART_COUNT", "1")
    inj = TrainFaultInjector(cfg)
    assert inj.fire_step_rank("kill_rank_at_step", 3, 1) is None
    assert inj.fire_rank("die_during_save", 1) is None
    monkeypatch.setenv("DSTPU_RESTART_COUNT", "0")
    inj = TrainFaultInjector(cfg)
    assert inj.fire_step_rank("kill_rank_at_step", 3, 1) == 3
    assert inj.fire_rank("die_during_save", 1) == 0


def test_dstpu_train_relaunches_a_killed_gang_at_the_same_world(tmp_path):
    """``python -m deepspeed_tpu_torch.bin.dstpu_train --procs 2 --device
    cpu``: rank 1 killed at step 2 on the first life (inside train_batch,
    before the save of step 2); the agent relaunches both ranks (the kill is
    first-life only) and the job completes at world 2 from the last sealed
    checkpoint, step 1."""
    script = _script(tmp_path)
    ckdir, marker = tmp_path / "ck", tmp_path / "marker.json"
    env = _env(ckdir, 4, DSTPU_GANG_MARKER=marker)
    env["DSTPU_TRAIN_FAULTS"] = json.dumps({"enabled": True, "kill_rank_at_steps": [2], "kill_rank": 1})
    r = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_train", "--procs", "2", "--device",
                        "cpu", "--backoff-base", "0", "--max-crashes", "2", "--gang-dir", str(tmp_path / "gang"),
                        "--", sys.executable, script], env=env, cwd=REPO, timeout=240, capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dstpu_train: exit rc=0 restarts=1 world=2" in r.stdout
    assert "resumed_step=1" in r.stdout
    doc = _marker(marker)
    assert doc["world"] == 2 and doc["final_step"] == 4
