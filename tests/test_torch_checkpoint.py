"""Port parity for checkpoints and training fault tolerance: save and load
(manifest, retention, loud fallback, async commit), preemption, the anomaly
sentinel and the training fault injector of deepspeed_tpu_torch, on the CPU.

The first part mirrors the single-process cases of
tests/unit/runtime/test_fault_tolerance.py (all 21 of them) and
tests/unit/checkpoint/test_async_checkpoint.py (all 4) on the port, with the
MLP of tests/test_torch_training.py. Left out, because they need several
processes: the gang seals and rank-scoped fault points
(tests/unit/elasticity/) and the kill-under-supervisor resume of
tests/unit/test_examples.py. The port's engine draws no random numbers, so
its manifest's ``rng`` is None where the reference records its key stream.

The second part holds the port against the JAX package: a resumed run
equals an uninterrupted one bitwise for every optimizer, the per-array CRC32s
of a save from one flax tree equal the JAX manifest's, and the training
fault injector's NaN reaches a batch of token ids (ROADMAP C6).
"""

import dataclasses
import glob
import json
import os
import shutil
import signal
import threading

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.runtime.checkpoint_engine.engine import read_manifest as jax_read_manifest
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ck_mod
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (MANIFEST_FILE, CheckpointCorruptionError,
                                                                  ReferenceCheckpointError, list_tags,
                                                                  read_manifest, retention_plan, tensor_crc32,
                                                                  verify_checkpoint)
from deepspeed_tpu_torch.runtime.engine import TrainingPreempted
from deepspeed_tpu_torch.runtime.faults import TrainFaultConfig, TrainFaultInjector, injector_from_env
from tests.test_torch_training import HIDDEN, SimpleModel, _random_batches
from tests.torch_port_helpers import jax_params, jax_tiny, port_config, port_params


@pytest.fixture(autouse=True)
def fresh_telemetry_and_signals():
    """Telemetry is process-global and the preemption test rebinds SIGTERM:
    leave both as found."""
    telemetry.shutdown()
    telemetry.state.registry = None
    old_term = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old_term)
    telemetry.shutdown()
    telemetry.state.registry = None


def _config(extra=None, optimizer=None):
    cfg = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 1,
           "optimizer": optimizer or {"type": "AdamW", "params": {"lr": 0.01, "weight_decay": 0.0}},
           "zero_optimization": {"stage": 2}}
    cfg.update(extra or {})
    return cfg


def _engine(extra=None, optimizer=None):
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=SimpleModel(), config=_config(extra, optimizer),
                                                     device="cpu")
    return engine


def _batch(step):
    rng = np.random.default_rng(100 + step)
    x = rng.normal(size=(8, HIDDEN)).astype(np.float32)
    return x, (x[:, 0] - 0.5 * x[:, 1]).astype(np.float32)


def _train_and_save(engine, save_dir, steps, start=0):
    for s in range(start, steps):
        engine.train_batch(batch=_batch(s))
        engine.save_checkpoint(str(save_dir))


def _corrupt_largest_state_file(tag_dir):
    files = [f for f in glob.glob(os.path.join(tag_dir, "state", "**"), recursive=True) if os.path.isfile(f)]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        f.seek(0)
        byte = f.read(1)
        f.seek(0)
        f.write(bytes([byte[0] ^ 0xFF]))
    return target


def _counter_value(name):
    return telemetry.get_registry().counter(name).value


def _params_equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _snapshot(engine):
    return {k: v.clone() for k, v in engine.params.items()}


# ------------------------------------------------------------- manifest core --
def test_manifest_seals_the_commit(tmp_path):
    e = _engine()
    _train_and_save(e, tmp_path, 1)
    tag_dir = os.path.join(str(tmp_path), "global_step1")
    manifest = read_manifest(tag_dir)
    assert manifest is not None and manifest["format"] == 1
    assert manifest["global_steps"] == 1
    assert "rng" in manifest
    assert manifest["world"]["device_count"] >= 1
    assert manifest["files"], "file seals missing"
    assert manifest["arrays"], "per-array CRC32s missing"
    assert any("params" in k for k in manifest["arrays"])
    assert verify_checkpoint(tag_dir) == ("good", f"{len(manifest['files'])} files verified")


def test_corrupted_and_torn_tags_fall_back_loudly(tmp_path):
    """Corrupt the newest tag and tear the middle one: the load lands on the
    oldest good tag, counted. An empty dir beforehand is a fresh start."""
    telemetry.configure(telemetry.TelemetryConfig(enabled=True))
    e = _engine()
    path, client = e.load_checkpoint(str(tmp_path))
    assert path is None and client is None

    _train_and_save(e, tmp_path, 3)
    _corrupt_largest_state_file(os.path.join(str(tmp_path), "global_step3"))
    os.unlink(os.path.join(str(tmp_path), "global_step2", MANIFEST_FILE))
    assert verify_checkpoint(os.path.join(str(tmp_path), "global_step3"))[0] == "corrupt"
    assert verify_checkpoint(os.path.join(str(tmp_path), "global_step2"))[0] == "torn"

    e2 = _engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1")
    assert e2.global_steps == 1
    assert _counter_value("checkpoint_verify_failures_total") >= 2
    assert _counter_value("checkpoint_load_fallbacks_total") >= 2


def test_bad_tags_raise_instead_of_silent_none(tmp_path):
    e = _engine()
    _train_and_save(e, tmp_path, 1)
    _corrupt_largest_state_file(os.path.join(str(tmp_path), "global_step1"))
    e2 = _engine()
    with pytest.raises(CheckpointCorruptionError, match="CORRUPT"):
        e2.load_checkpoint(str(tmp_path), tag="global_step1")
    with pytest.raises(CheckpointCorruptionError, match="no verified-good"):
        e2.load_checkpoint(str(tmp_path))


def test_verify_arrays_on_load_catches_sub_file_corruption(tmp_path):
    """Tamper with one array seal only (the file seals stay true): only the
    per-array re-check can catch it."""
    e = _engine(extra={"checkpoint": {"verify_arrays_on_load": True}})
    _train_and_save(e, tmp_path, 1)
    tag_dir = os.path.join(str(tmp_path), "global_step1")
    manifest = read_manifest(tag_dir)
    key = next(k for k in manifest["arrays"] if "params" in k)
    manifest["arrays"][key]["crc32"] ^= 0xFF
    with open(os.path.join(tag_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f)

    e2 = _engine(extra={"checkpoint": {"verify_arrays_on_load": True}})
    before = _snapshot(e2)
    with pytest.raises(CheckpointCorruptionError, match="per-array"):
        e2.load_checkpoint(str(tmp_path), tag="global_step1")
    assert _params_equal(e2.params, before) and e2.global_steps == 0, "a refused restore must change nothing"


# ---------------------------------------------------------------- retention --
def test_retention_keeps_last_k(tmp_path):
    e = _engine(extra={"checkpoint": {"keep_last_k": 2}})
    _train_and_save(e, tmp_path, 4)
    assert {t["tag"] for t in list_tags(str(tmp_path))} == {"global_step3", "global_step4"}


def test_retention_never_deletes_last_good(tmp_path):
    e = _engine()
    _train_and_save(e, tmp_path, 3)
    for tag in ("global_step2", "global_step3"):
        os.unlink(os.path.join(str(tmp_path), tag, MANIFEST_FILE))
    keep, drop = retention_plan(str(tmp_path), keep_last_k=1)
    kept = {e["tag"] for e in keep}
    assert "global_step1" in kept, "the last good tag must survive retention"
    assert "global_step3" in kept
    assert {e["tag"] for e in drop} == {"global_step2"}


# ------------------------------------------------- reference-format rejection --
def test_reference_torch_checkpoint_rejected_loudly(tmp_path):
    ref = tmp_path / "global_step100"
    ref.mkdir()
    (ref / "zero_pp_rank_0_mp_rank_00_optim_states.pt").write_bytes(b"torch")
    (ref / "mp_rank_00_model_states.pt").write_bytes(b"torch")
    (tmp_path / "latest").write_text("global_step100")

    e = _engine()
    with pytest.raises(ReferenceCheckpointError, match="ds_to_universal"):
        e.load_checkpoint(str(tmp_path))
    with pytest.raises(ReferenceCheckpointError, match="ds_to_universal"):
        e.load_checkpoint(str(tmp_path), tag="global_step100")


# --------------------------------------------------------- step-exact resume --
OPTIMIZERS = {
    "adamw": {"type": "AdamW", "params": {"lr": 0.01, "weight_decay": 0.01}},
    "adam_l2": {"type": "Adam", "params": {"lr": 0.01, "weight_decay": 0.01, "adam_w_mode": False}},
    "cpuadam": {"type": "CPUAdam", "params": {"lr": 0.01}},
    "lamb": {"type": "Lamb", "params": {"lr": 0.01, "weight_decay": 0.01}},
    "lion": {"type": "Lion", "params": {"lr": 0.001, "weight_decay": 0.01}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 0.01}},
    "sgd_momentum": {"type": "SGD", "params": {"lr": 0.01, "momentum": 0.9, "nesterov": True}},
    "sgd": {"type": "SGD", "params": {"lr": 0.01}},
    "onebitadam": {"type": "OnebitAdam", "params": {"lr": 0.01, "freeze_step": 2}},
    "onebitlamb": {"type": "OnebitLamb", "params": {"lr": 0.01, "freeze_step": 2}},
    "zerooneadam": {"type": "ZeroOneAdam", "params": {"lr": 0.001, "var_freeze_step": 2}},
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_save_load_resume_is_step_exact(tmp_path, opt):
    """Saved at step 2 and resumed in a fresh engine, the run's losses and
    weights equal, bitwise, those of a run that never stopped, for every
    optimizer (so every optimizer state round-trips; the 1-bit ones save
    inside their compressed phase)."""
    e1 = _engine(optimizer=OPTIMIZERS[opt])
    _train_and_save(e1, tmp_path, 2)
    want_losses = [e1.train_batch(batch=_batch(s)) for s in range(2, 5)]
    want = _snapshot(e1)

    e2 = _engine(optimizer=OPTIMIZERS[opt])
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and e2.global_steps == 2
    assert all(torch.equal(p.detach().float(), e2.params[n]) for n, p in e2._module_params.items()), \
        "the module must hold the restored masters"
    losses = [e2.train_batch(batch=_batch(s)) for s in range(2, 5)]
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert all(torch.isfinite(p).all() for p in want.values())
    assert _params_equal(e2.params, want), "resumed run diverged from uninterrupted"


# ------------------------------------------------------- async save draining --
def test_async_save_commits_on_destroy(tmp_path):
    e = _engine(extra={"nebula": {"enabled": True}})
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    e.destroy()
    status, detail = verify_checkpoint(os.path.join(str(tmp_path), "global_step1"))
    assert status == "good", f"async save torn by destroy: {detail}"
    assert e._async_ckpt["thread"] is None


def _gate_writes(monkeypatch, gate):
    real = ck_mod._write_state

    def gated(snapshot, state_dir):
        assert gate.wait(timeout=60)
        real(snapshot, state_dir)

    monkeypatch.setattr(ck_mod, "_write_state", gated)


def test_async_manifest_seals_dispatch_time_state(tmp_path, monkeypatch):
    gate = threading.Event()
    _gate_writes(monkeypatch, gate)
    e = _engine(extra={"nebula": {"enabled": True}})
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))  # the snapshot at step 1, the commit held open
    e.train_batch(batch=_batch(1))
    gate.set()
    e.checkpoint_wait()
    manifest = read_manifest(os.path.join(str(tmp_path), "global_step1"))
    assert manifest["global_steps"] == 1, "the manifest must seal the dispatch-time step"
    e.destroy()


def test_async_save_overlaps_training_and_is_loadable(tmp_path, monkeypatch):
    """Steps run while the commit is held open; the durable markers appear
    only after it; the loaded state is the one at save time."""
    gate = threading.Event()
    _gate_writes(monkeypatch, gate)
    eng = _engine(extra={"nebula": {"enabled": True}})
    batches = _random_batches(4, 8)
    for b in batches[:2]:
        float(eng.train_batch(batch=b))
    want = _snapshot(eng)
    steps_at_save = eng.global_steps

    assert eng.save_checkpoint(str(tmp_path), tag="async")
    st = eng._async_ckpt
    assert st["thread"].is_alive()
    for b in batches[2:]:
        float(eng.train_batch(batch=b))
    assert eng.global_steps == steps_at_save + 2
    assert not os.path.exists(tmp_path / "latest")
    assert not os.path.exists(tmp_path / "async" / "host_state.pkl")
    assert st["thread"].is_alive()

    gate.set()
    eng.checkpoint_wait()
    assert st["thread"] is None
    assert (tmp_path / "latest").read_text() == "async"
    assert os.path.exists(tmp_path / "async" / "host_state.pkl")

    eng2 = _engine(extra={"nebula": {"enabled": True}})
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="async")
    assert path is not None and eng2.global_steps == steps_at_save
    assert _params_equal(eng2.params, want)


def test_next_save_barriers_on_inflight_commit(tmp_path, monkeypatch):
    order = []
    real = ck_mod._write_state

    def logged(snapshot, state_dir):
        order.append(os.path.basename(os.path.dirname(state_dir)))
        real(snapshot, state_dir)

    monkeypatch.setattr(ck_mod, "_write_state", logged)
    eng = _engine(extra={"nebula": {"enabled": True}})
    float(eng.train_batch(batch=_random_batches(1, 8)[0]))
    eng.save_checkpoint(str(tmp_path), tag="first")
    first_thread = eng._async_ckpt["thread"]
    eng.save_checkpoint(str(tmp_path), tag="second")
    assert not first_thread.is_alive(), "the first commit must be joined before the second dispatches"
    assert order and order[0] == "first"
    eng.checkpoint_wait()
    assert (tmp_path / "latest").read_text() == "second"
    assert os.path.exists(tmp_path / "first" / "host_state.pkl")
    assert os.path.exists(tmp_path / "second" / "host_state.pkl")


def test_sync_save_unaffected(tmp_path):
    eng = _engine()
    float(eng.train_batch(batch=_random_batches(1, 8)[0]))
    eng.save_checkpoint(str(tmp_path), tag="sync")
    assert (tmp_path / "latest").read_text() == "sync"
    assert getattr(eng, "_async_ckpt", None) is None


def test_failed_commit_surfaces_at_barrier(tmp_path, monkeypatch):
    def broken(snapshot, state_dir):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(ck_mod, "_write_state", broken)
    eng = _engine(extra={"nebula": {"enabled": True}})
    float(eng.train_batch(batch=_random_batches(1, 8)[0]))
    eng.save_checkpoint(str(tmp_path), tag="doomed")
    with pytest.raises(RuntimeError, match="async checkpoint commit failed"):
        eng.checkpoint_wait()
    assert not os.path.exists(tmp_path / "latest")
    monkeypatch.undo()
    eng.save_checkpoint(str(tmp_path), tag="retry")
    eng.checkpoint_wait()
    assert (tmp_path / "latest").read_text() == "retry"


def test_dangling_latest_with_no_tags_is_a_fresh_start(tmp_path):
    (tmp_path / "latest").write_text("global_step9")
    path, client = _engine().load_checkpoint(str(tmp_path))
    assert path is None and client is None


def test_crash_during_first_ever_save_is_a_fresh_start(tmp_path):
    partial = tmp_path / "global_step1" / "state"
    partial.mkdir(parents=True)
    (partial / "partial_write").write_bytes(b"torn")
    path, client = _engine().load_checkpoint(str(tmp_path))
    assert path is None and client is None


# ------------------------------------------------------------ preemption path --
def test_preemption_sigterm_final_checkpoint_and_marker(tmp_path):
    telemetry.configure(telemetry.TelemetryConfig(enabled=True))
    e = _engine()
    e.install_preemption_handler(save_dir=str(tmp_path))
    e.train_batch(batch=_batch(0))
    os.kill(os.getpid(), signal.SIGTERM)
    with pytest.raises(TrainingPreempted) as exc:
        e.train_batch(batch=_batch(1))
    assert exc.value.code == 143
    assert exc.value.tag == f"preempt_step{exc.value.step}"

    with open(os.path.join(str(tmp_path), "PREEMPTED.json")) as f:
        marker = json.load(f)
    assert marker["tag"] == exc.value.tag
    assert verify_checkpoint(os.path.join(str(tmp_path), marker["tag"]))[0] == "good"
    assert _counter_value("train_preemptions_total") == 1

    e2 = _engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith(marker["tag"])
    assert e2.global_steps == marker["global_steps"]
    assert _params_equal(e2.params, e.params)


# ------------------------------------------------------------ anomaly sentinel --
def test_sentinel_skips_nonfinite_steps_and_rolls_back(tmp_path):
    """NaN grads in bf16: skip-step (weights and optimizer state untouched,
    counted as skipped), then M anomalies in a row roll back."""
    telemetry.configure(telemetry.TelemetryConfig(enabled=True))
    e = _engine(extra={"anomaly_sentinel": {"enabled": True, "max_consecutive": 2, "warmup_steps": 0},
                       "bf16": {"enabled": True}})
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    good_params = _snapshot(e)
    good_m = {k: v.clone() for k, v in e.opt_state.exp_avg.items()}

    x, y = _batch(1)
    bad = (np.full_like(x, np.nan), y)
    e.train_batch(batch=bad)
    assert e.skipped_steps == 1, "a non-finite step must be skipped"
    assert _params_equal(e.params, good_params), "skip-step must leave the weights untouched"
    assert _params_equal(e.opt_state.exp_avg, good_m) and int(e.opt_state.step) == 1
    assert _counter_value("train_anomalies_total") == 1

    e.train_batch(batch=bad)
    assert _counter_value("train_rollbacks_total") == 1
    assert e.global_steps == 1, "rollback must land on the checkpointed step"
    assert _params_equal(e.params, good_params)
    assert np.isfinite(float(e.train_batch(batch=_batch(1))))


def test_sentinel_spike_rollback_targets_pre_divergence_tag(tmp_path):
    e = _engine(extra={"anomaly_sentinel": {"enabled": True, "max_consecutive": 2, "warmup_steps": 0,
                                            "spike_factor": 5.0}})
    e.train_batch(batch=_batch(0))
    e.save_checkpoint(str(tmp_path))
    good_params = _snapshot(e)

    x, y = _batch(1)
    spike = (x * 100.0, y)
    e.train_batch(batch=spike)  # anomaly 1, the update applied
    e.save_checkpoint(str(tmp_path))  # the diverged state checkpointed
    assert e._sentinel.anomalies == 1
    e.train_batch(batch=spike)  # anomaly 2: rollback
    assert e._sentinel.rollbacks == 1
    assert e.global_steps == 1, "rollback must target the tag from before the divergence"
    assert _params_equal(e.params, good_params)

    # no tag at or before the healthy horizon left: rollback refuses
    shutil.rmtree(os.path.join(str(tmp_path), "global_step1"))
    e.train_batch(batch=spike)
    e.train_batch(batch=spike)
    assert e._sentinel.rollbacks == 2
    assert e.global_steps == 3, "no tag from before the divergence: nothing may be loaded"


# ---------------------------------------------------------- chaos injector --
def test_train_fault_injector_is_deterministic():
    cfg = TrainFaultConfig(enabled=True, seed=7, nan_inject_p=0.3, kill_at_steps=(5, ))
    a, b = TrainFaultInjector(cfg), TrainFaultInjector(cfg)
    assert a.schedule("nan_inject", 200) == b.schedule("nan_inject", 200)
    assert a.schedule("nan_inject", 200), "p=0.3 over 200 events must fire"
    assert a.would_fire("kill_at_step", 5) and not a.would_fire("kill_at_step", 4)
    fired = [n for n in range(50) if a.fire("checkpoint_corrupt") is not None]
    assert fired == a.schedule("checkpoint_corrupt", 50)
    with pytest.raises(ValueError, match="unknown injection point"):
        a.would_fire("nope", 0)


def test_injector_schedule_matches_jax():
    """The same seed gives the JAX package's schedule, event for event."""
    from deepspeed_tpu.runtime.faults import TrainFaultConfig as JConfig, TrainFaultInjector as JInjector
    kw = dict(enabled=True, seed=11, nan_inject_p=0.2, checkpoint_corrupt_p=0.1, sigterm_at_steps=(3, 9))
    port, ref = TrainFaultInjector(TrainFaultConfig(**kw)), JInjector(JConfig(**kw))
    for point in ("nan_inject", "checkpoint_corrupt", "sigterm_at_step", "kill_at_step"):
        assert port.schedule(point, 300) == ref.schedule(point, 300), point


def test_injector_kill_points_are_first_life_only(monkeypatch):
    inj = TrainFaultInjector(TrainFaultConfig(enabled=True, kill_at_steps=(3, )))
    monkeypatch.setenv("DSTPU_RESTART_COUNT", "1")
    assert inj.fire_step("kill_at_step", 3) is None, "a restarted life must not replay the kill"
    monkeypatch.setenv("DSTPU_RESTART_COUNT", "0")
    assert inj.fire_step("kill_at_step", 3) == 3
    assert inj.fire_step("kill_at_step", 3) is None


def test_injector_env_arming():
    assert injector_from_env(None) is None
    assert injector_from_env(json.dumps({"enabled": False})) is None
    inj = injector_from_env(json.dumps({"enabled": True, "seed": 3, "sigterm_at_steps": [2]}))
    assert inj is not None and inj.would_fire("sigterm_at_step", 2)
    with pytest.raises(ValueError):
        injector_from_env("{not json")


def test_injector_corrupts_sealed_checkpoint(tmp_path):
    e = _engine()
    _train_and_save(e, tmp_path, 1)
    tag_dir = os.path.join(str(tmp_path), "global_step1")
    inj = TrainFaultInjector(TrainFaultConfig(enabled=True, seed=1))
    assert inj.corrupt_checkpoint(tag_dir, 0) is not None
    status, detail = verify_checkpoint(tag_dir)
    assert status == "corrupt" and "crc32 mismatch" in detail
    assert inj.truncate_checkpoint(tag_dir) is True
    assert verify_checkpoint(tag_dir)[0] == "torn"
    assert inj.truncate_checkpoint(tag_dir) is False


def test_nan_inject_through_the_engine_env(monkeypatch):
    monkeypatch.setenv("DSTPU_TRAIN_FAULTS", json.dumps({"enabled": True, "nan_at_steps": [1]}))
    e = _engine(extra={"anomaly_sentinel": {"enabled": True, "max_consecutive": 10}})
    e.train_batch(batch=_batch(0))
    assert e.skipped_steps == 0
    e.train_batch(batch=_batch(1))  # global step 1: poisoned
    assert e.skipped_steps == 1
    assert e._sentinel.anomalies == 1
    e.train_batch(batch=_batch(2))
    assert e.skipped_steps == 1


def test_checkpoint_report_lists_statuses_and_survivors(tmp_path, capsys):
    from deepspeed_tpu_torch.env_report import checkpoint_report
    e = _engine(extra={"checkpoint": {"keep_last_k": 3}})
    _train_and_save(e, tmp_path, 3)
    assert checkpoint_report(str(tmp_path)) == 0
    assert "all tags verified" in capsys.readouterr().out

    _corrupt_largest_state_file(os.path.join(str(tmp_path), "global_step3"))
    os.unlink(os.path.join(str(tmp_path), "global_step2", MANIFEST_FILE))
    rc = checkpoint_report(str(tmp_path))
    out = capsys.readouterr().out
    assert rc == 1
    assert "corrupt" in out and "torn" in out and "good" in out
    assert "crc32 mismatch" in out
    assert "latest" in out and "kept" in out
    assert "keep_last_k=3" in out


# ------------------------------------------------------ against the JAX engine --
def _flax_path(name):
    """The flax key path of a port parameter name, and whether the port holds
    the leaf transposed (a Dense kernel is [in, out]; torch's weight is
    [out, in])."""
    *head, leaf = name.split(".")
    path, i = ["model"], 0
    while i < len(head):
        if head[i] == "layers":
            path.append(f"layers_{head[i + 1]}")
            i += 2
        else:
            path.append(head[i])
            i += 1
    if path[-1] == "embed_tokens":
        return path + ["embedding"], False
    if path[-1].endswith("norm"):
        return path + [leaf], False
    return path + ["kernel"], True


def _keystr(*keys):
    return "".join(f"[{k!r}]" for k in keys)


@pytest.fixture(scope="module")
def side_by_side(tmp_path_factory):
    """One flax tree into a JAX engine and a port engine, both with the
    sentinel and DSTPU_TRAIN_FAULTS's nan_at_steps [0]: each saves at step 0,
    then trains one step on a batch of token ids."""
    jcfg = jax_tiny(use_flash_attention=False)
    jparams = jax_params(jcfg)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "zero_optimization": {"stage": 0},
              "anomaly_sentinel": {"enabled": True, "max_consecutive": 5}}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, size=(4, 17))
    batch = (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    root = tmp_path_factory.mktemp("side_by_side")
    out = {"jcfg": jcfg}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSTPU_TRAIN_FAULTS", json.dumps({"enabled": True, "nan_at_steps": [0]}))
        groups.initialize_mesh(devices=jax.devices()[:1], force=True)
        jengine, _, _, _ = deepspeed_tpu.initialize(model=jllama.LlamaForCausalLM(jcfg), model_parameters=jparams,
                                                    config=config)
        jengine.save_checkpoint(str(root / "jax"))
        jengine.checkpoint_wait()
        out["jax_loss"] = float(jengine.train_batch(batch=batch))
        out["jax_skipped"] = jengine.skipped_steps
        out["jax_manifest"] = jax_read_manifest(str(root / "jax" / "global_step0"))
        jengine.destroy()
        jtel.shutdown()

        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(port_config(jcfg)),
                                                         model_parameters=port_params(jcfg, jparams),
                                                         config=config, device="cpu")
        engine.save_checkpoint(str(root / "port"))
        out["port_params"] = _snapshot(engine)
        out["port_loss"] = float(engine.train_batch(batch=batch))
        out["port_skipped"] = engine.skipped_steps
        out["port_params_after"] = _snapshot(engine)
        out["port_manifest"] = read_manifest(str(root / "port" / "global_step0"))
    return out


def test_array_crc32s_equal_the_jax_manifest(side_by_side):
    """Every f32 leaf of a save from one flax tree has the JAX manifest's
    CRC32: directly where the port holds the leaf in flax's layout (the
    embedding, the norms, every zero moment and the scalars), and through
    the port's CRC of the transposed tensor for the Dense kernels."""
    port, ref = side_by_side["port_manifest"], side_by_side["jax_manifest"]
    for key in ("global_steps", "global_samples", "micro_steps", "skipped_steps", "loss_scale"):
        assert port[key] == ref[key], key
    pa, ja = port["arrays"], ref["arrays"]
    assert len(pa) == len(ja)
    checked = 0
    for name, t in side_by_side["port_params"].items():
        path, transposed = _flax_path(name)
        for tree, port_key, jax_key in (("params", _keystr("params", name), _keystr("params", *path)),
                                        ("exp_avg", _keystr("opt_state", "exp_avg", name),
                                         _keystr("opt_state", "exp_avg", *path)),
                                        ("exp_avg_sq", _keystr("opt_state", "exp_avg_sq", name),
                                         _keystr("opt_state", "exp_avg_sq", *path))):
            assert pa[port_key]["dtype"] == ja[jax_key]["dtype"] == "float32"
            checked += 1
            if not transposed:
                assert pa[port_key] == ja[jax_key], jax_key
                continue
            assert pa[port_key]["shape"] == ja[jax_key]["shape"][::-1]
            if tree == "params":
                assert tensor_crc32(t.T) == ja[jax_key]["crc32"], jax_key
                assert pa[port_key]["crc32"] != ja[jax_key]["crc32"], "a transposed kernel holds other bytes"
            else:  # zeros at step 0: the same bytes in either layout
                assert pa[port_key]["crc32"] == ja[jax_key]["crc32"], jax_key
    for key in ("['opt_state']['step']", "['scale_state']['cur_scale']", "['scale_state']['good_steps']",
                "['scale_state']['hysteresis']"):
        assert pa[key] == ja[key], key
        checked += 1
    assert checked == len(pa)


def test_c6_nan_inject_reaches_a_batch_of_token_ids(side_by_side):
    """ROADMAP C6: the reference's poison_batch NaNs the first floating leaf
    and leaves a batch of token ids as it is, so DSTPU_TRAIN_FAULTS's
    nan_inject never fires on a language model; the port poisons the step's
    losses instead, and the sentinel skips the step."""
    assert side_by_side["jax_skipped"] == 0 and np.isfinite(side_by_side["jax_loss"])
    assert side_by_side["port_skipped"] == 1 and np.isnan(side_by_side["port_loss"])
    assert _params_equal(side_by_side["port_params_after"], side_by_side["port_params"])


def test_module_and_16bit_weights_round_trip(tmp_path):
    """``load_module_state_dict`` puts weights in the masters and the module;
    ``save_16bit_model`` writes them in the compute dtype (bf16 as its
    bits)."""
    e = _engine(extra={"bf16": {"enabled": True}})
    src = _engine()
    src.train_batch(batch=_batch(0))
    e.load_module_state_dict(src.module_state_dict())
    assert _params_equal(e.params, src.params)
    assert all(torch.equal(p, src.params[n].to(torch.bfloat16)) for n, p in e._module_params.items())
    with pytest.raises(KeyError, match="missing"):
        e.load_module_state_dict({"head.bias": src.params["head.bias"]})
    e.save_16bit_model(str(tmp_path))
    saved = np.load(str(tmp_path / "pytorch_model.bin.npz"))
    assert set(saved.files) == set(e.params)
    for name, p in e.params.items():
        assert np.array_equal(saved[name], p.to(torch.bfloat16).view(torch.uint16).numpy())


def test_checkpoint_dataclass_bounds():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    for block in ({"checkpoint": {"keep_last_k": -1}}, {"checkpoint": {"preemption_grace_s": 0}},
                  {"anomaly_sentinel": {"ema_beta": 1.0}}, {"anomaly_sentinel": {"spike_factor": 1.0}},
                  {"anomaly_sentinel": {"max_consecutive": 0}}):
        with pytest.raises(ValueError):
            DeepSpeedConfig({"train_batch_size": 8, **block})
    cfg = DeepSpeedConfig({"train_batch_size": 8, "checkpoint": {"tag_validation": "Ignore"},
                           "nebula": {"enabled": True}})
    assert not cfg.checkpoint_tag_validation_enabled and cfg.nebula_config.enabled
    assert dataclasses.asdict(cfg.anomaly_sentinel_config)["max_consecutive"] == 3


def _micro_steps_to_preemption(engine, save_dir, batches):
    """The micro-step API with GAS 2 and a SIGTERM before the first boundary
    step; returns the preemption checkpoint's manifest."""
    engine.install_preemption_handler(save_dir=save_dir)
    engine.backward(engine.forward(batches[0]))
    engine.step()
    os.kill(os.getpid(), signal.SIGTERM)
    engine.backward(engine.forward(batches[1]))
    with pytest.raises(SystemExit) as exc:  # each package's TrainingPreempted
        engine.step()  # the boundary: the optimizer step, then the preemption exit
    assert exc.value.code == 143
    with open(os.path.join(save_dir, "PREEMPTED.json")) as f:
        return read_manifest(os.path.join(save_dir, json.load(f)["tag"]))


def test_c7_a_preemption_in_step_saves_the_micro_step_it_took(tmp_path):
    """ROADMAP C7: the reference's ``step`` runs the preemption exit before it
    counts the micro-step, so its final checkpoint holds micro_steps 1 after
    two micro-steps (one optimizer step at GAS 2), and a resumed micro-step
    loop takes its boundaries one micro-step early. The port counts first."""
    from tests.unit.simple_model import make_simple_model
    extra = {"gradient_accumulation_steps": 2, "train_micro_batch_size_per_gpu": 8}
    batches = [_batch(0), _batch(1)]
    groups.initialize_mesh(devices=jax.devices()[:1], force=True)
    model, params = make_simple_model(hidden_dim=HIDDEN, batch_size=8)
    jengine, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=params, config=_config(extra))
    jmanifest = _micro_steps_to_preemption(jengine, str(tmp_path / "jax"), batches)
    jengine.destroy()
    manifest = _micro_steps_to_preemption(_engine(extra), str(tmp_path / "port"), batches)
    assert (jmanifest["global_steps"], jmanifest["micro_steps"]) == (1, 1)
    assert (manifest["global_steps"], manifest["micro_steps"]) == (1, 2)
    e2 = _engine(extra)
    e2.load_checkpoint(str(tmp_path / "port"))
    assert not e2.is_gradient_accumulation_boundary(), "the resumed window starts with a micro-step to accumulate"
