"""Port parity: replica supervision (``fleet/supervisor.py``) in
deepspeed_tpu_torch against deepspeed_tpu, and the port's replica entry
point under its supervisor.

- Local slots: the readiness gate, a routed request, a kill detected and
  restarted with backoff, a crash loop quarantined (absent capacity for the
  autoscaler, never respawned) and reset. Both packages' slots go through the
  same transitions with the same counters, and serve the same greedy tokens.
- Process slots on the reference's stdlib stub server
  (``tests/unit/fleet/stub_replica.py``): spawn, readiness, SIGKILL and
  restart; never-ready and exit-before-announce quarantined; a hang killed
  and restarted. Both supervisors end in the same slot table.
- ``python -m deepspeed_tpu_torch.bin.dstpu_replica --device cpu`` under the
  port's supervisor: readiness, registration, one routed request, SIGKILL,
  restart, re-registration and a second request, both requests' tokens equal
  to an in-process engine built from the same ``--params-seed``.

Mirrors ``tests/unit/fleet/test_supervisor.py``. Every wait has a timeout.
"""

import os
import signal
import sys
import time

import pytest
import torch

from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu.fleet import supervisor as jsupervisor
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch.bin import dstpu_replica
from deepspeed_tpu_torch.fleet import supervisor as tsupervisor
from deepspeed_tpu_torch.inference.v2.engine_factory import generate
from tests.test_torch_fleet import _ns
from tests.test_torch_serving import clear_jax_caches, fresh_telemetry, setup  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "unit", "fleet", "stub_replica.py")
WAIT_S = 60
FAST = dict(poll_interval_s=0.05, ready_timeout_s=5.0, restart_backoff_base_s=0.05, restart_backoff_cap_s=0.2,
            restart_jitter_frac=0.0)
SUPERVISORS = {"jax": jsupervisor, "torch": tsupervisor}


def _fleet_config(fleet_mod, **kw):
    kw.setdefault("probe_ttl_s", 0.0)
    kw.setdefault("connect_timeout_s", 1.0)
    kw.setdefault("read_timeout_s", 1.0)
    kw.setdefault("probe_backoff_cap_s", 0.1)
    kw.setdefault("retry_backoff_base_s", 0.0)
    return fleet_mod.FleetConfig(**kw)


def _wait(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _row(slot):
    doc = slot.describe()
    doc.pop("restart_in_s", None)
    doc.pop("command", None)
    return doc


# ------------------------------------------------------------- local slots --
def _local_run(ns, sup_mod):
    fleet = ns.fleet
    manager = fleet.ReplicaManager(engine_factory=ns.engine, config=_fleet_config(fleet))
    supervisor = sup_mod.ReplicaSupervisor(manager, fleet.SupervisorConfig(max_crashes=2, crash_window_s=60.0,
                                                                           **FAST))
    slot = supervisor.add_local(role="mixed", slot_id="sup-mixed-0")
    out = []
    supervisor.start()
    try:
        assert supervisor.wait_ready(timeout=WAIT_S)
        router = fleet.FleetRouter(manager)
        out.append((manager.pool_size("mixed"), _row(slot)))
        out.append(router.route({"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 4}).result()["tokens"])
        first = slot.replica
        first.kill("chaos")
        _wait(lambda: slot.restarts >= 1 and slot.state.name == "READY", "a restart")
        out.append((slot.replica is not first, slot.replica.id, _row(slot)))
        out.append(router.route({"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 4}).result()["tokens"])
        slot.replica.kill("chaos")  # the second crash in the window: quarantine
        _wait(lambda: slot.state.name == "QUARANTINED", "quarantine")
        scaler = fleet.FleetAutoscaler(manager, fleet.AutoscaleConfig(min_replicas=1, max_replicas=2))
        out.append((manager.pool_size("mixed"), manager.stats()["quarantined"], _row(slot),
                    scaler.observe()["replicas"], manager.pending_replicas("mixed")))
        time.sleep(0.3)
        out.append(slot.restarts)  # a quarantined slot is never respawned
        supervisor.reset(slot.id)
        _wait(lambda: slot.state.name == "READY", "the relaunch after reset")
        out.append((manager.pool_size("mixed"), _row(slot)))
        out.append(router.fleet_stats()["supervisor"]["restarts"])
    finally:
        supervisor.stop()
        manager.close()
    return out


def test_local_slots_restart_quarantine_and_reset_equal_the_reference(setup):
    runs = {pkg: _local_run(_ns(pkg, setup), SUPERVISORS[pkg]) for pkg in SUPERVISORS}
    assert runs["torch"] == runs["jax"]
    run = runs["torch"]
    assert run[1] == run[3] and run[2][0] and run[4][:2] == (0, 1) and run[4][2]["state"] == "QUARANTINED"


# ----------------------------------------------------------- process slots --
def _stub_cmd(mode, ttl_s=0.5):
    return [sys.executable, STUB, "--port-file", "{port_file}", "--mode", mode, "--ttl-s", str(ttl_s)]


PROCESS_CASES = {
    "serve": dict(sup=dict(max_crashes=3, crash_window_s=60.0, **FAST), kill=True),
    "never-ready": dict(sup=dict(max_crashes=2, crash_window_s=60.0, poll_interval_s=0.05, ready_timeout_s=0.5,
                                 restart_backoff_base_s=0.05, restart_backoff_cap_s=0.1, restart_jitter_frac=0.0),
                        until="QUARANTINED"),
    "exit": dict(sup=dict(max_crashes=1, crash_window_s=60.0, **FAST), until="QUARANTINED"),
    "hang-after-ready": dict(sup=dict(max_crashes=5, crash_window_s=2.0, probe_hang_failures=2, **FAST),
                             ttl_s=0.3, until="restart"),
}


def _process_run(fleet, sup_mod, mode):
    case = PROCESS_CASES[mode]
    manager = fleet.ReplicaManager(config=_fleet_config(fleet))
    supervisor = sup_mod.ReplicaSupervisor(manager, fleet.SupervisorConfig(**case["sup"]))
    slot = supervisor.add_process(_stub_cmd(mode, case.get("ttl_s", 0.5)), role="mixed", slot_id="sup-p-0")
    out, pids = [], []
    supervisor.start()
    try:
        if case.get("kill"):
            assert supervisor.wait_ready(timeout=WAIT_S)
            pids.append(slot.replica.proc.pid)
            out.append((manager.pool_size("mixed"), slot.replica.probe(max_age_s=0.0)["healthy"]))
            os.kill(pids[0], signal.SIGKILL)
            _wait(lambda: slot.restarts >= 1 and slot.state.name == "READY", "a process restart")
            out.append((slot.replica.proc.pid != pids[0], manager.pool_size("mixed")))
        elif case["until"] == "restart":
            assert supervisor.wait_ready(timeout=WAIT_S)
            pids.append(slot.replica.proc.pid)
            _wait(lambda: slot.restarts >= 1, "a hang restart")
            out.append(slot.last_error)
        else:
            _wait(lambda: slot.state.name == "QUARANTINED", "quarantine")
            row = next(r for r in manager.stats()["replicas"] if r["id"] == slot.id)
            out.append((manager.pool_size("mixed"), row["state"], slot.last_error.split(" (")[0]))
        if case.get("kill"):
            out.append(_row(slot))
    finally:
        supervisor.stop()
    out.append(slot.replica is None or slot.replica.proc.poll() is not None)  # stop() reaped its child
    return out


@pytest.mark.parametrize("mode", list(PROCESS_CASES))
def test_process_slots_equal_the_reference(mode):
    got = _process_run(tfleet, tsupervisor, mode)
    want = _process_run(jfleet, jsupervisor, mode)
    assert got == want
    assert got[-1] is True


# ------------------------------------------------- the port's replica binary --
REPLICA_ARGS = ["--vocab-size", "64", "--num-blocks", "32", "--max-context", "64", "--params-seed", "3"]


def test_dstpu_replica_under_the_supervisor_serves_the_in_process_tokens():
    """The port's entry point as a supervised process on the CPU: tokens
    before and after a SIGKILL + restart equal those of an in-process engine
    built from the same arguments."""
    env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.bin.dstpu_replica", "--device", "cpu",
           "--port-file", "{port_file}"] + REPLICA_ARGS
    manager = tfleet.ReplicaManager(config=_fleet_config(tfleet, read_timeout_s=30.0))
    supervisor = tsupervisor.ReplicaSupervisor(manager, tfleet.SupervisorConfig(
        max_crashes=2, crash_window_s=120.0, poll_interval_s=0.05, ready_timeout_s=60.0,
        restart_backoff_base_s=0.05, restart_backoff_cap_s=0.2, restart_jitter_frac=0.0))
    slot = supervisor.add_process(cmd, role="mixed", cwd=REPO, env=env)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]
    served = []
    supervisor.start()
    try:
        assert supervisor.wait_ready(timeout=WAIT_S), slot.describe()
        router = tfleet.FleetRouter(manager)
        served.append(router.route({"prompt": prompts[0], "max_new_tokens": 5}).result()["tokens"])
        pid = slot.replica.proc.pid
        os.kill(pid, signal.SIGKILL)
        _wait(lambda: slot.restarts >= 1 and slot.state.name == "READY", "the replica's restart")
        assert slot.replica.proc.pid != pid and manager.pool_size("mixed") == 1
        served.append(router.route({"prompt": prompts[1], "max_new_tokens": 5}).result()["tokens"])
    finally:
        supervisor.stop()
    assert slot.replica is None or slot.replica.proc.poll() is not None
    args = dstpu_replica.parser().parse_args(["--device", "cpu"] + REPLICA_ARGS)
    engine = dstpu_replica.build_engine_from_args(args)
    try:
        want = [generate(engine, [p], max_new_tokens=5)[0] for p in prompts]
    finally:
        engine.close()
    assert served == [list(map(int, w)) for w in want]


def test_dstpu_replica_refuses_the_cpu_unasked_and_checkpoints(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dstpu_replica.build_engine_from_args(dstpu_replica.parser().parse_args(REPLICA_ARGS))
    with pytest.raises(NotImplementedError, match="A9"):
        dstpu_replica.build_engine_from_args(dstpu_replica.parser().parse_args(["--checkpoint", "/nonexistent"]))
    with open(os.path.join(REPO, "bin", "dstpu_replica")) as f:
        ref = f.read()
    for action in dstpu_replica.parser()._actions[1:]:
        if action.dest != "device":
            assert action.option_strings[0] in ref
