"""Port parity for ``comm``, ``utils/groups.py`` and the file barrier: the
port's collectives on rank-local tensors over gloo gangs of 2 and 4 ranks
against the JAX package's eager ``comm`` on ``x:[G, ...]`` over a G-device
sub-mesh (``groups.initialize_mesh(devices=jax.devices()[:G])``), where
shard ``i`` plays rank ``i``'s tensor. Integer results are exact; float
sums agree to f32 rounding (gloo and XLA add in other orders).

The gangs are built once for the module (``tests/torch_gang.py``).
"""

import itertools
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.comm as jdist
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm.comm import BarrierTimeoutError, _file_barrier
from deepspeed_tpu_torch.utils import groups
from tests import torch_gang_scenarios as sc
from tests.torch_gang import Gang

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def gangs():
    made = {2: Gang(2), 4: Gang(4)}
    yield made
    for g in made.values():
        g.close()


def _x(G, shape, seed, dtype=np.float32, positive=False):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, size=(G, ) + shape).astype(dtype)
    x = rng.normal(size=(G, ) + shape).astype(dtype)
    return np.abs(x) + 0.5 if positive else x


# (name, op, kwargs, input maker, how to read the JAX result for group rank i)
ROW, FULL = "row", "full"
CASES = [
    ("all_reduce_sum_f32", "all_reduce", {"op": "SUM"}, lambda G: _x(G, (3, 5), 1), ROW),
    ("all_reduce_max_f32", "all_reduce", {"op": "MAX"}, lambda G: _x(G, (3, 5), 2), ROW),
    ("all_reduce_min_f32", "all_reduce", {"op": "MIN"}, lambda G: _x(G, (3, 5), 3), ROW),
    ("all_reduce_avg_f32", "all_reduce", {"op": "AVG"}, lambda G: _x(G, (3, 5), 4), ROW),
    ("all_reduce_product_f32", "all_reduce", {"op": "PRODUCT"}, lambda G: _x(G, (7, ), 5, positive=True), ROW),
    ("all_reduce_sum_i32", "all_reduce", {"op": "SUM"}, lambda G: _x(G, (3, 5), 6, np.int32), ROW),
    ("all_reduce_max_i32", "all_reduce", {"op": "MAX"}, lambda G: _x(G, (3, 5), 7, np.int32), ROW),
    ("all_reduce_min_i32", "all_reduce", {"op": "MIN"}, lambda G: _x(G, (3, 5), 8, np.int32), ROW),
    ("inference_all_reduce", "inference_all_reduce", {"op": "SUM"}, lambda G: _x(G, (6, ), 9), ROW),
    ("reduce", "reduce", {"op": "SUM"}, lambda G: _x(G, (6, ), 10), ROW),
    ("all_gather_into_tensor_f32", "all_gather_into_tensor", {}, lambda G: _x(G, (2, 3), 11), FULL),
    ("all_gather_into_tensor_i32", "all_gather_into_tensor", {}, lambda G: _x(G, (2, 3), 12, np.int32), FULL),
    ("all_gather", "all_gather", {}, lambda G: _x(G, (3, ), 13), FULL),
    ("gather", "gather", {}, lambda G: _x(G, (2, 2), 14), FULL),
    ("reduce_scatter_sum", "reduce_scatter_tensor", {"op": "SUM"}, lambda G: _x(G, (G * 2, 3), 15), ROW),
    ("reduce_scatter_avg", "reduce_scatter_tensor", {"op": "AVG"}, lambda G: _x(G, (G * 2, 3), 16), ROW),
    ("reduce_scatter_i32", "reduce_scatter_tensor", {"op": "SUM"}, lambda G: _x(G, (G * 3, ), 17, np.int32), ROW),
    ("reduce_scatter_alias", "reduce_scatter", {}, lambda G: _x(G, (G * 2, ), 18), ROW),
    ("all_to_all_single", "all_to_all_single", {}, lambda G: _x(G, (G, 3), 19), ROW),
    ("all_to_all_single_i32", "all_to_all_single", {}, lambda G: _x(G, (G, 2, 2), 20, np.int32), ROW),
    ("broadcast_src0", "broadcast", {"src": 0}, lambda G: _x(G, (4, ), 21), ROW),
    ("broadcast_src_last", "broadcast", {"src": -1}, lambda G: _x(G, (2, 3), 22, np.int32), ROW),
    ("scatter_src0", "scatter", {"src": 0}, lambda G: _x(G, (G * 2, ), 23), ROW),
    ("scatter_src1", "scatter", {"src": 1}, lambda G: _x(G, (G * 3, 2), 24, np.int32), ROW),
]


def _jax_call(op, kw, x, group=None):
    kw = {k: (jdist.ReduceOp[v] if k == "op" else v) for k, v in kw.items()}
    return np.asarray(getattr(jdist, op)(x, group=group, **kw))


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FLOAT_TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("G", [2, 4])
def test_collective_equals_the_jax_comm(gangs, G, case):
    name, op, kw, make, read = case
    x = make(G)
    kw = dict(kw)
    if kw.get("src") == -1:
        kw["src"] = G - 1
    jgroups.initialize_mesh(devices=jax.devices()[:G], force=True)
    jdist.init_distributed()
    want = _jax_call(op, kw, x)
    res = gangs[G].run(sc.comm_ops, {}, None, [(op, kw, x)])
    for gi, (out, ) in res:
        _check(out, want[gi] if read == ROW else want, x.dtype)


SUBGROUP_MESHES = [({"model_parallel_size": 2}, "model"), ({"model_parallel_size": 2}, "data"),
                   ({"pipe_parallel_size": 2}, "pipe"), ({"pipe_parallel_size": 2}, ("pipe", "data")),
                   ({"sequence_parallel_size": 2}, "seq"), ({"expert_parallel_size": 2}, ("data", "expert"))]


@pytest.mark.parametrize("mesh_kw,group", SUBGROUP_MESHES, ids=lambda v: str(v))
def test_subgroup_collectives_equal_the_jax_comm(gangs, mesh_kw, group):
    """On a 4-rank mesh with two axes of 2: each collective over an axis
    (or two) of it, every rank on its own slice, equals the JAX comm over
    that axis of the 4-device mesh (the same x on every slice there)."""
    jgroups.initialize_mesh(devices=jax.devices()[:4], force=True, **mesh_kw)
    jdist.init_distributed()
    G = jgroups._axis_size(group)
    cases = [("all_reduce", {"op": "SUM"}, _x(G, (3, ), 30), ROW),
             ("all_reduce", {"op": "MAX"}, _x(G, (2, 2), 31, np.int32), ROW),
             ("all_gather_into_tensor", {}, _x(G, (2, ), 32), FULL),
             ("reduce_scatter_tensor", {"op": "SUM"}, _x(G, (G * 2, ), 33), ROW),
             ("all_to_all_single", {}, _x(G, (G, 2), 34, np.int32), ROW),
             ("broadcast", {"src": 1}, _x(G, (3, ), 35), ROW)]
    want = [_jax_call(op, kw, x, group=group) for op, kw, x, _ in cases]
    res = gangs[4].run(sc.comm_ops, mesh_kw, group, [c[:3] for c in cases])
    for gi, outs in res:
        for out, w, (_, _, x, read) in zip(outs, want, cases):
            _check(out, w[gi] if read == ROW else w, x.dtype)


def _mesh_shapes(G):
    """Every assignment of sizes multiplying to ``G`` (2 or 4) to the six
    mesh axes: one axis of G, or (for 4) two axes of 2."""
    shapes = []
    for ax in groups.MESH_AXES:
        shapes.append({ax: G})
    if G == 4:
        for a, b in itertools.combinations(groups.MESH_AXES, 2):
            shapes.append({a: 2, b: 2})
    return shapes


def _mesh_kw(shape):
    """``initialize_mesh`` arguments for an axis -> size map (hpz splits the
    data degree, as the reference's ``secondary_partition_size``)."""
    return {"pipe_parallel_size": shape.get("pipe", 1), "model_parallel_size": shape.get("model", 1),
            "expert_parallel_size": shape.get("expert", 1), "sequence_parallel_size": shape.get("seq", 1),
            "secondary_partition_size": shape.get("hpz", 1),
            "data_parallel_size": shape.get("data", 1) * shape.get("hpz", 1)}


@pytest.mark.parametrize("G,shape", [(G, s) for G in (2, 4) for s in _mesh_shapes(G)],
                         ids=lambda v: str(v) if isinstance(v, int) else "-".join(f"{k}{n}" for k, n in v.items()))
def test_group_ranks_equal_the_device_ids_along_each_mesh_axis(gangs, G, shape):
    """For every axis: the ranks of each rank's group (and of the process
    group behind it) are the device ids along that axis of the reference's
    mesh, through the device at the rank's position, in axis order."""
    mesh = jgroups.initialize_mesh(devices=jax.devices()[:G], force=True, **_mesh_kw(shape))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    res = gangs[G].run(sc.group_membership, _mesh_kw(shape))
    for rank, out in res:
        where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        for k, ax in enumerate(groups.MESH_AXES):
            line = [int(ids[where[:k] + (j, ) + where[k + 1:]]) for j in range(ids.shape[k])]
            ranks, pg_ranks, index = out[ax]
            assert ranks == line, (ax, rank)
            assert sorted(pg_ranks) == sorted(line) and index == line.index(rank)


@pytest.mark.parametrize("mesh_kw,axes,positions,want", [
    ({"pipe_parallel_size": 4}, ("pipe", ), (0, 3), {0: [0, 3], 3: [0, 3]}),
    ({"pipe_parallel_size": 4}, ("pipe", ), (0, 1, 2, 3), {r: [0, 1, 2, 3] for r in range(4)}),
    ({"pipe_parallel_size": 2}, ("pipe", ), (1, ), {2: [2], 3: [3]}),
    ({"pipe_parallel_size": 2}, ("pipe", "data"), (0, 3), {0: [0, 3], 3: [0, 3]})], ids=str)
def test_mesh_subgroups_are_positions_of_each_slice(gangs, mesh_kw, axes, positions, want):
    """``RankMesh.subgroup`` (the pipeline's tied-layer groups): each
    slice's members at ``positions``, one process group each; a member's
    all-reduce sums over exactly those ranks, and the other ranks get
    None."""
    for rank, out in gangs[4].run(sc.mesh_subgroup, mesh_kw, axes, positions):
        if rank not in want:
            assert out is None, rank
            continue
        ranks, index, total = out
        assert ranks == want[rank] and index == ranks.index(rank)
        assert total == sum(r + 1 for r in ranks)


def test_topology_errors_match_the_reference():
    """The reference's TopologyError cases, in a world of one process."""
    from deepspeed_tpu_torch.runtime.pipe.topology import PipeModelDataParallelTopology, PipelineParallelGrid
    with pytest.raises(groups.TopologyError, match="not divisible by mp"):
        groups.initialize_mesh(model_parallel_size=2, force=True)
    with pytest.raises(groups.TopologyError, match="secondary partition"):
        groups.initialize_mesh(data_parallel_size=1, secondary_partition_size=2, force=True)
    with pytest.raises(groups.TopologyError, match="!= device count"):
        groups.initialize_mesh(data_parallel_size=2, force=True)
    mesh = groups.initialize_mesh(force=True)
    assert mesh.size == 1 and groups.get_data_parallel_world_size() == 1
    assert groups.get_zero_partition_axes() == ("data", "hpz", "expert", "seq")
    groups.destroy_mesh()
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    assert topo.get_axis_comm_lists("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert PipelineParallelGrid().get_data_parallel_world_size() == 1


# ------------------------------------------------------------------ barrier --
def test_monitored_barrier_over_a_gang_passes_and_names_an_absent_rank(gangs):
    assert gangs[2].run(sc.barrier_all, "all") == ["passed", "passed"]
    res = gangs[4].run(sc.barrier_with_absent, 2, 1.0, "absent")
    assert res[2] is None
    for r in (0, 1, 3):
        assert "absent ranks [2]" in res[r], res[r]


def test_file_barrier_rendezvous_all_ranks(tmp_path):
    """N threads playing N ranks all arrive: every one passes, and
    consecutive barriers advance the generation."""
    errors = []

    def rank(r, gen):
        try:
            _file_barrier(str(tmp_path), "b", gen, r, 3, timeout_s=5.0)
        except Exception as e:
            errors.append(e)

    for gen in range(3):
        threads = [threading.Thread(target=rank, args=(r, gen)) for r in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors


def test_file_barrier_rejects_previous_jobs_stale_files(tmp_path):
    stale = tmp_path / "b.g0.rank1"
    stale.write_text(json.dumps({"rank": 1, "unix": time.time() - 3600}))
    with pytest.raises(BarrierTimeoutError, match=r"absent ranks \[1\]"):
        _file_barrier(str(tmp_path), "b", 0, 0, 2, timeout_s=0.3, min_unix=time.time() - 60)
    fresh = tmp_path / "c.g0.rank1"
    fresh.write_text(json.dumps({"rank": 1, "unix": time.time()}))
    _file_barrier(str(tmp_path), "c", 0, 0, 2, timeout_s=2.0, min_unix=time.time() - 60)


def test_file_barrier_timeout_names_absent_ranks_and_counts(tmp_path):
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.telemetry import TelemetryConfig
    with pytest.raises(BarrierTimeoutError, match=r"absent ranks \[1, 2\]"):
        _file_barrier(str(tmp_path), "t", 0, 0, 3, timeout_s=0.3)
    telemetry.configure(TelemetryConfig(enabled=True))
    try:
        with pytest.raises(BarrierTimeoutError):
            _file_barrier(str(tmp_path), "m", 0, 0, 2, timeout_s=0.1)
        assert telemetry.get_registry().counter("barrier_timeouts_total").value == 1
    finally:
        telemetry.shutdown()
        telemetry.state.registry = None


def test_monitored_barrier_single_process_passes():
    dist.monitored_barrier(timeout=0.5)


# -------------------------------------------------------------- the surface --
def test_p2p_raises_as_the_reference():
    """The reference has no point-to-point (SPMD: ``ppermute`` instead) and
    raises; the port's send/recv/isend/irecv are the pipeline engine's
    neighbour exchange: without a process group they raise, over a gang
    they move the tensors (blocking and not)."""
    for call in (lambda: jdist.send(np.zeros(4), dst=1), lambda: jdist.recv(np.zeros(4), src=0)):
        with pytest.raises(NotImplementedError, match="ppermute"):
            call()
    for call in (lambda: dist.send(torch.zeros(4), dst=1), lambda: dist.recv(torch.zeros(4), src=0),
                 lambda: dist.isend(torch.zeros(4), dst=1), lambda: dist.irecv(torch.zeros(4), src=0)):
        with pytest.raises(RuntimeError, match="process group"):
            call()


def test_p2p_moves_tensors_between_ranks(gangs):
    """Over a gang of 2: a blocking exchange (rank 0 sends, rank 1 receives
    and answers) and a non-blocking one in both directions at once, each
    bit for bit, in f32, int64 and bf16."""
    res = gangs[2].run(sc.p2p_exchange)
    for rank, got in enumerate(res):
        peer = 1 - rank
        for dtype, blocking, nonblocking in got:
            np.testing.assert_array_equal(nonblocking, sc.p2p_payload(peer, dtype))
            if rank == 1:
                np.testing.assert_array_equal(blocking, sc.p2p_payload(0, dtype))
            else:
                np.testing.assert_array_equal(blocking, sc.p2p_payload(1, dtype) * 2)


def test_comms_logger_records_over_a_gang(gangs):
    for summary in gangs[2].run(sc.comms_log):
        assert "all_reduce" in summary and "all_gather_into_tensor" in summary


def test_group_and_capability_surface(gangs):
    """The reference's surface at world one, and the ranks' view of it."""
    assert dist.get_world_group() is None
    assert dist.new_group() is None
    assert dist.new_group(list(range(dist.get_world_size()))) is None
    with pytest.raises(NotImplementedError):
        dist.new_group([0, 2])
    with pytest.raises(NotImplementedError):
        dist.get_global_rank("model", 1)
    assert dist.get_global_rank(None, 3) == 3
    assert dist.is_available()
    assert dist.has_all_gather_into_tensor() and dist.has_reduce_scatter_tensor()
    assert dist.has_all_reduce_coalesced() and not dist.has_coalescing_manager()
    assert not dist.in_aml() and not dist.in_aws_sm() and not dist.in_dlts()
    assert gangs[4].run(sc.rank_info) == [(r, 4, "gloo") for r in range(4)]
    outs = dist.all_reduce_coalesced([torch.ones(2), 2 * torch.ones(2)])
    assert torch.equal(outs[1], 2 * outs[0])


def test_init_distributed_reads_the_env_contract_and_picks_the_backend(monkeypatch):
    """``DSTPU_*`` (or torch's names, or OpenMPI's) name the gang;
    ``dist_backend`` None takes the device's backend: gloo for the CPU, and
    for the default (cuda) device without a GPU a refusal, never a silent
    switch to gloo."""
    from deepspeed_tpu_torch.comm import comm as cm
    for k in ("DSTPU_COORDINATOR", "COORDINATOR_ADDRESS", "DSTPU_NUM_PROCESSES", "WORLD_SIZE", "DSTPU_PROCESS_ID",
              "RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DSTPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DSTPU_NUM_PROCESSES", "8")
    monkeypatch.setenv("DSTPU_PROCESS_ID", "5")
    assert cm._env_contract(True, 29500) == ("10.0.0.1:1234", 8, 5)
    for k in ("DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES", "DSTPU_PROCESS_ID"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert cm._env_contract(True, 29500) == (None, 4, 3)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.9")
    assert cm._env_contract(True, 29600) == ("10.0.0.9:29600", 2, 1)
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
    monkeypatch.setattr(cm, "cdb", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_distributed()
    backend = dist.init_distributed(device="cpu")
    assert backend.name == "gloo" and not backend.process_group_initialized and dist.get_world_size() == 1


def test_accelerator_surface(monkeypatch):
    """The accelerator names its device and its collective backend (nccl on
    the card, gloo on the host), and ``DS_ACCELERATOR`` chooses it."""
    from deepspeed_tpu_torch.accelerator import real_accelerator as ra
    from deepspeed_tpu_torch.accelerator.cpu_accelerator import CPU_Accelerator
    from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator
    assert CUDA_Accelerator().communication_backend_name() == "nccl"
    assert CUDA_Accelerator().device_name(1) == "cuda:1"
    cpu = CPU_Accelerator()
    assert (cpu.device_name(), cpu.communication_backend_name(), cpu.device_count()) == ("cpu", "gloo", 1)
    assert cpu.total_memory() >= cpu.available_memory() > 0
    t = cpu.FloatTensor(2, 3)
    assert t.shape == (2, 3) and t.dtype == torch.float32 and cpu.on_accelerator(t)
    assert torch.equal(cpu.IntTensor([1, 2]), torch.tensor([1, 2], dtype=torch.int32))
    e0, e1 = cpu.Event(enable_timing=True), cpu.Event(enable_timing=True)
    e0.record()
    e1.record()
    assert e0.elapsed_time(e1) >= 0
    monkeypatch.setattr(ra, "ds_accelerator", None)
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    assert isinstance(ra.get_accelerator(), CPU_Accelerator)
    monkeypatch.setattr(ra, "ds_accelerator", None)
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    with pytest.raises(ValueError, match="accelerator must be one of"):
        ra.get_accelerator()
    monkeypatch.setattr(ra, "ds_accelerator", None)
    monkeypatch.delenv("DS_ACCELERATOR")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ra.get_accelerator().communication_backend_name() == "gloo"


_EXIT_SCRIPT = r"""
import atexit, os, sys
import torch
import torch.distributed as tdist
# registered before the port's hook, so it runs after it (atexit is LIFO)
atexit.register(lambda: print(f"at_exit_initialized={tdist.is_initialized()}", flush=True))
from deepspeed_tpu_torch import comm
comm.init_distributed(dist_backend="gloo", verbose=False)
t = torch.ones(3)
comm.all_reduce(t)
print(f"sum={t.tolist()}", flush=True)
"""


def test_c12_the_process_group_is_torn_down_at_exit(tmp_path):
    """C12: the reference's ``jax.distributed`` client is shut down at
    interpreter exit (jax's ``atexit`` clean-up); the port destroys its
    process group the same way, so a gloo group is never left to the
    interpreter's teardown (which aborted ranks that had finished: exit -6,
    "terminate called without an active exception"). Two ranks of a gang
    run a collective and exit: both exit 0, with no group alive after the
    port's hook."""
    import os
    import socket
    import subprocess
    import sys
    script = tmp_path / "exit.py"
    script.write_text(_EXIT_SCRIPT)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=repo, DSTPU_COORDINATOR=f"127.0.0.1:{port}", DSTPU_NUM_PROCESSES="2",
                   DSTPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        assert "sum=[2.0, 2.0, 2.0]" in out and "at_exit_initialized=False" in out, out
