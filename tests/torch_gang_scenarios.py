"""Scenarios the gloo gangs of ``tests/torch_gang.py`` run, one call a
rank. They import torch and the port only (the workers never load jax);
inputs and results are numpy arrays and plain values, so the tests hold them
against the JAX package in the test process."""

import numpy as np
import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm import ReduceOp
from deepspeed_tpu_torch.utils import groups


def rank_info():
    return dist.get_rank(), dist.get_world_size(), dist.get_backend_name()


def _tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def p2p_payload(rank, dtype):
    """What rank ``rank`` sends in ``p2p_exchange`` (as f32 numpy)."""
    return (np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * rank).astype(np.float32)


def p2p_exchange():
    """Rank 0 sends, rank 1 receives and sends back twice the payload it
    was given, blocking; then both post ``irecv`` and ``isend`` at once. The
    results as f32 numpy, for f32, int64 and bf16 tensors."""
    rank = dist.get_rank()
    peer = 1 - rank
    out = []
    for dtype in (torch.float32, torch.int64, torch.bfloat16):
        mine = torch.from_numpy(p2p_payload(rank, dtype)).to(dtype)
        buf = torch.zeros_like(mine)
        if rank == 0:
            dist.send(mine, dst=1)
            dist.recv(buf, src=1)
        else:
            dist.recv(buf, src=0)
            dist.send(torch.from_numpy(p2p_payload(1, dtype) * 2).to(dtype), dst=0)
        blocking = buf.float().numpy()
        got = torch.zeros_like(mine)
        works = [dist.irecv(got, src=peer), dist.isend(mine, dst=peer)]
        for w in works:
            w.wait()
        out.append((str(dtype), blocking, got.float().numpy()))
    return out


def comm_ops(mesh_kw, group, cases):
    """Each case ``(op, kwargs, x)`` on this rank's ``x[i]``, ``i`` its index
    in ``group`` over the mesh ``mesh_kw``; the results as numpy."""
    groups.initialize_mesh(force=True, **mesh_kw)
    g = groups.get_group(group if isinstance(group, tuple) else (group, )) if group is not None else \
        groups.get_group(groups.get_data_parallel_axes())
    out = []
    for op, kw, x in cases:
        kw = dict(kw)
        if "op" in kw:
            kw["op"] = ReduceOp[kw["op"]]
        res = getattr(dist, op)(_tensor(x[g.rank]).clone(), group=group, **kw)
        out.append(res.numpy())
    groups.destroy_mesh()
    return g.rank, out


def _llama_engine(cfg_fields, state, ds_config):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    groups.destroy_mesh()
    cfg = LlamaConfig(dtype=torch.float32, **cfg_fields)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(cfg), config=ds_config,
                                                     model_parameters={k: _tensor(v) for k, v in state.items()},
                                                     device="cpu")
    return engine


def train_llama(cfg_fields, state, ds_config, batches):
    """``train_batch`` on each global batch; per-step losses and norms, the
    whole masters, this rank's part of them and of the optimizer state, and
    the bytes it holds."""
    engine = _llama_engine(cfg_fields, state, ds_config)
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(batch=tuple(_tensor(x) for x in b))))
        norms.append(engine.get_global_grad_norm())
    full = {k: v.numpy() for k, v in engine.full_params().items()}
    local = {k: v.detach().numpy() for k, v in engine.params.items()}
    opt = {f"{f}/{n}": t.detach().numpy() for f, v in engine.opt_state._asdict().items() if isinstance(v, dict)
           for n, t in v.items()}
    out = dict(losses=losses, norms=norms, full=full, local=local, opt=opt, bytes=engine.state_bytes(),
               param_dim=dict(engine._zero.param_dim), opt_dim=dict(engine._zero.opt_dim), rank=engine.dp_rank,
               lr=engine.get_lr()[0])
    engine.destroy()
    groups.destroy_mesh()
    return out


def stage3_memory(cfg_fields, state, ds_config, batches):
    """After training at the config's stage: how many elements the module's
    own parameters hold (the units release them), and the state bytes."""
    engine = _llama_engine(cfg_fields, state, ds_config)
    for b in batches:
        engine.train_batch(batch=tuple(_tensor(x) for x in b))
    held = sum(p.numel() for p in engine.module.parameters())
    out = dict(held=held, bytes=engine.state_bytes(), units=len(engine._zero.units))
    engine.destroy()
    groups.destroy_mesh()
    return out


def accessors(cfg_fields, state, ds_config, batches, name):
    """The tensor_fragment accessors on one parameter, across the ranks."""
    from deepspeed_tpu_torch.runtime.zero import GatheredParameters
    from deepspeed_tpu_torch.utils import tensor_fragment as tf
    engine = _llama_engine(cfg_fields, state, ds_config)
    b = tuple(_tensor(x) for x in batches[0])
    engine.train_batch(batch=b)
    out = {"full": tf.safe_get_full_fp32_param(engine, name), "local": tf.safe_get_local_fp32_param(engine, name),
           "exp_avg": tf.safe_get_full_optimizer_state(engine, name, "exp_avg"),
           "grad_outside": tf.safe_get_full_grad(engine, name)}
    # inside an accumulation window: the micro API over the global micro-batch
    engine.forward(tuple(x[:len(x) // engine.gradient_accumulation_steps()] for x in b))
    engine.backward()
    out["grad_inside"] = tf.safe_get_full_grad(engine, name)
    engine.zero_grad()
    new = out["full"] * 0.5
    tf.safe_set_full_fp32_param(engine, name, new)
    out["after_set"] = tf.safe_get_full_fp32_param(engine, name)
    tf.safe_set_full_optimizer_state(engine, name, np.ones_like(new), "exp_avg")
    out["exp_avg_after_set"] = tf.safe_get_full_optimizer_state(engine, name, "exp_avg")
    with GatheredParameters(engine) as g:
        out["gathered"] = g.params[name].numpy()
        g.params[name] = g.params[name] * 2
        g.update(engine)
    out["after_update"] = tf.safe_get_full_fp32_param(engine, name)
    engine.destroy()
    groups.destroy_mesh()
    return out


def save_after_training(cfg_fields, state, ds_config, batches, save_dir, tag=None):
    """Train, save (a gang commit over the ranks), and return the whole
    masters and optimizer first moments the save holds."""
    engine = _llama_engine(cfg_fields, state, ds_config)
    for b in batches:
        engine.train_batch(batch=tuple(_tensor(x) for x in b))
    engine.save_checkpoint(save_dir, tag=tag)
    full = {k: v.numpy() for k, v in engine.full_params().items()}
    z = engine._zero
    moments = {n: z.gather(t, z.opt_dim[n]).numpy() for n, t in engine.opt_state.exp_avg.items()}
    out = dict(full=full, exp_avg=moments, steps=engine.global_steps)
    engine.destroy()
    groups.destroy_mesh()
    return out


def load_and_report(cfg_fields, state, ds_config, load_dir, batches=(), save_dir=None):
    """Load the newest good checkpoint at this world size: this rank's part
    and the whole masters, then train on ``batches`` (saving after, into
    ``save_dir``, when given) and report them again."""
    engine = _llama_engine(cfg_fields, state, ds_config)
    path, _ = engine.load_checkpoint(load_dir)
    z = engine._zero
    out = dict(path=path, steps=engine.global_steps, local={k: v.numpy() for k, v in engine.params.items()},
               full={k: v.numpy() for k, v in engine.full_params().items()},
               exp_avg={n: z.gather(t, z.opt_dim[n]).numpy() for n, t in engine.opt_state.exp_avg.items()},
               param_dim=dict(z.param_dim), rank=engine.dp_rank)
    losses = [float(engine.train_batch(batch=tuple(_tensor(x) for x in b))) for b in batches]
    if save_dir is not None:
        engine.save_checkpoint(save_dir)
    out["losses"] = losses
    out["after"] = {k: v.numpy() for k, v in engine.full_params().items()}
    engine.destroy()
    groups.destroy_mesh()
    return out


def batch_triangle(ds_config):
    """The config's batch triangle at this world size, or its error."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    groups.destroy_mesh()
    try:
        c = DeepSpeedConfig(ds_config)
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu, c.gradient_accumulation_steps)
    except AssertionError as e:
        return f"AssertionError: {e}"


def tag_validation(cfg_fields, state, mode, save_dir):
    """Each rank saves under its own tag with ``checkpoint.tag_validation``
    set to ``mode``; the outcome on this rank."""
    import logging
    from deepspeed_tpu_torch.utils.logging import logger
    engine = _llama_engine(cfg_fields, state, {"train_batch_size": 2 * dist.get_world_size(),
                                               "checkpoint": {"tag_validation": mode},
                                               "optimizer": {"type": "SGD", "params": {"lr": 0.1}}})
    records = []

    class Grab(logging.Handler):

        def emit(self, record):
            records.append(record.getMessage())

    h = Grab()
    logger.addHandler(h)
    try:
        engine._checkpoint_tag_validation(f"tag-of-rank-{dist.get_rank()}")
        outcome = "ok"
    except RuntimeError as e:
        outcome = f"raised: {e}"
    finally:
        logger.removeHandler(h)
    engine.destroy()
    groups.destroy_mesh()
    return outcome, [m for m in records if "not consistent" in m]


def micro_api(cfg_fields, state, ds_config, batches):
    """The micro-step API over global micro-batches, and eval's global
    loss; returns the masters and the eval losses."""
    engine = _llama_engine(cfg_fields, state, ds_config)
    gas = engine.gradient_accumulation_steps()
    for b in batches:
        mb = len(b[0]) // gas
        for i in range(gas):
            engine.forward(tuple(_tensor(x[i * mb:(i + 1) * mb]) for x in b))
            engine.backward()
            engine.step()
    engine.eval()
    evals = [float(engine.forward(tuple(_tensor(x) for x in b))) for b in batches]
    out = dict(full={k: v.numpy() for k, v in engine.full_params().items()}, evals=evals,
               io_batch=engine.deepspeed_io(list(range(64))).batch_size)
    engine.destroy()
    groups.destroy_mesh()
    return out


def group_membership(mesh_kw):
    """For each mesh axis: this rank's group along it (the registry's
    ranks, and the ranks of the process group the collectives use)."""
    import torch.distributed as tdist
    groups.initialize_mesh(force=True, **mesh_kw)
    out = {}
    for ax in groups.MESH_AXES:
        g = groups.get_group(ax)
        if g.pg is not None:
            pg_ranks = tdist.get_process_group_ranks(g.pg)
        elif g.size == dist.get_world_size():
            pg_ranks = list(range(dist.get_world_size()))
        else:
            pg_ranks = [dist.get_rank()]
        out[ax] = (g.ranks, pg_ranks, g.rank)
    groups.destroy_mesh()
    return dist.get_rank(), out


def mesh_subgroup(mesh_kw, axes, positions):
    """This rank's group of the members at ``positions`` of each slice along
    ``axes`` (``RankMesh.subgroup``): its ranks, this rank's index and the
    sum over it of rank + 1 (None where this rank is not a member)."""
    mesh = groups.initialize_mesh(force=True, **mesh_kw)
    g = mesh.subgroup(axes, positions)
    out = None
    if g is not None:
        total = dist.all_reduce(torch.tensor([float(dist.get_rank() + 1)]), group=g)
        out = (g.ranks, g.rank, float(total[0]))
    groups.destroy_mesh()
    return dist.get_rank(), out


def barrier_with_absent(absent, timeout_s, name):
    """``monitored_barrier`` that rank ``absent`` never enters: the others'
    errors (naming the absent rank)."""
    if dist.get_rank() == absent:
        return None
    try:
        dist.monitored_barrier(timeout=timeout_s, name=name)
        return "passed"
    except dist.BarrierTimeoutError as e:
        return str(e)


def barrier_all(name):
    dist.monitored_barrier(timeout=30.0, name=name)
    return "passed"


def comms_log():
    """One all_reduce and one all_gather with the comms logger on; the
    summary."""
    dist.configure(enabled=True)
    try:
        dist.all_reduce(torch.ones(4))
        dist.all_gather_into_tensor(torch.ones(2))
        return dist.comm.comms_logger.log_all(print_log=False)
    finally:
        dist.configure(enabled=False)
        dist.comm.comms_logger.comms_dict.clear()


def cuda_collectives(host=True):
    """The collectives on CUDA tensors and (``host``; NCCL takes CUDA
    tensors only) on the same values on the host, this rank's tensor
    ``x[rank]``, with the host copies the comm layer made
    (``comms_logger.host_staged``) and this rank's input."""
    g = groups.world_group()
    G, r = g.size, g.rank
    rng = np.random.default_rng(0)
    x = rng.normal(size=(G, 4 * G, 3)).astype(np.float32)
    xi = rng.integers(-50, 50, size=(G, 4 * G, 3)).astype(np.int32)
    dist.comm.comms_logger.host_staged.clear()
    out = {}
    for name, data in (("f32", x), ("i32", xi)):
        out[(name, "input")] = data[r]
        for dev in ("cuda", "cpu") if host else ("cuda", ):
            t = torch.from_numpy(data[r]).to(dev)
            out[(name, dev)] = {
                "all_reduce": dist.all_reduce(t.clone()).cpu().numpy(),
                "all_gather_into_tensor": dist.all_gather_into_tensor(t).cpu().numpy(),
                "reduce_scatter_tensor": dist.reduce_scatter_tensor(t).cpu().numpy(),
                "all_to_all_single": dist.all_to_all_single(t).cpu().numpy(),
                "broadcast": dist.broadcast(t.clone(), src=G - 1).cpu().numpy()}
    staged = {op: list(v) for op, v in dist.comm.comms_logger.host_staged.items()}
    return out, staged, dist.get_backend_name()


class TiedLM(torch.nn.Module):
    """An embedding whose weight the output projection reuses: the
    projection reads a parameter another module owns, declared with
    ``register_external_parameter``."""

    def __init__(self, vocab=32, hidden=16):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, hidden)
        self.mix = torch.nn.Linear(hidden, hidden)
        self.out = _TiedHead(self.embed)

    def forward(self, batch):
        ids, labels = batch
        logits = self.out(torch.tanh(self.mix(self.embed(ids))))
        return torch.nn.functional.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1))


class _TiedHead(torch.nn.Module):

    def __init__(self, embed):
        super().__init__()
        self.__dict__["embed"] = embed  # not a submodule: its weight is another module's
        self.bias = torch.nn.Parameter(torch.zeros(embed.num_embeddings))

    def forward(self, h):
        return h @ self.embed.weight.t() + self.bias


def train_tied(stage, batches):
    """The tied model at ``stage`` over the gang, its external parameter
    registered; the whole masters after the steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.zero import register_external_parameter
    groups.destroy_mesh()
    torch.manual_seed(0)
    model = TiedLM()
    register_external_parameter(model.out, model.embed.weight)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
                "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}})
    losses = [float(engine.train_batch(batch=tuple(_tensor(x) for x in b))) for b in batches]
    out = dict(losses=losses, full={k: v.numpy() for k, v in engine.full_params().items()},
               units=len(engine._zero.units))
    engine.destroy()
    groups.destroy_mesh()
    return out


class _MLP(torch.nn.Module):
    """A regression MLP on float inputs (a NaN in a row reaches its loss)."""

    def __init__(self, hidden=16):
        super().__init__()
        torch.manual_seed(0)
        self.layers = torch.nn.ModuleList(torch.nn.Linear(hidden, hidden) for _ in range(2))
        self.head = torch.nn.Linear(hidden, 1)

    def forward(self, batch):
        x, y = batch
        for layer in self.layers:
            x = torch.relu(layer(x))
        return ((self.head(x).squeeze(-1) - y)**2).mean()


def nan_on_one_rank(stage, poisoned_rank):
    """A step whose NaN lies only in ``poisoned_rank``'s rows, with the
    anomaly sentinel's finite gate armed: every rank skips it (the gate is
    the gang's), so the masters stay as they were; the next step applies."""
    import deepspeed_tpu_torch
    groups.destroy_mesh()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_MLP(), device="cpu",
        config={"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
                "anomaly_sentinel": {"enabled": True},
                "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}})
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    y = x[:, 0].copy()
    before = {k: v.numpy() for k, v in engine.full_params().items()}
    bad = x.copy()
    rows = 8 // dist.get_world_size()
    bad[poisoned_rank * rows] = np.nan
    engine.train_batch(batch=(_tensor(bad), _tensor(y)))
    skipped = (engine.skipped_steps, not engine.was_step_applied())
    unchanged = all(np.array_equal(v, before[k]) for k, v in engine.full_params().items())
    engine.train_batch(batch=(_tensor(x), _tensor(y)))
    moved = any(not np.array_equal(v.numpy(), before[k]) for k, v in engine.full_params().items())
    engine.destroy()
    groups.destroy_mesh()
    return skipped, unchanged, moved


def curvature(stage, batch):
    """``loss_curvature`` after a forward of the global batch: the raw
    top eigenvalue of each block (every rank's)."""
    import deepspeed_tpu_torch
    groups.destroy_mesh()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_MLP(), device="cpu",
        config={"train_batch_size": 8, "optimizer": {"type": "SGD", "params": {"lr": 1e-2}},
                "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}})
    engine.forward(tuple(_tensor(x) for x in batch))
    engine.loss_curvature()
    raw = dict(engine._eig_state[0].last_raw)
    engine.destroy()
    groups.destroy_mesh()
    return raw


# ------------------------------------------------- offload and ZeRO++ (A8) --
def train_llama_plus(cfg_fields, state, ds_config, batches):
    """``train_llama`` for the offload and ZeRO++ configurations: the same
    results (the optimizer state swapped in where it rests on disk) plus
    where the state rests, the offload and qwZ counters, and the comms
    logger's bytes by op."""
    from deepspeed_tpu_torch.comm import comm as comm_mod
    engine = _llama_engine(cfg_fields, state, ds_config)
    comm_mod.comms_logger.comms_dict.clear()
    dist.configure(enabled=True, prof_all=True)  # after the engine's own configure
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(batch=tuple(_tensor(x) for x in b))))
        norms.append(engine.get_global_grad_norm())
    dist.configure(enabled=False)
    comm_bytes = {op: sum(size * vals[0] for size, vals in sizes.items())
                  for op, sizes in comm_mod.comms_logger.comms_dict.items()}
    opt_state = engine._offload.checkpoint_view(engine.opt_state)
    rest = engine._offload.resting_bytes(engine.opt_state)
    z = engine._zero
    out = dict(losses=losses, norms=norms, full={k: v.numpy() for k, v in engine.full_params().items()},
               local={k: v.detach().numpy() for k, v in engine.params.items()},
               opt={f"{f}/{n}": t.detach().numpy() for f, v in opt_state._asdict().items() if isinstance(v, dict)
                    for n, t in v.items()},
               bytes=engine.state_bytes(), rest=rest, param_dim=dict(z.param_dim), opt_dim=dict(z.opt_dim),
               param_group=list(z.pgroup.ranks) if z.pdegree > 1 else [dist.get_rank()],
               zero_group=list(z.group.ranks) if z.degree > 1 else [dist.get_rank()], rank=dist.get_rank(),
               qwz_gathers=z.qwz.gathers if z.qwz is not None else 0, qgz=engine._qgz is not None,
               cpu_offload=engine.zero_cpu_offload(), nvme=engine.zero_has_nvme_offload(), comm_bytes=comm_bytes,
               host_compute=engine._offload.host_compute)
    engine.destroy()
    groups.destroy_mesh()
    return out


def quantized_reduce_scatter_case(xs, block):
    """This rank's ``quantized_reduce_scatter`` of ``xs[rank]``."""
    from deepspeed_tpu_torch.runtime.comm.compressed import quantized_reduce_scatter
    return quantized_reduce_scatter(_tensor(xs[dist.get_rank()]), block=block).numpy()


def compressed_allreduce_case(x, worker_errors, server_errors, rounds):
    """``rounds`` calls of the 1-bit all-reduce of the same ``x`` on every
    rank, each rank with its own error feedback; the last output and the
    errors."""
    from deepspeed_tpu_torch.runtime.comm.compressed import compressed_allreduce
    r = dist.get_rank()
    we, se = _tensor(worker_errors[r]).clone(), _tensor(server_errors[r]).clone()
    for _ in range(rounds):
        out, we, se = compressed_allreduce(_tensor(x), we, se)
    return out.numpy(), we.numpy(), se.numpy()


# -------------------------------------------------------------- pipeline --
class InProj(torch.nn.Module):
    """The reference tests' ``InProj`` (flax ``Dense(HIDDEN)``)."""

    def __init__(self, d_in, hidden):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(d_in, hidden)

    def forward(self, x):
        return self.Dense_0(x)


class Block(torch.nn.Module):
    """``x + tanh(Dense(x))``."""

    def __init__(self, hidden):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(hidden, hidden)

    def forward(self, x):
        return x + torch.tanh(self.Dense_0(x))


class OutProj(torch.nn.Module):

    def __init__(self, hidden):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(hidden, 1)

    def forward(self, x):
        return self.Dense_0(x)


class TiedProj(torch.nn.Module):
    """A bias-free square weight used twice (in and, transposed, out)."""

    def __init__(self, hidden):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(hidden, hidden))

    def forward(self, x):
        return x @ self.w


class Middle(torch.nn.Module):

    def __init__(self, hidden):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(hidden, hidden))

    def forward(self, x):
        return torch.tanh(x @ self.w)


def mse(out, labels):
    return torch.mean((out.squeeze(-1) - labels)**2)


def mse_full(out, labels):
    return torch.mean((out - labels)**2)


def _unembed(module, x):
    return x @ module.w.t()


def pipeline_module(kind, stages, hidden, n_blocks=4):
    from deepspeed_tpu_torch.runtime.pipe import LayerSpec, PipelineModule, TiedLayerSpec
    if kind == "mlp":
        layers = [LayerSpec(InProj, hidden, hidden)] + [LayerSpec(Block, hidden) for _ in range(n_blocks)] + \
            [LayerSpec(OutProj, hidden)]
        return PipelineModule(layers=layers, num_stages=stages, loss_fn=mse)
    layers = [TiedLayerSpec("emb", TiedProj, hidden), LayerSpec(Middle, hidden),
              TiedLayerSpec("emb", TiedProj, hidden, forward_fn=_unembed)]
    return PipelineModule(layers=layers, num_stages=stages, loss_fn=mse_full)


def pipe_train(kind, stages, hidden, state, ds_config, batches, evaluate=False):
    """The port's ``PipelineEngine`` over this gang (one rank a stage):
    per-step losses and norms, this stage's masters, the send/recv counts,
    and (``evaluate``) an ``eval_batch`` of the first batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine, PipelineError
    groups.destroy_mesh()
    module = pipeline_module(kind, stages, hidden)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=module, config=ds_config, device="cpu",
                                                     model_parameters={k: _tensor(v) for k, v in state.items()})
    assert isinstance(engine, PipelineEngine)
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(batch=tuple(_tensor(x) for x in b))))
        norms.append(engine.get_global_grad_norm())
    raised = []
    for call in (lambda: engine.forward(batches[0]), engine.backward, engine.step):
        try:
            call()
        except PipelineError:
            raised.append(True)
    out = dict(losses=losses, norms=norms, params={k: v.detach().numpy() for k, v in engine.params.items()},
               stage=engine.stage_id, sends=engine._executor.sends, recvs=engine._executor.recvs, raised=raised,
               boundary=engine.is_gradient_accumulation_boundary())
    if evaluate:
        out["eval"] = float(engine.eval_batch(batch=tuple(_tensor(x) for x in batches[0])))
    engine.destroy()
    groups.destroy_mesh()
    return out


def cuda_p2p_exchange():
    """``p2p_exchange`` on CUDA tensors (gloo stages them through the host);
    the results and the host-staging tally."""
    from deepspeed_tpu_torch.comm import comm as comm_mod
    comm_mod.comms_logger.host_staged.clear()
    rank, peer = dist.get_rank(), 1 - dist.get_rank()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        mine = torch.from_numpy(p2p_payload(rank, dtype)).to("cuda", dtype)
        got = torch.zeros_like(mine)
        if rank == 0:
            dist.send(mine, dst=1)
            dist.recv(got, src=1)
        else:
            dist.recv(got, src=0)
            dist.send(mine, dst=0)
        nb = torch.zeros_like(mine)
        for w in [dist.irecv(nb, src=peer), dist.isend(mine, dst=peer)]:
            w.wait()
        out.append((got.float().cpu().numpy(), nb.float().cpu().numpy(), got.device.type))
    return out, {op: list(v) for op, v in comm_mod.comms_logger.host_staged.items()}
