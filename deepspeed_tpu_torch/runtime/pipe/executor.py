"""One pipeline stage walking its instruction stream.

Port of ``deepspeed_tpu/runtime/pipe/executor.py`` (``ScheduleExecutor``).
The reference simulates every stage in lock step inside one process, with a
mailbox a link; the port's :class:`StageExecutor` is one stage, one process,
and its sends and receives are ``comm``'s point-to-point calls to the
neighbouring stages. The streams pair every send with the neighbour's
receive at the same tick, and the two stages run a tick's instructions in
an order that matches (a forward tick sends its gradient before it
receives its activation; the backward tick upstream receives that gradient
before it sends the activation), so blocking calls cannot deadlock.

- ``LoadMicroBatch``: the first stage takes the micro-batch's inputs, the
  last its labels (the micro-batch is the tick's forward work).
- ``RecvActivation`` / ``SendActivation``: a small int64 header (dtype code
  and shape) goes before each activation, so the receiver allocates it.
- ``ForwardPass``: the stage's layers with autograd on; the last stage
  adds the loss.
- ``BackwardPass``: the gradients of the stage's output (the last stage:
  of ``loss * scale``) with respect to its parameters (at ZeRO 3 over
  several ranks: their chunks, reduce-scattered by the layers' units),
  accumulated in the engine's accumulation dtype, and to its input
  activation, kept for ``SendGrad``.
- ``ReduceTiedGrads``: the tied keys' gradients all-reduced over their
  holders; ``ReduceGrads``: nothing (the engine's step reduces over the
  data-parallel ranks); ``OptimizerStep``: the engine's step.
"""

import contextlib

import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import recompute_disabled
from deepspeed_tpu_torch.runtime.pipe import schedule as sched

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64, torch.int32]
_HEADER = 8  # dtype code, ndim, up to 6 dims


def _header(t):
    if t.ndim > _HEADER - 2:
        raise ValueError(f"a pipeline activation has at most {_HEADER - 2} dims, got {t.ndim}")
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0] = _DTYPES.index(t.dtype)
    h[1] = t.ndim
    h[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    return h


class StageExecutor:
    """Runs this process's stage of a pipeline engine (see the module doc)."""

    def __init__(self, engine):
        self.engine = engine
        self.sends = 0
        self.recvs = 0

    # -- point-to-point ---------------------------------------------------------
    def _send_activation(self, t):
        e = self.engine
        dist.send(_header(t), e.next_rank)
        dist.send(t.contiguous(), e.next_rank)
        self.sends += 2

    def _recv_activation(self):
        e = self.engine
        h = torch.zeros(_HEADER, dtype=torch.int64)
        dist.recv(h, e.prev_rank)
        shape = tuple(int(x) for x in h[2:2 + int(h[1])])
        t = torch.empty(shape, dtype=_DTYPES[int(h[0])], device=e.device)
        dist.recv(t, e.prev_rank)
        self.recvs += 2
        return t

    def _send_grad(self, g):
        dist.send(g.contiguous(), self.engine.prev_rank)
        self.sends += 1

    def _recv_grad(self, like):
        g = torch.empty_like(like)
        dist.recv(g, self.engine.next_rank)
        self.recvs += 1
        return g

    # -- the stage's work ---------------------------------------------------------
    def _forward(self, x, labels):
        e = self.engine
        # at ZeRO 3 the units recompute each layer for its backward, which
        # stands in for remat (as the base engine's forward)
        with recompute_disabled() if e._partition_params else contextlib.nullcontext():
            out = e.module(x)
        if e.is_last_stage:
            out = e.loss_fn(out, labels)
        return out

    def _backward(self, out, x, grad_out):
        """Parameter gradients into the engine's accumulation; the input
        activation's gradient (None on the first stage)."""
        e = self.engine
        names = list(e._module_params)
        leaves = e._zero.leaves if e._partition_params else {}
        wrt = [leaves.get(n, e._module_params[n]) for n in names]
        takes_x = x is not None and x.requires_grad
        if takes_x:
            wrt = [x] + wrt
        if grad_out is None:  # the last stage: the scaled loss
            out, grad_out = out.float() * e.scale_state.cur_scale, None
        grads = torch.autograd.grad(out, wrt, grad_outputs=grad_out, allow_unused=True, materialize_grads=True)
        dx = grads[0] if takes_x else None
        param_grads = grads[1:] if takes_x else grads
        e._accumulate_stage_grads({n: g.to(e._grad_accum_dtype) for n, g in zip(names, param_grads)})
        return dx

    def _input(self, t):
        """A received activation that the backward differentiates."""
        return t.requires_grad_(True) if t.is_floating_point() else t

    def train(self, stacked):
        """One ``TrainSchedule`` pass over ``stacked`` (``(inputs, labels)``,
        each ``[micro_batches, ...]``); returns the last stage's micro-batch
        losses (detached), in micro-batch order."""
        e = self.engine
        M, P, s = e._micro_batches, e._num_stages, e.stage_id
        schedule = sched.TrainSchedule(M, P, s)
        nbuf = schedule.num_pipe_buffers()
        inputs, labels = stacked[0], stacked[1] if len(stacked) > 1 else None
        act_in, outs, label_buf, dx = [None] * nbuf, [None] * nbuf, [None] * nbuf, [None] * nbuf
        grad_out = [None] * nbuf
        losses = {}
        e.acc_grads = None
        for tick, cmds in enumerate(schedule.steps()):
            _, mb = schedule.work_at(tick)
            for cmd in cmds:
                b = getattr(cmd, "buffer_id", None)
                if isinstance(cmd, sched.LoadMicroBatch):
                    if e.is_first_stage:
                        act_in[b] = inputs[mb]
                    if e.is_last_stage:
                        label_buf[b] = labels[mb] if labels is not None else None
                elif isinstance(cmd, sched.RecvActivation):
                    act_in[b] = self._input(self._recv_activation())
                elif isinstance(cmd, sched.ForwardPass):
                    outs[b] = self._forward(act_in[b], label_buf[b])
                    if e.is_last_stage:
                        losses[mb] = outs[b].detach().float()
                elif isinstance(cmd, sched.SendActivation):
                    self._send_activation(outs[b].detach())
                elif isinstance(cmd, sched.RecvGrad):
                    grad_out[b] = self._recv_grad(outs[b])
                elif isinstance(cmd, sched.BackwardPass):
                    x = act_in[b] if not e.is_first_stage else None
                    dx[b] = self._backward(outs[b], x, None if e.is_last_stage else grad_out[b])
                    act_in[b] = outs[b] = grad_out[b] = None
                elif isinstance(cmd, sched.SendGrad):
                    self._send_grad(dx[b])
                    dx[b] = None
                elif isinstance(cmd, sched.ReduceTiedGrads):
                    e.reduce_tied_grads()
                elif isinstance(cmd, sched.ReduceGrads):
                    pass  # the step reduces over the data-parallel ranks
                elif isinstance(cmd, sched.OptimizerStep):
                    e._pipeline_step()
        return [losses[m] for m in sorted(losses)]

    def evaluate(self, stacked):
        """One forward-only ``InferenceSchedule`` pass; the last stage's
        micro-batch losses."""
        e = self.engine
        M, P, s = e._micro_batches, e._num_stages, e.stage_id
        schedule = sched.InferenceSchedule(M, P, s)
        nbuf = schedule.num_pipe_buffers()
        inputs, labels = stacked[0], stacked[1] if len(stacked) > 1 else None
        act_in, outs, label_buf = [None] * nbuf, [None] * nbuf, [None] * nbuf
        losses = []
        for tick, cmds in enumerate(schedule.steps()):
            mb = tick - s
            for cmd in cmds:
                b = cmd.buffer_id
                if isinstance(cmd, sched.LoadMicroBatch):
                    if e.is_first_stage:
                        act_in[b] = inputs[mb]
                    if e.is_last_stage:
                        label_buf[b] = labels[mb] if labels is not None else None
                elif isinstance(cmd, sched.RecvActivation):
                    act_in[b] = self._recv_activation()
                elif isinstance(cmd, sched.ForwardPass):
                    outs[b] = self._forward(act_in[b], label_buf[b])
                    if e.is_last_stage:
                        losses.append(outs[b].float())
                elif isinstance(cmd, sched.SendActivation):
                    self._send_activation(outs[b])
        return losses
