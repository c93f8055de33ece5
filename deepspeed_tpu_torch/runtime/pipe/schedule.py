"""Pipeline schedules as instruction streams.

Port of ``deepspeed_tpu/runtime/pipe/schedule.py`` (``PipeSchedule``,
``TrainSchedule``, ``InferenceSchedule``, ``DataParallelSchedule`` and the
``PipeInstruction`` classes): host code, kept as its own copy, giving the
same instruction streams. The reference derives non-interleaved 1F1B over P
stages and M micro-batches from one tick equation: on a clock of
``T = 2 * (M + P - 1)`` ticks, stage ``s`` runs forward(f) at tick
``s + 2f`` and backward(b) at tick ``2 * (b + P) - s - 1``, so

    (t - s) even  ->  FORWARD  of  f = (t - s) // 2
    (t - s) odd   ->  BACKWARD of  b = (t + s + 1) // 2 - P

each only when the micro-batch lies in [0, M). A send on stage ``s`` at
tick ``t`` pairs with its neighbour's receive at the same tick: on a
backward tick a stage sends the activation of its previous (forward) tick
downstream, on a forward tick it sends the gradient of its previous
(backward) tick upstream.

The reference runs its pipeline as one compiled program and keeps these
streams as the semantic spec of its fallback executor; the port's
``PipelineEngine`` (one process a stage) walks them for real, with the
stage's ``send``/``recv`` in stream order (``runtime/pipe/executor.py``).
"""

from abc import ABC, abstractmethod

FORWARD = "forward"
BACKWARD = "backward"


class PipeSchedule(ABC):
    """Yields, per clock tick, the list of PipeInstructions for one stage."""

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @abstractmethod
    def steps(self):
        ...

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        self.it = None
        return self

    def __next__(self):
        if self.it is None:
            self.it = self.steps()
        return next(self.it)


class TrainSchedule(PipeSchedule):
    """1F1B instruction stream from the closed-form tick equation above."""

    def work_at(self, tick):
        """(direction, micro_batch_id) of this stage's compute slot at ``tick``.

        The microbatch may be outside [0, M) — warmup/drain ticks — in which
        case the slot is idle but the tick still has a well-defined direction.
        """
        if (tick - self.stage_id) % 2 == 0:
            return FORWARD, (tick - self.stage_id) // 2
        return BACKWARD, (tick + self.stage_id + 1) // 2 - self.stages

    def steps(self):
        total_ticks = 2 * (self.micro_batches + self.stages - 1)
        for tick in range(total_ticks):
            direction, mb = self.work_at(tick)
            cmds = []

            if direction == FORWARD:
                # Ship the gradient produced on the previous (backward) tick
                # upstream; the upstream stage recvs it on this same tick.
                if tick > 0 and self._valid_stage(self.prev_stage):
                    _, prev_b = self.work_at(tick - 1)
                    if self._valid_micro_batch(prev_b):
                        cmds.append(SendGrad(self._buffer_idx(prev_b)))
                if self._valid_micro_batch(mb):
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(self._buffer_idx(mb)))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(self._buffer_idx(mb)))
                    cmds.append(ForwardPass(self._buffer_idx(mb)))
            else:
                if self._valid_micro_batch(mb) and self._valid_stage(self.next_stage):
                    cmds.append(RecvGrad(self._buffer_idx(mb)))
                # Ship the activation produced on the previous (forward) tick
                # downstream; the downstream stage recvs it on this same tick.
                if tick > 0 and self._valid_stage(self.next_stage):
                    _, prev_f = self.work_at(tick - 1)
                    if self._valid_micro_batch(prev_f):
                        cmds.append(SendActivation(self._buffer_idx(prev_f)))
                if self._valid_micro_batch(mb):
                    cmds.append(BackwardPass(self._buffer_idx(mb)))

            if tick == total_ticks - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            yield cmds

    def num_pipe_buffers(self):
        """In-flight activations at stage s peak at the number of forwards that
        run before the first backward = min(P - s, M); floor of 2 so the
        send/compute double-buffering never aliases."""
        return max(2, min(self.stages - self.stage_id, self.micro_batches))


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining: microbatch f hits stage s at tick s + f.

    The activation computed at tick t is sent at tick t+1, pairing with the
    downstream stage's RecvActivation at that same tick (downstream forwards mb
    at tick s+1+mb) — the same same-tick send/recv invariant as TrainSchedule.
    """

    def steps(self):
        for tick in range(self.micro_batches + self.stages - 1):
            mb = tick - self.stage_id
            cmds = []
            prev_mb = mb - 1
            if self._valid_micro_batch(prev_mb) and self._valid_stage(self.next_stage):
                cmds.append(SendActivation(self._buffer_idx(prev_mb)))
            if self._valid_micro_batch(mb):
                if self.is_first_stage or self.is_last_stage:
                    cmds.append(LoadMicroBatch(self._buffer_idx(mb)))
                if self._valid_stage(self.prev_stage):
                    cmds.append(RecvActivation(self._buffer_idx(mb)))
                cmds.append(ForwardPass(self._buffer_idx(mb)))
            yield cmds

    def num_pipe_buffers(self):
        return 2


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (pure gradient accumulation)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


class PipeInstruction:

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        return f"{self.name}({', '.join(f'{k}={v!r}' for k, v in self.kwargs.items())})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    ...


class ReduceGrads(PipeInstruction):
    ...


class ReduceTiedGrads(PipeInstruction):
    ...


class BufferOpInstruction(PipeInstruction):

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    ...


class ForwardPass(BufferOpInstruction):
    ...


class BackwardPass(BufferOpInstruction):
    ...


class SendActivation(BufferOpInstruction):
    ...


class RecvActivation(BufferOpInstruction):
    ...


class SendGrad(BufferOpInstruction):
    ...


class RecvGrad(BufferOpInstruction):
    ...
