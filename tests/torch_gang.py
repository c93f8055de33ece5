"""A gang of the port for the parity tests: N worker processes, one a rank,
that join one ``torch.distributed`` process group (gloo unless the test
names another backend) through
``deepspeed_tpu_torch.comm.init_distributed`` (the launcher's environment
contract) and then run scenarios sent to them, each a function of a module
that imports no jax.

A test module builds its gangs once (a module fixture) and sends every
scenario to the same workers, since each spawn imports torch. ``Gang.run``
sends one call to every rank and returns the ranks' results in rank order;
an exception on a rank is raised in the test with the rank's traceback, and
a call that does not come back within ``timeout`` kills the gang.
"""

import importlib
import multiprocessing as mp
import os
import socket
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, inbox, outbox, env, backend):
    os.environ.update(env)
    os.environ.update(DSTPU_COORDINATOR=f"127.0.0.1:{port}", DSTPU_NUM_PROCESSES=str(world),
                      DSTPU_PROCESS_ID=str(rank))
    import torch
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm
    try:
        comm.init_distributed(dist_backend=backend, verbose=False)
        outbox.put((rank, True, None))
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        return
    while True:
        msg = inbox.get()
        if msg is None:
            break
        module, fn, args = msg
        try:
            out = getattr(importlib.import_module(module), fn)(*args)
            outbox.put((rank, True, out))
        except BaseException:
            outbox.put((rank, False, traceback.format_exc()))
    comm.destroy_process_group()


class GangError(RuntimeError):
    pass


class Gang:

    def __init__(self, world, timeout=120.0, env=None, backend="gloo"):
        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout = timeout
        port = _free_port()
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        env = dict(env or {})
        env.setdefault("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        # one BLAS thread a rank (read when numpy loads, before the worker
        # imports it): ranks of several gangs share the cores
        env.setdefault("OPENBLAS_NUM_THREADS", "1")
        self.procs = [ctx.Process(target=_worker, args=(r, world, port, self.inboxes[r], self.outbox, env, backend),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self._collect("init_distributed")

    def _collect(self, what):
        import queue
        import time
        results = [None] * self.world
        errors = []
        deadline = time.monotonic() + self.timeout
        for _ in range(self.world):
            while True:
                try:
                    rank, ok, out = self.outbox.get(timeout=0.5)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close(kill=True)
                        why = f"rank(s) {dead} died" if dead else f"no answer within {self.timeout:.0f}s"
                        raise GangError(f"{what}: {why} (gang killed)")
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            raise GangError(f"{what} failed:\n" + "\n".join(errors))
        return results

    def run(self, fn, *args):
        """``fn(*args)`` on every rank (``fn`` a module-level function of a
        module the workers can import); the results in rank order."""
        for inbox in self.inboxes:
            inbox.put((fn.__module__, fn.__name__, args))
        return self._collect(fn.__name__)

    def close(self, kill=False):
        if not kill:
            for inbox in self.inboxes:
                inbox.put(None)
        for p in self.procs:
            p.join(timeout=30.0 if not kill else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
