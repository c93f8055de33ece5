"""Data loading.

Port of ``deepspeed_tpu/runtime/dataloader.py`` (reference
``deepspeed/runtime/dataloader.py``): ``DeepSpeedDataLoader`` yields batches
of host numpy arrays collated from a map-style dataset (optionally shuffled
per epoch from a numpy seed) and ``RepeatingLoader`` restarts an iterator
when it runs out. The engine moves each batch to its device.

``PrefetchingLoader`` is the reference's pinned-memory prefetch worker: a
background thread runs collation, the ``[gas, micro, ...]`` stacking and the
host-to-device copy (``engine.stage_train_batch``) ``depth`` batches ahead.
On a CUDA device the copy leaves pinned host memory on a stream of its own
and records an event there; ``train_batch`` makes its stream wait on that
event before it reads the batch (:meth:`StagedBatch.wait`).
"""

import queue
import threading

import numpy as np
import torch


class StagedBatch:
    """A device-resident batch, stacked ``[gas, micro, ...]`` per leaf, ready
    for ``train_batch``. ``event`` (CUDA only) marks the end of its copy on
    the staging stream."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event=None):
        self.tree = tree
        self.event = event

    def wait(self):
        """Order the current stream after the copy, and tell the caching
        allocator that the current stream uses the tensors (so their memory
        is not handed out again while it may still read them)."""
        if self.event is None:
            return self.tree
        stream = torch.cuda.current_stream(self.event.device)
        stream.wait_event(self.event)
        _tree_apply(lambda t: t.record_stream(stream) if isinstance(t, torch.Tensor) and t.is_cuda else None,
                    self.tree)
        self.event = None
        return self.tree


class FusedHostBatch:
    """A full global batch still on the host: prefetched but left unstaged,
    since curriculum truncation must happen at the step that consumes it."""

    __slots__ = ("tree", )

    def __init__(self, tree):
        self.tree = tree


class DeepSpeedDataLoader:

    def __init__(self, dataset, batch_size, shuffle=False, seed=0, collate_fn=None, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate_fn = collate_fn or _default_collate
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        for start in range(0, n - (self.batch_size - 1 if self.drop_last else 0), self.batch_size):
            yield self.collate_fn([self.dataset[int(i)] for i in idx[start:start + self.batch_size]])


class RepeatingLoader:
    """Wrap an iterable to restart it (advancing its epoch) when exhausted."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "_epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class _PrefetchEpoch:
    """One epoch's iterator: it owns its queue, stop event and worker thread,
    so a straggler that outlives ``close()`` can never feed a later epoch's
    queue, and ``for`` calling ``iter()`` on it again restarts nothing."""

    def __init__(self, loader, engine, depth):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # the curriculum's difficulty belongs to the step that CONSUMES a
        # batch; staged ``depth`` steps early it would be stale, so under
        # curriculum the worker hands back host batches and train_batch
        # stages them
        stage = engine.curriculum_scheduler is None
        self._thread = threading.Thread(target=self._worker, args=(loader, engine, stage, self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _worker(loader, engine, stage, q, stop):

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for batch in loader:
                if stop.is_set():
                    return
                item = engine.stage_train_batch(batch=batch) if stage else FusedHostBatch(batch)
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # surfaces at the consumer
            put(_Err(e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._q is None:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._thread.join()
            self._q = None
            raise StopIteration
        if isinstance(item, _Err):
            self._q = None
            raise item.exc
        return item

    def close(self):
        """Stop the worker and drop the batches in flight (safe mid-epoch)."""
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
        self._q = None


class PrefetchingLoader:
    """Iterate ``loader`` with staging moved to a background thread.

    ``loader`` yields global batches (``[gas * micro, ...]`` per leaf, what
    ``engine.train_batch(batch=...)`` takes). Each ``iter()`` starts a fresh
    epoch that yields :class:`StagedBatch` objects (or :class:`FusedHostBatch`
    under curriculum) for ``train_batch``. ``depth`` bounds the batches in
    flight (double buffering at 2).
    """

    def __init__(self, loader, engine, depth: int = 2):
        self.loader = loader
        self.engine = engine
        self.depth = max(1, depth)
        self._epoch = None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        self.close()
        self._epoch = _PrefetchEpoch(self.loader, self.engine, self.depth)
        return self._epoch

    def close(self):
        if self._epoch is not None:
            self._epoch.close()
            self._epoch = None


_END = object()


class _Err:

    def __init__(self, exc):
        self.exc = exc


def _tree_apply(fn, tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            _tree_apply(fn, x)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tree_apply(fn, x)
    else:
        fn(tree)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])
