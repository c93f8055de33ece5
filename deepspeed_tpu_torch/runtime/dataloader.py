"""Data loading.

Port of ``deepspeed_tpu/runtime/dataloader.py`` (reference
``deepspeed/runtime/dataloader.py``): ``DeepSpeedDataLoader`` yields batches
of host numpy arrays collated from a map-style dataset (optionally shuffled
per epoch from a numpy seed) and ``RepeatingLoader`` restarts an iterator
when it runs out. The engine moves each batch to its device. The prefetching
loader of the JAX package belongs to a later slice.
"""

import numpy as np


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


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])
