"""Offline metric indexing over a corpus (the data-efficiency analysis tier).

Port of ``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_analyzer.py``
(numpy; the files it writes are the JAX package's, byte for byte).
Reference: ``deepspeed/runtime/data_pipeline/data_sampling/data_analyzer.py:20``
(DataAnalyzer — map workers compute per-sample metric values, reduce merges
them into ``sample_to_metric`` / ``metric_to_sample`` index files the
curriculum sampler consumes at train time).

Formulation: the map phase is host-parallel (thread pool over dataset
shards — metric fns are numpy; the reference's multi-process launcher
collapses to threads since there is no per-GPU affinity to respect), the
reduce phase merges shard outputs into:

- ``{metric}_sample_to_metric.npy`` — value per sample (difficulty array; the
  curriculum ``DeepSpeedDataSampler`` consumes exactly this), and
- ``{metric}_metric_to_sample.npz`` — value → sample-id arrays (the
  reference's per-value index files, one array per distinct value), plus
- ``{metric}_percentiles.npy`` for threshold scheduling.

Metric types follow the reference: ``single_value_per_sample`` (a value per
sample) and ``accumulate_value_over_samples`` (a running reduction, e.g. a
vocab histogram).
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class DataAnalyzer:

    def __init__(self, dataset, metric_names: Sequence[str],
                 metric_functions: Sequence[Callable],
                 metric_types: Sequence[str] = None,
                 save_path: str = "./data_analysis",
                 num_workers: int = 1, worker_id: int = 0,
                 num_threads: int = 4, batch_size: int = 1024,
                 metric_dtypes: Sequence = None):
        self.dataset = dataset
        self.metric_names = list(metric_names)
        self.metric_functions = list(metric_functions)
        self.metric_types = list(metric_types) if metric_types else \
            ["single_value_per_sample"] * len(self.metric_names)
        self.metric_dtypes = list(metric_dtypes) if metric_dtypes else \
            [np.int64] * len(self.metric_names)
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.num_threads = max(1, num_threads)
        self.batch_size = batch_size

    # ----------------------------------------------------------------- map --
    def _worker_range(self):
        n = len(self.dataset)
        per = (n + self.num_workers - 1) // self.num_workers
        lo = self.worker_id * per
        return lo, min(n, lo + per)

    def run_map(self) -> None:
        """Compute this worker's shard of every metric; one .npy per
        (metric, thread-shard) under save_path/worker_{id}/."""
        lo, hi = self._worker_range()
        wdir = os.path.join(self.save_path, f"worker_{self.worker_id}")
        os.makedirs(wdir, exist_ok=True)
        bounds = np.linspace(lo, hi, self.num_threads + 1).astype(np.int64)

        def one_thread(t):
            t_lo, t_hi = int(bounds[t]), int(bounds[t + 1])
            out = {m: [] for m in self.metric_names}
            for i in range(t_lo, t_hi):
                sample = self.dataset[i]
                for m, fn, typ in zip(self.metric_names, self.metric_functions,
                                      self.metric_types):
                    out[m].append(fn(sample))
            for m, typ, dt in zip(self.metric_names, self.metric_types, self.metric_dtypes):
                if typ == "single_value_per_sample":
                    arr = np.asarray(out[m], dtype=dt)
                else:  # accumulate_value_over_samples
                    arr = np.sum(np.stack(out[m]), axis=0).astype(dt) if out[m] else \
                        np.zeros(0, dt)
                np.save(os.path.join(wdir, f"{m}_thread{t}.npy"), arr)
            return t_hi - t_lo

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            done = sum(pool.map(one_thread, range(self.num_threads)))
        with open(os.path.join(wdir, "map_done.json"), "w") as f:
            json.dump({"lo": int(lo), "hi": int(hi), "threads": self.num_threads}, f)
        logger.info(f"data_analyzer worker {self.worker_id}: mapped {done} samples")

    # -------------------------------------------------------------- reduce --
    def run_reduce(self) -> Dict[str, np.ndarray]:
        """Merge every worker's shards into the train-time index files."""
        os.makedirs(self.save_path, exist_ok=True)
        results = {}
        for m, typ in zip(self.metric_names, self.metric_types):
            parts = []
            for w in range(self.num_workers):
                wdir = os.path.join(self.save_path, f"worker_{w}")
                with open(os.path.join(wdir, "map_done.json")) as f:
                    meta = json.load(f)
                for t in range(meta["threads"]):
                    parts.append(np.load(os.path.join(wdir, f"{m}_thread{t}.npy")))
            if typ == "single_value_per_sample":
                merged = np.concatenate(parts)
                np.save(os.path.join(self.save_path, f"{m}_sample_to_metric.npy"), merged)
                values, inverse = np.unique(merged, return_inverse=True)
                np.savez(os.path.join(self.save_path, f"{m}_metric_to_sample.npz"),
                         **{str(v): np.nonzero(inverse == j)[0]
                            for j, v in enumerate(values)})
                pct = np.percentile(merged, np.arange(0, 101))
                np.save(os.path.join(self.save_path, f"{m}_percentiles.npy"), pct)
            else:
                merged = np.sum(np.stack([p for p in parts if p.size], axis=0), axis=0)
                np.save(os.path.join(self.save_path, f"{m}_accumulated.npy"), merged)
            results[m] = merged
        logger.info(f"data_analyzer reduce: wrote indices for {self.metric_names} "
                    f"under {self.save_path}")
        return results

    def run_map_reduce(self) -> Dict[str, np.ndarray]:
        """Single-process convenience: every worker's map, then reduce."""
        me = self.worker_id
        for w in range(self.num_workers):
            self.worker_id = w
            self.run_map()
        self.worker_id = me
        return self.run_reduce()

    # ------------------------------------------------------------- consume --
    @staticmethod
    def sample_to_metric_path(save_path: str, metric_name: str) -> str:
        return os.path.join(save_path, f"{metric_name}_sample_to_metric.npy")

    @staticmethod
    def load_difficulties(save_path: str, metric_name: str) -> np.ndarray:
        """The curriculum sampler's difficulty array (one value per sample)."""
        return np.load(DataAnalyzer.sample_to_metric_path(save_path, metric_name))

    @staticmethod
    def get_metric_value_percentiles(save_path: str, metric_name: str) -> np.ndarray:
        return np.load(os.path.join(save_path, f"{metric_name}_percentiles.npy"))
