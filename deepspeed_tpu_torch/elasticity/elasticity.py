"""Elastic batch-size math.

Reference: ``deepspeed/elasticity/elasticity.py:233`` (compute_elastic_config) —
given a max acceptable global batch, candidate micro-batch sizes and a
chip-count range, find the global batch size compatible with the most chip
counts, so a job can scale up/down across that set without changing the
effective batch (GAS absorbs the difference). v0.1 lets the batch float over
highly-composite multiples; v0.2 fixes the global batch at node granularity.

The algorithm is scale-invariant pure arithmetic, ported semantically: the
candidate set is {base * HCN <= max} for each base in micro_batches + their
LCM, scored by how many chip counts in [min, max] divide it with some
micro-batch.

Port of ``deepspeed_tpu/elasticity/elasticity.py`` (pure Python, unchanged
in behaviour).
"""

import json
import math
from typing import List, Tuple

from deepspeed_tpu_torch.utils.logging import logger

# highly composite numbers — dense divisor sets make good batch multipliers
HCN_LIST = [1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680, 2520,
            5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400]

ELASTICITY = "elasticity"
MINIMUM_DEEPSPEED_VERSION = "0.3.8"


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Reference elasticity/config.py — schema of the "elasticity" block."""

    def __init__(self, param_dict: dict):
        self.enabled = param_dict.get("enabled", False)
        if "max_train_batch_size" not in param_dict:
            raise ElasticityConfigError("elasticity config missing max_train_batch_size")
        self.max_acceptable_batch_size = param_dict["max_train_batch_size"]
        if "micro_batch_sizes" not in param_dict:
            raise ElasticityConfigError("elasticity config missing micro_batch_sizes")
        self.micro_batches = param_dict["micro_batch_sizes"]
        if not isinstance(self.micro_batches, list) or \
                not all(isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(f"micro_batch_sizes must be positive ints, "
                                        f"got {self.micro_batches}")
        self.min_gpus = param_dict.get("min_gpus", 1)
        self.max_gpus = param_dict.get("max_gpus", 10000)
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(f"bad chip range [{self.min_gpus}, {self.max_gpus}]")
        self.model_parallel_size = param_dict.get("model_parallel_size", 1)
        self.num_gpus_per_node = param_dict.get("num_gpus_per_node", 1)
        self.min_time = param_dict.get("min_time", 0)
        self.version = param_dict.get("version", 0.1)
        self.prefer_larger_batch_size = param_dict.get("prefer_larger_batch_size", True)
        self.ignore_non_elastic_batch_info = param_dict.get("ignore_non_elastic_batch_info", False)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return json.dumps(self.__dict__, indent=2)


def elasticity_enabled(ds_config: dict) -> bool:
    return ds_config.get(ELASTICITY, {}).get("enabled", False)


def _candidate_batch_sizes(base_list: List[int], max_batch: int) -> List[int]:
    out = set()
    for base in base_list:
        if base >= max_batch:
            out.add(base)
            continue
        best = base
        for h in HCN_LIST:
            if h * base > max_batch:
                break
            best = h * base
        out.add(best)
    return sorted(out)


def _valid_gpus(batch_size: int, micro_batches: List[int], min_gpus: int,
                max_gpus: int) -> List[int]:
    """Chip counts n in range such that batch_size == micro * gas * n for some
    micro in the list (i.e. n divides batch_size/micro)."""
    valid = set()
    for micro in micro_batches:
        if batch_size % micro:
            continue
        top = batch_size // micro
        for n in range(1, int(math.isqrt(top)) + 1):
            if top % n == 0:
                for cand in (n, top // n):
                    if min_gpus <= cand <= max_gpus:
                        valid.add(cand)
    return sorted(valid)


def _best_candidate(candidates: List[int], micro_batches: List[int], min_gpus: int,
                    max_gpus: int, prefer_larger: bool) -> Tuple[int, List[int]]:
    best_batch, best_valid = min(micro_batches), []
    for batch in candidates:
        valid = _valid_gpus(batch, micro_batches, min_gpus, max_gpus)
        better = len(valid) > len(best_valid) or (
            len(valid) == len(best_valid) and
            (batch > best_batch if prefer_larger else batch < best_batch))
        if better:
            best_batch, best_valid = batch, valid
    return best_batch, best_valid


def _compatible_gpus_v01(micro_batches, max_batch, min_gpus=None, max_gpus=None,
                         prefer_larger=True):
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_batch // min(micro_batches)
    if not all(m <= max_batch for m in micro_batches):
        raise ElasticityError(f"all micro batches must be <= {max_batch}")
    lcm = micro_batches[0]
    for m in micro_batches[1:]:
        lcm = lcm * m // math.gcd(lcm, m)
    candidates = _candidate_batch_sizes(list(micro_batches) + [lcm], max_batch)
    return _best_candidate(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def _compatible_gpus_v02(micro_batches, max_batch, current_num_gpus, min_gpus, max_gpus,
                         prefer_larger, num_gpus_per_node, model_parallel_size):
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityError(f"chips per node {num_gpus_per_node} must be divisible by "
                              f"model parallel size {model_parallel_size}")
    dp_per_node = num_gpus_per_node // model_parallel_size

    def pick_micro(batch):
        chosen = None
        for m in micro_batches:
            if (batch // current_num_gpus) % m == 0:
                if chosen is None or (prefer_larger and m > chosen):
                    chosen = m
        return chosen

    batch, valid_nodes = _compatible_gpus_v01(
        micro_batches, max_batch // dp_per_node,
        max(1, min_gpus // num_gpus_per_node), max(1, max_gpus // num_gpus_per_node),
        prefer_larger)
    batch *= dp_per_node
    valid_dp = [n * dp_per_node for n in valid_nodes]
    if current_num_gpus // model_parallel_size in valid_dp:
        return batch, valid_dp, pick_micro(batch)

    # current world incompatible with the elastic set: fix batch to the current
    # dp size (reference _get_compatible_gpus_v02 fallback — float node ratio,
    # so a sub-node world degrades gracefully instead of dividing by zero)
    current_dp = max(1, round((current_num_gpus / num_gpus_per_node) * dp_per_node))
    cands = [m * current_dp * (max_batch // (m * current_dp)) for m in micro_batches
             if m * current_dp <= max_batch]
    if not cands:
        raise ElasticityIncompatibleWorldSize(f"no batch fits {current_num_gpus} chips")
    batch = max(cands) if prefer_larger else min(cands)
    return batch, [int(current_dp)], pick_micro(batch)


def compute_elastic_config(ds_config: dict, target_deepspeed_version: str = "0.13.2",
                           world_size: int = 0, return_microbatch: bool = False):
    """Reference elasticity.py:233. Returns (final_batch_size, valid_gpus[,
    micro_batch]) — deterministic for a given config, so the scheduler and the
    runtime independently agree."""
    if ELASTICITY not in ds_config:
        raise ElasticityConfigError(f"config missing {ELASTICITY!r} block")
    cfg = ElasticityConfig(ds_config[ELASTICITY])

    if float(cfg.version) == 0.1:
        batch, valid = _compatible_gpus_v01(cfg.micro_batches, cfg.max_acceptable_batch_size,
                                            cfg.min_gpus, cfg.max_gpus,
                                            cfg.prefer_larger_batch_size)
        micro = None
        if world_size > 0 and world_size not in valid:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} not in elastic set {valid}")
        if return_microbatch and world_size > 0:
            for m in sorted(cfg.micro_batches, reverse=cfg.prefer_larger_batch_size):
                if (batch // world_size) % m == 0:
                    micro = m
                    break
    elif float(cfg.version) == 0.2:
        current = world_size or cfg.num_gpus_per_node
        batch, valid, micro = _compatible_gpus_v02(
            cfg.micro_batches, cfg.max_acceptable_batch_size, current, cfg.min_gpus,
            cfg.max_gpus, cfg.prefer_larger_batch_size, cfg.num_gpus_per_node,
            cfg.model_parallel_size)
    else:
        raise ElasticityConfigError(f"unknown elasticity version {cfg.version}")

    logger.info(f"elasticity: batch={batch} valid_chip_counts={valid}")
    if return_microbatch:
        return batch, valid, micro
    return batch, valid
