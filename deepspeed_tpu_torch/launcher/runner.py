"""The ``deepspeed`` launcher's command line: hostfile, include/exclude
filtering (``parse_resource_filter``) and the runner's choice. Usage:

    python -m deepspeed_tpu_torch.launcher.runner --hostfile /job/hostfile train.py --deepspeed_config ds.json
    python -m deepspeed_tpu_torch.launcher.runner --num_nodes 1 --num_chips 4 train.py ...

Port of ``deepspeed_tpu/launcher/runner.py``. Single-node launches run the
per-node spawner (``launcher/launch.py``) directly; multi-node launches
render a pdsh, ssh or srun command (``launcher/multinode_runner.py``) and
run it. Spawned processes receive ``DSTPU_COORDINATOR``,
``DSTPU_NUM_PROCESSES`` and ``DSTPU_PROCESS_ID``, which
``deepspeed_tpu_torch.comm.init_distributed`` turns into a
``torch.distributed`` process group. A slot is one process, one rank; a
host's slots default to its GPU count. ``deepspeed_tpu_torch/bin/dstpu_ssh
-f HOSTFILE <command>`` runs a command on every host of the same hostfile
(pdsh, else an ssh loop).
"""

import argparse
import os
import subprocess
import sys
from collections import OrderedDict

from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="dstpu launcher (reference: deepspeed/launcher/runner.py)")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="hostfile with lines '<hostname> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="e.g. 'host1@host2:0,2' — restrict hosts/slots")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="e.g. 'host1:1@host2' — drop hosts/slots")
    parser.add_argument("--num_nodes", type=int, default=-1)
    parser.add_argument("--num_chips", "--num_gpus", dest="num_chips", type=int, default=-1)
    parser.add_argument("--master_addr", type=str, default="")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--launcher", type=str, default="pdsh",
                        choices=("pdsh", "ssh", "slurm", "local"))
    parser.add_argument("--module", action="store_true")
    parser.add_argument("--no_python", action="store_true")
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("--slurm_comment", type=str, default="")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def fetch_hostfile(path):
    """'<hostname> slots=<n>' per line → OrderedDict host→slots (reference
    runner.py:200). Returns None when the file doesn't exist (single-node)."""
    if not os.path.isfile(path):
        return None
    pool = OrderedDict()
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            try:
                host, slots = line.split()
                n = int(slots.split("=")[1])
            except (ValueError, IndexError) as e:
                raise ValueError(f"hostfile line not '<host> slots=<n>': {line!r}") from e
            if host in pool:
                raise ValueError(f"host {host} repeated in hostfile")
            pool[host] = n
    if not pool:
        raise ValueError(f"hostfile {path} is empty")
    return pool


def _parse_filter(s):
    """'host1@host2:0,2' → {host1: None (all), host2: [0, 2]}"""
    out = OrderedDict()
    for part in filter(None, s.split("@")):
        if ":" in part:
            host, slots = part.split(":")
            out[host.strip()] = sorted(int(x) for x in slots.split(","))
        else:
            out[part.strip()] = None
    return out


def parse_resource_filter(pool, include_str="", exclude_str=""):
    """Apply include/exclude to host→slots, producing host→[slot ids]
    (reference runner.py parse_resource_filter — include and exclude are
    mutually exclusive there too)."""
    if include_str and exclude_str:
        raise ValueError("--include and --exclude are mutually exclusive")
    full = OrderedDict((h, list(range(n))) for h, n in pool.items())
    if include_str:
        inc = _parse_filter(include_str)
        out = OrderedDict()
        for host, slots in inc.items():
            if host not in full:
                raise ValueError(f"include host {host} not in hostfile")
            picked = full[host] if slots is None else slots
            bad = set(picked) - set(full[host])
            if bad:
                raise ValueError(f"include slots {sorted(bad)} not available on {host}")
            out[host] = sorted(picked)
        return out
    if exclude_str:
        exc = _parse_filter(exclude_str)
        out = OrderedDict()
        for host, slots in full.items():
            if host in exc:
                if exc[host] is None:
                    continue
                keep = [s for s in slots if s not in exc[host]]
                if keep:
                    out[host] = keep
            else:
                out[host] = slots
        if not out:
            raise ValueError("exclude filter removed every host")
        return out
    return full


def _world_info(active: "OrderedDict[str, list]"):
    """host→[slot ids] → host→[global ranks], rank-ordered by host then slot."""
    world, rank = OrderedDict(), 0
    for host, slots in active.items():
        world[host] = list(range(rank, rank + len(slots)))
        rank += len(slots)
    return world


def main(argv=None):
    args = parse_args(argv)
    # strip a leading '--' that argparse.REMAINDER keeps
    if args.user_args and args.user_args[0] == "--":
        args.user_args = args.user_args[1:]

    pool = fetch_hostfile(args.hostfile)
    if pool is None:
        n = args.num_chips if args.num_chips > 0 else _local_chip_count()
        pool = OrderedDict([("localhost", n)])
    active = parse_resource_filter(pool, args.include, args.exclude)
    if args.num_nodes > 0:
        active = OrderedDict(list(active.items())[:args.num_nodes])
    if args.num_chips > 0:
        active = OrderedDict((h, s[:args.num_chips]) for h, s in active.items())
    world = _world_info(active)

    multi_node = args.force_multi or len(world) > 1
    if not args.master_addr:
        args.master_addr = next(iter(world)) if multi_node else "127.0.0.1"

    from deepspeed_tpu_torch.launcher.multinode_runner import (LocalRunner, PDSHRunner, SlurmRunner,
                                                         SSHRunner)
    env = os.environ.copy()
    if not multi_node:
        runner = LocalRunner(args, world)
        cmd = runner.get_cmd(env, active)
        logger.info(f"dstpu local launch: {' '.join(cmd)}")
        return subprocess.call(cmd, env=env)

    runner_cls = {"pdsh": PDSHRunner, "ssh": SSHRunner, "slurm": SlurmRunner}[args.launcher]
    runner = runner_cls(args, world)
    if not runner.backend_exists():
        raise RuntimeError(f"launcher backend {args.launcher!r} not found on PATH")
    if getattr(runner, "per_node", False):
        procs = [subprocess.Popen(c, env=env) for c in runner.get_cmd(env, active)]
        rc = 0
        for p in procs:
            p.wait()
            rc = rc or p.returncode
        return rc
    cmd = runner.get_cmd(env, active)
    logger.info(f"dstpu {runner.name}: {' '.join(cmd)}")
    return subprocess.call(cmd, env=env)


def _local_chip_count():
    import torch
    return max(1, torch.cuda.device_count())


if __name__ == "__main__":
    sys.exit(main())
