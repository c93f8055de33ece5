"""Per-node process spawner.

Port of ``deepspeed_tpu/launcher/launch.py``: one child process per local
slot, the environment contract ``deepspeed_tpu_torch.comm.init_distributed``
reads exported to each (``DSTPU_COORDINATOR``, ``DSTPU_NUM_PROCESSES``,
``DSTPU_PROCESS_ID``, a per-launch ``DSTPU_JOB_ID``, and torch's aliases
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), and the process tree cleaned up on a signal or a failed
child.

Where the reference gives one JAX process several devices, the port runs
one process a rank: a slot is a rank, and on a machine with GPUs local rank
``k`` takes device ``k % count`` (``comm.init_distributed``), unless the
script chooses its device itself.
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys

from deepspeed_tpu_torch.utils.logging import logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="per-node dstpu launcher")
    parser.add_argument("--world_info", type=str, required=True,
                        help="base64 json {hostname: [global ranks]}")
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--module", action="store_true",
                        help="run the training script as a python module")
    parser.add_argument("--no_python", action="store_true",
                        help="run the training script directly, not via python")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def decode_world_info(encoded: str):
    return json.loads(base64.urlsafe_b64decode(encoded).decode())


def encode_world_info(world_info: dict) -> str:
    return base64.urlsafe_b64encode(json.dumps(world_info).encode()).decode()


def main(argv=None):
    args = parse_args(argv)
    world_info = decode_world_info(args.world_info)
    hosts = list(world_info.keys())
    this_host = hosts[args.node_rank]
    local_ranks = world_info[this_host]
    world_size = sum(len(r) for r in world_info.values())
    coordinator = f"{args.master_addr}:{args.master_port}"

    children = []

    def kill_children(*_, rc=1):
        # terminate the process tree; exit with the failed child's code so
        # schedulers can tell failure causes apart
        for p in children:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    p.terminate()
        sys.exit(rc)

    signal.signal(signal.SIGINT, kill_children)
    signal.signal(signal.SIGTERM, kill_children)

    # one nonce per launch, shared by every rank: rendezvous artifacts keyed
    # by it (monitored_barrier's file barrier) can never be satisfied by a
    # previous job's leftovers on the same coordinator address
    import time as _time
    job_id = os.environ.get("DSTPU_JOB_ID", f"{os.getpid()}.{_time.time():.0f}")
    for local_rank, global_rank in enumerate(local_ranks):
        env = os.environ.copy()
        env.update({
            "DSTPU_COORDINATOR": coordinator,
            "DSTPU_NUM_PROCESSES": str(world_size),
            "DSTPU_PROCESS_ID": str(global_rank),
            "DSTPU_JOB_ID": job_id,
            # torch-compatible aliases (reference launch.py exports these)
            "RANK": str(global_rank),
            "LOCAL_RANK": str(local_rank),
            "WORLD_SIZE": str(world_size),
            "LOCAL_SIZE": str(len(local_ranks)),
            "MASTER_ADDR": args.master_addr,
            "MASTER_PORT": str(args.master_port),
        })
        if args.no_python:
            cmd = [args.training_script]
        elif args.module:
            cmd = [sys.executable, "-m", args.training_script]
        else:
            cmd = [sys.executable, "-u", args.training_script]
        cmd += list(args.training_script_args)
        logger.info(f"launch: rank {global_rank} (local {local_rank}): {' '.join(cmd)}")
        children.append(subprocess.Popen(cmd, env=env, start_new_session=True))

    for p in children:
        p.wait()
        if p.returncode != 0:
            kill_children(rc=p.returncode)
    sys.exit(0)


if __name__ == "__main__":
    main()
