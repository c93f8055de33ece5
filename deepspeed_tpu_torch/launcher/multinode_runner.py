"""Multi-node runners: build the command that starts ``launch.py`` on every node.

Port of ``deepspeed_tpu/launcher/multinode_runner.py`` (PDSH, ssh, Slurm and
the local runner). Each runner renders a command line and ``runner.py`` runs
it; building one is pure, so it is tested without a cluster.
"""

import os
import shlex
import shutil
import sys
from abc import ABC, abstractmethod

from deepspeed_tpu_torch.launcher.launch import encode_world_info

# env vars forwarded to remote shells (reference EXPORT_ENVS + .deepspeed_env)
EXPORT_ENVS = ("PYTHONPATH", "PATH", "LD_LIBRARY_PATH", "CUDA_VISIBLE_DEVICES", "NCCL_DEBUG", "NCCL_SOCKET_IFNAME",
               "NCCL_IB_DISABLE", "OMP_NUM_THREADS")


class MultiNodeRunner(ABC):

    def __init__(self, args, world_info: dict):
        self.args = args
        self.world_info = world_info
        self.user_arguments = list(getattr(args, "user_args", []) or [])
        self.user_script = args.user_script

    @abstractmethod
    def get_cmd(self, environment: dict, active_resources: dict):
        """Full argv to exec on this controller."""

    @property
    def name(self):
        return type(self).__name__

    def backend_exists(self) -> bool:
        return True

    def exports(self, environment):
        out = {}
        for var in EXPORT_ENVS:
            if var in environment:
                out[var] = environment[var]
        return out

    def _launch_args(self, node_rank: int):
        argv = ["--world_info", encode_world_info(self.world_info),
                "--node_rank", str(node_rank),
                "--master_addr", self.args.master_addr,
                "--master_port", str(self.args.master_port)]
        if getattr(self.args, "module", False):
            argv.append("--module")
        if getattr(self.args, "no_python", False):
            argv.append("--no_python")
        return argv + [self.user_script] + self.user_arguments


class PDSHRunner(MultiNodeRunner):
    """Reference multinode_runner.py:51 — one pdsh fan-out to all hosts;
    %n expands to the node's position in the pdsh host list."""

    def backend_exists(self):
        return shutil.which("pdsh") is not None

    def get_cmd(self, environment, active_resources):
        hosts = ",".join(active_resources.keys())
        env_flags = [f"export {k}={shlex.quote(str(v))};"
                     for k, v in self.exports(environment).items()]
        launch = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
                  "--world_info", encode_world_info(self.world_info),
                  "--node_rank", "%n",
                  "--master_addr", self.args.master_addr,
                  "--master_port", str(self.args.master_port)]
        if getattr(self.args, "module", False):
            launch.append("--module")
        if getattr(self.args, "no_python", False):
            launch.append("--no_python")
        launch += [self.user_script] + [shlex.quote(a) for a in self.user_arguments]
        return ["pdsh", "-S", "-f", "1024", "-w", hosts] + env_flags + launch


class SSHRunner(MultiNodeRunner):
    """Plain ssh loop fallback (one connection per host); get_cmd returns the
    command for a single node, per_node=True."""

    per_node = True

    def backend_exists(self):
        return shutil.which("ssh") is not None

    def get_cmd_for_node(self, environment, host, node_rank):
        env_flags = [f"export {k}={shlex.quote(str(v))};"
                     for k, v in self.exports(environment).items()]
        launch = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch"] \
            + self._launch_args(node_rank)
        return ["ssh", "-o", "StrictHostKeyChecking=no", host] \
            + env_flags + [shlex.quote(a) for a in launch]

    def get_cmd(self, environment, active_resources):
        return [self.get_cmd_for_node(environment, h, i)
                for i, h in enumerate(active_resources.keys())]


class SlurmRunner(MultiNodeRunner):
    """Reference multinode_runner.py SlurmRunner — srun spawns launch.py on
    every allocated node; SLURM_NODEID provides the node rank."""

    def backend_exists(self):
        return shutil.which("srun") is not None

    def get_cmd(self, environment, active_resources):
        nnodes = len(active_resources)
        srun = ["srun", "--nodes", str(nnodes), "--ntasks-per-node", "1"]
        if getattr(self.args, "slurm_comment", ""):
            srun += ["--comment", self.args.slurm_comment]
        env_flags = [f"export {k}={shlex.quote(str(v))};"
                     for k, v in self.exports(environment).items()]
        # SLURM_NODEID is expanded by a shell wrapper on each task; everything
        # else (incl. --module/--no_python and user args) goes through the same
        # _launch_args path as the other runners
        launch = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
                  "--world_info", encode_world_info(self.world_info),
                  "--node_rank", "$SLURM_NODEID",
                  "--master_addr", self.args.master_addr,
                  "--master_port", str(self.args.master_port)]
        if getattr(self.args, "module", False):
            launch.append("--module")
        if getattr(self.args, "no_python", False):
            launch.append("--no_python")
        launch += [self.user_script] + [shlex.quote(a) for a in self.user_arguments]
        return srun + ["bash", "-c", " ".join(env_flags) + " " + " ".join(launch)]


class LocalRunner(MultiNodeRunner):
    """Single-node: exec launch.py in-place (reference runner.py falls through
    to launch.py when no hostfile / one host)."""

    def get_cmd(self, environment, active_resources):
        return [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch"] \
            + self._launch_args(node_rank=0)
