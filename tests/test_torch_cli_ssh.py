"""The port's ``deepspeed_tpu_torch/bin/dstpu_ssh`` against the reference's
two CLI tests (``tests/unit/launcher/test_cli_tools.py``): a missing
hostfile fails loudly, and without pdsh the ssh loop visits every host of
the hostfile (a fake ``ssh`` on the PATH records its arguments)."""

import os
import subprocess

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "deepspeed_tpu_torch", "bin",
                      "dstpu_ssh")


def test_dstpu_ssh_requires_hostfile(tmp_path):
    r = subprocess.run(["bash", SCRIPT, "-f", str(tmp_path / "nope"), "echo", "hi"], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode != 0
    assert "Missing hostfile" in r.stdout + r.stderr


def test_dstpu_ssh_ssh_fallback_loops_hosts(tmp_path):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("hostA slots=1\nhostB slots=2\n")
    fake = tmp_path / "fakebin"
    fake.mkdir()
    log = tmp_path / "ssh.log"
    (fake / "ssh").write_text(f"#!/bin/bash\necho \"$@\" >> {log}\n")
    os.chmod(fake / "ssh", 0o755)
    env = dict(os.environ, PATH=f"{fake}:/usr/bin:/bin")  # no pdsh
    r = subprocess.run(["bash", SCRIPT, "-f", str(hostfile), "uptime"], capture_output=True, text=True, timeout=60,
                       env=env)
    assert r.returncode == 0, r.stderr
    logged = log.read_text()
    assert "hostA" in logged and "hostB" in logged and "uptime" in logged
