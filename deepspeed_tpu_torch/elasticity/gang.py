"""Gang liveness: per-rank heartbeat files and the agent's state document.

Port of ``deepspeed_tpu/elasticity/gang.py`` (stdlib only, as there). A
rank wedged inside a collective looks like a slow one: its process is alive
and its peers block waiting for it. What tells them apart is train-loop
progress, and that is what this module carries:

- each rank writes a small heartbeat file (``rank<k>.hb``) from the train
  loop (step entry and exit, saves) and while waiting in
  ``monitored_barrier``, atomically, read without locks;
- the elastic agent's watchdog reads them: a rank whose process is alive
  but whose heartbeat is older than ``hang_timeout_s`` is wedged, and the
  whole gang is torn down and relaunched;
- the agent keeps ``gang_state.json`` in the same directory: world size,
  valid shrink targets, crash history and the last shrink.

The directory reaches the ranks as ``DSTPU_GANG_DIR`` (exported by
``DSElasticAgent._spawn``); without it everything here costs one
``is None`` check.
"""

import json
import os
import re
import time
from typing import Dict, Optional

GANG_DIR_ENV = "DSTPU_GANG_DIR"
STATE_FILE = "gang_state.json"

_HB_RE = re.compile(r"^rank(\d+)\.hb$")


def heartbeat_path(gang_dir: str, rank: int) -> str:
    return os.path.join(gang_dir, f"rank{int(rank)}.hb")


def atomic_write_json(path: str, doc: dict) -> None:
    """tmp + os.replace: readers always see a complete JSON document, never a
    torn write. The one atomic-marker primitive the gang machinery shares
    (heartbeats, gang state, checkpoint shard seals, barrier rendezvous)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class GangHeartbeat:
    """One rank's heartbeat writer. ``beat`` is called from the train loop
    (step entry/exit) and at collective entry; each beat atomically replaces
    the rank's heartbeat file, so the watchdog's read is always a complete
    JSON document (never a torn write)."""

    def __init__(self, gang_dir: str, rank: int):
        self.gang_dir = gang_dir
        self.rank = int(rank)
        os.makedirs(gang_dir, exist_ok=True)
        self._path = heartbeat_path(gang_dir, self.rank)

    @classmethod
    def from_env(cls, rank: Optional[int] = None) -> Optional["GangHeartbeat"]:
        """A heartbeat writer when ``DSTPU_GANG_DIR`` is armed, else None
        (the disabled path is one env read at engine init)."""
        gang_dir = os.environ.get(GANG_DIR_ENV)
        if not gang_dir:
            return None
        if rank is None:
            rank = int(os.environ.get("DSTPU_PROCESS_ID", "0") or 0)
        return cls(gang_dir, rank)

    def beat(self, step: Optional[int] = None, phase: str = "step") -> None:
        try:
            atomic_write_json(self._path, {
                "rank": self.rank,
                "unix": time.time(),
                "step": step,
                "phase": phase,
                "pid": os.getpid(),
            })
        except OSError:
            # liveness reporting must never kill the training it reports on
            pass


def read_heartbeats(gang_dir: str) -> Dict[int, dict]:
    """``{rank: heartbeat_doc + "age_s"}`` for every rank that has beaten.
    Unreadable/torn files are skipped (the next beat replaces them)."""
    out: Dict[int, dict] = {}
    if not os.path.isdir(gang_dir):
        return out
    now = time.time()
    for name in os.listdir(gang_dir):
        m = _HB_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(gang_dir, name)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        doc["age_s"] = max(0.0, now - doc.get("unix", now))
        out[int(m.group(1))] = doc
    return out


def clear_heartbeats(gang_dir: str) -> None:
    """Remove every rank heartbeat (the agent calls this before each launch so
    one life's staleness can never indict the next life's ranks)."""
    if not os.path.isdir(gang_dir):
        return
    for name in os.listdir(gang_dir):
        if _HB_RE.match(name):
            try:
                os.unlink(os.path.join(gang_dir, name))
            except OSError:
                pass


def write_gang_state(gang_dir: str, state: dict) -> None:
    """Atomically publish the agent's state document (``gang_state.json``) —
    what ``bin/dstpu_report --gang`` renders."""
    os.makedirs(gang_dir, exist_ok=True)
    doc = dict(state)
    doc["updated_unix"] = time.time()
    atomic_write_json(os.path.join(gang_dir, STATE_FILE), doc)


def read_gang_state(gang_dir: str) -> Optional[dict]:
    path = os.path.join(gang_dir, STATE_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
