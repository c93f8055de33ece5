"""Checkpoint save and load for the training engine, crash-consistent.

Port of the single-process part of
``deepspeed_tpu/runtime/checkpoint_engine/engine.py``. A checkpoint is a
directory ``<save_dir>/<tag>/`` holding

- ``state/params.pt``, ``state/opt_state.pt`` and ``state/scale_state.pt``:
  flat name -> tensor dicts written with ``torch.save`` (the reference writes
  the same three trees with orbax). An optimizer-state field that is a tensor
  is saved under its field name, a dict of tensors under ``field/name``;
- ``host_state.pkl``: step counters, the lr schedule, the compression
  scheduler's state (which the reference does not save: ROADMAP C9), the
  config and the client state;
- ``MANIFEST.json``, written last by tmp + ``os.replace``: the commit marker.
  It holds a CRC32 of every saved tensor (over its raw bytes, keyed by the
  path the reference's ``jax.tree_util.keystr`` gives the same leaf, so that
  a tensor of the same dtype and layout has the same CRC in both manifests),
  the size and CRC32 of every file the commit wrote, and the step and
  loss-scale state.

A tag without a manifest is *torn* (the crash came mid-commit); one whose
files disagree with the manifest is *corrupt*. :func:`load_engine_state`
verifies before restoring and, asked for the newest checkpoint, falls back
loudly (an error log and ``checkpoint_load_fallbacks_total``) to the newest
verified-good tag. Keep-last-K retention never deletes the newest committed
tag. An async save (``nebula.enabled``) snapshots the tensors to the host
synchronously, then a non-daemon thread writes and commits them; a failure
surfaces at the next :func:`checkpoint_barrier`.

A gang of several ranks commits as the reference's does
(``_gang_commit``): after a barrier (so no seal of an earlier save of the
tag survives), every rank writes its own state under ``state/rank<r>/``
(its chunks of the partitioned tensors; rank 0 also the whole ones) and
then its seal (``.seals/rank<r>.sealed``, carrying its per-array CRCs); rank 0 waits
for every seal, then writes ``state/partition.json`` (the world and the
dimension each flat entry is chunked on), ``host_state.pkl`` and the
manifest. A rank that dies mid-save never seals, so the tag stays torn,
and a load skips it loudly. A load at any world size reads every rank's
files, puts each tensor back together along its dimension, and hands each
rank its own part under the current partitioning: a save at world N loads
at world M, bit for bit. A world of one keeps the single-process layout,
and so does a save across model, sequence or expert ranks: there every
rank gathers each array whole, entry by entry, and rank 0 alone writes
them as a world-1 save would (the same files and the same per-array CRCs
in the manifest; the other ranks write only their seals), so the tag loads
at any mesh, or at world 1, with each rank cutting its tensor-parallel or
expert shard and then its ZeRO chunk from the whole arrays.
"""

import atexit
import json
import os
import pickle
import re
import shutil
import threading
import time
import weakref
import zlib

import torch

from deepspeed_tpu_torch.utils.logging import logger

LATEST_FILE = "latest"
MANIFEST_FILE = "MANIFEST.json"
PREEMPT_MARKER = "PREEMPTED.json"
MANIFEST_FORMAT = 1
STATE_DIR = "state"
STATE_TREES = ("params", "opt_state", "scale_state")

# files the reference (torch) DeepSpeed writes per rank: their presence means
# the directory holds upstream shards, not a checkpoint of this engine
_REFERENCE_SHARD_PREFIXES = ("zero_pp_rank_", "mp_rank_", "bf16_zero_pp_rank_")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed manifest verification (torn or corrupt) and no
    fallback was possible (an explicit tag, or no verified-good tag left)."""


class ReferenceCheckpointError(RuntimeError):
    """The directory holds upstream DeepSpeed per-rank shards, not a
    checkpoint of this engine."""


def _metrics():
    """The checkpoint counters; None when telemetry is off."""
    from deepspeed_tpu_torch import telemetry
    if not telemetry.is_active():
        return None
    reg = telemetry.get_registry()
    return {
        "saves": reg.counter("checkpoint_saves_total", "Committed (manifest-sealed) checkpoint saves"),
        "verify_failures": reg.counter("checkpoint_verify_failures_total",
                                       "Checkpoint tags that failed manifest verification (torn/corrupt)"),
        "fallbacks": reg.counter("checkpoint_load_fallbacks_total",
                                 "Loads that skipped a bad tag and fell back to an older good one"),
        "pruned": reg.counter("checkpoint_pruned_total", "Checkpoint tags deleted by keep-last-K retention"),
    }


def _count(name):
    m = _metrics()
    if m is not None:
        m[name].inc()


def _ckpt_path(save_dir, tag):
    return os.path.join(os.path.abspath(save_dir), str(tag))


def checkpoint_barrier(engine):
    """Join an in-flight async save, so at most one commit is outstanding. A
    commit that failed in the background raises here: ``save_checkpoint``
    has already returned, so this is the first place it can surface."""
    st = getattr(engine, "_async_ckpt", None)
    if st and st.get("thread") is not None:
        st["thread"].join()
        st["thread"] = None
        err = st.pop("error", None)
        if err is not None:
            raise RuntimeError(f"async checkpoint commit failed: {err[1]}") from err[1]


def close_async_checkpointer(engine):
    """Drain the engine's async save (the ``engine.destroy`` path): the last
    save commits, or its failure surfaces."""
    checkpoint_barrier(engine)


def _atexit_barrier(engine_ref):
    """atexit hook: an async commit in flight lands before the interpreter
    tears down."""
    engine = engine_ref()
    if engine is None:
        return
    try:
        close_async_checkpointer(engine)
    except Exception as e:  # exit path: report, never mask other teardown
        logger.error(f"async checkpoint commit failed during interpreter exit: {e}")


# --------------------------------------------------------------- checksums --
def _crc32_bytes(data, crc=0):
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def _file_crc32(path, chunk=1 << 24):
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _walk_files(root):
    """``{relpath: {"size", "crc32"}}`` for every file under ``root`` but the
    manifest itself (it seals the others)."""
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for fname in sorted(filenames):
            fp = os.path.join(dirpath, fname)
            rel = os.path.relpath(fp, root)
            if rel == MANIFEST_FILE or not os.path.isfile(fp):
                continue
            out[rel] = {"size": os.path.getsize(fp), "crc32": _file_crc32(fp)}
    return out


def _leaves(tree, path=""):
    """``(keystr, tensor)`` for every tensor of nested dicts and NamedTuples,
    with the key path ``jax.tree_util.keystr`` gives a dict tree; None
    leaves are skipped."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif tree is not None:
        yield path, tree


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def tensor_crc32(t):
    """CRC32 of a tensor's raw bytes (row-major, from a contiguous host copy
    viewed as uint8, so bf16 needs no numpy dtype)."""
    raw = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
    return _crc32_bytes(memoryview(raw.numpy()))


def array_checksums(tree):
    """Per-tensor ``{keystr: {crc32, dtype, shape}}`` over nested dicts of
    tensors (one host copy at a time)."""
    return {path: {"crc32": tensor_crc32(t), "dtype": _dtype_name(t.dtype), "shape": list(t.shape)}
            for path, t in _leaves(tree)}


def _verify_array_checksums(tree, want):
    """Paths of the manifest's per-array CRCs that ``tree`` does not match."""
    got = array_checksums(tree)
    return [path for path, info in (want or {}).items()
            if path not in got or got[path]["crc32"] != info["crc32"]]


# ---------------------------------------------------------------- manifest --
def write_manifest(path, meta):
    """Seal a checkpoint directory: checksum every committed file, then write
    MANIFEST.json atomically (tmp + rename), last, so that manifest-present
    means commit-completed."""
    manifest = dict(meta)
    manifest["format"] = MANIFEST_FORMAT
    manifest["files"] = _walk_files(path)
    tmp = os.path.join(path, f".{MANIFEST_FILE}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST_FILE))
    return manifest


def read_manifest(path):
    """The manifest dict, or None when absent (torn). Malformed JSON raises
    ValueError (corrupt)."""
    mf = os.path.join(path, MANIFEST_FILE)
    if not os.path.isfile(mf):
        return None
    try:
        with open(mf) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise ValueError(f"manifest unreadable: {e}") from e


def verify_checkpoint(path):
    """Integrity verdict for one checkpoint directory:

    - ``("good", detail)``: manifest present, every sealed file there with
      its size and CRC32;
    - ``("torn", detail)``: no manifest (crash mid-commit) or a sealed file
      missing;
    - ``("corrupt", detail)``: manifest unreadable, or a sealed file's size
      or CRC32 disagrees with it;
    - ``("reference", detail)``: upstream DeepSpeed shards (the load path
      raises :class:`ReferenceCheckpointError` for these).
    """
    if not os.path.isdir(path):
        return "torn", "checkpoint directory does not exist"
    try:
        detect_reference_checkpoint(path)
    except ReferenceCheckpointError as e:
        return "reference", str(e)
    try:
        manifest = read_manifest(path)
    except ValueError as e:
        return "corrupt", str(e)
    if manifest is None:
        return "torn", f"no {MANIFEST_FILE} (commit never completed)"
    for rel, info in manifest.get("files", {}).items():
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            return "torn", f"sealed file missing: {rel}"
        size = os.path.getsize(fp)
        if size != info["size"]:
            return "corrupt", f"{rel}: size {size} != sealed {info['size']}"
        if _file_crc32(fp) != info["crc32"]:
            return "corrupt", f"{rel}: crc32 mismatch"
    return "good", f"{len(manifest.get('files', {}))} files verified"


def detect_reference_checkpoint(path):
    """Raise :class:`ReferenceCheckpointError` when ``path`` holds upstream
    DeepSpeed's per-rank shard files, naming the problem and the way out."""
    if not os.path.isdir(path):
        return
    hits = [name for name in sorted(os.listdir(path)) if name.startswith(_REFERENCE_SHARD_PREFIXES)]
    if hits:
        raise ReferenceCheckpointError(
            f"{path} is a reference DeepSpeed (torch) checkpoint: found per-rank shard files "
            f"{hits[:4]}{'...' if len(hits) > 4 else ''}. This engine loads its own checkpoints "
            f"(state/*.pt sealed by {MANIFEST_FILE}). Migration path: convert with the reference's "
            f"checkpoint/ds_to_universal.py (universal checkpoint), load the weights into the model, "
            f"and re-save from this engine with engine.save_checkpoint().")


def list_tags(save_dir):
    """Candidate tags under ``save_dir``, newest first, each as ``{"tag",
    "path", "manifest", "status", "detail", "mtime"}``. Newest means the
    highest manifest ``global_steps`` (mtime breaks ties; a tag without a
    manifest takes the step its name ends in). ``status`` is the cheap
    verdict (manifest present and readable); :func:`verify_checkpoint` does
    the CRCs."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path):
            continue
        if not (os.path.isfile(os.path.join(path, MANIFEST_FILE))
                or os.path.isfile(os.path.join(path, "host_state.pkl"))
                or os.path.isdir(os.path.join(path, STATE_DIR))):
            continue
        entry = {"tag": name, "path": path, "manifest": None, "status": "torn", "detail": f"no {MANIFEST_FILE}",
                 "mtime": os.path.getmtime(path)}
        try:
            manifest = read_manifest(path)
            if manifest is not None:
                entry.update(manifest=manifest, status="committed", detail="manifest present")
        except ValueError as e:
            entry.update(status="corrupt", detail=str(e))
        out.append(entry)

    def sort_key(entry):
        step = (entry["manifest"] or {}).get("global_steps")
        if step is None:
            match = re.search(r"(\d+)$", entry["tag"])
            step = int(match.group(1)) if match else -1
        return (step, entry["mtime"])

    out.sort(key=sort_key, reverse=True)
    return out


def retention_plan(save_dir, keep_last_k):
    """``(keep, drop)`` tag entries for keep-last-K retention. The newest K
    survive, and so does the newest committed tag even when it is older than
    the window. Committed is not CRC-verified: a sealed tag corrupted in
    place can satisfy the protection, so flaky-disk runs should keep K >= 2."""
    tags = list_tags(save_dir)
    if keep_last_k is None or keep_last_k <= 0 or len(tags) <= keep_last_k:
        return tags, []
    keep = tags[:keep_last_k]
    drop = tags[keep_last_k:]
    if not any(e["status"] == "committed" for e in keep):
        for e in list(drop):
            if e["status"] == "committed":
                drop.remove(e)
                keep.append(e)
                break
    return keep, drop


def prune_checkpoints(save_dir, keep_last_k):
    """Delete the tags :func:`retention_plan` drops; returns their names."""
    _, drop = retention_plan(save_dir, keep_last_k)
    deleted = []
    for entry in drop:
        try:
            shutil.rmtree(entry["path"])
            deleted.append(entry["tag"])
            _count("pruned")
        except OSError as e:  # a stuck delete must not fail the save
            logger.warning(f"checkpoint retention: could not delete {entry['path']}: {e}")
    if deleted:
        logger.info(f"checkpoint retention: pruned {deleted} (keep_last_k={keep_last_k})")
    return deleted


# -------------------------------------------------------------------- save --
def _named_opt_state(opt_state):
    """NamedTuple -> dict."""
    return dict(opt_state._asdict()) if hasattr(opt_state, "_asdict") else opt_state


def _state_trees(engine):
    """The trees a save writes; an offloaded optimizer state as its plan
    hands it over (swapped-in host tensors under NVMe offload)."""
    opt = engine._offload.checkpoint_view(engine.opt_state)
    return {"params": engine.params, "opt_state": _named_opt_state(opt), "scale_state": engine.scale_state._asdict()}


def _flatten(tree):
    """A state tree as one flat name -> tensor dict (``field/name`` for a
    dict field; None fields are left out)."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update({f"{key}/{name}": t for name, t in value.items()})
        elif value is not None:
            flat[key] = value
    return flat


def _chunked_part(trees, layout):
    """What a rank other than 0 writes: only its chunks of partitioned
    entries (rank 0 writes the whole ones, once)."""
    out = {}
    for name, tree in trees.items():
        dims, part = layout[name], {}
        for key, value in tree.items():
            if isinstance(value, dict):
                sub = {n: t for n, t in value.items() if dims.get(f"{key}/{n}") is not None}
                if sub:
                    part[key] = sub
            elif value is not None and dims.get(key) is not None:
                part[key] = value
        out[name] = part
    return out


def _global_trees(engine, trees, keep):
    """``trees`` with every entry gathered whole over the ranks, entry by
    entry in one order on every rank (``engine._gather_entry``); a copy on
    the host where ``keep``, else nothing (the entries are dropped as they
    come, so no rank holds more than one whole tensor at a time)."""
    out = {}
    for name, tree in trees.items():
        part = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                sub = {}
                for n, t in value.items():
                    whole = engine._gather_entry(name, f"{key}/{n}", t)
                    if keep:
                        sub[n] = whole.detach().to("cpu", copy=True)
                part[key] = sub
            elif value is None:
                part[key] = None
            else:
                whole = engine._gather_entry(name, key, value)
                if keep:
                    part[key] = whole.detach().to("cpu", copy=True)
        out[name] = part if keep else {}
    return out


def _host_snapshot(trees):
    """Host copies of every tensor, taken now: later steps replace the
    engine's tensors but never touch these."""
    if any(t.is_cuda for _, t in _leaves(trees)):
        torch.cuda.synchronize()

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return None if tree is None else tree.detach().to("cpu", copy=True)

    return copy(trees)


def _write_state(snapshot, state_dir):
    """``torch.save`` each state tree as a flat dict, flushed to disk."""
    os.makedirs(state_dir, exist_ok=True)
    for name in STATE_TREES:
        with open(os.path.join(state_dir, f"{name}.pt"), "wb") as f:
            torch.save(_flatten(snapshot[name]), f)
            f.flush()
            os.fsync(f.fileno())


def _world_meta(engine):
    from deepspeed_tpu_torch import comm as dist
    dev = engine.device
    return {"process_count": dist.get_world_size(), "device": str(dev),
            "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "mesh": {str(k): int(v) for k, v in engine.mesh.shape.items()},
            "zero_stage": engine.zero_optimization_stage()}


# -------------------------------------------------------------- gang seals --
SEAL_DIR = ".seals"
PARTITION_FILE = "partition.json"


def _seal_path(path, rank):
    return os.path.join(path, SEAL_DIR, f"rank{int(rank)}.sealed")


def _clear_rank_seal(path, rank):
    """Drop this rank's seal from an earlier save of the same tag: while the
    state is rewritten, a stale seal must not satisfy rank 0's check."""
    try:
        os.unlink(_seal_path(path, rank))
    except OSError:
        pass


def _write_rank_seal(path, rank, arrays=None):
    """This rank's files are durable: written atomically after them and
    before rank 0 may write the manifest. It carries the rank's per-array
    CRCs for the manifest."""
    from deepspeed_tpu_torch.elasticity.gang import atomic_write_json
    os.makedirs(os.path.join(path, SEAL_DIR), exist_ok=True)
    atomic_write_json(_seal_path(path, rank), {"rank": int(rank), "pid": os.getpid(), "unix": time.time(),
                                               "arrays": arrays})


def _await_gang_seals(path, process_count, timeout_s, poll_s=0.05):
    """Rank 0's half of the gang commit: wait until every rank's seal
    exists and return them by rank. A rank that died mid-save never seals;
    at the deadline this raises naming the absent ranks, and the tag stays
    torn (no manifest)."""
    deadline = time.monotonic() + timeout_s
    while True:
        absent = [r for r in range(process_count) if not os.path.isfile(_seal_path(path, r))]
        if not absent:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"gang checkpoint commit: ranks {absent} never sealed their shards within "
                               f"{timeout_s:.1f}s, leaving {path} torn (no manifest); a peer likely died mid-save")
        time.sleep(poll_s)
    seals = {}
    for r in range(process_count):
        with open(_seal_path(path, r)) as f:
            seals[r] = json.load(f)
    return seals


def _maybe_die_during_save(engine, path):
    """``die_during_save`` chaos point (runtime/faults.py): the targeted
    rank SIGKILLs itself between writing its files and its seal, the
    mid-save death whose only acceptable outcome is a torn tag."""
    inj = getattr(engine, "_train_faults", None)
    if inj is None:
        return
    rank = engine._gang_rank
    n = inj.fire_rank("die_during_save", rank)
    if n is not None:
        import signal
        logger.error(f"chaos: rank {rank} dying during save #{n} of {path} (its files written, its seal withheld)")
        os.kill(os.getpid(), signal.SIGKILL)


def _gang_commit(engine, path, save_dir, tag, host_state, save_latest, manifest_meta, keep_last_k, world,
                 rank_arrays, chunked=True):
    """Every rank seals its files; rank 0 waits for all the seals, then
    writes the partition map (of a ``chunked`` save), host_state.pkl and
    the manifest (last). One rank seals and commits at once."""
    rank = engine._gang_rank
    _maybe_die_during_save(engine, path)
    _write_rank_seal(path, rank, rank_arrays if world > 1 else None)
    if rank != 0:
        return
    if world > 1:
        timeout_s = float(engine._config.checkpoint_config.gang_seal_timeout_s or 60.0)
        seals = _await_gang_seals(path, world, timeout_s)
        if manifest_meta.get("arrays") is not None:
            merged = {}
            for r in range(world):
                merged.update(seals[r].get("arrays") or {})
            manifest_meta["arrays"] = merged
        if chunked:
            with open(os.path.join(path, STATE_DIR, PARTITION_FILE), "w") as f:
                json.dump({"world": world, "dims": engine._checkpoint_layout()}, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
    _commit_host_side(engine, path, save_dir, tag, host_state, save_latest, manifest_meta, keep_last_k)


def _manifest_meta(engine, tag, host_state, scale_state, arrays_crc, keep_last_k):
    """The manifest body, taken at save time: an async commit seals the
    dispatch-time state, not the steps trained since."""
    return {
        "tag": str(tag),
        "global_steps": host_state["global_steps"],
        "global_samples": host_state["global_samples"],
        "micro_steps": host_state["micro_steps"],
        "skipped_steps": host_state["skipped_steps"],
        "loss_scale": {k: v.item() for k, v in scale_state.items()},
        "rng": None,  # the port's engine draws no random numbers
        "data_state": _jsonable(host_state.get("client_state")),
        "world": _world_meta(engine),
        "keep_last_k": keep_last_k,
        "saved_unix": time.time(),
        "arrays": arrays_crc,
    }


def _jsonable(obj):
    """The client state for the manifest, as JSON where it can be (the
    authoritative copy is in host_state.pkl, CRC-sealed)."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)


def _commit_host_side(engine, path, save_dir, tag, host_state, save_latest, manifest_meta, keep_last_k):
    """The tail of a save, strictly after the tensors are on disk:
    host_state.pkl, then MANIFEST.json (the commit marker), then the
    ``latest`` pointer (atomic too), then retention."""
    with open(os.path.join(path, "host_state.pkl"), "wb") as f:
        pickle.dump(host_state, f)
        f.flush()
        os.fsync(f.fileno())
    write_manifest(path, manifest_meta)
    if save_latest:
        tmp = os.path.join(save_dir, f".{LATEST_FILE}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(tag))
        os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
    _count("saves")
    if keep_last_k > 0:
        prune_checkpoints(save_dir, keep_last_k)
    _maybe_inject_checkpoint_fault(engine, path)


def _maybe_inject_checkpoint_fault(engine, path):
    """The training chaos harness may corrupt or truncate the checkpoint just
    committed (runtime/faults.py)."""
    inj = getattr(engine, "_train_faults", None)
    if inj is None:
        return
    n = inj.fire("checkpoint_corrupt")
    if n is not None:
        inj.corrupt_checkpoint(path, n)
    if inj.fire("checkpoint_truncate") is not None:
        inj.truncate_checkpoint(path)


def save_engine_state(engine, save_dir, tag, client_state, save_latest, async_save=False):
    """Save the engine's state as tag ``tag`` under ``save_dir``. The host
    snapshot, the per-array CRCs and the manifest's body are taken now; with
    ``async_save`` a thread writes the files and commits while training goes
    on (a crash mid-commit leaves a torn tag and the previous one current),
    and :func:`checkpoint_barrier` (taken by the next save or load, by
    ``destroy`` and at exit) bounds the saves in flight to one."""
    from deepspeed_tpu_torch import comm as dist
    path = _ckpt_path(save_dir, tag)
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    checkpoint_barrier(engine)  # the previous save in flight lands first
    world, rank = dist.get_world_size(), engine._gang_rank

    # re-saving a tag (steps replayed after a rollback): drop its manifest
    # first, so that while the files are rewritten the tag reads as torn;
    # rank 0 drops every seal, each other rank its own, and the barrier
    # orders that before any rank seals this save
    stale_manifest = os.path.join(path, MANIFEST_FILE)
    if rank == 0:
        if os.path.isfile(stale_manifest):
            os.unlink(stale_manifest)
        shutil.rmtree(os.path.join(path, SEAL_DIR), ignore_errors=True)
    else:
        _clear_rank_seal(path, rank)
    if world > 1:
        dist.barrier()
    hb = getattr(engine, "_gang_hb", None)
    if hb is not None:
        hb.beat(step=engine.global_steps, phase="save")

    trees = _state_trees(engine)
    global_layout = world > 1 and engine._checkpoint_global()
    if global_layout:
        # every array whole, as at world 1: gathered by every rank, kept
        # (and written) by rank 0 alone
        trees = _global_trees(engine, trees, keep=rank == 0)
    elif world > 1 and rank != 0:
        trees = _chunked_part(trees, engine._checkpoint_layout())
    snapshot = _host_snapshot(trees)
    host_state = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": int(engine._overflow_count),
        "current_lr": engine._current_lr,
        "lr_scheduler": engine.lr_scheduler.state_dict() if engine.lr_scheduler is not None else None,
        # which compression techniques already fired (absent in the JAX
        # package's checkpoint, whose resume fires a once-only one again)
        "compression_scheduler": (engine.compression_scheduler.state_dict()
                                  if getattr(engine, "compression_scheduler", None) is not None else None),
        "ds_config": engine._config._param_dict,
        "client_state": client_state,
    }
    ck_cfg = engine._config.checkpoint_config
    keep_last_k = int(ck_cfg.keep_last_k or 0)
    arrays_crc = None
    if ck_cfg.array_checksums and (rank == 0 or not global_layout):
        arrays_crc = array_checksums({f"rank{rank}": snapshot} if world > 1 and not global_layout else snapshot)
    # over several ranks rank 0 replaces the arrays with every rank's seal's
    manifest_meta = _manifest_meta(engine, tag, host_state, snapshot["scale_state"], arrays_crc, keep_last_k)
    state_dir = os.path.join(path, STATE_DIR)
    if world > 1 and not global_layout:
        state_dir = os.path.join(state_dir, f"rank{rank}")

    def commit():
        if rank == 0 or not global_layout:
            _write_state(snapshot, state_dir)
        _gang_commit(engine, path, save_dir, tag, host_state, save_latest, manifest_meta, keep_last_k, world,
                     arrays_crc, chunked=not global_layout)

    if not async_save:
        commit()
        logger.info(f"Saved checkpoint to {path}")
        return True

    st = getattr(engine, "_async_ckpt", None)
    if st is None:
        st = engine._async_ckpt = {"thread": None}
        # the last async save of a short-lived trainer still commits (or
        # fails loudly) before the interpreter tears down
        atexit.register(_atexit_barrier, weakref.ref(engine))

    def finalize():
        try:
            commit()
            logger.info(f"Async checkpoint committed to {path}")
        except BaseException as e:  # surfaced at the next checkpoint_barrier
            st["error"] = (tag, e)
            logger.error(f"Async checkpoint commit for {path} FAILED: {e}")

    # non-daemon: the interpreter joins it at exit
    t = threading.Thread(target=finalize, name=f"ckpt-commit-{tag}")
    t.start()
    st["thread"] = t
    logger.info(f"Async checkpoint save dispatched for {path}")
    return True


# -------------------------------------------------------------------- load --
def load_engine_state(engine, load_dir, tag, load_optimizer_states=True, load_lr_scheduler_states=True,
                      load_module_only=False):
    """Verified restore; returns ``(path, client_state)``. An explicit ``tag``
    is authoritative: a torn or corrupt one raises
    :class:`CheckpointCorruptionError`. ``tag=None`` asks for the newest
    state: the ``latest`` pointer first, then every other tag newest first,
    each bad one skipped loudly (an error log and
    ``checkpoint_load_fallbacks_total``); it raises only when no
    verified-good tag remains. A directory where nothing was ever committed
    returns ``(None, None)``: a fresh start, not a failure."""
    checkpoint_barrier(engine)  # an async save in flight lands first
    load_dir = os.path.abspath(load_dir)
    detect_reference_checkpoint(load_dir)
    ck_cfg = engine._config.checkpoint_config
    verify = bool(ck_cfg.verify_on_load)

    explicit = tag is not None
    if explicit:
        candidates = [str(tag)]
    else:
        tags = list_tags(load_dir)
        latest = os.path.join(load_dir, LATEST_FILE)
        pointed = None
        if os.path.isfile(latest):
            with open(latest) as f:
                pointed = f.read().strip()
        # a fresh start when nothing was ever committed: no `latest` pointing
        # at a tag and no tag with a manifest (readable or not)
        committed_any = any(e["status"] != "torn" for e in tags)
        pointed_exists = pointed is not None and os.path.isdir(_ckpt_path(load_dir, pointed))
        if not committed_any and not pointed_exists:
            logger.warning(f"nothing ever committed under {load_dir} "
                           f"(latest={'missing' if pointed is None else repr(pointed)}, "
                           f"{len(tags)} torn partial tag(s)), returning (None, None)")
            return None, None
        candidates = ([pointed] if pointed is not None else []) + [e["tag"] for e in tags if e["tag"] != pointed]

    failures = []
    for tg in candidates:
        path = _ckpt_path(load_dir, tg)
        if not os.path.isdir(path):
            msg = f"checkpoint path {path} does not exist"
            if explicit:
                raise CheckpointCorruptionError(msg)
            failures.append(msg)
            logger.error(msg + "; trying the next newest tag")
            continue
        detect_reference_checkpoint(path)
        if verify:
            status, detail = verify_checkpoint(path)
            if status != "good":
                _count("verify_failures")
                msg = f"checkpoint {path} is {status.upper()}: {detail}"
                if explicit:
                    raise CheckpointCorruptionError(msg)
                _count("fallbacks")
                failures.append(msg)
                logger.error(f"{msg}: falling back to the newest verified-good tag")
                continue
        try:
            return _restore_into_engine(engine, path, load_optimizer_states=load_optimizer_states,
                                        load_lr_scheduler_states=load_lr_scheduler_states,
                                        load_module_only=load_module_only,
                                        verify_arrays=verify and bool(ck_cfg.verify_arrays_on_load))
        except ReferenceCheckpointError:
            raise
        except Exception as e:
            # an array-seal mismatch is raised before any engine state
            # changes: under tag=None it is one more bad tag to skip
            if explicit:
                raise
            _count("verify_failures")
            _count("fallbacks")
            msg = f"checkpoint {path} failed to restore: {e}"
            failures.append(msg)
            logger.error(f"{msg}: falling back to the newest verified-good tag")
    raise CheckpointCorruptionError(f"no verified-good checkpoint under {load_dir}: " + "; ".join(failures))


def _unflatten_like(flat, template, what):
    """The flat dict back into ``template``'s structure (a dict of tensors,
    or a NamedTuple of tensors, dicts and Nones), each tensor checked against
    the template's shape and dtype."""

    def take(key, like):
        if key not in flat:
            raise ValueError(f"{what}: {key!r} missing from the checkpoint")
        t = flat[key]
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{what}: {key!r} is {t.dtype}{list(t.shape)}, the engine holds "
                             f"{like.dtype}{list(like.shape)}")
        return t

    if not hasattr(template, "_asdict"):
        return {name: take(name, like) for name, like in template.items()}
    fields = {}
    for field, like in template._asdict().items():
        if like is None:
            fields[field] = None
        elif isinstance(like, dict):
            fields[field] = {name: take(f"{field}/{name}", t) for name, t in like.items()}
        else:
            fields[field] = take(field, like)
    return type(template)(**fields)


def _nest(flat):
    """A flat ``field/name`` dict back into nested dicts (the layout the
    per-array CRC paths were taken over)."""
    out = {}
    for key, t in flat.items():
        head, sep, name = key.partition("/")
        if sep:
            out.setdefault(head, {})[name] = t
        else:
            out[key] = t
    return out


def read_state(path, verify_arrays=True):
    """The checkpoint's three state trees as whole flat dicts: one file
    each for a save at world 1; else every rank's files put back together
    along the dimension each entry was chunked on (``partition.json``).
    Each file is checked against the manifest's per-array CRCs first."""
    state_dir = os.path.join(path, STATE_DIR)
    want = (read_manifest(path) or {}).get("arrays") if verify_arrays else None
    part_file = os.path.join(state_dir, PARTITION_FILE)
    load = lambda d, name: torch.load(os.path.join(d, f"{name}.pt"), weights_only=True, map_location="cpu")
    if not os.path.isfile(part_file):
        flat = {name: load(state_dir, name) for name in STATE_TREES}
        ranks = [("", flat)]
        dims, world = None, 1
    else:
        with open(part_file) as f:
            layout = json.load(f)
        world, dims = int(layout["world"]), layout["dims"]
        ranks = [(f"rank{r}", {name: load(os.path.join(state_dir, f"rank{r}"), name) for name in STATE_TREES})
                 for r in range(world)]
    if want is not None:
        for prefix, flat in ranks:
            tree = {name: _nest(flat[name]) for name in STATE_TREES}
            got = array_checksums({prefix: tree} if prefix else tree)
            bad = [p for p, info in got.items() if p not in want or want[p]["crc32"] != info["crc32"]]
            if bad:
                raise CheckpointCorruptionError(f"checkpoint {path}: restored arrays fail the manifest's per-array "
                                                f"CRC32 ({bad[:4]}{'...' if len(bad) > 4 else ''})")
    if dims is None:
        return ranks[0][1]
    full = {}
    for name in STATE_TREES:
        full[name] = {}
        for key, t0 in ranks[0][1][name].items():
            dim = dims.get(name, {}).get(key)
            full[name][key] = t0 if dim is None else torch.cat([flat[name][key] for _, flat in ranks], dim=dim)
    return full


def _restore_into_engine(engine, path, load_optimizer_states, load_lr_scheduler_states, load_module_only,
                         verify_arrays):
    full = read_state(path, verify_arrays)
    layout = engine._checkpoint_layout()
    offload = engine._offload
    templates = {"params": engine.params, "opt_state": offload.restore_template(engine.opt_state),
                 "scale_state": engine.scale_state}
    restored = {}
    for name in STATE_TREES:
        dims = layout[name]
        local = {k: engine._localize_entry(name, k, t, dims.get(k)).to(engine.device) for k, t in full[name].items()}
        restored[name] = _unflatten_like(local, templates[name], name)

    with open(os.path.join(path, "host_state.pkl"), "rb") as f:
        host_state = pickle.load(f)

    engine.params = restored["params"]
    if load_optimizer_states and not load_module_only:
        engine.opt_state = offload.accept_restored(restored["opt_state"])
        engine.scale_state = restored["scale_state"]
    engine._sync_module()  # the compute-dtype module holds the restored masters
    if not load_module_only:
        engine.global_steps = host_state["global_steps"]
        engine.global_samples = host_state["global_samples"]
        engine.micro_steps = host_state["micro_steps"]
        engine._current_lr = host_state["current_lr"]
        engine._overflow_count = torch.tensor(host_state.get("skipped_steps", 0), dtype=torch.int32,
                                              device=engine.device)
        if load_lr_scheduler_states and engine.lr_scheduler is not None and host_state["lr_scheduler"]:
            engine.lr_scheduler.load_state_dict(host_state["lr_scheduler"])
        if getattr(engine, "compression_scheduler", None) is not None and host_state.get("compression_scheduler"):
            engine.compression_scheduler.load_state_dict(host_state["compression_scheduler"])
    logger.info(f"Loaded checkpoint from {path}")
    return path, host_state.get("client_state", {})
