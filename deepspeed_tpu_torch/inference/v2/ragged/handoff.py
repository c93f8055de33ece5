"""Portable KV-block handoff payloads (the fleet prefill→decode transport).

``DSStateManager.export_sequence``/``import_sequence`` move a sequence's
ragged state (committed tokens + KV-block contents) between managers
in-process; this module frames that snapshot as a self-describing **bytes
payload** so it can cross a process or network boundary — the transport the
fleet router uses to continue decoding on a different replica than the one
that prefilled, built on the same gather/scatter machinery as
``offload_sequence``/``restore_sequence``.

Wire format (version 1)::

    b"DSTPUKV1" | u32 header length (LE) | header JSON (utf-8) | raw KV bytes

Header fields::

    version      1
    uid          donor engine's sequence uid
    seen_tokens  committed token count (KV coverage)
    tokens       full token-id history (prompt + generated so far)
    extra        caller state (serving stashes generation state here:
                 next_token, sampler rng_state, generated count)
    kv           {"shape": [...], "dtype": "bfloat16"} or null (no blocks)
    kv_crc32     CRC-32 of the raw KV bytes (present whenever kv is) —
                 verified at unpack, so a payload corrupted in transit is
                 rejected loudly instead of decoding silently wrong tokens
    cache        donor KV geometry: block_size / num_layers / kv_heads /
                 head_dim — validated on import, so a payload can only land
                 in an engine with an identical cache layout

The header is JSON and the body is a raw array — never pickle: a handoff
payload arrives over the network and must not be an arbitrary-code-execution
vector.

Port of ``deepspeed_tpu/inference/v2/ragged/handoff.py`` with the same wire
bytes: the KV region is the host tensor's raw bytes (read through a uint8
view, so bfloat16 needs no numpy dtype), and unpacking wraps the payload's
bytes with ``torch.frombuffer`` as a tensor of the header's dtype. The dtype
names are numpy's (``bfloat16``, ``float16``, ``float32``, ...), so a frame
from either package imports into the other.
"""

import json
import struct
import warnings
import zlib
from typing import Optional, Tuple

import torch

MAGIC = b"DSTPUKV1"
VERSION = 1
PARK_VERSION = 2
"""Payload version for *parked-session* frames (``fleet/park_store.py``): a
park frame carries a versioned ``extra["tier"]`` record that older builds
(``SUPPORTED_VERSIONS == {1}``) must reject loudly rather than silently
ignore — bumping the frame version is what makes the reject loud."""
SUPPORTED_VERSIONS = frozenset({1, 2})
TIER_FIELD_VERSION = 1
"""Schema version of the ``extra["tier"]`` record this build understands."""

CONTENT_TYPE = "application/x-dstpu-handoff"
"""HTTP content type for a raw (un-base64d) frame on the wire — the binary
transport's negotiation token (``serving/server.py`` / ``fleet/replica.py``)."""


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _torch_dtype(name: str) -> torch.dtype:
    """Resolve a header's dtype name (numpy's spelling) to a torch dtype."""
    try:
        return _DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(f"handoff header: unknown dtype {name!r}") from None


def _kv_meta(kv: torch.Tensor) -> dict:
    return {"shape": list(kv.shape), "dtype": _DTYPE_NAMES[kv.dtype]}


def _raw_bytes(kv: torch.Tensor) -> bytes:
    """The host tensor's bytes in C order (the JAX package's ``tobytes``)."""
    return kv.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _cache_signature(kv_config) -> dict:
    num_layers, kv_heads, head_dim = kv_config.cache_shape
    # dtype is part of the geometry: importing into a different-dtype cache
    # would silently cast the KV and break token-identical continuation
    return {"block_size": kv_config.block_size, "num_layers": num_layers,
            "kv_heads": kv_heads, "head_dim": head_dim,
            "dtype": str(kv_config.cache_dtype)}


def pack_sequence(state_manager, uid: int, tokens, extra: Optional[dict] = None,
                  seen_tokens: Optional[int] = None,
                  version: int = VERSION) -> bytes:
    """Snapshot ``uid`` from ``state_manager`` into a portable payload.
    ``tokens`` is the full token-id history (the manager tracks counts, not
    ids — the serving layer owns the ids); ``extra`` must be JSON-serializable.
    ``seen_tokens`` overrides the manager's committed count downward when the
    caller knows some trailing KV must be recomputed by the recipient (the
    chunked-decode case: the device loop feeds ahead of the kept history).
    ``version`` selects the frame version — :data:`PARK_VERSION` for parked
    sessions (requires a versioned ``extra["tier"]``); live handoffs stay v1.
    The sequence stays tracked on the donor (flush after the recipient has it)."""
    snap = state_manager.export_sequence(uid)
    kv = snap["kv"]
    header = {
        "version": int(version),
        "uid": int(snap["uid"]),
        "seen_tokens": int(snap["seen_tokens"] if seen_tokens is None
                           else min(seen_tokens, snap["seen_tokens"])),
        "tokens": [int(t) for t in tokens],
        "extra": extra or {},
        "cache": _cache_signature(state_manager._kv_config),
        "kv": None if kv is None else _kv_meta(kv),
    }
    raw = b"" if kv is None else _raw_bytes(kv)
    if kv is not None:
        header["kv_crc32"] = zlib.crc32(raw) & 0xFFFFFFFF
    return _frame(header, raw)


def _frame(header: dict, raw: bytes) -> bytes:
    hdr = json.dumps(header).encode()
    return MAGIC + struct.pack("<I", len(hdr)) + hdr + raw


def pack_blocks(state_manager, block_ids, tokens,
                extra: Optional[dict] = None) -> bytes:
    """Frame arbitrary KV blocks (full blocks, no tracked sequence) as a v1
    payload — the peer prefix-fetch transport. ``tokens`` is the token-id
    history the blocks cover; every block must be full
    (``len(tokens) == len(block_ids) * block_size``), which is exactly what
    the prefix-cache trie stores."""
    block_ids = list(block_ids)
    bs = state_manager._kv_config.block_size
    if len(tokens) != len(block_ids) * bs:
        raise ValueError(
            f"pack_blocks: {len(tokens)} tokens do not fill "
            f"{len(block_ids)} blocks of {bs}")
    kv = state_manager.kv_cache.gather_blocks(block_ids, synchronize=True)
    raw = _raw_bytes(kv)
    header = {
        "version": VERSION,
        "uid": 0,
        "seen_tokens": len(tokens),
        "tokens": [int(t) for t in tokens],
        "extra": extra or {},
        "cache": _cache_signature(state_manager._kv_config),
        "kv": _kv_meta(kv),
        "kv_crc32": zlib.crc32(raw) & 0xFFFFFFFF,
    }
    return _frame(header, raw)


def _validate_header(header) -> None:
    """Schema-check a parsed header. Payloads arrive over the network, so
    every field the import path touches is validated here — a malformed
    header must be a ``ValueError`` at the framing layer, never a KeyError
    deep inside the scheduler."""
    if not isinstance(header, dict):
        raise ValueError("handoff header must be a JSON object")
    if header.get("version") not in SUPPORTED_VERSIONS:
        # loud reject, not best-effort parse: a future-version frame may have
        # changed the geometry or the CRC coverage, and decoding it under v1
        # rules would stream silently wrong tokens
        raise ValueError(
            f"unsupported handoff payload version {header.get('version')!r} "
            f"(this build speaks {sorted(SUPPORTED_VERSIONS)})")
    if not isinstance(header.get("seen_tokens"), int) or header["seen_tokens"] < 0:
        raise ValueError("handoff header: seen_tokens must be a non-negative int")
    tokens = header.get("tokens")
    if not isinstance(tokens, list) or not all(isinstance(t, int) for t in tokens):
        raise ValueError("handoff header: tokens must be a list of token ids")
    cache = header.get("cache")
    if not isinstance(cache, dict) or \
            set(cache) != {"block_size", "num_layers", "kv_heads", "head_dim",
                           "dtype"}:
        raise ValueError("handoff header: missing or malformed cache signature")
    if not isinstance(header.get("extra", {}), dict):
        raise ValueError("handoff header: extra must be an object")
    # the parked-session tier record: v2 frames carry it, v1 frames must NOT
    # (a v1-with-tier frame would be silently misread by an older build whose
    # SUPPORTED_VERSIONS is {1} minus this check — the whole point of the
    # version bump is that old unpacks reject park frames loudly)
    tier = header.get("extra", {}).get("tier")
    if header["version"] >= PARK_VERSION:
        if not isinstance(tier, dict):
            raise ValueError(
                "handoff header: a v2 (parked) frame requires a versioned "
                "extra.tier record")
        if not isinstance(tier.get("v"), int) or tier["v"] < 1:
            raise ValueError("handoff header: extra.tier.v must be a positive int")
        if tier["v"] > TIER_FIELD_VERSION:
            raise ValueError(
                f"handoff header: tier record version {tier['v']} is newer "
                f"than this build speaks (v{TIER_FIELD_VERSION})")
        if not isinstance(tier.get("source"), str):
            raise ValueError("handoff header: extra.tier.source must be a "
                             "tier name string")
    elif tier is not None:
        raise ValueError(
            "handoff header: extra.tier requires payload version >= 2")
    kv_meta = header.get("kv")
    if kv_meta is not None:
        if not isinstance(kv_meta, dict) or not isinstance(kv_meta.get("dtype"), str):
            raise ValueError("handoff header: malformed kv block")
        shape = kv_meta.get("shape")
        if not (isinstance(shape, list) and len(shape) == 6
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError("handoff header: kv.shape must be 6 non-negative ints")
        crc = header.get("kv_crc32")
        if crc is not None and not isinstance(crc, int):
            raise ValueError("handoff header: kv_crc32 must be an int")
    # self-consistency: the committed-token count must be covered by the KV
    # actually shipped — otherwise the recipient would attend over blocks
    # that do not exist (faulting or streaming garbage for a whole batch)
    block_size = cache.get("block_size")
    n_blocks = kv_meta["shape"][2] if kv_meta is not None else 0
    if isinstance(block_size, int) and block_size > 0 \
            and header["seen_tokens"] > n_blocks * block_size:
        raise ValueError(
            f"handoff header: seen_tokens={header['seen_tokens']} exceeds the "
            f"payload's KV coverage ({n_blocks} blocks x {block_size})")


def unpack(payload: bytes) -> Tuple[dict, Optional[torch.Tensor]]:
    """Parse a payload into ``(header, kv tensor or None)``. Validates framing
    AND header schema; geometry-vs-target validation is
    :func:`compatibility_error`."""
    if not isinstance(payload, (bytes, bytearray, memoryview)):
        raise ValueError("handoff payload must be bytes")
    # zero-copy: the KV region is the bulk of a multi-MB payload on the
    # per-request handoff hot path — only the small header JSON is ever
    # materialized; the KV tensor aliases the caller's buffer (read-only,
    # which is fine: import scatters it into fresh device blocks)
    view = memoryview(payload).cast("B") if not isinstance(payload, bytes) \
        else memoryview(payload)
    n_total = view.nbytes
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise ValueError("not a DSTPU KV-handoff payload (bad magic)")
    off = len(MAGIC)
    if n_total < off + 4:
        raise ValueError("handoff payload truncated: no header length")
    (hdr_len, ) = struct.unpack_from("<I", view, off)
    off += 4
    if n_total < off + hdr_len:
        raise ValueError("handoff payload truncated: incomplete header")
    try:
        header = json.loads(bytes(view[off:off + hdr_len]))
    except json.JSONDecodeError as e:
        raise ValueError(f"handoff header is not valid JSON: {e}") from e
    _validate_header(header)
    off += hdr_len
    kv_meta = header.get("kv")
    if kv_meta is None:
        return header, None
    dtype = _torch_dtype(kv_meta["dtype"])
    shape = tuple(kv_meta["shape"])
    count = 1
    for d in shape:
        count *= d
    want = count * dtype.itemsize
    if n_total - off != want:
        raise ValueError(f"handoff payload truncated: {n_total - off} KV "
                         f"bytes, header promises {want}")
    crc = header.get("kv_crc32")
    if crc is not None and zlib.crc32(view[off:]) & 0xFFFFFFFF != crc:
        # corruption-in-transit must be a loud reject here, never silently
        # wrong attention downstream (the framing checks above only catch
        # length damage; a flipped KV byte is invisible without this)
        raise ValueError("handoff payload corrupted: KV checksum mismatch")
    if count == 0:
        return header, torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        # a bytes payload is read-only; nothing writes through this view
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        kv = torch.frombuffer(view, dtype=torch.uint8, count=want, offset=off)
    return header, kv.view(dtype).reshape(shape)


def compatibility_error(state_manager, header: dict) -> Optional[str]:
    """A reason this payload can NEVER land in ``state_manager`` (geometry
    mismatch, payload bigger than the whole pool), or None. Used both by
    :func:`import_payload` (raising) and by serving admission (fail fast
    rather than starve)."""
    sig = _cache_signature(state_manager._kv_config)
    if header["cache"] != sig:
        return (f"handoff payload geometry {header['cache']} does not match "
                f"this engine's KV cache {sig}")
    kv_meta = header.get("kv")
    if kv_meta is not None:
        n = kv_meta["shape"][2]
        if n > state_manager.kv_cache.num_blocks:
            return (f"handoff payload holds {n} KV blocks; the whole pool is "
                    f"{state_manager.kv_cache.num_blocks}")
        bs = state_manager._kv_config.block_size
        max_blocks = (state_manager._config.max_context + bs - 1) // bs
        if n > max_blocks:
            return (f"handoff payload holds {n} KV blocks; this manager caps "
                    f"sequences at {max_blocks} "
                    f"(max_context={state_manager._config.max_context})")
    return None


def import_payload(state_manager, payload: bytes,
                   uid: Optional[int] = None) -> Tuple[int, dict]:
    """Unpack + import a payload into ``state_manager`` under ``uid``
    (default: the donor's uid). Returns ``(uid, header)``. Raises
    ``ValueError`` for permanent problems (framing, geometry, uid taken) and
    the allocator's capacity error when the pool is merely full right now —
    evict and retry for the latter."""
    header, kv = unpack(payload)
    err = compatibility_error(state_manager, header)
    if err:
        raise ValueError(err)
    uid = state_manager.import_sequence({"uid": header["uid"],
                                         "seen_tokens": header["seen_tokens"],
                                         "kv": kv}, uid=uid)
    return uid, header
