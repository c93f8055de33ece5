"""Port parity: KV handoff frames, session parking, the host→disk tier and
the AIO engine in deepspeed_tpu_torch against deepspeed_tpu.

- Frames (``ragged/handoff.py``): a frame the JAX engine exports imports
  into the port with equal KV, and the port re-exports it byte for byte, in
  f32 and bf16 (and the other way round); the greedy continuation of a
  handed-off or parked request equals the JAX scheduler's; every framing,
  version, CRC and geometry refusal raises the reference's message.
- The streaming ``/v1/resume`` body decoder gives the reference's results on
  the same chunked inputs.
- The tier store (``ragged/tiering.py``): the same scripts of put/read/
  demote/drop on both stores give the same tiers, bytes and counters, the
  demote race included; the serving tier controller demotes before it
  evicts or sheds; ``offload_path`` spills through the native AIO engine,
  which this sandbox builds with g++.

Mirrors ``tests/unit/inference/v2/test_{handoff,kv_offload,kv_tiering}.py``
and ``tests/unit/serving/test_{kv_tiers,data_motion}.py``.
"""

import base64
import dataclasses
import io
import json
import struct
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2 import config_v2 as j_config
from deepspeed_tpu.inference.v2 import engine_factory as j_factory
from deepspeed_tpu.inference.v2.ragged import handoff as j_handoff
from deepspeed_tpu.inference.v2.ragged import manager_configs as j_mc
from deepspeed_tpu.inference.v2.ragged import tiering as j_tiering
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.serving import server as j_server
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
from deepspeed_tpu_torch.inference.v2.ragged import handoff as t_handoff
from deepspeed_tpu_torch.inference.v2.ragged import tiering as t_tiering
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                     MemoryConfig)
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import digest_chain
from deepspeed_tpu_torch.ops import aio as t_aio
from deepspeed_tpu_torch.ops.aio import aio_op as t_aio_op
from deepspeed_tpu_torch.serving import KVTierConfig, OverloadConfig, PrefixCacheConfig, ServingConfig, ServingScheduler
from deepspeed_tpu_torch.serving import server as t_server
from deepspeed_tpu_torch.serving.config import CostConfig
from tests.test_torch_serving import _prompts, make_engine, setup  # noqa: F401
from tests.torch_port_helpers import jax_params, port_config, port_params

MAX_STEPS = 400


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches():
    yield
    jax.clear_caches()


def _step_until_done(sched, reqs):
    for _ in range(MAX_STEPS):
        if all(r.finished for r in reqs):
            return
        sched.step()
    raise AssertionError("requests did not finish")


# ----------------------------------------------------------- frame refusals --
def _frame_with(version=1, flip_kv_byte=None, truncate=0, extra=None, **header_kw):
    """The reference's hand-built frame over synthetic KV
    (``tests/unit/serving/test_data_motion.py``), with header overrides."""
    kv = np.arange(2 * 1 * 2 * 16 * 1 * 4, dtype=np.float32).reshape((2, 1, 2, 16, 1, 4))
    raw = kv.tobytes()
    header = {
        "version": version, "uid": 7, "seen_tokens": 32, "tokens": list(range(32)),
        "extra": extra if extra is not None else {},
        "cache": {"block_size": 16, "num_layers": 1, "kv_heads": 1, "head_dim": 4, "dtype": "float32"},
        "kv": {"shape": list(kv.shape), "dtype": "float32"},
        "kv_crc32": zlib.crc32(raw) & 0xFFFFFFFF,
    }
    header.update(header_kw)
    hdr = json.dumps(header).encode()
    payload = bytearray(j_handoff.MAGIC + struct.pack("<I", len(hdr)) + hdr + raw)
    if flip_kv_byte is not None:
        payload[len(j_handoff.MAGIC) + 4 + len(hdr) + flip_kv_byte] ^= 0xFF
    if truncate:
        payload = payload[:-truncate]
    return bytes(payload)


TIER = {"v": 1, "source": "host"}
BAD_FRAMES = {
    "future_version": lambda: _frame_with(version=3),
    "no_version": lambda: _frame_with(version=None),
    "v2_without_tier": lambda: _frame_with(version=2),
    "tier_v0": lambda: _frame_with(version=2, extra={"tier": {"v": 0, "source": "host"}}),
    "tier_without_source": lambda: _frame_with(version=2, extra={"tier": {"v": 1}}),
    "tier_without_v": lambda: _frame_with(version=2, extra={"tier": {"source": "host"}}),
    "tier_v_not_int": lambda: _frame_with(version=2, extra={"tier": {"v": "x", "source": "host"}}),
    "tier_source_not_str": lambda: _frame_with(version=2, extra={"tier": {"v": 1, "source": 3}}),
    "tier_not_object": lambda: _frame_with(version=2, extra={"tier": "host"}),
    "tier_from_the_future": lambda: _frame_with(version=2, extra={"tier": {"v": 2, "source": "host"}}),
    "v1_with_tier": lambda: _frame_with(version=1, extra={"tier": TIER}),
    "crc_first_byte": lambda: _frame_with(flip_kv_byte=0),
    "crc_middle_byte": lambda: _frame_with(flip_kv_byte=100),
    "crc_last_byte": lambda: _frame_with(flip_kv_byte=2 * 2 * 16 * 4 * 4 - 1),
    "truncated_kv": lambda: _frame_with(truncate=5),
    "bad_magic": lambda: b"NOTDSTPU" + _frame_with()[8:],
    "no_header_length": lambda: j_handoff.MAGIC + b"\x01",
    "incomplete_header": lambda: j_handoff.MAGIC + struct.pack("<I", 999) + b"{}",
    "header_not_json": lambda: j_handoff.MAGIC + struct.pack("<I", 3) + b"{x}",
    "header_not_object": lambda: j_handoff.MAGIC + struct.pack("<I", 2) + b"[]",
    "negative_seen": lambda: _frame_with(seen_tokens=-1),
    "tokens_not_ints": lambda: _frame_with(tokens=["a"]),
    "malformed_cache": lambda: _frame_with(cache={"block_size": 16}),
    "extra_not_object": lambda: _frame_with(extra=[1]),
    "kv_not_object": lambda: _frame_with(kv=[1]),
    "kv_shape_not_6": lambda: _frame_with(kv={"shape": [2, 1], "dtype": "float32"}),
    "crc_not_int": lambda: _frame_with(kv_crc32="x"),
    "seen_past_the_kv": lambda: _frame_with(seen_tokens=33),
    "unknown_dtype": lambda: _frame_with(kv={"shape": [2, 1, 2, 16, 1, 4], "dtype": "complex7"}),
    "not_bytes": lambda: "DSTPUKV1",
}


@pytest.mark.parametrize("name", list(BAD_FRAMES))
def test_every_frame_refusal_raises_the_reference_message(name):
    frame = BAD_FRAMES[name]()
    with pytest.raises(ValueError) as want:
        j_handoff.unpack(frame)
    with pytest.raises(ValueError) as got:
        t_handoff.unpack(frame)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("version,extra", [(1, {}), (2, {"tier": TIER})])
def test_valid_frames_unpack_to_the_reference_header_and_kv(version, extra):
    frame = _frame_with(version=version, extra=extra)
    jheader, jkv = j_handoff.unpack(frame)
    theader, tkv = t_handoff.unpack(frame)
    assert theader == jheader and tkv.dtype == torch.float32
    np.testing.assert_array_equal(tkv.numpy(), jkv)
    # zero-copy: the tensor aliases the payload's KV region
    base = np.frombuffer(frame, np.uint8).ctypes.data
    assert tkv.data_ptr() == base + len(frame) - tkv.numel() * 4
    assert t_handoff.CONTENT_TYPE == j_handoff.CONTENT_TYPE and t_handoff.MAGIC == j_handoff.MAGIC
    assert (t_handoff.VERSION, t_handoff.PARK_VERSION, t_handoff.TIER_FIELD_VERSION,
            t_handoff.SUPPORTED_VERSIONS) == (j_handoff.VERSION, j_handoff.PARK_VERSION,
                                              j_handoff.TIER_FIELD_VERSION, j_handoff.SUPPORTED_VERSIONS)


# ------------------------------------------------------- engine-level frames --
def _bf16_setup():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.bfloat16)
    jparams = jax_params(jcfg)
    cfg = dataclasses.replace(port_config(jcfg), dtype=torch.bfloat16)
    return jcfg, jparams, cfg, port_params(jcfg, jparams)


def _engines(s, num_blocks=64, **mgr_kw):
    jcfg, jparams, cfg, params = s
    mgr_kw.setdefault("max_context", 512)
    jmgr = j_mc.DSStateManagerConfig(memory_config=j_mc.MemoryConfig(mode=j_mc.AllocationMode.ALLOCATE,
                                                                     size=num_blocks), **mgr_kw)
    jeng = j_factory.build_engine(jparams, jcfg, j_config.RaggedInferenceEngineConfig(state_manager=jmgr,
                                                                                      kv_block_size=16))
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=num_blocks), **mgr_kw)
    teng = build_engine(params, cfg, RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16), device="cpu")
    return jeng, teng


def _kv_bytes(engine, uid):
    sm = engine._state_manager
    kv = sm.kv_cache.gather_blocks(sm.get_sequence(uid).kv_blocks)
    if isinstance(kv, torch.Tensor):
        return kv.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(kv).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frames_cross_packages_and_reexport_byte_for_byte(setup, dtype):
    s = setup if dtype == "float32" else _bf16_setup()
    jeng, teng = _engines(s)
    prompt = _prompts(31, (37, ))[0]
    jeng.put([3], [np.asarray(prompt)])
    extra = {"next_token": 5, "generated": 1, "rng_state": np.random.default_rng(2).bit_generator.state}
    jframe = jeng.export_sequence(3, tokens=prompt, extra=extra, seen_tokens=36)
    uid, header = teng.import_sequence(jframe)
    assert uid == 3 and header == j_handoff.unpack(jframe)[0]
    assert header["kv"]["dtype"] == dtype
    tframe = teng.export_sequence(uid, tokens=header["tokens"], extra=header["extra"],
                                  seen_tokens=header["seen_tokens"])
    assert tframe == jframe
    # and back: a port-made frame imports into the JAX engine bit for bit
    teng.put([4], [np.asarray(prompt[:20])])
    tframe = teng.export_sequence(4, tokens=prompt[:20], extra={"k": [1, 2]})
    juid, jheader = jeng.import_sequence(tframe)
    assert _kv_bytes(jeng, juid) == _kv_bytes(teng, 4)
    assert jeng.export_sequence(juid, tokens=jheader["tokens"], extra=jheader["extra"]) == tframe
    if dtype == "bfloat16":
        want = j_handoff.unpack(jframe)[1]
        got = t_handoff.unpack(jframe)[1]
        assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes()


def test_import_under_new_uid_collision_and_export_refusals(setup):
    jeng, teng = _engines(setup)
    jeng.put([1], [np.arange(20)])
    frame = jeng.export_sequence(1, tokens=list(range(20)))
    teng.import_sequence(frame, uid=9)
    for eng in (jeng, teng):
        with pytest.raises(ValueError) as e:
            eng.import_sequence(frame, uid=9 if eng is teng else 1)
        assert "already tracked" in str(e.value)
        with pytest.raises(ValueError, match="unknown uid"):
            eng.export_sequence(77)
    assert teng.free_blocks == 64 - 2


@pytest.mark.parametrize("case", ["geometry", "dtype", "whole_pool", "sequence_cap"])
def test_compatibility_errors_are_the_reference_messages(setup, case):
    jeng, teng = _engines(setup)
    jeng.put([1], [np.arange(40)])
    frame = jeng.export_sequence(1, tokens=list(range(40)))
    header = j_handoff.unpack(frame)[0]
    if case == "geometry":
        header["cache"] = dict(header["cache"], head_dim=7)
    elif case == "dtype":
        header["cache"] = dict(header["cache"], dtype="bfloat16")
    kw = {"whole_pool": dict(num_blocks=2), "sequence_cap": dict(max_context=32)}.get(case, {})
    jsmall, tsmall = _engines(setup, **kw) if kw else (jeng, teng)
    want = j_handoff.compatibility_error(jsmall._state_manager, header)
    assert want is not None
    assert t_handoff.compatibility_error(tsmall._state_manager, header) == want


def test_export_restores_an_offloaded_sequence(setup):
    _, teng = _engines(setup)
    teng.put([2], [np.arange(33)])
    before = teng.export_sequence(2, tokens=list(range(33)))
    teng.offload_sequence(2)
    assert teng.is_offloaded(2)
    assert teng.export_sequence(2, tokens=list(range(33))) == before
    assert not teng.is_offloaded(2)


# --------------------------------------------------- scheduler continuation --
def _schedulers(setup, **cfg):
    jeng, teng = _engines(setup)
    return (jserving.ServingScheduler(jeng, jserving.ServingConfig(**cfg), start=False),
            ServingScheduler(teng, ServingConfig.from_dict(cfg), start=False))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_handoff_continuation_equals_the_reference(setup, temperature):
    """The JAX scheduler prefills with ``handoff``; its frame resumes on
    both packages' schedulers: the same tokens, greedy and sampled (the
    sampler's state rides the frame)."""
    prompt = _prompts(41, (23, ))[0]
    donor, _ = _schedulers(setup)
    req = donor.submit(prompt, max_new_tokens=3, temperature=temperature, seed=9, handoff=True)
    _step_until_done(donor, [req])
    frame = req.handoff_payload
    assert req.finish_reason == "length" and frame is not None
    out = []
    for sched in _schedulers(setup):
        r = sched.submit_resume(frame, max_new_tokens=6, temperature=temperature)
        _step_until_done(sched, [r])
        out.append((list(r.tokens), r.state.name, sched.stats()["counters"]))
        sched.stop(drain=False)
    assert out[1] == out[0]
    # the port donor's frame for the same request is continuable on the JAX side too
    _, tdonor = _schedulers(setup)
    treq = tdonor.submit(prompt, max_new_tokens=3, temperature=temperature, seed=9, handoff=True)
    _step_until_done(tdonor, [treq])
    assert treq.tokens == req.tokens
    # the same header but the CRC: the KV is each engine's own f32 rounding
    header, _ = t_handoff.unpack(treq.handoff_payload)
    header.pop("kv_crc32")
    assert header == {k: v for k, v in j_handoff.unpack(frame)[0].items() if k != "kv_crc32"}


@pytest.mark.parametrize("finish", ["length", "eos"])
def test_park_and_rehydrate_equal_the_reference(setup, finish):
    prompt = _prompts(43, (29, ))[0]
    runs = []
    for sched in _schedulers(setup):
        first = sched.submit(prompt, max_new_tokens=5, park=True)
        _step_until_done(sched, [first])
        eos = first.tokens[2] if finish == "eos" else None
        if eos is not None:
            sched.stop(drain=False)
            sched = type(sched)(sched._engine, sched._config, start=False)
            first = sched.submit(prompt, max_new_tokens=5, park=True, eos_token_id=eos)
            _step_until_done(sched, [first])
        frame = first.park_payload
        header = (j_handoff if isinstance(sched, jserving.ServingScheduler) else t_handoff).unpack(frame)[0]
        extended = prompt + list(first.tokens) + [7, 8, 9]
        second = sched.submit_resume(frame, prompt=extended, max_new_tokens=4)
        _step_until_done(sched, [second])
        header.pop("kv_crc32")  # each engine's own f32 KV
        runs.append(dict(first=list(first.tokens), reason=first.finish_reason, header=header,
                         second=list(second.tokens), cached=second.cached_tokens, tier=second.kv_tier_source,
                         counters=sched.stats()["counters"]))
        with pytest.raises(ValueError) as e:
            sched.submit_resume(frame, prompt=prompt[:5])
        runs[-1]["refusal"] = str(e.value)
        sched.stop(drain=False)
    assert runs[1] == runs[0]
    assert runs[0]["reason"] == finish and runs[0]["header"]["version"] == 2
    assert runs[0]["counters"]["parks"] == 1 and runs[0]["counters"]["rehydrates"] == 1


def test_unparked_resume_without_next_token_is_refused_as_the_reference(setup):
    jeng, teng = _engines(setup)
    jeng.put([1], [np.arange(12)])
    frame = jeng.export_sequence(1, tokens=list(range(12)))
    msgs = []
    for sched in (jserving.ServingScheduler(jeng, jserving.ServingConfig(), start=False),
                  ServingScheduler(teng, ServingConfig(), start=False)):
        with pytest.raises(ValueError) as e:
            sched.submit_resume(frame)
        msgs.append(str(e.value))
        sched.stop(drain=False)
    assert msgs[1] == msgs[0] and "next_token" in msgs[0]


def test_export_prefix_and_peer_fetch_hit(setup, make_engine):
    """Donor: the published trie path as a CRC'd frame of full blocks (its
    header the JAX donor's); recipient: the peer-fetch hook imports it into
    the trie and the request is served from it, token for token as cold."""
    prompt = _prompts(47, (40, ))[0]
    frames = []
    for pkg in ("jax", "port"):
        sched = _schedulers(setup, prefix_cache={"enabled": True})[0 if pkg == "jax" else 1]
        req = sched.submit(prompt, max_new_tokens=2)
        _step_until_done(sched, [req])
        chain = digest_chain(prompt, 16)
        frames.append(sched.export_prefix(chain))
        assert sched.export_prefix(chain, min_blocks=3) is None
        sched.stop(drain=False)
    jheader, jkv = j_handoff.unpack(frames[0])
    theader, tkv = t_handoff.unpack(frames[1])
    assert {k: v for k, v in theader.items() if k != "kv_crc32"} == \
        {k: v for k, v in jheader.items() if k != "kv_crc32"}
    np.testing.assert_allclose(tkv.numpy(), jkv, rtol=1e-4, atol=1e-4)
    assert theader["tokens"] == prompt[:32] and theader["extra"] == {"kind": "prefix"}

    cold = ServingScheduler(make_engine(), ServingConfig(), start=False)
    want = cold.submit(prompt, max_new_tokens=4)
    _step_until_done(cold, [want])
    cold.stop(drain=False)
    sched = ServingScheduler(make_engine(), ServingConfig(prefix_cache=PrefixCacheConfig(enabled=True)), start=False)
    seen, notes = [], []
    sched._peer_fetch = lambda digests, have: (seen.append(have), frames[1])[1]
    sched._peer_fetch_notify = notes.append
    req = sched.submit(prompt, max_new_tokens=4)
    _step_until_done(sched, [req])
    assert seen == [0] and notes == ["hit"] and req.cached_tokens == 32 and req.tokens == want.tokens
    counters = sched.stats()["counters"]
    assert (counters["peer_fetch_hits"], counters["peer_fetch_blocks"], counters["prefix_hits"]) == (1, 2, 1)
    bad = bytearray(frames[1])
    bad[-3] ^= 1
    sched._peer_fetch = lambda digests, have: bytes(bad)
    other = sched.submit(_prompts(48, (40, ))[0], max_new_tokens=1)
    _step_until_done(sched, [other])
    assert notes[-1] == "reject" and sched.stats()["counters"]["peer_fetch_rejects"] == 1
    sched.stop(drain=False)


# ------------------------------------------------- streaming resume decoder --
def _resume_body(n, seed=0, **fields):
    payload = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    doc = dict(max_new_tokens=3, **fields)
    doc["payload"] = base64.b64encode(payload).decode()
    return json.dumps(doc).encode(), payload


@pytest.mark.parametrize("chunk", [1, 3, 7, 64, 1 << 20])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 100, 8451])
def test_streaming_resume_body_decoder_matches_the_reference(monkeypatch, chunk, n):
    body, payload = _resume_body(n, seed=n, temperature=0.5, prompt=[1, 2])
    monkeypatch.setattr(j_server, "_DECODE_CHUNK", chunk)
    monkeypatch.setattr(t_server, "_DECODE_CHUNK", chunk)
    want = j_server.read_resume_body(io.BytesIO(body), len(body))
    got = t_server.read_resume_body(io.BytesIO(body), len(body))
    assert got == want and bytes(got["payload"]) == payload


@pytest.mark.parametrize("body", [
    json.dumps({"payload": base64.b64encode(b"x" * 64).decode()}).encode()[:-10],
    json.dumps({"prompt": [1, 2]}).encode(),
    b'{"payload": "AAA!"}',
    b'["payload", 1]',
], ids=["truncated", "no_payload", "bad_base64", "not_object"])
def test_streaming_resume_body_refusals_match_the_reference(body):
    n = len(body) + 10 if body.endswith(b"==") else len(body)
    errors = []
    for mod in (j_server, t_server):
        with pytest.raises((ValueError, KeyError)) as e:
            mod.read_resume_body(io.BytesIO(body), n)
        errors.append((type(e.value), str(e.value)))
    assert errors[1] == errors[0]


# ------------------------------------------------------------- tier store --
def _payload(seed=0, n=2):
    return np.random.default_rng(seed).standard_normal((1, 2, n, 1, 4, 8)).astype(np.float32)


def _store_script(store, to_array, tmp, script):
    """Apply ops to one store; returns (result, tier map, stats) after each."""
    handles, trace = [], []
    for op, *args in script:
        if op == "put":
            handles.append(store.put(to_array(_payload(*args[:1])), pin_host=bool(args[1:] and args[1])))
            result = handles[-1]
        elif op == "read":
            data, tier = store.read(handles[args[0]])
            result = (np.asarray(data).tolist(), tier)
        elif op == "demote":
            result = store.demote(handles[args[0]], wait=True)
        elif op == "drop":
            result = store.drop(handles[args[0]])
        elif op == "pin":
            result = store.pin(handles[args[0]], args[1])
        elif op == "configure":
            store.configure(spill_dir=str(tmp) if args[0] else None, host_bytes=args[1])
            deadline = time.monotonic() + 10
            while store.stats()["writeback_pending"] or any(
                    store._entries[h].state == "writing" for h in handles if h in store):
                assert time.monotonic() < deadline
                time.sleep(0.005)
            result = None
        trace.append((op, result, {h: store.tier_of(h) for h in handles if h in store}, store.stats()))
    store.close()
    return trace


STORE_SCRIPTS = {
    "host_tier_put_read_drop": (False, [("put", 0), ("put", 1, False), ("read", 0), ("drop", 0), ("read", 1)]),
    "explicit_demote_spills_and_reads_back": (True, [("put", 2), ("demote", 0), ("read", 0), ("read", 0),
                                                     ("drop", 0)]),
    "demote_without_spill_dir_is_refused": (False, [("put", 3), ("demote", 0), ("read", 0)]),
    "host_budget_demotes_lru_first": (False, [("put", 0), ("put", 1), ("put", 2), ("read", 0),
                                              ("configure", True, 300), ("read", 1), ("read", 0), ("read", 2)]),
    "pinned_entries_never_demote": (True, [("put", 0, True), ("demote", 0), ("pin", 0, False), ("demote", 0),
                                           ("read", 0)]),
    "configure_retrofits_policy": (False, [("put", 5), ("demote", 0), ("configure", True, None), ("demote", 0),
                                           ("read", 0), ("drop", 0)]),
}


@pytest.mark.parametrize("name", list(STORE_SCRIPTS))
def test_tier_store_scripts_match_the_reference(tmp_path, name):
    spill, script = STORE_SCRIPTS[name]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    want = _store_script(j_tiering.TieredKVStore(spill_dir=str(jdir) if spill else None), np.asarray, jdir, script)
    got = _store_script(t_tiering.TieredKVStore(spill_dir=str(tdir) if spill else None), torch.from_numpy, tdir,
                        script)
    assert got == want
    assert t_tiering.TIERS == j_tiering.TIERS


def test_demote_race_reader_wins_as_in_the_reference(tmp_path):
    """A read in the window between the spill write and the commit reclaims
    the entry to the host tier; the writer discards its file and counts the
    race, on both stores."""
    results = []
    for mod, to_array, sub in ((j_tiering, np.asarray, "jax"), (t_tiering, torch.from_numpy, "port")):
        store = mod.TieredKVStore(spill_dir=str(tmp_path / sub))
        data = _payload(seed=4)
        h = store.put(to_array(data))
        raced = threading.Event()

        def hook(handle, store=store):
            got, tier = store.read(handle)
            np.testing.assert_array_equal(np.asarray(got), data)
            raced.set()

        store.race_hook = hook
        store.demote(h, wait=True)
        assert raced.wait(5)
        results.append((store.tier_of(h), store.stats(), sorted(p.name for p in (tmp_path / sub).glob("*.bin"))))
        store.close()
    assert results[1] == results[0] and results[0][1]["demote_races"] == 1 and results[0][2] == []


# ------------------------------------------------------------ kv offload/AIO --
def test_aio_loader_builds_and_round_trips(tmp_path):
    assert t_aio.aio_available()
    handle = t_aio.AsyncIOHandle(thread_count=2)
    assert handle._handle is not None  # the native engine, not the Python pool
    buf = np.random.default_rng(0).integers(0, 256, 3 << 20, dtype=np.uint8)
    path = str(tmp_path / "a.bin")
    assert handle.sync_pwrite(buf, path) == buf.nbytes
    back = np.empty_like(buf)
    rids = [handle.async_pread(back[i << 20:(i + 1) << 20], path, offset=i << 20) for i in range(3)]
    assert [handle.wait(r) for r in rids] == [1 << 20] * 3
    np.testing.assert_array_equal(back, buf)
    with pytest.raises(OSError):
        handle.sync_pread(back, str(tmp_path / "missing.bin"))
    handle.close()


def test_aio_falls_back_to_a_thread_pool_when_the_build_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(t_aio_op, "_LIB", None)
    monkeypatch.setattr(t_aio_op, "_LIB_TRIED", False)
    monkeypatch.setattr(t_aio_op.builder, "load_host", lambda *a: (_ for _ in ()).throw(RuntimeError("no g++")))
    assert not t_aio_op.aio_available()
    handle = t_aio_op.AsyncIOHandle()
    buf = np.arange(1000, dtype=np.uint8)
    handle.sync_pwrite(buf, str(tmp_path / "b.bin"))
    back = np.empty_like(buf)
    handle.sync_pread(back, str(tmp_path / "b.bin"))
    np.testing.assert_array_equal(back, buf)
    handle.close()


@pytest.mark.parametrize("nvme", [False, True])
def test_offload_restore_round_trip_and_flush(make_engine, tmp_path, nvme):
    engine = make_engine(offload_path=str(tmp_path) if nvme else None)
    sm = engine._state_manager
    engine.put([1], [np.arange(40)])
    blocks = sm.get_sequence(1).kv_blocks
    before = sm.kv_cache.cache[:, :, torch.from_numpy(blocks)].clone()
    engine.offload_sequence(1)
    assert sm.sequence_tier(1) == ("disk" if nvme else "host")
    assert len(list(tmp_path.glob("*.bin"))) == (1 if nvme else 0)
    engine._restore_offloaded([1])
    after = sm.kv_cache.cache[:, :, torch.from_numpy(sm.get_sequence(1).kv_blocks)]
    assert torch.equal(after, before) and sm.sequence_tier(1) == "device"
    engine.offload_sequence(1)
    engine.flush(1)
    assert engine.free_blocks == 64 and not list(tmp_path.glob("*.bin"))
    if nvme:
        assert sm.kv_cache._aio._handle is not None  # spilled through the native engine


def test_restore_failure_keeps_the_payload(make_engine, tmp_path):
    engine = make_engine(num_blocks=6, offload_path=str(tmp_path))
    sm = engine._state_manager
    engine.put([1], [np.arange(40)])
    engine.offload_sequence(1)
    hog = sm.kv_cache.reserve(sm.kv_cache.free_blocks - 1)
    with pytest.raises(ValueError, match="free blocks"):
        sm.restore_sequence(1)
    assert sm.is_offloaded(1) and sm.sequence_tier(1) == "disk"
    sm.kv_cache.free(hog)
    sm.restore_sequence(1)
    assert not sm.is_offloaded(1)


# ---------------------------------------------------- serving tier controller --
def _tiered(tmp_path, **kw):
    return ServingConfig(prefix_cache=PrefixCacheConfig(enabled=True),
                         kv_tiers=KVTierConfig(enabled=True, spill_dir=str(tmp_path), **kw))


def test_evict_one_demotes_trie_nodes_before_evicting(make_engine, tmp_path):
    engine = make_engine(num_blocks=8)
    sched = ServingScheduler(engine, _tiered(tmp_path, host_bytes=0), start=False)
    p = _prompts(51, (48, ))[0]
    seed = sched.submit(p, max_new_tokens=2)
    _step_until_done(sched, [seed])
    assert sched._evict_one(set())
    assert sched.stats()["counters"]["tier_demotions"] == 1 and sched._prefix_cache.offloaded_nodes == 1
    again = sched.submit(p, max_new_tokens=2)  # the demoted node promotes on the hit
    _step_until_done(sched, [again])
    assert again.tokens == seed.tokens and sched._prefix_cache.tier_promotions == 1
    sched.stop(drain=False)
    assert engine.free_blocks == 8


def _brownout_config(tmp_path, tiered):
    kv = KVTierConfig(enabled=True, spill_dir=str(tmp_path), demote_batch=1) if tiered else KVTierConfig()
    return ServingConfig(kv_tiers=kv, prefix_cache=PrefixCacheConfig(enabled=True), queue_capacity=4,
                         overload=OverloadConfig(brownout_stage_thresholds=(0.05, 0.85, 0.95), pressure_alpha=1.0,
                                                 min_rate_samples=1, admission_control=False))


def _pressure_with_doomed_queue(sched):
    """The reference's set-up: pin trie blocks (warming the rate estimator),
    queue deadline-doomed work, and let the deadlines pass."""
    reqs = [sched.submit([(7 * i + k) % 64 for k in range(17)], max_new_tokens=3) for i in range(3)]
    _step_until_done(sched, reqs)
    assert sched._prefix_cache.n_blocks > 0
    doomed = [sched.submit([(50 + i + k) % 64 for k in range(12)], max_new_tokens=64, deadline_s=0.01)
              for i in range(3)]
    time.sleep(0.02)
    return doomed


def test_brownout_demotes_before_shedding(make_engine, tmp_path):
    """While the ladder has somewhere to put idle KV, pressure ticks demote
    instead of shedding; the same set-up without tiers sheds (the control)."""
    control = ServingScheduler(make_engine(num_blocks=16), _brownout_config(tmp_path / "c", tiered=False),
                               start=False)
    _pressure_with_doomed_queue(control)
    control._overload_tick(time.monotonic())
    assert control.stats()["counters"]["shed_queue"] > 0
    control.stop(drain=False)
    sched = ServingScheduler(make_engine(num_blocks=16), _brownout_config(tmp_path / "t", tiered=True), start=False)
    doomed = _pressure_with_doomed_queue(sched)
    for _ in range(2):
        sched._overload_tick(time.monotonic())
    counters = sched.stats()["counters"]
    assert counters["brownout_demotions"] > 0 and counters["shed_queue"] == 0
    assert not any(r.finished for r in doomed)
    for r in doomed:
        r.cancel()
    sched.stop(drain=False)


def test_tier_stats_block_and_gauges(make_engine, tmp_path):
    """/v1/stats carries the kv_tiers block and the serving_kv_tier_*
    gauges follow the store; a scheduler without tiers reports None."""
    from deepspeed_tpu_torch import telemetry as ttel
    ttel.configure({"enabled": True})
    try:
        sched = ServingScheduler(make_engine(num_blocks=8),
                                 dataclasses.replace(_tiered(tmp_path), cost=CostConfig(enabled=False)), start=False)
        doc = sched.stats()["kv_tiers"]
        assert doc["enabled"] is True and doc["device_blocks_total"] == 8
        assert {"host_blocks", "disk_blocks", "demotions", "pressure_demotions", "trie_offloaded_nodes"} <= set(doc)
        r = sched.submit(_prompts(55, (48, ))[0], max_new_tokens=2)
        _step_until_done(sched, [r])
        sched._overload_tick(time.monotonic())
        text = ttel.get_registry().render_prometheus()
        sched.stop(drain=False)
    finally:
        ttel.shutdown()
        ttel.state.registry = None
    assert "serving_kv_tier_device_blocks 3" in text and "serving_kv_tier_host_blocks 0" in text
    plain = ServingScheduler(make_engine(), ServingConfig(), start=False)
    assert plain.stats()["kv_tiers"] is None
    plain.stop(drain=False)
