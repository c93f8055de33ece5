"""Standalone serving-replica entry point (what the fleet supervisor spawns).

    python -m deepspeed_tpu_torch.bin.dstpu_replica --port 0 --port-file r0.port

One ``InferenceEngineV2 + ServingScheduler + ServingServer`` process speaking
the ``serving/server.py`` wire format (``POST /v1/generate`` / ``/v1/resume``
JSON+SSE, ``GET /v1/stats`` / ``/healthz``), suitable for:

- ``ReplicaSupervisor.add_process([... , "--port-file", "{port_file}"])`` —
  the supervised-fleet path: the replica binds an ephemeral port, announces
  ``"<host> <port>"`` via ``--port-file`` (atomic write), and the supervisor
  gates registration on ``/healthz`` readiness (``status: ok`` only once the
  scheduler loop ticks);
- ``ReplicaManager.add_upstream(url)`` — a manually-run upstream replica.

Port of ``bin/dstpu_replica``: the same arguments, plus ``--device`` (``cuda``
by default; without a GPU it raises unless ``--device cpu`` is given). The
model is the reference's tiny random Llama (``LlamaConfig.tiny`` in bf16 at
``--vocab-size`` and ``--max-context``), its weights drawn on the host from
``--params-seed``: two replicas launched with identical arguments build
identical weights, so KV handoffs between them are token-identical.
``--checkpoint DIR`` serves an HF checkpoint directory, or an
``InferenceEngineV2.serialize`` one, through ``engine_factory.build_hf_engine``
instead, as the reference does.

SIGTERM drains gracefully (in-flight requests finish bounded by
``--drain-timeout``); SIGKILL is the crash the supervisor's restart path
exists for.
"""

import argparse
import os
import signal
import threading


def build_engine_from_args(args):
    """The replica's engine on ``--device``, with the reference's KV pool and
    ragged limits: the checkpoint's model under ``--checkpoint``, else the
    tiny random Llama from ``--params-seed``."""
    import torch

    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, build_hf_engine
    from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import (AllocationMode, DSStateManagerConfig,
                                                                         MemoryConfig)
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_params

    engine_config = RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(
            memory_config=MemoryConfig(mode=AllocationMode.ALLOCATE, size=args.num_blocks),
            max_context=args.max_context,
            max_ragged_batch_size=args.max_ragged_batch_size,
            max_ragged_sequence_count=args.max_ragged_sequence_count),
        kv_block_size=args.block_size)
    if args.checkpoint:
        return build_hf_engine(args.checkpoint, engine_config, device=args.device)
    cfg = LlamaConfig.tiny(vocab_size=args.vocab_size, max_position_embeddings=args.max_context)
    params = init_params(cfg, torch.Generator().manual_seed(args.params_seed), device="cpu")
    return build_engine(params, cfg, engine_config, device=args.device)


def announce_port(port_file, host, port):
    """Atomic 'host port' announcement (tmp + rename): the supervisor never
    reads a half-written file."""
    tmp = f"{port_file}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{host} {port}\n")
    os.replace(tmp, port_file)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.bin.dstpu_replica",
                                description="standalone serving replica (fleet-supervisable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = ephemeral (announce via --port-file)")
    p.add_argument("--port-file", default=None, help="write '<host> <port>' here once the listener is bound")
    p.add_argument("--checkpoint", default=None, help="HF or serialize checkpoint dir (default: the tiny random Llama)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--vocab-size", type=int, default=512)
    p.add_argument("--max-context", type=int, default=128)
    p.add_argument("--num-blocks", type=int, default=128)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-ragged-batch-size", type=int, default=256)
    p.add_argument("--max-ragged-sequence-count", type=int, default=8)
    p.add_argument("--params-seed", type=int, default=0)
    p.add_argument("--decode-chunk", type=int, default=4)
    p.add_argument("--queue-capacity", type=int, default=128)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--telemetry", action="store_true", help="enable a telemetry session (metrics + spans)")
    p.add_argument("--timeseries", action="store_true",
                   help="with --telemetry: sample metric time-series so the probe doc carries a rollup")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.telemetry:
        from deepspeed_tpu_torch import telemetry
        telemetry.configure(telemetry.TelemetryConfig(enabled=True, timeseries={"enabled": args.timeseries}))

    from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler, ServingServer
    engine = build_engine_from_args(args)
    scheduler = ServingScheduler(engine, ServingConfig(
        decode_chunk=args.decode_chunk, queue_capacity=args.queue_capacity,
        drain_timeout_s=args.drain_timeout, heartbeat_enabled=True,
        host=args.host, port=args.port))
    server = ServingServer(scheduler).start()
    host, port = server.address
    if args.port_file:
        announce_port(args.port_file, host, port)
    print(f"dstpu_replica pid={os.getpid()} serving on {server.url} ({engine.device})", flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())
    signal.signal(signal.SIGINT, lambda signum, frame: done.set())
    done.wait()
    server.stop(drain=True, timeout=args.drain_timeout)
    engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
