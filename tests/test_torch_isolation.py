"""The port stands alone: no module of deepspeed_tpu_torch, and nothing that
chip_smoke.py imports, loads jax, flax, pydantic, ml_dtypes, orbax or deepspeed_tpu; and its
entry points refuse to fall back to the CPU when no GPU is present."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import deepspeed_tpu_torch
names = ["deepspeed_tpu_torch"] + [m.name for m in pkgutil.walk_packages(deepspeed_tpu_torch.__path__,
                                                                        "deepspeed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: the script runs under __main__
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "pydantic", "ml_dtypes", "orbax", "deepspeed_tpu"))
print(json.dumps({"imported": names, "banned": banned}))
"""


def test_port_and_chip_smoke_import_no_jax_flax_pydantic_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deepspeed_tpu_torch.ops.paged_attention" in result["imported"]
    assert "deepspeed_tpu_torch.inference.v2.engine_factory" in result["imported"]
    assert "deepspeed_tpu_torch.ops.flash_attention" in result["imported"]
    assert "deepspeed_tpu_torch.runtime.engine" in result["imported"]
    assert "deepspeed_tpu_torch.ops.block_sparse_attention" in result["imported"]
    assert "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention" in result["imported"]
    assert "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config" in result["imported"]
    for name in ("registry", "spans", "config", "catalog", "exporter", "flight_recorder", "compile_watch"):
        assert f"deepspeed_tpu_torch.telemetry.{name}" in result["imported"]
    for name in ("overload", "request", "config", "metrics", "scheduler", "server"):
        assert f"deepspeed_tpu_torch.serving.{name}" in result["imported"]
    for name in ("tiering", "prefix_cache", "handoff"):
        assert f"deepspeed_tpu_torch.inference.v2.ragged.{name}" in result["imported"]
    assert "deepspeed_tpu_torch.serving.kv_tiers" in result["imported"]
    assert "deepspeed_tpu_torch.ops.aio.aio_op" in result["imported"]
    for name in ("tree", "drafter", "learned", "distill"):
        assert f"deepspeed_tpu_torch.inference.v2.spec.{name}" in result["imported"]
    for name in ("ledger", "timeseries", "slo"):
        assert f"deepspeed_tpu_torch.telemetry.{name}" in result["imported"]
    for name in ("chip_specs", "observed"):
        assert f"deepspeed_tpu_torch.perf.{name}" in result["imported"]
    assert "deepspeed_tpu_torch.inference.v2.tracer" in result["imported"]
    for name in ("runtime.checkpoint_engine.engine", "runtime.sentinel", "runtime.faults", "env_report",
                 "ops.lamb.fused_lamb", "ops.lamb.onebit_lamb", "ops.lion.fused_lion", "ops.adagrad.cpu_adagrad",
                 "ops.sgd.sgd", "ops.adam.onebit_adam", "ops.adam.zero_one_adam"):
        assert f"deepspeed_tpu_torch.{name}" in result["imported"]
    for name in ("utils.timer", "runtime.progressive_layer_drop", "runtime.eigenvalue", "runtime.dataloader",
                 "runtime.data_pipeline.curriculum_scheduler", "runtime.data_pipeline.data_sampler",
                 "runtime.data_pipeline.data_sampling.indexed_dataset",
                 "runtime.data_pipeline.data_sampling.data_analyzer", "runtime.data_pipeline.data_routing.random_ltd",
                 "compression.basic_layer", "compression.compress", "compression.scheduler"):
        assert f"deepspeed_tpu_torch.{name}" in result["imported"]
    for name in ("fleet", "fleet.breaker", "fleet.config", "fleet.faults", "fleet.metrics", "fleet.global_queue",
                 "fleet.park_store", "fleet.replica", "fleet.manager", "fleet.supervisor", "fleet.policy",
                 "fleet.router", "elasticity.elasticity", "telemetry.collector", "bin.dstpu_replica"):
        assert f"deepspeed_tpu_torch.{name}" in result["imported"]
    assert result["banned"] == []


def test_entry_points_refuse_the_cpu_without_being_asked(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.bin import dstpu_replica
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from deepspeed_tpu_torch.utils.device import resolve_device

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, device="cpu")
    train_cfg = {"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    train = lambda **kw: deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(cfg), config=train_cfg, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    replica = lambda *argv: dstpu_replica.build_engine_from_args(dstpu_replica.parser().parse_args(list(argv)))
    for call in (lambda: resolve_device(None), lambda: init_params(cfg), lambda: build_engine(params, cfg), train,
                 replica):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_engine(params, cfg, device="cpu").device.type == "cpu"
    assert train(device="cpu")[0].device.type == "cpu"
    assert replica("--device", "cpu").device.type == "cpu"
