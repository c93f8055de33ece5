"""PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference; each module here keeps the
path and names of its counterpart there. This package imports ``torch`` and
``numpy`` and never ``jax`` or anything of ``deepspeed_tpu``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler=None, collate_fn=None, config=None, config_params=None, device=None, param_specs=None):
    """Build the training engine (reference ``deepspeed/__init__.py:64``).

    ``model`` is a ``torch.nn.Module`` whose ``forward(batch)`` returns the
    scalar loss; ``model_parameters``, when given, is a ``state_dict`` loaded
    into it first. ``device`` defaults to ``cuda`` and raises without a GPU
    unless ``"cpu"`` is passed. Returns the reference's 4-tuple
    ``(engine, optimizer, dataloader, lr_scheduler)``. A
    ``PipelineModule`` gets the pipeline engine (reference
    ``deepspeed_tpu/__init__.py:92-99``), one process a stage.
    ``param_specs`` (``module_inject.auto_tp_specs(model)``) places the
    module's parameters on the mesh's ``model`` axis under
    ``tensor_parallel_size`` (reference ``deepspeed_tpu/__init__.py:67``);
    the pipeline engine takes none (reference ``pipe/engine.py:131-133``).
    """
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    if config is None:
        config = config_params
    if config is None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    assert config is not None, "DeepSpeed requires --deepspeed_config to specify configuration file"
    kw = {}
    if isinstance(model, PipelineModule):
        engine_cls = PipelineEngine
        if param_specs is not None:
            # the reference's PipelineEngine drops them too: its stages are
            # replicated over the model ranks, never tensor-parallel
            from deepspeed_tpu_torch.utils.logging import logger
            logger.info("param_specs with a PipelineModule: dropped, as the reference drops them (each stage is "
                        "replicated over the model ranks)")
    else:
        engine_cls = DeepSpeedEngine
        kw["param_specs"] = param_specs
    engine = engine_cls(model=model, model_parameters=model_parameters, optimizer=optimizer,
                        training_data=training_data, lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                        config=config, device=device, **kw)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
