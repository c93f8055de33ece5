"""PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference; each module here keeps the
path and names of its counterpart there. This package imports ``torch`` and
``numpy`` and never ``jax`` or anything of ``deepspeed_tpu``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler=None, collate_fn=None, config=None, config_params=None, device=None):
    """Build the training engine (reference ``deepspeed/__init__.py:64``).

    ``model`` is a ``torch.nn.Module`` whose ``forward(batch)`` returns the
    scalar loss; ``model_parameters``, when given, is a ``state_dict`` loaded
    into it first. ``device`` defaults to ``cuda`` and raises without a GPU
    unless ``"cpu"`` is passed. Returns the reference's 4-tuple
    ``(engine, optimizer, dataloader, lr_scheduler)``.
    """
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if config is None:
        config = config_params
    if config is None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    assert config is not None, "DeepSpeed requires --deepspeed_config to specify configuration file"
    engine = DeepSpeedEngine(model=model, model_parameters=model_parameters, optimizer=optimizer,
                             training_data=training_data, lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             config=config, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
