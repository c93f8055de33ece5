"""PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference; each module here keeps the
path and names of its counterpart there. This package imports ``torch`` and
``numpy`` and never ``jax`` or anything of ``deepspeed_tpu``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
