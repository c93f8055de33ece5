from deepspeed_tpu_torch.ops.aio.aio_op import AsyncIOHandle, aio_available

__all__ = ["AsyncIOHandle", "aio_available"]
