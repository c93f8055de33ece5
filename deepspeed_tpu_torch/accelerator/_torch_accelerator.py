"""What the port's two accelerators share: torch tensor factories, the RNG
of ``torch``, and the names every torch device agrees on."""

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator


class TorchAccelerator(DeepSpeedAccelerator):

    def device(self, device_index=None):
        return torch.device(self.device_name(device_index))

    def random(self):
        return torch.random

    def manual_seed(self, seed):
        torch.manual_seed(seed)

    def initial_seed(self):
        return torch.initial_seed()

    def is_bf16_supported(self):
        return True

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16]

    def _factory(self, dtype):

        def make(*shape):
            if len(shape) == 1 and not isinstance(shape[0], int):
                return torch.as_tensor(shape[0], dtype=dtype, device=self.current_device_name())
            return torch.zeros(shape, dtype=dtype, device=self.current_device_name())

        return make

    @property
    def BFloat16Tensor(self):
        return self._factory(torch.bfloat16)

    @property
    def ByteTensor(self):
        return self._factory(torch.uint8)

    @property
    def DoubleTensor(self):
        return self._factory(torch.float64)

    @property
    def FloatTensor(self):
        return self._factory(torch.float32)

    @property
    def HalfTensor(self):
        return self._factory(torch.float16)

    @property
    def IntTensor(self):
        return self._factory(torch.int32)

    @property
    def LongTensor(self):
        return self._factory(torch.int64)

    def on_accelerator(self, tensor):
        return isinstance(tensor, torch.Tensor) and tensor.device.type == self._name

    def lazy_call(self, callback):
        return callback()

    def communication_backend_name(self):
        return self._communication_backend_name
