"""Device choice for the port's entry points.

Every entry point runs on ``cuda`` unless its caller passes ``device="cpu"``
(the tests do). With no GPU and no explicit device it raises: a model meant
for the card never runs on the host without being asked to.
"""

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
