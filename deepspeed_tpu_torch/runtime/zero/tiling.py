"""TiledLinear: a linear layer stored and computed as a grid of tiles.

Port of ``deepspeed_tpu/runtime/zero/tiling.py`` (``TiledLinear``,
``dense_kernel_to_tiles``, ``tiles_to_dense_kernel``). The weight is one
parameter ``kernel`` of shape ``[in_splits, out_splits, in/t, out/t]``, in
the reference's layout (not transposed as a ``torch.nn.Linear`` weight is),
so the ZeRO rule shards its leading tile axes and a stage-3 gather moves a
tile grid's chunk, never more than the rule cuts. The product is
``einsum("...xi,xyio->...yo")`` over the input split into ``in_splits``
pieces, and the bias is ``[out_splits, out/t]``: a reshape of the same
weight, so the numerics are a dense layer's.
"""

import torch
import torch.nn as nn


class TiledLinear(nn.Module):

    def __init__(self, in_features: int, out_features: int, bias: bool = True, in_splits: int = 1,
                 out_splits: int = 1, dtype=None, device=None):
        super().__init__()
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(f"tile grid {in_splits}x{out_splits} must divide ({in_features}, {out_features})")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        tin, tout = in_features // in_splits, out_features // out_splits
        self.kernel = nn.Parameter(torch.empty(in_splits, out_splits, tin, tout, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_splits, tout, dtype=dtype, device=device)) if bias else None
        with torch.no_grad():
            self.kernel.normal_(0.0, in_features**-0.5)

    def forward(self, x):
        lead = x.shape[:-1]
        xr = x.reshape(*lead, self.in_splits, self.in_features // self.in_splits)
        y = torch.einsum("...xi,xyio->...yo", xr, self.kernel.to(x.dtype)).reshape(*lead, self.out_features)
        if self.bias is not None:
            y = y + self.bias.reshape(self.out_features).to(y.dtype)
        return y

    def copy_params_from(self, linear: nn.Linear):
        """Take a dense ``torch.nn.Linear``'s weights (reference
        ``tiling.py:236``)."""
        with torch.no_grad():
            self.kernel.copy_(dense_kernel_to_tiles(linear.weight.t(), self.in_splits, self.out_splits))
            if self.bias is not None and linear.bias is not None:
                self.bias.copy_(linear.bias.reshape(self.out_splits, -1))
        return self


def dense_kernel_to_tiles(kernel, in_splits: int, out_splits: int):
    """A dense kernel ``[in, out]`` (a ``Linear`` weight transposed) as tiles
    ``[in_splits, out_splits, in/t, out/t]``."""
    i, o = kernel.shape
    tin, tout = i // in_splits, o // out_splits
    return kernel.reshape(in_splits, tin, out_splits, tout).permute(0, 2, 1, 3).contiguous()


def tiles_to_dense_kernel(tiles):
    """The inverse of :func:`dense_kernel_to_tiles`."""
    ins, outs, tin, tout = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(ins * tin, outs * tout)
