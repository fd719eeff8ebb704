"""Auxiliary neural modules (port of ``miso_tpu/models/modules.py``):
:class:`FeatureUpsampler` and :class:`FeatureReduction3D`.

ConvInterp and FeaturePrediction, the encoder's core, live in
``models/encoder.py``.  Layouts are channel-last, as in the JAX package, and
the parameters keep its layouts (a transposed conv's kernel (*k, I, O), MLP
weights (in, out)), so its arrays carry across unchanged; ``forward`` turns
the kernel into torch's.  Random draws come from ``generator`` (a CPU
generator).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from miso_tpu_torch.ops.mlp import mlp_apply, mlp_init


def _mlp_parameters(params) -> nn.ParameterList:
    return nn.ParameterList([nn.Parameter(t) for pair in params for t in pair])


def _pairs(flat: nn.ParameterList):
    return tuple(zip(flat[0::2], flat[1::2]))


class FeatureUpsampler(nn.Module):
    """A 2x transposed convolution (kernel 2, stride 2, 2D or 3D) + ReLU, then
    a per-cell MLP refiner (one hidden layer of twice the output width).

    ``deconv_W`` is (*(2,)*dim, in_channels, out_channels) as the JAX
    package's ``lax.conv_transpose`` takes it (no kernel transpose): torch's
    ``conv_transpose`` computes the same map with the kernel flipped in
    space.
    """

    def __init__(self, dim: int, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.dim = dim
        lim = 1.0 / math.sqrt(in_channels * 2 ** dim)
        W = (torch.rand((2,) * dim + (in_channels, out_channels), generator=generator,
                        dtype=dtype) * 2.0 - 1.0) * lim
        self.deconv_W = nn.Parameter(W.to(device))
        self.deconv_b = nn.Parameter(torch.zeros((out_channels,), dtype=dtype, device=device))
        self.refiner = _mlp_parameters(mlp_init(out_channels, out_channels, 2 * out_channels, 1,
                                                bias=True, generator=generator, dtype=dtype,
                                                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (1, *spatial, C) -> (1, *(2 * spatial), C')."""
        d = self.dim
        spatial = tuple(range(d))
        # (*k, I, O) -> torch's (I, O, *k), flipped in space.
        W = self.deconv_W.flip(spatial).permute(d, d + 1, *spatial)
        conv_t = F.conv_transpose2d if d == 2 else F.conv_transpose3d
        y = conv_t(torch.movedim(x, -1, 1), W, self.deconv_b, stride=2)
        y = torch.relu(torch.movedim(y, 1, -1))
        out = mlp_apply(_pairs(self.refiner), y.reshape(-1, y.shape[-1]))
        return out.reshape(*y.shape[:-1], -1)


class FeatureReduction3D(nn.Module):
    """Max or mean over some spatial axes, then a per-cell MLP."""

    def __init__(self, input_dim: int, output_dim: int, mlp_hidden: int = 8,
                 mlp_layers: int = 1, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.mlp = _mlp_parameters(mlp_init(input_dim, output_dim, mlp_hidden, mlp_layers,
                                            bias=True, generator=generator, dtype=dtype,
                                            device=device))

    def forward(self, x: torch.Tensor, reduce_axes: Sequence[int],
                reduce_op: str = "max") -> torch.Tensor:
        """x: (1, gx, gy, gz, C); ``reduce_axes`` are spatial axes (1..3 in
        this layout), kept as size 1."""
        axes = tuple(reduce_axes)
        if reduce_op == "max":
            y = torch.amax(x, dim=axes, keepdim=True)
        elif reduce_op == "mean":
            y = torch.mean(x, dim=axes, keepdim=True)
        else:
            raise ValueError(f"Invalid reduce op: {reduce_op}")
        out = mlp_apply(_pairs(self.mlp), y.reshape(-1, y.shape[-1]))
        return out.reshape(*y.shape[:-1], -1)
