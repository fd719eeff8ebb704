"""Small MLP decoder as explicit parameters (port of ``miso_tpu/ops/mlp.py``).

Linear(in, h) + ReLU, hidden_layers x [Linear(h, h) + ReLU], Linear(h, out).
Parameters are a tuple of (W, b) with W of shape (in, out), the JAX
package's layout, so weights carry across unchanged; b may be None.
Init follows torch.nn.Linear's defaults (uniform in +-1/sqrt(fan_in)).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Params = Tuple[Tuple[torch.Tensor, Optional[torch.Tensor]], ...]


def mlp_init(input_dim: int, output_dim: int, hidden_dim: int = 64,
             hidden_layers: int = 1, bias: bool = True,
             generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device="cuda") -> Params:
    """Draw decoder weights from ``generator`` (a CPU generator) onto ``device``."""
    dims = [input_dim] + [hidden_dim] * (hidden_layers + 1) + [output_dim]
    params = []
    for i in range(len(dims) - 1):
        lim = 1.0 / math.sqrt(dims[i])
        W = (torch.rand((dims[i], dims[i + 1]), generator=generator,
                        dtype=dtype) * 2.0 - 1.0) * lim
        b = None
        if bias:
            b = (torch.rand((dims[i + 1],), generator=generator,
                            dtype=dtype) * 2.0 - 1.0) * lim
            b = b.to(device)
        params.append((W.to(device), b))
    return tuple(params)


def mlp_apply(params: Params, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    """Forward pass; ReLU between layers, linear output."""
    n = len(params)
    for i, (W, b) in enumerate(params):
        x = x @ W
        if b is not None:
            x = x + b
        if i < n - 1:
            x = activation(x)
    return x
