"""Small MLP decoder as explicit parameters (port of ``miso_tpu/ops/mlp.py``).

Linear(in, h) + ReLU, hidden_layers x [Linear(h, h) + ReLU], Linear(h, out).
Parameters are a tuple of (W, b) with W of shape (in, out), the JAX
package's layout, so weights carry across unchanged; b may be None.
Init follows torch.nn.Linear's defaults (uniform in +-1/sqrt(fan_in)).

:func:`fp32_matmul` is a matmul in full float32 on the card (no TF32),
forward and backward to any order, for the models whose JAX twins ask for
float32 products (``preferred_element_type=float32``).
"""
from __future__ import annotations

import contextlib
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


def mlp_num_params(params: Params) -> int:
    """Number of weights and biases of an MLP's ((W, b), ...)."""
    return sum(int(W.numel()) + (int(b.numel()) if b is not None else 0)
               for W, b in params)


@contextlib.contextmanager
def fp32_math():
    """cuDNN convolutions and CUDA matmuls in full float32 (no TF32) inside
    the block; the process's flags are restored after it."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


class _Fp32Matmul(torch.autograd.Function):
    """a @ b under :func:`fp32_math`; the backward's products are this
    function again, so every order of derivative stays in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with fp32_math():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = fp32_matmul(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = fp32_matmul(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, K) @ (K, M) in full float32, forward and backward."""
    return _Fp32Matmul.apply(a, b)
