"""Spatial gradients of scalar fields (port of ``miso_tpu/ops/diff.py``).

``finitediff`` takes central differences.  ``autograd`` (and its alias
``autograd_vjp``) differentiates with ``torch.autograd.grad(...,
create_graph=True)``, so the result is itself differentiable: eikonal and
smoothness losses train through it.
"""
from __future__ import annotations

import torch


def gradient(x, f, method="autograd", finite_diff_eps=1e-2):
    """Gradient of a scalar field f at points x (N, d) -> (N, d).

    f maps (N, d) -> (N, 1) (or (N,)).
    """
    d = x.shape[-1]
    if method in ("finitediff", "finite_diff"):
        grads = []
        for k in range(d):
            e = torch.zeros((d,), dtype=x.dtype, device=x.device)
            e[k] = finite_diff_eps
            hi = f(x + e).reshape(-1, 1)
            lo = f(x - e).reshape(-1, 1)
            grads.append((hi - lo) / (2.0 * finite_diff_eps))
        return torch.cat(grads, dim=-1)
    if method in ("autograd", "autograd_vjp"):
        with torch.enable_grad():
            xx = x if x.requires_grad else x.detach().requires_grad_()
            (g,) = torch.autograd.grad(f(xx).sum(), xx, create_graph=True)
        return g
    raise ValueError(f"Unknown gradient method: {method}")


def gradient3d(x, f, method="autograd", finite_diff_eps=1e-2):
    if x.shape[-1] != 3:
        raise ValueError(f"expected (N, 3) points, got {tuple(x.shape)}")
    return gradient(x, f, method, finite_diff_eps)


def gradient2d(x, f, method="autograd", finite_diff_eps=1e-2):
    if x.shape[-1] != 2:
        raise ValueError(f"expected (N, 2) points, got {tuple(x.shape)}")
    return gradient(x, f, method, finite_diff_eps)
