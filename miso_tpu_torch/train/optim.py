"""Masked optimizers: Adam and SGD gated by a runtime mask (port of
``miso_tpu/train/optim.py``).

The mask is a dict over parameter names (``models/base.py``):

  * ``mask == 0`` -> the parameter is frozen and its moments are untouched,
    as if it were absent from a torch optimizer;
  * ``mask > 0``  -> it trains with its learning rate scaled by the mask.

Bias correction uses a per-element step count, so a parameter unlocked late
warms up as if its optimizer had just been created.  The update math is the
JAX package's, term for term.  Unlike the JAX version, updates are applied
in place to the parameters and to the state, which saves a copy of every
tensor per step; both are also returned.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from miso_tpu_torch.models.base import named_tensors


class MaskedAdamState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: Dict[str, torch.Tensor]   # per-element update counts


def masked_adam_init(params) -> MaskedAdamState:
    ps = named_tensors(params)

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in ps.items()}
    return MaskedAdamState(m=zeros(), v=zeros(), step=zeros())


@torch.no_grad()
def masked_adam_update(grads, state: MaskedAdamState, params, mask,
                       lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """One masked Adam step over ``params`` (a module or a name -> tensor dict).

    ``grads`` and ``mask`` are dicts keyed like ``params``.  Updates in place;
    returns (params, state).
    """
    ps = named_tensors(params)
    for k, p in ps.items():
        g = grads[k].to(torch.float32)
        mk = torch.as_tensor(mask[k], dtype=torch.float32, device=p.device)
        m, v, step = state.m[k], state.v[k], state.step[k]
        on_b = (mk > 0).to(torch.float32).expand(
            torch.broadcast_shapes(mk.shape, p.shape))
        m_new = torch.where(on_b > 0, b1 * m + (1 - b1) * g, m)
        v_new = torch.where(on_b > 0, b2 * v + (1 - b2) * g * g, v)
        step_new = step + on_b
        t = torch.clamp(step_new, min=1.0)
        m_hat = m_new / (1 - torch.pow(b1, t))
        v_hat = v_new / (1 - torch.pow(b2, t))
        delta = lr * mk * m_hat / (torch.sqrt(v_hat) + eps)
        p.sub_(delta.to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
        step.copy_(step_new)
    return params, state


class MaskedSgdState(NamedTuple):
    pass


def masked_sgd_init(params) -> MaskedSgdState:
    return MaskedSgdState()


@torch.no_grad()
def masked_sgd_update(grads, state: MaskedSgdState, params, mask, lr=1e-3):
    """p <- p - lr * mask * g, in place; returns (params, state)."""
    for k, p in named_tensors(params).items():
        mk = torch.as_tensor(mask[k], dtype=torch.float32, device=p.device)
        p.sub_((lr * mk * grads[k].to(torch.float32)).to(p.dtype))
    return params, state
