"""The train step (port of ``miso_tpu/train/trainer.py::make_train_step``).

One step: loss dict, total, gradients wrt every named parameter, the NaN
guard, and the masked optimizer update.  Training phases (per-level
coordinate descent, joint finetune, pose locking) change only the mask.
"""
from __future__ import annotations

from typing import Callable

import torch

from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.train.optim import masked_adam_update, masked_sgd_update

_UPDATES = {"adam": masked_adam_update, "sgd": masked_sgd_update}


def make_train_step(loss_fn: Callable, optimizer: str = "adam"):
    """Build the train step.

    loss_fn(model, batch, key) -> dict of scalar losses.
    The returned step(model, opt_state, batch, key, mask, lr) ->
    (model, opt_state, total, loss_dict) updates the model's parameters and
    the optimizer state in place and returns them.

    NaN guard: a non-finite total zeroes the effective mask, so the step
    changes no parameter and no moment; non-finite gradient entries become
    finite (``nan_to_num``).  The guard runs on the device, without a host
    read of the loss.
    """
    if optimizer not in _UPDATES:
        raise ValueError(f"Invalid optimizer: {optimizer}")
    update = _UPDATES[optimizer]

    def step(model, opt_state, batch, key, mask, lr):
        params = dict(model.named_parameters())
        loss_dict = loss_fn(model, batch, key)
        tl = total_loss(loss_dict)
        grads = torch.autograd.grad(tl, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else torch.nan_to_num(g)
                 for (k, p), g in zip(params.items(), grads)}
        guard = torch.isfinite(tl).to(torch.float32)
        eff_mask = {k: m * guard for k, m in mask.items()}
        update(grads, opt_state, params, eff_mask, lr=lr)
        return (model, opt_state, tl.detach(),
                {k: v.detach() for k, v in loss_dict.items()})

    return step
