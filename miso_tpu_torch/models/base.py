"""Parameter-mask helpers (port of ``miso_tpu/models/base.py``).

A mask is a dict from a module's (or ``GridAtlasParams``') parameter names to float tensors that
broadcast against the parameter: 0 = frozen, 1 = train, other values scale
that parameter's learning rate (see ``train/optim.py``).  A "tree" here is
an ``nn.Module`` or anything else with ``named_parameters()`` (its named
parameters), or a dict of tensors.
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

Tree = Union[nn.Module, Dict[str, torch.Tensor]]


def named_tensors(tree: Tree) -> Dict[str, torch.Tensor]:
    """A module's (or an atlas's, ``GridAtlasParams``) named parameters, or a
    dict's entries."""
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    return dict(tree)


def tree_full_mask(model: Tree, value: float = 1.0) -> Dict[str, torch.Tensor]:
    """Mask with every entry set to ``value`` (scalar tensors)."""
    return {k: torch.tensor(float(value), dtype=torch.float32, device=p.device)
            for k, p in named_tensors(model).items()}


def tree_zero_mask(model: Tree) -> Dict[str, torch.Tensor]:
    return tree_full_mask(model, 0.0)


def tree_combine_masks(*masks):
    """Element-wise max of masks (union of trainable sets)."""
    out = dict(masks[0])
    for m in masks[1:]:
        for k, v in m.items():
            out[k] = torch.maximum(out[k], v)
    return out


def relative_param_change(curr: Tree, prev: Tree) -> torch.Tensor:
    """sqrt(sum ||curr - prev||^2 / sum ||prev||^2) over matching entries."""
    c, p = named_tensors(curr), named_tensors(prev)
    num = sum(torch.sum((c[k] - p[k]) ** 2) for k in p)
    den = sum(torch.sum(v ** 2) for v in p.values())
    return torch.sqrt(num / torch.clamp(den, min=1e-30))


def masked_select_tree(tree: Tree, mask) -> Dict[str, torch.Tensor]:
    """The entries where mask > 0, zeros elsewhere (for norms)."""
    return {k: v * (mask[k] > 0) for k, v in named_tensors(tree).items()}


def count_params(tree: Tree) -> int:
    return sum(int(v.numel()) for v in named_tensors(tree).values())


def sanitize_batch(batch):
    """NaN-scrub the floating-point entries of a batch dict."""
    return {k: torch.nan_to_num(v) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in batch.items()}
