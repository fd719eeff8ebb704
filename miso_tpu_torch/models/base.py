"""Parameter-mask helpers (port of ``miso_tpu/models/base.py``).

A mask is a dict from a module's (or ``GridAtlasParams``') parameter names to float tensors that
broadcast against the parameter: 0 = frozen, 1 = train, other values scale
that parameter's learning rate (see ``train/optim.py``).  The functions here
and in ``models/`` that make masks return a :class:`Mask`, which also
carries the set of names it trains, decided on the host when it is built.
A mask is a value: to change one, build a new one (a tensor or an entry
changed in place would leave its trained set stale).  A "tree" here is an ``nn.Module`` or
anything else with ``named_parameters()`` (its named parameters), or a dict
of tensors.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn

from miso_tpu_torch.ops import se3

Tree = Union[nn.Module, Dict[str, torch.Tensor]]


def named_tensors(tree: Tree) -> Dict[str, torch.Tensor]:
    """A module's (or an atlas's, ``GridAtlasParams``) named parameters, or a
    dict's entries."""
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    return dict(tree)


class Mask(dict):
    """A mask (name -> float tensor) and ``trained``, the frozenset of the
    names it trains: fixed when it is built, from the host values it was
    built from, so reading it reads nothing from the device."""

    def __init__(self, entries: Dict[str, torch.Tensor], trained: Iterable[str]):
        super().__init__(entries)
        self.trained = frozenset(trained)


def tree_full_mask(model: Tree, value: float = 1.0) -> Mask:
    """Mask with every entry set to ``value`` (scalar tensors)."""
    named = named_tensors(model)
    return Mask({k: torch.tensor(float(value), dtype=torch.float32, device=p.device)
                 for k, p in named.items()}, named if float(value) != 0 else ())


def tree_zero_mask(model: Tree) -> Mask:
    return tree_full_mask(model, 0.0)


def tree_scale_mask(mask, scale: float):
    """Every entry of a mask times ``scale``: a :class:`Mask` training the
    same names (none for a scale of 0) when ``mask`` is one."""
    out = {k: m * scale for k, m in mask.items()}
    if not isinstance(mask, Mask):
        return out
    return Mask(out, mask.trained if scale != 0 else ())


def tree_combine_masks(*masks):
    """Element-wise max of masks (union of trainable sets): a :class:`Mask`
    training the union of their names when every one is a Mask."""
    out = dict(masks[0])
    for m in masks[1:]:
        for k, v in m.items():
            out[k] = torch.maximum(out[k], v)
    if not all(isinstance(m, Mask) for m in masks):
        return out
    return Mask(out, frozenset().union(*(m.trained for m in masks)))


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


def tree_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (a module's parameters, its
    buffers not included), in float32."""
    return torch.sqrt(sum(torch.sum(v.to(torch.float32) ** 2)
                          for v in named_tensors(tree).values()))


def check_tensor(x, name: str = "tensor"):
    """Raise ``ValueError`` when ``x`` holds a NaN or an infinity; else
    return it."""
    if not bool(torch.all(torch.isfinite(torch.as_tensor(x)))):
        raise ValueError(f"{name} contains NaN/Inf")
    return x


def sanitize_batch(batch):
    """NaN-scrub the floating-point entries of a batch dict."""
    return {k: torch.nan_to_num(v) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in batch.items()}


class KeyframePoses:
    """The keyframe pose API of the models: (K, 3) so(3) and translation
    corrections (parameters ``rot_corr``, ``trans_corr``) applied as
    ``R @ Exp(dr), t + dt`` on top of the buffered initial poses ``Rwk``
    (K, 3, 3) and ``twk`` (K, 3)."""

    @property
    def num_poses(self) -> int:
        return self.rot_corr.shape[0]

    def updated_kf_poses(self, lock_mask: Optional[torch.Tensor] = None):
        """All K corrected poses, batched.

        lock_mask: optional (K,) float; rows with 1 get no gradient.
        """
        dr, dt = self.rot_corr, self.trans_corr
        if lock_mask is not None:
            m = lock_mask[:, None]
            dr = dr.detach() * m + dr * (1.0 - m)
            dt = dt.detach() * m + dt * (1.0 - m)
        return se3.apply_pose_correction(self.Rwk, self.twk, dr, dt)

    @torch.no_grad()
    def updated_kf_pose(self, kf_id: int):
        """The corrected pose (R (3, 3), t (3,)) of local keyframe ``kf_id``."""
        R, t = self.updated_kf_poses()
        return R[kf_id], t[kf_id]

    @torch.no_grad()
    def set_initial_kf_pose(self, kf_id: int, R, t):
        """Set an initial pose and zero its corrections, in place; returns
        self."""
        self.Rwk[kf_id] = torch.as_tensor(R, dtype=self.Rwk.dtype)
        self.twk[kf_id] = torch.as_tensor(t, dtype=self.twk.dtype).reshape(3)
        self.rot_corr[kf_id] = 0.0
        self.trans_corr[kf_id] = 0.0
        return self
