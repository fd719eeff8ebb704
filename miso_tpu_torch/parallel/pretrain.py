"""Multi-scene decoder pretraining with the scenes stacked as atlas slots
(port of ``miso_tpu/parallel/pretrain.py``).

Each scene's grids are one slot of a ``GridAtlas`` (padded storage with
logical sizes, scene s in slot s) and all scenes share one decoder.  Every
step trains every scene: the per-scene TSDF losses, averaged over the
active scenes, with the grid gradients kept per scene and the decoder's
summed over them.  All the scenes a rank holds go through the atlas's
per-point path in one pass (``GridAtlasParams.forward_per_point``: one
slot-id interp call a level, then one decode).  With the stack sharded over
a ``scene`` axis (:func:`shard_scene_stack`) each rank holds a block of
scenes, the loss's denominator and the decoder's gradient are summed over
the ranks, and the result is the one-rank step's.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.models.grid_net import create_grid_net
from miso_tpu_torch.ops.diff import gradient3d
from miso_tpu_torch.parallel.sharding import _replicated_names, shard_atlas
from miso_tpu_torch.train.optim import masked_adam_update
from miso_tpu_torch.train.trainer import guarded_update, trained_leaves


def build_scene_stack(cfg_model: Dict, bounds: Sequence[np.ndarray],
                      generator: Optional[torch.Generator] = None, device="cuda") -> GridAtlas:
    """An atlas with one slot per scene (its bound, identity pose, one
    keyframe) and one shared decoder: each scene's grids drawn by
    ``create_grid_net`` from ``generator`` in scene order, the decoder the
    first scene's.  Its parameters require gradients."""
    cfg = copy.deepcopy(cfg_model)
    cfg.setdefault("pose", {})
    cfg["pose"]["optimize"] = False
    cfg["pose"]["num_poses"] = 1
    atlas = GridAtlas(cfg, max_kfs_per_submap=1, device=device)
    for b in bounds:
        atlas.add_submap(np.asarray(b, np.float32))
        atlas.add_kf()
    decoder = None
    for s, b in enumerate(bounds):
        g = create_grid_net(cfg, bound=np.asarray(b, np.float32), num_poses=1,
                            generator=generator, device=device)
        if decoder is None:
            decoder = [t.detach().clone() for t in g.decoder]
        atlas.set_submap(s, g)
    with torch.no_grad():
        for dst, src in zip((t for pair in atlas.params.decoder for t in pair), decoder):
            dst.copy_(src)
    atlas.params.requires_grad_()
    return atlas


def scene_tsdf_loss(params, batches: Dict, key=None, sdf_weight=3e3, sign_weight=1e2,
                    eik_weight=5e1, trunc_dist=0.15, uniforms=None) -> torch.Tensor:
    """The TSDF loss (``losses/sdf.py::tsdf_loss_3d``) of every scene slot
    ``params`` holds, (S,): ``batches`` hold (S, N, ...) scene-frame samples.

    The eikonal's N points a scene are uniform in the scene's own bound:
    ``uniforms`` (S, N, 3) in [0, 1), else drawn from ``key`` (a
    ``torch.Generator`` on the samples' device) for every scene of the
    whole stack (``params.slot_total``), this shard keeping its own rows, so
    a shard draws the one-rank step's points.
    """
    coords = batches["coords"]
    S, N = int(coords.shape[0]), int(coords.shape[1])
    ids = torch.arange(S, dtype=torch.int32, device=coords.device).repeat_interleave(N)

    def field(x):
        return params.forward_per_point(ids, x).reshape(S, N)

    pred = field(coords.reshape(S * N, 3))
    gt = batches["sdf"].reshape(S, N)
    zero = torch.zeros_like(pred)
    c = torch.where(batches["sdf_valid"].reshape(S, N) == 1, pred - gt, zero)
    total = torch.mean(c ** 2, dim=1) * sdf_weight
    if sign_weight > 0:
        sign = batches["sdf_signs"].reshape(S, N)
        pos = torch.where(sign == 1, trunc_dist - pred, zero)
        neg = torch.where(sign == -1, pred + trunc_dist, zero)
        total = total + (torch.mean(torch.relu(pos), dim=1)
                         + torch.mean(torch.relu(neg), dim=1)) * sign_weight
    if eik_weight > 0:
        if uniforms is None:
            first = params.slot_offset
            every = params.slot_total or S
            uniforms = torch.rand((every, N, 3), generator=key,
                                  device=coords.device)[first:first + S]
        b = params.bounds[:, None]                                      # (S, 1, 3, 2)
        pts = (b[..., 0] + uniforms * (b[..., 1] - b[..., 0])).reshape(S * N, 3)
        g = gradient3d(pts, lambda x: field(x).reshape(S * N, 1))
        eik = (torch.linalg.vector_norm(g, dim=-1) - 1.0) ** 2
        total = total + torch.mean(eik.reshape(S, N), dim=1) * eik_weight
    return total


def scene_parallel_grads(params, batches: Dict, key, names: Sequence[str],
                         scene_loss_fn: Callable = scene_tsdf_loss, **loss_kwargs):
    """(total, gradients by parameter name) of the stack's objective
    sum(loss_s * active_s) / max(sum(active_s), 1) over every scene (the
    sums crossing a shard's scene axis), for the parameters ``names`` alone
    (every rank giving the same names): each scene's grid gradients its
    own, the decoder's summed over the scenes of every rank."""
    named = dict(params.named_parameters())
    ax = params.slot_axis
    losses = scene_loss_fn(params, batches, key, **loss_kwargs)
    sums = torch.stack([torch.sum(losses * params.active), torch.sum(params.active)])
    if ax is not None:
        sums = ax.psum(sums)
    tl = sums[0] / torch.clamp(sums[1], min=1.0)
    if not names:
        return tl, {}
    grads = torch.autograd.grad(tl, [named[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(named[k]) if g is None else g for k, g in zip(names, grads)}
    if ax is not None:
        ax.sum_([grads[k] for k in _replicated_names(params) if k in grads])
    return tl, grads


def scene_parallel_decoder_step(scene_loss_fn: Callable = scene_tsdf_loss, **loss_kwargs):
    """One step training every scene of a stack (or of a
    :func:`shard_scene_stack` shard).

    step(params, opt_state, batches, key, mask, lr) -> (params, opt_state,
    total): :func:`scene_parallel_grads` of the leaves the mask trains
    (``train/trainer.py::trained_leaves``), then the NaN guard and masked
    Adam of those, in place.  ``batches`` hold the (S, N, ...) samples of
    the scenes ``params`` holds (:func:`stack_scene_batches`).
    """

    def step(params, opt_state, batches, key, mask, lr):
        named = dict(params.named_parameters())
        names = trained_leaves(named, mask)
        tl, grads = scene_parallel_grads(params, batches, key, names, scene_loss_fn,
                                         **loss_kwargs)
        guarded_update(masked_adam_update, {k: named[k] for k in names},
                       [grads[k] for k in names], opt_state, mask, lr, tl)
        return params, opt_state, tl.detach()

    return step


def stack_scene_batches(batches: Sequence[Dict], mesh=None, axis: str = "scene",
                        device=None) -> Dict:
    """Per-scene sample dicts stacked on a leading scene axis as tensors on
    ``device`` (``coords_frame`` named ``coords``: scene samples are in the
    scene's frame); with a mesh, this rank's block of scenes."""
    out = {}
    for k in batches[0]:
        arr = np.stack([np.asarray(b[k]) for b in batches])
        if mesh is not None:
            arr = arr[mesh.axis(axis).rows(arr.shape[0])]
        out["coords" if k in ("coords_frame", "coords") else k] = torch.as_tensor(
            arr, device=device)
    return out


def shard_scene_stack(params, mesh, axis: str = "scene"):
    """This rank's block of scenes; the decoder and the keyframe tables
    whole (``parallel/sharding.py::shard_atlas``), every leaf requiring
    gradients."""
    return shard_atlas(params, mesh, axis).requires_grad_()
