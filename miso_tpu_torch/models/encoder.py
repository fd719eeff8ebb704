"""Hierarchical encoder: learned initialization of grid features (port of
``miso_tpu/models/encoder.py``).

For each level, coarse to fine (:func:`predict_corrections_until_level`):

  1. the SDF and free-space residuals at the observed points under the
     corrections predicted so far (:func:`compute_residuals`), queried
     through the same interp and decode ops as ``GridNet.forward``: on the
     card one interp kernel launch per level and one decode kernel launch
     per residual pass;
  2. scatter-averaged into a (1, gx, gy, gz, 3) volume at the level's
     resolution (``ops/pooling.py::grid_pool_avg``);
  3. the level's :class:`FeaturePrediction` (a Conv3d + ReLU stack, a resize
     to the level's shape, a per-cell MLP) predicts that level's feature
     correction.

The public layouts are the JAX package's, channel-last: volumes
(1, gx, gy, gz, C) in, feature grids (gx, gy, gz, F) out; the convolutions
permute to torch's (N, C, D, H, W) inside.  Their weights are torch's
(O, I, D, H, W); :meth:`FeaturePrediction.tree_fields` writes them in the
JAX package's (D, H, W, I, O), so ``feature_encoder_level_{l}.npz`` files
load in either package.

The convolutions, the resize and the per-cell MLP run in float32, forward
and backward, whatever the process's TF32 flags say (:func:`fp32_math`,
:func:`float32_call`), as the JAX encoder asks for ``Precision.HIGHEST``.
Random numbers (initial weights, the ``pred_std`` noise) come from explicit
``torch.Generator``s, so their streams differ from the JAX package's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from miso_tpu_torch.ops import interp, se3
from miso_tpu_torch.ops.fused_decode import mlp_decode
from miso_tpu_torch.ops.mlp import mlp_apply, mlp_init
from miso_tpu_torch.ops.pooling import grid_pool_avg
from miso_tpu_torch.ops.tiled_interp import grid_interpolate_dispatch


@dataclasses.dataclass
class EncoderObservation:
    """Raw SDF observations of a grid's scene, in the grid's frame."""
    coords_world: torch.Tensor   # (N, 3)
    gt_sdf: torch.Tensor         # (N, 1)
    gt_sdf_sign: torch.Tensor    # (N, 1)
    gt_sdf_valid: torch.Tensor   # (N, 1)


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


class _Float32(torch.autograd.Function):
    """``fn(*tensors)`` with its forward and its backward under
    :func:`fp32_math`: the graph of ``fn`` is built inside the forward and
    differentiated inside the backward, where the flags are the process's
    again when the caller's backward runs (first order only)."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        inner = [t.detach().requires_grad_(need)
                 for t, need in zip(tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad(), fp32_math():
            out = fn(*inner)
        ctx.graph = (inner, out)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        inner, out = ctx.graph
        want = [t for t in inner if t.requires_grad]
        with fp32_math():
            got = iter(torch.autograd.grad(out, want, grad, allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None for t in inner))


def float32_call(fn, *tensors):
    """``fn(*tensors)`` in full float32, forward and backward (the tensors
    that need a gradient must all be among ``tensors``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Float32.apply(fn, *tensors)
    with fp32_math():
        return fn(*tensors)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(method="linear")``
    along one axis: half-pixel centres, a triangle kernel widened by
    n_in / n_out when shrinking (the antialiased case), columns normalised,
    samples outside the input zeroed."""
    inv = np.float32(n_in / n_out)
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize the spatial axes of a channels-first (N, C, *spatial) volume to
    ``size``, separably, as ``jax.image.resize(..., "linear")`` does with
    antialiasing when it shrinks: linear with half-pixel centres growing (the
    values of ``F.interpolate(mode="trilinear", align_corners=False)``), a
    triangle filter shrinking.  An axis already at its size is left as it is,
    so resizing to the volume's own shape is the identity."""
    for k, (n_in, n_out) in enumerate(zip(x.shape[2:], size)):
        if int(n_in) == int(n_out):
            continue
        w = torch.as_tensor(_resize_weights(int(n_in), int(n_out)), dtype=x.dtype,
                            device=x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([2 + k], [0])), -1, 2 + k)
    return x


def _uniform(shape, lim, generator, dtype, device):
    return ((torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0) * lim).to(device)


class ConvInterp(nn.Module):
    """A stack of ``hidden_layers`` Conv3d ('same' padding, odd kernel) +
    ReLU, channels ``base_channels * 2**i``, then a resize to the target
    spatial size.  Weights (O, I, D, H, W) and biases drawn uniform in
    +-1/sqrt(fan_in) from ``generator`` (a CPU generator), then moved to
    ``device``."""

    def __init__(self, in_channels: int, base_channels: int = 4, hidden_layers: int = 2,
                 kernel_size: int = 3, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd for 'same' padding, got {kernel_size}")
        self.kernel_size = kernel_size
        self.weight = nn.ParameterList()
        self.bias = nn.ParameterList()
        for i in range(hidden_layers):
            in_ch = in_channels if i == 0 else base_channels * 2 ** (i - 1)
            out_ch = base_channels * 2 ** i
            lim = 1.0 / math.sqrt(in_ch * kernel_size ** 3)
            self.weight.append(nn.Parameter(_uniform(
                (out_ch, in_ch) + (kernel_size,) * 3, lim, generator, dtype, device)))
            self.bias.append(nn.Parameter(_uniform((out_ch,), lim, generator, dtype, device)))

    @property
    def out_channels(self) -> int:
        return self.weight[-1].shape[0]

    def forward(self, x: torch.Tensor, output_spatial_size: Sequence[int]) -> torch.Tensor:
        """x: (1, gx, gy, gz, C) channel-last -> (1, *output_spatial_size, C')."""
        n = len(self.weight)

        def apply(y, *p):
            y = y.permute(0, 4, 1, 2, 3)
            for W, b in zip(p[:n], p[n:]):
                y = torch.relu(F.conv3d(y, W, b, padding=self.kernel_size // 2))
            return resize_linear(y, output_spatial_size).permute(0, 2, 3, 4, 1)

        return float32_call(apply, x, *self.weight, *self.bias)


def _dhwio(W: torch.Tensor) -> torch.Tensor:
    """A (O, I, D, H, W) conv weight as a (D, H, W, I, O) view."""
    return W.permute(2, 3, 4, 1, 0)


class FeaturePrediction(nn.Module):
    """One level's encoder with the residual processor only: a
    :class:`ConvInterp` over the (1, gx, gy, gz, rdim) residual volume, then
    a per-cell MLP (``ops/mlp.py``, ``mlp_layers`` hidden layers of
    ``mlp_hidden``) to ``fdim`` features."""

    def __init__(self, fdim: int, rdim: int = 3, base_channels: int = 4, hidden_layers: int = 2,
                 mlp_hidden: int = 16, mlp_layers: int = 2, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.conv = ConvInterp(rdim, base_channels, hidden_layers, kernel_size, generator,
                               dtype, device)
        mlp = mlp_init(self.conv.out_channels, fdim, mlp_hidden, mlp_layers, bias=True,
                       generator=generator, dtype=dtype, device=device)
        self.mlp = nn.ParameterList([nn.Parameter(t) for pair in mlp for t in pair])

    @property
    def mlp_params(self):
        return tuple(zip(self.mlp[0::2], self.mlp[1::2]))

    def forward(self, residual_vol: torch.Tensor,
                output_spatial_size: Sequence[int]) -> torch.Tensor:
        """(1, gx, gy, gz, rdim) -> (*output_spatial_size, fdim)."""
        x = self.conv(residual_vol, output_spatial_size)
        emb = float32_call(lambda x, *p: mlp_apply(tuple(zip(p[0::2], p[1::2])), x),
                           x.reshape(-1, x.shape[-1]), *self.mlp)
        return emb.reshape(*output_spatial_size, -1)

    def tree_fields(self):
        """The JAX package's parameter tree (``{'conv': ((W DHWIO, b), ...),
        'mlp': ((W, b), ...)}``) as checkpoint key paths; the conv weights are
        (D, H, W, I, O) views of the parameters."""
        return [("['conv']", [[_dhwio(W), b] for W, b in zip(self.conv.weight, self.conv.bias)]),
                ("['mlp']", [[W, b] for W, b in self.mlp_params])]


# ---------------------------------------------------------------------------
# The residual passes and the hierarchical prediction.
# ---------------------------------------------------------------------------

def query_sdf_with_corrections(grid, corrections: Sequence[torch.Tensor],
                               x: torch.Tensor) -> torch.Tensor:
    """The SDF of the tables ``features + corrections`` at x, through the
    interp op of each level and the decode op (``GridNet.forward``'s ops), the
    decoder detached (pretrained and frozen).  Differentiable wrt the
    corrections."""
    updated = [f + c for f, c in zip(grid.features, corrections)]
    feats = interp.multi_level_interpolate(updated, x, grid.bound, None,
                                           interpolate=grid_interpolate_dispatch)
    decoder = grid.decoder_params
    if decoder is not None:
        decoder = tuple((W.detach(), b.detach()) for W, b in decoder)
    return interp.grid_decode(feats, x, decoder, grid.pos_invariant, decode=mlp_decode)


def compute_residuals(grid, corrections, obs: EncoderObservation,
                      trunc_dist: float = 0.15) -> Dict[str, torch.Tensor]:
    """The SDF residual and the free-space upper and lower constraints at the
    observed points."""
    pred = query_sdf_with_corrections(grid, corrections, obs.coords_world)
    zero = torch.zeros_like(pred)
    sdf_res = torch.where(obs.gt_sdf_valid == 1, obs.gt_sdf - pred, zero)
    is_free = obs.gt_sdf_sign == 1
    fs_upper = torch.where(is_free, torch.relu(pred - obs.gt_sdf), zero)
    fs_lower = torch.where(is_free, torch.relu(trunc_dist - pred), zero)
    return {
        "sdf_constraint": sdf_res,
        "fs_upper_constraint": fs_upper,
        "fs_lower_constraint": fs_lower,
        "fs_constraint": torch.maximum(fs_upper, fs_lower),
        "sdf_coords": obs.coords_world,
    }


def encoder_inputs_from_residuals(residuals, grid, level: int) -> torch.Tensor:
    """[sdf_res, fs_upper, fs_lower] pooled into the level's grid:
    (1, gx, gy, gz, 3)."""
    feats = torch.cat([residuals["sdf_constraint"], residuals["fs_upper_constraint"],
                       residuals["fs_lower_constraint"]], dim=1)
    vol = grid_pool_avg(residuals["sdf_coords"], feats, grid.bound, grid.cell_sizes[level],
                        spatial=grid.level_shape(level))
    return vol[None]


def predict_corrections_until_level(levels: Sequence[FeaturePrediction], grid,
                                    obs: EncoderObservation, stop_level: int,
                                    trunc_dist: float = 0.15, pred_std: float = 0.0,
                                    generator: Optional[torch.Generator] = None
                                    ) -> List[torch.Tensor]:
    """The per-level corrections of levels < ``stop_level`` (zeros above),
    each predicted from the residuals under the ones before it.  With
    ``pred_std > 0`` and a ``generator`` (on the grid's device) each
    prediction gets N(0, pred_std^2) noise."""
    if stop_level > len(levels):
        raise ValueError(f"the encoder has {len(levels)} levels; {stop_level} asked for")
    corrections = [torch.zeros_like(f) for f in grid.features]
    for level in range(stop_level):
        residuals = compute_residuals(grid, corrections, obs, trunc_dist)
        vol = encoder_inputs_from_residuals(residuals, grid, level)
        pred = levels[level](vol, grid.level_shape(level))
        if pred_std > 0 and generator is not None:
            pred = pred + torch.randn(pred.shape, generator=generator, dtype=pred.dtype,
                                      device=pred.device) * pred_std
        corrections[level] = pred
    return corrections


def encoder_pretrain_loss(levels: Sequence[FeaturePrediction], grid, batch,
                          generator: Optional[torch.Generator], target_level: int,
                          trunc_dist: float = 0.15, sdf_weight: float = 3e3,
                          sign_weight: float = 0.0, pred_std: float = 0.1):
    """Predict the corrections up to ``target_level`` (inclusive) and penalise
    the residuals that remain.  The batch's frame points go to the grid's
    frame by its keyframe poses, outside autograd (no pose trains here)."""
    ids = batch["sample_frame_ids"].reshape(-1).long()
    with torch.no_grad():
        R, t = grid.updated_kf_poses()
        coords = se3.transform_points_by_id(batch["coords_frame"], ids, R, t)
    obs = EncoderObservation(coords_world=coords, gt_sdf=batch["sdf"],
                             gt_sdf_sign=batch["sdf_signs"], gt_sdf_valid=batch["sdf_valid"])
    corrections = predict_corrections_until_level(levels, grid, obs, target_level + 1,
                                                  trunc_dist, pred_std, generator)
    residuals = compute_residuals(grid, corrections, obs, trunc_dist)
    out = {"sdf": torch.mean(residuals["sdf_constraint"] ** 2) * sdf_weight}
    if sign_weight > 0:
        out["free_space"] = torch.mean(residuals["fs_constraint"]) * sign_weight
    return out


class Encoder:
    """Per-level :class:`FeaturePrediction` modules (``level_params``, an
    ``nn.ModuleList``) and the grids registered for prediction.

    ``pretrained_dir`` holds ``feature_encoder_level_{l}.npz`` files written
    by either package's ``Encoder.save``.  The modules are drawn from
    ``generator`` (a CPU generator) and live on ``device``.
    """

    def __init__(self, cfg: Dict, pretrained_dir: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, trunc_dist: float = 0.15,
                 device="cuda"):
        from miso_tpu_torch.models.grid_net import _check_device

        device = _check_device(device)
        m = cfg["model"]["grid"]
        self.num_levels = int(m["n_levels"])
        self.fdim = int(m["feature_dim"])
        self.rdim = 3
        self.trunc_dist = trunc_dist
        self.level_params = nn.ModuleList(
            [FeaturePrediction(self.fdim, self.rdim, generator=generator, device=device)
             for _ in range(self.num_levels)])
        if pretrained_dir is not None:
            from miso_tpu_torch.train.checkpoint import load_pytree
            for level, params in enumerate(self.level_params):
                load_pytree(os.path.join(pretrained_dir, f"feature_encoder_level_{level}.npz"),
                            like=params)
        self.grids: List = []

    def register_grid_model(self, grid) -> int:
        self.grids.append(grid)
        return len(self.grids) - 1

    @torch.no_grad()
    def predict_corrections(self, model_id: int, obs: EncoderObservation,
                            stop_level: Optional[int] = None, pred_std: float = 0.0,
                            generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """One-shot prediction for a registered grid (no autograd)."""
        grid = self.grids[model_id]
        stop = stop_level if stop_level is not None else grid.num_levels
        return predict_corrections_until_level(self.level_params, grid, obs, stop,
                                               self.trunc_dist, pred_std, generator)

    def save(self, out_dir: str):
        from miso_tpu_torch.train.checkpoint import save_pytree

        os.makedirs(out_dir, exist_ok=True)
        for level, params in enumerate(self.level_params):
            save_pytree(os.path.join(out_dir, f"feature_encoder_level_{level}.npz"), params)
