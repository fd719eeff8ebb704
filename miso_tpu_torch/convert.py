"""Carry a JAX GridNet's or GridAtlasParams' arrays into the port's.

For :func:`grid_net_from_numpy`, ``arrays`` holds the leaves of a
``miso_tpu`` GridNet as numpy arrays:

  features      per-level (X, Y, Z, F) grids ((X, Y, F) in 2D), or per-level
                VM factor dicts ('xy', ..., 'z')
  vm_bases      per-level VM basis dicts ('xy_z', 'xz_y', 'yz_x'), VM only
  stability     per-level (X, Y, Z, 1) grids
  decoder       ((W (in, out), b (out,)), ...) or None
  rot_corr, trans_corr, twk   (K, 3)
  Rwk           (K, 3, 3)
  bound         (d, 2)
  ignore_level  (L,)
  anchor_kf     () integer

The static settings (cell sizes, pos_invariant, decoder.fix, decoder.impl)
come from ``cfg_model``, the same config dict the JAX model was built from.
:func:`grid_atlas_params_from_numpy` takes the leaves of a JAX
``GridAtlasParams`` under their field names, feature and stability levels in
its folded ``(S, g0, g1*g2*C)`` storage, with its static ``pad_spatial``.
:func:`feature_prediction_from_numpy` and :func:`feature_prediction_to_numpy`
carry one encoder level's parameters (``{'conv': ((W, b), ...), 'mlp':
((W, b), ...)}``) both ways, the conv weights between the JAX package's
(D, H, W, I, O) and torch's (O, I, D, H, W).
:func:`hash_grid_net_from_numpy`, :func:`isdf_from_numpy` and
:func:`pointsdf_from_numpy` take the leaves of a JAX ``HashGridNet``,
``ISDF`` or ``PointSDF`` under their field names (the layer lists as
((W, b), ...), PointSDF's decoder as ((W0, b0), (g, b, W, bb), ...)), with
the static settings from ``cfg_model``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from miso_tpu_torch.models.encoder import FeaturePrediction
from miso_tpu_torch.models.grid_atlas import GridAtlasParams
from miso_tpu_torch.models.grid_net import GridNet, _check_device, _settings
from miso_tpu_torch.models.hashgrid import HashGridNet, hash_settings
from miso_tpu_torch.models.isdf import ISDF, isdf_settings
from miso_tpu_torch.models.pointsdf import PointSDF, pointsdf_settings


def _tensor_fn(device):
    """numpy (or JAX) array -> a tensor on ``device`` (a copy)."""
    def t(a):
        return torch.as_tensor(np.array(a), device=device)
    return t


def grid_net_from_numpy(arrays: Dict, cfg_model: Dict, device="cuda") -> GridNet:
    t = _tensor_fn(_check_device(device))

    def level(f):
        return {k: t(v) for k, v in f.items()} if isinstance(f, dict) else t(f)

    decoder = arrays.get("decoder")
    if decoder is not None:
        decoder = [(t(W), None if b is None else t(b)) for W, b in decoder]
    vm_bases = arrays.get("vm_bases")
    pcfg = cfg_model.get("pose", {})
    return GridNet(
        [level(f) for f in arrays["features"]],
        [t(s) for s in arrays["stability"]],
        decoder,
        rot_corr=t(arrays["rot_corr"]), trans_corr=t(arrays["trans_corr"]),
        Rwk=t(arrays["Rwk"]), twk=t(arrays["twk"]), bound=t(arrays["bound"]),
        ignore_level=t(arrays["ignore_level"]),
        anchor_kf=int(np.asarray(arrays.get("anchor_kf", 0))),
        optimize_pose=bool(pcfg.get("optimize", False)),
        vm_bases=None if vm_bases is None else [level(b) for b in vm_bases],
        **_settings(cfg_model))


def grid_atlas_params_from_numpy(arrays: Dict, cfg_model: Dict, num_submaps: int,
                                 device="cuda") -> GridAtlasParams:
    """The port's atlas params from a JAX atlas's arrays; ``num_submaps`` is
    the live slot count (the JAX wrapper's ``num_submaps``)."""
    t = _tensor_fn(_check_device(device))

    def unfold(levels, channels):
        return [t(a).reshape(a.shape[0], *pad, channels)
                for a, pad in zip(levels, arrays["pad_spatial"])]

    fdim = int(cfg_model["grid"]["feature_dim"])
    decoder = arrays.get("decoder")
    settings = _settings(cfg_model)
    return GridAtlasParams(
        unfold(arrays["features"], fdim), unfold(arrays["stability"], 1),
        None if decoder is None else tuple((t(W), t(b)) for W, b in decoder),
        **{k: t(arrays[k]) for k in (
            "sub_rot_corr", "sub_trans_corr", "Rws", "tws", "kf_rot_corr",
            "kf_trans_corr", "Rsk", "tsk", "bounds", "ignore_level", "active",
            "kf_to_submap", "kf_to_local")},
        sizes=[t(a) for a in arrays["sizes"]], num_submaps=num_submaps,
        cell_sizes=settings["cell_sizes"], pos_invariant=settings["pos_invariant"],
        decoder_fixed=bool(arrays.get("decoder_fixed", settings["decoder_fixed"])),
        decode_impl=settings["decode_impl"])


def feature_prediction_from_numpy(params: Dict, device="cuda") -> FeaturePrediction:
    """The port's :class:`FeaturePrediction` holding a JAX encoder level's
    arrays; its widths are read from their shapes."""
    device = _check_device(device)
    conv, mlp = params["conv"], params["mlp"]
    W0 = np.asarray(conv[0][0])
    module = FeaturePrediction(
        fdim=int(np.shape(mlp[-1][0])[1]), rdim=int(W0.shape[3]), base_channels=int(W0.shape[4]),
        hidden_layers=len(conv), mlp_hidden=int(np.shape(mlp[0][0])[1]),
        mlp_layers=len(mlp) - 2, kernel_size=int(W0.shape[0]),
        generator=torch.Generator().manual_seed(0), device=device)
    with torch.no_grad():
        for (W, b), pw, pb in zip(conv, module.conv.weight, module.conv.bias):
            pw.copy_(torch.as_tensor(np.transpose(np.array(W), (4, 3, 0, 1, 2))))
            pb.copy_(torch.as_tensor(np.array(b)))
        for (W, b), (pw, pb) in zip(mlp, module.mlp_params):
            pw.copy_(torch.as_tensor(np.array(W)))
            pb.copy_(torch.as_tensor(np.array(b)))
    return module


def feature_prediction_to_numpy(module: FeaturePrediction) -> Dict:
    """A :class:`FeaturePrediction`'s parameters in the JAX package's tree and
    layouts, as numpy arrays."""
    def a(t):
        return t.detach().cpu().numpy()
    return {"conv": tuple((np.transpose(a(W), (2, 3, 4, 1, 0)), a(b))
                          for W, b in zip(module.conv.weight, module.conv.bias)),
            "mlp": tuple((a(W), a(b)) for W, b in module.mlp_params)}


def _poses(arrays, t):
    return {k: t(arrays[k]) for k in ("rot_corr", "trans_corr", "Rwk", "twk", "bound")}


def hash_grid_net_from_numpy(arrays: Dict, cfg_model: Dict, device="cuda") -> HashGridNet:
    t = _tensor_fn(_check_device(device))
    return HashGridNet([t(a) for a in arrays["tables"]],
                       [(t(W), t(b)) for W, b in arrays["decoder"]],
                       **_poses(arrays, t), **hash_settings(cfg_model))


def isdf_from_numpy(arrays: Dict, cfg_model: Dict, device="cuda") -> ISDF:
    t = _tensor_fn(_check_device(device))
    return ISDF([(t(W), t(b)) for W, b in arrays["layers"]], **_poses(arrays, t),
                **isdf_settings(cfg_model))


def pointsdf_from_numpy(arrays: Dict, cfg_model: Dict, device="cuda") -> PointSDF:
    t = _tensor_fn(_check_device(device))
    return PointSDF(t(arrays["points"]), t(arrays["features"]),
                    [tuple(t(a) for a in layer) for layer in arrays["decoder"]],
                    t(arrays["hash_point_idx"]), t(arrays["neighbor_dx"]),
                    **_poses(arrays, t), **pointsdf_settings(cfg_model))
