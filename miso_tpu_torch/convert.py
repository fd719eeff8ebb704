"""Carry a JAX GridNet's arrays into the port's GridNet.

``arrays`` holds the leaves of a ``miso_tpu`` GridNet as numpy arrays:

  features      per-level (X, Y, Z, F) grids
  stability     per-level (X, Y, Z, 1) grids
  decoder       ((W (in, out), b (out,)), ...) or None
  rot_corr, trans_corr, twk   (K, 3)
  Rwk           (K, 3, 3)
  bound         (3, 2)
  ignore_level  (L,)
  anchor_kf     () integer

The static settings (cell sizes, pos_invariant, decoder.fix, decoder.impl)
come from ``cfg_model``, the same config dict the JAX model was built from.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from miso_tpu_torch.models.grid_net import GridNet, _check_device, _settings


def grid_net_from_numpy(arrays: Dict, cfg_model: Dict, device="cuda") -> GridNet:
    device = _check_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    decoder = arrays.get("decoder")
    if decoder is not None:
        decoder = [(t(W), None if b is None else t(b)) for W, b in decoder]
    pcfg = cfg_model.get("pose", {})
    return GridNet(
        [t(f) for f in arrays["features"]],
        [t(s) for s in arrays["stability"]],
        decoder,
        rot_corr=t(arrays["rot_corr"]), trans_corr=t(arrays["trans_corr"]),
        Rwk=t(arrays["Rwk"]), twk=t(arrays["twk"]), bound=t(arrays["bound"]),
        ignore_level=t(arrays["ignore_level"]),
        anchor_kf=int(np.asarray(arrays.get("anchor_kf", 0))),
        optimize_pose=bool(pcfg.get("optimize", False)),
        **_settings(cfg_model))
