"""iSDF baseline: an MLP-only SDF model with the icosahedron positional
encoding (port of ``miso_tpu/models/isdf.py``).

The encoding projects the scaled coordinates onto 21 icosahedron directions
and takes sin at geometric frequencies and with a pi/2 phase (cos),
prepending the scaled coordinates (297 wide at the defaults).  Softplus
(beta 100) blocks, a skip concat of the encoding after the first block
stack, a linear scalar output; 2D queries are padded with a zero z.  Every
product runs in full float32 on the card (``ops/mlp.py::fp32_matmul``), as
the JAX package's ``preferred_element_type=float32`` dots do on the CPU;
torch ops on every device, no kernel.  Same keyframe pose API as GridNet.

Trainable parameters: ``layers.<2i>`` (W_i, (in, out)), ``layers.<2i+1>``
(b_i), ``rot_corr``, ``trans_corr``.  Buffers: ``Rwk``, ``twk``, ``bound``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from miso_tpu_torch.models.base import KeyframePoses
from miso_tpu_torch.models.grid_net import _check_device
from miso_tpu_torch.ops import se3
from miso_tpu_torch.ops.mlp import fp32_matmul

# The 21 icosahedron directions of the iSDF paper's open-source release.
_ICO_DIRS = np.array([
    [0.8506508, 0, 0.5257311],
    [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0],
    [1, 0, 0],
    [0.809017, 0.5, -0.309017],
    [0.8506508, 0, -0.5257311],
    [0.309017, 0.809017, -0.5],
    [0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017],
    [0, 1, 0],
    [-0.5257311, 0.8506508, 0],
    [-0.309017, 0.809017, -0.5],
    [0, 0.5257311, 0.8506508],
    [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5],
    [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017],
    [0, 0, 1],
    [-0.5, 0.309017, 0.809017],
    [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017],
], np.float32).T  # (3, 21)


def positional_encoding(x: torch.Tensor, min_deg=0, max_deg=6, scale=0.1) -> torch.Tensor:
    """(N, 3) -> (N, 3 + 2 * 21 * n_freqs): the scaled coordinates, then the
    sines of the (direction, frequency) products, direction-major, then the
    same shifted by pi/2."""
    freqs = 2.0 ** torch.arange(min_deg, max_deg + 1, dtype=x.dtype, device=x.device)
    xs = x * scale
    proj = fp32_matmul(xs, torch.as_tensor(_ICO_DIRS, dtype=x.dtype, device=x.device))
    xb = (proj[..., None] * freqs).reshape(*proj.shape[:-1], -1)
    emb = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([xs, emb], dim=-1)


def pe_embedding_size(min_deg=0, max_deg=6) -> int:
    return 2 * 21 * (max_deg - min_deg + 1) + 3


def _softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta 100.  torch's softplus is the identity above its
    threshold (100 x > 20), where the JAX package's ``jax.nn.softplus`` adds
    log1p(exp(-100 x)) < 2.1e-9: under 2.1e-11 after the division."""
    return F.softplus(100.0 * x) / 100.0


class ISDF(KeyframePoses, nn.Module):

    def __init__(self, layers, rot_corr, trans_corr, Rwk, twk, bound, *,
                 hidden_size: int = 256, hidden_layers_block: int = 1,
                 min_deg: int = 0, max_deg: int = 6, pe_scale: float = 0.1,
                 scale_output: float = 1.0, optimize_pose: bool = False):
        super().__init__()
        self.layers = nn.ParameterList([nn.Parameter(t) for pair in layers for t in pair])
        self.rot_corr = nn.Parameter(rot_corr)
        self.trans_corr = nn.Parameter(trans_corr)
        self.register_buffer("Rwk", Rwk)
        self.register_buffer("twk", twk)
        self.register_buffer("bound", bound)
        self.hidden_size = hidden_size
        self.hidden_layers_block = hidden_layers_block
        self.min_deg = min_deg
        self.max_deg = max_deg
        self.pe_scale = pe_scale
        self.scale_output = scale_output
        self.optimize_pose = optimize_pose
        self.anchor_kf = 0

    def tree_fields(self):
        """(key, value) of the JAX ISDF's leaves in its key-path spelling."""
        return [(".layers", [[self.layers[i], self.layers[i + 1]]
                             for i in range(0, len(self.layers), 2)]),
                (".rot_corr", self.rot_corr), (".trans_corr", self.trans_corr),
                (".Rwk", self.Rwk), (".twk", self.twk), (".bound", self.bound)]

    def _linear(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return fp32_matmul(h, self.layers[2 * i]) + self.layers[2 * i + 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 2:
            x = torch.cat([x, torch.zeros((*x.shape[:-1], 1), dtype=x.dtype,
                                          device=x.device)], dim=-1)
        pe = positional_encoding(x, self.min_deg, self.max_deg, self.pe_scale)
        n_block = self.hidden_layers_block
        h = _softplus100(self._linear(0, pe))
        for i in range(1, 1 + n_block):                   # mid1
            h = _softplus100(self._linear(i, h))
        h = torch.cat([h, pe], dim=-1)                    # the skip concat
        h = _softplus100(self._linear(1 + n_block, h))    # cat_layer
        for i in range(2 + n_block, 2 + 2 * n_block):     # mid2
            h = _softplus100(self._linear(i, h))
        return self._linear(2 + 2 * n_block, h) * self.scale_output


def isdf_settings(cfg_model: Dict, hidden_size=256, hidden_layers_block=1,
                  scale_output=1.0):
    """The static settings of an ISDF's config (``isdf``: hidden_size,
    hidden_layers_block, scale_output; ``pose.optimize``)."""
    icfg = cfg_model.get("isdf", {})
    return dict(hidden_size=int(icfg.get("hidden_size", hidden_size)),
                hidden_layers_block=int(icfg.get("hidden_layers_block", hidden_layers_block)),
                scale_output=float(icfg.get("scale_output", scale_output)),
                optimize_pose=bool(cfg_model.get("pose", {}).get("optimize", False)))


def create_isdf(cfg_model: Dict, bound=None, hidden_size=256, hidden_layers_block=1,
                scale_output=1.0, dtype=torch.float32,
                generator: Optional[torch.Generator] = None, device="cuda") -> ISDF:
    """Build an ISDF from a model config (:func:`isdf_settings`, ``pose``,
    ``grid.bound``).  Weights are Xavier-normal, drawn layer by layer from
    ``generator`` (a CPU generator); biases zero."""
    device = _check_device(device)
    settings = isdf_settings(cfg_model, hidden_size, hidden_layers_block, scale_output)
    hidden, n_block = settings["hidden_size"], settings["hidden_layers_block"]
    emb = pe_embedding_size()
    dims = [(emb, hidden)] + [(hidden, hidden)] * n_block + [(hidden + emb, hidden)] \
        + [(hidden, hidden)] * n_block + [(hidden, 1)]
    layers = []
    for fin, fout in dims:
        W = torch.randn((fin, fout), generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / (fin + fout))
        layers.append((W.to(device), torch.zeros((fout,), dtype=dtype, device=device)))
    K = int(cfg_model.get("pose", {}).get("num_poses", 1))
    b = cfg_model.get("grid", {}).get("bound", [[-1, 1]] * 3)
    return ISDF(
        layers,
        rot_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        trans_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        Rwk=se3.identity_rotations(K, dtype, device),
        twk=torch.zeros((K, 3), dtype=dtype, device=device),
        bound=torch.as_tensor(np.asarray(bound if bound is not None else b, np.float32),
                              device=device),
        **settings)
