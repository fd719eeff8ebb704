"""Multiresolution hash-grid SDF model (port of ``miso_tpu/models/hashgrid.py``).

The Instant-NGP hash encoding: per level l the lattice resolution is
``N_l = floor(N_min * b**l)``; corner features live in a (T_l, F) table,
addressed densely when the (N_l + 1)^3 lattice fits in T (then
``T_l = (N_l + 1)^3``), else by the xor-prime spatial hash modulo T; a query
gathers its 8 corners per level and interpolates trilinearly, the levels are
concatenated and an MLP decodes them (on the card the decode kernel,
``ops/fused_decode.py::mlp_decode``; the encoding is torch ops on every
device).  Same keyframe pose API as GridNet.

Trainable parameters: ``tables.<l>``, ``decoder.<2i>`` (W_i, (in, out)) and
``decoder.<2i+1>`` (b_i), ``rot_corr``, ``trans_corr``.  Buffers: ``Rwk``,
``twk``, ``bound``.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from miso_tpu_torch.models.base import KeyframePoses
from miso_tpu_torch.models.grid_net import _check_device
from miso_tpu_torch.ops import se3
from miso_tpu_torch.ops.fused_decode import mlp_decode
from miso_tpu_torch.ops.interp import _gather_lerp_channels
from miso_tpu_torch.ops.mlp import mlp_init

# The JAX package hashes uint32 corner indices with wraparound; torch has no
# uint32 arithmetic on the card, so the products are taken in int64 and
# masked to 32 bits (exact: an index is at most res and a prime < 2^32).
_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
_CORNERS = tuple(itertools.product((0, 1), repeat=3))


def hash_encode_level(table: torch.Tensor, x01: torch.Tensor, res: int) -> torch.Tensor:
    """One hash-grid level: (T, F) table, (N, 3) coords in [0, 1] and a
    static lattice resolution -> (N, F).

    As in the JAX package, the lerp fraction comes from the unclipped floor
    and only then is the cell clipped to res - 1: a point with x01 = 1 reads
    cell res - 1 with weight 1 on its lower corner.
    """
    tsize = table.shape[0]
    u = x01 * res
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = i0f.to(torch.int64).clamp(0, res - 1)
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=x01.device)   # (8, 3)
    idx = (i0[None] + corners[:, None, :]).clamp(0, res)                      # (8, N, 3)
    if (res + 1) ** 3 <= tsize:
        lin = (idx[..., 0] * (res + 1) + idx[..., 1]) * (res + 1) + idx[..., 2]
    else:
        h = [(idx[..., k] * _PRIMES[k]) & _MASK32 for k in range(3)]
        lin = (h[0] ^ h[1] ^ h[2]) % tsize
    wk = torch.where(corners[:, None, :] == 1, frac[None], 1.0 - frac[None])  # (8, N, 3)
    w = wk[..., 0] * wk[..., 1] * wk[..., 2]
    return _gather_lerp_channels(table, lin, w, table.shape[1])


class HashGridNet(KeyframePoses, nn.Module):

    def __init__(self, tables: Sequence[torch.Tensor], decoder, rot_corr, trans_corr,
                 Rwk, twk, bound, *, resolutions: Sequence[int], table_size: int,
                 pos_invariant: bool = True, decoder_fixed: bool = False,
                 optimize_pose: bool = False):
        super().__init__()
        self.tables = nn.ParameterList([nn.Parameter(t) for t in tables])
        self.decoder = nn.ParameterList([nn.Parameter(t) for pair in decoder for t in pair])
        self.rot_corr = nn.Parameter(rot_corr)
        self.trans_corr = nn.Parameter(trans_corr)
        self.register_buffer("Rwk", Rwk)
        self.register_buffer("twk", twk)
        self.register_buffer("bound", bound)
        self.resolutions = tuple(int(r) for r in resolutions)
        self.table_size = int(table_size)
        self.pos_invariant = pos_invariant
        self.decoder_fixed = decoder_fixed
        self.optimize_pose = optimize_pose
        self.anchor_kf = 0

    @property
    def num_levels(self) -> int:
        return len(self.tables)

    @property
    def decoder_params(self):
        """The decoder as ((W, b), ...), detached when the decoder is fixed."""
        ts = [t.detach() if self.decoder_fixed else t for t in self.decoder]
        return tuple(zip(ts[0::2], ts[1::2]))

    def tree_fields(self):
        """(key, value) of the JAX HashGridNet's leaves in its key-path
        spelling (``train/checkpoint.py``)."""
        return [(".tables", list(self.tables)),
                (".decoder", [[self.decoder[i], self.decoder[i + 1]]
                              for i in range(0, len(self.decoder), 2)]),
                (".rot_corr", self.rot_corr), (".trans_corr", self.trans_corr),
                (".Rwk", self.Rwk), (".twk", self.twk), (".bound", self.bound)]

    def query_feature(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        x01 = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
        return torch.cat([hash_encode_level(t, x01, r)
                          for t, r in zip(self.tables, self.resolutions)], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.query_feature(x)
        inp = feats if self.pos_invariant else torch.cat([feats, x], dim=-1)
        return mlp_decode(self.decoder_params, inp)


def hash_settings(cfg_model: Dict):
    """The static settings of a HashGridNet's config (``hash`` or ``grid``:
    n_levels, feature_dim, base_resolution, per_level_scale,
    log2_hashmap_size; ``decoder``; ``pose``)."""
    h = cfg_model.get("hash", cfg_model.get("grid", {}))
    dcfg = cfg_model.get("decoder", {})
    n_min = int(h.get("base_resolution", 16))
    growth = float(h.get("per_level_scale", 1.5))
    T = int(h.get("log2_hashmap_size", 19))
    return dict(
        resolutions=tuple(int(math.floor(n_min * growth ** l))
                          for l in range(int(h.get("n_levels", 8)))),
        table_size=2 ** T if T < 64 else T,
        pos_invariant=bool(dcfg.get("pos_invariant", True)),
        decoder_fixed=bool(dcfg.get("fix", False)),
        optimize_pose=bool(cfg_model.get("pose", {}).get("optimize", False)))


def create_hash_grid_net(cfg_model: Dict, bound=None, dtype=torch.float32,
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> HashGridNet:
    """Build a HashGridNet from a model config (:func:`hash_settings`).
    Tables are drawn from U(-1e-4, 1e-4), level by level, then the decoder,
    from ``generator`` (a CPU generator), and moved to ``device``."""
    device = _check_device(device)
    settings = hash_settings(cfg_model)
    h = cfg_model.get("hash", cfg_model.get("grid", {}))
    dcfg = cfg_model.get("decoder", {})
    fdim = int(h.get("feature_dim", 2))
    b = cfg_model.get("grid", {}).get("bound", [[-1, 1]] * 3)
    bound_t = torch.as_tensor(np.asarray(bound if bound is not None else b, np.float32))
    tables = []
    for res in settings["resolutions"]:
        size = min((res + 1) ** 3, settings["table_size"])
        tables.append(((torch.rand((size, fdim), generator=generator, dtype=dtype) * 2.0 - 1.0)
                       * 1e-4).to(device))
    n_levels = len(settings["resolutions"])
    decoder = mlp_init(n_levels * fdim + (0 if settings["pos_invariant"] else 3),
                       int(dcfg.get("out_dim", 1)), int(dcfg.get("hidden_dim", 64)),
                       int(dcfg.get("hidden_layers", 1)), bias=True, generator=generator,
                       dtype=dtype, device=device)
    K = int(cfg_model.get("pose", {}).get("num_poses", 1))
    return HashGridNet(
        tables, decoder,
        rot_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        trans_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        Rwk=se3.identity_rotations(K, dtype, device),
        twk=torch.zeros((K, 3), dtype=dtype, device=device),
        bound=bound_t.to(device), **settings)
