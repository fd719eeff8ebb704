"""The general generator of an atlas to align: a world feature field over a
site, true submap poses on a closed lap inside it, each submap's tables
sampled from the field under its true pose, the poses of its keyframes, and
a perturbation of every submap pose but the first, all drawn from the run's
seed.

The field is the trilinear read of seeded world tables, one a level, at the
site's cell sizes (``portbench/reference/field.py::trilinear``).  A submap's
table holds the field at its cell centres moved into the world by its true
pose; a centre outside the site reads exactly zero, as unobserved space does
on a map.  The lap is an ellipse about the site's centre, ``lap_share`` of
its half-extents wide, ``lap_height`` above its floor, with each submap's
yaw along it.  The perturbation turns a submap about a random axis by up to
``max_deg`` and moves it by up to ``max_m`` in a random direction, in its
own frame.  The same seed gives the same tensors: the device draws come from
one generator, in a fixed order, and the rest is arithmetic.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.harness import mapgen
from portbench.reference import field


def cell_sizes(grid: Dict) -> List[float]:
    return [float(grid["base_cell_size"]) / float(grid["per_level_scale"]) ** l
            for l in range(int(grid["n_levels"]))]


def grid_shape(bound, cell: float) -> List[int]:
    """Cells a level has over ``bound``: ceil(extent / cell) on each axis."""
    b = np.asarray(bound, np.float64)
    return [int(v) for v in np.ceil((b[:, 1] - b[:, 0]) / cell - 1e-9)]


def submap_count(config: Dict) -> int:
    """Submaps the sequence makes: its frames in runs of ``submap_size``."""
    return -(-int(config["dataset"]["num_frames"]) // int(config["system"]["submap_size"]))


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues' rotation about a unit axis, in float64."""
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + math.sin(angle) * K + (1.0 - math.cos(angle)) * K @ K


def _yaw(psi: float) -> np.ndarray:
    return _rotation(np.array([0.0, 0.0, 1.0]), psi)


def lap(site, n: int, share: float, height: float):
    """World poses (R (n, 3, 3), t (n, 3), float64) at n equal steps of the
    lap, each yawed along it."""
    b = np.asarray(site, np.float64)
    c, r = b[:2].mean(1), share * (b[:2, 1] - b[:2, 0]) / 2
    R, t = [], []
    for i in range(n):
        th = 2 * math.pi * i / n
        t.append([c[0] + r[0] * math.cos(th), c[1] + r[1] * math.sin(th), b[2, 0] + height])
        R.append(_yaw(math.atan2(r[1] * math.cos(th), -r[0] * math.sin(th))))
    return np.stack(R), np.asarray(t)


def keyframe_poses(mix: Dict, site, submaps: int, frames: int, size: int):
    """Each submap's keyframe poses in its frame ([(Rsk (k, 3, 3), tsk (k, 3))],
    float32): the sequence's frames spread evenly over the lap, ``size`` a
    submap, the first of a submap at the submap's own pose."""
    Rw, tw = lap(site, submaps, float(mix["lap_share"]), float(mix["lap_height"]))
    out = []
    for s in range(submaps):
        k = min(size, frames - s * size)
        Rk, tk = lap(site, submaps * size, float(mix["lap_share"]), float(mix["lap_height"]))
        Rk, tk = Rk[s * size:s * size + k], tk[s * size:s * size + k]
        Rsk = np.einsum("ji,kjl->kil", Rw[s], Rk)
        tsk = (tk - tw[s]) @ Rw[s]
        out.append((Rsk.astype(np.float32), tsk.astype(np.float32)))
    return out


def perturbations(n: int, max_deg: float, max_m: float, gen: torch.Generator):
    """(dR (n, 3, 3), dt (n, 3)) float64 on the host, the first the identity:
    a turn about a random axis by U(0, max_deg) and a move in a random
    direction by U(0, max_m)."""
    dev = gen.device
    axis = torch.randn((n, 3), generator=gen, device=dev, dtype=torch.float64)
    move = torch.randn((n, 3), generator=gen, device=dev, dtype=torch.float64)
    u = torch.rand((n, 2), generator=gen, device=dev, dtype=torch.float64)
    axis, move, u = axis.cpu().numpy(), move.cpu().numpy(), u.cpu().numpy()
    dR, dt = [np.eye(3)], [np.zeros(3)]
    for i in range(1, n):
        a = axis[i] / np.linalg.norm(axis[i])
        dR.append(_rotation(a, math.radians(max_deg) * u[i, 0]))
        dt.append(move[i] / np.linalg.norm(move[i]) * max_m * u[i, 1])
    return np.stack(dR), np.stack(dt)


def vertex_positions(bound: torch.Tensor, shape: Sequence[int], lo_x: int = 0,
                     hi_x: int = None) -> torch.Tensor:
    """Cell centres lo + (i + 0.5) (hi - lo) / n of a grid over ``bound``,
    x slowest, for x cells [lo_x, hi_x)."""
    hi_x = shape[0] if hi_x is None else hi_x
    axes = []
    for k, (a, b) in enumerate(zip((lo_x, 0, 0), (hi_x, shape[1], shape[2]))):
        step = (bound[k, 1] - bound[k, 0]) / shape[k]
        axes.append(bound[k, 0] + (torch.arange(a, b, device=bound.device,
                                                dtype=torch.float32) + 0.5) * step)
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def sample_table(world: torch.Tensor, site: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                 local: torch.Tensor, shape: Sequence[int], chunk: int = 1 << 21) -> torch.Tensor:
    """A submap level's (X, Y, Z, F) table: the world table's trilinear read
    at each cell centre moved into the world by (R, t), zero outside the
    site; in slabs of about ``chunk`` centres."""
    X, Y, Z = shape
    out = torch.empty((X, Y, Z, world.shape[-1]), dtype=torch.float32, device=world.device)
    slab = max(chunk // (Y * Z), 1)
    for a in range(0, X, slab):
        b = min(a + slab, X)
        x = (R * vertex_positions(local, shape, a, b)[:, None, :]).sum(-1) + t
        inside = ((x >= site[:, 0]) & (x <= site[:, 1])).all(-1, keepdim=True)
        v = field.trilinear(world, x, site) * inside
        out[a:b] = v.reshape(b - a, Y, Z, -1)
    return out


class AtlasInputs:
    """What an alignment run starts from, drawn from the seed in this order:
    the decoder, the world tables, the perturbations; the true poses, the
    keyframe poses and each submap's tables follow from them.

    ``R_true``/``t_true`` and ``R_start``/``t_start`` (S, 3, 3) / (S, 3)
    float32 arrays on the host: the true submap poses and the perturbed
    ones the alignment starts from (R_true dR, t_true + dt).
    ``tables(s)`` gives submap s's tables on the device, one a level, at its
    logical shape."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        model = config["model"]
        g = model["grid"]
        self.device = torch.device(device)
        self.fdim = int(g["feature_dim"])
        self.site = torch.tensor(g["bound"], dtype=torch.float32, device=self.device)
        self.local = torch.tensor(config["system"]["submap_local_bound"], dtype=torch.float32,
                                  device=self.device)
        self.cells = cell_sizes(g)
        self.world_shapes = [grid_shape(g["bound"], c) for c in self.cells]
        self.submap_shapes = [grid_shape(config["system"]["submap_local_bound"], c)
                              for c in self.cells]
        self.submaps = submap_count(config)
        self.frames = int(config["dataset"]["num_frames"])
        self.size = int(config["system"]["submap_size"])
        gen = mapgen.generator(seed, self.device)
        self.decoder = mapgen.decoder_weights(config["decoder_dims"], gen, self.device)
        self.world = [torch.randn((*s, self.fdim), generator=gen, device=self.device)
                      * float(mix["feature_std"]) for s in self.world_shapes]
        dR, dt = perturbations(self.submaps, float(mix["max_deg"]), float(mix["max_m"]), gen)
        Rw, tw = lap(g["bound"], self.submaps, float(mix["lap_share"]), float(mix["lap_height"]))
        self.keyframes = keyframe_poses(mix, g["bound"], self.submaps, self.frames, self.size)
        self.R_true, self.t_true = Rw.astype(np.float32), tw.astype(np.float32)
        self.R_start = np.einsum("sij,sjk->sik", Rw, dR).astype(np.float32)
        self.t_start = (tw + dt).astype(np.float32)

    def tables(self, s: int) -> List[torch.Tensor]:
        R = torch.tensor(self.R_true[s], device=self.device)
        t = torch.tensor(self.t_true[s], device=self.device)
        return [sample_table(w, self.site, R, t, self.local, shape)
                for w, shape in zip(self.world, self.submap_shapes)]

    def free_world(self):
        self.world = None
