"""SDF field extraction, meshing and sphere tracing (port of
``miso_tpu/utils/sdf.py``: the label masks, ``extract_fields``,
``extract_geometry``, ``save_mesh``, ``cast_feature_storage``,
``observed_sdf_query``, PLY IO and ``sphere_tracing``).

Field evaluation is a chunked loop on the device: each chunk's lattice
points are made on the device, the query runs under ``torch.no_grad()``,
and the values stay on the device until the whole lattice is done.
Marching cubes runs in the native C++ runtime.  ``feature_dtype`` of
``extract_geometry`` and ``save_mesh`` queries a copy of the model whose
feature and stability storage is cast (bfloat16: the interp and fused
kernels read it as it is stored and sum in float32).  The JAX package's scan
bucketing, watchdog budget, ``prewarm_extract_fields`` and
``_forward_only_query`` are TPU dispatch and compile means with no
counterpart here.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn


def sign_mask_from_gt_sdf(gt_sdf, trunc_dist=0.15):
    """1 where the label says free space beyond the truncation (sdf > trunc),
    else 0, in the label's dtype."""
    return (gt_sdf > trunc_dist).to(gt_sdf.dtype)


def valid_mask_from_gt_sdf(gt_sdf, trunc_dist=0.15):
    """1 where the label lies inside the truncation band (|sdf| < trunc)."""
    return (torch.abs(gt_sdf) < trunc_dist).to(gt_sdf.dtype)


def _query_device(query_func) -> torch.device:
    """The device of a query's tensors: its ``device`` (an atlas's params, an
    ObservedQuery), else its ``bound``'s (GridNet), else the card."""
    device = getattr(query_func, "device", None)
    if isinstance(device, torch.device):
        return device
    bound = getattr(query_func, "bound", None)
    if isinstance(bound, torch.Tensor):
        return bound.device
    return torch.device("cuda")


def lattice_chunk_points(bound: torch.Tensor, res: int, start: int, count: int):
    """Lattice coordinates of rows [start, start + count) of the res^3 lattice
    (linspace(lo, hi, res) per axis, x slowest), made on bound's device."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=bound.device)
    ix = i // (res * res)
    iy = (i // res) % res
    iz = i % res
    step = (bound[:, 1] - bound[:, 0]) / max(res - 1, 1)
    return torch.stack([bound[0, 0] + ix * step[0],
                        bound[1, 0] + iy * step[1],
                        bound[2, 0] + iz * step[2]], dim=-1)


def extract_fields(query_func: Callable, bound, resolution: int,
                   chunk: int = 2 ** 18, device=None) -> np.ndarray:
    """Evaluate an SDF on a resolution^3 lattice spanning ``bound``.

    Lattice nodes are linspace(bound_min, bound_max, resolution) per axis.
    ``query_func`` maps (N, 3) points to (N, 1) values (a GridNet, an
    atlas's ``GridAtlasParams``, an ``ObservedQuery`` of either); it runs on
    ``device`` (default: the query's own, else the card), under
    ``torch.no_grad()``.
    Returns a (res, res, res) float32 numpy array.
    """
    device = torch.device(device) if device is not None else _query_device(query_func)
    b = torch.as_tensor(np.asarray(bound, np.float32), device=device)
    n = resolution ** 3
    out = torch.empty((n,), dtype=torch.float32, device=device)
    with torch.no_grad():
        for start in range(0, n, chunk):
            count = min(chunk, n - start)
            pts = lattice_chunk_points(b, resolution, start, count)
            out[start:start + count] = query_func(pts).reshape(-1)
    return out.cpu().numpy().reshape(resolution, resolution, resolution)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return got


def _cast_tables(tables, dtype):
    """Detached copies of a model's tables (tensors, or a VM level's dict of
    factors) in ``dtype``."""
    return [{k: v.detach().to(dtype) for k, v in t.items()} if isinstance(t, dict)
            else t.detach().to(dtype) for t in tables]


def cast_feature_storage(query_func, dtype=torch.bfloat16):
    """A copy of ``query_func`` whose feature and stability storage is cast to
    ``dtype`` (a torch dtype or its name); the original is untouched.

    Works on a ``GridNet`` (every other tensor shared with the original), on
    ``GridAtlasParams`` and on an ``ObservedQuery`` (its model cast).  Any
    other callable comes back as it is.  Queries of a bf16 copy read the
    tables as stored and sum in float32, so fields and meshes stay float32.
    """
    from miso_tpu_torch.models.grid_atlas import GridAtlasParams
    from miso_tpu_torch.models.grid_net import GridNet

    dtype = _torch_dtype(dtype)
    if isinstance(query_func, ObservedQuery):
        return ObservedQuery(cast_feature_storage(query_func.model, dtype),
                             query_func.stability_thresh, query_func.fill_value)
    if isinstance(query_func, GridAtlasParams):
        return query_func.replace(features=_cast_tables(query_func.features, dtype),
                                  stability=_cast_tables(query_func.stability, dtype))
    if isinstance(query_func, GridNet):
        # A deep copy of the module's structure that shares every tensor, then
        # new tables in place of the copy's.
        shared = {id(t): t for t in (*query_func.parameters(), *query_func.buffers())}
        out = copy.deepcopy(query_func, shared)
        features = _cast_tables(query_func.features, dtype)
        if query_func.grid_type == "VM":
            out.features = nn.ModuleList([nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=False) for k, v in f.items()})
                for f in features])
        else:
            out.features = nn.ParameterList(
                [nn.Parameter(f, requires_grad=False) for f in features])
        out.stability = nn.ParameterList(
            [nn.Parameter(st, requires_grad=False)
             for st in _cast_tables(query_func.stability, dtype)])
        return out
    return query_func


def extract_geometry(query_func, bound, resolution=256, threshold=0.0, device=None,
                     feature_dtype=None):
    """Field eval + marching cubes -> (verts, tris) in world coords.
    ``feature_dtype`` (``"bfloat16"`` or a torch dtype): query a copy with
    that feature storage (:func:`cast_feature_storage`)."""
    from miso_tpu_torch.native import marching_cubes

    if feature_dtype is not None:
        query_func = cast_feature_storage(query_func, feature_dtype)
    b = np.asarray(bound, np.float32)
    u = extract_fields(query_func, bound, resolution, device=device)
    spacing = (b[:, 1] - b[:, 0]) / (resolution - 1.0)
    return marching_cubes(u, threshold, origin=b[:, 0], spacing=spacing)


def save_mesh(query_func, bound, save_path: Optional[str] = None,
              resolution: int = 256, transform: Optional[np.ndarray] = None,
              device=None, feature_dtype=None):
    """Extract a mesh and optionally write a binary PLY; returns a native
    ``TriangleMesh``.  ``feature_dtype``: see :func:`extract_geometry`."""
    from miso_tpu_torch.native import TriangleMesh

    if isinstance(bound, torch.Tensor):
        bound = bound.detach().cpu().numpy()
    verts, tris = extract_geometry(query_func, bound, resolution, device=device,
                                   feature_dtype=feature_dtype)
    if transform is not None:
        T = np.asarray(transform)
        verts = (verts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    if save_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        write_ply(save_path, verts, tris)
    return TriangleMesh(verts, tris)


class ObservedQuery:
    """A model wrapped with a stability mask: points whose finest-level
    stability is at most ``stability_thresh`` decode to ``fill_value``.

    Finest level: the coarse level's cells smear "observed" about one coarse
    cell past the data, which would keep the phantom TSDF shell behind
    surfaces in the mesh.
    """

    def __init__(self, model, stability_thresh=0.2, fill_value=1e3):
        self.model = model
        self.stability_thresh = stability_thresh
        self.fill_value = fill_value

    @property
    def bound(self):
        return self.model.bound

    @property
    def device(self) -> torch.device:
        return _query_device(self.model)

    def __call__(self, x):
        sdf = self.model(x)[:, :1]
        mu = self.model.query_stability(x)[:, -1:]
        return torch.where(mu > self.stability_thresh, sdf,
                           torch.full_like(sdf, self.fill_value))


def observed_sdf_query(model, stability_thresh=0.2, fill_value=1e3):
    """Wrap a model so unobserved regions decode to a large positive SDF, and
    marching cubes extracts surface only where the map saw data."""
    return ObservedQuery(model, stability_thresh, fill_value)


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray):
    """Minimal binary-little-endian PLY writer."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tris)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        face = np.empty((len(tris),), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        face["n"] = 3
        face["idx"] = tris
        f.write(face.tobytes())


def read_ply(path: str):
    """Minimal PLY reader (ascii + binary_little_endian, xyz + faces)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = "ascii"
    nv = nf = 0
    vert_props = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if parts[1] == "vertex":
                nv = int(parts[2])
            elif parts[1] == "face":
                nf = int(parts[2])
        elif parts[0] == "property" and in_vertex and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
    if fmt == "ascii":
        text = body.decode("ascii").split()
        k = len(vert_props)
        vals = np.array(text[: nv * k], dtype=np.float64).reshape(nv, k)
        verts = vals[:, :3].astype(np.float32)
        tris = []
        pos = nv * k
        for _ in range(nf):
            cnt = int(text[pos])
            pos += 1
            tris.append([int(t) for t in text[pos: pos + cnt]][:3])
            pos += cnt
        return verts, np.asarray(tris, np.int32)
    vdtype = np.dtype([(n, type_map[t]) for n, t in vert_props])
    varr = np.frombuffer(body, dtype=vdtype, count=nv)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], axis=-1).astype(np.float32)
    offset = nv * vdtype.itemsize
    fdtype = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    farr = np.frombuffer(body, dtype=fdtype, count=nf, offset=offset)
    return verts, farr["idx"].astype(np.int32).copy()


@torch.no_grad()
def sphere_tracing(query_func, origins: torch.Tensor, directions: torch.Tensor, min_dist=1e-3,
                   max_dist=50.0, max_iters=100, epsilon=1e-5):
    """Sphere-trace rays (N, 3) against an SDF ``query_func`` ((N, 3) -> (N, 1)
    or (N,)): ``max_iters`` steps of the queried distance along each unit
    direction, a ray frozen once its value is under ``epsilon`` or it is
    farther than ``max_dist`` from its origin, then one last query.  A fixed
    step count, as the JAX package's loop has.  Returns (points (N, 3),
    hit_mask (N, 1) bool)."""
    directions = directions / (torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
                               + 1e-12)
    points = origins + min_dist * directions
    stopped = torch.zeros((origins.shape[0], 1), dtype=torch.bool, device=origins.device)
    for _ in range(max_iters):
        sdfs = query_func(points).reshape(-1, 1)
        far = torch.linalg.vector_norm(points - origins, dim=-1, keepdim=True) > max_dist
        stopped = stopped | (sdfs < epsilon) | far
        points = torch.where(stopped, points, points + sdfs * directions)
    return points, query_func(points).reshape(-1, 1) < epsilon
