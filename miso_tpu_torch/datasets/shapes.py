"""Procedural watertight test meshes (a copy of
``miso_tpu/datasets/shapes.py``, numpy only).

The reference relies on external mesh files (Replica scenes, armadillo
etc.).  For self-contained tests/benchmarks we generate watertight
primitives: icosphere, box, torus, and composite scenes.
"""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 3, radius: float = 1.0, center=(0, 0, 0)):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key in edge_mid:
                return edge_mid[key]
            m = (verts_list[a] + verts_list[b]) / 2.0
            m = m / np.linalg.norm(m)
            verts_list.append(m)
            idx = len(verts_list) - 1
            edge_mid[key] = idx
            return idx

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    verts = verts * radius + np.asarray(center)
    return verts.astype(np.float32), faces.astype(np.int32)


def box(size=(1.0, 1.0, 1.0), center=(0, 0, 0)):
    sx, sy, sz = np.asarray(size) / 2.0
    cx, cy, cz = center
    v = np.array([
        [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
        [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
    ], np.float32) + np.asarray([cx, cy, cz], np.float32)
    f = np.array([
        [0, 2, 1], [0, 3, 2],  # bottom (z-)
        [4, 5, 6], [4, 6, 7],  # top (z+)
        [0, 1, 5], [0, 5, 4],  # y-
        [2, 3, 7], [2, 7, 6],  # y+
        [1, 2, 6], [1, 6, 5],  # x+
        [3, 0, 4], [3, 4, 7],  # x-
    ], np.int32)
    return v, f


def torus(major_radius=1.0, minor_radius=0.3, center=(0, 0, 0), n_major=48, n_minor=24):
    us = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    verts = []
    for u in us:
        for v in vs:
            x = (major_radius + minor_radius * np.cos(v)) * np.cos(u)
            y = (major_radius + minor_radius * np.cos(v)) * np.sin(u)
            z = minor_radius * np.sin(v)
            verts.append([x, y, z])
    verts = np.asarray(verts, np.float32) + np.asarray(center, np.float32)
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = i * n_minor + (j + 1) % n_minor
            c = ((i + 1) % n_major) * n_minor + j
            d = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            faces += [[a, c, b], [b, c, d]]
    return verts, np.asarray(faces, np.int32)


def merge_meshes(*meshes):
    """Concatenate (verts, tris) pairs.  Components should be disjoint
    for pseudonormal signed distance to remain valid."""
    vs, fs = [], []
    off = 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def _rounded_rect_ring_distance(p, half, corner_frac):
    """2D distance from points (N, 2) to the rounded-rectangle circuit of
    ``datasets/sequence.py::circuit_trajectory`` (straight
    half-length ``half*(1-corner_frac)``, corner radius
    ``half*corner_frac``)."""
    a = half * (1.0 - corner_frac)
    r = half * corner_frac
    q = np.abs(np.asarray(p, np.float64)) - a
    qp = np.maximum(q, 0.0)
    sdf_rbox = (np.sqrt((qp**2).sum(-1))
                + np.minimum(np.maximum(q[..., 0], q[..., 1]), 0.0) - r)
    return np.abs(sdf_rbox)


def quad_scene(extent=40.0, wall_height=6.0, seed=0, n_objects=24,
               path_half_extent=None, path_corner_frac=0.35,
               path_clearance=3.0):
    """An NCD-quad-like courtyard: ground slab, perimeter walls, and
    scattered pillars/boxes/spheres (stand-in for the reference's
    flagship 62x73x23 m Newer College workload, ncd_quad.yaml:2-3).

    path_half_extent: if set, objects are rejection-sampled to stay
    ``path_clearance`` away from the circuit_trajectory ring of that
    half-extent (an object straddling the sensor path truncates a whole
    scan to <2 m -- measured to leave a freshly spawned submap's map
    untrained beyond arm's reach and blow up LM tracking).

    Returns (verts, tris) of a watertight composite mesh spanning
    roughly [-extent/2, extent/2]^2 x [-1, wall_height].
    """
    rng = np.random.default_rng(seed)
    h = extent / 2.0
    parts = [box(size=(extent + 2, extent + 2, 0.4), center=(0, 0, -0.2))]
    wt = 0.6  # wall thickness
    for cx, cy, sx, sy in [(0, h, extent + 2, wt), (0, -h, extent + 2, wt),
                           (h, 0, wt, extent + 2), (-h, 0, wt, extent + 2)]:
        parts.append(box(size=(sx, sy, wall_height),
                         center=(cx, cy, wall_height / 2)))
    # Scattered objects inside, clear of the sensor circuit.
    placed = 0
    for _ in range(n_objects * 40):
        if placed >= n_objects:
            break
        x, y = rng.uniform(-h + 6.0, h - 6.0, 2)
        if path_half_extent is not None and _rounded_rect_ring_distance(
                np.array([[x, y]]), path_half_extent,
                path_corner_frac)[0] < path_clearance:
            continue
        placed += 1
        kind = rng.integers(0, 3)
        if kind == 0:
            s = rng.uniform(0.6, 2.4)
            parts.append(box(size=(s, s, rng.uniform(1.0, 4.0)),
                             center=(x, y, rng.uniform(0.5, 1.5))))
        elif kind == 1:
            r = rng.uniform(0.5, 1.4)
            parts.append(icosphere(2, r, center=(x, y, r * 0.8)))
        else:
            parts.append(torus(rng.uniform(0.8, 1.6), rng.uniform(0.2, 0.5),
                               center=(x, y, rng.uniform(0.5, 1.5))))
    return merge_meshes(*parts)


def room_scene(size=4.0, seed=0):
    """A simple 'room': floor slab + a few disjoint objects.

    Useful as a stand-in for Replica-style indoor scenes in tests.
    """
    rng = np.random.default_rng(seed)
    parts = [box(size=(size, size, 0.2), center=(0, 0, -1.0))]
    parts.append(icosphere(2, 0.5, center=(-size / 4, -size / 4, 0.0)))
    parts.append(box(size=(0.8, 0.8, 1.2), center=(size / 4, size / 4, -0.3)))
    parts.append(torus(0.6, 0.2, center=(size / 4, -size / 4, 0.2)))
    return merge_meshes(*parts)
