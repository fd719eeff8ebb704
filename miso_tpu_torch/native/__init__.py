"""ctypes bindings of the C++ geometry runtime (port of ``miso_tpu/native``).

``src/miso_native.cpp`` and ``src/mc_tables.h`` are this package's own copies
of the JAX package's runtime.  The library is built at first use with
``g++ -O3 -march=native -shared -fPIC`` (the JAX package's flags, so both
give the same bits) into ``miso_tpu_torch/_build/``, under a file name that
carries a hash of the sources, the flags, the compiler's version and the
host's CPU: a library tuned to one CPU is never loaded on another.  Nothing
is built when the module is imported, and a failed build raises.  Unlike the JAX
package's Makefile it does not pass ``-fopenmp``: the g++ beside the CUDA
toolkit on the H100 machine has no libgomp, and the OpenMP loops (one per
query point, no reductions) give the same bits on one thread.  Entry points
take contiguous float32 / int32 numpy arrays.

Entry points: ``marching_cubes`` and ``TriangleMesh`` (``signed_distance``,
``unsigned_distance``, ``closest_points``, ``raycast``, ``sample_surface``,
``face_normals``, ``area``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wno-unknown-pragmas", "-shared")


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _host_tag() -> bytes:
    """The compiler's version and the CPU's model and feature flags."""
    version = subprocess.run([_compiler(), "--version"], capture_output=True,
                             text=True).stdout
    cpu = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:            # the first processor's block
                if not line.strip():
                    break
                if line.startswith(("model name", "flags")):
                    cpu.append(line)
    except OSError:
        cpu.append(platform.processor())
    return (version + "".join(cpu)).encode()


@functools.cache
def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(_host_tag())
    for name in ("miso_native.cpp", "mc_tables.h"):
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libmiso_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the runtime unless it is built; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, str(SRC / "miso_native.cpp"),
           "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native runtime build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)
    lib.mn_marching_cubes.argtypes = [
        c_fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        c_fp, c_fp,
        ctypes.POINTER(c_fp), c_ip, ctypes.POINTER(c_ip), c_ip,
    ]
    lib.mn_marching_cubes.restype = ctypes.c_int
    lib.mn_free.argtypes = [ctypes.c_void_p]
    lib.mn_mesh_build.argtypes = [c_fp, ctypes.c_int, c_ip, ctypes.c_int]
    lib.mn_mesh_build.restype = ctypes.c_void_p
    lib.mn_mesh_free.argtypes = [ctypes.c_void_p]
    lib.mn_signed_distance.argtypes = [ctypes.c_void_p, c_fp, ctypes.c_int, c_fp]
    lib.mn_unsigned_distance.argtypes = [ctypes.c_void_p, c_fp, ctypes.c_int, c_fp]
    lib.mn_closest_points.argtypes = [ctypes.c_void_p, c_fp, ctypes.c_int, c_fp, c_fp]
    lib.mn_raycast.argtypes = [ctypes.c_void_p, c_fp, c_fp, ctypes.c_int, c_fp, c_ip]
    lib.mn_sample_surface.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_uint64, c_fp, c_fp]
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def marching_cubes(field: np.ndarray, iso: float = 0.0,
                   origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract an iso-surface from a (nx, ny, nz) scalar field.

    Returns (verts (V, 3) float32 in world coords, tris (T, 3) int32).
    """
    lib = get_lib()
    field = np.ascontiguousarray(field, dtype=np.float32)
    nx, ny, nz = field.shape
    origin = np.ascontiguousarray(origin, dtype=np.float32)
    spacing = np.ascontiguousarray(spacing, dtype=np.float32)
    overts = ctypes.POINTER(ctypes.c_float)()
    otris = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    lib.mn_marching_cubes(_fp(field), nx, ny, nz, iso, _fp(origin), _fp(spacing),
                          ctypes.byref(overts), ctypes.byref(nv),
                          ctypes.byref(otris), ctypes.byref(nt))
    verts = (np.ctypeslib.as_array(overts, shape=(nv.value, 3)).copy() if nv.value
             else np.zeros((0, 3), np.float32))
    tris = (np.ctypeslib.as_array(otris, shape=(nt.value, 3)).copy() if nt.value
            else np.zeros((0, 3), np.int32))
    lib.mn_free(overts)
    lib.mn_free(otris)
    return verts, tris


class TriangleMesh:
    """BVH-accelerated triangle mesh queries."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self.triangles = np.ascontiguousarray(triangles, dtype=np.int32)
        self._lib = get_lib()
        self._handle = self._lib.mn_mesh_build(
            _fp(self.vertices), len(self.vertices),
            _ip(self.triangles), len(self.triangles))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mn_mesh_free(handle)
            self._handle = None

    def signed_distance(self, points: np.ndarray) -> np.ndarray:
        """Signed distance, positive outside."""
        pts = np.ascontiguousarray(points, dtype=np.float32)
        out = np.empty((len(pts),), np.float32)
        self._lib.mn_signed_distance(self._handle, _fp(pts), len(pts), _fp(out))
        return out

    def unsigned_distance(self, points: np.ndarray) -> np.ndarray:
        pts = np.ascontiguousarray(points, dtype=np.float32)
        out = np.empty((len(pts),), np.float32)
        self._lib.mn_unsigned_distance(self._handle, _fp(pts), len(pts), _fp(out))
        return out

    def closest_points(self, points: np.ndarray):
        """(closest surface points (N, 3), distances (N,))."""
        pts = np.ascontiguousarray(points, dtype=np.float32)
        out_p = np.empty((len(pts), 3), np.float32)
        out_d = np.empty((len(pts),), np.float32)
        self._lib.mn_closest_points(self._handle, _fp(pts), len(pts), _fp(out_p),
                                    _fp(out_d))
        return out_p, out_d

    def raycast(self, origins: np.ndarray, directions: np.ndarray):
        """First hits: (t (N,), triangle (N,)); t = -1 where the ray misses."""
        o = np.ascontiguousarray(origins, dtype=np.float32)
        d = np.ascontiguousarray(directions, dtype=np.float32)
        if o.shape != d.shape or o.ndim != 2 or o.shape[1] != 3:
            raise ValueError(f"origins {o.shape} and directions {d.shape} must both be (N, 3)")
        t = np.empty((len(o),), np.float32)
        tri = np.empty((len(o),), np.int32)
        self._lib.mn_raycast(self._handle, _fp(o), _fp(d), len(o), _fp(t), _ip(tri))
        return t, tri

    def sample_surface(self, n: int, seed: int = 0, return_normals: bool = False):
        """n area-weighted surface samples (and their face normals)."""
        pts = np.empty((n, 3), np.float32)
        nrm = np.empty((n, 3), np.float32)
        self._lib.mn_sample_surface(self._handle, n, seed, _fp(pts), _fp(nrm))
        if return_normals:
            return pts, nrm
        return pts

    def _cross(self) -> np.ndarray:
        v, t = self.vertices, self.triangles
        return np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])

    @property
    def face_normals(self) -> np.ndarray:
        n = self._cross()
        return n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-20)

    @property
    def area(self) -> float:
        return float(0.5 * np.linalg.norm(self._cross(), axis=1).sum())
