"""Which tables the gather kernels stage in shared memory
(``ops/tiled_interp.py::staged_tables``), and what the fused wrapper packs,
held on the CPU.

The interp forward (``csrc/grid_interp.cu``) and the fused kernel
(``csrc/fused_interp_decode.cu``) gather a level's corner rows either from a
copy of its table in the block's shared memory or from L2
(``csrc/mtt_grid.cuh``).  A table is staged, smallest first, while it fits
the block's share of an SM's shared memory after the block's other shared
memory: the interp forward keeps 2 blocks an SM, the fused kernel 3 beside
its weights and feature slices.  Here the rule is held at the paths' levels
(the ScanNet levels, the mesh path's), on padded storage, at large F and on
each side of the budget; the fused wrapper's packed layout is held to its
byte count; and a gather from a staged copy, which holds the whole storage,
is held to ``jax`` ``grid_interpolate`` with a logical size.

Tolerance: atol/rtol 1e-5, float32 sums taken in another order.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, t
from miso_tpu.ops import interp as jinterp
from miso_tpu_torch.ops import fused_decode as fd
from miso_tpu_torch.ops import interp
from miso_tpu_torch.ops import tiled_interp as ti

TOL = dict(atol=1e-5, rtol=1e-5)
SCANNET = [8, 64, 64, 1]   # the ScanNet decoder's widths (2 levels x F = 4 in)
# The fused kernel's weights and feature slices at the ScanNet decoder, bytes.
SCANNET_OTHER = fd.fused_layout(SCANNET, [])["smem_bytes"]

# (storage shape, staged by the interp forward, staged by the fused kernel
# beside the ScanNet decoder): the ScanNet levels (0.1 m and 0.5 m cells over
# 10.4 x 8.75 x 3.04 m), the mesh path's (5 x 5 x 2.65 m), the ScanNet coarse
# level padded as GridNet pads a growing grid, and at F = 1, 12 and 36.
LEVELS = {
    "scannet_fine": ((105, 88, 31, 4), False, False),
    "scannet_coarse": ((21, 18, 7, 4), True, True),
    "mesh_fine": ((50, 50, 27, 4), False, False),
    "mesh_coarse": ((10, 10, 6, 4), True, True),
    "scannet_coarse_padded": ((24, 20, 8, 4), True, False),
    "scannet_coarse_F1": ((21, 18, 7, 1), True, True),
    "scannet_coarse_F12": ((21, 18, 7, 12), False, False),
    "scannet_coarse_F36": ((21, 18, 7, 36), False, False),
}


@pytest.mark.parametrize("level", list(LEVELS), ids=list(LEVELS))
def test_staged_tables_at_the_paths_levels(level):
    shape, interp_staged, fused_staged = LEVELS[level]
    nbytes = math.prod(shape) * 4
    assert ti.table_bytes(torch.zeros(shape)) == nbytes
    assert ti.staged_tables([nbytes], 0, ti.INTERP_STAGED_BLOCKS) == [interp_staged]
    assert ti.staged_tables([nbytes], SCANNET_OTHER, fd.FUSED_BLOCKS_PER_SM) == [fused_staged]


# (storage shape, points, float4 rows, the forward's path).
PATHS = {
    "scannet_fine_1e6": ((105, 88, 31, 4), 10 ** 6, True, "pairs"),
    "scannet_coarse_1e6": ((21, 18, 7, 4), 10 ** 6, True, "staged"),
    "mesh_fine_2^15": ((50, 50, 27, 4), 2 ** 15, True, "l2"),
    "mesh_coarse_2^15": ((10, 10, 6, 4), 2 ** 15, True, "l2"),
    "lattice_fine_2^18": ((50, 50, 27, 4), 2 ** 18, True, "l2"),
    "lattice_coarse_2^18": ((10, 10, 6, 4), 2 ** 18, True, "l2"),
    "coarse_F12_1e6": ((21, 18, 7, 12), 10 ** 6, True, "l2"),
    "fine_F8_1e6": ((105, 88, 31, 8), 10 ** 6, True, "l2"),
    "large_F1_1e6": ((105, 88, 31, 1), 10 ** 6, False, "l2"),
    "small_unaligned_1e6": ((21, 18, 7, 4), 10 ** 6, False, "staged"),
    "at_the_threshold": ((105, 88, 31, 4), ti.COPY_MIN_POINTS, True, "pairs"),
    "below_the_threshold": ((21, 18, 7, 4), ti.COPY_MIN_POINTS - 1, True, "l2"),
}


@pytest.mark.parametrize("case", list(PATHS), ids=list(PATHS))
def test_interp_forward_path(case):
    """Calls of at least COPY_MIN_POINTS points copy their table: to shared
    memory where it fits, else in pairs (F = 4 in float4 rows only); smaller
    calls, and the rest, gather from the table in L2."""
    shape, n, vec4, path = PATHS[case]
    assert ti.interp_forward_path(torch.zeros(shape), n, vec4) == path
    assert path in ti.FORWARD_PATHS


@pytest.mark.parametrize("side", ["under", "over"])
@pytest.mark.parametrize("kernel", ["interp", "fused"])
def test_staging_budget_boundary(kernel, side):
    """A table of exactly the budget left is staged; 16 bytes more is not
    (a table takes a multiple of 16 bytes: one byte more rounds up to 16)."""
    blocks, other = ((ti.INTERP_STAGED_BLOCKS, 0) if kernel == "interp"
                     else (fd.FUSED_BLOCKS_PER_SM, SCANNET_OTHER))
    left = ti.smem_budget(blocks) - other
    nbytes = left if side == "under" else left + 1
    assert ti.staged_tables([nbytes], other, blocks) == [side == "under"]
    assert ti.smem_budget(blocks) == ti.SM_SMEM // blocks - ti.BLOCK_RESERVED_SMEM
    # blocks of that budget fit an SM together
    assert blocks * (ti.smem_budget(blocks) + ti.BLOCK_RESERVED_SMEM) <= ti.SM_SMEM


def test_staged_tables_smallest_first():
    """Tables that do not all fit: the smallest are staged first, each
    rounded up to 16 bytes, in the caller's order in the result."""
    budget = ti.smem_budget(3)
    got = ti.staged_tables([budget // 2, budget // 3, 40, budget // 3 + 100], 0, 3)
    assert got == [False, True, True, True]
    assert ti.staged_tables([budget - 16, 1], 0, 3) == [True, True]
    assert ti.staged_tables([budget - 15, 1], 0, 3) == [False, True]
    assert ti.staged_tables([budget - 15, 1, budget], 0, 3) == [False, True, False]
    assert ti.staged_tables([], 100, 3) == []


# (levels' storage, F, widths, rows a warp tile, staged levels, smem bytes):
# the ScanNet model, the mesh path's model, the 3-level F = 8 off-default
# shape and the ScanNet cells at F = 36, whose 72-wide input takes 16-point
# warp tiles.
PACKED = {
    "scannet": ([(105, 88, 31), (21, 18, 7)], 4, SCANNET, 32, [False, True],
                (5256 + 4 * 8 * 36 + 21 * 18 * 7 * 4) * 4),
    "mesh": ([(50, 50, 27), (10, 10, 6)], 4, SCANNET, 32, [False, True],
             (5256 + 4 * 8 * 36 + 10 * 10 * 6 * 4) * 4),
    "3lvl_F8": ([(26, 22, 8), (52, 44, 16), (104, 88, 31)], 8, [24, 64, 64, 64, 3], 32,
                [False, False, False], (fd.mma_layout([24, 64, 64, 64, 3])[2]
                                        + 4 * 24 * 36) * 4),
    "mesh_F1": ([(50, 50, 27), (10, 10, 6)], 1, [2, 4, 1], 32, [False, True],
                (fd.mma_layout([2, 4, 1])[2] + 4 * 8 * 36 + 600) * 4),
    "scannet_F36": ([(105, 88, 31), (21, 18, 7)], 36, [72, 64, 64, 1], 16, [False, False],
                    None),
}


@pytest.mark.parametrize("case", list(PACKED), ids=list(PACKED))
def test_fused_wrapper_packs_the_layout(case):
    """pack_args's shared memory: the weights (mma_layout), 4 warps' slices
    of 8 * ceil(L * F / 8) columns of rows + 4 floats, and each staged table
    in level order; the level flags and offsets agree with it."""
    shapes, fdim, dims, rows, staged, smem = PACKED[case]
    rng = np.random.default_rng(len(case))
    grids = [torch.zeros((*s, fdim)) for s in shapes]
    decoder = [(torch.as_tensor(rng.normal(size=(i, o)).astype(np.float32)), torch.zeros(o))
               for i, o in zip(dims[:-1], dims[1:])]
    x = torch.zeros((5, 3))
    bound = torch.tensor([[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]])
    assert fd._check_args(grids, x, bound, decoder, None, None) == dims
    a = fd.pack_args(grids, x, bound, decoder, None, None, torch.empty((5, dims[-1])), dims)
    w_floats = fd.mma_layout(dims)[2]
    off = w_floats + 4 * 8 * -(-dims[0] // 8) * (rows + 4)
    assert (a.rows_per_warp, a.slice_off, a.mlp.w_floats) == (rows, w_floats, w_floats)
    for lvl, shape in enumerate(shapes):
        assert bool(a.levels[lvl].staged) == staged[lvl]
        assert a.levels[lvl].soff == (off if staged[lvl] else 0)
        if staged[lvl]:
            off += -(-math.prod(shape) * fdim // 4) * 4
    assert a.smem_bytes == 4 * off
    if smem is not None:
        assert a.smem_bytes == smem
    assert a.smem_bytes <= ti.smem_budget(fd.FUSED_BLOCKS_PER_SM)


@pytest.mark.parametrize("seed", range(3))
def test_staged_copy_covers_every_corner(seed):
    """The staged copy holds the whole storage, padded rows included: every
    corner's row, valid or clipped, in bound or out, lies in it, and a lerp
    gathered from it matches jax's grid_interpolate with the logical size."""
    rng = np.random.default_rng(seed)
    bound = np.array([[-1.0, 1.4], [0.0, 2.0], [-2.0, 0.5]], np.float32)
    size = rng.integers(2, 12, 3)
    storage = tuple(int(s + p) for s, p in zip(size, rng.integers(0, 4, 3)))
    fdim = int(rng.choice([1, 4, 12]))
    table = rng.normal(size=(*storage, fdim)).astype(np.float32)
    x = rng.uniform(bound[:, 0] - 0.3, bound[:, 1] + 0.3, (2000, 3)).astype(np.float32)
    tsize = torch.tensor(size, dtype=torch.int32)
    lin, w = interp.corner_indices_and_weights(t(x), t(bound), storage, tsize)
    assert bool(((lin >= 0) & (lin < math.prod(storage))).all())
    copy = t(table).reshape(-1)   # the staged copy: the storage, flat
    rows = copy.reshape(-1, fdim)[lin]
    got = (w.unsqueeze(-1) * rows).sum(0)
    ref = jinterp.grid_interpolate(jnp.asarray(table), jnp.asarray(x), jnp.asarray(bound),
                                   size=jnp.asarray(size.astype(np.int32)))
    close(got, np.asarray(ref), TOL)
    close(ti.grid_interpolate_plain(t(table), t(x), t(bound), tsize), np.asarray(ref), TOL)


def emulate_pairs(table, x, bound, size=None):
    """The forward's paired path on the CPU: the copy as the pack kernel
    makes it (row r holds storage rows r and r + 1 along axis 2, r again
    past the last row a corner clips to), then per point the pair at the
    clipped lower corner of axis 2, its rows weighted as the gather kernel
    weights them, at the 4 corners of axes 0 and 1."""
    dims = tuple(table.shape[:3])
    F = table.shape[-1]
    n = [int(size[k]) if size is not None else dims[k] for k in range(3)]
    hi = [min(n[k], dims[k]) - 1 for k in range(3)]
    flat = table.reshape(-1, F)
    r = torch.arange(flat.shape[0])
    upper = torch.where(r % dims[2] < hi[2], r + 1, r)
    pairs = torch.stack([flat, flat[upper]], dim=1)
    i0, fr = [], []
    for k in range(3):
        u = (x[:, k] - bound[k, 0]) / (bound[k, 1] - bound[k, 0]) * float(n[k]) - 0.5
        f0 = torch.floor(u)
        i0.append(f0.long())
        fr.append(u - f0)

    def valid(i, k):
        return ((i >= 0) & (i < n[k])).to(x.dtype)

    zp = i0[2].clamp(0, hi[2])
    wz0 = valid(i0[2], 2) * (1 - fr[2])
    wz1 = valid(i0[2] + 1, 2) * fr[2]
    below = i0[2] < 0
    e0, e1 = torch.where(below, wz1, wz0), torch.where(below, torch.zeros_like(wz1), wz1)
    out = torch.zeros((x.shape[0], F))
    for b0 in (0, 1):
        for b1 in (0, 1):
            ia, ib = i0[0] + b0, i0[1] + b1
            w = (valid(ia, 0) * valid(ib, 1) * (fr[0] if b0 else 1 - fr[0])
                 * (fr[1] if b1 else 1 - fr[1]))
            row = (ia.clamp(0, hi[0]) * dims[1] + ib.clamp(0, hi[1])) * dims[2] + zp
            out += (w * e0)[:, None] * pairs[row, 0] + (w * e1)[:, None] * pairs[row, 1]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_paired_gather_matches_jax(seed):
    """The paired path, emulated, against jax's grid_interpolate: random
    storage padded past a logical size (or none), points in and out of the
    bound and on the bound's faces."""
    rng = np.random.default_rng(10 + seed)
    bound = np.array([[-1.0, 1.4], [0.0, 2.0], [-2.0, 0.5]], np.float32)
    size = rng.integers(1, 10, 3)
    storage = tuple(int(s + p) for s, p in zip(size, rng.integers(0, 3, 3)))
    table = rng.normal(size=(*storage, 4)).astype(np.float32)
    x = rng.uniform(bound[:, 0] - 0.3, bound[:, 1] + 0.3, (3000, 3)).astype(np.float32)
    x[:6] = [bound[:, 0], bound[:, 1], [bound[0, 0], 1.0, bound[2, 1]],
             [0.3, bound[1, 1], -1.0], [-1.2, -0.1, 0.7], [1.6, 2.2, -2.2]]
    sized = seed % 2 == 0
    jsize = jnp.asarray(size.astype(np.int32)) if sized else None
    ref = jinterp.grid_interpolate(jnp.asarray(table), jnp.asarray(x), jnp.asarray(bound),
                                   size=jsize)
    got = emulate_pairs(t(table), t(x), t(bound), size if sized else None)
    close(got, np.asarray(ref), TOL)
