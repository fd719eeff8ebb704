"""How the interp grad kernel spreads its atomics
(``ops/tiled_interp.py::interp_grad_copies``), held on the CPU.

The CUDA backward (``csrc/grid_interp.cu``) runs one thread per point, in
blocks of 256 points in the caller's order; block b adds its points' w_c * g
into copy ``b % copies`` of the table, and the copies are summed into the
gradient.  The plan gives a table whose rows take many atomics several
copies, so that the same-address atomics of its rows spread out, and any
other table a single copy, the gradient itself.  Here the plan is held to its
budget over 200 random shapes, and a plain-torch emulation of the scatter
into the copies and their sum, built on the plan, is held to
``grid_interpolate_grad_plain`` and to ``jax.grad`` of
``miso_tpu/ops/interp.py::grid_interpolate``.  The emulation lives in this
file only: the package's CPU path is the plain version.  Last, the plain
version's points' gradient at a point on a cell face is held to ``jax.grad``
(the kernels round u as both do: ``csrc/mtt_grid.cuh``).

Tolerance: atol/rtol 1e-5, float32 sums taken in another order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, t
from miso_tpu.ops import interp as jinterp
from miso_tpu_torch.ops import interp
from miso_tpu_torch.ops import tiled_interp as ti

BOUND = np.array([[-1.0, 1.4], [0.0, 2.0], [-2.0, 0.5]], np.float32)
TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 256  # points per block of the grad kernel (MTT_INTERP_THREADS)


def emulate_grad(grid, x, bound, g, size=None, need_x=True):
    """Block b of 256 points scatters its corners' w_c * g into copy
    b % copies; the copies are summed; the points' gradient per point."""
    dims = tuple(grid.shape[:3])
    F = grid.shape[-1]
    n = x.shape[0]
    n_copies = ti.interp_grad_copies(dims, F, n)
    lin, w = interp.corner_indices_and_weights(x, bound, dims, size)
    rows = math.prod(dims)
    copies = torch.zeros((n_copies * rows, F), dtype=g.dtype)
    copy_of = (torch.arange(n) // BLOCK) % n_copies
    target = lin + (copy_of * rows).unsqueeze(0)
    copies.index_add_(0, target.flatten(), (w.unsqueeze(-1) * g.unsqueeze(0)).reshape(-1, F))
    d_grid = copies.reshape(n_copies, *grid.shape).sum(0)
    if not need_x:
        return d_grid, None
    dots = (grid.reshape(-1, F)[lin] * g[None]).sum(-1)
    dw = ti.corner_weight_derivatives(x, bound, dims, size)
    return d_grid, (dw * dots[None]).sum(1).T


@pytest.mark.parametrize("seed", range(4))
def test_plan_fits_budget(seed):
    """50 random (dims, F, n) a seed, 200 in all: between 1 and MAX_COPIES
    copies, several only when they fit COPY_BUDGET together and each gets at
    least ATOMICS_PER_COPY atomics a row; every valid corner's row, in bound
    or out, with or without a logical size, lies in the table and so in
    every copy."""
    rng = np.random.default_rng(seed)
    bound = torch.as_tensor(BOUND)
    for _ in range(50):
        dims = tuple(int(v) for v in rng.integers(1, 120, 3))
        fdim = int(rng.choice([1, 2, 3, 4, 8, 12, 36, 64]))
        n = int(rng.choice([0, 1, 1000, 2 ** 15, 10 ** 6]))
        copies = ti.interp_grad_copies(dims, fdim, n)
        rows = math.prod(dims)
        assert 1 <= copies <= ti.MAX_COPIES
        if copies > 1:
            assert copies * rows * fdim * 4 <= ti.COPY_BUDGET
            assert 8 * n >= copies * rows * ti.ATOMICS_PER_COPY
        else:
            assert (8 * n < 2 * rows * ti.ATOMICS_PER_COPY
                    or 2 * rows * fdim * 4 > ti.COPY_BUDGET)
        size = None
        if rng.uniform() < 0.5:
            size = torch.tensor([int(rng.integers(1, d + 1)) for d in dims], dtype=torch.int32)
        x = torch.as_tensor(rng.uniform(BOUND[:, 0] - 0.4, BOUND[:, 1] + 0.4, (300, 3))
                            .astype(np.float32))
        lin, w = interp.corner_indices_and_weights(x, bound, dims, size)
        assert bool(((lin >= 0) & (lin < rows))[w != 0].all())


def test_plan_examples():
    """The ScanNet levels at 1e6 points: the coarse table (2,646 rows, some
    3,000 atomics a row) in 47 copies, the fine one (286,440 rows, 28) in
    one; the mesh path's levels at 2^15: the coarse one (600 rows) in 6, the
    fine one in one."""
    assert ti.interp_grad_copies((21, 18, 7), 4, 10 ** 6) == 47
    assert ti.interp_grad_copies((105, 88, 31), 4, 10 ** 6) == 1
    assert ti.interp_grad_copies((10, 10, 6), 4, 2 ** 15) == 6
    assert ti.interp_grad_copies((50, 50, 27), 4, 2 ** 15) == 1
    assert ti.interp_grad_copies((2, 2, 2), 1, 10 ** 6) == ti.MAX_COPIES
    assert ti.interp_grad_copies((21, 18, 7), 4, 0) == 1


def _jax_grads(table, x, cot, size=None):
    def loss(tb, xx):
        v = jinterp.grid_interpolate(tb, xx, jnp.asarray(BOUND),
                                     size=None if size is None else jnp.asarray(size))
        return jnp.sum(v * jnp.asarray(cot))

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))


# (storage shape, logical size or None, points, where the points are).
EMULATION_CASES = {
    "F4_out_of_bound": ((26, 30, 20, 4), None, 4000, "spread"),
    "F4_copies": ((6, 5, 4, 4), None, 6000, "spread"),
    "F1_copies": ((5, 4, 3, 1), None, 3000, "spread"),
    "F12_copies": ((6, 5, 4, 12), None, 3000, "spread"),
    "F4_padded_logical_size": ((8, 7, 6, 4), (6, 5, 4), 6000, "spread"),
    "F4_one_cell": ((26, 30, 20, 4), None, 5000, "one_cell"),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES), ids=list(EMULATION_CASES))
def test_emulation_matches_plain_and_jax(case):
    shape, size, n, where = EMULATION_CASES[case]
    rng = np.random.default_rng(sum(shape) + n)
    table = rng.normal(size=shape).astype(np.float32)
    if where == "one_cell":
        u = np.array([11, 13, 7]) + rng.uniform(0.1, 0.9, (n, 3))
        x = (BOUND[:, 0] + (u + 0.5) / np.array(shape[:3]) * (BOUND[:, 1] - BOUND[:, 0]))
        x = x.astype(np.float32)
    else:
        x = rng.uniform(BOUND[:, 0] - 0.3, BOUND[:, 1] + 0.3, (n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, shape[-1])).astype(np.float32)
    tsize = None if size is None else torch.tensor(size, dtype=torch.int32)
    args = (t(table), t(x), t(BOUND), t(cot), tsize)
    copies = ti.interp_grad_copies(shape[:3], shape[-1], n)
    assert (copies > 1) == case.endswith(("copies", "logical_size"))
    d_grid, d_x = emulate_grad(*args)
    r_grid, r_x = ti.grid_interpolate_grad_plain(*args)
    close(d_grid, r_grid.numpy(), TOL)
    close(d_x, r_x.numpy(), TOL)
    j_grid, j_x = _jax_grads(table, x, cot, None if size is None else np.array(size, np.int32))
    close(d_grid, np.asarray(j_grid), TOL)
    close(d_x, np.asarray(j_x), TOL)
    only, none = emulate_grad(*args, need_x=False)
    assert none is None
    close(only, r_grid.numpy(), TOL)


def test_point_on_a_cell_face_matches_jax():
    """A point of the ScanNet coarse level whose u is exactly 16 on axis 1
    when rounded op by op (as the reference and the kernels round it; a fused
    multiply-add gives 15.99999): its floor cell, and so its points'
    gradient, which jumps across the face, match ``jax.grad``."""
    bound = np.array([[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]], np.float32)
    rng = np.random.default_rng(7)
    x = rng.uniform(bound[:, 0], bound[:, 1], (64, 3)).astype(np.float32)
    x[0] = [1.4275164604187012, 8.010832786560059, 0.1370464414358139]
    table = rng.normal(size=(21, 18, 7, 4)).astype(np.float32)
    cot = rng.normal(size=(64, 4)).astype(np.float32)
    lin, _ = interp.corner_indices_and_weights(t(x[:1]), t(bound), (21, 18, 7))
    assert (int(lin[0, 0]) // 7) % 18 == 16
    r_grid, r_x = ti.grid_interpolate_grad_plain(t(table), t(x), t(bound), t(cot))

    def loss(tb, xx):
        return jnp.sum(jinterp.grid_interpolate(tb, xx, jnp.asarray(bound)) * jnp.asarray(cot))

    j_grid, j_x = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    close(r_grid, np.asarray(j_grid), TOL)
    close(r_x, np.asarray(j_x), TOL)
