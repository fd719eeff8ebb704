"""miso_tpu_torch.ops.tiled_interp against miso_tpu.ops.pallas_interp (its
Pallas kernels in interpret mode) and miso_tpu.ops.interp.

On the CPU the port runs its plain versions; ``_GridInterp``'s two backward
branches are driven here with the plain functions standing in for the
kernels.  Tolerances (tests/_torch_port.py): values rtol 1e-4 / atol 1e-5
(float32 sums in another order); gradients rtol 2e-3 / atol 2e-4, as the JAX
package's own Pallas tests hold theirs.  The table gradient is held to the
TPU grad kernel at rtol/atol 1e-4, as tests/test_pallas_interp.py holds that
kernel to the gather path.

The JAX references run under jax.jit: an interpret-mode kernel then compiles
into one program instead of dispatching op by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.ops import interp as jinterp
from miso_tpu.ops.pallas_interp import (TILE, _tiled_interp_call,
                                        _tiled_interp_grad_call, bin_points,
                                        halo_tiles, point_cols, tiled_grid_interpolate)
from miso_tpu_torch.ops import tiled_interp as ti

BOUND = np.array([[-1.0, 1.4], [0.0, 2.0], [-2.0, 0.5]], np.float32)
TABLE_GRAD = dict(rtol=1e-4, atol=1e-4)


def _case(seed, shape, n, margin=0.3):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=shape).astype(np.float32)
    x = rng.uniform(BOUND[:, 0] - margin, BOUND[:, 1] + margin, (n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, shape[-1])).astype(np.float32)
    return table, x, cot


@pytest.mark.parametrize("shape", [(9, 17, 18, 4), (24, 32, 33, 2)])
def test_values_match_tiled_kernel(shape):
    """The TPU kernel's tile-sorted output, unsorted through an index payload,
    against the port's output in the caller's order."""
    table, x, _ = _case(0, shape, 1000)
    idx = jnp.arange(x.shape[0], dtype=jnp.int32)
    vals, (sidx,) = jax.jit(lambda tb, xx, i: tiled_grid_interpolate(
        tb, xx, BOUND, payload=[i], interpret=True))(jnp.asarray(table), jnp.asarray(x), idx)
    vals, sidx = np.asarray(vals), np.asarray(sidx)
    # Padding rows carry zero weights and alias index 0: tell real rows by
    # their values (a real row is exactly zero only when all its corners
    # lie outside the grid).
    live = np.abs(vals).sum(1) > 0
    ref = np.zeros((x.shape[0], shape[-1]), np.float32)
    ref[sidx[live]] = vals[live]
    got = ti.grid_interpolate_dispatch(t(table), t(x), t(BOUND))
    close(got, ref, VAL)
    assert 0 < live.sum() < x.shape[0] + len(vals)


@jax.jit
def _jax_interp(tb, xx):
    return jinterp.grid_interpolate(tb, xx, jnp.asarray(BOUND))


def test_f12_matches_grid_interpolate():
    """F > 8, which the TPU op cannot take (fpad=8), against the gather path."""
    table, x, _ = _case(1, (9, 17, 18, 12), 700)
    ref = _jax_interp(jnp.asarray(table), jnp.asarray(x))
    close(ti.grid_interpolate_dispatch(t(table), t(x), t(BOUND)), ref, VAL)


def _tiled_table_grad(table, x, cot):
    """d sum(out * cot) / d table through the TPU forward and grad kernels in
    interpret mode (tests/test_pallas_interp.py:85-142)."""
    shape = table.shape
    T = int(np.prod([-(-s // k) for s, k in zip(shape[:3], TILE)]))
    idx = jnp.arange(x.shape[0], dtype=jnp.int32)
    tile_id, cols = point_cols(jnp.asarray(x), BOUND, shape[:3])
    ct, scols, (sidx,), _ = bin_points(tile_id, cols, T, payload=[idx])
    live = np.abs(np.asarray(scols[:, 6:12])).sum(1) > 0
    cot_sorted = np.asarray(cot)[np.asarray(sidx)] * live[:, None]
    cot_sorted = jnp.asarray(np.pad(cot_sorted, ((0, 0), (0, 8 - shape[-1]))))

    @jax.custom_vjp
    def sti(tiles, scols_, ct_):
        return _tiled_interp_call(ct_, scols_, tiles, interpret=True)

    def fwd(tiles, scols_, ct_):
        return sti(tiles, scols_, ct_), (tiles.shape[0], scols_, ct_)

    def bwd(res, g):
        nt, scols_, ct_ = res
        return (_tiled_interp_grad_call(ct_, scols_, g, nt, interpret=True),
                jnp.zeros_like(scols_), None)

    sti.defvjp(fwd, bwd)
    return np.asarray(jax.jit(jax.grad(
        lambda tb: jnp.sum(sti(halo_tiles(tb), scols, ct) * cot_sorted)))(jnp.asarray(table)))


def test_table_grad_matches_tiled_grad_kernel():
    table, x, cot = _case(3, (9, 17, 18, 4), 700, margin=0.2)
    ref = _tiled_table_grad(table, x, cot)
    d_grid, d_x = ti.grid_interpolate_grad_plain(t(table), t(x), t(BOUND), t(cot),
                                                 need_x=False)
    assert d_x is None
    close(d_grid, ref, TABLE_GRAD)
    tg = t(table, requires_grad=True)
    out = ti.grid_interpolate_dispatch(tg, t(x), t(BOUND))
    (auto,) = torch.autograd.grad((out * t(cot)).sum(), tg)
    close(auto, ref, TABLE_GRAD)


def _first_order_ref(table, x, cot, size=None):
    """jax.grad of sum(grid_interpolate * cot) wrt the table and the points."""
    def loss(tb, xx):
        v = jinterp.grid_interpolate(tb, xx, jnp.asarray(BOUND),
                                     size=None if size is None else jnp.asarray(size))
        return jnp.sum(v * jnp.asarray(cot))

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(table), jnp.asarray(x))


@pytest.fixture(scope="module")
def first_order():
    """A case and its first-order JAX reference, shared by the tests below."""
    table, x, cot = _case(4, (9, 17, 18, 4), 700)
    return table, x, cot, _first_order_ref(table, x, cot)


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded_storage"])
def test_point_grad_matches_jax_grad(padded, first_order):
    """The points' gradient (zeros in the TPU op) against jax.grad of
    grid_interpolate, also on storage padded beyond a logical size."""
    table, x, cot, (ref_grid, ref_x) = first_order
    size = None
    store = table
    if padded:
        store = np.random.default_rng(5).normal(size=(12, 18, 20, 4)).astype(np.float32)
        store[:9, :17, :18] = table
        size = np.array([9, 17, 18], np.int32)
        ref_grid, ref_x = _first_order_ref(store, x, cot, size)
    tsize = None if size is None else t(size)
    d_grid, d_x = ti.grid_interpolate_grad_plain(t(store), t(x), t(BOUND), t(cot), tsize)
    close(d_x, ref_x, GRAD)
    close(d_grid, ref_grid, GRAD)
    xs = t(x, requires_grad=True)
    out = ti.grid_interpolate_dispatch(t(store), xs, t(BOUND), tsize)
    (auto,) = torch.autograd.grad((out * t(cot)).sum(), xs)
    close(auto, ref_x, GRAD)


def _jax_eikonal_like(tb, xx, c):
    """sum over points of |d <interp(x), c> / dx|^2, a second-order loss."""
    gx = jax.grad(lambda p: jnp.sum(jinterp.grid_interpolate(tb, p, jnp.asarray(BOUND))
                                    * c))(xx)
    return jnp.sum(gx ** 2)


@pytest.fixture(scope="module")
def second_order():
    """A case and jax.grad of :func:`_jax_eikonal_like`, shared below."""
    table, x, cot = _case(6, (9, 17, 18, 4), 300, margin=0.0)
    ref = jax.jit(jax.grad(_jax_eikonal_like, argnums=(0, 1)))(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(cot))
    return table, x, cot, ref


def test_grad2_matches_jax(second_order):
    table, x, cot, ref = second_order
    tg, xs = t(table, requires_grad=True), t(x, requires_grad=True)
    out = ti.grid_interpolate_dispatch(tg, xs, t(BOUND))
    (gx,) = torch.autograd.grad((out * t(cot)).sum(), xs, create_graph=True)
    got = torch.autograd.grad((gx ** 2).sum(), [tg, xs])
    for a, b in zip(got, ref):
        close(a, b, GRAD)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernels' plain versions stand in for the kernels, counted."""
    calls = {"forward": 0, "grad": 0, "need_x": [], "need_grid": []}

    def forward(grid, x, bound, size=None):
        calls["forward"] += 1
        return ti.grid_interpolate_plain(grid, x, bound, size)

    def grad(grid, x, bound, g, size=None, need_x=True, need_grid=True):
        calls["grad"] += 1
        calls["need_x"].append(need_x)
        calls["need_grid"].append(need_grid)
        return ti.grid_interpolate_grad_plain(grid, x, bound, g, size, need_x, need_grid)

    monkeypatch.setattr(ti, "grid_interpolate_cuda", forward)
    monkeypatch.setattr(ti, "grid_interpolate_grad_cuda", grad)
    return calls


def test_function_first_order_runs_grad_kernel(plain_kernels, first_order):
    table, x, cot, ref = first_order
    recomputes = ti._GridInterp.recomputes
    tg, xs = t(table, requires_grad=True), t(x, requires_grad=True)
    out = ti._GridInterp.apply(tg, xs, t(BOUND), None)
    close(out, _jax_interp(jnp.asarray(table), jnp.asarray(x)), VAL)
    got = torch.autograd.grad((out * t(cot)).sum(), [tg, xs])
    for a, b in zip(got, ref):
        close(a, b, GRAD)
    # Points that need no gradient: the kernel is asked for the grid's only.
    out = ti._GridInterp.apply(tg, t(x), t(BOUND), None)
    (d_grid,) = torch.autograd.grad((out * t(cot)).sum(), tg)
    close(d_grid, ref[0], GRAD)
    assert plain_kernels["forward"] == 2 and plain_kernels["grad"] == 2
    assert plain_kernels["need_x"] == [True, False]
    assert ti._GridInterp.recomputes == recomputes


def test_function_frozen_grid_asks_for_the_points_only_mode(plain_kernels, first_order):
    """A grid that needs no gradient (LM tracking's frozen query): the
    backward asks the grad kernel for the points' gradient alone."""
    table, x, cot, ref = first_order
    xs = t(x, requires_grad=True)
    out = ti._GridInterp.apply(t(table), xs, t(BOUND), None)
    (d_x,) = torch.autograd.grad((out * t(cot)).sum(), xs)
    close(d_x, ref[1], GRAD)
    assert plain_kernels["grad"] == 1 and plain_kernels["need_grid"] == [False]
    d_grid, d_x2 = ti.grid_interpolate_grad_plain(t(table), t(x), t(BOUND), t(cot),
                                                  need_grid=False)
    assert d_grid is None
    close(d_x2, ref[1], GRAD)


def test_function_create_graph_recomputes(plain_kernels, second_order):
    table, x, cot, ref = second_order
    recomputes = ti._GridInterp.recomputes
    tg, xs = t(table, requires_grad=True), t(x, requires_grad=True)
    out = ti._GridInterp.apply(tg, xs, t(BOUND), None)
    (gx,) = torch.autograd.grad((out * t(cot)).sum(), xs, create_graph=True)
    assert ti._GridInterp.recomputes == recomputes + 1 and plain_kernels["grad"] == 0
    got = torch.autograd.grad((gx ** 2).sum(), [tg, xs])
    for a, b in zip(got, ref):
        close(a, b, GRAD)
