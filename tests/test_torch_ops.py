"""miso_tpu_torch.ops (interp, mlp, se3, diff) against miso_tpu.ops.

Tolerances: values rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 / atol 2e-4
(tests/_torch_port.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.ops import diff as jdiff
from miso_tpu.ops import interp as jinterp
from miso_tpu.ops import mlp as jmlp
from miso_tpu.ops import se3 as jse3
from miso_tpu_torch.ops import diff, interp, mlp, se3

BOUND = np.array([[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]], np.float32)


def _grid_and_points(rng, shape=(5, 4, 3), F=4, N=300, padded=False):
    """A grid (optionally padded with garbage beyond a logical size) and
    query points, out-of-bound ones included."""
    g = rng.normal(0, 1, (*shape, F)).astype(np.float32)
    x = rng.uniform(-1.3, 1.4, (N, 3)).astype(np.float32)
    if not padded:
        return g, x, None
    p = rng.normal(0, 10, (shape[0] + 3, shape[1] + 2, shape[2] + 1, F)).astype(np.float32)
    p[:shape[0], :shape[1], :shape[2]] = g
    return p, x, np.asarray(shape, np.int32)


def test_coordinate_maps(rng):
    x = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    size = np.asarray([5, 4, 3], np.float32)
    close(interp.index_coords(t(x), t(BOUND), t(size)),
          jinterp.index_coords(x, BOUND, size), VAL)
    xn = interp.normalize_coordinates(t(x), t(BOUND))
    close(xn, jinterp.normalize_coordinates(x, BOUND), VAL)
    close(interp.denormalize_coordinates(xn, t(BOUND)), x, VAL)
    close(interp.vertex_positions((5, 4, 3), t(BOUND)),
          jinterp.vertex_positions((5, 4, 3), jnp.asarray(BOUND)), VAL)
    for cell in (0.5, 0.1, 0.37):
        assert interp.grid_shape_for_bound(BOUND, cell) == \
            jinterp.grid_shape_for_bound(BOUND, cell)


@pytest.mark.parametrize("padded", [False, True], ids=["static", "sized"])
def test_corner_indices_and_weights(rng, padded):
    g, x, size = _grid_and_points(rng, padded=padded)
    spatial = g.shape[:3]
    lin, w = interp.corner_indices_and_weights(
        t(x), t(BOUND), spatial, None if size is None else t(size))
    jlin, jw = jinterp.corner_indices_and_weights(
        jnp.asarray(x), jnp.asarray(BOUND), spatial,
        None if size is None else jnp.asarray(size))
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))
    close(w, jw, VAL)


@pytest.mark.parametrize("padded", [False, True], ids=["static", "sized"])
def test_grid_interpolate_value_grads_grad2(rng, padded):
    g, x, size = _grid_and_points(rng, padded=padded)
    c = rng.normal(0, 1, (x.shape[0], g.shape[-1])).astype(np.float32)
    jsize = None if size is None else jnp.asarray(size)
    tsize = None if size is None else t(size)

    def jf(gg, xx):
        return jinterp.grid_interpolate(gg, xx, jnp.asarray(BOUND), size=jsize)

    gt, xt = t(g, True), t(x, True)
    out = interp.grid_interpolate(gt, xt, t(BOUND), size=tsize)
    close(out, jf(g, x), VAL)

    # First order, wrt grid and x.
    jg, jx = jax.grad(lambda gg, xx: jnp.sum(jf(gg, xx) * c), argnums=(0, 1))(g, x)
    dg, dx = torch.autograd.grad((out * t(c)).sum(), [gt, xt], create_graph=True)
    close(dg, jg, GRAD)
    close(dx, jx, GRAD)

    # Second order: d/dgrid of ||d(out . c)/dx||^2.
    def j_eik(gg):
        gx = jax.grad(lambda xx: jnp.sum(jf(gg, xx) * c))(x)
        return jnp.sum(gx ** 2)

    (dg2,) = torch.autograd.grad((dx ** 2).sum(), gt)
    close(dg2, jax.grad(j_eik)(g), GRAD)


@pytest.mark.parametrize("ignore", [None, [0.0, 1.0], [1.0, 0.0]])
def test_multi_level_interpolate(rng, ignore):
    grids = [rng.normal(0, 1, (5 * (l + 1), 4 * (l + 1), 3 * (l + 1), 4)).astype(np.float32)
             for l in range(2)]
    x = rng.uniform(-1.3, 1.4, (300, 3)).astype(np.float32)
    ig = None if ignore is None else np.asarray(ignore, np.float32)
    got = interp.multi_level_interpolate([t(g) for g in grids], t(x), t(BOUND),
                                         None if ig is None else t(ig))
    ref = jinterp.multi_level_interpolate([jnp.asarray(g) for g in grids], jnp.asarray(x),
                                          jnp.asarray(BOUND),
                                          None if ig is None else jnp.asarray(ig))
    close(got, ref, VAL)


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_apply_and_grid_decode(rng, bias):
    params = jmlp.mlp_init(jax.random.PRNGKey(0), 8, 3, 32, 2, bias=bias)
    tparams = tuple((t(W), None if b is None else t(b)) for W, b in params)
    x = rng.normal(0, 1, (200, 8)).astype(np.float32)
    close(mlp.mlp_apply(tparams, t(x)), jmlp.mlp_apply(params, jnp.asarray(x)), VAL)
    close(interp.grid_decode(t(x), None, tparams), jinterp.grid_decode(x, None, params), VAL)
    # Init: torch.nn.Linear's bounds, shapes and the (in, out) layout.
    init = mlp.mlp_init(8, 3, 32, 2, bias=bias, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert [tuple(W.shape) for W, _ in init] == [tuple(W.shape) for W, _ in params]
    for (W, b), dim in zip(init, (8, 32, 32, 32)):
        assert float(W.abs().max()) <= 1.0 / np.sqrt(dim)
        assert (b is None) == (not bias)


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.3, 3.0], ids=["zero", "tiny", "mid", "large"])
def test_so3_exp_log(rng, scale):
    w = (rng.normal(0, 1, (64, 3)) * scale).astype(np.float32)
    wt = t(w, True)
    R = se3.so3_exp(wt)
    close(R, jse3.so3_exp(jnp.asarray(w)), VAL)
    c = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    (g,) = torch.autograd.grad((R * t(c)).sum(), wt)
    close(g, jax.grad(lambda ww: jnp.sum(jse3.so3_exp(ww) * c))(jnp.asarray(w)), GRAD)
    assert np.isfinite(g.numpy()).all()
    Rj = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    close(se3.so3_log(t(Rj)), jse3.so3_log(jnp.asarray(Rj)), dict(rtol=1e-4, atol=1e-4))


def test_pose_transforms(rng):
    K, N = 6, 400
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 1, (K, 3)).astype(np.float32))))
    tr = rng.normal(0, 2, (K, 3)).astype(np.float32)
    p = rng.normal(0, 3, (N, 3)).astype(np.float32)
    ids = rng.integers(0, K, (N,)).astype(np.int32)
    Rt, tt = t(R, True), t(tr, True)
    out = se3.transform_points_by_id(t(p), t(ids), Rt, tt)
    close(out, jse3.transform_points_by_id(p, ids, R, tr), VAL)
    c = rng.normal(0, 1, (N, 3)).astype(np.float32)
    gR, gt = torch.autograd.grad((out * t(c)).sum(), [Rt, tt])
    jR, jt = jax.grad(lambda a, b: jnp.sum(jse3.transform_points_by_id(p, ids, a, b) * c),
                      argnums=(0, 1))(R, tr)
    close(gR, jR, GRAD)
    close(gt, jt, GRAD)

    close(se3.transform_points_to(t(p), t(R[0]), t(tr[0])),
          jse3.transform_points_to(p, R[0], tr[0]), VAL)
    close(se3.transform_points_from(t(p), t(R[0]), t(tr[0])),
          jse3.transform_points_from(p, R[0], tr[0]), VAL)
    dr = rng.normal(0, 0.1, (K, 3)).astype(np.float32)
    for a, b in zip(se3.apply_pose_correction(t(R), t(tr), t(dr), t(tr)),
                    jse3.apply_pose_correction(R, tr, dr, tr)):
        close(a, b, VAL)
    close(se3.hat(t(tr)), jse3.hat(tr), VAL)
    close(se3.coords_in_bound(t(p), t(BOUND)), jse3.coords_in_bound(p, BOUND), VAL)
    close(se3.identity_rotations(K, device="cpu"), jse3.identity_rotations(K), VAL)


@pytest.mark.parametrize("method", ["finitediff", "autograd"])
def test_gradient3d(rng, method):
    g = rng.normal(0, 1, (5, 4, 3, 1)).astype(np.float32)
    x = rng.uniform(-0.9, 0.9, (200, 3)).astype(np.float32)
    gt = t(g, True)

    def tf(xx):
        return interp.grid_interpolate(gt, xx, t(BOUND))

    def jf(gg):
        return lambda xx: jinterp.grid_interpolate(gg, xx, jnp.asarray(BOUND))

    grad = diff.gradient3d(t(x), tf, method=method, finite_diff_eps=0.05)
    close(grad, jdiff.gradient3d(jnp.asarray(x), jf(g), method=method,
                                 finite_diff_eps=0.05), dict(rtol=1e-3, atol=1e-4))
    # The result is differentiable: d/dgrid of sum(grad^2).
    (dg,) = torch.autograd.grad((grad ** 2).sum(), gt)
    jdg = jax.grad(lambda gg: jnp.sum(jdiff.gradient3d(
        jnp.asarray(x), jf(gg), method=method, finite_diff_eps=0.05) ** 2))(g)
    close(dg, jdg, GRAD)
