"""The alternative models and grids of miso_tpu_torch against miso_tpu: the
hash grid, iSDF, PointSDF, VM grids, 2D grids and the 2D SDF path.

Inputs come from numpy seeds; JAX parameters are carried across with
``miso_tpu_torch.convert``.  Tolerances: values rtol 1e-4 / atol 1e-5 and
gradients rtol 2e-3 / atol 2e-4 (tests/_torch_port.py), except where a test
states its own: iSDF's values atol 2e-5 (its 297-wide encoding's sines and
the 256-wide float32 products, and torch's softplus, which is the identity
where 100 x > 20 and differs from ``jax.nn.softplus`` by under 2.1e-11
there).  Parameters after one trainer step: the gradient tolerance (Adam's
first step is lr * g / (|g| + eps)).

The JAX trainers here get a mask with every buffer of the port at 0
(``bound``, ``Rwk``, ``twk``, GridNet's ``ignore_level``, PointSDF's
``points``): the JAX base Trainer's default ``tree_full_mask`` trains those
leaves too (ROADMAP Queue 3, shown by
``test_jax_full_mask_trains_the_buffers``); the port keeps them as buffers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.datasets.sdf_2d import Sdf2D as JSdf2D
from miso_tpu.datasets.sdf_3d import Sdf3D as JSdf3D
from miso_tpu.datasets.shapes import icosphere
from miso_tpu.losses.miso import make_loss as jmake_loss
from miso_tpu.losses.sdf import sdf_loss_2d as jsdf_loss_2d
from miso_tpu.losses.sdf import tsdf_loss_3d as jtsdf
from miso_tpu.models import base as jbase
from miso_tpu.models import hashgrid as jh
from miso_tpu.models import isdf as ji
from miso_tpu.models import pointsdf as jp
from miso_tpu.models.grid_net import create_grid_net as jcreate_grid_net
from miso_tpu.models.grid_net import grid_net_mask as jgrid_net_mask
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.ops import diff as jdiff
from miso_tpu.ops import interp as jinterp
from miso_tpu.ops import mlp as jmlp
from miso_tpu.ops import se3 as jse3
from miso_tpu.train import checkpoint as jckpt
from miso_tpu.train.trainer import Trainer as JTrainer
from miso_tpu_torch import convert
from miso_tpu_torch.datasets.sdf_2d import Sdf2D
from miso_tpu_torch.datasets.sdf_3d import Sdf3D
from miso_tpu_torch.losses.miso import make_loss
from miso_tpu_torch.losses.sdf import sdf_loss_2d, tsdf_loss_3d
from miso_tpu_torch.models import base as tbase
from miso_tpu_torch.models import hashgrid as th
from miso_tpu_torch.models import isdf as ti
from miso_tpu_torch.models import pointsdf as tp
from miso_tpu_torch.models.grid_net import grid_net_mask
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.ops import diff as tdiff
from miso_tpu_torch.ops import interp as tinterp
from miso_tpu_torch.ops import mlp as tmlp
from miso_tpu_torch.ops import se3 as tse3
from miso_tpu_torch.train import checkpoint as tckpt
from miso_tpu_torch.train.trainer import Trainer

ISDF_VAL = dict(rtol=1e-4, atol=2e-5)
POSES = ("rot_corr", "trans_corr", "Rwk", "twk", "bound")

HASH_CFG = {"grid": {"bound": [[-1.0, 1.2], [-0.9, 1.0], [-1.0, 0.9]]},
            "hash": {"n_levels": 4, "feature_dim": 2, "base_resolution": 4,
                     "per_level_scale": 1.8, "log2_hashmap_size": 9},
            "decoder": {"hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": True},
            "pose": {"num_poses": 2, "optimize": False}}
ISDF_CFG = {"grid": {"bound": [[-1, 1]] * 3}, "isdf": {"hidden_size": 32},
            "pose": {"num_poses": 1, "optimize": False}}
POINT_CFG = {"point": {"total_samples": 800, "noise_threshold": 0.05,
                       "sample_ratio_surface": 0.4, "sample_ratio_random": 0.2,
                       "feature_dim": 4, "k_neighbors": 6, "resolution": 0.15,
                       "hash_table_size": 2 ** 12, "num_nei_cells": 1, "search_alpha": 1.0,
                       "bound": [[-1, 1]] * 3},
             "decoder": {"sinusoidal_pe": True, "hidden_dim": 16, "num_layers": 3,
                         "output_dim": 1},
             "pose": {"num_frames": 1, "optimize": False}}
VM_CFG = {"spatial_dim": 3,
          "grid": {"type": "VM", "feature_dim": 3, "init_stddev": 1e-2,
                   "bound": [[-1.0, 1.0], [-0.8, 1.1], [-1.0, 0.9]], "base_cell_size": 0.5,
                   "per_level_scale": 2.0, "n_levels": 2, "VM": {"rank": 4, "fix_bases": False}},
          "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                      "pos_invariant": True, "fix": False, "pretrained_model": None},
          "pose": {"optimize": False, "num_poses": 1}}


def grid_2d_cfg(bound):
    """tests/test_models_extra.py's 2D GridNet, narrower."""
    return {"spatial_dim": 2,
            "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-1,
                     "bound": bound, "base_cell_size": 0.8, "per_level_scale": 4.0,
                     "n_levels": 2},
            "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": False, "fix": False, "pretrained_model": None},
            "pose": {"optimize": False, "num_poses": 1}}


def disk_image(n=48):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = np.ones((n, n), np.float32)
    img[(ii - n // 2) ** 2 + (jj - n // 2) ** 2 < (n // 4) ** 2] = 0.0
    img[3:9, 30:40] = 0.0
    return img


@pytest.fixture(scope="module")
def sphere():
    return icosphere(2, 0.7)


# ---------------------------------------------------------------------------
# Carrying JAX models across.
# ---------------------------------------------------------------------------

def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def hash_pair(seed=0):
    jm = jh.create_hash_grid_net(jax.random.PRNGKey(seed), HASH_CFG)
    arrays = dict(tables=np_tree(list(jm.tables)), decoder=np_tree(list(jm.decoder)),
                  **{k: np.asarray(getattr(jm, k)) for k in POSES})
    return jm, convert.hash_grid_net_from_numpy(arrays, HASH_CFG, device="cpu")


def isdf_pair(seed=0):
    jm = ji.create_isdf(jax.random.PRNGKey(seed), ISDF_CFG)
    arrays = dict(layers=np_tree(list(jm.layers)),
                  **{k: np.asarray(getattr(jm, k)) for k in POSES})
    return jm, convert.isdf_from_numpy(arrays, ISDF_CFG, device="cpu")


def pointsdf_pair(mesh, seed=0):
    jm = jp.create_pointsdf(jax.random.PRNGKey(seed), POINT_CFG, mesh=JMesh(*mesh))
    arrays = dict(points=np.asarray(jm.points), features=np.asarray(jm.features),
                  decoder=np_tree(list(jm.decoder)),
                  hash_point_idx=np.asarray(jm.hash_point_idx),
                  neighbor_dx=np.asarray(jm.neighbor_dx),
                  **{k: np.asarray(getattr(jm, k)) for k in POSES})
    return jm, convert.pointsdf_from_numpy(arrays, POINT_CFG, device="cpu")


def grid_pair(cfg, seed=0):
    jm = jcreate_grid_net(jax.random.PRNGKey(seed), cfg)
    arrays = dict(features=np_tree(list(jm.features)), stability=np_tree(list(jm.stability)),
                  decoder=np_tree(list(jm.decoder)),
                  vm_bases=None if jm.vm_bases is None else np_tree(list(jm.vm_bases)),
                  ignore_level=np.asarray(jm.ignore_level), anchor_kf=np.asarray(jm.anchor_kf),
                  **{k: np.asarray(getattr(jm, k)) for k in POSES})
    return jm, convert.grid_net_from_numpy(arrays, cfg, device="cpu")


def jax_leaf(tree, name):
    """The JAX leaf that the port's parameter ``name`` holds: the port's
    decoders and layer lists are flat (``decoder.<i>``), the JAX ones
    nested per layer."""
    head, *rest = name.split(".")
    node = getattr(tree, head)
    if head in ("decoder", "layers") and rest:
        i = int(rest[0])
        for layer in node:
            if i < len(layer):
                return layer[i]
            i -= len(layer)
    for part in rest:
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def grads_of(model, loss):
    names = [n for n, p in model.named_parameters()]
    gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                             allow_unused=True)
    return {n: g for n, g in zip(names, gs) if g is not None}


def check_forward_and_grads(jm, tm, x, val_tol=VAL):
    """Values and the gradients of sum(out^2) wrt every parameter."""
    (jout, jval), jgrad = jax.jit(jax.value_and_grad(
        lambda m, xx: (jnp.sum(m(xx) ** 2), m(xx)), has_aux=True, allow_int=True))(
            jm, jnp.asarray(x))
    tval = tm(t(x))
    tout = torch.sum(tval ** 2)
    close(tout, jout, val_tol)
    close(tval, jval, val_tol)
    got = grads_of(tm, tout)
    assert got, "no parameter got a gradient"
    for name, g in got.items():
        close(g, jax_leaf(jgrad, name), GRAD)
    return got


# ---------------------------------------------------------------------------
# Hash grid.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tsize,res", [(2 ** 12, 8), (2 ** 8, 12)], ids=["dense", "hashed"])
def test_hash_encode_level_matches_jax(tsize, res):
    """Values and the table's and points' gradients, with points on the
    upper faces (x01 = 1 reads cell res - 1 with weight 1)."""
    rng = np.random.default_rng(res)
    table = rng.standard_normal((min((res + 1) ** 3, tsize), 3)).astype(np.float32)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    x[:4, 0] = 1.0
    x[4:8] = 1.0
    x[8:12, 2] = 0.0
    cot = rng.standard_normal((300, 3)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda tb, xx: jh.hash_encode_level(tb, xx, res),
                         jnp.asarray(table), jnp.asarray(x))
    jg_table, jg_x = jvjp(jnp.asarray(cot))
    tb, tx = t(table, True), t(x, True)
    out = th.hash_encode_level(tb, tx, res)
    close(out, jout, VAL)
    g_table, g_x = torch.autograd.grad(out, [tb, tx], t(cot))
    close(g_table, jg_table, GRAD)
    close(g_x, jg_x, GRAD)


def test_hash_grid_net_matches_jax():
    jm, tm = hash_pair()
    assert tm.resolutions == jm.resolutions and tm.table_size == jm.table_size
    assert [tuple(p.shape) for p in tm.tables] == [tuple(a.shape) for a in jm.tables]
    x = np.random.default_rng(1).uniform(-1.1, 1.3, (400, 3)).astype(np.float32)
    got = check_forward_and_grads(jm, tm, x)
    assert {"tables.0", "tables.3", "decoder.0", "decoder.5"} <= set(got)


# ---------------------------------------------------------------------------
# iSDF.
# ---------------------------------------------------------------------------

def test_isdf_positional_encoding_matches_jax():
    x = np.random.default_rng(2).uniform(-3, 3, (50, 3)).astype(np.float32)
    got = ti.positional_encoding(t(x))
    assert got.shape == (50, ti.pe_embedding_size()) == (50, 297)
    close(got, ji.positional_encoding(jnp.asarray(x)), ISDF_VAL)


@pytest.mark.parametrize("d", [3, 2], ids=["3d", "2d"])
def test_isdf_matches_jax(d):
    jm, tm = isdf_pair()
    x = np.random.default_rng(3).uniform(-1.5, 1.5, (300, d)).astype(np.float32)
    got = check_forward_and_grads(jm, tm, x, ISDF_VAL)
    assert len(got) == 2 * len(jm.layers)


def test_fp32_matmul_pins_float32_to_the_second_order(sphere, monkeypatch):
    """With the TF32 matmul flag on, every product of iSDF, PointSDF's MLP and
    the VM bases, forward, backward and double backward, runs with it off
    (a VM GridNet's decoder is GridNet's, under the caller's flags); the flag
    is the caller's again afterwards, and fp32_matmul's second-order
    gradient is the plain product's."""
    seen = []
    matmul = torch.Tensor.__matmul__

    def recording(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    _, isdf = isdf_pair()
    _, psdf = pointsdf_pair(sphere)
    _, vm = grid_pair(VM_CFG)

    def vm_bases(x):
        fac, basis = vm.features[0], vm.vm_bases[0]
        return tinterp.vm_basis_apply(basis, tinterp.vm_interpolate(fac, fac, x, vm.bound))

    x = t(np.random.default_rng(10).uniform(-0.8, 0.8, (64, 3)).astype(np.float32), True)
    before = torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.Tensor, "__matmul__", recording)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fn, params in ((isdf, isdf.parameters()), (psdf, psdf.parameters()),
                           (vm_bases, vm.vm_bases.parameters())):
            (g,) = torch.autograd.grad((fn(x) ** 2).sum(), x, create_graph=True)
            assert torch.backends.cuda.matmul.allow_tf32
            torch.autograd.grad((g ** 2).sum(), list(params), allow_unused=True)
    finally:
        monkeypatch.undo()
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen and not any(seen), seen
    a, b = t(np.eye(3, dtype=np.float32) + 0.5, True), t(np.full((3, 2), 0.3, np.float32), True)
    for fn in (tmlp.fp32_matmul, torch.matmul):
        (ga,) = torch.autograd.grad((fn(a, b) ** 3).sum(), a, create_graph=True)
        (gb,) = torch.autograd.grad(ga.sum(), b)
        if fn is tmlp.fp32_matmul:
            got = (ga, gb)
    close(got[0], ga.detach().numpy(), VAL)
    close(got[1], gb.numpy(), VAL)


# ---------------------------------------------------------------------------
# PointSDF.
# ---------------------------------------------------------------------------

def test_pointsdf_cloud_and_table_are_jax_s(sphere):
    jm = jp.create_pointsdf(jax.random.PRNGKey(0), POINT_CFG, mesh=JMesh(*sphere))
    tm = tp.create_pointsdf(POINT_CFG, mesh=TriangleMesh(*sphere), device="cpu")
    for name in ("points", "hash_point_idx", "neighbor_dx", "bound"):
        a, b = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tm.features.shape == jm.features.shape
    assert [tuple(p.shape) for p in tm.decoder] == \
        [tuple(a.shape) for layer in jm.decoder for a in layer]
    # The default fan: 2 neighbour cells with alpha 1 keeps 93 of 125.
    default = tp.support_cloud({"total_samples": 10})
    assert default[2].shape == (93, 3)


def test_pointsdf_query_hash_matches_jax_on_negative_cells(sphere):
    jm, tm = pointsdf_pair(sphere)
    x = np.random.default_rng(4).uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    jidx, jvalid = jm._neighbor_candidates(jnp.asarray(x))
    idx, valid = tm.neighbor_candidates(t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_pointsdf_matches_jax(sphere):
    """Outputs and gradients (never indices: top-k orders ties its own way),
    with queries that have fewer than k valid candidates and none at all."""
    jm, tm = pointsdf_pair(sphere)
    rng = np.random.default_rng(5)
    # Far queries whose fan hashes to empty slots only, or to fewer than k
    # occupied ones (a slot is valid whatever the distance of its point).
    far = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
    n_far = tm.neighbor_candidates(t(far))[1].sum(1).numpy()
    none, few = far[n_far == 0][:2], far[(n_far > 0) & (n_far < tm.k_neighbors)][:4]
    assert len(none) == 2 and len(few) == 4
    x = np.concatenate([rng.uniform(-0.9, 0.9, (300, 3)).astype(np.float32), few, none])
    got = check_forward_and_grads(jm, tm, x)
    assert {"features", "decoder.0", "decoder.9"} <= set(got)
    out = tm(t(x)).detach().numpy()[:, 0]
    n_valid = tm.neighbor_candidates(t(x))[1].sum(1).numpy()
    assert (out[n_valid > 0] != 0).all()
    np.testing.assert_array_equal(out[n_valid == 0], 0.0)


# ---------------------------------------------------------------------------
# VM grids.
# ---------------------------------------------------------------------------

def test_vm_ops_match_jax():
    rng = np.random.default_rng(6)
    R, F = 4, 3
    shapes = {"xy": (6, 5, R), "xz": (6, 7, R), "yz": (5, 7, R),
              "x": (6, R), "y": (5, R), "z": (7, R)}
    fac = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    basis = {k: rng.standard_normal((F, R)).astype(np.float32) for k in ("xy_z", "xz_y", "yz_x")}
    bound = np.array([[-1, 1], [-0.8, 1.1], [-1, 0.9]], np.float32)
    x = rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32)

    def jfn(fac, basis, x):
        c = jinterp.vm_interpolate(fac, fac, x, jnp.asarray(bound))
        return c, jinterp.vm_basis_apply(basis, c)

    (jc, jout), jvjp = jax.vjp(jfn, *jax.tree_util.tree_map(jnp.asarray, (fac, basis, x)))
    tfac = {k: t(v, True) for k, v in fac.items()}
    tbasis = {k: t(v, True) for k, v in basis.items()}
    tx = t(x, True)
    c = tinterp.vm_interpolate(tfac, tfac, tx, t(bound))
    out = tinterp.vm_basis_apply(tbasis, c)
    assert list(c) == ["xy_z", "xz_y", "yz_x"]
    for k in c:
        close(c[k], jc[k], VAL)
    close(out, jout, VAL)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    jg_fac, jg_basis, jg_x = jvjp(({k: jnp.zeros_like(v) for k, v in jc.items()},
                                   jnp.asarray(cot)))
    leaves = [*tfac.values(), *tbasis.values(), tx]
    got = dict(zip([*tfac, *tbasis, "points"], torch.autograd.grad(out, leaves, t(cot))))
    for k in fac:
        close(got[k], jg_fac[k], GRAD)
    for k in basis:
        close(got[k], jg_basis[k], GRAD)
    close(got["points"], jg_x, GRAD)


@pytest.mark.parametrize("fix_bases", [False, True], ids=["bases_train", "bases_fixed"])
def test_vm_grid_net_matches_jax(fix_bases):
    cfg = {**VM_CFG, "grid": {**VM_CFG["grid"], "VM": {"rank": 4, "fix_bases": fix_bases}}}
    jm, tm = grid_pair(cfg)
    ig = np.array([0.0, 1.0], np.float32)
    jm = jm.replace(ignore_level=jnp.asarray(ig))
    tm.ignore_level.copy_(t(ig))
    x = np.random.default_rng(7).uniform(-1.1, 1.1, (300, 3)).astype(np.float32)
    close(tm.query_feature(t(x)), jm.query_feature(jnp.asarray(x)), VAL)
    got = check_forward_and_grads(jm, tm, x)
    assert ("vm_bases.0.xy_z" in got) != fix_bases
    assert not got["features.1.xy"].any()  # the ignored level
    # The masks: the port's names and values are the JAX mask's leaves.
    for kw in ({}, {"decoder": False}, {"level": 1}):
        mask, jmask = grid_net_mask(tm, **kw), jgrid_net_mask(jm, **kw)
        assert set(mask) == {n for n, _ in tm.named_parameters()}
        for name, m in mask.items():
            close(m, jax_leaf(jmask, name), VAL)


# ---------------------------------------------------------------------------
# 2D grids and the 2D SDF path.
# ---------------------------------------------------------------------------

def test_sdf2d_batches_and_loss_match_jax():
    img = disk_image()
    ds, jds = Sdf2D(img, batch_size=512, cell_size=0.1), JSdf2D(img, batch_size=512, cell_size=0.1)
    np.testing.assert_array_equal(ds.sdf, jds.sdf)
    np.testing.assert_array_equal(ds.full_coords, jds.full_coords)
    np.testing.assert_array_equal(ds.bound, jds.bound)
    b, jb = ds.sample(np.random.default_rng(3)), jds.sample(np.random.default_rng(3))
    assert b.keys() == jb.keys()
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    cfg = grid_2d_cfg(ds.bound.tolist())
    jm, tm = grid_pair(cfg)
    assert tm.d == 2 and [p.shape for p in tm.features] == [a.shape for a in jm.features]
    got = make_loss(sdf_loss_2d, sdf_weight=3e3)(tm, {k: t(v) for k, v in b.items()}, None)
    ref = jmake_loss(jsdf_loss_2d, sdf_weight=3e3)(jm, {k: jnp.asarray(v) for k, v in jb.items()},
                                                   jax.random.PRNGKey(0))
    close(got["sdf"], ref["sdf"], VAL)


def test_grid_net_2d_and_gradient2d_match_jax():
    cfg = grid_2d_cfg([[0.0, 4.8], [0.0, 4.0]])
    jm, tm = grid_pair(cfg)
    x = np.random.default_rng(8).uniform(-0.2, 5.0, (300, 2)).astype(np.float32)
    check_forward_and_grads(jm, tm, x)
    close(tm.query_stability(t(x)), jm.query_stability(jnp.asarray(x)), VAL)
    for method in ("autograd", "finitediff"):
        got = tdiff.gradient2d(t(x), tm, method)
        ref = jdiff.gradient2d(jnp.asarray(x), jm, method)
        close(got, ref, GRAD)
    with pytest.raises(ValueError):
        tdiff.gradient2d(t(np.zeros((2, 3), np.float32)), tm)


# ---------------------------------------------------------------------------
# One base-Trainer step of each model against the JAX Trainer's.
# ---------------------------------------------------------------------------

def jax_buffer_free_mask(jm):
    """The JAX full mask with the leaves the port keeps as buffers at 0."""
    mask = jbase.tree_full_mask(jm)
    zero = {k: jbase.tree_zero_mask(getattr(jm, k))
            for k in ("bound", "Rwk", "twk", "ignore_level", "points")
            if hasattr(jm, k)}
    return mask.replace(**zero)


def _step_case(name, sphere):
    if name == "sdf2d":
        img = disk_image()
        ds, jds = (Sdf2D(img, batch_size=256, cell_size=0.1),
                   JSdf2D(img, batch_size=256, cell_size=0.1))
        jm, tm = grid_pair(grid_2d_cfg(ds.bound.tolist()))
        return jm, tm, ds, jds, make_loss(sdf_loss_2d), jmake_loss(jsdf_loss_2d)
    ds = Sdf3D(TriangleMesh(*sphere), batch_size=256, total_samples=2 ** 11,
               surface_stddev=0.05, bound_buffer=0.3, trunc_dist=0.3)
    jds = JSdf3D(JMesh(*sphere), batch_size=256, total_samples=2 ** 11,
                 surface_stddev=0.05, bound_buffer=0.3, trunc_dist=0.3)
    pairs = {"ngp": hash_pair, "isdf": isdf_pair, "vm": lambda: grid_pair(VM_CFG),
             "pointsdf": lambda: pointsdf_pair(sphere)}
    jm, tm = pairs[name]()
    kw = dict(sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0, trunc_dist=0.3)
    return jm, tm, ds, jds, make_loss(tsdf_loss_3d, **kw), jmake_loss(jtsdf, **kw)


@pytest.mark.parametrize("name", ["ngp", "isdf", "pointsdf", "vm", "sdf2d"])
def test_trainer_step_matches_jax(name, sphere):
    jm, tm, ds, jds, loss, jloss = _step_case(name, sphere)
    cfg = {"optimizer": "adam", "learning_rate": 5e-3, "epochs": 1}
    jm = JTrainer(cfg, jm, jloss, jds, mask=jax_buffer_free_mask(jm)).train()
    tm = Trainer(cfg, tm, loss, ds).train()
    for n, p in tm.named_parameters():
        close(p, jax_leaf(jm, n), GRAD)
    for n, b in tm.named_buffers():
        close(b, getattr(jm, n), VAL)


def test_jax_full_mask_trains_the_buffers():
    """The reference fault of ROADMAP Queue 3: the JAX base Trainer's default
    mask moves ``bound`` and ``ignore_level``; the port's buffers stay."""
    img = disk_image()
    ds, jds = Sdf2D(img, batch_size=256, cell_size=0.1), JSdf2D(img, batch_size=256, cell_size=0.1)
    jm, tm = grid_pair(grid_2d_cfg(ds.bound.tolist()))
    cfg = {"optimizer": "adam", "learning_rate": 5e-3, "epochs": 3}
    bound0 = np.asarray(jm.bound).copy()
    jm = JTrainer(cfg, jm, jmake_loss(jsdf_loss_2d), jds).train()
    tm = Trainer(cfg, tm, make_loss(sdf_loss_2d), ds).train()
    assert np.abs(np.asarray(jm.bound) - bound0).max() > 1e-3
    assert np.abs(np.asarray(jm.ignore_level)).max() > 1e-3
    np.testing.assert_array_equal(tm.bound.numpy(), bound0)
    np.testing.assert_array_equal(tm.ignore_level.numpy(), 0.0)


# ---------------------------------------------------------------------------
# Checkpoints both ways.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ngp", "isdf", "pointsdf", "vm"])
def test_checkpoint_round_trip_both_ways(name, sphere, tmp_path):
    pairs = {"ngp": hash_pair, "isdf": isdf_pair, "vm": lambda seed=0: grid_pair(VM_CFG, seed),
             "pointsdf": lambda seed=0: pointsdf_pair(sphere, seed)}
    jm, tm = pairs[name]()
    jm2, tm2 = pairs[name](seed=1)
    # JAX -> port: the second port model takes the first JAX model's leaves.
    jckpt.save_pytree(str(tmp_path / "j.npz"), jm)
    tckpt.load_pytree(str(tmp_path / "j.npz"), like=tm2)
    assert tckpt._flatten_with_paths(tm2).keys() == jckpt._flatten_with_paths(jm)[0].keys()
    for n, p in tm2.named_parameters():
        close(p, jax_leaf(jm, n), dict(rtol=0, atol=0))
    # port -> JAX.
    with torch.no_grad():
        for p in tm2.parameters():
            p.add_(0.5)
    tckpt.save_pytree(str(tmp_path / "t.npz"), tm2)
    back = jckpt.load_pytree(str(tmp_path / "t.npz"), like=jm2)
    for n, p in tm2.named_parameters():
        close(p, jax_leaf(back, n), dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# The small helpers.
# ---------------------------------------------------------------------------

def test_tree_scale_mask_norm_and_check_tensor():
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    close(tbase.tree_norm({k: t(v) for k, v in tree.items()}),
          jbase.tree_norm({k: jnp.asarray(v) for k, v in tree.items()}), VAL)
    mask = {"a": torch.tensor(1.0), "b": torch.tensor(0.5)}
    scaled = tbase.tree_scale_mask(mask, 0.2)
    jscaled = jbase.tree_scale_mask({"a": jnp.float32(1.0), "b": jnp.float32(0.5)}, 0.2)
    for k in mask:
        close(scaled[k], jscaled[k], VAL)
    x = t(tree["a"])
    assert tbase.check_tensor(x) is x
    x[1, 2] = float("nan")
    for bad in (x, torch.tensor([1.0, float("inf")])):
        with pytest.raises(ValueError, match="NaN/Inf"):
            tbase.check_tensor(bad, "x")
        with pytest.raises(ValueError, match="NaN/Inf"):
            jbase.check_tensor(jnp.asarray(bad.numpy()), "x")


def test_mlp_num_params_and_fixed_pose_draws():
    jparams = jmlp.mlp_init(jax.random.PRNGKey(0), 8, 1, 32, 2, bias=True)
    tparams = tmlp.mlp_init(8, 1, 32, 2, bias=True, device="cpu")
    assert tmlp.mlp_num_params(tparams) == jmlp.mlp_num_params(jparams) == 8 * 32 + 32 + \
        2 * (32 * 32 + 32) + 32 + 1
    assert tmlp.mlp_num_params(tmlp.mlp_init(4, 2, 8, 0, bias=False, device="cpu")) == 4 * 8 + 8 * 2
    gen = torch.Generator().manual_seed(0)
    R = tse3.fixed_angle_rotations(50, 0.3, generator=gen)
    tr = tse3.fixed_length_translations(50, 0.7, generator=gen)
    jR = jse3.fixed_angle_rotations(jax.random.PRNGKey(0), 50, 0.3)
    jt = jse3.fixed_length_translations(jax.random.PRNGKey(0), 50, 0.7)
    # Each package draws its own axes: the angles and lengths are what agree.
    eye = torch.eye(3).expand(50, 3, 3)
    close(tse3.so3_relative_angle(R, eye), np.full(50, 0.3, np.float32), VAL)
    close(jse3.so3_relative_angle(jR, jnp.eye(3)[None].repeat(50, 0)),
          np.full(50, 0.3, np.float32), VAL)
    close(torch.linalg.norm(tr, dim=-1), np.full(50, 0.7, np.float32), VAL)
    close(jnp.linalg.norm(jt, axis=-1), np.full(50, 0.7, np.float32), VAL)
    # Same axes in, same rotations out.
    axis = torch.randn((50, 3), generator=torch.Generator().manual_seed(0))
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    close(R, tse3.so3_exp(axis * 0.3), VAL)
