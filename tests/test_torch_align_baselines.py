"""The port's alignment baselines, InfoNCE alignment and the vmapped pair loss
against the JAX package's, on the CPU.

The baseline losses run on tests/test_atlas_align.py's analytic two-submap
atlas (``build_atlas``: both grids sample one smooth world field), its
stability grids drawn at random so that the stability mask bites, carried
across with ``convert.grid_atlas_params_from_numpy``; the observations are
those of tests/test_align_baselines.py (labels from submap 1's own field).
The vmapped pair loss runs on tests/test_torch_align.py's three-submap
atlases and pair batches.  The ICP runs on tests/test_align_baselines.py's
two-sphere atlas.

Tolerances: loss values 1e-5 relative; pose gradients 1e-4 of the largest
entry; ICP transforms 1e-5; after 5 InfoNCE iterations a level, the submap
poses 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu.align import baselines as j_base
from miso_tpu.align import miso as j_align
from miso_tpu.models.grid_atlas import fold_stacked as j_fold
from miso_tpu.ops import interp as j_interp
from miso_tpu.utils import eval as j_eval
from miso_tpu_torch.align import baselines as t_base
from miso_tpu_torch.align import miso as t_align
from miso_tpu_torch.convert import grid_atlas_params_from_numpy
from miso_tpu_torch.models.grid_atlas import GridAtlas, fold_stacked, unfold_stacked
from miso_tpu_torch.ops import se3
from miso_tpu_torch.utils import eval as t_eval
from test_align_baselines import _passthrough_decoder
from test_atlas_align import CFG_MODEL, build_atlas
from test_torch_align import (PAIRS, grad_close, np_, pair_batch, port_ctx,
                              port_loss_and_grads, submap_poses)
from test_torch_atlas import jax_atlas_arrays, pair

POSE_TOL = dict(rtol=0, atol=1e-4)


def port_twin(ja, device="cpu"):
    """A port atlas built by the same calls as build_atlas, with the JAX
    atlas's parameters carried across."""
    ta = GridAtlas(CFG_MODEL, max_kfs_per_submap=4, device=device)
    for s in range(ja.num_submaps):
        ta.add_submap(np.array([[-1, 1]] * 3, np.float32), np.eye(3, dtype=np.float32),
                      np.asarray(ja.params.tws[s]))
        ta.add_kf()
    ta.params = grid_atlas_params_from_numpy(jax_atlas_arrays(ja.params), CFG_MODEL,
                                             ja.num_submaps, device=device)
    return ta


@pytest.fixture(scope="module")
def analytic():
    """(JAX atlas, port atlas, observations) with submap 1 moved by 2.9
    degrees and 7.8 cm."""
    ja = build_atlas()
    r = np.random.default_rng(3)
    ja.params = ja.params.replace(stability=tuple(
        jnp.asarray(r.uniform(0, 1, s.shape).astype(np.float32)) for s in ja.params.stability))
    ja.set_submap_pose_correction(1, np.array([0.0, 0.02, 0.05], np.float32),
                                  np.array([0.06, -0.04, 0.03], np.float32))
    ta = port_twin(ja)
    coords = np.random.default_rng(0).uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    gt = np.asarray(build_atlas().get_submap(1)(jnp.asarray(coords)))
    valid = (np.random.default_rng(1).uniform(size=gt.shape) < 0.9).astype(np.float32)
    return ja, ta, (coords, gt, valid)


def jax_value_and_pose_grads(fn, ja, obs, **kw):
    p = ja.params

    def f(rot, trans):
        (v,) = fn(p.replace(sub_rot_corr=rot, sub_trans_corr=trans), ja, 1, 0,
                  *(jnp.asarray(a) for a in obs), **kw).values()
        return v

    v, g = jax.value_and_grad(f, argnums=(0, 1))(p.sub_rot_corr, p.sub_trans_corr)
    return float(v), g


def port_value_and_pose_grads(fn, ta, obs, **kw):
    rot = ta.params.sub_rot_corr.detach().clone().requires_grad_()
    trans = ta.params.sub_trans_corr.detach().clone().requires_grad_()
    (v,) = fn(ta.params.replace(sub_rot_corr=rot, sub_trans_corr=trans), ta, 1, 0,
              *(torch.as_tensor(a) for a in obs), **kw).values()
    return float(v), torch.autograd.grad(v, (rot, trans))


def check_baseline(fn, analytic, **kw):
    ja, ta, obs = analytic
    ref, (jr, jt) = jax_value_and_pose_grads(getattr(j_base, fn), ja, obs, **kw)
    got, (tr, tt) = port_value_and_pose_grads(getattr(t_base, fn), ta, obs, **kw)
    assert ref > 0 and np.abs(np.asarray(jt)).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    grad_close(tr, jr)
    grad_close(tt, jt)


VFPP = [dict(trunc_dist=0.4), dict(trunc_dist=0.4, use_bound=False),
        dict(trunc_dist=10.0, stability_thresh=0.3)]


@pytest.mark.parametrize("kw", VFPP, ids=["bound", "no_bound", "stability"])
def test_vfpp_loss_and_pose_gradient_match_jax(analytic, kw):
    check_baseline("pairwise_loss_vfpp", analytic, **kw)


MIPS = [dict(constraint_type="point_to_plane"), dict(constraint_type="point_to_point"),
        dict(constraint_type="point_to_plane", use_bound=False)]


@pytest.mark.parametrize("kw", MIPS, ids=["plane", "point", "plane_no_bound"])
def test_mips_loss_and_pose_gradient_match_jax(analytic, kw):
    check_baseline("pairwise_loss_mips", analytic, surf_tol=0.5, **kw)


def test_baseline_subsample_draws_with_replacement(analytic):
    """A pair's generator draws subsample_points rows with replacement: the
    loss is the full-batch loss of the drawn rows."""
    _, ta, obs = analytic
    c, g, v = (torch.as_tensor(a) for a in obs)
    gen = torch.Generator().manual_seed(4)
    idx = torch.randint(c.shape[0], (1500,), generator=gen)
    assert len(torch.unique(idx)) < 1500                        # repeats: with replacement
    for fn, kw in ((t_base.pairwise_loss_vfpp, dict(trunc_dist=0.4)),
                   (t_base.pairwise_loss_mips, dict(surf_tol=0.5))):
        drawn = fn(ta.params, ta, 1, 0, c, g, v, key=torch.Generator().manual_seed(4),
                   subsample_points=1500, **kw)
        full = fn(ta.params, ta, 1, 0, c[idx], g[idx], v[idx], **kw)
        np.testing.assert_allclose(float(*drawn.values()), float(*full.values()), rtol=1e-6)


@pytest.mark.parametrize("fn,kw", [("pairwise_loss_vfpp", dict(trunc_dist=0.4)),
                                   ("pairwise_loss_mips", dict(surf_tol=0.5))],
                         ids=["vfpp", "mips"])
def test_baselines_in_generic_alignment_match_jax(analytic, fn, kw):
    """5 iterations of generic_align_multiple_submaps on the pair (1, 0), as
    demo/align_submaps.py plugs the losses in (no subsample), against the JAX
    package's: poses 1e-4, submap 0 anchored."""
    ja, _, obs = analytic
    ja, ta = copy.deepcopy(ja), port_twin(ja)
    j_fn, t_fn = getattr(j_base, fn), getattr(t_base, fn)
    j_ctx = {1: tuple(jnp.asarray(a) for a in obs)}
    t_ctx = {1: tuple(torch.as_tensor(a) for a in obs)}
    start = submap_poses(ta)
    j_align.generic_align_multiple_submaps(
        ja, lambda p, s, d, key, ctx: j_fn(p, ja, s, d, *ctx[s], key=key, **kw), num_iters=5,
        lr=5e-3, submap_pairs=[(1, 0)], loss_ctx=j_ctx)
    t_align.generic_align_multiple_submaps(
        ta, lambda p, s, d, key, ctx: t_fn(p, ta, s, d, *ctx[s], key=key, **kw), num_iters=5,
        lr=5e-3, submap_pairs=[(1, 0)], loss_ctx=t_ctx)
    R, t = submap_poses(ta)
    Rj, tj = (np.asarray(a)[:2] for a in ja.params.updated_submap_poses())
    np.testing.assert_allclose(t, tj, **POSE_TOL)
    np.testing.assert_allclose(R, Rj, **POSE_TOL)
    assert np.abs(t - start[1]).max() > 1e-3
    np.testing.assert_array_equal(t[0], start[1][0])


def test_atlas_copy_is_independent(analytic):
    """GridAtlas.copy_to (phase 7 runs each baseline from a copy of the
    trained atlas, and its first-step check on a CPU copy): equal tensors and
    alignment coordinates, none of them shared."""
    _, ta, _ = analytic
    ta = copy.deepcopy(ta)
    ta.precompute_coordinates_for_alignment()
    cp = ta.copy_to("cpu")
    for (name, a), (_, b) in zip(ta.params.named_parameters(), cp.params.named_parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    assert torch.equal(cp.alignment_coords_stacked(1)[0], ta.alignment_coords_stacked(1)[0])
    cp.set_submap_pose_correction(1, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    with torch.no_grad():
        cp.params.features[0].zero_()
    assert float(ta.params.sub_trans_corr[1].abs().max()) > 0
    assert float(ta.params.features[0].abs().max()) > 0
    assert cp.num_submaps == ta.num_submaps and cp.submap_shapes(1) == ta.submap_shapes(1)


# ---------------------------------------------------------------------------
# The vmapped pair loss and InfoNCE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def atlases():
    return pair(seed=2)


VMAPPED = [("latent", 0, "L2"), ("latent", 1, "L1"), ("latent", 0, "cos"),
           ("latent", 1, "InfoNCE"), ("latent", 0, "InfoNCE"), ("sdf", None, "L2"),
           ("sdf", None, "L1"), ("sdf", None, "GM")]
VMAPPED_IDS = [f"{k}{'' if l is None else l}_{t}" for k, l, t in VMAPPED]


def unrolled_sum(ta, kind, level, loss_type, batch, sub, seed=5):
    """The unrolled per-pair losses of the live pairs, each drawing from its
    pair's generator, summed; with the pose gradients."""
    src, dst, coords, valid = batch
    rot = ta.params.sub_rot_corr.detach().clone().requires_grad_()
    trans = ta.params.sub_trans_corr.detach().clone().requires_grad_()
    p = ta.params.replace(sub_rot_corr=rot, sub_trans_corr=trans)
    gens = t_align.PairGenerators(seed, "cpu")
    total = 0.0
    for i, (s, d) in enumerate(PAIRS):
        c, v = torch.tensor(coords[i]), torch.tensor(valid[i])
        gen = gens.get(s, d) if sub else None
        if kind == "latent":
            out = t_align.pairwise_loss_latent(p, ta, s, d, level, c, v, align_loss=loss_type,
                                               key=gen, subsample_points=sub)
        else:
            out = t_align.pairwise_loss_sdf(p, ta, s, d, c, v, align_loss=loss_type, key=gen,
                                            subsample_points=sub)
        total = total + sum(out.values())
    return (total,) + torch.autograd.grad(total, (rot, trans))


def port_batched(ta, loss, ctx, sub, seed=5):
    rot = ta.params.sub_rot_corr.detach().clone().requires_grad_()
    trans = ta.params.sub_trans_corr.detach().clone().requires_grad_()
    gens = t_align.PairGenerators(seed, "cpu") if sub else None
    (v,) = loss(ta.params.replace(sub_rot_corr=rot, sub_trans_corr=trans), gens, ctx).values()
    return (v,) + torch.autograd.grad(v, (rot, trans))


@pytest.mark.parametrize("sub", [None, 200], ids=["all_points", "subsampled"])
@pytest.mark.parametrize("kind,level,loss_type", VMAPPED, ids=VMAPPED_IDS)
def test_vmapped_matches_unrolled_and_flat(atlases, kind, level, loss_type, sub):
    """The vmapped loss is the sum of the unrolled per-pair losses (the pad
    pair adding exactly 0), with the same per-pair draws; every loss but
    InfoNCE equals the flat one too."""
    ja, ta = atlases
    batch = pair_batch(ja)
    ctx = port_ctx(batch)
    kw = dict(level=level, align_loss=loss_type, subsample_points=sub)
    vm = t_align.make_vmapped_pair_loss(kind, **kw)
    value, d_rot, d_trans = port_batched(ta, vm, ctx, sub)
    ref, r_rot, r_trans = unrolled_sum(ta, kind, level, loss_type, batch, sub)
    assert float(ref) > 0
    np.testing.assert_allclose(float(value), float(ref), rtol=1e-5)
    grad_close(d_rot, r_rot)
    grad_close(d_trans, r_trans)
    assert float(vm.pair_losses(ta.params, None, ctx)[-1]) == 0.0      # the pad pair
    if loss_type == "InfoNCE":
        with pytest.raises(ValueError, match="make_vmapped_pair_loss"):
            t_align.make_flat_pair_loss(kind, **kw)
        return
    flat = t_align.make_flat_pair_loss(kind, **kw)
    f_value, f_rot, f_trans = port_batched(ta, flat, ctx, sub)
    np.testing.assert_allclose(float(f_value), float(value), rtol=1e-5)
    grad_close(f_rot, d_rot)
    grad_close(f_trans, d_trans)


@pytest.mark.parametrize("level", [0, 1])
def test_vmapped_infonce_matches_jax(atlases, level):
    """The port's vmapped InfoNCE loss against the JAX package's
    make_vmapped_pair_loss (no subsample), values and pose gradients."""
    ja, ta = atlases
    batch = pair_batch(ja)
    jloss = j_align.make_vmapped_pair_loss("latent", level=level, align_loss="InfoNCE")
    p = ja.params
    jctx = tuple(jnp.asarray(a) for a in batch)

    def f(rot, trans):
        (v,) = jloss(p.replace(sub_rot_corr=rot, sub_trans_corr=trans), jax.random.PRNGKey(0),
                     jctx).values()
        return v

    # Jitted, as the JAX package's alignment runs it: op by op, the gradient
    # of the norm at a zero feature row (a point beyond the destination's
    # grid) is NaN there, which XLA's compiled gradient does not produce.
    ref, (g_rot, g_trans) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(p.sub_rot_corr,
                                                                            p.sub_trans_corr)
    loss = t_align.make_vmapped_pair_loss("latent", level=level, align_loss="InfoNCE")
    value, d_rot, d_trans = port_loss_and_grads(ta, loss, port_ctx(batch))
    np.testing.assert_allclose(float(value), float(ref), rtol=1e-5)
    grad_close(d_rot, g_rot)
    grad_close(d_trans, g_trans)


def test_infonce_of_an_empty_pair_is_zero_with_zero_gradient():
    """A pad pair has no valid point: every logit column takes -1e9 and every
    row weighs 0, so its InfoNCE is exactly 0 with a zero gradient."""
    from miso_tpu_torch.losses.common import info_nce_loss
    r = np.random.default_rng(2)
    q = torch.tensor(r.normal(size=(2, 30, 4)).astype(np.float32), requires_grad=True)
    p = torch.tensor(r.normal(size=(2, 30, 4)).astype(np.float32), requires_grad=True)
    mask = torch.ones((2, 30, 1))
    mask[1] = 0.0
    out = info_nce_loss(q, p, mask)
    assert float(out[1]) == 0.0 and float(out[0]) > 0
    dq, dp = torch.autograd.grad(out[1], (q, p))
    assert torch.all(dq == 0) and torch.all(dp == 0)
    one = info_nce_loss(q[0], p[0], mask[0])
    np.testing.assert_allclose(float(one), float(out[0]), rtol=1e-6)


INFONCE_KW = dict(level_iters=5, lr=5e-3, latent_levels=[0], skip_finetune=True,
                  align_loss="InfoNCE")


def test_hierarchical_infonce_matches_jax():
    """5 InfoNCE iterations at level 0 (384 points a submap; level 1's 3072
    give (3072, 3072) logits a pair, slow on the CPU) from the same perturbed
    start, through the vmapped loss, against the JAX package's."""
    ja, ta = pair(seed=9, pose_noise=0.05)
    start = submap_poses(ta)
    j_align.align_multiple_submaps_hierarchical(ja, **INFONCE_KW)
    info = t_align.align_multiple_submaps_hierarchical(ta, **INFONCE_KW)
    assert info["hier_latent_level0_InfoNCE"]["steps"] == 6
    R, t = submap_poses(ta)
    Rj, tj = submap_poses(ja)
    np.testing.assert_allclose(t, tj, **POSE_TOL)
    np.testing.assert_allclose(R, Rj, **POSE_TOL)
    assert np.abs(t - start[1]).max() > 1e-3
    np.testing.assert_array_equal(t[0], start[1][0])


def test_infonce_refusals_match_jax(atlases):
    """The flat loss and the SDF stage refuse InfoNCE with ValueError, in both
    packages; the hierarchical alignment raises once its latent levels are
    done."""
    ja, ta = atlases
    with pytest.raises(ValueError):
        j_align.make_flat_pair_loss("latent", level=0, align_loss="InfoNCE")
    with pytest.raises(ValueError):
        t_align.make_flat_pair_loss("latent", level=0, align_loss="InfoNCE")
    with pytest.raises(ValueError, match="Invalid align loss"):
        t_align.make_vmapped_pair_loss("sdf", align_loss="InfoNCE")
    kw = dict(level_iters=1, latent_levels=[0], skip_finetune=False, align_loss="InfoNCE")
    ja2, ta2 = copy.deepcopy(ja), copy.deepcopy(ta)
    with pytest.raises(ValueError, match="Invalid align loss"):
        j_align.align_multiple_submaps_hierarchical(ja2, **kw)
    before = submap_poses(ta2)
    with pytest.raises(ValueError, match="Invalid align loss"):
        t_align.align_multiple_submaps_hierarchical(ta2, **kw)
    assert np.abs(submap_poses(ta2)[1] - before[1]).max() > 0      # level 0 ran first


# ---------------------------------------------------------------------------
# ICP, the pose graph and the ICP baseline
# ---------------------------------------------------------------------------

def sphere_clouds(n=3000, seed=0):
    """Points on two spheres and a plane (dst), normals, and the same points
    moved by a small rigid transform and noised (src)."""
    r = np.random.default_rng(seed)
    u = r.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    a = u[: n // 3] * 0.5 + [0.3, 0, 0]
    b = u[n // 3: 2 * n // 3] * 0.3 + [-0.4, 0.3, 0.1]
    c = np.concatenate([r.uniform(-1, 1, (n - 2 * (n // 3), 2)),
                        np.full((n - 2 * (n // 3), 1), -0.6)], axis=1)
    dst = np.concatenate([a, b, c]).astype(np.float32)
    nrm = np.concatenate([u[: n // 3], u[n // 3: 2 * n // 3],
                          np.tile([0.0, 0.0, 1.0], (len(c), 1))]).astype(np.float32)
    w = np.array([0.03, -0.02, 0.05])
    Rm = np.asarray(se3.so3_exp(torch.tensor(w, dtype=torch.float64)))
    src = ((dst - [0.04, -0.03, 0.02]) @ Rm + r.normal(0, 2e-3, dst.shape)).astype(np.float32)
    return src, dst, nrm


@pytest.mark.parametrize("kind", ["point_to_point", "point_to_plane", "robust"])
def test_icp_matches_jax(kind):
    src, dst, nrm = sphere_clouds()
    if kind == "point_to_plane":
        ref = j_eval.icp_point_to_plane(src, dst, nrm, max_corr_dist=0.3)
        got = t_eval.icp_point_to_plane(src, dst, nrm, max_corr_dist=0.3)
    else:
        kw = dict(max_corr_dist=0.3, robust_k=0.2 if kind == "robust" else None)
        ref = j_eval.icp_point_to_point(src, dst, **kw)
        got = t_eval.icp_point_to_point(src, dst, **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5)
    moved = src @ got[0][:3, :3].T + got[0][:3, 3]
    assert np.abs(moved - dst).mean() < 1e-2                       # it registered


def graph_case():
    """3 nodes, 3 edges: noisy initial poses, edges from the true ones."""
    r = np.random.default_rng(6)
    T_true = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T_init = T_true.copy()
    for i in range(3):
        w = r.normal(0, 0.3, 3)
        T_true[i, :3, :3] = np.asarray(se3.so3_exp(torch.tensor(w, dtype=torch.float32)))
        T_true[i, :3, 3] = r.normal(0, 1, 3)
        w2 = w + (r.normal(0, 0.05, 3) if i else 0)
        T_init[i, :3, :3] = np.asarray(se3.so3_exp(torch.tensor(w2, dtype=torch.float32)))
        T_init[i, :3, 3] = T_true[i, :3, 3] + (r.normal(0, 0.1, 3) if i else 0)
    edges = [(i, j, (np.linalg.inv(T_true[i]) @ T_true[j]).astype(np.float32))
             for i, j in ((0, 1), (1, 2), (0, 2))]
    return edges, T_init, T_true


def test_pose_graph_matches_jax():
    edges, T_init, T_true = graph_case()
    ref = j_base._pose_graph_optimize(3, edges, T_init, iters=100)
    got = t_base._pose_graph_optimize(3, edges, T_init, iters=100, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], T_init[0])                  # node 0 fixed
    assert (np.abs(got[1:, :3, 3] - T_true[1:, :3, 3]).max()
            < np.abs(T_init[1:, :3, 3] - T_true[1:, :3, 3]).max())


def test_pose_graph_at_convergence_has_finite_gradients():
    """Edges that already hold put every edge residual at the identity, where
    so3_log's gradient must be finite (0): the graph's steps stay finite."""
    edges, _, T_true = graph_case()
    I = torch.eye(3, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(se3.so3_log(I[None]) ** 2), I)
    assert torch.isfinite(g).all() and float(g.abs().max()) == 0.0
    got = t_base._pose_graph_optimize(3, edges, T_true, iters=5, device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], T_true[0])


def two_sphere_atlases():
    """tests/test_align_baselines.py::test_icp_pose_graph_reduces_error's
    atlas in both packages: channel 0 of every level a two-sphere SDF in the
    world, decoded by a pass-through decoder, submap 1 moved."""
    ja = build_atlas()
    ja.params = ja.params.replace(decoder=_passthrough_decoder(ja.params.decoder))

    def sphere_field(x):
        d1 = np.linalg.norm(x - np.array([0.25, 0.0, 0.0]), axis=-1) - 0.35
        d2 = np.linalg.norm(x - np.array([0.3, -0.25, 0.25]), axis=-1) - 0.22
        return np.minimum(d1, d2)

    p = ja.params
    feats = []
    for level in range(p.num_levels):
        arr = np.asarray(unfold_stacked(np.asarray(p.features[level]), p.pad_spatial[level],
                                        p.fdim)).copy()
        shape = ja.submap_shapes(0)[level]
        for s in range(2):
            verts = np.asarray(j_interp.vertex_positions(shape, p.bounds[s]))
            arr[s, ..., 0] = sphere_field(verts + np.array([0.5 * s, 0, 0])).reshape(shape)
        feats.append(jnp.asarray(j_fold(arr)))
    ja.params = ja.params.replace(features=tuple(feats))
    ja.set_submap_pose_correction(1, np.array([0, 0, 0.04], np.float32),
                                  np.array([0.06, -0.04, 0.02], np.float32))
    return ja, port_twin(ja)


ICP_KW = dict(resolution=32, surf_thresh=0.1, max_corr_coarse=0.5, max_corr_fine=0.15,
              pose_graph_iters=200)


def test_icp_baseline_matches_jax():
    """The near-surface clouds first (a lattice value within float32 rounding
    of the threshold may fall in one package's cloud only: none may), then
    the ICP baseline's poses."""
    ja, ta = two_sphere_atlases()
    for s in range(2):
        ref = j_base.extract_near_surface_points(ja, s, 32, 0.1)
        got = t_base.extract_near_surface_points(ta, s, 32, 0.1)
        assert len(got) == len(ref) > 100, (s, len(got), len(ref))
        np.testing.assert_array_equal(got, ref)
    # fold_stacked / unfold_stacked are each other's inverse on the port's tables.
    f = ta.params.features[1]
    assert torch.equal(unfold_stacked(fold_stacked(f), f.shape[1:-1], f.shape[-1]), f)
    t_before = np_(ta.params.updated_submap_poses()[1])[1].copy()
    j_info = j_base.align_multiple_submaps_icp(ja, **ICP_KW)
    t_info = t_base.align_multiple_submaps_icp(ta, **ICP_KW)
    assert t_info == j_info and t_info["num_edges"] == 1
    R, t = submap_poses(ta)
    Rj, tj = (np.asarray(a) for a in ja.params.updated_submap_poses())
    np.testing.assert_allclose(t, tj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-5)
    truth = np.array([0.5, 0.0, 0.0])
    assert np.linalg.norm(t[1] - truth) < np.linalg.norm(t_before - truth)
