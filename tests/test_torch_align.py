"""The port's per-point interpolation, atlas per-point queries, alignment
coordinates and submap alignment against the JAX package's, on the CPU.

The atlases are tests/test_torch_atlas.py's: three submaps of different
bounds (padded storage, each slot read at its logical sizes) in both
packages, the JAX atlas's random features, stability, decoder and pose
corrections carried across with ``convert.grid_atlas_params_from_numpy``.
Pair batches are made with numpy from a seed and given to both packages.

Tolerances: values 1e-5 relative (float32 sums in another order); pose
gradients 1e-4 of the largest entry; after 5 alignment iterations a level,
the submap poses 1e-4.  The loop tests use the L2 loss, whose gradients sit
clearly off zero, so Adam's first steps (about lr times the gradient's sign)
agree.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu.align import miso as j_align
from miso_tpu.models.grid_atlas import grid_atlas_mask as j_mask
from miso_tpu.ops import interp as j_interp
from miso_tpu_torch.align import miso as t_align
from miso_tpu_torch.convert import grid_atlas_params_from_numpy
from miso_tpu_torch.models.grid_atlas import GridAtlas, grid_atlas_mask
from miso_tpu_torch.ops import interp as t_interp
from miso_tpu_torch.ops import se3
from miso_tpu_torch.ops import tiled_interp as ti
from test_torch_atlas import CFG, SUBMAPS, jax_atlas_arrays, pair

VAL = dict(rtol=1e-5, atol=1e-6)
POSE_TOL = dict(rtol=0, atol=1e-4)


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_close(got, ref, frac=1e-4):
    """Gradients to ``frac`` of the largest reference entry."""
    ref = np_(ref)
    np.testing.assert_allclose(np_(got), ref, rtol=0, atol=frac * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# grid_interpolate_per_point
# ---------------------------------------------------------------------------

def per_point_case(F, n=600, seed=0):
    """Padded (3, 6, 5, 7, F) storage with mixed logical sizes, rotated
    bounds of different extents, points each around its own slot's bound
    (about a fifth outside it)."""
    r = np.random.default_rng(seed)
    stacked = r.normal(0, 1, (3, 6, 5, 7, F)).astype(np.float32)
    sizes = np.array([[6, 5, 7], [4, 3, 5], [5, 5, 2]], np.int32)
    lo = r.uniform(-1.5, -0.5, (3, 3))
    bounds = np.stack([lo, lo + r.uniform(1.0, 2.5, (3, 3))], -1).astype(np.float32)
    ids = r.integers(0, 3, n).astype(np.int32)
    b = bounds[ids]
    ext = b[..., 1] - b[..., 0]
    x = (b[..., 0] - 0.1 * ext + r.uniform(0, 1, (n, 3)) * 1.2 * ext).astype(np.float32)
    g = r.normal(0, 1, (n, F)).astype(np.float32)
    return stacked, ids, x, bounds, sizes, g


@pytest.mark.parametrize("F", [1, 4, 3])
def test_per_point_interp_matches_jax(F):
    stacked, ids, x, bounds, sizes, g = per_point_case(F)
    ref, vjp = jax.vjp(lambda s, p: j_interp.grid_interpolate_per_point(
        s, jnp.asarray(ids), p, jnp.asarray(bounds), jnp.asarray(sizes)),
        jnp.asarray(stacked), jnp.asarray(x))
    d_st_ref, d_x_ref = vjp(jnp.asarray(g))
    st_t = torch.tensor(stacked, requires_grad=True)
    x_t = torch.tensor(x, requires_grad=True)
    args = (torch.tensor(ids), x_t, torch.tensor(bounds), torch.tensor(sizes))
    out = ti.grid_interpolate_per_point_dispatch(st_t, *args)
    np.testing.assert_allclose(np_(out), np.asarray(ref), **VAL)
    # Outside its slot's logical grid a point reads zeros (zeros padding).
    assert float(np.abs(np.asarray(ref)).min()) == 0.0
    d_st, d_x = torch.autograd.grad(out, (st_t, x_t), torch.tensor(g))
    grad_close(d_st, d_st_ref)
    grad_close(d_x, d_x_ref)
    # The kernel's plain backward: both gradients, and the points' alone.
    pd_st, pd_x = ti.grid_interpolate_per_point_grad_plain(
        torch.tensor(stacked), args[0], torch.tensor(x), *args[2:], torch.tensor(g))
    grad_close(pd_st, d_st_ref)
    grad_close(pd_x, d_x_ref)
    none, only_x = ti.grid_interpolate_per_point_grad_plain(
        torch.tensor(stacked), args[0], torch.tensor(x), *args[2:], torch.tensor(g),
        need_grid=False)
    assert none is None
    grad_close(only_x, d_x_ref)
    # Padded rows and rows past a slot's logical size get no gradient.
    for s, n in enumerate(sizes):
        assert float(pd_st[s, n[0]:].abs().sum() + pd_st[s, :, n[1]:].abs().sum()
                     + pd_st[s, :, :, n[2]:].abs().sum()) == 0.0


def test_per_point_interp_is_the_slot_grid():
    """Each point's value is its own slot's single-grid interpolation at the
    slot's logical size."""
    stacked, ids, x, bounds, sizes, _ = per_point_case(4, seed=1)
    out = t_interp.grid_interpolate_per_point(*(torch.tensor(a) for a in (
        stacked, ids, x, bounds, sizes)))
    for s in range(3):
        m = ids == s
        ref = t_interp.grid_interpolate(torch.tensor(stacked[s]), torch.tensor(x[m]),
                                        torch.tensor(bounds[s]), torch.tensor(sizes[s]))
        np.testing.assert_allclose(np_(out[torch.tensor(m)]), np_(ref), **VAL)


# ---------------------------------------------------------------------------
# The atlas's per-point queries, its mask and the alignment coordinates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def atlases():
    return pair(seed=2)


def submap_points(ja, n=900, seed=4):
    """Per-point slot ids and points around each slot's bound."""
    r = np.random.default_rng(seed)
    b = np.asarray(ja.params.bounds)[:ja.num_submaps]
    ids = r.integers(0, len(b), n).astype(np.int32)
    ext = b[ids, :, 1] - b[ids, :, 0]
    x = b[ids, :, 0] - 0.1 * ext + r.uniform(0, 1, (n, 3)) * 1.2 * ext
    return ids, x.astype(np.float32)


@pytest.mark.parametrize("query", ["query_feature_per_point", "query_stability_per_point",
                                   "forward_per_point"])
def test_per_point_queries_match_jax(atlases, query):
    ja, ta = atlases
    ids, x = submap_points(ja)
    ref = getattr(ja.params, query)(jnp.asarray(ids), jnp.asarray(x))
    got = getattr(ta.params, query)(torch.tensor(ids), torch.tensor(x))
    np.testing.assert_allclose(np_(got), np.asarray(ref), **VAL)


@pytest.mark.parametrize("kw", [
    dict(features=True, stability=True, submap_pose=True, kf_pose=True, feature_lr=1e-3,
         submap_pose_lr=1e-4, kf_pose_lr=2e-4, anchor_first_submap=False),
    dict(features=True, decoder=True, submap_pose=True, level=1),
    dict(submap_pose=True)], ids=["fuse", "level1_decoder", "align"])
def test_grid_atlas_mask_matches_jax(atlases, kw):
    ja, ta = atlases
    ref = j_mask(ja.params, **kw)
    got = grid_atlas_mask(ta.params, **kw)
    names = dict(ta.params.named_parameters())
    assert got.keys() == names.keys()
    for name, m in got.items():
        head, _, idx = name.partition(".")
        leaf = getattr(ref, head)
        if head in ("features", "stability"):
            leaf = leaf[int(idx)]
        elif head == "decoder":
            leaf = leaf[int(idx) // 2][int(idx) % 2]
        np.testing.assert_array_equal(np_(m), np.asarray(leaf))


@pytest.fixture(scope="module")
def holed():
    """Atlases of the first two submaps (two shapes a level, so each JAX
    shape compiles once for both tests), slot 1's features zero on the
    lower half of its logical grid along x at every level, so the norm
    threshold drops some of its vertices and the smaller sets are tiled."""
    ja, ta = pair(seed=6, submaps=SUBMAPS[:2])
    p = ja.params
    feats = []
    for level, f in enumerate(p.features):
        a = np.array(f).reshape(f.shape[0], *p.pad_spatial[level], -1)
        a[1, :int(p.sizes[level][1][0]) // 2] = 0.0
        feats.append(jnp.asarray(a.reshape(f.shape)))
    ja.params = p.replace(features=tuple(feats))
    ta.params = grid_atlas_params_from_numpy(jax_atlas_arrays(ja.params), CFG, ja.num_submaps,
                                             device="cpu")
    return ja, ta


def test_alignment_coordinates_match_jax(holed):
    ja, ta = holed
    ref = ja.precompute_coordinates_for_alignment()
    got = ta.precompute_coordinates_for_alignment()
    assert got.keys() == ref.keys()
    assert float(np.asarray(ref[(1, 0)][1]).mean()) < 1.0     # the threshold dropped some
    for k in ref:
        np.testing.assert_allclose(np_(got[k][0]), np.asarray(ref[k][0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np_(got[k][1]), np.asarray(ref[k][1]))
    for level in range(2):
        C, V = ta.alignment_coords_stacked(level)
        Cj, Vj = ja.alignment_coords_stacked(level)
        np.testing.assert_allclose(np_(C), np.asarray(Cj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np_(V), np.asarray(Vj))
    assert ta.alignment_points_per_level(100) == ja.alignment_points_per_level(100)


@pytest.mark.parametrize("cap", [40, 100000])
def test_capped_alignment_coordinates(holed, cap):
    """The capped path by its invariants: P rows a level (min(cap, the
    largest submap's vertex count)); every valid row a vertex whose feature
    norm is over the threshold; no valid row twice; as many valid rows as
    the cap allows."""
    _, ta = holed
    exact = {k: (np_(c), np_(v)) for k, (c, v) in
             ta.precompute_coordinates_for_alignment().items()}
    got = ta.precompute_coordinates_for_alignment(max_points=cap, seed=3)
    P = ta.alignment_points_per_level(cap)
    for (s, level), (c, v) in got.items():
        c, v = np_(c), np_(v)[:, 0]
        assert c.shape == (P[level], 3) and v.shape == (P[level],)
        over = exact[(s, level)][0][exact[(s, level)][1][:, 0] > 0]
        rows = c[v > 0]
        assert len(rows) == min(P[level], len(over))
        assert len(rows) > 0 and len(np.unique(rows, axis=0)) == len(rows)
        d = np.abs(rows[:, None, :] - over[None, :, :]).max(-1).min(-1)
        assert d.max() == 0.0


# ---------------------------------------------------------------------------
# The pair losses
# ---------------------------------------------------------------------------

PAIRS = [(0, 1), (0, 2), (1, 2), (0, 0)]      # the last an inert pad pair


def pair_batch(ja, n=700, seed=8):
    """Points around each pair's source bound (some outside the
    destination's) and a random validity, the pad pair all invalid."""
    r = np.random.default_rng(seed)
    b = np.asarray(ja.params.bounds)
    src = np.array([s for s, _ in PAIRS], np.int32)
    dst = np.array([d for _, d in PAIRS], np.int32)
    ext = b[src, :, 1] - b[src, :, 0]
    coords = (b[src, None, :, 0] - 0.05 * ext[:, None] + r.uniform(0, 1, (len(PAIRS), n, 3))
              * 1.1 * ext[:, None]).astype(np.float32)
    valid = (r.uniform(size=(len(PAIRS), n, 1)) < 0.9).astype(np.float32)
    valid[-1] = 0.0
    return src, dst, coords, valid


def port_ctx(batch):
    src, dst, coords, valid = batch
    return t_align.PairContext(torch.tensor(src), torch.tensor(dst), torch.tensor(coords),
                               torch.tensor(valid), tuple(PAIRS))


def port_loss_and_grads(ta, loss, ctx):
    rot = ta.params.sub_rot_corr.detach().clone().requires_grad_()
    trans = ta.params.sub_trans_corr.detach().clone().requires_grad_()
    out = loss(ta.params.replace(sub_rot_corr=rot, sub_trans_corr=trans), None, ctx)
    (value,) = out.values()
    return (value,) + torch.autograd.grad(value, (rot, trans))


LOSSES = [("latent", 0, "L2"), ("latent", 1, "L2"), ("latent", 1, "L1"), ("latent", 0, "cos"),
          ("sdf", None, "L2"), ("sdf", None, "L1"), ("sdf", None, "GM")]


@pytest.mark.parametrize("kind,level,loss_type", LOSSES,
                         ids=[f"{k}{'' if l is None else l}_{t}" for k, l, t in LOSSES])
def test_flat_pair_loss_matches_jax(atlases, kind, level, loss_type):
    ja, ta = atlases
    batch = pair_batch(ja)
    kw = dict(level=level, align_loss=loss_type)
    jloss = j_align.make_flat_pair_loss(kind, **kw)
    jctx = tuple(jnp.asarray(a) for a in batch)
    p = ja.params

    def f(rot, trans):
        (v,) = jloss(p.replace(sub_rot_corr=rot, sub_trans_corr=trans), jax.random.PRNGKey(0),
                     jctx).values()
        return v

    ref, (g_rot, g_trans) = jax.value_and_grad(f, argnums=(0, 1))(p.sub_rot_corr,
                                                                    p.sub_trans_corr)
    tloss = t_align.make_flat_pair_loss(kind, **kw)
    ctx = port_ctx(batch)
    value, d_rot, d_trans = port_loss_and_grads(ta, tloss, ctx)
    np.testing.assert_allclose(float(value), float(ref), rtol=1e-5)
    assert abs(float(ref)) > 0 and np.abs(np.asarray(g_trans)).max() > 0
    grad_close(d_rot, g_rot)
    grad_close(d_trans, g_trans)
    # The source terms computed once give the same loss and gradients.
    pre = tloss.precompute_src(ta.params, ctx)
    assert pre.src_vals.shape[:2] == ctx.coords.shape[:2]
    v2, r2, t2 = port_loss_and_grads(ta, tloss, pre)
    np.testing.assert_allclose(float(v2), float(value), rtol=1e-6)
    grad_close(r2, d_rot, 1e-6)
    grad_close(t2, d_trans, 1e-6)
    # The unrolled per-pair losses sum to the flat one.
    src, dst, coords, valid = batch
    parts = []
    for i, (s, d) in enumerate(PAIRS[:-1]):
        c, v = torch.tensor(coords[i]), torch.tensor(valid[i])
        if kind == "latent":
            parts += t_align.pairwise_loss_latent(ta.params, ta, s, d, level, c, v,
                                                  align_loss=loss_type).values()
        else:
            parts += t_align.pairwise_loss_sdf(ta.params, ta, s, d, c, v,
                                               align_loss=loss_type).values()
    np.testing.assert_allclose(float(sum(parts)), float(value), rtol=1e-5)


def per_point_sums(loss, params, R, t, src_ids, dst_ids, coords, mask, src_vals):
    """The flat loss on per-point ids: each point's poses gathered by its
    own id (``se3``'s by-id transforms), the per-pair sums an ``index_add``
    over each point's pair row.  Returns (coords_to (P * N, 3), mask after
    the bound (P * N, 1), per-pair terms (P,), per-pair counts (P,))."""
    P, N, d = coords.shape
    ids_src, ids_dst = src_ids.repeat_interleave(N), dst_ids.repeat_interleave(N)
    world = se3.transform_points_by_id(coords.reshape(P * N, d), ids_src, R, t)
    coords_to = se3.inverse_transform_points_by_id(world, ids_dst, R, t)
    m = mask.reshape(P * N, 1)
    if loss.use_bound:
        b = params.bounds[ids_dst.long()]
        m = m * torch.all((coords_to >= b[..., 0]) & (coords_to <= b[..., 1]), dim=-1,
                          keepdim=True).to(m.dtype)
    bound_mask = m
    rows = torch.arange(P).repeat_interleave(N)

    def seg(x):
        return torch.zeros((P,), dtype=x.dtype).index_add(0, rows, x)

    sv = src_vals.reshape(P * N, -1)
    if loss.kind == "latent":
        f_to = params.query_feature_per_point(ids_dst, coords_to)[:, :sv.shape[-1]]
        c = sv - f_to
        if loss.align_loss == "L2":
            term = seg(torch.sum(m * c ** 2, dim=1))
        elif loss.align_loss == "L1":
            term = seg(m[:, 0] * t_align._safe_norm(c, dim=1))
        else:
            num = torch.sum(sv * f_to, dim=1, keepdim=True)
            den = t_align._safe_norm(sv, dim=1, keepdim=True) * t_align._safe_norm(
                f_to, dim=1, keepdim=True)
            term = seg((m * (1.0 - num / torch.clamp(den, min=1e-8)))[:, 0])
    else:
        c = sv - params.forward_per_point(ids_dst, coords_to)
        if loss.align_loss == "L2":
            term = seg((m * c ** 2)[:, 0])
        elif loss.align_loss == "L1":
            term = seg(m[:, 0] * t_align._safe_norm(c, dim=1))
        else:
            term = seg((m * t_align.gm_weighted_sq(c, loss.gm_scale_sdf))[:, 0])
    return coords_to, bound_mask, term, seg(m[:, 0])


@pytest.mark.parametrize("subsample", [None, 50], ids=["all", "subsample"])
@pytest.mark.parametrize("kind,level,loss_type", LOSSES,
                         ids=[f"{k}{'' if l is None else l}_{t}" for k, l, t in LOSSES])
def test_flat_pair_rows_match_per_point_ids(atlases, kind, level, loss_type, subsample):
    """The flat loss's pair rows (each row's poses gathered once, its sums
    over the row) against the same loss on per-point ids, on a batch with a
    pad row: the destination points and the bound mask bit for bit, the
    per-pair sums and the pose gradient to 1e-6; two pose rows a pair row."""
    ja, ta = atlases
    loss = t_align.make_flat_pair_loss(kind, level=level, align_loss=loss_type,
                                       subsample_points=subsample)
    ctx = port_ctx(pair_batch(ja))
    coords, mask, src_vals = loss.sample_rows(ta.params, t_align.PairGenerators(7, "cpu"), ctx)
    P, N = coords.shape[:2]
    assert N == (subsample or ctx.coords.shape[1])
    rot = ta.params.sub_rot_corr.detach().clone().requires_grad_()
    trans = ta.params.sub_trans_corr.detach().clone().requires_grad_()
    p = ta.params.replace(sub_rot_corr=rot, sub_trans_corr=trans)
    R, t = p.updated_submap_poses()
    args = (p, R, t, ctx.src_ids, ctx.dst_ids, coords, mask)
    to, bound_mask = loss.to_destination(*args)
    assert t_align.FlatPairLoss.pose_rows == 2 * P
    ref_to, ref_mask, ref_term, ref_cnt = per_point_sums(loss, *args, src_vals)
    assert torch.equal(to.reshape(P * N, 3), ref_to)
    assert torch.equal(bound_mask.reshape(P * N, 1), ref_mask)
    assert 0 < float(ref_mask.sum()) < float(mask.sum())
    term, cnt = loss.point_sums(*args, src_vals)
    torch.testing.assert_close(term, ref_term, rtol=1e-6, atol=0)
    torch.testing.assert_close(cnt, ref_cnt, rtol=1e-6, atol=0)
    assert float(term[-1]) == float(cnt[-1]) == 0.0 and float(term[:-1].min()) > 0

    def grads(term, cnt):
        return torch.autograd.grad(torch.sum(term / torch.clamp(cnt, min=1.0)), (rot, trans),
                                   retain_graph=True)

    got, ref = grads(term, cnt), grads(ref_term, ref_cnt)
    assert float(ref[1].abs().max()) > 0
    for g, r in zip(got, ref):
        grad_close(g, r, 1e-6)


def test_pair_loss_subsample_and_trust_region(atlases):
    """A subsample draws per pair from its own generator: the same draws
    whatever the pair's row; the trust region matches the JAX hinge."""
    ja, ta = atlases
    batch = pair_batch(ja, n=300)
    loss = t_align.make_flat_pair_loss("latent", level=1, subsample_points=50)
    ctx = port_ctx(batch)
    a = loss(ta.params, t_align.PairGenerators(5, "cpu"), ctx)
    order = [1, 0, 2, 3]
    shuffled = ctx._replace(src_ids=ctx.src_ids[order], dst_ids=ctx.dst_ids[order],
                            coords=ctx.coords[order], valid=ctx.valid[order],
                            pairs=tuple(PAIRS[i] for i in order))
    b = loss(ta.params, t_align.PairGenerators(5, "cpu"), shuffled)
    np.testing.assert_allclose(float(b["align_latent_level1"]),
                               float(a["align_latent_level1"]), rtol=1e-6)
    c = loss(ta.params, t_align.PairGenerators(6, "cpu"), ctx)
    assert float(c["align_latent_level1"]) != float(a["align_latent_level1"])
    ref = j_align.atlas_pose_trust_region_loss(ja.params, 0.01, 0.02, 10.0)
    got = t_align.atlas_pose_trust_region_loss(ta.params, 0.01, 0.02, 10.0)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)
        assert float(ref[k]) > 0


# ---------------------------------------------------------------------------
# The alignment loop
# ---------------------------------------------------------------------------

def submap_poses(atlas):
    R, t = atlas.params.updated_submap_poses()
    return np_(R)[:atlas.num_submaps], np_(t)[:atlas.num_submaps]


HIER_KW = dict(level_iters=5, finetune_iters=5, lr=5e-3, latent_levels=[0, 1],
               skip_finetune=False, align_loss="L2")


@pytest.fixture(scope="module")
def jax_aligned():
    """The JAX package's alignment, run once for both port paths: (the
    port's atlas before alignment, the JAX submap poses after it)."""
    ja, ta = pair(seed=9, pose_noise=0.05)
    j_align.align_multiple_submaps_hierarchical(ja, **HIER_KW)
    return ta, submap_poses(ja)


@pytest.mark.parametrize("vmap_pairs", [True, False], ids=["flat", "unrolled"])
def test_hierarchical_alignment_matches_jax(jax_aligned, vmap_pairs):
    """5 iterations a level at levels 0 and 1, then 5 of the SDF finetune,
    from the same perturbed start, against the JAX package's (whose default
    path, the flat loss in a scanned solve, is the reference of both)."""
    ta, (Rj, tj) = jax_aligned
    ta = copy.deepcopy(ta)
    start = submap_poses(ta)
    info = t_align.align_multiple_submaps_hierarchical(ta, vmap_pairs=vmap_pairs, **HIER_KW)
    assert info["hier_latent_level0_L2"]["steps"] == 6 and info["hier_sdf_L2"]["steps"] == 6
    R, t = submap_poses(ta)
    np.testing.assert_allclose(t, tj, **POSE_TOL)
    np.testing.assert_allclose(R, Rj, **POSE_TOL)
    assert np.abs(t - start[1]).max() > 1e-3                 # the poses moved
    np.testing.assert_array_equal(t[0], start[1][0])         # submap 0 anchored


def analytic_atlas(offset=0.5):
    """tests/test_atlas_align.py's build: two unit-cube submaps along x whose
    grids sample one smooth world feature field, lattices coinciding in the
    world, so the latent optimum is the true relative pose."""
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 0.0,
                    "bound": [[-1, 1]] * 3, "base_cell_size": 0.5, "per_level_scale": 2.0,
                    "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": True, "num_poses": 4}}
    atlas = GridAtlas(cfg, max_kfs_per_submap=4, device="cpu")
    bound = np.array([[-1, 1]] * 3, np.float32)
    for s in range(2):
        atlas.add_submap(bound, np.eye(3, dtype=np.float32), np.array([offset * s, 0, 0]))
        atlas.add_kf()
    p = atlas.params
    with torch.no_grad():
        for level, f in enumerate(p.features):
            for s in range(2):
                v = t_interp.vertex_positions(atlas.submap_shapes(s)[level], p.bounds[s])
                x = v.numpy() + np.array([offset * s, 0, 0], np.float32)
                f0 = (np.sin(2.1 * x[:, 0] + 0.5) + 0.8 * np.cos(1.7 * x[:, 1])
                      + 0.6 * np.sin(1.9 * x[:, 2] + 0.3) + 0.4 * np.sin(1.3 * (x[:, 0] + x[:, 1])))
                f1 = (0.7 * np.cos(2.3 * x[:, 1] + 1.0) + 0.5 * np.sin(1.6 * x[:, 0] - 0.4)
                      + 0.6 * np.cos(1.8 * x[:, 2]) + 0.3 * np.cos(1.1 * (x[:, 1] + x[:, 2])))
                f[s] = torch.tensor(np.stack([f0, f1], -1), dtype=torch.float32).reshape(f[s].shape)
    return atlas


def test_hierarchical_alignment_recovers_pose():
    """The port alone, as tests/test_atlas_align.py holds the JAX package:
    submap 1 moved by 3.4 degrees and 10 cm, the latent alignment takes most
    of it back and submap 0 stays anchored."""
    atlas = analytic_atlas()
    atlas.set_submap_pose_correction(1, [0.0, 0.0, 0.06], [0.08, -0.05, 0.04])
    truth_t = torch.tensor([0.5, 0.0, 0.0])

    def errors():
        R, t = atlas.params.updated_submap_poses()
        return (float(torch.linalg.vector_norm(t[1] - truth_t)),
                float(se3.rotation_rmse_deg(R[1:2], torch.eye(3)[None])))

    e_t0, e_r0 = errors()
    t_align.align_multiple_submaps_hierarchical(atlas, level_iters=120, lr=5e-3,
                                                latent_levels=[0, 1], skip_finetune=True)
    e_t, e_r = errors()
    assert e_t < 0.4 * e_t0 and e_r < 0.6 * e_r0, (e_t0, e_t, e_r0, e_r)
    assert float(atlas.params.sub_trans_corr[0].abs().max()) == 0.0


def test_alignment_without_pairs_is_a_no_op():
    """Two submaps that do not overlap, and a single submap: nothing moves."""
    for atlas in (analytic_atlas(offset=10.0), GridAtlas(CFG, device="cpu")):
        if atlas.num_submaps == 0:
            atlas.add_submap(np.array([[-1, 1]] * 3, np.float32))
            atlas.add_kf()
        before = [t.clone() for t in (atlas.params.sub_rot_corr, atlas.params.sub_trans_corr)]
        info = t_align.align_multiple_submaps_hierarchical(atlas, level_iters=3,
                                                           skip_finetune=False)
        assert info["cpu_time_sec"] == 0.0
        assert "hier_latent_level0_L2" not in info
        for a, b in zip(before, (atlas.params.sub_rot_corr, atlas.params.sub_trans_corr)):
            assert torch.equal(a, b)


def test_unported_alignment_options_raise(atlases):
    _, ta = atlases
    # The mesh's pair-axis sharding is ported (tests/test_torch_parallel.py);
    # InfoNCE is ported; the JAX package's refusals stay: the flat loss and the
    # SDF stage take no InfoNCE.
    with pytest.raises(ValueError, match="make_vmapped_pair_loss"):
        t_align.make_flat_pair_loss("latent", level=0, align_loss="InfoNCE")
    with pytest.raises(ValueError, match="Invalid align loss"):
        t_align.make_vmapped_pair_loss("sdf", align_loss="InfoNCE")
    with pytest.raises(NotImplementedError, match="TPU"):
        t_align.align_multiple_submaps_hierarchical(ta, aot_only=True)
