"""The port's GridAtlas against the JAX package's, on the CPU.

Both atlases are built by the same ``add_submap`` / ``add_kf`` calls from the
same config; their structure (every leaf, feature and stability levels in
the JAX package's folded storage) must agree exactly.  The queries then run
on the JAX atlas's parameters carried across by
``convert.grid_atlas_params_from_numpy``: random features, stability,
decoder and pose corrections drawn with numpy from a seed, on three submaps
of different bounds, so that storage is padded and each slot is read with
its logical sizes (as in tests/test_submap_sizes.py).  Tolerance 1e-5
(float32 sums in another order) unless a test says otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu.models.grid_atlas import GridAtlas as JAtlas
from miso_tpu.train import checkpoint as j_ckpt
from miso_tpu.utils import sdf as j_sdf
from miso_tpu_torch.convert import grid_atlas_params_from_numpy
from miso_tpu_torch.models.grid_atlas import GridAtlas, GridAtlasParams
from miso_tpu_torch.train import checkpoint as t_ckpt
from miso_tpu_torch.utils import sdf as t_sdf

TOL = dict(rtol=1e-5, atol=1e-5)
K = 2
CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
             "bound": [[-1, 1], [-1, 1], [-1, 1]],
             "base_cell_size": 0.5, "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                "pos_invariant": True, "fix": True, "pretrained_model": None},
    "pose": {"optimize": True, "num_poses": K},
}
# Three submaps of different extents: the first sets the padded shapes.
SUBMAPS = [
    (np.array([[-2.0, 2.0], [-2.0, 2.0], [-1.5, 1.5]], np.float32), [0.0, 0.0, 0.0]),
    (np.array([[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]], np.float32), [1.0, 0.0, 0.0]),
    (np.array([[-1.5, 1.0], [-1.0, 1.5], [-0.5, 0.5]], np.float32), [-0.5, 0.8, 0.2]),
]


def add_submaps(atlas, submaps=SUBMAPS, kfs=K, rotated=True):
    """Each submap at a random rotation (or none) and the given offset, with
    ``kfs`` keyframes at random poses in it."""
    rng = np.random.default_rng(5)
    for bound, tws in submaps:
        w = rng.normal(0, 0.3, 3)
        Rws = np.asarray(_rot(w), np.float32) if rotated else np.eye(3, dtype=np.float32)
        atlas.add_submap(bound, Rws=Rws, tws=np.asarray(tws, np.float32))
        for k in range(kfs):
            atlas.add_kf(_rot(rng.normal(0, 0.2, 3)), rng.normal(0, 0.3, 3))
    return atlas


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * W @ W
            ).astype(np.float32)


def jax_atlas_arrays(p):
    """A JAX GridAtlasParams's leaves as grid_atlas_params_from_numpy takes
    them."""
    names = ("sub_rot_corr", "sub_trans_corr", "Rws", "tws", "kf_rot_corr", "kf_trans_corr",
             "Rsk", "tsk", "bounds", "ignore_level", "active", "kf_to_submap", "kf_to_local")
    out = {k: np.asarray(getattr(p, k)) for k in names}
    out.update(features=[np.asarray(f) for f in p.features],
               stability=[np.asarray(s) for s in p.stability],
               sizes=[np.asarray(s) for s in p.sizes],
               decoder=None if p.decoder is None else
               [(np.asarray(W), np.asarray(b)) for W, b in p.decoder],
               pad_spatial=p.pad_spatial, decoder_fixed=p.decoder_fixed)
    return out


def randomize(ja, seed=0, pose_noise=0.02, feature_std=0.5, decoder_std=0.5):
    """Random features, stability (in [0, 1]), decoder and pose corrections
    on the JAX atlas's live slots."""
    r = np.random.default_rng(seed)
    p = ja.params
    S = ja.num_submaps

    def live(a, scale, lo=None):
        v = (r.uniform(0, scale, a.shape) if lo is not None
             else r.normal(0, scale, a.shape)).astype(np.float32)
        v[S:] = 0.0
        return jnp.asarray(v)

    if decoder_std is None:  # mlp_init's draw: U(-1, 1) / sqrt(fan_in)
        dec = tuple(tuple(jnp.asarray((r.uniform(-1, 1, a.shape) / np.sqrt(W.shape[0]))
                                      .astype(np.float32)) for a in (W, b))
                    for W, b in p.decoder)
    else:
        dec = tuple((jnp.asarray(r.normal(0, decoder_std, W.shape).astype(np.float32)),
                     jnp.asarray(r.normal(0, 0.2 * decoder_std, b.shape).astype(np.float32)))
                    for W, b in p.decoder)
    ja.params = p.replace(
        features=tuple(live(f, feature_std) for f in p.features),
        stability=tuple(live(s, 1.0, lo=0.0) for s in p.stability),
        decoder=dec,
        sub_rot_corr=live(p.sub_rot_corr, pose_noise),
        sub_trans_corr=live(p.sub_trans_corr, pose_noise),
        kf_rot_corr=live(p.kf_rot_corr, pose_noise),
        kf_trans_corr=live(p.kf_trans_corr, pose_noise))
    return ja


def pair(capacity=None, seed=0, pose_noise=0.02, submaps=SUBMAPS, rotated=True, **scales):
    """(JAX atlas, port atlas) with the same structure; the port's params
    are the randomized JAX params carried across."""
    ja = randomize(add_submaps(JAtlas(CFG, max_kfs_per_submap=K, capacity=capacity), submaps,
                               rotated=rotated), seed, pose_noise, **scales)
    ta = add_submaps(GridAtlas(CFG, max_kfs_per_submap=K, capacity=capacity, device="cpu"),
                     submaps, rotated=rotated)
    ta.params = grid_atlas_params_from_numpy(jax_atlas_arrays(ja.params), CFG,
                                             ja.num_submaps, device="cpu")
    return ja, ta


@pytest.fixture(scope="module")
def atlases():
    return pair()


def world_points(ja, n=2048, seed=3, margin=0.3):
    b = ja.global_bound()
    r = np.random.default_rng(seed)
    return r.uniform(b[:, 0] - margin, b[:, 1] + margin, (n, 3)).astype(np.float32)


def close(got, ref, tol=TOL):
    got, ref = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                for a in (got, ref))
    np.testing.assert_allclose(got, ref, **tol)


def flat(tree_jax=None, tree_torch=None):
    if tree_jax is not None:
        return j_ckpt._flatten_with_paths(tree_jax)[0]
    return t_ckpt._flatten_with_paths(tree_torch)


@pytest.mark.parametrize("capacity", [None, 2], ids=["exact", "capacity2_grown"])
def test_structure_matches_jax(capacity):
    """Leaf by leaf (folded feature storage, padded shapes, logical sizes,
    spare slots, keyframe maps) after the same calls; capacity 2 grows to 4
    slots on the third submap."""
    ja = add_submaps(JAtlas(CFG, max_kfs_per_submap=K, capacity=capacity))
    ta = add_submaps(GridAtlas(CFG, max_kfs_per_submap=K, capacity=capacity, device="cpu"))
    ref = flat(tree_jax=ja.params.replace(decoder=None))
    got = flat(tree_torch=GridAtlasParams(**{**vars(ta.params), "decoder": None}))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ta.params.pad_spatial == ja.params.pad_spatial
    assert ta.params.capacity == ja.params.Rws.shape[0] == (3 if capacity is None else 4)
    assert ta.num_submaps == ta.params.num_submaps == ja.num_submaps == 3
    assert [ta.submap_shapes(s) for s in range(3)] == [ja.submap_shapes(s) for s in range(3)]
    assert [ta.anchor_kf_for_submap(s) for s in range(3)] == [0, 2, 4]


@pytest.mark.parametrize("query", ["query_feature", "query_stability", "forward"])
def test_atlas_queries_match_jax(atlases, query):
    """The masked average over the live slots (and its decode), at points in,
    between and outside the submaps."""
    ja, ta = atlases
    x = world_points(ja)
    got = getattr(ta.params, query)(torch.from_numpy(x))
    ref = getattr(ja.params, "__call__" if query == "forward" else query)(jnp.asarray(x))
    close(got, ref)
    assert got.shape == ref.shape


@pytest.mark.parametrize("s", [0, 1, 2])
def test_submap_queries_match_jax(atlases, s):
    """query_feature_submap, query_stability_submap and forward_submap read
    slot s at its logical sizes."""
    ja, ta = atlases
    b = np.asarray(SUBMAPS[s][0])
    x = np.random.default_rng(s).uniform(b[:, 0] - 0.2, b[:, 1] + 0.2, (512, 3)).astype(np.float32)
    for name in ("query_feature_submap", "query_stability_submap", "forward_submap"):
        close(getattr(ta.params, name)(s, torch.from_numpy(x)),
              getattr(ja.params, name)(s, jnp.asarray(x)))
    # The padded slot read at its logical size is the unpadded GridNet.
    close(ta.params.forward_submap(s, torch.from_numpy(x)), ta.get_submap(s)(torch.from_numpy(x)))


def test_get_submap_matches_jax(atlases):
    """get_submap: contiguous copies at the logical shapes, with the same
    leaves as the JAX GridNet."""
    ja, ta = atlases
    for s in range(3):
        g, gj = ta.get_submap(s), ja.get_submap(s)
        got = flat(tree_torch=g)
        ref = flat(tree_jax=gj)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=0, err_msg=k)
        assert all(t.is_contiguous() for t in list(g.features) + list(g.stability))
        assert tuple(g.features[1].shape[:3]) == tuple(ja.submap_shapes(s)[1])


def test_get_submap_is_a_copy_and_set_submap_writes_back():
    """Training the submap's GridNet leaves the atlas as it is until
    set_submap, which writes the crop back and keeps the padding zero."""
    _, ta = pair(seed=1)
    s = 1
    before = [f.clone() for f in ta.params.features]
    g = ta.get_submap(s)
    with torch.no_grad():
        for f in g.features:
            f.add_(1.0)
        g.rot_corr[1] += 0.5
    for f, f0 in zip(ta.params.features, before):
        assert torch.equal(f, f0)
    ta.set_submap(s, g)
    for level, (f, f0) in enumerate(zip(ta.params.features, before)):
        crop = tuple(slice(0, n) for n in ta.submap_shapes(s)[level])
        assert torch.equal(f[s][crop], f0[s][crop] + 1.0)
        pad = f[s].clone()
        pad[crop] = 0.0
        assert not pad.any()
        for other in (0, 2):
            assert torch.equal(f[other], f0[other])
    assert torch.equal(ta.params.kf_rot_corr[s], g.rot_corr.detach())


def test_pose_accessors_and_global_bound_match_jax(atlases):
    ja, ta = atlases
    for got, ref in zip(ta.params.updated_submap_poses(), ja.params.updated_submap_poses()):
        close(got, ref)
    for got, ref in zip(ta.params.updated_kf_poses_in_world(),
                        ja.params.updated_kf_poses_in_world()):
        close(got, ref)
    for got, ref in zip(ta.params.updated_kf_pose_in_world(3),
                        ja.params.updated_kf_pose_in_world(3)):
        close(got, ref)
    close(ta.global_bound(), ja.global_bound())
    for src, dst in ((0, 1), (1, 2), (2, 0)):
        assert ta.check_submap_intersection(src, dst) == ja.check_submap_intersection(src, dst)


def test_capacity_atlas_matches_exact_atlas():
    """A capacity-2 atlas grown to 4 submaps computes the exact-size atlas's
    field (tests/test_submap_sizes.py:246), and marks only live slots
    active."""
    four = SUBMAPS + [(SUBMAPS[1][0], [0.0, -0.7, 0.3])]
    (ja_e, ta_e), (ja_c, ta_c) = pair(None, 4, submaps=four), pair(2, 4, submaps=four)
    assert ta_c.params.capacity == 4 and ta_e.params.capacity == 4
    x = torch.from_numpy(world_points(ja_e))
    close(ta_c.params(x), ta_e.params(x).detach())
    close(ta_c.params(x), ja_c.params(jnp.asarray(x.numpy())))
    ta = add_submaps(GridAtlas(CFG, max_kfs_per_submap=K, capacity=2, device="cpu"), four[:3])
    assert ta.params.capacity == 4
    assert ta.params.active.tolist() == [1.0, 1.0, 1.0, 0.0]


# tests/test_consolidate.py's atlas: co-located submaps of one bound (the
# fused grid's nodes are theirs), or offset ones under pose corrections.
UNIT = np.array([[-1.0, 1.0]] * 3, np.float32)
COLOCATED = [(UNIT, [0.0, 0.0, 0.0])] * 3
OFFSET = [(UNIT, [0.3 * s, -0.2 * s, 0.1 * s]) for s in range(3)]


def test_consolidated_exact_at_identity_poses():
    """The fused grid's leaves are the JAX package's, and its field is the
    atlas's at identity submap rotations and no corrections."""
    ja, ta = pair(capacity=4, pose_noise=0.0, submaps=COLOCATED, rotated=False)
    fused, fused_j = ta.consolidated_grid(chunk=1 << 12), ja.consolidated_grid(chunk=1 << 12)
    got, ref = flat(tree_torch=fused), flat(tree_jax=fused_j)
    for k in ref:
        if k in got:
            np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)
    x = world_points(ja, seed=4, margin=0.0)
    close(fused(torch.from_numpy(x)), ta.params(torch.from_numpy(x)).detach(),
          dict(rtol=0, atol=2e-5))


def test_consolidated_close_under_pose_corrections():
    """Under 1 cm / 0.01 rad submap corrections the fused grid resamples the
    moved field: the same nodes' features as the JAX package's, and the same
    O(cell * pose delta) mean error against the atlas at the same points."""
    # tests/test_consolidate.py's draws: features 0.3 N(0, 1), mlp_init's decoder.
    ja, ta = pair(capacity=4, pose_noise=0.01, submaps=OFFSET, rotated=False,
                  feature_std=0.3, decoder_std=None)
    fused, fused_j = ta.consolidated_grid(chunk=1 << 12), ja.consolidated_grid(chunk=1 << 12)
    for f, fj in zip(fused.features, fused_j.features):
        close(f, fj)
    x = world_points(ja, seed=5, margin=0.0)
    with torch.no_grad():
        err = float((fused(torch.from_numpy(x)) - ta.params(torch.from_numpy(x))).abs().mean())
    err_j = float(jnp.abs(fused_j(jnp.asarray(x)) - ja.params(jnp.asarray(x))).mean())
    assert err > 0 and abs(err - err_j) <= 1e-5 * max(err_j, 1.0), (err, err_j)
    assert err < 0.1 * float(jnp.abs(ja.params(jnp.asarray(x))).max())


def test_consolidated_zero_outside_coverage_and_structural():
    ja, ta = pair(capacity=4, pose_noise=0.0, submaps=COLOCATED[:2], rotated=False)
    fused = ta.consolidated_grid(chunk=1 << 12)
    far = np.array([[50.0, 50.0, 50.0]], np.float32)
    close(fused(torch.from_numpy(far)), ja.params(jnp.asarray(far)), dict(rtol=0, atol=1e-6))
    empty = ta.consolidated_grid(structural_only=True, bound=ta.global_bound())
    assert [tuple(f.shape) for f in empty.features] == [tuple(f.shape) for f in fused.features]
    assert not any(f.any() for f in empty.features)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_atlas_params_file_interchange(tmp_path, writer):
    """save_pytree of atlas params (folded leaves) loads in the other package."""
    ja, ta = pair(capacity=4, seed=6)
    path = str(tmp_path / "atlas.npz")
    if writer == "port":
        t_ckpt.save_pytree(path, ta.params)
        like = add_submaps(JAtlas(CFG, max_kfs_per_submap=K, capacity=4)).params
        loaded = j_ckpt.load_pytree(path, like=like)
        got, ref = flat(tree_jax=loaded), flat(tree_jax=ja.params)
    else:
        j_ckpt.save_pytree(path, ja.params)
        tb = add_submaps(GridAtlas(CFG, max_kfs_per_submap=K, capacity=4, device="cpu"))
        t_ckpt.load_pytree(path, like=tb.params)
        got, ref = flat(tree_torch=tb.params), flat(tree_jax=ja.params)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_observed_atlas_lattice_matches_jax(atlases):
    """extract_fields over an observed query of an atlas (the demo's final
    mesh query: the atlas's decode where its stability passes 0.2), on a
    12^3 lattice."""
    ja, ta = atlases
    b = ja.global_bound()
    query = t_sdf.observed_sdf_query(ta.params, 0.2)
    got = t_sdf.extract_fields(query, b, 12)
    close(got, j_sdf.extract_fields(j_sdf.observed_sdf_query(ja.params, 0.2), b, 12))
    assert 0 < (got == 1e3).mean() < 1      # observed and unobserved nodes
    assert t_sdf._query_device(query) == torch.device("cpu")
