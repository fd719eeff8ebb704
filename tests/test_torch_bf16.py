"""bfloat16 feature storage in miso_tpu_torch against miso_tpu.

bf16 tables go through the interp ops, a GridNet and the fused op as the
JAX package takes them: each bf16 row widened to float32 (exactly) and
lerped in float32, so values agree to float32 rounding (relative 1e-6).  The
table's gradient differs by design: the port sums it in float32 and rounds
once to bf16 (held to half a bf16 step of the function's gradient, JAX's
gradient of the same values in float32), the JAX package's scatter-add
rounds in bf16 at every add (held to the port within 1e-2 of the largest
entry where a row takes a few adds); the points' gradient, in float32 in
both, to 1e-5 of the largest.  Then ``cast_feature_storage`` and
bf16 meshing (tests/test_utils_misc.py's field and mesh parity), masked Adam
on bf16 parameters and bf16 checkpoints both ways.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_port import jax_arrays, t
from miso_tpu.ops import interp as jinterp
from miso_tpu.ops.pallas_decode import fused_interp_decode as jfused
from miso_tpu_torch.ops import tiled_interp as ti

BOUND = np.array([[-1.0, 1.4], [0.0, 2.0], [-2.0, 0.5]], np.float32)
VALUE_RTOL = 1e-6
TABLE_GRAD_OF_MAX = 1e-2
POINTS_GRAD_OF_MAX = 1e-5
# One bf16 step of a value, relative (at most): a float32 result rounded to
# bf16 is within half of it, and one that straddles a rounding boundary in
# one package and not the other lands one step away.
BF16_STEP = 2.0 ** -7


def bf16(a):
    """A numpy or JAX array, rounded to bf16, as a torch tensor (the same
    values as ``jnp.asarray(a).astype(jnp.bfloat16)``)."""
    return torch.as_tensor(np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).astype(np.float32)
                           ).to(torch.bfloat16)


def _case(seed, shape, n, margin=0.3):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=shape).astype(np.float32)
    x = rng.uniform(BOUND[:, 0] - margin, BOUND[:, 1] + margin, (n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, shape[-1])).astype(np.float32)
    return table, x, cot


def _rel_close(got, ref, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-6), \
        (np.abs(got - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("shape", [(9, 17, 18, 4), (7, 6, 5, 3)])
def test_bf16_interp_forward_and_grads_match_jax(shape):
    """Values and the points' gradient against JAX on the bf16 table.  The
    table's gradient: the function's (JAX's gradient of the same values in
    float32) rounded once, within half a bf16 step; JAX's bf16 gradient
    drifts from it by its scatter's rounding, which grows with the adds a row
    takes.  At 4 adds a row (the first table) the port is within 1e-2 of
    the largest entry of JAX's bf16 gradient; at 57 (the second) JAX's drift
    reaches 1.5 % of it, and the port is held to be no farther from the
    function's gradient than JAX's bf16 one is."""
    table, x, cot = _case(0, shape, 1500)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    ref = jinterp.grid_interpolate(jt, jnp.asarray(x), jnp.asarray(BOUND))
    assert ref.dtype == jnp.float32
    g16 = bf16(table).requires_grad_()
    xx = t(x, requires_grad=True)
    got = ti.grid_interpolate_dispatch(g16, xx, t(BOUND))
    assert got.dtype == torch.float32
    _rel_close(got, ref, VALUE_RTOL)

    def f(g, xv):
        return jnp.sum(jinterp.grid_interpolate(g, xv, jnp.asarray(BOUND)) * cot)
    d_tab, d_x = jax.grad(f, argnums=(0, 1))(jt, jnp.asarray(x))
    exact = np.asarray(jax.grad(f)(jt.astype(jnp.float32), jnp.asarray(x)))
    got.backward(t(cot))
    assert g16.grad.dtype == torch.bfloat16
    _rel_close(xx.grad, d_x, POINTS_GRAD_OF_MAX)
    port = g16.grad.float().numpy()
    jax16 = np.asarray(d_tab.astype(jnp.float32))
    scale = np.abs(exact).max()
    assert np.all(np.abs(port - exact) <= 0.5 * BF16_STEP * np.abs(exact) + 1e-6 * scale)
    assert np.abs(port - exact).max() <= np.abs(jax16 - exact).max()
    if shape == (9, 17, 18, 4):
        _rel_close(g16.grad, jax16, TABLE_GRAD_OF_MAX)


def test_bf16_interp_per_point_matches_jax():
    rng = np.random.default_rng(3)
    stacked = rng.normal(size=(3, 8, 7, 6, 4)).astype(np.float32)
    bounds = np.stack([BOUND, BOUND + 0.3, BOUND - 0.2]).astype(np.float32)
    sizes = np.array([[8, 7, 6], [6, 7, 4], [5, 3, 6]], np.int32)
    ids = rng.integers(0, 3, 900).astype(np.int32)
    x = rng.uniform(-1.5, 2.0, (900, 3)).astype(np.float32)
    cot = rng.normal(size=(900, 4)).astype(np.float32)
    js = jnp.asarray(stacked).astype(jnp.bfloat16)

    def f(s, xv):
        return jinterp.grid_interpolate_per_point(s, jnp.asarray(ids), xv, jnp.asarray(bounds),
                                                  jnp.asarray(sizes))
    ref = f(js, jnp.asarray(x))
    s16 = bf16(stacked).requires_grad_()
    xx = t(x, requires_grad=True)
    got = ti.grid_interpolate_per_point_dispatch(s16, t(ids), xx, t(bounds), t(sizes))
    _rel_close(got, ref, VALUE_RTOL)
    d_st, d_x = jax.grad(lambda s, xv: jnp.sum(f(s, xv) * cot), argnums=(0, 1))(
        js, jnp.asarray(x))
    got.backward(t(cot))
    assert s16.grad.dtype == torch.bfloat16
    _rel_close(s16.grad, np.asarray(d_st.astype(jnp.float32)), TABLE_GRAD_OF_MAX)
    _rel_close(xx.grad, d_x, POINTS_GRAD_OF_MAX)


def _bf16_model(impl, seed=0):
    from _torch_port import small_cfg
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu_torch.convert import grid_net_from_numpy
    cfg = small_cfg(impl=impl, init_std=0.3)
    cfg["grid"]["feature_dtype"] = "bfloat16"
    jm = create_grid_net(jax.random.PRNGKey(seed), cfg)
    assert jm.features[0].dtype == jnp.bfloat16
    arrays = jax_arrays(jm)
    arrays["features"] = [np.asarray(f.astype(jnp.float32)) for f in jm.features]
    arrays["stability"] = [np.asarray(s.astype(jnp.float32)) for s in jm.stability]
    tm = grid_net_from_numpy(arrays, cfg, device="cpu")
    with torch.no_grad():
        for ps in (tm.features, tm.stability):
            for i, p in enumerate(ps):
                ps[i] = torch.nn.Parameter(p.to(torch.bfloat16))
    return jm, tm, cfg


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_grid_net_forward_matches_jax(impl):
    """A GridNet with grid.feature_dtype bfloat16 (the default decode and the
    fused op) against the JAX GridNet on the same bf16 tables."""
    jm, tm, _ = _bf16_model(impl)
    assert tm.features[0].dtype == torch.bfloat16
    x = np.random.default_rng(5).uniform([0, 0, 0], [2.3, 1.7, 1.0], (800, 3)).astype(np.float32)
    _rel_close(tm(t(x)), jm(jnp.asarray(x)), 1e-5)


def test_bf16_fused_op_matches_jax_fused_op():
    """The fused op's plain version on bf16 levels against the JAX fused
    op (its Pallas kernel in interpret mode) on the same levels."""
    from miso_tpu.ops.mlp import mlp_init as jmlp_init
    from miso_tpu_torch.ops import fused_decode as fd
    rng = np.random.default_rng(7)
    grids = [rng.normal(0, 1, (5 * (l + 1), 4 * (l + 1), 3 * (l + 1), 4)).astype(np.float32)
             for l in range(2)]
    decoder = [(np.asarray(W), np.asarray(b))
               for W, b in jmlp_init(jax.random.PRNGKey(2), 8, 1, 32, 1)]
    bound = np.asarray([[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]], np.float32)
    x = rng.uniform(-1.3, 1.4, (700, 3)).astype(np.float32)
    ref = jfused([jnp.asarray(g).astype(jnp.bfloat16) for g in grids], jnp.asarray(x),
                 jnp.asarray(bound), tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in decoder),
                 force=True)
    got = fd.fused_interp_decode([bf16(g) for g in grids], t(x), t(bound),
                                 [(t(W), t(b)) for W, b in decoder])
    _rel_close(got, ref, 1e-5)


def _mesh_models():
    """tests/test_utils_misc.py:130's model in both packages (float32), made
    an oracle field as tests/test_torch_slam.py makes one: a sphere's signed
    distance (radius 0.6) in the fine level's channel 0, read by a
    pass-through decoder.  (That test's model decodes a field without a zero
    level, -0.12 to -0.01 over its bound, so it has no surface to mesh.)"""
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu_torch.convert import grid_net_from_numpy
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.3,
                    "bound": [[-1, 1], [-1, 1], [-1, 1]], "base_cell_size": 0.25,
                    "per_level_scale": 2.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 2, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": False, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 1}}
    jm = create_grid_net(jax.random.PRNGKey(2), cfg)
    fine = np.array(jm.features[1])
    n = fine.shape[0]
    c = -1 + (np.arange(n) + 0.5) * 2.0 / n
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    fine[..., 0] = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
    # (relu(1 + f) - relu(1 - f)) / 2 of the fine level's channel 0 (input 4).
    W1 = np.zeros((8, 2), np.float32)
    W1[4, 0], W1[4, 1] = 1.0, -1.0
    decoder = ((jnp.asarray(W1), jnp.ones(2)), (jnp.eye(2), jnp.zeros(2)),
               (jnp.asarray([[0.5], [-0.5]]), jnp.zeros(1)))
    jm = jm.replace(features=(jm.features[0], jnp.asarray(fine)), decoder=decoder)
    return jm, grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")


def test_cast_feature_storage_copies_and_leaves_the_original():
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.utils.sdf import ObservedQuery, cast_feature_storage
    _, tm = _mesh_models()
    before = [f.detach().clone() for f in tm.features]
    m16 = cast_feature_storage(tm)
    assert m16 is not tm
    assert all(f.dtype == torch.bfloat16 for f in list(m16.features) + list(m16.stability))
    assert all(f.dtype == torch.float32 for f in list(tm.features) + list(tm.stability))
    for f, b in zip(tm.features, before):
        torch.testing.assert_close(f.detach(), b, rtol=0, atol=0)
    assert m16.decoder[0] is tm.decoder[0]          # the decoder is shared
    q = cast_feature_storage(ObservedQuery(tm, 0.5, 99.0), "bfloat16")
    assert isinstance(q, ObservedQuery) and q.model.features[0].dtype == torch.bfloat16
    assert q.stability_thresh == 0.5 and q.fill_value == 99.0
    assert tm.features[0].dtype == torch.float32
    fn = lambda p: p[:, :1]                          # any other callable: as it is
    assert cast_feature_storage(fn) is fn
    atlas = GridAtlas(_small_atlas_cfg(), device="cpu")
    atlas.add_submap(np.array([[-1, 1]] * 3, np.float32))
    p16 = cast_feature_storage(atlas.params)
    assert p16.features[0].dtype == torch.bfloat16 and p16.stability[0].dtype == torch.bfloat16
    assert atlas.params.features[0].dtype == torch.float32


def _small_atlas_cfg():
    return {"spatial_dim": 3,
            "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 0.0,
                     "bound": [[-1, 1], [-1, 1], [-1, 1]], "base_cell_size": 0.5,
                     "per_level_scale": 2.0, "n_levels": 2},
            "decoder": {"type": "mlp", "hidden_dim": 8, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": True, "fix": False, "pretrained_model": None},
            "pose": {"optimize": False, "num_poses": 2}}


def test_bf16_fields_and_mesh_match_float32_and_jax():
    """tests/test_utils_misc.py:130 through the port: the bf16 field within
    0.02 of the field's scale of the float32 one and of the JAX package's
    bf16 field; the bf16 mesh's F-score against the float32 mesh over 95 %."""
    from miso_tpu.utils.sdf import cast_feature_storage as jcast
    from miso_tpu.utils.sdf import extract_fields as jfields
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import cast_feature_storage, extract_fields, save_mesh
    jm, tm = _mesh_models()
    bound = tm.bound.numpy()
    u32 = extract_fields(tm, bound, 24, chunk=2048)
    u16 = extract_fields(cast_feature_storage(tm), bound, 24, chunk=2048)
    j16 = jfields(jcast(jm), np.asarray(jm.bound), 24, chunk=2048)
    assert u16.dtype == np.float32
    scale = max(float(np.abs(u32).max()), 1e-3)
    assert np.abs(u16 - u32).max() < 0.02 * scale
    assert np.abs(u16 - j16).max() < 0.02 * scale
    mesh32 = save_mesh(tm, bound, resolution=48)
    mesh16 = save_mesh(tm, bound, resolution=48, feature_dtype="bfloat16")
    assert len(mesh32.vertices) > 50
    m = mesh_reconstruction_metrics(mesh16, mesh32, n_points=5000, threshold=0.05,
                                    truncation=0.5)
    assert m["F-score (%)"] > 95, m
    assert tm.features[0].dtype == torch.float32


def test_masked_adam_on_bf16_params_matches_jax():
    """3 masked Adam steps of an L2 loss on a bf16 and a float32 parameter:
    float32 moments, the update cast to the parameter's dtype and subtracted
    there, as the JAX package's update does."""
    from miso_tpu.train.optim import masked_adam_init as jinit
    from miso_tpu.train.optim import masked_adam_update as jupd
    from miso_tpu_torch.train.optim import masked_adam_init, masked_adam_update
    rng = np.random.default_rng(11)
    p0 = {"a": rng.normal(size=(6, 5, 4)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    tgt = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
    mask = {"a": 1.0, "b": 0.5}

    def jloss(p):
        return sum(jnp.mean((p[k].astype(jnp.float32) - tgt[k]) ** 2) for k in p)
    jp = {"a": jnp.asarray(p0["a"]).astype(jnp.bfloat16), "b": jnp.asarray(p0["b"])}
    js = jinit(jp)
    tp = {"a": bf16(p0["a"]).requires_grad_(), "b": t(p0["b"], requires_grad=True)}
    ts = masked_adam_init(tp)
    for _ in range(3):
        g = jax.grad(jloss)(jp)
        jp, js = jupd(g, js, jp, {k: jnp.float32(v) for k, v in mask.items()}, lr=0.05)
        loss = sum(torch.mean((tp[k].float() - t(tgt[k])) ** 2) for k in tp)
        grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
        masked_adam_update(grads, ts, tp, mask, lr=0.05)
    assert jp["a"].dtype == jnp.bfloat16 and tp["a"].dtype == torch.bfloat16
    ref = np.asarray(jp["a"].astype(jnp.float32))
    got = tp["a"].detach().float().numpy()
    assert np.all(np.abs(got - ref) <= BF16_STEP * np.abs(ref) + 1e-12)
    assert np.mean(got == ref) > 0.99
    np.testing.assert_allclose(tp["b"].detach().numpy(), np.asarray(jp["b"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.m["a"].numpy(), np.asarray(js.m["a"]), rtol=1e-5, atol=1e-7)


def test_bf16_checkpoints_both_ways(tmp_path):
    """The JAX package writes a bf16 leaf as raw 2-byte elements ('<V2'); the
    port reads it back bit for bit and writes its own the same way, which
    numpy and ml_dtypes read back as the same bf16 values.  (The JAX
    package's own load_pytree refuses such a leaf: jnp.asarray takes no V2
    dtype.)"""
    from miso_tpu.train.checkpoint import save_pytree as jsave
    from miso_tpu_torch.train.checkpoint import load_pytree, save_pytree
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 6, 4)).astype(np.float32)
    jtree = {"f": jnp.asarray(a).astype(jnp.bfloat16), "g": jnp.asarray(a[0])}
    jsave(str(tmp_path / "jax.npz"), jtree)
    like = {"f": torch.zeros((5, 6, 4), dtype=torch.bfloat16), "g": torch.zeros((6, 4))}
    got = load_pytree(str(tmp_path / "jax.npz"), like)
    assert got["f"].dtype == torch.bfloat16
    torch.testing.assert_close(got["f"], bf16(a), rtol=0, atol=0)
    save_pytree(str(tmp_path / "port.npz"), {"f": bf16(a), "g": t(a[0])})
    with np.load(tmp_path / "port.npz") as mine, np.load(tmp_path / "jax.npz") as theirs:
        assert mine["arr::['f']"].dtype == theirs["arr::['f']"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(mine["arr::['f']"].view(ml_dtypes.bfloat16),
                                      np.asarray(jtree["f"]))
    back = load_pytree(str(tmp_path / "port.npz"), like)
    torch.testing.assert_close(back["f"], bf16(a), rtol=0, atol=0)
