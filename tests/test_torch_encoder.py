"""The port's encoder slice against the JAX package's, on the CPU: grid
pooling and its host helpers, the conv modules and the resize, the InfoNCE
loss, the encoder's residual passes, its hierarchical prediction and its
pretraining loss with the gradients of every level's parameters, and the
encoder files both ways.

Inputs are made with numpy from a seed; the JAX encoder's parameters are
carried across with ``convert.feature_prediction_from_numpy`` (conv weights
(D, H, W, I, O) -> (O, I, D, H, W)), the grid's with ``grid_net_from_numpy``.

Tolerances: values 1e-4 relative and 1e-5 absolute (float32 sums in another
order: convolutions, the resize's contractions, pooled sums); gradients 1e-4
of the largest reference entry (the same sums, through the backward of the
interp, the pooling and the convolutions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu.losses import common as j_common
from miso_tpu.models import encoder as j_enc
from miso_tpu.models import modules as j_mod
from miso_tpu.ops import pooling as j_pool
from miso_tpu_torch.convert import (feature_prediction_from_numpy, feature_prediction_to_numpy,
                                    grid_net_from_numpy)
from miso_tpu_torch.losses import common as t_common
from miso_tpu_torch.models import encoder as t_enc
from miso_tpu_torch.models import modules as t_mod
from miso_tpu_torch.ops import pooling as t_pool
from _torch_port import VAL, close, jax_arrays, jax_model, small_cfg, t

TRUNC = 0.15


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_close(got, ref, frac=1e-4):
    """Gradients to ``frac`` of the largest reference entry."""
    ref = np_(ref)
    np.testing.assert_allclose(np_(got), ref, rtol=0,
                               atol=frac * max(np.abs(ref).max(), 1e-30))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

BOUND = np.array([[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]], np.float32)


@pytest.mark.parametrize("F", [1, 3])
def test_grid_pool_avg_matches_jax(F):
    """A fifth of the points outside the bound (clamped to the edge cells),
    a sparse sample that leaves most cells empty, and the spatial shape
    given and computed."""
    r = np.random.default_rng(F)
    coords = r.uniform(-1.4, 1.5, (300, 3)).astype(np.float32)
    feats = r.normal(size=(300, F)).astype(np.float32)
    for cell, spatial in ((0.3, None), (0.1, (20, 22, 18))):
        ref = j_pool.grid_pool_avg(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(BOUND),
                                   cell, spatial=spatial)
        got = t_pool.grid_pool_avg(t(coords), t(feats), t(BOUND), cell, spatial=spatial)
        assert tuple(got.shape) == tuple(ref.shape)
        close(got, ref, VAL)
        empty = np.asarray(ref) == 0
        assert empty.all(axis=-1).any(), "the case should leave cells empty"


def test_pooling_host_helpers_match_jax():
    r = np.random.default_rng(3)
    pts = r.uniform(-8, 8, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_pool.voxel_down_sample_indices(pts, 0.7),
                                  j_pool.voxel_down_sample_indices(pts, 0.7))
    ts = np.arange(len(pts), dtype=np.float64)
    got_p, got_ts = t_pool.crop_points(pts, ts, min_z=-2.0, max_z=5.0, min_range=2.75)
    ref_p, ref_ts = j_pool.crop_points(pts, ts, min_z=-2.0, max_z=5.0, min_range=2.75)
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_ts, ref_ts)


# ---------------------------------------------------------------------------
# Conv modules and the resize
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def level_params():
    """Two JAX FeaturePrediction levels (F=4, 3 residual channels) and the
    port's modules holding the same arrays."""
    jp = [j_enc.feature_prediction_init(jax.random.PRNGKey(10 + l), 4, 3) for l in range(2)]
    tp = torch.nn.ModuleList([feature_prediction_from_numpy(tree_np(p), device="cpu")
                              for p in jp])
    return jp, tp


@pytest.mark.parametrize("size", [(5, 6, 7), (9, 11, 13), (3, 4, 2)],
                         ids=["same", "up", "down"])
def test_conv_interp_matches_jax(level_params, size):
    """The conv stack then the resize: to the input's own size (the identity
    resize every encoder path takes), growing, and shrinking (antialiased)."""
    jp, tp = level_params
    x = np.random.default_rng(1).normal(size=(1, 5, 6, 7, 3)).astype(np.float32)
    ref = j_enc.conv_interp_apply(jp[0]["conv"], jnp.asarray(x), size)
    got = tp[0].conv(t(x), size)
    assert tuple(got.shape) == (1, *size, 8)
    close(got, ref, VAL)


def test_resize_linear_grows_as_trilinear_interpolate():
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(1, 3, 4, 5, 6)).astype(np.float32))
    ref = torch.nn.functional.interpolate(x, size=(7, 5, 11), mode="trilinear",
                                          align_corners=False)
    torch.testing.assert_close(t_enc.resize_linear(x, (7, 5, 11)), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(t_enc.resize_linear(x, (4, 5, 6)), x)


def test_feature_prediction_matches_jax(level_params):
    jp, tp = level_params
    vol = np.random.default_rng(4).normal(size=(1, 6, 5, 4, 3)).astype(np.float32)
    ref = j_enc.feature_prediction_apply(jp[1], jnp.asarray(vol), (6, 5, 4))
    got = tp[1](t(vol), (6, 5, 4))
    assert tuple(got.shape) == (6, 5, 4, 4)
    close(got, ref, VAL)
    back = feature_prediction_to_numpy(tp[1])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree_np(jp[1]))):
        np.testing.assert_array_equal(a, b)


def test_feature_prediction_pins_float32_forward_and_backward(level_params, monkeypatch):
    """With both TF32 flags on (cuDNN's is PyTorch's default), every
    convolution the level calls and every tensor its forward saves for the
    backward, and each use of one in the backward, sees both flags off; the
    flags are the caller's again afterwards."""
    _, tp = level_params

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    seen = {"conv3d": [], "pack": [], "unpack": []}
    conv3d = torch.nn.functional.conv3d

    def recording_conv3d(*args, **kwargs):
        seen["conv3d"].append(flags())
        return conv3d(*args, **kwargs)

    def pack(x):
        seen["pack"].append(flags())
        return x

    def unpack(x):
        seen["unpack"].append(flags())
        return x

    monkeypatch.setattr(torch.nn.functional, "conv3d", recording_conv3d)
    before = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        vol = t(np.random.default_rng(5).normal(size=(1, 6, 5, 4, 3)).astype(np.float32))
        vol.requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            out = tp[1](vol, (6, 5, 4))
        assert flags() == (True, True)
        out.backward(torch.ones_like(out))
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert vol.grad is not None and all(p.grad is not None for p in tp[1].parameters())
    tp[1].zero_grad(set_to_none=True)
    for where, got in seen.items():
        assert got and set(got) == {(False, False)}, (where, got)


@pytest.mark.parametrize("dim", [2, 3])
def test_feature_upsampler_matches_jax(dim):
    jp = j_mod.feature_upsampler_init(jax.random.PRNGKey(dim), dim, 3, 5)
    jp = {**jp, "deconv_b": jax.random.normal(jax.random.PRNGKey(9), (5,))}
    m = t_mod.FeatureUpsampler(dim, 3, 5, device="cpu")
    with torch.no_grad():
        m.deconv_W.copy_(t(jp["deconv_W"]))
        m.deconv_b.copy_(t(jp["deconv_b"]))
        for dst, src in zip(m.refiner, (v for pair in jp["refiner"] for v in pair)):
            dst.copy_(t(src))
    x = np.random.default_rng(dim).normal(size=(1,) + (4, 3, 5)[:dim] + (3,)).astype(np.float32)
    ref = j_mod.feature_upsampler_apply(jp, jnp.asarray(x))
    got = m(t(x))
    assert tuple(got.shape) == (1,) + (8, 6, 10)[:dim] + (5,)
    close(got, ref, VAL)


@pytest.mark.parametrize("op", ["max", "mean"])
def test_feature_reduction_3d_matches_jax(op):
    jp = j_mod.feature_reduction_3d_init(jax.random.PRNGKey(5), 6, 4)
    m = t_mod.FeatureReduction3D(6, 4, device="cpu")
    with torch.no_grad():
        for dst, src in zip(m.mlp, (v for pair in jp["mlp"] for v in pair)):
            dst.copy_(t(src))
    x = np.random.default_rng(6).normal(size=(1, 4, 5, 3, 6)).astype(np.float32)
    for axes in ((3,), (1, 2)):
        ref = j_mod.feature_reduction_3d_apply(jp, jnp.asarray(x), axes, op)
        got = m(t(x), axes, op)
        assert tuple(got.shape) == tuple(ref.shape)
        close(got, ref, VAL)


# ---------------------------------------------------------------------------
# InfoNCE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_info_nce_loss_matches_jax(masked):
    r = np.random.default_rng(7)
    q = r.normal(size=(40, 6)).astype(np.float32)
    p = (q + 0.3 * r.normal(size=(40, 6))).astype(np.float32)
    mask = (r.uniform(size=(40, 1)) < 0.7).astype(np.float32) if masked else None
    ref, (dq_ref, dp_ref) = jax.value_and_grad(
        lambda a, b: j_common.info_nce_loss(a, b, None if mask is None else jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    qt, pt = t(q, True), t(p, True)
    got = t_common.info_nce_loss(qt, pt, None if mask is None else t(mask))
    dq, dp = torch.autograd.grad(got, (qt, pt))
    close(got, ref, VAL)
    grad_close(dq, dq_ref)
    grad_close(dp, dp_ref)


# ---------------------------------------------------------------------------
# The encoder's residual passes, prediction and pretraining loss
# ---------------------------------------------------------------------------

def encoder_case(seed=0, n=800):
    """The small ScanNet-like GridNet (2 levels, F=4, fixed decoder, random
    features and pose corrections) in both packages, a batch of frame points
    over its bound (a tenth outside), and the world-frame observation."""
    cfg = small_cfg(fix=True, init_std=0.05, num_poses=4)
    jm = jax_model(cfg, seed=seed, pose_noise=0.02)
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    r = np.random.default_rng(seed + 1)
    batch = {
        "coords_frame": r.uniform([-0.2, -0.2, -0.1], [2.6, 1.9, 1.1], (n, 3)).astype(np.float32),
        "sample_frame_ids": r.integers(0, 4, (n,)).astype(np.int32),
        "sdf": r.uniform(-0.3, 0.3, (n, 1)).astype(np.float32),
        "sdf_signs": (r.uniform(size=(n, 1)) < 0.3).astype(np.float32),
        "sdf_valid": (r.uniform(size=(n, 1)) < 0.7).astype(np.float32),
    }
    R, tr = jm.updated_kf_poses()
    from miso_tpu.ops import se3 as j_se3
    coords = j_se3.transform_points_by_id(jnp.asarray(batch["coords_frame"]),
                                          jnp.asarray(batch["sample_frame_ids"]), R, tr)
    jobs = j_enc.EncoderObservation(coords_world=coords, gt_sdf=jnp.asarray(batch["sdf"]),
                                    gt_sdf_sign=jnp.asarray(batch["sdf_signs"]),
                                    gt_sdf_valid=jnp.asarray(batch["sdf_valid"]))
    tobs = t_enc.EncoderObservation(coords_world=t(coords), gt_sdf=t(batch["sdf"]),
                                    gt_sdf_sign=t(batch["sdf_signs"]),
                                    gt_sdf_valid=t(batch["sdf_valid"]))
    return jm, tm, batch, jobs, tobs


def test_compute_residuals_and_pooled_inputs_match_jax(level_params):
    jm, tm, _, jobs, tobs = encoder_case()
    r = np.random.default_rng(8)
    corr = [r.normal(0, 0.05, f.shape).astype(np.float32) for f in jm.features]
    ref = j_enc.compute_residuals(jm, [jnp.asarray(c) for c in corr], jobs, TRUNC)
    got = t_enc.compute_residuals(tm, [t(c) for c in corr], tobs, TRUNC)
    for k in ("sdf_constraint", "fs_upper_constraint", "fs_lower_constraint", "fs_constraint"):
        close(got[k], ref[k], VAL)
    for level in range(2):
        close(t_enc.encoder_inputs_from_residuals(got, tm, level),
              j_enc.encoder_inputs_from_residuals(ref, jm, level), VAL)


def test_predict_corrections_until_level_matches_jax(level_params):
    jp, tp = level_params
    jm, tm, _, jobs, tobs = encoder_case(seed=1)
    for stop in (1, 2):
        ref = j_enc.predict_corrections_until_level(jp, jm, jobs, stop, TRUNC)
        got = t_enc.predict_corrections_until_level(tp, tm, tobs, stop, TRUNC)
        for g, rf in zip(got, ref):
            close(g, rf, VAL)
    assert np.abs(np.asarray(ref[1])).max() > 0


def test_encoder_pretrain_loss_and_gradients_match_jax(level_params):
    """Values and the gradients wrt both levels' parameters at target level
    1: level 0's reach the loss through level 1's pooled residuals and the
    final pass, level 1's through the final pass."""
    jp, tp = level_params
    jm, tm, batch, _, _ = encoder_case(seed=2)
    kw = dict(trunc_dist=TRUNC, sign_weight=1e2, pred_std=0.0)

    def j_obj(enc):
        d = j_enc.encoder_pretrain_loss(enc, jm, {k: jnp.asarray(v) for k, v in batch.items()},
                                        None, 1, **kw)
        return sum(jnp.mean(v) for v in d.values()), d

    (ref, ref_d), ref_g = jax.value_and_grad(j_obj, has_aux=True)(jp)
    d = t_enc.encoder_pretrain_loss(tp, tm, {k: t(v) for k, v in batch.items()}, None, 1, **kw)
    got = sum(torch.mean(v) for v in d.values())
    assert set(d) == set(ref_d) == {"sdf", "free_space"}
    close(got, ref, VAL)
    names = [n for n, _ in tp.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(got, list(tp.parameters()))))
    for level in range(2):
        g = {k[len(f"{level}."):]: v for k, v in grads.items() if k.startswith(f"{level}.")}
        for i, (W, b) in enumerate(ref_g[level]["conv"]):
            grad_close(g[f"conv.weight.{i}"].permute(2, 3, 4, 1, 0), W)
            grad_close(g[f"conv.bias.{i}"], b)
        for i, (W, b) in enumerate(ref_g[level]["mlp"]):
            grad_close(g[f"mlp.{2 * i}"], W)
            grad_close(g[f"mlp.{2 * i + 1}"], b)
        assert max(float(v.abs().max()) for v in g.values()) > 0


def test_encoder_files_load_in_either_package(tmp_path):
    cfg = {"model": small_cfg()}
    j_encoder = j_enc.Encoder(cfg, key=jax.random.PRNGKey(3))
    j_encoder.save(str(tmp_path / "jax"))
    t_encoder = t_enc.Encoder(cfg, pretrained_dir=str(tmp_path / "jax"), device="cpu")
    for jl, tl in zip(j_encoder.level_params, t_encoder.level_params):
        for a, b in zip(jax.tree_util.tree_leaves(feature_prediction_to_numpy(tl)),
                        jax.tree_util.tree_leaves(tree_np(jl))):
            np.testing.assert_array_equal(a, b)
    t_other = t_enc.Encoder(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    t_other.save(str(tmp_path / "torch"))
    j_back = j_enc.Encoder(cfg, pretrained_dir=str(tmp_path / "torch"))
    for jl, tl in zip(j_back.level_params, t_other.level_params):
        for a, b in zip(jax.tree_util.tree_leaves(feature_prediction_to_numpy(tl)),
                        jax.tree_util.tree_leaves(tree_np(jl))):
            np.testing.assert_array_equal(a, b)
