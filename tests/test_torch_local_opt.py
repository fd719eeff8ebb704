"""The port's posed dataset, iSDF and posed-SDF losses, local optimization
and ``System``'s encoder spawn against the JAX package's, on the CPU.

* ``PosedSdf3D`` with the JAX dataset's camera rotations handed over (the
  port draws its own from a torch generator): the same frames and batches.
* The iSDF losses (the SLAM form with the eikonal and the trust region, the
  world form with the eikonal and the normals' cosine, the atlas form with
  stability and the trust region) and ``posed_sdf_loss_3d``: values 1e-5
  relative, gradients 1e-4 of the largest entry.
* ``initialize_grid_net`` in each mode (encode: 1e-5 relative, as the
  encoder's values), a few ``optimize_grid_net`` and ``optimize_grid_atlas``
  iterations (parameters 2e-6: Adam's first steps are lr times the
  gradient's sign, and these losses' gradients sit clear of zero).
* A 3-frame ``System`` run with two encoder spawns against the JAX
  ``System`` with the same encoder parameters: each new submap's features
  right after its encoder init agree to 1e-4.
"""
import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miso_tpu.datasets import sdf_3d as j_sdf3d
from miso_tpu.losses import miso as j_miso
from miso_tpu.models import encoder as j_enc
from miso_tpu.models.grid_atlas import GridAtlas as JAtlas
from miso_tpu.ops import se3 as j_se3
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.slam import system as j_system
from miso_tpu.train import local_opt as j_lo
from miso_tpu_torch.convert import feature_prediction_from_numpy, grid_net_from_numpy
from miso_tpu_torch.datasets import sdf_3d as t_sdf3d
from miso_tpu_torch.losses import isdf_loss as t_isdf
from miso_tpu_torch.losses import miso as t_miso
from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.models import encoder as t_enc
from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.slam import system as t_system
from miso_tpu_torch.train import local_opt as t_lo
from _torch_port import jax_arrays, jax_leaf, jax_model, mapping_batch, small_cfg, t
from test_torch_atlas import pair
from test_torch_system import CFG as SYS_CFG
from test_torch_system import MODEL_CFG as SYS_MODEL_CFG
from test_torch_system import pass_through_decoder, sequences

# The JAX package's losses/__init__.py binds the name isdf_loss to the function.
j_isdf = importlib.import_module("miso_tpu.losses.isdf_loss")
VAL = dict(rtol=1e-5, atol=1e-6)


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_close(got, ref, frac=1e-4, name=""):
    ref = np_(ref)
    np.testing.assert_allclose(np_(got), ref, rtol=0,
                               atol=frac * max(np.abs(ref).max(), 1e-30), err_msg=name)


def j_total(d):
    return sum(jnp.mean(v) for v in d.values())


def room():
    from miso_tpu_torch.datasets.shapes import room_scene
    return room_scene(3.0, seed=4)


# ---------------------------------------------------------------------------
# PosedSdf3D
# ---------------------------------------------------------------------------

POSED_KW = dict(frame_batchsize=64, frame_samples=256, num_frames=3, trunc_dist=0.15,
                distance_std=0.01, width=40, height=30, seed=2)


@pytest.fixture(scope="module")
def posed():
    """The JAX dataset and the port's with its rotations, poses noise-free
    (the noise's stream is each package's own)."""
    verts, tris = room()
    jds = j_sdf3d.PosedSdf3D(JMesh(verts, tris), **POSED_KW)
    tds = t_sdf3d.PosedSdf3D(TriangleMesh(verts, tris), rotations=jds.R_world_frame_gt,
                             **POSED_KW)
    return jds, tds


def test_posed_sdf3d_matches_jax(posed):
    jds, tds = posed
    np.testing.assert_array_equal(tds.t_world_frame_gt, jds.t_world_frame_gt)
    np.testing.assert_array_equal(tds.R_world_frame, jds.R_world_frame)
    np.testing.assert_array_equal(tds.t_world_frame, jds.t_world_frame)
    for a, b in zip(tds.frames, jds.frames):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, ref = tds.sample(np.random.default_rng(0)), jds.sample(np.random.default_rng(0))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(tds.get_inflated_bound(), jds.get_inflated_bound())


def test_posed_sdf3d_noise_and_batched_wrappers():
    """Pose noise from the generator: the first frame exact, the others moved
    by about the stds; the wrappers draw a scene per sample and tag it."""
    verts, tris = room()
    ds = t_sdf3d.PosedSdf3D(TriangleMesh(verts, tris), frame_std_rad=0.05,
                            frame_std_meter=0.05, **{**POSED_KW, "num_frames": 6})
    np.testing.assert_array_equal(ds.t_world_frame[0], ds.t_world_frame_gt[0])
    dt = np.linalg.norm(ds.t_world_frame - ds.t_world_frame_gt, axis=1)[1:]
    assert (dt > 0).all() and dt.max() < 0.5
    kw = {k: v for k, v in POSED_KW.items() if k != "seed"}
    bp = t_sdf3d.BatchPosedSdf3D([(verts, tris), (verts, tris)], resample_pose_every=2, **kw)
    b = bp.sample(np.random.default_rng(1))
    assert int(b["dataset_index"]) in (0, 1) and b["coords_frame"].shape == (64 * 3, 3)
    bs = t_sdf3d.BatchedSdf3D([(verts, tris)], batch_size=128, total_samples=1024)
    assert bs.sample(np.random.default_rng(2))["coords"].shape == (128, 3)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def model_pair(seed=0, num_poses=5, pose_noise=0.05, fix=False):
    cfg = small_cfg(num_poses=num_poses, init_std=0.1, fix=fix)
    jm = jax_model(cfg, seed=seed, pose_noise=pose_noise)
    return jm, grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu"), cfg


def isdf_batch(n=900, seed=0, num_poses=5):
    """Points well inside the grid's bound: outside it the field is flat, and
    the JAX eikonal's gradient there is NaN (ROADMAP Queue 3)."""
    b = mapping_batch(np.random.default_rng(seed), n, num_poses)
    r = np.random.default_rng(seed + 1)
    b["coords_frame"] = r.uniform([0.3, 0.3, 0.2], [2.0, 1.4, 0.8], (n, 3)).astype(np.float32)
    # Ray bounds: a third beyond the truncation band (free space).
    b["sdf"] = np.where(r.uniform(size=(n, 1)) < 0.33, r.uniform(0.2, 1.0, (n, 1)),
                        r.uniform(-0.15, 0.15, (n, 1))).astype(np.float32)
    b["coords"] = b["coords_frame"]
    b["normals"] = r.normal(size=(n, 3)).astype(np.float32)
    b["sdf"][:50] = 0.0          # surface samples carry the normals' term
    return b


def compare_loss(tm, jm, t_fn, j_fn, batch, names):
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    got = t_fn(tm, tb)
    (ref_total, ref), jg = jax.jit(jax.value_and_grad(
        lambda m: (j_total(j_fn(m, jb)), j_fn(m, jb)), has_aux=True, allow_int=True))(jm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), err_msg=k, **VAL)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(total_loss(got), [params[n] for n in names], allow_unused=True)
    for n, g in zip(names, grads):
        ref_g = jax_leaf(jg, n)
        grad_close(torch.zeros(ref_g.shape) if g is None else g, ref_g, name=n)
    return got


def test_isdf_loss_matches_jax():
    """The SLAM form (L1) with the eikonal (autograd, second order) and a
    trust region that the corrections cross (thresholds under their norms).
    The L2 form is held in the atlas test below."""
    jm, tm, _ = model_pair(pose_noise=0.03)
    kw = dict(trunc_dist=0.15, trunc_weight=2.0, eik_weight=0.3, eik_apply_dist=0.1,
              loss_type="L1", pose_reg_weight=10.0, pose_thresh_rad=0.02,
              pose_thresh_m=0.02)
    got = compare_loss(tm, jm, lambda m, b: t_isdf.isdf_loss(m, b, None, **kw),
                       lambda m, b: j_isdf.isdf_loss(m, b, None, **kw), isdf_batch(),
                       ["features.0", "features.1", "decoder.0", "rot_corr", "trans_corr"])
    assert min(float(got[k].detach()) for k in ("trust_region_R", "trust_region_t")) > 0


def test_isdf_loss_default_matches_jax():
    jm, tm, _ = model_pair(seed=1)
    kw = dict(trunc_dist=0.15, eik_weight=0.2, grad_weight=0.5, trunc_weight=3.0)
    got = compare_loss(tm, jm, lambda m, b: t_isdf.isdf_loss_default(m, b, None, **kw),
                       lambda m, b: j_isdf.isdf_loss_default(m, b, None, **kw),
                       isdf_batch(seed=3), ["features.0", "features.1", "decoder.2"])
    assert set(got) == {"sdf", "grad"}


def test_posed_sdf_loss_3d_matches_jax():
    """The random-free terms (SDF, free space, stability); the eikonal's
    points and the smoothness noise are each package's own stream."""
    jm, tm, _ = model_pair(seed=2)
    batch = mapping_batch(np.random.default_rng(4), 700, 5)
    kw = dict(trunc_dist=0.15, loss_type="L2")
    got = compare_loss(tm, jm, lambda m, b: t_miso.posed_sdf_loss_3d(m, b, None, **kw),
                       lambda m, b: j_miso.posed_sdf_loss_3d(m, b, jax.random.PRNGKey(0), **kw),
                       batch, ["features.0", "features.1", "stability.1", "rot_corr",
                               "trans_corr"])
    assert "stability" in got and "free_space" in got


def test_isdf_loss_submap_matches_jax():
    ja, ta = pair(seed=5)
    r = np.random.default_rng(6)
    n = 1200
    batch = {"coords_frame": r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32),
             "sample_frame_ids": r.integers(0, 6, n).astype(np.int32),
             "sdf": np.where(r.uniform(size=(n, 1)) < 0.3, r.uniform(0.2, 0.8, (n, 1)),
                             r.normal(0, 0.08, (n, 1))).astype(np.float32)}
    kw = dict(trunc_dist=0.15, trunc_weight=2.0, stability_weight=0.5, pose_reg_weight=5.0,
              pose_thresh_rad=0.01, pose_thresh_m=0.01, loss_type="L2")
    tp = ta.params.trim(ta.num_submaps).requires_grad_()
    got = t_isdf.isdf_loss_submap(tp, {k: torch.tensor(v) for k, v in batch.items()}, None, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, ref), jg = jax.jit(jax.value_and_grad(
        lambda p: (j_total(j_isdf.isdf_loss_submap(p, jb, None, **kw)),
                   j_isdf.isdf_loss_submap(p, jb, None, **kw)),
        has_aux=True, allow_int=True))(ja.params)
    assert got.keys() == ref.keys() and len(got) == 4 * ta.num_submaps
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), err_msg=k, **VAL)
    total_loss(got).backward()
    for name in ("features.1", "stability.0", "kf_rot_corr", "kf_trans_corr"):
        head, _, idx = name.partition(".")
        ref_g = getattr(jg, head)
        ref_g = np.asarray(ref_g[int(idx)] if idx else ref_g)
        p = dict(tp.named_parameters())[name]
        grad_close(p.grad, ref_g.reshape(tuple(p.shape)), name=name)


# ---------------------------------------------------------------------------
# Local optimization
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoders():
    cfg = {"model": small_cfg(fix=True)}
    je = j_enc.Encoder(cfg, key=jax.random.PRNGKey(2), trunc_dist=0.2)
    te = t_enc.Encoder(cfg, trunc_dist=0.2, device="cpu")
    te.level_params = torch.nn.ModuleList([
        feature_prediction_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
        for p in je.level_params])
    return je, te


def test_initialize_grid_net_modes(posed, encoders):
    je, te = encoders
    jds, _ = posed
    jm, tm, _ = model_pair(seed=3, num_poses=3, pose_noise=0.0, fix=True)
    zero, info = t_lo.initialize_grid_net(copy.deepcopy(tm), "zero")
    assert all(float(f.abs().max()) == 0 for f in zero.features) and info == {
        "total_encoder_time": 0.0}
    rand, _ = t_lo.initialize_grid_net(copy.deepcopy(tm), "randn",
                                       generator=torch.Generator().manual_seed(1))
    std = float(torch.cat([f.reshape(-1) for f in rand.features]).std())
    assert 0.8e-4 < std < 1.2e-4
    with pytest.raises(ValueError):
        t_lo.initialize_grid_net(copy.deepcopy(tm), "encode")
    b = jds.sample(np.random.default_rng(3))
    xw = j_se3.transform_points_by_id(jnp.asarray(b["coords_frame"]),
                                      jnp.asarray(b["sample_frame_ids"]),
                                      jnp.asarray(jds.R_world_frame),
                                      jnp.asarray(jds.t_world_frame))
    jobs = j_enc.EncoderObservation(coords_world=xw, gt_sdf=jnp.asarray(b["sdf"]),
                                    gt_sdf_sign=jnp.asarray(b["sdf_signs"]),
                                    gt_sdf_valid=jnp.asarray(b["sdf_valid"]))
    tobs = t_enc.EncoderObservation(coords_world=t(xw), gt_sdf=t(b["sdf"]),
                                    gt_sdf_sign=t(b["sdf_signs"]), gt_sdf_valid=t(b["sdf_valid"]))
    ref, _ = j_lo.initialize_grid_net(jm, "encode", je, jobs)
    got, info = t_lo.initialize_grid_net(copy.deepcopy(tm), "encode", te, tobs)
    assert info["total_encoder_time"] > 0 and len(te.grids) == 1
    te.grids.clear()
    for g, r in zip(got.features, ref.features):
        np.testing.assert_allclose(np_(g), np.asarray(r), **VAL)
    assert max(float(f.abs().max()) for f in got.features) > 0


def test_optimize_grid_net_matches_jax(posed):
    """6 epochs coarse to fine (2 a level, then joint) of the iSDF loss on
    the posed dataset's batches."""
    jds, tds = posed
    cfg = small_cfg(num_poses=3, init_std=0.05, fix=True, optimize=False)
    cfg["grid"]["bound"] = jds.get_inflated_bound().tolist()
    jm = jax_model(cfg, seed=4).replace(Rwk=jnp.asarray(jds.R_world_frame),
                                        twk=jnp.asarray(jds.t_world_frame))
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    opt = {"loss": {"trunc_distance": 0.15, "trunc_weight": 1.0},
           "train": {"optimizer": "adam", "verbose": False}}
    kw = dict(iterations=6, learning_rate=1e-3, train_mode="coordinate+joint",
              iterations_per_level=2, seed=3)
    ref, _ = j_lo.optimize_grid_net(jm, jds, opt, **kw)
    got, info = t_lo.optimize_grid_net(tm, tds, opt, **kw)
    moved = 0
    for l in range(2):
        np.testing.assert_allclose(np_(got.features[l]), np.asarray(ref.features[l]),
                                   rtol=0, atol=2e-6)
        moved += float((got.features[l] - t(jm.features[l])).abs().max()) > 1e-4
    assert moved == 2 and info["trainer_epoch"] == []


def test_optimize_grid_atlas_matches_jax():
    """3 epochs of the per-submap iSDF loss on an atlas of three submaps
    (features of level 0, stability, submap and keyframe poses)."""
    ja, ta = pair(seed=7)

    class Source:
        def sample(self, rng):
            r = np.random.default_rng(int(rng.integers(1 << 30)))
            n = 900
            return {"coords_frame": r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32),
                    "sample_frame_ids": r.integers(0, 6, n).astype(np.int32),
                    "sdf": r.uniform(-0.6, 0.6, (n, 1)).astype(np.float32)}

    cfg = {"loss": {"trunc_dist": 0.15, "stability_weight": 0.1},
           "train": {"optimizer": "adam"}}
    j_lo.optimize_grid_atlas(ja, Source(), cfg, iterations=3, seed=2)
    t_lo.optimize_grid_atlas(ta, Source(), cfg, iterations=3, seed=2)
    for name, p in ta.params.named_parameters():
        head, _, idx = name.partition(".")
        if head == "decoder":
            continue
        ref = getattr(ja.params, head)
        ref = np.asarray(ref[int(idx)] if idx else ref).reshape(tuple(p.shape))
        np.testing.assert_allclose(np_(p), ref, rtol=0, atol=2e-6, err_msg=name)
        assert not p.requires_grad


# ---------------------------------------------------------------------------
# System's encoder spawn
# ---------------------------------------------------------------------------

def test_system_encode_spawn_matches_jax():
    """3 frames, submaps of 2: the encoder initializes both submaps (the
    first at start-up, the second at the spawn, after one tracked frame);
    each one's features right after its encoder init (1e-4), one encoder
    record per submap, the registrations dropped, and the keyframe poses
    after the run (0.1 mm)."""
    seqs = sequences(3, dict(frame_samples=2**10, frame_batchsize=512, trunc_dist=0.3,
                             near_surface_std=0.1, seed=1))
    cfg = copy.deepcopy(SYS_CFG)
    cfg["system"].update(submap_size=2, submap_init_mode="encode")
    cfg["mapping"].update(init_iterations=6, iters_per_frame=2, level_iters_per_frame=1)
    je = j_enc.Encoder({"model": SYS_MODEL_CFG}, key=jax.random.PRNGKey(4), trunc_dist=0.3)
    te = t_enc.Encoder({"model": SYS_MODEL_CFG}, trunc_dist=0.3, device="cpu")
    te.level_params = torch.nn.ModuleList([
        feature_prediction_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
        for p in je.level_params])
    seen = {"jax": [], "torch": []}

    def recording(cls, key):
        class Recording(cls):
            def _encode_init_current_submap(self):
                super()._encode_init_current_submap()
                seen[key].append([np_(f).copy() for f in self.mapper.grid.features])
        return Recording

    dec = pass_through_decoder()
    ja = JAtlas(SYS_MODEL_CFG, max_kfs_per_submap=2)
    ja.set_decoder(tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in dec), fixed=True)
    ta = GridAtlas(SYS_MODEL_CFG, max_kfs_per_submap=2, device="cpu")
    ta.set_decoder(tuple((torch.from_numpy(W), torch.from_numpy(b)) for W, b in dec), fixed=True)
    pose0 = seqs[0].noisy_kf_pose_in_world(0)
    js = recording(j_system.System, "jax")(ja, seqs[1], seqs[1], cfg, *pose0, verbose=False,
                                           encoder=je)
    ts = recording(t_system.System, "torch")(ta, seqs[0], seqs[0], cfg, *pose0, verbose=False,
                                             encoder=te)
    js.run()
    ts.run()
    assert ta.num_submaps == ja.num_submaps == 2
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for got, ref in zip(seen["torch"], seen["jax"]):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        assert max(np.abs(r).max() for r in ref) > 1e-3
    assert [i["submap"] for i in ts.encoder_info] == [i["submap"] for i in js.encoder_info]
    assert len(te.grids) == 0 and ts.init_iters_encode == js.init_iters_encode == 2
    Rw, tw = ts.kf_poses_in_world()
    jR, jt = ja.params.updated_kf_poses_in_world()
    np.testing.assert_allclose(tw, np.asarray(jt)[:3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rw, np.asarray(jR)[:3], rtol=0, atol=1e-4)
