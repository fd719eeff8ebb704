"""The port's single-submap SLAM runtime against the JAX package's.

``miso_tpu_torch.slam`` (LM steps and solves, the Tracker, the Mapper and the
one-submap loop) and ``train/trainer.py``'s ``level_schedule`` and pool burst,
on the CPU.  Both packages get the same sequence (the same mesh, trajectory
and seed give the same frames and odometry) and the same model (JAX
parameters copied across); the trackers and the host-sampling mapper draw
their batches from numpy generators with the same seeds, so both see the same
batches.

The LM tests run on an "oracle" grid: the fine level's channel 0 holds the
mesh's signed distance at the cell centres and the decoder passes it through
(f clamped to [-1, 1]), so the field is the scene's SDF, interpolated, and the
normal equations are well conditioned.  The mapping tests train zero features
through the same decoder.

Tolerances: LM pose rows 1e-5 (float32 sums of the Jacobian products in
another order); Adam-trained pose rows 1e-5, features 1e-4; the 6-frame loop
0.1 mm and 1e-4 per rotation entry (about 0.006 degrees).  The mapping tests use the L2 SDF loss: under L1 the
gradient is the residual's sign, and at the surface samples (label 0, first
prediction exactly 0) float32 sums taken in another order flip it, which
Adam turns into full steps of opposite sign (0.9 cm apart after six frames).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_arrays
from miso_tpu.datasets.sequence import SdfSequence as JSeq
from miso_tpu.datasets.shapes import room_scene as j_room_scene
from miso_tpu.models.grid_net import create_grid_net as j_create
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.ops import interp as j_interp
from miso_tpu.ops import se3 as j_se3
from miso_tpu.slam import tracker as j_tracker
from miso_tpu.slam.mapper import Mapper as JMapper
from miso_tpu.slam.tracker import Tracker as JTracker
from miso_tpu.train import trainer as j_trainer
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
from miso_tpu_torch.datasets.shapes import room_scene
from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.models.grid_net import grid_net_mask
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.ops import se3
from miso_tpu_torch.slam import tracker as t_tracker
from miso_tpu_torch.slam.mapper import Mapper
from miso_tpu_torch.slam.system import System, replay_window
from miso_tpu_torch.slam.tracker import Tracker
from miso_tpu_torch.train import trainer as t_trainer

POSE_TOL = dict(rtol=0, atol=1e-5)
BOUND = [[-3.0, 3.0], [-3.0, 3.0], [-2.0, 2.0]]
N_FRAMES = 8
SEQ_KW = dict(frame_samples=2**10, frame_batchsize=256, trunc_dist=0.3,
              near_surface_std=0.1, seed=1, odom_std_rad=0.002, odom_std_meter=0.005)


def model_cfg(num_poses=N_FRAMES, bound=BOUND, fix=True):
    return {"spatial_dim": 3,
            "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
                     "bound": bound, "base_cell_size": 1.0, "per_level_scale": 4.0,
                     "n_levels": 2},
            "decoder": {"type": "mlp", "hidden_dim": 2, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": True, "fix": fix, "pretrained_model": None},
            "pose": {"optimize": False, "num_poses": num_poses}}


def pass_through_decoder():
    """(relu(1 + f) - relu(1 - f)) / 2 of the fine level's channel 0: f on
    [-1, 1], with a gradient at f = 0."""
    W1 = np.zeros((8, 2), np.float32)
    W1[4, 0], W1[4, 1] = 1.0, -1.0
    return ((jnp.asarray(W1), jnp.ones(2)), (jnp.eye(2), jnp.zeros(2)),
            (jnp.asarray([[0.5], [-0.5]]), jnp.zeros(1)))


@pytest.fixture(scope="module")
def meshes():
    v, t = room_scene(4.0, seed=0)
    vj, tj = j_room_scene(4.0, seed=0)
    return TriangleMesh(v, t), JMesh(vj, tj)


@pytest.fixture(scope="module")
def seqs(meshes):
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, N_FRAMES, look_at=[0, 0, -0.5])
    return SdfSequence(meshes[0], R, t, **SEQ_KW), JSeq(meshes[1], R, t, **SEQ_KW)


def jax_grid(mesh, cfg, oracle: bool, kf_poses=()):
    """A JAX GridNet of ``cfg``: the oracle field, or zero features; the
    pass-through decoder; the given (kf, R, t) initial poses."""
    g = cfg["grid"]
    b = np.asarray(cfg["grid"]["bound"], np.float32)
    shape = j_interp.grid_shape_for_bound(b, g["base_cell_size"] / g["per_level_scale"], 3)
    fine = np.zeros(shape + (4,), np.float32)
    if oracle:
        axes = [b[k, 0] + (np.arange(shape[k]) + 0.5) * (b[k, 1] - b[k, 0]) / shape[k]
                for k in range(3)]
        centres = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        fine[..., 0] = mesh.signed_distance(centres.astype(np.float32)).reshape(shape)
    model = j_create(jax.random.PRNGKey(0), cfg, initial_features={1: fine})
    model = model.replace(decoder=pass_through_decoder())
    for kf, R, t in kf_poses:
        model = model.set_initial_kf_pose(kf, jnp.asarray(R), jnp.asarray(t))
    return model


def both(jmodel, cfg):
    return jmodel, grid_net_from_numpy(jax_arrays(jmodel), cfg, device="cpu")


def perturbed_pair(meshes, seqs, kf=3, cfg=None):
    """Oracle grids with every keyframe at its true pose but ``kf``, which is
    rotated by 0.03 rad about z and moved by (5, -4, 2) cm."""
    cfg = cfg or model_cfg()
    poses = [(k, *seqs[0].true_kf_pose_in_world(k)) for k in range(N_FRAMES)]
    R, t = poses[kf][1:]
    dR = np.asarray(j_se3.so3_exp(jnp.asarray([0.0, 0.0, 0.03])))
    poses[kf] = (kf, R @ dR, t + np.array([0.05, -0.04, 0.02], np.float32))
    return both(jax_grid(meshes[1], cfg, True, poses), cfg)


def batches(seq, kf, k, seed=0):
    seq.select_keyframes([kf])
    rng = np.random.default_rng(seed)
    return [seq.sample(rng) for _ in range(k)]


def rows(grid, kf):
    if isinstance(grid, torch.nn.Module):
        return grid.rot_corr[kf].detach().numpy(), grid.trans_corr[kf].detach().numpy()
    return np.asarray(grid.rot_corr[kf]), np.asarray(grid.trans_corr[kf])


@pytest.mark.parametrize("loss_type", ["GM", "L2"])
def test_lm_step_matches_jax(meshes, seqs, loss_type):
    gj, gt = perturbed_pair(meshes, seqs)
    for b in batches(seqs[0], 3, 3):
        gj, ij = j_tracker.lm_step(gj, jnp.asarray(b["coords_frame"]), jnp.asarray(b["sdf"]),
                                   jnp.asarray(b["sdf_valid"]), 3, jnp.float32(1e-4),
                                   jnp.float32(0.1), np.float32(np.inf), loss_type=loss_type,
                                   max_step_rad=jnp.float32(math.radians(10.0)),
                                   max_step_m=jnp.float32(1.0))
        gt, it = t_tracker.lm_step(gt, torch.as_tensor(b["coords_frame"]),
                                   torch.as_tensor(b["sdf"]), torch.as_tensor(b["sdf_valid"]),
                                   3, 1e-4, 0.1, math.inf, loss_type=loss_type,
                                   max_step_rad=math.radians(10.0), max_step_m=1.0)
        for a, r in zip(rows(gt, 3), rows(gj, 3)):
            np.testing.assert_allclose(a, r, **POSE_TOL)
        for k in ("delta_R_rad", "delta_t_norm", "fov_overlap"):
            np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(it["grad_norm"]), float(ij["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("tols", [(0.0, 0.0), (math.radians(0.01), 1e-3)],
                         ids=["no_freeze", "freeze"])
def test_lm_solve_matches_jax(meshes, seqs, tols):
    gj, gt = perturbed_pair(meshes, seqs)
    bs = batches(seqs[0], 3, 6)
    stack = lambda key: np.stack([b[key] for b in bs])
    rj, tj, ij = j_tracker.lm_solve(
        gj, jnp.asarray(stack("coords_frame")), jnp.asarray(stack("sdf")),
        jnp.asarray(stack("sdf_valid")), 3, jnp.float32(1e-4), jnp.float32(0.3),
        np.float32(0.3), jnp.float32(tols[0]), jnp.float32(tols[1]), loss_type="GM")
    rt, tt, it = t_tracker.lm_solve(
        gt, torch.as_tensor(stack("coords_frame")), torch.as_tensor(stack("sdf")),
        torch.as_tensor(stack("sdf_valid")), 3, 1e-4, 0.3, 0.3, tols[0], tols[1],
        loss_type="GM")
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **POSE_TOL)
    np.testing.assert_allclose(it["fov_overlap"].numpy(), np.asarray(ij["fov_overlap"]),
                               atol=1e-6)
    # lm_solve leaves the grid as it was.
    np.testing.assert_array_equal(gt.rot_corr[3].detach().numpy(), 0.0)


def test_lm_solve_matches_sequential_lm_steps(meshes, seqs):
    """With the tolerances off, the solve applies exactly the sequential
    steps' updates."""
    _, gt = perturbed_pair(meshes, seqs)
    bs = batches(seqs[0], 3, 4)
    stack = lambda key: torch.as_tensor(np.stack([b[key] for b in bs]))
    rot, trans, infos = t_tracker.lm_solve(gt, stack("coords_frame"), stack("sdf"),
                                           stack("sdf_valid"), 3, 1e-4, 0.1, math.inf,
                                           0.0, 0.0)
    for b in bs:
        gt, _ = t_tracker.lm_step(gt, torch.as_tensor(b["coords_frame"]),
                                  torch.as_tensor(b["sdf"]), torch.as_tensor(b["sdf_valid"]),
                                  3, 1e-4, 0.1, math.inf)
    np.testing.assert_allclose(rot.numpy(), gt.rot_corr[3].detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), gt.trans_corr[3].detach().numpy(), atol=1e-6)
    assert infos["fov_overlap"].shape == (4,)


LM_CFG = {"solver": "lm", "learning_rate": 1e-3, "loss_type": "GM", "trunc_dist": None,
          "gm_scale_sdf": 0.3, "lm_lambda": 1e-4, "lm_max_iter": 10, "lm_tol_deg": 0.01,
          "lm_tol_m": 0.001, "verbose": False}


@pytest.mark.parametrize("tracking", [LM_CFG, dict(LM_CFG, lm_scan=False),
                                      dict(LM_CFG, solver="adam", loss_type="L1",
                                           learning_rate=1e-3)],
                         ids=["lm_solve", "lm_steps", "adam_window"])
def test_tracker_matches_jax(meshes, seqs, tracking):
    gj, gt = perturbed_pair(meshes, seqs)
    cfg = {"tracking": tracking}
    tj, tt = JTracker(gj, seqs[1], cfg), Tracker(gt, seqs[0], cfg)
    tj.track(3)
    tt.track(3)
    for a, r in zip(rows(tt.grid, 3), rows(tj.grid, 3)):
        np.testing.assert_allclose(a, r, **POSE_TOL)
    assert tt.latest_fov_overlap == pytest.approx(tj.latest_fov_overlap, abs=1e-6)
    assert tt.initial_fov_overlap == pytest.approx(tj.initial_fov_overlap, abs=1e-6)


def test_lm_recovers_a_perturbed_pose(meshes):
    """The recipe of the JAX package's test_lm_tracker_converges, on an
    oracle grid with 0.125 m fine cells and frames of surface points (whose
    label, 0, the oracle field holds exactly): the LiDAR profile's settings
    bring a keyframe moved by 6.7 cm and 1.72 degrees back."""
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, N_FRAMES, look_at=[0, 0, -0.5])
    kw = dict(SEQ_KW, frame_batchsize=1024, surface_only=True)
    seqs = SdfSequence(meshes[0], R, t, **kw), None
    cfg = model_cfg()
    cfg["grid"]["per_level_scale"] = 8.0
    _, gt = perturbed_pair(meshes, seqs, kf=5, cfg=cfg)
    R_gt, t_gt = (torch.as_tensor(a) for a in seqs[0].true_kf_pose_in_world(5))
    tracker = Tracker(gt, seqs[0], {"tracking": LM_CFG})
    err_t0 = float(torch.linalg.vector_norm(tracker.grid.updated_kf_pose(5)[1] - t_gt))
    tracker.track_lm(5)
    R1, t1 = tracker.grid.updated_kf_pose(5)
    err_t1 = float(torch.linalg.vector_norm(t1 - t_gt))
    err_r1 = float(se3.rotation_rmse_deg(R1[None], R_gt[None]))
    assert err_t1 < 0.5 * err_t0, (err_t0, err_t1)
    assert err_r1 < math.degrees(0.03), err_r1
    assert 0.5 < tracker.latest_fov_overlap <= 1.0


MAP_CFG = {"learning_rate": 3e-3, "loss_type": "L2", "weight_sdf": 1.0, "weight_eik": 0.0,
           "weight_fs": 0.2, "trunc_dist": 0.3, "finite_diff_eps": 0.05,
           "grad_method": "finitediff", "eik_trunc_dist": 0.3, "use_stability": True,
           "verbose": False, "max_replay_frames": 3, "max_replay_freq": 2,
           "init_iterations": 12, "iters_per_frame": 6, "level_iters_per_frame": 2,
           "device_sampling": False}


def test_mapper_host_path_matches_jax(meshes, seqs):
    poses = [(k, *seqs[0].true_kf_pose_in_world(k)) for k in range(N_FRAMES)]
    gj, gt = both(jax_grid(meshes[1], model_cfg(), False, poses), model_cfg())
    cfg = {"mapping": MAP_CFG, "train": {"grid_training_mode": "coordinate+joint"}}
    mj, mt = JMapper(gj, seqs[1], cfg), Mapper(gt, seqs[0], cfg)
    mj.mapping([0, 2, 4, 4], iterations=7, level_iterations=2)
    mt.mapping([0, 2, 4, 4], iterations=7, level_iterations=2)
    for l in range(2):
        np.testing.assert_allclose(mt.grid.features[l].detach().numpy(),
                                   np.asarray(mj.grid.features[l]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(mt.grid.stability[l].detach().numpy(),
                                   np.asarray(mj.grid.stability[l]), rtol=0, atol=1e-4)
    assert float(mt.grid.features[1].detach().abs().max()) > 1e-3   # it trained


def test_pool_burst_matches_train_steps(meshes, seqs):
    """The burst equals make_train_step on the rows its generator draws."""
    poses = [(k, *seqs[0].true_kf_pose_in_world(k)) for k in range(N_FRAMES)]
    _, g_burst = both(jax_grid(meshes[1], model_cfg(), False, poses), model_cfg())
    _, g_steps = both(jax_grid(meshes[1], model_cfg(), False, poses), model_cfg())
    seq = seqs[0]
    seq.select_keyframes([1, 2, 2])
    pool, sel, n_rows, B = seq.device_pool("cpu")
    loss_fn = make_loss(mapping_loss, loss_type="L1", weight_eik=0.0, weight_fs=0.2,
                        trunc_dist=0.3, grad_method="finitediff", finite_diff_eps=0.05)
    sched = t_trainer.level_schedule(5, 2, 2)
    masks = [grid_net_mask(g_burst, level=l, pose=False) for l in sched]
    burst = t_trainer.make_train_burst_pool(loss_fn)
    _, totals = burst(g_burst, pool, sel, n_rows, torch.Generator().manual_seed(3), masks,
                      3e-3, B)
    gen = torch.Generator().manual_seed(3)
    step = t_trainer.make_train_step(loss_fn)
    opt = t_trainer.masked_adam_init(g_steps)
    n_max = pool["sdf"].shape[1]
    for l, total in zip(sched, totals):
        r = t_trainer.pool_batch_rows(torch.rand((3, B), generator=gen), sel, n_rows[sel],
                                      n_max)
        kf, row = r // n_max, r % n_max
        assert bool((row < n_rows[kf]).all())
        batch = {k: v[kf, row] for k, v in pool.items()}
        batch["sample_frame_ids"] = kf.to(torch.int32)
        batch["weights"] = torch.ones((3 * B, 1))
        g_steps, opt, tl, _ = step(g_steps, opt, batch, gen,
                                   grid_net_mask(g_steps, level=l, pose=False), 3e-3)
        assert float(tl) == float(total)
    for a, b in zip(g_burst.parameters(), g_steps.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(15, 5, 2, "coordinate+joint"), (50, 16, 2, "coordinate+joint"),
                                  (7, 3, 3, "coordinate"), (4, 10, 2, "coordinate+joint"),
                                  (6, 2, 2, "joint"), (9, 1, 3, "coordinate"),
                                  (0, 5, 2, "coordinate+joint")])
def test_level_schedule_matches_jax(case):
    assert t_trainer.level_schedule(*case) == j_trainer.level_schedule(*case)


def test_replay_window():
    assert replay_window(0, 1, 10, 10) == [0, 1] * 5 + [0]
    assert replay_window(0, 23, 10, 10) == [0, 10, 20, 23] * 2 + [0, 10, 20]
    assert replay_window(0, 5, 3, 2) == [0, 2, 4, 5]


def _jax_single_submap(grid, seq, cfg, n):
    """System.run for one submap on a JAX GridNet: the JAX Tracker and Mapper
    in the loop the port's System runs while it spawns no second submap."""
    m = cfg["mapping"]
    tracker, mapper = JTracker(grid, seq, cfg), JMapper(grid, seq, cfg)
    slots = m["max_replay_frames"] + 1
    mapper.mapping([0] * slots, iterations=m["init_iterations"],
                   level_iterations=max(m["init_iterations"] // 3, 1))
    tracker.grid = mapper.grid
    for dst in range(1, n):
        R, t = tracker.grid.updated_kf_pose(dst - 1)
        T = np.asarray(j_se3.pose_matrix(R, t)) @ np.asarray(seq.get_odometry_at_pose(dst - 1))
        tracker.grid = tracker.grid.set_initial_kf_pose(dst, jnp.asarray(T[:3, :3]),
                                                        jnp.asarray(T[:3, 3]))
        tracker.track(dst)
        mapper.grid = tracker.grid
        mapper.mapping(replay_window(0, dst, m["max_replay_frames"], m["max_replay_freq"]),
                       iterations=m["iters_per_frame"],
                       level_iterations=m["level_iters_per_frame"])
        tracker.grid = mapper.grid
    R, t = tracker.grid.updated_kf_poses()
    return np.asarray(R)[:n], np.asarray(t)[:n]


def test_six_frame_loop_matches_jax(meshes):
    """Six frames of online tracking (Adam, as the RGB-D profile tracks) and
    mapping from a zero submap, in the submap frame of keyframe 0, on the
    demo's 24-frame orbit: the port's System on a GridAtlas with one live
    slot against the JAX Tracker/Mapper loop."""
    n = 6
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, 24, look_at=[0, 0, -0.5])
    seq, seq_j = SdfSequence(meshes[0], R, t, **SEQ_KW), JSeq(meshes[1], R, t, **SEQ_KW)
    R0, t0 = seq.true_kf_pose_in_world(0)
    # The submap frame is keyframe 0's: a cube around it holds the room.
    bound = [[-4.5, 4.5]] * 3
    cfg_m = model_cfg(num_poses=24, bound=bound)
    cfg = {"tracking": dict(LM_CFG, solver="adam", loss_type="L1"), "mapping": MAP_CFG,
           "train": {"grid_training_mode": "coordinate+joint"},
           "system": {"init_odom": "external", "submap_size": 24, "submap_local_bound": bound,
                      "submap_fov_thresh": 0.0}}
    Rj, tj = _jax_single_submap(jax_grid(meshes[1], cfg_m, False), seq_j, cfg, n)
    atlas = GridAtlas(cfg_m, max_kfs_per_submap=24, device="cpu")
    atlas.set_decoder(tuple((torch.as_tensor(np.asarray(W)), torch.as_tensor(np.asarray(b)))
                            for W, b in pass_through_decoder()), fixed=True)
    system = System(atlas, seq, seq, cfg, R0, t0, verbose=False)
    system.run(max_frames=n)
    assert atlas.num_keyframes == n and atlas.num_submaps == 1
    R_sk, t_sk = atlas.params.updated_kf_poses_in_submap()
    R_s, t_s = R_sk[0, :n].detach().numpy(), t_sk[0, :n].detach().numpy()
    np.testing.assert_allclose(t_s, tj, rtol=0, atol=1e-4)
    # Rotations entry by entry: 1e-4 is about 0.006 degrees.  (The arccos of
    # the relative rotation's trace resolves no finer than 0.02 degrees in
    # float32 matrices.)
    np.testing.assert_allclose(R_s, Rj, rtol=0, atol=1e-4)
    # Tracking moved the poses off the odometry.
    assert np.abs(atlas.params.kf_trans_corr[0, 1:n].detach().numpy()).max() > 1e-3
    # World poses: the submap frame composed with keyframe 0's world pose.
    Rw, tw = system.kf_poses_in_world()
    np.testing.assert_allclose(tw, t_s @ R0.T + t0, atol=1e-5)
    np.testing.assert_allclose(Rw[0], R0, atol=1e-5)
