"""The port's multi-submap SLAM runtime (``slam/system.py``) against the JAX
package's, on the CPU.

Both packages get the same sequence (tests/test_slam.py's 12-frame orbit of
``room_scene(4.0)``: the same mesh, trajectory and seed give the same frames
and odometry) and atlases built from the same config.

* Dry runs (tracking and mapping disabled, as demo/build_submaps.py builds
  its structure) with ``submap_size`` 3, in the submap-local and the
  axis-aligned world-bound modes, and with static odometry spawning on the
  FOV overlap: the same keyframe -> submap map, anchors, bounds
  (bit-identical, through ``quantized_local_bound`` in world-bound mode) and
  submap and keyframe poses (1e-5).
* A spawning run of 6 frames with ``submap_size`` 4: Adam tracking and
  host-sampled mapping with the L2 loss (tests/test_torch_slam.py's loop
  settings), world keyframe poses to 0.1 mm.
* ``System`` checkpoints written by either package load in the other.
* The per-frame ``StageProfiler`` summary, the timers, and the profiler
  window that prints a step's kernel and operator tables.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from miso_tpu.datasets.sequence import SdfSequence as JSeq
from miso_tpu.datasets.shapes import room_scene as j_room_scene
from miso_tpu.models.grid_atlas import GridAtlas as JAtlas
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.slam import system as j_system
from miso_tpu.train import checkpoint as j_ckpt
from miso_tpu.utils import profiling as j_prof
from miso_tpu_torch.datasets import lidar as t_lidar
from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
from miso_tpu_torch.datasets.shapes import room_scene
from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.slam import system as t_system
from miso_tpu_torch.train import checkpoint as t_ckpt
from miso_tpu_torch.utils import profiling as t_prof

N_FRAMES = 12
SEQ_KW = dict(frame_samples=2**11, frame_batchsize=2048, trunc_dist=0.3,
              near_surface_std=0.1, seed=1)
MODEL_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
             "bound": [[-3.0, 3.0], [-3.0, 3.0], [-2.0, 2.0]],
             "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 2, "hidden_layers": 1, "out_dim": 1,
                "pos_invariant": True, "fix": True, "pretrained_model": None},
    "pose": {"optimize": True, "num_poses": 100},
}
CFG = {
    "tracking": {"solver": "adam", "learning_rate": 1e-3, "loss_type": "L1",
                 "trunc_dist": None, "gm_scale_sdf": 0.3, "lm_lambda": 1e-4,
                 "lm_max_iter": 10, "lm_tol_deg": 0.01, "lm_tol_m": 0.001, "verbose": False},
    "mapping": {"learning_rate": 3e-3, "loss_type": "L2", "weight_sdf": 1.0,
                "weight_eik": 0.0, "weight_fs": 0.2, "trunc_dist": 0.3,
                "finite_diff_eps": 0.05, "grad_method": "finitediff", "eik_trunc_dist": 0.3,
                "use_stability": True, "verbose": False, "max_replay_frames": 3,
                "max_replay_freq": 2, "init_iterations": 12, "iters_per_frame": 6,
                "level_iters_per_frame": 2, "device_sampling": False},
    "system": {"init_odom": "external", "submap_size": 3,
               "submap_local_bound": [[-4.5, 4.5]] * 3, "submap_fov_thresh": 0.0,
               "save_submap_mesh": False, "log_dir": "/tmp/miso_slam_test"},
    "visualizer": {"enable": False},
    "train": {"grid_training_mode": "coordinate+joint", "relchange_tol": 0.0},
}


def pass_through_decoder():
    """(relu(1 + f) - relu(1 - f)) / 2 of the fine level's channel 0."""
    W1 = np.zeros((8, 2), np.float32)
    W1[4, 0], W1[4, 1] = 1.0, -1.0
    return ((W1, np.ones(2, np.float32)), (np.eye(2, dtype=np.float32), np.zeros(2, np.float32)),
            (np.array([[0.5], [-0.5]], np.float32), np.zeros(1, np.float32)))


@pytest.fixture(scope="module")
def seqs():
    return sequences(N_FRAMES, SEQ_KW)


def sequences(n, seq_kw):
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, n, look_at=[0, 0, -0.5])
    return (SdfSequence(TriangleMesh(*room_scene(4.0, seed=0)), R, t, **seq_kw),
            JSeq(JMesh(*j_room_scene(4.0, seed=0)), R, t, **seq_kw))


def config(dry=False, **system):
    cfg = copy.deepcopy(CFG)
    cfg["system"].update(system)
    if dry:
        cfg["tracking"]["disable"] = True
        cfg["mapping"]["disable"] = True
    return cfg


def port_system(seqs, cfg, capacity=None):
    """The port's System on the sequence, with the pass-through decoder,
    anchored at keyframe 0's noisy world pose."""
    ta = GridAtlas(MODEL_CFG, max_kfs_per_submap=cfg["system"]["submap_size"],
                   capacity=capacity, device="cpu")
    ta.set_decoder(tuple((torch.from_numpy(W), torch.from_numpy(b))
                         for W, b in pass_through_decoder()), fixed=True)
    return t_system.System(ta, seqs[0], seqs[0], cfg, *seqs[0].noisy_kf_pose_in_world(0),
                           verbose=False)


def jax_system(seqs, cfg, capacity=None):
    """The JAX package's System as :func:`port_system` builds the port's."""
    ja = JAtlas(MODEL_CFG, max_kfs_per_submap=cfg["system"]["submap_size"], capacity=capacity)
    ja.set_decoder(tuple((jax.numpy.asarray(W), jax.numpy.asarray(b))
                         for W, b in pass_through_decoder()), fixed=True)
    return j_system.System(ja, seqs[1], seqs[1], cfg, *seqs[0].noisy_kf_pose_in_world(0),
                           verbose=False)


def systems(seqs, cfg, capacity=None, n_frames=N_FRAMES):
    """(port System, JAX System) on the same sequence, config and decoder,
    run over ``n_frames``."""
    ts, js = port_system(seqs, cfg, capacity), jax_system(seqs, cfg, capacity)
    ts.run(max_frames=n_frames)
    js.run(max_frames=n_frames)
    return ts, js


def world_poses(system, n):
    R, t = system.model.params.updated_kf_poses_in_world()
    if isinstance(R, torch.Tensor):
        return R[:n].detach().numpy(), t[:n].detach().numpy()
    return np.asarray(R)[:n], np.asarray(t)[:n]


MODES = {"local": {},
         "world_bound": {"submap_axis_aligned": True,
                         "submap_world_bound": [[-3.7, 3.3], [-3.1, 3.6], [-2.2, 2.05]]},
         # No odometry (every keyframe starts at its predecessor's pose), and
         # a FOV-overlap threshold above 1, which spawns at every frame.
         "static_fov_spawn": {"init_odom": "static", "submap_fov_thresh": 1.5}}


@pytest.mark.parametrize("mode", list(MODES))
def test_dry_run_matches_jax(seqs, mode):
    # The FOV case spawns at every frame: 4 submaps over 4 frames, into 6
    # preallocated slots (the checkpoint tests' storage).
    n, S, cap = (4, 4, 6) if mode == "static_fov_spawn" else (N_FRAMES, 4, None)
    ts, js = systems(seqs, config(dry=True, **MODES[mode]), capacity=cap, n_frames=n)
    ta, ja = ts.model, js.model
    assert ta.num_submaps == ja.num_submaps == S and ta.num_keyframes == n
    assert ta._kf_to_submap == ja._kf_to_submap
    assert [ta.anchor_kf_for_submap(s) for s in range(S)] == \
        [ja.anchor_kf_for_submap(s) for s in range(S)] == list(range(0, n, n // S))
    bt, bj = ta.params.bounds.numpy(), np.asarray(ja.params.bounds)
    np.testing.assert_array_equal(bt, bj)
    assert [ta.submap_shapes(s) for s in range(S)] == [ja.submap_shapes(s) for s in range(S)]
    for got, ref in zip(ta.params.updated_submap_poses(), ja.params.updated_submap_poses()):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for got, ref in zip(world_poses(ts, n), world_poses(js, n)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if MODES[mode].get("submap_axis_aligned"):
        np.testing.assert_array_equal(ta.params.Rws.numpy()[:4], np.tile(np.eye(3), (4, 1, 1)))
    if mode == "world_bound":  # one extent, so one set of grid shapes
        assert len({tuple(map(tuple, ta.submap_shapes(s))) for s in range(4)}) == 1
        np.testing.assert_array_equal(
            bt[2], t_system.quantized_local_bound(MODES[mode]["submap_world_bound"],
                                                  ta.params.tws[2].numpy()))


@pytest.mark.parametrize("t_anchor", [[0.0, 0.0, 0.0], [1.2345678, -0.3, 2.0000001],
                                      [-17.3, 4.51, 0.99902344]])
def test_quantized_local_bound_matches_jax(t_anchor):
    wb = [[-20.4, 19.7], [-3.3, 41.05], [-1.5, 6.25]]
    got = t_system.quantized_local_bound(wb, t_anchor)
    np.testing.assert_array_equal(got, j_system.quantized_local_bound(wb, t_anchor))
    np.testing.assert_array_equal(got[:, 1] - got[:, 0],
                                  t_system.quantized_local_bound(wb, [0.0, 0.0, 0.0])[:, 1]
                                  - t_system.quantized_local_bound(wb, [0.0, 0.0, 0.0])[:, 0])


def test_spawning_run_matches_jax():
    """Six frames in submaps of 4: the second submap spawns at keyframe 4
    with a fresh tracker and mapper on a copy of its slot and tracks
    keyframe 5.  The frames are sampled as tests/test_torch_slam.py's loop
    samples them (1024 a frame, 256 a batch)."""
    n = 6
    seqs = sequences(n, dict(SEQ_KW, frame_samples=2**10, frame_batchsize=256))
    ts, js = systems(seqs, config(submap_size=4), capacity=3, n_frames=n)
    assert ts.model.num_submaps == js.model.num_submaps == 2
    assert ts.model._kf_to_submap == js.model._kf_to_submap == [0] * 4 + [1] * 2
    (Rt, tt), (Rj, tj) = world_poses(ts, n), world_poses(js, n)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4)
    # Tracking moved the poses in both submaps; the map was written back.
    kf = ts.model.params.kf_trans_corr.detach()
    assert kf[0, 1:4].abs().max() > 1e-4 and kf[1, 1].abs().max() > 1e-4
    fine = ts.model.params.features[1]  # the pass-through decoder reads its channel 0
    assert fine[:2, ..., 0].abs().amax(dim=(1, 2, 3)).min() > 0 and not fine[2:].any()
    assert len(ts.spawn_ms) == 1 and set(ts.spawn_ms[0]) == {
        "sync_before", "add_submap", "fresh_tm", "init_mapping", "sync_after"}
    t_gt = np.stack([seqs[0].true_kf_pose_in_world(k)[1] for k in range(n)])
    assert np.abs(tt - t_gt).max() < 0.1


@pytest.fixture(scope="module")
def capacity6(seqs):
    """Dry runs of both packages over the 12 frames on capacity-6 atlases
    (4 live submaps), the port's with random features and submap offsets."""
    ts, js = systems(seqs, config(dry=True), capacity=6)
    r = np.random.default_rng(0)
    with torch.no_grad():
        for f in ts.model.params.features:
            f[:4] = torch.from_numpy(r.normal(0, 1, f[:4].shape).astype(np.float32))
        ts.model.params.sub_trans_corr[:4] = torch.from_numpy(
            r.normal(0, 0.1, (4, 3)).astype(np.float32))
    ts.mapper.grid = ts.model.get_submap(3)
    return ts, js


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_interchange(seqs, capacity6, tmp_path, writer):
    """A System checkpoint (atlas params with folded grids, and the
    bookkeeping) written by either package resumes in the other, on a
    capacity-6 atlas with 4 live submaps and random features."""
    ts, js = capacity6
    cfg = config(dry=True)
    path = str(tmp_path / "slam.npz")
    if writer == "port":
        ts.save_checkpoint(path)
        src = t_ckpt._flatten_with_paths(ts.model.params)
        dst_sys = jax_system(seqs, cfg, capacity=6)
        dst_sys.load_checkpoint(path)
        dst = j_ckpt._flatten_with_paths(dst_sys.model.params)[0]
        src_model = ts.model
    else:
        params = str(tmp_path / "params.npz")
        t_ckpt.save_pytree(params, ts.model.params)
        js.model.params = j_ckpt.load_pytree(params, like=js.model.params)
        js.mapper.grid = js.model.get_submap(3)
        js.save_checkpoint(path)
        src = j_ckpt._flatten_with_paths(js.model.params)[0]
        dst_sys = port_system(seqs, cfg, capacity=6)
        dst_sys.load_checkpoint(path)
        dst = t_ckpt._flatten_with_paths(dst_sys.model.params)
        assert dst_sys.model.num_submaps == 4
        src_model = js.model
    assert src.keys() == dst.keys()
    for k in src:
        np.testing.assert_array_equal(dst[k], src[k], err_msg=k)
    assert dst_sys.model.curr_kf_id == src_model.curr_kf_id == N_FRAMES - 1
    assert dst_sys.model.curr_submap_id == src_model.curr_submap_id == 3
    assert dst_sys.first_frame_in_submap == 9
    assert dst_sys.model._kf_to_submap == src_model._kf_to_submap


def test_resumed_port_run_finishes(seqs, tmp_path):
    """A port checkpoint taken mid-sequence resumes in a fresh port System
    and runs to the end, spawning the remaining submaps."""
    cfg = config(dry=True)
    ts = port_system(seqs, cfg, capacity=2)
    ts.run(max_frames=5)
    path = str(tmp_path / "mid.npz")
    ts.save_checkpoint(path)
    ts2 = port_system(seqs, cfg, capacity=2)
    ts2.load_checkpoint(path)
    assert ts2.model.num_keyframes == 5 and ts2.model.num_submaps == 2
    ts2.run()
    assert ts2.model.num_keyframes == N_FRAMES and ts2.model.num_submaps == 4
    assert ts2.model.params.capacity == 4


def test_stage_profiler_matches_jax(seqs):
    """The same stage durations give the JAX profiler's summary; a profiled
    dry run reports the JAX System's stage keys."""
    tp, jp = t_prof.StageProfiler(), j_prof.StageProfiler()
    r = np.random.default_rng(1)
    for frame in range(7):
        for p in (tp, jp):
            p.start_frame(frame)
        for name in ("odom", "track", "track_sample", "map", "sync"):
            dt = float(r.uniform(0, 0.1))
            tp.add(name, dt)
            jp.add(name, dt)
        if frame == 3:
            tp.mark("new_submap")
            jp.mark("new_submap")
        tp.end_frame()
        jp.end_frame()
    got, ref = tp.summary(), jp.summary()
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "n_frames":
            assert got[k] == ref[k] == 7
        else:
            for stat in ("median", "mean", "p90"):
                np.testing.assert_allclose(got[k][stat], ref[k][stat], rtol=1e-12)
    ts, js = systems(seqs, config(dry=True, profile=True), n_frames=7)
    got, ref = ts.profile_summary(), js.profile_summary()
    assert got.keys() == ref.keys() >= {"frame_ms", "odom_ms", "track_ms", "map_ms",
                                        "sync_ms", "submap_init_ms"}
    assert got["n_frames"] == ref["n_frames"] == 6


@pytest.mark.parametrize("profiled", [False, True])
def test_system_stages_are_spans(seqs, tmp_path, profiled):
    """Under a CPU profiler, a tracked and mapped frame and then a spawn
    open the ``slam.<stage>`` spans, with or without ``system.profile``; the
    mapping burst's train steps lie inside ``slam.map``."""
    from torch.profiler import ProfilerActivity, profile

    ts = port_system(seqs, config(profile=profiled, submap_size=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts.step()
        ts.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    stages = [n for n, _, _ in sorted(spans, key=lambda e: e[1]) if n.startswith("slam.")]
    assert stages == ["slam.odom", "slam.track", "slam.map", "slam.sync", "slam.vis",
                      "slam.submap_init"]
    (_, m0, m1), = [e for e in spans if e[0] == "slam.map"]
    steps = [e for e in spans if e[0] == "miso.step"]
    assert any(m0 <= a and b <= m1 for _, a, b in steps)
    assert (ts.profile_summary() is not None) == profiled


def test_breakdown_and_device_trace(tmp_path, capsys):
    """breakdown's window on CPU work: its wall times, no device time, and
    its table header; device_trace writes a Chrome trace where asked."""
    x = torch.ones((64, 64))
    calls = []

    def run(n):
        for _ in range(n):
            calls.append((x @ x).sum())

    got = t_prof.breakdown("cpu matmul", run, 2)
    assert len(calls) == 4
    assert got["steps"] == 2 and got["wall_ms"] > 0 and got["profiled_wall_ms"] > 0
    assert got["device_ms"] == 0.0 and got["idle_share"] == 1.0
    assert "== cpu matmul: 2 steps" in capsys.readouterr().out
    with t_prof.device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_encoder_init_raises(seqs):
    """Encoder init runs at start-up (tests/test_torch_local_opt.py holds it
    to the JAX package's); an encoder with fewer levels than the atlas's
    grids raises there."""
    from miso_tpu_torch.models.encoder import Encoder
    cfg = config(dry=True, submap_init_mode="encode")
    atlas = GridAtlas(MODEL_CFG, max_kfs_per_submap=3, device="cpu")
    one_level = {"model": {"grid": dict(MODEL_CFG["grid"], n_levels=1)}}
    with pytest.raises(ValueError, match="the encoder has 1 levels; 2 asked for"):
        t_system.System(atlas, seqs[0], seqs[0], cfg, encoder=Encoder(one_level, device="cpu"))


def test_kitti_poses_match_jax(tmp_path):
    from miso_tpu.datasets import lidar as j_lidar

    r = np.random.default_rng(2)
    T = np.tile(np.eye(4), (5, 1, 1))
    T[:, :3, :] = r.normal(0, 1, (5, 3, 4))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    t_lidar.write_kitti_format_poses(a, T)
    j_lidar.write_kitti_format_poses(b, T)
    assert open(a).read() == open(b).read()
    got, ref = t_lidar.read_kitti_format_poses(a), j_lidar.read_kitti_format_poses(b)
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    np.testing.assert_allclose(np.stack(got), T, rtol=0, atol=1e-12)
