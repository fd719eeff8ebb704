"""The port's apps against the JAX package's: the live viewer, the
Visualizer's live view and bf16 meshes, the visualization tools, and the
five demo CLIs (``python -m miso_tpu_torch.demo.<name>``) on the CPU.

The CLIs run at a tiny depth: few frames and iterations, small meshes, and
the module constants that set a demo's grid, pretraining and fuse depth
(``SYNTHETIC_GRID``, ``PRETRAIN_EPOCHS``, ``ENCODER_EPOCHS``, ``FUSE``)
patched to a coarse grid and a few steps; each must write its JAX demo's
``results.json`` keys.  ``build_submaps --synthetic``'s structure (the
dry run's submap count, keyframe -> submap map and anchors) is held to the
JAX demo's dry run on the same sequence, and its ``grid_atlas.npz`` loads
in the JAX package's ``load_pytree``.
"""
import copy
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from miso_tpu_torch.slam.live_viewer import LiveViewer, submap_box_corners


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


def test_live_viewer_serves_page_and_state():
    rng = np.random.default_rng(0)
    v = LiveViewer(port=0)
    try:
        status, body = _get(v.port, "/")
        assert status == 200 and b"state.json" in body
        traj = np.cumsum(rng.normal(0, 0.1, (20, 3)), axis=0)
        box = submap_box_corners(np.array([[-1, 1]] * 3, np.float32), np.eye(3), np.zeros(3))
        assert box.shape == (8, 3)
        verts = rng.normal(0, 1, (30, 3)).astype(np.float32)
        tris = rng.integers(0, 30, (40, 3)).astype(np.int32)
        v.update(frame=7, traj_est=traj, traj_gt=traj + 0.01,
                 frame_points=rng.normal(0, 1, (5000, 3)), submap_boxes=[box],
                 mesh=(verts, tris), num_submaps=1)
        st = json.loads(_get(v.port, "/state.json")[1])
        assert st["frame"] == 7 and st["num_submaps"] == 1
        assert len(st["traj_est"]) == 20 and len(st["frame_points"]) == 2000
        assert len(st["submap_boxes"][0]) == 8 and 0 < len(st["mesh_edges"]) <= 4000
        v.update(frame=8)
        st = json.loads(_get(v.port, "/state.json")[1])
        assert st["frame"] == 8 and len(st["traj_est"]) == 20
        assert _get_status(v.port, "/nothing") == 404
        # The JAX package's viewer publishes the same state for the same updates.
        from miso_tpu.slam.live_viewer import LiveViewer as JViewer
        from miso_tpu.slam.live_viewer import submap_box_corners as jbox
        np.testing.assert_array_equal(box, jbox(np.array([[-1, 1]] * 3, np.float32),
                                                np.eye(3), np.zeros(3)))
        jv = JViewer(port=0)
        try:
            rng = np.random.default_rng(0)
            traj = np.cumsum(rng.normal(0, 0.1, (20, 3)), axis=0)
            kw = dict(frame=7, traj_est=traj, traj_gt=traj + 0.01,
                      frame_points=rng.normal(0, 1, (5000, 3)), submap_boxes=[box],
                      mesh=(verts, tris), num_submaps=1)
            jv.update(**kw)
            v.update(**kw)
            assert v.state_json() == jv.state_json()
        finally:
            jv.close()
    finally:
        v.close()


def _get_status(port, path):
    try:
        return _get(port, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_visualizer_live_view_over_a_system_run(tmp_path):
    """Visualizer(live=True) fed by 3 frames of a System run: the trajectory,
    the frame's points, the submap box and a mesh queried in bf16 storage
    (mesh_feature_dtype, bfloat16 by default) reach /state.json; quit()
    closes the server."""
    from test_torch_system import CFG, MODEL_CFG, SEQ_KW, pass_through_decoder
    from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.slam.system import System
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, 3, look_at=[0, 0, -0.5])
    ds = SdfSequence(TriangleMesh(*room_scene(4.0, seed=0)), R, t, **SEQ_KW)
    cfg = copy.deepcopy(CFG)
    cfg["system"]["log_dir"] = str(tmp_path)
    cfg["visualizer"] = {"enable": True, "live": True, "live_port": 0, "mesh_vis_freq": 1,
                         "mesh_resolution": 16}
    atlas = GridAtlas(MODEL_CFG, max_kfs_per_submap=3, device="cpu")
    atlas.set_decoder(tuple((torch.as_tensor(W), torch.as_tensor(b))
                            for W, b in pass_through_decoder()), fixed=True)
    system = System(atlas, ds, ds, cfg, *ds.noisy_kf_pose_in_world(0), verbose=False)
    vis = system.visualizer
    assert vis.mesh_dtype == "bfloat16" and vis.live is not None
    try:
        system.step()
        system.step()
        st = json.loads(_get(vis.live.port, "/state.json")[1])
        assert st["frame"] == 3 and st["num_submaps"] == 1
        assert len(st["traj_est"]) == 3 and len(st["submap_boxes"]) == 1
        assert len(st["frame_points"]) > 0
        assert os.path.exists(tmp_path / "mesh_frame00003.ply")
        assert os.path.exists(tmp_path / "trajectory_live.txt")
    finally:
        vis.quit()
    with pytest.raises(OSError):
        _get(vis.live.port, "/state.json")


def _two_slot_atlas():
    """A 2-slot atlas on the CPU: a sphere's signed distance in every slot's
    fine level and a pass-through decoder, the second slot 0.3 m along x."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from test_torch_system import pass_through_decoder
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
                    "bound": [[-1, 1]] * 3, "base_cell_size": 0.5, "per_level_scale": 4.0,
                    "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 2, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 1}}
    atlas = GridAtlas(cfg, device="cpu")
    for s in range(2):
        atlas.add_submap(np.array([[-1, 1]] * 3, np.float32), np.eye(3, dtype=np.float32),
                         np.array([0.3 * s, 0, 0], np.float32))
        atlas.add_kf()
    atlas.set_decoder(tuple((torch.as_tensor(W), torch.as_tensor(b))
                            for W, b in pass_through_decoder()), fixed=True)
    with torch.no_grad():
        f = atlas.params.features[1]
        n = f.shape[1]
        c = -1 + (torch.arange(n, dtype=torch.float32) + 0.5) * 2.0 / n
        X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
        f[:, :n, :n, :n, 0] = torch.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
        for st in atlas.params.stability:
            st.fill_(1.0)
    return atlas


def test_vis_functions_write_their_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from miso_tpu_torch.utils import vis
    rng = np.random.default_rng(1)
    vis.visualize_grid_scalar(torch.as_tensor(rng.standard_normal((16, 16))),
                              str(tmp_path / "scalar.png"))
    vis.visualize_grid_magnitude(rng.standard_normal((16, 16, 3)), str(tmp_path / "mag.png"))
    vis.plot_trajectories([torch.as_tensor(rng.standard_normal((10, 3)))], ["est"],
                          str(tmp_path / "traj.png"))
    vis.plot_training_curves({"epochs": list(range(5)), "total_loss": [5, 4, 3, 2, 1]},
                             fig_path=str(tmp_path / "curve.png"))
    plane = vis.visualize_sdf_plane(_two_slot_atlas().params, np.array([[-1, 1]] * 3), 16,
                                    fig_path=str(tmp_path / "plane.png"))
    assert plane.shape == (16, 16) and plane.min() < 0 < plane.max()
    for name in ("scalar", "mag", "traj", "curve", "plane"):
        assert (tmp_path / f"{name}.png").exists()


def test_atlas_vis_on_a_two_slot_atlas(tmp_path):
    pytest.importorskip("matplotlib")
    from miso_tpu_torch.utils import atlas_vis
    atlas = _two_slot_atlas()
    atlas_vis.visualize_atlas(atlas, str(tmp_path / "atlas"), resolution=24)
    assert (tmp_path / "atlas" / "mesh_final.ply").exists()
    assert (tmp_path / "atlas" / "sdf_plane_final.png").exists()
    atlas_vis.visualize_submaps(atlas, str(tmp_path / "subs"), resolution=16)
    corners = np.load(tmp_path / "subs" / "submap_obb_corners.npy")
    assert corners.shape == (2, 8, 3)
    np.testing.assert_allclose(corners[1].mean(0), [0.3, 0, 0], atol=1e-6)
    for s in range(2):
        for f in ("mesh_submap.ply", "mesh_submap_transformed.ply", "featnorm_level1.png",
                  "mu_level0.png"):
            assert (tmp_path / "subs" / f"submap{s}" / f).exists()
    R, tt = atlas.params.updated_submap_poses()
    T = torch.eye(4).repeat(2, 1, 1)
    T[:, :3, :3], T[:, :3, 3] = R, tt
    atlas_vis.render_alignment_animation(atlas, [T, T.clone()], str(tmp_path / "anim"),
                                         resolution=16, surf_thresh=0.1)
    assert np.load(tmp_path / "anim" / "pose_history.npy").shape == (2, 2, 4, 4)
    assert (tmp_path / "anim" / "frame_001.png").exists()


# ---------------------------------------------------------------------------
# The demo CLIs.
# ---------------------------------------------------------------------------

def _results(save_dir):
    with open(os.path.join(save_dir, "results.json")) as f:
        return json.load(f)


def _jax_build_submaps_dry_run():
    """demo/build_submaps.py's synthetic setup and structure-only dry run in
    the JAX package (demo/build_submaps.py:41-78)."""
    from miso_tpu.config import load_config
    from miso_tpu.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.models.grid_atlas import GridAtlas
    from miso_tpu.native import TriangleMesh
    from miso_tpu.slam.system import System
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "rgbd",
                                   "scannet.yaml"))
    R, t = orbit_trajectory([0, 0, 0], 1.8, 1.4, 24, look_at=[0, 0, -0.5])
    dataset = SdfSequence(TriangleMesh(*room_scene(5.0, seed=0)), R, t, frame_samples=2 ** 12,
                          frame_batchsize=2048, trunc_dist=0.3, near_surface_std=0.1)
    bound = [[-3.5, 3.5], [-3.5, 3.5], [-2.0, 2.0]]
    cfg["system"].update({"submap_size": 8, "submap_local_bound": bound})
    cfg["model"]["grid"].update({"base_cell_size": 1.0, "per_level_scale": 4.0, "bound": bound})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None, "hidden_dim": 32})
    cfg["model"]["pose"]["num_poses"] = 8
    cfg_dry = copy.deepcopy(cfg)
    cfg_dry["tracking"]["disable"] = True
    cfg_dry["mapping"]["disable"] = True
    cfg_dry["visualizer"] = {"enable": False}
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"))
    R0, t0 = dataset.noisy_kf_pose_in_world(0)
    System(atlas, dataset, dataset, cfg_dry, R_world_origin=R0, t_world_origin=t0,
           verbose=False).run()
    return atlas


# What build_submaps saved in the run of the fixture below: every leaf of the
# atlas, its live submap count and its field at SAVED_POINTS.
SAVED_ATLAS = {}
SAVED_POINTS = torch.as_tensor(np.random.default_rng(0).uniform(
    [-2.5, -2.5, -1.5], [2.5, 2.5, 1.5], (4096, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def built_submaps(tmp_path_factory):
    from miso_tpu_torch.demo import build_submaps
    from miso_tpu_torch.train import checkpoint
    out = str(tmp_path_factory.mktemp("build_submaps"))
    save = checkpoint.save_pytree

    @torch.no_grad()
    def capture(path, tree, meta=None):
        SAVED_ATLAS.update(leaves=checkpoint._flatten_with_paths(tree),
                           num_submaps=tree.num_submaps, field=tree.forward(SAVED_POINTS))
        save(path, tree, meta)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "save_pytree", capture)
        build_submaps.main(["--synthetic", "--device", "cpu", "--iters", "6",
                            "--iters_per_level", "2", "--mesh_resolution", "24",
                            "--save_dir", out])
    return out


def test_build_submaps_matches_the_jax_dry_run(built_submaps):
    from miso_tpu.train.checkpoint import load_meta as jload_meta
    from miso_tpu.train.checkpoint import load_pytree as jload
    res = _results(built_submaps)
    assert set(res) == {"num_submaps", "num_keyframes", "mapping_time_sec"}
    jatlas = _jax_build_submaps_dry_run()
    path = os.path.join(built_submaps, "grid_atlas.npz")
    meta = jload_meta(path)
    assert res["num_submaps"] == meta["num_submaps"] == jatlas.num_submaps == 3
    assert meta["kf_to_submap"] == [jatlas.submap_id_for_kf(k)
                                    for k in range(jatlas.num_keyframes)]
    assert meta["anchor_kfs"] == [jatlas.anchor_kf_for_submap(s)
                                  for s in range(jatlas.num_submaps)]
    loaded = jload(path, like=jatlas.params)
    assert np.abs(np.asarray(loaded.features[1])).max() > 0
    np.testing.assert_allclose(np.asarray(loaded.bounds), np.asarray(jatlas.params.bounds))
    for s in range(3):
        assert os.path.exists(os.path.join(built_submaps, f"submap{s}", "mesh_submap.ply"))


@torch.no_grad()
def test_align_submaps_loads_the_atlas_as_it_was_saved(built_submaps):
    """align_submaps --atlas's load (the structure replayed from the file's
    meta and bounds under the config.yaml beside it, then every tensor
    loaded) gives back build_submaps' atlas: every leaf, the structure and
    the field, exactly."""
    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.demo.align_submaps import load_atlas
    from miso_tpu_torch.demo.build_submaps import structure
    from miso_tpu_torch.train.checkpoint import _flatten_with_paths, load_meta
    path = os.path.join(built_submaps, "grid_atlas.npz")
    atlas = load_atlas(path, load_config(os.path.join(built_submaps, "config.yaml")),
                       torch.device("cpu"))
    leaves = _flatten_with_paths(atlas.params)
    assert leaves.keys() == SAVED_ATLAS["leaves"].keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, SAVED_ATLAS["leaves"][k], err_msg=k)
    assert structure(atlas) == load_meta(path)
    assert atlas.params.num_submaps == SAVED_ATLAS["num_submaps"] == 3
    field = atlas.params.forward(SAVED_POINTS)
    assert torch.isfinite(field).all()
    torch.testing.assert_close(field, SAVED_ATLAS["field"], rtol=0, atol=0)


@pytest.mark.parametrize("method", ["miso", "icp"])
def test_align_submaps_from_the_built_atlas(built_submaps, tmp_path, method):
    pytest.importorskip("matplotlib")
    from miso_tpu_torch.demo import align_submaps
    extra = ["--use_sdf", "--save_animation"] if method == "miso" else []
    res = align_submaps.main(["--atlas", os.path.join(built_submaps, "grid_atlas.npz"),
                              "--method", method, "--iters", "2", "--device", "cpu",
                              "--save_dir", str(tmp_path), *extra])
    assert res == _results(tmp_path)
    assert set(res) == {"method", "feature_levels", "use_sdf", "rot_rmse_deg_before",
                        "rot_rmse_deg_after", "trans_rmse_m_before", "trans_rmse_m_after",
                        "align_time_sec"}
    assert abs(res["rot_rmse_deg_before"] - 3.0) < 1e-3
    assert abs(res["trans_rmse_m_before"] - 0.15) < 1e-5
    assert np.isfinite([res["rot_rmse_deg_after"], res["trans_rmse_m_after"]]).all()
    if method == "miso":
        assert (tmp_path / "animation" / "pose_history.npy").exists()
    with pytest.raises(SystemExit):
        align_submaps.main(["--atlas", os.path.join(built_submaps, "grid_atlas.npz"),
                            "--method", "vfpp", "--device", "cpu", "--save_dir", str(tmp_path)])


@pytest.mark.parametrize("method", ["miso", "vfpp", "mips"])
def test_align_submaps_on_its_synthetic_atlas(tmp_path, monkeypatch, method):
    """Without --atlas: the demo's synthetic two-submap atlas (4 epochs a
    training here), whose raw observations vfpp and mips read."""
    import functools
    from miso_tpu_torch.demo import align_submaps
    monkeypatch.setattr(align_submaps, "build_synthetic_atlas",
                        functools.partial(align_submaps.build_synthetic_atlas, epochs=4))
    extra = ["--use_sdf"] if method == "miso" else []
    res = align_submaps.main(["--method", method, "--iters", "2", "--device", "cpu",
                              "--save_dir", str(tmp_path), *extra])
    assert res == _results(tmp_path)
    assert res["method"] == method and res["use_sdf"] == (method == "miso")
    assert abs(res["rot_rmse_deg_before"] - 3.0) < 1e-3
    assert abs(res["trans_rmse_m_before"] - 0.15) < 1e-5
    assert np.isfinite([res["rot_rmse_deg_after"], res["trans_rmse_m_after"]]).all()


def test_full_slam_scannet_cli(tmp_path, monkeypatch):
    from miso_tpu_torch.demo import full_slam_scannet as demo
    monkeypatch.setattr(demo, "PRETRAIN_EPOCHS", 6)
    monkeypatch.setitem(demo.SYNTHETIC_GRID, "base_cell_size", 2.0)
    monkeypatch.setitem(demo.SYNTHETIC_GRID, "per_level_scale", 2.0)
    res = demo.main(["--synthetic", "--num_frames", "3", "--final_iters", "2",
                     "--mesh_resolution", "32", "--device", "cpu", "--save_dir", str(tmp_path)])
    assert res == _results(tmp_path)
    assert {"ate", "slam_time_sec", "num_submaps", "num_keyframes",
            "reconstruction"} <= set(res)
    assert res["num_keyframes"] == 3 and np.isfinite(res["ate"]["ate_rmse"])
    assert (tmp_path / "traj_est_kitti.txt").exists()


@pytest.mark.parametrize("scene,init_mode", [("room", "encode")])
def test_full_slam_newer_college_cli(tmp_path, monkeypatch, scene, init_mode):
    """Two submaps (the Fuser's alignment and fuse), encoder init, and the
    consolidated grid meshed in bf16."""
    from miso_tpu_torch.demo import full_slam_newer_college as demo
    from miso_tpu_torch.demo import full_slam_scannet
    monkeypatch.setattr(full_slam_scannet, "PRETRAIN_EPOCHS", 3)
    monkeypatch.setattr(demo, "ENCODER_EPOCHS", 2)
    monkeypatch.setattr(demo, "SYNTHETIC_GRID", {"base_cell_size": 4.0, "per_level_scale": 2.0})
    monkeypatch.setattr(demo, "FUSE", dict(demo.FUSE, iterations=2, max_points_per_iter=4096))
    res = demo.main(["--synthetic", "--scene", scene, "--init_mode", init_mode,
                     "--num_frames", "4", "--submap_size", "2", "--mesh_resolution", "16",
                     "--device", "cpu", "--save_dir", str(tmp_path)])
    assert res == _results(tmp_path)
    assert {"ate", "ate_prefusion", "ate_postalign", "slam_time_sec", "fusion_time_sec",
            "align_time_sec", "align_stage_info", "fuse_time_sec", "fuse_info", "num_frames",
            "num_submaps", "init_mode", "init_iterations", "init_iterations_encode",
            "encoder_info", "frame_profile", "mesh_resolution", "mesh_time_sec",
            "consolidate_time_sec", "consolidation_sdf_error", "mesh_vs_gt"} <= set(res)
    assert res["num_submaps"] == 2 and res["init_mode"] == init_mode
    assert len(res["encoder_info"]) >= 1
    assert res["consolidation_sdf_error"]["max_abs"] < 0.05
    assert (tmp_path / "ckpt_final.npz").exists() and (tmp_path / "mesh_final.ply").exists()


def test_encoder_init_cli(tmp_path):
    from miso_tpu_torch.demo import encoder_init
    res = encoder_init.main(["--pretrain_epochs", "3", "--encoder_epochs", "2",
                             "--eval_epochs", "0", "2", "--device", "cpu",
                             "--save_dir", str(tmp_path)])
    got = _results(tmp_path)
    assert set(got) == {"zero", "encode"}
    for mode in ("zero", "encode"):
        assert set(got[mode]) == {"mae_by_epoch", "encoder_time_sec"}
        assert set(got[mode]["mae_by_epoch"]) == {"0", "2"}
        assert all(np.isfinite(v) for v in got[mode]["mae_by_epoch"].values())
    assert res["zero"]["encoder_time_sec"] == 0.0


def test_clis_refuse_cuda_without_a_card(tmp_path):
    """--device cuda (the default) raises where torch sees no card, before
    any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from miso_tpu_torch.demo import encoder_init
    with pytest.raises(RuntimeError, match="cuda"):
        encoder_init.main(["--save_dir", str(tmp_path)])
