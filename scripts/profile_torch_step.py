#!/usr/bin/env python3
"""Where the port's steps spend their device time, on one CUDA card.

    python3 scripts/profile_torch_step.py
        [mapping|mesh|slam|multisubmap|align|fuse|encode|all]
                                          [--steps N] [--root DIR]

``mapping`` (the default): chip_smoke.py's main path, bench.py's mapping
step (ScanNet widths, 1e6-point batches, masked Adam), first with
decoder.impl "pallas" (the fused kernel), then with GridNet's default decode
(decoder.impl "xla": the interp, interp grad and decode kernels), as bench.py
and configs/ run it: each 3 warm-up steps, N steps unprofiled (default 5),
then N steps under torch.profiler (CPU and CUDA activity).  ``--root``
(default: this checkout) is the checkout whose package is profiled, with this
checkout's chip_smoke, so that another commit unpacked beside this one runs
the same steps in the same call.

``mesh``: chip_smoke.py's synthetic mesh path (room_scene, Sdf3D with 2^15
points per batch, GridTrainer with tsdf_loss_3d and the autograd eikonal,
default decode): 20 warm-up epochs, 20 unprofiled, 20 profiled; then the
192^3 lattice of extract_fields once unprofiled and once profiled.

``slam``: chip_smoke.py phase 5's online SLAM of one submap (System on a
GridAtlas with one live slot; phase 5's sequence, config and pretrained
decoder): after the init burst and 2 warm-up frames, N
whole frames (odometry, Adam tracking, mapping burst), then the tracking of
one frame and one mapping burst apart, N times each, then LM tracking of one
frame with configs/lidar/ncd_quad.yaml's settings, N times.

``multisubmap``: chip_smoke.py phase 6's two-submap quad run (System on a
GridAtlas, LM tracking, separate tracking and mapping sequences): after the
second submap's spawn and 2 warm-up frames, N whole frames, then its LM
tracking of one frame and one mapping burst apart, N times each.

``align``: chip_smoke.py phase 7's alignment (demo/align_submaps.py's
synthetic atlas, submap 1 perturbed): N steps of its latent level-1 stage
and N of its SDF finetune, each after 2 warm-up steps (one
generic_align_multiple_submaps call of N steps: the slot-id forward and
points-only backward at both levels over 38,400 points a pair, the decode in
the finetune, the pose gather, Adam over the poses).

``fuse``: chip_smoke.py phase 6's quad run to its end, then its Fuser: N
steps of the alignment's latent stage and N of its SDF finetune (8192 points
a pair), and N fuse steps (2^19 points drawn from the mapping pool, the
atlas's world query over the live slots, masked Adam over the trimmed
atlas).

``encode``: chip_smoke.py phase 8's encoder: the one-shot prediction on
demo/encoder_init.py's unseen room (32 frames of 2^10 points, 2 levels of
F=4), N times after 2 warm-up calls; N pretraining steps a level there
(training.train_encoders.pretrain_encoders: host sampling, 2 or 3 residual
passes, the target level's backward, masked Adam); and the encoder init of
a quad submap (phase 6's model, one keyframe's 2048 mapping points), N
times.

For each window it prints the card, the wall time per step (host clock,
synchronised) unprofiled and profiled, the device time per step summed over
kernels and copies, the idle share (device time against the unprofiled
window), the kernels by device time with their share, and the aten
operators by the device time of the kernels they launched.  Imports torch,
numpy, chip_smoke and miso_tpu_torch.
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _load_breakdown():
    """utils/profiling.py::breakdown of this checkout, loaded as a file of its
    own so that ``--root`` swaps only the package that is measured."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_profiling", os.path.join(ROOT, "miso_tpu_torch", "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.breakdown


breakdown = _load_breakdown()

def profile_mapping(chip_smoke, impl, steps):
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    cfg = dict(chip_smoke.SCANNET_MODEL,
               decoder=dict(chip_smoke.SCANNET_MODEL["decoder"], impl=impl))
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    batches = chip_smoke.mapping_batches(chip_smoke.N_POINTS, 4, dev)
    step = make_train_step(make_loss(mapping_loss, **chip_smoke.MAPPING_HYPER), "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    state = {"opt": masked_adam_init(model)}

    def run(n):
        for i in range(n):
            _, state["opt"], _, _ = step(model, state["opt"], batches[i % 4], None,
                                         mask, 1e-3)

    run(3)
    torch.cuda.synchronize()
    breakdown(f"mapping train step (decoder.impl {impl!r}, 1e6 points)", run, steps)


def profile_mesh(chip_smoke):
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.trainer import GridTrainer
    from miso_tpu_torch.utils.sdf import extract_fields

    ds = Sdf3D(TriangleMesh(*room_scene(4.0)), batch_size=chip_smoke.MESH_BATCH,
               total_samples=chip_smoke.MESH_SAMPLES, trunc_dist=0.3)
    model = create_grid_net(chip_smoke.mesh_model_cfg(ds.bound.tolist()),
                            generator=torch.Generator().manual_seed(0),
                            device=torch.device("cuda"))
    trainer = GridTrainer(chip_smoke.MESH_TRAIN, model,
                          make_loss(tsdf_loss_3d, **chip_smoke.MESH_LOSS), ds)
    state = {"epoch": 0}

    def run(n):
        for _ in range(n):
            trainer.pre_epoch(state["epoch"])
            trainer.train_epoch(state["epoch"])
            state["epoch"] += 1

    run(20)
    torch.cuda.synchronize()
    breakdown("mesh-path train step (default decode, 2^15 points + 2^15 eikonal)",
              run, 20)

    def lattice(n):
        for _ in range(n):
            extract_fields(model, ds.bound, chip_smoke.MESH_RESOLUTION)

    lattice(1)
    breakdown("extract_fields, 192^3 lattice (one call per step)", lattice, 1)


def _profile_system(system, steps, points):
    """N whole frames of ``system``, then the tracking of one frame and one
    mapping burst apart, N times each."""
    from miso_tpu_torch.slam.system import replay_window

    def frames(n):
        for _ in range(n):
            system.step()

    def track(n):
        for _ in range(n):
            system.tracker.track(system.current_kf_id())

    def mapping(n):
        kfs = replay_window(system.first_frame_in_submap, system.current_kf_id(),
                            system.max_replay_frames, system.max_replay_freq)
        for _ in range(n):
            system.mapper.mapping(kfs, iterations=system.map_iters,
                                  level_iterations=system.map_level_iters)

    atlas = system.model
    tracking = system.cfg["tracking"]
    solve = (f"LM tracking: {tracking['lm_max_iter']} iterations" if tracking["solver"] == "lm"
             else "Adam tracking: 15 steps")
    burst = f"{system.map_iters} steps of 11 x {points}"
    breakdown(f"one frame of submap {atlas.curr_submap_id} ({atlas.num_submaps} live of "
              f"{atlas.params.capacity} slots; odometry, {solve} of {points} points, "
              f"mapping burst: {burst})", frames, steps)
    breakdown(f"{solve} of {points} points, one frame", track, steps)
    breakdown(f"one mapping burst ({burst} points)", mapping, steps)


def profile_slam(chip_smoke, steps):
    """chip_smoke.py phase 5's run on System and a GridAtlas (one live slot):
    after the init burst and 2 warm-up frames, N whole frames, the Adam
    tracking of one frame and one mapping burst apart, then LM tracking of
    one frame with configs/lidar/ncd_quad.yaml's settings."""
    import tempfile

    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System
    from miso_tpu_torch.slam.tracker import Tracker
    from miso_tpu_torch.train.checkpoint import save_pytree

    dev = torch.device("cuda")
    mesh, ds = chip_smoke.slam_sequence()
    cfg = chip_smoke.slam_config()
    cfg["system"]["profile"] = False
    if 2 + 2 * steps >= ds.num_kfs:
        raise ValueError(f"--steps {steps}: the sequence has {ds.num_kfs} frames")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decoder.npz")
        save_pytree(path, chip_smoke.pretrain_decoder(mesh, cfg["model"], dev))
        cfg["model"]["decoder"].update({"fix": True, "pretrained_model": path})
        atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                          capacity=cfg["system"]["submap_capacity"], device=dev)
        system = System(atlas, ds, ds, cfg, *ds.noisy_kf_pose_in_world(0), verbose=False)
    system.run(max_frames=3)
    torch.cuda.synchronize()
    _profile_system(system, steps, ds.frame_batchsize)

    lidar = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
    lm_tracker = Tracker(system.tracker.grid, ds, {"tracking": lidar["tracking"]})

    def lm(n):
        for _ in range(n):
            lm_tracker.track_lm(system.current_kf_id())

    lm(2)
    breakdown(f"LM tracking of one frame ({lidar['tracking']['lm_max_iter']} iterations of "
              f"{ds.frame_batchsize} points)", lm, steps)


def profile_multisubmap(chip_smoke, steps):
    """chip_smoke.py phase 6's quad run on System and GridAtlas: after the
    second submap's spawn and 2 warm-up frames, N whole frames (odometry, LM
    tracking, mapping burst, pose sync), then the LM tracking of one frame and
    one mapping burst apart, N times each."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System

    dev = torch.device("cuda")
    mesh, _, ds_track, ds_map, cfg, _ = chip_smoke.quad_setup()
    cfg["system"]["profile"] = False
    decoder = chip_smoke.pretrain_decoder(mesh, cfg["model"], dev, trunc_dist=0.5)
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"]["submap_capacity"], device=dev)
    atlas.set_decoder(decoder, fixed=True)
    R0, t0 = np.eye(3, dtype=np.float32), ds_track.noisy_kf_pose_in_world(0)[1]
    system = System(atlas, ds_track, ds_map, cfg, R0, t0, verbose=False)
    first = cfg["system"]["submap_size"] + 3
    if first + 2 * steps > ds_track.num_kfs:
        raise ValueError(f"--steps {steps}: the sequence has {ds_track.num_kfs} frames")
    system.run(max_frames=first)
    torch.cuda.synchronize()
    _profile_system(system, steps, ds_map.frame_batchsize)


def _align_stage(atlas, kind, level, subsample_points, steps_label, lr, seed=0):
    """run(n): n steps of one alignment stage of ``atlas`` over its pairs, in
    one generic_align_multiple_submaps call (the hierarchical alignment's
    flat pair loss and pair batch, source terms precomputed)."""
    from miso_tpu_torch.align import miso as align

    pairs = [(i, j) for i in range(atlas.num_submaps) for j in range(i + 1, atlas.num_submaps)
             if atlas.check_submap_intersection(i, j)]
    loss = align.make_flat_pair_loss(kind, level=level, subsample_points=subsample_points)
    ctx = loss.precompute_src(atlas.params, align.pair_context(atlas, level, pairs))

    def run(n):
        align.generic_align_multiple_submaps(atlas, loss, num_iters=n - 1, lr=lr,
                                             submap_pairs=pairs, check_intersection=False,
                                             seed=seed, loss_ctx=ctx, batched_loss=True)

    run(2)
    return run, f"{steps_label}: {len(pairs)} pair(s) of {ctx.coords.shape[1]} points"


def profile_align(chip_smoke, steps):
    """chip_smoke.py phase 7's alignment: steps of its latent level-1 stage
    and of its SDF finetune."""
    atlas, _ = chip_smoke.build_align_atlas(torch.device("cuda"))
    atlas.set_submap_pose_correction(1, [0.02, -0.03, 0.04], [0.1, -0.05, 0.08])
    atlas.precompute_coordinates_for_alignment()
    for kind, level, label in (("latent", 1, "alignment step, latent level 1"),
                               ("sdf", atlas.num_levels - 1, "alignment step, SDF finetune")):
        run, text = _align_stage(atlas, kind, level, None, label, chip_smoke.ALIGN_LR)
        breakdown(text, run, steps)


def profile_fuse(chip_smoke, steps):
    """chip_smoke.py phase 6's quad run, then its Fuser's alignment stages
    and fuse steps."""
    import copy

    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.fuser import Fuser
    from miso_tpu_torch.slam.system import System

    dev = torch.device("cuda")
    mesh, _, ds_track, ds_map, cfg, _ = chip_smoke.quad_setup()
    cfg["system"]["profile"] = False
    decoder = chip_smoke.pretrain_decoder(mesh, cfg["model"], dev, trunc_dist=0.5)
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"]["submap_capacity"], device=dev)
    atlas.set_decoder(decoder, fixed=True)
    R0, t0 = np.eye(3, dtype=np.float32), ds_track.noisy_kf_pose_in_world(0)[1]
    System(atlas, ds_track, ds_map, cfg, R0, t0, verbose=False).run()
    c = dict(cfg["align"], **chip_smoke.QUAD_ALIGN)
    atlas.precompute_coordinates_for_alignment(max_points=c.get("max_points", 32768))
    for kind, level, label in (("latent", 1, "Fuser alignment step, latent level 1"),
                               ("sdf", atlas.num_levels - 1, "Fuser alignment step, SDF")):
        run, text = _align_stage(atlas, kind, level, c["subsample_points"], label,
                                 c["learning_rate"])
        breakdown(f"{text}, {c['subsample_points']} subsampled", run, steps)
    fuser = Fuser(atlas, ds_map, copy.deepcopy(cfg))
    kw = dict(chip_smoke.QUAD_FUSE, max_points_per_iter=chip_smoke.QUAD_FUSE_POINTS)

    def fuse(n):
        fuser.fuse(**dict(kw, iterations=n))

    fuse(2)
    breakdown(f"Fuser.fuse step ({chip_smoke.QUAD_FUSE_POINTS} points, {atlas.num_submaps} "
              f"live slots; one fuse() call of N steps: its trim, mask and scatter included)",
              fuse, steps)


def profile_encode(chip_smoke, steps):
    from miso_tpu_torch.datasets.sdf_3d import PosedSdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.models.encoder import Encoder, EncoderObservation
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.training.train_encoders import pretrain_encoders

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def observed_grid(cfg, bound, num_poses, R, t, batch):
        """A grid over ``bound`` at the poses (R, t), its encoder, and the
        observation of ``batch`` in the grid's frame."""
        cfg = dict(cfg, decoder=dict(cfg["decoder"], fix=True),
                   pose={"optimize": False, "num_poses": num_poses})
        grid = create_grid_net(cfg, bound=bound, generator=gen, device=dev)
        chip_smoke._set_grid_poses(grid, R, t)
        b = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in batch.items()}
        with torch.no_grad():
            R_, t_ = grid.updated_kf_poses()
            x = se3.transform_points_by_id(b["coords_frame"], b["sample_frame_ids"].long(),
                                           R_, t_)
        obs = EncoderObservation(coords_world=x, gt_sdf=b["sdf"], gt_sdf_sign=b["sdf_signs"],
                                 gt_sdf_valid=b["sdf_valid"])
        encoder = Encoder({"model": cfg}, generator=gen, trunc_dist=chip_smoke.ENC_TRUNC,
                          device=dev)
        return grid, encoder, obs

    def prediction(grid, encoder, obs, label):
        mid = encoder.register_grid_model(grid)

        def run(n):
            for _ in range(n):
                encoder.predict_corrections(mid, obs)

        run(2)
        breakdown(label, run, steps)

    ds = PosedSdf3D(TriangleMesh(*room_scene(5.0, seed=0)),
                    frame_batchsize=chip_smoke.ENC_FRAME_BATCH,
                    frame_samples=chip_smoke.ENC_FRAME_SAMPLES,
                    num_frames=chip_smoke.ENC_FRAMES, trunc_dist=chip_smoke.ENC_TRUNC, seed=50)
    grid, encoder, obs = observed_grid(chip_smoke.encoder_init_model_cfg(),
                                       ds.get_inflated_bound(), ds.num_frames, ds.R_world_frame,
                                       ds.t_world_frame, ds.sample(np.random.default_rng(7)))
    prediction(grid, encoder, obs, f"one-shot encoder prediction (demo/encoder_init.py's "
               f"test scene, {obs.coords_world.shape[0]} points)")

    def pretrain(n):
        pretrain_encoders(encoder.level_params, [grid], [ds], n,
                          trunc_dist=chip_smoke.ENC_TRUNC)

    pretrain(2)
    breakdown("encoder pretraining: a step of each level (host sampling included)", pretrain,
              steps)

    mesh, _, _, ds_map, cfg, _ = chip_smoke.quad_setup()
    ds_map.select_keyframes([0])
    batch = ds_map.sample(np.random.default_rng(17))
    ds_map.unselect_keyframes()
    R, t = ds_map.true_kf_pose_in_world(0)
    grid, encoder, obs = observed_grid(cfg["model"], cfg["model"]["grid"]["bound"], 1,
                                       np.asarray(R)[None], np.zeros((1, 3), np.float32), batch)
    prediction(grid, encoder, obs, f"encoder init of a quad submap (levels "
               f"{[tuple(f.shape[:3]) for f in grid.features]}, "
               f"{obs.coords_world.shape[0]} points)")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="mapping",
                    choices=("mapping", "mesh", "slam", "multisubmap", "align", "fuse",
                             "encode", "all"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    which = args.which

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    if which in ("mapping", "all"):
        for impl in ("pallas", "xla"):
            profile_mapping(chip_smoke, impl, args.steps)
    if which in ("mesh", "all"):
        profile_mesh(chip_smoke)
    if which in ("slam", "all"):
        profile_slam(chip_smoke, args.steps)
    if which in ("multisubmap", "all"):
        profile_multisubmap(chip_smoke, args.steps)
    if which in ("align", "all"):
        profile_align(chip_smoke, args.steps)
    if which in ("fuse", "all"):
        profile_fuse(chip_smoke, args.steps)
    if which in ("encode", "all"):
        profile_encode(chip_smoke, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
