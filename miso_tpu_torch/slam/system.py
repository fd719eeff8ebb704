"""SLAM orchestrator (port of ``miso_tpu/slam/system.py``).

Host-side per-frame control flow around the tracker and mapper of the
current submap:

  while frames remain:
    spawn a new submap if the KF count or the FOV overlap says so
    propagate odometry to initialize the next KF
    tracker.track(head_kf)                     (LM or Adam)
    mapper.mapping(replay window + head)       (padded, ``replay_window``)
    sync the head's pose rows into the atlas, visualizer artifacts

The current submap trains as a GridNet of its own (``GridAtlas.get_submap``,
a contiguous copy); its features are written back into the atlas at a
boundary only (spawn, checkpoint, a visualizer mesh, the end of the run),
its pose rows every frame.  With ``system.profile`` each frame's stages are
timed by ``utils/profiling.py::StageProfiler``, synchronizing the card
before the clock is read; with or without it, each stage opens the span
``slam.<stage>`` for a recording profiler.  With an ``encoder`` and
``system.submap_init_mode: "encode"`` each new submap's features start from
the encoder's one-shot prediction on its anchor keyframe's observations
(:meth:`System._encode_init_current_submap`), and its init burst runs
``mapping.init_iterations_encode`` iterations (default ``init_iterations //
3``) instead of ``init_iterations``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.models.encoder import EncoderObservation
from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.ops import se3
from miso_tpu_torch.slam.mapper import Mapper
from miso_tpu_torch.slam.tracker import Tracker
from miso_tpu_torch.slam.visualizer import Visualizer
from miso_tpu_torch.utils.profiling import StageProfiler, span, synchronize
from miso_tpu_torch.utils.sdf import save_mesh


def quantized_local_bound(world_bound, t_anchor) -> np.ndarray:
    """A world box translated into a submap frame: (quantized centre) +-
    (quantized half-extent), both multiples of 2^-10 m, so every anchor gives
    bit-identical extents and grid shapes (a raw float32 ``bound - t_anchor``
    can cross a ceil boundary and give submaps different shapes)."""
    b = np.asarray(world_bound, np.float64)
    q = 1.0 / 1024.0
    e = np.round((b[:, 1] - b[:, 0]) / 2.0 / q) * q
    c = np.round((b.mean(axis=1) - np.asarray(t_anchor, np.float64).reshape(3)) / q) * q
    return np.stack([c - e, c + e], axis=1).astype(np.float32)


def replay_window(first_kf: int, head_kf: int, max_replay_frames: int,
                  max_replay_freq: int):
    """The keyframes one mapping burst replays: every ``replay_freq``-th
    keyframe since the submap's first, and the head, padded to
    ``max_replay_frames + 1`` slots by repeating the window, as the JAX
    system pads it."""
    replay_freq = max((head_kf - first_kf) // max_replay_frames, max_replay_freq)
    kfs = list(range(first_kf, head_kf, replay_freq)) + [head_kf]
    slots = max_replay_frames + 1
    if len(kfs) > slots:
        kfs = kfs[-slots:]
    base = list(kfs)
    while len(kfs) < slots:
        kfs.append(base[len(kfs) % len(base)])
    return kfs


def _pose_np(R, t) -> np.ndarray:
    return se3.pose_matrix(R, t).detach().cpu().numpy()


class System:
    def __init__(self, model: GridAtlas, dataset_track: SubmapDataset,
                 dataset_map: SubmapDataset, cfg: Dict,
                 R_world_origin=None, t_world_origin=None, verbose=True, encoder=None):
        if model.num_submaps != 0:
            raise ValueError("System needs an empty GridAtlas")
        self.model = model
        self.cfg = cfg
        self.verbose = verbose
        self.dataset_track = dataset_track
        self.dataset_map = dataset_map
        m = cfg["mapping"]
        self.max_replay_frames = m.get("max_replay_frames", 10)
        self.max_replay_freq = m.get("max_replay_freq", 10)
        self.map_iters = m.get("iters_per_frame", 15)
        self.map_level_iters = m.get("level_iters_per_frame", 5)
        self.init_iters = m.get("init_iterations", 50)
        self.encoder = encoder
        self.init_mode = cfg["system"].get("submap_init_mode", "zero")
        self.init_iters_encode = m.get("init_iterations_encode", max(self.init_iters // 3, 1))
        self.encoder_info = []  # per encoder-initialized submap: {'submap', 'encoder_time' (s)}
        self._enc_rng = np.random.default_rng(cfg["system"].get("encoder_seed", 17))
        self.init_odom = cfg["system"].get("init_odom", "external")
        if self.init_odom not in ("external", "static"):
            raise ValueError(f"Unknown odometry type: {self.init_odom}")
        self.log_dir = cfg["system"].get("log_dir", "./results/default")
        # Per-frame stage breakdown (system.profile: true); the summary's
        # medians leave out the first frames' one-off costs.
        self.profiler = StageProfiler() if cfg["system"].get("profile", False) else None
        self._features_synced = True
        self.spawn_ms = []  # per spawned submap: ms of each part, synchronized
        self.initialize_system(R_world_origin, t_world_origin)

    def profile_summary(self):
        return self.profiler.summary() if self.profiler else None

    # -- helpers -------------------------------------------------------------
    def current_kf_id(self) -> int:
        return self.model.curr_kf_id

    def _sync_submap_from_tracker_mapper(self):
        """Write the current submap (features and poses) back to the atlas.
        At a boundary only: spawn, checkpoint, a visualizer mesh, the end."""
        self.model.set_submap(self.model.curr_submap_id, self.mapper.grid)
        self._features_synced = True

    def _sync_poses_from_tracker(self):
        """The per-frame sync: the current submap's pose rows only."""
        self.model.set_submap_poses(self.model.curr_submap_id, self.tracker.grid)
        self._features_synced = False

    def ensure_full_sync(self):
        """Make the atlas's features current before a reader of them."""
        if not self._features_synced:
            self._sync_submap_from_tracker_mapper()

    def _fresh_tracker_mapper(self):
        grid = self.model.get_submap(self.model.curr_submap_id)
        self.tracker = Tracker(grid, self.dataset_track, self.cfg)
        self.mapper = Mapper(grid, self.dataset_map, self.cfg)

    def _push_grid(self):
        """Keep tracker and mapper on the same grid object."""
        self.mapper.grid = self.tracker.grid

    def _submap_local_bound(self, t_anchor) -> np.ndarray:
        """``system.submap_local_bound`` (a box in the submap frame), or with
        ``system.submap_world_bound`` that world box translated into the
        submap frame by :func:`quantized_local_bound` (axis-aligned submaps
        only), so every submap covers the whole site with the same shapes."""
        wb = self.cfg["system"].get("submap_world_bound")
        if wb is None:
            return np.asarray(self.cfg["system"]["submap_local_bound"], np.float32)
        if not self.cfg["system"].get("submap_axis_aligned", False):
            raise ValueError("system.submap_world_bound requires system.submap_axis_aligned")
        return quantized_local_bound(wb, t_anchor)

    @property
    def _encode_init(self) -> bool:
        return self.encoder is not None and self.init_mode == "encode"

    def _encode_init_current_submap(self):
        """One-shot init of the new submap's features by the encoder, from a
        batch of its anchor keyframe drawn from the mapping sequence (with
        the generator seeded by ``system.encoder_seed``) and moved into the
        submap frame by the anchor's pose there."""
        from miso_tpu_torch.train.local_opt import initialize_grid_net

        kf = self.current_kf_id()
        ds = self.dataset_map
        ds.select_keyframes([kf])
        batch = ds.sample(self._enc_rng)
        ds.unselect_keyframes()
        grid = self.mapper.grid
        dev = grid.bound.device

        def t(name):
            return torch.as_tensor(np.asarray(batch[name]), device=dev)

        R, tr = grid.updated_kf_pose(kf - int(grid.anchor_kf))
        obs = EncoderObservation(coords_world=se3.transform_points_to(t("coords_frame"), R, tr),
                                 gt_sdf=t("sdf"), gt_sdf_sign=t("sdf_signs"),
                                 gt_sdf_valid=t("sdf_valid"))
        grid, info = initialize_grid_net(grid, init_mode="encode", encoder=self.encoder,
                                         encoder_observation=obs)
        # Drop the registration, which would keep every spawned submap's grid
        # alive for the whole run.
        self.encoder.grids.clear()
        self.encoder_info.append({"submap": self.model.curr_submap_id,
                                  "encoder_time": info["total_encoder_time"]})
        self.mapper.grid = grid
        self.tracker.grid = grid

    def _init_mapping(self):
        """The new submap's start-up burst: its anchor keyframe in every
        replay slot; shorter after an encoder init."""
        iters = self.init_iters_encode if self._encode_init else self.init_iters
        slots = self.max_replay_frames + 1
        self.mapper.mapping([self.current_kf_id()] * slots, iterations=iters,
                            level_iterations=max(iters // 3, 1))
        self.tracker.grid = self.mapper.grid

    # -- lifecycle -------------------------------------------------------------
    def initialize_system(self, Rws=None, tws=None):
        Rws = np.eye(3, dtype=np.float32) if Rws is None else np.asarray(Rws, np.float32)
        tws = np.zeros(3, np.float32) if tws is None else np.asarray(tws, np.float32).reshape(3)
        local_bound = self._submap_local_bound(tws)
        K = self.cfg["system"]["submap_size"]
        if self.cfg["system"].get("submap_axis_aligned", False):
            self.model.add_submap(local_bound, np.eye(3, dtype=np.float32), tws, num_poses=K)
            self.model.add_kf(Rws, np.zeros(3, dtype=np.float32))
        else:
            self.model.add_submap(local_bound, Rws, tws, num_poses=K)
            self.model.add_kf()  # the anchor at the identity in its submap
        self._after_init()

    def _after_init(self):
        self._fresh_tracker_mapper()
        if self._encode_init:
            self._encode_init_current_submap()
        self._init_mapping()
        self._sync_submap_from_tracker_mapper()
        self.visualizer = Visualizer(self.model, cfg=self.cfg)
        self.first_frame_in_submap = 0

    def initialize_next_kf_in_submap(self):
        """Odometry propagation inside the current submap."""
        dst = self.current_kf_id() + 1
        src = dst - 1
        grid = self.tracker.grid
        T_ss = _pose_np(*grid.updated_kf_pose(src - int(grid.anchor_kf)))
        T_sd = np.asarray(self.dataset_track.get_odometry_at_pose(src)) \
            if self.init_odom == "external" else np.eye(4, dtype=np.float32)
        T = T_ss @ T_sd
        self.model.add_kf(T[:3, :3], T[:3, 3])
        # Mirror into the live grid (tracker and mapper share it).
        self.tracker.grid.set_initial_kf_pose(
            dst - self.model.anchor_kf_for_submap(self.model.curr_submap_id),
            T[:3, :3], T[:3, 3])
        self.mapper.grid = self.tracker.grid

    def should_create_new_submap(self) -> bool:
        s = self.model.curr_submap_id
        if self.model.num_keyframes_in_submap(s) >= self.cfg["system"]["submap_size"]:
            return True
        return self.tracker.latest_fov_overlap < self.cfg["system"]["submap_fov_thresh"]

    def initialize_next_submap(self):
        """A new submap anchored at the odometry-propagated world pose."""
        sync = self.model.device
        marks = [("start", time.perf_counter())]

        def mark(name):
            synchronize(sync)
            marks.append((name, time.perf_counter()))

        self._sync_submap_from_tracker_mapper()
        mark("sync_before")
        src = self.current_kf_id()
        T_ws = _pose_np(*self.model.params.updated_kf_pose_in_world(src))
        T_wd = T_ws @ np.asarray(self.dataset_track.get_odometry_at_pose(src))
        local_bound = self._submap_local_bound(T_wd[:3, 3])
        K = self.cfg["system"]["submap_size"]
        if self.cfg["system"].get("submap_axis_aligned", False):
            # The submap frame is axis-aligned with the world; the anchor
            # keyframe carries its rotation in the submap.
            self.model.add_submap(local_bound, np.eye(3, dtype=np.float32), T_wd[:3, 3],
                                  num_poses=K)
            self.model.add_kf(T_wd[:3, :3], np.zeros(3, dtype=np.float32))
        else:
            self.model.add_submap(local_bound, T_wd[:3, :3], T_wd[:3, 3], num_poses=K)
            self.model.add_kf()  # the anchor at the identity in its submap
        mark("add_submap")
        self._fresh_tracker_mapper()
        mark("fresh_tm")
        if self._encode_init:
            self._encode_init_current_submap()
            mark("encode_init")
        self._init_mapping()
        mark("init_mapping")
        self._sync_submap_from_tracker_mapper()
        mark("sync_after")
        parts = {n: 1e3 * (t1 - t0) for (_, t0), (n, t1) in zip(marks, marks[1:])}
        self.spawn_ms.append(parts)
        if self.profiler is not None:
            print(f"[spawn submap {self.model.curr_submap_id}] "
                  + " ".join(f"{n}={v:.0f}ms" for n, v in parts.items()), flush=True)

    # -- checkpoint / resume -----------------------------------------------------
    def save_checkpoint(self, path: str):
        from miso_tpu_torch.train.checkpoint import save_pytree

        self._sync_submap_from_tracker_mapper()
        p = self.model.params
        save_pytree(path, p, meta={
            "curr_kf_id": self.model.curr_kf_id,
            "curr_submap_id": self.model.curr_submap_id,
            "kf_to_submap": list(self.model._kf_to_submap),
            "max_kfs": self.model.max_kfs,
            "bounds": p.bounds.cpu().numpy().tolist(),
            "first_frame_in_submap": self.first_frame_in_submap,
        })

    def load_checkpoint(self, path: str):
        """Resume from a :meth:`save_checkpoint` file (either package's):
        replay the live submaps and keyframes so the stacked storage gets the
        saved shapes, then load the tensors over it in place."""
        from miso_tpu_torch.train.checkpoint import load_meta, load_pytree

        meta = load_meta(path)
        m = self.model
        bounds = np.asarray(meta["bounds"], np.float32)
        kf2sub = [int(v) for v in meta["kf_to_submap"]]
        m.params = None
        m._submap_shapes, m._anchor_kf, m._kf_to_submap = [], [], []
        m.curr_submap_id = m.curr_kf_id = -1
        m.max_kfs = 1
        # ``bounds`` covers every stacked slot; the live ones come first.
        for s in range(int(meta["curr_submap_id"]) + 1):
            m.add_submap(bounds[s], num_poses=int(meta["max_kfs"]))
            for _ in range(kf2sub.count(s)):
                m.add_kf()
        load_pytree(path, like=m.params)
        m.curr_kf_id = int(meta["curr_kf_id"])
        m.curr_submap_id = int(meta["curr_submap_id"])
        self.first_frame_in_submap = int(meta["first_frame_in_submap"])
        self._fresh_tracker_mapper()
        self._features_synced = True

    # -- main loop ------------------------------------------------------------------
    def run(self, max_frames: Optional[int] = None):
        stop = self.dataset_map.num_kfs if max_frames is None \
            else min(self.dataset_map.num_kfs, max_frames)
        while self.model.num_keyframes < stop:
            self.step()
            if self.verbose and self.current_kf_id() % 25 == 0:
                print(f"[slam] frame {self.current_kf_id()}/{stop} submap "
                      f"{self.model.curr_submap_id} ({time.strftime('%H:%M:%S')})", flush=True)
        self.ensure_full_sync()
        self.visualizer.quit()

    def step(self):
        """One iteration of :meth:`run`'s loop: spawn a submap (its anchor is
        the next keyframe), or track and map the next keyframe."""
        prof = self.profiler
        dev = self.model.device

        @contextlib.contextmanager
        def stage(name):
            with span("slam." + name), (prof.stage(name, sync=dev) if prof
                                        else contextlib.nullcontext()):
                yield

        if prof:
            prof.start_frame(self.current_kf_id() + 1)
        if self.should_create_new_submap():
            if self.cfg["system"].get("save_submap_mesh", False):
                s = self.model.curr_submap_id
                grid = self.tracker.grid
                save_mesh(grid, grid.bound, os.path.join(self.log_dir, f"submap_{s}.ply"),
                          resolution=256)
            if prof:
                prof.mark("new_submap")
            with stage("submap_init"):
                self.initialize_next_submap()
            self.first_frame_in_submap = self.current_kf_id()
        else:
            with stage("odom"):
                self.initialize_next_kf_in_submap()
            head_kf = self.current_kf_id()
            with stage("track"):
                self.tracker.track(optimize_kf=head_kf)
            if prof:
                prof.add("track_sample", self.tracker.last_sample_time)
            self._push_grid()
            kfs = replay_window(self.first_frame_in_submap, head_kf, self.max_replay_frames,
                                self.max_replay_freq)
            with stage("map"):
                self.mapper.mapping(kfs, iterations=self.map_iters,
                                    level_iterations=self.map_level_iters)
            if prof:
                prof.add("map_sample", self.mapper.last_sample_time)
            self.tracker.grid = self.mapper.grid
            with stage("sync"):
                self._sync_poses_from_tracker()
            with stage("vis"):
                if self.visualizer.enable:
                    self.ensure_full_sync()
                self.visualizer.set_current_frame_points(
                    np.asarray(self.dataset_track.sampled_points_at_kf(head_kf)))
                self.visualizer.update_geometries(stop_frame=head_kf + 1)
                self.visualizer.update_view()
        if prof:
            prof.end_frame()

    @torch.no_grad()
    def kf_poses_in_world(self):
        """World poses (R (n, 3, 3), t (n, 3)) of the keyframes so far, as
        numpy arrays."""
        R, t = self.model.params.updated_kf_poses_in_world()
        n = self.model.num_keyframes
        return R[:n].cpu().numpy(), t[:n].cpu().numpy()
