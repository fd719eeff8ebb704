"""GridAtlas: the submap collection, the SLAM map (port of
``miso_tpu/models/grid_atlas.py``).

All submaps are stacked on a leading slot axis: per level, features
``(S, *pad_spatial, F)`` and stability ``(S, *pad_spatial, 1)``, channel
last; submap poses ``(S, ...)``; keyframe poses ``(S, K, ...)``.  Submaps may
have different logical bounds (ScanNet's precomputed submaps), so storage is
padded to the largest grid per level and each slot carries its logical sizes
``(S, 3)`` per level, which the interp op takes as its ``size``.

An atlas query is the masked average of the live slots' features: each slot
moves the world points into its frame, masks them with its bound and its
``active`` flag, interpolates every level with its logical size, and adds
``m * f`` and ``m``; points no slot covers keep zero features.  The port
loops over the live slots in Python, one ``grid_interpolate_dispatch`` per
slot and level (the interp kernel on the card), then decodes once through
``mlp_decode`` (the decode kernel on the card).  A spare slot would add
exactly 0 to both sums, so the result is the JAX package's over every slot.

Structure:
  * :class:`GridAtlasParams` -- the tensors and the static shape settings;
    every query reads it.
  * :class:`GridAtlas` -- the host wrapper with the SLAM bookkeeping (anchor
    keyframes, keyframe -> submap map, current ids) and the reference's
    ``add_submap`` / ``add_kf`` / pose API.  Updates are in place.

The JAX package keeps each level FOLDED as ``(S, g0, g1*g2*F)`` against TPU
lane padding; the port stores the channel-last layout and folds only in
checkpoint files (:meth:`GridAtlasParams.tree_fields`, a free reshape), so a
file from either package loads in the other.  Its ``slot_loop`` switch, jit
caches and ``prewarm_*`` are TPU compile means and have no counterpart.

Alignment and fusion read the atlas per point: ``query_feature_per_point``,
``query_stability_per_point`` and ``forward_per_point`` take each point in
its own submap's frame with its slot id and make one slot-id interp call a
level over the stacked storage (``ops/tiled_interp.py::
grid_interpolate_per_point_dispatch``).  ``trim``/``scatter_trimmed`` copy the
live slots out for the Fuser's optimisation and back; ``grid_atlas_mask``
gives the per-group learning rates as mask multipliers;
``precompute_coordinates_for_alignment`` picks the cell centres that
alignment compares.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from miso_tpu_torch.models.base import Mask
from miso_tpu_torch.models.grid_net import (GridNet, _check_device, _settings,
                                            decoder_from_config)
from miso_tpu_torch.ops import interp, se3
from miso_tpu_torch.ops.fused_decode import mlp_decode
from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_dispatch,
                                             grid_interpolate_per_point_dispatch)


def fold_stacked(t: torch.Tensor) -> torch.Tensor:
    """(S, g0, ..., F) -> the JAX package's folded (S, g0, g1*...*F), a view
    of the same storage."""
    return t.reshape(t.shape[0], t.shape[1], -1)


def unfold_stacked(t, pad_spatial: Sequence[int], fdim: int):
    """Inverse of :func:`fold_stacked`: (S, g0, g1*...*F) -> (S, *pad_spatial,
    fdim), a view of the same storage (torch tensors and numpy arrays)."""
    return t.reshape(t.shape[0], *pad_spatial, fdim)


class GridAtlasParams:
    """The atlas's tensors (all on one device) and static settings.

    ``num_submaps`` is the number of live slots, the first of the ``capacity``
    stacked ones; queries loop over those only.
    """

    # A shard of ``parallel/sharding.py::shard_atlas`` sets these: its slots
    # are rows [slot_offset, slot_offset + capacity) of slot_total, and the
    # world query sums over slot_axis.  None: the whole atlas.
    slot_axis = None
    slot_offset = 0
    slot_total = None

    def __init__(self, features, stability, decoder, sub_rot_corr, sub_trans_corr,
                 Rws, tws, kf_rot_corr, kf_trans_corr, Rsk, tsk, bounds, sizes,
                 ignore_level, active, kf_to_submap, kf_to_local, *, num_submaps: int,
                 cell_sizes: Sequence[float] = (), pos_invariant: bool = True,
                 decoder_fixed: bool = True, decode_impl: str = "xla"):
        self.features = list(features)          # per level (S, *pad, F)
        self.stability = list(stability)        # per level (S, *pad, 1)
        self.decoder = decoder                  # ((W, b), ...) or None, shared
        self.sub_rot_corr = sub_rot_corr        # (S, 3)
        self.sub_trans_corr = sub_trans_corr    # (S, 3)
        self.Rws = Rws                          # (S, 3, 3) initial submap poses
        self.tws = tws                          # (S, 3)
        self.kf_rot_corr = kf_rot_corr          # (S, K, 3)
        self.kf_trans_corr = kf_trans_corr      # (S, K, 3)
        self.Rsk = Rsk                          # (S, K, 3, 3) initial KF-in-submap
        self.tsk = tsk                          # (S, K, 3)
        self.bounds = bounds                    # (S, 3, 2) local bounds
        self.sizes = list(sizes)                # per level (S, 3) int32 logical sizes
        self.ignore_level = ignore_level        # (L,)
        self.active = active                    # (S,) float
        self.kf_to_submap = kf_to_submap        # (S*K,) int32
        self.kf_to_local = kf_to_local          # (S*K,) int32
        self.num_submaps = int(num_submaps)
        self.cell_sizes = tuple(cell_sizes)
        self.pos_invariant = pos_invariant
        self.decoder_fixed = decoder_fixed
        self.decode_impl = decode_impl

    # -- static shapes -------------------------------------------------------
    @property
    def fdim(self) -> int:
        return int(self.features[0].shape[-1])

    @property
    def num_levels(self) -> int:
        return len(self.features)

    @property
    def pad_spatial(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(int(v) for v in f.shape[1:-1]) for f in self.features)

    @property
    def capacity(self) -> int:
        return int(self.Rws.shape[0])

    @property
    def max_kfs_per_submap(self) -> int:
        return int(self.Rsk.shape[1])

    @property
    def device(self) -> torch.device:
        return self.bounds.device

    def replace(self, **fields) -> "GridAtlasParams":
        """A shallow copy with ``fields`` replaced (the tensors are shared)."""
        out = copy.copy(self)
        for k, v in fields.items():
            if not hasattr(out, k):
                raise AttributeError(f"GridAtlasParams has no field {k!r}")
            setattr(out, k, list(v) if k in ("features", "stability", "sizes") else v)
        return out

    def named_parameters(self):
        """The trainable tensors by name, as a module's: ``features.<l>``,
        ``stability.<l>``, ``decoder.<2i or 2i+1>`` (W and b of layer i),
        ``sub_rot_corr``, ``sub_trans_corr``, ``kf_rot_corr``,
        ``kf_trans_corr``.  The JAX package masks its other leaves (initial
        poses, bounds, sizes, tables) to 0 always; here they are not
        parameters.  ``train/trainer.py``'s steps and the masks of
        :func:`grid_atlas_mask` are keyed by these names."""
        for l, f in enumerate(self.features):
            yield f"features.{l}", f
        for l, st in enumerate(self.stability):
            yield f"stability.{l}", st
        for i, t in enumerate(() if self.decoder is None
                              else (t for pair in self.decoder for t in pair)):
            yield f"decoder.{i}", t
        for name in ("sub_rot_corr", "sub_trans_corr", "kf_rot_corr", "kf_trans_corr"):
            yield name, getattr(self, name)

    def requires_grad_(self, requires_grad: bool = True) -> "GridAtlasParams":
        """Set ``requires_grad`` on every tensor of :meth:`named_parameters`
        (leaves, as :meth:`trim` makes them); returns self."""
        for _, t in self.named_parameters():
            t.requires_grad_(requires_grad)
        return self

    def tree_fields(self):
        """(key, value) of the JAX GridAtlasParams's leaves in its key-path
        spelling, feature and stability levels folded as its storage is
        (``train/checkpoint.py`` writes and reads them in place)."""
        return [(".features", [fold_stacked(f) for f in self.features]),
                (".stability", [fold_stacked(s) for s in self.stability]),
                (".decoder", None if self.decoder is None else
                 [list(pair) for pair in self.decoder]),
                (".sub_rot_corr", self.sub_rot_corr), (".sub_trans_corr", self.sub_trans_corr),
                (".Rws", self.Rws), (".tws", self.tws),
                (".kf_rot_corr", self.kf_rot_corr), (".kf_trans_corr", self.kf_trans_corr),
                (".Rsk", self.Rsk), (".tsk", self.tsk), (".bounds", self.bounds),
                (".sizes", list(self.sizes)), (".ignore_level", self.ignore_level),
                (".active", self.active), (".kf_to_submap", self.kf_to_submap),
                (".kf_to_local", self.kf_to_local)]

    # -- submap poses ----------------------------------------------------------
    def updated_submap_poses(self):
        return se3.apply_pose_correction(self.Rws, self.tws, self.sub_rot_corr,
                                         self.sub_trans_corr)

    def updated_submap_pose(self, s: int):
        R, t = self.updated_submap_poses()
        return R[s], t[s]

    # -- keyframe poses --------------------------------------------------------
    def updated_kf_poses_in_submap(self):
        """(S, K, 3, 3), (S, K, 3): corrected keyframe poses in their submap."""
        return se3.apply_pose_correction(self.Rsk, self.tsk, self.kf_rot_corr,
                                         self.kf_trans_corr)

    def _every_slot_pose(self):
        """Every slot's corrected pose: a shard's own rows placed among
        zeros and summed over its slot axis (an all-gather whose gradient
        reaches each owner's rows)."""
        R, t = self.updated_submap_poses()
        ax = self.slot_axis
        if ax is None:
            return R, t

        def gather(x):
            rest = self.slot_total - self.slot_offset - x.shape[0]
            return ax.psum(torch.cat([x.new_zeros((self.slot_offset,) + x.shape[1:]), x,
                                      x.new_zeros((rest,) + x.shape[1:])]))
        return gather(R), gather(t)

    def updated_kf_poses_in_world(self):
        """(S*K, 3, 3), (S*K, 3): every global keyframe slot's world pose."""
        R_sk, t_sk = self.updated_kf_poses_in_submap()
        R_ws, t_ws = self._every_slot_pose()
        sub = self.kf_to_submap.long()
        loc = self.kf_to_local.long()
        return _compose(R_ws[sub], t_ws[sub], R_sk[sub, loc], t_sk[sub, loc])

    def updated_kf_pose_in_world(self, kf_id: int):
        R, t = self.updated_kf_poses_in_world()
        return R[kf_id], t[kf_id]

    # -- atlas queries ---------------------------------------------------------
    # ``interpolate`` and ``decode`` run one level's interp and the MLP: the
    # kernels' dispatching ops by default, the plain versions when given
    # (``ops/tiled_interp.py::grid_interpolate_plain``,
    # ``ops/fused_decode.py::mlp_decode_plain``).
    def _decoder(self):
        if self.decoder is None or not self.decoder_fixed:
            return self.decoder
        return tuple((W.detach(), b.detach()) for W, b in self.decoder)

    def _slot_levels(self, tables, s, x, ignore_level, interpolate):
        return interp.multi_level_interpolate(
            [t[s] for t in tables], x, self.bounds[s], ignore_level,
            sizes=[sz[s] for sz in self.sizes], interpolate=interpolate)

    def _masked_average(self, tables, ignore_level, x_world, interpolate):
        """(sum of weights (N,), masked average (N, L * C)) over the live
        slots of ``tables`` (per level (S, *pad, C))."""
        R_ws, t_ws = self.updated_submap_poses()
        ax = self.slot_axis
        if ax is not None:
            x_world = ax.pvary(x_world)
        n = x_world.shape[0]
        width = sum(int(t.shape[-1]) for t in tables)
        acc = torch.zeros((n, width), dtype=x_world.dtype, device=x_world.device)
        sum_w = torch.zeros((n,), dtype=x_world.dtype, device=x_world.device)
        for s in range(self.num_submaps):
            xs = se3.transform_points_from(x_world, R_ws[s], t_ws[s])
            m = se3.coords_in_bound(xs, self.bounds[s])[:, 0] * self.active[s]
            f = self._slot_levels(tables, s, xs, ignore_level, interpolate)
            acc = acc + m[:, None] * f
            sum_w = sum_w + m
        if ax is not None:
            both = ax.psum(torch.cat([acc, sum_w[:, None]], dim=1))
            acc, sum_w = both[:, :width], both[:, width]
        sum_w = torch.where(sum_w == 0, torch.ones_like(sum_w), sum_w)
        return sum_w, acc / sum_w[:, None]

    def query_feature(self, x_world: torch.Tensor,
                      interpolate=grid_interpolate_dispatch) -> torch.Tensor:
        """Masked average of the live submaps' features (N, L * F); points
        outside every submap get zero features."""
        return self._masked_average(self.features, self.ignore_level, x_world, interpolate)[1]

    def query_stability(self, x_world: torch.Tensor,
                        interpolate=grid_interpolate_dispatch) -> torch.Tensor:
        """Masked average of the live submaps' stability fields (N, L), the
        atlas's observedness (``utils/sdf.py::observed_sdf_query``)."""
        return self._masked_average(self.stability, None, x_world, interpolate)[1]

    def forward(self, x_world: torch.Tensor, interpolate=grid_interpolate_dispatch,
                decode=mlp_decode) -> torch.Tensor:
        return interp.grid_decode(self.query_feature(x_world, interpolate), x_world,
                                  self._decoder(), self.pos_invariant, decode=decode)

    __call__ = forward

    # -- one submap at its logical size ----------------------------------------
    def query_feature_submap(self, s: int, x_submap: torch.Tensor,
                             interpolate=grid_interpolate_dispatch) -> torch.Tensor:
        return self._slot_levels(self.features, s, x_submap, self.ignore_level, interpolate)

    def query_stability_submap(self, s: int, x_submap: torch.Tensor,
                               interpolate=grid_interpolate_dispatch) -> torch.Tensor:
        return self._slot_levels(self.stability, s, x_submap, None, interpolate)

    def forward_submap(self, s: int, x_submap: torch.Tensor,
                       interpolate=grid_interpolate_dispatch, decode=mlp_decode) -> torch.Tensor:
        """Decode submap s's field at submap-frame coordinates."""
        return interp.grid_decode(self.query_feature_submap(s, x_submap, interpolate),
                                  x_submap, self._decoder(), self.pos_invariant, decode=decode)

    # -- per-point submap queries ---------------------------------------------
    # Each point reads only its own slot of every level: one slot-id interp
    # call a level over the stacked storage (the slot-id kernels on the card),
    # whatever the number of slots.  The alignment and per-submap losses use
    # these (align/miso.py, losses/fusion.py).
    def query_feature_per_point(self, sub_ids: torch.Tensor,
                                x_submap: torch.Tensor) -> torch.Tensor:
        """(N, L * F) features of each point in its own submap ``sub_ids``
        (coordinates in that submap's frame); ignored levels give zeros."""
        outs = []
        for level, f in enumerate(self.features):
            v = grid_interpolate_per_point_dispatch(f, sub_ids, x_submap, self.bounds,
                                                    self.sizes[level])
            outs.append(v * (1.0 - self.ignore_level[level].to(v.dtype)))
        return torch.cat(outs, dim=-1)

    def query_stability_per_point(self, sub_ids: torch.Tensor,
                                  x_submap: torch.Tensor) -> torch.Tensor:
        """(N, L) stability of each point in its own submap."""
        return torch.cat([grid_interpolate_per_point_dispatch(st, sub_ids, x_submap, self.bounds,
                                                              self.sizes[level])
                          for level, st in enumerate(self.stability)], dim=-1)

    def forward_per_point(self, sub_ids: torch.Tensor, x_submap: torch.Tensor) -> torch.Tensor:
        """Decode each point against its own submap's field (a fixed decoder
        detached)."""
        return interp.grid_decode(self.query_feature_per_point(sub_ids, x_submap), x_submap,
                                  self._decoder(), self.pos_invariant, decode=mlp_decode)

    # -- capacity trimming (fusion) ----------------------------------------------
    @torch.no_grad()
    def trim(self, S_live: int) -> "GridAtlasParams":
        """A copy of the first ``S_live`` slots, every tensor a new leaf (the
        decoder included), for an optimisation over the live slots only
        (``slam/fuser.py``: masked Adam walks only what it trains); valid
        because submaps fill the slots in order and global keyframe ids are
        sequential, so every live keyframe id is below ``S_live * K``.
        :meth:`scatter_trimmed` writes it back."""
        K = self.max_kfs_per_submap

        def c(t, n=S_live):
            return t[:n].clone()

        return self.replace(
            features=[c(f) for f in self.features], stability=[c(st) for st in self.stability],
            decoder=None if self.decoder is None else
            tuple((W.detach().clone(), b.detach().clone()) for W, b in self.decoder),
            sub_rot_corr=c(self.sub_rot_corr), sub_trans_corr=c(self.sub_trans_corr),
            Rws=c(self.Rws), tws=c(self.tws), kf_rot_corr=c(self.kf_rot_corr),
            kf_trans_corr=c(self.kf_trans_corr), Rsk=c(self.Rsk), tsk=c(self.tsk),
            bounds=c(self.bounds), sizes=[c(sz) for sz in self.sizes],
            ignore_level=self.ignore_level.clone(), active=c(self.active),
            kf_to_submap=c(self.kf_to_submap, S_live * K),
            kf_to_local=c(self.kf_to_local, S_live * K), num_submaps=S_live)

    @torch.no_grad()
    def scatter_trimmed(self, t: "GridAtlasParams") -> "GridAtlasParams":
        """Write a :meth:`trim` copy's trained tensors (features, stability,
        decoder, submap and keyframe poses) back into the first slots of this
        storage, in place; returns self."""
        S_live = int(t.Rws.shape[0])
        for dst, src in zip(self.features + self.stability, t.features + t.stability):
            dst[:S_live] = src
        if self.decoder is not None:
            for dst, src in zip((x for pair in self.decoder for x in pair),
                                (x for pair in t.decoder for x in pair)):
                dst.copy_(src)
        for name in ("sub_rot_corr", "sub_trans_corr", "Rws", "tws", "kf_rot_corr",
                     "kf_trans_corr", "Rsk", "tsk"):
            getattr(self, name)[:S_live] = getattr(t, name)
        return self

    # -- submap views ----------------------------------------------------------
    @torch.no_grad()
    def submap(self, s: int, shapes: Optional[Sequence[Sequence[int]]] = None,
               anchor_kf: int = 0) -> GridNet:
        """Submap s as a standalone GridNet: contiguous copies of its grids
        cropped to ``shapes`` (its logical shapes per level), of its keyframe
        poses (in the submap frame) and of the shared decoder.  Training the
        GridNet leaves the atlas as it is until :meth:`with_submap`."""
        def crop(t, level):
            slot = t[s]
            if shapes is not None:
                slot = slot[tuple(slice(0, int(n)) for n in shapes[level])]
            return slot.clone(memory_format=torch.contiguous_format)

        return GridNet(
            [crop(f, l) for l, f in enumerate(self.features)],
            [crop(st, l) for l, st in enumerate(self.stability)],
            None if self.decoder is None else
            [(W.detach().clone(), b.detach().clone()) for W, b in self.decoder],
            rot_corr=self.kf_rot_corr[s].clone(), trans_corr=self.kf_trans_corr[s].clone(),
            Rwk=self.Rsk[s].clone(), twk=self.tsk[s].clone(), bound=self.bounds[s].clone(),
            ignore_level=self.ignore_level.clone(), anchor_kf=anchor_kf,
            cell_sizes=self.cell_sizes, pos_invariant=self.pos_invariant,
            decoder_fixed=self.decoder_fixed, optimize_pose=True,
            decode_impl=self.decode_impl)

    @torch.no_grad()
    def with_submap(self, s: int, grid: GridNet) -> "GridAtlasParams":
        """Write a (trained) GridNet back into slot s, in place: its grids at
        the corner of the slot, the padding beyond them zero; its keyframe
        poses; its decoder as the shared one.  Returns self."""
        for dst, src in zip(self.features + self.stability,
                            list(grid.features) + list(grid.stability)):
            slot = dst[s]
            if tuple(src.shape) != tuple(slot.shape):
                slot.zero_()
            slot[tuple(slice(0, n) for n in src.shape[:-1])] = src.detach()
        if self.decoder is not None:
            for dst, src in zip((t for pair in self.decoder for t in pair), grid.decoder):
                dst.copy_(src.detach())
        return self.with_submap_poses(s, grid)

    @torch.no_grad()
    def with_submap_poses(self, s: int, grid: GridNet) -> "GridAtlasParams":
        """Write only slot s's keyframe pose state back (the per-frame sync);
        returns self."""
        self.kf_rot_corr[s] = grid.rot_corr.detach()
        self.kf_trans_corr[s] = grid.trans_corr.detach()
        self.Rsk[s] = grid.Rwk
        self.tsk[s] = grid.twk
        return self


def _compose(Rw, tw, Rk, tk):
    """World <- keyframe from world <- submap (Rw, tw) and submap <- keyframe
    (Rk, tk), batched: (Rw Rk, Rw tk + tw)."""
    R = se3._mm(Rw, Rk)
    t = (Rw * tk.unsqueeze(-2)).sum(-1) + tw
    return R, t


def _level_shapes(bound, grid_cfg, num_levels):
    return [interp.grid_shape_for_bound(
        bound, float(grid_cfg["base_cell_size"]) / float(grid_cfg["per_level_scale"]) ** l, 3)
        for l in range(num_levels)]


# ---------------------------------------------------------------------------
# Host wrapper with SLAM bookkeeping.
# ---------------------------------------------------------------------------

class GridAtlas:
    """Host-side atlas: the params plus bookkeeping (reference grid_atlas.py).

    Keyframes and submaps are created sequentially; the first keyframe of each
    submap is its anchor.  The tensors live on ``device`` (the card unless the
    caller asks for the CPU).
    """

    def __init__(self, cfg_model: Dict, max_kfs_per_submap: int = 1,
                 dtype=torch.float32, capacity: Optional[int] = None, device="cuda"):
        """``capacity``: preallocate this many submap slots, so that
        ``add_submap`` writes a slot in place; spare slots are inactive.  When
        exceeded, storage grows geometrically (2x).  None keeps exact-size
        storage (rebuilt on every add)."""
        self.cfg_model = copy.deepcopy(cfg_model)
        self.dtype = dtype
        self.device = _check_device(device)
        self.max_kfs = int(max_kfs_per_submap)
        self.capacity = int(capacity) if capacity else None
        self.params: Optional[GridAtlasParams] = None
        self._submap_shapes: List[List[Tuple[int, ...]]] = []  # [submap][level]
        self._anchor_kf: List[int] = []
        self._kf_to_submap: List[int] = []
        self._pinned_decoder = None
        self.curr_submap_id = -1
        self.curr_kf_id = -1

    # -- properties ----------------------------------------------------------
    @property
    def num_submaps(self) -> int:
        return len(self._anchor_kf)

    @property
    def num_keyframes(self) -> int:
        return self.curr_kf_id + 1

    @property
    def num_levels(self) -> int:
        return int(self.cfg_model["grid"]["n_levels"])

    def anchor_kf_for_submap(self, s: int) -> int:
        return self._anchor_kf[s]

    def submap_id_for_kf(self, kf_id: int) -> int:
        return self._kf_to_submap[kf_id]

    def num_keyframes_in_submap(self, s: int) -> int:
        return sum(1 for x in self._kf_to_submap if x == s)

    def submap_shapes(self, s: int) -> List[Tuple[int, ...]]:
        return self._submap_shapes[s]

    # -- construction --------------------------------------------------------
    def add_submap(self, local_bound, Rws=None, tws=None, num_poses: Optional[int] = None):
        """Append a submap with the given local bound and world pose."""
        bound_np = np.asarray(local_bound, np.float32)
        K = max(int(num_poses if num_poses is not None else self.max_kfs), self.max_kfs)
        self.max_kfs = K
        Rws = np.eye(3, dtype=np.float32) if Rws is None else np.asarray(Rws, np.float32)
        tws = np.zeros(3, np.float32) if tws is None \
            else np.asarray(tws, np.float32).reshape(3)
        shapes = _level_shapes(bound_np, self.cfg_model["grid"], self.num_levels)
        self._submap_shapes.append(shapes)
        self._anchor_kf.append(self.curr_kf_id + 1)
        self.curr_submap_id = self.num_submaps - 1
        if self._can_insert_in_place(shapes, K):
            self._insert_submap_slot(bound_np, Rws, tws, shapes)
        else:
            self._rebuild_params(bound_np, Rws, tws)

    def _can_insert_in_place(self, shapes, K: int) -> bool:
        """A free slot exists, the keyframe axis is long enough and the padded
        shapes cover the new submap's."""
        p = self.params
        if p is None or self.capacity is None:
            return False
        if self.num_submaps > p.capacity or K > p.max_kfs_per_submap:
            return False
        return all(n <= pad for level in range(self.num_levels)
                   for n, pad in zip(shapes[level], p.pad_spatial[level]))

    @torch.no_grad()
    def _insert_submap_slot(self, bound_np, Rws, tws, shapes):
        """Write the slot in place; its grids are already zero."""
        s = self.curr_submap_id
        p = self.params
        for level in range(self.num_levels):
            p.sizes[level][s] = torch.as_tensor(shapes[level], dtype=torch.int32)
        p.bounds[s] = torch.as_tensor(bound_np)
        p.Rws[s] = torch.as_tensor(Rws)
        p.tws[s] = torch.as_tensor(tws)
        p.sub_rot_corr[s] = 0.0
        p.sub_trans_corr[s] = 0.0
        p.active[s] = 1.0
        p.num_submaps = self.num_submaps

    @torch.no_grad()
    def _rebuild_params(self, new_bound, new_Rws, new_tws):
        """Reallocate the stacked storage to hold the new submap, with spare
        slots when ``capacity`` is set (2x growth once exceeded), and copy the
        old slots over."""
        S_live = self.num_submaps
        old = self.params
        if self.capacity is None:
            S = S_live
        else:
            S = max(self.capacity, S_live)
            if old is not None and S_live > old.capacity:
                S = max(S, 2 * old.capacity)
            self.capacity = S
        K, L, dev = self.max_kfs, self.num_levels, self.device
        fdim = int(self.cfg_model["grid"]["feature_dim"])
        feat_dtype = getattr(torch, self.cfg_model["grid"].get("feature_dtype", "float32"))
        pads = [tuple(max(sh[level][k] for sh in self._submap_shapes) for k in range(3))
                for level in range(L)]

        def grown(old_t, shape, fill=0.0, dtype=torch.float32):
            out = torch.full(shape, fill, dtype=dtype, device=dev)
            if old_t is not None:
                out[tuple(slice(0, n) for n in old_t.shape)] = old_t
            return out

        features, stability, sizes = [], [], []
        for level in range(L):
            features.append(grown(None if old is None else old.features[level],
                                  (S, *pads[level], fdim), dtype=feat_dtype))
            stability.append(grown(None if old is None else old.stability[level],
                                   (S, *pads[level], 1), dtype=feat_dtype))
            # Spare slots get size 1: they still interpolate to finite values.
            sz = torch.ones((S, 3), dtype=torch.int32)
            for s in range(S_live):
                sz[s] = torch.as_tensor(self._submap_shapes[s][level])
            sizes.append(sz.to(dev))
        eye = torch.eye(3, dtype=torch.float32)
        Rws = eye.expand(S, 3, 3).clone()
        tws = torch.zeros((S, 3))
        # Spare slots get a unit bound: a zero extent would divide by zero.
        bounds = torch.tensor([0.0, 1.0]).expand(S, 3, 2).clone()
        if old is not None:
            n = old.capacity
            Rws[:n], tws[:n], bounds[:n] = old.Rws.cpu(), old.tws.cpu(), old.bounds.cpu()
        Rws[S_live - 1] = torch.as_tensor(new_Rws)
        tws[S_live - 1] = torch.as_tensor(new_tws)
        bounds[S_live - 1] = torch.as_tensor(new_bound)
        Rsk = eye.expand(S, K, 3, 3).clone().to(dev)
        if old is not None:
            Rsk[:old.capacity, :old.max_kfs_per_submap] = old.Rsk
        kf_map = torch.zeros((S * K,), dtype=torch.int32)
        kf_loc = torch.zeros((S * K,), dtype=torch.int32)
        for kf, sub in enumerate(self._kf_to_submap):
            kf_map[kf] = sub
            kf_loc[kf] = kf - self._anchor_kf[sub]

        if self._pinned_decoder is not None:
            decoder = self._pinned_decoder
        elif old is not None:
            decoder = old.decoder
        else:
            decoder = decoder_from_config(self.cfg_model, torch.Generator().manual_seed(0),
                                          self.dtype, dev)
        settings = _settings(self.cfg_model)
        dcfg = self.cfg_model.get("decoder", {"type": "none"})
        self.params = GridAtlasParams(
            features, stability, decoder,
            sub_rot_corr=grown(None if old is None else old.sub_rot_corr, (S, 3)),
            sub_trans_corr=grown(None if old is None else old.sub_trans_corr, (S, 3)),
            Rws=Rws.to(dev), tws=tws.to(dev),
            kf_rot_corr=grown(None if old is None else old.kf_rot_corr, (S, K, 3)),
            kf_trans_corr=grown(None if old is None else old.kf_trans_corr, (S, K, 3)),
            Rsk=Rsk, tsk=grown(None if old is None else old.tsk, (S, K, 3)),
            bounds=bounds.to(dev), sizes=sizes,
            ignore_level=torch.zeros((L,), dtype=torch.float32, device=dev),
            active=(torch.arange(S) < S_live).to(torch.float32).to(dev),
            kf_to_submap=kf_map.to(dev), kf_to_local=kf_loc.to(dev),
            num_submaps=S_live, cell_sizes=settings["cell_sizes"],
            pos_invariant=settings["pos_invariant"],
            decoder_fixed=bool(dcfg.get("fix", True)), decode_impl=settings["decode_impl"])

    @torch.no_grad()
    def add_kf(self, Rsk=None, tsk=None) -> int:
        """Add a keyframe to the current submap at (Rsk, tsk) in its frame."""
        if self.curr_submap_id < 0:
            raise RuntimeError("add_kf before any add_submap: create a submap first")
        s = self.curr_submap_id
        kf_global = self.curr_kf_id + 1
        kf_local = kf_global - self._anchor_kf[s]
        if kf_local >= self.max_kfs:
            raise ValueError(f"submap {s} exceeded max_kfs_per_submap={self.max_kfs}")
        self._kf_to_submap.append(s)
        p = self.params
        p.Rsk[s, kf_local] = torch.eye(3) if Rsk is None \
            else torch.as_tensor(np.asarray(Rsk, np.float32))
        p.tsk[s, kf_local] = torch.zeros(3) if tsk is None \
            else torch.as_tensor(np.asarray(tsk, np.float32).reshape(3))
        p.kf_rot_corr[s, kf_local] = 0.0
        p.kf_trans_corr[s, kf_local] = 0.0
        p.kf_to_submap[kf_global] = s
        p.kf_to_local[kf_global] = kf_local
        self.curr_kf_id = kf_global
        return kf_global

    @torch.no_grad()
    def set_kf_pose(self, kf_id: int, Rsk, tsk):
        s = self.submap_id_for_kf(kf_id)
        loc = kf_id - self._anchor_kf[s]
        p = self.params
        p.Rsk[s, loc] = torch.as_tensor(np.asarray(Rsk, np.float32))
        p.tsk[s, loc] = torch.as_tensor(np.asarray(tsk, np.float32).reshape(3))
        p.kf_rot_corr[s, loc] = 0.0
        p.kf_trans_corr[s, loc] = 0.0

    @torch.no_grad()
    def set_submap_pose(self, s: int, Rws, tws):
        p = self.params
        p.Rws[s] = torch.as_tensor(np.asarray(Rws, np.float32))
        p.tws[s] = torch.as_tensor(np.asarray(tws, np.float32).reshape(3))
        p.sub_rot_corr[s] = 0.0
        p.sub_trans_corr[s] = 0.0

    @torch.no_grad()
    def set_submap_pose_correction(self, s: int, dr, dt):
        p = self.params
        p.sub_rot_corr[s] = torch.as_tensor(np.asarray(dr, np.float32).reshape(3))
        p.sub_trans_corr[s] = torch.as_tensor(np.asarray(dt, np.float32).reshape(3))

    def set_decoder(self, decoder, fixed: Optional[bool] = None):
        """Install a (pretrained) shared decoder ((W, b), ...), moved to the
        atlas's device; it persists across later rebuilds.  ``fixed``
        optionally freezes it (config ``decoder.fix``)."""
        decoder = tuple((torch.as_tensor(W).detach().to(self.device).clone(),
                         torch.as_tensor(b).detach().to(self.device).clone())
                        for W, b in decoder)
        self._pinned_decoder = decoder
        if fixed is not None:
            self.cfg_model.setdefault("decoder", {})["fix"] = bool(fixed)
        if self.params is not None:
            self.params.decoder = decoder
            if fixed is not None:
                self.params.decoder_fixed = bool(fixed)

    # -- views -----------------------------------------------------------------
    def get_submap(self, s: int) -> GridNet:
        """Submap s as a GridNet of contiguous copies at its logical shapes."""
        return self.params.submap(s, self._submap_shapes[s], self._anchor_kf[s])

    def copy_to(self, device) -> "GridAtlas":
        """An independent copy of the atlas (its tensors, structure and
        alignment coordinates) on ``device``."""
        device = _check_device(device)

        def moved(v):
            if isinstance(v, torch.Tensor):
                return v.detach().to(device).clone()
            if isinstance(v, (list, tuple)):
                return type(v)(moved(x) for x in v)
            if isinstance(v, dict):
                return {k: moved(x) for k, x in v.items()}
            return v

        out = copy.copy(self)
        for k, v in vars(self).items():
            if k != "params":
                setattr(out, k, moved(v))
        out.device = device
        if self.params is not None:
            out.params = self.params.replace(**{k: moved(v) for k, v in vars(self.params).items()
                                                if isinstance(v, (torch.Tensor, list, tuple))})
        return out

    def set_submap(self, s: int, grid: GridNet):
        self.params.with_submap(s, grid)

    def set_submap_poses(self, s: int, grid: GridNet):
        self.params.with_submap_poses(s, grid)

    @torch.no_grad()
    def global_bound(self) -> np.ndarray:
        """World AABB (3, 2) of the live submaps' transformed bound corners."""
        R, t = (a.cpu().numpy() for a in self.params.updated_submap_poses())
        bounds = self.params.bounds.cpu().numpy()
        corners_all = []
        for s in range(self.num_submaps):
            b = bounds[s]
            corners = np.array([[b[0, i], b[1, j], b[2, k]] for i in range(2)
                                for j in range(2) for k in range(2)], np.float32)
            corners_all.append(corners @ R[s].T + t[s])
        corners_all = np.concatenate(corners_all)
        return np.stack([corners_all.min(0), corners_all.max(0)], axis=1)

    @torch.no_grad()
    def consolidated_grid(self, chunk: int = 1 << 18, structural_only: bool = False,
                          bound=None) -> GridNet:
        """Resample the atlas's masked-average field onto ONE world-frame
        GridNet (fuse-then-mesh).

        Trilinear interpolation is linear in the tables and every grid uses
        cell-centred nodes, so a grid whose node features are the atlas's
        feature field at those nodes reproduces the field exactly where the
        submap poses are identity, and to O(cell * pose delta) under small
        corrections.  Meshing it costs one query a point instead of one per
        live submap.  The nodes are queried in chunks of ``chunk`` on the
        device (features and stability, every live slot).

        ``structural_only``: zero grids of the same shapes, no query.
        ``bound``: the world bound (default :meth:`global_bound`)."""
        p = self.params
        bound_w = np.asarray(bound, np.float32) if bound is not None else self.global_bound()
        grid_cfg = self.cfg_model["grid"]
        dev, fdim = self.device, p.fdim
        feats, stabs, cells = [], [], []
        for level, shape in enumerate(_level_shapes(bound_w, grid_cfg, self.num_levels)):
            cells.append(float(grid_cfg["base_cell_size"])
                         / float(grid_cfg["per_level_scale"]) ** level)
            f = torch.zeros((*shape, fdim), dtype=p.features[level].dtype, device=dev)
            st = torch.zeros((*shape, 1), dtype=p.stability[level].dtype, device=dev)
            if not structural_only:
                verts = node_centres(bound_w, shape, dev)
                f_flat, st_flat = f.view(-1, fdim), st.view(-1, 1)
                for start in range(0, verts.shape[0], chunk):
                    pts = verts[start:start + chunk]
                    f_flat[start:start + pts.shape[0]] = \
                        p.query_feature(pts)[:, level * fdim:(level + 1) * fdim]
                    st_flat[start:start + pts.shape[0]] = \
                        p.query_stability(pts)[:, level:level + 1]
            feats.append(f)
            stabs.append(st)
        return GridNet(
            feats, stabs,
            None if p.decoder is None else [(W.clone(), b.clone()) for W, b in p.decoder],
            rot_corr=torch.zeros((1, 3), device=dev), trans_corr=torch.zeros((1, 3), device=dev),
            Rwk=torch.eye(3, device=dev)[None], twk=torch.zeros((1, 3), device=dev),
            bound=torch.as_tensor(bound_w, device=dev), ignore_level=p.ignore_level.clone(),
            cell_sizes=tuple(cells), pos_invariant=p.pos_invariant, decoder_fixed=True,
            optimize_pose=False, decode_impl=p.decode_impl)

    @torch.no_grad()
    def check_submap_intersection(self, src: int, dst: int, overlap_thresh=1e-2) -> bool:
        """Whether more than ``overlap_thresh`` of src's finest-level cell
        centres fall inside dst's bound (in chunks of 2^20 centres)."""
        p = self.params
        verts = interp.vertex_positions(self._submap_shapes[src][-1], p.bounds[src])
        R, t = p.updated_submap_poses()
        hits = torch.zeros((), dtype=torch.float32, device=self.device)
        chunk = 1 << 20
        for start in range(0, verts.shape[0], chunk):
            world = se3.transform_points_to(verts[start:start + chunk], R[src], t[src])
            local = se3.transform_points_from(world, R[dst], t[dst])
            hits = hits + se3.coords_in_bound(local, p.bounds[dst]).sum()
        return float(hits) / verts.shape[0] > overlap_thresh

    # -- alignment coordinates -------------------------------------------------
    @torch.no_grad()
    def precompute_coordinates_for_alignment(self, norm_thresh=1e-5,
                                             max_points: Optional[int] = None, seed: int = 0):
        """Per (submap, level): the cell centres of the submap's grid whose
        multi-level feature norm exceeds ``norm_thresh``, in its frame.

        Returns {(s, level): (coords (P, 3), valid (P, 1))}, P the same for
        every submap of a level, so the pair batches of alignment stack.

        ``max_points=None``: every such vertex; P is the largest submap's
        count, and a smaller set is tiled to P with its repeats marked
        invalid (a submap with none gives P invalid zero rows).  With
        ``max_points`` (the SLAM Fuser's path), P is min(max_points, the
        largest submap's vertex count), a shape known without the data, and
        each submap keeps a random P-subset of its vertices over the
        threshold (the top P of (over threshold) * (1 + U(0, 1)) drawn from a
        ``torch.Generator`` seeded by ``seed``), padded with invalid rows when
        it has fewer; the norms are taken on the device in chunks of 2^19
        vertices.  Either way the JAX package's selection in distribution,
        the capped one not in its bits."""
        out = {}
        p = self.params
        L, S = self.num_levels, self.num_submaps
        if max_points is None:
            for level in range(L):
                per_submap = []
                for s in range(S):
                    verts = interp.vertex_positions(self._submap_shapes[s][level], p.bounds[s])
                    norm = torch.linalg.vector_norm(p.query_feature_submap(s, verts), dim=1)
                    per_submap.append(verts[norm > norm_thresh])
                P = max(max((len(c) for c in per_submap), default=0), 1)
                for s, coords in enumerate(per_submap):
                    n = len(coords)
                    valid = torch.zeros((P, 1), dtype=torch.float32, device=self.device)
                    if n == 0:
                        padded = torch.zeros((P, 3), dtype=torch.float32, device=self.device)
                    else:
                        padded = coords.repeat(-(-P // n), 1)[:P]
                        valid[:n] = 1.0
                    out[(s, level)] = (padded.contiguous(), valid)
            self._set_alignment_coords(out)
            return out
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for level in range(L):
            P = self.alignment_points_per_level(max_points)[level]
            for s in range(S):
                out[(s, level)] = self._capped_alignment_coords(s, level, P, norm_thresh, gen)
        self._set_alignment_coords(out)
        return out

    def _capped_alignment_coords(self, s, level, P, norm_thresh, gen, chunk=1 << 19):
        p = self.params
        verts = interp.vertex_positions(self._submap_shapes[s][level], p.bounds[s])
        norm = torch.cat([torch.linalg.vector_norm(p.query_feature_submap(s, v), dim=1)
                          for v in verts.split(chunk)])
        score = (norm > norm_thresh).to(torch.float32) * (
            1.0 + torch.rand(norm.shape, generator=gen, device=self.device))
        if verts.shape[0] < P:  # a smaller submap in a mixed atlas
            pad = P - verts.shape[0]
            verts = torch.cat([verts, verts.new_zeros((pad, 3))])
            score = torch.cat([score, score.new_zeros((pad,))])
        idx = torch.topk(score, P).indices
        return verts[idx], (score[idx] >= 1.0).to(torch.float32)[:, None]

    def _set_alignment_coords(self, out):
        self._coords_for_alignment = out
        self._coords_stacked = {
            level: (torch.stack([out[(s, level)][0] for s in range(self.num_submaps)]),
                    torch.stack([out[(s, level)][1] for s in range(self.num_submaps)]))
            for level in range(self.num_levels)}

    def alignment_coords_stacked(self, level: int):
        """(S, P, 3) coordinates and (S, P, 1) validity of one level."""
        return self._coords_stacked[level]

    def coordinates_for_alignment(self, s: int, level: int):
        return self._coords_for_alignment[(s, level)]

    def alignment_points_per_level(self, max_points: int) -> List[int]:
        """Per level, the capped alignment point count P: min(max_points, the
        largest submap's vertex count), from the shapes alone."""
        return [max(min(max_points, max(int(np.prod(self._submap_shapes[s][level]))
                                        for s in range(self.num_submaps))), 1)
                for level in range(self.num_levels)]


def grid_atlas_mask(params: GridAtlasParams, features: bool = False, stability: bool = False,
                    decoder: bool = False, submap_pose: bool = False, kf_pose: bool = False,
                    anchor_first_submap: bool = True, feature_lr: float = 1.0,
                    submap_pose_lr: float = 1.0, kf_pose_lr: float = 1.0,
                    level: Optional[int] = None) -> Mask:
    """The train mask of an atlas (``models/base.py::Mask``), keyed by
    :meth:`GridAtlasParams.named_parameters`: 0 freezes a tensor, a positive
    value trains it with the learning rate scaled by that value, so each
    group's rate is its multiplier on a masked Adam of base rate 1.
    ``anchor_first_submap`` keeps submap 0 at its pose; ``level=l`` trains
    features and stability of level l only (None, or l >= the level count,
    means all).  Submap pose rows are (S, 1) over the stacked slots."""
    dev = params.device

    def full(v, shape=()):
        return torch.full(shape, float(v), dtype=torch.float32, device=dev)

    L = params.num_levels
    sel = ([1.0 if l == level else 0.0 for l in range(L)]
           if level is not None and level < L else [1.0] * L)
    sub_val = float(submap_pose) * submap_pose_lr
    sub = full(sub_val, (params.capacity, 1))
    if anchor_first_submap and params.capacity > 0:
        sub[0] = 0.0
    if params.capacity <= int(anchor_first_submap):
        sub_val = 0.0   # no row left to train
    values = {}   # name -> the entry's host value
    for name, _ in params.named_parameters():
        head, _, idx = name.partition(".")
        if head == "features":
            values[name] = float(features) * feature_lr * sel[int(idx)]
        elif head == "stability":
            values[name] = float(stability) * feature_lr * sel[int(idx)]
        elif head == "decoder":
            values[name] = float(decoder)
        elif head.startswith("sub_"):
            values[name] = sub_val
        else:
            values[name] = float(kf_pose) * kf_pose_lr
    return Mask({k: sub if k.startswith("sub_") else full(v) for k, v in values.items()},
                (k for k, v in values.items() if v != 0))


def node_centres(bound_w: np.ndarray, shape: Sequence[int], device) -> torch.Tensor:
    """(prod(shape), 3) cell centres of a grid of ``shape`` over ``bound_w``,
    x slowest, made on ``device`` in float64 and rounded once to float32, as
    numpy makes them in the JAX package."""
    axes = []
    for k in range(3):
        lo = float(np.float32(bound_w[k, 0]))
        ext = float(np.float32(bound_w[k, 1]) - np.float32(bound_w[k, 0]))
        i = torch.arange(int(shape[k]), dtype=torch.float64, device=device)
        axes.append(lo + (i + 0.5) * ext / int(shape[k]))
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1).to(torch.float32)
