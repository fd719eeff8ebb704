"""MISO hierarchical latent-space submap alignment (port of
``miso_tpu/align/miso.py``).

Adam over the submap pose corrections (submap 0 anchored) minimises, for
each pair of overlapping submaps, the difference between the source
submap's interpolated features (or decoded SDF) at its own grid vertices and
the destination submap's at the same points moved into its frame, coarse
level to fine, then optionally in SDF space.

The default pair loss (:func:`make_flat_pair_loss`) puts every pair's
points in one batch of (pair row, point): each row gathers its source and
destination poses once and moves its points by broadcasting over them
(:meth:`FlatPairLoss.to_destination`), so the poses' gradient comes back as
sums over each row's points and a gather backward into the pair rows; the
destination query is one slot-id interp call a level over the atlas's
stacked storage (``GridAtlasParams.query_feature_per_point``; the slot-id
kernels on the card), and the per-pair means come from sums over each row.
The source-side terms do not depend on the poses, so
:meth:`FlatPairLoss.precompute_src` computes them once per alignment call.
The flat axis is not chunked: at the sizes the repo runs (one to a few
pairs of 2^15 points or fewer after subsampling) its tensors take a few MB.
The unrolled per-pair losses (``pairwise_loss_*``, ``vmap_pairs=False``)
query one slot at a time and serve as the reference of the flat one.

InfoNCE's per-pair softmax is not a sum over points, so the flat loss
refuses it and the hierarchical alignment sends it through
:func:`make_vmapped_pair_loss` (the JAX package's vmap over the pair axis):
every pair's points go through the same per-point slot-id queries, and each
pair keeps its own (N, N) softmax, one batched product for all pairs.

Randomness: a pair's subsample is drawn from a ``torch.Generator`` seeded by
(seed, src, dst) (:class:`PairGenerators`), fresh at every iteration: the
JAX package's distribution, not its bits.

The pair axis may be sharded over the ranks of a mesh
(``align_multiple_submaps_hierarchical(mesh=, pair_axis=)``,
``parallel/sharding.py::shard_pair_ctx``): each rank evaluates its rows of
the padded pair batch, and the pair losses and the poses' gradient are
summed over the ranks (pair losses add), which gives the unsharded result.

Not ported, and raising where a call asks for them: the scanned solve, its
segments, the solve and loss caches and ``aot_only`` (TPU dispatch and
compile means, with no counterpart).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from miso_tpu_torch.losses.common import gm_weighted_sq, info_nce_loss
from miso_tpu_torch.models.base import relative_param_change
from miso_tpu_torch.models.grid_atlas import GridAtlas, GridAtlasParams, grid_atlas_mask
from miso_tpu_torch.ops import se3
from miso_tpu_torch.parallel.sharding import shard_pair_ctx
from miso_tpu_torch.train.optim import masked_adam_init
from miso_tpu_torch.train.trainer import make_train_step
from miso_tpu_torch.utils.profiling import span, synchronize

class PairGenerators:
    """One ``torch.Generator`` per (src, dst) pair on ``device``, seeded by
    (seed, src, dst), so a pair's draws do not depend on its row in the
    pair batch or on the inert pad pairs."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gens: Dict[Tuple[int, int], torch.Generator] = {}

    def get(self, src: int, dst: int) -> torch.Generator:
        key = (int(src), int(dst))
        if key not in self._gens:
            state = np.random.SeedSequence([self.seed, *key]).generate_state(1, np.uint64)[0]
            self._gens[key] = torch.Generator(device=self.device).manual_seed(
                int(state) & 0x7FFF_FFFF_FFFF_FFFF)
        return self._gens[key]


class PairContext(NamedTuple):
    """A batch of pairs: src_ids, dst_ids (P,) int32; coords (P, N, 3) source
    submap-frame points; valid (P, N, 1); ``pairs`` the same (src, dst) ids on
    the host; after :meth:`FlatPairLoss.precompute_src`, the source-side
    values (P, N, C) and mask (P, N, 1)."""
    src_ids: torch.Tensor
    dst_ids: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    pairs: Tuple[Tuple[int, int], ...]
    src_vals: Optional[torch.Tensor] = None
    src_mask: Optional[torch.Tensor] = None


def pair_context(atlas: GridAtlas, level: int, pairs: Sequence[Tuple[int, int]],
                 rows: Optional[int] = None) -> PairContext:
    """The pair batch of ``pairs`` at ``level`` from the atlas's alignment
    coordinates (:meth:`GridAtlas.precompute_coordinates_for_alignment`):
    each pair's source coordinates, padded to ``rows`` pairs with inert ones
    (src = dst = 0, no valid point)."""
    dev = atlas.device
    padded = list(pairs) + [(0, 0)] * max((rows or 0) - len(pairs), 0)
    src = torch.tensor([s for s, _ in padded], dtype=torch.int32, device=dev)
    dst = torch.tensor([d for _, d in padded], dtype=torch.int32, device=dev)
    live = (torch.arange(len(padded), device=dev) < len(pairs)).to(torch.float32)
    C, V = atlas.alignment_coords_stacked(level)
    return PairContext(src, dst, C[src.long()], V[src.long()] * live[:, None, None],
                       tuple(padded))


def _pair_points(params: GridAtlasParams, coords_from, src: int, dst: int):
    """Source-submap coordinates -> world -> destination submap."""
    R, t = params.updated_submap_poses()
    world = se3.transform_points_to(coords_from, R[src], t[src])
    return se3.transform_points_from(world, R[dst], t[dst])


def _view_queries(params: GridAtlasParams, s: int):
    """Slot s's queries at its logical size (the JAX package's unpadded
    GridNet view gives the same values)."""
    return {"feature": lambda x: params.query_feature_submap(s, x),
            "stability": lambda x: params.query_stability_submap(s, x),
            "sdf": lambda x: params.forward_submap(s, x),
            "bound": params.bounds[s]}


def _subsample(coords_from, valid_from, gen, subsample_points):
    if subsample_points is not None and gen is not None:
        n = coords_from.shape[0]
        idx = torch.randperm(n, generator=gen, device=coords_from.device)[:min(subsample_points, n)]
        return coords_from[idx], valid_from[idx]
    return coords_from, valid_from


def _pair_mask(qf, qt, coords_from, coords_to, valid_from, use_bound, stability_thresh):
    mask = valid_from
    if use_bound:
        mask = mask * se3.coords_in_bound(coords_to, qt["bound"])
    if stability_thresh > 0:
        mu_to = qt["stability"](coords_to)[:, :1]
        mu_from = qf["stability"](coords_from)[:, :1]
        mask = mask * (mu_to > stability_thresh) * (mu_from > stability_thresh)
    return mask


def _latent_pair_core(params, qf, qt, src, dst, level, coords_from, valid_from, align_loss,
                      use_bound, stability_thresh, trunc_factor, gen, subsample_points):
    """Latent residual of one pair over channels [0, F * (level + 1))."""
    end_ch = params.fdim * (level + 1)
    coords_from, valid_from = _subsample(coords_from, valid_from, gen, subsample_points)
    coords_to = _pair_points(params, coords_from, src, dst)
    mask = _pair_mask(qf, qt, coords_from, coords_to, valid_from, use_bound, stability_thresh)
    if trunc_factor is not None:
        sdf_from = qf["sdf"](coords_from)
        mask = mask * (torch.abs(sdf_from) < trunc_factor * params.cell_sizes[level])
    f_from = qf["feature"](coords_from)[:, :end_ch]
    f_to = qt["feature"](coords_to)[:, :end_ch]
    c = f_from - f_to
    count = torch.clamp(torch.sum(mask), min=1.0)
    if align_loss == "L2":
        return torch.sum(mask * c ** 2) / (count * end_ch)
    if align_loss == "L1":
        return torch.sum(mask[:, 0] * torch.linalg.vector_norm(c, dim=1)) / count
    if align_loss == "cos":
        num = torch.sum(f_from * f_to, dim=1, keepdim=True)
        den = (torch.linalg.vector_norm(f_from, dim=1, keepdim=True)
               * torch.linalg.vector_norm(f_to, dim=1, keepdim=True))
        return torch.sum(mask * (1.0 - num / torch.clamp(den, min=1e-8))) / count
    if align_loss == "InfoNCE":
        return info_nce_loss(f_from, f_to, mask)
    raise ValueError(f"Invalid align loss: {align_loss}")


def _sdf_pair_core(params, qf, qt, src, dst, coords_from, valid_from, align_loss, use_bound,
                   stability_thresh, gm_scale_sdf, gen, subsample_points):
    """SDF residual of one pair: both submaps' decoded fields at the shared
    points."""
    coords_from, valid_from = _subsample(coords_from, valid_from, gen, subsample_points)
    coords_to = _pair_points(params, coords_from, src, dst)
    mask = _pair_mask(qf, qt, coords_from, coords_to, valid_from, use_bound, stability_thresh)
    c = qf["sdf"](coords_from) - qt["sdf"](coords_to)
    count = torch.clamp(torch.sum(mask), min=1.0)
    if align_loss == "L2":
        return torch.sum(mask * c ** 2) / count
    if align_loss == "L1":
        return torch.sum(mask[:, 0] * torch.linalg.vector_norm(c, dim=1)) / count
    if align_loss == "GM":
        return torch.sum(mask * gm_weighted_sq(c, gm_scale_sdf)) / count
    raise ValueError(f"Invalid align loss: {align_loss}")


def pairwise_loss_latent(params: GridAtlasParams, atlas: GridAtlas, src: int, dst: int,
                         level: int, coords_from, valid_from, align_weight=3000.0,
                         align_loss="L2", use_bound=True, stability_thresh=0.0,
                         trunc_factor=None, key=None, subsample_points=None):
    """Latent residual of one pair (the unrolled path).  ``coords_from``
    (P, 3) are src's alignment coordinates at ``level``, ``valid_from``
    (P, 1) their pad mask; ``key`` a generator for the subsample."""
    loss = _latent_pair_core(params, _view_queries(params, src), _view_queries(params, dst),
                             src, dst, level, coords_from, valid_from, align_loss, use_bound,
                             stability_thresh, trunc_factor, key, subsample_points)
    return {f"align_latent_level{level}_{src}_{dst}": loss * align_weight}


def pairwise_loss_sdf(params: GridAtlasParams, atlas: GridAtlas, src: int, dst: int,
                      coords_from, valid_from, align_weight=3000.0, align_loss="L2",
                      use_bound=True, stability_thresh=0.0, gm_scale_sdf=0.1, key=None,
                      subsample_points=None):
    """SDF residual of one pair (the unrolled path), at src's alignment
    coordinates."""
    loss = _sdf_pair_core(params, _view_queries(params, src), _view_queries(params, dst),
                          src, dst, coords_from, valid_from, align_loss, use_bound,
                          stability_thresh, gm_scale_sdf, key, subsample_points)
    return {f"align_sdf_{src}_{dst}": loss * align_weight}


def _safe_norm(v, dim, keepdim=False):
    """The vector norm with a zero gradient (not NaN) at a zero vector: masked
    rows and exactly agreeing features give zero vectors, and 0 * NaN would
    poison the pose gradient."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    pos = sq > 0
    return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos.to(v.dtype)


class FlatPairLoss:
    """Every pair's points in one batch of pair rows (see the module note).

    ``loss(params, gens, ctx) -> {name: scalar}``, ``ctx`` a
    :class:`PairContext` (its source terms computed on the fly when it has
    none), ``gens`` a :class:`PairGenerators` for the subsample.  Counter on
    the class: ``.pose_rows``, the pose rows the last call gathered (two a
    pair row)."""

    pose_rows = 0

    def __init__(self, kind, level=None, align_weight=3000.0, align_loss="L2", use_bound=True,
                 stability_thresh=0.0, trunc_factor=None, gm_scale_sdf=0.1,
                 subsample_points=None):
        if align_loss == "InfoNCE":
            raise ValueError("InfoNCE alignment uses make_vmapped_pair_loss")
        latent = {"L2", "L1", "cos"}
        if align_loss not in (latent if kind == "latent" else {"L2", "L1", "GM"}):
            raise ValueError(f"Invalid align loss: {align_loss}")
        self.kind, self.level = kind, level
        self.align_weight, self.align_loss = align_weight, align_loss
        self.use_bound, self.stability_thresh = use_bound, stability_thresh
        self.trunc_factor, self.gm_scale_sdf = trunc_factor, gm_scale_sdf
        self.subsample_points = subsample_points
        self.name = f"align_latent_level{level}" if kind == "latent" else f"align_sdf_{align_loss}"

    def src_terms(self, params: GridAtlasParams, ids_src, pts):
        """The pose-independent source-side terms of each point: its values
        (features up to the level, or the decoded SDF) and mask factor
        (stability, truncation)."""
        smask = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=pts.device)
        if self.stability_thresh > 0:
            mu = params.query_stability_per_point(ids_src, pts)[:, :1]
            smask = smask * (mu > self.stability_thresh)
        if self.kind == "latent":
            if self.trunc_factor is not None:
                sdf = params.forward_per_point(ids_src, pts)
                smask = smask * (torch.abs(sdf) < self.trunc_factor
                                 * params.cell_sizes[self.level])
            vals = params.query_feature_per_point(ids_src, pts)[:, :params.fdim * (self.level + 1)]
        else:
            vals = params.forward_per_point(ids_src, pts)
        return vals, smask

    @torch.no_grad()
    def precompute_src(self, params: GridAtlasParams, ctx: PairContext) -> PairContext:
        """``ctx`` with the source terms of every point, computed once."""
        P, N, d = ctx.coords.shape
        vals, smask = self.src_terms(params, ctx.src_ids.repeat_interleave(N),
                                     ctx.coords.reshape(P * N, d))
        return ctx._replace(src_vals=vals.reshape(P, N, -1), src_mask=smask.reshape(P, N, 1))

    def to_destination(self, params: GridAtlasParams, R, t, src_ids, dst_ids, coords, mask):
        """Each pair row's (N, 3) points ``coords`` (P, N, 3) moved from its
        source submap's frame into its destination's, and ``mask`` (P, N, 1)
        times their destination bound test where ``use_bound``.  A row's two
        poses are gathered once and broadcast over its points, summed in
        ``se3.transform_points_by_id`` and ``inverse_transform_points_by_id``'s
        order (the same float32 operations, so the same bits); their gradient
        comes back as sums over each row's points and a gather backward into
        the 2P rows (``FlatPairLoss.pose_rows``)."""
        src, dst = src_ids.long(), dst_ids.long()
        Rs, ts, Rd, td = R[src], t[src], R[dst], t[dst]
        FlatPairLoss.pose_rows = 2 * src.shape[0]
        world = []
        for j in range(3):
            acc = ts[:, j, None]
            for k in range(3):
                acc = acc + Rs[:, j, k, None] * coords[..., k]
            world.append(acc)
        d = [world[k] - td[:, k, None] for k in range(3)]
        cols = []
        for j in range(3):
            acc = Rd[:, 0, j, None] * d[0]
            for k in range(1, 3):
                acc = acc + Rd[:, k, j, None] * d[k]
            cols.append(acc)
        coords_to = torch.stack(cols, dim=-1)
        if self.use_bound:
            b = params.bounds[dst][:, None]                                   # (P, 1, d, 2)
            inside = (coords_to >= b[..., 0]) & (coords_to <= b[..., 1])
            mask = mask * torch.all(inside, dim=-1, keepdim=True).to(coords.dtype)
        return coords_to, mask

    def point_sums(self, params: GridAtlasParams, R, t, src_ids, dst_ids, coords, mask,
                   src_vals):
        """Per-pair sums ((P,) masked terms, (P,) mask counts) of the pair
        rows: ``coords`` (P, N, 3), ``mask`` (P, N, 1), ``src_vals`` (P, N, C)."""
        P, N, d = coords.shape
        coords_to, mask = self.to_destination(params, R, t, src_ids, dst_ids, coords, mask)
        ids_dst = dst_ids.repeat_interleave(N)
        pts_to = coords_to.reshape(P * N, d)
        mask = mask.reshape(P * N, 1)
        src_vals = src_vals.reshape(P * N, -1)
        if self.stability_thresh > 0:
            mu = params.query_stability_per_point(ids_dst, pts_to)[:, :1]
            mask = mask * (mu > self.stability_thresh)

        def seg(x):  # (P * N,) per-point -> (P,) per-pair sums
            return x.reshape(P, N).sum(1)

        loss = self.align_loss
        if self.kind == "latent":
            f_to = params.query_feature_per_point(ids_dst, pts_to)[:, :src_vals.shape[-1]]
            c = src_vals - f_to
            if loss == "L2":
                term = seg(torch.sum(mask * c ** 2, dim=1))
            elif loss == "L1":
                term = seg(mask[:, 0] * _safe_norm(c, dim=1))
            else:
                num = torch.sum(src_vals * f_to, dim=1, keepdim=True)
                den = (_safe_norm(src_vals, dim=1, keepdim=True)
                       * _safe_norm(f_to, dim=1, keepdim=True))
                term = seg((mask * (1.0 - num / torch.clamp(den, min=1e-8)))[:, 0])
        else:
            c = src_vals - params.forward_per_point(ids_dst, pts_to)
            if loss == "L2":
                term = seg((mask * c ** 2)[:, 0])
            elif loss == "L1":
                term = seg(mask[:, 0] * _safe_norm(c, dim=1))
            else:
                term = seg((mask * gm_weighted_sq(c, self.gm_scale_sdf))[:, 0])
        return term, seg(mask[:, 0])

    def sample_rows(self, params: GridAtlasParams, gens: Optional[PairGenerators],
                    ctx: PairContext):
        """The pair rows a call evaluates: (coords (P, N, 3), mask (P, N, 1),
        source values (P, N, C)), each row's subsample drawn from its pair's
        generator where ``subsample_points`` is under N, the source terms
        computed here where ``ctx`` has none."""
        coords, valid = ctx.coords, ctx.valid
        src_vals, src_mask = ctx.src_vals, ctx.src_mask
        P, N = coords.shape[0], coords.shape[1]
        dev = coords.device
        M = self.subsample_points
        if M is not None and M < N and gens is not None:
            idx = torch.stack([torch.randperm(N, generator=gens.get(s, d), device=dev)[:M]
                               for s, d in ctx.pairs])
            rows = torch.arange(P, device=dev)[:, None]
            coords, valid = coords[rows, idx], valid[rows, idx]
            if src_vals is not None:
                src_vals, src_mask = src_vals[rows, idx], src_mask[rows, idx]
            N = M
        if src_vals is None:
            sv, sm = self.src_terms(params, ctx.src_ids.repeat_interleave(N),
                                    coords.reshape(P * N, coords.shape[-1]))
            src_vals, src_mask = sv.reshape(P, N, -1), sm.reshape(P, N, 1)
        return coords, valid * src_mask, src_vals

    def __call__(self, params: GridAtlasParams, gens: Optional[PairGenerators],
                 ctx: PairContext):
        coords, mask, src_vals = self.sample_rows(params, gens, ctx)
        R, t = params.updated_submap_poses()
        term, cnt = self.point_sums(params, R, t, ctx.src_ids, ctx.dst_ids, coords, mask,
                                    src_vals)
        counts = torch.clamp(cnt, min=1.0)
        if self.kind == "latent" and self.align_loss == "L2":
            counts = counts * (params.fdim * (self.level + 1))
        return {self.name: torch.sum(term / counts) * self.align_weight}


def make_flat_pair_loss(kind: str, level: Optional[int] = None, align_weight=3000.0,
                        align_loss="L2", use_bound=True, stability_thresh=0.0,
                        trunc_factor=None, gm_scale_sdf=0.1, subsample_points=None):
    """The batched pair loss over one flat (pairs x points) axis: a
    :class:`FlatPairLoss`."""
    return FlatPairLoss(kind, level, align_weight, align_loss, use_bound, stability_thresh,
                        trunc_factor, gm_scale_sdf, subsample_points)


class VmappedPairLoss:
    """Each pair's own loss, summed over the pairs (see the module note).

    Same context and call as :class:`FlatPairLoss` (``loss(params, gens,
    ctx)``, ``ctx`` a :class:`PairContext`), with no precomputed source terms:
    the pairs' points, subsampled per pair as the flat and unrolled losses
    draw them, go through the per-point queries in one batch; the poses move
    each pair's (N, 3) block by its own (src, dst) poses and every reduction
    stays per pair, so pair i gives the unrolled ``pairwise_loss_*`` of that
    pair.  An inert pad pair (no valid point) gives exactly 0."""

    def __init__(self, kind, level=None, align_weight=3000.0, align_loss="L2", use_bound=True,
                 stability_thresh=0.0, trunc_factor=None, gm_scale_sdf=0.1,
                 subsample_points=None):
        allowed = {"L2", "L1", "cos", "InfoNCE"} if kind == "latent" else {"L2", "L1", "GM"}
        if align_loss not in allowed:
            raise ValueError(f"Invalid align loss: {align_loss}")
        self.kind, self.level = kind, level
        self.align_weight, self.align_loss = align_weight, align_loss
        self.use_bound, self.stability_thresh = use_bound, stability_thresh
        self.trunc_factor, self.gm_scale_sdf = trunc_factor, gm_scale_sdf
        self.subsample_points = subsample_points
        self.name = f"align_latent_level{level}" if kind == "latent" else f"align_sdf_{align_loss}"

    def pair_losses(self, params: GridAtlasParams, gens: Optional[PairGenerators],
                    ctx: PairContext) -> torch.Tensor:
        """(P,) per-pair losses, unweighted."""
        coords, valid = ctx.coords, ctx.valid
        P, N, d = coords.shape
        dev = coords.device
        M = self.subsample_points
        if M is not None and gens is not None:
            # Drawn on the generators' device: CPU generators give a card run
            # the CPU run's draws.
            idx = torch.stack([torch.randperm(N, generator=gens.get(s, t),
                                              device=gens.device)[:min(M, N)]
                               for s, t in ctx.pairs]).to(dev)
            rows = torch.arange(P, device=dev)[:, None]
            coords, valid = coords[rows, idx], valid[rows, idx]
            N = idx.shape[1]
        src, dst = ctx.src_ids.long(), ctx.dst_ids.long()
        ids_src, ids_dst = ctx.src_ids.repeat_interleave(N), ctx.dst_ids.repeat_interleave(N)
        R, t = params.updated_submap_poses()
        coords_to = se3.transform_points_from(se3.transform_points_to(coords, R[src], t[src]),
                                              R[dst], t[dst])
        pts_to = coords_to.reshape(P * N, d)
        pts = coords.reshape(P * N, d)

        def per_pair(x):   # (P * N, C) -> (P, N, C)
            return x.reshape(P, N, x.shape[-1])

        mask = valid
        if self.use_bound:
            b = params.bounds[dst][:, None]                                   # (P, 1, d, 2)
            inside = (coords_to >= b[..., 0]) & (coords_to <= b[..., 1])
            mask = mask * torch.all(inside, dim=-1, keepdim=True).to(coords.dtype)
        if self.stability_thresh > 0:
            mu_to = per_pair(params.query_stability_per_point(ids_dst, pts_to)[:, :1])
            mu_from = per_pair(params.query_stability_per_point(ids_src, pts)[:, :1])
            mask = mask * (mu_to > self.stability_thresh) * (mu_from > self.stability_thresh)
        count = torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0)            # (P,)
        loss = self.align_loss
        if self.kind == "latent":
            end_ch = params.fdim * (self.level + 1)
            if self.trunc_factor is not None:
                sdf_from = per_pair(params.forward_per_point(ids_src, pts))
                mask = mask * (torch.abs(sdf_from) < self.trunc_factor
                               * params.cell_sizes[self.level])
                count = torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0)
            f_from = per_pair(params.query_feature_per_point(ids_src, pts)[:, :end_ch])
            f_to = per_pair(params.query_feature_per_point(ids_dst, pts_to)[:, :end_ch])
            if loss == "InfoNCE":
                return info_nce_loss(f_from, f_to, mask)
            c = f_from - f_to
            if loss == "L2":
                return torch.sum(mask * c ** 2, dim=(1, 2)) / (count * end_ch)
            if loss == "L1":
                return torch.sum(mask[..., 0] * _safe_norm(c, dim=-1), dim=1) / count
            num = torch.sum(f_from * f_to, dim=-1, keepdim=True)
            den = _safe_norm(f_from, dim=-1, keepdim=True) * _safe_norm(f_to, dim=-1, keepdim=True)
            return torch.sum(mask * (1.0 - num / torch.clamp(den, min=1e-8)), dim=(1, 2)) / count
        c = per_pair(params.forward_per_point(ids_src, pts)
                     - params.forward_per_point(ids_dst, pts_to))
        if loss == "L2":
            return torch.sum(mask * c ** 2, dim=(1, 2)) / count
        if loss == "L1":
            return torch.sum(mask[..., 0] * _safe_norm(c, dim=-1), dim=1) / count
        return torch.sum(mask * gm_weighted_sq(c, self.gm_scale_sdf), dim=(1, 2)) / count

    def __call__(self, params: GridAtlasParams, gens: Optional[PairGenerators],
                 ctx: PairContext):
        return {self.name: torch.sum(self.pair_losses(params, gens, ctx)) * self.align_weight}


def make_vmapped_pair_loss(kind: str, level: Optional[int] = None, align_weight=3000.0,
                           align_loss="L2", use_bound=True, stability_thresh=0.0,
                           trunc_factor=None, gm_scale_sdf=0.1, subsample_points=None):
    """The batched pair loss with each pair's reduction its own: a
    :class:`VmappedPairLoss` (every loss kind; InfoNCE only here)."""
    return VmappedPairLoss(kind, level, align_weight, align_loss, use_bound, stability_thresh,
                           trunc_factor, gm_scale_sdf, subsample_points)


def atlas_pose_trust_region_loss(params: GridAtlasParams, thresh_rad, thresh_m, weight=1e3):
    """Per-submap trust-region hinge on the pose-correction norms."""
    rot = torch.linalg.vector_norm(params.sub_rot_corr, dim=-1)
    tr = torch.linalg.vector_norm(params.sub_trans_corr, dim=-1)
    return {"trust_region_R": weight * torch.sum(torch.relu(rot - thresh_rad)),
            "trust_region_t": weight * torch.sum(torch.relu(tr - thresh_m))}


def _submap_poses_np(params: GridAtlasParams) -> np.ndarray:
    R, t = params.updated_submap_poses()
    T = np.zeros((R.shape[0], 4, 4), np.float32)
    T[:, 3, 3] = 1.0
    T[:, :3, :3] = R.detach().cpu().numpy()
    T[:, :3, 3] = t.detach().cpu().numpy()
    return T


def generic_align_multiple_submaps(
        atlas: GridAtlas, pair_loss_fn: Callable, num_iters=10, lr=1e-2,
        rel_change_thresh=0.0, submap_pairs: Optional[Sequence[Tuple[int, int]]] = None,
        check_intersection=True, pose_reg_weight=0.0, pose_thresh_rad=1.0,
        pose_thresh_m=1.0, verbose=False, save_iterations=False, seed=0, loss_ctx=None,
        batched_loss=False, aot_only=False, pair_axis=None):
    """Masked Adam over every submap's pose correction, submap 0 anchored
    and spare slots frozen, for ``num_iters + 1`` steps (the JAX package's
    count), stopping early once the relative change of the poses falls
    under ``rel_change_thresh`` (from the second step on).

    ``pair_loss_fn(params, src, dst, generator[, loss_ctx]) -> dict`` per
    pair, or with ``batched_loss`` ``pair_loss_fn(params, gens, loss_ctx)``
    once a step over every pair (``submap_pairs`` and the intersection test
    then belong to the caller).  Only the poses carry gradients; a
    non-finite total skips the step (the NaN guard).  Writes the poses into
    the atlas; returns timings and, with ``save_iterations``, the (S, 4, 4)
    submap poses before each step.

    ``pair_axis`` (a ``parallel/sharding.py::Axis``, batched losses only):
    ``loss_ctx`` holds this rank's rows of the pair batch; each term of the
    pair loss is summed over the axis, and the poses it reads pass the
    axis's ``pvary``, so their gradient is summed with it.
    """
    if aot_only:
        raise NotImplementedError("aot_only compiles the JAX package's scanned solve without "
                                  "running it, a TPU compile means with no counterpart here")
    params = atlas.params
    if not batched_loss:
        if submap_pairs is None:
            submap_pairs = [(i, j) for i in range(atlas.num_submaps)
                            for j in range(i + 1, atlas.num_submaps)]
        if check_intersection:
            submap_pairs = [(i, j) for (i, j) in submap_pairs
                            if atlas.check_submap_intersection(i, j)]
    dev = params.device
    if not batched_loss and not submap_pairs and pose_reg_weight <= 0:
        # Nothing to minimise: the JAX package's steps move no pose either.
        return {"cpu_time_sec": 0.0, "gpu_time_sec": 0.0, "steps": 0,
                "iteration_results": {}}
    pose = {"sub_rot_corr": params.sub_rot_corr.detach().clone().requires_grad_(),
            "sub_trans_corr": params.sub_trans_corr.detach().clone().requires_grad_()}
    row_mask = params.active.to(torch.float32).reshape(-1, 1).clone()
    row_mask[0] = 0.0
    mask = {k: row_mask for k in pose}
    opt_state = masked_adam_init(pose)
    gens = PairGenerators(seed, dev)

    def align_loss(pose, batch, key):
        p = params.replace(**pose)
        loss_dict = {}
        if batched_loss and pair_axis is not None:
            pv = params.replace(**{k: pair_axis.pvary(v) for k, v in pose.items()})
            loss_dict.update({k: pair_axis.psum(v)
                              for k, v in pair_loss_fn(pv, gens, loss_ctx).items()})
        elif batched_loss:
            loss_dict.update(pair_loss_fn(p, gens, loss_ctx))
        else:
            for s, d in submap_pairs:
                args = (p, s, d, gens.get(s, d)) + ((loss_ctx,) if loss_ctx is not None else ())
                loss_dict.update(pair_loss_fn(*args))
        if pose_reg_weight > 0:
            loss_dict.update(atlas_pose_trust_region_loss(p, pose_thresh_rad, pose_thresh_m,
                                                          pose_reg_weight))
        return loss_dict

    step = make_train_step(align_loss)
    iteration_results = {}
    t0 = time.perf_counter()
    prev = None
    steps = 0
    for it in range(num_iters + 1):
        if save_iterations:
            iteration_results[it] = _submap_poses_np(params.replace(**pose))
        pose, opt_state, tl, _ = step(pose, opt_state, None, None, mask, lr)
        steps += 1
        if rel_change_thresh > 0 or verbose:
            cur = {k: v.detach().clone() for k, v in pose.items()}
            rel = float(relative_param_change(cur, prev)) if prev is not None else np.inf
            prev = cur
            if verbose:
                print(f"AlignMulti iteration {it}: loss={float(tl):.2e} relchange={rel:.2e}")
            if rel < rel_change_thresh:
                break
    with torch.no_grad():
        params.sub_rot_corr.copy_(pose["sub_rot_corr"])
        params.sub_trans_corr.copy_(pose["sub_trans_corr"])
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    return {"cpu_time_sec": elapsed, "gpu_time_sec": elapsed, "steps": steps,
            "iteration_results": iteration_results}


def bundle_adjust_multiple_submaps(atlas: GridAtlas, dataset, loss_fn=None, num_epochs=10,
                                   pose_lr=1e-3, map_lr=1e-4, verbose=False, seed=0):
    """Joint refinement of every submap's features and stability, submap
    poses (submap 0 anchored) and keyframe poses, each group at its own rate
    (mask multipliers on a masked Adam of base rate 1), over ``num_epochs``
    batches ``dataset.sample(rng)`` drawn up front from
    ``np.random.default_rng(seed)`` (``train/trainer.py::make_train_scan``).
    ``loss_fn(params, batch, generator)`` defaults to the fusion loss.  The
    live slots are trimmed out, trained and scattered back."""
    from miso_tpu_torch.losses.fusion import fusion_loss
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.train.trainer import make_train_scan

    if loss_fn is None:
        loss_fn = make_loss(fusion_loss, loss_type="L2", weight_sdf=1.0, weight_eik=0.0,
                            weight_fs=0.1)
    dev = atlas.device
    params = atlas.params.trim(atlas.num_submaps).requires_grad_()
    mask = grid_atlas_mask(params, features=True, stability=True, submap_pose=True,
                           kf_pose=True, anchor_first_submap=True, feature_lr=map_lr,
                           submap_pose_lr=pose_lr, kf_pose_lr=pose_lr)
    opt_state = masked_adam_init(params)
    burst = make_train_scan(loss_fn, "adam")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    raw = [dataset.sample(rng) for _ in range(num_epochs)]
    batches = {k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in raw])).to(dev)
               for k in raw[0]}
    params, opt_state, tls = burst(params, opt_state, batches,
                                   torch.Generator(device=dev).manual_seed(seed), mask, 1.0)
    atlas.params.scatter_trimmed(params)
    tls = tls.cpu().numpy()
    if verbose:
        print(f"BA losses: {tls[::max(num_epochs // 5, 1)]}")
    elapsed = time.perf_counter() - t0
    return {"cpu_time_sec": elapsed, "gpu_time_sec": elapsed, "final_loss": float(tls[-1])}


def align_multiple_submaps_hierarchical(
        atlas: GridAtlas, level_iters=10, finetune_iters=10, level_thresh=0.0, lr=1e-2,
        align_weight=3000.0, align_loss="L2", use_bound=True, stability_thresh=0.0,
        subsample_points=None, latent_levels: Optional[Sequence[int]] = None,
        skip_finetune=False, submap_pairs=None, pose_reg_weight=0.0, pose_thresh_m=1.0,
        pose_thresh_rad=1.0, gm_scale_sdf=0.1, verbose=False, save_iterations=False, seed=0,
        vmap_pairs=True, mesh=None, pair_axis="data", max_align_points=None, aot_only=False):
    """Coarse-to-fine latent alignment over ``latent_levels`` (all by
    default), ``level_iters`` a level, then unless ``skip_finetune`` the SDF
    alignment for ``finetune_iters``, over the pairs of ``submap_pairs``
    (every pair by default) whose bounds intersect.

    ``vmap_pairs`` (the default): the flat batched loss
    (:func:`make_flat_pair_loss`; for InfoNCE the vmapped one,
    :func:`make_vmapped_pair_loss`) over the pair list padded to the next
    power of two of all pairs with inert pairs (src = dst = 0, no valid
    point: zero loss and gradient), as the JAX package pads it; False: the
    unrolled per-pair losses.  InfoNCE has no SDF form: with the finetune on
    it raises ``ValueError`` once the latent levels are done, as the JAX
    package does.  ``max_align_points`` caps the alignment
    coordinates per (submap, level) (the Fuser's ``align.max_points``); None
    takes every vertex over the norm threshold.

    ``mesh`` (a ``parallel/sharding.py::Mesh``): the batched losses' pair
    rows, padded to a multiple of the ``pair_axis`` size, are sharded over
    it (``shard_pair_ctx``); the result is the unsharded one.  The unrolled
    losses (``vmap_pairs=False``) do not shard, as in the JAX package.
    Returns per-stage timings.

    Spans (``utils/profiling.py::span``): ``miso.align`` holds the call and,
    inside it in turn, ``miso.align.precompute`` (the coordinate selection),
    ``miso.align.intersect`` (the pair tests) and, for each level,
    ``miso.align.ctx`` (its pair context and source terms) and
    ``miso.align.steps`` (its step loop, with the steps' ``miso.step`` spans);
    each phase that launches work ends with a synchronize inside its span.
    Counters on this function, of the last call: ``.pairs`` (live pairs),
    ``.pair_rows`` (rows of the padded pair batch), ``.points_per_step``
    (live pairs times a pair's points at the last level run) and ``.steps``
    (steps over every level).
    """
    if aot_only:
        raise NotImplementedError("aot_only compiles the JAX package's alignment without "
                                  "running it, a TPU compile means with no counterpart here")
    dev = atlas.device
    fn = align_multiple_submaps_hierarchical
    fn.pairs = fn.pair_rows = fn.points_per_step = fn.steps = 0
    with span("miso.align"):
        t_pre = time.perf_counter()
        with span("miso.align.precompute"):
            atlas.precompute_coordinates_for_alignment(max_points=max_align_points)
            synchronize(dev)
        info: Dict = {"precompute_sec": time.perf_counter() - t_pre}
        cpu_total = 0.0
        if latent_levels is None:
            latent_levels = range(atlas.num_levels)
        S = atlas.num_submaps
        pairs = submap_pairs if submap_pairs is not None else \
            [(i, j) for i in range(S) for j in range(i + 1, S)]
        with span("miso.align.intersect"):
            pairs = [(i, j) for (i, j) in pairs if atlas.check_submap_intersection(i, j)]
        if not pairs:
            # One submap or no overlapping pair: nothing to align.
            info["cpu_time_sec"] = info["gpu_time_sec"] = 0.0
            return info
        rows = 1 << max(S * (S - 1) // 2 - 1, 0).bit_length()
        fn.pairs, fn.pair_rows = len(pairs), rows
        ctx_secs: List[float] = []
        common = dict(lr=lr, submap_pairs=pairs, check_intersection=False,
                      pose_reg_weight=pose_reg_weight, pose_thresh_rad=pose_thresh_rad,
                      pose_thresh_m=pose_thresh_m, verbose=verbose,
                      save_iterations=save_iterations, batched_loss=vmap_pairs,
                      pair_axis=mesh.axis(pair_axis) if mesh is not None and vmap_pairs else None)

        def pair_ctx(level_, loss_fn):
            t_c = time.perf_counter()
            with span("miso.align.ctx"):
                ctx = pair_context(atlas, level_, pairs, rows)
                if mesh is not None:
                    ctx = shard_pair_ctx(ctx, mesh, pair_axis)
                if isinstance(loss_fn, FlatPairLoss):
                    ctx = loss_fn.precompute_src(atlas.params, ctx)
                synchronize(dev)
            ctx_secs.append(time.perf_counter() - t_c)
            return ctx

        def run_steps(loss_fn, ctx, points, **kw):
            with span("miso.align.steps"):
                out = generic_align_multiple_submaps(atlas, loss_fn, loss_ctx=ctx, **common,
                                                     **kw)
            fn.points_per_step = len(pairs) * points
            fn.steps += out["steps"]
            return out

        # The flat loss unless the loss needs each pair's own softmax (InfoNCE).
        make_batched = make_vmapped_pair_loss if align_loss == "InfoNCE" else make_flat_pair_loss
        for level in latent_levels:
            if vmap_pairs:
                pair_loss = make_batched("latent", level=level, align_weight=align_weight,
                                         align_loss=align_loss, use_bound=use_bound,
                                         stability_thresh=stability_thresh,
                                         subsample_points=subsample_points)
                ctx = pair_ctx(level, pair_loss)
            else:
                ctx = {s: atlas.coordinates_for_alignment(s, level) for s in range(S)}

                def pair_loss(p, s, d, key, ctx, _level=level):
                    cf, vf = ctx[s]
                    return pairwise_loss_latent(p, atlas, s, d, _level, cf, vf, align_weight,
                                                align_loss, use_bound, stability_thresh, None,
                                                key, subsample_points)
            level_info = run_steps(pair_loss, ctx, _pair_points_per_step(atlas, level,
                                                                         subsample_points),
                                   num_iters=level_iters, rel_change_thresh=level_thresh,
                                   seed=seed + level)
            cpu_total += level_info["cpu_time_sec"]
            info[f"hier_latent_level{level}_{align_loss}"] = level_info
        if not skip_finetune:
            sdf_align_loss = "L2" if align_loss == "cos" else align_loss
            finest = atlas.num_levels - 1
            if vmap_pairs:
                make_batched = (make_vmapped_pair_loss if sdf_align_loss == "InfoNCE"
                                else make_flat_pair_loss)
                pair_loss_sdf = make_batched("sdf", align_weight=align_weight,
                                             align_loss=sdf_align_loss, use_bound=use_bound,
                                             stability_thresh=stability_thresh,
                                             gm_scale_sdf=gm_scale_sdf,
                                             subsample_points=subsample_points)
                ctx = pair_ctx(finest, pair_loss_sdf)
            else:
                ctx = {s: atlas.coordinates_for_alignment(s, finest) for s in range(S)}

                def pair_loss_sdf(p, s, d, key, ctx):
                    cf, vf = ctx[s]
                    return pairwise_loss_sdf(p, atlas, s, d, cf, vf, align_weight,
                                             sdf_align_loss, use_bound, stability_thresh,
                                             gm_scale_sdf, key, subsample_points)
            fin = run_steps(pair_loss_sdf, ctx, _pair_points_per_step(atlas, finest,
                                                                      subsample_points),
                            num_iters=finetune_iters, seed=seed + 101)
            cpu_total += fin["cpu_time_sec"]
            info[f"hier_sdf_{sdf_align_loss}"] = fin
        info["ctx_build_secs"] = ctx_secs
        info["cpu_time_sec"] = info["gpu_time_sec"] = cpu_total
        return info


def _pair_points_per_step(atlas: GridAtlas, level: int, subsample_points) -> int:
    """Points of one pair in a step at ``level``: its alignment coordinates,
    or the subsample where one is drawn."""
    n = int(atlas.alignment_coords_stacked(level)[0].shape[1])
    return n if subsample_points is None else min(int(subsample_points), n)


align_multiple_submaps_hierarchical.pairs = 0
align_multiple_submaps_hierarchical.pair_rows = 0
align_multiple_submaps_hierarchical.points_per_step = 0
align_multiple_submaps_hierarchical.steps = 0
