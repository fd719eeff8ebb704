"""Sharded train steps on ``torch.distributed`` (port of
``miso_tpu/parallel/sharding.py``).

The JAX package jits each step over a device ``Mesh`` and lets XLA insert
the collectives: the program sees global arrays.  Here every rank runs its
own program on its own rows, and the collectives are written out.  The
parallel axes are JAX's:

  * **data** -- the point batch: each rank keeps its rows
    (:func:`shard_batch`), the loss and the gradients are reduced over the
    ranks (:func:`data_parallel_train_step`);
  * **submap** -- the atlas's stacked slots: each rank keeps its block
    (:func:`shard_atlas`); the world query's masked average sums the slots'
    features over the ranks before the decode
    (:func:`submap_parallel_fusion_step`);
  * the alignment's **pair** axis (:func:`shard_pair_ctx`, used by
    ``align/miso.py``), the pretraining's **scene** axis
    (``parallel/pretrain.py``) and a grid's **spatial** axis
    (``parallel/spatial.py``).

Every reduction is one of two ``autograd.Function`` s, with the gradient
JAX's ``shard_map`` transposes give:

  * :meth:`Axis.psum` sums a rank-varying value into a replicated one;
    its gradient passes through unchanged (each rank's share of a
    replicated value gets the replicated gradient);
  * :meth:`Axis.pvary` hands a replicated value to rank-varying work;
    forward unchanged, its gradient is summed over the ranks.

``torch.distributed.nn.functional.all_reduce`` back-propagates an
all-reduce of the gradient, which multiplies the gradient of a replicated
loss by the number of ranks; these functions do not.  Each backward is
written with the other function, so gradients of gradients (the eikonal)
keep the same rule.  Every collective is an ``all_reduce`` or a
``broadcast``: the two that the gloo backend runs on CUDA tensors, so two
ranks may share one card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from miso_tpu_torch.losses.common import batch_axis, total_loss
from miso_tpu_torch.models.base import named_tensors
from miso_tpu_torch.train.optim import masked_adam_update
from miso_tpu_torch.train.trainer import guarded_update, trained_leaves


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` summed over ``group`` (``x`` untouched)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _PVary.apply(g, ctx.group), None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None


class Axis:
    """One mesh axis as this rank sees it: its name, size, this rank's
    index along it and the process group of the ranks on this rank's line.
    With no group (a one-rank mesh) every collective is the identity."""

    def __init__(self, name: str, size: int, index: int, group=None):
        self.name, self.size, self.index, self.group = name, int(size), int(index), group

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis; the gradient passes through unchanged."""
        return x if self.group is None else _PSum.apply(x, self.group)

    def pvary(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` unchanged; its gradient is summed over the axis."""
        return x if self.group is None else _PVary.apply(x, self.group)

    @torch.no_grad()
    def sum_(self, tensors: Sequence[torch.Tensor], mean: bool = False):
        """Sum (or average) ``tensors`` over the axis in place, in one
        all-reduce of a float32 buffer."""
        if self.group is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        if mean:
            flat /= self.size
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.reshape(t.shape))

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows (``n`` divisible by the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over {self.size} ranks of axis {self.name!r}")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


class Mesh:
    """A JAX-style mesh of ranks: ``axis_names``, ``shape`` (name -> size)
    and this rank's :class:`Axis` on each (:meth:`axis`); ``group`` spans
    every rank of the mesh.  Built by :func:`make_mesh`."""

    def __init__(self, axes: Dict[str, Axis], group=None):
        self._axes = dict(axes)
        self.axis_names = tuple(axes)
        self.shape = {k: a.size for k, a in axes.items()}
        self.group = group

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise KeyError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self._axes[name]


def make_mesh(n_devices: Optional[int] = None, axes=("data",),
              shape: Optional[tuple] = None) -> Mesh:
    """A mesh of the first ``n_devices`` ranks (all by default) of the
    initialized process group, row-major over ``shape`` (1-D by default; a
    2-D mesh needs an explicit shape, as in the JAX package).  Every axis
    gets a process group per line of ranks, made by every rank in the same
    order (``dist.new_group``'s rule); a rank outside the mesh gets a mesh
    with no axis index.

    With no process group initialized the mesh has one rank and every
    collective is the identity, as a one-device JAX mesh; asking for more
    than one rank then raises.
    """
    axes = tuple(axes)
    if not (dist.is_available() and dist.is_initialized()):
        n = int(n_devices or 1) if shape is None else int(np.prod(shape))
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs an initialized process group "
                               "(parallel/distributed.py::initialize)")
        return Mesh({a: Axis(a, 1, 0) for a in axes})
    world, rank = dist.get_world_size(), dist.get_rank()
    n = int(n_devices or world)
    if shape is None:
        if len(axes) != 1:
            raise ValueError("a mesh of more than one axis needs an explicit shape")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or n > world:
        raise ValueError(f"mesh shape {shape} over {n} of {world} ranks")
    grid = np.arange(n).reshape(shape)
    whole = dist.new_group(list(range(n)))
    where = np.argwhere(grid == rank)
    out = {}
    for k, name in enumerate(axes):
        mine = None
        for line in np.moveaxis(grid, k, -1).reshape(-1, shape[k]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = g
        out[name] = Axis(name, shape[k], int(where[0][k]) if len(where) else -1, mine)
    return Mesh(out, whole if len(where) else None)


def _tree_tensors(tree):
    """Every tensor of a module (parameters and buffers), an atlas's params,
    a dict, list or tuple, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v)
    elif hasattr(tree, "tree_fields"):
        for _, v in tree.tree_fields():
            yield from _tree_tensors(v)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Make every rank of the mesh hold rank 0's values of ``tree`` (in
    place, a broadcast per tensor); returns ``tree``.  JAX's "every process
    must hold identical values" becomes a guarantee."""
    if mesh.group is None:
        return tree
    src = dist.get_global_rank(mesh.group, 0)
    for t in _tree_tensors(tree):
        if t.is_contiguous():
            dist.broadcast(t, src=src, group=mesh.group)
        else:
            c = t.contiguous()
            dist.broadcast(c, src=src, group=mesh.group)
            t.copy_(c)
    return tree


def shard_batch(batch: Dict, mesh: Mesh, axis: str = "data") -> Dict:
    """This rank's rows of each (N, ...) array of ``batch`` whose leading
    size divides the axis; every other array whole (JAX's placement rule).
    numpy arrays become CPU tensors."""
    ax = mesh.axis(axis)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.ndim >= 1 and t.shape[0] % ax.size == 0:
            t = t[ax.rows(t.shape[0])].contiguous()
        out[k] = t
    return out


def data_parallel_train_step(loss_fn: Callable, mesh: Mesh, axis: str = "data"):
    """Data-parallel ``train/trainer.py::make_train_step``: the model and the
    optimizer state replicated, each rank holding its rows of the batch.

    step(model, opt_state, batch, key, mask, lr) -> (model, opt_state,
    total, loss_dict) gives every rank the loss, parameters and Adam moments
    that ``make_train_step`` gives on the global batch:

      * each loss term is the mean of the ranks' terms (a plain mean over
        equal shards is the global mean);
      * inside the loss the helpers of ``losses/common.py`` that are not
        plain means take the global batch (``batch_axis``): a ratio of sums
        (``masked_mean``, ``eikonal_loss_at`` with a select mask) sums its
        numerator and denominator over the ranks, and the eikonal's uniform
        points are drawn for the global batch, each rank keeping its rows;
      * the gradients of the leaves the mask trains
        (``train/trainer.py::trained_leaves``) are summed over the ranks (one
        all-reduce); autograd is asked for no other.

    ``key`` is a ``torch.Generator`` in the same state on every rank, and
    ``mask`` the same mask, so every rank reduces the same gradients.  The
    NaN guard reads the global total, so every rank takes or skips the step.
    """
    ax = mesh.axis(axis)

    def step(model, opt_state, batch, key, mask, lr):
        params = named_tensors(model)
        trained = {k: params[k] for k in trained_leaves(params, mask)}
        with batch_axis(ax):
            loss_dict = loss_fn(model, batch, key)
        names = list(loss_dict)
        terms = ax.psum(torch.stack([torch.mean(loss_dict[k]) for k in names])) / ax.size
        tl = terms.sum()
        if trained:
            grads = torch.autograd.grad(tl, list(trained.values()), allow_unused=True)
            ax.sum_([g for g in grads if g is not None])
            guarded_update(masked_adam_update, trained, grads, opt_state, mask, lr, tl)
        return model, opt_state, tl.detach(), {k: terms[i].detach() for i, k in enumerate(names)}

    return step


# -- the alignment's pair axis ------------------------------------------------

def pad_pair_ctx(ctx, multiple: int):
    """A pair context (``align/miso.py::PairContext``) padded to a multiple
    of ``multiple`` pairs with inert ones (src = dst = 0, no valid point:
    zero loss, zero gradient)."""
    P = int(ctx.src_ids.shape[0])
    rem = (-P) % multiple
    if rem == 0:
        return ctx
    z = torch.zeros((rem,), dtype=ctx.src_ids.dtype, device=ctx.src_ids.device)

    def pad_rows(t, fill_first=False):
        if t is None:
            return None
        extra = (t[:1].expand((rem,) + t.shape[1:]) if fill_first
                 else torch.zeros((rem,) + t.shape[1:], dtype=t.dtype, device=t.device))
        return torch.cat([t, extra])

    return ctx._replace(src_ids=torch.cat([ctx.src_ids, z]), dst_ids=torch.cat([ctx.dst_ids, z]),
                        coords=pad_rows(ctx.coords, True), valid=pad_rows(ctx.valid),
                        pairs=tuple(ctx.pairs) + ((0, 0),) * rem,
                        src_vals=pad_rows(ctx.src_vals, True), src_mask=pad_rows(ctx.src_mask))


def shard_pair_ctx(ctx, mesh: Mesh, axis: str = "data"):
    """This rank's rows of the pair context, padded first to a multiple of
    the axis size (:func:`pad_pair_ctx`).  Each rank then evaluates its
    pairs; ``align/miso.py`` sums the pair losses over the axis and the
    poses' gradient with them (pair losses add)."""
    ax = mesh.axis(axis)
    ctx = pad_pair_ctx(ctx, ax.size)
    rows = ax.rows(int(ctx.src_ids.shape[0]))
    return ctx._replace(**{k: None if v is None else v[rows]
                           for k, v in ctx._asdict().items() if k != "pairs"},
                        pairs=tuple(ctx.pairs[rows]))


# -- the atlas's submap axis --------------------------------------------------

# GridAtlasParams fields stacked per slot (leading size S) that a shard
# splits; the decoder and the keyframe tables stay whole on every rank.
SLOT_FIELDS = ("sub_rot_corr", "sub_trans_corr", "Rws", "tws", "bounds", "active")


def shard_atlas(params, mesh: Mesh, axis: str = "submap"):
    """This rank's block of an atlas's slots: features, stability, sizes
    and the fields of :data:`SLOT_FIELDS`, each a new leaf; the decoder and
    the keyframe tables are kept whole (replicated).  The shard's world
    query (``GridAtlasParams._masked_average``) sums its slots' features
    and weights over the axis (``slot_axis``, ``slot_offset``), and its
    keyframe world poses read every slot's pose (``updated_submap_poses``
    gathers them)."""
    ax = mesh.axis(axis)
    S = params.capacity
    rows = ax.rows(S)

    def block(t):
        return t[rows].detach().clone()

    out = params.replace(
        features=[block(f) for f in params.features],
        stability=[block(s) for s in params.stability],
        sizes=[block(s) for s in params.sizes],
        num_submaps=min(max(params.num_submaps - rows.start, 0), rows.stop - rows.start),
        **{k: block(getattr(params, k)) for k in SLOT_FIELDS})
    out.slot_axis, out.slot_offset, out.slot_total = ax, rows.start, S
    return out


def _replicated_names(params):
    """The trainable leaves a shard keeps whole: the decoder and the
    keyframe pose corrections."""
    return [k for k, _ in params.named_parameters()
            if k.startswith("decoder.") or k.startswith("kf_")]


def submap_parallel_fusion_step(loss_fn: Callable, mesh: Mesh, submap_axis: str = "submap",
                                data_axis: Optional[str] = "data"):
    """The fusion step (``losses/fusion.py::fusion_loss`` over an atlas) with
    the atlas sharded over ``submap_axis`` (:func:`shard_atlas`) and, where
    the mesh has ``data_axis``, the point batch sharded over it.

    step(params, opt_state, batch, key, mask, lr) -> (params, opt_state,
    total), the unsharded step's numbers: the world query's feature and
    weight sums cross the submap axis before the decode, so the loss is
    replicated over it; the grid gradients stay on the rank that owns them
    and the shared leaves' (decoder, keyframe poses) are the same on every
    rank of the submap axis (averaged there, so the copies stay equal bit
    for bit).  Over the data axis the terms are averaged and every gradient
    summed, as in :func:`data_parallel_train_step`.  Only the leaves the
    mask trains (``train/trainer.py::trained_leaves``) are differentiated,
    reduced and updated; every rank holds the same mask.
    """
    sub = mesh.axis(submap_axis)
    data = mesh.axis(data_axis) if data_axis and data_axis in mesh.axis_names else None

    def step(params, opt_state, batch, key, mask, lr):
        named = dict(params.named_parameters())
        trained = {k: named[k] for k in trained_leaves(named, mask)}
        if data is None:
            tl = total_loss(loss_fn(params, batch, key))
        else:
            with batch_axis(data):
                loss_dict = loss_fn(params, batch, key)
            tl = data.psum(total_loss(loss_dict)) / data.size
        if trained:
            grads = torch.autograd.grad(tl, list(trained.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(trained.values(), grads)]
            if data is not None:
                data.sum_(grads)
            shared = set(_replicated_names(params))
            sub.sum_([g for k, g in zip(trained, grads) if k in shared], mean=True)
            guarded_update(masked_adam_update, trained, grads, opt_state, mask, lr, tl)
        return params, opt_state, tl.detach()

    return step
