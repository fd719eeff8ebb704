"""The train step and the training loops (port of
``miso_tpu/train/trainer.py``: ``make_train_step``, ``make_train_burst_pool``,
``make_train_step_pool``, ``make_train_scan``, ``level_schedule``,
``Trainer``, ``GridTrainer``).

One step: loss dict, total, gradients wrt every parameter the mask trains,
the NaN guard, and the masked optimizer update of those parameters.
Training phases (per-level coordinate descent, joint finetune, pose locking)
change only the mask.

The loops are plain Python, one freshly sampled batch per epoch.  A
checkpoint holds the whole train state (model, optimizer moments, the loss
generator, the numpy sampler, epoch and level bookkeeping), so a run resumed
from one is bit-identical to an uninterrupted run.  The SLAM mapper's burst
(:func:`make_train_burst_pool`) and the Fuser's step
(:func:`make_train_step_pool`) draw their batches on the device from a
resident pool; :func:`make_train_scan` is a plain loop over stacked batches.
The JAX package's scan chunking, remat and step caches (``_train_scan_chunk``,
``MISO_DEBUG_BURST``) amortise TPU dispatch and have no counterpart here;
TensorBoard logging waits for a later slice.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.models.base import (Mask, masked_select_tree, named_tensors,
                                        relative_param_change, tree_full_mask)
from miso_tpu_torch.train.optim import (masked_adam_init, masked_adam_update,
                                        masked_sgd_init, masked_sgd_update)
from miso_tpu_torch.utils.profiling import span

_UPDATES = {"adam": masked_adam_update, "sgd": masked_sgd_update}


def trained_leaves(names, mask) -> List[str]:
    """The names, in order, that ``mask`` trains, read from nothing on the
    device: for a ``models/base.py::Mask`` its ``trained`` set; for any
    other dict an entry of host numbers (a Python number, a numpy array) by
    its value, and a tensor entry as trained.  Masked Adam and SGD leave a
    zero element of a leaf, its moments and its step count as they are, so
    a tensor of zeros counted as trained changes no number: it costs a
    gradient the update ignores."""
    if isinstance(mask, Mask):
        return [k for k in names if k in mask.trained]
    return [k for k in names
            if isinstance(mask[k], torch.Tensor) or np.any(np.asarray(mask[k]) != 0)]


def make_train_step(loss_fn: Callable, optimizer: str = "adam"):
    """Build the train step.

    loss_fn(model, batch, key) -> dict of scalar losses; ``model`` is a
    module, an atlas's params, or a dict of leaf tensors.
    The returned step(model, opt_state, batch, key, mask, lr) ->
    (model, opt_state, total, loss_dict) updates the model's parameters and
    the optimizer state in place and returns them.

    Only the leaves the mask trains (:func:`trained_leaves`) take part in
    the backward and the update: autograd is asked for their gradients
    alone, so it leaves out every node that leads only to frozen leaves, and
    a frozen leaf, its moments and its step count stay as they are, as the
    full masked update would leave them.  With no leaf trained no backward
    runs; the loss is still computed and returned.  ``step.leaves_skipped``
    counts the frozen leaves left out, over every step.

    NaN guard: a non-finite total zeroes the effective mask, so the step
    changes no parameter and no moment; non-finite gradient entries become
    finite (``nan_to_num``).  The guard runs on the device, without a host
    read of the loss.

    A step opens the span ``miso.step`` and, inside it in turn,
    ``miso.step.loss``, ``miso.step.grad`` and ``miso.step.update`` (the
    last two only when a leaf trains; ``utils/profiling.py::span``: marks
    for a recording profiler, nothing otherwise).
    """
    if optimizer not in _UPDATES:
        raise ValueError(f"Invalid optimizer: {optimizer}")
    update = _UPDATES[optimizer]

    def step(model, opt_state, batch, key, mask, lr):
        with span("miso.step"):
            params = named_tensors(model)
            trained = {k: params[k] for k in trained_leaves(params, mask)}
            step.leaves_skipped += len(params) - len(trained)
            with span("miso.step.loss"):
                loss_dict = loss_fn(model, batch, key)
                tl = total_loss(loss_dict)
            if trained:
                with span("miso.step.grad"):
                    grads = torch.autograd.grad(tl, list(trained.values()), allow_unused=True)
                with span("miso.step.update"):
                    guarded_update(update, trained, grads, opt_state, mask, lr, tl)
            return (model, opt_state, tl.detach(),
                    {k: v.detach() for k, v in loss_dict.items()})

    step.leaves_skipped = 0
    return step


def guarded_update(update, params, grads, opt_state, mask, lr, total):
    """The step's update of ``params`` (name -> tensor: the leaves ``mask``
    trains, :func:`trained_leaves`) from ``grads`` (in the same order;
    None for an unused tensor): non-finite gradient entries made finite, the
    mask zeroed where ``total`` is not finite.  A leaf left out, and its
    optimizer state, are not touched."""
    if not params:
        return
    grads = {k: torch.zeros_like(p) if g is None else torch.nan_to_num(g)
             for (k, p), g in zip(params.items(), grads)}
    guard = torch.isfinite(total).to(torch.float32)
    update(grads, opt_state, params, {k: mask[k] * guard for k in params}, lr=lr)


def pool_batch_rows(u: torch.Tensor, sel: torch.Tensor, n_rows_sel: torch.Tensor,
                    n_max: int) -> torch.Tensor:
    """Flat pool rows of one burst step: uniforms u (K, B) -> row
    ``floor(u * n_rows[sel])`` of each selected keyframe's pool, as
    (K * B,) indices into the pool flattened over (keyframe, row).  The
    floor is kept below n_rows, where a uniform just under 1 rounds up,
    and at 0 where a keyframe has no rows."""
    idx = torch.floor(u * n_rows_sel[:, None].to(u.dtype)).to(torch.int64)
    idx = torch.minimum(idx, (n_rows_sel[:, None] - 1).to(torch.int64)).clamp(min=0)
    return (sel[:, None].to(torch.int64) * n_max + idx).reshape(-1)


def make_train_burst_pool(loss_fn: Callable, optimizer: str = "adam"):
    """A whole training burst whose batches are drawn on the device from a
    resident pool (the SLAM mapper's per-frame burst).

    burst(model, pool, sel, n_rows, generator, masks, lr, B) ->
    (model, total losses (steps,)): a fresh masked-optimizer state, then one
    step per entry of ``masks`` (a list of mask dicts, one a step: a
    coarse-to-fine level schedule).  Each step draws u (K, B) from
    ``generator`` on the pool's device and takes rows
    :func:`pool_batch_rows` of every pool field (``pool``: name ->
    (num_kfs, n_max, ...)), with ``sample_frame_ids`` = the selected
    keyframe of each row and unit ``weights``.  Nothing reads the device
    from the host.
    """
    step = make_train_step(loss_fn, optimizer)

    def burst(model, pool, sel, n_rows, generator, masks: Sequence, lr, B: int):
        K = sel.shape[0]
        n_max = next(iter(pool.values())).shape[1]
        flat = {name: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
                for name, a in pool.items()}
        dev = sel.device
        ids = sel.to(torch.int32).repeat_interleave(B)
        weights = torch.ones((K * B, 1), dtype=torch.float32, device=dev)
        n_rows_sel = n_rows[sel.to(torch.int64)]
        opt_state = (masked_adam_init(model) if optimizer == "adam"
                     else masked_sgd_init(model))
        totals = []
        for mask in masks:
            u = torch.rand((K, B), generator=generator, device=dev)
            rows = pool_batch_rows(u, sel, n_rows_sel, n_max)
            batch = {name: a.index_select(0, rows) for name, a in flat.items()}
            batch["sample_frame_ids"] = ids
            batch["weights"] = weights
            model, opt_state, tl, _ = step(model, opt_state, batch, generator, mask, lr)
            totals.append(tl)
        return model, torch.stack(totals)

    return burst


def make_train_step_pool(loss_fn: Callable, optimizer: str = "adam"):
    """One train step whose batch is drawn on the device from a resident pool
    (the Fuser's step).

    step(model, opt_state, pool, n_rows, k_live, generator, mask, lr, N) ->
    (model, opt_state, total): N rows drawn uniformly over (keyframe <
    k_live, row < n_rows[keyframe]) -- a keyframe uniform over the first
    ``k_live``, then a row uniform over its count (:func:`pool_batch_rows`),
    both from ``generator`` on the pool's device -- with ``sample_frame_ids`` = the keyframe of each
    row and unit ``weights``, then :func:`make_train_step`'s update.
    ``pool``: name -> (num_kfs, n_max, ...).  Nothing reads the device from
    the host.
    """
    step = make_train_step(loss_fn, optimizer)

    def step_pool(model, opt_state, pool, n_rows, k_live: int, generator, mask, lr, N: int):
        n_max = next(iter(pool.values())).shape[1]
        dev = n_rows.device
        u = torch.rand((N,), generator=generator, device=dev)
        kf = torch.clamp(torch.floor(u * k_live).to(torch.int64), max=int(k_live) - 1)
        u_row = torch.rand((N, 1), generator=generator, device=dev)
        rows = pool_batch_rows(u_row, kf, n_rows[kf], n_max)
        batch = {name: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]).index_select(0, rows)
                 for name, a in pool.items()}
        batch["sample_frame_ids"] = kf.to(torch.int32)
        batch["weights"] = torch.ones((N, 1), dtype=torch.float32, device=dev)
        model, opt_state, tl, _ = step(model, opt_state, batch, generator, mask, lr)
        return model, opt_state, tl

    return step_pool


def make_train_scan(loss_fn: Callable, optimizer: str = "adam"):
    """k train steps over stacked batches (bundle adjustment's burst).

    scan(model, opt_state, batches, generator, mask, lr) -> (model, opt_state,
    total losses (k,)): :func:`make_train_step` on ``{name: a[i]}`` for each
    i < k of the (k, ...) stacked ``batches``, in a plain loop.  The JAX
    package's scanned dispatch and its ``remat`` option are TPU means and
    have no counterpart.
    """
    step = make_train_step(loss_fn, optimizer)

    def scan(model, opt_state, batches, generator, mask, lr):
        k = next(iter(batches.values())).shape[0]
        totals = []
        for i in range(k):
            model, opt_state, tl, _ = step(model, opt_state, {n: a[i] for n, a in batches.items()},
                                           generator, mask, lr)
            totals.append(tl)
        return model, opt_state, torch.stack(totals)

    return scan


def level_schedule(iterations: int, max_epochs_in_level: int, num_levels: int,
                   mode: str = "coordinate+joint") -> List[int]:
    """The level of each epoch's mask as GridTrainer.pre_epoch picks it with
    relchange_tol == 0: level l for ``max_epochs_in_level`` epochs, then the
    next, then the finest ('coordinate') or the joint phase
    ('coordinate+joint'); ``num_levels`` stands for the joint mask."""
    if mode == "joint":
        return [num_levels] * iterations
    out, active, in_level = [], 0, 0
    for _ in range(iterations):
        if in_level >= max_epochs_in_level and active < num_levels:
            active += 1
            in_level = 0
        in_level += 1
        if active >= num_levels:
            out.append(num_levels - 1 if mode == "coordinate" else num_levels)
        else:
            out.append(active)
    return out


def _device_of(model) -> torch.device:
    return next(iter(named_tensors(model).values())).device


class Trainer:
    """Generic loop: one mega-batch from ``dataset.sample(rng)`` per epoch.

    Args:
      cfg: train cfg dict (epochs, learning_rate, optimizer, eval_every,
        verbose, relchange_tol, ...).
      model: a module (GridNet); trained in place and returned by train().
      loss_fn: (model, batch, key) -> dict; ``key`` is a torch.Generator on
        the model's device, seeded from ``seed``.
      dataset: object with ``sample(rng) -> dict of numpy arrays``.
      mask: trainability mask dict; defaults to all-trainable.
    """

    def __init__(self, cfg: Dict, model, loss_fn, dataset, val_dataset=None,
                 mask=None, seed: int = 0):
        self.cfg = cfg
        self.model = model
        self.loss_fn = loss_fn
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.verbose = cfg.get("verbose", False)
        self.lr = float(cfg.get("learning_rate", 1e-3))
        self.optimizer_name = cfg.get("optimizer", "adam")
        self.mask = mask if mask is not None else tree_full_mask(model)
        self.opt_state = (masked_adam_init(model) if self.optimizer_name == "adam"
                          else masked_sgd_init(model))
        self.step_fn = make_train_step(loss_fn, self.optimizer_name)
        self.device = _device_of(model)
        self.rng = np.random.default_rng(seed)
        self.key = torch.Generator(device=self.device).manual_seed(seed)
        self.eval_every = cfg.get("eval_every", -1)
        self.ckpt_every = cfg.get("ckpt_every", -1)
        self.log_dir = cfg.get("log_dir", None)
        self.train_dict: Dict[str, List] = {"epochs": [], "elapsed_time": [],
                                            "epoch_time": [], "total_loss": []}
        self.val_dict: Dict[str, List] = {"epochs": [], "total_loss": []}
        self.custom_eval_funcs: Dict[str, Callable] = {}
        self.custom_eval_dict: Dict[str, List] = {"epochs": []}
        self._params_prev = None
        self.relchange = np.inf
        self.total_epoch_time = 0.0
        self.sample_time = 0.0   # host-side dataset.sample + upload
        self.start_epoch = 0
        self._train_start = time.process_time()

    # -- hooks -------------------------------------------------------------
    def pre_epoch(self, epoch: int):
        if self.eval_every > 0 and epoch % self.eval_every == 0:
            self.run_eval(epoch)

    def post_epoch(self, epoch: int):
        if self.ckpt_every > 0 and epoch % self.ckpt_every == 0:
            self.save_model(epoch, f"ckpt_{epoch}")

    def current_mask(self):
        return self.mask

    # -- main loop ---------------------------------------------------------
    def train(self):
        epochs = int(self.cfg.get("epochs", 1))
        for epoch in range(self.start_epoch, epochs):
            self.pre_epoch(epoch)
            self.train_epoch(epoch)
            self.post_epoch(epoch)
        if self.eval_every > 0:
            self.run_eval(epochs)
        if self.ckpt_every > 0:
            self.save_model(epochs, "final")
        return self.model

    def _to_device(self, batch):
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def _next_batch(self):
        t0 = time.perf_counter()
        batch = self._to_device(self.dataset.sample(self.rng))
        self.sample_time += time.perf_counter() - t0
        return batch

    def train_epoch(self, epoch: int):
        """One step on a fresh batch.  Host time only: nothing here waits for
        the device unless ``verbose`` prints a loss."""
        t0 = time.perf_counter()
        batch = self._next_batch()
        self.model, self.opt_state, tl, loss_dict = self.step_fn(
            self.model, self.opt_state, batch, self.key, self.current_mask(), self.lr)
        self.total_epoch_time += time.perf_counter() - t0
        if self.verbose and epoch % 10 == 0:
            print(f"Train epoch {epoch} | train_loss={float(tl):.2e}")
        self._last_loss_dict = loss_dict

    # -- eval --------------------------------------------------------------
    def register_eval_func(self, name: str, func: Callable):
        self.custom_eval_funcs[name] = func
        self.custom_eval_dict[name] = []

    def run_eval(self, epoch: int):
        self.eval(epoch, "train")
        self.eval(epoch, "val")
        self.custom_eval_dict["epochs"].append(epoch)
        for name, func in self.custom_eval_funcs.items():
            self.custom_eval_dict[name].append(
                func(epoch, self.cfg, self.model, self.loss_fn,
                     self.dataset, self.val_dataset))

    def eval(self, epoch: int, mode: str = "train"):
        dataset = self.dataset if mode == "train" else self.val_dataset
        target = self.train_dict if mode == "train" else self.val_dict
        if dataset is None:
            return
        batch = self._to_device(dataset.sample(self.rng))
        loss_dict = self.loss_fn(self.model, batch, self.key)
        target["epochs"].append(epoch)
        tl = 0.0
        for name, val in loss_dict.items():
            v = float(torch.mean(val))
            target.setdefault(name, []).append(v)
            tl += v
        target["total_loss"].append(tl)
        if mode == "train":
            target["elapsed_time"].append(time.process_time() - self._train_start)
            target["epoch_time"].append(self.total_epoch_time)
        if self.verbose:
            print(f"Epoch {epoch} {mode} total loss: {tl:.2e}")

    def update_relchange(self, mask=None):
        """Relative change of the masked parameters since the last call."""
        params = masked_select_tree(self.model,
                                    mask if mask is not None else self.mask)
        params = {k: v.detach().clone() for k, v in params.items()}
        if self._params_prev is None:
            self._params_prev = params
            self.relchange = np.inf
            return self.relchange
        self.relchange = float(relative_param_change(params, self._params_prev))
        self._params_prev = params
        return self.relchange

    def save_model(self, epoch: int, name: str):
        """The train state at ``<log_dir>/ckpt/<name>.npz`` (nothing without a
        log_dir)."""
        if self.log_dir is None:
            return
        self.save_checkpoint(os.path.join(self.log_dir, "ckpt", f"{name}.npz"), epoch)

    # -- exact resume --------------------------------------------------------
    def _aux_state(self) -> Dict:
        return {}

    def _restore_aux_state(self, st: Dict):
        pass

    def save_checkpoint(self, path: str, epoch: int = 0):
        """The whole train state: model, optimizer state, the loss generator,
        the previous parameters of the convergence check, and in the meta
        entry the epoch, the numpy sampler's state and the level state."""
        from miso_tpu_torch.train.checkpoint import save_pytree

        tree = {"model": self.model, "opt_state": self.opt_state, "key": self.key}
        if self._params_prev is not None:
            tree["params_prev"] = self._params_prev
        meta = {"epoch": int(epoch), "rng_state": self.rng.bit_generator.state,
                "relchange": float(self.relchange),
                "has_params_prev": self._params_prev is not None,
                "total_epoch_time": float(self.total_epoch_time),
                "optimizer": self.optimizer_name, "aux": self._aux_state()}
        save_pytree(path, tree, meta=meta)

    def load_checkpoint(self, path: str) -> int:
        """Restore the train state of :meth:`save_checkpoint` (the model in
        place); returns the epoch to resume from, also ``self.start_epoch``."""
        from miso_tpu_torch.train.checkpoint import load_meta, load_pytree

        meta = load_meta(path) or {}
        like = {"model": self.model, "opt_state": self.opt_state, "key": self.key}
        if meta.get("has_params_prev"):
            like["params_prev"] = {k: v.detach() for k, v in
                                   masked_select_tree(self.model, self.mask).items()}
        tree = load_pytree(path, like)
        self.opt_state = tree["opt_state"]
        self._params_prev = tree.get("params_prev")
        if "rng_state" in meta:
            self.rng.bit_generator.state = meta["rng_state"]
        self.relchange = float(meta.get("relchange", np.inf))
        self.total_epoch_time = float(meta.get("total_epoch_time", 0.0))
        self._restore_aux_state(meta.get("aux") or {})
        self.start_epoch = int(meta.get("epoch", 0))
        return self.start_epoch


class GridTrainer(Trainer):
    """Coarse-to-fine trainer.

    Modes: 'coordinate' (level by level, then stay at the finest),
    'coordinate+joint' (then unlock every level), 'joint'.  A level ends when
    relchange < relchange_tol or after max_epochs_in_level epochs.  Only the
    mask changes between phases.
    """

    def __init__(self, cfg, model, loss_fn, dataset, val_dataset=None,
                 mask_for_level: Optional[Callable] = None, seed: int = 0):
        super().__init__(cfg, model, loss_fn, dataset, val_dataset, seed=seed)
        from miso_tpu_torch.models.grid_net import grid_net_mask

        self.mask_for_level = mask_for_level or (
            lambda m, level: grid_net_mask(m, level=level))
        self.relchange_tol = float(cfg.get("relchange_tol", 0.0))
        self.max_epochs_in_level = int(cfg.get("max_epochs_in_level", 100))
        self.mode = cfg.get("grid_training_mode", "coordinate+joint")
        self.num_levels = model.num_levels
        self.active_level = self.num_levels if self.mode == "joint" else 0
        self.epochs_in_level = 0
        self.mask = self.mask_for_level(self.model, self.active_level)

    def reset_convergence_check(self):
        self._params_prev = None
        self.relchange = np.inf
        self.epochs_in_level = 0

    def _level_mask(self):
        if self.active_level >= self.num_levels:
            # 'coordinate' keeps training the finest level; otherwise the
            # joint finetune over all levels.
            level = (self.num_levels - 1 if self.mode == "coordinate"
                     else self.num_levels)
        else:
            level = self.active_level
        return self.mask_for_level(self.model, level)

    def _aux_state(self) -> Dict:
        return {"active_level": int(self.active_level),
                "epochs_in_level": int(self.epochs_in_level)}

    def _restore_aux_state(self, st: Dict):
        if not st:
            return
        self.active_level = int(st["active_level"])
        self.epochs_in_level = int(st["epochs_in_level"])
        self.mask = self._level_mask()

    def pre_epoch(self, epoch: int):
        super().pre_epoch(epoch)
        if self.relchange_tol > 0:
            self.update_relchange()
        if (self.relchange < self.relchange_tol
                or self.epochs_in_level >= self.max_epochs_in_level):
            if self.active_level < self.num_levels:
                self.train_dict[f"level{self.active_level}_last_epoch"] = epoch
                self.active_level += 1
                self.mask = self._level_mask()
                self.reset_convergence_check()
        self.epochs_in_level += 1
