"""Offline mapping steps: ``make_train_step(mapping_loss, "adam")`` on a
``GridNet`` with the default decode, dispatched back to back over batches
drawn at set-up, as a training loop runs them.

Set-up builds one model and optimizer state, drives them through the
check's first steps and the warm-up, and hands the same objects to the
window.  The check follows the first ``check_steps`` steps with the plain
reference (``portbench/reference/field.py``) from the same seed's inputs:
each step's loss, the first gradient as the optimizer got it (its first
moment after one step, over 1 - b1), and each leaf's change after the
checked steps, read before the next step.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import mapgen, trace as tracing
from portbench.reference import field
from portbench.roofline import counts

B1 = 0.9  # masked Adam's first-moment decay (the program's default)
# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone and are left out of the comparison.
NEGLIGIBLE_GRAD = 1e-3


# A planted fault's wrapper of the program's train step, ``step(model,
# opt_state, batch, key, mask, lr) -> (model, opt_state, total, losses)``
# (``FAULTS``); None runs the program as it is.
WRAP_STEP = None


def build_step(loss_fn):
    """The program's train step, wrapped by a planted fault if there is one."""
    from miso_tpu_torch.train.trainer import make_train_step
    step = make_train_step(loss_fn, "adam")
    return WRAP_STEP(step) if WRAP_STEP else step


def _step_unchanged(step):
    def faulty(model, opt_state, batch, key, mask, lr):
        return model, opt_state, torch.zeros((), device=batch["sdf"].device), {}
    return faulty


def _step_half_batch(step):
    def faulty(model, opt_state, batch, key, mask, lr):
        n = next(iter(batch.values())).shape[0] // 2
        return step(model, opt_state, {k: v[:n] for k, v in batch.items()}, key, mask, lr)
    return faulty


def _step_altered(step):
    def faulty(model, opt_state, batch, key, mask, lr):
        model, opt_state, total, losses = step(model, opt_state, batch, key, mask, lr)
        return model, opt_state, total * 1.01, losses
    return faulty


# The faults this cell can have, planted under its timed path by the tests
# that see ``correct`` come out false and by ``readings.py``: name -> (the
# hook above, the wrapper it takes).
FAULTS = {"unchanged": ("WRAP_STEP", _step_unchanged),
          "half_batch": ("WRAP_STEP", _step_half_batch),
          "altered_loss": ("WRAP_STEP", _step_altered)}


class Runner:
    end_to_end = ("map_points_per_s",)

    def __init__(self, cell):
        self.cell = cell
        cfg = cell.config
        self.model_cfg = cfg["model"]
        self.loss_kw = {k: cfg["mapping"][k] for k in
                        ("loss_type", "weight_sdf", "weight_fs", "trunc_dist")}
        if float(cfg["mapping"].get("weight_eik", 0.0)):
            raise ValueError("the mapping reference has no eikonal term")
        self.lr = float(cfg["train"]["learning_rate"])
        self.n = int(cfg["train"]["batch_size"])
        self.mix = dict(cell.traffic, points_per_step=self.n)
        self.dims = list(cfg["decoder_dims"])
        self.train_decoder = not bool(self.model_cfg["decoder"].get("fix", False))
        self.device = cell.device

    # -- the program -----------------------------------------------------------
    def _inputs(self):
        g = self.model_cfg["grid"]
        return mapgen.mapping_inputs(self.mix, g["bound"], float(self.loss_kw["trunc_dist"]),
                                     int(self.model_cfg["pose"]["num_poses"]), self.dims,
                                     self.cell.seed, self.device)

    def setup(self):
        from miso_tpu_torch.losses.miso import make_loss, mapping_loss
        from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
        from miso_tpu_torch.train.optim import masked_adam_init

        inp = self._inputs()
        self.batches, self.R, self.t = inp["batches"], inp["R"], inp["t"]
        model = create_grid_net(self.model_cfg, generator=torch.Generator().manual_seed(0),
                                device=self.device)
        shapes = [list(f.shape[:3]) for f in model.features]
        if shapes != self.cell.config["table_shapes"]:
            raise RuntimeError(f"the program's tables are {shapes}, the configuration "
                               f"states {self.cell.config['table_shapes']}")
        with torch.no_grad():
            for p, v in zip(model.decoder, [a for wb in inp["decoder"] for a in wb]):
                p.copy_(v)
            model.Rwk.copy_(inp["R"])
            model.twk.copy_(inp["t"])
        self.model = model
        self.step_fn = build_step(make_loss(mapping_loss, weight_eik=0.0, **self.loss_kw))
        self.mask = grid_net_mask(model, level=model.num_levels, pose=False)
        self.opt = masked_adam_init(model)
        self.steps_done = 0
        self.checked = self._checked_steps(int(self.cell.traffic["check_steps"]))
        self._steps(int(self.cell.traffic["warmup_steps"]))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _steps(self, k: int):
        for _ in range(k):
            b = self.batches[self.steps_done % len(self.batches)]
            self.model, self.opt, self.last_loss, _ = self.step_fn(
                self.model, self.opt, b, None, self.mask, self.lr)
            self.steps_done += 1

    def _checked_steps(self, k: int) -> Dict:
        """The first k steps, with what the check reads of them."""
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grad_norms = [], {}
        for i in range(k):
            self._steps(1)
            losses.append(float(self.last_loss))
            if i == 0:
                grad_norms = {n: field.leaf_norm(self.opt.m[n]) / (1.0 - B1)
                              for n in params if float(self.mask[n].max()) > 0}
        changes = {n: field.leaf_norm(p.detach() - start[n]) for n, p in params.items()}
        return dict(losses=losses, grad_norms=grad_norms, changes=changes)

    def window(self, seconds: float) -> Dict:
        self._sync()
        t0 = time.perf_counter()
        k0 = self.steps_done
        while time.perf_counter() - t0 < seconds:
            self._steps(1)
        self._sync()
        wall = time.perf_counter() - t0
        steps = self.steps_done - k0
        self.window_steps, self.window_wall = steps, wall
        return {"metrics": {"map_points_per_s": steps * self.n / wall},
                "attempted": steps, "failed": 0}

    def trace(self) -> Dict:
        k = int(self.cell.traffic["trace_steps"])
        tr = tracing.capture(self._steps, k)
        return {"trace": tr, "device_trace": tracing.capture_device(self._steps, k),
                "counts": self._step_counts(),
                "step_s": self.window_wall / self.window_steps}

    def _step_counts(self) -> Dict:
        """Per step, averaged over the batches: the interp and decode calls'
        least seconds and the step's model operations."""
        bound = torch.tensor(self.model_cfg["grid"]["bound"], dtype=torch.float32,
                             device=self.device)
        fdim = int(self.model_cfg["grid"]["feature_dim"])
        interp, decode, flops = [], [], []
        for b in self.batches:
            x = field.to_world(b["coords_frame"], b["sample_frame_ids"], self.R, self.t)
            fwd, bwd = [], []
            for dims in self.cell.config["table_shapes"]:
                rows = counts.touched_rows(x, bound, dims)
                fwd.append(counts.interp_forward(self.n, fdim, rows))
                bwd.append(counts.interp_backward(self.n, fdim, int(np.prod(dims)), rows,
                                                  need_x=True))
            dfw = counts.decode_forward(self.n, self.dims)
            dbw = counts.decode_backward(self.n, self.dims, self.train_decoder)
            interp.append(sum(counts.least_s(**c) for c in fwd + bwd))
            decode.append(counts.least_s(**dfw) + counts.least_s(**dbw))
            ops = counts.add(*fwd, *bwd, dfw, dbw)
            flops.append(counts.least_s(ops.get("flops_simt", 0.0), ops.get("flops_tensor", 0.0)))
        return {"interp_least_s": float(np.mean(interp)), "decode_least_s": float(np.mean(decode)),
                "model_flops_least_s": float(np.mean(flops))}

    def release(self):
        del self.model, self.opt, self.step_fn, self.mask, self.batches, self.R, self.t
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def reference_readings(self, precision: str = "fp32") -> Dict:
        """The reference's readings of the checked steps from the seed's inputs."""
        inp = self._inputs()
        k = int(self.cell.traffic["check_steps"])
        g = self.model_cfg["grid"]
        dev = self.device
        bound = inp["bound"]
        tables = [torch.zeros((*s, int(g["feature_dim"])), dtype=torch.float32, device=dev)
                  for s in self.cell.config["table_shapes"]]
        if float(g.get("init_stddev", 0.0)) > 0:
            raise ValueError("the mapping check expects tables that start at zero")
        start = [tb.clone() for tb in tables]
        decoder = [(W.clone(), b.clone()) for W, b in inp["decoder"]]
        dec_start = [(W.clone(), b.clone()) for W, b in decoder]
        losses, grads = field.train_steps(
            tables, decoder, inp["R"], inp["t"], bound, inp["batches"][:k], self.loss_kw,
            self.lr, self.train_decoder, precision)
        changes = {f"features.{i}": field.leaf_norm(tb - s)
                   for i, (tb, s) in enumerate(zip(tables, start))}
        for i, ((W, b), (W0, b0)) in enumerate(zip(decoder, dec_start)):
            changes[f"decoder.{2 * i}"] = field.leaf_norm(W - W0)
            changes[f"decoder.{2 * i + 1}"] = field.leaf_norm(b - b0)
        return dict(losses=losses, grad_norms={n: field.leaf_norm(v) for n, v in grads.items()},
                    changes=changes)

    @staticmethod
    def compare(got: Dict, ref: Dict) -> Dict[str, float]:
        """The three numbers the check compares.

        loss_gap: the largest relative gap of a checked step's loss.
        grad_gap / change_gap: by the worst leaf, |program's norm - the
        reference's| over the larger of the reference's norm of that leaf and
        of the median leaf.  A leaf counts where its reference gradient is at
        least NEGLIGIBLE_GRAD of the median leaf's; a leaf that the
        reference leaves unchanged (frozen, or absent from the loss) counts
        in change_gap with the reference's change 0, so moving it is a gap.
        """
        losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        if len(got["losses"]) != len(ref["losses"]):
            losses.append(float("inf"))
        med = float(np.median(list(ref["grad_norms"].values())))
        counted = [n for n, v in ref["grad_norms"].items() if v >= NEGLIGIBLE_GRAD * med]
        g_ref = {n: ref["grad_norms"][n] for n in counted}
        g_got = {n: got["grad_norms"].get(n, 0.0) for n in counted}
        c_ref = {n: ref["changes"][n] for n in counted}
        c_med = float(np.median(list(c_ref.values())))
        change_gap = field.worst_leaf_gap({n: got["changes"].get(n, 0.0) for n in counted}, c_ref)
        for n, v in got["changes"].items():
            if n not in counted and n not in ref["grad_norms"]:
                change_gap = max(change_gap, v / c_med)
        return {"loss_gap": max(losses), "grad_gap": field.worst_leaf_gap(g_got, g_ref),
                "change_gap": change_gap}

    def program_readings(self) -> Dict:
        return self.checked

    def check(self) -> List:
        gaps = self.compare(self.checked, self.reference_readings("fp32"))
        limits = self.cell.limits
        return [(name, gaps[name], limits[name]) for name in ("loss_gap", "grad_gap",
                                                              "change_gap")]
