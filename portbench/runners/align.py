"""Whole hierarchical latent alignments of a SLAM atlas:
``Fuser(atlas, None, cfg).align()`` with the configuration's ``align:``
section, back to back, each from the same perturbed submap poses.

Set-up builds the atlas through the program's own calls (``GridAtlas`` with
the configuration's submap size and capacity, ``add_submap`` and ``add_kf``
for every submap and keyframe, its tables written in, ``set_submap_pose``
for the perturbation; ``harness/atlasgen.py`` draws it all from the seed),
then runs the check's call, which is the warm-up: it selects the alignment
coordinates, tests the pairs, builds the pair context and runs the checked
steps, every shape and kernel a call uses, and ends there.  Before every
call the submap pose corrections go back to the perturbed start (zero), one
in-place copy a leaf.  A call's phases each end with a synchronize, so the
window's calls run back to back with no other wait; a call runs
``len(latent_levels)`` times ``level_iters + 1`` steps (the Fuser's
``level_thresh`` is 0, so none stops early).

The check's call runs with the program's train step and pair context as
``align/miso.py`` builds them, read as they pass: the pairs the call keeps,
its padded rows, its alignment coordinates at the level it aligns, each of
its first ``check_steps`` losses, the first gradient as masked Adam got it
(its first moment after one step, over 1 - b1) and each pose leaf after the
checked steps.  The plain reference (``portbench/reference/align.py``)
follows those steps from the seed's tables and poses, with its own pair test,
on the program's coordinates, which it also checks.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import atlasgen, trace as tracing
from portbench.reference import align as reference
from portbench.reference import field
from portbench.roofline import counts, slot_counts

B1 = 0.9  # masked Adam's first-moment decay (the program's default)
RESET = "portbench_align_reset"

# A planted fault's wrapper of the program's train step as the alignment
# builds it, ``step(pose, opt_state, batch, key, mask, lr) -> (pose,
# opt_state, total, losses)``, or of its pair context (``FAULTS``); None
# runs the program as it is.
WRAP_STEP = None
WRAP_CTX = None


def _step_unchanged(step):
    def faulty(pose, opt_state, batch, key, mask, lr):
        return pose, opt_state, torch.zeros((), device=next(iter(pose.values())).device), {}
    return faulty


def _step_altered(step):
    def faulty(pose, opt_state, batch, key, mask, lr):
        pose, opt_state, total, losses = step(pose, opt_state, batch, key, mask, lr)
        return pose, opt_state, total * 1.01, losses
    return faulty


def _ctx_half(ctx):
    n = ctx.src_ids.shape[0] // 2
    return ctx._replace(src_ids=ctx.src_ids[:n], dst_ids=ctx.dst_ids[:n], coords=ctx.coords[:n],
                        valid=ctx.valid[:n], pairs=ctx.pairs[:n])


# The faults this cell can have, planted under its timed path by the tests
# that see ``correct`` come out false and by ``readings.py``: name -> (the
# hook above, the wrapper it takes).
FAULTS = {"unchanged": ("WRAP_STEP", _step_unchanged),
          "half_pairs": ("WRAP_CTX", _ctx_half),
          "altered_loss": ("WRAP_STEP", _step_altered)}


class _Checked(Exception):
    """The check's call has run its checked steps."""


class _Reading:
    """What the check reads of the program's call, as its step and pair
    context pass; the call ends after the checked steps."""

    def __init__(self, k: int):
        self.k = k
        self.steps, self.losses, self.grads, self.changes = 0, [], {}, {}
        self.pairs, self.level, self.points, self.rows = [], None, 0, 0

    def step(self, step):
        def read(pose, opt_state, batch, key, mask, lr):
            i = self.steps
            if i == 0:
                self.start = {n: v.detach().clone() for n, v in pose.items()}
            out = step(pose, opt_state, batch, key, mask, lr)
            self.steps += 1
            if i < self.k:
                self.losses.append(float(out[2]))
                if i == 0:
                    self.grads = {n: (m / (1.0 - B1)).cpu() for n, m in out[1].m.items()}
                if i == self.k - 1:
                    self.changes = {n: (v.detach() - self.start[n]).cpu()
                                    for n, v in out[0].items()}
                    raise _Checked
            return out
        return read

    def context(self, atlas, level, pairs, rows=None):
        self.pairs, self.level = [tuple(p) for p in pairs], int(level)
        self.rows = max(int(rows or 0), len(self.pairs))
        coords, valid = atlas.alignment_coords_stacked(level)
        self.coords, self.valid = coords.detach().clone(), valid.detach().clone()
        self.points = int(coords.shape[1])


@contextlib.contextmanager
def _program_hooks(reading=None):
    """The program's alignment with its train step and pair context passed
    through ``reading`` and the planted fault's wrappers (none: as it is)."""
    from miso_tpu_torch.align import miso as program

    build, context = program.make_train_step, program.pair_context

    def make_train_step(loss_fn, optimizer="adam"):
        step = build(loss_fn, optimizer)
        if WRAP_STEP:
            step = WRAP_STEP(step)
        return reading.step(step) if reading else step

    def pair_context(atlas, level, pairs, rows=None):
        if reading:
            reading.context(atlas, level, pairs, rows)
        ctx = context(atlas, level, pairs, rows)
        return WRAP_CTX(ctx) if WRAP_CTX else ctx

    program.make_train_step, program.pair_context = make_train_step, pair_context
    try:
        yield
    finally:
        program.make_train_step, program.pair_context = build, context


def _angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    c = (np.einsum("sij,sij->s", Ra, Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


class Runner:
    end_to_end = ("map_points_per_s",)

    def __init__(self, cell):
        self.cell = cell
        cfg = cell.config
        self.model_cfg = cfg["model"]
        self.align_cfg = dict(cfg["align"], max_points=int(cfg["assumed"]["align.max_points"]))
        self.size = int(cfg["system"]["submap_size"])
        self.capacity = int(cfg["system"]["submap_capacity"])
        self.device = cell.device

    # -- the program -----------------------------------------------------------
    def _inputs(self):
        return atlasgen.AtlasInputs(self.cell.config, self.cell.traffic, self.cell.seed,
                                    self.device)

    def setup(self):
        from miso_tpu_torch.models.grid_atlas import GridAtlas

        inp = self._inputs()
        atlas = GridAtlas(self.model_cfg, max_kfs_per_submap=self.size, capacity=self.capacity,
                          device=self.device)
        local = np.asarray(self.cell.config["system"]["submap_local_bound"], np.float32)
        for s in range(inp.submaps):
            atlas.add_submap(local, inp.R_true[s], inp.t_true[s])
            for Rsk, tsk in zip(*inp.keyframes[s]):
                atlas.add_kf(Rsk, tsk)
        atlas.set_decoder([(W, b) for W, b in inp.decoder], fixed=True)
        p = atlas.params
        shapes = [list(atlas.submap_shapes(0)[l]) for l in range(atlas.num_levels)]
        if shapes != self.cell.config["table_shapes"]:
            raise RuntimeError(f"the program's submap tables are {shapes}, the configuration "
                               f"states {self.cell.config['table_shapes']}")
        with torch.no_grad():
            for s in range(inp.submaps):
                for f, tb in zip(p.features, inp.tables(s)):
                    f[s, :tb.shape[0], :tb.shape[1], :tb.shape[2]] = tb
        inp.free_world()
        for s in range(1, inp.submaps):
            atlas.set_submap_pose(s, inp.R_start[s], inp.t_start[s])
        self.atlas, self.inp = atlas, inp
        self.start = [p.sub_rot_corr.detach().clone(), p.sub_trans_corr.detach().clone()]
        self.checked = self._checked_call(int(self.cell.traffic["check_steps"]))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self):
        from miso_tpu_torch.slam.fuser import Fuser

        p = self.atlas.params
        # Under a span of its own while a profiler records:
        # ``harness/trace.py`` takes the traced window by name, whatever its
        # category, and a kernel launched directly inside the window gives
        # it a device-side copy that spans that kernel alone.
        recording = torch.autograd._profiler_enabled()
        with torch.no_grad(), (torch.profiler.record_function(RESET) if recording
                               else contextlib.nullcontext()):
            p.sub_rot_corr.copy_(self.start[0])
            p.sub_trans_corr.copy_(self.start[1])
        hooked = WRAP_STEP is not None or WRAP_CTX is not None
        with _program_hooks() if hooked else contextlib.nullcontext():
            Fuser(self.atlas, None, {"align": self.align_cfg}).align()

    def _calls(self, k: int):
        for _ in range(k):
            self._call()

    def _checked_call(self, k: int) -> Dict:
        """The check's call, up to its k-th step, with what the check reads."""
        from miso_tpu_torch.slam.fuser import Fuser

        reading = _Reading(k)
        with _program_hooks(reading):
            try:
                Fuser(self.atlas, None, {"align": self.align_cfg}).align()
            except _Checked:
                pass
        a = self.align_cfg
        levels = len(a["latent_levels"]) if a.get("latent_levels") else self.atlas.num_levels
        self.steps_per_call = levels * (int(a["level_iters"]) + 1) + (
            0 if a["skip_finetune"] else int(a["finetune_iters"]) + 1)
        self.pair_points = len(reading.pairs) * reading.points
        return dict(losses=reading.losses, grads=reading.grads, changes=reading.changes,
                    pairs=reading.pairs, rows=reading.rows, level=reading.level,
                    coords=reading.coords.cpu(), valid=reading.valid.cpu())

    def pose_error(self) -> Dict:
        """Degrees and metres of every submap but the first from its true
        pose, at the perturbed start and as the atlas holds it now (after a
        call, its aligned poses): a reading, not a check."""
        R, t = (a.detach().cpu().numpy() for a in self.atlas.params.updated_submap_poses())
        S = self.inp.submaps
        err = {}
        for when, (Ra, ta) in (("start", (self.inp.R_start, self.inp.t_start)),
                               ("now", (R[:S], t[:S]))):
            deg = _angle_deg(Ra[1:], self.inp.R_true[1:])
            m = np.linalg.norm(ta[1:] - self.inp.t_true[1:], axis=-1)
            err[when] = {"deg_mean": float(deg.mean()), "deg_max": float(deg.max()),
                         "m_mean": float(m.mean()), "m_max": float(m.max())}
        return err

    def window(self, seconds: float) -> Dict:
        self._sync()
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < seconds:
            self._call()
            calls += 1
        self._sync()
        wall = time.perf_counter() - t0
        return {"metrics": {"map_points_per_s":
                            calls * self.steps_per_call * self.pair_points / wall},
                "attempted": calls, "failed": 0}

    def trace(self) -> Dict:
        tr = tracing.capture(self._calls, 1)
        return {"trace": tr, "device_trace": tracing.capture_device(self._calls, 1),
                "counts": self._step_counts(), "steps_per_call": self.steps_per_call}

    def _step_counts(self) -> Dict:
        """A step's slot-id interp calls (every level, forward and the
        points' gradient, over the padded pair batch) and their least seconds,
        at the perturbed start."""
        p, c = self.atlas.params, self.checked
        pairs = c["pairs"] + [(0, 0)] * (c["rows"] - len(c["pairs"]))
        src = torch.tensor([s for s, _ in pairs], device=self.device)
        dst = torch.tensor([d for _, d in pairs], device=self.device)
        N = c["coords"].shape[1]
        x = c["coords"].to(self.device)[src].reshape(-1, 3)
        ids_src, ids_dst = src.repeat_interleave(N), dst.repeat_interleave(N)
        with torch.no_grad():
            R, t = p.Rws, p.tws       # every call starts from zero corrections
            world = field.to_world(x, ids_src, R, t)
            x_dst = ((world - t[ids_dst])[:, :, None] * R[ids_dst]).sum(1)
        n, F = x_dst.shape[0], p.fdim
        calls = []
        for level, stacked in enumerate(p.features):
            touched = slot_counts.touched_rows(ids_dst, x_dst, p.bounds, p.sizes[level],
                                               stacked.shape[1:4])
            calls += [slot_counts.forward(n, F, touched), slot_counts.points_backward(n, F, touched)]
        return {"slot_interp_least_s": sum(counts.least_s(**k) for k in calls)}

    def release(self):
        del self.atlas
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def reference_readings(self, precision: str = "fp32") -> Dict:
        """The reference's readings of the checked steps from the seed's
        tables and poses, on the program's alignment coordinates."""
        inp = self._inputs()
        dev = self.device
        submaps = [inp.tables(s) for s in range(inp.submaps)]
        inp.free_world()
        bounds = inp.local.expand(inp.submaps, 3, 2)
        R0 = torch.tensor(inp.R_start, device=dev)
        t0 = torch.tensor(inp.t_start, device=dev)
        c = self.checked
        coords, valid = c["coords"].to(dev), c["valid"].to(dev)
        pairs = reference.overlapping_pairs(R0, t0, bounds, [s[-1].shape[:3] for s in submaps])
        a = self.align_cfg
        level = int(a["latent_levels"][0]) if a.get("latent_levels") else 0
        out = reference.align_steps(submaps, bounds, R0, t0, coords, valid, pairs, level,
                                    int(self.cell.traffic["check_steps"]),
                                    float(a["learning_rate"]), precision)
        fails, rows = reference.selection_failures(submaps, bounds, coords, valid, level,
                                                   int(a["max_points"]))
        out["select_gap"] = fails / rows
        out["pairs"] = pairs
        return out

    @staticmethod
    def compare(got: Dict, ref: Dict) -> Dict[str, float]:
        """The four numbers the check compares.

        loss_gap: the largest relative gap of a checked step's loss.
        grad_gap: by the worst pose leaf, the norm of the program's first
        gradient less the reference's over the reference's norm.
        change_gap: by the worst pose leaf, |program's change norm - the
        reference's| over the larger of the reference's norm of that leaf and
        of the median leaf (``map_step``'s norms).
        select_gap: the share of the program's alignment coordinates that
        fail the reference's test of them.
        """
        losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        if len(got["losses"]) != len(ref["losses"]):
            losses.append(float("inf"))

        def rows(v, n):  # a leaf at n rows: the program's spare rows must be 0
            v = v.to(torch.float64).cpu()
            if v.shape[0] < n:
                v = torch.cat([v, v.new_zeros((n - v.shape[0],) + v.shape[1:])])
            return v

        grad_gap, got_c, ref_c = 0.0, {}, {}
        for name, g_ref in ref["grads"].items():
            g = got["grads"].get(name)
            n = max(g_ref.shape[0], 0 if g is None else g.shape[0])
            g_ref = rows(g_ref, n)
            g = torch.zeros_like(g_ref) if g is None else rows(g, n)
            grad_gap = max(grad_gap, float(torch.linalg.vector_norm(g - g_ref)
                                           / torch.linalg.vector_norm(g_ref)))
            got_c[name] = field.leaf_norm(got["changes"].get(name, torch.zeros(1)))
            ref_c[name] = field.leaf_norm(ref["changes"][name])
        return {"loss_gap": max(losses), "grad_gap": grad_gap,
                "change_gap": field.worst_leaf_gap(got_c, ref_c),
                "select_gap": float(ref["select_gap"])}

    def program_readings(self) -> Dict:
        return self.checked

    def check(self) -> List:
        gaps = self.compare(self.checked, self.reference_readings("fp32"))
        limits = self.cell.limits
        return [(name, gaps[name], limits[name]) for name in ("loss_gap", "grad_gap",
                                                              "change_gap", "select_gap")]
