"""The train step trains only the leaves its mask trains
(``miso_tpu_torch/train/trainer.py::make_train_step``, ``trained_leaves``),
on the CPU.

* Parity: five steps of the step against the full update written out here
  (``autograd.grad`` over every leaf, the NaN guard, the masked optimizer
  over every leaf), bit for bit in every parameter and every Adam ``m``,
  ``v`` and ``step``, on a 2-level GridNet with a fixed decoder and 372
  poses: the mapping cell's joint mask, one level (the coordinate phase),
  the tracker's pose rows, every leaf frozen (no backward runs, the loss is
  still returned), a non-finite total (the guard), and SGD.
* The trained set: every mask function's ``Mask.trained`` is the set of
  names whose entry has an element other than 0.  ``step.leaves_skipped``
  counts the frozen leaves of every step; a mask of Python numbers trains
  the same leaves; no step, the first on a new mask included, reads a
  tensor on the host; round-robin decoder pretraining trains the same
  leaves and reads nothing.
"""
import numpy as np
import pytest
import torch

from _torch_port import mapping_batch, small_cfg, to_torch
from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models import base
from miso_tpu_torch.models.base import tree_zero_mask
from miso_tpu_torch.models.grid_atlas import GridAtlas, grid_atlas_mask
from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
from miso_tpu_torch.train import optim
from miso_tpu_torch.train.trainer import make_train_step

LOSS = dict(loss_type="L2", weight_sdf=1.0, weight_eik=0.0, weight_fs=0.1, trunc_dist=0.15)
NUM_POSES = 372
STEPS = 5
LR = 1e-2


def model_and_batches(seed=0, n=2048, steps=STEPS):
    """A 2-level GridNet with the mapping cell's fixed 8-64-64-1 decoder and
    372 poses, its pose corrections off zero, and ``steps`` batches."""
    cfg = small_cfg(num_poses=NUM_POSES, fix=True)
    cfg["decoder"]["hidden_dim"] = 64
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        model.rot_corr.copy_(0.01 * torch.randn(model.rot_corr.shape, generator=g))
        model.trans_corr.copy_(0.01 * torch.randn(model.trans_corr.shape, generator=g))
    rng = np.random.default_rng(seed)
    return model, [to_torch(mapping_batch(rng, n, NUM_POSES)) for _ in range(steps)]


def pose_rows_mask(model):
    rows = torch.zeros((NUM_POSES,), dtype=torch.float32)
    rows[5:40] = 1.0
    return grid_net_mask(model, features=False, stability=False, decoder=False, pose=True,
                         pose_rows=rows)


MASKS = {
    "joint": lambda m: grid_net_mask(m, level=m.num_levels, pose=False),
    "level": lambda m: grid_net_mask(m, level=0, pose=False),
    "pose_rows": pose_rows_mask,
    "frozen": tree_zero_mask,
    "nonfinite": lambda m: grid_net_mask(m, level=m.num_levels, pose=False),
    "sgd": lambda m: grid_net_mask(m, level=m.num_levels, pose=False),
}
TRAINED = {"joint": 4, "level": 2, "pose_rows": 2, "frozen": 0, "nonfinite": 4, "sgd": 4}
# The leaves the five steps move: the stability grids train but are absent
# from the mapping loss, so their zero gradient leaves them in place.
MOVED = {"joint": ["features.0", "features.1"], "level": ["features.0"],
         "pose_rows": ["rot_corr", "trans_corr"], "frozen": [],
         "nonfinite": ["features.0", "features.1"], "sgd": ["features.0", "features.1"]}


def full_step(loss_fn, update):
    """The update over every leaf: gradients of all of them, the NaN guard,
    the masked optimizer on each."""

    def step(model, opt, batch, mask, lr):
        params = dict(model.named_parameters())
        tl = total_loss(loss_fn(model, batch, None))
        grads = torch.autograd.grad(tl, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else torch.nan_to_num(g)
                 for (k, p), g in zip(params.items(), grads)}
        guard = torch.isfinite(tl).to(torch.float32)
        update(grads, opt, params, {k: m * guard for k, m in mask.items()}, lr=lr)
        return tl.detach()

    return step


def bits(x):
    return x.detach().contiguous().view(torch.int32)


def assert_same_bits(a, b, name):
    assert torch.equal(bits(a), bits(b)), name


def leaf_versions(model, opt, k):
    """The write counts of leaf ``k`` and of its optimizer state."""
    state = [getattr(opt, f)[k] for f in ("m", "v", "step") if hasattr(opt, f)]
    return [t._version for t in [model.get_parameter(k)] + state]


def _refuse(*args, **kwargs):
    raise AssertionError("autograd.grad ran though no leaf trains")


@pytest.mark.parametrize("case", sorted(MASKS))
def test_step_matches_the_full_update_bitwise(case, monkeypatch):
    name = "sgd" if case == "sgd" else "adam"
    init = optim.masked_sgd_init if case == "sgd" else optim.masked_adam_init
    update = optim.masked_sgd_update if case == "sgd" else optim.masked_adam_update
    loss_fn = make_loss(mapping_loss, **LOSS)
    ref_model, batches = model_and_batches()
    model, _ = model_and_batches()
    if case == "nonfinite":
        batches[2]["sdf"][7, 0] = float("nan")
    ref_mask, mask = MASKS[case](ref_model), MASKS[case](model)
    ref_opt, opt = init(ref_model), init(model)
    ref = full_step(loss_fn, update)
    step = make_train_step(loss_fn, name)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    frozen = [k for k, m in mask.items() if not torch.any(m)]
    assert len(frozen) == 12 - TRAINED[case]
    versions = {k: leaf_versions(model, opt, k) for k in frozen}
    totals = []
    for i, b in enumerate(batches):
        ref_tl = ref(ref_model, ref_opt, b, ref_mask, LR)
        with monkeypatch.context() as mp:
            if case == "frozen":
                mp.setattr(torch.autograd, "grad", _refuse)
            model, opt, tl, losses = step(model, opt, b, None, mask, LR)
        assert_same_bits(tl, ref_tl, f"total, step {i}")
        assert set(losses) and all(not v.requires_grad for v in losses.values())
        totals.append(tl)
    assert [bool(torch.isfinite(x)) for x in totals] == [case != "nonfinite" or i != 2
                                                         for i in range(STEPS)]
    ref_params = dict(ref_model.named_parameters())
    for k, p in model.named_parameters():
        assert_same_bits(p, ref_params[k], k)
        if case != "sgd":
            for field in ("m", "v", "step"):
                assert_same_bits(getattr(opt, field)[k], getattr(ref_opt, field)[k],
                                 f"{field}[{k}]")
    # A frozen leaf and its state are never written.
    assert {k: leaf_versions(model, opt, k) for k in frozen} == versions
    assert step.leaves_skipped == STEPS * (12 - TRAINED[case])
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, start[k])]
    assert moved == MOVED[case]


def _one_mask_run(mask_of, steps=10):
    """``steps`` steps of one mask on one batch rotation; the step and model."""
    model, batches = model_and_batches(n=512, steps=2)
    step = make_train_step(make_loss(mapping_loss, **LOSS), "adam")
    opt = optim.masked_adam_init(model)
    mask = mask_of(model)
    for i in range(steps):
        step(model, opt, batches[i % 2], None, mask, LR)
    return step, model, opt, mask, batches


def test_one_mask_skips_eight_leaves_a_step():
    step, *_ = _one_mask_run(MASKS["joint"])
    assert step.leaves_skipped == 8 * 10


def test_a_mask_of_python_numbers_needs_no_read_and_trains_the_same():
    def numbers(model):
        return {k: float(v) for k, v in MASKS["joint"](model).items()}

    step, model, opt, *_ = _one_mask_run(numbers, steps=4)
    ref_step, ref_model, ref_opt, *_ = _one_mask_run(MASKS["joint"], steps=4)
    assert step.leaves_skipped == ref_step.leaves_skipped == 8 * 4
    ref_params = dict(ref_model.named_parameters())
    for k, p in model.named_parameters():
        assert_same_bits(p, ref_params[k], k)
        assert_same_bits(opt.m[k], ref_opt.m[k], k)


def _refuse_host_reads(monkeypatch):
    def host_read(*args, **kwargs):
        raise AssertionError("the step read a tensor on the host")

    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, attr, host_read)
    monkeypatch.setattr(torch.cuda, "synchronize", host_read)


def test_no_step_the_first_included_reads_the_device(monkeypatch):
    """No synchronize and no host read of a tensor in any step, the first
    on a new ``grid_net_mask`` mask and the first on another mask
    included."""
    model, batches = model_and_batches(n=512, steps=2)
    step = make_train_step(make_loss(mapping_loss, **LOSS), "adam")
    opt = optim.masked_adam_init(model)
    masks = [MASKS["joint"](model), MASKS["level"](model)]
    start = model.features[0].detach().clone()
    with monkeypatch.context() as mp:
        _refuse_host_reads(mp)
        for mask in masks:
            for b in batches:
                step(model, opt, b, None, mask, LR)
    assert step.leaves_skipped == 8 * 2 + 10 * 2
    assert not torch.equal(model.features[0].detach(), start)


def _grid(fix=False):
    return create_grid_net(small_cfg(num_poses=6, fix=fix),
                           generator=torch.Generator().manual_seed(0), device="cpu")


def _vm_grid():
    cfg = small_cfg(num_poses=4)
    cfg["grid"] = {**cfg["grid"], "type": "VM", "VM": {"rank": 2, "fix_bases": False}}
    return create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def _atlas_params():
    atlas = GridAtlas(small_cfg(num_poses=1), max_kfs_per_submap=2, device="cpu")
    for _ in range(2):
        atlas.add_submap(np.array([[-1.0, 1.0]] * 3, np.float32))
        atlas.add_kf()
    return atlas.params


def _pose_rows_mask():
    model = _grid()
    rows = torch.zeros((model.num_poses,))
    rows[1::3] = 1.0
    return grid_net_mask(model, features=False, stability=False, decoder=False, pose=True,
                         pose_lr=0.5, pose_rows=rows)


def _combined_mask():
    model = _grid()
    return base.tree_combine_masks(grid_net_mask(model, level=0, pose=False),
                                   grid_net_mask(model, level=1, decoder=False, pose=False),
                                   tree_zero_mask(model))


# One case a mask function; every case but the first two leaves a name frozen.
MASK_CASES = {
    "grid_net_joint": lambda: grid_net_mask(_grid(), level=2),
    "tree_full": lambda: base.tree_full_mask(_grid(), 0.5),
    "grid_net_level0": lambda: grid_net_mask(_grid(), level=0, pose=False),
    "grid_net_pose_rows": _pose_rows_mask,
    "grid_net_frozen": lambda: grid_net_mask(_grid(), features=False, stability=False,
                                             decoder=False, pose=False),
    "grid_net_decoder_fixed": lambda: grid_net_mask(_grid(fix=True), level=1, pose=False),
    "grid_net_vm": lambda: grid_net_mask(_vm_grid(), level=0, pose=False),
    "grid_atlas": lambda: grid_atlas_mask(_atlas_params(), features=True, level=1,
                                          submap_pose=True),
    "grid_atlas_one_anchored_slot": lambda: grid_atlas_mask(_atlas_params().trim(1),
                                                            decoder=True, submap_pose=True),
    "tree_zero": lambda: base.tree_zero_mask(_grid()),
    "tree_scale": lambda: base.tree_scale_mask(grid_net_mask(_grid(), level=1), 0.2),
    "tree_scale_zero": lambda: base.tree_scale_mask(grid_net_mask(_grid(), level=1), 0.0),
    "tree_combine": _combined_mask,
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_builders_carry_their_trained_set(case):
    mask = MASK_CASES[case]()
    assert isinstance(mask, base.Mask)
    nonzero = {k for k, m in mask.items() if torch.any(m != 0)}
    assert mask.trained == nonzero
    assert nonzero or case.endswith(("frozen", "zero"))
    assert nonzero != set(mask) or case in list(MASK_CASES)[:2]


def test_round_robin_pretraining_trains_the_same_leaves_and_reads_nothing(monkeypatch):
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.training import train_decoder

    steps, seen = [], []

    def keep(loss_fn, optimizer="adam"):
        inner = make_train_step(loss_fn, optimizer)

        def step(model, opt_state, batch, key, mask, lr):
            nonzero = sorted(k for k, m in mask.items() if torch.any(m != 0))
            seen.append((sorted(mask.trained), nonzero, len(mask)))
            with monkeypatch.context() as mp:
                _refuse_host_reads(mp)
                return inner(model, opt_state, batch, key, mask, lr)

        steps.append(inner)
        return step

    monkeypatch.setattr(train_decoder, "make_train_step", keep)
    datasets = [Sdf3D(TriangleMesh(*room_scene(4.0 + s, seed=s)), batch_size=256,
                      total_samples=1024, trunc_dist=0.15) for s in range(2)]
    train_decoder.train_round_robin(datasets, 6, 0.15, device="cpu")
    (step,) = steps
    assert len(seen) == 6 * len(train_decoder.STAGES)
    assert all(trained == nonzero and trained for trained, nonzero, _ in seen)
    assert step.leaves_skipped == sum(n - len(trained) for trained, _, n in seen)
