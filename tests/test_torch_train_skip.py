"""The train step trains only the leaves its mask trains
(``miso_tpu_torch/train/trainer.py::make_train_step``, ``TrainedLeaves``),
on the CPU.

* Parity: five steps of the step against the full update written out here
  (``autograd.grad`` over every leaf, the NaN guard, the masked optimizer
  over every leaf), bit for bit in every parameter and every Adam ``m``,
  ``v`` and ``step``, on a 2-level GridNet with a fixed decoder and 372
  poses: the mapping cell's joint mask, one level (the coordinate phase),
  the tracker's pose rows, every leaf frozen (no backward runs, the loss is
  still returned), a non-finite total (the guard), and SGD.
* Counters: ``step.mask_reads`` reads a mask's tensors once and again only
  when an entry is written in place or a new mask arrives; a mask of Python
  numbers needs no read; ``step.leaves_skipped`` counts the frozen leaves of
  every step; after the read the step reads nothing from its tensors on
  the host.
* ``TrainedLeaves`` alone: a mask of 100 tensors is read once, and the
  reader keeps no mask alive; round-robin decoder pretraining reads each
  scene's mask once a stage.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from _torch_port import mapping_batch, small_cfg, to_torch
from miso_tpu_torch.losses.common import total_loss
from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models.base import tree_zero_mask
from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
from miso_tpu_torch.train import optim
from miso_tpu_torch.train.trainer import TrainedLeaves, make_train_step

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
    assert step.mask_reads == 1
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


def test_one_mask_is_read_once_and_skips_eight_leaves_a_step():
    step, *_ = _one_mask_run(MASKS["joint"])
    assert step.mask_reads == 1
    assert step.leaves_skipped == 8 * 10


def test_a_mask_written_in_place_is_read_again_and_its_leaf_then_stays():
    step, model, opt, mask, batches = _one_mask_run(MASKS["joint"], steps=3)
    mask["features.1"].fill_(0)
    before = {k: v.detach().clone() for k, v in [("p", model.features[1]),
                                                 ("m", opt.m["features.1"]),
                                                 ("v", opt.v["features.1"]),
                                                 ("step", opt.step["features.1"])]}
    for i in range(3):
        step(model, opt, batches[i % 2], None, mask, LR)
    assert step.mask_reads == 2
    assert step.leaves_skipped == 8 * 3 + 9 * 3
    after = {"p": model.features[1], "m": opt.m["features.1"], "v": opt.v["features.1"],
             "step": opt.step["features.1"]}
    for k, v in before.items():
        assert_same_bits(after[k], v, k)


def test_a_new_mask_with_new_tensors_is_read_again():
    step, model, opt, mask, batches = _one_mask_run(MASKS["joint"], steps=2)
    step(model, opt, batches[0], None, MASKS["level"](model), LR)
    assert step.mask_reads == 2
    # The first mask's tensors are still known: going back reads nothing.
    step(model, opt, batches[1], None, mask, LR)
    assert step.mask_reads == 2


def test_a_mask_of_python_numbers_needs_no_read_and_trains_the_same():
    def numbers(model):
        return {k: float(v) for k, v in MASKS["joint"](model).items()}

    step, model, opt, *_ = _one_mask_run(numbers, steps=4)
    ref_step, ref_model, ref_opt, *_ = _one_mask_run(MASKS["joint"], steps=4)
    assert step.mask_reads == 0 and ref_step.mask_reads == 1
    assert step.leaves_skipped == ref_step.leaves_skipped == 8 * 4
    ref_params = dict(ref_model.named_parameters())
    for k, p in model.named_parameters():
        assert_same_bits(p, ref_params[k], k)
        assert_same_bits(opt.m[k], ref_opt.m[k], k)


def test_after_the_first_read_the_step_reads_nothing_on_the_host(monkeypatch):
    """No synchronize and no host read of a tensor once the mask is known
    (the read's span, ``miso.step.mask``, is held to the first step in
    ``tests/test_torch_profiling.py``)."""
    step, model, opt, mask, batches = _one_mask_run(MASKS["joint"], steps=1)

    def host_read(*args, **kwargs):
        raise AssertionError("the step read a tensor on the host")

    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, attr, host_read)
    monkeypatch.setattr(torch.cuda, "synchronize", host_read)
    for b in batches:
        step(model, opt, b, None, mask, LR)
    monkeypatch.undo()
    assert step.mask_reads == 1


def test_a_large_mask_is_read_once_and_no_mask_is_kept_alive():
    leaves = TrainedLeaves()
    names = [f"w{i}" for i in range(100)]
    mask = {k: torch.full((3, 1), float(i % 2)) for i, k in enumerate(names)}
    for _ in range(3):
        assert leaves(names, mask) == tuple(names[1::2])
    assert leaves.reads == 1
    for _ in range(4):
        assert leaves(names, {k: torch.tensor(1.0) for k in names}) == tuple(names)
    assert leaves.reads == 5
    assert leaves(names, mask) == tuple(names[1::2]) and leaves.reads == 5
    dead = weakref.ref(mask["w1"])
    del mask
    gc.collect()
    assert dead() is None


def test_round_robin_pretraining_reads_each_mask_once_a_stage(monkeypatch):
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.training import train_decoder

    steps = []

    def keep(loss_fn, optimizer="adam"):
        steps.append(make_train_step(loss_fn, optimizer))
        return steps[-1]

    monkeypatch.setattr(train_decoder, "make_train_step", keep)
    datasets = [Sdf3D(TriangleMesh(*room_scene(4.0 + s, seed=s)), batch_size=256,
                      total_samples=1024, trunc_dist=0.15) for s in range(2)]
    train_decoder.train_round_robin(datasets, 6, 0.15, device="cpu")
    (step,) = steps
    assert step.mask_reads == len(train_decoder.STAGES) * len(datasets)
