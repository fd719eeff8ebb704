"""miso_tpu_torch.models (GridNet, masks, base helpers) and convert against
miso_tpu.models.

Tolerances: values rtol 1e-4 / atol 1e-5 (tests/_torch_port.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import VAL, close, jax_arrays, jax_leaf, jax_model, small_cfg, t
from miso_tpu.models import base as jbase
from miso_tpu.models.grid_net import grid_net_mask as jmask
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.models import base
from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("ignore", [None, [0], [1]], ids=["all", "ignore0", "ignore1"])
def test_forward_parity(rng, impl, ignore):
    cfg = small_cfg(impl=impl)
    jm = jax_model(cfg, pose_noise=0.01)
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    assert tm.decode_impl == jm.decode_impl == impl
    if ignore is not None:
        jm = jm.with_ignore_level(ignore)
        assert tm.with_ignore_level(ignore) is tm
    x = rng.uniform(-0.3, 2.6, (400, 3)).astype(np.float32)
    close(tm(t(x)), jm(jnp.asarray(x)), VAL)
    close(tm.query_feature(t(x)), jm.query_feature(jnp.asarray(x)), VAL)
    close(tm.query_stability(t(x)), jm.query_stability(jnp.asarray(x)), VAL)


def test_poses_parity(rng):
    cfg = small_cfg()
    jm = jax_model(cfg, pose_noise=0.05).replace(anchor_kf=jnp.asarray(3, jnp.int32))
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    lock = np.asarray([1, 0, 1, 0, 0], np.float32)
    for lm in (None, lock):
        for a, b in zip(tm.updated_kf_poses(None if lm is None else t(lm)),
                        jm.updated_kf_poses(None if lm is None else jnp.asarray(lm))):
            close(a, b, VAL)
    # Locked rows get no gradient.
    R, tr = tm.updated_kf_poses(t(lock))
    (R.sum() + tr.sum()).backward()
    assert np.all(tm.rot_corr.grad.numpy()[lock == 1] == 0)
    assert np.all(tm.rot_corr.grad.numpy()[lock == 0] != 0)
    assert tm.pose_key_to_id("KF7") == jm.pose_key_to_id("KF7") == 4
    Rn = np.asarray(jax.numpy.eye(3)) * -1.0
    Rn[2, 2] = 1.0
    jm = jm.set_initial_kf_pose(2, jnp.asarray(Rn), jnp.asarray([1.0, 2.0, 3.0]))
    assert tm.set_initial_kf_pose(2, t(Rn), t([1.0, 2.0, 3.0])) is tm
    for name in ("Rwk", "twk", "rot_corr", "trans_corr"):
        close(getattr(tm, name), getattr(jm, name), VAL)


def test_create_grid_net_structure():
    cfg = small_cfg(impl="pallas", num_poses=7)
    jm = jax_model(cfg)
    tm = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tm.level_shape(l) for l in range(2)] == [jm.level_shape(l) for l in range(2)]
    assert tm.cell_sizes == pytest.approx(jm.cell_sizes)
    assert (tm.num_poses, tm.num_levels, tm.fdim, tm.decode_impl) == \
        (jm.num_poses, jm.num_levels, jm.fdim, jm.decode_impl)
    names = [n for n, _ in tm.named_parameters()]
    for n in names:
        assert tuple(jax_leaf(jm, n).shape) == tuple(dict(tm.named_parameters())[n].shape)
    assert base.count_params(tm) == sum(
        int(np.asarray(jax_leaf(jm, n)).size) for n in names)
    # Random draws are as wide as the config asks.
    assert 0.05 < float(tm.features[1].detach().std()) < 0.15
    close(tm.Rwk, jm.Rwk, VAL)


@pytest.mark.parametrize("case", ["level0", "levelL", "pose", "pose_rows_lr"])
def test_mask_matches_jax(case):
    cfg = small_cfg(optimize=False)
    jm = jax_model(cfg)
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    rows = np.asarray([1, 0, 1, 1, 0], np.float32)
    kw = {"level0": dict(level=0), "levelL": dict(level=2),
          "pose": dict(level=2, pose=True),
          "pose_rows_lr": dict(level=1, pose=True, pose_rows=rows, pose_lr=0.5,
                               feature_lr=3.0, decoder=False)}[case]
    jkw = dict(kw)
    if "pose_rows" in jkw:
        jkw["pose_rows"] = jnp.asarray(rows)
    jmk = jmask(jm, **jkw)
    tmk = grid_net_mask(tm, **kw)
    assert set(tmk) == {n for n, _ in tm.named_parameters()}
    for name, m in tmk.items():
        ref = np.broadcast_to(np.asarray(jax_leaf(jmk, name)), jax_leaf(jm, name).shape)
        got = np.broadcast_to(m.numpy(), ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_base_helpers(rng):
    cfg = small_cfg()
    jm = jax_model(cfg, pose_noise=0.01)
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    names = [n for n, _ in tm.named_parameters()]
    jparams = {n: jax_leaf(jm, n) for n in names}
    full, zero = base.tree_full_mask(tm, 0.5), base.tree_zero_mask(tm)
    assert set(full) == set(names) and all(float(v) == 0.5 for v in full.values())
    assert all(float(v) == 0.0 for v in zero.values())
    ma = grid_net_mask(tm, level=0)
    mb = grid_net_mask(tm, level=1)
    comb = base.tree_combine_masks(ma, mb)
    jcomb = jbase.tree_combine_masks({n: jax_leaf(jmask(jm, level=0), n) for n in names},
                                     {n: jax_leaf(jmask(jm, level=1), n) for n in names})
    for n in names:
        np.testing.assert_array_equal(comb[n].numpy(), np.asarray(jcomb[n]))
    prev = {n: p.detach().clone() for n, p in tm.named_parameters()}
    curr = {n: p + 0.01 for n, p in prev.items()}
    jprev = {n: jnp.asarray(v) for n, v in jparams.items()}
    jcurr = {n: v + 0.01 for n, v in jprev.items()}
    close(base.relative_param_change(curr, prev),
          jbase.relative_param_change(jcurr, jprev), VAL)
    sel = base.masked_select_tree(tm, ma)
    jsel = jbase.masked_select_tree(jparams, {n: jax_leaf(jmask(jm, level=0), n)
                                              for n in names})
    for n in names:
        close(sel[n], jsel[n], VAL)
    batch = {"a": np.asarray([1.0, np.nan, np.inf], np.float32),
             "ids": np.asarray([1, 2, 3], np.int32)}
    got = base.sanitize_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jbase.sanitize_batch(batch)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
