"""miso_tpu_torch.losses against miso_tpu.losses: loss dicts and gradients.

Tolerances: values rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 / atol 2e-4
(tests/_torch_port.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (GRAD, VAL, close, jax_arrays, jax_leaf, jax_model,
                         mapping_batch, small_cfg, t, to_jax, to_torch)
from miso_tpu.losses import common as jcommon
from miso_tpu.losses.miso import mapping_loss as jmapping
from miso_tpu.losses.miso import tracking_loss as jtracking
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.losses import common
from miso_tpu_torch.losses.miso import make_loss, mapping_loss, tracking_loss

# bench.py:72-73.
BENCH = dict(loss_type="L1", weight_sdf=1.0, weight_eik=0.0, weight_fs=0.1,
             trunc_dist=0.15)


def _models(impl="xla"):
    cfg = small_cfg(impl=impl)
    jm = jax_model(cfg, pose_noise=0.02)
    return jm, grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")


def _check_loss_and_grads(jfn, tfn, jm, tm, batch):
    """Same loss dict; same gradients wrt features, decoder and pose corrections."""
    jb, tb = to_jax(batch), to_torch(batch)

    def objective(m, b):
        d = jfn(m, b, jax.random.PRNGKey(0))
        return jcommon.total_loss(d), d

    (_, jd), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True,
                                                 allow_int=True))(jm, jb)
    td = tfn(tm, tb, None)
    assert set(td) == set(jd)
    for k in jd:
        close(td[k], jd[k], VAL)
    params = dict(tm.named_parameters())
    names = [n for n in params if not n.startswith("stability")]
    tgrads = torch.autograd.grad(common.total_loss(td), [params[n] for n in names])
    for n, g in zip(names, tgrads):
        close(g, jax_leaf(jgrads, n), GRAD)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mapping_loss_bench_hyperparameters(rng, impl):
    jm, tm = _models(impl)
    batch = mapping_batch(rng, 600, 5)
    _check_loss_and_grads(lambda m, b, k: jmapping(m, b, k, **BENCH),
                          make_loss(mapping_loss, **BENCH), jm, tm, batch)


def test_mapping_loss_eikonal_finitediff_stability(rng):
    """The ScanNet config's eikonal settings (finite differences) plus the
    stability terms and the bound mask."""
    hyper = dict(BENCH, weight_eik=0.5, finite_diff_eps=0.024, grad_method="finitediff",
                 eik_trunc_dist=0.1, use_stability=True, mask_bound=0.05)
    jm, tm = _models()
    batch = mapping_batch(rng, 400, 5)
    _check_loss_and_grads(lambda m, b, k: jmapping(m, b, k, **hyper),
                          make_loss(mapping_loss, **hyper), jm, tm, batch)


@pytest.mark.parametrize("loss_type,trunc", [("GM", None), ("L2", 0.1)])
def test_tracking_loss(rng, loss_type, trunc):
    hyper = dict(loss_type=loss_type, trunc_dist=trunc, gm_scale_sdf=0.1, weight_sdf=2.0)
    jm, tm = _models()
    batch = mapping_batch(rng, 500, 5)
    lock = np.asarray([1, 0, 0, 1, 0], np.float32)
    _check_loss_and_grads(
        lambda m, b, k: jtracking(m, b, k, pose_lock_rows=jnp.asarray(lock), **hyper),
        make_loss(tracking_loss, pose_lock_rows=t(lock), **hyper), jm, tm, batch)


def test_common_helpers(rng):
    n = 300
    pred = rng.normal(0, 1, (n, 3)).astype(np.float32)
    targ = rng.normal(0, 1, (n, 3)).astype(np.float32)
    valid = (rng.uniform(size=(n, 1)) < 0.6).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    for lt in ("L1", "L2", "Cosine"):
        close(common.regression_loss(t(pred), t(targ), t(valid), t(w), lt),
              jcommon.regression_loss(pred, targ, valid, w, lt), VAL)
    p1, g1 = pred[:, :1], targ[:, :1]
    for lt in ("L1", "L2", "GM"):
        close(common.sdf_residual_loss(t(p1), t(g1), t(valid), lt, 0.1),
              jcommon.sdf_residual_loss(p1, g1, valid, lt, 0.1), VAL)
    # GM weights are detached: the gradient is w * 2 * residual.
    pt = t(p1, True)
    (g,) = torch.autograd.grad(common.gm_weighted_sq(pt - t(g1), 0.1).sum(), pt)
    jg = jax.grad(lambda p: jnp.sum(jcommon.gm_weighted_sq(p - g1, 0.1)))(p1)
    close(g, jg, GRAD)
    sign = (rng.uniform(size=(n, 1)) < 0.3).astype(np.float32)
    close(common.free_space_loss(t(p1), t(g1), t(sign), 0.15),
          jcommon.free_space_loss(p1, g1, sign, 0.15), VAL)
    close(common.masked_mean(t(pred), t(valid)), jcommon.masked_mean(pred, valid), VAL)
    close(common.masked_mean(t(pred)), jcommon.masked_mean(pred), VAL)
    rc, tc = pred[:20], targ[:20]
    for a, b in ((common.pose_regularization_loss(t(rc), t(tc), 2.0),
                  jcommon.pose_regularization_loss(rc, tc, 2.0)),
                 (common.pose_trust_region_loss(t(rc), t(tc), 0.5, 0.3),
                  jcommon.pose_trust_region_loss(rc, tc, 0.5, 0.3))):
        assert set(a) == set(b)
        for k in a:
            close(a[k], b[k], VAL)
    d = {"a": t(pred), "b": t(targ[:, 0])}
    close(common.total_loss(d), jcommon.total_loss({"a": pred, "b": targ[:, 0]}), VAL)
