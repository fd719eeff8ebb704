"""miso_tpu_torch.train (masked optimizers, train step) against miso_tpu.train.

Tolerances: losses rtol 1e-4 / atol 1e-5; parameters and moments after the
steps rtol 2e-3 / atol 2e-4, the gradient tolerance, since Adam's update
carries the gradients' float32 rounding (tests/_torch_port.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (GRAD, VAL, close, jax_arrays, jax_leaf, jax_model,
                         mapping_batch, small_cfg, t, to_jax, to_torch)
from miso_tpu.losses.miso import make_loss as jmake_loss
from miso_tpu.losses.miso import mapping_loss as jmapping
from miso_tpu.models.grid_net import grid_net_mask as jmask
from miso_tpu.train import optim as joptim
from miso_tpu.train.trainer import make_train_step as jmake_step
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models.grid_net import grid_net_mask
from miso_tpu_torch.train import optim
from miso_tpu_torch.train.trainer import make_train_step

BENCH = dict(loss_type="L1", weight_sdf=1.0, weight_eik=0.0, weight_fs=0.1,
             trunc_dist=0.15)


def test_three_chained_steps_match_jax(rng):
    """Three masked-Adam steps from identical state on rotating batches; the
    second batch's loss is NaN, so the guard must leave everything as it was."""
    cfg = small_cfg(optimize=True)
    jm = jax_model(cfg, pose_noise=0.01)
    tm = grid_net_from_numpy(jax_arrays(jm), cfg, device="cpu")
    batches = [mapping_batch(rng, 500, 5) for _ in range(3)]
    batches[1]["sdf"][7, 0] = np.nan
    jstep = jmake_step(jmake_loss(jmapping, **BENCH), "adam")
    tstep = make_train_step(make_loss(mapping_loss, **BENCH), "adam")
    jmk = jmask(jm, level=2, pose=True, pose_lr=0.5)
    tmk = grid_net_mask(tm, level=2, pose=True, pose_lr=0.5)
    jopt, topt = joptim.masked_adam_init(jm), optim.masked_adam_init(tm)
    names = [n for n, _ in tm.named_parameters()]
    for i, b in enumerate(batches):
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        jm, jopt, jtl, _ = jstep(jm, jopt, to_jax(b), jax.random.PRNGKey(i), jmk,
                                 jnp.float32(1e-2))
        tm, topt, ttl, _ = tstep(tm, topt, to_torch(b), None, tmk, 1e-2)
        if i == 1:
            assert not np.isfinite(float(jtl)) and not np.isfinite(float(ttl))
            for n, p in tm.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
        else:
            close(ttl, jtl, VAL)
    for n in names:
        close(dict(tm.named_parameters())[n], jax_leaf(jm, n), GRAD)
        close(topt.m[n], jax_leaf(jopt.m, n), GRAD)
        close(topt.step[n], jax_leaf(jopt.step, n), VAL)
    # Two real updates ran: the step counts show it where the mask is on.
    assert float(topt.step["features.1"].max()) == 2.0
    assert float(topt.step["rot_corr"].max()) == 2.0


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_masked_update_matches_jax(rng, opt):
    """Frozen entries keep their values and moments; rows and scales of the
    mask apply per element; the per-element step count drives bias correction."""
    shapes = {"a": (4, 3), "b": (6,), "c": (5, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    masks = [{"a": np.float32(1.0), "b": np.float32(0.0),
              "c": np.asarray([[1], [0], [2], [0], [1]], np.float32)},
             {"a": np.float32(0.0), "b": np.float32(1.0),
              "c": np.asarray([[1], [1], [0], [0], [1]], np.float32)}]
    tp = {k: t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    init, update = ((optim.masked_adam_init, optim.masked_adam_update) if opt == "adam"
                    else (optim.masked_sgd_init, optim.masked_sgd_update))
    jinit, jupdate = ((joptim.masked_adam_init, joptim.masked_adam_update) if opt == "adam"
                      else (joptim.masked_sgd_init, joptim.masked_sgd_update))
    ts, js = init(tp), jinit(jp)
    for i in range(4):
        g = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        mk = masks[i % 2]
        tp, ts = update({k: t(v) for k, v in g.items()}, ts, tp,
                        {k: t(v) for k, v in mk.items()}, lr=0.05)
        jp, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                         {k: jnp.asarray(v) for k, v in mk.items()}, lr=0.05)
    for k in shapes:
        close(tp[k], jp[k], VAL)
        if opt == "adam":
            close(ts.m[k], js.m[k], VAL)
            close(ts.v[k], js.v[k], VAL)
            np.testing.assert_array_equal(ts.step[k].numpy(), np.asarray(js.step[k]))
