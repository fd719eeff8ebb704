"""Shared helpers of the tests that hold miso_tpu_torch to miso_tpu.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters are copied across with ``grid_net_from_numpy``, never re-drawn.
"""
import jax.numpy as jnp
import numpy as np
import torch

# Values: float32 results of the same formula with sums in another order.
VAL = dict(rtol=1e-4, atol=1e-5)
# Gradients: as the JAX package's own Pallas tests compare them
# (tests/test_pallas_decode.py).
GRAD = dict(rtol=2e-3, atol=2e-4)


def t(a, requires_grad=False):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    out = torch.as_tensor(np.array(a))
    return out.requires_grad_() if requires_grad else out


def close(got, ref, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


def jax_arrays(model):
    """A JAX GridNet's leaves as the numpy dict grid_net_from_numpy takes."""
    return dict(
        features=[np.asarray(f) for f in model.features],
        stability=[np.asarray(s) for s in model.stability],
        decoder=None if model.decoder is None else
        [(np.asarray(W), np.asarray(b)) for W, b in model.decoder],
        rot_corr=np.asarray(model.rot_corr), trans_corr=np.asarray(model.trans_corr),
        Rwk=np.asarray(model.Rwk), twk=np.asarray(model.twk),
        bound=np.asarray(model.bound), ignore_level=np.asarray(model.ignore_level),
        anchor_kf=np.asarray(model.anchor_kf))


def jax_leaf(tree, name):
    """The JAX GridNet leaf (or mask / gradient / moment leaf) that the port's
    parameter ``name`` holds: ``features.<l>``, ``decoder.<2i or 2i+1>``, ..."""
    head, _, idx = name.partition(".")
    if head == "decoder":
        return tree.decoder[int(idx) // 2][int(idx) % 2]
    if head in ("features", "stability"):
        return getattr(tree, head)[int(idx)]
    return getattr(tree, head)


def small_cfg(impl="xla", num_poses=5, optimize=True, init_std=0.1, fix=False):
    """The ScanNet model config's structure at a small bound and width."""
    return {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": init_std,
                 "bound": [[-0.02, 2.38], [-0.01, 1.74], [-0.01, 1.03]],
                 "base_cell_size": 0.5, "per_level_scale": 5.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1,
                    "out_dim": 1, "pos_invariant": True, "fix": fix,
                    "pretrained_model": None, "impl": impl},
        "pose": {"optimize": optimize, "num_poses": num_poses},
    }


def jax_model(cfg, seed=0, pose_noise=0.0):
    """A JAX GridNet from cfg, with optional random pose corrections."""
    import jax
    from miso_tpu.models.grid_net import create_grid_net
    m = create_grid_net(jax.random.PRNGKey(seed), cfg)
    if pose_noise:
        rng = np.random.default_rng(seed + 100)
        K = m.rot_corr.shape[0]
        m = m.replace(
            rot_corr=jnp.asarray(rng.normal(0, pose_noise, (K, 3)).astype(np.float32)),
            trans_corr=jnp.asarray(rng.normal(0, pose_noise, (K, 3)).astype(np.float32)))
    return m


def mapping_batch(rng, n, num_poses, extent=(2.3, 1.7, 1.0)):
    """A mapping batch as bench.py samples one, at a small extent."""
    return {
        "coords_frame": rng.uniform([0, 0, 0], extent, (n, 3)).astype(np.float32),
        "sample_frame_ids": rng.integers(0, num_poses, (n,)).astype(np.int32),
        "weights": np.ones((n, 1), np.float32),
        "sdf": rng.uniform(-0.15, 0.15, (n, 1)).astype(np.float32),
        "sdf_valid": (rng.uniform(size=(n, 1)) < 0.7).astype(np.float32),
        "sdf_signs": (rng.uniform(size=(n, 1)) < 0.2).astype(np.float32),
    }


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
