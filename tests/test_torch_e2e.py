"""The synthetic mesh path of miso_tpu_torch against miso_tpu's, piece by
piece, at a small size: native runtime, Sdf3D, GridTrainer, extract_fields,
Chamfer metrics.

Tolerances (tests/_torch_port.py): values rtol 1e-4 / atol 1e-5; trained
parameters rtol 2e-3 / atol 2e-4 (Adam carries the gradients' float32
rounding).  The native runtime and the numpy samplers are the same code on
the same inputs, so their outputs must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, jax_arrays, jax_leaf, t
from miso_tpu.datasets.sdf_3d import Sdf3D as JSdf3D
from miso_tpu.datasets.shapes import room_scene as jroom_scene
from miso_tpu.losses.common import eikonal_loss_at as jeikonal_at
from miso_tpu.losses.miso import make_loss as jmake_loss
from miso_tpu.losses.sdf import tsdf_loss_3d as jtsdf
from miso_tpu.models.grid_net import create_grid_net as jcreate
from miso_tpu.models.grid_net import grid_net_mask as jmask
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.native import marching_cubes as jmarching_cubes
from miso_tpu.train.trainer import GridTrainer as JGridTrainer
from miso_tpu.utils.eval import compute_chamfer_metrics as jchamfer
from miso_tpu.utils.sdf import extract_fields as jextract_fields
from miso_tpu.utils.sdf import observed_sdf_query as jobserved_sdf_query
from miso_tpu.utils.sdf import read_ply as jread_ply
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.datasets.sdf_3d import Sdf3D
from miso_tpu_torch.datasets.shapes import icosphere, room_scene
from miso_tpu_torch.losses.common import eikonal_loss_at
from miso_tpu_torch.losses.miso import make_loss
from miso_tpu_torch.losses.sdf import tsdf_loss_3d
from miso_tpu_torch.models.grid_net import grid_net_mask
from miso_tpu_torch.native import TriangleMesh, marching_cubes
from miso_tpu_torch.train.trainer import GridTrainer, Trainer
from miso_tpu_torch.utils.eval import compute_chamfer_metrics
from miso_tpu_torch.utils.sdf import extract_fields, observed_sdf_query, save_mesh

# tests/test_train_e2e.py's model.
MODEL_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
             "bound": [[-1.2, 1.2], [-1.2, 1.2], [-1.2, 1.2]],
             "base_cell_size": 0.4, "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                "pos_invariant": True, "fix": False, "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 1},
}
TRAIN_CFG = {"optimizer": "adam", "learning_rate": 5e-3, "epochs": 6,
             "max_epochs_in_level": 2, "grid_training_mode": "coordinate+joint"}


@pytest.fixture(scope="module")
def sphere():
    return icosphere(2, 0.7)


def _models(seed=0):
    jm = jcreate(jax.random.PRNGKey(seed), MODEL_CFG)
    return jm, grid_net_from_numpy(jax_arrays(jm), MODEL_CFG, device="cpu")


def test_native_runtime_matches_jax(tmp_path):
    """Marching cubes, surface sampling, signed distance and closest points:
    the same C++ code on the same inputs gives the same bits."""
    ax = np.linspace(-1, 1, 40)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    field = (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6).astype(np.float32)
    spacing = [ax[1] - ax[0]] * 3
    got = marching_cubes(field, 0.0, origin=[-1, -1, -1], spacing=spacing)
    ref = jmarching_cubes(field, 0.0, origin=[-1, -1, -1], spacing=spacing)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    verts, tris = room_scene(4.0)
    jv, jt = jroom_scene(4.0)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(tris, jt)
    mesh, jmesh = TriangleMesh(verts, tris), JMesh(verts, tris)
    for a, b in zip(mesh.sample_surface(5000, seed=3, return_normals=True),
                    jmesh.sample_surface(5000, seed=3, return_normals=True)):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(0).uniform(-2.5, 2.5, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(mesh.signed_distance(pts), jmesh.signed_distance(pts))
    for a, b in zip(mesh.closest_points(pts), jmesh.closest_points(pts)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "sphere.ply"
    save_mesh(lambda x: (x.norm(dim=-1, keepdim=True) - 0.6), np.array([[-1.0, 1.0]] * 3),
              str(path), resolution=24, device="cpu")
    v, f = jread_ply(str(path))
    assert len(v) > 100 and len(f) > 100


def test_sdf3d_batches_match_jax(sphere):
    kw = dict(batch_size=2 ** 10, total_samples=2 ** 13, trunc_dist=0.3, seed=4)
    ours, ref = Sdf3D(sphere, **kw), JSdf3D(sphere, **kw)
    np.testing.assert_array_equal(ours.bound, ref.bound)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        a, b = ours.sample(r1), ref.sample(r2)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _perturbed(jm, name, scale, seed):
    rng = np.random.default_rng(seed)
    return jm.replace(**{name: tuple(
        f + scale * jnp.asarray(rng.normal(size=f.shape).astype(np.float32))
        for f in getattr(jm, name))})


def test_extract_fields_matches_jax():
    """On a GridNet and on its observed_sdf_query wrapper."""
    jm, _ = _models(seed=1)
    jm = _perturbed(_perturbed(jm, "features", 0.3, 1), "stability", 0.5, 2)
    tm = grid_net_from_numpy(jax_arrays(jm), MODEL_CFG, device="cpu")
    bound = np.asarray(MODEL_CFG["grid"]["bound"], np.float32) * 0.9
    got = extract_fields(tm, bound, 24, chunk=5000)
    assert got.shape == (24, 24, 24)
    close(got, jextract_fields(jm, bound, 24), VAL)
    got = extract_fields(observed_sdf_query(tm), bound, 24, chunk=5000)
    ref = jextract_fields(jobserved_sdf_query(jm), bound, 24)
    assert 0 < (ref == 1e3).mean() < 1
    close(got, ref, VAL)


def test_chamfer_metrics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.03, a.shape).astype(np.float32)
    b[:100] += 1.0
    got, ref = compute_chamfer_metrics(a, b), jchamfer(a, b)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k


def test_trainer_masks_freeze_params(sphere):
    """Mask 0 leaves parameters bit-identical (tests/test_train_e2e.py:94-109)."""
    dataset = Sdf3D(sphere, batch_size=2 ** 10, total_samples=2 ** 13, trunc_dist=0.3)
    _, model = _models()
    loss_fn = make_loss(tsdf_loss_3d, eik_weight=0.0, trunc_dist=0.3)
    mask = grid_net_mask(model, level=0, decoder=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = Trainer(dict(TRAIN_CFG, epochs=5), model, loss_fn, dataset, mask=mask).train()
    assert torch.equal(out.features[1].detach(), before["features.1"])
    assert torch.equal(out.decoder[0].detach(), before["decoder.0"])
    assert float((out.features[0].detach() - before["features.0"]).abs().max()) > 0


def test_grid_trainer_epochs_match_jax(sphere):
    """Six chained GridTrainer epochs (level 0, level 1, then joint, two each)
    from identical parameters on identical batches, eikonal off: the two
    packages' random streams differ, so the eikonal is compared below on
    shared points."""
    kw = dict(batch_size=2 ** 9, total_samples=2 ** 12, trunc_dist=0.3)
    jm, tm = _models()
    hyper = dict(sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0, trunc_dist=0.3)
    jt = JGridTrainer(TRAIN_CFG, jm, jmake_loss(jtsdf, **hyper), JSdf3D(sphere, **kw))
    tt = GridTrainer(TRAIN_CFG, tm, make_loss(tsdf_loss_3d, **hyper), Sdf3D(sphere, **kw))
    jm, tm = jt.train(), tt.train()
    assert tt.active_level == jt.active_level == 2
    assert tt.train_dict == {k: v for k, v in jt.train_dict.items()}
    for name, p in tm.named_parameters():
        close(p, jax_leaf(jm, name), GRAD)
    for name, m in grid_net_mask(tm, level=2).items():
        close(m, jax_leaf(jmask(jm, level=2), name), VAL)


def test_eikonal_matches_jax_on_shared_points():
    jm, _ = _models(seed=3)
    jm = _perturbed(jm, "features", 0.2, 3)
    tm = grid_net_from_numpy(jax_arrays(jm), MODEL_CFG, device="cpu")
    pts = np.random.default_rng(4).uniform(-1.1, 1.1, (500, 3)).astype(np.float32)

    def jloss(m):
        return jeikonal_at(m, jnp.asarray(pts))

    ref_val, ref_grad = jax.jit(jax.value_and_grad(jloss, allow_int=True))(jm)
    val = eikonal_loss_at(tm, t(pts))
    close(val, ref_val, VAL)
    names = [n for n, _ in tm.named_parameters() if n.startswith(("features", "decoder"))]
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(val, [params[n] for n in names], allow_unused=True)
    for n, g in zip(names, grads):
        close(torch.zeros_like(params[n]) if g is None else g, jax_leaf(ref_grad, n), GRAD)
