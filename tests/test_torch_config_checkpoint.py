"""The port's configs and checkpoints against the JAX package's.

* ``load_config`` of every ``configs/*.yaml`` (and an ``inherit_from``
  chain) equals the JAX package's;
* ``cfg_model`` / ``cfg_loss`` / ``cfg_dataset`` / ``cfg_trainer`` build the
  same objects for the ported names (values to 1e-5 relative, float32 sums
  in another order) and raise ``NotImplementedError`` for the others;
* ``save_pytree`` files interchange in both directions, a decoder saved by
  either package loads as a ``pretrained_model``;
* a resumed CPU trainer is bit-identical to an uninterrupted one (the JAX
  package's tests/test_resume.py, on the port).
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from _torch_port import VAL, close, jax_arrays, t
from miso_tpu import config as j_config
from miso_tpu.models.grid_net import create_grid_net as j_create
from miso_tpu.train import checkpoint as j_ckpt
from miso_tpu_torch import config as t_config
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.losses.miso import make_loss
from miso_tpu_torch.losses.sdf import sdf_loss_3d
from miso_tpu_torch.models.grid_net import GridNet, create_grid_net
from miso_tpu_torch.train import checkpoint as t_ckpt
from miso_tpu_torch.train.trainer import GridTrainer, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_load_config_matches_jax(path):
    assert t_config.load_config(path) == j_config.load_config(path)
    base = os.path.join(ROOT, "configs", "base.yaml")
    assert (t_config.load_config(path, default_path=base)
            == j_config.load_config(path, default_path=base))


def test_inherit_from_and_save_config(tmp_path):
    (tmp_path / "a.yaml").write_text("model:\n  grid:\n    n_levels: 3\n  name: x\nseed: 4\n")
    (tmp_path / "b.yaml").write_text("inherit_from: a.yaml\nmodel:\n  grid:\n"
                                     "    feature_dim: 2\nseed: 5\n")
    path = str(tmp_path / "b.yaml")
    cfg = t_config.load_config(path)
    assert cfg == j_config.load_config(path)
    assert cfg == {"model": {"grid": {"n_levels": 3, "feature_dim": 2}, "name": "x"},
                   "seed": 5, "inherit_from": "a.yaml"}
    out = str(tmp_path / "snap" / "cfg.yaml")
    snap = dict(cfg, arr=np.arange(3), f=np.float32(1.5))
    del snap["inherit_from"]
    t_config.save_config(snap, out)
    assert t_config.load_config(out) == dict(snap, arr=[0, 1, 2], f=1.5)


def _scannet(**decoder):
    cfg = t_config.load_config(os.path.join(ROOT, "configs", "rgbd", "scannet.yaml"))
    cfg["model"]["grid"]["bound"] = [[-1.0, 1.5], [-1.0, 1.0], [-0.5, 1.0]]
    cfg["model"]["pose"]["num_poses"] = 3
    cfg["model"]["decoder"].update({"hidden_dim": 16, "pretrained_model": None, **decoder})
    return cfg


def test_cfg_model_matches_jax():
    cfg = _scannet()
    m = t_config.cfg_model(cfg, device="cpu")
    mj = j_config.cfg_model(cfg, jax.random.PRNGKey(0))
    assert isinstance(m, GridNet)
    assert (m.num_levels, m.fdim, m.cell_sizes, m.decoder_fixed, m.pos_invariant,
            m.num_poses) == (mj.num_levels, mj.fdim, mj.cell_sizes, mj.decoder_fixed,
                             mj.pos_invariant, mj.num_poses)
    for a, b in zip(m.features, mj.features):      # init_stddev 0: zeros
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for (W, b), (Wj, bj) in zip(m.decoder_params, mj.decoder):
        assert W.shape == Wj.shape and b.shape == bj.shape
    close(m.bound, mj.bound, VAL)
    # The same seed gives the same model.
    m2 = t_config.cfg_model(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), m2.parameters()))


def _batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"coords_frame": rng.uniform([-0.9, -0.9, -0.4], [1.4, 0.9, 0.9], (n, 3)
                                        ).astype(np.float32),
            "coords": rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
            "sample_frame_ids": rng.integers(0, 3, (n,)).astype(np.int32),
            "weights": np.ones((n, 1), np.float32),
            "sdf": rng.uniform(-0.3, 0.3, (n, 1)).astype(np.float32),
            "sdf_valid": (rng.uniform(size=(n, 1)) < 0.8).astype(np.float32),
            "sdf_signs": rng.choice([-1.0, 0.0, 1.0], (n, 1)).astype(np.float32)}


@pytest.mark.parametrize("name", ["MisoMapping", "MisoTracking", "Tsdf3D", "Sdf3D",
                                  "PosedSdf3D", "iSDF"])
def test_cfg_loss_matches_jax(name):
    cfg = _scannet()
    cfg["model"]["grid"]["init_stddev"] = 0.1
    # base.yaml's loss with eik_weight 0: its eikonal points are drawn from the
    # loss's key, a JAX key on one side and a torch generator on the other.
    cfg["loss"] = dict(t_config.load_config(os.path.join(ROOT, "configs", "base.yaml"))["loss"],
                       name=name, eik_weight=0.0)
    mj = j_config.cfg_model(cfg, jax.random.PRNGKey(1))
    m = grid_net_from_numpy(jax_arrays(mj), cfg["model"], device="cpu")
    b = _batch()
    got = t_config.cfg_loss(cfg)(m, {k: t(v) for k, v in b.items()}, None)
    ref = j_config.cfg_loss(cfg)(mj, {k: jax.numpy.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(0))
    assert got.keys() == ref.keys()
    for k in got:
        close(got[k], ref[k], dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("kind,name", [
    ("model", "isdf"), ("model", "pointsdf"), ("model", "ngp"),
    ("loss", "Sdf2D"), ("dataset", "Sdf2D"), ("dataset", "PosedSdf3DLidar"),
    ("dataset", "ScanNet"), ("dataset", "ReplicaCAD"), ("dataset", "FastCaMo")])
def test_unported_entries_raise(kind, name):
    cfg = _scannet()
    cfg[kind] = dict(cfg.get(kind, {}), name=name)
    build = {"model": lambda: t_config.cfg_model(cfg, device="cpu"),
             "loss": lambda: t_config.cfg_loss(cfg),
             "dataset": lambda: t_config.cfg_dataset(cfg)}[kind]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build()
    with pytest.raises(ValueError, match="Unknown"):
        cfg[kind]["name"] = "no_such_entry"
        build()


def test_cfg_dataset_builds_posed_sdf3d(tmp_path):
    """``dataset.name: PosedSdf3D`` from a mesh file: the JAX registry's
    dataset's camera positions and sizes (its rotations come from a JAX key,
    the port's from a torch generator)."""
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.utils.sdf import write_ply
    path = str(tmp_path / "room.ply")
    write_ply(path, *room_scene(3.0, seed=2))
    cfg = {"dataset": {"name": "PosedSdf3D", "path": path, "frame_batchsize": 32,
                       "frame_samples": 128, "num_frames": 3, "trunc_dist": 0.2}}
    got, ref = t_config.cfg_dataset(cfg), j_config.cfg_dataset(cfg)
    assert type(got).__name__ == type(ref).__name__ == "PosedSdf3D"
    np.testing.assert_array_equal(got.t_world_frame_gt, ref.t_world_frame_gt)
    assert (got.num_frames, got.frame_samples, got.frame_batchsize, got.trunc_dist) == \
        (ref.num_frames, ref.frame_samples, ref.frame_batchsize, ref.trunc_dist)
    assert got.sample(np.random.default_rng(0))["coords_frame"].shape == (3 * 32, 3)


def test_cfg_model_builds_the_atlas():
    """``model.name: grid_atlas`` builds an empty GridAtlas with the system's
    submap size and capacity, as the JAX registry does."""
    cfg = _scannet()
    cfg["model"]["name"] = "grid_atlas"
    cfg["system"].update({"submap_size": 7, "submap_capacity": 3})
    atlas = t_config.cfg_model(cfg, device="cpu")
    ref = j_config.cfg_model(cfg, jax.random.PRNGKey(0))
    assert type(atlas).__name__ == type(ref).__name__ == "GridAtlas"
    assert (atlas.max_kfs, atlas.capacity, atlas.num_submaps) == \
        (ref.max_kfs, ref.capacity, ref.num_submaps) == (7, 3, 0)


def test_cfg_model_defaults_to_the_card():
    cfg = _scannet()
    if torch.cuda.is_available():
        assert t_config.cfg_model(cfg).bound.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            t_config.cfg_model(cfg)


def test_cfg_dataset_and_trainer(tmp_path):
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.utils.sdf import write_ply

    path = str(tmp_path / "room.ply")
    write_ply(path, *room_scene(3.0))
    cfg = t_config.load_config(os.path.join(ROOT, "configs", "base.yaml"))
    cfg["dataset"].update({"path": path, "trunc_dist": 0.2})
    cfg["train"].update({"batch_size": 512, "log_dir": str(tmp_path / "log")})
    ds, dsj = t_config.cfg_dataset(cfg), j_config.cfg_dataset(cfg)
    a, b = ds.sample(np.random.default_rng(2)), dsj.sample(np.random.default_rng(2))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    model = t_config.cfg_model(cfg, device="cpu")
    tr = t_config.cfg_trainer(cfg, model, t_config.cfg_loss(cfg), ds)
    assert type(tr) is Trainer
    assert t_config.load_config(str(tmp_path / "log" / "cfg.yaml")) == cfg
    cfg["train"]["trainer"] = "grid"
    assert type(t_config.cfg_trainer(cfg, model, t_config.cfg_loss(cfg), ds)) is GridTrainer


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

CFG_MODEL = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 1e-3,
             "bound": [[-1, 1], [-1, 1], [-1, 1]],
             "base_cell_size": 0.5, "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 3},
}


def _params(m):
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


def test_grid_net_files_interchange(tmp_path):
    mj = j_create(jax.random.PRNGKey(3), CFG_MODEL)
    mj = mj.set_initial_kf_pose(1, jax.numpy.eye(3) * -1.0, jax.numpy.ones(3))
    mj = mj.replace(rot_corr=mj.rot_corr.at[2].set(0.5), anchor_kf=jax.numpy.int32(4))
    path = str(tmp_path / "j.npz")
    j_ckpt.save_pytree(path, mj, meta={"who": "jax"})
    m = create_grid_net(CFG_MODEL, device="cpu", generator=torch.Generator().manual_seed(1))
    assert t_ckpt.load_pytree(path, like=m) is m
    ref = grid_net_from_numpy(jax_arrays(mj), CFG_MODEL, device="cpu")
    for (k, a), b in zip(m.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    assert t_ckpt.load_meta(path) == {"who": "jax"}
    # ... and back: the port's file loads in the JAX package.
    with torch.no_grad():
        m.features[0].add_(1.0)
        m.trans_corr[0] = 7.0
    path2 = str(tmp_path / "t.npz")
    t_ckpt.save_pytree(path2, m)
    assert t_ckpt.load_meta(path2) is None
    back = j_ckpt.load_pytree(path2, like=mj)
    arr = jax_arrays(back)
    for name, v in _params(m).items():
        head, _, idx = name.partition(".")
        want = arr[head] if not idx else (
            arr[head][int(idx) // 2][int(idx) % 2] if head == "decoder" else arr[head][int(idx)])
        np.testing.assert_array_equal(v, want)
    assert int(back.anchor_kf) == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pretrained_decoder(tmp_path, writer):
    dec_j = j_create(jax.random.PRNGKey(5), CFG_MODEL).decoder
    path = str(tmp_path / "decoder.npz")
    if writer == "jax":
        j_ckpt.save_pytree(path, dec_j)
    else:
        src = grid_net_from_numpy(jax_arrays(j_create(jax.random.PRNGKey(5), CFG_MODEL)),
                                  CFG_MODEL, device="cpu")
        t_ckpt.save_pytree(path, src.decoder_params)
    cfg = dict(CFG_MODEL, decoder=dict(CFG_MODEL["decoder"], pretrained_model=path, fix=True))
    m = create_grid_net(cfg, device="cpu")
    assert m.decoder_fixed
    for (W, b), (Wj, bj) in zip(m.decoder_params, dec_j):
        np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
        assert not W.requires_grad       # decoder.fix: the decoder is detached
    mj = j_create(jax.random.PRNGKey(0), cfg)
    for (W, _), (Wj, _) in zip(m.decoder_params, mj.decoder):
        np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))


def test_model_pickle_and_torch_decoder(tmp_path):
    m = create_grid_net(CFG_MODEL, device="cpu")
    path = str(tmp_path / "m.pkl")
    t_ckpt.save_model_pickle(path, m)
    m2 = t_ckpt.load_model_pickle(path, device="cpu")
    assert isinstance(m2, GridNet) and m2.cell_sizes == m.cell_sizes
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 m2.state_dict().values()))
    sd = {"network.0.weight": torch.randn(16, 8), "network.0.bias": torch.randn(16),
          "network.2.weight": torch.randn(1, 16)}
    torch.save(sd, str(tmp_path / "dec.pt"))
    dec = t_ckpt.import_torch_mlp_decoder(str(tmp_path / "dec.pt"), device="cpu")
    assert torch.equal(dec[0][0], sd["network.0.weight"].T) and dec[1][1] is None
    assert torch.equal(dec[0][1], sd["network.0.bias"])


class SphereSdf:
    def sample(self, rng):
        x = rng.uniform(-0.9, 0.9, (256, 3)).astype(np.float32)
        sdf = (np.linalg.norm(x, axis=1, keepdims=True) - 0.5).astype(np.float32)
        return {"coords": x, "sdf": sdf, "sdf_valid": np.ones_like(sdf),
                "sdf_signs": np.zeros_like(sdf)}


LOSS = make_loss(sdf_loss_3d, sdf_weight=1.0)


def _model():
    return create_grid_net(CFG_MODEL, device="cpu", generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("kind", ["grid", "base"])
def test_trainer_resume_bit_exact(tmp_path, kind):
    cfg = {"optimizer": "adam", "learning_rate": 1e-2, "epochs": 24,
           "max_epochs_in_level": 7, "relchange_tol": 1e-4,
           "grid_training_mode": "coordinate+joint"}
    cls = GridTrainer if kind == "grid" else Trainer
    full = cls(dict(cfg), _model(), LOSS, SphereSdf(), seed=3)
    model_full = full.train()
    part = cls(dict(cfg, epochs=10), _model(), LOSS, SphereSdf(), seed=3)
    part.train()
    path = str(tmp_path / "ckpt.npz")
    part.save_checkpoint(path, epoch=10)
    res = cls(dict(cfg), _model(), LOSS, SphereSdf(), seed=999)
    assert res.load_checkpoint(path) == 10
    model_res = res.train()
    for a, b in zip(model_res.state_dict().values(), model_full.state_dict().values()):
        assert torch.equal(a, b)
    for part_ in ("m", "v", "step"):
        for k, v in getattr(full.opt_state, part_).items():
            assert torch.equal(getattr(res.opt_state, part_)[k], v), (part_, k)
    if kind == "grid":
        assert (res.active_level, res.epochs_in_level) == (full.active_level,
                                                            full.epochs_in_level)


def test_ckpt_every_writes_the_train_state(tmp_path):
    cfg = {"optimizer": "adam", "learning_rate": 1e-2, "epochs": 3, "ckpt_every": 2,
           "log_dir": str(tmp_path)}
    Trainer(dict(cfg), _model(), LOSS, SphereSdf(), seed=0).train()
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names == ["ckpt_0.npz", "ckpt_2.npz", "final.npz"]
    with np.load(tmp_path / "ckpt" / "final.npz") as data:
        keys = list(data.keys())
    assert any(k.startswith("arr::['opt_state']") for k in keys)
    assert "arr::['model']/.features/[0]" in keys and "arr::['key']" in keys
