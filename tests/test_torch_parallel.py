"""The port's sharded steps (``miso_tpu_torch/parallel``, the alignment's pair
axis, ``training/train_decoder.py``) against the JAX package, on the CPU.

One 2-rank gloo job (``tests/_torch_parallel_worker.py``, a ``file://``
rendezvous under the test's temporary directory, one thread a rank) runs
every sharded case of this file once and saves its results; the module's
fixture makes the inputs with numpy and the JAX package, starts the two
ranks, computes the references while they run, and waits for both with a
timeout that kills both.  Each test then holds the ranks' numbers to the
JAX package's on the global batch, or to the port's unsharded run where the
two packages draw different random numbers:

  * the data-parallel step (loss 1e-5, parameters and Adam moments 1e-4)
    with ``tsdf_loss_3d`` (``tests/test_parallel.py``'s recipe) and with
    ``mapping_loss``'s filtered eikonal, a ratio of sums, on shards whose
    selected counts differ (a mean of the ranks' means fails it); the
    eikonal's uniform draw against the port's one-rank step;
  * the scene-parallel gradient against JAX's vmapped one
    (``tests/test_pretrain_parallel.py``), and 2 ranks against 1 after 5
    steps;
  * ``sharded_grid_interpolate`` on a grid of X = 37 rows (padded to 38)
    with points out of bound and on the slab faces: values 1e-5, table and
    points' gradients 1e-4 of the largest entry; the sharded train step's
    loss falls;
  * the pair-sharded alignment against JAX's unsharded
    ``generic_align_multiple_submaps`` (``tests/test_parallel.py``'s set-up;
    with a subsample, against the port's unsharded run), and the
    hierarchical alignment with a mesh;
  * ``submap_parallel_fusion_step`` over (submap 2 x data 1) and (1 x 2)
    meshes against the unsharded step;
  * ``initialize`` from the three environment variables;
  * on a one-rank mesh in the test's own process, the data-parallel, the
    submap-parallel fusion and the scene-parallel decoder steps with a
    frozen decoder leave the decoder's state untouched and equal the update
    over every leaf;
  * ``train_decoder``'s scene-parallel pretraining on 2 ranks against 1,
    and its CLI, whose ``.npz`` loads as ``decoder.pretrained_model`` in
    both packages.
"""
import copy
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_arrays, jax_leaf
from test_torch_atlas import jax_atlas_arrays

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_parallel_worker.py")
JOB_TIMEOUT_S = 420

VAL = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-6)

DP_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
             "bound": [[-1.2, 1.2]] * 3, "base_cell_size": 0.4,
             "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 1},
}
RATIO_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 0.1,
             "bound": [[-1, 1], [-1, 1], [-1, 1]],
             "base_cell_size": 0.5, "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 4},
}
RATIO_LOSS = dict(loss_type="L2", weight_sdf=1.0, weight_eik=0.5, weight_fs=0.2,
                  trunc_dist=0.1)
SCENE_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 1e-3,
             "bound": None, "base_cell_size": 1.0, "per_level_scale": 2.0,
             "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 1},
}
SPATIAL_BOUND = np.array([[-2.0, 2.0], [-1.0, 1.0], [-1.0, 1.5]], np.float32)
FUSION_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 2, "init_stddev": 1e-3,
             "bound": [[-1, 1], [-1, 1], [-1, 1]],
             "base_cell_size": 0.5, "per_level_scale": 2.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 1},
}
FUSION_LOSS = dict(loss_type="L2", weight_sdf=1.0, weight_eik=0.1, weight_fs=0.1,
                   trunc_dist=0.15)
PRETRAIN = dict(trunc_dist=0.15, batch=256, samples=2 ** 12, epochs=2)


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_close(got, ref, frac=1e-4):
    """Gradients to ``frac`` of the largest reference entry."""
    ref = np_(ref)
    np.testing.assert_allclose(np_(got), ref, rtol=0, atol=frac * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def dp_inputs():
    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import icosphere
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.native import TriangleMesh

    ds = Sdf3D(TriangleMesh(*icosphere(2, 0.7)), batch_size=2 ** 12, total_samples=2 ** 14,
               trunc_dist=0.3)
    model = create_grid_net(jax.random.PRNGKey(0), DP_CFG)
    rng = np.random.default_rng(0)
    batches = [ds.sample(rng) for _ in range(2)]
    tsdf = dict(model=jax_arrays(model), cfg=DP_CFG, loss="tsdf_loss_3d",
                loss_kw=dict(eik_weight=0.0, trunc_dist=0.3), batches=batches[:1], lr=1e-3)
    uniform = dict(tsdf, loss_kw=dict(eik_weight=5e1, trunc_dist=0.3), batches=batches)

    r = np.random.default_rng(1)
    N = 1024
    sdf = np.concatenate([r.uniform(-0.08, 0.08, (N // 2, 1)),
                          r.uniform(-0.4, 0.4, (N // 2, 1))]).astype(np.float32)
    ratio_batch = {
        "coords_frame": r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32),
        "sample_frame_ids": r.integers(0, 4, (N,)).astype(np.int32),
        "weights": r.uniform(0.5, 1.5, (N, 1)).astype(np.float32),
        "sdf": sdf, "sdf_valid": (r.uniform(size=(N, 1)) < 0.9).astype(np.float32),
        "sdf_signs": np.where(sdf > 0.05, 1.0, np.where(sdf < -0.05, -1.0, 0.0)).astype(
            np.float32)}
    ratio_model = create_grid_net(jax.random.PRNGKey(3), RATIO_CFG)
    ratio = dict(model=jax_arrays(ratio_model), cfg=RATIO_CFG, loss="mapping_loss",
                 loss_kw=RATIO_LOSS, batches=[ratio_batch], lr=1e-3)
    return {"dp_tsdf": tsdf, "dp_uniform": uniform, "dp_ratio": ratio}, model, ratio_model


def scene_inputs():
    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.native import TriangleMesh
    from miso_tpu.parallel.pretrain import build_scene_stack

    dss = [Sdf3D(TriangleMesh(*room_scene(3.0 + 0.5 * s, seed=s)), batch_size=512,
                 total_samples=2 ** 13, trunc_dist=0.3) for s in range(4)]
    rng = np.random.default_rng(5)
    two = build_scene_stack(SCENE_CFG, [ds.bound for ds in dss[:2]], jax.random.PRNGKey(0))
    batches = [{k: v[:256] for k, v in ds.sample(rng).items()} for ds in dss[:2]]
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (256, 3))) for k in keys])
    grads = dict(arrays=jax_atlas_arrays(two.params), cfg=SCENE_CFG, S=2, batches=batches,
                 uniforms=uniforms, trunc_dist=0.3)
    four = build_scene_stack(SCENE_CFG, [ds.bound for ds in dss], jax.random.PRNGKey(1))
    steps = dict(arrays=jax_atlas_arrays(four.params), cfg=SCENE_CFG, S=4, trunc_dist=0.3,
                 lr=3e-3, batches=[[{k: v[:256] for k, v in ds.sample(rng).items()}
                                    for ds in dss] for _ in range(5)])
    return grads, steps, two, keys


def face_points(X, S, bound, n_y=4):
    """Points whose cell coordinate is on a row face (u an integer, and an
    ulp either side) at the slab faces and the grid's ends."""
    lo, hi = np.float32(bound[0, 0]), np.float32(bound[0, 1])
    cell = np.float32((hi - lo) / np.float32(X))
    xs = []
    for u in (-0.5, 0.0, S - 1, S, 2 * S - 1, X - 1, X - 0.5):
        x = np.float32(lo + np.float32(u + 0.5) * cell)
        xs += [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
    r = np.random.default_rng(9)
    yz = r.uniform(bound[1:, 0], bound[1:, 1], (len(xs) * n_y, 2)).astype(np.float32)
    return np.concatenate([np.repeat(np.asarray(xs, np.float32), n_y)[:, None], yz], axis=1)


def spatial_inputs():
    r = np.random.default_rng(0)
    grid = r.normal(size=(37, 12, 9, 4)).astype(np.float32)
    x = np.concatenate([r.uniform(-2.4, 2.4, (4096, 3)).astype(np.float32),
                        face_points(37, 19, SPATIAL_BOUND)])
    target = r.normal(size=(x.shape[0], 4)).astype(np.float32)
    tx = r.uniform(-1.8, 1.8, (8192, 3)).astype(np.float32)
    tx = tx * np.float32([1.0, 0.5, 0.6]) + np.float32([0.0, 0.0, 0.25])
    ty = (np.linalg.norm(tx, axis=-1, keepdims=True) - 0.8).astype(np.float32)
    return dict(grid=grid, x=x, target=target, bound=SPATIAL_BOUND,
                train_shapes=[(16, 8, 8), (40, 20, 20)], train_x=tx, train_y=ty,
                train_steps=120)


def pair_inputs():
    from test_atlas_align import CFG_MODEL, build_atlas

    def state(n, offset):
        atlas = build_atlas(n, offset=offset)
        return atlas

    a = state(3, 0.4)
    a.set_submap_pose_correction(1, np.array([0, 0, 0.05], np.float32),
                                 np.array([0.05, -0.03, 0.02], np.float32))
    h = state(3, 0.5)
    r = np.random.default_rng(3)
    for s in range(1, 3):
        h.set_submap_pose_correction(s, r.normal(0, 0.02, 3).astype(np.float32),
                                     r.normal(0, 0.04, 3).astype(np.float32))
    bound = np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32)
    common = dict(cfg=CFG_MODEL, max_kfs=4, bound=bound)
    hier = dict(common, arrays=jax_atlas_arrays(h.params),
                tws=[np.array([0.5 * s, 0, 0], np.float32) for s in range(3)],
                kw=dict(level_iters=20, lr=5e-3, align_weight=3000.0, latent_levels=[0],
                        skip_finetune=False, finetune_iters=10))
    return dict(common, arrays=jax_atlas_arrays(a.params),
                tws=[np.array([0.4 * s, 0, 0], np.float32) for s in range(3)],
                pairs=[(0, 1), (0, 2), (1, 2)], iters=15, subsamples=(None, 64),
                hier=hier), a


def fusion_inputs():
    from miso_tpu.models.grid_atlas import GridAtlas

    atlas = GridAtlas(FUSION_CFG, max_kfs_per_submap=1)
    for s in range(2):
        atlas.add_submap(np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32),
                         tws=np.array([0.5 * s, 0, 0], np.float32))
        atlas.add_kf()
    r = np.random.default_rng(7)
    arrays = jax_atlas_arrays(atlas.params)
    arrays["features"] = [r.normal(0, 0.1, f.shape).astype(np.float32)
                          for f in arrays["features"]]
    N = 256
    batches = [{
        "coords_frame": r.uniform(-0.8, 0.8, (N, 3)).astype(np.float32),
        "sample_frame_ids": r.integers(0, 2, (N,)).astype(np.int32),
        "weights": np.ones((N, 1), np.float32),
        "sdf": r.uniform(-0.2, 0.2, (N, 1)).astype(np.float32),
        "sdf_valid": np.ones((N, 1), np.float32),
        "sdf_signs": r.choice([-1.0, 0.0, 1.0], (N, 1)).astype(np.float32)} for _ in range(2)]
    return dict(cfg=FUSION_CFG, max_kfs=1, bound=np.array([[-1, 1]] * 3, np.float32),
                tws=[np.array([0.5 * s, 0, 0], np.float32) for s in range(2)],
                arrays=arrays, batches=batches, loss_kw=FUSION_LOSS, lr=1e-3)


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def jax_dp_reference(model, inp):
    from miso_tpu.losses import miso as jmiso
    from miso_tpu.losses import sdf as jsdf
    from miso_tpu.models.grid_net import grid_net_mask
    from miso_tpu.train.optim import masked_adam_init
    from miso_tpu.train.trainer import make_train_step

    fn = getattr(jsdf, inp["loss"], None) or getattr(jmiso, inp["loss"])
    step = make_train_step(jmiso.make_loss(fn, **inp["loss_kw"]))
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt = masked_adam_init(model)
    losses = []
    for b in inp["batches"]:
        model, opt, tl, _ = step(model, opt, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(1), mask, jnp.float32(inp["lr"]))
        losses.append(float(tl))
    return model, opt, losses


def port_dp_reference(inp):
    from miso_tpu_torch.convert import grid_net_from_numpy
    from miso_tpu_torch.losses import miso, sdf
    from miso_tpu_torch.models.grid_net import grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    model = grid_net_from_numpy(inp["model"], inp["cfg"], device="cpu")
    step = make_train_step(miso.make_loss(getattr(sdf, inp["loss"]), **inp["loss_kw"]))
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt = masked_adam_init(model)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for b in inp["batches"]:
        model, opt, tl, _ = step(model, opt, {k: torch.as_tensor(v) for k, v in b.items()},
                                 gen, mask, inp["lr"])
        losses.append(float(tl))
    return model, opt, losses


def jax_scene_grads(two, inp, keys):
    from miso_tpu.parallel.pretrain import scene_tsdf_loss

    batches = {k: jnp.asarray(np.stack([b[k] for b in inp["batches"]]))
               for k in inp["batches"][0]}

    def obj(p):
        def one(s, k):
            return scene_tsdf_loss(p, s, {kk: v[s] for kk, v in batches.items()}, k,
                                   trunc_dist=inp["trunc_dist"])
        return jnp.mean(jax.vmap(one)(jnp.arange(2), keys))

    return jax.jit(jax.value_and_grad(obj, allow_int=True))(two.params)


def port_scene_steps(inp):
    from miso_tpu_torch.convert import grid_atlas_params_from_numpy
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
    from miso_tpu_torch.parallel.pretrain import scene_parallel_decoder_step, stack_scene_batches
    from miso_tpu_torch.train.optim import masked_adam_init

    params = grid_atlas_params_from_numpy(inp["arrays"], inp["cfg"], inp["S"],
                                          device="cpu").requires_grad_()
    mask = grid_atlas_mask(params, features=True, stability=True, decoder=True,
                           anchor_first_submap=False)
    opt = masked_adam_init(params)
    step = scene_parallel_decoder_step(trunc_dist=inp["trunc_dist"])
    gen = torch.Generator().manual_seed(2)
    losses = []
    for b in inp["batches"]:
        params, opt, tl = step(params, opt, stack_scene_batches(b), gen, mask, inp["lr"])
        losses.append(float(tl))
    return params, losses


def jax_spatial_reference(inp):
    from miso_tpu.ops import interp

    grid, x = jnp.asarray(inp["grid"]), jnp.asarray(inp["x"])

    def loss(g, xx):
        f = interp.grid_interpolate(g, xx, jnp.asarray(inp["bound"]))
        return jnp.mean((f - jnp.asarray(inp["target"])) ** 2), f

    (_, f), (gg, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(grid, x)
    return np.asarray(f), np.asarray(gg), np.asarray(gx)


def port_atlas(inp):
    from miso_tpu_torch.convert import grid_atlas_params_from_numpy
    from miso_tpu_torch.models.grid_atlas import GridAtlas

    atlas = GridAtlas(inp["cfg"], max_kfs_per_submap=inp["max_kfs"], device="cpu")
    for t in inp["tws"]:
        atlas.add_submap(inp["bound"], np.eye(3, dtype=np.float32), t)
        atlas.add_kf()
    atlas.params = grid_atlas_params_from_numpy(inp["arrays"], inp["cfg"], len(inp["tws"]),
                                                device="cpu")
    return atlas


def pair_references(inp, jatlas):
    from miso_tpu.align.miso import generic_align_multiple_submaps as j_align
    from miso_tpu.align.miso import make_vmapped_pair_loss as j_loss
    from miso_tpu_torch.align.miso import (align_multiple_submaps_hierarchical,
                                           generic_align_multiple_submaps,
                                           make_vmapped_pair_loss, pair_context)

    ja = copy.deepcopy(jatlas)
    ja.precompute_coordinates_for_alignment()
    coords = {s: ja.coordinates_for_alignment(s, 0) for s in range(3)}
    pairs = inp["pairs"]
    ctx = (jnp.asarray([s for s, _ in pairs], jnp.int32),
           jnp.asarray([d for _, d in pairs], jnp.int32),
           jnp.stack([coords[s][0] for s, _ in pairs]),
           jnp.stack([coords[s][1] for s, _ in pairs]))
    j_align(ja, j_loss("latent", level=0, align_weight=100.0), num_iters=inp["iters"],
            lr=5e-3, batched_loss=True, loss_ctx=ctx, seed=3, scan=True)
    out = {"jax": (np.asarray(ja.params.sub_rot_corr), np.asarray(ja.params.sub_trans_corr))}
    for sub in inp["subsamples"]:
        atlas = port_atlas(inp)
        atlas.precompute_coordinates_for_alignment()
        generic_align_multiple_submaps(
            atlas, make_vmapped_pair_loss("latent", level=0, align_weight=100.0,
                                          subsample_points=sub),
            num_iters=inp["iters"], lr=5e-3, batched_loss=True,
            loss_ctx=pair_context(atlas, 0, pairs), seed=3)
        out[sub] = (np_(atlas.params.sub_rot_corr), np_(atlas.params.sub_trans_corr))
    atlas = port_atlas(inp["hier"])
    align_multiple_submaps_hierarchical(atlas, **inp["hier"]["kw"])
    out["hier"] = (np_(atlas.params.sub_rot_corr), np_(atlas.params.sub_trans_corr))
    return out


def port_fusion_reference(inp):
    from miso_tpu_torch.losses.fusion import fusion_loss
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    params = port_atlas(inp).params.requires_grad_()
    mask = grid_atlas_mask(params, features=True, stability=True, decoder=True, kf_pose=True,
                           submap_pose=True)
    opt = masked_adam_init(params)
    step = make_train_step(lambda p, b, k: fusion_loss(p, b, k, **inp["loss_kw"]))
    losses = []
    for b in inp["batches"]:
        params, opt, tl, _ = step(params, opt, {k: torch.as_tensor(v) for k, v in b.items()},
                                  None, mask, inp["lr"])
        losses.append(float(tl))
    return params, losses


def port_pretrain_reference(inp):
    from _torch_parallel_worker import small_scenes
    from miso_tpu_torch.training.train_decoder import train_parallel

    return train_parallel(small_scenes(inp), inp["epochs"], inp["trunc_dist"], device="cpu")


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    dp, dp_model, ratio_model = dp_inputs()
    scene, scene_steps, two, keys = scene_inputs()
    pairs, jatlas = pair_inputs()
    inputs = dict(dp, scene=scene, scene_steps=scene_steps, spatial=spatial_inputs(),
                  pairs=pairs, fusion=fusion_inputs(), pretrain=PRETRAIN)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for rank in range(2):
        env = dict(os.environ, MISO_COORDINATOR=f"file://{tmp / 'store'}",
                   MISO_NUM_PROCESSES="2", MISO_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp / "inputs.pkl"), str(tmp / f"rank{rank}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    refs = {}
    try:
        refs["dp_tsdf"] = jax_dp_reference(dp_model, dp["dp_tsdf"])
        refs["dp_ratio"] = jax_dp_reference(ratio_model, dp["dp_ratio"])
        refs["dp_uniform"] = port_dp_reference(dp["dp_uniform"])
        refs["scene"] = jax_scene_grads(two, scene, keys)
        refs["scene_steps"] = port_scene_steps(scene_steps)
        refs["spatial"] = jax_spatial_reference(inputs["spatial"])
        refs["pairs"] = pair_references(pairs, jatlas)
        refs["fusion"] = port_fusion_reference(inputs["fusion"])
        refs["pretrain"] = port_pretrain_reference(PRETRAIN)
        errs = []
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=JOB_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n{errs[rank][-4000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return inputs, refs, ranks


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_initialize_from_the_environment(job):
    """initialize() from MISO_COORDINATOR / NUM_PROCESSES / PROCESS_ID; then
    replicate() gives every rank rank 0's values."""
    _, _, ranks = job
    assert [int(r["init/rank"]) for r in ranks] == [0, 1]
    assert [int(r["init/world"]) for r in ranks] == [2, 2]
    for r in ranks:
        np.testing.assert_array_equal(r["init/replicated"], [1, 1, 1, 0, 1, 2, 3])


def test_pad_and_shard_rows_match_the_jax_package():
    """pad_pair_ctx, shard_pair_ctx, shard_batch and pad_to_multiple keep
    the JAX package's rows, row for row (one rank of two, from a Mesh
    stand-in with its index)."""
    from miso_tpu.parallel import sharding as jsh
    from miso_tpu.parallel.spatial import pad_to_multiple as j_pad
    from miso_tpu_torch.align.miso import PairContext
    from miso_tpu_torch.parallel import sharding as tsh
    from miso_tpu_torch.parallel.spatial import pad_to_multiple

    r = np.random.default_rng(0)
    src, dst = np.int32([0, 0, 1]), np.int32([1, 2, 2])
    coords = r.normal(size=(3, 5, 3)).astype(np.float32)
    valid = np.ones((3, 5, 1), np.float32)
    jctx = jsh.pad_pair_ctx((src, dst, coords, valid), 4)
    tctx = tsh.pad_pair_ctx(PairContext(*(torch.as_tensor(a) for a in (src, dst, coords, valid)),
                                        pairs=((0, 1), (0, 2), (1, 2))), 4)
    for j, t in zip(jctx, tctx):
        np.testing.assert_array_equal(np_(t), np.asarray(j))
    assert tctx.pairs[3] == (0, 0)
    for index in range(2):
        mesh = tsh.Mesh({"data": tsh.Axis("data", 2, index)})
        part = tsh.shard_pair_ctx(tctx, mesh)
        for j, t in zip(jctx, part):
            np.testing.assert_array_equal(np_(t), np.asarray(j)[2 * index:2 * index + 2])
        batch = {"a": r.normal(size=(6, 2)), "b": r.normal(size=(3,))}
        got = tsh.shard_batch(batch, mesh)
        np.testing.assert_array_equal(np_(got["a"]), batch["a"][3 * index:3 * index + 3])
        np.testing.assert_array_equal(np_(got["b"]), batch["b"])
    g = r.normal(size=(37, 2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(np_(pad_to_multiple(torch.as_tensor(g), 8)),
                                  np.asarray(j_pad(jnp.asarray(g), 8)))


def test_one_rank_mesh_without_a_process_group():
    from miso_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh()
    assert mesh.shape == {"data": 1} and mesh.axis("data").group is None
    x = torch.ones(3)
    assert mesh.axis("data").psum(x) is x
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)


def _sdf_batch(r, n, num_ids=None):
    b = {"coords": r.uniform(-0.9, 0.9, (n, 3)), "weights": np.ones((n, 1)),
         "sdf": r.uniform(-0.2, 0.2, (n, 1)), "sdf_valid": np.ones((n, 1)),
         "sdf_signs": r.choice([-1.0, 0.0, 1.0], (n, 1))}
    if num_ids is not None:
        b["coords_frame"] = b.pop("coords")
        b["sample_frame_ids"] = r.integers(0, num_ids, (n,)).astype(np.int32)
    return {k: v if v.dtype == np.int32 else v.astype(np.float32) for k, v in b.items()}


def _one_rank_data_parallel():
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.parallel import sharding

    cfg = copy.deepcopy(RATIO_CFG)
    cfg["decoder"]["fix"] = True
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    r = np.random.default_rng(2)
    batches = [{k: torch.as_tensor(v) for k, v in _sdf_batch(r, 512, 4).items()}
               for _ in range(3)]
    step = sharding.data_parallel_train_step(
        make_loss(mapping_loss, **dict(RATIO_LOSS, weight_eik=0.0)), sharding.make_mesh())
    return sharding, model, mask, batches, lambda m, o, b: step(m, o, b, None, mask, 1e-2)[:2]


def _one_rank_submap_parallel_fusion():
    from miso_tpu_torch.losses.fusion import fusion_loss
    from miso_tpu_torch.models.grid_atlas import GridAtlas, grid_atlas_mask
    from miso_tpu_torch.parallel import sharding

    atlas = GridAtlas(FUSION_CFG, max_kfs_per_submap=1, device="cpu")
    for s in range(2):
        atlas.add_submap(np.array([[-1, 1]] * 3, np.float32),
                         tws=np.array([0.5 * s, 0, 0], np.float32))
        atlas.add_kf()
    params = atlas.params
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for f in params.features:
            f.copy_(0.1 * torch.randn(f.shape, generator=g))
    params.requires_grad_()
    mask = grid_atlas_mask(params, features=True, stability=True, kf_pose=True,
                           submap_pose=True)
    r = np.random.default_rng(7)
    batches = [{k: torch.as_tensor(v) for k, v in _sdf_batch(r, 256, 2).items()}
               for _ in range(3)]
    step = sharding.submap_parallel_fusion_step(
        lambda p, b, k: fusion_loss(p, b, k, **FUSION_LOSS),
        sharding.make_mesh(1, ("submap", "data"), (1, 1)))
    return sharding, params, mask, batches, lambda m, o, b: step(m, o, b, None, mask, 1e-2)[:2]


def _one_rank_scene_parallel_decoder():
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
    from miso_tpu_torch.parallel import pretrain

    bounds = [np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32),
              np.array([[-1, 1.5], [-1, 1], [-1, 0.5]], np.float32)]
    params = pretrain.build_scene_stack(SCENE_CFG, bounds, torch.Generator().manual_seed(5),
                                        device="cpu").params
    mask = grid_atlas_mask(params, features=True, stability=True, anchor_first_submap=False)
    r = np.random.default_rng(5)
    batches = [pretrain.stack_scene_batches([_sdf_batch(r, 256) for _ in bounds])
               for _ in range(3)]
    step = pretrain.scene_parallel_decoder_step(trunc_dist=0.15)
    gen = torch.Generator().manual_seed(2)
    return pretrain, params, mask, batches, lambda m, o, b: step(m, o, b, gen, mask, 1e-2)[:2]


ONE_RANK_STEPS = {"data_parallel": _one_rank_data_parallel,
                  "submap_parallel_fusion": _one_rank_submap_parallel_fusion,
                  "scene_parallel_decoder": _one_rank_scene_parallel_decoder}


@pytest.mark.parametrize("kind", sorted(ONE_RANK_STEPS))
def test_one_rank_step_leaves_a_frozen_decoder_alone(kind, monkeypatch):
    """A sharded step on a one-rank mesh, decoder frozen by its mask: the
    decoder's parameters and Adam state stay untouched, and every leaf and
    moment equals the update over every leaf, bit for bit."""
    from miso_tpu_torch.train.optim import masked_adam_init

    def run(full):
        with monkeypatch.context() as mp:
            module, model, mask, batches, step = ONE_RANK_STEPS[kind]()
            if full:
                # The guarded update over every leaf, the frozen ones included.
                mp.setattr(module, "trained_leaves", lambda names, mask: list(names))
            named = dict(model.named_parameters())
            start = {k: v.detach().clone() for k, v in named.items()}
            opt = masked_adam_init(model)
            state = {k: (named[k], opt.m[k], opt.v[k], opt.step[k]) for k in opt.m}
            versions = {k: [t._version for t in ts] for k, ts in state.items()}
            for b in batches:
                model, opt = step(model, opt, b)
        return dict(model.named_parameters()), opt, start, state, versions

    params, opt, start, state, versions = run(full=False)
    ref_params, ref_opt, *_ = run(full=True)
    decoder = [k for k in params if k.startswith("decoder.")]
    assert decoder
    for k in decoder:
        assert torch.equal(params[k], start[k]), k
        got = (params[k], opt.m[k], opt.v[k], opt.step[k])
        # Untouched: the same tensors, never written (their versions as at
        # the start), the moments still zero.
        assert all(a is b for a, b in zip(got, state[k])), k
        assert [t._version for t in got] == versions[k], k
        assert not any(torch.any(t) for t in got[1:]), k
    for k, p in params.items():
        np.testing.assert_array_equal(np_(p), np_(ref_params[k]), err_msg=k)
        for field in ("m", "v", "step"):
            np.testing.assert_array_equal(np_(getattr(opt, field)[k]),
                                          np_(getattr(ref_opt, field)[k]), err_msg=k)
    assert not torch.equal(params["features.1"], start["features.1"])


@pytest.mark.parametrize("case", ["dp_tsdf", "dp_ratio"])
def test_data_parallel_step_matches_jax_on_the_global_batch(job, case):
    """Loss 1e-5; parameters and Adam moments after the step 1e-4."""
    _, refs, ranks = job
    jm, jopt, jlosses = refs[case]
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/loss0"], jlosses[0], rtol=1e-5)
        for name in [k.split("/", 1)[1] for k in r if k.startswith(case + "/")
                     and k.split("/", 1)[1].split(".")[0] in ("features", "decoder")]:
            np.testing.assert_allclose(r[f"{case}/{name}"], np.asarray(jax_leaf(jm, name)),
                                       **PARAM)
            np.testing.assert_allclose(r[f"{case}/m.{name}"],
                                       np.asarray(jax_leaf(jopt.m, name)), **PARAM)
            np.testing.assert_allclose(r[f"{case}/v.{name}"],
                                       np.asarray(jax_leaf(jopt.v, name)), rtol=1e-4,
                                       atol=1e-12)
    for k in ranks[0]:
        if k.startswith(case + "/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_ratio_case_shards_select_different_counts(job):
    """The filtered eikonal's denominators differ between the shards, so a
    mean of the ranks' ratios is not the global ratio."""
    inputs, _, _ = job
    sdf = inputs["dp_ratio"]["batches"][0]["sdf"]
    counts = [int(np.sum(np.abs(half) < 0.1)) for half in np.split(sdf, 2)]
    assert counts[0] > 1.5 * counts[1], counts


def test_data_parallel_uniform_eikonal_matches_one_rank(job):
    """tsdf_loss_3d with the eikonal's uniform draw, 2 steps: every rank
    draws the one-rank step's points for the global batch."""
    _, refs, ranks = job
    model, opt, losses = refs["dp_uniform"]
    for r in ranks:
        for i, l in enumerate(losses):
            np.testing.assert_allclose(r[f"dp_uniform/loss{i}"], l, rtol=1e-5)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(r[f"dp_uniform/{k}"], np_(p), **PARAM)


def test_scene_parallel_gradient_matches_jax_vmapped(job):
    """2 scenes on 2 ranks: the decoder's gradient summed over the ranks and
    each scene's grid gradient against JAX's vmapped objective."""
    inputs, refs, ranks = job
    loss, g = refs["scene"]
    inp = inputs["scene"]
    for r in ranks:
        np.testing.assert_allclose(r["scene/loss"], float(loss), rtol=1e-5)
        for i, (W, b) in enumerate(g.decoder):
            grad_close(r[f"scene/decoder.{2 * i}"], W)
            grad_close(r[f"scene/decoder.{2 * i + 1}"], b)
    pads = inp["arrays"]["pad_spatial"]
    for level, pad in enumerate(pads):
        ref = np.asarray(g.features[level]).reshape(2, *pad, -1)
        got = np.concatenate([r[f"scene/features.{level}"] for r in ranks])
        grad_close(got, ref)


def test_scene_parallel_two_ranks_match_one_after_five_steps(job):
    _, refs, ranks = job
    params, losses = refs["scene_steps"]
    for r in ranks:
        np.testing.assert_allclose([r[f"scene_steps/loss{i}"] for i in range(5)], losses,
                                   rtol=1e-5)
        for i, t in enumerate(x for pair in params.decoder for x in pair):
            grad_close(r[f"scene_steps/decoder.{i}"], t)
    for level, f in enumerate(params.features):
        got = np.concatenate([r[f"scene_steps/features.{level}"] for r in ranks])
        grad_close(got, f)


def test_sharded_grid_interpolate_matches_jax(job):
    """X = 37 (padded to 2 slabs of 19), points out of bound and on the
    slab faces: values 1e-5, table and points' gradients 1e-4 of the
    largest entry."""
    inputs, refs, ranks = job
    f, gg, gx = refs["spatial"]
    for r in ranks:
        np.testing.assert_allclose(r["spatial/values"], f, rtol=1e-5, atol=1e-5)
        grad_close(r["spatial/grad_x"], gx)
    got = np.concatenate([r["spatial/grad_slab"] for r in ranks])
    grad_close(got[:37], gg)
    assert not np.any(got[37:])
    faces = len(face_points(37, 19, SPATIAL_BOUND))
    np.testing.assert_allclose(ranks[0]["spatial/values"][-faces:], f[-faces:], rtol=1e-5,
                               atol=1e-5)


def test_sharded_sdf_train_step_loss_falls(job):
    _, _, ranks = job
    for r in ranks:
        losses = r["spatial/train_losses"]
        assert np.all(np.isfinite(losses))
        assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    np.testing.assert_array_equal(ranks[0]["spatial/train_losses"],
                                  ranks[1]["spatial/train_losses"])


@pytest.mark.parametrize("subsample", [None, 64])
def test_pair_sharded_alignment_matches_unsharded(job, subsample):
    """3 pairs padded to 4, 2 a rank: the poses of the unsharded port run
    (rtol 1e-5, atol 1e-6, JAX's sharded-against-one tolerance) and, without
    a subsample, of the JAX package's (1e-4, the alignment tests'); with
    one, the two packages draw different subsamples."""
    _, refs, ranks = job
    rot, trans = refs["pairs"][subsample]
    assert np.abs(trans[1:]).max() > 0
    for r in ranks:
        np.testing.assert_allclose(r[f"pairs/rot{subsample}"], rot, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[f"pairs/trans{subsample}"], trans, rtol=1e-5, atol=1e-6)
        if subsample is None:
            jr, jt = refs["pairs"]["jax"]
            np.testing.assert_allclose(r["pairs/rotNone"], jr, rtol=0, atol=1e-4)
            np.testing.assert_allclose(r["pairs/transNone"], jt, rtol=0, atol=1e-4)


def test_hierarchical_alignment_with_a_mesh(job):
    _, refs, ranks = job
    rot, trans = refs["pairs"]["hier"]
    for r in ranks:
        np.testing.assert_allclose(r["pairs/hier_rot"], rot, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["pairs/hier_trans"], trans, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_submap_parallel_fusion_step_matches_unsharded(job, shape):
    """(submap x data) = (2 x 1): one submap a rank, the world query's sums
    crossing the ranks; (1 x 2): the batch split, the filtered eikonal's
    sums crossing them.  Two steps, losses 1e-5, parameters 1e-4."""
    _, refs, ranks = job
    params, losses = refs["fusion"]
    tag = f"fusion{shape.replace('x', 'x')}"
    S = params.capacity
    for r in ranks:
        np.testing.assert_allclose([r[f"{tag}/loss{i}"] for i in range(2)], losses, rtol=1e-5)
    for k, p in params.named_parameters():
        ref = np_(p)
        if shape == "2x1" and (k.startswith(("features", "stability", "sub_"))):
            got = np.concatenate([r[f"{tag}/{k}"] for r in ranks])
            assert got.shape[0] == S
        else:
            got = ranks[0][f"{tag}/{k}"]
            np.testing.assert_array_equal(got, ranks[1][f"{tag}/{k}"])
        np.testing.assert_allclose(got, ref, **PARAM)


def test_train_decoder_parallel_two_ranks_match_one(job):
    _, refs, ranks = job
    res = refs["pretrain"]
    for r in ranks:
        for i, (W, b) in enumerate(res["decoder"]):
            np.testing.assert_allclose(r[f"pretrain/W{i}"], np_(W), **PARAM)
            np.testing.assert_allclose(r[f"pretrain/b{i}"], np_(b), **PARAM)
        for k, v in res["stage_losses"].items():
            np.testing.assert_allclose(r[f"pretrain/{k}"], v, rtol=1e-5)


def test_train_decoder_cli_file_loads_in_both_packages(tmp_path):
    """``--synthetic --parallel`` for 2 epochs a stage on one rank; the
    saved decoder loads as decoder.pretrained_model in the port and in the
    JAX package, bit for bit."""
    from miso_tpu.models.grid_net import create_grid_net as j_create
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.training import train_decoder

    assert train_decoder.main(["--synthetic", "--parallel", "--epochs", "2", "--device", "cpu",
                               "--save_dir", str(tmp_path)]) == 0
    path = str(tmp_path / "decoder_indoor.npz")
    cfg = copy.deepcopy(train_decoder.MODEL_CFG)
    cfg["grid"]["bound"] = [[-1, 1]] * 3
    cfg["decoder"].update(pretrained_model=path, fix=True)
    t = create_grid_net(cfg, device="cpu")
    j = j_create(jax.random.PRNGKey(0), cfg)
    saved = np.load(path)
    assert len(saved.files) == 2 * len(j.decoder)
    for i, (W, b) in enumerate(j.decoder):
        np.testing.assert_array_equal(np_(t.decoder[2 * i]), np.asarray(W))
        np.testing.assert_array_equal(np_(t.decoder[2 * i + 1]), np.asarray(b))
    assert t.decoder_fixed
