"""One rank of tests/test_torch_parallel.py's 2-rank gloo job on the CPU.

    MISO_COORDINATOR=file://<store> MISO_NUM_PROCESSES=2 MISO_PROCESS_ID=<r> \
        python tests/_torch_parallel_worker.py <inputs.pkl> <results_r.npz>

The parent makes every input with numpy (and the JAX package) and pickles
it; each rank runs every case of the file through the port's sharded
functions and saves its results, flat ``<case>/<name>`` arrays, for the
parent to compare.  No JAX here: this process imports only the port.
"""
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from miso_tpu_torch.parallel import distributed  # noqa: E402


def np_(t):
    return t.detach().cpu().numpy()


def atlas_from_arrays(inp):
    """A port GridAtlas with the structure of ``inp`` (cfg, submap
    translations, keyframes a submap) holding the JAX atlas's arrays."""
    from miso_tpu_torch.convert import grid_atlas_params_from_numpy
    from miso_tpu_torch.models.grid_atlas import GridAtlas

    atlas = GridAtlas(inp["cfg"], max_kfs_per_submap=inp["max_kfs"], device="cpu")
    for t in inp["tws"]:
        atlas.add_submap(inp["bound"], np.eye(3, dtype=np.float32), t)
        atlas.add_kf()
    atlas.params = grid_atlas_params_from_numpy(inp["arrays"], inp["cfg"], len(inp["tws"]),
                                                device="cpu")
    return atlas


def data_parallel(inp, mesh, out, tag):
    from miso_tpu_torch.convert import grid_net_from_numpy
    from miso_tpu_torch.losses import miso, sdf
    from miso_tpu_torch.models.grid_net import grid_net_mask
    from miso_tpu_torch.parallel.sharding import data_parallel_train_step, shard_batch
    from miso_tpu_torch.train.optim import masked_adam_init

    model = grid_net_from_numpy(inp["model"], inp["cfg"], device="cpu")
    loss_fn = miso.make_loss(getattr(sdf, inp["loss"], None) or getattr(miso, inp["loss"]),
                             **inp["loss_kw"])
    step = data_parallel_train_step(loss_fn, mesh)
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt = masked_adam_init(model)
    gen = torch.Generator().manual_seed(1)
    for i, b in enumerate(inp["batches"]):
        model, opt, tl, _ = step(model, opt, shard_batch(b, mesh), gen, mask, inp["lr"])
        out[f"{tag}/loss{i}"] = np_(tl)
    for k, p in model.named_parameters():
        out[f"{tag}/{k}"] = np_(p)
        out[f"{tag}/m.{k}"] = np_(opt.m[k])
        out[f"{tag}/v.{k}"] = np_(opt.v[k])


def scene_grads(inp, mesh, out):
    from miso_tpu_torch.convert import grid_atlas_params_from_numpy
    from miso_tpu_torch.parallel.pretrain import (scene_parallel_grads, shard_scene_stack,
                                                  stack_scene_batches)

    params = grid_atlas_params_from_numpy(inp["arrays"], inp["cfg"], inp["S"], device="cpu")
    params = shard_scene_stack(params, mesh)
    rows = mesh.axis("scene").rows(inp["S"])
    batches = stack_scene_batches(inp["batches"], mesh)
    names = [k for k, _ in params.named_parameters()]
    tl, grads = scene_parallel_grads(params, batches, None, names, trunc_dist=inp["trunc_dist"],
                                     uniforms=torch.as_tensor(inp["uniforms"][rows]))
    out["scene/loss"] = np_(tl)
    for k, g in grads.items():
        out[f"scene/{k}"] = np_(g)


def scene_steps(inp, mesh, out):
    from miso_tpu_torch.convert import grid_atlas_params_from_numpy
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
    from miso_tpu_torch.parallel.pretrain import (scene_parallel_decoder_step,
                                                  shard_scene_stack, stack_scene_batches)
    from miso_tpu_torch.train.optim import masked_adam_init

    params = grid_atlas_params_from_numpy(inp["arrays"], inp["cfg"], inp["S"], device="cpu")
    params = shard_scene_stack(params, mesh)
    mask = grid_atlas_mask(params, features=True, stability=True, decoder=True,
                           anchor_first_submap=False)
    opt = masked_adam_init(params)
    step = scene_parallel_decoder_step(trunc_dist=inp["trunc_dist"])
    gen = torch.Generator().manual_seed(2)
    for i, b in enumerate(inp["batches"]):
        params, opt, tl = step(params, opt, stack_scene_batches(b, mesh), gen, mask, inp["lr"])
        out[f"scene_steps/loss{i}"] = np_(tl)
    for k, p in params.named_parameters():
        out[f"scene_steps/{k}"] = np_(p)


def spatial(inp, mesh, out):
    from miso_tpu_torch.parallel.spatial import (shard_grid_spatial, sharded_grid_interpolate,
                                                 sharded_sdf_train_step)

    slab, xl = shard_grid_spatial(torch.as_tensor(inp["grid"]), mesh)
    slab.requires_grad_()
    x = torch.as_tensor(inp["x"]).requires_grad_()
    f = sharded_grid_interpolate(slab, x, inp["bound"], xl, mesh)
    loss = torch.mean((f - torch.as_tensor(inp["target"])) ** 2)
    g_slab, g_x = torch.autograd.grad(loss, [slab, x])
    out["spatial/values"] = np_(f)
    out["spatial/grad_slab"] = np_(g_slab)
    out["spatial/grad_x"] = np_(g_x)

    W = torch.full((8, 1), 0.25)
    step = sharded_sdf_train_step(lambda feats: feats @ W, mesh, lr=2e-2)
    slabs, logical = [], []
    for shape in inp["train_shapes"]:
        s, l = shard_grid_spatial(torch.zeros(tuple(shape) + (4,)), mesh)
        slabs.append(s)
        logical.append(l)
    xs, y = torch.as_tensor(inp["train_x"]), torch.as_tensor(inp["train_y"])
    valid = torch.ones_like(y)
    opt, losses = None, []
    for _ in range(inp["train_steps"]):
        slabs, opt, l = step(slabs, opt, logical, inp["bound"], xs, y, valid)
        losses.append(float(l))
    out["spatial/train_losses"] = np.asarray(losses)


def pairs(inp, mesh, out):
    from miso_tpu_torch.align.miso import (align_multiple_submaps_hierarchical,
                                           generic_align_multiple_submaps,
                                           make_vmapped_pair_loss, pair_context)
    from miso_tpu_torch.parallel.sharding import shard_pair_ctx

    for sub in inp["subsamples"]:
        atlas = atlas_from_arrays(inp)
        atlas.precompute_coordinates_for_alignment()
        ctx = shard_pair_ctx(pair_context(atlas, 0, inp["pairs"]), mesh, "data")
        loss = make_vmapped_pair_loss("latent", level=0, align_weight=100.0,
                                      subsample_points=sub)
        generic_align_multiple_submaps(atlas, loss, num_iters=inp["iters"], lr=5e-3,
                                       batched_loss=True, loss_ctx=ctx, seed=3,
                                       pair_axis=mesh.axis("data"))
        out[f"pairs/rot{sub}"] = np_(atlas.params.sub_rot_corr)
        out[f"pairs/trans{sub}"] = np_(atlas.params.sub_trans_corr)
    hier = dict(inp["hier"])
    atlas = atlas_from_arrays(hier)
    align_multiple_submaps_hierarchical(atlas, mesh=mesh, **hier["kw"])
    out["pairs/hier_rot"] = np_(atlas.params.sub_rot_corr)
    out["pairs/hier_trans"] = np_(atlas.params.sub_trans_corr)


def fusion(inp, out):
    from miso_tpu_torch.losses.fusion import fusion_loss
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
    from miso_tpu_torch.parallel.sharding import (make_mesh, shard_atlas, shard_batch,
                                                  submap_parallel_fusion_step)
    from miso_tpu_torch.train.optim import masked_adam_init

    for shape in ((2, 1), (1, 2)):
        tag = f"fusion{shape[0]}x{shape[1]}"
        mesh = make_mesh(2, ("submap", "data"), shape)
        atlas = atlas_from_arrays(inp)
        full = atlas.params
        mask = grid_atlas_mask(full, features=True, stability=True, decoder=True,
                               kf_pose=True, submap_pose=True)
        params = shard_atlas(full, mesh, "submap").requires_grad_()
        rows = mesh.axis("submap").rows(full.capacity)
        mask = {k: (m[rows] if k.startswith("sub_") else m) for k, m in mask.items()}
        opt = masked_adam_init(params)
        step = submap_parallel_fusion_step(
            lambda p, b, k: fusion_loss(p, b, k, **inp["loss_kw"]), mesh)
        for i, b in enumerate(inp["batches"]):
            params, opt, tl = step(params, opt, shard_batch(b, mesh, "data"), None, mask,
                                   inp["lr"])
            out[f"{tag}/loss{i}"] = np_(tl)
        for k, p in params.named_parameters():
            out[f"{tag}/{k}"] = np_(p)


def small_scenes(inp):
    """train_decoder's four synthetic rooms at ``inp``'s batch and sample
    counts."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh

    return [Sdf3D(TriangleMesh(*room_scene(4.0 + s, seed=s)), batch_size=inp["batch"],
                  total_samples=inp["samples"], trunc_dist=inp["trunc_dist"]) for s in range(4)]


def pretrain(inp, out):
    from miso_tpu_torch.training.train_decoder import train_parallel

    res = train_parallel(small_scenes(inp), inp["epochs"], inp["trunc_dist"], device="cpu")
    for i, (W, b) in enumerate(res["decoder"]):
        out[f"pretrain/W{i}"] = np_(W)
        out[f"pretrain/b{i}"] = np_(b)
    for k, v in res["stage_losses"].items():
        out[f"pretrain/{k}"] = np.asarray(v)


def main():
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        inputs = pickle.load(f)
    distributed.initialize(backend="gloo", device="cpu", timeout_s=300)
    from miso_tpu_torch.parallel.sharding import make_mesh

    from miso_tpu_torch.parallel.sharding import replicate

    rank, world = distributed.process_info()
    out = {"init/rank": np.asarray(rank), "init/world": np.asarray(world)}
    data = make_mesh(2, ("data",))
    tree = {"a": torch.full((3,), float(rank + 1)), "b": [torch.arange(4.0) * (rank + 1)]}
    replicate(tree, data)
    out["init/replicated"] = np.concatenate([np_(tree["a"]), np_(tree["b"][0])])
    for tag in ("dp_tsdf", "dp_ratio", "dp_uniform"):
        data_parallel(inputs[tag], data, out, tag)
    scenes = make_mesh(2, ("scene",))
    scene_grads(inputs["scene"], scenes, out)
    scene_steps(inputs["scene_steps"], scenes, out)
    spatial(inputs["spatial"], make_mesh(2, ("grid",)), out)
    pairs(inputs["pairs"], data, out)
    fusion(inputs["fusion"], out)
    pretrain(inputs["pretrain"], out)
    np.savez(sys.argv[2], **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
