"""Pretrain the shared MLP decoder over several scenes (port of
``training/train_decoder.py``).

    python -m miso_tpu_torch.training.train_decoder --synthetic [--parallel]
        [--save_dir DIR] [--name decoder_indoor] [--epochs 300]
        [--trunc_dist 0.15] [--meshes PLY ...] [--device cpu]

Per-scene feature grids and one shared decoder train in three stages,
coarse level, fine level, then jointly at a tenth of the rate, and the
decoder is saved with ``save_pytree`` as ``<save_dir>/<name>.npz``, which
either package loads as a model config's ``decoder.pretrained_model``.
``--synthetic`` trains on four procedural room scenes.

Default path: one scene a step in turn, each scene's own Adam state.
``--parallel``: every scene every step, the scenes stacked as atlas slots
(``parallel/pretrain.py``); on as many ranks as tile the scene count when
the process was started as one of several (``MISO_COORDINATOR``,
``MISO_NUM_PROCESSES``, ``MISO_PROCESS_ID``; ``--backend gloo`` for ranks
that share a card or run on the CPU), on one rank otherwise.  Rank 0 saves.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from miso_tpu_torch.config import load_config
from miso_tpu_torch.datasets.sdf_3d import Sdf3D
from miso_tpu_torch.datasets.shapes import room_scene
from miso_tpu_torch.losses.miso import make_loss
from miso_tpu_torch.losses.sdf import tsdf_loss_3d
from miso_tpu_torch.models.grid_atlas import grid_atlas_mask
from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.parallel import distributed
from miso_tpu_torch.parallel.pretrain import (build_scene_stack, scene_parallel_decoder_step,
                                              shard_scene_stack, stack_scene_batches)
from miso_tpu_torch.parallel.sharding import make_mesh
from miso_tpu_torch.train.checkpoint import save_pytree
from miso_tpu_torch.train.optim import masked_adam_init
from miso_tpu_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL_CFG = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
             "bound": None, "base_cell_size": 0.5, "per_level_scale": 5.0,
             "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 1},
}
# (name, learning rate, trained level (n_levels: all), fine level ignored)
STAGES = (("coarse", 1e-3, 0, True), ("fine", 1e-3, 1, False), ("joint", 1e-4, None, False))
SCENE_BATCH = 2 ** 14
SCENE_SAMPLES = 2 ** 17
LOG_EVERY = 50


def scene_datasets(meshes: Sequence[str] = (), trunc_dist: float = 0.15) -> List[Sdf3D]:
    """``Sdf3D`` of each mesh file, or of four procedural rooms
    (``room_scene(4 + s, seed=s)``) when there is none."""
    if not meshes:
        meshes = [TriangleMesh(*room_scene(4.0 + s, seed=s)) for s in range(4)]
    return [Sdf3D(m, batch_size=SCENE_BATCH, total_samples=SCENE_SAMPLES, trunc_dist=trunc_dist)
            for m in meshes]


def _log(msg):
    print(msg, flush=True)


def train_parallel(datasets: Sequence[Sdf3D], epochs: int, trunc_dist: float,
                   device="cuda") -> Dict:
    """Every scene every step (see the module note).  Returns ``decoder``
    (((W, b), ...), None on a rank outside the mesh), ``stage_losses`` (each
    stage's last total), ``params`` (this rank's shard) and ``seconds``."""
    S = len(datasets)
    atlas = build_scene_stack(MODEL_CFG, [ds.bound for ds in datasets],
                              torch.Generator().manual_seed(0), device=device)
    rank, world = distributed.process_info()
    n = max(d for d in range(1, min(S, world) + 1) if S % d == 0)
    mesh = make_mesh(n, axes=("scene",))
    if mesh.group is None and world > 1:
        _log(f"rank {rank}: outside the {n}-rank scene mesh, idle")
        return {"decoder": None, "stage_losses": {}, "params": None, "seconds": 0.0}
    _log(f"parallel decoder pretraining: {S} scenes over {n} rank(s)")
    params = shard_scene_stack(atlas.params, mesh, "scene")
    step = scene_parallel_decoder_step(trunc_dist=trunc_dist)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(1)
    L = params.num_levels
    out = {}
    t0 = time.perf_counter()
    for name, lr, level, ignore_fine in STAGES:
        _log(f"=== {name}: {epochs} epochs, lr={lr} ===")
        with torch.no_grad():
            params.ignore_level.copy_(torch.tensor([0.0, 1.0] if ignore_fine else [0.0, 0.0])[:L])
        mask = grid_atlas_mask(params, features=True, stability=True, decoder=True,
                               anchor_first_submap=False, level=L if level is None else level)
        opt_state = masked_adam_init(params)
        for e in range(epochs):
            batches = stack_scene_batches([ds.sample(rng) for ds in datasets], mesh, "scene",
                                          device=device)
            params, opt_state, tl = step(params, opt_state, batches, gen, mask, lr)
            if e % LOG_EVERY == 0:
                _log(f"  epoch {e}: loss={float(tl):.3e}")
        out[name] = float(tl)
    return {"decoder": tuple((W.detach(), b.detach()) for W, b in params.decoder),
            "stage_losses": out, "params": params, "seconds": time.perf_counter() - t0}


def train_round_robin(datasets: Sequence[Sdf3D], epochs: int, trunc_dist: float,
                      device="cuda") -> Dict:
    """One scene a step in turn, the grids sharing one decoder (the first
    scene's), each with its own Adam state, restarted at every stage.
    Returns ``decoder``, ``stage_losses`` (each stage's last step's),
    ``grids`` and ``seconds``."""
    gen = torch.Generator().manual_seed(0)
    grids = [create_grid_net(MODEL_CFG, bound=ds.bound, generator=gen, device=device)
             for ds in datasets]
    for g in grids[1:]:
        g.decoder = grids[0].decoder
    step = make_train_step(make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2,
                                     eik_weight=5e1, trunc_dist=trunc_dist))
    out = {}
    t0 = time.perf_counter()
    for name, lr, level, ignore_fine in STAGES:
        _log(f"=== {name}: {epochs} epochs, lr={lr} ===")
        opts = [masked_adam_init(g) for g in grids]
        masks = [grid_net_mask(g, level=g.num_levels if level is None else level, pose=False)
                 for g in grids]
        rng = np.random.default_rng(0)
        k = torch.Generator(device=device).manual_seed(1)
        for e in range(epochs):
            i = e % len(grids)
            g = grids[i].with_ignore_level([1] if ignore_fine else [])
            batch = {kk: torch.as_tensor(v, device=device)
                     for kk, v in datasets[i].sample(rng).items()}
            _, _, tl, _ = step(g, opts[i], batch, k, masks[i], lr)
            if e % LOG_EVERY == 0:
                _log(f"  epoch {e} scene {i}: loss={float(tl):.3e}")
        out[name] = float(tl)
    d = grids[0].decoder
    return {"decoder": tuple((d[i].detach(), d[i + 1].detach()) for i in range(0, len(d), 2)),
            "stage_losses": out, "grids": grids, "seconds": time.perf_counter() - t0}


def run(argv=None) -> Dict:
    """The command line's run: :func:`train_parallel`'s or
    :func:`train_round_robin`'s result, with ``path`` the saved file (None
    on a rank other than 0)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=os.path.join(ROOT, "configs", "base.yaml"))
    p.add_argument("--save_dir", default="./results/trained_decoders")
    p.add_argument("--name", default="decoder_indoor")
    p.add_argument("--meshes", nargs="*", default=None,
                   help="Watertight scene meshes (.ply); omit for --synthetic")
    p.add_argument("--synthetic", action="store_true",
                   help="Use procedural scenes instead of mesh files")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--trunc_dist", type=float, default=0.15)
    p.add_argument("--parallel", action="store_true",
                   help="Every scene every step, the scenes stacked as atlas slots and "
                        "sharded over the ranks")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--backend", default=None,
                   help="process-group backend of a multi-rank run (nccl on cards, gloo "
                        "on the CPU or for ranks sharing a card)")
    args = p.parse_args(argv)
    if not args.meshes and not args.synthetic:
        p.error("pass --meshes or --synthetic")
    load_config(args.config)
    device = torch.device(args.device)
    if "MISO_NUM_PROCESSES" in os.environ:
        device = distributed.initialize(backend=args.backend, device=args.device)
    datasets = scene_datasets(args.meshes or (), args.trunc_dist)
    train = train_parallel if args.parallel else train_round_robin
    res = train(datasets, args.epochs, args.trunc_dist, device=device)
    rank, _ = distributed.process_info()
    res["path"] = None
    if res["decoder"] is not None and rank == 0:
        res["path"] = os.path.join(args.save_dir, f"{args.name}.npz")
        save_pytree(res["path"], res["decoder"])
        _log(f"Saved pretrained decoder to {res['path']}")
    _log(f"stage losses: {res['stage_losses']}; {res['seconds']:.1f} s")
    if "MISO_NUM_PROCESSES" in os.environ:
        torch.distributed.destroy_process_group()
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
