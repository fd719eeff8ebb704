"""Pretrain the per-level FeaturePrediction encoders (port of
``training/train_encoders.py``).

    python -m miso_tpu_torch.training.train_encoders [--save_dir DIR]
        [--decoder_weights FILE] [--meshes PLY ...] [--epochs N] [--device cpu]

With a frozen pretrained decoder, one encoder level trains at a time, coarse
first, to predict the grid-feature corrections that remove the residuals of
a scene's observations (``models/encoder.py::encoder_pretrain_loss``):
masked Adam over the target level's parameters, one random scene a step.
The script trains on simulated camera views of room scenes with pose and
distance noise and writes ``feature_encoder_level_{l}.npz``, which either
package's ``Encoder(pretrained_dir=...)`` loads.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.models.base import tree_full_mask
from miso_tpu_torch.models.encoder import encoder_pretrain_loss
from miso_tpu_torch.train.optim import masked_adam_init, masked_adam_update


def pretrain_encoders(levels, grids: Sequence, datasets: Sequence, epochs: int,
                      trunc_dist: float = 0.15, pred_std: float = 1e-3,
                      learning_rate: float = 1e-3, seed: int = 0, log_every: int = 0,
                      save_dir: Optional[str] = None) -> List[List[float]]:
    """Train ``levels`` (an ``nn.ModuleList`` of FeaturePrediction, updated in
    place) level by level for ``epochs`` steps each.

    Step: scene ``i`` drawn from ``np.random.default_rng(seed)``, a batch
    ``datasets[i].sample(rng)`` on the levels' device, the pretraining loss
    on ``grids[i]`` (its decoder fixed, its keyframe poses those the batch's
    frame points are moved by), the target level's gradient, and masked Adam
    (every other level's mask 0: its parameters and moments untouched; the
    optimizer state is fresh for each level).  The ``pred_std`` noise of
    level l comes from a generator seeded l.  ``save_dir`` receives
    ``feature_encoder_level_{l}.npz`` after each level.  Returns each trained
    level's losses, read once the level ends.
    """
    from miso_tpu_torch.train.checkpoint import save_pytree

    dev = next(levels.parameters()).device
    rng = np.random.default_rng(seed)
    names = dict(levels.named_parameters())
    out = []
    for level in range(len(levels)):
        prefix = f"{level}."
        target = [k for k in names if k.startswith(prefix)]
        mask = tree_full_mask(levels, 0.0)
        mask.update({k: torch.tensor(1.0, device=dev) for k in target})
        opt = masked_adam_init(levels)
        gen = torch.Generator(device=dev).manual_seed(level)
        losses = []
        for e in range(epochs):
            i = int(rng.integers(len(datasets)))
            batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                     for k, v in datasets[i].sample(rng).items()}
            d = encoder_pretrain_loss(levels, grids[i], batch, gen, level,
                                      trunc_dist=trunc_dist, pred_std=pred_std)
            loss = sum(torch.mean(v) for v in d.values())
            got = torch.autograd.grad(loss, [names[k] for k in target])
            grads = {k: torch.zeros_like(p) for k, p in names.items()}
            grads.update(zip(target, got))
            masked_adam_update(grads, opt, levels, mask, lr=learning_rate)
            losses.append(loss.detach())
            if log_every and e % log_every == 0:
                print(f"  level {level} epoch {e} scene {i}: loss={float(loss):.3e}", flush=True)
        out.append([float(v) for v in losses])
        if save_dir is not None:
            save_pytree(os.path.join(save_dir, f"feature_encoder_level_{level}.npz"),
                        levels[level])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save_dir", default="./results/trained_encoders")
    p.add_argument("--decoder_weights", default="./results/trained_decoders/decoder_indoor.npz")
    p.add_argument("--meshes", nargs="*", default=None)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--trunc_dist", type=float, default=0.15)
    p.add_argument("--pred_std", type=float, default=1e-3)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from miso_tpu_torch.datasets.sdf_3d import PosedSdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.models.encoder import Encoder
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.checkpoint import load_pytree

    os.makedirs(args.save_dir, exist_ok=True)
    model_cfg = {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
                 "bound": None, "base_cell_size": 0.5, "per_level_scale": 5.0,
                 "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1,
                    "out_dim": 1, "pos_invariant": True, "fix": True,
                    "pretrained_model": None},
        "pose": {"optimize": False, "num_poses": 32},
    }
    gen = torch.Generator().manual_seed(0)
    datasets, grids = [], []
    for i, m in enumerate(args.meshes or [None] * 4):
        mesh = TriangleMesh(*room_scene(4.0 + i, seed=i)) if m is None else m
        ds = PosedSdf3D(mesh, frame_batchsize=2**10, frame_samples=2**11, num_frames=32,
                        trunc_dist=args.trunc_dist, frame_std_rad=0.00872665,
                        frame_std_meter=0.005, distance_std=0.01, seed=i)
        g = create_grid_net(model_cfg, bound=ds.get_inflated_bound(), generator=gen,
                            device=args.device)
        with torch.no_grad():
            g.Rwk.copy_(torch.as_tensor(ds.R_world_frame))
            g.twk.copy_(torch.as_tensor(ds.t_world_frame))
        datasets.append(ds)
        grids.append(g)
    if os.path.exists(args.decoder_weights):
        dec = load_pytree(args.decoder_weights, like=grids[0].decoder_params)
        for g in grids:
            with torch.no_grad():
                for t, v in zip(g.decoder, (v for pair in dec for v in pair)):
                    t.copy_(v)
        print(f"Loaded pretrained decoder from {args.decoder_weights}")
    encoder = Encoder({"model": model_cfg}, generator=gen, trunc_dist=args.trunc_dist,
                      device=args.device)
    pretrain_encoders(encoder.level_params, grids, datasets, args.epochs,
                      trunc_dist=args.trunc_dist, pred_std=args.pred_std, log_every=50,
                      save_dir=args.save_dir)
    print(f"Saved the encoders to {args.save_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
