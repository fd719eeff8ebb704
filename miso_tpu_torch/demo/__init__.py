"""Command-line demos of the port (ports of the JAX package's ``demo/*.py``),
run as ``python -m miso_tpu_torch.demo.<name>``:

  * ``build_submaps``: the SLAM structure from a dry run, each submap mapped
    with known poses, meshes and ``grid_atlas.npz``;
  * ``align_submaps``: submap alignment (MISO, vfpp, mips, ICP) from a
    perturbation, on a synthetic atlas or ``build_submaps``' ``--atlas``;
  * ``full_slam_scannet``: online RGB-D SLAM, its refinement, ATE and mesh;
  * ``full_slam_newer_college``: online LiDAR SLAM in submaps, the Fuser and
    the fused mesh;
  * ``encoder_init``: learned encoder initialization against the zero init.

Each keeps its JAX demo's arguments, defaults and ``results.json`` keys, and
adds ``--device``: ``cuda`` (the default) runs on the card and raises
without one, ``cpu`` runs the kernels' plain versions.  Results go under
``./results/torch/<name>`` by default.  The JAX demos' compile arguments
(``--jax_cache``, ``--no_prewarm``, ``--prewarm_only``) have no counterpart:
nothing is compiled ahead of a run here.
"""
from __future__ import annotations

import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_device(name: str) -> torch.device:
    """The device a demo runs on; ``cuda`` raises when there is no card."""
    from miso_tpu_torch.models.grid_net import _check_device
    return _check_device(name)


def repo_path(path: str) -> str:
    """``path`` as given when it exists, else relative to the repository
    (the default ``--config`` works from any directory)."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(REPO, path)
