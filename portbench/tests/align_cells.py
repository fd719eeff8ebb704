"""The alignment cell at a size the CPU runs in seconds, for the tests of
the cell, its reference and the program's alignment spans: the site, the
submaps' bound, the sequence and the cap cut down, every other setting the
cell's own.  Three submaps of 6×6×4 and 30×30×20 cells on a site of 8×8×4
m; two slots that grow to four at the third submap, as eight grow to
sixteen at the ninth."""
from __future__ import annotations

import copy

import torch

from portbench.harness import cell as cells

NAME = "ncd_quad_atlas.align"
SEED = 2 ** 31 + 2 ** 20 + 11


def small_align_cell(seed: int = SEED, points: int = 512, device: str = "cpu"):
    c = cells.load(cells.bench_json(), NAME, seed, torch.device(device))
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["model"]["grid"]["bound"] = [[0, 8], [0, 8], [0, 4]]
    c.config["system"].update(submap_local_bound=[[-3, 3], [-3, 3], [-2, 2]], submap_size=4,
                              submap_capacity=2)
    c.config["dataset"]["num_frames"] = 12
    c.config["table_shapes"] = [[6, 6, 4], [30, 30, 20]]
    c.config["assumed"]["align.max_points"] = points
    c.traffic["lap_height"] = 2.0
    return c


def small_runner(seed: int = SEED, points: int = 512):
    """The cell's runner after its set-up (the check's call and the
    warm-up), its atlas still held."""
    c = small_align_cell(seed, points)
    r = cells.runner_class(c.traffic["runner"])(c)
    r.setup()
    return r
