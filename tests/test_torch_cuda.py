"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; they skip where torch sees no CUDA card.  On a machine with
one:  python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: values atol/rtol 1e-4 (float32 sums in another order);
gradients 1e-4 of the largest reference entry (the same recompute on both
sides, scatter-adds in a run-dependent order).
"""
import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SCANNET_BOUND = [[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]]
# A point of the ScanNet coarse level exactly on a cell face: u = 16 on axis 1
# when rounded op by op (15.99999 through a fused multiply-add).
ON_FACE = [1.4275164604187012, 8.010832786560059, 0.1370464414358139]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n_levels, fdim, hidden, hidden_layers, out_dim, n=20000, seed=0):
    from miso_tpu_torch.ops.mlp import mlp_init
    gen = torch.Generator(device=dev).manual_seed(seed)
    bound = torch.tensor([[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]], device=dev)
    grids = [torch.randn((5 * (l + 1), 4 * (l + 1), 3 * (l + 1), fdim), generator=gen,
                         device=dev) for l in range(n_levels)]
    decoder = mlp_init(n_levels * fdim, out_dim, hidden, hidden_layers,
                       generator=torch.Generator().manual_seed(seed), device=dev)
    x = -1.3 + 2.7 * torch.rand((n, 3), generator=gen, device=dev)
    return grids, x, bound, decoder


@pytest.mark.parametrize("shape", [(2, 4, 64, 1, 1), (3, 8, 64, 2, 3), (1, 1, 4, 0, 1),
                                   (2, 4, 128, 1, 17), (2, 12, 64, 1, 1), (2, 36, 64, 1, 1)],
                         ids=["scannet", "3lvl_F8_out3", "base", "wide_out17", "F12", "F36"])
def test_kernel_matches_plain(dev, shape):
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_plain)
    grids, x, bound, decoder = _case(dev, *shape)
    ig = torch.zeros(len(grids), device=dev)
    ig[-1] = 1.0
    for kw in ({}, {"ignore_level": ig}):
        got = fused_interp_decode_cuda(grids, x, bound, decoder, **kw)
        ref = fused_interp_decode_plain(grids, x, bound, decoder, **kw)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_kernel_sized_storage(dev):
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_plain)
    grids, x, bound, decoder = _case(dev, 2, 4, 32, 1, 1)
    padded, sizes = [], []
    for g in grids:
        p = 10.0 * torch.randn((g.shape[0] + 3, g.shape[1] + 2, g.shape[2] + 1, 4), device=dev)
        p[:g.shape[0], :g.shape[1], :g.shape[2]] = g
        padded.append(p)
        sizes.append(torch.tensor(g.shape[:3], dtype=torch.int32, device=dev))
    got = fused_interp_decode_cuda(padded, x, bound, decoder, sizes)
    torch.testing.assert_close(got, fused_interp_decode_plain(grids, x, bound, decoder),
                               atol=1e-4, rtol=1e-4)


# (level shapes, F): the ScanNet levels (the fine one left in L2, the coarse
# one staged), one level just under and one just over the fused kernel's
# staging budget beside a 1-row level (8 -> 64 -> 64 -> 1 decoder).
FUSED_PATHS = {"scannet": ([(105, 88, 31), (21, 18, 7)], [False, True]),
               "budget_under": ([(1, 1, 3197), (1, 1, 1)], [True, True]),
               "budget_over": ([(1, 1, 3198), (1, 1, 1)], [False, True])}


@pytest.mark.parametrize("case", list(FUSED_PATHS), ids=list(FUSED_PATHS))
def test_kernel_staged_and_l2_levels(dev, case):
    """The fused kernel with levels staged in shared memory and left in L2,
    against the plain version, 1e5 points and a point on a cell face."""
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_occupancy,
                                                 fused_interp_decode_plain)
    from miso_tpu_torch.ops.mlp import mlp_init
    shapes, staged = FUSED_PATHS[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    bound = torch.tensor(SCANNET_BOUND, device=dev)
    grids = [torch.randn((*s, 4), generator=gen, device=dev) for s in shapes]
    decoder = mlp_init(8, 1, 64, 1, generator=torch.Generator().manual_seed(1), device=dev)
    x = bound[:, 0] + (-0.05 + 1.1 * torch.rand((100000, 3), generator=gen, device=dev)) * (
        bound[:, 1] - bound[:, 0])
    x[0] = torch.tensor(ON_FACE, device=dev)
    assert fused_interp_decode_occupancy(grids, x, bound, decoder)["staged"] == staged
    torch.testing.assert_close(fused_interp_decode_cuda(grids, x, bound, decoder),
                               fused_interp_decode_plain(grids, x, bound, decoder),
                               atol=1e-4, rtol=1e-4)


def test_function_grads_and_grad2(dev):
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode,
                                                 fused_interp_decode_plain)
    grids, x, bound, decoder = _case(dev, 2, 4, 32, 1, 1, n=4000)
    results = []
    for fn in (fused_interp_decode, fused_interp_decode_plain):
        xs = x.clone().requires_grad_()
        gs = [g.clone().requires_grad_() for g in grids]
        ds = [(W.clone().requires_grad_(), b.clone().requires_grad_()) for W, b in decoder]
        out = fn(gs, xs, bound, ds)
        flat = [w for pair in ds for w in pair]
        (gx,) = torch.autograd.grad(out.sum(), xs, create_graph=True)
        eik = ((gx.norm(dim=-1) - 1.0) ** 2).mean()
        results.append(torch.autograd.grad((out ** 2).sum() + eik, [xs, *gs, *flat]))
    for a, b in zip(*results):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6)


def test_grid_net_pallas_matches_xla_and_counts(dev):
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda
    cfg = {"grid": {"feature_dim": 4, "init_stddev": 0.1,
                    "bound": [[-0.02, 2.38], [-0.01, 1.74], [-0.01, 1.03]],
                    "base_cell_size": 0.5, "per_level_scale": 5.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1, "out_dim": 1,
                       "impl": "pallas"},
           "pose": {"num_poses": 5}}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0))
    plain = copy.deepcopy(model)
    plain.decode_impl = "xla"
    rng = np.random.default_rng(0)
    n = 50000
    batch = {"coords_frame": rng.uniform(0, 2.3, (n, 3)).astype(np.float32),
             "sample_frame_ids": rng.integers(0, 5, (n,)).astype(np.int32),
             "sdf": rng.uniform(-0.15, 0.15, (n, 1)).astype(np.float32),
             "sdf_valid": np.ones((n, 1), np.float32),
             "sdf_signs": (rng.uniform(size=(n, 1)) < 0.2).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    loss = make_loss(mapping_loss, loss_type="L1", weight_eik=0.0, weight_fs=0.1,
                     trunc_dist=0.15)
    fused_interp_decode_cuda.launches = 0
    a = loss(model, batch)
    assert fused_interp_decode_cuda.launches == 1
    b = loss(plain, batch)
    assert fused_interp_decode_cuda.launches == 1
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=1e-5)


# The interp kernels' cases: (grid shape, points, where the points lie).  "F1",
# "F4", "F12", "F36": the second level of _case's grids, whose rows take
# enough atomics for the grad kernel's copies; a 45-row F = 1 table (copies
# summed one float at a time); the ScanNet coarse level at 1e6 points (47
# copies); F = 1 and 12 on a larger grid (one copy); all points in one cell;
# 1e6 points in 16^3 cells of the ScanNet fine level; a grid of 7e6 rows;
# storage padded beyond a logical size at F = 1, 4 and 12; no point and one
# point; a point on a cell face of the ScanNet coarse level (u = 16 exactly
# on axis 1 when rounded op by op, 15.99999 through a fused multiply-add); a
# table just under and just over the forward's staging budget (115,712 B), and
# the forward's other paths at 1e6 points (ops/tiled_interp.py::
# interp_forward_path): padded storage staged and in pairs, F = 12 in pairs,
# F = 1 from L2.
INTERP_CASES = {
    "F1": ((10, 8, 6, 1), 20000, "spread"), "F4": ((10, 8, 6, 4), 20000, "spread"),
    "F12": ((10, 8, 6, 12), 20000, "spread"), "F36": ((10, 8, 6, 36), 20000, "spread"),
    "scannet_coarse_1e6": ((21, 18, 7, 4), 10 ** 6, "spread"),
    "F1_odd": ((5, 3, 3, 1), 20000, "spread"),
    "F1_large": ((40, 36, 30, 1), 20000, "spread"),
    "F12_large": ((40, 36, 30, 12), 20000, "spread"),
    "one_cell": ((40, 36, 30, 4), 20000, "one_cell"),
    "dense_region_1e6": ((105, 88, 31, 4), 10 ** 6, "dense_region"),
    "large_grid": ((240, 240, 120, 4), 200000, "spread"),
    "padded": ((10, 8, 6, 4), 20000, "padded"),
    "padded_F1": ((10, 8, 6, 1), 20000, "padded"),
    "padded_F12": ((10, 8, 6, 12), 20000, "padded"),
    "n0": ((10, 8, 6, 4), 0, "spread"), "n1": ((10, 8, 6, 4), 1, "spread"),
    "n0_large": ((40, 36, 30, 4), 0, "spread"), "n1_large": ((40, 36, 30, 4), 1, "spread"),
    "on_face": ((21, 18, 7, 4), 20000, "on_face"),
    "staging_budget_under": ((8, 8, 113, 4), 10 ** 6, "spread"),
    "staging_budget_over": ((8, 8, 114, 4), 10 ** 6, "spread"),
    "padded_1e6": ((10, 8, 6, 4), 10 ** 6, "padded"),
    "padded_large_1e6": ((40, 36, 30, 4), 10 ** 6, "padded"),
    "F12_large_1e6": ((40, 36, 30, 12), 10 ** 6, "spread"),
    "F1_large_1e6": ((40, 36, 30, 1), 10 ** 6, "spread"),
}


def _interp_case(dev, name):
    """(grid, x, bound, size, unpadded): points 5 % beyond the bound, or as
    the case says; ``unpadded`` is the grid without its padding, or None."""
    shape, n, where = INTERP_CASES[name]
    gen = torch.Generator(device=dev).manual_seed(len(name) + n)
    scannet = shape[:3] in ((21, 18, 7), (105, 88, 31))
    bound = torch.tensor(SCANNET_BOUND if scannet else [[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]],
                         device=dev)
    lo, ext = bound[:, 0], bound[:, 1] - bound[:, 0]
    dims = torch.tensor(shape[:3], device=dev, dtype=torch.float32)
    grid = torch.randn(shape, generator=gen, device=dev)
    u = torch.rand((n, 3), generator=gen, device=dev)
    if where == "one_cell":
        u = (torch.tensor([17.0, 5.0, 22.0], device=dev) + 0.5 + 0.1 + 0.8 * u) / dims
    elif where == "dense_region":   # 16^3 cells: some 240 points a cell
        u = (24.0 + 16.0 * u) / dims
    else:
        u = -0.05 + 1.1 * u
    size, unpadded = None, None
    if where == "padded":
        padded = torch.randn((shape[0] + 2, shape[1] + 1, shape[2] + 3, shape[3]),
                             generator=gen, device=dev)
        padded[:shape[0], :shape[1], :shape[2]] = grid
        unpadded, grid = grid, padded
        size = torch.tensor(shape[:3], dtype=torch.int32, device=dev)
    x = lo + u * ext
    if where == "on_face":
        x[0] = torch.tensor(ON_FACE, device=dev)
        assert float((x[0, 1] - lo[1]) / ext[1] * shape[1] - 0.5) == 16.0
    return grid, x.contiguous(), bound, size, unpadded


def _grad_close(got, ref):
    assert got.shape == ref.shape
    if ref.numel():
        assert float((got - ref).abs().max()) <= 1e-4 * max(float(ref.abs().max()), 1e-6)


@pytest.mark.parametrize("case", list(INTERP_CASES), ids=list(INTERP_CASES))
def test_interp_kernels_match_plain(dev, case):
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain,
                                                 grid_interpolate_plain)
    grid, x, bound, size, unpadded = _interp_case(dev, case)
    out = grid_interpolate_cuda(grid, x, bound, size)
    torch.testing.assert_close(out, grid_interpolate_plain(grid, x, bound, size),
                               atol=1e-4, rtol=1e-4)
    if unpadded is not None:
        torch.testing.assert_close(out, grid_interpolate_plain(unpadded, x, bound),
                                   atol=1e-4, rtol=1e-4)
    g = torch.randn((x.shape[0], grid.shape[-1]), device=dev)
    before = grid_interpolate_grad_cuda.launches
    for need_x in (True, False):
        got = grid_interpolate_grad_cuda(grid, x, bound, g, size, need_x=need_x)
        ref = grid_interpolate_grad_plain(grid, x, bound, g, size, need_x=need_x)
        _grad_close(got[0], ref[0])
        if need_x:
            _grad_close(got[1], ref[1])
        else:
            assert got[1] is None
    torch.cuda.synchronize()
    assert grid_interpolate_grad_cuda.launches == before + 2


DECODE_CASES = {  # (F_in, out, hidden, hidden layers, points)
    "scannet": (8, 1, 64, 1, 30000), "h64x3_out3": (8, 3, 64, 2, 30000),
    "base": (1, 1, 4, 0, 30000),
    # 3 levels x F=4 in, the widest layers, a ragged output.
    "wide_12_128_128_17": (12, 17, 128, 1, 30000),
    # Ragged and tiny tiles (a warp takes 32 points at 64 wide, 16 at 128).
    "scannet_n1000013": (8, 1, 64, 1, 1_000_013), "scannet_n1": (8, 1, 64, 1, 1),
    "scannet_n15": (8, 1, 64, 1, 15), "scannet_n33": (8, 1, 64, 1, 33),
    "wide_n1000013": (12, 17, 128, 1, 1_000_013), "wide_n1": (12, 17, 128, 1, 1),
    "wide_n15": (12, 17, 128, 1, 15), "wide_n33": (12, 17, 128, 1, 33)}


@pytest.mark.parametrize("shape", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_decode_kernel_matches_plain(dev, shape):
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.mlp import mlp_init
    fin, fout, hidden, layers, n = DECODE_CASES[shape]
    params = mlp_init(fin, fout, hidden, layers, generator=torch.Generator().manual_seed(0),
                      device=dev)
    x = torch.randn((n, fin), device=dev)
    for p in (params, tuple((W, None) for W, _ in params)):
        torch.testing.assert_close(mlp_decode_cuda(p, x), mlp_decode_plain(p, x),
                                   atol=1e-4, rtol=1e-4)


def test_grid_net_default_decode_runs_kernels(dev):
    """GridNet's default decode on the card launches the interp, interp grad and
    decode kernels, and its tsdf loss and gradients match a CPU copy's."""
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda)
    cfg = {"grid": {"feature_dim": 4, "init_stddev": 0.1,
                    "bound": [[-1.2, 1.2], [-1.2, 1.2], [-1.2, 1.2]],
                    "base_cell_size": 0.4, "per_level_scale": 2.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1}}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(0)
    n = 20000
    batch = {"coords": rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32),
             "sdf": rng.uniform(-0.3, 0.3, (n, 1)).astype(np.float32),
             "sdf_valid": np.ones((n, 1), np.float32),
             "sdf_signs": rng.integers(-1, 2, (n, 1)).astype(np.float32)}
    loss = make_loss(tsdf_loss_3d, eik_weight=0.0, trunc_dist=0.2)
    for fn in (grid_interpolate_cuda, grid_interpolate_grad_cuda, mlp_decode_cuda):
        fn.launches = 0
    results = []
    for m, d in ((model, dev), (cpu, torch.device("cpu"))):
        tl = sum(loss(m, {k: torch.from_numpy(v).to(d) for k, v in batch.items()}).values())
        results.append([tl] + list(torch.autograd.grad(tl, list(m.features) + list(m.decoder))))
    assert grid_interpolate_cuda.launches == 2 and mlp_decode_cuda.launches == 1
    assert grid_interpolate_grad_cuda.launches == 2
    for a, b in zip(*results):
        a = a.cpu()
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6)


POINTS_ONLY_CASES = ["F1", "F4", "F12", "F1_odd", "scannet_coarse_1e6", "dense_region_1e6",
                     "padded", "padded_F12", "n0", "n1", "on_face"]


@pytest.mark.parametrize("case", POINTS_ONLY_CASES, ids=POINTS_ONLY_CASES)
def test_interp_points_only_backward(dev, case, monkeypatch):
    """The backward's points-only mode against the plain version's points'
    gradient: it allocates nothing but d_x (no table gradient, no copies, so
    no atomics) and counts in its own launch counter."""
    from miso_tpu_torch.ops import tiled_interp as ti
    grid, x, bound, size, _ = _interp_case(dev, case)
    g = torch.randn((x.shape[0], grid.shape[-1]), device=dev)
    ref = ti.grid_interpolate_grad_plain(grid, x, bound, g, size, need_grid=False)
    assert ref[0] is None
    monkeypatch.setattr(ti, "interp_grad_copies", None)    # never asked for copies
    table, points = ti.grid_interpolate_grad_cuda.launches, \
        ti.grid_interpolate_grad_cuda.points_launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ti.grid_interpolate_grad_cuda(grid, x, bound, g, size, need_grid=False)
    torch.cuda.synchronize()
    assert got[0] is None
    assert torch.cuda.max_memory_allocated() - base <= max(512, -(-12 * x.shape[0] // 512) * 512)
    _grad_close(got[1], ref[1])
    assert ti.grid_interpolate_grad_cuda.launches == table
    assert ti.grid_interpolate_grad_cuda.points_launches == points + 1
    with pytest.raises(ValueError):
        ti.grid_interpolate_grad_cuda(grid, x, bound, g, size, need_x=False, need_grid=False)


def test_frozen_grid_backward_takes_the_points_only_mode(dev):
    """_GridInterp's backward launches the points-only mode when the grid asks
    for no gradient, and the table-gradient mode when it does."""
    from miso_tpu_torch.ops import tiled_interp as ti
    grid, x, bound, _, _ = _interp_case(dev, "F4")
    g = torch.randn((x.shape[0], 4), device=dev)
    for grid_grad in (False, True):
        gr = grid.clone().requires_grad_(grid_grad)
        xr = x.clone().requires_grad_()
        table, points = ti.grid_interpolate_grad_cuda.launches, \
            ti.grid_interpolate_grad_cuda.points_launches
        out = ti.grid_interpolate_dispatch(gr, xr, bound)
        (d_x,) = torch.autograd.grad(out, xr, g)
        assert ti.grid_interpolate_grad_cuda.points_launches == points + (not grid_grad)
        assert ti.grid_interpolate_grad_cuda.launches == table + grid_grad
        _grad_close(d_x, ti.grid_interpolate_grad_plain(grid, x, bound, g)[1])


def test_lm_step_launches(dev):
    """One LM step queries the frozen grid: per level one interp forward and
    one points-only backward, one decode, no table-gradient backward; its
    update matches a CPU copy's."""
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda, mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_grad_cuda
    from miso_tpu_torch.slam.tracker import lm_step
    cfg = {"grid": {"feature_dim": 4, "init_stddev": 0.1, "bound": SCANNET_BOUND,
                    "base_cell_size": 0.5, "per_level_scale": 5.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                       "fix": True},
           "pose": {"num_poses": 4}}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(0)
    n = 4096
    args = [rng.uniform([1, 1, 0.5], [9, 7, 2.5], (n, 3)).astype(np.float32),
            rng.uniform(-0.2, 0.2, (n, 1)).astype(np.float32), np.ones((n, 1), np.float32)]
    counters = (grid_interpolate_cuda, mlp_decode_cuda, fused_interp_decode_cuda)
    for fn in counters:
        fn.launches = 0
    grid_interpolate_grad_cuda.launches = grid_interpolate_grad_cuda.points_launches = 0
    for m, d in ((model, dev), (cpu, torch.device("cpu"))):
        lm_step(m, *(torch.from_numpy(a).to(d) for a in args), 1, 1.0, 0.3, float("inf"))
    assert [fn.launches for fn in counters] == [2, 1, 0]
    assert grid_interpolate_grad_cuda.points_launches == 2
    assert grid_interpolate_grad_cuda.launches == 0
    for a, b in ((model.rot_corr, cpu.rot_corr), (model.trans_corr, cpu.trans_corr)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-4, rtol=1e-3)


def _atlas(device, capacity=4):
    """3 live submaps of mixed bounds (two padded), random features,
    stability and pose corrections, a 8 -> 32 -> 1 decoder."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
                    "bound": SCANNET_BOUND, "base_cell_size": 0.5, "per_level_scale": 5.0,
                    "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 2}}
    atlas = GridAtlas(cfg, max_kfs_per_submap=2, capacity=capacity, device=device)
    for bound, shift in ((SCANNET_BOUND, [0.0, 0.0, 0.0]),
                         ([[-0.02, 6.38], [-0.01, 5.24], [-0.01, 3.03]], [2.0, 1.0, 0.0]),
                         ([[-1.0, 7.0], [-2.0, 2.5], [-0.5, 2.0]], [-1.0, 3.0, 0.2])):
        atlas.add_submap(np.asarray(bound, np.float32), tws=np.asarray(shift, np.float32))
        atlas.add_kf()
    gen = torch.Generator(device=device).manual_seed(3)
    p = atlas.params
    with torch.no_grad():
        for f in p.features:
            f[:3] = 0.1 * torch.randn(f[:3].shape, generator=gen, device=device)
        for s in p.stability:
            s[:3] = torch.rand(s[:3].shape, generator=gen, device=device)
        p.sub_rot_corr[:3] = 0.02 * torch.randn((3, 3), generator=gen, device=device)
        p.sub_trans_corr[:3] = 0.02 * torch.randn((3, 3), generator=gen, device=device)
    return atlas


def test_atlas_queries_match_the_plain_ops_on_the_cpu(dev):
    """query_feature, query_stability, __call__ and the per-submap queries on
    the card (interp and decode kernels on padded slots with logical sizes)
    against the same atlas on the CPU (plain ops)."""
    atlas = _atlas(dev)
    cpu = copy.deepcopy(atlas.params)
    for name in ("features", "stability", "sizes"):
        setattr(cpu, name, [t.cpu() for t in getattr(cpu, name)])
    for name in ("sub_rot_corr", "sub_trans_corr", "Rws", "tws", "kf_rot_corr",
                 "kf_trans_corr", "Rsk", "tsk", "bounds", "ignore_level", "active",
                 "kf_to_submap", "kf_to_local"):
        setattr(cpu, name, getattr(cpu, name).cpu())
    cpu.decoder = tuple((W.cpu(), b.cpu()) for W, b in cpu.decoder)
    b = atlas.global_bound()
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        b[:, 0] - 0.5, b[:, 1] + 0.5, (200_000, 3)).astype(np.float32))
    with torch.no_grad():
        for name in ("query_feature", "query_stability", "forward"):
            torch.testing.assert_close(getattr(atlas.params, name)(x.to(dev)).cpu(),
                                       getattr(cpu, name)(x), atol=1e-4, rtol=1e-4)
        for s in range(3):
            for name in ("query_feature_submap", "query_stability_submap", "forward_submap"):
                torch.testing.assert_close(getattr(atlas.params, name)(s, x.to(dev)).cpu(),
                                           getattr(cpu, name)(s, x), atol=1e-4, rtol=1e-4)


def test_atlas_query_launches_per_live_slot(dev):
    """One interp forward per live slot and level (not per capacity slot), one
    decode per __call__, no backward."""
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_grad_cuda
    atlas = _atlas(dev, capacity=8)
    assert atlas.params.capacity == 8 and atlas.num_submaps == 3
    x = torch.rand((4096, 3), device=dev) * 8.0
    for name, interp, decode in (("query_feature", 6, 0), ("query_stability", 6, 0),
                                 ("forward", 6, 1)):
        grid_interpolate_cuda.launches = mlp_decode_cuda.launches = 0
        grid_interpolate_grad_cuda.launches = grid_interpolate_grad_cuda.points_launches = 0
        with torch.no_grad():
            getattr(atlas.params, name)(x)
        assert (grid_interpolate_cuda.launches, mlp_decode_cuda.launches) == (interp, decode)
        assert grid_interpolate_grad_cuda.launches == 0
        assert grid_interpolate_grad_cuda.points_launches == 0


def test_atlas_get_submap_returns_contiguous_copies(dev):
    """get_submap crops each padded slot into a contiguous copy (the kernels
    take it as it is); training it leaves the atlas alone until set_submap."""
    atlas = _atlas(dev)
    for s in range(3):
        g = atlas.get_submap(s)
        for level, (f, st) in enumerate(zip(g.features, g.stability)):
            assert f.is_cuda and f.is_contiguous() and st.is_contiguous()
            assert tuple(f.shape[:3]) == tuple(atlas.submap_shapes(s)[level])
            assert f.data_ptr() != atlas.params.features[level].data_ptr()
            crop = tuple(slice(0, n) for n in f.shape[:3])
            assert torch.equal(f, atlas.params.features[level][s][crop])
        x = torch.rand((1000, 3), device=dev) * 3.0
        torch.testing.assert_close(g(x), atlas.params.forward_submap(s, x),
                                   atol=1e-5, rtol=1e-5)
        before = atlas.params.features[1][s].clone()
        with torch.no_grad():
            g.features[1].add_(1.0)
        assert torch.equal(atlas.params.features[1][s], before)


# The slot-id mode: (storage (S, X, Y, Z), F, logical sizes, points).
SLOT_CASES = {
    "F4": ((3, 12, 10, 9), 4, [(12, 10, 9), (7, 10, 4), (12, 3, 9)], 30000),
    "F1": ((3, 12, 10, 9), 1, [(12, 10, 9), (7, 10, 4), (12, 3, 9)], 30000),
    "F3": ((3, 12, 10, 9), 3, [(12, 10, 9), (7, 10, 4), (12, 3, 9)], 30000),
    "F8_one_slot": ((1, 12, 10, 9), 8, [(9, 10, 9)], 30000),
    "n1": ((3, 12, 10, 9), 4, [(12, 10, 9), (7, 10, 4), (12, 3, 9)], 1),
    "n0": ((3, 12, 10, 9), 4, [(12, 10, 9), (7, 10, 4), (12, 3, 9)], 0),
}


def _slot_case(dev, pad, F, sizes, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = pad[0]
    stacked = torch.randn((*pad, F), generator=gen, device=dev)
    lo = -1.0 - torch.rand((S, 3), generator=gen, device=dev)
    bounds = torch.stack([lo, lo + 1.5 + torch.rand((S, 3), generator=gen, device=dev)],
                         -1).contiguous()
    ids = torch.randint(0, S, (n,), generator=gen, device=dev, dtype=torch.int32)
    b = bounds[ids.long()]
    ext = b[..., 1] - b[..., 0]
    x = (b[..., 0] - 0.1 * ext + torch.rand((n, 3), generator=gen, device=dev) * 1.2 * ext)
    return (stacked, ids, x.contiguous(), bounds,
            torch.tensor(sizes, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("case", list(SLOT_CASES), ids=list(SLOT_CASES))
def test_slot_interp_kernels_match_plain(dev, case):
    """The slot-id forward, the backward (table and points, table alone) and
    the points-only backward against the plain versions: mixed logical sizes
    below the storage, points outside their slot's bound, F = 1, 3, 4 and 8,
    0 and 1 points."""
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_per_point_cuda, grid_interpolate_per_point_grad_cuda,
        grid_interpolate_per_point_grad_plain, grid_interpolate_per_point_plain)
    args = _slot_case(dev, *SLOT_CASES[case])
    n, F = args[2].shape[0], args[0].shape[-1]
    got = grid_interpolate_per_point_cuda(*args)
    assert got.shape == (n, F)
    torch.testing.assert_close(got, grid_interpolate_per_point_plain(*args), atol=1e-4,
                               rtol=1e-4)
    g = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    r_st, r_x = grid_interpolate_per_point_grad_plain(*args, g)
    tol = dict(atol=1e-4 * max(float(r_st.abs().max()), 1e-6), rtol=0)
    d_st, d_x = grid_interpolate_per_point_grad_cuda(*args, g)
    torch.testing.assert_close(d_st, r_st, **tol)
    only, none = grid_interpolate_per_point_grad_cuda(*args, g, need_x=False)
    assert none is None
    torch.testing.assert_close(only, r_st, **tol)
    none, p_x = grid_interpolate_per_point_grad_cuda(*args, g, need_grid=False)
    assert none is None and p_x.shape == (n, 3)
    if n:
        xtol = dict(atol=1e-4 * max(float(r_x.abs().max()), 1e-6), rtol=0)
        torch.testing.assert_close(d_x, r_x, **xtol)
        torch.testing.assert_close(p_x, r_x, **xtol)


def test_slot_interp_function_grads_and_launches(dev):
    """Through the dispatching op: one forward launch; a first-order backward
    launches the table-and-points kernel, or the points-only one when the
    storage needs no gradient; under create_graph it recomputes through the
    plain version."""
    from miso_tpu_torch.ops import tiled_interp as ti
    stacked, ids, x, bounds, sizes = _slot_case(dev, *SLOT_CASES["F4"])
    for fn, attr in ((ti.grid_interpolate_per_point_cuda, "launches"),
                     (ti.grid_interpolate_per_point_grad_cuda, "launches"),
                     (ti.grid_interpolate_per_point_grad_cuda, "points_launches")):
        setattr(fn, attr, 0)
    st = stacked.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    out = ti.grid_interpolate_per_point_dispatch(st, ids, xx, bounds, sizes)
    d_st, d_x = torch.autograd.grad(out.square().sum(), (st, xx))
    assert ti.grid_interpolate_per_point_cuda.launches == 1
    assert ti.grid_interpolate_per_point_grad_cuda.launches == 1
    out = ti.grid_interpolate_per_point_dispatch(stacked, ids, xx, bounds, sizes)
    (p_x,) = torch.autograd.grad(out.square().sum(), (xx,))
    assert ti.grid_interpolate_per_point_grad_cuda.points_launches == 1
    torch.testing.assert_close(p_x, d_x, atol=1e-4 * float(d_x.abs().max()), rtol=0)
    before = ti._GridInterpPerPoint.recomputes
    out = ti.grid_interpolate_per_point_dispatch(st, ids, xx, bounds, sizes)
    (g,) = torch.autograd.grad(out.sum(), (xx,), create_graph=True)
    g.square().sum().backward()
    assert ti._GridInterpPerPoint.recomputes == before + 1
    assert st.grad is not None


# ---------------------------------------------------------------------------
# The encoder: its residual passes run the interp and decode kernels, its
# pretraining the table-only interp backward.
# ---------------------------------------------------------------------------

def _encoder_case(dev, seed=0, n=30000):
    """A GridNet of demo/encoder_init.py's width (2 levels of F=4 over a
    6 x 5 x 3.5 m bound, 1.0 m / 0.25 m cells, 8 -> 32 -> 32 -> 1 fixed
    decoder, random features), its encoder, and an observation (a tenth of
    the points outside the bound); the same on the CPU."""
    from miso_tpu_torch.models.encoder import Encoder, EncoderObservation
    from miso_tpu_torch.models.grid_net import create_grid_net
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.05,
                    "bound": [[-3.0, 3.0], [-2.5, 2.5], [-0.5, 3.0]],
                    "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 4}}
    grid = create_grid_net(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    encoder = Encoder({"model": cfg}, generator=torch.Generator().manual_seed(seed + 1),
                      trunc_dist=0.2, device=dev)
    r = np.random.default_rng(seed)
    b = np.asarray(cfg["grid"]["bound"], np.float32)
    ext = b[:, 1] - b[:, 0]
    obs_np = dict(coords_world=(b[:, 0] - 0.05 * ext + r.uniform(0, 1.1, (n, 3)) * ext),
                  gt_sdf=r.uniform(-0.4, 0.4, (n, 1)),
                  gt_sdf_sign=(r.uniform(size=(n, 1)) < 0.3),
                  gt_sdf_valid=(r.uniform(size=(n, 1)) < 0.7))

    def obs(device):
        return EncoderObservation(**{k: torch.as_tensor(v.astype(np.float32), device=device)
                                     for k, v in obs_np.items()})

    cpu_grid = copy.deepcopy(grid).cpu()
    cpu_encoder = copy.deepcopy(encoder)
    cpu_encoder.level_params = copy.deepcopy(encoder.level_params).cpu()
    return grid, encoder, obs(dev), cpu_grid, cpu_encoder, obs("cpu")


def _zero_encoder_counts():
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (_GridInterp, grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda)
    grid_interpolate_cuda.launches = mlp_decode_cuda.launches = 0
    grid_interpolate_grad_cuda.launches = grid_interpolate_grad_cuda.points_launches = 0
    _GridInterp.recomputes = 0


def _encoder_counts():
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (_GridInterp, grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda)
    return dict(interp=grid_interpolate_cuda.launches, decode=mlp_decode_cuda.launches,
                interp_grad=grid_interpolate_grad_cuda.launches,
                interp_points_grad=grid_interpolate_grad_cuda.points_launches,
                recompute=_GridInterp.recomputes)


@pytest.mark.parametrize("allow_tf32", [False, True], ids=["fp32_flags", "tf32_default"])
def test_encoder_prediction_matches_plain_and_launches(dev, allow_tf32, monkeypatch):
    """The one-shot prediction on the card against the plain ops on the CPU
    (1e-4), with one interp forward per level and one decode per residual
    pass.  With ``allow_tf32`` as PyTorch ships it for cuDNN (True), and the
    matmul flag True too, every convolution the encoder launches sees both
    flags off (recorded inside ``F.conv3d``), and the encoder leaves the
    flags as it found them."""
    grid, encoder, obs, cpu_grid, cpu_encoder, cpu_obs = _encoder_case(dev)
    seen = []
    conv3d = torch.nn.functional.conv3d

    def recording_conv3d(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv3d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv3d", recording_conv3d)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        _zero_encoder_counts()
        got = encoder.predict_corrections(encoder.register_grid_model(grid), obs)
        torch.cuda.synchronize()
        counts = _encoder_counts()
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == \
            (allow_tf32, allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert seen and set(seen) == {(False, False)}, seen
    ref = cpu_encoder.predict_corrections(cpu_encoder.register_grid_model(cpu_grid), cpu_obs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=1e-4)
    L = grid.num_levels
    assert counts == dict(interp=L * L, decode=L, interp_grad=0, interp_points_grad=0,
                          recompute=0)


def test_encoder_pretrain_gradients_match_plain_and_launches(dev):
    """encoder_pretrain_loss at target level 1 and the target level's
    gradients on the card against the CPU's: 3 residual passes (2 interp
    forwards and a decode each) and one table-only interp backward."""
    from miso_tpu_torch.models.encoder import encoder_pretrain_loss
    grid, encoder, obs, cpu_grid, cpu_encoder, cpu_obs = _encoder_case(dev, seed=3)
    n = obs.coords_world.shape[0]
    ids = torch.zeros((n,), dtype=torch.int32)
    batch = {"coords_frame": cpu_obs.coords_world, "sample_frame_ids": ids,
             "sdf": cpu_obs.gt_sdf, "sdf_signs": cpu_obs.gt_sdf_sign,
             "sdf_valid": cpu_obs.gt_sdf_valid}
    out = {}
    for name, levels, g, device in (("cuda", encoder.level_params, grid, dev),
                                    ("cpu", cpu_encoder.level_params, cpu_grid, "cpu")):
        _zero_encoder_counts()
        b = {k: v.to(device) for k, v in batch.items()}
        d = encoder_pretrain_loss(levels, g, b, None, 1, trunc_dist=0.2, sign_weight=1e2,
                                  pred_std=0.0)
        loss = sum(torch.mean(v) for v in d.values())
        grads = torch.autograd.grad(loss, list(levels[1].parameters()))
        if name == "cuda":
            torch.cuda.synchronize()
            assert _encoder_counts() == dict(interp=6, decode=3, interp_grad=1,
                                             interp_points_grad=0, recompute=0)
        out[name] = (loss.detach().cpu(), [v.cpu() for v in grads])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()), rtol=0)


def test_grid_pool_avg_on_the_card_matches_the_cpu(dev):
    """index_add on the card accumulates with float atomics, so each cell's
    sum is taken in a run-dependent order: values to 1e-5."""
    from miso_tpu_torch.ops.pooling import grid_pool_avg
    r = np.random.default_rng(4)
    coords = torch.as_tensor(r.uniform(-3.5, 3.5, (200000, 3)).astype(np.float32))
    feats = torch.as_tensor(r.normal(size=(200000, 3)).astype(np.float32))
    bound = torch.tensor([[-3.0, 3.0], [-2.5, 2.5], [-0.5, 3.0]])
    for cell in (1.0, 0.25):
        got = grid_pool_avg(coords.to(dev), feats.to(dev), bound.to(dev), cell)
        torch.testing.assert_close(got.cpu(), grid_pool_avg(coords, feats, bound, cell),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The alignment baselines, the vmapped InfoNCE loss and sphere tracing: the
# interp and decode kernels on their paths, against the CPU.
# ---------------------------------------------------------------------------

def _baseline_atlas(seed=0):
    """Two overlapping submaps (F=4, 2 levels, random features, a fixed
    random decoder) on the CPU, submap 1 perturbed; observations of submap 0
    (labels from its own field, a tenth invalid)."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0,
                    "bound": [[-1.5, 1.5], [-1.5, 1.5], [-1.0, 1.0]],
                    "base_cell_size": 0.5, "per_level_scale": 4.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": True, "num_poses": 1}}
    atlas = GridAtlas(cfg, device="cpu")
    b = np.asarray(cfg["grid"]["bound"], np.float32)
    for s in range(2):
        atlas.add_submap(b, np.eye(3, dtype=np.float32), np.array([1.0 * s, 0, 0], np.float32))
        atlas.add_kf()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for f in atlas.params.features:
            f.copy_(0.5 * torch.randn(f.shape, generator=gen))
        for W, bias in atlas.params.decoder:
            W.copy_(0.5 * torch.randn(W.shape, generator=gen))
    atlas.set_submap_pose_correction(1, [0.01, -0.02, 0.03], [0.04, -0.03, 0.02])
    r = np.random.default_rng(seed)
    coords = r.uniform(-1.4, 1.4, (6000, 3)).astype(np.float32)
    with torch.no_grad():
        gt = atlas.params.forward_submap(0, torch.as_tensor(coords)).numpy()
    valid = (r.uniform(size=gt.shape) < 0.9).astype(np.float32)
    return atlas, (coords, gt, valid)


def _align_counts():
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops import tiled_interp as ti
    return dict(interp=ti.grid_interpolate_cuda.launches,
                interp_grad=ti.grid_interpolate_grad_cuda.launches,
                interp_points_grad=ti.grid_interpolate_grad_cuda.points_launches,
                slot=ti.grid_interpolate_per_point_cuda.launches,
                slot_grad=ti.grid_interpolate_per_point_grad_cuda.launches,
                slot_points_grad=ti.grid_interpolate_per_point_grad_cuda.points_launches,
                decode=mlp_decode_cuda.launches, recompute=ti._GridInterp.recomputes)


def _zero_align_counts():
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda
    from miso_tpu_torch.ops import tiled_interp as ti
    ti.grid_interpolate_cuda.launches = mlp_decode_cuda.launches = 0
    ti.grid_interpolate_grad_cuda.launches = ti.grid_interpolate_grad_cuda.points_launches = 0
    ti.grid_interpolate_per_point_cuda.launches = 0
    ti.grid_interpolate_per_point_grad_cuda.launches = 0
    ti.grid_interpolate_per_point_grad_cuda.points_launches = 0
    ti._GridInterp.recomputes = 0


def _pose_loss_and_grads(atlas, loss):
    p = atlas.params
    rot = p.sub_rot_corr.detach().clone().requires_grad_()
    trans = p.sub_trans_corr.detach().clone().requires_grad_()
    total = sum(loss(p.replace(sub_rot_corr=rot, sub_trans_corr=trans)).values())
    return (total.detach().cpu(),) + tuple(g.cpu() for g in torch.autograd.grad(total, (rot, trans)))


@pytest.mark.parametrize("method", ["vfpp", "mips"])
def test_baseline_losses_match_the_cpu_and_launch(dev, method):
    """The pair loss and pose gradient on the card against the CPU (the plain
    versions) with the same 4096 draws; per call vfpp launches L interp
    forwards, a decode and L points-only backwards, mips three times that."""
    from miso_tpu_torch.align import baselines
    cpu, obs = _baseline_atlas()
    card = cpu.copy_to(dev)
    fn = baselines.pairwise_loss_vfpp if method == "vfpp" else baselines.pairwise_loss_mips
    kw = {"trunc_dist": 0.3} if method == "vfpp" else {"surf_tol": 0.3}
    out = {}
    for name, a in (("cpu", cpu), ("cuda", card)):
        args = [torch.as_tensor(v, device=a.device) for v in obs]
        if name == "cuda":
            _zero_align_counts()
        out[name] = _pose_loss_and_grads(a, lambda p: fn(
            p, a, 0, 1, *args, key=torch.Generator().manual_seed(3), subsample_points=4096, **kw))
    L = cpu.num_levels
    k = 1 if method == "vfpp" else 3
    assert _align_counts() == dict(interp=k * L, interp_grad=0, interp_points_grad=k * L, slot=0,
                                   slot_grad=0, slot_points_grad=0, decode=k, recompute=0)
    got, ref = out["cuda"], out["cpu"]
    assert float(ref[0]) > 0
    torch.testing.assert_close(got[0], ref[0], atol=0, rtol=1e-4)
    scale = max(float(ref[1].abs().max()), float(ref[2].abs().max()))
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, atol=1e-4 * scale, rtol=0)


def test_vmapped_infonce_matches_unrolled_and_the_cpu(dev):
    """The vmapped InfoNCE loss on the card against the unrolled per-pair one
    on the card and against itself on the CPU (same draws, CPU generators);
    per call 2L slot-id forwards and L slot-id points-only backwards."""
    from miso_tpu_torch.align import miso
    cpu, _ = _baseline_atlas(seed=1)
    cpu.precompute_coordinates_for_alignment()
    card = cpu.copy_to(dev)
    loss = miso.make_vmapped_pair_loss("latent", level=1, align_loss="InfoNCE",
                                       subsample_points=2048)
    out = {}
    for name, a in (("cpu", cpu), ("cuda", card)):
        ctx = miso.pair_context(a, 1, [(0, 1)], 2)
        if name == "cuda":
            _zero_align_counts()
        out[name] = _pose_loss_and_grads(a, lambda p: loss(p, miso.PairGenerators(4, "cpu"),
                                                           ctx))
        if name == "cuda":
            L = card.num_levels
            assert _align_counts() == dict(interp=0, interp_grad=0, interp_points_grad=0,
                                           slot=2 * L, slot_grad=0, slot_points_grad=L,
                                           decode=0, recompute=0)
    coords, valid = card.coordinates_for_alignment(0, 1)
    gens = miso.PairGenerators(4, "cpu")
    idx = torch.randperm(coords.shape[0], generator=gens.get(0, 1))[:2048].to(dev)
    unrolled = _pose_loss_and_grads(card, lambda p: miso.pairwise_loss_latent(
        p, card, 0, 1, 1, coords[idx], valid[idx], align_loss="InfoNCE"))
    for got, ref in ((out["cuda"], out["cpu"]), (out["cuda"], unrolled)):
        torch.testing.assert_close(got[0], ref[0], atol=0, rtol=1e-4)
        scale = max(float(ref[1].abs().max()), float(ref[2].abs().max()))
        for g, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, r, atol=1e-4 * scale, rtol=0)


def test_sphere_tracing_a_grid_net_matches_the_cpu(dev):
    """Sphere tracing a GridNet on the card against the CPU: per step L interp
    forwards and a decode, max_iters + 1 steps."""
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.ops import interp
    from miso_tpu_torch.utils.sdf import sphere_tracing
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.3,
                    "bound": [[-2.0, 2.0], [-2.0, 2.0], [-1.0, 1.0]],
                    "base_cell_size": 0.5, "per_level_scale": 4.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": True, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 1}}
    grid = create_grid_net(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    # A sphere of radius 1.2 in channel 0 of the coarse level, which the
    # decoder passes through (relu(x) - relu(-x)); the other channels random.
    with torch.no_grad():
        f = grid.features[0]
        v = interp.vertex_positions(f.shape[:3], grid.bound)
        f[..., 0] = (torch.linalg.vector_norm(v, dim=-1) - 1.2).reshape(f.shape[:3])
        W0, b0, W1, b1, W2, b2 = grid.decoder
        for t in (W0, b0, W1, b1, W2, b2):
            t.zero_()
        W0[0, 0], W0[0, 1], W1[0, 0], W1[1, 1], W2[0, 0], W2[1, 0] = 1, -1, 1, 1, 1, -1
    card = copy.deepcopy(grid).to(dev)
    r = np.random.default_rng(3)
    a = r.uniform(0, 2 * np.pi, 5000)
    origins = np.stack([1.9 * np.cos(a), 1.9 * np.sin(a), r.uniform(-0.5, 0.5, 5000)],
                       1).astype(np.float32)
    dirs = (-origins + r.normal(0, 0.3, origins.shape)).astype(np.float32)
    ref_p, ref_h = sphere_tracing(grid, torch.as_tensor(origins), torch.as_tensor(dirs),
                                  max_iters=40)
    _zero_align_counts()
    got_p, got_h = sphere_tracing(card, torch.as_tensor(origins, device=dev),
                                  torch.as_tensor(dirs, device=dev), max_iters=40)
    assert _align_counts() == dict(interp=2 * 41, interp_grad=0, interp_points_grad=0, slot=0,
                                   slot_grad=0, slot_points_grad=0, decode=41, recompute=0)
    # A ray whose value sits within float32 rounding of epsilon may stop a
    # step apart (a step shorter than epsilon): all but a few rays agree in
    # their hit flag.
    agree = (got_h.cpu() == ref_h)
    assert int(ref_h.sum()) > 0 and float(agree.float().mean()) > 0.999
    torch.testing.assert_close(got_p.cpu(), ref_p, atol=1e-4, rtol=0)


def _alt_model(name, device):
    """A small model of each alternative family, built on the CPU from a seed
    and moved to ``device``; its loss's batch dimension (2 or 3)."""
    from miso_tpu_torch.datasets.shapes import icosphere
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.models.hashgrid import create_hash_grid_net
    from miso_tpu_torch.models.isdf import create_isdf
    from miso_tpu_torch.models.pointsdf import create_pointsdf
    gen = torch.Generator().manual_seed(4)
    bound = [[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]]
    decoder = {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
               "pos_invariant": True}
    if name == "ngp":
        model = create_hash_grid_net(
            {"grid": {"bound": bound}, "decoder": decoder,
             "hash": {"n_levels": 6, "feature_dim": 2, "base_resolution": 8,
                      "per_level_scale": 1.6, "log2_hashmap_size": 12}},
            generator=gen, device="cpu")
    elif name == "isdf":
        model = create_isdf({"grid": {"bound": bound}}, generator=gen, device="cpu")
    elif name == "pointsdf":
        model = create_pointsdf(
            {"point": {"total_samples": 20000, "resolution": 0.1, "bound": bound},
             "decoder": {"hidden_dim": 64}}, mesh=icosphere(3, 0.7), generator=gen,
            device="cpu")
    else:
        grid = {"type": "VM" if name == "vm" else "regular", "feature_dim": 4,
                "init_stddev": 0.1, "base_cell_size": 0.5, "per_level_scale": 5.0,
                "n_levels": 2, "VM": {"rank": 10},
                "bound": bound if name == "vm" else bound[:2]}
        model = create_grid_net({"spatial_dim": 3 if name == "vm" else 2, "grid": grid,
                                 "decoder": decoder}, generator=gen, device="cpu")
    return model.to(device), (2 if name == "grid2d" else 3)


@pytest.mark.parametrize("name", ["ngp", "isdf", "pointsdf", "vm", "grid2d"])
def test_alt_models_match_the_cpu_and_launch(dev, name):
    """Each alternative model's loss and gradients on the card against a CPU
    copy; the hash grid, VM and 2D grids decode through the decode kernel
    (one launch a forward), iSDF and PointSDF through none; no interp kernel
    runs (the encodings and 2D/1D interpolation are torch ops)."""
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    cpu, d = _alt_model(name, torch.device("cpu"))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(1)
    n = 2 ** 15
    batch = {"coords": rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32),
             "sdf": rng.uniform(-0.3, 0.3, (n, 1)).astype(np.float32),
             "sdf_valid": np.ones((n, 1), np.float32),
             "sdf_signs": rng.integers(-1, 2, (n, 1)).astype(np.float32)}
    loss = make_loss(tsdf_loss_3d, eik_weight=0.0, trunc_dist=0.2)
    results = []
    for m, device in ((card, dev), (cpu, torch.device("cpu"))):
        _zero_align_counts()
        tl = sum(loss(m, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}).values())
        params = [p for p in m.parameters() if p.requires_grad]
        grads = torch.autograd.grad(tl, params, allow_unused=True)
        results.append([tl] + [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)])
        if device.type == "cuda":
            want = 1 if name in ("ngp", "vm", "grid2d") else 0
            assert _align_counts() == dict(interp=0, interp_grad=0, interp_points_grad=0,
                                           slot=0, slot_grad=0, slot_points_grad=0,
                                           decode=want, recompute=0)
    torch.testing.assert_close(results[0][0].cpu(), results[1][0], atol=0, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in results[1][1:])
    for a, b in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=0)


def test_interp_dispatch_raises_on_a_2d_card_grid(dev):
    """The interp kernels are 3D: the dispatch raises on a 2D card input (a 2D
    GridNet calls the plain rank-generic op itself)."""
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_dispatch
    grid = torch.zeros((4, 5, 2), device=dev)
    with pytest.raises(ValueError, match="3D"):
        grid_interpolate_dispatch(grid, torch.zeros((3, 2), device=dev),
                                  torch.tensor([[0.0, 1.0], [0.0, 1.0]], device=dev))


# bf16 tables: every case above again in bf16.  Values as above; a bf16
# table's gradient is the float32 one rounded once (the kernel sums in
# float32 copies), so each entry is held to the plain version's float32
# gradient within half a bf16 step (2^-8 of the entry) beyond 1e-4 of the
# largest entry; the points' gradient (float32) as above.
def _bf16_grad_close(got, ref32):
    assert got.dtype == torch.bfloat16 and got.shape == ref32.shape
    if ref32.numel():
        excess = ((got.float() - ref32).abs() - 2.0 ** -8 * ref32.abs()).clamp(min=0)
        assert float(excess.max()) <= 1e-4 * max(float(ref32.abs().max()), 1e-6)


BF16_INTERP_CASES = ["F4", "F12", "F1_odd", "scannet_coarse_1e6", "dense_region_1e6",
                     "large_grid", "padded", "padded_F1", "padded_1e6", "on_face", "n0", "n1",
                     "staging_budget_over"]


@pytest.mark.parametrize("case", BF16_INTERP_CASES, ids=BF16_INTERP_CASES)
def test_bf16_interp_kernels_match_plain(dev, case):
    """The forward (staged and L2 paths) and all three backward modes on a
    bf16 table, each launch counted as a float32 one is."""
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain,
                                                 grid_interpolate_plain)
    grid, x, bound, size, _ = _interp_case(dev, case)
    grid = grid.to(torch.bfloat16)
    before = (grid_interpolate_cuda.launches, grid_interpolate_grad_cuda.launches,
              grid_interpolate_grad_cuda.points_launches)
    out = grid_interpolate_cuda(grid, x, bound, size)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, grid_interpolate_plain(grid, x, bound, size), atol=1e-4,
                               rtol=1e-4)
    g = torch.randn((x.shape[0], grid.shape[-1]), device=dev)
    r_grid, r_x = grid_interpolate_grad_plain(grid.float(), x, bound, g, size)
    d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, g, size)
    _bf16_grad_close(d_grid, r_grid)
    _grad_close(d_x, r_x)
    only, _ = grid_interpolate_grad_cuda(grid, x, bound, g, size, need_x=False)
    _bf16_grad_close(only, r_grid)
    _, p_x = grid_interpolate_grad_cuda(grid, x, bound, g, size, need_grid=False)
    _grad_close(p_x, r_x)
    torch.cuda.synchronize()
    assert (grid_interpolate_cuda.launches, grid_interpolate_grad_cuda.launches,
            grid_interpolate_grad_cuda.points_launches) == (before[0] + 1, before[1] + 2,
                                                            before[2] + 1)


@pytest.mark.parametrize("case", list(SLOT_CASES), ids=list(SLOT_CASES))
def test_bf16_slot_interp_kernels_match_plain(dev, case):
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_per_point_cuda, grid_interpolate_per_point_grad_cuda,
        grid_interpolate_per_point_grad_plain, grid_interpolate_per_point_plain)
    stacked, *rest = _slot_case(dev, *SLOT_CASES[case])
    args = (stacked.to(torch.bfloat16), *rest)
    n, F = args[2].shape[0], stacked.shape[-1]
    torch.testing.assert_close(grid_interpolate_per_point_cuda(*args),
                               grid_interpolate_per_point_plain(*args), atol=1e-4, rtol=1e-4)
    g = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    r_st, r_x = grid_interpolate_per_point_grad_plain(args[0].float(), *rest, g)
    d_st, d_x = grid_interpolate_per_point_grad_cuda(*args, g)
    _bf16_grad_close(d_st, r_st)
    only, _ = grid_interpolate_per_point_grad_cuda(*args, g, need_x=False)
    _bf16_grad_close(only, r_st)
    _, p_x = grid_interpolate_per_point_grad_cuda(*args, g, need_grid=False)
    if n:
        _grad_close(d_x, r_x)
        _grad_close(p_x, r_x)


@pytest.mark.parametrize("shape", [(2, 4, 64, 1, 1), (3, 8, 64, 2, 3), (1, 1, 4, 0, 1)])
def test_bf16_fused_kernel_matches_plain(dev, shape):
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_plain)
    grids, x, bound, decoder = _case(dev, *shape)
    grids = [g.to(torch.bfloat16) for g in grids]
    before = fused_interp_decode_cuda.launches
    torch.testing.assert_close(fused_interp_decode_cuda(grids, x, bound, decoder),
                               fused_interp_decode_plain(grids, x, bound, decoder),
                               atol=1e-4, rtol=1e-4)
    assert fused_interp_decode_cuda.launches == before + 1


def test_kernels_refuse_other_table_dtypes(dev):
    """A float16 or float64 table raises, and so do fused levels of two
    dtypes; nothing is launched."""
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_per_point_cuda)
    grids, x, bound, decoder = _case(dev, 2, 4, 64, 1, 1)
    before = (grid_interpolate_cuda.launches, fused_interp_decode_cuda.launches)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            grid_interpolate_cuda(grids[0].to(dtype), x, bound)
        with pytest.raises(TypeError):
            grid_interpolate_per_point_cuda(
                grids[0].to(dtype)[None], torch.zeros(x.shape[0], dtype=torch.int32, device=dev),
                x, bound[None], torch.tensor([grids[0].shape[:3]], dtype=torch.int32,
                                             device=dev))
        with pytest.raises(TypeError):
            fused_interp_decode_cuda([g.to(dtype) for g in grids], x, bound, decoder)
    with pytest.raises(TypeError):
        fused_interp_decode_cuda([grids[0], grids[1].to(torch.bfloat16)], x, bound, decoder)
    assert (grid_interpolate_cuda.launches, fused_interp_decode_cuda.launches) == before


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_grid_net_trains_through_the_kernels(dev, impl):
    """A GridNet with grid.feature_dtype bfloat16 on the card, with the
    default decode and the fused op: its forward, the backward and masked
    Adam keep bf16 tables, the kernels are launched on them (the interp
    forward and backward a level, or the fused kernel, whose backward is the
    torch recompute), and no float32 copy of a table is made."""
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_grad_cuda
    from miso_tpu_torch.train.optim import masked_adam_init, masked_adam_update
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.1,
                    "feature_dtype": "bfloat16", "bound": [[-2, 2]] * 3,
                    "base_cell_size": 0.25, "per_level_scale": 4.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": False, "pretrained_model": None,
                       "impl": impl},
           "pose": {"optimize": False, "num_poses": 1}}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    assert model.features[0].dtype == torch.bfloat16
    x = torch.rand((4096, 3), device=dev) * 4 - 2
    state = masked_adam_init(model)
    named = dict(model.named_parameters())
    mask = grid_net_mask(model)

    def forward_backward():
        loss = (model(x) ** 2).mean()
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return {k: torch.zeros_like(named[k]) if g is None else g
                for k, g in zip(named, grads)}

    # A first step allocates the libraries' workspaces, once.
    masked_adam_update(forward_backward(), state, model, mask, lr=1e-2)
    counts = lambda: (grid_interpolate_cuda.launches, grid_interpolate_grad_cuda.launches,
                      fused_interp_decode_cuda.launches)
    before = counts()
    # The largest float32 copy the step could make is the fine table's.
    table32 = max(f.numel() * 4 for f in model.features)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    grads = forward_backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - start
    assert grads["features.1"].dtype == torch.bfloat16
    masked_adam_update(grads, state, model, mask, lr=1e-2)
    assert model.features[1].dtype == torch.bfloat16
    want = (2, 2, 0) if impl == "xla" else (0, 0, 1)
    assert tuple(a - b for a, b in zip(counts(), before)) == want
    # The forward and backward hold the bf16 gradients (2 bytes an element of
    # the 64^3 x 4 fine table) and the interp backward's float32 scratch (one
    # copy, 4 bytes), about 1.5 float32 tables; a float32 copy of the table
    # and its float32 gradient would add 2 more.
    assert peak < 2 * table32


def test_bf16_grid_net_frozen_query_and_eikonal(dev):
    """A bf16 GridNet's frozen query (LM tracking: the points-only backward on
    the bf16 tables, no table gradient) and the autograd eikonal (a second
    order through the differentiable recompute, which gathers bf16 rows)."""
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.ops.tiled_interp import _GridInterp, grid_interpolate_grad_cuda
    cfg = {"spatial_dim": 3,
           "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.1,
                    "feature_dtype": "bfloat16", "bound": [[-1, 1]] * 3,
                    "base_cell_size": 0.5, "per_level_scale": 4.0, "n_levels": 2},
           "decoder": {"type": "mlp", "hidden_dim": 16, "hidden_layers": 1, "out_dim": 1,
                       "pos_invariant": True, "fix": False, "pretrained_model": None},
           "pose": {"optimize": False, "num_poses": 1}}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    x = (torch.rand((4096, 3), device=dev) * 1.8 - 0.9).requires_grad_()
    before = (grid_interpolate_grad_cuda.launches, grid_interpolate_grad_cuda.points_launches)
    gx, = torch.autograd.grad(model(x, frozen=True).sum(), x)
    torch.cuda.synchronize()
    assert (grid_interpolate_grad_cuda.launches, grid_interpolate_grad_cuda.points_launches) == \
        (before[0], before[1] + 2)
    cpu = copy.deepcopy(model).to("cpu")
    xc = x.detach().cpu().requires_grad_()
    gc, = torch.autograd.grad(cpu(xc, frozen=True).sum(), xc)
    _grad_close(gx.cpu(), gc)
    recomputes = _GridInterp.recomputes
    g, = torch.autograd.grad(model(x).sum(), x, create_graph=True)
    eik = ((torch.linalg.vector_norm(g, dim=-1) - 1) ** 2).mean()
    d_fine, = torch.autograd.grad(eik, model.features[1])
    assert _GridInterp.recomputes == recomputes + 2
    assert d_fine.dtype == torch.bfloat16 and bool(torch.isfinite(d_fine.float()).all())
