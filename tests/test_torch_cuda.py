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
