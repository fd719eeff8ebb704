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
                                   (2, 4, 128, 1, 17)],
                         ids=["scannet", "3lvl_F8_out3", "base", "wide_out17"])
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


@pytest.mark.parametrize("fdim", [1, 4, 12])
def test_interp_kernels_match_plain(dev, fdim):
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain,
                                                 grid_interpolate_plain)
    grids, x, bound, _ = _case(dev, 2, fdim, 16, 0, 1, n=20000, seed=fdim)
    grid = grids[1]
    torch.testing.assert_close(grid_interpolate_cuda(grid, x, bound),
                               grid_interpolate_plain(grid, x, bound), atol=1e-4, rtol=1e-4)
    g = torch.randn((x.shape[0], fdim), device=dev)
    for got, ref in zip(grid_interpolate_grad_cuda(grid, x, bound, g),
                        grid_interpolate_grad_plain(grid, x, bound, g)):
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    padded = torch.randn((grid.shape[0] + 2, grid.shape[1] + 1, grid.shape[2] + 3, fdim),
                         device=dev)
    padded[:grid.shape[0], :grid.shape[1], :grid.shape[2]] = grid
    size = torch.tensor(grid.shape[:3], dtype=torch.int32, device=dev)
    torch.testing.assert_close(grid_interpolate_cuda(padded, x, bound, size),
                               grid_interpolate_plain(grid, x, bound), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(8, 1, 64, 1), (8, 3, 64, 2), (1, 1, 4, 0)],
                         ids=["scannet", "h64x3_out3", "base"])
def test_decode_kernel_matches_plain(dev, shape):
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.mlp import mlp_init
    fin, fout, hidden, layers = shape
    params = mlp_init(fin, fout, hidden, layers, generator=torch.Generator().manual_seed(0),
                      device=dev)
    x = torch.randn((30000, fin), device=dev)
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
