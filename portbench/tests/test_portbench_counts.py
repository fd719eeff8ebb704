"""The roofline counts and the reference's pieces against hand-computed tiny
cases.  CPU only."""
from __future__ import annotations


import pytest
import torch

from portbench.reference import field
from portbench.roofline import counts


def test_touched_rows_counts_distinct_corners_inside_the_table():
    bound = torch.tensor([[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]])
    # Cell centres at 0.5, 1.5, ...: a point at a centre still reads 8 corners
    # (weights 0 for half of them); two points in one cell share them all.
    x = torch.tensor([[1.75, 1.75, 1.75], [1.8, 1.8, 1.8], [0.1, 0.1, 0.1]])
    # The first two touch rows {1, 2}^3 = 8; the third {-1, 0}^3 of which only
    # (0, 0, 0) lies inside.
    assert counts.touched_rows(x, bound, (4, 4, 4)) == 9


def test_interp_counts_by_hand():
    f = counts.interp_forward(n=10, fdim=4, rows=7)
    assert f["flops_simt"] == 2 * 8 * 4 * 10
    assert f["nbytes"] == 12 * 10 + 7 * 4 * 4 + 4 * 10 * 4
    b = counts.interp_backward(n=10, fdim=4, table_rows=100, rows=7, need_x=True)
    assert b["flops_simt"] == 2 * (2 * 8 * 4 * 10)
    assert b["nbytes"] == 12 * 10 + 4 * 10 * 4 + 100 * 4 * 4 + 7 * 4 * 4 + 12 * 10
    b0 = counts.interp_backward(n=10, fdim=4, table_rows=100, rows=7, need_x=False)
    assert b0["nbytes"] == 12 * 10 + 4 * 10 * 4 + 100 * 4 * 4


def test_decode_counts_by_hand():
    dims = (8, 64, 64, 1)
    macs = 8 * 64 + 64 * 64 + 64 * 1
    weights = macs + 64 + 64 + 1
    f = counts.decode_forward(100, dims)
    assert f["flops_tensor"] == 2 * 100 * macs
    assert f["nbytes"] == 4 * (100 * 9 + weights)
    b = counts.decode_backward(100, dims, weight_grads=False)
    assert b["flops_tensor"] == 2 * 100 * macs
    assert b["nbytes"] == 4 * (100 * 17 + weights)
    assert counts.decode_backward(100, dims, weight_grads=True)["flops_tensor"] == 4 * 100 * macs


def test_least_time_is_the_longer_of_operations_and_bytes():
    p = counts.PEAKS
    assert counts.least_s(flops_simt=p["fp32_flops"]) == pytest.approx(1.0)
    assert counts.least_s(flops_tensor=p["fp32_exact_tensor_flops"]) == pytest.approx(1.0)
    assert counts.least_s(nbytes=2 * p["hbm_bytes_per_s"], flops_simt=1.0) == pytest.approx(2.0)


def test_trilinear_by_hand():
    # A 2x2x2 table over [0, 2]^3: centres at 0.5 and 1.5.
    table = torch.arange(8, dtype=torch.float32).reshape(2, 2, 2, 1)
    bound = torch.tensor([[0.0, 2.0]] * 3)
    x = torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.5, 1.5], [0.25, 0.5, 0.5]])
    got = field.trilinear(table, x, bound)[:, 0]
    # The centre of the box: the mean of all 8; a node: its value; a quarter
    # cell below the first node: (1 - 0.25) of it, the rest reads zero.
    assert got.tolist() == pytest.approx([3.5, 1.0, 0.75 * 0.0])
    x = torch.tensor([[1.5, 1.0, 0.5]])
    assert field.trilinear(table, x, bound)[0, 0] == pytest.approx((4 + 6) / 2)


def test_mlp_and_mapping_loss_by_hand():
    W0, b0 = torch.tensor([[1.0, -1.0]]), torch.tensor([0.0, 0.5])
    W1, b1 = torch.tensor([[2.0], [3.0]]), torch.tensor([-1.0])
    h = torch.tensor([[1.0], [-2.0]])
    # relu([1, -0.5]) = [1, 0] -> 2 - 1 = 1; relu([-2, 2.5]) = [0, 2.5] -> 7.5 - 1.
    assert field.mlp([(W0, b0), (W1, b1)], h, "fp32")[:, 0].tolist() == [1.0, 6.5]
    pred = torch.tensor([[0.2], [0.0], [-0.1]])
    batch = {"sdf": torch.tensor([[0.1], [0.3], [0.1]]),
             "sdf_valid": torch.tensor([[1.0], [1.0], [0.0]]),
             "sdf_signs": torch.tensor([[0.0], [1.0], [1.0]]),
             "weights": torch.ones(3, 1)}
    l1 = field.mapping_loss(pred, batch, "L1", 1.0, 0.0, 0.15)
    assert float(l1) == pytest.approx((0.1 + 0.3) / 3)
    # Free space on rows 2 and 3: max(relu(0 - 0.3), relu(0.15 - 0)) = 0.15,
    # max(relu(-0.2), relu(0.25)) = 0.25.
    l2 = field.mapping_loss(pred, batch, "L2", 1.0, 0.5, 0.15)
    assert float(l2) == pytest.approx((0.01 + 0.09) / 3 + 0.5 * (0.15 + 0.25) / 3)


def test_adam_first_step_moves_by_the_learning_rate():
    p = {"a": torch.tensor([1.0, -2.0, 3.0])}
    opt = field.Adam(p, lr=0.1)
    opt.step(p, {"a": torch.tensor([0.5, -4.0, 0.0])})
    # m_hat / sqrt(v_hat) = sign(g) where g != 0; 0 where it is 0.
    assert p["a"].tolist() == pytest.approx([0.9, -1.9, 3.0], abs=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 1.0 + 3 * 2 ** -12])
    # A tie rounds to even; above half rounds up.
    assert field.tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
