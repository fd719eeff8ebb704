"""miso_tpu_torch.ops.fused_decode against miso_tpu.ops.pallas_decode.

The JAX side runs the Pallas kernel as tests/test_pallas_decode.py does:
``fused_interp_decode(..., force=True)`` in interpret mode.  The port's CUDA
kernel needs a card (tests/test_torch_cuda.py, chip_smoke.py); here the
port's plain version, its recompute backward and its autograd.Function
(with the kernel call replaced by the plain version) are held to JAX.

Tolerances: values rtol 1e-4 / atol 1e-5, gradients rtol 2e-3 / atol 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.ops.mlp import mlp_init as jmlp_init
from miso_tpu.ops.pallas_decode import fused_interp_decode as jfused
from miso_tpu_torch.ops import fused_decode as fd


def _setup(rng, n_levels=2, fdim=4, N=700, inside=False):
    """tests/test_pallas_decode.py's _setup, as numpy arrays.

    ``inside`` keeps the points within the bound: at a point outside it the
    field is flat, and JAX's norm gradient at a zero spatial gradient is NaN
    where torch's is 0 (see the second-order tests).
    """
    bound = np.asarray([[-1.0, 1.0], [-1.0, 1.2], [-0.8, 1.0]], np.float32)
    grids = [rng.normal(0, 1, (5 * (l + 1), 4 * (l + 1), 3 * (l + 1), fdim)).astype(np.float32)
             for l in range(n_levels)]
    decoder = [(np.asarray(W), np.asarray(b))
               for W, b in jmlp_init(jax.random.PRNGKey(2), n_levels * fdim, 1, 32, 1)]
    x = (rng.uniform(bound[:, 0] + 0.05, bound[:, 1] - 0.05, (N, 3)) if inside
         else rng.uniform(-1.3, 1.4, (N, 3))).astype(np.float32)
    return grids, bound, decoder, x


def _pad(rng, grids):
    """Each grid padded with garbage rows, plus its logical size."""
    padded, sizes = [], []
    for g in grids:
        sp = g.shape[:3]
        p = rng.normal(0, 10, (sp[0] + 3, sp[1] + 2, sp[2] + 1, g.shape[-1])).astype(np.float32)
        p[:sp[0], :sp[1], :sp[2]] = g
        padded.append(p)
        sizes.append(np.asarray(sp, np.int32))
    return padded, sizes


def _jax(grids, x, bound, decoder, sizes=None, ignore=None):
    return jfused([jnp.asarray(g) for g in grids], jnp.asarray(x), jnp.asarray(bound),
                  tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in decoder),
                  sizes=None if sizes is None else tuple(jnp.asarray(s) for s in sizes),
                  ignore_level=None if ignore is None else jnp.asarray(ignore),
                  force=True)


def _torch_args(grids, x, bound, decoder, sizes=None, ignore=None, grad=False):
    return ([t(g, grad) for g in grids], t(x, grad), t(bound),
            [(t(W, grad), t(b, grad)) for W, b in decoder],
            None if sizes is None else [t(s) for s in sizes],
            None if ignore is None else t(ignore))


@pytest.mark.parametrize("case", ["plain", "ignore[0,1]", "sized", "sized+ignore[1,0]"])
def test_plain_matches_pallas_value(rng, case):
    grids, bound, decoder, x = _setup(rng)
    sizes, ignore = None, None
    if "sized" in case:
        grids, sizes = _pad(rng, grids)
    if "ignore" in case:
        ignore = np.asarray([0.0, 1.0] if "[0,1]" in case else [1.0, 0.0], np.float32)
    got = fd.fused_interp_decode(*_torch_args(grids, x, bound, decoder, sizes, ignore))
    close(got, _jax(grids, x, bound, decoder, sizes, ignore), VAL)


@pytest.mark.parametrize("argnum", [0, 1, 2], ids=["grids", "decoder", "x"])
def test_plain_grads_match_pallas(rng, argnum):
    grids, bound, decoder, x = _setup(rng, N=300)

    def jloss(g, p, xx):
        return jnp.sum(jfused(g, xx, jnp.asarray(bound), p, force=True) ** 2)

    jgrads = jax.grad(jloss, argnums=argnum)(
        [jnp.asarray(g) for g in grids],
        tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in decoder), jnp.asarray(x))
    tg, tx, tb, tp, _, _ = _torch_args(grids, x, bound, decoder, grad=True)
    loss = (fd.fused_interp_decode(tg, tx, tb, tp) ** 2).sum()
    wrt = [tg, [w for pair in tp for w in pair], [tx]][argnum]
    got = torch.autograd.grad(loss, wrt)
    for a, b in zip(got, jax.tree_util.tree_leaves(jgrads)):
        close(a, b, GRAD)


def _eikonal_grads(fused, grids, x, bound, decoder):
    """Mean (|d out/dx| - 1)^2 and its gradient wrt the grids, in torch."""
    tg, tx, tb, tp, _, _ = _torch_args(grids, x, bound, decoder, grad=True)
    out = fused(tg, tx, tb, tp)
    (gx,) = torch.autograd.grad(out.sum(), tx, create_graph=True)
    eik = ((torch.linalg.vector_norm(gx, dim=-1) - 1.0) ** 2).mean()
    return eik, torch.autograd.grad(eik, tg)


@pytest.fixture(scope="module")
def eikonal_case():
    """Inputs of the eikonal grad^2 check and JAX's value and grid gradients,
    computed once: points inside the bound, since outside it the field is
    flat and JAX's gradient of the norm at a zero vector is NaN (torch's is 0)."""
    grids, bound, decoder, x = _setup(np.random.default_rng(0), N=48, inside=True)
    jdec = tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in decoder)

    def eik(g):
        grad_x = jax.vmap(jax.grad(lambda pt: jfused(
            g, pt[None], jnp.asarray(bound), jdec, force=True)[0, 0]))(jnp.asarray(x))
        return jnp.mean((jnp.linalg.norm(grad_x, axis=-1) - 1.0) ** 2)

    g = [jnp.asarray(a) for a in grids]
    return (grids, bound, decoder, x), float(eik(g)), jax.grad(eik)(g)


def _check_eikonal(fused, eikonal_case):
    (grids, bound, decoder, x), jeik, jgrads = eikonal_case
    eik, grads = _eikonal_grads(fused, grids, x, bound, decoder)
    np.testing.assert_allclose(float(eik.detach()), jeik, rtol=1e-3)
    for a, b in zip(grads, jgrads):
        close(a, b, GRAD)


def test_plain_second_order_matches_pallas(eikonal_case):
    """The eikonal grad^2 of test_fused_interp_decode_second_order."""
    _check_eikonal(fd.fused_interp_decode, eikonal_case)


@pytest.mark.parametrize("case", ["plain", "sized+ignore[0,1]"])
def test_backward_matches_jax_vjp(rng, case):
    """The autograd.Function's backward, called directly on CPU tensors."""
    grids, bound, decoder, x = _setup(rng, N=300)
    sizes, ignore = None, None
    if case != "plain":
        grids, sizes = _pad(rng, grids)
        ignore = np.asarray([0.0, 1.0], np.float32)
    cot = rng.normal(0, 1, (x.shape[0], 1)).astype(np.float32)
    tg, tx, tb, tp, ts, ti = _torch_args(grids, x, bound, decoder, sizes, ignore)
    gx, g_grids, g_params = fd.fused_interp_decode_backward(
        t(cot), tg, tx, tb, tp, ts, ti)

    jsizes = None if sizes is None else tuple(jnp.asarray(s) for s in sizes)
    jig = None if ignore is None else jnp.asarray(ignore)
    _, vjp = jax.vjp(lambda g, p, xx: jfused(g, xx, jnp.asarray(bound), p, sizes=jsizes,
                                             ignore_level=jig, force=True),
                     [jnp.asarray(g) for g in grids],
                     tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in decoder),
                     jnp.asarray(x))
    jg, jp, jx = vjp(jnp.asarray(cot))
    close(gx, jx, GRAD)
    for a, b in zip(g_grids, jg):
        close(a, b, GRAD)
    for (a, b), (c, d) in zip(g_params, jp):
        close(a, c, GRAD)
        close(b, d, GRAD)


def _plain_kernel(grids, x, bound, decoder_params, sizes=None, ignore_level=None):
    """Stands in for the CUDA launch: the kernel's function, without autograd."""
    with torch.no_grad():
        return fd.fused_interp_decode_plain(grids, x, bound, decoder_params, sizes,
                                            ignore_level)


def test_autograd_function_value_grad_grad2(rng, monkeypatch, eikonal_case):
    """The Function's plumbing (saved tensors, recompute backward, grad^2)
    on CPU, with the kernel call replaced by its plain version."""
    monkeypatch.setattr(fd, "fused_interp_decode_cuda", _plain_kernel)

    def fused(grids, x, bound, decoder):
        flat = [w for pair in decoder for w in pair]
        return fd._FusedInterpDecode.apply(x, bound, None, None, len(grids), *grids, *flat)

    grids, bound, decoder, x = _setup(rng, N=200)
    tg, tx, tb, tp, _, _ = _torch_args(grids, x, bound, decoder, grad=True)
    out = fused(tg, tx, tb, tp)
    close(out, _jax(grids, x, bound, decoder), VAL)
    flat = [w for pair in tp for w in pair]
    grads = torch.autograd.grad((out ** 2).sum(), [*tg, *flat, tx])
    ref = fd.fused_interp_decode_plain(tg, tx, tb, tp)
    ref_grads = torch.autograd.grad((ref ** 2).sum(), [*tg, *flat, tx])
    for a, b in zip(grads, ref_grads):
        close(a, b, GRAD)
    _check_eikonal(fused, eikonal_case)


def _reject_cases():
    def base(rng):
        grids, bound, decoder, x = _setup(rng, N=64)
        return _torch_args(grids, x, bound, decoder)

    def d2(a):
        g, x, b, p, s, i = a
        return g, x[:, :2].contiguous(), b, p, s, i

    def f64(a):
        g, x, b, p, s, i = a
        return [v.double() for v in g], x.double(), b, p, s, i

    def no_bias(a):
        g, x, b, p, s, i = a
        return g, x, b, [(W, None) for W, _ in p], s, i

    def too_wide(a):
        g, x, b, p, s, i = a
        W = torch.zeros((8, fd.MAX_WIDTH + 1))
        return g, x, b, [(W, torch.zeros(fd.MAX_WIDTH + 1)),
                         (torch.zeros((fd.MAX_WIDTH + 1, 1)), torch.zeros(1))], s, i

    def strided(a):
        g, x, b, p, s, i = a
        return g, torch.cat([x, x], dim=1)[:, ::2], b, p, s, i

    def cpu(a):
        return a

    return {"d2": (d2, ValueError), "float64": (f64, TypeError),
            "no_bias": (no_bias, ValueError), "too_wide": (too_wide, ValueError),
            "non_contiguous": (strided, ValueError), "cpu_tensor": (cpu, ValueError)}, base


@pytest.mark.parametrize("case", ["d2", "float64", "no_bias", "too_wide",
                                  "non_contiguous", "cpu_tensor"])
def test_kernel_wrapper_rejects(rng, case):
    """The wrapper raises, and never falls back, on what the kernel does not take."""
    cases, base = _reject_cases()
    make, exc = cases[case]
    fd.fused_interp_decode_cuda.launches = 0
    with pytest.raises(exc):
        fd.fused_interp_decode_cuda(*make(base(rng)))
    assert fd.fused_interp_decode_cuda.launches == 0


def test_kernel_arguments_layout(rng):
    """The struct handed to the kernel at the ScanNet decoder widths: the
    weights as the decode kernel stages them (8 x 8 tiles, biases padded to
    8), then the 4 warps' feature slices (8 columns of 32 + 4 floats each),
    then both levels' tables, 16-byte aligned, which fit the block's
    staging budget at 3 blocks an SM."""
    grids, bound, decoder, x = _setup(rng, N=64)
    decoder = [(np.zeros((8, 64), np.float32), np.zeros(64, np.float32)),
               (np.zeros((64, 64), np.float32), np.zeros(64, np.float32)),
               (np.zeros((64, 1), np.float32), np.zeros(1, np.float32))]
    tg, tx, tb, tp, _, _ = _torch_args(grids, x, bound, decoder)
    ig = torch.zeros(2)
    dims = fd._check_args(tg, tx, tb, tp, None, ig)
    assert dims == [8, 64, 64, 1]
    out = torch.empty((64, 1))
    a = fd.pack_args(tg, tx, tb, tp, None, ig, out, dims)
    m = a.mlp
    assert list(m.woff[:3]) == [0, 576, 4736]
    assert list(m.boff[:3]) == [512, 4672, 5248]
    assert m.w_floats == 5256 and m.smem_bytes == 5256 * 4
    assert list(m.dims[:4]) == [8, 64, 64, 1] and m.W[1] == tp[1][0].data_ptr()
    assert a.rows_per_warp == 32 and a.slice_off == 5256
    assert [a.levels[l].staged for l in range(2)] == [1, 1]
    assert [a.levels[l].soff for l in range(2)] == [5256 + 4 * 8 * 36, 6408 + 5 * 4 * 3 * 4]
    assert a.smem_bytes == (6648 + 10 * 8 * 6 * 4) * 4
    assert a.x == tx.data_ptr() and a.out == out.data_ptr() and a.ignore == ig.data_ptr()
    assert a.levels[1].grid == tg[1].data_ptr() and a.levels[1].size is None
    assert list(a.levels[1].dims) == [10, 8, 6]
    assert (a.n, a.n_levels, a.fdim, a.vec4, m.n_layers) == (64, 2, 4, 1, 3)
