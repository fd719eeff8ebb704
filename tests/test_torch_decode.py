"""miso_tpu_torch's MLP decode (ops/fused_decode.py: mlp_decode, _MlpDecode)
against miso_tpu.ops.pallas_decode.pallas_decode, its Pallas kernel in
interpret mode.

Mirrors tests/test_pallas_decode.py:21-49 (value, gradients) and adds grad^2
with respect to x through the custom_jvp, and decoders without biases.
``_MlpDecode`` runs here with the plain version standing in for the kernel.
Tolerances (tests/_torch_port.py): values rtol 1e-4 / atol 1e-5, gradients
rtol 2e-3 / atol 2e-4.

The kernel's shared-memory layout (``mma_layout``, ``csrc/mtt_mma.cuh``) is
held here too: an emulation of its staging and fragment reads in FP32
against ``mlp_apply`` and the JAX ``mlp_apply``, at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.ops.mlp import mlp_apply as jmlp_apply
from miso_tpu.ops.mlp import mlp_init as jmlp_init
from miso_tpu.ops.pallas_decode import pallas_decode
from miso_tpu_torch.ops import fused_decode as fd
from miso_tpu_torch.ops.mlp import mlp_apply


def _case(seed, fin, fout, hidden, layers, n, bias=True):
    params = jmlp_init(jax.random.PRNGKey(seed), fin, fout, hidden, layers, bias=bias)
    x = np.random.default_rng(seed).standard_normal((n, fin)).astype(np.float32)
    return params, x


def _torch_params(params):
    return tuple((t(W, True), None if b is None else t(b, True)) for W, b in params)


def _flat(params):
    return [p for pair in params for p in pair if p is not None]


def _pallas(p, xx):
    return pallas_decode(p, xx, force=True, interpret=True)


# The JAX references run under jax.jit: the interpret-mode kernel compiles
# into one program instead of dispatching op by op.
@jax.jit
def _pallas_vjp(p, xx):
    """pallas_decode's output and the gradients of sum(out^2)."""
    out, vjp = jax.vjp(_pallas, p, xx)
    return out, vjp(2.0 * out)


@pytest.fixture(scope="module", params=[True, False], ids=["bias", "no_bias"])
def first_order(request):
    """A case, pallas_decode's output on it, and the gradients of sum(out^2)
    wrt the parameters and x, from one vjp through the custom_jvp."""
    params, x = _case(0, 8, 1, 64, 1, 1000, request.param)
    return (params, x, *_pallas_vjp(params, jnp.asarray(x)))


def test_value_matches_pallas_decode(first_order):
    params, x, ref, _ = first_order
    close(fd.mlp_decode(_torch_params(params), t(x)), ref, VAL)


def test_grads_match_pallas_decode(first_order):
    params, x, _, (ref_p, ref_x) = first_order
    tp, xs = _torch_params(params), t(x, True)
    got = torch.autograd.grad((fd.mlp_decode(tp, xs) ** 2).sum(), [xs, *_flat(tp)])
    close(got[0], ref_x, GRAD)
    for a, b in zip(got[1:], jax.tree_util.tree_leaves(ref_p)):
        close(a, b, GRAD)


def test_grad2_wrt_x_matches_custom_jvp():
    """jax.grad of a gradient norm: d/dx of the decode, then its norm,
    differentiated again wrt the parameters and x."""
    params, x = _case(2, 8, 1, 32, 2, 200)

    def eik(p, xx):
        gx = jax.grad(lambda q: jnp.sum(_pallas(p, q)))(xx)
        return jnp.mean((jnp.linalg.norm(gx, axis=-1) - 1.0) ** 2)

    ref_val, (ref_p, ref_x) = jax.jit(jax.value_and_grad(eik, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tp, xs = _torch_params(params), t(x, True)
    (gx,) = torch.autograd.grad(fd.mlp_decode(tp, xs).sum(), xs, create_graph=True)
    val = ((gx.norm(dim=-1) - 1.0) ** 2).mean()
    close(val, ref_val, VAL)
    wrt = [xs, *_flat(tp)]
    got = torch.autograd.grad(val, wrt, allow_unused=True)
    got = [torch.zeros_like(w) if g is None else g for g, w in zip(got, wrt)]
    close(got[0], ref_x, GRAD)
    for a, b in zip(got[1:], jax.tree_util.tree_leaves(ref_p)):
        close(a, b, GRAD)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_function_with_plain_kernel(monkeypatch, bias):
    """_MlpDecode's forward (the kernel's slot, here the plain version) and its
    recompute backward, first and second order, against pallas_decode."""
    calls = []

    def kernel(p, xx):
        calls.append(xx.shape)
        return fd.mlp_decode_plain(p, xx)

    monkeypatch.setattr(fd, "mlp_decode_cuda", kernel)
    params, x = _case(3, 8, 3, 32, 1, 200, bias)

    def loss(p, xx):
        out = _pallas(p, xx)
        gx = jax.grad(lambda q: jnp.sum(_pallas(p, q)[:, 0]))(xx)
        return jnp.sum(out ** 2) + jnp.sum(gx ** 2)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tp, xs = _torch_params(params), t(x, True)
    flat = [p for pair in tp for p in pair]
    out = fd._MlpDecode.apply(xs, *flat)
    close(out, _pallas_vjp(params, jnp.asarray(x))[0], VAL)
    (gx,) = torch.autograd.grad(fd._MlpDecode.apply(xs, *flat)[:, 0].sum(), xs,
                                create_graph=True)
    got = torch.autograd.grad((out ** 2).sum() + (gx ** 2).sum(), [xs, *_flat(tp)])
    close(got[0], ref_x, GRAD)
    for a, b in zip(got[1:], jax.tree_util.tree_leaves(ref_p)):
        close(a, b, GRAD)
    assert calls == [(200, 8), (200, 8)]


def test_kernel_wrapper_rejects():
    """The wrapper raises, and never falls back, on what the kernel does not take."""
    params, x = _case(4, 8, 1, 16, 1, 10)
    tp = _torch_params(params)
    fd.mlp_decode_cuda.launches = 0
    for bad in (t(x).double(), t(x)[:, ::2], t(x)):   # dtype, layout, device
        with pytest.raises((TypeError, ValueError)):
            fd.mlp_decode_cuda(tp, bad)
    wide = ((torch.zeros((8, 200)), torch.zeros(200)), (torch.zeros((200, 1)), None))
    with pytest.raises(ValueError):
        fd.mlp_decode_cuda(wide, t(x))
    assert fd.mlp_decode_cuda.launches == 0


# ---------------------------------------------------------------------------
# The decode kernel's layout (csrc/mtt_mma.cuh), emulated on the CPU.
# ---------------------------------------------------------------------------

# Column p of an A fragment's 8-wide k tile holds unit PERM[p] of the tile:
# p = q <-> 2q and p = q + 4 <-> 2q + 1, so a layer's accumulator (columns 2q,
# 2q + 1 of lane q) is the next layer's A fragment as it stands.
PERM = [0, 2, 4, 6, 1, 3, 5, 7]


def _tiles(width):
    return -(-width // 8)


def _stage(params, dims):
    """The shared-memory image mtt_mma_stage builds, at mma_layout's offsets:
    float ((kt * n_tiles + nt) * 32 + lane) * 2 + j holds
    W[8kt + 2(lane % 4) + j][8nt + lane // 4], zero outside W, and each bias
    zero-padded to a multiple of 8."""
    woff, boff, w_floats, smem_bytes = fd.mma_layout(dims)
    assert smem_bytes == 4 * w_floats
    smem = torch.full((w_floats,), float("nan"))
    for l, (W, b) in enumerate(params):
        fan_in, fan_out = dims[l], dims[l + 1]
        n_tiles = _tiles(fan_out)
        i = torch.arange(_tiles(fan_in) * n_tiles * 64)
        tile, lane = i >> 6, (i >> 1) & 31
        kt, nt = tile // n_tiles, tile % n_tiles
        k, n = 8 * kt + 2 * (lane & 3) + (i & 1), 8 * nt + (lane >> 2)
        inside = (k < fan_in) & (n < fan_out)
        w = W[k.clamp(max=fan_in - 1), n.clamp(max=fan_out - 1)]
        smem[woff[l] + i] = torch.where(inside, w, torch.zeros(()))
        bias = torch.zeros(8 * n_tiles)
        if b is not None:
            bias[:fan_out] = b
        smem[boff[l]:boff[l] + 8 * n_tiles] = bias
    assert not torch.isnan(smem).any(), "the staged layers do not cover the layout"
    return smem


def _emulate(smem, dims, x):
    """The kernel's arithmetic on the CPU, in FP32 without TF32 rounding:
    rows padded with zeros to whole warp tiles (32 points, 16 above 64-wide
    layers), each layer's B tiles read from the image as the lanes read them
    (the float2 of lane (g, q) holds k rows q and q + 4 of column g), A
    columns in fragment order, bias, ReLU between layers, the output cut to
    n rows and dims[-1] columns."""
    woff, boff, _, _ = fd.mma_layout(dims)
    n = x.shape[0]
    rows = 32 if _tiles(max(dims)) <= 8 else 16
    n_pad = -(-n // rows) * rows
    act = torch.zeros((n_pad, 8 * _tiles(dims[0])))
    act[:n, :dims[0]] = x
    for l in range(len(dims) - 1):
        k_tiles, n_tiles = _tiles(dims[l]), _tiles(dims[l + 1])
        img = smem[woff[l]:woff[l] + k_tiles * n_tiles * 64]
        B = (img.reshape(k_tiles, n_tiles, 8, 4, 2)     # kt, nt, g, q, j
             .permute(0, 4, 3, 1, 2)                   # kt, j, q, nt, g: row p = 4j + q
             .reshape(8 * k_tiles, 8 * n_tiles))
        A = act.reshape(n_pad, k_tiles, 8)[:, :, PERM].reshape(n_pad, 8 * k_tiles)
        act = A @ B + smem[boff[l]:boff[l] + 8 * n_tiles]
        if l < len(dims) - 2:
            act = torch.relu(act)
    return act[:n, :dims[-1]]


LAYOUT_CASES = {"scannet": (8, 1, 64, 1, 1000), "h64x3_out3": (8, 3, 64, 2, 33),
                "base": (1, 1, 4, 0, 15), "wide_12_128_128_17": (12, 17, 128, 1, 1)}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", list(LAYOUT_CASES), ids=list(LAYOUT_CASES))
def test_staged_layout_emulation_matches_mlp_apply(shape, bias):
    """The staged weights read in fragment order give the MLP: against
    mlp_apply (the kernel's plain version) and the JAX mlp_apply, 1e-5."""
    fin, fout, hidden, layers, n = LAYOUT_CASES[shape]
    params, x = _case(5, fin, fout, hidden, layers, n, bias)
    tp = _torch_params(params)
    dims = [fin] + [W.shape[1] for W, _ in tp]
    got = _emulate(_stage(tp, dims), dims, t(x))
    tol = dict(rtol=1e-5, atol=1e-5)
    close(got, mlp_apply(tp, t(x)).detach(), tol)
    close(got, jmlp_apply(params, jnp.asarray(x)), tol)


def test_decode_arguments_layout():
    """The struct handed to the decode kernel at the ScanNet decoder widths:
    each layer's weights padded to 8 x 8 tiles, then its bias padded to 8."""
    params, x = _case(6, 8, 1, 64, 1, 64)
    tp, tx = _torch_params(params), t(x)
    a, dims = fd._decode_args(tp, tx)
    assert dims == [8, 64, 64, 1]
    assert (a.n, a.n_layers, a.x) == (64, 3, tx.data_ptr())
    assert a.W[1] == tp[1][0].data_ptr() and a.b[2] == tp[2][1].data_ptr()
    assert list(a.woff[:3]) == [0, 576, 4736]
    assert list(a.boff[:3]) == [512, 4672, 5248]
    assert a.w_floats == 5256 and a.smem_bytes == 5256 * 4
    assert list(a.dims[:4]) == [8, 64, 64, 1]


# MLP widths the fused kernel's first layout (one thread a point: weights
# with outputs padded to 16, or 4 below 16, and two activation columns of the
# widest layer for each of 64 threads) took, with the shared memory it needed
# of the block's 232,448 bytes: the ScanNet decoder, base.yaml's, and the
# widest of 4,000 random stacks of 1-9 layers of 1-128.
OLD_FUSED_LAYOUT_BYTES = {
    (8, 64, 64, 1): 52752, (1, 4, 1): 2160, (24, 64, 64, 1): 56848,
    (72, 64, 64, 1): 73232, (12, 128, 128, 17): 154752, (8, 128, 128, 128, 1): 204304,
    (128, 128, 128): 197632, (128, 64, 64, 128, 100, 32, 64, 12): 230768,
    (64, 128, 100, 128, 32, 17, 4, 8): 229504, (8, 128, 100, 100, 128, 4, 12, 3): 227408,
    (32, 4, 100, 128, 64, 32, 100, 100, 12): 226240,
    (4, 128, 128, 100, 8, 64, 32, 100, 12): 225424,
    (3, 64, 8, 100, 128, 128, 64, 4, 3): 224576, (3, 4, 100, 100, 128, 100, 3): 224208,
    (100, 100, 128, 100, 8): 223520, (100, 64, 8, 4, 128, 128, 100, 1): 221632,
    (100, 64, 100, 3, 128, 128, 32, 100): 221520,
    (100, 64, 1, 12, 100, 128, 17, 100, 100): 219888, (100, 17, 12, 128, 128, 128): 218080,
}


def test_decode_layout_takes_what_the_fused_layout_fits():
    """Every MLP the fused wrapper took in its first layout still fits in a
    block: in the decode kernel's layout and in the fused kernel's (weights
    and feature slices, no table staged)."""
    for dims, old in OLD_FUSED_LAYOUT_BYTES.items():
        assert old <= fd.SMEM_LIMIT
        assert fd.mma_layout(dims)[-1] <= fd.SMEM_LIMIT, dims
        assert fd.fused_layout(dims, [])["smem_bytes"] <= fd.SMEM_LIMIT, dims
