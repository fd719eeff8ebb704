"""miso_tpu_torch's MLP decode (ops/fused_decode.py: mlp_decode, _MlpDecode)
against miso_tpu.ops.pallas_decode.pallas_decode, its Pallas kernel in
interpret mode.

Mirrors tests/test_pallas_decode.py:21-49 (value, gradients) and adds grad^2
with respect to x through the custom_jvp, and decoders without biases.
``_MlpDecode`` runs here with the plain version standing in for the kernel.
Tolerances (tests/_torch_port.py): values rtol 1e-4 / atol 1e-5, gradients
rtol 2e-3 / atol 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import GRAD, VAL, close, t
from miso_tpu.ops.mlp import mlp_init as jmlp_init
from miso_tpu.ops.pallas_decode import pallas_decode
from miso_tpu_torch.ops import fused_decode as fd


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
