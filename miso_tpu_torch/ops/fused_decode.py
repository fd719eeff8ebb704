"""Fused multi-level interp + concat + MLP decode, and the MLP decode alone
(ports of ``miso_tpu/ops/pallas_decode.py::fused_interp_decode`` and
``pallas_decode``).

The fused op has three parts:

  * :func:`fused_interp_decode_cuda`, the wrapper of the CUDA kernel
    ``csrc/fused_interp_decode.cu`` (the lerp of every level, from tables
    staged in shared memory where they fit, feeding the decode kernel's
    tensor-core MLP; :func:`fused_layout`).  It validates its inputs,
    launches on PyTorch's current stream, counts its launches in
    ``.launches`` and raises on what the kernel does not take.  It never
    falls back.
  * :func:`fused_interp_decode_plain`, ``multi_level_interpolate`` followed
    by ``grid_decode``: the kernel's plain version, used for CPU tensors and
    as the reference the kernel is held to.
  * ``_FusedInterpDecode``, a ``torch.autograd.Function`` whose forward is
    the kernel and whose backward, like the JAX version's ``_fused_jvp``,
    recomputes the lerp and MLP with differentiable torch ops
    (:func:`fused_interp_decode_backward`), so derivatives of any order work.

The decode op has the same three: :func:`mlp_decode_cuda` (kernel
``csrc/mlp_decode.cu``, a 3xTF32 tensor-core MLP, ``csrc/mtt_mma.cuh``), its
plain version :func:`mlp_decode_plain` (``ops/mlp.py::mlp_apply``) and
``_MlpDecode``, whose backward recomputes the MLP with torch ops as
``_decode_jvp`` does.

:func:`fused_interp_decode` and :func:`mlp_decode` dispatch on the device of
``x``: CUDA tensors go through the kernel, CPU tensors through the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from miso_tpu_torch.ops.interp import grid_decode, multi_level_interpolate
from miso_tpu_torch.ops.mlp import mlp_apply

# Mirrors of the kernels' compile-time maxima (csrc/mtt_mma.cuh), checked
# against each library when it is loaded.
MAX_LEVELS = 8
MAX_LAYERS = 8
MAX_WIDTH = 128
SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
# The fused kernel's block: 4 warps (MTT_MMA_THREADS), registers cut for 3
# resident blocks an SM (MTT_MMA_MIN_BLOCKS); its tables are staged within
# the shared memory that leaves a block.
MMA_WARPS = 4
FUSED_BLOCKS_PER_SM = 3


class _Level(ctypes.Structure):
    _fields_ = [("grid", ctypes.c_void_p), ("size", ctypes.c_void_p),
                ("dims", ctypes.c_int * 3), ("staged", ctypes.c_int),
                ("soff", ctypes.c_int)]


class _MmaMlp(ctypes.Structure):
    _fields_ = [("n_layers", ctypes.c_int), ("w_floats", ctypes.c_int),
                ("smem_bytes", ctypes.c_int),
                ("W", ctypes.c_void_p * MAX_LAYERS),
                ("b", ctypes.c_void_p * MAX_LAYERS),
                ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
                ("woff", ctypes.c_int * MAX_LAYERS),
                ("boff", ctypes.c_int * MAX_LAYERS)]


class _FusedArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("bound", ctypes.c_void_p),
                ("ignore", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("n_levels", ctypes.c_int),
                ("fdim", ctypes.c_int), ("vec4", ctypes.c_int),
                ("rows_per_warp", ctypes.c_int), ("slice_off", ctypes.c_int),
                ("smem_bytes", ctypes.c_int),
                ("levels", _Level * MAX_LEVELS),
                ("mlp", _MmaMlp), ("bf16", ctypes.c_int)]


# The MLP's fields are anonymous: ``args.woff`` reads ``args.mlp.woff``.
class _DecodeArgs(ctypes.Structure):
    _anonymous_ = ("mlp",)
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("mlp", _MmaMlp)]


def _round_up(v, m):
    return (v + m - 1) // m * m


def mma_layout(dims: Sequence[int]):
    """Shared-memory layout of the MLP of the decode and fused kernels
    (``csrc/mtt_mma.cuh``) for MLP widths ``dims``.

    Each layer's weights, zero-padded to multiples of 8 in both dimensions
    and stored in the order the warps' mma fragments read them, then its bias
    zero-padded to a multiple of 8.  Returns (woff, boff, w_floats,
    smem_bytes).
    """
    woff, boff, off = [], [], 0
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        woff.append(off)
        off += _round_up(fan_in, 8) * _round_up(fan_out, 8)
        boff.append(off)
        off += _round_up(fan_out, 8)
    return woff, boff, off, off * 4


def fused_layout(dims: Sequence[int], level_bytes: Sequence[int]):
    """Shared-memory layout of the fused kernel for MLP widths ``dims``
    (``dims[0]`` = levels x F) and levels whose storage takes
    ``level_bytes``.

    The weights as :func:`mma_layout` stages them; then each of the 4 warps'
    feature slices, 8 * ceil(dims[0] / 8) columns of rows_per_warp + 4 floats
    (rows_per_warp: 32 points a warp tile when every width fits 64, else 16,
    as the decode kernel takes them); then each staged level's table in level
    order, 16-byte aligned.  Which levels are staged is
    ``ops/tiled_interp.py::staged_tables`` for the shared memory left beside
    the weights and slices at 3 blocks an SM.  Returns a dict of woff, boff,
    w_floats, rows_per_warp, slice_off, staged, soff (float offsets, 0 where
    not staged) and smem_bytes.
    """
    from miso_tpu_torch.ops.tiled_interp import staged_tables
    woff, boff, w_floats, _ = mma_layout(dims)
    rows = 32 if _round_up(max(dims), 8) // 8 <= 8 else 16
    off = w_floats + MMA_WARPS * _round_up(dims[0], 8) * (rows + 4)
    staged = staged_tables(level_bytes, 4 * off, FUSED_BLOCKS_PER_SM)
    soff = []
    for nbytes, st in zip(level_bytes, staged):
        soff.append(off if st else 0)
        off += _round_up(nbytes, 16) // 4 if st else 0
    return dict(woff=woff, boff=boff, w_floats=w_floats, rows_per_warp=rows,
                slice_off=w_floats, staged=staged, soff=soff, smem_bytes=4 * off)


def _check_tensors(named, device):
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _check_mlp(decoder_params, in_dim, device, bias_required, smem_bytes):
    """Raise on an MLP the kernels do not take; returns its widths.
    ``smem_bytes(dims)`` is the kernel's shared memory for widths ``dims``."""
    if not 1 <= len(decoder_params) <= MAX_LAYERS:
        raise ValueError(f"{len(decoder_params)} layers; the kernel takes 1..{MAX_LAYERS}")
    dims = [in_dim]
    named = []
    for i, (W, b) in enumerate(decoder_params):
        if b is None and bias_required:
            raise ValueError(f"decoder layer {i} has no bias; the kernel needs one")
        if W.ndim != 2 or W.shape[0] != dims[-1] or (
                b is not None and tuple(b.shape) != (W.shape[1],)):
            raise ValueError(f"decoder layer {i}: W {tuple(W.shape)}, b "
                             f"{None if b is None else tuple(b.shape)} after width "
                             f"{dims[-1]}")
        named.append((f"W[{i}]", W))
        if b is not None:
            named.append((f"b[{i}]", b))
        dims.append(W.shape[1])
    _check_tensors(named, device)
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"MLP widths {dims} exceed the kernel's maximum {MAX_WIDTH}")
    smem = smem_bytes(dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP widths {dims} need {smem} B of shared memory; "
                         f"the kernel has {SMEM_LIMIT}")
    return dims


def _check_args(grids, x, bound, decoder_params, sizes, ignore_level):
    """Raise on anything the fused kernel does not take; returns the MLP widths.
    The tables may be float32 or bfloat16, all of one dtype; every other
    tensor is float32."""
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"the fused kernel is 3D only: x has shape {tuple(x.shape)}")
    n_levels = len(grids)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} levels; the kernel takes 1..{MAX_LEVELS}")
    fdim = grids[0].shape[-1]
    from miso_tpu_torch.ops.tiled_interp import TABLE_DTYPES
    if grids[0].dtype not in TABLE_DTYPES:
        raise TypeError(f"grids[0] is {grids[0].dtype}; the kernel takes float32 or "
                        "bfloat16 tables")
    for l, g in enumerate(grids):
        if g.dtype != grids[0].dtype:
            raise TypeError(f"grids[{l}] is {g.dtype}, grids[0] {grids[0].dtype}: the "
                            "kernel takes the levels in one dtype")
        if g.device != x.device:
            raise ValueError(f"grids[{l}] is on {g.device}, x on {x.device}")
        if not g.is_contiguous():
            raise ValueError(f"grids[{l}] is not contiguous")
    named = [("x", x), ("bound", bound)]
    if ignore_level is not None:
        named.append(("ignore_level", ignore_level))
    _check_tensors(named, x.device)
    if tuple(bound.shape) != (3, 2):
        raise ValueError(f"bound has shape {tuple(bound.shape)}, expected (3, 2)")
    if ignore_level is not None and tuple(ignore_level.shape) != (n_levels,):
        raise ValueError(f"ignore_level has shape {tuple(ignore_level.shape)}")
    for l, g in enumerate(grids):
        if g.ndim != 4 or g.shape[-1] != fdim:
            raise ValueError(f"grids[{l}] has shape {tuple(g.shape)}; expected "
                             f"(X, Y, Z, {fdim})")
    if sizes is not None:
        if len(sizes) != n_levels:
            raise ValueError(f"{len(sizes)} sizes for {n_levels} levels")
        for l, s in enumerate(sizes):
            if s.dtype != torch.int32 or tuple(s.shape) != (3,):
                raise TypeError(f"sizes[{l}] must be a (3,) int32 tensor")
            if s.device != x.device or not s.is_contiguous():
                raise ValueError(f"sizes[{l}] must be contiguous and on {x.device}")
    return _check_mlp(decoder_params, n_levels * fdim, x.device, bias_required=True,
                      smem_bytes=lambda dims: fused_layout(dims, [])["smem_bytes"])


def _pack_mlp(m, decoder_params, dims, woff, boff, w_floats):
    m.n_layers, m.w_floats, m.smem_bytes = len(decoder_params), w_floats, 4 * w_floats
    for i, (W, b) in enumerate(decoder_params):
        m.W[i], m.b[i] = W.data_ptr(), None if b is None else b.data_ptr()
        m.woff[i], m.boff[i] = woff[i], boff[i]
    m.dims[:len(dims)] = dims


def pack_args(grids, x, bound, decoder_params, sizes, ignore_level, out, dims):
    """The fused kernel's argument struct for validated inputs and ``out``."""
    from miso_tpu_torch.ops.tiled_interp import table_bytes
    lay = fused_layout(dims, [table_bytes(g) for g in grids])
    a = _FusedArgs()
    a.x, a.bound, a.out = x.data_ptr(), bound.data_ptr(), out.data_ptr()
    a.ignore = ignore_level.data_ptr() if ignore_level is not None else None
    a.n, a.n_levels, a.fdim = x.shape[0], len(grids), grids[0].shape[-1]
    a.vec4 = int(a.fdim % 4 == 0 and all(g.data_ptr() % (4 * g.element_size()) == 0
                                         for g in grids))
    a.bf16 = int(grids[0].dtype == torch.bfloat16)
    a.rows_per_warp, a.slice_off, a.smem_bytes = (
        lay["rows_per_warp"], lay["slice_off"], lay["smem_bytes"])
    for l, g in enumerate(grids):
        a.levels[l].grid = g.data_ptr()
        a.levels[l].size = sizes[l].data_ptr() if sizes is not None else None
        a.levels[l].dims[:] = list(g.shape[:3])
        a.levels[l].staged, a.levels[l].soff = int(lay["staged"][l]), lay["soff"][l]
    _pack_mlp(a.mlp, decoder_params, dims, lay["woff"], lay["boff"], lay["w_floats"])
    return a


@functools.cache
def _library(name: str = "fused_interp_decode"):
    """Load (building if needed) ``csrc/<name>.cu``, one of the MLP kernels."""
    from miso_tpu_torch.ops._build import load_library
    lib = load_library(name)
    lib.mtt_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.mtt_limits.restype = None
    lib.mtt_error_string.argtypes = [ctypes.c_int]
    lib.mtt_error_string.restype = ctypes.c_char_p
    launcher, args = {"fused_interp_decode": ("mtt_fused_interp_decode", _FusedArgs),
                      "mlp_decode": ("mtt_mlp_decode", _DecodeArgs)}[name]
    getattr(lib, launcher).argtypes = [ctypes.POINTER(args), ctypes.c_int,
                                       ctypes.c_void_p]
    getattr(lib, launcher).restype = ctypes.c_int
    occupancy = getattr(lib, launcher + "_occupancy")
    occupancy.argtypes = [ctypes.POINTER(args), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occupancy.restype = ctypes.c_int
    limits = (ctypes.c_int * 3)()
    lib.mtt_limits(limits)
    if tuple(limits) != (MAX_LEVELS, MAX_LAYERS, MAX_WIDTH):
        raise RuntimeError(f"kernel limits {tuple(limits)} differ from the "
                           "wrapper's mirror of them")
    return lib


def _launch(lib, launcher, args, device, what):
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, launcher)(ctypes.byref(args), device.index,
                                  ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.mtt_error_string(code).decode())


def fused_interp_decode_cuda(grids: Sequence[torch.Tensor], x: torch.Tensor,
                             bound: torch.Tensor, decoder_params,
                             sizes: Optional[Sequence[torch.Tensor]] = None,
                             ignore_level: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Launch the CUDA kernel: (N, 3) float32 points -> (N, out) float32,
    from float32 or bfloat16 tables (each bf16 row widened as it is read).

    Raises (and never falls back) on a non-CUDA tensor, d != 3, tables of
    another dtype or of mixed dtypes, any other tensor not float32, a missing
    bias, widths above the kernel's maxima and non-contiguous inputs.  No
    autograd: see :func:`fused_interp_decode`.
    """
    dims = _check_args(grids, x, bound, decoder_params, sizes, ignore_level)
    if not x.is_cuda:
        raise ValueError(f"fused_interp_decode_cuda needs CUDA tensors, got {x.device}")
    lib = _library()
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    a = pack_args(grids, x, bound, decoder_params, sizes, ignore_level, out, dims)
    _launch(lib, "mtt_fused_interp_decode", a, x.device, "fused_interp_decode")
    fused_interp_decode_cuda.launches += 1
    return out


fused_interp_decode_cuda.launches = 0


def fused_interp_decode_occupancy(grids, x, bound, decoder_params, sizes=None,
                                  ignore_level=None):
    """The fused kernel that ``fused_interp_decode_cuda`` would launch on
    these inputs, from the CUDA occupancy calculator: a dict of its resident
    blocks per SM, threads per block, points per warp tile, shared-memory
    bytes per block and which levels it stages."""
    dims = _check_args(grids, x, bound, decoder_params, sizes, ignore_level)
    out = torch.empty((0, dims[-1]), dtype=torch.float32, device=x.device)
    a = pack_args(grids, x, bound, decoder_params, sizes, ignore_level, out, dims)
    return dict(_occupancy(_library(), "mtt_fused_interp_decode", a, x.device),
                smem_bytes=a.smem_bytes,
                staged=[bool(a.levels[l].staged) for l in range(len(grids))])


def _occupancy(lib, launcher, args, device):
    got = (ctypes.c_int * 3)()
    code = getattr(lib, launcher + "_occupancy")(ctypes.byref(args), device.index, got)
    if code != 0:
        raise RuntimeError(f"{launcher} occupancy query failed: "
                           + lib.mtt_error_string(code).decode())
    return dict(blocks_per_sm=got[0], threads=got[1], rows_per_warp=got[2])


def fused_interp_decode_plain(grids, x, bound, decoder_params, sizes=None,
                              ignore_level=None):
    """The kernel's plain PyTorch version: interpolate, concat, decode.  A
    bf16 table's gathered rows are widened by the lerp's promotion against
    the float32 weights: the values of ``table.float()``, with no float32
    copy of the table (the backward's recompute runs this on the card)."""
    feats = multi_level_interpolate(grids, x, bound, ignore_level, sizes)
    return grid_decode(feats, x, decoder_params, True)


def fused_interp_decode_backward(grad_out, grids, x, bound, decoder_params,
                                 sizes=None, ignore_level=None,
                                 create_graph=False):
    """Cotangents of the fused op by a differentiable torch-op recompute.

    The counterpart of the JAX version's ``_fused_jvp``: the lerp and MLP are
    recomputed through ``ops/interp.py`` and ``ops/mlp.py`` and differentiated
    with ``torch.autograd.grad``.  Inputs that do not require grad get a local
    leaf.  With ``create_graph`` the result is itself differentiable (grad^2).

    Returns (d_x, (d_grid per level), ((d_W, d_b) per layer)).
    """
    with torch.enable_grad():
        def leaf(t):
            return t if t.requires_grad else t.detach().requires_grad_()

        x_ = leaf(x)
        grids_ = [leaf(g) for g in grids]
        params_ = [(leaf(W), leaf(b)) for W, b in decoder_params]
        flat = [t for pair in params_ for t in pair]
        out = fused_interp_decode_plain(grids_, x_, bound, params_, sizes,
                                        ignore_level)
        grads = torch.autograd.grad(out, [x_, *grids_, *flat], grad_out,
                                    create_graph=create_graph, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, [x_, *grids_, *flat])]
    n = len(grids)
    g_flat = grads[1 + n:]
    return grads[0], tuple(grads[1:1 + n]), tuple(zip(g_flat[0::2], g_flat[1::2]))


class _FusedInterpDecode(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: differentiable torch-op recompute."""

    @staticmethod
    def forward(ctx, x, bound, ignore_level, sizes, n_levels, *tensors):
        grids = tensors[:n_levels]
        flat = tensors[n_levels:]
        params = tuple(zip(flat[0::2], flat[1::2]))
        out = fused_interp_decode_cuda(grids, x, bound, params, sizes, ignore_level)
        ctx.save_for_backward(x, bound, *tensors)
        ctx.n_levels = n_levels
        ctx.sizes = sizes
        ctx.ignore_level = ignore_level
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, bound, *tensors = ctx.saved_tensors
        n = ctx.n_levels
        grids = tensors[:n]
        flat = tensors[n:]
        params = tuple(zip(flat[0::2], flat[1::2]))
        gx, g_grids, g_params = fused_interp_decode_backward(
            grad_out, grids, x, bound, params, ctx.sizes, ctx.ignore_level,
            create_graph=torch.is_grad_enabled())
        g_flat = [g for pair in g_params for g in pair]
        return (gx, None, None, None, None, *g_grids, *g_flat)


def fused_interp_decode(grids: Sequence[torch.Tensor], x: torch.Tensor,
                        bound: torch.Tensor, decoder_params,
                        sizes: Optional[Sequence[torch.Tensor]] = None,
                        ignore_level: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Multi-level trilinear interp + concat + MLP decode, fused.

    Drop-in for ``grid_decode(multi_level_interpolate(...))`` on the
    pos_invariant path.  CUDA tensors run the kernel (differentiable to any
    order through the recompute backward); CPU tensors run the plain version.
    """
    if x.is_cuda:
        flat = [t for pair in decoder_params for t in pair]
        return _FusedInterpDecode.apply(x, bound, ignore_level,
                                        None if sizes is None else tuple(sizes),
                                        len(grids), *grids, *flat)
    if x.device.type == "cpu":
        return fused_interp_decode_plain(grids, x, bound, decoder_params, sizes,
                                         ignore_level)
    raise ValueError(f"fused_interp_decode runs on CUDA or CPU tensors, not {x.device}")


# ---------------------------------------------------------------------------
# The MLP decode alone (port of pallas_decode / _decode_kernel).
# ---------------------------------------------------------------------------

def _decode_args(decoder_params, x):
    """Check ``x`` and the MLP for the decode kernel and pack its arguments
    but the output; returns (args, dims)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (N, F_in), got shape {tuple(x.shape)}")
    _check_tensors([("x", x)], x.device)
    dims = _check_mlp(decoder_params, x.shape[1], x.device, bias_required=False,
                      smem_bytes=lambda dims: mma_layout(dims)[-1])
    woff, boff, w_floats, smem = mma_layout(dims)
    a = _DecodeArgs()
    a.x, a.n = x.data_ptr(), x.shape[0]
    a.n_layers, a.w_floats, a.smem_bytes = len(decoder_params), w_floats, smem
    for i, (W, b) in enumerate(decoder_params):
        a.W[i], a.b[i] = W.data_ptr(), None if b is None else b.data_ptr()
        a.woff[i], a.boff[i] = woff[i], boff[i]
    a.dims[:len(dims)] = dims
    return a, dims


def mlp_decode_cuda(decoder_params, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel ``csrc/mlp_decode.cu``: (N, F_in) float32 ->
    (N, out) float32, ReLU between layers, a None bias taken as zeros.

    Raises (and never falls back) on a non-CUDA tensor, a non-f32 dtype,
    widths above the kernel's maxima and non-contiguous inputs.  No
    autograd: see :func:`mlp_decode`.
    """
    a, dims = _decode_args(decoder_params, x)
    if not x.is_cuda:
        raise ValueError(f"mlp_decode_cuda needs CUDA tensors, got {x.device}")
    lib = _library("mlp_decode")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    a.out = out.data_ptr()
    _launch(lib, "mtt_mlp_decode", a, x.device, "mlp_decode")
    mlp_decode_cuda.launches += 1
    return out


def mlp_decode_occupancy(decoder_params, x: torch.Tensor):
    """The decode kernel that ``mlp_decode_cuda(decoder_params, x)`` would
    launch, from the CUDA occupancy calculator: a dict of its resident blocks
    per SM, threads per block, points per warp tile and shared-memory bytes
    per block."""
    a, _ = _decode_args(decoder_params, x)
    return dict(_occupancy(_library("mlp_decode"), "mtt_mlp_decode", a, x.device),
                smem_bytes=a.smem_bytes)


mlp_decode_cuda.launches = 0


def mlp_decode_plain(decoder_params, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``ops/mlp.py::mlp_apply``."""
    return mlp_apply(decoder_params, x)


class _MlpDecode(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the MLP recomputed with torch ops
    and differentiated (``_decode_jvp``'s counterpart), so the result is
    itself differentiable when the backward runs with ``create_graph``."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return mlp_decode_cuda(tuple(zip(flat[0::2], flat[1::2])), x)

    @staticmethod
    def backward(ctx, grad_out):
        x, *flat = ctx.saved_tensors
        inputs = [x, *flat]
        wrt = [i for i, t in enumerate(inputs)
               if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * len(inputs)
        if wrt:
            with torch.enable_grad():
                out = mlp_apply(tuple(zip(flat[0::2], flat[1::2])), x)
                got = torch.autograd.grad(out, [inputs[i] for i in wrt], grad_out,
                                          create_graph=torch.is_grad_enabled(),
                                          allow_unused=True)
            for i, g in zip(wrt, got):
                grads[i] = torch.zeros_like(inputs[i]) if g is None else g
        return tuple(grads)


def mlp_decode(decoder_params, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP decode, a drop-in for ``ops/mlp.py::mlp_apply``.

    CUDA tensors run the kernel (differentiable to any order through the
    recompute backward); CPU tensors run the plain version.
    """
    if x.is_cuda:
        flat = [t for pair in decoder_params for t in pair]
        return _MlpDecode.apply(x.contiguous(), *flat)
    if x.device.type == "cpu":
        return mlp_decode_plain(decoder_params, x)
    raise ValueError(f"mlp_decode runs on CUDA or CPU tensors, not {x.device}")
