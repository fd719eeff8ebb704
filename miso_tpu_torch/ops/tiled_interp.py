"""Single-level trilinear interpolation on the card (port of
``miso_tpu/ops/pallas_interp.py``: ``tiled_grid_interpolate`` and
``sorted_tiled_interp``).

The TPU op bins points into (8, 16, 16)-cell tiles, sorts them and returns
its output in tile-sorted order, because the TPU cannot gather per point.
The function it computes is ``ops/interp.py::grid_interpolate``
(align_corners=False, zeros padding, channel-last grids) and that is what
this module computes, in the caller's point order:

  * :func:`grid_interpolate_cuda` and :func:`grid_interpolate_grad_cuda`,
    the wrappers of the CUDA kernels in ``csrc/grid_interp.cu`` (forward;
    backward: the grid's gradient by float4 atomics, spread over L2-resident
    copies of a small table, plus, when asked, the points' gradient; or, with
    ``need_grid=False``, the points' gradient alone, with no table gradient,
    copies or atomics).  They validate their inputs, launch on PyTorch's
    current stream, count their calls (``.launches``; the points-only mode in
    ``grid_interpolate_grad_cuda.points_launches``) and raise on what the
    kernels do not take.  They never fall back.
  * :func:`interp_grad_copies`, how many copies of the table the backward
    spreads its atomics over; :func:`staged_tables`, which tables a kernel
    copies to each block's shared memory before it gathers from them (the
    forward here, the fused kernel of ``ops/fused_decode.py``); and
    :func:`interp_forward_path`, where the forward gathers from (shared
    memory, a paired copy of the table, or the table in L2), all computed
    here and handed to the kernels.
  * :func:`grid_interpolate_plain` (``ops/interp.py::grid_interpolate``) and
    :func:`grid_interpolate_grad_plain` (an ``index_add_`` scatter plus the
    analytic points' gradient): the kernels' plain versions, used for CPU
    tensors and as the reference the kernels are held to.
  * ``_GridInterp``, a ``torch.autograd.Function``.  Its forward is the
    kernel.  Its backward dispatches on the order of the derivative, not on
    failure:

      - first order (``torch.is_grad_enabled()`` false in the backward: a
        plain ``backward`` or ``autograd.grad``) launches the grad kernel, in
        its points-only mode when the grid needs no gradient (a frozen
        grid, as LM tracking queries it);
      - under ``create_graph=True`` (the autograd eikonal,
        ``losses/common.py::eikonal_loss_at``) the gradient must itself be
        differentiable, so it is recomputed through the plain, differentiable
        ``ops/interp.py::grid_interpolate`` and counted in
        ``_GridInterp.recomputes``.  The fused op's backward
        (``ops/fused_decode.py``) recomputes the same way.

:func:`grid_interpolate_dispatch` sends CUDA tensors through ``_GridInterp``
and CPU tensors to the plain version; ``GridNet`` hands it to
``ops/interp.py::multi_level_interpolate`` as the per-level interpolation.

The slot-id mode interpolates each point against its own slot of an atlas
level's stacked, padded storage (S, X, Y, Z, F), with each slot's bound and
logical size (``ops/interp.py::grid_interpolate_per_point``, the alignment's
and per-submap losses' query): :func:`grid_interpolate_per_point_cuda` and
:func:`grid_interpolate_per_point_grad_cuda` (counted apart from the
single-grid calls), their plain versions, ``_GridInterpPerPoint`` and
:func:`grid_interpolate_per_point_dispatch`, as above.

Tables may be float32 or bfloat16 (``grid.feature_dtype: bfloat16``); the
points, the cotangent, the output and the points' gradient are float32
whatever the table.  The kernels widen each bf16 row as they read it (no
float32 copy of the table is made), and the table's gradient comes back in
the table's dtype: summed in float32 and rounded once (the JAX package's
scatter-add rounds in bf16 at every add).  The plain versions compute from
``table.float()``.

Two faults of the TPU op are not carried over: it breaks for
F > 8 (``fpad=8``) and its backward gives zeros for the points' gradient.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Optional, Sequence

import torch

from miso_tpu_torch.ops import interp
from miso_tpu_torch.utils.profiling import span


class _InterpArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("bound", ctypes.c_void_p),
                ("grid", ctypes.c_void_p), ("size", ctypes.c_void_p),
                ("g", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("gx", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("dims", ctypes.c_int * 3), ("fdim", ctypes.c_int),
                ("vec4", ctypes.c_int), ("slot", ctypes.c_void_p),
                ("slot_rows", ctypes.c_longlong), ("slots", ctypes.c_int),
                ("bf16", ctypes.c_int)]


# The tables' dtypes the kernels take (csrc/mtt_grid.cuh's element types).
TABLE_DTYPES = (torch.float32, torch.bfloat16)


class _GradPlanArgs(ctypes.Structure):
    """``MttGradPlan`` of ``csrc/grid_interp.cu``: the copies and their scratch."""
    _fields_ = [("copies", ctypes.c_int), ("partial", ctypes.c_void_p)]


# The grad kernel spreads its atomics over copies of the table where each row
# takes many of them: one copy per ATOMICS_PER_COPY atomics a row (8 per point
# over the table's rows), at most MAX_COPIES and all within COPY_BUDGET bytes
# (the H100's L2 holds 50 MB).  Otherwise it has one copy, the gradient itself.
ATOMICS_PER_COPY = 64
MAX_COPIES = 64
COPY_BUDGET = 8 << 20


@functools.lru_cache(maxsize=256)
def interp_grad_copies(dims: Sequence[int], fdim: int, n: int) -> int:
    """How many copies of a (dims..., fdim) table the grad kernel's atomics for
    n points are spread over: block b of 256 points adds into copy
    ``b % copies``, and the copies are then summed into the gradient (cached:
    the wrapper asks at every call)."""
    rows = math.prod(int(d) for d in dims)
    copies = min(MAX_COPIES, COPY_BUDGET // (4 * rows * fdim),
                 8 * n // (rows * ATOMICS_PER_COPY))
    return max(1, copies)


# Shared memory of one H100 SM, and what the runtime reserves of it for each
# resident block.  A kernel whose tables are staged keeps a given number of
# blocks resident an SM; a table is staged when it fits what that leaves.
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
# The forward's staged kernel runs 1024-thread blocks, two an SM.
INTERP_STAGED_BLOCKS = 2
# The forward's paths (csrc/grid_interp.cu MTT_FWD_*), and the fewest points a
# call copies its table for: measured on the H100, a copy (to shared memory
# or in pairs) is repaid at 1e6 points and not at 2^15 or 2^18 (PERF.md).
FORWARD_PATHS = {"l2": 0, "staged": 1, "pairs": 2}
COPY_MIN_POINTS = 1 << 19


def smem_budget(blocks_per_sm: int) -> int:
    """Shared memory one block may take with ``blocks_per_sm`` resident."""
    return SM_SMEM // blocks_per_sm - BLOCK_RESERVED_SMEM


def staged_tables(table_bytes: Sequence[int], other_bytes: int,
                  blocks_per_sm: int) -> list:
    """Which tables a kernel copies to each block's shared memory: the
    smallest first, each while it fits the block's budget
    (:func:`smem_budget`) after ``other_bytes`` and the tables already
    staged, each rounded up to 16 bytes.  The rest are read from global
    memory (L2).  Returns one bool per table, in the given order."""
    left = smem_budget(blocks_per_sm) - other_bytes
    staged = [False] * len(table_bytes)
    for i in sorted(range(len(table_bytes)), key=lambda i: table_bytes[i]):
        need = -(-table_bytes[i] // 16) * 16
        if need <= left:
            staged[i] = True
            left -= need
    return staged


def interp_forward_path(grid: torch.Tensor, n: int, vec4: bool) -> str:
    """Where the forward gathers a call's rows from: ``"staged"``, a copy of
    the table in each block's shared memory, where :func:`staged_tables`
    lets it fit; else, at F = 4 with float4 rows (``vec4``), ``"pairs"``, a
    copy of the table in 32-byte pairs along axis 2; else, and for every
    call of fewer than ``COPY_MIN_POINTS`` points, ``"l2"``, the table
    itself.  (A pair of wider rows spans several L2 sectors anyway: at F = 8
    and 12 the pairs measured slower than the table.)  A bf16 table pairs
    too: at the fine ScanNet level its 16-byte pairs measured 17 % faster
    than its unpaired rows (PERF.md)."""
    if n < COPY_MIN_POINTS:
        return "l2"
    if staged_tables([table_bytes(grid)], 0, INTERP_STAGED_BLOCKS)[0]:
        return "staged"
    return "pairs" if vec4 and grid.shape[-1] == 4 else "l2"


def table_bytes(grid: torch.Tensor) -> int:
    """Bytes of a level's storage, padded rows included, at its element size:
    what a staged copy holds."""
    return grid.numel() * grid.element_size()


@functools.cache
def _library():
    from miso_tpu_torch.ops._build import load_library
    lib = load_library("grid_interp")
    lib.mtt_error_string.argtypes = [ctypes.c_int]
    lib.mtt_error_string.restype = ctypes.c_char_p
    lib.mtt_grid_interp_forward.argtypes = [ctypes.POINTER(_InterpArgs), ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.mtt_grid_interp_backward.argtypes = [ctypes.POINTER(_InterpArgs),
                                             ctypes.POINTER(_GradPlanArgs), ctypes.c_int,
                                             ctypes.c_void_p]
    lib.mtt_grid_interp_points_grad.argtypes = [ctypes.POINTER(_InterpArgs), ctypes.c_int,
                                                ctypes.c_void_p]
    for fn in (lib.mtt_grid_interp_forward, lib.mtt_grid_interp_backward,
               lib.mtt_grid_interp_points_grad):
        fn.restype = ctypes.c_int
    return lib


def _check(grid, x, bound, size, g=None):
    """Raise on anything the kernels do not take."""
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"the interp kernels are 3D only: x has shape {tuple(x.shape)}")
    if grid.ndim != 4:
        raise ValueError(f"grid has shape {tuple(grid.shape)}; expected (X, Y, Z, F)")
    if tuple(bound.shape) != (3, 2):
        raise ValueError(f"bound has shape {tuple(bound.shape)}, expected (3, 2)")
    named = [("grid", grid), ("x", x), ("bound", bound)]
    if g is not None:
        if tuple(g.shape) != (x.shape[0], grid.shape[-1]):
            raise ValueError(f"cotangent has shape {tuple(g.shape)}, expected "
                             f"{(x.shape[0], grid.shape[-1])}")
        named.append(("cotangent", g))
    _check_dtypes(named)
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if size is not None:
        if size.dtype != torch.int32 or tuple(size.shape) != (3,):
            raise TypeError("size must be a (3,) int32 tensor")
        if size.device != x.device or not size.is_contiguous():
            raise ValueError(f"size must be contiguous and on {x.device}")
    if not x.is_cuda:
        raise ValueError(f"the interp kernels need CUDA tensors, got {x.device}")


def _check_dtypes(named):
    """The table (first of ``named``) float32 or bfloat16, the rest float32."""
    (table_name, table), rest = named[0], named[1:]
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"{table_name} is {table.dtype}; the kernels take float32 or "
                        "bfloat16 tables")
    for name, t in rest:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernels take it as float32 only")


def _pack(grid, x, bound, size, out, g=None, gx=None):
    """The kernels' arguments for one grid (X, Y, Z, F): rows are read 4
    elements at a time (``vec4``) where F % 4 == 0, the table is aligned to 4
    elements and the float32 rows of ``out`` and ``g`` to 16 bytes."""
    a = _InterpArgs()
    a.x, a.bound, a.grid = x.data_ptr(), bound.data_ptr(), grid.data_ptr()
    a.out = None if out is None else out.data_ptr()
    a.size = None if size is None else size.data_ptr()
    a.g = None if g is None else g.data_ptr()
    a.gx = None if gx is None else gx.data_ptr()
    a.n = x.shape[0]
    a.dims[:] = list(grid.shape[:3])
    a.fdim = grid.shape[-1]
    rows = [t for t in (grid, out, g) if t is not None]
    a.vec4 = int(a.fdim % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                                         for t in rows))
    a.bf16 = int(grid.dtype == torch.bfloat16)
    return a


def _launch(name, device, *args):
    """Call entry ``name`` on ``args`` (structs by reference, ints as they
    are), the device and PyTorch's current stream; raise on its error."""
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, name)(*(ctypes.byref(a) if isinstance(a, ctypes.Structure) else a
                                for a in args), device.index, ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.mtt_error_string(code).decode())


def grid_interpolate_cuda(grid: torch.Tensor, x: torch.Tensor, bound: torch.Tensor,
                          size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel: (X, Y, Z, F) grid, (N, 3) points -> (N, F).

    ``size`` is an optional (3,) int32 logical size for padded storage.  The
    rows are gathered where :func:`interp_forward_path` says.  No autograd:
    see :func:`grid_interpolate_dispatch`.
    """
    with span("miso.launch.grid_interp"):
        _check(grid, x, bound, size)
        out = torch.empty((x.shape[0], grid.shape[-1]), dtype=torch.float32,
                          device=x.device)
        a = _pack(grid, x, bound, size, out)
        path = interp_forward_path(grid, x.shape[0], bool(a.vec4))
        # Freed on return, while the kernels may still run: PyTorch's caching
        # allocator hands the block out again only in this stream's order.
        pairs = torch.empty(2 * grid.numel(), dtype=grid.dtype,
                            device=x.device) if path == "pairs" else None
        _launch("mtt_grid_interp_forward", x.device, a, FORWARD_PATHS[path],
                None if pairs is None else pairs.data_ptr())
    grid_interpolate_cuda.launches += 1
    return out


grid_interpolate_cuda.launches = 0


def _grad_plan(table, n_copies):
    """The backward's ``MttGradPlan`` and the float32 scratch it points into
    (None for a float32 table with one copy, whose atomics go to the
    gradient itself; a bf16 table's always go to float32 scratch).  The
    caller keeps the scratch alive until the launch is queued: freed then,
    while the kernels may still run, PyTorch's caching allocator hands the
    block out again only in this stream's order."""
    plan = _GradPlanArgs(n_copies, None)
    if n_copies == 1 and table.dtype == torch.float32:
        return plan, None
    partial = torch.empty(n_copies * table.numel(), dtype=torch.float32, device=table.device)
    plan.partial = partial.data_ptr()
    return plan, partial


def grid_interpolate_grad_cuda(grid: torch.Tensor, x: torch.Tensor,
                               bound: torch.Tensor, g: torch.Tensor,
                               size: Optional[torch.Tensor] = None,
                               need_x: bool = True, need_grid: bool = True):
    """Launch the backward kernel for cotangent ``g`` (N, F), its atomics
    spread over the copies of :func:`interp_grad_copies` (one count in
    ``.launches`` per call).

    Returns (d_grid (X, Y, Z, F) in the grid's dtype, d_x (N, 3) or None when
    ``need_x`` is false).  d_grid is scattered with atomics, so its float32
    sums run in an order that varies from run to run; a bf16 grid's is
    summed in float32 copies and rounded once.  With ``need_grid=False`` the
    points-only mode computes d_x alone, allocates no table gradient and no
    copies and makes no atomic adds (one count in ``.points_launches``), and
    returns (None, d_x).
    """
    with span("miso.launch.grid_interp_grad"):
        _check(grid, x, bound, size, g)
        if not need_grid:
            if not need_x:
                raise ValueError("neither the grid's nor the points' gradient asked for")
            d_x = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
            _launch("mtt_grid_interp_points_grad", x.device,
                    _pack(grid, x, bound, size, None, g, d_x))
            grid_interpolate_grad_cuda.points_launches += 1
            return None, d_x
        n_copies = interp_grad_copies(grid.shape[:3], grid.shape[-1], x.shape[0])
        d_grid = torch.empty_like(grid)
        d_x = (torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
               if need_x else None)
        copies, _partial = _grad_plan(grid, n_copies)
        _launch("mtt_grid_interp_backward", x.device,
                _pack(grid, x, bound, size, d_grid, g, d_x), copies)
    grid_interpolate_grad_cuda.launches += 1
    return d_grid, d_x


grid_interpolate_grad_cuda.launches = 0
grid_interpolate_grad_cuda.points_launches = 0


def grid_interpolate_plain(grid, x, bound, size=None):
    """The forward kernel's plain version: ``ops/interp.py::grid_interpolate``
    of ``grid.float()`` (through which a bf16 grid's gradient is summed in
    float32 and rounded once, as the kernel's is)."""
    return interp.grid_interpolate(grid.float(), x, bound, size)


def corner_weight_derivatives(x, bound, spatial: Sequence[int], size=None):
    """d w_c / d x_k of the lerp weights of ``corner_indices_and_weights``:
    (3, 8, N), zero at corners outside the logical grid (zeros padding)."""
    if size is not None:
        size = torch.as_tensor(size, device=x.device)
    axes = []
    for k in range(3):
        nk = float(spatial[k]) if size is None else size[k].to(x.dtype)
        nk_i = int(spatial[k]) if size is None else size[k].to(torch.int64)
        lo, hi = bound[k, 0], bound[k, 1]
        u = (x[:, k] - lo) / (hi - lo) * nk - 0.5
        i0f = torch.floor(u)
        axes.append((i0f.to(torch.int64), u - i0f, nk_i, nk / (hi - lo)))
    out = []
    for k in range(3):
        per_corner = []
        for corner in itertools.product((0, 1), repeat=3):
            d = None
            ok = None
            for j, (i0, fr, nk_i, scale) in enumerate(axes):
                ik = i0 + corner[j]
                ok_j = (ik >= 0) & (ik < nk_i)
                ok = ok_j if ok is None else ok & ok_j
                if j == k:
                    wj = (scale if corner[j] else -scale) * torch.ones_like(fr)
                else:
                    wj = fr if corner[j] else 1.0 - fr
                d = wj if d is None else d * wj
            per_corner.append(d * ok.to(d.dtype))
        out.append(torch.stack(per_corner))
    return torch.stack(out)


def grid_interpolate_grad_plain(grid, x, bound, g, size=None, need_x=True,
                                need_grid=True):
    """The backward kernel's plain version: the grid's gradient by an
    ``index_add_`` scatter of the corner-weighted cotangents in float32,
    returned in the grid's dtype (skipped, and None, when ``need_grid`` is
    false), and the points' gradient from the weights' derivatives
    (:func:`corner_weight_derivatives`) and ``grid.float()``'s rows."""
    spatial = tuple(grid.shape[:3])
    F = grid.shape[-1]
    table_dtype, grid = grid.dtype, grid.float()
    lin, w = interp.corner_indices_and_weights(x, bound, spatial, size)
    d_grid = None
    if need_grid:
        rows = (w.unsqueeze(-1) * g.unsqueeze(0)).reshape(-1, F)
        d_grid = torch.zeros((grid[..., 0].numel(), F), dtype=g.dtype, device=g.device)
        d_grid.index_add_(0, lin.reshape(-1), rows)
        d_grid = d_grid.reshape(grid.shape).to(table_dtype)
    if not need_x:
        return d_grid, None
    corners = torch.index_select(grid.reshape(-1, F), 0, lin.reshape(-1))
    dots = torch.sum(corners.reshape(*lin.shape, F) * g.unsqueeze(0), dim=-1)
    dw = corner_weight_derivatives(x, bound, spatial, size)
    return d_grid, torch.sum(dw * dots.unsqueeze(0), dim=1).T


class _GridInterp(torch.autograd.Function):
    """Forward: the interp kernel.  Backward: the grad kernel at first order,
    a differentiable recompute under ``create_graph`` (see the module note)."""

    recomputes = 0

    @staticmethod
    def forward(ctx, grid, x, bound, size):
        ctx.save_for_backward(grid, x, bound, size)
        return grid_interpolate_cuda(grid, x, bound, size)

    @staticmethod
    def backward(ctx, grad_out):
        grid, x, bound, size = ctx.saved_tensors
        need_grid, need_x = ctx.needs_input_grad[:2]
        if not (need_grid or need_x):
            return None, None, None, None
        if torch.is_grad_enabled():
            _GridInterp.recomputes += 1
            wrt = [t for t, need in ((grid, need_grid), (x, need_x)) if need]
            out = interp.grid_interpolate(grid, x, bound, size)
            got = list(torch.autograd.grad(out, wrt, grad_out, create_graph=True,
                                           allow_unused=True))
            got = [torch.zeros_like(t) if d is None else d for d, t in zip(got, wrt)]
            d_grid = got.pop(0) if need_grid else None
            d_x = got.pop(0) if need_x else None
        else:
            g = grad_out.contiguous()
            if need_grid:
                d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, g, size,
                                                         need_x=need_x)
            else:
                d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, g, size,
                                                         need_grid=False)
        return d_grid, d_x, None, None


def grid_interpolate_dispatch(grid: torch.Tensor, x: torch.Tensor,
                              bound: torch.Tensor,
                              size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trilinear interpolation, differentiable to any order in ``grid`` and
    ``x``: CUDA tensors run the kernels through ``_GridInterp``, CPU tensors
    the plain version."""
    if x.is_cuda:
        return _GridInterp.apply(grid, x.contiguous(), bound, size)
    if x.device.type == "cpu":
        return grid_interpolate_plain(grid, x, bound, size)
    raise ValueError(f"grid_interpolate runs on CUDA or CPU tensors, not {x.device}")



# ---------------------------------------------------------------------------
# Slot-id mode: each point against its own slot of an atlas level's stacked,
# padded storage (``ops/interp.py::grid_interpolate_per_point``).
# ---------------------------------------------------------------------------

def _check_per_point(stacked, sub_ids, x, bounds, sizes, g=None):
    """Raise on anything the slot-id mode does not take."""
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"the interp kernels are 3D only: x has shape {tuple(x.shape)}")
    if stacked.ndim != 5:
        raise ValueError(f"stacked has shape {tuple(stacked.shape)}; expected (S, X, Y, Z, F)")
    S, n = stacked.shape[0], x.shape[0]
    if tuple(bounds.shape) != (S, 3, 2):
        raise ValueError(f"bounds has shape {tuple(bounds.shape)}, expected {(S, 3, 2)}")
    if tuple(sizes.shape) != (S, 3) or sizes.dtype != torch.int32:
        raise TypeError(f"sizes must be an {(S, 3)} int32 tensor")
    if tuple(sub_ids.shape) != (n,) or sub_ids.dtype != torch.int32:
        raise TypeError(f"sub_ids must be an ({n},) int32 tensor")
    named = [("stacked", stacked), ("x", x), ("bounds", bounds)]
    if g is not None:
        if tuple(g.shape) != (n, stacked.shape[-1]):
            raise ValueError(f"cotangent has shape {tuple(g.shape)}, expected "
                             f"{(n, stacked.shape[-1])}")
        named.append(("cotangent", g))
    _check_dtypes(named)
    for name, t in named + [("sizes", sizes), ("sub_ids", sub_ids)]:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not x.is_cuda:
        raise ValueError(f"the interp kernels need CUDA tensors, got {x.device}")


def _pack_per_point(stacked, sub_ids, x, bounds, sizes, out, g=None, gx=None):
    """The kernels' arguments in slot-id mode, and the tensors they point
    into that the caller must keep alive until the launch is queued."""
    a = _pack(stacked[0], x, bounds[0], sizes[0], out, g, gx)
    a.grid, a.bound, a.size = stacked.data_ptr(), bounds.data_ptr(), sizes.data_ptr()
    # An empty id tensor has no storage; a null id pointer would mean one grid.
    ids = sub_ids if sub_ids.numel() else torch.zeros(1, dtype=torch.int32, device=x.device)
    a.slot = ids.data_ptr()
    a.slot_rows = math.prod(int(v) for v in stacked.shape[1:4])
    a.slots = stacked.shape[0]
    return a, ids


def grid_interpolate_per_point_cuda(stacked: torch.Tensor, sub_ids: torch.Tensor,
                                    x: torch.Tensor, bounds: torch.Tensor,
                                    sizes: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel in slot-id mode: (S, X, Y, Z, F) stacked
    storage, (N,) int32 slot ids, (N, 3) points each in its slot's frame,
    (S, 3, 2) bounds, (S, 3) int32 logical sizes -> (N, F).  One thread a
    point from the table in L2 (one count in ``.launches``).  No autograd:
    see :func:`grid_interpolate_per_point_dispatch`."""
    with span("miso.launch.grid_interp_per_point"):
        _check_per_point(stacked, sub_ids, x, bounds, sizes)
        out = torch.empty((x.shape[0], stacked.shape[-1]), dtype=torch.float32,
                          device=x.device)
        a, _ids = _pack_per_point(stacked, sub_ids, x, bounds, sizes, out)
        _launch("mtt_grid_interp_forward", x.device, a, FORWARD_PATHS["l2"], None)
    grid_interpolate_per_point_cuda.launches += 1
    return out


grid_interpolate_per_point_cuda.launches = 0


def grid_interpolate_per_point_grad_cuda(stacked, sub_ids, x, bounds, sizes, g,
                                         need_x: bool = True, need_grid: bool = True):
    """Launch the backward kernel in slot-id mode for cotangent ``g`` (N, F).

    Returns (d_stacked (S, X, Y, Z, F) or None, d_x (N, 3) or None), as
    :func:`grid_interpolate_grad_cuda` does: the table's gradient covers the
    whole stacked storage, zero in padded rows and in slots no point reads,
    with its atomics spread over :func:`interp_grad_copies` of the stacked
    table (one count in ``.launches``); ``need_grid=False`` computes d_x
    alone, with no table gradient and no atomics (``.points_launches``)."""
    with span("miso.launch.grid_interp_per_point_grad"):
        _check_per_point(stacked, sub_ids, x, bounds, sizes, g)
        if not need_grid:
            if not need_x:
                raise ValueError("neither the grid's nor the points' gradient asked for")
            d_x = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
            a, _ids = _pack_per_point(stacked, sub_ids, x, bounds, sizes, None, g, d_x)
            _launch("mtt_grid_interp_points_grad", x.device, a)
            grid_interpolate_per_point_grad_cuda.points_launches += 1
            return None, d_x
        n_copies = interp_grad_copies(tuple(stacked.shape[:4]), stacked.shape[-1],
                                      x.shape[0])
        d_grid = torch.empty_like(stacked)
        d_x = (torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device)
               if need_x else None)
        copies, _partial = _grad_plan(stacked, n_copies)
        a, _ids = _pack_per_point(stacked, sub_ids, x, bounds, sizes, d_grid, g, d_x)
        _launch("mtt_grid_interp_backward", x.device, a, copies)
    grid_interpolate_per_point_grad_cuda.launches += 1
    return d_grid, d_x


grid_interpolate_per_point_grad_cuda.launches = 0
grid_interpolate_per_point_grad_cuda.points_launches = 0


def grid_interpolate_per_point_plain(stacked, sub_ids, x, bounds, sizes):
    """The slot-id forward's plain version:
    ``ops/interp.py::grid_interpolate_per_point`` of ``stacked.float()``."""
    return interp.grid_interpolate_per_point(stacked.float(), sub_ids, x, bounds, sizes)


def grid_interpolate_per_point_grad_plain(stacked, sub_ids, x, bounds, sizes, g,
                                          need_x=True, need_grid=True):
    """The slot-id backward's plain version: the plain forward's vector-Jacobian
    product (its row gather's backward is an ``index_add_`` scatter into the
    stacked storage, in float32, returned in the storage's dtype).  Returns
    (d_stacked or None, d_x or None)."""
    with torch.enable_grad():
        st = stacked.detach().float().requires_grad_(need_grid)
        xx = x.detach().requires_grad_(need_x)
        out = interp.grid_interpolate_per_point(st, sub_ids, xx, bounds, sizes)
        wrt = [t for t, need in ((st, need_grid), (xx, need_x)) if need]
        got = torch.autograd.grad(out, wrt, g, allow_unused=True)
    got = [torch.zeros_like(t) if d is None else d for d, t in zip(got, wrt)]
    d_grid = got.pop(0).to(stacked.dtype) if need_grid else None
    d_x = got.pop(0) if need_x else None
    return d_grid, d_x


class _GridInterpPerPoint(torch.autograd.Function):
    """``_GridInterp`` in slot-id mode: the kernel forward; the grad kernel at
    first order (points-only when the storage needs no gradient, as in
    alignment, where only the submap poses train); under ``create_graph`` a
    differentiable recompute through the plain version, counted in
    ``recomputes``."""

    recomputes = 0

    @staticmethod
    def forward(ctx, stacked, x, sub_ids, bounds, sizes):
        ctx.save_for_backward(stacked, x, sub_ids, bounds, sizes)
        return grid_interpolate_per_point_cuda(stacked, sub_ids, x, bounds, sizes)

    @staticmethod
    def backward(ctx, grad_out):
        stacked, x, sub_ids, bounds, sizes = ctx.saved_tensors
        need_grid, need_x = ctx.needs_input_grad[:2]
        if not (need_grid or need_x):
            return None, None, None, None, None
        if torch.is_grad_enabled():
            _GridInterpPerPoint.recomputes += 1
            wrt = [t for t, need in ((stacked, need_grid), (x, need_x)) if need]
            out = interp.grid_interpolate_per_point(stacked, sub_ids, x, bounds, sizes)
            got = list(torch.autograd.grad(out, wrt, grad_out, create_graph=True,
                                           allow_unused=True))
            got = [torch.zeros_like(t) if d is None else d for d, t in zip(got, wrt)]
            d_grid = got.pop(0) if need_grid else None
            d_x = got.pop(0) if need_x else None
        else:
            d_grid, d_x = grid_interpolate_per_point_grad_cuda(
                stacked, sub_ids, x, bounds, sizes, grad_out.contiguous(),
                need_x=need_x, need_grid=need_grid)
        return d_grid, d_x, None, None, None


def grid_interpolate_per_point_dispatch(stacked: torch.Tensor, sub_ids: torch.Tensor,
                                        x: torch.Tensor, bounds: torch.Tensor,
                                        sizes: torch.Tensor) -> torch.Tensor:
    """Each point against its own slot of an atlas level, differentiable to
    any order in ``stacked`` and ``x``: CUDA tensors run the slot-id kernels
    through ``_GridInterpPerPoint``, CPU tensors the plain version."""
    if x.is_cuda:
        return _GridInterpPerPoint.apply(stacked, x.contiguous(),
                                         sub_ids.to(torch.int32).contiguous(),
                                         bounds.contiguous(), sizes.to(torch.int32).contiguous())
    if x.device.type == "cpu":
        return grid_interpolate_per_point_plain(stacked, sub_ids, x, bounds, sizes)
    raise ValueError(f"grid_interpolate_per_point runs on CUDA or CPU tensors, not {x.device}")
