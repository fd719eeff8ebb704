"""GridNet: the multiresolution submap model (port of
``miso_tpu/models/grid_net.py``).

Per level l the model holds a dense feature grid with
``cell_size = base / scale**l`` and a parallel 1-channel stability grid; a
shared MLP decoder reads the concatenated per-level features; (K, 3) so(3)
and translation corrections are applied as ``R @ Exp(dr), t + dt`` on top
of the buffered initial keyframe poses.

Trainable parameters (named as the masks of :func:`grid_net_mask` name
them): ``features.<l>``, ``stability.<l>``, ``decoder.<2i>`` (W_i, shape
(in, out)) and ``decoder.<2i+1>`` (b_i), ``rot_corr``, ``trans_corr``.
Buffers: ``Rwk``, ``twk``, ``bound``, ``ignore_level``, ``anchor_kf``.

``decode_impl`` keeps the config value ``decoder.impl``: ``"xla"`` (the
default) interpolates each level and then decodes, ``"pallas"`` runs the
fused kernel (``ops/fused_decode.py``; regular grids only).  On the card the
``"xla"`` path, and ``query_feature`` and ``query_stability``, go through the
interp kernels (``ops/tiled_interp.py``) and the decode kernel
(``ops/fused_decode.py::mlp_decode``); on the CPU through their plain
versions.  The interp kernels are 3D: a 2D grid (``spatial_dim: 2``)
interpolates with the rank-generic ``ops/interp.py::grid_interpolate`` on
every device, and so do the planes and lines of a VM grid.

``grid.type: "VM"`` is the TensoRF plane and line factorization: per level
six factors, ``features.<l>.xy``, ``.xz``, ``.yz`` (g_i, g_j, R) and
``.x``, ``.y``, ``.z`` (g_k, R), and three learned bases
``vm_bases.<l>.xy_z``, ``.xz_y``, ``.yz_x`` (F, R) that turn the products
of the factors into F features (``ops/interp.py::vm_interpolate``,
``vm_basis_apply``); its stability grids stay dense.  ``frozen=True``
queries with every table and the decoder detached, so that a backward asks
for no parameter's gradient (LM tracking wants the points' alone).  A
decoder's ``pretrained_model`` (an ``.npz`` of either package's
``save_pytree``) is loaded by :func:`create_grid_net`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from miso_tpu_torch.models.base import KeyframePoses, Mask
from miso_tpu_torch.ops import interp, se3
from miso_tpu_torch.ops.fused_decode import fused_interp_decode, mlp_decode
from miso_tpu_torch.ops.mlp import mlp_init
from miso_tpu_torch.ops.tiled_interp import grid_interpolate_dispatch

DECODE_IMPLS = ("xla", "pallas")
GRID_TYPES = ("regular", "VM")
VM_PLANES = ("xy", "xz", "yz")
VM_LINES = ("x", "y", "z")
VM_PRODUCTS = ("xy_z", "xz_y", "yz_x")


class GridNet(KeyframePoses, nn.Module):

    def __init__(self, features, stability, decoder, rot_corr, trans_corr,
                 Rwk, twk, bound, ignore_level, anchor_kf=0, *,
                 cell_sizes: Sequence[float] = (), pos_invariant: bool = True,
                 decoder_fixed: bool = False, optimize_pose: bool = False,
                 decode_impl: str = "xla", grid_type: str = "regular",
                 vm_bases=None, vm_bases_fixed: bool = False):
        super().__init__()
        if decode_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, "
                             f"got {decode_impl!r}")
        if grid_type not in GRID_TYPES:
            raise ValueError(f"grid_type must be one of {GRID_TYPES}, got {grid_type!r}")
        if grid_type == "VM":
            self.features = nn.ModuleList([nn.ParameterDict(
                {k: nn.Parameter(fac[k]) for k in VM_PLANES + VM_LINES}) for fac in features])
            self.vm_bases = nn.ModuleList([nn.ParameterDict(
                {k: nn.Parameter(b[k]) for k in VM_PRODUCTS}) for b in vm_bases])
            self.fdim = int(vm_bases[0]["xy_z"].shape[0])
        else:
            self.features = nn.ParameterList([nn.Parameter(f) for f in features])
            self.vm_bases = None
            self.fdim = int(features[0].shape[-1])
        self.stability = nn.ParameterList([nn.Parameter(s) for s in stability])
        if decoder is None:
            self.decoder = None
        else:
            if any(b is None for _, b in decoder):
                raise ValueError("GridNet decoders carry a bias on every layer")
            self.decoder = nn.ParameterList(
                [nn.Parameter(t) for pair in decoder for t in pair])
        self.rot_corr = nn.Parameter(rot_corr)
        self.trans_corr = nn.Parameter(trans_corr)
        self.register_buffer("Rwk", Rwk)
        self.register_buffer("twk", twk)
        self.register_buffer("bound", bound)
        self.register_buffer("ignore_level", ignore_level)
        self.register_buffer("anchor_kf", torch.as_tensor(
            anchor_kf, dtype=torch.int32, device=bound.device))
        self.d = int(bound.shape[0])
        self.num_levels = len(features)
        self.cell_sizes = tuple(cell_sizes)
        self.pos_invariant = pos_invariant
        self.decoder_fixed = decoder_fixed
        self.optimize_pose = optimize_pose
        self.decode_impl = decode_impl
        self.grid_type = grid_type
        self.vm_bases_fixed = vm_bases_fixed

    # --- derived ----------------------------------------------------------
    def level_shape(self, level: int):
        return tuple(self.features[level].shape[:-1])

    @property
    def decoder_params(self):
        """The decoder as ((W, b), ...), detached when the decoder is fixed."""
        return self._decoder(False)

    def _decoder(self, frozen: bool):
        if self.decoder is None:
            return None
        ts = [t.detach() if self.decoder_fixed or frozen else t for t in self.decoder]
        return tuple(zip(ts[0::2], ts[1::2]))

    def tree_fields(self):
        """(key, value) of the JAX GridNet's leaves, in its key-path spelling
        (``train/checkpoint.py`` writes and reads them)."""
        if self.grid_type == "VM":
            features = [dict(fac.items()) for fac in self.features]
            vm_bases = [dict(b.items()) for b in self.vm_bases]
        else:
            features, vm_bases = list(self.features), None
        return [(".features", features), (".stability", list(self.stability)),
                (".decoder", None if self.decoder is None else
                 [[self.decoder[i], self.decoder[i + 1]]
                  for i in range(0, len(self.decoder), 2)]),
                (".rot_corr", self.rot_corr), (".trans_corr", self.trans_corr),
                (".Rwk", self.Rwk), (".twk", self.twk), (".bound", self.bound),
                (".ignore_level", self.ignore_level), (".vm_bases", vm_bases),
                (".anchor_kf", self.anchor_kf)]

    # --- queries ----------------------------------------------------------
    @property
    def _interpolate(self):
        """One level's interp: the kernels' dispatch for 3D grids, the
        rank-generic plain op for 2D ones."""
        return grid_interpolate_dispatch if self.d == 3 else interp.grid_interpolate

    def query_feature(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        """Multi-level interp and concat; a VM level's features are its
        factors' products through its bases."""
        if self.grid_type == "VM":
            return self._vm_features(x, frozen)
        feats = [f.detach() if frozen else f for f in self.features]
        return interp.multi_level_interpolate(feats, x, self.bound, self.ignore_level,
                                              interpolate=self._interpolate)

    def _vm_features(self, x: torch.Tensor, frozen: bool) -> torch.Tensor:
        feats = []
        for level in range(self.num_levels):
            fac = {k: v.detach() if frozen else v for k, v in self.features[level].items()}
            basis = {k: v.detach() if frozen or self.vm_bases_fixed else v
                     for k, v in self.vm_bases[level].items()}
            f = interp.vm_basis_apply(basis, interp.vm_interpolate(fac, fac, x, self.bound))
            feats.append(f * (1.0 - self.ignore_level[level].to(f.dtype)))
        return torch.cat(feats, dim=-1)

    def query_stability(self, x: torch.Tensor) -> torch.Tensor:
        """Stability grids are never level-ignored."""
        return interp.multi_level_interpolate(list(self.stability), x, self.bound,
                                              interpolate=self._interpolate)

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        decoder = self._decoder(frozen)
        if (self.decode_impl == "pallas" and self.grid_type == "regular"
                and decoder is not None and self.pos_invariant):
            feats = [f.detach() if frozen else f for f in self.features]
            return fused_interp_decode(feats, x, self.bound, decoder,
                                       ignore_level=self.ignore_level)
        return interp.grid_decode(self.query_feature(x, frozen), x, decoder,
                                  self.pos_invariant, decode=mlp_decode)

    # --- poses (updated_kf_poses and the rest: KeyframePoses) --------------
    def initial_kf_pose(self, kf_id: int):
        return self.Rwk[kf_id], self.twk[kf_id]

    def pose_key_to_id(self, kf_key: str) -> int:
        """'KF{global_id}' -> local pose index."""
        if not kf_key.startswith("KF"):
            raise ValueError(f"not a keyframe key: {kf_key!r}")
        return int(kf_key[2:]) - int(self.anchor_kf)

    # --- in-place updates -------------------------------------------------
    @torch.no_grad()
    def zero_features(self) -> "GridNet":
        """Zero every feature table, in place; returns self."""
        for f in self.features:
            f.zero_()
        return self

    @torch.no_grad()
    def randn_features(self, generator: torch.Generator, std: float) -> "GridNet":
        """Redraw every feature table from N(0, std^2) with ``generator`` (one
        draw per level, in level order, on the generator's device), in place;
        returns self."""
        for f in self.features:
            f.copy_(torch.randn(f.shape, generator=generator, dtype=torch.float32,
                                device=generator.device) * std)
        return self

    @torch.no_grad()
    def with_ignore_level(self, levels: Sequence[int]) -> "GridNet":
        """Ignore exactly ``levels`` from now on (in place); returns self."""
        self.ignore_level.zero_()
        for l in levels:
            self.ignore_level[l] = 1.0
        return self


def _settings(cfg_model: Dict):
    """The static settings create_grid_net and convert read from a config."""
    g = cfg_model["grid"]
    dcfg = cfg_model.get("decoder", {"type": "none"})
    n_levels = int(g["n_levels"])
    base_cell = float(g["base_cell_size"])
    scale = float(g["per_level_scale"])
    return dict(
        cell_sizes=tuple(base_cell / scale ** l for l in range(n_levels)),
        pos_invariant=bool(dcfg.get("pos_invariant", True)),
        decoder_fixed=bool(dcfg.get("fix", False)),
        decode_impl=str(dcfg.get("impl", "xla")),
        grid_type=g.get("type", "regular"),
        vm_bases_fixed=bool(g.get("VM", {}).get("fix_bases", False)),
    )


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


def decoder_from_config(cfg_model: Dict, generator: Optional[torch.Generator] = None,
                        dtype=torch.float32, device="cuda"):
    """The decoder of ``cfg_model['decoder']`` as ((W, b), ...) on ``device``:
    drawn from ``generator``, then replaced by its ``pretrained_model`` file
    when one is named; None when the config has no MLP decoder."""
    dcfg = cfg_model.get("decoder", {"type": "none"})
    if dcfg.get("type", "none") != "mlp":
        return None
    g = cfg_model["grid"]
    d = int(cfg_model.get("spatial_dim", 3))
    in_dim = int(g["n_levels"]) * int(g["feature_dim"]) \
        + (0 if bool(dcfg.get("pos_invariant", True)) else d)
    decoder = mlp_init(in_dim, int(dcfg["out_dim"]), int(dcfg["hidden_dim"]),
                       int(dcfg["hidden_layers"]), bias=True,
                       generator=generator, dtype=dtype, device=device)
    if dcfg.get("pretrained_model"):
        from miso_tpu_torch.train.checkpoint import load_pytree
        decoder = load_pytree(dcfg["pretrained_model"], like=decoder)
    return decoder


def create_grid_net(cfg_model: Dict, bound=None, num_poses: Optional[int] = None,
                    optimize_pose: Optional[bool] = None,
                    initial_features: Optional[Dict[int, torch.Tensor]] = None,
                    anchor_kf: int = 0, dtype=torch.float32,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> GridNet:
    """Build a GridNet from a model config dict (``configs/*.yaml``'s ``model``).

    Random draws come from ``generator`` (a CPU generator; the default
    generator when None) and are moved to ``device``.  A VM level draws its
    factors (xy, xz, yz, x, y, z), then its bases (xy_z, xz_y, yz_x), from
    N(0, max(init_stddev, 1e-2)^2).
    """
    device = _check_device(device)
    g = cfg_model["grid"]
    settings = _settings(cfg_model)
    pcfg = cfg_model.get("pose", {"num_poses": 1, "optimize": False})
    feat_dtype = getattr(torch, g["feature_dtype"]) if "feature_dtype" in g else dtype
    bound_t = torch.as_tensor(bound if bound is not None else g["bound"],
                              dtype=torch.float32)
    fdim = int(g["feature_dim"])
    init_std = float(g.get("init_stddev", 0.0))
    initial_features = initial_features or {}
    d = int(cfg_model.get("spatial_dim", 3))
    rank = int(g.get("VM", {}).get("rank", 10))

    def vm_draw(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * max(init_std, 1e-2)).to(feat_dtype).to(device)

    features, stability, vm_bases = [], [], []
    for level, cell in enumerate(settings["cell_sizes"]):
        shape = interp.grid_shape_for_bound(bound_t, cell, d)
        if settings["grid_type"] == "VM":
            gx, gy, gz = shape
            features.append({"xy": vm_draw(gx, gy, rank), "xz": vm_draw(gx, gz, rank),
                             "yz": vm_draw(gy, gz, rank), "x": vm_draw(gx, rank),
                             "y": vm_draw(gy, rank), "z": vm_draw(gz, rank)})
            vm_bases.append({k: vm_draw(fdim, rank) for k in VM_PRODUCTS})
            stability.append(torch.zeros((*shape, 1), dtype=feat_dtype, device=device))
            continue
        if level in initial_features:
            f = torch.as_tensor(initial_features[level], dtype=feat_dtype)
            if tuple(f.shape) != (*shape, fdim):
                raise ValueError(f"initial features of level {level} have shape "
                                 f"{tuple(f.shape)}, expected {(*shape, fdim)}")
        elif init_std > 0:
            f = (torch.randn((*shape, fdim), generator=generator, dtype=torch.float32)
                 * init_std).to(feat_dtype)
        else:
            f = torch.zeros((*shape, fdim), dtype=feat_dtype)
        features.append(f.to(device))
        stability.append(torch.zeros((*shape, 1), dtype=feat_dtype, device=device))

    decoder = decoder_from_config(cfg_model, generator, dtype, device)
    K = int(num_poses if num_poses is not None else pcfg.get("num_poses", 1))
    opt_pose = bool(optimize_pose if optimize_pose is not None
                    else pcfg.get("optimize", False))
    return GridNet(
        features, stability, decoder,
        rot_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        trans_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        Rwk=se3.identity_rotations(K, dtype, device),
        twk=torch.zeros((K, 3), dtype=dtype, device=device),
        bound=bound_t.to(device),
        ignore_level=torch.zeros((len(features),), dtype=dtype, device=device),
        anchor_kf=anchor_kf, optimize_pose=opt_pose, vm_bases=vm_bases or None,
        **settings)


# ---------------------------------------------------------------------------
# Masks: which parameters train, and at what learning-rate scale.
# ---------------------------------------------------------------------------

def grid_net_mask(model: GridNet, features=True, stability=None,
                  decoder: Optional[bool] = None, pose: Optional[bool] = None,
                  pose_rows: Optional[torch.Tensor] = None,
                  level: Optional[int] = None, feature_lr: float = 1.0,
                  pose_lr: float = 1.0) -> Mask:
    """Mask over ``model.named_parameters()`` (``models/base.py::Mask``).

      * ``level=l`` -> only level-l feature and stability grids train
        (``level >= num_levels`` means all levels, the joint phase);
      * ``features``/``stability``: a bool, or one bool per level;
      * the decoder trains unless ``decoder_fixed``, and a VM grid's bases
        with it unless ``vm_bases_fixed``;
      * poses train when ``optimize_pose`` (or an explicit ``pose``);
      * ``pose_rows`` is a (K,) float row mask for per-index locking; the
        poses count as trained when their scale is not 0, whatever the rows
        hold (a frozen row is left as it is by the masked update).
    """
    dev = model.bound.device

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    if stability is None:
        stability = features
    if decoder is None:
        decoder = not model.decoder_fixed
    if pose is None:
        pose = model.optimize_pose
    L = model.num_levels
    if level is not None and level < L:
        feat_sel = [1.0 if l == level else 0.0 for l in range(L)]
    else:
        feat_sel = [1.0] * L

    def level_sel(enabled):
        if isinstance(enabled, (list, tuple)):
            return [feat_sel[l] * float(enabled[l]) for l in range(L)]
        return [feat_sel[l] * float(bool(enabled)) for l in range(L)]

    values = {}   # name -> the entry's host value
    for l, s in enumerate(level_sel(features)):
        if model.grid_type == "VM":
            for k in model.features[l]:
                values[f"features.{l}.{k}"] = s * feature_lr
            for k in model.vm_bases[l]:
                values[f"vm_bases.{l}.{k}"] = 0.0 if model.vm_bases_fixed else float(bool(decoder))
            continue
        values[f"features.{l}"] = s * feature_lr
    for l, s in enumerate(level_sel(stability)):
        values[f"stability.{l}"] = s * feature_lr
    if model.decoder is not None:
        for i in range(len(model.decoder)):
            values[f"decoder.{i}"] = float(bool(decoder))
    mask = {k: scalar(v) for k, v in values.items()}
    pose_val = float(bool(pose)) * pose_lr
    if pose_rows is not None:
        rows = torch.as_tensor(pose_rows, dtype=torch.float32, device=dev)
        pose_mask = rows[:, None] * pose_val
    else:
        pose_mask = scalar(pose_val)
    for k in ("rot_corr", "trans_corr"):
        mask[k], values[k] = pose_mask, pose_val
    return Mask(mask, (k for k, v in values.items() if v != 0))
