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
fused kernel (``ops/fused_decode.py``).  On the card the ``"xla"`` path, and
``query_feature`` and ``query_stability``, go through the interp kernels
(``ops/tiled_interp.py``) and the decode kernel (``ops/fused_decode.py::
mlp_decode``); on the CPU through their plain versions.  ``frozen=True``
queries with every table and the decoder detached, so that a backward asks
for no parameter's gradient (LM tracking wants the points' alone).  A
decoder's ``pretrained_model`` (an ``.npz`` of either package's
``save_pytree``) is loaded by :func:`create_grid_net`.  VM grids wait for a
later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from miso_tpu_torch.ops import interp, se3
from miso_tpu_torch.ops.fused_decode import fused_interp_decode, mlp_decode
from miso_tpu_torch.ops.mlp import mlp_init
from miso_tpu_torch.ops.tiled_interp import grid_interpolate_dispatch

DECODE_IMPLS = ("xla", "pallas")


class GridNet(nn.Module):

    def __init__(self, features, stability, decoder, rot_corr, trans_corr,
                 Rwk, twk, bound, ignore_level, anchor_kf=0, *,
                 cell_sizes: Sequence[float] = (), pos_invariant: bool = True,
                 decoder_fixed: bool = False, optimize_pose: bool = False,
                 decode_impl: str = "xla"):
        super().__init__()
        if decode_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, "
                             f"got {decode_impl!r}")
        self.features = nn.ParameterList([nn.Parameter(f) for f in features])
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
        self.fdim = int(features[0].shape[-1])
        self.num_levels = len(features)
        self.cell_sizes = tuple(cell_sizes)
        self.pos_invariant = pos_invariant
        self.decoder_fixed = decoder_fixed
        self.optimize_pose = optimize_pose
        self.decode_impl = decode_impl

    # --- derived ----------------------------------------------------------
    @property
    def num_poses(self) -> int:
        return self.rot_corr.shape[0]

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
        return [(".features", list(self.features)), (".stability", list(self.stability)),
                (".decoder", None if self.decoder is None else
                 [[self.decoder[i], self.decoder[i + 1]]
                  for i in range(0, len(self.decoder), 2)]),
                (".rot_corr", self.rot_corr), (".trans_corr", self.trans_corr),
                (".Rwk", self.Rwk), (".twk", self.twk), (".bound", self.bound),
                (".ignore_level", self.ignore_level), (".anchor_kf", self.anchor_kf)]

    # --- queries ----------------------------------------------------------
    def query_feature(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        """Multi-level interp and concat (regular grids)."""
        feats = [f.detach() if frozen else f for f in self.features]
        return interp.multi_level_interpolate(feats, x, self.bound, self.ignore_level,
                                              interpolate=grid_interpolate_dispatch)

    def query_stability(self, x: torch.Tensor) -> torch.Tensor:
        """Stability grids are never level-ignored."""
        return interp.multi_level_interpolate(list(self.stability), x, self.bound,
                                              interpolate=grid_interpolate_dispatch)

    def forward(self, x: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        decoder = self._decoder(frozen)
        if (self.decode_impl == "pallas" and decoder is not None
                and self.pos_invariant):
            feats = [f.detach() if frozen else f for f in self.features]
            return fused_interp_decode(feats, x, self.bound, decoder,
                                       ignore_level=self.ignore_level)
        return interp.grid_decode(self.query_feature(x, frozen), x, decoder,
                                  self.pos_invariant, decode=mlp_decode)

    # --- poses ------------------------------------------------------------
    def updated_kf_poses(self, lock_mask: Optional[torch.Tensor] = None):
        """All K corrected poses, batched.

        lock_mask: optional (K,) float; rows with 1 get no gradient.
        """
        dr, dt = self.rot_corr, self.trans_corr
        if lock_mask is not None:
            m = lock_mask[:, None]
            dr = dr.detach() * m + dr * (1.0 - m)
            dt = dt.detach() * m + dt * (1.0 - m)
        return se3.apply_pose_correction(self.Rwk, self.twk, dr, dt)

    @torch.no_grad()
    def updated_kf_pose(self, kf_id: int):
        """The corrected pose (R (3, 3), t (3,)) of local keyframe ``kf_id``."""
        R, t = self.updated_kf_poses()
        return R[kf_id], t[kf_id]

    def initial_kf_pose(self, kf_id: int):
        return self.Rwk[kf_id], self.twk[kf_id]

    def pose_key_to_id(self, kf_key: str) -> int:
        """'KF{global_id}' -> local pose index."""
        if not kf_key.startswith("KF"):
            raise ValueError(f"not a keyframe key: {kf_key!r}")
        return int(kf_key[2:]) - int(self.anchor_kf)

    # --- in-place updates -------------------------------------------------
    @torch.no_grad()
    def set_initial_kf_pose(self, kf_id: int, R, t) -> "GridNet":
        """Set an initial pose and zero its corrections, in place."""
        self.Rwk[kf_id] = torch.as_tensor(R, dtype=self.Rwk.dtype)
        self.twk[kf_id] = torch.as_tensor(t, dtype=self.twk.dtype).reshape(3)
        self.rot_corr[kf_id] = 0.0
        self.trans_corr[kf_id] = 0.0
        return self

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
    if g.get("type", "regular") != "regular":
        raise NotImplementedError(f"grid type {g.get('type')!r}: only regular "
                                  "grids are ported so far")
    if int(cfg_model.get("spatial_dim", 3)) != 3:
        raise NotImplementedError("only 3D grids are ported so far")
    dcfg = cfg_model.get("decoder", {"type": "none"})
    n_levels = int(g["n_levels"])
    base_cell = float(g["base_cell_size"])
    scale = float(g["per_level_scale"])
    return dict(
        cell_sizes=tuple(base_cell / scale ** l for l in range(n_levels)),
        pos_invariant=bool(dcfg.get("pos_invariant", True)),
        decoder_fixed=bool(dcfg.get("fix", False)),
        decode_impl=str(dcfg.get("impl", "xla")),
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
    in_dim = int(g["n_levels"]) * int(g["feature_dim"]) \
        + (0 if bool(dcfg.get("pos_invariant", True)) else 3)
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
    generator when None) and are moved to ``device``.
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

    features, stability = [], []
    for level, cell in enumerate(settings["cell_sizes"]):
        shape = interp.grid_shape_for_bound(bound_t, cell, 3)
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
        anchor_kf=anchor_kf, optimize_pose=opt_pose, **settings)


# ---------------------------------------------------------------------------
# Masks: which parameters train, and at what learning-rate scale.
# ---------------------------------------------------------------------------

def grid_net_mask(model: GridNet, features=True, stability=None,
                  decoder: Optional[bool] = None, pose: Optional[bool] = None,
                  pose_rows: Optional[torch.Tensor] = None,
                  level: Optional[int] = None, feature_lr: float = 1.0,
                  pose_lr: float = 1.0) -> Dict[str, torch.Tensor]:
    """Mask dict over ``model.named_parameters()``.

      * ``level=l`` -> only level-l feature and stability grids train
        (``level >= num_levels`` means all levels, the joint phase);
      * ``features``/``stability``: a bool, or one bool per level;
      * the decoder trains unless ``decoder_fixed``;
      * poses train when ``optimize_pose`` (or an explicit ``pose``);
      * ``pose_rows`` is a (K,) float row mask for per-index locking.
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

    mask = {}
    for l, s in enumerate(level_sel(features)):
        mask[f"features.{l}"] = scalar(s * feature_lr)
    for l, s in enumerate(level_sel(stability)):
        mask[f"stability.{l}"] = scalar(s * feature_lr)
    if model.decoder is not None:
        for i in range(len(model.decoder)):
            mask[f"decoder.{i}"] = scalar(float(bool(decoder)))
    pose_val = float(bool(pose)) * pose_lr
    if pose_rows is not None:
        rows = torch.as_tensor(pose_rows, dtype=torch.float32, device=dev)
        pose_mask = rows[:, None] * pose_val
    else:
        pose_mask = scalar(pose_val)
    mask["rot_corr"] = pose_mask
    mask["trans_corr"] = pose_mask
    return mask
