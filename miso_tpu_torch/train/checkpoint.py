"""Checkpoints: tree save and load (port of ``miso_tpu/train/checkpoint.py``).

A tree is saved to a compressed ``.npz`` whose keys spell each leaf's path as
the JAX package spells a pytree's (``arr::<path>``), with an optional JSON
``__meta__`` entry.  The port writes the JAX package's paths for the same
structure, so a file written by one package loads in the other:

  * a decoder ((W, b), ...):       ``[0]/[0]``, ``[0]/[1]``, ``[1]/[0]``, ...
  * a GridNet:                     ``.features/[0]``, ``.decoder/[0]/[1]``,
                                   ``.rot_corr``, ... (``GridNet.tree_fields``;
                                   a VM level ``.features/[0]/['xy']``)
  * the other models:              their ``tree_fields`` (``HashGridNet``,
                                   ``ISDF``, ``PointSDF``)
  * a dict:                        ``['key']``; a NamedTuple: ``.field``.

Leaves are tensors, numpy arrays, numbers and ``torch.Generator``s (saved as
their state bytes).  :func:`load_pytree` rebuilds the structure of ``like``
from a file; a model in ``like`` is loaded in place.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch


def _children(node):
    """(path part, child) pairs of an inner node, or None for a leaf."""
    if hasattr(node, "tree_fields"):
        return node.tree_fields()
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _leaf_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(node, prefix, out):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out[prefix] = _leaf_array(node)
        return
    for part, child in kids:
        _flatten(child, f"{prefix}/{part}" if prefix else part, out)


def _flatten_with_paths(tree) -> dict:
    """{path: numpy array} of every leaf of ``tree``."""
    out = {}
    _flatten(tree, "", out)
    return out


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"arr::{k}": v for k, v in _flatten_with_paths(tree).items()}
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _load(node, prefix, data):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        key = "arr::" + prefix
        if key not in data:
            raise KeyError(f"{key} is not in the checkpoint")
        arr = data[key]
        if isinstance(node, torch.Generator):
            node.set_state(torch.from_numpy(arr.copy()))
            return node
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise ValueError(f"{key}: saved shape {arr.shape}, expected {tuple(np.shape(node))}")
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(arr, device=node.device)
        return arr
    loaded = [(part, _load(child, f"{prefix}/{part}" if prefix else part, data))
              for part, child in kids]
    if hasattr(node, "tree_fields"):
        for (_, dst), (_, src) in zip(kids, loaded):
            _copy_into(dst, src)
        return node
    if isinstance(node, dict):
        return {k: v for k, (_, v) in zip(node.keys(), loaded)}
    values = [v for _, v in loaded]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


@torch.no_grad()
def _copy_into(dst, src):
    """Copy loaded values into the tensors of ``dst`` (same structure)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    if isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    if isinstance(dst, dict):
        for k, d in dst.items():
            _copy_into(d, src[k])


def load_pytree(path: str, like: Any):
    """Load arrays saved by :func:`save_pytree` into the structure of ``like``:
    tensors come back on the device of ``like``'s, a model is filled in
    place, a generator takes the saved state."""
    with np.load(path, allow_pickle=False) as data:
        return _load(like, "", data)


def load_meta(path: str) -> Optional[dict]:
    with np.load(path, allow_pickle=False) as data:
        if "__meta__" not in data:
            return None
        return json.loads(bytes(data["__meta__"]).decode())


def save_model_pickle(path: str, model):
    """The whole model (structure, settings and tensors) on the CPU, pickled:
    the counterpart of ``torch.save(grid_atlas)``.  For array exchange prefer
    :func:`save_pytree`."""
    import copy

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(copy.deepcopy(model).cpu(), f)


def load_model_pickle(path: str, device="cuda"):
    """Unpickle a model written by :func:`save_model_pickle` (only files this
    program wrote: unpickling runs code) and move it to ``device``."""
    with open(path, "rb") as f:
        model = pickle.load(f)
    return model.to(device)


def import_torch_mlp_decoder(path: str, device="cuda"):
    """A reference MLPNet state_dict (``network.<i>.weight`` (out, in) and
    ``.bias``) as the port's decoder ((W (in, out), b), ...)."""
    sd = torch.load(path, map_location="cpu")
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.endswith(".weight")})
    params = []
    for i in idxs:
        W = sd[f"network.{i}.weight"].T.contiguous().to(device)
        b = sd.get(f"network.{i}.bias")
        params.append((W, None if b is None else b.to(device)))
    return tuple(params)
