"""miso_tpu_torch and chip_smoke.py import neither jax nor miso_tpu, and the
port's entry points ask for the card unless told otherwise."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import miso_tpu_torch
from miso_tpu_torch.models.grid_net import create_grid_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_POISON = """
import sys

for name in ("jax", "jaxlib", "flax", "optax", "miso_tpu"):
    sys.modules[name] = None   # any import of it raises ImportError
import importlib, pkgutil
sys.path.insert(0, {root!r})
import miso_tpu_torch
mods = ["miso_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    miso_tpu_torch.__path__, "miso_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print("imported", len(mods), "modules")
"""


def test_port_imports_without_jax_or_miso_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _POISON.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    n_mods = len(list(pkgutil.walk_packages(miso_tpu_torch.__path__, "miso_tpu_torch."))) + 1
    assert f"imported {n_mods} modules" in res.stdout


def _imported_modules(path):
    """Every module an import statement in ``path`` names, at any depth
    (function-level imports included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_name_neither_jax_nor_miso_tpu():
    """Imports that run only on the card (inside functions) are checked too."""
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "profile_torch_step.py")]
    for d, _, files in os.walk(os.path.dirname(miso_tpu_torch.__file__)):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    banned = ("jax", "jaxlib", "flax", "optax", "miso_tpu")
    for path in paths:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path} imports {mod}"


def test_create_grid_net_defaults_to_cuda():
    cfg = {"grid": {"feature_dim": 1, "bound": [[-1, 1]] * 3, "base_cell_size": 1.0,
                    "per_level_scale": 2.0, "n_levels": 1}}
    import torch
    if torch.cuda.is_available():
        assert create_grid_net(cfg).bound.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            create_grid_net(cfg)
