"""What the benchmark runs imports neither JAX nor the JAX package, and the
reference imports nothing of the program.  Module names are compared whole
at their top level (the part before the first dot): ``miso_tpu_torch`` is
not ``miso_tpu``.  CPU only: an AST walk, nothing is imported."""
from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "miso_tpu"}


def imported(path):
    """(module, level) of every import in a file, relative ones resolved."""
    tree = ast.parse(open(path).read(), filename=path)
    pkg = os.path.relpath(os.path.dirname(path), ROOT).replace(os.sep, ".")
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def module_file(mod):
    base = os.path.join(ROOT, *mod.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def reach(files):
    """Every repository file that the given files import, transitively."""
    seen, todo = set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for mod in imported(f):
            parts = mod.split(".")
            for i in range(len(parts), 0, -1):
                g = module_file(".".join(parts[:i]))
                if g:
                    todo.append(g)
                    break
    return seen


def bench_files():
    out = []
    for d, _, names in os.walk(os.path.join(ROOT, "portbench")):
        if os.sep + "tests" in d:
            continue
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return out


def top_names(files):
    return {m.split(".")[0] for f in files for m in imported(f)}


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = reach(bench_files())
    assert any(f.endswith(os.path.join("miso_tpu_torch", "train", "trainer.py")) for f in files)
    found = {os.path.relpath(f, ROOT): sorted(top_names([f]) & FORBIDDEN) for f in files}
    assert not {f: v for f, v in found.items() if v}


def test_the_port_imports_no_jax_anywhere():
    files = []
    for d, _, names in os.walk(os.path.join(ROOT, "miso_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert files and not top_names(files) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(ROOT, "portbench", "reference"))))
def test_the_reference_reaches_nothing_of_the_program(name):
    if not name.endswith(".py"):
        return
    files = reach([os.path.join(ROOT, "portbench", "reference", name)])
    assert all(os.path.relpath(f, ROOT).startswith(os.path.join("portbench", "reference"))
               for f in files)
    assert not top_names(files) & (FORBIDDEN | {"miso_tpu_torch"})
