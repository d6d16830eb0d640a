"""What the benchmark may import: no module under benchmark/ names JAX, its
libraries or the JAX package, by the whole top-level name (the port's
name begins with the JAX package's and must not be caught), and the
reference imports nothing of the port."""

import ast
import os

import pytest

from benchmark import harness

HERE = harness.HERE


def sources(sub=""):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        if "_cache" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "scene_graph_commonsense_torch" not in names
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "benchmark"}


def test_whole_names_compared():
    assert "scene_graph_commonsense_torch".split(".")[0] \
        not in harness.FORBIDDEN
    assert "scene_graph_commonsense_tpu" in harness.FORBIDDEN
