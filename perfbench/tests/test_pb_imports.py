"""What the benchmark may import: nothing of JAX or the JAX package (top
level names compared whole, so the port `bundlesdf_tpu_torch` passes),
nothing of the repository's `tests/`, its bench or chip smoke; and the
reference nothing of the port."""
import ast
import os

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "bundlesdf_tpu", "tests", "chip_smoke",
             "synthetic"}
FORBIDDEN_MODULES = {"bundlesdf_tpu_torch.bench"}


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _sources(sub=""):
    root = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_forbidden_import(path):
    for m in _modules(path):
        assert m.split(".")[0] not in FORBIDDEN, (path, m)
        assert m not in FORBIDDEN_MODULES, (path, m)


def test_top_level_names_compare_whole():
    assert "bundlesdf_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "bundlesdf_tpu.ops".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for m in _modules(path):
            assert m.split(".")[0] != "bundlesdf_tpu_torch", (path, m)
