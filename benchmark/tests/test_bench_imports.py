"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the measured program. Top-level module
names are compared whole: the port's name begins with the JAX
package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "srgan_st_tpu"}


def sources(sub=""):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "srgan_st_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "contextlib", "importlib", "math", "torch",
                                       "benchmark"}


def test_the_comparison_is_by_whole_top_level_names():
    assert "srgan_st_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "srgan_st_tpu.models".split(".")[0] in FORBIDDEN
