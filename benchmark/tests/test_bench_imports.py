"""No file of the benchmark imports JAX or the JAX package, and nothing of
the reference imports the program (whole top-level names compared)."""

import ast
import os

import pytest

from harness import FORBIDDEN, forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(BENCH, sub)):
        if "out" in d.split(os.sep) or "__pycache__" in d:
            continue
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_no_jax_anywhere():
    bad = [(f, m) for f in _files() for m in _imports(f) if m in FORBIDDEN]
    assert not bad


def test_reference_stands_alone():
    bad = [(f, m) for f in _files("reference") for m in _imports(f)
           if m in FORBIDDEN + ("vgqa_tpu_torch",)]
    assert not bad


@pytest.mark.parametrize("names,found", [
    (["vgqa_tpu_torch", "vgqa_tpu_torch.qa.engine", "torch"], []),
    (["jax.numpy", "torch"], ["jax.numpy"]),
    (["jaxlib"], ["jaxlib"]), (["flax.linen"], ["flax.linen"]), (["optax"], ["optax"]),
    (["vgqa_tpu.models"], ["vgqa_tpu.models"]), (["jaxtyping"], []),
])
def test_module_check_compares_whole_names(names, found):
    assert forbidden_modules(names) == found
