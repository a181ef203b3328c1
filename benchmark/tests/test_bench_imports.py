"""Nothing of the benchmark loads JAX or the JAX package, and the check of
loaded modules compares whole top-level names."""

import ast
import os

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.micro import ROOT


def test_whole_top_level_names():
    mods = ["bagel_tpu_torch", "bagel_tpu_torch.models", "jaxtyping", "flaxen", "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["jax.numpy", "bagel_tpu.ops", "flax", "jaxlib"]) == [
        "bagel_tpu.ops", "flax", "jax.numpy", "jaxlib"]


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def sources(*parts):
    base = os.path.join(ROOT, "benchmark", *parts)
    for dirpath, _, files in os.walk(base):
        if os.sep + "tests" in dirpath[len(ROOT):]:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax():
    for path in sources():
        for name in imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        for name in imports(path):
            assert name.split(".")[0] not in ("bagel_tpu_torch", "bagel_tpu", "jax"), (path, name)
