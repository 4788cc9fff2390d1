"""Nothing under port_bench imports JAX or the JAX package, and the
plain reference imports nothing of the program: each import's top-level
name compared whole."""

import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "acc_genomics_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_check_compares_whole_names():
    assert "acc_genomics_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"acc_genomics_tpu_torch", "port_bench"})
