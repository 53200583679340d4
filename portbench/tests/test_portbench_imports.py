"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (reference, work counts, traffic, metric readers) imports
nothing of the program: every import in ``portbench/`` compared by its
whole top-level name."""
import ast
import os

import pytest

from portbench import harness

JAX = {"jax", "jaxlib", "flax", "lerf_tpu"}
PROGRAM = "lerf_torch"
# the files that may import the program: the system under test, and the
# harness and entry that drive it
DRIVERS = ("system", "harness.py", "run.py", "tests")


def _files():
    for d, _, names in os.walk(harness.HERE):
        for n in names:
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(d, n), harness.HERE)


def _imports(rel):
    tree = ast.parse(open(os.path.join(harness.HERE, rel)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", sorted(_files()))
def test_no_jax_and_the_yardstick_is_independent(rel):
    names = set(_imports(rel))
    assert not names & JAX, rel
    if not rel.startswith(DRIVERS):
        assert PROGRAM not in names, rel


def test_whole_names_tell_the_port_from_the_jax_package():
    assert "lerf_torch".split(".")[0] not in JAX
    assert "lerf_tpu.ops".split(".")[0] in JAX
