"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level name; the plain reference imports nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from perfbench import core

JAX_SIDE = {"jax", "jaxlib", "flax", "srsue_tpu"}


def imported_tops(path):
    """Top-level names of every absolute import in a source file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(core.HERE.rglob("*.py")), ids=lambda p: str(p))
def test_sources_import_no_jax(path):
    tops = set(imported_tops(path))
    assert not tops & JAX_SIDE
    if "reference" in path.relative_to(core.HERE).parts:
        assert "srsue_tpu_torch" not in tops and "perfbench" not in tops


@pytest.mark.parametrize("what,allowed", [
    ("import perfbench.reference.receiver, perfbench.reference.transmitter", set()),
    ("from perfbench import core; [core.load_module('entries', n) for n in "
     "('chain', 'ue_dl', 'shard')]", {"srsue_tpu_torch"}),
])
def test_loaded_modules(what, allowed):
    """What a fresh interpreter holds after the import, by whole top-level
    name (``srsue_tpu_torch`` begins with ``srsue_tpu``)."""
    code = (f"import sys; sys.path.insert(0, {str(core.ROOT)!r}); {what}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              check=True).stdout.split())
    assert not tops & JAX_SIDE
    assert not (tops & {"srsue_tpu_torch"}) - allowed
