"""Nothing under portbench imports JAX or the JAX package, by whole top-level
name; the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "livae_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "livae_tpu_torch" not in _imports(path)
    # relative imports stay inside the reference
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1


def test_the_whole_name_is_compared():
    from portbench.run import forbidden_modules
    import sys

    assert "livae_tpu_torch" not in forbidden_modules()
    sys.modules["livae_tpu.fake"] = object()
    try:
        assert forbidden_modules() == ["livae_tpu"]
    finally:
        del sys.modules["livae_tpu.fake"]
