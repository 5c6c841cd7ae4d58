"""Nothing under port_bench imports JAX or the JAX package, and the
reference imports nothing of the port; top-level module names are compared
whole, since the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from port_bench.harness import common

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob('*.py'))
PORT = 'transtacos_retunegan_tpu_torch'


def top_level_imports(path: Path):
    """(top-level name, relative level) of every import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split('.')[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or '').split('.')[0], node.level))
    return out


@pytest.mark.parametrize('path', FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_anywhere(path):
    names = {n for n, level in top_level_imports(path) if level == 0}
    assert not names & set(common.FORBIDDEN), (path, names & set(common.FORBIDDEN))


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').rglob('*.py')),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_stays_plain(path):
    """The reference imports neither package of the repository nor the
    harness: absolute imports only of the standard library, numpy and
    torch, relative ones that stay inside ``port_bench/reference``."""
    depth = len(path.relative_to(BENCH / 'reference').parts) - 1
    for name, level in top_level_imports(path):
        if level == 0:
            assert name not in (PORT, 'port_bench') + common.FORBIDDEN, (path, name)
        else:
            assert level - 1 <= depth, (path, name, level)


def test_whole_name_comparison():
    """The port's own name is not taken for the JAX package's."""
    assert PORT.startswith('transtacos_retunegan_tpu')
    assert PORT not in common.FORBIDDEN
    assert 'transtacos_retunegan_tpu' in common.FORBIDDEN


def test_forbidden_modules_seen(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, 'flax.linen', types.ModuleType('flax.linen'))
    monkeypatch.setitem(sys.modules, PORT + '.fake', types.ModuleType('fake'))
    found = common.forbidden_modules()
    assert 'flax' in found and PORT not in found
