"""The port never imports JAX or the JAX package: every ``.py`` of
``transtacos_retunegan_tpu_torch`` (``parallel/`` and ``tools/`` included)
and ``chip_smoke.py`` is checked by an AST walk over its import
statements."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transtacos_retunegan_tpu')
FILES = sorted((ROOT / 'transtacos_retunegan_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def _forbidden(name):
    top = name.split('.')[0]
    return top in FORBIDDEN


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imported(ast.parse(path.read_text())) if _forbidden(n)]
    assert not bad, f'{path}: imports {bad}'


def test_checker_sees_the_jax_package():
    """The port's own name is not mistaken for the JAX package's."""
    assert _forbidden('transtacos_retunegan_tpu.ops')
    assert _forbidden('jax.numpy') and _forbidden('flax')
    assert not _forbidden('transtacos_retunegan_tpu_torch.ops')


def test_walk_covers_the_parallel_package():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for f in ('parallel/__init__.py', 'parallel/mesh.py', 'tools/multihost_smoke.py'):
        assert f'transtacos_retunegan_tpu_torch/{f}' in names, f


@pytest.mark.parametrize('tool', ['acoustic_step_ab', 'pallas_equivalence', 'profile_stages',
                                  'acoustic_step_trace', 'train_scaling', 'bench_precision'])
def test_walk_covers_the_timing_tools(tool):
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert f'transtacos_retunegan_tpu_torch/tools/{tool}.py' in names
