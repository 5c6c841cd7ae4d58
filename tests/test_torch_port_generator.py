"""RefineGAN_small generator and its weight-normalised layers: port vs the
JAX modules at ``train=False``, float32 on the CPU.  Weight-norm gains are
random (not the initial constant), which pins the per-OUTPUT-channel norm
with 1e-12 inside the sqrt that the JAX transposed conv uses.  Tolerance
2e-5 absolute covers convolution summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair, generator_tree, random_tree
from transtacos_retunegan_tpu.models import vocoder_layers as jvl
from transtacos_retunegan_tpu.models.generators import make_generator as jmake
from transtacos_retunegan_tpu_torch.models import vocoder_layers as tvl
from transtacos_retunegan_tpu_torch.models.generators import make_generator
from transtacos_retunegan_tpu_torch.weights import load_flax

pytestmark = pytest.mark.usefixtures('few_threads')

JCFG, PCFG = cfg_pair()
TOL = dict(atol=2e-5, rtol=1e-5)


def test_generator_matches():
    tree = generator_tree(JCFG, seed=6)
    gen = load_flax(make_generator(PCFG), tree).eval()
    rng = np.random.RandomState(7)
    t = 6
    mel = rng.randn(1, t, 80).astype(np.float32)
    tmpl = (0.3 * rng.randn(1, t * 256, 1)).astype(np.float32)
    ref = jax.jit(lambda p, m, x: jmake(JCFG).apply({'params': p}, m, x, train=False))(
        tree, jnp.asarray(mel), jnp.asarray(tmpl))
    with torch.no_grad():
        out = gen(torch.from_numpy(mel), torch.from_numpy(tmpl))
    assert out.shape == (1, t * 256, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('k,s', [(15, 8), (7, 4)])
def test_wn_conv_transpose_matches(k, s):
    cin, cout, t = 12, 10, 9
    jmod = jvl.WNConvTranspose(cout, k, s)
    x = np.random.RandomState(k).randn(2, t, cin).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tree = random_tree(shapes['params'], seed=k)
    ref = jmod.apply({'params': tree}, jnp.asarray(x))
    tmod = load_flax(tvl.WNConvTranspose(cin, cout, k, s), tree)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert out.shape == (2, t * s, cout)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wn_conv_strided_grouped_matches():
    cin, cout, k = 8, 12, 5
    jmod = jvl.WNConv(cout, k, stride=2, groups=4, padding=2, dense_groups=False)
    x = np.random.RandomState(1).randn(2, 16, cin).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tree = random_tree(shapes['params'], seed=2)
    ref = jmod.apply({'params': tree}, jnp.asarray(x))
    tmod = load_flax(tvl.WNConv(cin, cout, k, stride=2, groups=4, padding=2), tree)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_other_generators_not_ported():
    """Every variant of the JAX registry is ported now (parity per variant
    in ``test_torch_port_vocoder.py``); a name outside it raises."""
    import dataclasses
    from transtacos_retunegan_tpu.models.generators import GENERATORS as JAX_GENERATORS
    from transtacos_retunegan_tpu_torch.models.generators import GENERATORS
    assert sorted(GENERATORS) == sorted(JAX_GENERATORS)
    cfg = dataclasses.replace(PCFG, vocoder=dataclasses.replace(
        PCFG.vocoder, generator_ver='NoSuchGAN'))
    with pytest.raises(ValueError, match='unknown generator'):
        make_generator(cfg)
