"""The port's copy of JAX's random numbers (``jax_random``) and of the
JAX package's initial vocoder weights (``weights.flax_vocoder_init``
through ``vocoder_step.init_gan_state``), against JAX and flax on the CPU.

Keys are compared exactly.  Normal draws agree to 1e-6: the port computes
XLA's float32 inverse error function with a ``log1p`` rounded from
float64, which may be an ulp from XLA's float32 one.  The initial GAN state is compared leaf by leaf at
small widths, for the default generator and every discriminator family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import vocoder_batch, vocoder_cfg_pair
from transtacos_retunegan_tpu.train import vocoder_step as jvs
from transtacos_retunegan_tpu_torch import jax_random, weights
from transtacos_retunegan_tpu_torch.train import vocoder_step as vs

pytestmark = pytest.mark.usefixtures('few_threads')
NORMAL_TOL = 1e-6
INIT_TOL = 1e-6
SLIM = dict(disc_width_mult=0.25, msd_layers=1, mpd_periods=(3,),
            multi_stft_params=((512, 256, 60),))


def _words(key):
    return tuple(int(w) for w in np.asarray(key))


@pytest.mark.parametrize('seed', [0, 1, 114514, 2 ** 31 - 1])
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert jax_random.prng_key(seed) == _words(key)
    for data in (0, 7, 11, 2 ** 32 - 1):
        assert jax_random.fold_in(jax_random.prng_key(seed), data) == \
            _words(jax.random.fold_in(key, data))
    for num in (2, 3, 5):
        assert jax_random.split(jax_random.prng_key(seed), num) == \
            tuple(_words(k) for k in jax.random.split(key, num))


@pytest.mark.parametrize('shape', [(1,), (7,), (3, 5, 2), (100003,)])
def test_normal_matches_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(114514), 3)
    want = np.asarray(jax.random.normal(key, shape))
    got = jax_random.normal(_words(key), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)


def test_flax_key_matches_flax():
    """A parameter's key: the scope's names, then its position in the
    scope; the draw of a nested module's third parameter."""
    import flax.linen as fnn

    class Leaf(fnn.Module):
        @fnn.compact
        def __call__(self):
            return [self.param(n, fnn.initializers.normal(1.0), (4,)) for n in 'abc']

    class Outer(fnn.Module):
        @fnn.compact
        def __call__(self):
            return Leaf(name='inner_0')()

    params = Outer().init(jax.random.PRNGKey(5))['params']
    root = jax_random.prng_key(5)
    for i, name in enumerate('abc'):
        want = np.asarray(params['inner_0'][name])
        got = jax_random.normal(jax_random.flax_key(root, ('inner_0', i + 1)), (4,)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)


def test_init_gan_state_matches_jax():
    """``init_gan_state(cfg, seed)`` holds the weights of the JAX
    package's ``init_gan_state(cfg, PRNGKey(seed), ...)``, leaf by leaf."""
    jcfg, pcfg = vocoder_cfg_pair(**SLIM)
    batch = {k: jnp.asarray(v) for k, v in vocoder_batch(jcfg, 0).items()}
    want = jvs.init_gan_state(jcfg, jax.random.PRNGKey(114514), batch, 1)
    got = vs.init_gan_state(pcfg, 114514, 'cpu')
    pairs = [(want.gen_params, got.generator)] + [
        (want.disc_params[n], getattr(got.discriminators, n)) for n in ('msd', 'mpd', 'mtd')]
    for tree, module in pairs:
        ref = weights.flatten(jax.tree.map(np.asarray, tree))
        port = weights.flatten(weights.to_flax(module, module.state_dict())[0])
        assert set(port) == set(ref)
        for path, leaf in ref.items():
            np.testing.assert_allclose(port[path], leaf, rtol=0, atol=INIT_TOL,
                                       err_msg='/'.join(path))


def test_flax_vocoder_init_refuses_an_unknown_leaf():
    import torch
    module = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match='no flax initialiser'):
        weights.flax_vocoder_init(module, jax_random.prng_key(0))
