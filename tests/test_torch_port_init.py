"""The port's copy of JAX's random numbers (``jax_random``) and of the
JAX package's initial weights (``weights.flax_vocoder_init`` through
``vocoder_step.init_gan_state``; ``weights.flax_acoustic_init`` through
``acoustic_step.init_state`` and the ``Synthesizer`` without checkpoints),
against JAX and flax on the CPU.

Keys are compared exactly.  Normal, uniform and truncated-normal draws
agree to 1e-6: the port computes XLA's float32 inverse error function with
a ``log1p`` rounded from float64, which may be an ulp from XLA's float32
one, and XLA may fuse the uniform's scale and shift.  Orthogonal draws
agree to 1e-5: the float32 QR of another LAPACK rounds otherwise.  The
initial GAN state is compared leaf by leaf at small widths, for the default
generator and every discriminator family; the initial acoustic model for
the default configuration (the JAX server's tree, from ``PRNGKey(0)``) and
for one that has the CBHG encoder (its batch statistics too), the fused
decoder cell and the sew layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (_tacotron_init, cfg_pair, jax_synthesizer, small_cfg,
                               vocoder_batch, vocoder_cfg_pair)
from transtacos_retunegan_tpu.train import vocoder_step as jvs
from transtacos_retunegan_tpu_torch import jax_random, weights
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.train import acoustic_step as A
from transtacos_retunegan_tpu_torch.train import vocoder_step as vs

pytestmark = pytest.mark.usefixtures('few_threads')
NORMAL_TOL = 1e-6
INIT_TOL = 1e-6
ORTHO_TOL = 1e-5
# one configuration with every acoustic variant the default lacks
VARIANTS = dict(encoder_type='cb', encoder_conv_K=2, highway_layers=2, fast_cell=True,
                decoder_sew_layer=True)
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


@pytest.mark.parametrize('shape', [(7,), (3, 5, 2), (4099,)])
def test_uniform_matches_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 2)
    want = np.asarray(jax.random.uniform(key, shape, minval=-0.3, maxval=2.5))
    got = jax_random.uniform(_words(key), shape, -0.3, 2.5).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)


@pytest.mark.parametrize('bounds', [(-2.0, 2.0), (-1.5, 0.5)])
@pytest.mark.parametrize('shape', [(7,), (3, 5, 2), (4099,)])
def test_truncated_normal_matches_jax(shape, bounds):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = np.asarray(jax.random.truncated_normal(key, *bounds, shape))
    got = jax_random.truncated_normal(_words(key), *bounds, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert bounds[0] < got.min() and got.max() < bounds[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)


@pytest.mark.parametrize('shape', [(64, 64), (32, 96), (96, 32), (3, 4, 16)])
def test_orthogonal_matches_flax(shape):
    import flax.linen as fnn
    key = jax.random.fold_in(jax.random.PRNGKey(7), 4)
    want = np.asarray(fnn.initializers.orthogonal()(key, shape))
    got = jax_random.orthogonal(_words(key), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ORTHO_TOL)


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


def _ortho(path) -> bool:
    """A leaf flax draws with ``orthogonal()``: a GRU's hidden kernels."""
    return path[-1] == 'wh' or (path[-1] == 'kernel' and path[-2] in ('hr', 'hz', 'hn'))


def assert_acoustic_init(module, params, batch_stats=None):
    """Every leaf of ``module`` (parameters and batch statistics) against
    the JAX trees, orthogonal leaves to ORTHO_TOL, the others to
    INIT_TOL."""
    got_p, got_s = weights.to_flax(module, module.state_dict())
    for got, want in ((got_p, params), (got_s, batch_stats or {})):
        got = weights.flatten(got)
        ref = weights.flatten(jax.tree.map(np.asarray, dict(want)))
        got = {k: v for k, v in got.items() if k in ref or k[-1] != 'pe_table'}
        assert set(got) == set(ref)
        for path, leaf in ref.items():
            np.testing.assert_allclose(got[path], leaf, rtol=0,
                                       atol=ORTHO_TOL if _ortho(path) else INIT_TOL,
                                       err_msg='/'.join(path))


def test_flax_acoustic_init_matches_jax_default():
    """The default configuration's draw from ``PRNGKey(0)`` against the
    JAX server's tree (its ``init_state(cfg, PRNGKey(0), batch)``)."""
    module = Tacotron(small_cfg(PortConfig))
    weights.flax_acoustic_init(module, jax_random.prng_key(0))
    assert_acoustic_init(module, jax_synthesizer().acoustic_params)


def test_flax_acoustic_init_matches_jax_variants():
    """The CBHG encoder (GRU cells inside ``nn.RNN``, highway gates,
    batch norm and its statistics), the fused decoder cell (``_concat_init``
    under ``nn.scan`` and ``nn.remat``) and the sew layer, from a seed
    other than 0."""
    jcfg, pcfg = cfg_pair(**VARIANTS)
    r = jcfg.acoustic.outputs_per_step
    from transtacos_retunegan_tpu.train.acoustic_step import init_state
    batch = {'text': jnp.zeros((1, 8, 2), jnp.int32), 'text_lengths': jnp.asarray([8]),
             'prds': jnp.zeros((1, 8), jnp.int32), 'spec_lengths': jnp.asarray([4 * r]),
             'mel_targets': jnp.zeros((1, 4 * r, jcfg.audio.n_mel)),
             'f0_targets': jnp.zeros((1, 4 * r), jnp.int32),
             'c0_targets': jnp.zeros((1, 4 * r), jnp.int32)}
    want = init_state(jcfg, jax.random.PRNGKey(114514), batch)
    assert set(want.extra_vars) == {'batch_stats'}
    module = weights.flax_acoustic_init(Tacotron(pcfg), jax_random.prng_key(114514))
    assert_acoustic_init(module, want.params, want.extra_vars['batch_stats'])


def test_init_state_is_the_jax_init_state():
    """The port's ``init_state(cfg, seed)`` holds JAX's ``init_state(cfg,
    PRNGKey(seed), batch).params`` (seed 0: the JAX server's tree)."""
    state = A.init_state(small_cfg(PortConfig), 0, 'cpu')
    assert state.step == 0
    assert_acoustic_init(state.model, jax_synthesizer().acoustic_params)


def test_synthesizer_without_checkpoints_has_the_jax_servers_weights():
    """The acoustic model from ``PRNGKey(0)``, the generator from
    ``PRNGKey(1)``, whatever the request seed."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    want = jax_synthesizer()
    synth = Synthesizer(small_cfg(PortConfig), devices=['cpu'], seed=5)
    assert_acoustic_init(synth.acoustic, want.acoustic_params)
    ref = weights.flatten(jax.tree.map(np.asarray, dict(want.gen_params)))
    got = weights.flatten(weights.to_flax(synth.generator, synth.generator.state_dict())[0])
    assert set(got) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=INIT_TOL,
                                   err_msg='/'.join(path))


def test_infer_vocoder_without_a_checkpoint_draws_from_key_0(tmp_path, capsys):
    """``load_generator`` on a run dir without ``g_*``: the JAX tool's
    generator from ``PRNGKey(0)`` (``flax_vocoder_init``, held to JAX's
    draws by ``test_init_gan_state_matches_jax``)."""
    import torch
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    from transtacos_retunegan_tpu_torch.serve.infer_vocoder import load_generator
    cfg = small_cfg(PortConfig)
    gen = load_generator(str(tmp_path), cfg, 'cpu')
    assert 'no g_* checkpoint' in capsys.readouterr().out
    want = weights.flax_vocoder_init(make_generator(cfg), jax_random.prng_key(0)).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())


def test_flax_acoustic_init_refuses_an_unknown_leaf():
    import torch
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match='no flax initialiser'):
        weights.flax_acoustic_init(module, jax_random.prng_key(0))
