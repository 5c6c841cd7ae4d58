"""Shared pieces of the ``test_torch_port_*`` files: small configurations,
JAX-initialised parameter trees as numpy, and the choice of a stop bias
that makes batch rows stop at different decode steps."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu_torch.config import Config as PortConfig

SMALL_ACOUSTIC = dict(embed_depth=32, encoder_depth=32, decoder_depth=64,
                      attention_depth=16, prenet_depths=(32,), posnet_depth=64,
                      var_embed_depth=16, var_prednet_depth=16,
                      prdsnet_depth=16, posenc_depth=8, max_iters=8)
SMALL_VOCODER = dict(upsample_initial_channel=64)


def small_cfg(config_cls, **acoustic):
    """The same small configuration in either package's Config class."""
    base = config_cls()
    return dataclasses.replace(
        base,
        acoustic=dataclasses.replace(base.acoustic, **{**SMALL_ACOUSTIC, **acoustic}),
        vocoder=dataclasses.replace(base.vocoder, **SMALL_VOCODER))


def cfg_pair(**acoustic):
    return small_cfg(JaxConfig, **acoustic), small_cfg(PortConfig, **acoustic)


def np_tree(tree):
    """JAX param tree -> nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _tacotron_init(cfg, seed):
    import jax.numpy as jnp
    from transtacos_retunegan_tpu.train.acoustic_step import init_state
    r = cfg.acoustic.outputs_per_step
    batch = {
        'text': jnp.zeros((1, 8, 2), jnp.int32),
        'text_lengths': jnp.asarray([8]),
        'prds': jnp.zeros((1, 8), jnp.int32),
        'spec_lengths': jnp.asarray([4 * r]),
        'mel_targets': jnp.zeros((1, 4 * r, cfg.audio.n_mel)),
        'f0_targets': jnp.zeros((1, 4 * r), jnp.int32),
        'c0_targets': jnp.zeros((1, 4 * r), jnp.int32),
    }
    return init_state(cfg, jax.random.PRNGKey(seed), batch).params


def _generator_init(cfg, seed):
    import jax.numpy as jnp
    from transtacos_retunegan_tpu.models.generators import make_generator
    mel = jnp.zeros((1, 4, cfg.audio.n_mel))
    tmpl = jnp.zeros((1, 4 * cfg.audio.hop_length, 1))
    return make_generator(cfg).init({'params': jax.random.PRNGKey(seed),
                                     'noise': jax.random.PRNGKey(seed + 1)},
                                    mel, tmpl, train=False)['params']


@functools.lru_cache(maxsize=None)
def jax_synthesizer():
    """The JAX ``Synthesizer(fused_decoder=True)`` at the small
    configuration, built once per process: its constructor initialises the
    full training-init Tacotron tree (train-only leaves included) and the
    generator, which takes most of a test file's time."""
    from transtacos_retunegan_tpu.serve.pipeline import Synthesizer
    return Synthesizer(small_cfg(JaxConfig), fused_decoder=True)


def random_tree(shapes, seed: int):
    """Random numpy tree of the given shapes: dense/conv kernels and
    weight-norm directions scaled by their fan-in, non-trivial weight-norm
    gains, small non-zero biases (as a trained checkpoint has)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name in ('kernel', 'v'):
            fan = int(np.prod(shape[:-1]))
            return rng.randn(*shape).astype(np.float32) / np.sqrt(fan)
        if name == 'g':
            return (1.0 + 0.5 * rng.rand(*shape)).astype(np.float32)
        if name.startswith('E_'):
            return (0.5 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def tacotron_tree(cfg, seed: int = 0):
    """Random values on the shapes of the JAX Tacotron's training tree."""
    return random_tree(jax.eval_shape(lambda: _tacotron_init(cfg, 0)), seed)


def generator_tree(cfg, seed: int = 1):
    return random_tree(jax.eval_shape(lambda: _generator_init(cfg, 0)), seed)


def distinct_stop_bias(stop_probs: np.ndarray, r: int, bias0: float,
                       margin: float = 0.05):
    """Stop bias under which the rows of a decode stop at different steps.

    ``stop_probs`` [B, steps*r] come from a decode run with every stop bias
    at ``bias0`` in which no row stopped.  Until a row stops, its
    trajectory does not depend on the stop bias, so with bias ``-c`` row b
    stops at the first step whose largest pre-bias stop logit reaches c.
    Returns (bias, stop steps) for the c, between two observed logits,
    that gives the rows distinct stop steps before the last step with the
    widest distance from every observed logit.
    """
    p = stop_probs.astype(np.float64).reshape(stop_probs.shape[0], -1, r)
    z = (np.log(p) - np.log1p(-p) - bias0).max(-1)                # [B, steps]
    vals = np.sort(z.ravel())
    best = None
    for c in (vals[1:] + vals[:-1]) / 2:
        hit = z >= c
        if not hit.any(1).all():
            continue
        first = hit.argmax(1)
        if len(set(first.tolist())) < len(first) or first.max() >= z.shape[1] - 1:
            continue
        gap = np.abs(z - c).min()
        if gap >= margin and (best is None or gap > best[0]):
            best = (gap, c, first)
    assert best is not None, 'no stop bias separates the rows'
    return -float(best[1]), best[2] + 1


# ---------------------------------------------------------------------------
# vocoder training (test_torch_port_vocoder*.py, test_torch_port_gan_step*.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def few_threads():
    """Two intra-op threads for PyTorch while a module's tests run (then
    the number before): the vocoder's CPU steps are many small ops, and
    with one thread per core in each of several test processes the
    threads' synchronisation took 17x the single-process time."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# tests/test_vocoder.py's small configuration: 2048-sample segments (8
# frames), B=2, 32 initial generator channels, two STFT resolutions
VOCODER_SMALL = dict(upsample_initial_channel=32,
                     multi_stft_params=((1024, 512, 120), (512, 256, 60)))
SEG, FRAMES, VB = 2048, 8, 2


def vocoder_cfg_pair(**vocoder):
    """The same vocoder configuration in both packages' Config classes."""
    out = []
    for config_cls in (JaxConfig, PortConfig):
        base = config_cls()
        out.append(dataclasses.replace(base, vocoder=dataclasses.replace(
            base.vocoder, **{**VOCODER_SMALL, **vocoder})))
    return tuple(out)


def vocoder_batch(cfg, seed: int, b: int = VB, seg: int = SEG):
    """A numpy batch of the configured generator's inputs and a target."""
    rng = np.random.RandomState(seed)
    frames = seg // cfg.audio.hop_length
    mel = rng.randn(b, frames, cfg.audio.n_mel).astype(np.float32)
    tmpl = (0.1 * rng.randn(b, seg)).astype(np.float32)
    wav = (0.1 * rng.randn(b, seg)).astype(np.float32)
    if not cfg.vocoder.split_cv:
        return {'mel': mel, 'tmpl': tmpl, 'wav': wav}
    uv = (rng.rand(b, seg) > 0.5).astype(np.float32)
    return {'mel_c': mel, 'mel_v': (mel[:, ::-1] * 0.5).copy(), 'tmpl_c': tmpl * uv,
            'tmpl_v': tmpl * (1 - uv), 'uv': uv, 'wav': wav}


def generator_args(cfg, batch):
    """The generator's positional inputs in the JAX layout."""
    if cfg.vocoder.split_cv:
        return (batch['mel_c'], batch['mel_v'], batch['tmpl_c'][..., None],
                batch['tmpl_v'][..., None], batch['uv'][..., None])
    return batch['mel'], batch['tmpl'][..., None]


def vocoder_trees(cfg, batch, seed: int):
    """Random trees on the shapes of the JAX generator and of the
    ``{'msd', 'mpd', 'mtd'}`` discriminator tree."""
    import jax.numpy as jnp
    from transtacos_retunegan_tpu.models import discriminators as jd
    from transtacos_retunegan_tpu.models import vocoder_losses as jl
    from transtacos_retunegan_tpu.models.generators import make_generator
    args = tuple(jnp.asarray(a) for a in generator_args(cfg, batch))
    keys = {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}
    gshape = jax.eval_shape(lambda: make_generator(cfg).init(keys, *args, train=True))
    y = jnp.asarray(batch['wav'])
    _, sr, sg = jax.eval_shape(lambda: jl.multi_stft_specs_and_loss(y, y, cfg))
    spec = [jnp.zeros(s.shape) for s in sr]
    k = jax.random.PRNGKey(0)
    dshape = {
        'msd': jax.eval_shape(lambda: jd.MultiScaleDiscriminator(cfg).init(
            k, y[..., None], y[..., None])),
        'mpd': jax.eval_shape(lambda: jd.MultiPeriodDiscriminator(cfg).init(
            k, y[..., None], y[..., None])),
        'mtd': jax.eval_shape(lambda: jd.MultiStftDiscriminator(cfg).init(k, spec, spec)),
    }
    return (random_tree(gshape['params'], seed),
            {n: random_tree(s['params'], seed + 1 + i)
             for i, (n, s) in enumerate(sorted(dshape.items()))})


def noise_interceptor(record):
    """A ``flax.linen.intercept_methods`` interceptor that draws the
    training noise of ``LearnedGaussianNoise.__call__`` itself, from the
    same ``make_rng('noise')`` call the module makes, appends it to
    ``record`` and returns what the module would."""
    from transtacos_retunegan_tpu.models import vocoder_layers as jvl

    def icpt(next_fun, args, kwargs, context):
        train = kwargs.get('train', args[1] if len(args) > 1 else True)
        if (not isinstance(context.module, jvl.LearnedGaussianNoise)
                or context.method_name != '__call__' or not train):
            return next_fun(*args, **kwargs)
        x = args[0]
        w = context.module.param('w', lambda *_: None, (1,))
        n = jax.random.uniform(context.module.make_rng('noise'), x.shape, x.dtype)
        record.append(n)
        return jvl.lrelu(x + n * w)
    return icpt


def jax_generator_with_noise(cfg):
    """jitted ``(params, args, noise_key) -> (train-forward output, noise
    list)`` of the JAX generator, the noise recorded by
    ``noise_interceptor``."""
    import flax.linen as fnn
    from transtacos_retunegan_tpu.models.generators import make_generator

    @jax.jit
    def run(params, args, key):
        record = []
        with fnn.intercept_methods(noise_interceptor(record)):
            out = make_generator(cfg).apply({'params': params}, *args, train=True,
                                            rngs={'noise': key})
        return out, record
    return run


def exact_zero_imag_stft_ri(stft_ri):
    """The JAX package's ``stft_ri`` with the imaginary parts that are
    exactly zero for any real input (the DC and Nyquist rows, the first
    frame, which reflect padding makes even-symmetric, and the last one
    when it is centred on the last sample) set to +0, as the port sets
    them.  The DFT matmul computes rounding noise of either sign there,
    which makes the phase of a bin with a negative real part +pi or -pi at
    random; comparisons that feed the phase to the STFT discriminator patch
    it in."""
    import jax.numpy as jnp

    def patched(y, n_fft, hop_length, win_length, window='hann', **kw):
        re, im = stft_ri(y, n_fft, hop_length, win_length, window, **kw)
        keep = np.ones(im.shape[-2:], bool)
        keep[0, :] = keep[-1, :] = keep[:, 0] = False
        if (y.shape[-1] - 1) % hop_length == 0:
            keep[:, -1] = False
        return re, jnp.where(keep, im, 0.0)
    return patched


# ---------------------------------------------------------------------------
# acoustic training (test_torch_port_acoustic_*.py)
# ---------------------------------------------------------------------------

ACOUSTIC_KEYS = ('text', 'text_lengths', 'prds', 'spec_lengths', 'mel_targets',
                 'f0_targets', 'c0_targets')


def acoustic_cfg_pair(**acoustic):
    """``tests/test_train_cli.py``'s tiny configuration (B=2, frame bucket
    40) in both packages' Config classes."""
    return cfg_pair(**{'batch_size': 2, 'frame_bucket': 40, **acoustic})


@functools.lru_cache(maxsize=None)
def _acoustic_shapes(cfg):
    return jax.eval_shape(lambda: _tacotron_state(cfg))


def _tacotron_state(cfg):
    import jax.numpy as jnp
    from transtacos_retunegan_tpu.train.acoustic_step import init_state
    r = cfg.acoustic.outputs_per_step
    batch = {
        'text': jnp.zeros((1, 8, 2), jnp.int32), 'text_lengths': jnp.asarray([8]),
        'prds': jnp.zeros((1, 8), jnp.int32), 'spec_lengths': jnp.asarray([4 * r]),
        'mel_targets': jnp.zeros((1, 4 * r, cfg.audio.n_mel)),
        'f0_targets': jnp.zeros((1, 4 * r), jnp.int32),
        'c0_targets': jnp.zeros((1, 4 * r), jnp.int32),
    }
    state = init_state(cfg, jax.random.PRNGKey(0), batch)
    return state.params, state.extra_vars


def acoustic_tree(cfg, seed: int = 3, with_stats: bool = False):
    """Random values on the shapes of the JAX Tacotron's training tree;
    with ``with_stats`` also its batch statistics (None for the 'sa'
    encoder) as (params, batch_stats), the variances positive."""
    params, extra = _acoustic_shapes(cfg)
    tree = random_tree(params, seed)
    if not with_stats:
        return tree
    if 'batch_stats' not in extra:
        return tree, None
    stats = random_tree(extra['batch_stats'], seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: np.abs(v) + 0.5 if p[-1].key == 'var' else v, stats)
    return tree, stats


def acoustic_batch(cfg, seed: int = 0):
    """A numpy batch in the feeder's layout: B=2, text 12 and 9 of 16
    positions, spectrograms of 33 and 27 frames padded to 40 (8 decode
    steps), loss lengths 35 frames and 12 text positions."""
    r = np.random.RandomState(seed)
    au = cfg.audio
    b, n, t = 2, 16, 40
    tl, sl = np.array([12, 9], np.int32), np.array([33, 27], np.int32)
    text = np.zeros((b, n, 2), np.int32)
    prds = np.zeros((b, n), np.int32)
    stop = np.ones((b, t), np.float32)
    for i in range(b):
        text[i, :tl[i], 0] = r.randint(1, 40, tl[i])
        text[i, :tl[i], 1] = r.randint(0, au.n_tone, tl[i])
        prds[i, :tl[i]] = r.randint(0, au.n_prds, tl[i])
        stop[i, :sl[i]] = 0.0
    return {'text': text, 'text_lengths': tl, 'prds': prds, 'spec_lengths': sl,
            'mel_targets': r.randn(b, t, au.n_mel).astype(np.float32),
            'mag_targets': r.randn(b, t, au.n_freq - 1).astype(np.float32),
            'f0_targets': r.randint(0, au.n_f0_bins, (b, t)).astype(np.int32),
            'c0_targets': r.randint(0, au.n_c0_bins, (b, t)).astype(np.int32),
            'stop_token_targets': stop,
            'frame_loss_len': np.asarray(35, np.int32),
            'text_loss_len': np.asarray(12, np.int32)}


def coin_of(step_inputs):
    """The 'random' teacher-forcing coin of each decode step, a function
    of that step's input frame [..., B, M] (float32, the same in numpy
    and in jax.numpy)."""
    x = step_inputs[..., 0, 0]
    return (abs(x) * np.float32(7.31) + np.float32(0.37)) % np.float32(1.0)


def acoustic_interceptor(next_fun, args, kwargs, context):
    """``flax.linen.intercept_methods`` interceptor: ``nn.Dropout`` and
    ``GaussianNoise`` are identities, and a training decoder cell with
    ``tf_method='random'`` takes its coin from ``coin_of`` of its input
    (the cell's own coin still runs, against a ratio of 2 or -1 that
    decides it)."""
    import flax.linen as fnn
    import jax.numpy as jnp
    from transtacos_retunegan_tpu.models import decoder as jdec
    from transtacos_retunegan_tpu.models import decoder_fast as jfast
    from transtacos_retunegan_tpu.models import layers as jl
    m = context.module
    if context.method_name != '__call__':
        return next_fun(*args, **kwargs)
    if isinstance(m, (fnn.Dropout, jl.GaussianNoise)):
        return args[0]
    if (isinstance(m, (jdec.DecoderCell, jfast.DecoderCellFast)) and m.mode == 'train'
            and m.cfg.acoustic.tf_method == 'random'):
        (carry, attn, tfr), xs = args
        coin = coin_of(xs['target_prev'])
        (c, a, _), ys = next_fun((carry, attn, jnp.where(coin < tfr, 2.0, -1.0)), xs)
        return (c, a, tfr), ys
    return next_fun(*args, **kwargs)



def reference_state_dict(module, mapping, seed: int):
    """A seeded state dict in the reference RetuneGAN's torch layout for an
    ``interop`` layer map, built from the map entries on the shapes of the
    port's ``module`` (``interop.seeded_state_dict``)."""
    from transtacos_retunegan_tpu_torch.interop import seeded_state_dict
    return seeded_state_dict(module, mapping, seed)


SYLLABLES = ['ni3', 'hao3', 'shi4', 'jie4', 'zhong1', 'guo2', 'ren2', 'wo3', 'men5',
             'de5', 'jia1', 'tian1', 'qi4']


def write_npy_corpus(d):
    """A preprocessed-corpus directory of random features in ``d`` (the
    layout both packages' ``AcousticDataset`` read): 24 utterances of 2-9
    syllables and 30-110 frames."""
    rng = np.random.RandomState(0)
    cfg = PortConfig().audio
    rows = []
    for i in range(24):
        n, t = rng.randint(2, 10), rng.randint(30, 111)
        text = ' '.join(rng.choice(SYLLABLES, n))
        rows.append(f'u{i:02d}|{"0" * (n - 1)}4|{text}')
        np.save(d / f'mel-u{i:02d}.npy', rng.randn(cfg.n_mel, t).astype(np.float32))
        np.save(d / f'mag-u{i:02d}.npy', rng.randn(cfg.n_freq, t).astype(np.float32))
        np.save(d / f'f0-u{i:02d}.npy', rng.uniform(0, 400, t).astype(np.float32))
        np.save(d / f'c0-u{i:02d}.npy', rng.uniform(0, 1, t).astype(np.float32))
    (d / 'train.txt').write_text('\n'.join(rows), encoding='utf-8')
    return str(d)
