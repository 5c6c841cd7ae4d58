"""Shared pieces of the ``test_torch_port_*`` files: small configurations,
JAX-initialised parameter trees as numpy, and the choice of a stop bias
that makes batch rows stop at different decode steps."""

import dataclasses
import functools

import jax
import numpy as np

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
