"""The slice end to end: ``Synthesizer.tts_fused`` of the port (CPU, plain
decode) against the JAX ``Synthesizer(fused_decoder=True)`` (Pallas in
interpret mode) with the JAX object's weights bridged into the port and the
JAX request's Griffin-Lim phase passed in.

In the first test the stop bias is -20 on both sides, so no row is near
the 0.5 stop threshold and both decode every step.  In the second it is set
so that the decode stops before the last step, at a step whose stop logit
clears every earlier one by at least 0.1 (an unambiguous stop step), and
the wavs are compared after the cut at the stop.

Tolerance: 1e-4 absolute on a wav in [-1, 1].  Both decodes use bf16
weights and round the same operands, but the order of float32 sums
differs between the frameworks (matmul vs DFT-matmul STFT too); the
autoregression carries such differences, and the 4 Griffin-Lim
iterations (with momentum) and the generator amplify them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair, jax_synthesizer, np_tree
from transtacos_retunegan_tpu_torch.ops import fused_decoder as PF
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer

pytestmark = pytest.mark.usefixtures('few_threads')

JCFG, PCFG = cfg_pair()
TEXT = 'ni3 hao3 shi4 jie4'


@pytest.fixture(scope='module')
def pair():
    jsynth = jax_synthesizer()
    stop = jsynth.acoustic_params['decoder_cell']['stop_projection']
    stop['bias'] = jnp.full_like(stop['bias'], -20.0)
    port = Synthesizer(PCFG, acoustic_params=np_tree(jsynth.acoustic_params),
                       gen_params=np_tree(jsynth.gen_params), devices=['cpu'])
    return jsynth, port


FRAMES = JCFG.acoustic.max_iters * JCFG.acoustic.outputs_per_step


def _same_phase(jsynth, monkeypatch):
    """Pin the JAX request key and return the phase it draws, for the port."""
    key = jax.random.fold_in(jax.random.PRNGKey(114514), 0)
    monkeypatch.setattr(jsynth, '_next_key', lambda: key)
    return torch.tensor(np.asarray(2.0 * jnp.pi * jax.random.uniform(
        key, (JCFG.audio.n_freq, FRAMES))))


def _set_stop_bias(jsynth, port, value):
    stop = jsynth.acoustic_params['decoder_cell']['stop_projection']
    stop['bias'] = jnp.full_like(stop['bias'], value)
    cell = port.acoustic.decoder_cell
    with torch.no_grad():
        cell.stop_projection.bias.fill_(value)
    port.decoder = PF.fold_params(cell, port.decoder.wbuf.dtype)


def test_tts_fused_matches_jax(pair, monkeypatch):
    jsynth, port = pair
    theta = _same_phase(jsynth, monkeypatch)
    ref = jsynth.tts_fused(TEXT)
    got = port.tts_fused(TEXT, theta=theta)
    assert got.dtype == np.float32 and got.shape == ref.shape == (256 * FRAMES,)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_tts_fused_matches_jax_with_a_stop(pair, monkeypatch):
    jsynth, port = pair
    steps, r = JCFG.acoustic.max_iters, JCFG.acoustic.outputs_per_step
    # the largest stop logit per step of a decode in which nothing stops
    enc = port._encode(TEXT)
    out = PF.to_outputs(port.decoder, *PF.decode_full_plain(
        port.decoder, enc['keys'], enc['values'], enc['mask'], steps))
    p = out['stop_token_outputs'][0].double().numpy().reshape(steps, r)
    z = (np.log(p) - np.log1p(-p) + 20.0).max(-1)
    run = np.maximum.accumulate(z)
    t = [t for t in range(1, steps - 1) if z[t] - run[t - 1] >= 0.1][-1]
    try:
        _set_stop_bias(jsynth, port, -float(run[t - 1] + z[t]) / 2)
        theta = _same_phase(jsynth, monkeypatch)
        ref = jsynth.tts_fused(TEXT)
        got = port.tts_fused(TEXT, theta=theta)
    finally:
        _set_stop_bias(jsynth, port, -20.0)
    assert got.shape == ref.shape == (256 * r * (t + 1),)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_surfaces_shapes(pair):
    _, port = pair
    spec = port.synthesize_spec('da4 jia1')
    assert spec.shape[0] == 1025 and spec.shape[1] % 5 == 0
    assert np.isfinite(spec).all() and (spec >= 0).all()
    w1, w2 = port.vocode(spec), port.vocode(spec.T)
    assert len(w1) == len(w2) == 256 * spec.shape[1]
    wav = port.tts('zhong1 guo2')
    assert len(wav) > 0 and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def test_device_defaults_to_cuda():
    """No device argument means the card; without one it raises, it never
    quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        Synthesizer(PCFG)
