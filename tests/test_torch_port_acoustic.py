"""Acoustic encoder and posnet: port vs ``Tacotron.apply(train=False,
encoder_only=True)`` and ``posnet_apply`` on the same weights and text.
Both sides run float32 on the CPU; tolerance 1e-5 absolute (plus 1e-5
relative) covers the different summation orders of the two frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair, tacotron_tree
from transtacos_retunegan_tpu.models.acoustic import Tacotron as JTacotron
from transtacos_retunegan_tpu.models.acoustic import posnet_apply as jposnet
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron, posnet_apply
from transtacos_retunegan_tpu_torch.text import frontend
from transtacos_retunegan_tpu_torch.weights import load_flax

pytestmark = pytest.mark.usefixtures('few_threads')

JCFG, PCFG = cfg_pair()
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope='module')
def models():
    tree = tacotron_tree(JCFG, seed=4)
    return tree, load_flax(Tacotron(PCFG), tree).eval()


def _text():
    seqs = [frontend.serialize_inference(p) for p in
            ('ni3 hao3 shi4 jie4', 'zhong1 guo2')]
    n = 16
    text = np.zeros((2, n, 2), np.int32)
    for i, s in enumerate(seqs):
        text[i, :len(s)] = s
    return text, np.asarray([len(s) for s in seqs], np.int32)


def test_encoder_only_matches(models):
    tree, model = models
    text, lens = _text()
    ref = jax.jit(lambda p, t, n: JTacotron(JCFG).apply(
        {'params': p}, t, n, train=False, encoder_only=True))(
            tree, jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        out = model(torch.from_numpy(text).long(), torch.from_numpy(lens).long())
    for k in ('keys', 'values', 'mask'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(out['prds_out'].numpy(),
                                  np.asarray(ref['prds_out']))


def test_posnet_matches(models):
    tree, model = models
    mel = np.random.RandomState(5).randn(2, 20, 80).astype(np.float32)
    ref = jax.jit(lambda p, m: jposnet(p, m, JCFG))(tree, jnp.asarray(mel))
    with torch.no_grad():
        out = posnet_apply(model, torch.from_numpy(mel))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_frontend_copy_matches():
    from transtacos_retunegan_tpu.text import frontend as jfront
    for p in ('ni3 hao3 shi4 jie4', 'er2 hua4r', 'lv4 nve4', 'xx7'):
        np.testing.assert_array_equal(frontend.serialize_inference(p),
                                      jfront.serialize_inference(p))
    assert frontend.looks_like_pinyin('ni3 hao3')
    assert not frontend.looks_like_pinyin('你好')
