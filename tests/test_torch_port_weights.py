"""Weight bridge: JAX-initialised flax trees load into the port's modules
with every leaf consumed and every shape matching, and anything else
raises."""

import copy

import numpy as np
import pytest

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair, jax_synthesizer, np_tree
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.models.generators import (
    GeneratorRefineGANSmall, make_generator)

pytestmark = pytest.mark.usefixtures('few_threads')

_, PCFG = cfg_pair()


@pytest.fixture(scope='module')
def trees():
    jsynth = jax_synthesizer()
    return np_tree(jsynth.acoustic_params), np_tree(jsynth.gen_params)


def test_tacotron_tree_bridges(trees):
    tree = trees[0]
    model = weights.load_flax(Tacotron(PCFG), tree)
    # every leaf landed, with the layout conversions applied
    flat = weights.flatten(tree)
    assert len(flat) == len(model.state_dict())
    dense = tree['decoder_cell']['rnn_in_proj']['kernel']
    np.testing.assert_array_equal(model.decoder_cell.rnn_in_proj.weight.detach().numpy(),
                                  dense.T)
    conv = tree['prdsnet']['conv1']['kernel']
    np.testing.assert_array_equal(model.prdsnet.conv1.weight.detach().numpy(),
                                  conv.transpose(2, 1, 0))


def test_generator_tree_bridges(trees):
    tree = trees[1]
    gen = weights.load_flax(make_generator(PCFG), tree)
    assert isinstance(gen, GeneratorRefineGANSmall)
    assert len(weights.flatten(tree)) == len(gen.state_dict())
    v = tree['WNConvTranspose_1']['v']                    # [k, in, out]
    np.testing.assert_array_equal(gen.WNConvTranspose_1.v.detach().numpy(),
                                  v.transpose(1, 2, 0))
    np.testing.assert_array_equal(gen.noise.w.detach().numpy(), tree['noise']['w'])


@pytest.mark.parametrize('fault', ['missing', 'extra', 'shape'])
def test_bridge_rejects_bad_trees(trees, fault):
    tree = copy.deepcopy(trees[1])
    if fault == 'missing':
        del tree['merge_0']['g']
    elif fault == 'extra':
        tree['merge_0']['unused'] = np.zeros(3, np.float32)
    else:
        tree['conv_fuse']['b'] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match=fault if fault != 'extra' else 'unconsumed'):
        weights.from_flax(make_generator(PCFG), tree)


def test_npz_round_trip(trees, tmp_path):
    path = str(tmp_path / 'ac.npz')
    weights.save_npz(path, trees[0])
    back = weights.load_npz(path)
    a, b = weights.flatten(trees[0]), weights.flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    weights.load_flax(Tacotron(PCFG), back)
