"""Reference RetuneGAN checkpoints on the CPU.

``interop``: for all 12 generator maps and MSD/MPD/MTD, a seeded state dict
in the reference's torch layout (built from the map entries,
``torch_port_common.reference_state_dict``) maps to the same flax tree,
key for key and bit for bit, in the port and in the JAX package, and the
port's modules consume every leaf; the imported RefineGAN_small runs the
same forward in both packages (the generator tolerance of
``test_torch_port_vocoder.py``, 1e-4).
``tools/import_reference_ckpt``: the port's ``g_``/``do_`` files load
through ``restore_generator_params``, ``restore_gan`` (fresh optimizer
states) and ``Synthesizer``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import reference_state_dict, vocoder_cfg_pair
from transtacos_retunegan_tpu import interop as jinterop
from transtacos_retunegan_tpu.models.generators import make_generator as jmake
from transtacos_retunegan_tpu_torch import interop as pinterop
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models.discriminators import Discriminators
from transtacos_retunegan_tpu_torch.models.generators import make_generator
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
from transtacos_retunegan_tpu_torch.tools import import_reference_ckpt as tool
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train.vocoder_step import init_gan_state
from transtacos_retunegan_tpu_torch.weights import flatten, load_flax

pytestmark = pytest.mark.usefixtures('few_threads')
GEN_TOL_ATOL = 1e-4        # the generator tolerance of test_torch_port_vocoder.GEN_TOL


def _cfgs(ver):
    return vocoder_cfg_pair(generator_ver=ver)


def _equal_trees(got, ref):
    got, ref = flatten(got), flatten(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg='/'.join(k))


@pytest.mark.parametrize('ver', sorted(pinterop.GENERATOR_MAPS))
def test_generator_import_matches_jax(ver):
    _, pcfg = _cfgs(ver)
    assert pinterop.GENERATOR_MAPS[ver]() == jinterop.GENERATOR_MAPS[ver]()
    module = make_generator(pcfg)
    sd = reference_state_dict(module, pinterop.GENERATOR_MAPS[ver](), seed=len(ver))
    tree = pinterop.import_generator_state_dict(sd, ver)
    _equal_trees(tree, jinterop.import_generator_state_dict(sd, ver))
    load_flax(module, tree)


def test_discriminator_import_matches_jax(tmp_path):
    _, pcfg = _cfgs('RefineGAN_small')
    hv = pcfg.vocoder
    disc = Discriminators(pcfg)
    maps = {'msd': pinterop.map_msd(hv.msd_layers), 'mpd': pinterop.map_mpd(hv.mpd_periods),
            'mtd': pinterop.map_mtd(len(hv.multi_stft_params))}
    assert maps['mtd'] == jinterop.map_mtd(len(hv.multi_stft_params))
    sds = {k: reference_state_dict(getattr(disc, k), m, seed=i)
           for i, (k, m) in enumerate(maps.items())}
    path = str(tmp_path / 'do_00000007')
    torch.save({**sds, 'steps': 7, 'epoch': 2}, path)
    got = pinterop.import_do_checkpoint(path, pcfg)
    ref = jinterop.import_do_checkpoint(path, pcfg)
    assert (got['steps'], got['epoch']) == (ref['steps'], ref['epoch']) == (7, 2)
    for k in maps:
        _equal_trees(got[k], ref[k])
    load_flax(disc, {k: got[k] for k in maps})


def test_imported_refinegan_small_forward_matches_jax():
    jcfg, pcfg = _cfgs('RefineGAN_small')
    module = make_generator(pcfg)
    sd = reference_state_dict(module, pinterop.map_refinegan_small(), seed=3)
    tree = pinterop.import_generator_state_dict(sd, 'RefineGAN_small')
    rng = np.random.RandomState(0)
    mel = rng.randn(1, 8, pcfg.audio.n_mel).astype(np.float32)
    tmpl = (0.1 * rng.randn(1, 8 * pcfg.audio.hop_length, 1)).astype(np.float32)
    ref = jax.jit(lambda p, m, t: jmake(jcfg).apply({'params': p}, m, t, train=False))(
        jax.tree.map(jnp.asarray, tree), mel, tmpl)
    with torch.no_grad():
        out = load_flax(module, tree)(torch.from_numpy(mel), torch.from_numpy(tmpl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=GEN_TOL_ATOL, rtol=0)


def _reference_run(tmp_path, pcfg, step=1234, epoch=5, with_do=True):
    """Seeded reference ``g_`` (and ``do_``) files of RefineGAN_small."""
    gen_sd = reference_state_dict(make_generator(pcfg), pinterop.map_refinegan_small(), 11)
    src = tmp_path / 'reference'
    src.mkdir()
    torch.save({'generator': gen_sd}, src / f'g_{step:08d}')
    if not with_do:
        return gen_sd, None, str(src / f'g_{step:08d}'), None
    disc = Discriminators(pcfg)
    hv = pcfg.vocoder
    do = {'msd': reference_state_dict(disc.msd, pinterop.map_msd(hv.msd_layers), 12),
          'mpd': reference_state_dict(disc.mpd, pinterop.map_mpd(hv.mpd_periods), 13),
          'mtd': reference_state_dict(disc.mtd, pinterop.map_mtd(len(hv.multi_stft_params)),
                                      14),
          'optim_g': {'state': {}, 'param_groups': []},
          'optim_d': {'state': {}, 'param_groups': []}, 'steps': step, 'epoch': epoch}
    torch.save(do, src / f'do_{step:08d}')
    return gen_sd, do, str(src / f'g_{step:08d}'), str(src / f'do_{step:08d}')


def test_import_tool_round_trip(tmp_path):
    _, pcfg = _cfgs('RefineGAN_small')
    gen_sd, do, g_path, do_path = _reference_run(tmp_path, pcfg)
    out = str(tmp_path / 'imported')
    assert tool.import_run(g_path, out, 'RefineGAN_small', do_path, pcfg) == \
        os.path.join(out, 'g_00001234')
    assert sorted(os.listdir(out)) == ['config.json', 'do_00001234', 'g_00001234']
    cfg = PortConfig.load(out)
    assert cfg.to_dict() == pcfg.to_dict()
    want = load_flax(make_generator(cfg), pinterop.import_generator_state_dict(
        gen_sd, 'RefineGAN_small')).state_dict()
    gen = ckpt.restore_generator_params(out, make_generator(cfg))
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())

    state = init_gan_state(cfg, device='cpu')
    state, epoch = ckpt.restore_gan(out, state)
    assert (state.step, epoch) == (1234, 5)
    assert state.gen_opt.state_dict()['state'] == {} == state.disc_opt.state_dict()['state']
    want_d = load_flax(Discriminators(cfg), {k: pinterop.transplant(do[k], m) for k, m in (
        ('msd', pinterop.map_msd(cfg.vocoder.msd_layers)),
        ('mpd', pinterop.map_mpd(cfg.vocoder.mpd_periods)),
        ('mtd', pinterop.map_mtd(len(cfg.vocoder.multi_stft_params))))}).state_dict()
    assert all(torch.equal(v, want_d[k]) for k, v in state.discriminators.state_dict().items())

    tree = pinterop.import_generator_state_dict(gen_sd, 'RefineGAN_small')
    served = Synthesizer(cfg, gen_params=ckpt.load_generator_params(out), devices=['cpu'],
                         max_iters=8)
    direct = Synthesizer(cfg, gen_params=tree, devices=['cpu'], max_iters=8)
    spec = np.abs(np.random.RandomState(1).randn(cfg.audio.n_freq, 16)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    theta = 2 * np.pi * torch.rand(cfg.audio.n_freq, 64, generator=gen)
    np.testing.assert_array_equal(served.vocode(spec, theta), direct.vocode(spec, theta))


def test_import_tool_generator_only(tmp_path):
    """The CLI at the default configuration (full width), ``--g`` alone."""
    _, _, g_path, _ = _reference_run(tmp_path, PortConfig(), with_do=False)
    out = str(tmp_path / 'g_only')
    tool.main(['--g', g_path, '--out', out])
    assert sorted(os.listdir(out)) == ['config.json', 'g_00001234']
    assert ckpt.restore_gan(out, init_gan_state(PortConfig.load(out), device='cpu')) == (None, -1)
