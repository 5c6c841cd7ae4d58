"""The port's vocoder data and trainer CLI on the CPU.

``VocoderDataset`` items are bit-identical to the JAX package's (the same
numpy code and seeds on both sides) on a small synthetic corpus from
``tools.tone_corpus``: scratch mode (augmentation, Griffin-Lim template),
finetune mode (``mag-*.npy`` features, the template's disk cache) and the
Split u/v masks, over two passes (the second crops again).  Each package
reads its own copy of the index directory, so neither reads a template
the other cached; both take the numpy Griffin-Lim engine (the port's
``engine='numpy'``; ``tests/test_torch_port_native.py`` holds the native
engine to the JAX package).  ``VocoderLoader`` batches equal the JAX loader's, and a
worker's error surfaces in the consumer.  ``train_vocoder`` runs 2 steps
at a tiny configuration, checkpoints, resumes, exits 75 over its host
memory limit, refuses more devices than the machine has and defaults to
the card.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from transtacos_retunegan_tpu.audio import features as jF
from transtacos_retunegan_tpu.audio import transforms as jT
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.data import native as jnative
from transtacos_retunegan_tpu.data import vocoder_data as jvd
from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu_torch.audio import features as pF
from transtacos_retunegan_tpu_torch.audio import transforms as pT
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.data import vocoder_data as pvd
from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train import train_vocoder

N_TRAIN, N_TEST = 4, 2
pytestmark = pytest.mark.usefixtures('few_threads')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Wavs of 0.25-1.2 s (the segment is 8192 samples, 0.37 s: both the
    crop and the pad branch) and the acoustic preprocessor's ``mag-*.npy``
    (trimmed, aligned, ``get_specs`` of all but the last sample)."""
    base = str(tmp_path_factory.mktemp('tones'))
    au = PortConfig().audio
    lengths = write_corpus(base, au, N_TRAIN, N_TEST, seed=1, min_s=0.25, max_s=1.2)
    assert min(lengths[:N_TRAIN]) < au.segment_size < max(lengths[:N_TRAIN])
    for i in range(N_TRAIN + N_TEST):
        y = pF.load_wav(os.path.join(base, 'wavs', f'tone{i:04d}.wav'), au)
        y = pF.align_wav(pF.trim_silence(y, au), au.hop_length)
        mag, _ = pT.get_specs(y[:-1], au)
        np.save(os.path.join(base, f'mag-tone{i:04d}.npy'), mag)
    return base


def test_features_and_transforms_bit_identical(corpus, tmp_path, monkeypatch):
    """Every numpy/scipy function the dataset calls, on one utterance of
    the corpus, against the JAX package's copy: equal bits."""
    monkeypatch.setattr(jnative, 'available', lambda: False)
    ja, pa = JaxConfig().audio, PortConfig().audio
    path = os.path.join(corpus, 'wavs', 'tone0000.wav')
    y = pF.load_wav(path, pa)
    np.testing.assert_array_equal(y, jF.load_wav(path, ja))
    log_mag = pT.get_mag(y, pa)
    cases = [
        (pF.align_wav(y, 256), jF.align_wav(y, 256)),
        (pF.stft_np(y, 1024, 256, 1024), jF.stft_np(y, 1024, 256, 1024)),
        (pF.get_c0(y, pa), jF.get_c0(y, ja)), (pF.get_zcr(y, pa), jF.get_zcr(y, ja)),
        (pF.get_uv(pF.get_zcr(y, pa), pF.get_c0(y, pa)),
         jF.get_uv(jF.get_zcr(y, ja), jF.get_c0(y, ja))),
        (pF.time_stretch(y, 1.3, pa), jF.time_stretch(y, 1.3, ja)),
        (pF.pitch_shift(y, 3, pa), jF.pitch_shift(y, 3, ja)),
        (pF.trim_silence(y, pa), jF.trim_silence(y, ja)),
        (log_mag, jT.get_mag(y, ja)), (pT.get_mel(y, pa), jT.get_mel(y, ja)),
        (pT.mag_to_mel(np.exp(log_mag), pa), jT.mag_to_mel(np.exp(log_mag), ja)),
        (pT.spec_to_natural_scale(log_mag / 10, pa), jT.spec_to_natural_scale(log_mag / 10, ja)),
        (pT.get_specs(y, pa)[0], jT.get_specs(y, ja)[0]),
        (pT.inv_log_mag(log_mag, pa, length=len(y), engine='numpy'),
         jT.inv_log_mag(log_mag, ja, length=len(y))),
    ]
    # seeds that open and close each gate: 1 none, 4 pitch and gain, 6 pitch
    # only, 10 pitch by 0 semitones, 23 tempo only, 32 all three
    for seed in (1, 4, 6, 10, 23, 32):
        cases.append((pF.augment_wav(y, pa, np.random.RandomState(seed)),
                      jF.augment_wav(y, ja, np.random.RandomState(seed))))
        cases.append((pF.augment_spec(log_mag, np.random.RandomState(seed), rounds=5),
                      jF.augment_spec(log_mag, np.random.RandomState(seed), rounds=5)))
    for i, (got, ref) in enumerate(cases):
        assert got.dtype == ref.dtype, i
        np.testing.assert_array_equal(got, ref, err_msg=str(i))
    wav = str(tmp_path / 'saved.wav')
    pF.save_wav(y, wav, pa)
    np.testing.assert_array_equal(jF.load_wav(wav, ja), y)


def _copy(corpus, dst):
    shutil.copytree(corpus, dst, ignore=shutil.ignore_patterns('wavs'))
    return str(dst)


def _cfgs(generator_ver='RefineGAN_small'):
    out = []
    for config_cls in (JaxConfig, PortConfig):
        base = config_cls()
        out.append(dataclasses.replace(base, vocoder=dataclasses.replace(
            base.vocoder, generator_ver=generator_ver)))
    return out


@pytest.mark.parametrize('mode,split,ver', [
    ('scratch', 'train', 'RefineGAN_small'), ('finetune', 'train', 'RefineGAN_small'),
    ('finetune', 'test', 'RefineGAN_small'), ('scratch', 'train', 'HiFiGANSplit')])
def test_dataset_items_bit_identical(corpus, tmp_path, monkeypatch, mode, split, ver):
    monkeypatch.setattr(jnative, 'available', lambda: False)
    jcfg, pcfg = _cfgs(ver)
    finetune = mode == 'finetune'
    jds = jvd.VocoderDataset(split, _copy(corpus, tmp_path / 'jax'), jcfg, finetune=finetune)
    pds = pvd.VocoderDataset(split, _copy(corpus, tmp_path / 'port'), pcfg, finetune=finetune,
                             engine='numpy')
    assert len(pds) == len(jds) == (N_TRAIN if split == 'train' else N_TEST)
    for _ in range(2):
        for i in range(len(pds)):
            a, b = jds[i], pds[i]
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if finetune:
        cached = sorted(f for f in os.listdir(tmp_path / 'port') if f.startswith('tmpl'))
        assert len(cached) == len(pds)
        again = pvd.VocoderDataset(split, str(tmp_path / 'port'), pcfg, finetune=True,
                                   train=False, engine='numpy')
        fresh = pvd.VocoderDataset(split, _copy(corpus, tmp_path / 'fresh'), pcfg,
                                   finetune=True, train=False, engine='numpy')
        np.testing.assert_array_equal(again[0]['tmpl'], fresh[0]['tmpl'])


def test_loader_batches_match(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, 'available', lambda: False)
    jcfg, pcfg = _cfgs()
    jl = jvd.VocoderLoader(jvd.VocoderDataset('train', _copy(corpus, tmp_path / 'j'), jcfg),
                           2, num_workers=1, seed=5, num_shards=1)
    pl = pvd.VocoderLoader(pvd.VocoderDataset('train', _copy(corpus, tmp_path / 'p'), pcfg,
                                              engine='numpy'),
                           2, num_workers=1, seed=5)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == len(pl) == N_TRAIN // 2
    for a, b in zip(jb, pb):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_loader_shards_are_disjoint():
    class Items:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            return {'i': np.asarray([i])}

    shards = [list(pvd.VocoderLoader(Items(), 4, num_workers=2, seed=3, num_shards=2,
                                     shard_index=r)) for r in range(2)]
    seen = [int(x) for s in shards for b in s for x in b['i'].ravel()]
    assert len(shards[0]) == len(shards[1]) == 2
    assert len(seen) == len(set(seen)) == 8


def test_loader_surfaces_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError('disk gone')

    with pytest.raises(RuntimeError, match='VocoderLoader worker failed') as info:
        list(pvd.VocoderLoader(Broken(), 2, num_workers=2))
    assert isinstance(info.value.__cause__, OSError)


def test_device_batches_surface_a_loader_error():
    def loader():
        yield {'wav': np.zeros((2, 4), np.float32)}
        raise OSError('disk gone')

    it = train_vocoder.device_batches(loader(), torch.device('cpu'))
    assert next(it)['wav'].shape == (2, 4)
    with pytest.raises(OSError, match='disk gone'):
        next(it)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _tiny_config(tmp_path):
    base = PortConfig()
    cfg = dataclasses.replace(
        base, audio=dataclasses.replace(base.audio, segment_size=2048),
        vocoder=dataclasses.replace(
            base.vocoder, upsample_initial_channel=32, batch_size=2, num_workers=1,
            d_train_times=1, multi_stft_params=((512, 256, 60),), disc_width_mult=0.25,
            msd_layers=1, mpd_periods=(3,)))
    return cfg.save(str(tmp_path / 'cfg'))


def _args(corpus, run, cfg_path, *extra):
    return train_vocoder.parser().parse_args([
        '--data_dir', corpus, '--log_path', str(run), '--config', cfg_path,
        '--device', 'cpu', '--stdout_interval', '1', '--summary_interval', '1',
        '--checkpoint_interval', '2', '--validation_interval', '2', *extra])


def test_cli_trains_checkpoints_and_resumes(corpus, tmp_path):
    cfg_path = _tiny_config(tmp_path)
    run = tmp_path / 'run'
    train_vocoder.train(_args(corpus, run, cfg_path, '--epochs', '1'))
    files = os.listdir(run)
    assert {'g_00000002', 'do_00000002', 'config.json', 'rtg.log'} <= set(files)
    saved = torch.load(run / 'do_00000002')
    assert (saved['step'], saved['epoch']) == (2, 0)
    g2 = torch.load(run / 'g_00000002')['generator']
    train_vocoder.train(_args(corpus, run, cfg_path, '--epochs', '2'))
    log = (run / 'rtg.log').read_text()
    assert 'resumed from step 2 epoch 0' in log
    assert 'valid >> loss_mstft' in log
    assert ckpt.scan_checkpoint(str(run), 'g_').endswith('g_00000006')
    g6 = torch.load(run / 'g_00000006')['generator']
    assert any(not torch.equal(g2[k], g6[k]) for k in g2)
    assert sorted(f for f in os.listdir(run) if f.startswith('do_')) == [
        'do_00000004', 'do_00000006']
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    gen = ckpt.restore_generator_params(str(run), make_generator(Config.load(str(run))))
    assert all(torch.equal(v, g6[k]) for k, v in gen.state_dict().items())
    assert ckpt.restore_generator_params(str(tmp_path / 'empty'), gen) is None


def test_cli_exits_75_over_the_memory_limit(corpus, tmp_path):
    run = tmp_path / 'run'
    with pytest.raises(SystemExit) as info:
        train_vocoder.train(_args(corpus, run, _tiny_config(tmp_path), '--epochs', '1',
                                  '--rss_limit_gb', '0.001'))
    assert info.value.code == 75
    assert torch.load(run / 'do_00000001')['step'] == 1


def test_cli_exits_1_when_the_loss_explodes(corpus, tmp_path, monkeypatch):
    real = train_vocoder.gan_train_step

    def exploding(cfg, state, batch, noise, spe):
        state, m = real(cfg, state, batch, noise, spe)
        return state, dict(m, loss_gen_all=torch.tensor(float('inf')))
    monkeypatch.setattr(train_vocoder, 'gan_train_step', exploding)
    with pytest.raises(SystemExit) as info:
        train_vocoder.train(_args(corpus, tmp_path / 'run', _tiny_config(tmp_path),
                                  '--epochs', '1'))
    assert info.value.code == 1
    assert 'loss exploded' in (tmp_path / 'run' / 'rtg.log').read_text()


@pytest.mark.parametrize('flag,pointer,env', [
    pytest.param(['--num_devices', '2', '--device', 'cuda'], 'only 0 CUDA devices', {},
                 id='flag0'),
    pytest.param(['--num_devices', '2', '--model_parallel', '3', '--device', 'cpu'],
                 'does not divide --num_devices 2', {}, id='flag1'),
    pytest.param(['--coordinator', 'localhost:1234'], '--num_processes', {}, id='flag2'),
    pytest.param(['--num_devices', '2', '--model_parallel', '2', '--device', 'cpu'],
                 'model groups would span hosts',
                 {'RANK': '0', 'WORLD_SIZE': '2', 'LOCAL_WORLD_SIZE': '1'}, id='flag3')])
def test_cli_refuses_more_than_one_device(corpus, tmp_path, monkeypatch, flag, pointer, env):
    """More cards than the machine has (none here), a model axis that does
    not divide the devices, a coordinator without a rank, model groups
    across hosts (a launcher's rank alone on its host)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=pointer):
        train_vocoder.train(_args(corpus, tmp_path / 'run', _tiny_config(tmp_path), *flag))
    assert not (tmp_path / 'run').exists()


def test_cli_defaults_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    args = train_vocoder.parser().parse_args(['--data_dir', corpus,
                                              '--log_path', str(tmp_path / 'run')])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_vocoder.train(args)
