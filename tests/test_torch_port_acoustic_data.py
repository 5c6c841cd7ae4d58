"""Acoustic training data and CLI: the port's copies of the JAX package's
numpy modules (YIN, the f0/c0 quantizers, the preprocessor, the synthetic
corpus, the feeder) give the same arrays and files, bit for bit, on the
same wavs and seeds; then the port's ``train_acoustic`` CLI at the tiny
configuration of ``tests/test_train_cli.py`` on the CPU: steps,
checkpoint, resume, the exits 1 and 75, the refusals, the 16-bit wire,
the profiler trace, ``--debug_nans`` and the default device.  Tolerance: exact equality
throughout (the same numpy code on the same inputs)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu.audio import features as JF
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.data import feeder as JD
from transtacos_retunegan_tpu.data import preprocess as JP
from transtacos_retunegan_tpu.tools import synth_corpus as JS
from transtacos_retunegan_tpu_torch.audio import features as PF
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.data import feeder as PD
from transtacos_retunegan_tpu_torch.data import preprocess as PP
from transtacos_retunegan_tpu_torch.data.prefetch import device_batches
from transtacos_retunegan_tpu_torch.tools import synth_corpus as PS
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train import train_acoustic as ta

pytestmark = pytest.mark.usefixtures('few_threads')
PINYINS = ['ni3 hao3 shi4 jie4', 'zhong1 guo2 ren2', 'wo3 men5 de5 jia1',
           'tian1 qi4 zhen1 hao3', 'xie4 xie4 da4 jia1', 'zai4 jian4 peng2 you3']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """``tests/test_train_cli.py``'s corpus (tones with a little noise),
    preprocessed by each package into its own directory."""
    base = tmp_path_factory.mktemp('acoustic_corpus')
    (base / 'wavs').mkdir()
    rng = np.random.RandomState(0)
    cfg = PortConfig()
    rows = []
    for i, py in enumerate(PINYINS):
        dur = 22050 // 2 + i * 1500
        t = np.arange(dur) / 22050
        y = (0.4 * np.sin(2 * np.pi * (150 + 20 * i) * t)
             + 0.01 * rng.randn(dur)).astype(np.float32)
        PF.save_wav(y, str(base / 'wavs' / f'utt{i:03d}.wav'), cfg.audio)
        n_syl = len(py.split(' '))
        rows.append(f'utt{i:03d}|{py}|{"0" * (n_syl - 1)}4')
    (base / 'metadata.csv').write_text('\n'.join(rows), encoding='utf-8')
    stats = {}
    for name, mod, config in (('port', PP, PortConfig), ('jax', JP, JaxConfig)):
        stats[name] = mod.preprocess_generic(str(base), name, str(base / 'metadata.csv'),
                                             wav_dir='wavs', num_workers=1, cfg=config())
    return base, stats


def test_yin_f0_and_quantizers_match_jax():
    cfg = PortConfig().audio
    jcfg = JaxConfig().audio
    sr = cfg.sample_rate
    t = np.arange(sr) / sr
    rng = np.random.RandomState(1)
    for y in (0.5 * np.sin(2 * np.pi * (110 + 200 * t) * t),        # a sweep
              0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(sr),
              0.1 * rng.randn(sr)):
        y = y.astype(np.float32)
        f0 = PF.get_f0(y, cfg)
        np.testing.assert_array_equal(f0, JF.get_f0(y, jcfg))
        np.testing.assert_array_equal(PF.yin(y, 60.0, 500.0, sr, 2048, 256),
                                      JF.yin(y, 60.0, 500.0, sr, 2048, 256))
        np.testing.assert_array_equal(PF.quantize_f0(f0, cfg), JF.quantize_f0(f0, jcfg))
        c0 = PF.get_c0(y, cfg)
        np.testing.assert_array_equal(PF.quantize_c0(c0, cfg), JF.quantize_c0(c0, jcfg))
    np.testing.assert_array_equal(PF.hz_to_midi([0.0, 55.0, 440.0]),
                                  JF.hz_to_midi([0.0, 55.0, 440.0]))


def test_preprocess_generic_matches_jax(corpus):
    base, stats = corpus
    assert stats['port'].keys() == stats['jax'].keys()
    for k, v in stats['jax'].items():
        assert stats['port'][k] == v, k
    port, jax_dir = base / 'port', base / 'jax'
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port)) == names
    for name in names:
        a, b = port / name, jax_dir / name
        if name.endswith('.npy'):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=name)
        elif name != 'wav_path.txt':
            assert a.read_bytes() == b.read_bytes(), name


def test_label_parsers_match_jax(tmp_path):
    (tmp_path / 'labels.txt').write_text(
        '000001\t卡尔普#2陪外孙#1玩滑梯#4。\n\tka2 er2 pu3 pei2 wai4 sun1 wan2 hua2 ti1\n'
        '000002\t假语村言#2别再#1拥抱我#4。\n\tjia2 yu3 cun1 yan2 bie2 zai4 yong1 bao4 wo3\n',
        encoding='utf-8')
    assert (PP.parse_databaker_labels(str(tmp_path / 'labels.txt'))
            == JP.parse_databaker_labels(str(tmp_path / 'labels.txt')))
    data = tmp_path / 'thchs'
    data.mkdir()
    for i, py in enumerate(PINYINS[:3]):
        (data / f'A{i}.wav').write_bytes(b'')
        (data / f'A{i}.wav.trn').write_text(f'汉字\n{py}\n', encoding='utf-8')
    assert PP.parse_thchs30_labels(str(data)) == JP.parse_thchs30_labels(str(data))


def test_dataset_and_prepare_batch_match_jax(corpus):
    base, _ = corpus
    pcfg, jcfg = PortConfig(), JaxConfig()
    pds, jds = PD.AcousticDataset(str(base / 'port'), pcfg), JD.AcousticDataset(
        str(base / 'jax'), jcfg)
    assert len(pds) == len(jds)
    for i in range(len(pds)):
        assert pds.frame_len(i) == jds.frame_len(i)
        for a, b in zip(pds.load(i), jds.load(i)):
            np.testing.assert_array_equal(a, b)
    got = PD.prepare_batch([pds.load(i) for i in (2, 0, 1)], pcfg)
    ref = JD.prepare_batch([jds.load(i) for i in (2, 0, 1)], jcfg, shuffle=False)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # padding: text 0, spectra at each row's minimum, stop 1, lengths
    assert int(got['frame_loss_len']) % 5 == 0 and got['mel_targets'].shape[1] % 80 == 0
    row = int(np.argmin(got['spec_lengths']))
    assert (got['stop_token_targets'][row, got['spec_lengths'][row]:] == 1.0).all()
    assert (got['mel_targets'][row, -1] == got['mel_targets'][row].min()).all()


def test_feeder_batches_match_jax(corpus):
    base, _ = corpus
    pcfg, jcfg = _tiny(PortConfig), _tiny(JaxConfig)
    feeders = [PD.DataFeeder(PD.AcousticDataset(str(base / 'port'), pcfg), pcfg, seed=5),
               JD.DataFeeder(JD.AcousticDataset(str(base / 'jax'), jcfg), jcfg, seed=5,
                             num_shards=1, shard_index=0)]
    for f in feeders:
        f.start()
    try:
        for _ in range(4):
            got, ref = (f.get_batch(timeout=60) for f in feeders)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    finally:
        for f in feeders:
            f.stop()


def test_synth_corpus_matches_jax(tmp_path):
    cfg, jcfg = PortConfig(), JaxConfig()
    texts = PS.sample_texts(4, np.random.RandomState(2), 3, 9)
    assert texts == JS.sample_texts(4, np.random.RandomState(2), 3, 9)
    assert (PS.speaker_profiles(3, np.random.RandomState(4))
            == JS.speaker_profiles(3, np.random.RandomState(4)))
    for text in texts[:2]:
        a, pa = PS.synth_utterance(text, cfg, np.random.RandomState(7), formant_scale=1.1)
        b, pb = JS.synth_utterance(text, jcfg, np.random.RandomState(7), formant_scale=1.1)
        np.testing.assert_array_equal(a, b)
        assert pa == pb
    data = PS.build_corpus(str(tmp_path / 'c'), cfg, n_utts=5, seed=9, num_workers=1)
    rows = (tmp_path / 'c' / 'metadata.csv').read_text().splitlines()
    assert len(rows) == 5 and os.path.exists(os.path.join(data, 'train.txt'))


def test_device_batches_narrow_float32_on_the_wire():
    batch = {'mel': np.ones((2, 3), np.float32), 'text': np.ones((2, 3), np.int32),
             'len': np.asarray(4, np.int32)}
    out = next(device_batches([batch], torch.device('cpu'), 1, torch.bfloat16))
    assert out['mel'].dtype == torch.bfloat16 and out['text'].dtype == torch.int32
    assert out['len'].shape == ()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _tiny(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, acoustic=dataclasses.replace(
            cfg.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
            attention_depth=16, prenet_depths=(32,), posnet_depth=64,
            var_embed_depth=16, var_prednet_depth=16, prdsnet_depth=16,
            posenc_depth=8, batch_size=2, frame_bucket=40))


def _args(corpus, run, tmp_path, *extra):
    base, _ = corpus
    cfg_path = _tiny(PortConfig).save(str(tmp_path / 'cfg'))
    return ta.parser().parse_args([
        '--data_dir', str(base / 'port'), '--log_path', str(run), '--config', cfg_path,
        '--device', 'cpu', '--log_interval', '1', '--summary_interval', '2',
        '--checkpoint_interval', '2', *extra])


def test_cli_trains_checkpoints_and_resumes(corpus, tmp_path):
    run = tmp_path / 'run'
    ta.train(_args(corpus, run, tmp_path, '--max_steps', '2'))
    files = set(os.listdir(run))
    assert {'ckpt_00000002', 'config.json', 'train.log', 'step-2-raw.wav',
            'step-2-gen.wav'} <= files
    saved = torch.load(run / 'ckpt_00000002')
    assert saved['step'] == 2
    assert {v['step'].item() for v in saved['opt_state']['state'].values()} == {2.0}
    ta.train(_args(corpus, run, tmp_path, '--max_steps', '4'))
    log = (run / 'train.log').read_text()
    assert 'resumed from step 2' in log and 'training complete at step 4' in log
    assert sorted(f for f in os.listdir(run) if f.startswith('ckpt_')) == ['ckpt_00000004']
    new = torch.load(run / 'ckpt_00000004')
    assert any(not torch.equal(saved['params'][k], new['params'][k]) for k in new['params'])
    assert 'Input:' in log and 'pred:' in log


def test_cli_wire_dtype_profile_and_debug_nans(corpus, tmp_path, monkeypatch):
    ta.train(_args(corpus, tmp_path / 'a', tmp_path, '--max_steps', '2', '--wire_dtype',
                   'bfloat16', '--debug_nans', '--profile_dir', str(tmp_path / 'prof'),
                   '--profile_start', '0', '--profile_steps', '1'))
    assert (tmp_path / 'prof' / 'trace.json').stat().st_size > 0
    assert 'wire dtype torch.bfloat16' in (tmp_path / 'a' / 'train.log').read_text()
    real = ta.train_step_hoisted

    def poisoned(cfg, state, batch, draws):
        state, losses = real(cfg, state, batch, draws)
        next(state.model.parameters()).grad.fill_(float('nan'))
        return state, losses
    monkeypatch.setattr(ta, 'train_step_hoisted', poisoned)
    with pytest.raises(FloatingPointError, match='E_text'):
        ta.train(_args(corpus, tmp_path / 'b', tmp_path, '--max_steps', '1', '--debug_nans'))


def test_cli_exits_75_over_the_memory_limit(corpus, tmp_path):
    run = tmp_path / 'run'
    with pytest.raises(SystemExit) as info:
        ta.train(_args(corpus, run, tmp_path, '--max_steps', '3', '--rss_limit_gb', '0.001'))
    assert info.value.code == 75
    assert torch.load(run / 'ckpt_00000001')['step'] == 1


def test_cli_exits_1_when_the_loss_explodes(corpus, tmp_path, monkeypatch):
    real = ta.train_step_hoisted

    def exploding(cfg, state, batch, draws):
        state, losses = real(cfg, state, batch, draws)
        return state, dict(losses, loss=losses['loss'] + 1e4)
    monkeypatch.setattr(ta, 'train_step_hoisted', exploding)
    with pytest.raises(SystemExit) as info:
        ta.train(_args(corpus, tmp_path / 'run', tmp_path, '--max_steps', '3'))
    assert info.value.code == 1
    assert 'loss exploded' in (tmp_path / 'run' / 'train.log').read_text()
    assert ckpt.scan_checkpoint(str(tmp_path / 'run'), 'ckpt_') is None


LAUNCHED_ALONE = {'RANK': '0', 'WORLD_SIZE': '2', 'LOCAL_WORLD_SIZE': '1'}


@pytest.mark.parametrize('flag,pointer,env', [
    pytest.param(['--num_devices', '2', '--device', 'cuda'], 'only 0 CUDA devices', {},
                 id='flag0-queue 1.7'),
    pytest.param(['--num_devices', '2', '--model_parallel', '3', '--device', 'cpu'],
                 'does not divide --num_devices 2', {}, id='flag1-queue 1.7'),
    pytest.param(['--coordinator', 'localhost:1234'], '--num_processes', {},
                 id='flag2-queue 1.7'),
    pytest.param(['--device_data', '--coordinator', 'localhost:1234', '--num_processes', '2',
                  '--process_id', '0'], 'single-host', {}, id='flag3-queue 1.8'),
    pytest.param(['--num_devices', '2', '--model_parallel', '2', '--device', 'cpu'],
                 'model groups would span hosts', LAUNCHED_ALONE, id='flag4-hosts')])
def test_cli_refuses_what_is_not_ported(corpus, tmp_path, monkeypatch, flag, pointer, env):
    """Data parallelism is ported, but not over more cards than the
    machine has (none here), nor with a coordinator and no rank; tensor
    parallelism is, but not with a model axis that does not divide the
    devices, nor with model groups across hosts (a launcher's rank alone on
    its host); the device-resident corpus (queue 1.8) is, but not for a
    run whose ranks may be on other hosts, as the JAX package refuses
    multi-host runs."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=pointer):
        ta.train(_args(corpus, tmp_path / 'run', tmp_path, *flag))
    assert not (tmp_path / 'run').exists()


def test_cli_defaults_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    base, _ = corpus
    args = ta.parser().parse_args(['--data_dir', str(base / 'port'),
                                   '--log_path', str(tmp_path / 'run')])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ta.train(args)
