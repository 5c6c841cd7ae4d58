"""The device-resident acoustic corpus (``data/device_data.py``) and
``train_acoustic --device_data`` on the CPU.

On a corpus of random features (both packages' ``AcousticDataset`` read
it): the corpus-wide geometry and byte count equal the JAX package's; the
index plan equals JAX's ``DeviceResidentData.plan`` for the same seed, and
per rank (23 utterances over 2 ranks: the last block wraps) each rank's
plan is its slice of JAX's ``MeshDeviceResidentData.plan`` on a 2-device
CPU mesh; the gathered batches equal JAX's bit for bit (the float16 store
included; per rank, this rank's rows, and the loss lengths are the maxima
over the ranks), and equal the streaming feeder's batch of the same
examples to float16 quantization (2e-3 relative) on the feeder's extent,
with the same loss lengths.  The train steps on a batch padded to the
corpus geometry give the masked losses of the same examples at the
feeder's geometry.  The CLI trains 3 steps with ``--device_data``, exits
when the corpus does not fit the device's budget, and refuses a run whose
ranks may be on other hosts.  (The ranks' max over a real process group:
``test_torch_port_parallel.py``.)
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import small_cfg
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.data import device_data as JDD
from transtacos_retunegan_tpu.data import feeder as JD
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.data import device_data as DD
from transtacos_retunegan_tpu_torch.data import feeder as PD
from transtacos_retunegan_tpu_torch.jax_random import prng_key
from transtacos_retunegan_tpu_torch.parallel import Shard
from transtacos_retunegan_tpu_torch.train import acoustic_step as A
from transtacos_retunegan_tpu_torch.train import train_acoustic as ta
from transtacos_retunegan_tpu_torch.weights import flax_acoustic_init

pytestmark = pytest.mark.usefixtures('few_threads')
SYLLABLES = ['ni3', 'hao3', 'shi4', 'jie4', 'zhong1', 'guo2', 'ren2', 'wo3', 'men5',
             'de5', 'jia1', 'tian1', 'qi4']
STORE_TOL = 2e-3          # float16 store, relative (the JAX package's test)


def _cfgs():
    return (small_cfg(c, batch_size=4, frame_bucket=40, text_bucket=8)
            for c in (JaxConfig, PortConfig))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """24 utterances of 2-9 syllables and 30-110 frames (``train``) and
    the first 23 of them (``odd``)."""
    d = tmp_path_factory.mktemp('npy_corpus')
    rng = np.random.RandomState(1)
    au = PortConfig().audio
    rows = []
    for i in range(24):
        n, t = rng.randint(2, 10), rng.randint(30, 111)
        rows.append(f'u{i:02d}|{"0" * (n - 1)}4|{" ".join(rng.choice(SYLLABLES, n))}')
        np.save(d / f'mel-u{i:02d}.npy', rng.randn(au.n_mel, t).astype(np.float32))
        np.save(d / f'mag-u{i:02d}.npy', rng.randn(au.n_freq, t).astype(np.float32))
        np.save(d / f'f0-u{i:02d}.npy', rng.uniform(0, 400, t).astype(np.float32))
        np.save(d / f'c0-u{i:02d}.npy', rng.uniform(0, 1, t).astype(np.float32))
    (d / 'train.txt').write_text('\n'.join(rows), encoding='utf-8')
    (d / 'odd.txt').write_text('\n'.join(rows[:23]), encoding='utf-8')
    return str(d)


def _datasets(corpus, split='train'):
    jcfg, pcfg = _cfgs()
    return (jcfg, JD.AcousticDataset(corpus, jcfg, split),
            pcfg, PD.AcousticDataset(corpus, pcfg, split))


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _assert_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_geometry_and_bytes_match_jax(corpus):
    jcfg, jds, pcfg, pds = _datasets(corpus)
    assert DD._padded_geometry(pds, pcfg) == JDD._padded_geometry(jds, jcfg)
    assert DD.corpus_nbytes(pds, pcfg) == JDD.corpus_nbytes(jds, jcfg)
    dd = DD.DeviceResidentData(pds, pcfg, 'cpu')
    assert dd.nbytes() == DD.corpus_nbytes(pds, pcfg)
    assert dd.data['mel'].dtype == torch.float16


def test_plan_and_gather_match_jax(corpus):
    jcfg, jds, pcfg, pds = _datasets(corpus)
    ref = JDD.DeviceResidentData(jds, jcfg)
    dd = DD.DeviceResidentData(pds, pcfg, 'cpu')
    jplan, pplan = ref.plan(seed=7), dd.plan(seed=7)
    for i in range(14):                    # past an epoch (6 batches of 4)
        idx = next(pplan)
        np.testing.assert_array_equal(idx, next(jplan))
        if i < 3:
            _assert_equal(_np(dd.gather(idx)), _np(ref.gather(idx)))


def test_blocks_per_rank_match_the_jax_mesh(corpus, monkeypatch):
    """Rank r's plan is rows [r*2, r*2+2) of JAX's global plan (local
    indices into block r), its gathered rows are JAX's, and the max over
    the ranks' local loss lengths is JAX's global one."""
    jcfg, jds, pcfg, pds = _datasets(corpus, 'odd')
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ('data', 'model'))
    ref = JDD.MeshDeviceResidentData(jds, jcfg, mesh)
    monkeypatch.setattr(DD.ShardedDeviceResidentData, '_global_max', lambda self, x: x)
    ranks = [DD.ShardedDeviceResidentData(pds, pcfg, Shard(r, 2), 'cpu') for r in range(2)]
    assert [dd.rows[-1] for dd in ranks] == [11, 0] and ranks[0].blk == ref.blk == 12
    assert sum(dd.nbytes() for dd in ranks) * 23 == DD.corpus_nbytes(pds, pcfg) * 24
    jplan, plans = ref.plan(seed=7), [dd.plan(seed=7) for dd in ranks]
    for i in range(8):
        jidx = next(jplan)
        idx = [next(p) for p in plans]
        np.testing.assert_array_equal(np.concatenate(idx), jidx)
        if i >= 3:
            continue
        jb = _np(ref.gather(jidx))
        got = [_np(dd.gather(ix)) for dd, ix in zip(ranks, idx)]
        for k in jb:
            if jb[k].ndim:
                np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), jb[k],
                                              err_msg=k)
            else:
                assert max(int(g[k]) for g in got) == int(jb[k]), k


def _feeder_batch(pds, pcfg, idx):
    return PD.prepare_batch([pds.load(int(i)) for i in idx], pcfg)


def test_gather_matches_the_streaming_feeder(corpus):
    _, _, pcfg, pds = _datasets(corpus)
    dd = DD.DeviceResidentData(pds, pcfg, 'cpu')
    plan = dd.plan(seed=3)
    for _ in range(3):
        idx = next(plan)
        got, ref = _np(dd.gather(idx)), _feeder_batch(pds, pcfg, idx)
        assert got['mel_targets'].shape[1] == dd.t_pad >= ref['mel_targets'].shape[1]
        for k in ref:
            a, b = got[k], ref[k]
            if a.ndim == 0:
                assert int(a) == int(b), k
                continue
            a = a[tuple(slice(0, n) for n in b.shape)]
            assert a.dtype == b.dtype, k
            np.testing.assert_allclose(a, b, rtol=0, atol=STORE_TOL * max(1.0, np.abs(b).max()),
                                       err_msg=k)
        for i, t in enumerate(got['spec_lengths']):
            assert (got['stop_token_targets'][i, t:] == 1.0).all()
            assert (got['mel_targets'][i, t:] == got['mel_targets'][i].min()).all()


@pytest.mark.parametrize('hoisted', [True, False], ids=['hoisted', 'scanned'])
def test_steps_take_the_corpus_geometry(corpus, hoisted):
    """The steps' masked losses (the L1s, stop, prosody) on a batch padded
    to the corpus geometry equal those of the same examples padded to the
    feeder's geometry (targets rounded to float16 in both), so that the
    loss lengths, not the padding, mark the batch's extent.  Without the
    'sa' encoder's fusenet: its cross-attention rows of padded text
    positions are wholly masked and spread over every padded frame, so
    with it the losses depend on the frame padding, in the JAX package as
    in the port (ROADMAP, faults)."""
    _, _, pcfg, pds = _datasets(corpus)
    pcfg = dataclasses.replace(pcfg, acoustic=dataclasses.replace(
        pcfg.acoustic, tf_method='force', encoder_fusenet=False))
    dd = DD.DeviceResidentData(pds, pcfg, 'cpu')
    idx = next(dd.plan(seed=3))
    corpus_b = dd.gather(idx)
    fed = {k: torch.from_numpy(np.asarray(v)) for k, v in
           _feeder_batch(pds, pcfg, idx).items()}
    for k in ('mel_targets', 'mag_targets', 'stop_token_targets'):
        fed[k] = fed[k].half().float()
    assert corpus_b['mel_targets'].shape[1] > fed['mel_targets'].shape[1]
    losses = []
    for batch in (corpus_b, fed):
        state = A.init_state(pcfg, 5, 'cpu')
        step = A.train_step_hoisted if hoisted else A.train_step
        _, out = step(pcfg, state, batch, None)
        losses.append(out)
    for k in ('mel_loss', 'mag_loss', 'stop_token_loss', 'prds_loss', 'sim_loss', 'reg_loss'):
        np.testing.assert_allclose(float(losses[0][k]), float(losses[1][k]), rtol=1e-5,
                                   err_msg=k)


def _args(corpus, run, cfg_dir, *extra):
    _, pcfg = _cfgs()
    return ta.parser().parse_args([
        '--data_dir', corpus, '--log_path', str(run), '--config', pcfg.save(str(cfg_dir)),
        '--device', 'cpu', '--log_interval', '1', '--summary_interval', '100',
        '--checkpoint_interval', '3', *extra])


def test_cli_trains_on_the_device_resident_corpus(corpus, tmp_path):
    run = tmp_path / 'run'
    ta.train(_args(corpus, run, tmp_path / 'cfg', '--device_data', '--max_steps', '3'))
    log = (run / 'train.log').read_text()
    assert 'device-resident corpus:' in log and 'prefetch depth' not in log
    assert log.count('step 3 [') == 1 and 'training complete at step 3' in log
    assert torch.load(run / 'ckpt_00000003', map_location='cpu')['step'] == 3


def test_cli_exits_when_the_corpus_does_not_fit(corpus, tmp_path, monkeypatch):
    _, _, pcfg, pds = _datasets(corpus)
    need = DD.corpus_nbytes(pds, pcfg)
    monkeypatch.setattr(DD, 'device_memory_bytes', lambda device: need * 16 // 9 + 16)
    assert DD.fits_in_hbm(pds, pcfg, device='cpu')
    assert not DD.fits_in_hbm(pds, pcfg, budget_bytes=need - 1)
    monkeypatch.setattr(DD, 'device_memory_bytes', lambda device: need)
    assert not DD.fits_in_hbm(pds, pcfg, device='cpu')
    with pytest.raises(SystemExit, match='over the budget'):
        ta.train(_args(corpus, tmp_path / 'run', tmp_path / 'cfg', '--device_data',
                       '--max_steps', '1'))


@pytest.mark.parametrize('env', [{}, {'RANK': '0', 'WORLD_SIZE': '4', 'LOCAL_WORLD_SIZE': '2'}],
                         ids=['coordinator', 'launcher-across-nodes'])
def test_cli_refuses_ranks_on_other_hosts(corpus, tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    extra = [] if env else ['--coordinator', 'localhost:1234', '--num_processes', '2',
                            '--process_id', '0']
    with pytest.raises(SystemExit, match='single-host'):
        ta.train(_args(corpus, tmp_path / 'run', tmp_path / 'cfg', '--device_data',
                       '--num_devices', '2', *extra))
    assert not (tmp_path / 'run').exists()


def test_seeded_model_steps_on_gathered_batches(corpus):
    """A few steps of the default train loop's choice of step on planned
    device batches: finite losses, parameters moved."""
    _, _, pcfg, pds = _datasets(corpus)
    dd = DD.DeviceResidentData(pds, pcfg, 'cpu')
    state = A.init_state(pcfg, 0, 'cpu')
    before = flax_acoustic_init(type(state.model)(pcfg), prng_key(0)).state_dict()
    for batch in zip(range(2), DD.DevicePump(dd, seed=1)):
        state, out = A.train_step_hoisted(pcfg, state, batch[1], None)
        assert np.isfinite(float(out['loss']))
    after = state.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
