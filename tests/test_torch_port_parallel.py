"""Data parallelism of the port on the CPU, in real two-process gloo groups
(``torch_port_dp.Group``, one per module, started before the first test
needs it).

* The 2-shard feeders against the JAX package's with the same
  ``num_shards``/``shard_index``: the same members, pad shapes and loss
  lengths; the ranks' batches in rank order are the one-shard batch's rows.
* Two-rank train steps, each held against the port's one-process step on
  the rank-order global batch (B=4, two rows per rank) and against the JAX
  package's step on that batch: the scanned and the hoisted acoustic step,
  the 'cb' encoder (batch norm over the global batch) and the GAN step's
  two phases.  Tolerances: against one process, every logged loss within
  1e-6 relative and every averaged gradient within 1e-5 of its leaf's norm
  (float32 sums taken per rank, then averaged; the GAN step's in float64,
  see its test); against JAX, the
  tolerances of ``test_torch_port_acoustic_train.py`` and
  ``test_torch_port_gan_step.py``.  The draws are shared with JAX as those
  files share them; a step with every stream on is held to one process,
  whose draws of the global shape each rank keeps its rows of.
* Ranks stay bitwise equal over three steps of each trainer; rank 0 alone
  writes checkpoints and both ranks resume from them.
* ``Synthesizer(devices=['cpu', 'cpu'])``: the batched surfaces bit for bit
  as one replica at the same rows per replica, each replica on its thread
  with its own folded weights; single requests on replica 0.
* The CLIs: ``--num_devices 2 --device cpu`` trains each model for 2 steps
  in the group's ranks, as a launcher would start them, and outside a
  launcher the entry point starts its ranks itself; ``--dp 2`` serves.
"""

import dataclasses
import json
import os
import pickle
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_acoustic_train as AT
import test_torch_port_gan_step as GT
import torch_port_dp as DP
from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (acoustic_batch, acoustic_cfg_pair, acoustic_tree,
                               exact_zero_imag_stft_ri, generator_args,
                               jax_generator_with_noise, small_cfg, vocoder_batch,
                               vocoder_cfg_pair, vocoder_trees, write_npy_corpus)
from transtacos_retunegan_tpu.audio import dsp as jdsp
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.data import feeder as JD
from transtacos_retunegan_tpu.data import vocoder_data as JV
from transtacos_retunegan_tpu.train import vocoder_step as jvs
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.data import feeder as PD
from transtacos_retunegan_tpu_torch.data import vocoder_data as PV
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.serve import app
from transtacos_retunegan_tpu_torch.serve import pipeline as PP
from transtacos_retunegan_tpu_torch.tools import multihost_smoke

pytestmark = pytest.mark.usefixtures('few_threads')


@pytest.fixture(scope='module')
def group():
    g = DP.Group(2)
    yield g
    g.close()


def _assert_ranks_equal(results, *keys):
    for k in keys:
        for name, v in results[0][k].items():
            np.testing.assert_array_equal(results[1][k][name], v, err_msg=f'{k} {name}')


# ---------------------------------------------------------------------------
# (a) the feeders' multi-process plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def npy_corpus(tmp_path_factory):
    """A preprocessed-corpus directory of random features (the layout both
    packages' ``AcousticDataset`` read): 24 utterances of 2-9 syllables
    and 30-110 frames."""
    return write_npy_corpus(tmp_path_factory.mktemp('npy_corpus'))


def _batches(feeder, n):
    feeder.start()
    try:
        return [feeder.get_batch(timeout=60) for _ in range(n)]
    finally:
        feeder.stop()


def test_sharded_feeder_matches_jax(npy_corpus):
    """Each rank's batches equal the JAX feeder's for that shard; the two
    ranks' batches have the global batch's shapes and loss lengths, and in
    rank order they are the one-shard batch's rows (members idxs[r::2])."""
    pcfg, jcfg = (small_cfg(c, batch_size=4, frame_bucket=40) for c in (PortConfig, JaxConfig))
    shards = []
    for r in range(2):
        got = _batches(PD.DataFeeder(PD.AcousticDataset(npy_corpus, pcfg), pcfg, seed=5,
                                     batches_per_group=2, num_shards=2, shard_index=r), 3)
        ref = _batches(JD.DataFeeder(JD.AcousticDataset(npy_corpus, jcfg), jcfg, seed=5,
                                     batches_per_group=2, num_shards=2, shard_index=r), 3)
        for g, j in zip(got, ref):
            assert g.keys() == j.keys()
            for k in j:
                np.testing.assert_array_equal(g[k], j[k], err_msg=k)
        shards.append(got)
    whole = _batches(PD.DataFeeder(PD.AcousticDataset(npy_corpus, pcfg), pcfg, seed=5,
                                   batches_per_group=2, num_shards=1, shard_index=0), 3)
    order = [0, 2, 1, 3]
    for b0, b1, w in zip(*shards, whole):
        for k in w:
            if w[k].ndim == 0:
                assert b0[k] == b1[k] == w[k], k
            else:
                np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]), w[k][order],
                                              err_msg=k)


def test_sharded_vocoder_loader_matches_jax():
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {'i': np.asarray([i]), 'x': np.full(3, i, np.float32)}

    for r in range(2):
        got = list(PV.VocoderLoader(Items(), 4, num_workers=2, seed=3, num_shards=2,
                                    shard_index=r))
        ref = list(JV.VocoderLoader(Items(), 4, num_workers=2, seed=3, num_shards=2,
                                    shard_index=r))
        assert len(got) == len(ref) == 2
        for g, j in zip(got, ref):
            assert g['i'].shape == (2, 1)
            for k in j:
                np.testing.assert_array_equal(g[k], j[k])


# ---------------------------------------------------------------------------
# (b) two-rank steps against one process and against JAX
# ---------------------------------------------------------------------------

def _global_acoustic_batch(jcfg):
    """B=4: two of the shared test batches (the same pad shapes and loss
    lengths), rows 0-1 on rank 0 and 2-3 on rank 1."""
    b0, b1 = acoustic_batch(jcfg, 0), acoustic_batch(jcfg, 1)
    return {k: (np.concatenate([b0[k], b1[k]]) if b0[k].ndim else b0[k]) for k in b0}


def _exact_zero(name, params):
    """Leaves whose gradient is 0 in exact arithmetic, so that both sides'
    are float32 rounding: the dot attentions' key biases (a constant per
    query row under the softmax) and the biases of the convs before a batch
    norm (the norm subtracts them)."""
    return name.endswith('.k.bias') or (
        name.endswith('Conv_0.bias') and name[:-len('Conv_0.bias')] + 'BatchNorm_0.scale'
        in params)


def _check_zero(name, *grads, gnorm):
    for g in grads:
        assert float(np.abs(g).max()) <= 1e-6 * gnorm, name


def _check_one_process(dp, ref):
    """Every logged loss within 1e-6 relative, every averaged gradient
    within 1e-5 of its leaf's norm (the exactly-zero ones below 1e-6 of
    the global norm on both sides), batch statistics within 1e-6."""
    for k, v in ref['losses'].items():
        np.testing.assert_allclose(dp['losses'][k], v, rtol=1e-6, atol=1e-12, err_msg=k)
    gnorm = ref['losses']['grad_norm']
    for name, g in ref['grads'].items():
        if _exact_zero(name, ref['params']):
            _check_zero(name, g, dp['grads'][name], gnorm=gnorm)
            continue
        diff = float(np.abs(dp['grads'][name] - g).max())
        assert diff <= 1e-5 * float(np.linalg.norm(g)), (name, diff)
    for name, v in ref['buffers'].items():
        np.testing.assert_allclose(dp['buffers'][name], v, rtol=1e-6, atol=1e-7, err_msg=name)


def _check_jax(pcfg, dp, jnew, jlosses):
    """``test_torch_port_acoustic_train._check_step``'s comparison:
    losses 1e-5 relative; each gradient (the JAX step's first moment / 0.1)
    within 1e-4 of the larger of its leaf's norm and 1e-6 of the global
    norm (that floor is for the key biases; the 'cb' encoder's conv
    biases before a batch norm, which that file compares in no step, are
    held below 1e-6 of the global norm on both sides); the updated
    parameters within 1e-2 x lr where the sign is resolved; the batch
    statistics 1e-5."""
    for k in jlosses:
        np.testing.assert_allclose(dp['losses'][k], float(jlosses[k]), rtol=1e-5, err_msg=k)
    module = Tacotron(pcfg)
    stats = jnew.extra_vars.get('batch_stats')
    mu = weights.from_flax(module, jax.tree.map(np.asarray, jnew.opt_state[1].mu), stats)
    newp = weights.from_flax(module, jax.tree.map(np.asarray, jnew.params), stats)
    gnorm, lr = float(jlosses['grad_norm']), dp['losses']['learning_rate']
    checked = 0
    for name, g in dp['grads'].items():
        rg = mu[name].numpy() / 0.1
        if _exact_zero(name, dp['params']) and name.endswith('Conv_0.bias'):
            _check_zero(name, g, rg, gnorm=gnorm)
            continue
        diff = float(np.abs(g - rg).max())
        assert diff <= 1e-4 * max(float(np.linalg.norm(rg)), 1e-6 * gnorm), name
        live = np.abs(rg) >= 1e-6 + diff
        err = np.abs(dp['params'][name] - newp[name].numpy())[live]
        if err.size:
            assert float(err.max()) <= 1e-2 * lr, name
            checked += int(live.sum())
    # the 'sa' model's step checks 90% of its elements; the 'cb' encoder's
    # bank of 16 convs over 4 rows leaves 12% of its elements with a
    # gradient under 1e-6, whose first update is a sign
    assert checked > 0.85 * sum(v.size for v in dp['params'].values())
    if stats is not None:
        for path, v in weights.flatten(jax.tree.map(np.asarray, stats)).items():
            np.testing.assert_allclose(dp['buffers']['.'.join(path)], v, rtol=1e-5,
                                       atol=1e-5, err_msg='/'.join(path))


ACOUSTIC_CASES = {'scanned': (dict(), False), 'hoisted': (dict(), True),
                  'cb': (dict(encoder_type='cb', embed_depth=32), False)}


@pytest.mark.parametrize('case', sorted(ACOUSTIC_CASES))
def test_acoustic_step_two_ranks(group, case):
    kw, hoisted = ACOUSTIC_CASES[case]
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4, **kw)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    batch = _global_acoustic_batch(jcfg)
    key, step = jax.random.PRNGKey(11), 4000
    keep = None
    if hoisted:
        keep = [k.numpy() for k in AT.jax_prenet_keep(jcfg, key, 8, 4)]
    state = AT._jax_state(jcfg, tree, step)
    if stats is not None:
        state = state._replace(extra_vars={'batch_stats': stats})
    jnew, jlosses = AT.jax_step(jcfg, hoisted)(state, AT._jnp(batch), key)
    args = (pcfg, tree, stats, batch, step, hoisted, keep)
    ref = DP.acoustic_step(*args)
    dp = group.run(DP.acoustic_step, *args)
    _assert_ranks_equal(dp, 'params', 'buffers')
    _check_one_process(dp[0], ref)
    _check_jax(pcfg, dp[0], jnew, jlosses)


def test_acoustic_draws_two_ranks(group):
    """Noise, dropout and the prenet masks drawn by each rank at the global
    shape (rows kept per rank): the step of one process with the same
    seeds."""
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4)
    args = (pcfg, acoustic_tree(jcfg), None, _global_acoustic_batch(jcfg), 4000, False,
            None, (5, 6, 7))
    ref = DP.acoustic_step(*args)
    assert ref['losses']['loss'] != DP.acoustic_step(*args[:-1])['losses']['loss']
    dp = group.run(DP.acoustic_step, *args)
    _assert_ranks_equal(dp, 'params')
    _check_one_process(dp[0], ref)


@pytest.fixture(scope='module')
def gan_case():
    """The JAX reference of ``test_torch_port_gan_step.py``'s RefineGAN_small
    case (B=2, one row per rank): the noise the JAX step draws, ``jax.grad`` of its
    discriminator loss at the common start, the discriminators after that
    update, and ``jax.grad`` of its generator loss against them."""
    jcfg, pcfg = vocoder_cfg_pair(**GT.SLIM, d_train_times=1)
    batch = vocoder_batch(jcfg, seed=31)
    gtree, dtree = vocoder_trees(jcfg, batch, seed=32)
    rngs = {'noise': jax.random.fold_in(jax.random.PRNGKey(33), 7)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    y_g, noise = jax_generator_with_noise(jcfg)(gtree, generator_args(jcfg, jb), rngs['noise'])
    gopt, dopt = jvs.make_optimizers(jcfg, GT.SPE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdsp, 'stft_ri', exact_zero_imag_stft_ri(jdsp.stft_ri))
        (_, d_m), g_d = jax.jit(jax.value_and_grad(
            lambda d: GT._jax_d_loss(jcfg, d, jb['wav'], y_g[..., 0]), has_aux=True))(dtree)
        new_d, _ = GT._update(dopt, g_d, dtree)
        (_, g_m), g_g = jax.jit(jax.value_and_grad(
            lambda g: GT._jax_g_loss(jcfg, g, new_d, jb, rngs), has_aux=True))(gtree)
        new_g, _ = GT._update(gopt, g_g, gtree)
    noise = [np.ascontiguousarray(np.asarray(n).transpose(0, 2, 1)) for n in noise]
    return {'pcfg': pcfg, 'args': (pcfg, gtree, dtree, batch, noise, new_d, GT.SPE),
            'metrics': {k: float(v) for k, v in {**d_m, **g_m}.items()},
            'grads': {'disc': GT._np(g_d), 'gen': GT._np(g_g)},
            'params': {'disc': new_d, 'gen': new_g}}


def test_gan_step_two_ranks(group, gan_case):
    """One discriminator update from the common start, then the generator
    update against the JAX step's updated discriminators (the phases of
    ``test_torch_port_gan_step.py``; Adam's first update is a sign), each
    over two ranks.  In float64 against one process in float64: the metrics
    within 1e-6 relative (1e-6 absolute floor: the mean scores are near 0)
    and the gradients within 1e-5 of each leaf's norm (float64, because in
    float32 the weight-norm gains and biases, which sum row contributions
    that cancel, move by up to 6.5e-4 of their norm with the summation
    order alone).  In float32 against JAX: 1e-4 (metrics), 1e-3 of each
    leaf's norm and the updated parameters within 1e-2 x lr where the sign
    is resolved."""
    args = gan_case['args']
    ref64 = DP.gan_phases(*args, torch.float64)
    dp64 = group.run(DP.gan_phases, *args, torch.float64)
    dp = group.run(DP.gan_phases, *args)
    hv = gan_case['pcfg'].vocoder
    for k, v in ref64['metrics'].items():
        GT._metric_close(dp64[0]['metrics'][k], v, k, tol=1e-6)
        GT._metric_close(dp[0]['metrics'][k], gan_case['metrics'][k], k)
    for which, module, lr in (('disc', 'discriminators', hv.learning_rate_d),
                              ('gen', 'generator', hv.learning_rate_g)):
        _assert_ranks_equal([d[which] for d in dp], 'params', 'grads')
        _assert_ranks_equal([d[which] for d in dp64], 'params', 'grads')
        for name, g in ref64[which]['grads'].items():
            diff = float(np.abs(dp64[0][which]['grads'][name] - g).max())
            assert diff <= 1e-5 * float(np.linalg.norm(g)), (which, name, diff)
        st = DP.V.init_gan_state(gan_case['pcfg'], 0, 'cpu')
        jg = weights.from_flax(getattr(st, module), gan_case['grads'][which])
        jp = weights.from_flax(getattr(st, module), gan_case['params'][which])
        for name, got in dp[0][which]['grads'].items():
            rg = jg[name].numpy()
            diff = float(np.abs(got - rg).max())
            assert diff <= GT.GRAD_TOL * float(np.linalg.norm(rg)) + 1e-30, (which, name, diff)
            live = np.abs(rg) >= 1e-6 + diff
            err = np.abs(dp[0][which]['params'][name] - jp[name].numpy())[live]
            assert err.size == 0 or float(err.max()) <= 1e-2 * lr, (which, name)


@pytest.mark.parametrize('model', ['acoustic', 'gan'])
def test_multihost_smoke_two_ranks(group, model):
    """The tool's step over the group prints the one-process loss."""
    ref = multihost_smoke.run(['--cpu', '--model', model])
    got = group.run(DP.smoke, ['--cpu', '--model', model])
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) ranks stay equal; (d) checkpoints
# ---------------------------------------------------------------------------

def test_ranks_stay_bitwise_equal(group):
    """Three acoustic steps ('cb' encoder, every stream on) and three GAN
    steps (noise from a generator): parameters, batch statistics and
    moments equal bit for bit on both ranks."""
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4, encoder_type='cb', embed_depth=32)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    batches = [_global_acoustic_batch(jcfg)] * 3
    _assert_ranks_equal(group.run(DP.acoustic_steps, pcfg, tree, stats, batches, (1, 2, 3)),
                        'params', 'buffers', 'moments')
    _, vcfg = vocoder_cfg_pair(**GT.SLIM)
    gb = [vocoder_batch(vcfg, seed=s, b=4) for s in range(3)]
    gan = group.run(DP.gan_steps, vcfg, gb, 9)
    _assert_ranks_equal(gan, 'params')
    assert gan[0]['metrics'] == gan[1]['metrics']


def test_checkpoints_written_by_rank_0_and_resumed_by_both(group, tmp_path):
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4)
    out = group.run(DP.checkpoint_round, pcfg, acoustic_tree(jcfg),
                    _global_acoustic_batch(jcfg), str(tmp_path))
    assert out[0]['writes'] == ['ckpt_00000008', 'g_00000005', 'do_00000005']
    assert out[1]['writes'] == []
    for o in out:
        assert o['step'] == 8 and o['restored_equal'] and o['moments_held']
        assert o['gan_step'] == 5 and o['epoch'] == 1
    _assert_ranks_equal(out, 'params')


# ---------------------------------------------------------------------------
# (e) serving replicas
# ---------------------------------------------------------------------------

TEXTS = ['ni3 hao3', 'wo3 men5', 'ni3 hao3 ma5', 'tian1 qi4 hao3', 'zhong1 guo2 ren2',
         'xie4 xie4 ni3', 'da4 jia1 hao3', 'zai4 jian4']


def test_synthesizer_replicas_equal_one_replica(monkeypatch):
    """Cohorts of 8 over two CPU replicas, bit for bit as one replica at 4
    rows; both replicas decode (their own folded weights, their own
    threads); a single request stays on replica 0."""
    cfg = small_cfg(PortConfig)
    two = PP.Synthesizer(cfg, devices=['cpu', 'cpu'])
    one = PP.Synthesizer(cfg, devices=['cpu'])
    calls = []
    decode = PP.fused_decode_full
    monkeypatch.setattr(PP, 'fused_decode_full', lambda fp, *a, **k: (
        calls.append((id(fp), threading.current_thread().name)), decode(fp, *a, **k))[1])

    specs = two.synthesize_spec_batch(TEXTS, rows=8)
    assert {c[0] for c in calls} == {id(r.decoder) for r in two.replicas}
    assert len({c[1] for c in calls}) == 2 and id(two.replicas[0].decoder) != id(
        two.replicas[1].decoder)
    ref = one.synthesize_spec_batch(TEXTS[:4], rows=4) + one.synthesize_spec_batch(
        TEXTS[4:], rows=4)
    for a, b in zip(specs, ref):
        np.testing.assert_array_equal(a, b)

    gens = lambda s: [s.content_generator(t.encode()) for t in TEXTS]   # noqa: E731
    wavs = two.vocode_batch(specs, gens(two), rows=8)
    g1 = gens(one)
    ref = one.vocode_batch(specs[:4], g1[:4], rows=4) + one.vocode_batch(specs[4:], g1[4:],
                                                                          rows=4)
    for a, b in zip(wavs, ref):
        np.testing.assert_array_equal(a, b)
    tts = two.tts_batch(TEXTS, generators=gens(two))
    assert [len(w) for w in tts] == [len(w) for w in wavs]

    calls.clear()
    np.testing.assert_array_equal(two.synthesize_spec(TEXTS[0]), one.synthesize_spec(TEXTS[0]))
    assert calls[0] == (id(two.replicas[0].decoder), threading.current_thread().name)


# ---------------------------------------------------------------------------
# (f) the CLIs
# ---------------------------------------------------------------------------

def test_train_acoustic_on_two_processes(group, npy_corpus, tmp_path):
    """The group's ranks as a launcher's (``RANK``/``WORLD_SIZE`` set)."""
    cfg = small_cfg(PortConfig, batch_size=4, frame_bucket=40)
    group.run(DP.cli, 'train.train_acoustic', [
        '--data_dir', npy_corpus, '--log_path', str(tmp_path / 'run'),
        '--config', cfg.save(str(tmp_path / 'cfg')), '--device', 'cpu', '--num_devices', '2',
        '--max_steps', '2', '--log_interval', '1', '--checkpoint_interval', '2',
        '--summary_interval', '1'])
    log = (tmp_path / 'run' / 'train.log').read_text()
    assert 'data parallel over 2 processes, 2 rows each' in log
    assert log.count('step 2 [') == 1 and 'training complete at step 2' in log
    assert torch.load(tmp_path / 'run' / 'ckpt_00000002', map_location='cpu')['step'] == 2


def test_device_data_blocks_on_two_processes(group, npy_corpus, tmp_path):
    """One block of the device-resident corpus per rank (23 utterances:
    the last block wraps): each rank's loss lengths are the maxima over
    the ranks, JAX's global ones on a 2-device mesh; then ``train_acoustic
    --device_data`` takes 2 steps on the two ranks."""
    from jax.sharding import Mesh
    from transtacos_retunegan_tpu.data.device_data import MeshDeviceResidentData
    pcfg, jcfg = (small_cfg(c, batch_size=4, frame_bucket=40) for c in (PortConfig, JaxConfig))
    rows = open(f'{npy_corpus}/train.txt', encoding='utf-8').read().split('\n')[:23]
    (tmp_path / 'odd.txt').write_text('\n'.join(rows), encoding='utf-8')
    for f in os.listdir(npy_corpus):
        if f.endswith('.npy'):
            os.symlink(os.path.join(npy_corpus, f), tmp_path / f)
    got = group.run(DP.device_data_lengths, pcfg, str(tmp_path), 'odd', 3)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ('data', 'model'))
    ref = MeshDeviceResidentData(JD.AcousticDataset(str(tmp_path), jcfg, 'odd'), jcfg, mesh)
    plan = ref.plan(seed=7)
    want = [(int(b['frame_loss_len']), int(b['text_loss_len']))
            for b in (ref.gather(next(plan)) for _ in range(3))]
    assert got == [want, want]
    group.run(DP.cli, 'train.train_acoustic', [
        '--data_dir', npy_corpus, '--log_path', str(tmp_path / 'run'),
        '--config', pcfg.save(str(tmp_path / 'cfg')), '--device', 'cpu', '--num_devices', '2',
        '--device_data', '--max_steps', '2', '--log_interval', '1',
        '--checkpoint_interval', '100', '--summary_interval', '100'])
    log = (tmp_path / 'run' / 'train.log').read_text()
    assert 'block 0 of 2' in log and 'training complete at step 2' in log


def test_train_vocoder_on_two_processes(group, tmp_path):
    """Rank 0 validates after every step (its eval step is local) while
    rank 1 goes on to the next step's collectives."""
    from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
    _, cfg = vocoder_cfg_pair(**GT.SLIM, batch_size=2, d_train_times=1, num_workers=1)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, segment_size=2048))
    write_corpus(str(tmp_path / 'corpus'), cfg.audio, 4, 1, seed=0, min_s=0.3, max_s=0.6)
    group.run(DP.cli, 'train.train_vocoder', [
        '--data_dir', str(tmp_path / 'corpus'), '--log_path', str(tmp_path / 'run'),
        '--config', cfg.save(str(tmp_path / 'cfg')), '--device', 'cpu', '--num_devices', '2',
        '--epochs', '1', '--stdout_interval', '1', '--checkpoint_interval', '2',
        '--validation_interval', '1', '--summary_interval', '100'])
    log = (tmp_path / 'run' / 'rtg.log').read_text()
    assert 'data parallel over 2 processes, 1 examples each' in log
    assert log.count('[2 (') == 1 and log.count('valid >>') == 2
    assert torch.load(tmp_path / 'run' / 'do_00000002', map_location='cpu')['step'] == 2


def test_one_command_starts_the_processes(tmp_path):
    """``--num_devices 2`` outside a launcher: ``start_workers`` runs the
    entry point in two spawned ranks of one group (here a stand-in that
    all-reduces its rank and then exits 3 on rank 1); a rank that fails
    stops the other, blocked in its next collective, and its exit code is
    the command's."""
    import argparse
    from transtacos_retunegan_tpu_torch.parallel import start_workers
    args = argparse.Namespace(num_devices=2, device='cpu', out=str(tmp_path))
    with pytest.raises(SystemExit) as info:
        start_workers(DP.spawned_entry, args)
    assert info.value.code == 3
    for r in range(2):
        assert (tmp_path / f'rank{r}').read_text() == f'{r} 2 cpu 1.0'
    assert not start_workers(DP.spawned_entry, argparse.Namespace(num_devices=1))


def test_shards_default_to_the_process_group(group):
    assert group.run(DP.shard_defaults) == [(2, 0, 2), (2, 1, 2)]
    assert DP.shard_defaults() == (1, 0, 4)


def test_serving_cli_with_two_replicas(tmp_path):
    small_cfg(PortConfig).save(str(tmp_path))
    servers = app.start(app.parse_args(
        ['--dp', '2', '--device', 'cpu', '--config', str(tmp_path), '--mode', 'webui',
         '--port', '0', '--host', '127.0.0.1', '--batch_window_ms', '0']))
    (server,) = servers
    try:
        port = server.server_address[1]
        body = json.dumps({'texts': TEXTS[:3]}).encode()
        req = urllib.request.Request(f'http://127.0.0.1:{port}/synth_batch', data=body,
                                     headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            wavs = pickle.loads(r.read())
        assert len(wavs) == 3 and all(len(w) > 0 for w in wavs)
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(SystemExit, match='only 0 CUDA devices'):
        app.start(app.parse_args(['--dp', '2']))
