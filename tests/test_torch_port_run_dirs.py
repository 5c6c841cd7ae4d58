"""Run dirs on the port: the server's ``--acoustic_dir``/``--vocoder_dir``
over the port's own trainers' runs, and JAX runs carried over by the
two-step converter (``export_jax_run.py`` where JAX is, then
``tools/import_jax_run.py``), resumed by the port's steps and served.

One small configuration serves every run: ``tests/test_train_cli.py``'s
acoustic widths (B=2, frame bucket 40, 8 decode steps) and
``test_torch_port_gan_step.py``'s slim vocoder (32 generator channels, the
discriminators at width 0.25 with one scale, one period and one STFT
resolution, one discriminator update per step), with 2048-sample segments.

Tolerances: the port's own runs serve bit for bit as
``Synthesizer(acoustic_params=load_acoustic_params(run))``; ``to_flax``
round-trips bit for bit; a converted JAX state's next port step equals the
JAX package's next step at ``test_torch_port_acoustic_train.py``'s
tolerances (``_check_step``) and ``test_torch_port_gan_step.py``'s
(metrics 1e-4 relative, gradients 1e-2 of each leaf's norm against the
whole jitted JAX step, updated parameters 1e-2 x lr where the sign is
resolved); the served wav is the JAX ``Synthesizer``'s within
``test_torch_port_slice.py``'s 1e-4.  The JAX states start past Adam's
first update (two JAX steps before the export), so the step after the
import is smooth in the gradient.
"""

import dataclasses
import io
import json
import os
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import export_jax_run
import test_torch_port_acoustic_train as AT
import test_torch_port_gan_step as GT
from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (acoustic_batch, acoustic_cfg_pair, acoustic_tree,
                               exact_zero_imag_stft_ri, generator_args,
                               jax_generator_with_noise, vocoder_batch, vocoder_trees,
                               write_npy_corpus)
from transtacos_retunegan_tpu.audio import dsp as jdsp
from transtacos_retunegan_tpu.train import acoustic_step as JS
from transtacos_retunegan_tpu.train import checkpoint as jck
from transtacos_retunegan_tpu.train import vocoder_step as jvs
from transtacos_retunegan_tpu.train.schedules import noam_lr
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.models.discriminators import Discriminators
from transtacos_retunegan_tpu_torch.models.generators import GENERATORS, make_generator
from transtacos_retunegan_tpu_torch.models.layers import Draws
from transtacos_retunegan_tpu_torch.serve import app
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
from transtacos_retunegan_tpu_torch.tools import import_jax_run
from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
from transtacos_retunegan_tpu_torch.train import acoustic_step as PS
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train import train_acoustic, train_vocoder
from transtacos_retunegan_tpu_torch.train import vocoder_step as vs

pytestmark = pytest.mark.usefixtures('few_threads')
RUN_VOCODER = dict(upsample_initial_channel=32, disc_width_mult=0.25, msd_layers=1,
                   mpd_periods=(3,), multi_stft_params=((512, 256, 60),), d_train_times=1,
                   batch_size=2, num_workers=1, lr_decay=0.5)
TEXT = 'ni3 hao3 shi4 jie4'
ACOUSTIC_STEP = 4000        # the JAX states' step: past the warm-up, lr ~1e-3
SPE = 2                     # GAN steps per epoch: the third step is in epoch 1


def run_cfg_pair(**acoustic):
    """The configuration of every run here, in both packages (the decode
    without remat: it compiles faster, and remat is
    ``test_torch_port_acoustic_train.py``'s to compare)."""
    return tuple(dataclasses.replace(
        c, audio=dataclasses.replace(c.audio, segment_size=2048),
        vocoder=dataclasses.replace(c.vocoder, **RUN_VOCODER))
        for c in acoustic_cfg_pair(**{'remat_decoder': False, **acoustic}))


JCFG, PCFG = run_cfg_pair()


def _wav(body: bytes) -> np.ndarray:
    sr, wav = wavfile.read(io.BytesIO(body))
    assert sr == PCFG.audio.sample_rate and wav.dtype == np.float32
    return wav


def serve_once(monkeypatch, argv, text=TEXT, theta=None):
    """Start ``serve.app`` on the CPU with ``argv`` (one request at a time,
    the webui role on an ephemeral port) and return ``GET /synth``'s wav
    and the app's ``Synthesizer``; ``theta`` pins the request's
    Griffin-Lim phase."""
    built = []

    def capture(*a, **kw):
        built.append(Synthesizer(*a, **kw))
        return built[-1]
    monkeypatch.setattr(app, 'Synthesizer', capture)
    (server,) = app.start(app.parse_args(
        ['--device', 'cpu', '--mode', 'webui', '--port', '0', '--host', '127.0.0.1',
         '--batch_window_ms', '0', *argv]))
    try:
        if theta is not None:
            tts = built[0].tts
            monkeypatch.setattr(built[0], 'tts', lambda t: tts(t, theta=theta))
        url = (f'http://127.0.0.1:{server.server_address[1]}/synth?text='
               + urllib.request.quote(text))
        with urllib.request.urlopen(url, timeout=300) as r:
            return _wav(r.read()), built[0]
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# (a)-(c) the port's own run dirs through the server's flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def port_runs(tmp_path_factory):
    """An acoustic and a vocoder run of the port's trainers' CLIs (2 steps
    each, a checkpoint at step 2) at the small configuration."""
    base = tmp_path_factory.mktemp('port_runs')
    cfg_path = PCFG.save(str(base / 'cfg'))
    npy = base / 'npy'
    npy.mkdir()
    acoustic = base / 'acoustic'
    train_acoustic.train(train_acoustic.parser().parse_args([
        '--data_dir', write_npy_corpus(npy), '--log_path', str(acoustic),
        '--config', cfg_path, '--device', 'cpu', '--max_steps', '2',
        '--checkpoint_interval', '2', '--summary_interval', '1000']))
    tones = str(base / 'tones')
    write_corpus(tones, PCFG.audio, 4, 2, seed=1, min_s=0.25, max_s=1.2)
    vocoder = base / 'vocoder'
    train_vocoder.train(train_vocoder.parser().parse_args([
        '--data_dir', tones, '--log_path', str(vocoder), '--config', cfg_path,
        '--device', 'cpu', '--epochs', '1', '--checkpoint_interval', '2',
        '--summary_interval', '1000', '--validation_interval', '1000']))
    assert ckpt.scan_checkpoint(str(acoustic), 'ckpt_').endswith('ckpt_00000002')
    assert ckpt.scan_checkpoint(str(vocoder), 'g_').endswith('g_00000002')
    return str(acoustic), str(vocoder)


def test_cli_runs_serve_through_the_flags(port_runs, monkeypatch):
    """(a) ``--acoustic_dir``/``--vocoder_dir`` serve the newest checkpoints
    of the trainers' runs, bit for bit as the same checkpoints loaded by
    hand (the server's warm-up request comes first on both sides: it
    draws the first Griffin-Lim phase)."""
    acoustic, vocoder = port_runs
    got, synth = serve_once(monkeypatch, ['--config', acoustic, '--acoustic_dir', acoustic,
                                          '--vocoder_dir', vocoder])
    want_a, want_g = ckpt.load_acoustic_params(acoustic), ckpt.load_generator_params(vocoder)
    for module, want in ((synth.acoustic, want_a), (synth.generator, want_g)):
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items())
    ref = Synthesizer(PortConfig.load(acoustic), acoustic_params=want_a, gen_params=want_g,
                      devices=['cpu'])
    ref.tts(app.WARM_TEXT)
    want = ref.tts(TEXT)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_a_dir_without_a_checkpoint_keeps_the_seeded_weights(tmp_path):
    """(b) as the JAX ``Synthesizer``: an empty or missing dir gives the
    seeded weights."""
    (tmp_path / 'empty').mkdir()
    seeded = Synthesizer(PCFG, devices=['cpu'])
    for d in ('empty', 'missing'):
        run = str(tmp_path / d)
        assert ckpt.restore_acoustic_params(run) is None
        assert ckpt.restore_generator_params(run) is None
        synth = Synthesizer(PCFG, acoustic_dir=run, vocoder_dir=run, devices=['cpu'])
        for name in ('acoustic', 'generator'):
            want = getattr(seeded, name).state_dict()
            assert all(torch.equal(v, want[k])
                       for k, v in getattr(synth, name).state_dict().items())
    with pytest.raises(FileNotFoundError):          # the callers that ask for a file
        ckpt.load_acoustic_params(str(tmp_path / 'empty'))


@pytest.mark.parametrize('model', ['acoustic', 'vocoder'])
def test_a_dir_and_npz_for_one_model_are_refused(model, tmp_path, capsys):
    """(c) one source of weights per model, in the CLI and the constructor."""
    with pytest.raises(SystemExit):
        app.parse_args([f'--{model}_dir', str(tmp_path), f'--{model}_npz', 'w.npz'])
    assert f'--{model}_dir and --{model}_npz' in capsys.readouterr().err
    kw = ({'acoustic_params': {}, 'acoustic_dir': str(tmp_path)} if model == 'acoustic'
          else {'gen_params': {}, 'vocoder_dir': str(tmp_path)})
    with pytest.raises(ValueError, match='not both'):
        Synthesizer(PCFG, devices=['cpu'], **kw)


# ---------------------------------------------------------------------------
# (d) to_flax inverts from_flax
# ---------------------------------------------------------------------------

def _models():
    acoustic = {'stock': {}, 'fast_cell': dict(fast_cell=True),
                'cb': dict(encoder_type='cb', embed_depth=32),
                'sew': dict(decoder_sew_layer=True)}
    for name, kw in acoustic.items():
        yield pytest.param('acoustic', kw, id=f'acoustic-{name}')
    for ver in sorted(GENERATORS):
        yield pytest.param('generator', ver, id=f'generator-{ver}')
    yield pytest.param('discriminators', None, id='discriminators')


@pytest.mark.parametrize('kind,variant', list(_models()))
def test_to_flax_round_trips(kind, variant):
    """(d) ``from_flax(to_flax(sd)) == sd`` bit for bit, batch statistics
    included, for every model of the port."""
    if kind == 'acoustic':
        _, cfg = run_cfg_pair(**variant)
        module = Tacotron(cfg)
    else:
        cfg = dataclasses.replace(PCFG, vocoder=dataclasses.replace(
            PCFG.vocoder, generator_ver=variant or PCFG.vocoder.generator_ver))
        module = make_generator(cfg) if kind == 'generator' else Discriminators(cfg)
    weights.seeded_init(module, 7)
    sd = module.state_dict()
    if kind == 'acoustic' and 'encoder_type' in variant:
        stats = {k: v for k, v in sd.items() if k.endswith(('.mean', '.var'))}
        assert stats
        for i, v in enumerate(stats.values()):
            v.copy_(torch.rand(v.shape, generator=torch.Generator().manual_seed(i)) + 0.5)
    params, stats = weights.to_flax(module, sd)
    assert bool(stats) == (kind == 'acoustic' and 'encoder_type' in variant)
    back = weights.from_flax(module, params, stats)
    assert back.keys() == sd.keys()
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in sd.items())


# ---------------------------------------------------------------------------
# (e)-(g) JAX runs: export, import, resume and serve
# ---------------------------------------------------------------------------

def _counted_state(tree, jcfg, step):
    """A JAX acoustic state at ``step`` with every optax count at it, as a
    JAX run from scratch has them."""
    opt = JS.make_optimizer(jcfg).init(tree)
    count = jnp.asarray(step, jnp.int32)
    opt = (opt[0], opt[1]._replace(count=count), opt[2]._replace(count=count))
    return JS.TrainState(count, tree, opt, {})


def _convert(run_dir, base, name):
    """``export_jax_run.py`` then ``tools/import_jax_run.py``; the export
    and the port's run dir."""
    exported, port = str(base / f'{name}_exported'), str(base / f'{name}_port')
    export_jax_run.export_run(run_dir, exported)
    import_jax_run.import_run(exported, port)
    return exported, port


@pytest.fixture(scope='module')
def jax_acoustic_runs(tmp_path_factory):
    """For each decoder cell: a JAX run of two scanned 'mix' steps from
    step ACOUSTIC_STEP saved with the JAX package's ``save_acoustic``, its
    conversion, the third batch and the JAX package's third step.  The
    stock tree's stop bias is -20, so that the served decode (test (g))
    stops nowhere near the threshold."""
    base = tmp_path_factory.mktemp('jax_acoustic')
    out = {}
    for cell in ('stock', 'fast_cell'):
        jcfg, pcfg = run_cfg_pair(fast_cell=cell == 'fast_cell')
        tree = acoustic_tree(jcfg)
        if cell == 'stock':
            tree['decoder_cell']['stop_projection']['bias'][:] = -20.0
        step = AT.jax_step(jcfg, False)
        state = _counted_state(tree, jcfg, ACOUSTIC_STEP)
        batches = [AT._jnp(acoustic_batch(jcfg, seed=s)) for s in range(3)]
        keys = [jax.random.PRNGKey(20 + s) for s in range(3)]
        for b, k in zip(batches[:2], keys[:2]):
            state, _ = step(state, b, k)
        run = str(base / f'{cell}_run')
        jck.save_acoustic(run, state)
        jcfg.save(run)
        new, losses = step(state, batches[2], keys[2])
        out[cell] = (run, *_convert(run, base, cell), pcfg, acoustic_batch(jcfg, seed=2),
                     (new, losses, state.opt_state[1].mu))
    return out


def check_next_step(pcfg, state, losses, jax_step_out):
    """``test_torch_port_acoustic_train.py``'s checks of one step against
    the JAX step (``_check_step``) for a state past its first update: each
    loss term and the gradient norm within 1e-5 relative; each leaf's
    clipped gradient (the port's ``.grad``, JAX's from its first moments
    before and after the step) within 1e-4 of the larger of the leaf's
    norm and 1e-6 of the global norm; the updated parameters within 1e-2 x
    lr, every element (past the first update Adam's step is smooth in the
    gradient, so no element's update is a sign that rounding decides).
    The keys' biases of the dot attentions have a gradient that is 0 in
    exact arithmetic (a constant per query row under the softmax), so both
    packages give rounding there, and their updates follow it: their
    gradients are held to 1e-6 of the global norm, as ``chip_smoke.py``
    holds them."""
    jnew, jlosses, mu_old = jax_step_out
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    module = Tacotron(pcfg)
    b1 = pcfg.acoustic.adam_beta1
    mu_new, mu_old, ref_p = (weights.from_flax(module, jax.tree.map(np.asarray, t))
                             for t in (jnew.opt_state[1].mu, mu_old, jnew.params))
    gnorm, lr = float(jlosses['grad_norm']), float(losses['learning_rate'])
    for name, p in state.model.named_parameters():
        rg = (mu_new[name] - b1 * mu_old[name]) / (1 - b1)
        diff = float((p.grad - rg).abs().max())
        if name.endswith('.k.bias'):
            assert diff <= 1e-6 * gnorm, name
            continue
        assert diff <= 1e-4 * max(float(rg.norm()), 1e-6 * gnorm), name
        assert float((p.detach() - ref_p[name]).abs().max()) <= 1e-2 * lr, name


@pytest.mark.parametrize('cell', ['stock', 'fast_cell'])
def test_converted_acoustic_run_resumes_like_jax(jax_acoustic_runs, cell):
    """(e) the trainer's resume of the imported run, then one port step:
    the JAX package's next step, at the acoustic train-step tolerances,
    at the Noam rate of the step counter (optax's count)."""
    _, _, port_run, pcfg, batch, jax_step_out = jax_acoustic_runs[cell]
    state = PS.init_state(pcfg, 0, 'cpu')
    assert ckpt.restore_acoustic(port_run, state) is state
    assert state.step == ACOUSTIC_STEP + 2
    assert {float(s['step']) for s in state.opt.state.values()} == {ACOUSTIC_STEP + 2.0}
    state, losses = PS.train_step(pcfg, state, AT._torch(batch), Draws())
    assert float(losses['learning_rate']) == pytest.approx(
        float(noam_lr(jnp.asarray(ACOUSTIC_STEP + 2), pcfg.acoustic)), rel=1e-6)
    check_next_step(pcfg, state, losses, jax_step_out)


@pytest.fixture(scope='module')
def jax_vocoder_run(tmp_path_factory):
    """A JAX GAN run of two steps (epoch 0; the JAX step's own noise)
    saved with the JAX package's ``save_gan`` at epoch 0, its conversion,
    and the JAX package's third step (in epoch 1: the rate is halved)."""
    base = tmp_path_factory.mktemp('jax_vocoder')
    batches = [vocoder_batch(JCFG, seed=70 + s) for s in range(3)]
    gtree, dtree = vocoder_trees(JCFG, batches[0], seed=80)
    gopt, dopt = jvs.make_optimizers(JCFG, SPE)
    state = jvs.GANState(jnp.asarray(0, jnp.int32), gtree, gopt.init(gtree), dtree,
                         dopt.init(dtree))
    keys = [jax.random.PRNGKey(90 + s) for s in range(3)]
    run = str(base / 'run')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdsp, 'stft_ri', exact_zero_imag_stft_ri(jdsp.stft_ri))
        for b, k in zip(batches[:2], keys[:2]):
            state, _ = jvs.gan_train_step(JCFG, state, {n: jnp.asarray(v) for n, v in b.items()},
                                          k, SPE)
        jck.save_gan(run, state, 0)
        JCFG.save(run)
        jb = {n: jnp.asarray(v) for n, v in batches[2].items()}
        _, noise = jax_generator_with_noise(JCFG)(gtree, generator_args(JCFG, jb),
                                                  jax.random.fold_in(keys[2], 7))
        old = GT._np(state._asdict())       # the step donates its state
        new, jm = jvs.gan_train_step(JCFG, state, jb, keys[2], SPE)
    return (run, _convert(run, base, 'vocoder')[1], batches[2], [np.array(n) for n in noise],
            GT._np(new._asdict()), {k: float(v) for k, v in jm.items()}, old)


def test_converted_vocoder_run_resumes_like_jax(jax_vocoder_run):
    """(f) ``restore_gan`` of the imported run, then one port GAN step: the
    JAX package's third step, at the GAN step's tolerances; the rate of
    epoch 1 on both sides."""
    _, port_run, batch, noise, jnew, jm, jold = jax_vocoder_run
    state = vs.init_gan_state(PCFG, 0, 'cpu')
    state, epoch = ckpt.restore_gan(port_run, state)
    assert (state.step, epoch) == (2, 0)
    for opt in (state.gen_opt, state.disc_opt):
        assert {float(s['step']) for s in opt.state.values()} == {2.0}
    assert vs.learning_rate(1.0, 0.5, state.step, SPE) == 0.5
    state, m = vs.gan_train_step(PCFG, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 [torch.from_numpy(n).transpose(1, 2) for n in noise], SPE)
    assert set(m) == set(jm)
    for k, ref in jm.items():
        GT._metric_close(float(m[k]), ref, k)
    hv = PCFG.vocoder
    checked = 0
    for module, who, lr in ((state.generator, 'gen', hv.learning_rate_g * 0.5),
                            (state.discriminators, 'disc', hv.learning_rate_d * 0.5)):
        params = 'gen_params' if who == 'gen' else 'disc_params'
        mu_new, mu_old = (weights.from_flax(module, GT._adam(s[f'{who}_opt']).mu)
                          for s in (jnew, jold))
        ref_p = weights.from_flax(module, jnew[params])
        for name, p in module.named_parameters():
            ref_g = (mu_new[name] - hv.adam_b1 * mu_old[name]) / (1 - hv.adam_b1)
            diff = float((p.grad - ref_g).abs().max())
            assert diff <= 1e-2 * float(ref_g.norm()) + 1e-30, (who, name, diff)
            live = ref_g.abs() >= 1e-6 + diff
            err = (p.detach() - ref_p[name]).abs()[live]
            assert err.numel() == 0 or float(err.max()) <= 1e-2 * lr, (who, name)
            checked += int(live.sum())
    assert checked > 0


def test_converted_runs_serve_like_jax(jax_acoustic_runs, jax_vocoder_run, monkeypatch):
    """(g) the converted acoustic (stock cell) and vocoder runs served
    through the flags give the JAX ``Synthesizer(acoustic_dir=,
    vocoder_dir=)``'s wav on the JAX runs, with its request's Griffin-Lim
    phase."""
    from transtacos_retunegan_tpu.serve.pipeline import Synthesizer as JaxSynthesizer
    jax_run, _, port_run = jax_acoustic_runs['stock'][:3]
    jax_voc, port_voc = jax_vocoder_run[:2]
    jsynth = JaxSynthesizer(JCFG, acoustic_dir=jax_run, vocoder_dir=jax_voc)
    key = jax.random.fold_in(jax.random.PRNGKey(114514), 0)
    monkeypatch.setattr(jsynth, '_next_key', lambda: key)
    frames = JCFG.acoustic.max_iters * JCFG.acoustic.outputs_per_step
    theta = torch.tensor(np.asarray(2.0 * jnp.pi * jax.random.uniform(
        key, (JCFG.audio.n_freq, frames))))
    want = jsynth.tts_fused(TEXT)
    got, _ = serve_once(monkeypatch, ['--config', port_run, '--acoustic_dir', port_run,
                                      '--vocoder_dir', port_voc], theta=theta)
    assert got.shape == want.shape == (256 * frames,)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_import_refuses_a_rate_count_that_is_not_the_step(jax_acoustic_runs, tmp_path):
    """The port applies the Noam rate of its step counter: an export whose
    schedule count differs cannot resume with JAX's rate."""
    exported = str(tmp_path / 'exported')
    shutil.copytree(jax_acoustic_runs['stock'][1], exported)
    with open(os.path.join(exported, 'meta.json')) as f:
        meta = json.load(f)
    meta['lr_count'] += 1
    with open(os.path.join(exported, 'meta.json'), 'w') as f:
        json.dump(meta, f)
    with pytest.raises(SystemExit, match='schedule count'):
        import_jax_run.import_run(exported, str(tmp_path / 'port'))


def test_a_generator_alone_converts_for_serving(jax_vocoder_run, tmp_path):
    """A JAX vocoder run with a ``g_`` and no ``do_`` exports and imports
    the generator alone: a ``g_`` that serves the same weights."""
    run, port_run = jax_vocoder_run[:2]
    alone = tmp_path / 'g_only'
    shutil.copytree(run, alone, ignore=shutil.ignore_patterns('do_*'))
    _, port = _convert(str(alone), tmp_path, 'g_only')
    assert sorted(os.listdir(port)) == ['config.json', 'g_00000002']
    want = ckpt.load_generator_params(port_run)
    got = ckpt.restore_generator_params(port)
    assert got.keys() == want.keys() and all(torch.equal(v, want[k]) for k, v in got.items())
