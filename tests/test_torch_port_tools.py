"""The port's evaluation metrics and user-facing tools on the CPU.

``eval/metrics.py``: every metric equals the JAX package's within 1e-6
relative on seeded signals (``pesq_wb`` is None in both without the
``pesq`` package).  ``tools/param_counts.py`` (modules on the ``meta``
device) equals the JAX tool's counts, and the reference table once the
documented weight-norm layout of transposed convs is accounted for (the
reference keeps one gain per input channel, both packages one per output
channel).  ``tools/corpus_stats.py`` gives the JAX tool's numbers, files
and CLI output on a synthetic corpus, a long- and a short-form TextGrid
and a THCHS-30 style index.  ``tools/convert_acoustic_cell.py`` turns a
stock run into a fast-cell run that resumes and decodes like the stock
run (1e-5), its Adam moments re-arranged exactly and zeroed for the
folded location block.  ``tools/serving_latency.py``: the percentiles and
the slow requests' classification of a closed-loop load, and a short load
through the batching frontend on a small CPU ``Synthesizer``.
"""

import dataclasses
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import acoustic_batch, small_cfg
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.eval import metrics as JM
from transtacos_retunegan_tpu.tools import corpus_stats as JCS
from transtacos_retunegan_tpu.tools import param_counts as JPC
from transtacos_retunegan_tpu_torch.audio import features as PF
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.eval import metrics as PM
from transtacos_retunegan_tpu_torch.models.generators import make_generator
from transtacos_retunegan_tpu_torch.models.vocoder_layers import WNConvTranspose
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
from transtacos_retunegan_tpu_torch.tools import convert_acoustic_cell as CAC
from transtacos_retunegan_tpu_torch.tools import corpus_stats as PCS
from transtacos_retunegan_tpu_torch.tools import param_counts as PPC
from transtacos_retunegan_tpu_torch.tools import serving_latency as SL
from transtacos_retunegan_tpu_torch.train import acoustic_step as A
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt

pytestmark = pytest.mark.usefixtures('few_threads')
REL = 1e-6
SR = 22050


def _pair(seed: int, seconds: float = 0.6, snr: float = 0.1):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    y = (0.5 * np.sin(2 * np.pi * 180 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
         + 0.05 * rng.randn(len(t))).astype(np.float32)
    y_hat = (y + snr * rng.randn(len(t))).astype(np.float32)[:len(t) - 37]
    return y, y_hat


def _close(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _close(got[k], ref[k])
    elif ref is None:
        assert got is None
    else:
        np.testing.assert_allclose(got, ref, rtol=REL, atol=0)


def test_metrics_match_jax(tmp_path):
    pcfg, jcfg = PortConfig(), JaxConfig()
    for seed, snr in ((0, 0.1), (1, 0.5)):
        y, y_hat = _pair(seed, snr=snr)
        _close(PM.align_lengths(y, y_hat)[1], JM.align_lengths(y, y_hat)[1])
        _close(PM.multi_stft_distance(y, y_hat, pcfg), JM.multi_stft_distance(y, y_hat, jcfg))
        _close(PM.mel_cepstral_distortion(y, y_hat, pcfg.audio),
               JM.mel_cepstral_distortion(y, y_hat, jcfg.audio))
        _close(PM.snr_db(y, y_hat), JM.snr_db(y, y_hat))
        _close(PM.pesq_wb(y, y_hat, SR), JM.pesq_wb(y, y_hat, SR))
        _close(PM.pesq_proxy(y, y_hat, SR), JM.pesq_proxy(y, y_hat, SR))
        _close(PM.pesq_proxy(y[:600], y_hat[:600], SR), JM.pesq_proxy(y[:600], y_hat[:600], SR))
        _close(PM.evaluate_pair(y, y_hat, pcfg), JM.evaluate_pair(y, y_hat, jcfg))
    _close(PM._bark_filterbank(16000, 512), JM._bark_filterbank(16000, 512))
    align = np.random.RandomState(2).rand(12, 30)
    align[np.arange(12), np.arange(12) * 2] += 3.0
    _close(PM.alignment_diagonality(align), JM.alignment_diagonality(align))
    _close(PM.prds_accuracy(np.ones((2, 5)), np.eye(2, 5), np.array([5, 3])),
           JM.prds_accuracy(np.ones((2, 5)), np.eye(2, 5), np.array([5, 3])))
    ref_dir, gen_dir = tmp_path / 'ref', tmp_path / 'gen'
    ref_dir.mkdir()
    gen_dir.mkdir()
    for i in range(2):
        y, y_hat = _pair(10 + i)
        PF.save_wav(y, str(ref_dir / f'u{i}.wav'), pcfg.audio)
        PF.save_wav(y_hat, str(gen_dir / (f'u{i}.gen.wav' if i else f'u{i}.wav')), pcfg.audio)
    _close(PM.evaluate_dirs(str(ref_dir), str(gen_dir), pcfg),
           JM.evaluate_dirs(str(ref_dir), str(gen_dir), jcfg))


def test_param_counts_match_jax_and_the_reference():
    cfg = PortConfig()
    counts = PPC.generator_counts(cfg)
    assert counts == JPC.generator_counts(JaxConfig())
    assert PPC.acoustic_count(cfg) == JPC.acoustic_count(JaxConfig()) == 10_434_907
    for name, ref in PPC.REFERENCE.items():
        c = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder,
                                                                 generator_ver=name))
        with torch.device('meta'):
            gen = make_generator(c)
        # the reference's weight_g of a ConvTranspose1d: [in, 1, 1]; ours [out]
        layout = sum(m.v.shape[0] - m.v.shape[1] for m in gen.modules()
                     if isinstance(m, WNConvTranspose))
        assert counts[name] + layout == ref, name


TEXTGRID_LONG = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 1.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.0
        intervals: size = 2
        intervals [1]:
            xmin = 0
            xmax = 0.4
            text = "ni3"
        intervals [2]:
            xmin = 0.4
            xmax = 1.0
            text = "hao3"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.0
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 0.2
            text = "n"
        intervals [2]:
            xmin = 0.2
            xmax = 0.4
            text = "i"
        intervals [3]:
            xmin = 0.4
            xmax = 1.0
            text = "h"
'''
TEXTGRID_SHORT = '''File type = "ooTextFile"
Object class = "TextGrid"

0
0.9
<exists>
2
"IntervalTier"
"words"
0
0.9
1
0
0.9
"hao3"
"IntervalTier"
"phones"
0
0.9
2
0
0.35
"h"
0.35
0.9
"ao"
'''


@pytest.fixture(scope='module')
def stats_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp('stats_corpus')
    rng = np.random.RandomState(4)
    rows = []
    speakers = ['A8', 'B8', 'A2', 'A13', 'C7', 'Z9']
    syls = ['ni3', 'hao3', 'zhong1', 'guo2', 'ren2', 'jia1', 'xie4']
    for i in range(12):
        n, t = rng.randint(2, 6), rng.randint(20, 90)
        name = f'{speakers[i % 6]}_{i}'
        rows.append(f'{name}|{"0" * (n - 1)}4|{" ".join(rng.choice(syls, n))}')
        np.save(d / f'mel-{name}.npy', rng.randn(80, t).astype(np.float32))
        np.save(d / f'f0-{name}.npy', rng.uniform(60, 420, t).astype(np.float32))
        np.save(d / f'c0-{name}.npy', rng.uniform(0, 2, t).astype(np.float32))
    (d / 'train.txt').write_text('\n'.join(rows), encoding='utf-8')
    tg = d / 'PhoneLabeling'
    tg.mkdir()
    (tg / 'a.TextGrid').write_text(TEXTGRID_LONG, encoding='utf-8')
    (tg / 'b.interval').write_text(TEXTGRID_SHORT, encoding='utf-8')
    return d


def test_corpus_stats_match_jax(stats_corpus, tmp_path, monkeypatch):
    d = str(stats_corpus)
    tg = str(stats_corpus / 'PhoneLabeling')
    assert PCS.feature_ranges(d) == JCS.feature_ranges(d)
    assert PCS.symbol_inventory(d) == JCS.symbol_inventory(d)
    assert PCS.duration_stats(d, PortConfig()) == JCS.duration_stats(d, JaxConfig())
    for f in ('a.TextGrid', 'b.interval'):
        got = PCS.read_textgrid(os.path.join(tg, f))
        assert got == JCS.read_textgrid(os.path.join(tg, f)) and set(got) == {'words', 'phones'}
    for tier in ('words', 'phones'):
        stats = PCS.textgrid_duration_stats(tg, tier)
        assert stats == JCS.textgrid_duration_stats(tg, tier)
        PCS.write_duration_csv(stats, str(tmp_path / 'p.csv'))
        JCS.write_duration_csv(stats, str(tmp_path / 'j.csv'))
        assert (tmp_path / 'p.csv').read_text() == (tmp_path / 'j.csv').read_text()
    (tmp_path / 'pv').mkdir()
    (tmp_path / 'jv').mkdir()
    assert PCS.gen_vbanks(d, str(tmp_path / 'pv')) == JCS.gen_vbanks(d, str(tmp_path / 'jv'))
    for f in os.listdir(tmp_path / 'jv'):
        assert (tmp_path / 'pv' / f).read_text() == (tmp_path / 'jv' / f).read_text()

    args = ['--data_dir', d, '--textgrid_dir', tg, '--gen_vbanks']
    monkeypatch.setattr(sys, 'argv', ['corpus_stats', *args])
    outs = []
    for main in (lambda: PCS.main(args), JCS.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main()
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1] and outs[0]['vbanks']['male'] == 4


def test_converted_run_resumes_and_decodes_like_the_stock_run(tmp_path):
    cfg = small_cfg(PortConfig, batch_size=2, frame_bucket=40)
    run, out = str(tmp_path / 'stock'), str(tmp_path / 'fast')
    state = A.init_state(cfg, 3, 'cpu')
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in acoustic_batch(cfg).items()}
    for _ in range(2):
        state, _ = A.train_step_hoisted(cfg, state, batch, None)
    ckpt.save_acoustic(run, state)
    cfg.save(run)
    CAC.main(['--run_dir', run, '--out_dir', out])
    fast_cfg = PortConfig.load(out)
    assert fast_cfg.acoustic.fast_cell and not cfg.acoustic.fast_cell
    fast = A.init_state(fast_cfg, 0, 'cpu')
    assert ckpt.restore_acoustic(out, fast) is not None and fast.step == 2

    ref = A.infer_step(cfg, state.model.eval(), batch, 8)
    got = A.infer_step(fast_cfg, fast.model.eval(), batch, 8)
    for k in ('mel_outputs', 'mag_outputs', 'stop_token_outputs', 'alignments'):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)

    stock_m = {n: state.opt.state[p] for n, p in state.model.named_parameters()}
    fast_m = {n: fast.opt.state[p] for n, p in fast.model.named_parameters()}
    assert sorted(fast_m) == sorted(n for n, _ in fast.model.named_parameters())
    cell = 'decoder_cell.'
    for m in ('exp_avg', 'exp_avg_sq'):
        gate = [stock_m[f'{cell}gru_0.{g}.weight'][m].t() for g in ('ir', 'iz', 'in')]
        assert torch.equal(fast_m[f'{cell}gru_0.wi'][m], torch.cat(gate, 1))
        assert torch.equal(fast_m[f'{cell}out_projection.bias'][m], torch.cat(
            [stock_m[f'{cell}frame_projection.bias'][m],
             stock_m[f'{cell}stop_projection.bias'][m]]))
        for k in CAC.FOLDED:
            assert not fast_m[cell + k][m].any()
        for n in stock_m:
            if not n.startswith(cell):
                assert torch.equal(fast_m[n][m], stock_m[n][m]), n
    with pytest.raises(SystemExit, match='already fast_cell'):
        CAC.convert_run(out, str(tmp_path / 'again'))


def test_serving_latency_percentiles_and_outliers():
    got = SL.percentiles([1.0, 2.0, 3.0, 4.0])
    want = {'n': 4, 'p50_ms': 2.5, 'p90_ms': 3.7, 'p95_ms': 3.85, 'p99_ms': 3.97,
            'max_ms': 4.0, 'mean_ms': 2.5}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-12)
    state = {'n': 0}

    def fast():
        time.sleep(0.005)

    def stalls():
        state['n'] += 1
        time.sleep(0.3 if state['n'] == 6 else 0.005)

    def broken():
        raise OSError('card lost')

    res = SL.run_load([fast, stalls, broken], duration_s=0.8, warmup_s=0.02)
    assert res['errors'] == ["OSError('card lost')"] and res['concurrency'] == 3
    assert res['steady_state']['max_ms'] >= 300
    slow = res['outliers_gt_3x_p50']
    assert len(slow) == 1 and slow[0]['kind'] == 'cohort_local'


def test_serving_latency_through_the_frontend():
    synth = Synthesizer(small_cfg(PortConfig), devices=['cpu'], max_iters=8)
    res = SL.measure(synth, duration_s=1.5, warmup_s=0.2, concurrency=2, frames=16,
                     max_batch=2)
    assert res['errors'] == [] and res['device'] == 'cpu'
    assert res['steady_state']['n'] >= 2 and res['config']['frames'] == [16, 16]
