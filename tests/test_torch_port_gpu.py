"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one run
``python -m pytest -m gpu --noconftest tests/test_torch_port_gpu.py`` (the
repo's ``tests/conftest.py`` imports JAX, which the port does not need).
Whether a card is present is decided inside the fixture, never at import.

Tolerances: float32 weights 1e-4 absolute (six steps of float32 sums taken
in another order than PyTorch's); bf16 weights 1e-2, since both sides round
the same operands to bf16 but a different sum order can flip one rounding.
The LSA step: 1e-5 on the alignment and cum, 1e-4 on the context
(``tests/test_ops.py``'s bounds; float32 sums in another order); a row's
bits do not depend on B or on the launch (no atomics, fixed sum orders).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from transtacos_retunegan_tpu_torch.config import Config
from transtacos_retunegan_tpu_torch.models.decoder import DecoderCell
from transtacos_retunegan_tpu_torch.ops import fused_decoder as fd
from transtacos_retunegan_tpu_torch.ops import lsa_kernel as lk
from transtacos_retunegan_tpu_torch.weights import seeded_init

pytestmark = pytest.mark.gpu

B, N, STEPS = 2, 24, 6
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _cfg():
    base = Config()
    return dataclasses.replace(base, acoustic=dataclasses.replace(
        base.acoustic, decoder_depth=64, attention_depth=16, prenet_depths=(48, 32),
        decoder_layers=3, encoder_depth=32))


def _problem(device, dtype, stop_bias=-20.0, blocks=None, b=B):
    cell = seeded_init(DecoderCell(_cfg()), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            if name.endswith('bias'):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
        cell.stop_projection.bias.fill_(stop_bias)
    fp = fd.fold_params(cell.to(device), dtype, blocks=blocks)
    r = np.random.RandomState(5)
    lens = np.maximum(N - 5 * np.arange(b), 1)
    mask = (np.arange(N)[None] < lens[:, None]).astype(np.float32)
    mem = (0.3 * r.randn(b, N, 16), 0.3 * r.randn(b, N, 32) * mask[..., None], mask)
    return fp, tuple(torch.tensor(x, dtype=torch.float32, device=device) for x in mem)


def _close(got, ref, dtype):
    assert torch.equal(got['out_lengths'], ref['out_lengths'])
    for k in ('mel_outputs', 'stop_token_outputs', 'alignments'):
        assert float((got[k] - ref[k]).abs().max()) <= TOL[dtype], k


@pytest.mark.parametrize('early_exit', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_decode_full_kernel_matches_plain(cuda, dtype, early_exit):
    fp, mem = _problem(cuda, dtype)
    before = fd.LAUNCHES['decode_full']
    got = fd.fused_decode_full(fp, *mem, STEPS, early_exit=early_exit)
    assert fd.LAUNCHES['decode_full'] == before + 1
    ref = fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS, early_exit))
    _close(got, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_decode_step_kernel_matches_plain(cuda, dtype):
    """One step from a non-zero carry with one row already finished: the
    finished row still emits stop/align and holds its carry."""
    fp, mem = _problem(cuda, dtype)
    g = torch.Generator().manual_seed(6)
    d = fp.dims
    rnd = lambda *s: torch.randn(*s, generator=g).to(cuda)      # noqa: E731
    prev, ctx, cum = rnd(B, d.n_mel), rnd(B, d.d), rnd(B, N).abs()
    hs = tuple(rnd(B, d.h) for _ in range(d.n_gru))
    fin = torch.tensor([[0.0], [1.0]], device=cuda)
    before = fd.LAUNCHES['decode_step']
    (outs, hs_k) = fd.decode_step(fp, prev, ctx, hs, cum, *mem, fin)
    assert fd.LAUNCHES['decode_step'] == before + 1
    (refs, hs_p) = fd.decode_step_plain(fp, prev, ctx, hs, cum, *mem, fin)
    for a, b in zip(outs + hs_k, refs + hs_p):
        assert float((a - b).abs().max()) <= TOL[dtype]


def test_step_path_launches_once_per_step(cuda, monkeypatch):
    fp, mem = _problem(cuda, torch.float32)
    monkeypatch.setattr(fd, 'SMEM_BUDGET_BYTES', 0)
    before = dict(fd.LAUNCHES)
    got = fd.fused_decode_full(fp, *mem, STEPS, early_exit=True)
    assert fd.LAUNCHES['decode_step'] == before['decode_step'] + STEPS
    assert fd.LAUNCHES['decode_full'] == before['decode_full']
    _close(got, fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS)), torch.float32)


def test_early_exit_after_stops(cuda):
    fp, mem = _problem(cuda, torch.float32, stop_bias=0.0)
    ref = fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS, True))
    _close(fd.fused_decode_full(fp, *mem, STEPS, early_exit=True), ref, torch.float32)


def test_wrapper_rejects_bad_operands(cuda):
    fp, (keys, values, mask) = _problem(cuda, torch.float32)
    with pytest.raises(ValueError, match='contiguous'):
        fd.decode_full(fp, keys.transpose(0, 1).contiguous().transpose(0, 1),
                       values, mask, STEPS)
    with pytest.raises(ValueError, match='shape'):
        fd.decode_full(fp, keys[:, :, :8].contiguous(), values, mask, STEPS)
    prev, ctx, hs, cum, fin = fd._zero_carry(fp, B, N, cuda)
    with pytest.raises(ValueError, match='prev has shape'):
        fd.decode_step(fp, prev[:, :8].contiguous(), ctx, hs, cum, keys, values,
                       mask, fin)
    with pytest.raises(ValueError, match='GRU states'):
        fd.decode_step(fp, prev, ctx, hs[:1], cum, keys, values, mask, fin)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_decode_full_grid_of_all_sms_reports_its_size(cuda, dtype):
    """One block per SM, so G > B; at these widths most blocks own no
    column of several matrices (wq has 16 columns for 132 blocks)."""
    fp, mem = _problem(cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fp.blocks == sms > B
    empty = sum(not list(dict((k, c) for k, c, _ in fd._slice(fp.dims, g, fp.blocks)[0])['wq'])
                for g in range(fp.blocks))
    assert empty == fp.blocks - fp.dims.a
    got = fd.fused_decode_full(fp, *mem, STEPS, early_exit=True)
    assert fd.LAST_GRID['decode_full'] == sms
    _close(got, fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS, True)), dtype)


@pytest.mark.parametrize('blocks', [3, 7])
def test_kernels_on_a_grid_that_does_not_divide_the_widths(cuda, blocks):
    fp, mem = _problem(cuda, torch.bfloat16, blocks=blocks)
    got = fd.fused_decode_full(fp, *mem, STEPS)
    assert fd.LAST_GRID['decode_full'] == blocks
    ref = fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS))
    _close(got, ref, torch.bfloat16)
    _close(fd.fused_decode(fp, *mem, STEPS), ref, torch.bfloat16)
    assert fd.LAST_GRID['decode_step'] == blocks


def test_batch_invariance_bf16(cuda):
    """A row decoded in a batch of 8 is bit-identical to the same row
    decoded alone, by both kernels (no atomics; each sum is taken by the
    same lanes in the same order whatever B is)."""
    b = 8
    fp, mem = _problem(cuda, torch.bfloat16, stop_bias=0.0, b=b)
    full = fd.decode_full(fp, *mem, STEPS, early_exit=True)
    g = torch.Generator().manual_seed(8)
    d = fp.dims
    rnd = lambda *s: torch.randn(*s, generator=g).to(cuda)      # noqa: E731
    carry = (rnd(b, d.n_mel), rnd(b, d.d), tuple(rnd(b, d.h) for _ in range(d.n_gru)),
             rnd(b, N).abs(), (torch.arange(b, device=cuda) % 3 == 0).float()[:, None])
    prev, ctx, hs, cum, fin = carry
    step = fd.decode_step(fp, prev, ctx, hs, cum, *mem, fin)
    for i in range(b):
        row = lambda x: x[i:i + 1].contiguous()                  # noqa: E731
        alone = fd.decode_full(fp, *map(row, mem), STEPS, early_exit=True)
        assert all(torch.equal(a[:, 0], f[:, i]) for a, f in zip(alone, full)), i
        outs, hs1 = fd.decode_step(fp, row(prev), row(ctx), tuple(map(row, hs)), row(cum),
                                   *map(row, mem), row(fin))
        assert all(torch.equal(a[0], f[i]) for a, f in zip(outs + hs1, step[0] + step[1])), i


def _small_cfg():
    base = Config()
    return dataclasses.replace(
        base, acoustic=dataclasses.replace(
            base.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
            attention_depth=16, prenet_depths=(32,), posnet_depth=64,
            var_embed_depth=16, var_prednet_depth=16, prdsnet_depth=16,
            posenc_depth=8, max_iters=8),
        vocoder=dataclasses.replace(base.vocoder, upsample_initial_channel=64))


def test_synthesizer_on_the_card(cuda):
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    synth = Synthesizer(_small_cfg())
    before = fd.LAUNCHES['decode_full']
    wav = synth.tts_fused('ni3 hao3')
    assert fd.LAUNCHES['decode_full'] == before + 1
    assert wav.dtype == np.float32 and len(wav) > 0 and np.isfinite(wav).all()


def _lsa_inputs(device, b, n, a, d, kwin, lens, seed=0):
    r = np.random.RandomState(seed)
    mask = (np.arange(n)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    xs = (r.randn(b, a), np.abs(r.randn(b, n)), 0.1 * r.randn(b, n, a), r.randn(b, n, d),
          mask, 0.05 * r.randn(kwin, a), 0.1 * r.randn(a), 0.01 * r.randn(a))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in xs]


@pytest.mark.parametrize('shape', [(4, 128, 128, 256, 31, [128, 70, 3, 0]),
                                   (8, 64, 128, 256, 31, [64, 60, 50, 40, 30, 20, 9, 1]),
                                   (1, 16, 128, 256, 5, [16])],
                         ids=['B4-N128-k31', 'B8-N64-k31', 'B1-N16-k5'])
def test_lsa_step_kernel_matches_plain(cuda, shape):
    *dims, lens = shape
    args = _lsa_inputs(cuda, *dims, lens)
    before = lk.LAUNCHES['lsa_step']
    got = lk.lsa_step_fused(*args)
    assert lk.LAUNCHES['lsa_step'] == before + 1
    ref = lk.lsa_step_plain(*args)
    for g, r, tol in zip(got, ref, (1e-5, 1e-5, 1e-4)):
        assert float((g - r).abs().max()) <= tol
    if lens[-1] == 0:
        assert float(got[0][-1].abs().max()) == 0.0 and float(got[2][-1].abs().max()) == 0.0


LSA_CLUSTER = [(1, 1, 31), (1, 17, 31), (8, 64, 31), (8, 64, 5), (4, 128, 63), (8, 256, 31)]


def _cluster_lens(b, n):
    """Full rows; for B > 1 the second row ends inside the first CTA's tile
    and the third, for B > 2, is all masked."""
    lens = [n] * b
    if b > 1:
        lens[1] = max(1, lk.lsa_plan(n)[1] // 2)
    if b > 2:
        lens[2] = 0
    return lens


@pytest.mark.parametrize('b,n,kwin', LSA_CLUSTER, ids=lambda x: str(x))
def test_lsa_cluster_kernel_matches_plain(cuda, b, n, kwin):
    """One cluster of C CTAs per row against the plain version: full rows,
    a row whose other CTAs see only masked positions, an all-masked row
    (zeros); two launches give the same bits."""
    lens = _cluster_lens(b, n)
    args = _lsa_inputs(cuda, b, n, 128, 256, kwin, lens, seed=n + kwin)
    before = lk.LAUNCHES['lsa_step']
    got = lk.lsa_step_fused(*args)
    assert lk.LAUNCHES['lsa_step'] == before + 1
    again = lk.lsa_step_fused(*args)
    assert lk.LAUNCHES['lsa_step'] == before + 2
    ref = lk.lsa_step_plain(*args)
    for g, r, tol in zip(got, ref, (1e-5, 1e-5, 1e-4)):
        assert float((g - r).abs().max()) <= tol
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for i, ln in enumerate(lens):
        if ln == 0:
            assert not got[0][i].any() and not got[2][i].any()
        else:
            assert not got[0][i, ln:].any()


@pytest.mark.parametrize('n', [64, 256])
def test_lsa_rows_at_b8_bit_identical_to_b1(cuda, n):
    args = _lsa_inputs(cuda, 8, n, 128, 256, 31, _cluster_lens(8, n), seed=n)
    got = lk.lsa_step_fused(*args)
    for i in range(8):
        alone = lk.lsa_step_fused(*(x[i:i + 1].contiguous() if k < 5 else x
                                    for k, x in enumerate(args)))
        assert all(torch.equal(a[0], g[i]) for a, g in zip(alone, got)), i


def test_lsa_plan_mirrors_the_kernel_and_the_floor_launches(cuda):
    lib, c, p = lk._lib(), ctypes.c_int(), ctypes.c_int()
    for n in range(1, 513):
        lib.lsa_plan(n, ctypes.byref(c), ctypes.byref(p))
        assert (c.value, p.value) == lk.lsa_plan(n), n
    before = lk.LAUNCHES['lsa_step']
    lk.lsa_floor(8, 64, 128, 256, 31, cuda)
    torch.cuda.synchronize()
    assert lk.LAUNCHES['lsa_step'] == before


def test_lsa_wrapper_rejects_bad_operands(cuda):
    args = _lsa_inputs(cuda, 2, 16, 16, 32, 31, [16, 8])
    for i, bad, match in ((2, args[2][:, :, :8].contiguous(), 'shape'),
                          (0, args[0].double(), 'float32'),
                          (5, args[5][:4].contiguous(), 'odd'), (1, args[1].cpu(), 'device')):
        with pytest.raises(ValueError, match=match):
            lk.lsa_step_fused(*args[:i], bad, *args[i + 1:])


def test_spec_batch_on_the_card_matches_the_cpu(cuda):
    """``synthesize_spec_batch`` at B=4 (float32 decoder weights) on the card
    against the same synthesizer on the CPU, every row decoding all steps:
    one ``decode_full`` launch, specs within 1e-3 relative and 1e-4
    absolute (float32 sums in another order, exponentiated by the natural
    scale)."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    texts = ['ni3 hao3 shi4 jie4', 'da4 jia1 hao3', 'zhong1 guo2', 'a1']
    specs = []
    for device in (cuda, 'cpu'):
        synth = Synthesizer(_small_cfg(), devices=[device])
        synth.acoustic.decoder_cell.stop_projection.bias.fill_(-20.0)   # no stop
        synth.decoder = fd.fold_params(synth.acoustic.decoder_cell, torch.float32)
        before = fd.LAUNCHES['decode_full']
        specs.append(synth.synthesize_spec_batch(texts))
        assert fd.LAUNCHES['decode_full'] == before + (device == cuda)
    for g, r in zip(*specs):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# vocoder training on the card (no kernel of the repo: cuDNN convolutions)
# ---------------------------------------------------------------------------

def _vocoder_cfg(**vocoder):
    """The CPU tests' small vocoder: 2048-sample segments, B=2, 32 initial
    generator channels, slim discriminators, one STFT resolution."""
    base = Config()
    return dataclasses.replace(
        base, audio=dataclasses.replace(base.audio, segment_size=2048),
        vocoder=dataclasses.replace(
            base.vocoder, **{**dict(upsample_initial_channel=32, batch_size=2, num_workers=1,
                                    disc_width_mult=0.25, msd_layers=1, mpd_periods=(3,),
                                    multi_stft_params=((512, 256, 60),)), **vocoder}))


def _vocoder_batch(cfg, seed=0, b=2):
    r = np.random.RandomState(seed)
    seg, hop = cfg.audio.segment_size, cfg.audio.hop_length
    mel = r.randn(b, seg // hop, cfg.audio.n_mel).astype(np.float32)
    tmpl = (0.1 * r.randn(b, seg)).astype(np.float32)
    uv = (np.repeat(r.rand(b, seg // hop), hop, 1) > 0.5).astype(np.float32)
    return {'mel': mel, 'tmpl': tmpl, 'wav': (0.1 * r.randn(b, seg)).astype(np.float32),
            'mel_c': mel, 'mel_v': mel[:, ::-1].copy(), 'tmpl_c': tmpl * uv,
            'tmpl_v': tmpl * (1 - uv), 'uv': uv}


@pytest.mark.parametrize('ver', ['HiFiGAN', 'HiFiGANRetune', 'HiFiGANSplit', 'HiFiGAN_micro',
                                 'HiFiGAN_mini', 'HiFiGAN_mu', 'MelGAN', 'MelGANRetune',
                                 'MelGANSplit', 'RefineGAN', 'RefineGAN_small', 'RetuneCNN'])
def test_generator_on_the_card_matches_the_cpu(cuda, ver):
    """Each generator's inference and training forwards (the same noise)
    on the card against the CPU, float32: 1e-4 on outputs in (-1, 1)."""
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    from transtacos_retunegan_tpu_torch.train.vocoder_step import apply_generator
    cfg = _vocoder_cfg(generator_ver=ver)
    gen = seeded_init(make_generator(cfg), 7)
    batch = {k: torch.from_numpy(v) for k, v in _vocoder_batch(cfg).items()}
    noise = [torch.rand(s, generator=torch.Generator().manual_seed(i))
             for i, s in enumerate(_noise_shapes(cfg, gen, batch))]
    with torch.no_grad():
        ref = [apply_generator(cfg, gen, batch), apply_generator(cfg, gen, batch, list(noise))]
        gen.to(cuda)
        gpu_b = {k: v.to(cuda) for k, v in batch.items()}
        got = [apply_generator(cfg, gen, gpu_b),
               apply_generator(cfg, gen, gpu_b, [n.to(cuda) for n in noise])]
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 2048)
        assert float((g.cpu() - r).abs().max()) <= 1e-4


def _noise_shapes(cfg, gen, batch):
    from transtacos_retunegan_tpu_torch.models.vocoder_layers import LearnedGaussianNoise
    from transtacos_retunegan_tpu_torch.train.vocoder_step import apply_generator
    shapes = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: shapes.append(args[0].shape))
             for m in gen.modules() if isinstance(m, LearnedGaussianNoise)]
    with torch.no_grad():
        apply_generator(cfg, gen, batch)
    for h in hooks:
        h.remove()
    return shapes


def test_gan_step_on_the_card_matches_the_cpu(cuda):
    """One GAN step from the same seeded weights, batch and noise, as
    ``tests/test_torch_port_gan_step.py`` holds the port to the JAX
    package: the whole step's metrics within 1e-3 relative; one
    discriminator update from the common start and the generator update
    against the CPU's updated discriminators, each leaf's gradient within
    1e-2 of its norm (cuDNN's float32 algorithms against the CPU's, summed
    over every position with cancellation: 2.4e-3 measured on the
    generator's template conv) and the updated parameters within 1e-2 x lr
    where the gradient exceeds 1e-6 plus the leaf's largest difference."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    cfg = _vocoder_cfg()
    cpu_b = {k: torch.from_numpy(v) for k, v in _vocoder_batch(cfg, 1).items()
             if k in ('mel', 'tmpl', 'wav')}
    gpu_b = {k: v.to(cuda) for k, v in cpu_b.items()}
    cpu, gpu = vs.init_gan_state(cfg, 3, 'cpu'), vs.init_gan_state(cfg, 3, cuda)
    noise = [torch.rand(s, generator=torch.Generator().manual_seed(i))
             for i, s in enumerate(_noise_shapes(cfg, cpu.generator, cpu_b))]
    _, m_cpu = vs.gan_train_step(cfg, cpu, cpu_b, list(noise), 4)
    _, m_gpu = vs.gan_train_step(cfg, gpu, gpu_b, [n.to(cuda) for n in noise], 4)
    for k in m_cpu:
        assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-3 * abs(float(m_cpu[k])) + 1e-6, k

    cfg1 = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder, d_train_times=1))
    out, cpu_d = {}, None
    for where, b, nz in (('cpu', cpu_b, noise), ('gpu', gpu_b, [n.to(cuda) for n in noise])):
        st = vs.init_gan_state(cfg1, 3, b['wav'].device)
        y_g = vs.apply_generator(cfg1, st.generator, b, nz)
        vs.discriminator_phase(cfg1, st, b['wav'], y_g.detach(), 4)
        d = {n: (p.detach().cpu().clone(), p.grad.cpu().clone())
             for n, p in st.discriminators.named_parameters()}
        if where == 'cpu':
            cpu_d = st.discriminators.state_dict()
        else:
            st.discriminators.load_state_dict(cpu_d)
        vs.generator_phase(cfg1, st, b['wav'], y_g, 4)
        g = {n: (p.detach().cpu(), p.grad.cpu()) for n, p in st.generator.named_parameters()}
        out[where] = {'disc': d, 'gen': g}
    hv = cfg.vocoder
    for part, lr in (('disc', hv.learning_rate_d), ('gen', hv.learning_rate_g)):
        for name, (p_ref, g_ref) in out['cpu'][part].items():
            p, g = out['gpu'][part][name]
            diff = float((g - g_ref).abs().max())
            assert diff <= 1e-2 * float(g_ref.norm()) + 1e-30, (part, name, diff)
            live = g_ref.abs() >= 1e-6 + diff
            err = (p - p_ref).abs()[live]
            assert err.numel() == 0 or float(err.max()) <= 1e-2 * lr, (part, name)


def test_train_vocoder_on_the_card(cuda, tmp_path):
    """``train_vocoder`` (default ``--device cuda``) for 2 steps on a tone
    corpus at the small configuration: a checkpoint at step 2."""
    from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
    from transtacos_retunegan_tpu_torch.train import train_vocoder
    cfg = _vocoder_cfg()
    write_corpus(str(tmp_path / 'corpus'), cfg.audio, 4, 1, seed=0, min_s=0.3, max_s=1.0)
    train_vocoder.main(['--data_dir', str(tmp_path / 'corpus'), '--log_path',
                        str(tmp_path / 'run'), '--config', cfg.save(str(tmp_path / 'cfg')),
                        '--epochs', '1', '--stdout_interval', '1', '--checkpoint_interval', '2',
                        '--validation_interval', '2'])
    saved = torch.load(tmp_path / 'run' / 'do_00000002', map_location='cpu')
    assert saved['step'] == 2
    assert all(v.is_cuda for v in torch.load(tmp_path / 'run' / 'g_00000002')
               ['generator'].values())


# ---------------------------------------------------------------------------
# acoustic training and the fused-layout cell
# ---------------------------------------------------------------------------

def _acoustic_cfg():
    base = Config()
    return dataclasses.replace(base, acoustic=dataclasses.replace(
        base.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
        attention_depth=16, prenet_depths=(32,), posnet_depth=64, var_embed_depth=16,
        var_prednet_depth=16, prdsnet_depth=16, posenc_depth=8, batch_size=4,
        frame_bucket=40))


@pytest.mark.parametrize('step', ['hoisted', 'scanned'])
def test_acoustic_step_on_the_card_matches_the_cpu(cuda, step):
    """One acoustic train step from the same seeded weights, batch and
    prenet masks (noise off) on the card and on the CPU: every loss within
    1e-4 relative, each leaf's gradient within 1e-3 of the larger of its
    norm and 1e-6 of the global norm (the attention keys' biases have a
    gradient that is 0 in exact arithmetic)."""
    from transtacos_retunegan_tpu_torch.models.layers import Draws, keep_mask
    from transtacos_retunegan_tpu_torch.tools.acoustic_step_profile import seeded_batch
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    cfg = _acoustic_cfg()
    batch = seeded_batch(cfg, 4, 60, 16, seed=2, device='cpu')
    s = batch['mel_targets'].shape[1] // cfg.acoustic.outputs_per_step
    keep = [keep_mask((s, 4, w), 0.5, torch.Generator().manual_seed(1), 'cpu')
            for w in cfg.acoustic.prenet_depths]
    fn, step0 = ((A.train_step_hoisted, 0) if step == 'hoisted'
                 else (A.train_step, cfg.acoustic.tf_start_decay + 10000))
    runs = {}
    for where in ('cpu', cuda):
        state = A.init_state(cfg, 7, where)
        state.step = step0
        _, losses = fn(cfg, state, {k: v.to(where) for k, v in batch.items()},
                       Draws(prenet_keep=[k.to(where) for k in keep]))
        runs[str(where)] = ({k: float(v) for k, v in losses.items()},
                            {n: p.grad.cpu() for n, p in state.model.named_parameters()})
    (lc, gc), (lg, gg) = runs['cpu'], runs[str(cuda)]
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-9, k
    for n, g in gc.items():
        assert float((gg[n] - g).abs().max()) <= 1e-3 * max(float(g.norm()),
                                                             1e-6 * lc['grad_norm']), n


def test_fast_cell_decodes_like_the_stock_cell_through_the_kernels(cuda):
    """The whole-decode kernel on a stock cell and on its fused layout
    (``fuse_cell_params``): the two decodes agree, and the fused one agrees
    with its plain version (float32 weights, 1e-4)."""
    from transtacos_retunegan_tpu_torch.models.decoder_fast import (DecoderCellFast,
                                                                    fuse_cell_params)
    fp, mem = _problem(cuda, torch.float32)
    stock = seeded_init(DecoderCell(_cfg()), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in stock.named_parameters():
            if name.endswith('bias'):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
        stock.stop_projection.bias.fill_(-20.0)
    fast = DecoderCellFast(_cfg())
    fast.load_state_dict(fuse_cell_params(stock.state_dict()))
    fps = [fd.fold_params(c.to(cuda), torch.float32) for c in (stock, fast)]
    before = fd.LAUNCHES['decode_full']
    got = [fd.fused_decode_full(f, *mem, STEPS) for f in fps]
    assert fd.LAUNCHES['decode_full'] == before + 2
    _close(got[1], got[0], torch.float32)
    _close(got[1], fd.to_outputs(fps[1], *fd.decode_full_plain(fps[1], *mem, STEPS)),
           torch.float32)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def test_nccl_world_size_one_is_the_step_without_a_group(cuda):
    """In an NCCL group of world size 1 (the all-reduce of the gradients,
    the loss averaging and the draws of the global shape all on their
    path, through the states' shard), one hoisted acoustic step and one GAN
    step are bit for bit the steps without a group: losses, parameters and
    gradients.  cuDNN's and PyTorch's deterministic algorithms are on for
    the comparison (the GAN step's STFT frames overlap, and their gradient
    is an ``index_add_`` of atomics otherwise: two runs differed without
    them); the step without a group runs twice first, as the control."""
    import torch.distributed as dist
    from transtacos_retunegan_tpu_torch.models.layers import Draws, keep_mask
    from transtacos_retunegan_tpu_torch.parallel import (current_shard, free_port,
                                                        maybe_initialize_distributed)
    from transtacos_retunegan_tpu_torch.tools.acoustic_step_profile import seeded_batch
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train import vocoder_step as V
    from transtacos_retunegan_tpu_torch.utils.determinism import deterministic
    acfg, vcfg = _acoustic_cfg(), _vocoder_cfg()
    batch = seeded_batch(acfg, 4, 60, 16, seed=2, device=cuda)
    s = batch['mel_targets'].shape[1] // acfg.acoustic.outputs_per_step
    keep = [keep_mask((s, 4, w), 0.5, torch.Generator().manual_seed(1), 'cpu').to(cuda)
            for w in acfg.acoustic.prenet_depths]
    vb = {k: torch.from_numpy(v).to(cuda) for k, v in _vocoder_batch(vcfg, 1).items()
          if k in ('mel', 'tmpl', 'wav')}

    def snap(modules, metrics):
        return ([(p.detach().clone(), p.grad.clone()) for m in modules for p in m.parameters()],
                {k: float(v) for k, v in metrics.items()})

    def steps():
        st = A.init_state(acfg, 7, cuda, current_shard())
        _, losses = A.train_step_hoisted(acfg, st, batch, Draws(prenet_keep=keep))
        gs = V.init_gan_state(vcfg, 3, cuda, current_shard())
        noise = torch.Generator(device=cuda).manual_seed(5)
        _, m = V.gan_train_step(vcfg, gs, vb, noise, 4)
        return snap([st.model], losses), snap([gs.generator, gs.discriminators], m)

    def same(a, b):
        return all(x[1] == y[1] and all(torch.equal(p, q) and torch.equal(g, h)
                                        for (p, g), (q, h) in zip(x[0], y[0]))
                   for x, y in zip(a, b))

    with deterministic():
        ref = steps()
        assert same(steps(), ref), 'the steps without a group are not deterministic'
        maybe_initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0, device=cuda)
        try:
            assert dist.get_backend() == 'nccl' and current_shard().count == 1
            got = steps()
        finally:
            dist.destroy_process_group()
    assert same(got, ref)


# ---------------------------------------------------------------------------
# the host side: native Griffin-Lim, reference checkpoints, the resident corpus
# ---------------------------------------------------------------------------

def test_native_loader_feeds_the_card(cuda, tmp_path):
    """The native library builds on this machine from ``native/ttsdsp.cpp``
    and the vocoder loader's first epoch (the default engine) gives the
    card batches whose templates are the native ones."""
    from transtacos_retunegan_tpu_torch.audio import transforms as T
    from transtacos_retunegan_tpu_torch.data import native
    from transtacos_retunegan_tpu_torch.data.vocoder_data import VocoderDataset, VocoderLoader
    from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
    from transtacos_retunegan_tpu_torch.train.train_vocoder import device_batches
    native.lib()
    cfg = _vocoder_cfg()
    write_corpus(str(tmp_path / 'corpus'), cfg.audio, 4, 1, seed=0, min_s=0.3, max_s=1.0)
    ds = VocoderDataset('train', str(tmp_path / 'corpus'), cfg)
    batches = list(device_batches(VocoderLoader(ds, 2, num_workers=2), cuda))
    assert len(batches) == 2 and all(b['tmpl'].device.type == cuda.type for b in batches)
    for _, wav, tmpl in ds.cache:                   # the items the epoch built
        want = T.inv_log_mag(T.get_mag(wav[:-1], cfg.audio), cfg.audio, length=len(wav) - 1)
        np.testing.assert_array_equal(tmpl[:-1], want)


def test_imported_checkpoint_serves_on_the_card(cuda, tmp_path):
    """A seeded reference-layout RefineGAN_small checkpoint, imported, serves
    ``tts_fused`` through ``decode_full``; its wav equals that of the same
    weights loaded with ``from_flax``, bit for bit."""
    from transtacos_retunegan_tpu_torch import interop
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    from transtacos_retunegan_tpu_torch.tools.import_reference_ckpt import import_run
    from transtacos_retunegan_tpu_torch.train.checkpoint import load_generator_params
    cfg = _small_cfg()
    sd = interop.seeded_state_dict(make_generator(cfg), interop.map_refinegan_small(), 5)
    torch.save({'generator': sd}, tmp_path / 'g_00000100')
    import_run(str(tmp_path / 'g_00000100'), str(tmp_path / 'run'), cfg=cfg)
    wavs = []
    for gen_params in (load_generator_params(str(tmp_path / 'run')),
                       interop.import_generator_state_dict(sd, 'RefineGAN_small')):
        before = fd.LAUNCHES['decode_full']
        wavs.append(Synthesizer(cfg, gen_params=gen_params, devices=[cuda]).tts_fused('ni3 hao3'))
        assert fd.LAUNCHES['decode_full'] == before + 1
    assert np.isfinite(wavs[0]).all() and len(wavs[0]) > 0
    np.testing.assert_array_equal(wavs[0], wavs[1])


def test_run_dir_serves_on_the_card(cuda, tmp_path):
    """A trainer's run dir served through ``Synthesizer(acoustic_dir=...)``
    (the app's ``--acoustic_dir``) on the card: one ``decode_full`` launch,
    and the CPU's wav within 1e-3 (``chip_smoke.py``'s ``SLICE_TOL`` for
    this configuration on the card against the CPU; float32 throughout, the
    same Griffin-Lim phase, no stop)."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.train.acoustic_step import init_state
    cfg = _small_cfg()
    state = init_state(cfg, 11, 'cpu')
    with torch.no_grad():
        state.model.decoder_cell.stop_projection.bias.fill_(-20.0)
    ckpt.save_acoustic(str(tmp_path), state)
    frames = cfg.acoustic.max_iters * cfg.acoustic.outputs_per_step
    theta = 2 * np.pi * torch.rand(cfg.audio.n_freq, frames,
                                   generator=torch.Generator().manual_seed(12))
    wavs = []
    for device in (cuda, 'cpu'):
        synth = Synthesizer(cfg, acoustic_dir=str(tmp_path), devices=[device],
                            infer_dtype='float32')
        assert torch.equal(synth.acoustic.decoder_cell.stop_projection.bias.cpu(),
                           torch.full((cfg.acoustic.outputs_per_step,), -20.0))
        synth.decoder = fd.fold_params(synth.acoustic.decoder_cell, torch.float32)
        before = fd.LAUNCHES['decode_full']
        wavs.append(synth.tts_fused('ni3 hao3', theta=theta.to(device)))
        assert fd.LAUNCHES['decode_full'] == before + (device == cuda)
    assert wavs[0].shape == wavs[1].shape == (256 * frames,)
    assert float(np.abs(wavs[0] - wavs[1]).max()) <= 1e-3


def test_device_data_on_the_card(cuda, tmp_path):
    """The resident corpus gathers on the card the CPU's batches bit for
    bit, and ``train_acoustic --device_data`` takes 2 steps there."""
    from transtacos_retunegan_tpu_torch.data.device_data import DeviceResidentData
    from transtacos_retunegan_tpu_torch.data.feeder import AcousticDataset
    from transtacos_retunegan_tpu_torch.tools.synth_corpus import build_corpus
    from transtacos_retunegan_tpu_torch.train import train_acoustic
    cfg = _acoustic_cfg()
    data_dir = build_corpus(str(tmp_path / 'corpus'), cfg, n_utts=12, seed=0, num_workers=1)
    ds = AcousticDataset(data_dir, cfg)
    on_card, on_cpu = DeviceResidentData(ds, cfg, cuda), DeviceResidentData(ds, cfg, 'cpu')
    idx = next(on_card.plan(seed=1))
    got, ref = on_card.gather(idx), on_cpu.gather(idx)
    for k, v in ref.items():
        assert got[k].device.type == cuda.type and torch.equal(got[k].cpu(), v), k
    train_acoustic.main(['--data_dir', data_dir, '--log_path', str(tmp_path / 'run'),
                         '--config', cfg.save(str(tmp_path / 'cfg')), '--device_data',
                         '--device', cuda.type,
                         '--max_steps', '2', '--log_interval', '1',
                         '--checkpoint_interval', '2', '--summary_interval', '100'])
    log = (tmp_path / 'run' / 'train.log').read_text()
    assert 'device-resident corpus' in log and 'training complete at step 2' in log


def test_coverage_diagnosis_on_the_card(cuda, tmp_path, monkeypatch):
    """``tools/coverage_diagnosis`` on a seeded small-width run, on the card
    against the CPU, the decoder's weights in float32 on both: the same
    missed tokens and kinds, coverage within 1e-3 (``chip_smoke.py``'s
    ``SLICE_TOL`` for this configuration), one ``decode_full`` launch per
    text on the card and none on the CPU."""
    import functools
    from transtacos_retunegan_tpu_torch.serve import pipeline
    from transtacos_retunegan_tpu_torch.tools import coverage_diagnosis
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.train.acoustic_step import init_state
    cfg = _small_cfg()
    run = str(tmp_path / 'run')
    state = init_state(cfg, 13, 'cpu')
    with torch.no_grad():
        state.model.decoder_cell.stop_projection.bias.fill_(-20.0)
    ckpt.save_acoustic(run, state)
    cfg.save(run)
    texts = ['ni3 hao3 shi4 jie4', 'da4 jia1 hao3', 'wo3 men5 yi4 qi3 qu4 gong1 yuan2']
    (tmp_path / 'test.txt').write_text(''.join(
        f'u{i}|{"0" * (len(t.split()) - 1)}4|{t}\n' for i, t in enumerate(texts)))
    monkeypatch.setattr(pipeline, 'fold_params',
                        functools.partial(fd.fold_params, dtype=torch.float32))
    res = {}
    for device in (cuda.type, 'cpu'):
        before = fd.LAUNCHES['decode_full']
        res[device] = coverage_diagnosis.main([
            '--data_dir', str(tmp_path), '--acoustic_dir', run, '--config', run,
            '--out', str(tmp_path / f'{device}.json'), '--device', device])
        assert fd.LAUNCHES['decode_full'] - before == (len(texts) if device == cuda.type else 0)
    for g, w in zip(res[cuda.type]['per_utt'], res['cpu']['per_utt']):
        assert [(m['pos'], m['kind']) for m in g['missed']] == \
            [(m['pos'], m['kind']) for m in w['missed']]
        assert abs(g['coverage'] - w['coverage']) <= 1e-3
        assert abs(g['coverage_winnable'] - w['coverage_winnable']) <= 1e-3


def test_pallas_equivalence_on_the_card(cuda, tmp_path):
    """``tools/pallas_equivalence.py`` at its defaults (B=1, N=80, 40
    steps, the stock cell from ``PRNGKey(0)``): every float32 path within
    2e-4 of the stepped cell with equal ``out_lengths``, 40 ``decode_step``
    and 3 ``decode_full`` launches."""
    from transtacos_retunegan_tpu_torch.tools import pallas_equivalence as pe
    before = dict(fd.LAUNCHES)
    result = pe.main(['--out', str(tmp_path / 'pe.json')])
    assert {k: fd.LAUNCHES[k] - before[k] for k in before} == {'decode_step': 40,
                                                                'decode_full': 3}
    assert not result['interpret'] and result['platform'] == 'cuda'
    for tag in pe.F32_RUNS:
        assert result['runs'][tag]['out_lengths_equal']
        assert max(result['runs'][tag][k] for k in pe.OUTPUTS) <= 2e-4
