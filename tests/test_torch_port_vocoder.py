"""Vocoder modules of the port against the JAX package on the CPU: all 12
generators (train and eval forwards), every layer, the differentiable
STFT, the three discriminators, every loss, and the weight bridge of every
tree.  Inputs are numpy from a seed; the JAX side runs under ``jax.jit``;
weights are random trees on the JAX shapes (weight-norm gains away from
their initial constant), loaded through ``weights.from_flax``.  The
training noise is the JAX noise, recorded by ``noise_interceptor``.

Tolerances (float32, convolutions summed in another order): layers 2e-5
absolute; whole generators 1e-4 absolute on outputs in (-1, 1);
discriminator scores and feature maps 1e-4 relative to the largest value
of each; STFT magnitude and mel 1e-5 relative to their largest value, the
phase 1e-4 after wrapping the difference into (-pi, pi] (the JAX package
computes rounding noise for the imaginary parts that are exactly zero,
which gives +pi or -pi at random where the real part is negative), the
log-magnitude 1e-4, both on the bins within 60 dB of the peak (elsewhere
a relative error of the magnitude is amplified by the log and the phase is
ill-conditioned); losses 1e-5 relative; gradients 1e-4 of their norm
(1e-3 for the second derivative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (SEG, VB, generator_args, jax_generator_with_noise,
                               random_tree, vocoder_batch, vocoder_cfg_pair,
                               vocoder_trees)
from transtacos_retunegan_tpu.audio import dsp as jdsp
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.models import discriminators as jd
from transtacos_retunegan_tpu.models import vocoder_layers as jvl
from transtacos_retunegan_tpu.models import vocoder_losses as jl
from transtacos_retunegan_tpu.models.generators import GENERATORS as JAX_GENERATORS
from transtacos_retunegan_tpu.models.generators import make_generator as jmake
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.audio import dsp as tdsp
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models import discriminators as td
from transtacos_retunegan_tpu_torch.models import vocoder_layers as tvl
from transtacos_retunegan_tpu_torch.models import vocoder_losses as tl
from transtacos_retunegan_tpu_torch.models.generators import GENERATORS, make_generator

LAYER_TOL = dict(atol=2e-5, rtol=1e-5)
pytestmark = pytest.mark.usefixtures('few_threads')
GEN_TOL = dict(atol=1e-4, rtol=0)
DISC = dict(disc_width_mult=0.25, mpd_periods=(3,))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_scaled(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), (err, float(np.abs(ref).max()))


def _wrapped(a, b):
    d = np.asarray(a) - np.asarray(b)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def test_registry_has_every_variant():
    assert sorted(GENERATORS) == sorted(JAX_GENERATORS)


def _generator_tree(jcfg, batch, seed):
    args = tuple(jnp.asarray(a) for a in generator_args(jcfg, batch))
    shapes = jax.eval_shape(lambda: jmake(jcfg).init(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, *args,
        train=True))
    return random_tree(shapes['params'], seed)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('ver', sorted(JAX_GENERATORS))
def test_generator_matches(ver, train):
    jcfg, pcfg = vocoder_cfg_pair(generator_ver=ver)
    batch = vocoder_batch(jcfg, seed=3)
    tree = _generator_tree(jcfg, batch, seed=4)
    args = generator_args(jcfg, batch)
    jargs = tuple(jnp.asarray(a) for a in args)
    if train:
        ref, noise = jax_generator_with_noise(jcfg)(tree, jargs, jax.random.PRNGKey(9))
        assert len(noise) == (6 if ver.startswith('RefineGAN') else 0)
        noise = [_t(n).transpose(1, 2) for n in noise]     # [B, C, T]
    else:
        ref = jax.jit(lambda p, a: jmake(jcfg).apply({'params': p}, *a, train=False))(
            tree, jargs)
        noise = None
    gen = weights.load_flax(make_generator(pcfg), tree)
    with torch.no_grad():
        out = gen(*(_t(a) for a in args), noise=noise)
    assert out.shape == (VB, SEG, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GEN_TOL)


def test_noise_interceptor_is_transparent():
    """The recorded noise is the noise the JAX module draws: the train
    forward with the interceptor equals the one without, bit for bit."""
    jcfg, _ = vocoder_cfg_pair()
    batch = vocoder_batch(jcfg, seed=5)
    tree = _generator_tree(jcfg, batch, seed=6)
    args = tuple(jnp.asarray(a) for a in generator_args(jcfg, batch))
    key = jax.random.PRNGKey(3)
    with_icpt, noise = jax_generator_with_noise(jcfg)(tree, args, key)
    plain = jax.jit(lambda p, a, k: jmake(jcfg).apply(
        {'params': p}, *a, train=True, rngs={'noise': k}))(tree, args, key)
    np.testing.assert_array_equal(np.asarray(with_icpt), np.asarray(plain))
    assert len({float(np.asarray(n).sum()) for n in noise}) == len(noise)


def test_noise_from_a_generator():
    layer = tvl.LearnedGaussianNoise()
    x = torch.randn(2, 3, 50)
    with torch.no_grad():
        layer.w.fill_(0.5)
        out = layer(x, torch.Generator().manual_seed(1))
        n = torch.rand(x.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out, tvl.lrelu(x + 0.5 * n))
    torch.testing.assert_close(layer(x), tvl.lrelu(x))


def _layer_pair(jmod, tmod, x_jax_layout, seed):
    """Init shapes of the JAX layer, random tree, both outputs in the JAX
    layout (the port's module takes channels first)."""
    x = jnp.asarray(x_jax_layout)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
    tree = random_tree(shapes['params'], seed)
    ref = jax.jit(lambda p, x: jmod.apply({'params': p}, x))(tree, x)
    weights.load_flax(tmod, tree)
    perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    back = (0,) + tuple(range(2, x.ndim)) + (1,)
    with torch.no_grad():
        out = tmod(_t(x_jax_layout).permute(*perm)).permute(*back)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize('k,s,p', [(16, 8, 4), (4, 2, 1)])
def test_wn_conv_transpose_even_kernels(k, s, p):
    cin, cout, t = 6, 5, 7
    x = np.random.RandomState(k).randn(2, t, cin).astype(np.float32)
    out, ref = _layer_pair(jvl.WNConvTranspose(cout, k, s, padding=p, output_padding=0),
                           tvl.WNConvTranspose(cin, cout, k, s, padding=p, output_padding=0),
                           x, seed=k)
    assert out.shape == (2, t * s, cout)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize('kernel,stride,padding', [((5, 1), (3, 1), (2, 0)),
                                                   ((3, 3), (2, 2), (1, 1)),
                                                   ((5, 3), (3, 2), (2, 1))])
def test_wn_conv2d_matches(kernel, stride, padding):
    x = np.random.RandomState(2).randn(2, 17, 9, 3).astype(np.float32)
    out, ref = _layer_pair(jvl.WNConv2d(7, kernel, stride, padding),
                           tvl.WNConv2d(3, 7, kernel, stride, padding), x, seed=3)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize('k,s,resize', [(16, 8, 'u'), (4, 2, 'u'), (4, 2, 'd')])
def test_residual_block_matches(k, s, resize):
    cin, cout, t = 6, 4, 16
    x = np.random.RandomState(k).randn(2, t, cin).astype(np.float32)
    out, ref = _layer_pair(jvl.ResidualBlock(cout, k, s, resize),
                           tvl.ResidualBlock(cin, cout, k, s, resize), x, seed=5)
    assert out.shape == (2, t * s if resize == 'u' else t // s, cout)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


@pytest.mark.parametrize('name', ['ResBlock2', 'ResBlock3', 'ResBlockFull'])
def test_resblocks_match(name):
    x = np.random.RandomState(1).randn(2, 40, 6).astype(np.float32)
    dil = (1, 3, 9)
    out, ref = _layer_pair(getattr(jvl, name)(6, 5, dil), getattr(tvl, name)(6, 5, dil),
                           x, seed=7)
    np.testing.assert_allclose(out, ref, **LAYER_TOL)


# ---------------------------------------------------------------------------
# differentiable STFT
# ---------------------------------------------------------------------------

RESOLUTIONS = ((2048, 1024, 240), (1024, 512, 120), (512, 256, 60))


@pytest.mark.parametrize('res', RESOLUTIONS, ids=lambda r: str(r[0]))
def test_stft_mag_mel_phase_and_gradient(res):
    au = JaxConfig().audio
    n_fft, win, hop = res
    rng = np.random.RandomState(n_fft)
    y = (0.1 * rng.randn(2, 4096)).astype(np.float32)
    a, b, c = (rng.randn(*s).astype(np.float32) for s in (
        (2, n_fft // 2 + 1, 4096 // hop + 1), (2, au.n_mel, 4096 // hop + 1),
        (2, n_fft // 2 + 1, 4096 // hop + 1)))

    def jf(y):
        s, m, p = jdsp.stft_mag_mel_phase(y, au, n_fft, win, hop)
        return jnp.sum(a * s) + jnp.sum(b * m) + jnp.sum(c * jnp.cos(p)), (s, m, p)
    (_, (s, m, p)), gj = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(y))

    yt = _t(y).requires_grad_(True)
    st, mt, pt = tdsp.stft_mag_mel_phase(yt, PortConfig().audio, n_fft, win, hop)
    _close_scaled(st.detach(), s, 1e-5)
    _close_scaled(mt.detach(), m, 1e-5)
    well = np.asarray(s) > 1e-3 * float(np.asarray(s).max())
    assert _wrapped(pt.detach(), p)[well].max() <= 1e-4
    (_t(a) * st).sum().add((_t(b) * mt).sum()).add((_t(c) * torch.cos(pt)).sum()).backward()
    gj = np.asarray(gj)
    assert np.abs(yt.grad.numpy() - gj).max() <= 1e-4 * np.linalg.norm(gj)


def test_stft_second_derivative_matches():
    """The R1 penalty's path: the gradient of a squared input-gradient."""
    au = JaxConfig().audio
    n_fft, win, hop = RESOLUTIONS[2]
    rng = np.random.RandomState(0)
    y = (0.1 * rng.randn(2, 2048)).astype(np.float32)
    a = rng.randn(2, n_fft // 2 + 1, 2048 // hop + 1).astype(np.float32)

    def score(y):
        s, _, p = jdsp.stft_mag_mel_phase(y, au, n_fft, win, hop)
        return jnp.sum(a * jnp.log(s) * jnp.cos(p))
    gj = jax.jit(jax.grad(lambda y: jnp.sum(jax.grad(score)(y) ** 2)))(jnp.asarray(y))

    yt = _t(y).requires_grad_(True)
    s, _, p = tdsp.stft_mag_mel_phase(yt, PortConfig().audio, n_fft, win, hop)
    gy, = torch.autograd.grad((_t(a) * torch.log(s) * torch.cos(p)).sum(), yt,
                              create_graph=True)
    (gy * gy).sum().backward()
    gj = np.asarray(gj)
    assert np.abs(yt.grad.numpy() - gj).max() <= 1e-3 * np.linalg.norm(gj)


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def disc_pair():
    """Discriminators at width 0.25 with one period, both packages, the
    same random trees, and a (real, fake) pair of waveforms."""
    jcfg, pcfg = vocoder_cfg_pair(**DISC)
    batch = vocoder_batch(jcfg, seed=11)
    _, dtree = vocoder_trees(jcfg, batch, seed=12)
    disc = weights.load_flax(td.Discriminators(pcfg), dtree)
    rng = np.random.RandomState(13)
    y_hat = (0.1 * rng.randn(*batch['wav'].shape)).astype(np.float32)
    return jcfg, pcfg, dtree, disc, batch['wav'], y_hat


def _fmaps_close(got, ref):
    for fg, fr in zip(got, ref):
        assert len(fg) == len(fr)
        for g, r in zip(fg, fr):
            r = np.asarray(r)
            r = np.moveaxis(r, -1, 1)                    # channels first
            _close_scaled(g.detach(), r, 1e-4)


def _outputs_close(got, ref, both):
    rs, gs, fr, fg = got
    jrs, jgs, jfr, jfg = ref
    assert len(rs) == len(jrs) and len(gs) == len(jgs) == (len(jrs) if both else 0)
    for a, b in zip(rs + gs, list(jrs) + list(jgs)):
        _close_scaled(a.detach(), b, 1e-4)
    _fmaps_close(fr, jfr)
    _fmaps_close(fg, jfg)


@pytest.mark.parametrize('both', [True, False], ids=['real_fake', 'real_only'])
@pytest.mark.parametrize('name', ['msd', 'mpd'])
def test_wave_discriminators_match(disc_pair, name, both):
    jcfg, _, dtree, disc, y, y_hat = disc_pair
    cls = {'msd': jd.MultiScaleDiscriminator, 'mpd': jd.MultiPeriodDiscriminator}[name]
    yy, yh = jnp.asarray(y)[..., None], jnp.asarray(y_hat)[..., None]
    ref = jax.jit(lambda p, a, b: cls(jcfg).apply({'params': p}, a, b if both else None))(
        dtree[name], yy, yh)
    with torch.no_grad():
        got = getattr(disc, name)(_t(y)[:, None], _t(y_hat)[:, None] if both else None)
    _outputs_close(got, ref, both)


@pytest.mark.parametrize('both', [True, False], ids=['real_fake', 'real_only'])
def test_stft_discriminator_matches(disc_pair, both):
    jcfg, _, dtree, disc, y, y_hat = disc_pair
    _, sr, sg = jax.jit(lambda a, b: jl.multi_stft_specs_and_loss(a, b, jcfg))(
        jnp.asarray(y), jnp.asarray(y_hat))
    ref = jax.jit(lambda p, a, b: jd.MultiStftDiscriminator(jcfg).apply(
        {'params': p}, a, b if both else None))(dtree['mtd'], sr, sg)
    to_port = [_t(s).permute(0, 3, 1, 2) for s in sr]     # [B, 2, F, T]
    with torch.no_grad():
        got = disc.mtd(to_port, [_t(s).permute(0, 3, 1, 2) for s in sg] if both else None)
    _outputs_close(got, ref, both)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _waves(seed):
    rng = np.random.RandomState(seed)
    y = (0.3 * rng.randn(VB, SEG)).astype(np.float32)
    return y, (0.5 * y + 0.1 * rng.randn(VB, SEG)).astype(np.float32)


@pytest.mark.parametrize('phd_input', ['stft', 'phase'])
def test_multi_stft_loss_and_specs_match(phd_input):
    jcfg, pcfg = vocoder_cfg_pair(phd_input=phd_input)
    y, y_g = _waves(21)
    loss, sr, sg = jax.jit(lambda a, b: jl.multi_stft_specs_and_loss(a, b, jcfg))(
        jnp.asarray(y), jnp.asarray(y_g))
    only = jax.jit(lambda a: jl.multi_stft_specs(a, jcfg))(jnp.asarray(y))
    grad = jax.jit(jax.grad(lambda b: jl.multi_stft_specs_and_loss(jnp.asarray(y), b, jcfg)[0]))(
        jnp.asarray(y_g))
    yg = _t(y_g).requires_grad_(True)
    tloss, tsr, tsg = tl.multi_stft_specs_and_loss(_t(y), yg, pcfg)
    tloss.backward()
    _close_scaled(tloss.detach(), loss, 1e-5)
    grad = np.asarray(grad)
    assert np.abs(yg.grad.numpy() - grad).max() <= 1e-4 * np.linalg.norm(grad)
    tonly = tl.multi_stft_specs(_t(y), pcfg)
    # the bins within 60 dB of the peak of the waveform each phase belongs to
    mag_g = [tdsp.stft_mag_mel_phase(_t(y_g), pcfg.audio, n, w, h)[0].log().numpy()
             for n, w, h in pcfg.vocoder.multi_stft_params]
    for got, ref, lm in zip(tsr + tsg + tonly, list(sr) + list(sg) + list(only),
                            [None] * len(tsr) + mag_g + [None] * len(tonly)):
        ref = np.moveaxis(np.asarray(ref), -1, 1)
        got = got.detach().numpy()
        well = ref[:, 0] > np.log(1e-3) + ref[:, 0].max()
        assert np.abs(got[:, 0] - ref[:, 0])[well].max() <= 1e-4
        if lm is not None:
            well = lm > np.log(1e-3) + lm.max()
        assert (_wrapped(np.pi * got[:, 1], np.pi * ref[:, 1])[well]).max() <= 1e-4


@pytest.mark.parametrize('name', ['envelope_loss', 'dynamic_loss', 'strip_mirror_loss'])
def test_wave_losses_match(name):
    jcfg, pcfg = vocoder_cfg_pair()
    y, y_g = _waves(22)
    jf = getattr(jl, name)
    tf = getattr(tl, name)
    if name == 'strip_mirror_loss':
        y_g = y_g[:, :-1]                      # odd length: the trim branch
        jfun, tfun = (lambda b: jf(b)), (lambda b: tf(b))
    else:
        jfun = lambda b: jf(jnp.asarray(y), b, jcfg)          # noqa: E731
        tfun = lambda b: tf(_t(y), b, pcfg)                  # noqa: E731
    val, grad = jax.jit(jax.value_and_grad(jfun))(jnp.asarray(y_g))
    yg = _t(y_g).requires_grad_(True)
    tval = tfun(yg)
    tval.backward()
    _close_scaled(tval.detach(), val, 1e-5)
    grad = np.asarray(grad)
    assert np.abs(yg.grad.numpy() - grad).max() <= 1e-4 * max(np.linalg.norm(grad), 1e-30)


@pytest.mark.parametrize('relative', [False, True], ids=['lsgan', 'relativistic'])
def test_adversarial_and_feature_losses_match(relative):
    jcfg, pcfg = vocoder_cfg_pair(relative_gan_loss=relative)
    rng = np.random.RandomState(23)
    dr = [rng.randn(VB, n).astype(np.float32) for n in (5, 9, 2)]
    dg = [rng.randn(VB, n).astype(np.float32) for n in (5, 9, 2)]
    fr = [[rng.randn(VB, 3, n).astype(np.float32) for n in (4, 6)] for _ in range(2)]
    fg = [[rng.randn(VB, 3, n).astype(np.float32) for n in (4, 6)] for _ in range(2)]

    def jall(dr, dg, fg):
        return (jl.discriminator_loss(dr, dg, jcfg), jl.generator_loss(dg, dr, jcfg),
                jl.feature_loss(fr, fg))
    vals = jax.jit(jall)(dr, dg, fg)
    grads = [jax.jit(jax.grad(lambda *a, i=i: jall(*a)[i], argnums=(0, 1, 2)))(dr, dg, fg)
             for i in range(3)]
    tdr = [_t(x).requires_grad_(True) for x in dr]
    tdg = [_t(x).requires_grad_(True) for x in dg]
    tfg = [[_t(x).requires_grad_(True) for x in f] for f in fg]
    tvals = (tl.discriminator_loss(tdr, tdg, pcfg), tl.generator_loss(tdg, tdr, pcfg),
             tl.feature_loss([[_t(x) for x in f] for f in fr], tfg))
    leaves = tdr + tdg + [x for f in tfg for x in f]
    for tv, v, g in zip(tvals, vals, grads):
        _close_scaled(tv.detach(), v, 1e-5)
        tg = torch.autograd.grad(tv, leaves, allow_unused=True)
        for got, ref in zip(tg, jax.tree.leaves(g)):
            ref = np.asarray(ref)
            got = np.zeros_like(ref) if got is None else got.numpy()
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the weight bridge, every tree at the default widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('which', sorted(JAX_GENERATORS) + ['discriminators'])
def test_from_flax_consumes_every_tree(which):
    base = JaxConfig()
    jcfg = dataclasses.replace(base, vocoder=dataclasses.replace(
        base.vocoder, generator_ver='RefineGAN_small' if which == 'discriminators' else which))
    pcfg = dataclasses.replace(PortConfig(), vocoder=dataclasses.replace(
        PortConfig().vocoder, generator_ver=jcfg.vocoder.generator_ver))
    batch = vocoder_batch(jcfg, seed=0, b=1, seg=8192)
    if which == 'discriminators':
        _, tree = vocoder_trees(jcfg, batch, seed=1)
        module = td.Discriminators(pcfg)
        v = tree['mpd']['disc_p3']['conv_1']['v']                 # [kh, kw, in, out]
    else:
        tree = _generator_tree(jcfg, batch, seed=1)
        module = make_generator(pcfg)
        v = None
    state = weights.from_flax(module, tree)
    assert len(state) == len(weights.flatten(tree)) == len(module.state_dict())
    if v is not None:
        np.testing.assert_array_equal(state['mpd.disc_p3.conv_1.v'].numpy(),
                                      v.transpose(3, 2, 0, 1).astype(np.float32))
    weights.seeded_init(module, 0)
    assert all(torch.isfinite(p).all() for p in module.parameters())


# ---------------------------------------------------------------------------
# the bf16 training policy
# ---------------------------------------------------------------------------

def test_bf16_policy_matches():
    """``compute_dtype='bfloat16'``: the generator and the discriminators
    run their convolutions in bf16 on both sides and hand float32 to the
    losses; the master parameters stay float32.  Both sides round the same
    operands to bf16, but a sum taken in another order can flip one
    rounding, which later layers carry: the wav within 5e-2 (mean 5e-3),
    discriminator scores within 5e-2 of their largest value."""
    from transtacos_retunegan_tpu.train import vocoder_step as jvs
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    jcfg, pcfg = vocoder_cfg_pair(compute_dtype='bfloat16', **DISC)
    batch = vocoder_batch(jcfg, seed=17)
    gtree, dtree = vocoder_trees(jcfg, batch, seed=18)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    y_j = jax.jit(lambda p, b: jvs.apply_generator(jcfg, p, b, {}, train=False))(gtree, jb)
    st = vs.init_gan_state(pcfg, 0, 'cpu')
    weights.load_flax(st.generator, gtree)
    weights.load_flax(st.discriminators, dtree)
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        y_t = vs.apply_generator(pcfg, st.generator, tb)
    assert y_t.dtype == torch.float32
    err = np.abs(y_t.numpy() - np.asarray(y_j))
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())

    y, y_hat = jb['wav'], y_j                      # the same STFT images on both sides
    _, sr, sg = jax.jit(lambda a, b: jl.multi_stft_specs_and_loss(a, b, jcfg))(y, y_hat)
    ref = jax.jit(lambda d, a, b, r, g: jvs._disc_forward(jcfg, d, a, b, r, g))(
        dtree, y, y_hat, sr, sg)
    tsr, tsg = ([_t(x).permute(0, 3, 1, 2) for x in specs] for specs in (sr, sg))
    with torch.no_grad():
        got = vs._disc_forward(pcfg, st.discriminators, tb['wav'], _t(y_hat), tsr, tsg)
    for (rs, gs, fr, fg), (jrs, jgs, _, _) in zip(got, ref):
        for a, b in zip(rs + gs, list(jrs) + list(jgs)):
            assert a.dtype == torch.float32
            _close_scaled(a, b, 5e-2)
        assert all(m.dtype == torch.float32 for f in fr + fg for m in f)
    assert all(p.dtype == torch.float32 for p in st.discriminators.parameters())
