"""One GAN train step of the port against the JAX package's
``gan_train_step``, from identical parameters, batch and generator noise,
on the CPU: ``RefineGAN_small``, a Split variant (``HiFiGANSplit``) with
the global-norm clip on, and ``RefineGAN_small`` with the R1 penalty on.
Also the NaN guard, the number of updates per step, the learning rate
across an epoch boundary, and the eval step.

The discriminators are slim (width 0.25, one scale, one period, one STFT
resolution) so that each JAX step compiles in well under a minute; every
family and every loss is on the path.  The noise is the JAX step's own,
recorded by ``noise_interceptor`` from ``fold_in(key, 7)`` as the JAX step
draws it.  The JAX side runs with ``exact_zero_imag_stft_ri``: the
imaginary parts that are exactly zero are +0 on both sides (the JAX DFT's
rounding noise there flips the phase of about half the first frame's
bins between +pi and -pi, which moved the STFT discriminator's losses by
up to 7e-3 relative).

Two properties of the step bound what can be compared element by element,
and the checks are built around them:

* Adam's first update is lr x the sign of the gradient, so an element
  whose gradient is within rounding of 0 moves by +lr or -lr at random,
  and everything computed after that update (a second discriminator
  update, the generator's losses against the updated discriminators)
  inherits the difference.  So the cases take one discriminator update
  (``d_train_times=1``; the default 2 is counted by
  ``test_updates_per_step`` and the learning-rate test), the discriminator phase is
  compared from the common start, and the port's generator phase runs
  against the JAX step's updated discriminators.
* The reference gradients are ``jax.grad`` of the JAX package's losses,
  composed as ``gan_train_step`` composes them, each jitted on its own.
  Inside the whole jitted step XLA sums the first STFT-discriminator
  conv's weight gradient in another order, and that sum cancels: the
  step's moments put it 0.4-0.6% of the leaf's norm away from the same
  gradient taken alone, which the port matches to 1e-5.

Checks and tolerances (float32):

* every metric within 1e-4 relative (1e-6 absolute floor), the same keys;
  the R1 penalty itself within 3e-2 (see ``R1_TOL``);
* each leaf's gradient within 1e-3 of that leaf's norm (R1 case: 3e-2);
* the updated parameters within 1e-2 x lr of the JAX step's where the
  reference gradient exceeds 1e-6 plus the leaf's largest gradient
  difference of either package's step from it: there both steps'
  gradients are above 1e-6 with the reference's sign, so both updates are
  within 1% of that sign x lr (Adam's first update is lr x g / (|g| +
  1e-8)).  Below, the update is a sign the rounding decides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (exact_zero_imag_stft_ri, generator_args,
                               jax_generator_with_noise, vocoder_batch, vocoder_cfg_pair,
                               vocoder_trees)
from transtacos_retunegan_tpu.audio import dsp as jdsp
from transtacos_retunegan_tpu.models import vocoder_losses as jl
from transtacos_retunegan_tpu.train import vocoder_step as jvs
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.train import vocoder_step as vs

SLIM = dict(disc_width_mult=0.25, msd_layers=1, mpd_periods=(3,),
            multi_stft_params=((512, 256, 60),))
SPE = 10                                    # steps per epoch
pytestmark = pytest.mark.usefixtures('few_threads')
CASES = {'refinegan_small': dict(),
         'hifigan_split_clip': dict(generator_ver='HiFiGANSplit', grad_clip_norm=1.0),
         'r1': dict(r1_gamma=0.5)}
# R1 through the STFT discriminator: the first frame is even-symmetric
# (reflect padding), its imaginary parts are exactly 0, and d log|S| / dy
# there is 1/re, so the penalty is dominated by the bins whose real part
# is nearest 0 and carries their relative rounding error (25% apart
# between the packages on white noise; 2e-3 once the waveform has a DC and
# a Nyquist component, which the R1 case adds).  The scale and period
# discriminators' R1 agree to 1e-7.
R1_TOL = 3e-2
GRAD_TOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _adam(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    if hasattr(opt_state, 'mu'):
        return opt_state
    for s in opt_state:
        if isinstance(s, tuple) or hasattr(s, 'mu'):
            found = _adam(s)
            if found is not None:
                return found
    return None


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_d_loss(cfg, dparams, y, y_g):
    """``gan_train_step``'s discriminator loss (its ``d_loss_fn``) and its
    metrics."""
    _, specs_r, specs_g = jl.multi_stft_specs_and_loss(y, y_g, cfg)
    (sr, sg, _, _), (pr, pg, _, _), (tr, tg, _, _) = jvs._disc_forward(
        cfg, dparams, y, y_g, specs_r, specs_g)
    ls, lp, lt = (jl.discriminator_loss(r, g, cfg) for r, g in ((sr, sg), (pr, pg), (tr, tg)))
    total, r1 = ls + lp + lt, jnp.asarray(0.0)
    if cfg.vocoder.r1_gamma > 0:
        def real_score(yy):
            (rs, _, _, _), (rp, _, _, _), (rt, _, _, _) = jvs._disc_forward(
                cfg, dparams, yy, None, jl.multi_stft_specs(yy, cfg), None)
            return sum(jnp.sum(x) for x in rs + rp + rt)
        r1 = jnp.sum(jax.grad(real_score)(y) ** 2) / y.shape[0]
        total = total + 0.5 * cfg.vocoder.r1_gamma * r1
    mean = lambda xs: sum(jnp.mean(x) for x in xs) / len(xs)          # noqa: E731
    return total, {'loss_disc_s': ls, 'loss_disc_p': lp, 'loss_disc_t': lt, 'loss_r1': r1,
                   'sc_s_r': mean(sr), 'sc_s_g': mean(sg), 'sc_p_r': mean(pr),
                   'sc_p_g': mean(pg), 'sc_t_r': mean(tr), 'sc_t_g': mean(tg)}


def _jax_g_loss(cfg, gparams, dparams, batch, rngs):
    """``gan_train_step``'s generator loss (its ``g_loss_fn``) and its
    metrics."""
    hv = cfg.vocoder
    y = batch['wav']
    y_hat = jvs.apply_generator(cfg, gparams, batch, rngs, train=True)
    loss_mstft, sp_r, sp_g = jl.multi_stft_specs_and_loss(y, y_hat, cfg)
    zero = jnp.asarray(0.0)
    m = {'loss_mstft': loss_mstft,
         'loss_env': jl.envelope_loss(y, y_hat, cfg) if hv.envelope_loss else zero,
         'loss_dyn': jl.dynamic_loss(y, y_hat, cfg) if hv.dynamic_loss else zero,
         'loss_sm': jl.strip_mirror_loss(y_hat) if hv.strip_mirror_loss else zero}
    families = jvs._disc_forward(cfg, dparams, y, y_hat, sp_r, sp_g)
    for k, (r, g, fr, fg) in zip('spt', families):
        m[f'loss_fm_{k}'] = jl.feature_loss(fr, fg)
        m[f'loss_gen_{k}'] = jl.generator_loss(g, r, cfg)
    m['loss_gen_all'] = (sum(m[f'loss_gen_{k}'] for k in 'spt')
                         + sum(m[f'loss_fm_{k}'] for k in 'spt') * hv.w_loss_fm
                         + m['loss_mstft'] * hv.w_loss_mstft + m['loss_env'] * hv.w_loss_env
                         + m['loss_dyn'] * hv.w_loss_dyn + m['loss_sm'] * hv.w_loss_sm)
    return m['loss_gen_all'], m


def _clipped(grads, clip):
    if clip <= 0:
        return grads
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in jax.tree.leaves(grads))))
    return grads if norm < clip else jax.tree.map(lambda g: g / norm * clip, grads)


def _update(opt, grads, params):
    """One optax update from a fresh state: (new params, new state)."""
    upd, state = jax.jit(opt.update)(grads, opt.init(params), params)
    return _np(optax.apply_updates(params, upd)), _np(state)


class Run:
    """One step of each package from the same start, and the reference:
    ``jax.grad`` of the JAX package's discriminator loss at the common
    start, the discriminators after its optax update, ``jax.grad`` of the
    generator loss against them, and the generator after its update
    (``reference``).  The ``refinegan_small`` case (and the NaN guard's,
    which compiles to the same program) also runs the JAX package's own
    ``gan_train_step`` (``step``), which the reference must equal: one
    compiled step per file instead of one per case."""

    def __init__(self, name, wav_nan=False, seed=31):
        self.jcfg, self.pcfg = vocoder_cfg_pair(**SLIM, **CASES[name], d_train_times=1)
        hv = self.jcfg.vocoder
        batch = vocoder_batch(self.jcfg, seed=seed)
        if hv.r1_gamma > 0:
            batch['wav'] += np.float32(0.3) + np.float32(0.2) * (
                -1.0) ** np.arange(batch['wav'].shape[1], dtype=np.float32)
        if wav_nan:
            batch['wav'][0, 100] = np.nan
        gtree, dtree = vocoder_trees(self.jcfg, batch, seed=seed + 1)
        key = jax.random.PRNGKey(seed + 2)
        rngs = {'noise': jax.random.fold_in(key, 7)}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        y_g, noise = jax_generator_with_noise(self.jcfg)(
            gtree, generator_args(self.jcfg, jb), rngs['noise'])
        gopt, dopt = jvs.make_optimizers(self.jcfg, SPE)
        self.step = self.reference = None
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdsp, 'stft_ri', exact_zero_imag_stft_ri(jdsp.stft_ri))
            if name == 'refinegan_small':
                state = jvs.GANState(jnp.asarray(0, jnp.int32), gtree, gopt.init(gtree),
                                     dtree, dopt.init(dtree))
                new, jm = jvs.gan_train_step(self.jcfg, state, jb, key, SPE)
                self.step = {f: _np(getattr(new, f)) for f in new._fields}
                self.step_m = {k: float(v) for k, v in jm.items()}
            if not wav_nan:
                (_, d_m), g_d = jax.jit(jax.value_and_grad(
                    lambda d: _jax_d_loss(self.jcfg, d, jb['wav'], y_g[..., 0]),
                    has_aux=True))(dtree)
                new_d, d_state = _update(dopt, g_d, dtree)
                (_, g_m), g_g = jax.jit(jax.value_and_grad(
                    lambda g: _jax_g_loss(self.jcfg, g, new_d, jb, rngs), has_aux=True))(gtree)
                new_g, g_state = _update(gopt, g_g, gtree)
                self.ref_d, self.ref_g = (_clipped(_np(g), hv.grad_clip_norm) for g in (g_d, g_g))
                self.reference = {'gen_params': new_g, 'gen_opt': g_state, 'disc_params': new_d,
                                  'disc_opt': d_state}
                self.ref_m = {k: float(v) for k, v in {**d_m, **g_m}.items()}
                self.ref_m['loss_disc_all'] = sum(self.ref_m[f'loss_disc_{k}'] for k in 'spt')
        self.jax = self.reference or self.step
        self.jm = self.ref_m if self.reference else self.step_m

        tb = {k: _t(v) for k, v in batch.items()}
        tnoise = [_t(n).transpose(1, 2) for n in noise]
        # the whole step
        st = vs.init_gan_state(self.pcfg, 0, 'cpu')
        weights.load_flax(st.generator, gtree)
        weights.load_flax(st.discriminators, dtree)
        self.whole, self.whole_m = vs.gan_train_step(self.pcfg, st, tb, tnoise, SPE)
        self.lr = {'gen': hv.learning_rate_g, 'disc': hv.learning_rate_d}
        if wav_nan:
            return
        # the phases: D from the common start, G against the reference's D
        self.port = vs.init_gan_state(self.pcfg, 0, 'cpu')
        weights.load_flax(self.port.generator, gtree)
        weights.load_flax(self.port.discriminators, dtree)
        y_gt = vs.apply_generator(self.pcfg, self.port.generator, tb, tnoise)
        d_aux = vs.discriminator_phase(self.pcfg, self.port, tb['wav'], y_gt.detach(), SPE)
        self.port_d = {n: (p.detach().clone(), p.grad.clone())
                       for n, p in self.port.discriminators.named_parameters()}
        weights.load_flax(self.port.discriminators, self.jax['disc_params'])
        g_aux = vs.generator_phase(self.pcfg, self.port, tb['wav'], y_gt, SPE)
        d_aux['loss_disc_all'] = d_aux['loss_disc_s'] + d_aux['loss_disc_p'] + d_aux['loss_disc_t']
        self.tm = {k: float(v.detach()) for k, v in {**d_aux, **g_aux}.items()}

    def leaves(self, which):
        """(name, port param, port grad, port step's Adam state, reference
        updated param, reference first moment, reference gradient) per leaf
        of 'gen' or 'disc', all in the port's layout."""
        module, opt = ((self.port.generator, self.port.gen_opt) if which == 'gen'
                       else (self.port.discriminators, self.port.disc_opt))
        adam = _adam(self.jax['gen_opt' if which == 'gen' else 'disc_opt'])
        ref = {kind: weights.from_flax(module, tree) for kind, tree in (
            ('p', self.jax['gen_params' if which == 'gen' else 'disc_params']),
            ('mu', adam.mu), ('g', self.ref_g if which == 'gen' else self.ref_d))}
        for name, p in module.named_parameters():
            value, grad = (p.detach(), p.grad) if which == 'gen' else self.port_d[name]
            yield name, value, grad, opt.state[p], {k: ref[k][name] for k in ref}


@functools.lru_cache(maxsize=None)
def _run(name):
    return Run(name)


def _metric_close(got, ref, k, tol=1e-4):
    assert np.isfinite(ref), k
    assert abs(got - ref) <= tol * abs(ref) + 1e-6, (k, got, ref)


@pytest.mark.parametrize('case', sorted(CASES))
def test_metrics_match(case):
    run = _run(case)
    assert set(run.tm) == set(run.jm) == set(run.whole_m)
    for k, ref in run.jm.items():
        _metric_close(run.tm[k], ref, k, R1_TOL if k == 'loss_r1' else 1e-4)
    if run.jcfg.vocoder.r1_gamma > 0:
        assert run.jm['loss_r1'] > 0
    # the whole step: the discriminator side is the phase's, bit for bit
    for k in run.whole_m:
        if k.startswith(('loss_disc', 'sc_', 'loss_r1')):
            assert float(run.whole_m[k]) == run.tm[k], k
    assert run.whole.step == 1


@pytest.mark.parametrize('which', ['gen', 'disc'])
def test_reference_is_the_jax_step(which):
    """The reference equals the JAX package's own ``gan_train_step``: the
    metrics within 1e-4 relative; the step's gradients (its first moments)
    within 1e-2 of each leaf's norm of the reference's (the whole step sums
    the first STFT-discriminator conv's gradient in a cancelling order, and
    its generator sees its own updated discriminators); the updated
    parameters within 1e-2 x lr where the sign is resolved."""
    run = _run('refinegan_small')
    for k, v in run.step_m.items():
        _metric_close(run.ref_m[k], v, k)
    assert int(run.step['step']) == 1
    module = run.port.generator if which == 'gen' else run.port.discriminators
    params, opt = ('gen_params', 'gen_opt') if which == 'gen' else ('disc_params', 'disc_opt')
    step_p, ref_p = (weights.from_flax(module, t[params]) for t in (run.step, run.reference))
    step_mu = weights.from_flax(module, _adam(run.step[opt]).mu)
    ref_g = weights.from_flax(module, run.ref_g if which == 'gen' else run.ref_d)
    for name, g in ref_g.items():
        diff = float((step_mu[name] / (1 - run.jcfg.vocoder.adam_b1) - g).abs().max())
        assert diff <= 1e-2 * float(g.norm()) + 1e-30, (name, diff, float(g.norm()))
        err = (step_p[name] - ref_p[name]).abs()[g.abs() >= 1e-6 + diff]
        assert err.numel() == 0 or float(err.max()) <= 1e-2 * run.lr[which], name


# the R1 penalty changes only the discriminator phase
@pytest.mark.parametrize('case,which', [(c, w) for c in sorted(CASES) for w in ('gen', 'disc')
                                        if (c, w) != ('r1', 'gen')])
def test_gradients_and_updates_match(case, which):
    run = _run(case)
    hv = run.jcfg.vocoder
    lr = run.lr[which]
    tol = R1_TOL if which == 'disc' and hv.r1_gamma > 0 else GRAD_TOL
    checked = 0
    for name, p, grad, adam, ref in run.leaves(which):
        scale = float(ref['g'].norm())
        port_diff = float((grad - ref['g']).abs().max())
        assert port_diff <= tol * scale + 1e-30, (name, port_diff, scale)
        assert int(adam['step']) == 1
        torch.testing.assert_close(adam['exp_avg'], (1 - hv.adam_b1) * grad)
        step_diff = float((ref['mu'] / (1 - hv.adam_b1) - ref['g']).abs().max())
        live = ref['g'].abs() >= 1e-6 + max(port_diff, step_diff)
        err = (p - ref['p']).abs()[live]
        assert err.numel() == 0 or float(err.max()) <= 1e-2 * lr, (name, float(err.max()))
        checked += int(live.sum())
    assert checked > 0


def test_nan_guard_matches():
    """A NaN in the target makes every loss non-finite: both packages zero
    the gradients and still step (weight decay applies, the count moves)."""
    r = Run('refinegan_small', wav_nan=True, seed=41)
    assert not np.isfinite(r.jm['loss_gen_all'])
    assert not np.isfinite(float(r.whole_m['loss_gen_all']))
    st = r.whole
    for module, opt, which in ((st.generator, st.gen_opt, 'gen'),
                               (st.discriminators, st.disc_opt, 'disc')):
        adam = _adam(r.jax['gen_opt' if which == 'gen' else 'disc_opt'])
        ref_p = weights.from_flax(module, r.jax['gen_params' if which == 'gen'
                                               else 'disc_params'])
        ref_mu = weights.from_flax(module, adam.mu)
        for name, p in module.named_parameters():
            assert float(opt.state[p]['exp_avg'].abs().max()) == 0.0
            assert float(ref_mu[name].abs().max()) == 0.0
            torch.testing.assert_close(p.detach(), ref_p[name], atol=1e-2 * r.lr[which],
                                       rtol=0)
        assert {int(s['step']) for s in opt.state.values()} == {int(adam.count)} == {1}


def test_updates_per_step():
    """The default two discriminator updates and one generator update per
    step, each optimizer's count advancing by them."""
    _, pcfg = vocoder_cfg_pair(**SLIM)
    assert pcfg.vocoder.d_train_times == 2
    batch = {k: _t(v) for k, v in vocoder_batch(pcfg, seed=61).items()}
    st = vs.init_gan_state(pcfg, 0, 'cpu')
    for _ in range(2):
        st, m = vs.gan_train_step(pcfg, st, batch, torch.Generator().manual_seed(1), SPE)
    assert st.step == 2 and all(torch.isfinite(v) for v in m.values())
    assert {int(s['step']) for s in st.disc_opt.state.values()} == {4}
    assert {int(s['step']) for s in st.gen_opt.state.values()} == {2}


def test_learning_rate_across_an_epoch_boundary():
    """The port's optimizer against optax over 8 updates of a 3-update
    epoch (decay 0.5 per epoch, so that an off-by-one shows), for both
    schedules: G counts updates, D counts d_train_times per step."""
    jcfg, pcfg = vocoder_cfg_pair(lr_decay=0.5)
    hv = pcfg.vocoder
    spe = 3
    jg, jd = jvs.make_optimizers(jcfg, spe)
    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(8)]
    gen, disc = torch.nn.Linear(5, 1, bias=False), torch.nn.Linear(5, 1, bias=False)
    for m in (gen, disc):
        with torch.no_grad():
            m.weight.copy_(_t(p0)[None])
    tg, td_ = vs.make_optimizers(pcfg, gen, disc)
    for jopt, topt, mod, base, epoch in ((jg, tg, gen, hv.learning_rate_g, spe),
                                         (jd, td_, disc, hv.learning_rate_d,
                                          spe * hv.d_train_times)):
        p, s = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
        for k, g in enumerate(grads):
            u, s = jopt.update(jnp.asarray(g), s, p)
            p = optax.apply_updates(p, u)
            mod.weight.grad = _t(g)[None]
            vs._guarded_update(topt, torch.tensor(0.0),
                               vs.learning_rate(base, hv.lr_decay, k, epoch), 0.0)
            np.testing.assert_allclose(mod.weight.detach().numpy()[0], np.asarray(p),
                                       rtol=0, atol=1e-6)
    assert vs.learning_rate(1.0, 0.5, 2, 3) == 1.0 and vs.learning_rate(1.0, 0.5, 3, 3) == 0.5


def test_eval_step_matches():
    jcfg, pcfg = vocoder_cfg_pair()
    batch = vocoder_batch(jcfg, seed=51, b=1)
    gtree, _ = vocoder_trees(jcfg, batch, seed=52)
    y_j, mj = jvs.gan_eval_step(jcfg, gtree, {k: jnp.asarray(v) for k, v in batch.items()})
    st = vs.init_gan_state(pcfg, 0, 'cpu')
    weights.load_flax(st.generator, gtree)
    y_t, mt = vs.gan_eval_step(pcfg, st.generator, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4, rtol=0)
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4 * abs(float(mj[k])) + 1e-6, k


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        vs.init_gan_state(vocoder_cfg_pair()[1])
