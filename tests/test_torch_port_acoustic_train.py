"""Acoustic-model training: the port against the JAX package on the CPU at
``tests/test_train_cli.py``'s tiny configuration, from the same flax tree
and batch.

Random draws are shared or turned off on both sides:

* flax's ``nn.Dropout`` and ``GaussianNoise`` are identities under
  ``flax.linen.intercept_methods`` (``acoustic_interceptor``); the port
  gets ``Draws()`` with those streams off;
* the 'random' teacher-forcing coin of each step is a function of that
  step's input frame (``coin_of``), fed to the JAX cell by the same
  interceptor and to the port as ``Draws.coins``;
* the hoisted step's prenet masks are the JAX step's own
  (``jax.random.bernoulli`` on ``split(fold_in(key, 4))``), recomputed
  here and given to the port as ``Draws.prenet_keep``.

Tolerances (float32): forward outputs 1e-5 absolute plus 1e-5 relative;
each loss term and the gradient norm 1e-5 relative; each parameter's
gradient (Adam's first moment after one step, / (1 - b1)) within 1e-4 of
the larger of that leaf's norm and 1e-6 of the global norm (the keys'
biases of the dot attentions have a gradient that is 0 in exact
arithmetic, a constant per query row under the softmax, so theirs is
rounding); the updated parameters within 1e-2 x lr of the JAX step's
where the gradient's sign is resolved (Adam's first update is lr x g /
(|g| + eps)).  Port against port (hoisted against scanned, remat on
against off): 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (ACOUSTIC_KEYS, acoustic_batch, acoustic_cfg_pair,
                               acoustic_interceptor, acoustic_tree, coin_of,
                               jax_synthesizer, np_tree)
from transtacos_retunegan_tpu.models import acoustic as JA
from transtacos_retunegan_tpu.models import decoder_fast as JF
from transtacos_retunegan_tpu.train import acoustic_step as JS
from transtacos_retunegan_tpu.train import schedules as JSch
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron, compute_losses
from transtacos_retunegan_tpu_torch.models.decoder import teacher_inputs
from transtacos_retunegan_tpu_torch.models.decoder_fast import (DecoderCellFast,
                                                                fuse_cell_params)
from transtacos_retunegan_tpu_torch.models.layers import Draws, keep_mask
from transtacos_retunegan_tpu_torch.train import acoustic_step as PS
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train import schedules as PSch

pytestmark = pytest.mark.usefixtures('few_threads')
TOL = dict(atol=1e-5, rtol=1e-5)
OUTPUTS = ('mel_outputs', 'mag_outputs', 'stop_token_outputs', 'alignments',
           'f0_r', 'f0_r_pred', 'c0_r', 'c0_r_pred', 'prds_prob', 'E_text_sim')


def _rngs():
    return {k: jax.random.PRNGKey(i) for i, k in enumerate(('noise', 'dropout', 'tf'))}


def jax_forward(cfg, mutable=False):
    import flax.linen as fnn

    @jax.jit
    def run(variables, batch, tfr):
        with fnn.intercept_methods(acoustic_interceptor):
            return JA.Tacotron(cfg).apply(
                variables, *[batch[k] for k in ACOUSTIC_KEYS], tfr, train=True,
                rngs=_rngs(), mutable=['batch_stats'] if mutable else False)
    return run


def port_forward(model, tb, tfr, cfg):
    coins = None
    if cfg.acoustic.tf_method == 'random':
        coins = torch.from_numpy(coin_of(teacher_inputs(
            tb['mel_targets'], cfg.acoustic.outputs_per_step).numpy()))
    return model(*[tb[k] for k in ACOUSTIC_KEYS], tfr, train=True, draws=Draws(coins=coins))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize('method,tfr', [('force', 1.0), ('mix', 1.0), ('mix', 0.5),
                                        ('random', 0.5)])
def test_train_forward_matches(method, tfr):
    jcfg, pcfg = acoustic_cfg_pair(tf_method=method)
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    ref = jax_forward(jcfg)({'params': tree}, _jnp(batch), tfr)
    model = weights.load_flax(Tacotron(pcfg), tree)
    out = port_forward(model, _torch(batch), tfr, pcfg)
    if method == 'random':       # the fed coins take both branches
        coins = coin_of(teacher_inputs(torch.from_numpy(batch['mel_targets']), 5).numpy())
        assert (coins < tfr).any() and (coins >= tfr).any()
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def _loss_inputs(out_np, batch):
    keys = [k for k in OUTPUTS if k != 'alignments'] + ['E_prds_sim']
    return {k: np.array(out_np[k]) for k in keys}


def test_losses_and_their_gradients_match():
    """Each loss term of the port's ``compute_losses`` on the JAX
    forward's outputs, and its gradient with respect to those outputs
    (stop logits of exactly 0 included, where JAX's subgradients of
    max(x, 0) and |x|, 1/2 and 1, sum to 0 for a label of 0)."""
    jcfg, pcfg = acoustic_cfg_pair()
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    ref_out = jax_forward(jcfg)({'params': tree}, _jnp(batch), 1.0)
    outs = _loss_inputs(ref_out, batch)
    outs['stop_token_outputs'][:, ::7] = 0.0

    def jax_loss(o):
        return JA.compute_losses(o, _jnp(batch), jcfg, tree)
    ref = jax.jit(jax_loss)({k: jnp.asarray(v) for k, v in outs.items()})
    ref_g = jax.jit(jax.grad(lambda o: jax_loss(o)['loss']))(
        {k: jnp.asarray(v) for k, v in outs.items()})

    model = weights.load_flax(Tacotron(pcfg), tree)
    t_out = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    got = compute_losses(t_out, _torch(batch), pcfg, model)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    got['loss'].backward()
    for k, v in t_out.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref_g[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    # the masks are one length for the whole batch
    fmask_len = int(batch['frame_loss_len'])
    assert fmask_len < batch['mel_targets'].shape[1]


# ---------------------------------------------------------------------------
# one train step against the JAX step
# ---------------------------------------------------------------------------

def jax_step(cfg, hoisted):
    import flax.linen as fnn
    fn = (JS.train_step_hoisted if hoisted else JS.train_step).__wrapped__

    @jax.jit
    def run(state, batch, key):
        with fnn.intercept_methods(acoustic_interceptor):
            return fn(cfg, state, batch, key)
    return run


def jax_prenet_keep(cfg, key, steps, b):
    """The hoisted JAX step's prenet masks, scaled as the port's."""
    drops = jax.random.split(jax.random.fold_in(key, 4), len(cfg.acoustic.prenet_depths))
    return [torch.from_numpy(np.asarray(jax.random.bernoulli(d, 0.5, (steps * b, w)))
                             .reshape(steps, b, w).astype(np.float32) * 2.0)
            for d, w in zip(drops, cfg.acoustic.prenet_depths)]


def _jax_state(cfg, tree, step):
    opt = JS.make_optimizer(cfg).init(tree)
    opt = (opt[0], opt[1], opt[2]._replace(count=jnp.asarray(step, jnp.int32)))
    return JS.TrainState(jnp.asarray(step, jnp.int32), tree, opt, {})


def _check_step(pcfg, pstate, plosses, jnew, jlosses):
    assert set(plosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=1e-5,
                                   err_msg=k)
    module = Tacotron(pcfg)
    ref_mu = weights.from_flax(module, jax.tree.map(np.asarray, jnew.opt_state[1].mu))
    ref_p = weights.from_flax(module, jax.tree.map(np.asarray, jnew.params))
    gnorm = float(jlosses['grad_norm'])
    lr = float(plosses['learning_rate'])
    checked = 0
    for name, p in pstate.model.named_parameters():
        g = pstate.opt.state[p]['exp_avg'] / 0.1
        rg = ref_mu[name] / 0.1
        diff = float((g - rg).abs().max())
        assert diff <= 1e-4 * max(float(rg.norm()), 1e-6 * gnorm), name
        live = rg.abs() >= 1e-6 + diff
        err = (p.detach() - ref_p[name]).abs()[live]
        if err.numel():
            assert float(err.max()) <= 1e-2 * lr, name
            checked += int(live.sum())
    assert checked > 0.9 * sum(p.numel() for p in pstate.model.parameters())


@pytest.mark.parametrize('method,step,hoisted', [
    ('mix', 4000, False), ('mix', 4000, True), ('mix', 120000, False),
    ('random', 120000, False)], ids=['scanned', 'hoisted', 'scanned-tfr<1', 'random-tfr<1'])
def test_train_step_matches_jax(method, step, hoisted):
    """One step from a common start: steps past the warm-up (a rate of
    about 1e-3, so that the update is well above the float32 spacing of
    the parameters), and past the teacher-forcing decay (tfr < 1, the
    gradient flows through the previous prediction)."""
    jcfg, pcfg = acoustic_cfg_pair(tf_method=method)
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    key = jax.random.PRNGKey(11)
    jnew, jlosses = jax_step(jcfg, hoisted)(_jax_state(jcfg, tree, step), _jnp(batch), key)
    model = weights.load_flax(Tacotron(pcfg), tree)
    state = PS.TrainState(step, model, PS.make_optimizer(pcfg, model))
    tb = _torch(batch)
    steps, b = tb['mel_targets'].shape[1] // 5, tb['text'].shape[0]
    coins = (torch.from_numpy(coin_of(teacher_inputs(tb['mel_targets'], 5).numpy()))
             if method == 'random' else None)
    keep = jax_prenet_keep(jcfg, key, steps, b) if hoisted else None
    fn = PS.train_step_hoisted if hoisted else PS.train_step
    state, losses = fn(pcfg, state, tb, Draws(coins=coins, prenet_keep=keep))
    assert state.step == step + 1
    _check_step(pcfg, state, losses, jnew, jlosses)


def _port_step(pcfg, tree, batch, fn, draws, step=0):
    model = weights.load_flax(Tacotron(pcfg), tree)
    state = PS.TrainState(step, model, PS.make_optimizer(pcfg, model))
    _, losses = fn(pcfg, state, _torch(batch), draws)
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()}


def _same(a, b, tol=1e-5):
    la, ga = a
    lb, gb = b
    for k in la:
        np.testing.assert_allclose(float(la[k]), float(lb[k]), rtol=tol, err_msg=k)
    for k in ga:
        np.testing.assert_allclose(ga[k].numpy(), gb[k].numpy(), rtol=tol, atol=tol * 1e-2,
                                   err_msg=k)


@pytest.mark.parametrize('fast_cell', [False, True])
def test_hoisted_equals_scanned_while_eligible(fast_cell):
    """Before the teacher-forcing decay both steps compute one function:
    with the same prenet masks, the same losses and gradients."""
    jcfg, pcfg = acoustic_cfg_pair(fast_cell=fast_cell)
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    assert PS.hoist_force_eligible(pcfg, 0)
    g = torch.Generator().manual_seed(3)
    keep = [keep_mask((8, 2, w), 0.5, g, 'cpu') for w in pcfg.acoustic.prenet_depths]
    _same(_port_step(pcfg, tree, batch, PS.train_step, Draws(prenet_keep=keep)),
          _port_step(pcfg, tree, batch, PS.train_step_hoisted, Draws(prenet_keep=keep)))


@pytest.mark.parametrize('hoisted', [False, True])
def test_remat_on_equals_off(hoisted):
    """Recomputing each decode step in the backward pass changes nothing:
    the dropout masks are drawn before the step loop."""
    runs = []
    for remat in (True, False):
        jcfg, pcfg = acoustic_cfg_pair(remat_decoder=remat)
        tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
        gens = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
        fn = PS.train_step_hoisted if hoisted else PS.train_step
        runs.append(_port_step(pcfg, tree, batch, fn, Draws(*gens), step=30000))
    _same(*runs, tol=1e-6)


def test_draws_are_used():
    """With the noise and dropout streams on, the step draws: the losses
    differ from the draw-free step and repeat for the same seeds."""
    jcfg, pcfg = acoustic_cfg_pair()
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)

    def run(seed):
        gens = None if seed is None else [torch.Generator().manual_seed(seed + i)
                                          for i in range(3)]
        return float(_port_step(pcfg, tree, batch, PS.train_step,
                                Draws(*gens) if gens else Draws())[0]['loss'])
    assert run(1) == run(1) != run(None)


# ---------------------------------------------------------------------------
# the other model variants: CBHG encoder, sew layer, fused cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', ['cb', 'sew', 'fast_cell'])
def test_variant_forward_matches(variant):
    kw = {'cb': dict(encoder_type='cb', embed_depth=32),
          'sew': dict(decoder_sew_layer=True),
          'fast_cell': dict(fast_cell=True)}[variant]
    jcfg, pcfg = acoustic_cfg_pair(**kw)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    batch = acoustic_batch(jcfg)
    variables = {'params': tree, **({'batch_stats': stats} if stats else {})}
    ref = jax_forward(jcfg, mutable=bool(stats))(variables, _jnp(batch), 0.7)
    model = weights.load_flax(Tacotron(pcfg), tree, stats)
    out = port_forward(model, _torch(batch), 0.7, pcfg)
    if stats:
        ref, new_stats = ref
        state = model.state_dict()
        for path, v in weights.flatten(jax.tree.map(np.asarray, new_stats['batch_stats'])).items():
            np.testing.assert_allclose(state['.'.join(path)].numpy(), v, **TOL,
                                       err_msg='/'.join(path))
    keys = [k for k in OUTPUTS if not (variant == 'cb' and k.startswith(('f0', 'c0')))]
    for k in keys:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_cb_encoder_inference_uses_running_stats():
    jcfg, pcfg = acoustic_cfg_pair(encoder_type='cb', embed_depth=32)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    batch = acoustic_batch(jcfg)
    ref = jax.jit(lambda v, t, n: JA.Tacotron(jcfg).apply(
        v, t, n, train=False, encoder_only=True))(
            {'params': tree, 'batch_stats': stats}, batch['text'], batch['text_lengths'])
    model = weights.load_flax(Tacotron(pcfg), tree, stats)
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        out = model(torch.from_numpy(batch['text']), torch.from_numpy(batch['text_lengths']))
    for k in ('keys', 'values', 'mask'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cb_encoder_needs_equal_widths():
    """The CBHG residual adds the embeddings to the projections, so both
    packages refuse ``embed_depth != encoder_depth``: the JAX module's
    ``Dense`` after the residual, meant for that case, is never reached
    (ROADMAP Faults)."""
    jcfg, pcfg = acoustic_cfg_pair(encoder_type='cb', embed_depth=16)
    with pytest.raises(TypeError, match='incompatible shapes'):
        acoustic_tree(jcfg)
    with pytest.raises(ValueError, match='embed_depth == encoder_depth'):
        Tacotron(pcfg)


@pytest.mark.parametrize('variant', ['sa', 'cb', 'sew', 'fast_cell'])
def test_from_flax_consumes_every_acoustic_tree(variant):
    kw = {'sa': {}, 'cb': dict(encoder_type='cb', embed_depth=32),
          'sew': dict(decoder_sew_layer=True), 'fast_cell': dict(fast_cell=True)}[variant]
    jcfg, pcfg = acoustic_cfg_pair(**kw)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    model = Tacotron(pcfg)
    state = weights.from_flax(model, tree, stats)
    n_leaves = len(weights.flatten(tree)) + len(weights.flatten(stats or {}))
    assert len(state) == n_leaves == len(model.state_dict())
    # the L2 term runs over exactly the flax tree's parameters
    assert (sum(p.numel() for p in model.parameters())
            == sum(v.size for v in weights.flatten(tree).values()))
    if variant == 'cb':
        with pytest.raises(ValueError, match='missing'):
            weights.from_flax(model, tree)                 # batch stats required


def test_fuse_cell_params_matches_jax():
    jcfg, pcfg = acoustic_cfg_pair()
    tree = acoustic_tree(jcfg)
    stock = weights.load_flax(Tacotron(pcfg), tree).decoder_cell
    got = fuse_cell_params(stock.state_dict())
    _, fcfg = acoustic_cfg_pair(fast_cell=True)
    ref = weights.from_flax(DecoderCellFast(fcfg), jax.tree.map(
        np.asarray, JF.fuse_cell_params(tree['decoder_cell'])))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_fast_cell_tree_serves_like_jax(monkeypatch):
    """A JAX ``fast_cell`` tree (here the fused layout of the JAX
    Synthesizer's own tree) loads into the port with every leaf consumed
    and ``tts_fused`` gives the JAX Synthesizer's wav (no stop: bias -20;
    the JAX request's Griffin-Lim phase passed in; 1e-4 absolute, as
    ``tests/test_torch_port_slice.py``)."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    jsynth = jax_synthesizer()
    stock = jsynth.acoustic_params
    fused = dict(stock, decoder_cell=JF.fuse_cell_params(stock['decoder_cell']))
    fused['decoder_cell']['out_projection'] = dict(fused['decoder_cell']['out_projection'])
    r = jsynth.cfg.acoustic.outputs_per_step
    bias = np.asarray(fused['decoder_cell']['out_projection']['bias']).copy()
    bias[-r:] = -20.0
    fused['decoder_cell']['out_projection']['bias'] = jnp.asarray(bias)
    _, fcfg = acoustic_cfg_pair(fast_cell=True)
    port = Synthesizer(fcfg, acoustic_params=np_tree(fused),
                       gen_params=np_tree(jsynth.gen_params), devices=['cpu'])
    frames = jsynth.cfg.acoustic.max_iters * r
    key = jax.random.fold_in(jax.random.PRNGKey(114514), 0)
    monkeypatch.setattr(jsynth, '_next_key', lambda: key)
    monkeypatch.setattr(jsynth, 'acoustic_params', fused)
    theta = torch.tensor(np.asarray(2.0 * jnp.pi * jax.random.uniform(
        key, (jsynth.cfg.audio.n_freq, frames))))
    ref = jsynth.tts_fused('ni3 hao3 shi4 jie4')
    got = port.tts_fused('ni3 hao3 shi4 jie4', theta=theta)
    assert isinstance(port.acoustic.decoder_cell, DecoderCellFast)
    assert got.shape == ref.shape == (256 * frames,)
    np.testing.assert_allclose(got, ref, atol=1e-4)


# ---------------------------------------------------------------------------
# schedules, eligibility, summaries, inference, checkpoints
# ---------------------------------------------------------------------------

def test_schedules_match_jax():
    jcfg, pcfg = acoustic_cfg_pair()
    for step in (0, 1, 2, 999, 3999, 4000, 4001, 19999, 20000, 20001, 120000, 220000, 300000):
        np.testing.assert_allclose(PSch.noam_lr(step, pcfg.acoustic),
                                   float(JSch.noam_lr(jnp.asarray(step), jcfg.acoustic)),
                                   rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(PSch.teacher_forcing_ratio(step, pcfg.acoustic),
                                   float(JSch.teacher_forcing_ratio(jnp.asarray(step),
                                                                    jcfg.acoustic)),
                                   rtol=1e-6, atol=1e-7, err_msg=str(step))
    assert PSch.noam_lr(0, pcfg.acoustic) == pytest.approx(2.5e-7, rel=1e-5)


@pytest.mark.parametrize('kw', [dict(tf_method='force'), dict(tf_method='mix'),
                                dict(tf_method='random'), dict(tf_init=0.9),
                                dict(decoder_sew_layer=True)])
def test_hoist_force_eligible_matches_jax(kw):
    jcfg, pcfg = acoustic_cfg_pair(**kw)
    for step in (0, 19999, 20000, 50000):
        assert PS.hoist_force_eligible(pcfg, step) == JS.hoist_force_eligible(jcfg, step)


def test_summary_stats_leave_the_state():
    jcfg, pcfg = acoustic_cfg_pair()
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    model = weights.load_flax(Tacotron(pcfg), tree)
    state = PS.TrainState(0, model, PS.make_optimizer(pcfg, model))
    before = copy.deepcopy(model.state_dict())
    stats = PS.summary_stats(pcfg, state, _torch(batch))
    assert set(stats['grad_norms']) == {n for n, _ in model.named_parameters()}
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, grads = _port_step(pcfg, tree, batch, PS.train_step, Draws())
    for n, g in grads.items():            # the step's grads are clipped
        assert float(stats['grad_norms'][n]) >= float(g.norm()) * (1 - 1e-5), n


def test_infer_step_matches_jax():
    jcfg, pcfg = acoustic_cfg_pair()
    tree, batch = acoustic_tree(jcfg), acoustic_batch(jcfg)
    steps = 6
    ref = JS.infer_step(jcfg, tree, {k: jnp.asarray(batch[k]) for k in ('text', 'text_lengths')},
                        steps)
    model = weights.load_flax(Tacotron(pcfg), tree)
    out = PS.infer_step(pcfg, model, _torch(batch), steps)
    for k in ('mel_outputs', 'mag_outputs', 'stop_token_outputs', 'alignments'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(out['out_lengths'].numpy(), np.asarray(ref['out_lengths']))


def test_checkpoint_round_trip(tmp_path):
    jcfg, pcfg = acoustic_cfg_pair(encoder_type='cb', embed_depth=32)
    tree, stats = acoustic_tree(jcfg, with_stats=True)
    batch = _torch(acoustic_batch(jcfg))
    state = PS.init_state(pcfg, 0, 'cpu')
    weights.load_flax(state.model, tree, stats)
    PS.train_step_hoisted(pcfg, state, batch, Draws())
    assert set(state.extra_vars) == {k for k in state.model.state_dict()
                                     if k.endswith(('.mean', '.var'))}
    paths = [ckpt.save_acoustic(str(tmp_path), state, keep=1)]
    PS.train_step_hoisted(pcfg, state, batch, Draws())
    paths.append(ckpt.save_acoustic(str(tmp_path), state, keep=1))
    assert sorted(p.name for p in tmp_path.iterdir()) == ['ckpt_00000002']
    fresh = PS.init_state(pcfg, 1, 'cpu')
    assert ckpt.restore_acoustic(str(tmp_path), fresh) is fresh and fresh.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = state.opt.state_dict()['state'], fresh.opt.state_dict()['state']
    assert all(torch.equal(a[i]['exp_avg'], b[i]['exp_avg']) for i in a)
    served = ckpt.load_acoustic_params(str(tmp_path))
    assert served.keys() == state.model.state_dict().keys()
    assert ckpt.restore_acoustic(str(tmp_path / 'none'), fresh) is None
