"""Decode: the port's plain versions of both decode kernels (which the CUDA
kernels are held to on the card) and its plain torch decoder loop, against
the JAX ``DecoderCell`` scan and the Pallas kernels in interpret mode, on
the same weights and encoder memory.

Tolerances: float32 weights 2e-4 absolute (as ``tests/test_fused_decoder``
holds Pallas to the flax scan: six autoregressive steps of float32 sums in
different orders).  bf16 weights: both sides round the same operands to
bf16 and accumulate in float32, but a sum order difference can flip one
bf16 rounding of an activation, which the autoregression carries; 0.05
absolute on the mel, as ``test_bf16_close`` allows.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import distinct_stop_bias, np_tree
from transtacos_retunegan_tpu.config import Config as JConfig
from transtacos_retunegan_tpu.models import decoder as jdec
from transtacos_retunegan_tpu.ops import fused_decoder as JF
from transtacos_retunegan_tpu_torch.config import Config as PConfig
from transtacos_retunegan_tpu_torch.models import decoder as pdec
from transtacos_retunegan_tpu_torch.ops import fused_decoder as PF
from transtacos_retunegan_tpu_torch.weights import load_flax

pytestmark = pytest.mark.usefixtures('few_threads')

B, N, STEPS = 2, 24, 6
R = 5
KEYS = ('mel_outputs', 'stop_token_outputs', 'alignments')


def _cfgs(prenet=(32,), layers=2):
    small = dict(decoder_depth=64, attention_depth=16, prenet_depths=prenet,
                 decoder_layers=layers, encoder_depth=32)
    return tuple(dataclasses.replace(c(), acoustic=dataclasses.replace(
        c().acoustic, **small)) for c in (JConfig, PConfig))


@functools.lru_cache(maxsize=None)
def _jax_cell(prenet, layers):
    """Jitted init and scan of the JAX infer-mode cell (a jitted program is
    reused across cases; op-by-op execution takes seconds each time)."""
    jcfg = _cfgs(prenet, layers)[0]
    cell = jdec.make_scanned_cell(jcfg, 'infer')
    xs = {'target_prev': jnp.zeros((STEPS, B, 80))}
    carry = lambda attn: (jdec.init_carry(B, N, jcfg), attn, jnp.asarray(0.0))  # noqa: E731
    init = jax.jit(lambda rng, attn: cell.init({'params': rng}, carry(attn), xs)['params'])
    scan = jax.jit(lambda params, attn: cell.apply({'params': params}, carry(attn), xs)[1])
    return init, scan


@functools.partial(jax.jit, static_argnums=(1, 5, 6, 7))
def _pallas(params, jcfg, keys, values, mask, full, dtype, early_exit):
    """The Pallas decode kernels in interpret mode, under jit."""
    if full:
        return JF.fused_decode_full(params, jcfg, keys, values, mask, STEPS,
                                    interpret=True, dtype=dtype, early_exit=early_exit)
    return JF.fused_decode(params, jcfg, keys, values, mask, STEPS,
                           interpret=True, dtype=dtype)


class Case:
    """One decode problem: JAX cell params, the bridged port cell, memory."""

    def __init__(self, prenet=(32,), layers=2, seed=0, short=5, edit=None):
        self.jcfg, self.pcfg = _cfgs(prenet, layers)
        r = np.random.RandomState(seed)
        keys = r.randn(B, N, 16).astype(np.float32) * 0.3
        values = r.randn(B, N, 32).astype(np.float32) * 0.3
        lens = np.asarray([N, N - short])
        mask = (np.arange(N)[None, :] < lens[:, None]).astype(np.float32)
        values = values * mask[..., None]
        self.np = (keys, values, mask)
        self.attn = jdec.AttentionParams(*map(jnp.asarray, self.np))
        self.init, self.scan = _jax_cell(prenet, layers)
        params = np_tree(self.init(jax.random.PRNGKey(seed), self.attn))
        if edit:
            edit(params, r)
        self.params = params
        self.cell = load_flax(pdec.DecoderCell(self.pcfg), params)
        self.t = tuple(map(torch.from_numpy, self.np))

    def flax_scan(self):
        ys = self.scan(self.params, self.attn)
        fin = np.asarray(ys['finished'])
        first = fin.argmax(0)
        return {'mel_outputs': ys['frames'].transpose(1, 0, 2).reshape(B, STEPS * R, 80),
                'stop_token_outputs': ys['stop'].transpose(1, 0, 2).reshape(B, STEPS * R),
                'alignments': ys['alignments'].transpose(1, 2, 0),
                'out_lengths': np.where(fin.any(0), first + 1, STEPS) * R}

    def pallas(self, full, dtype=jnp.float32, early_exit=False):
        a = self.attn
        return _pallas(self.params, self.jcfg, a.keys, a.values, a.mask, full,
                       dtype, early_exit)

    def port(self, kind, dtype=torch.float32, early_exit=False):
        if kind == 'model':
            return pdec.decode(self.cell, pdec.AttentionParams(*self.t), STEPS)
        fp = PF.fold_params(self.cell, dtype)
        if kind == 'step':
            return PF.fused_decode(fp, *self.t, STEPS)
        return PF.fused_decode_full(fp, *self.t, STEPS, early_exit=early_exit)


def _compare(got, ref, atol, trim=False):
    lengths = np.asarray(ref['out_lengths'])
    np.testing.assert_array_equal(got['out_lengths'].numpy(), lengths)
    np.testing.assert_allclose(got['mel_outputs'].numpy(),
                               np.asarray(ref['mel_outputs']), atol=atol)
    for k in KEYS[1:]:
        g, r = got[k].numpy(), np.asarray(ref[k])
        for i in range(B):
            n = lengths[i] if trim else STEPS * R
            sl = np.s_[i, :n] if k == 'stop_token_outputs' else np.s_[i, :, :n // R]
            np.testing.assert_allclose(g[sl], r[sl], atol=atol, err_msg=k)


@pytest.fixture(scope='module')
def default():
    return Case()


def test_default_depths_f32(default):
    refs = {'scan': default.flax_scan(), 'step': default.pallas(False),
            'full': default.pallas(True),
            'full_ee': default.pallas(True, early_exit=True)}
    ports = {'model': default.port('model'), 'step': default.port('step'),
             'full': default.port('full'),
             'full_ee': default.port('full', early_exit=True)}
    for rk, ref in refs.items():
        for pk, got in ports.items():
            _compare(got, ref, 2e-4, trim='ee' in rk or 'ee' in pk)


def test_default_depths_bf16(default):
    ref = default.pallas(True, dtype=jnp.bfloat16, early_exit=True)
    for kind, ee in (('step', False), ('full', True)):
        got = default.port(kind, torch.bfloat16, early_exit=ee)
        np.testing.assert_array_equal(got['out_lengths'].numpy(),
                                      np.asarray(ref['out_lengths']))
        diff = np.abs(got['mel_outputs'].numpy() - np.asarray(ref['mel_outputs']))
        assert diff.max() < 0.05, diff.max()


def test_nondefault_prenet_and_gru_depths():
    case = Case(prenet=(48, 32), layers=3, seed=3, short=7)
    ref = case.pallas(True)
    for kind in ('model', 'step', 'full'):
        _compare(case.port(kind), ref, 2e-4)


def _set_stop_bias(value, gain=1.0):
    """Stop head edit: every stop bias at ``value``, the kernel scaled by
    ``gain`` (the init's stop logits differ by only ~0.01 between steps)."""
    def edit(params, _):
        stop = params['stop_projection']
        stop['bias'] = np.full_like(stop['bias'], value)
        stop['kernel'] = stop['kernel'] * np.float32(gain)
    return edit


def test_no_stop_runs_all_steps():
    case = Case(edit=_set_stop_bias(-20.0))
    ref = case.pallas(True, early_exit=True)
    assert (np.asarray(ref['out_lengths']) == STEPS * R).all()
    _compare(case.port('full', early_exit=True), ref, 2e-4)
    _compare(case.port('step'), ref, 2e-4)


def test_rows_stop_at_different_steps():
    probe = Case(edit=_set_stop_bias(-20.0, gain=30.0))
    stop = probe.port('full')['stop_token_outputs'].numpy()
    bias, steps = distinct_stop_bias(stop, R, -20.0)
    case = Case(edit=_set_stop_bias(bias, gain=30.0))
    ref = case.pallas(True, early_exit=True)
    lengths = np.asarray(ref['out_lengths'])
    assert lengths[0] != lengths[1] and (lengths < STEPS * R).all(), lengths
    np.testing.assert_array_equal(lengths, steps * R)
    for ee in (True, False):
        _compare(case.port('full', early_exit=ee), ref, 2e-4, trim=True)
    _compare(case.port('step'), case.pallas(False), 2e-4)


def test_fit_check_falls_back_to_step_kernel(default, monkeypatch):
    calls = []
    step = PF.fused_decode
    monkeypatch.setattr(PF, 'fused_decode', lambda *a: calls.append(1) or step(*a))
    monkeypatch.setattr(PF, 'SMEM_BUDGET_BYTES', 0)
    got = default.port('full', early_exit=True)
    assert calls, 'budget 0 must route to the per-step kernel'
    _compare(got, default.pallas(False), 2e-4)


def test_trained_location_conv_bias():
    """Non-zero location-conv and attention biases (a trained checkpoint's)
    must survive folding."""
    def edit(params, r):
        lsa = params['lsa']
        conv = lsa['location_convolution']
        conv['bias'] = r.randn(*conv['bias'].shape).astype(np.float32)
        lsa['attention_bias'] = (0.3 * r.randn(*lsa['attention_bias'].shape)
                                 ).astype(np.float32)
    case = Case(edit=edit, seed=9)
    ref = case.flax_scan()
    for kind in ('step', 'full'):
        _compare(case.port(kind), ref, 2e-4)
