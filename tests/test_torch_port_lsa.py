"""The port's fused LSA step (``ops/lsa_kernel.py``; on the CPU its plain
version) against the JAX op: the Pallas kernel in interpret mode and
``lsa_step_reference``, on the same numpy inputs; and the CUDA kernel's
split of a row over a cluster of CTAs (``lsa_plan``) with its merge of the
tiles' softmax and context, written out in torch and held to the same
references.

Tolerances are ``tests/test_ops.py``'s: 1e-5 absolute on the alignment and
the cumulative alignment, 1e-4 on the context (float32 throughout; the two
sides differ only in the order of their sums, and the context sums N
products of values of order 1).  The LSA module against the op takes
``test_ops.py``'s 2e-5, since the module convolves and projects in two steps
where the op uses the folded matrix.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu.models.decoder import AttentionParams, LSAStep
from transtacos_retunegan_tpu.ops import lsa_kernel as K
from transtacos_retunegan_tpu_torch.models import decoder as pdec
from transtacos_retunegan_tpu_torch.ops import lsa_kernel as PK
from transtacos_retunegan_tpu_torch.weights import load_flax

pytestmark = pytest.mark.usefixtures('few_threads')

TOL = {'align': 1e-5, 'cum': 1e-5, 'ctx': 1e-4}


def _inputs(b=4, n=128, a=128, d=256, kwin=31, seed=0, lens=None):
    """``test_ops._inputs`` with a window width and text lengths to choose."""
    r = np.random.RandomState(seed)
    q = r.randn(b, a).astype(np.float32)
    cum = np.abs(r.randn(b, n)).astype(np.float32)
    keys = r.randn(b, n, a).astype(np.float32) * 0.1
    values = r.randn(b, n, d).astype(np.float32)
    if lens is None:
        lens = r.randint(n // 2, n + 1, size=b)
    mask = (np.arange(n)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    loc_mat = r.randn(kwin, a).astype(np.float32) * 0.05
    v = r.randn(a).astype(np.float32) * 0.1
    bias = r.randn(a).astype(np.float32) * 0.01
    return q, cum, keys, values, mask, loc_mat, v, bias


def _port(args):
    return [x.numpy() for x in PK.lsa_step_fused(*map(torch.from_numpy, args))]


def _close(got, ref):
    for name, g, r in zip(TOL, got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=TOL[name], rtol=TOL[name] if name == 'ctx' else 0,
                                   err_msg=name)


@pytest.mark.parametrize('shape', [(4, 128, 128, 256, 31), (2, 16, 128, 256, 5),
                                   (8, 64, 128, 256, 31), (3, 24, 16, 32, 5)],
                         ids=lambda s: 'B{}-N{}-A{}-D{}-k{}'.format(*s))
def test_matches_pallas_and_reference(shape):
    b, n, a, d, kwin = shape
    args = _inputs(b, n, a, d, kwin, seed=n + kwin)
    got = _port(args)
    _close(got, K.lsa_step_fused(*map(jnp.asarray, args), interpret=True))
    _close(got, K.lsa_step_reference(*map(jnp.asarray, args)))


def test_masked_rows_and_an_all_masked_row():
    """Short texts and a row with no valid position: that row's alignment
    and context are zeros and its cum is unchanged, as the Pallas kernel
    gives them (the reference's -inf fill would give NaN)."""
    args = _inputs(4, 64, 128, 256, 31, seed=5, lens=[64, 3, 1, 0])
    got = _port(args)
    _close(got, K.lsa_step_fused(*map(jnp.asarray, args), interpret=True))
    align, cum, ctx = got
    assert np.isfinite(align).all() and (align[3] == 0).all() and (ctx[3] == 0).all()
    np.testing.assert_array_equal(cum[3], args[1][3])
    assert (align[1, 3:] == 0).all() and abs(align[1].sum() - 1) < 1e-6
    np.testing.assert_allclose(align[:3].sum(-1), 1.0, atol=1e-5)


def _lsa_tree(a, f, h, kwin, seed):
    """A flax ``LSAStep`` parameter tree (numpy) with non-zero biases."""
    r = np.random.RandomState(seed)
    return {'query_layer': {'kernel': r.randn(h, a).astype(np.float32) / np.sqrt(h)},
            'location_convolution': {'kernel': r.randn(kwin, 1, f).astype(np.float32) * 0.2,
                                     'bias': r.randn(f).astype(np.float32) * 0.1},
            'location_layer': {'kernel': r.randn(f, a).astype(np.float32) / np.sqrt(f)},
            'attention_variable': r.randn(a, 1).astype(np.float32) * 0.1,
            'attention_bias': r.randn(a).astype(np.float32) * 0.01}


@pytest.mark.parametrize('kwin', [5, 31])
def test_fold_location_params_matches_jax(kwin):
    """The fold of the port's layouts (conv ``[F, 1, k]``, dense ``[A, F]``,
    reached through the weight bridge) equals the JAX fold of the flax
    layouts."""
    tree = _lsa_tree(128, 32, 64, kwin, seed=kwin)
    lsa = load_flax(pdec.LSA(64, 128, 32, kwin), tree)
    got = PK.fold_location_params(lsa.location_convolution.weight,
                                  lsa.location_layer.weight).detach().numpy()
    ref = np.asarray(K.fold_location_params(tree['location_convolution']['kernel'],
                                            tree['location_layer']['kernel']))
    assert got.shape == (kwin, 128)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _flax_lsa():
    module = LSAStep(attention_dim=16)
    init = jax.jit(lambda rng, q, c, attn: module.init(rng, q, c, attn))
    apply = jax.jit(lambda v, q, c, attn: module.apply(v, q, c, attn))
    return init, apply


def test_model_lsa_module_matches_the_op():
    """As ``test_ops.py`` holds the flax ``LSAStep`` to the op: the port's
    ``models.decoder.LSA`` (flax parameters loaded through the bridge, with
    a non-zero location-conv bias folded into the energy bias) against the
    port's op and the flax module."""
    r = np.random.RandomState(3)
    b, n, a, d, h = 2, 128, 16, 32, 64
    query = r.randn(b, h).astype(np.float32)
    cum = np.abs(r.randn(b, n)).astype(np.float32)
    keys = r.randn(b, n, a).astype(np.float32) * 0.1
    values = r.randn(b, n, d).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    attn = AttentionParams(*map(jnp.asarray, (keys, values, mask)))
    init, apply = _flax_lsa()
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jnp.asarray(query),
                                         jnp.asarray(cum), attn)['params'])
    tree = dict(tree)
    conv = dict(tree['location_convolution'])
    conv['bias'] = r.randn(*conv['bias'].shape).astype(np.float32) * 0.1
    tree['location_convolution'] = conv
    align_m, cum_m = apply({'params': tree}, jnp.asarray(query), jnp.asarray(cum), attn)

    lsa = load_flax(pdec.LSA(h, a), tree)
    t = lambda x: torch.from_numpy(x)                                   # noqa: E731
    with torch.no_grad():
        align_p, cum_p = lsa(t(query), t(cum), pdec.AttentionParams(t(keys), t(values), t(mask)))
        wloc = lsa.location_layer.weight
        align_f, cum_f, ctx_f = PK.lsa_step_fused(
            lsa.query_layer(t(query)), t(cum), t(keys), t(values), t(mask),
            PK.fold_location_params(lsa.location_convolution.weight, wloc),
            lsa.attention_variable[:, 0],
            lsa.attention_bias + lsa.location_convolution.bias @ wloc.t())
    for got in (align_p, align_f):
        np.testing.assert_allclose(got.numpy(), np.asarray(align_m), atol=2e-5)
    for got in (cum_p, cum_f):
        np.testing.assert_allclose(got.numpy(), np.asarray(cum_m), atol=2e-5)
    np.testing.assert_allclose(ctx_f.numpy(), np.einsum('bn,bnd->bd', align_p.numpy(), values),
                               rtol=1e-4, atol=1e-5)


def test_lsa_plan_covers_every_text_length():
    """``lsa_plan``: at most 8 CTAs (the portable cluster size) of at least
    8 positions, which cover N, the last one non-empty."""
    for n in range(1, 513):
        c, p = PK.lsa_plan(n)
        assert 1 <= c <= 8 and p >= 8 and c * p >= n and (c - 1) * p < n, n
    assert [PK.lsa_plan(n) for n in (1, 8, 9, 16, 64, 65, 128, 256)] == [
        (1, 8), (1, 8), (2, 8), (2, 8), (8, 8), (8, 9), (8, 16), (8, 32)]


def _cluster_merge(q, cum, keys, values, mask, loc_mat, v, b):
    """The CUDA kernel's algebra in torch: the energies as the plain
    version computes them, then per CTA tile r of ``lsa_plan`` its max m_r,
    weights w = exp(e - m_r) * valid, their sum s_r and the unnormalised
    partial context; merged in rank order into M = max m_r and
    S = sum s_r exp(m_r - M).  Returns (align, cum', ctx) and, per tile,
    its share ``s_r exp(m_r - M)`` and its scaled partial context."""
    n, kwin = cum.shape[1], loc_mat.shape[0]
    c, p = PK.lsa_plan(n)
    windows = torch.nn.functional.pad(cum, (kwin // 2, kwin // 2)).unfold(1, kwin, 1)
    e = torch.tanh(keys + q[:, None, :] + windows @ loc_mat + b) @ v
    valid = mask > 0
    e = torch.where(valid, e, torch.full_like(e, -1e30))
    tiles = [slice(r * p, min((r + 1) * p, n)) for r in range(c)]
    m = [e[:, t].amax(-1) for t in tiles]
    w = [torch.exp(e[:, t] - m_r[:, None]) * valid[:, t] for t, m_r in zip(tiles, m)]
    part = [torch.einsum('bn,bnd->bd', w_r, values[:, t]) for t, w_r in zip(tiles, w)]
    big = m[0]
    for m_r in m[1:]:
        big = torch.maximum(big, m_r)
    ex = [torch.exp(m_r - big) for m_r in m]
    den = torch.zeros_like(big)
    for w_r, ex_r in zip(w, ex):
        den = den + w_r.sum(-1) * ex_r
    den = den + 1e-30
    align = torch.cat([w_r * (ex_r / den)[:, None] for w_r, ex_r in zip(w, ex)], 1)
    ctx = torch.zeros_like(part[0])
    shares = []
    for part_r, w_r, ex_r in zip(part, w, ex):
        ctx = ctx + part_r * (ex_r / den)[:, None]
        shares.append((w_r.sum(-1) * ex_r, part_r * (ex_r / den)[:, None]))
    return (align, cum + align, ctx), shares


@pytest.mark.parametrize('b,n,kwin,jax_too', [(1, 1, 31, False), (1, 17, 31, True),
                                              (8, 64, 31, True), (8, 64, 5, False),
                                              (4, 128, 63, True), (8, 256, 31, False)],
                         ids=lambda x: str(x))
def test_cluster_merge_matches_plain_and_pallas(b, n, kwin, jax_too):
    """The tiles merged in rank order give the plain version's and the
    Pallas kernel's (interpret mode) results, for full rows, a row that ends
    inside the first tile (its other tiles all masked) and an all-masked
    row; masked tiles and rows contribute exact zeros."""
    c, p = PK.lsa_plan(n)
    lens = [n] * b
    if b > 1:
        lens[1] = max(1, p // 2)
    if b > 2:
        lens[2] = 0
    args = _inputs(b, n, 64, 96, kwin, seed=n + kwin, lens=lens)
    with torch.no_grad():
        got, shares = _cluster_merge(*map(torch.from_numpy, args))
        plain = PK.lsa_step_plain(*map(torch.from_numpy, args))
    got = [x.numpy() for x in got]
    _close(got, [x.numpy() for x in plain])
    if jax_too:
        _close(got, K.lsa_step_fused(*map(jnp.asarray, args), interpret=True))
    align, _, ctx = got
    for i, ln in enumerate(lens):
        assert (align[i, ln:] == 0).all()
        for r, (share, part) in enumerate(shares):
            if r * p >= ln:              # a tile with no valid position
                assert share[i] == 0 and (part[i] == 0).all(), (i, r)
        if ln == 0:
            assert (ctx[i] == 0).all()
        else:
            assert abs(align[i].sum() - 1) < 1e-5


def test_lsa_floor_needs_a_cuda_device():
    """The launch floor is a device measurement: on the CPU it raises."""
    with pytest.raises(ValueError, match='CUDA device'):
        PK.lsa_floor(8, 64, 128, 256, 31, 'cpu')


def test_wrapper_rejects_bad_operands_before_launching():
    """The shape, dtype and window checks run before any launch."""
    args = [torch.from_numpy(x) for x in _inputs(2, 16, 16, 32, 31)]
    bad = list(args)
    bad[5] = bad[5][:4]                                  # even window width
    with pytest.raises(ValueError, match='odd'):
        PK._check(*bad)
    bad = list(args)
    bad[3] = bad[3][:, :8].contiguous()
    with pytest.raises(ValueError, match='values has shape'):
        PK._check(*bad)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match='float32'):
        PK._check(*bad)
    bad = list(args)
    bad[2] = bad[2].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match='contiguous'):
        PK._check(*bad)
    PK._check(*args)
