"""The fused-layout decoder cell and the hoisted teacher-forced decode,
ported from ``transtacos_retunegan_tpu/models/decoder_fast.py``.

``DecoderCellFast`` computes the stock cell's step with fewer, wider
projections, in the JAX package's fused parameter layout (``fast_cell``):

* ``FusedGRU``: the three input-side gate matrices as one ``wi`` [in, 3H]
  with bias ``bi`` [3H], the three hidden-side ones as one ``wh`` [H, 3H],
  and the candidate's hidden bias ``bn`` [H] (flax layouts, ``x @ wi``);
* ``LSAStepFast``: the location conv and dense folded into one conv
  ``loc_conv`` (kwin taps, A outputs);
* ``out_projection``: the frame and stop projections as one dense, split.

``fuse_cell_params`` maps a stock cell's state dict onto that layout.

``hoisted_force_decode`` is the training decode while the decoder input
is pure ground truth (``train/acoustic_step.py::hoist_force_eligible``):
the prenet (and its half of the input-feed projection) runs batched over
all steps, then only the recurrent core (context projection, GRUs, LSA,
context) runs step by step, then the frame/stop head runs batched.  It
reads either cell layout through ``cell_weights``, whose tensors carry the
gradient back to the cell's parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..parallel import Shard, column_matmul
from .decoder import AttentionParams, CellBase, teacher_inputs
from .layers import Conv, Dense, Prenet, keep_mask


class FusedGRU(nn.Module):
    """flax ``GRUCell`` with the three gate matmuls fused per side; under
    tensor parallelism (``tp``) it holds this rank's columns of ``wi`` and
    ``wh`` and gathers both products."""

    TP_LEAVES = {'wi': 1, 'wh': 1}
    tp: Optional[Shard] = None

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(cin, 3 * hidden))
        self.wh = nn.Parameter(torch.zeros(hidden, 3 * hidden))
        self.bi = nn.Parameter(torch.zeros(3 * hidden))
        self.bn = nn.Parameter(torch.zeros(hidden))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return gru_fused(h, column_matmul(x, self.wi, self.tp) + self.bi,
                         column_matmul(h, self.wh, self.tp), self.bn)


def gru_fused(h, gi, gh, bn):
    """The GRU update from the fused input and hidden projections."""
    hd = h.shape[-1]
    r = torch.sigmoid(gi[..., :hd] + gh[..., :hd])
    z = torch.sigmoid(gi[..., hd:2 * hd] + gh[..., hd:2 * hd])
    n = torch.tanh(gi[..., 2 * hd:] + r * (gh[..., 2 * hd:] + bn))
    return (1.0 - z) * n + z * h


class LSAStepFast(nn.Module):
    """Location-sensitive attention with the location conv and dense
    folded into ``loc_conv``."""

    def __init__(self, query_dim: int, attention_dim: int = 128,
                 location_kernel: int = 31):
        super().__init__()
        self.query_layer = nn.Linear(query_dim, attention_dim, bias=False)
        self.loc_conv = Conv(1, attention_dim, location_kernel)
        self.attention_variable = nn.Parameter(torch.zeros(attention_dim, 1))
        self.attention_bias = nn.Parameter(torch.zeros(attention_dim))

    def forward(self, query, cum, attn: AttentionParams):
        q = self.query_layer(query)[:, None, :]
        loc = self.loc_conv(cum[..., None])
        energy = (torch.tanh(attn.keys + q + loc + self.attention_bias)
                  @ self.attention_variable)[..., 0]
        energy = energy.masked_fill(attn.mask <= 0, float('-inf'))
        align = torch.softmax(energy, dim=-1)
        return align, cum + align


class DecoderCellFast(CellBase):
    """The stock cell's step in the fused layout (same carry, same
    emissions, inference and training)."""

    def __init__(self, cfg: Config):
        super().__init__()
        hp = cfg.acoustic
        self.cfg = cfg
        n_mel, d, h, r = cfg.audio.n_mel, hp.encoder_depth, hp.decoder_depth, hp.outputs_per_step
        self.decoder_prenet = Prenet(n_mel, hp.prenet_depths)
        self.rnn_in_proj = Dense(hp.prenet_depths[-1] + d, h)
        for i in range(hp.decoder_layers):
            self.add_module(f'gru_{i}', FusedGRU(h, h))
        self.lsa = LSAStepFast(h, hp.attention_depth)
        self.out_projection = nn.Linear(h + d, n_mel * r + r)

    def head(self, proj_in: torch.Tensor):
        out = self.out_projection(proj_in)
        split = self.cfg.audio.n_mel * self.cfg.acoustic.outputs_per_step
        return out[..., :split], out[..., split:]


def fuse_cell_params(stock: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A stock ``DecoderCell`` state dict -> the ``DecoderCellFast`` one:
    the gate matrices concatenated (exact), the location conv and dense
    folded into one conv (its kernel ``k_conv @ w_dense``, its bias
    ``b_conv @ w_dense``), the frame and stop heads concatenated (exact)."""
    out = {k: v for k, v in stock.items()
           if k.startswith(('decoder_prenet.', 'rnn_in_proj.'))}
    i = 0
    while f'gru_{i}.ir.weight' in stock:
        g = lambda name: stock[f'gru_{i}.{name}']              # noqa: E731
        out[f'gru_{i}.wi'] = torch.cat([g(f'{k}.weight').t() for k in ('ir', 'iz', 'in')], 1)
        out[f'gru_{i}.wh'] = torch.cat([g(f'{k}.weight').t() for k in ('hr', 'hz', 'hn')], 1)
        out[f'gru_{i}.bi'] = torch.cat([g(f'{k}.bias') for k in ('ir', 'iz', 'in')])
        out[f'gru_{i}.bn'] = g('hn.bias')
        i += 1
    conv_w = stock['lsa.location_convolution.weight']        # [F, 1, K]
    dense_w = stock['lsa.location_layer.weight']             # [A, F]
    out['lsa.query_layer.weight'] = stock['lsa.query_layer.weight']
    out['lsa.loc_conv.weight'] = torch.einsum('fik,af->aik', conv_w, dense_w)
    out['lsa.loc_conv.bias'] = dense_w @ stock['lsa.location_convolution.bias']
    out['lsa.attention_variable'] = stock['lsa.attention_variable']
    out['lsa.attention_bias'] = stock['lsa.attention_bias']
    out['out_projection.weight'] = torch.cat([stock['frame_projection.weight'],
                                              stock['stop_projection.weight']], 0)
    out['out_projection.bias'] = torch.cat([stock['frame_projection.bias'],
                                            stock['stop_projection.bias']])
    return out


def cell_weights(cell: CellBase) -> Dict[str, object]:
    """The decode step's operands from either cell layout, as ``[in, out]``
    matrices that carry the gradient back to the cell's parameters:
    ``prenet`` [(w, b)], ``wx_p``/``wx_c``/``bx`` (the input-feed
    projection split into its prenet and context rows), ``grus`` [(wi, bi,
    wh, bn)], ``wq``, ``loc`` [kwin, A] (the folded location features),
    ``v`` [A, 1], ``ba`` (the attention bias with the location conv's bias
    folded in), and the head ``wf``/``bf``, ``ws``/``bs`` [H + D, .].
    Under tensor parallelism the input-feed and GRU matrices are this
    rank's columns: ``x_tp`` and ``gru_tp`` [(shard, blocks)] say how to
    gather their products (``parallel.column_matmul``; the stock cell's
    gates are three blocks split alike, the fused ones one)."""
    m = cell._modules
    pre = [(lin.weight.t(), lin.bias) for lin in m['decoder_prenet'].children()]
    p_out = pre[-1][0].shape[1]
    wx = m['rnn_in_proj'].weight.t()
    lsa = m['lsa']
    if isinstance(cell, DecoderCellFast):
        grus = [(g.wi, g.bi, g.wh, g.bn) for g in cell.grus()]
        gru_tp = [(g.tp, 1) for g in cell.grus()]
        loc = lsa.loc_conv.weight[:, 0, :].t()
        ba = lsa.attention_bias + lsa.loc_conv.bias
        head = cell.out_projection.weight.t()
        split = cell.cfg.audio.n_mel * cell.cfg.acoustic.outputs_per_step
        wf, ws = head[:, :split], head[:, split:]
        bf, bs = cell.out_projection.bias[:split], cell.out_projection.bias[split:]
    else:
        grus = []
        for g in cell.grus():
            gm = g._modules
            grus.append((torch.cat([gm[k].weight.t() for k in ('ir', 'iz', 'in')], 1),
                         torch.cat([gm[k].bias for k in ('ir', 'iz', 'in')]),
                         torch.cat([gm[k].weight.t() for k in ('hr', 'hz', 'hn')], 1),
                         gm['hn'].bias))
        gru_tp = [(g.ir.tp, 3) for g in cell.grus()]
        conv, w_loc = lsa.location_convolution, lsa.location_layer.weight
        loc = torch.einsum('fik,af->ka', conv.weight, w_loc)
        ba = lsa.attention_bias + w_loc @ conv.bias
        wf, bf = cell.frame_projection.weight.t(), cell.frame_projection.bias
        ws, bs = cell.stop_projection.weight.t(), cell.stop_projection.bias
    return {'prenet': pre, 'wx_p': wx[:p_out], 'wx_c': wx[p_out:],
            'bx': m['rnn_in_proj'].bias, 'grus': grus,
            'x_tp': m['rnn_in_proj'].tp, 'gru_tp': gru_tp,
            'wq': lsa.query_layer.weight.t(), 'loc': loc,
            'v': lsa.attention_variable, 'ba': ba,
            'wf': wf, 'bf': bf, 'ws': ws, 'bs': bs}


def _core(w, xp_t, hs, ctx, cum, keys, values, mask):
    """One recurrent step of the hoisted decode."""
    x = xp_t + column_matmul(ctx, w['wx_c'], w['x_tp'])
    h_news = []
    for (wi, bi, wh, bn), (tp, blocks), h in zip(w['grus'], w['gru_tp'], hs):
        h_new = gru_fused(h, column_matmul(x, wi, tp, blocks) + bi,
                          column_matmul(h, wh, tp, blocks), bn)
        h_news.append(h_new)
        x = h_new + x                                       # residual
    kwin = w['loc'].shape[0]
    loc = F.conv1d(F.pad(cum[:, None, :], ((kwin - 1) // 2, kwin // 2)),
                   w['loc'].t()[:, None, :]).transpose(1, 2)
    energy = (torch.tanh(keys + (x @ w['wq'])[:, None, :] + loc + w['ba'])
              @ w['v'])[..., 0]
    align = torch.softmax(energy.masked_fill(mask <= 0, float('-inf')), dim=-1)
    ctx_new = torch.einsum('bn,bnd->bd', align, values)
    return tuple(h_news), ctx_new, cum + align, x, align


def hoisted_force_decode(cell: CellBase, cfg: Config, mel_targets: torch.Tensor,
                         keys: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                         keep: Optional[Sequence[torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None,
                         shard: Optional[Shard] = None):
    """Teacher-forced training decode with the time-parallel work hoisted
    out of the step loop; the stock train decode's function whenever the
    decoder input is ground truth.  ``keep``: the prenet's dropout masks,
    [S, B, width] per layer, scaled (``layers.keep_mask``); else drawn from
    ``generator`` under the data-parallel ``shard``; else no dropout.
    Returns mel [B, S*r, M], raw stop logits [B, S*r] and alignments
    [B, N, S].  ``remat_decoder`` recomputes each core step in the backward
    pass."""
    hp = cfg.acoustic
    r, n_mel = hp.outputs_per_step, cfg.audio.n_mel
    w = cell_weights(cell)
    x_in = teacher_inputs(mel_targets, r)                   # [S, B, M]
    s, b = x_in.shape[0], x_in.shape[1]
    if keep is None and generator is not None:
        keep = [keep_mask((s, b, lw.shape[1]), Prenet.RATE, generator, x_in.device,
                          batch_axis=1, shard=shard) for lw, _ in w['prenet']]
    act = x_in
    for i, (lw, lb) in enumerate(w['prenet']):
        act = F.relu(act @ lw + lb)         # gradient 0 at 0, as jax.nn.relu
        if keep is not None:
            act = act * keep[i]
    # one gather of the input projection for all steps under TP
    xp = column_matmul(act, w['wx_p'], w['x_tp']) + w['bx']   # [S, B, H]

    hs = tuple(x_in.new_zeros(b, hp.decoder_depth) for _ in w['grus'])
    ctx, cum = x_in.new_zeros(b, values.shape[-1]), x_in.new_zeros(b, mask.shape[-1])
    rnn, ctxs, aligns = [], [], []
    for t in range(s):
        args = (w, xp[t], hs, ctx, cum, keys, values, mask)
        if hp.remat_decoder:
            hs, ctx, cum, x, align = checkpoint(_core, *args, use_reentrant=False)
        else:
            hs, ctx, cum, x, align = _core(*args)
        rnn.append(x)
        ctxs.append(ctx)
        aligns.append(align)
    proj_in = torch.cat([torch.stack(rnn), torch.stack(ctxs)], -1)   # [S, B, H + D]
    frames = proj_in @ w['wf'] + w['bf']
    stop = proj_in @ w['ws'] + w['bs']
    return (frames.transpose(0, 1).reshape(b, s * r, n_mel),
            stop.transpose(0, 1).reshape(b, s * r),
            torch.stack(aligns, -1))
