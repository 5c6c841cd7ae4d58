"""Autoregressive decoder: residual GRU stack + location-sensitive
attention, ported from ``transtacos_retunegan_tpu/models/decoder.py``.

``decode`` is the plain torch loop over inference decode steps.  It is the
model-level reference that the fused decode kernels
(``ops/fused_decoder.py``) are held to: prenet -> [prev context] -> dense ->
residual GRUs -> LSA over precomputed keys -> frame/stop projections, with
the stop rule "any of the r stop sigmoids >= 0.5" per row and
impute-finished semantics (finished rows emit zero frames and hold state).

``train_decode`` is the teacher-forced training decode (the JAX
``nn.scan`` of the cell in 'train' mode): per step the input is the
previous group's last target frame (``force``), a blend of it with the
previous prediction (``mix``), or one of the two by a coin (``random``);
the prenet's dropout is on and the stop outputs are raw logits.  The scan
is a Python loop over steps; under ``remat`` each step runs inside
``torch.utils.checkpoint`` and is recomputed in the backward pass.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Config
from .layers import Conv, Dense, Draws, Prenet, keep_mask, sequence_mask


class AttentionParams(NamedTuple):
    keys: torch.Tensor      # [B, N, A] processed memory
    values: torch.Tensor    # [B, N, D] masked encoder outputs
    mask: torch.Tensor      # [B, N]    1 inside text length


class MemoryLayer(nn.Module):
    """Key projection of the encoder memory (Dense, no bias)."""

    def __init__(self, cin: int, attention_dim: int):
        super().__init__()
        self.memory_layer = nn.Linear(cin, attention_dim, bias=False)

    def forward(self, memory: torch.Tensor) -> torch.Tensor:
        return self.memory_layer(memory)


def prepare_attention(memory: torch.Tensor, memory_lengths: torch.Tensor,
                      keys: torch.Tensor) -> AttentionParams:
    """Zero the memory beyond its length; the mask gates the scores."""
    mask = sequence_mask(memory_lengths, memory.shape[-2])
    return AttentionParams(keys, memory * mask[..., None], mask)


class GRUCell(nn.Module):
    """flax ``GRUCell`` gate layout: input denses ir/iz/in with biases,
    hidden denses hr/hz without and hn with a bias inside ``r * (.)``."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        for g in ('ir', 'iz', 'in'):
            self.add_module(g, Dense(cin, hidden))
        for g in ('hr', 'hz'):
            self.add_module(g, Dense(hidden, hidden, bias=False))
        self.add_module('hn', Dense(hidden, hidden))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        r = torch.sigmoid(m['ir'](x) + m['hr'](h))
        z = torch.sigmoid(m['iz'](x) + m['hz'](h))
        n = torch.tanh(m['in'](x) + r * m['hn'](h))
        return (1.0 - z) * n + z * h


class LSA(nn.Module):
    """Location-sensitive attention parameters and one evaluation."""

    def __init__(self, query_dim: int, attention_dim: int = 128,
                 location_filters: int = 32, location_kernel: int = 31):
        super().__init__()
        self.query_layer = nn.Linear(query_dim, attention_dim, bias=False)
        self.location_convolution = Conv(1, location_filters, location_kernel)
        self.location_layer = nn.Linear(location_filters, attention_dim,
                                        bias=False)
        self.attention_variable = nn.Parameter(torch.zeros(attention_dim, 1))
        self.attention_bias = nn.Parameter(torch.zeros(attention_dim))

    def forward(self, query, cum, attn: AttentionParams):
        q = self.query_layer(query)[:, None, :]
        loc = self.location_layer(self.location_convolution(cum[..., None]))
        energy = (torch.tanh(attn.keys + q + loc + self.attention_bias)
                  @ self.attention_variable)[..., 0]
        energy = energy.masked_fill(attn.mask <= 0, float('-inf'))
        align = torch.softmax(energy, dim=-1)
        return align, cum + align


class CellBase(nn.Module):
    """One decode step over a cell's projections; ``DecoderCell`` (the
    stock flax layout) and ``decoder_fast.DecoderCellFast`` (the fused one)
    supply ``decoder_prenet``, ``rnn_in_proj``, ``grus()``, ``lsa`` and
    ``head``."""

    def grus(self):
        return [self._modules[f'gru_{i}']
                for i in range(self.cfg.acoustic.decoder_layers)]

    def head(self, proj_in: torch.Tensor):
        raise NotImplementedError

    def advance(self, inputs, hs, ctx, cum, attn: AttentionParams, keep=None):
        """prenet -> [prev context] -> dense -> residual GRUs -> LSA ->
        context -> head; returns (hs', ctx', cum', frames, stop logits,
        alignment)."""
        x = self.rnn_in_proj(torch.cat([self.decoder_prenet(inputs, keep), ctx], -1))
        h_news = []
        for gru, h in zip(self.grus(), hs):
            h_new = gru(h, x)
            h_news.append(h_new)
            x = h_new + x                                   # residual
        align, cum_new = self.lsa(x, cum, attn)
        ctx_new = torch.einsum('bn,bnd->bd', align, attn.values)
        frames, stop = self.head(torch.cat([x, ctx_new], -1))
        return tuple(h_news), ctx_new, cum_new, frames, stop, align

    def step(self, carry, attn: AttentionParams):
        """One inference step.  ``carry`` = (hs, ctx, cum, prev, finished)."""
        hs, ctx, cum, prev, was_fin = carry
        n_mel = self.cfg.audio.n_mel
        h_news, ctx_new, cum_new, frames, stop, align = self.advance(
            prev, hs, ctx, cum, attn)
        stop = torch.sigmoid(stop)
        fin = was_fin | (stop >= 0.5).any(-1)
        held = was_fin[:, None]
        frames = frames * (~held).to(frames.dtype)
        carry = (tuple(torch.where(held, h0, h1) for h0, h1 in zip(hs, h_news)),
                 torch.where(held, ctx, ctx_new),
                 torch.where(held, cum, cum_new),
                 torch.where(held, prev, frames[:, -n_mel:]),
                 fin)
        return carry, frames, stop, align

    def train_step(self, carry, target_prev, keep, coin, tf_ratio,
                   attn: AttentionParams):
        """One teacher-forced step.  ``carry`` = (hs, ctx, cum, prev);
        ``keep``: this step's prenet dropout masks (or None); ``coin``:
        this step's 'random' coin.  The gradient flows through ``prev``
        wherever the input uses it (``mix`` with tf_ratio < 1)."""
        hs, ctx, cum, prev = carry
        method = self.cfg.acoustic.tf_method
        if method == 'force':
            inputs = target_prev
        elif method == 'mix':
            inputs = tf_ratio * target_prev + (1.0 - tf_ratio) * prev
        elif method == 'random':
            inputs = torch.where(coin < tf_ratio, target_prev, prev)
        else:
            raise ValueError(method)
        h_news, ctx_new, cum_new, frames, stop, align = self.advance(
            inputs, hs, ctx, cum, attn, keep)
        n_mel = self.cfg.audio.n_mel
        return (h_news, ctx_new, cum_new, frames[:, -n_mel:]), (frames, stop, align)


class DecoderCell(CellBase):
    """Parameters of one decode step (the flax ``decoder_cell`` subtree)."""

    def __init__(self, cfg: Config):
        super().__init__()
        hp = cfg.acoustic
        self.cfg = cfg
        n_mel, d, h = cfg.audio.n_mel, hp.encoder_depth, hp.decoder_depth
        self.decoder_prenet = Prenet(n_mel, hp.prenet_depths)
        self.rnn_in_proj = Dense(hp.prenet_depths[-1] + d, h)
        for i in range(hp.decoder_layers):
            self.add_module(f'gru_{i}', GRUCell(h, h))
        self.lsa = LSA(h, hp.attention_depth)
        self.frame_projection = nn.Linear(h + d, n_mel * hp.outputs_per_step)
        self.stop_projection = nn.Linear(h + d, hp.outputs_per_step)

    def head(self, proj_in: torch.Tensor):
        return self.frame_projection(proj_in), self.stop_projection(proj_in)


def init_carry(batch: int, n_text: int, cfg: Config, device=None):
    hp = cfg.acoustic
    z = lambda *s: torch.zeros(*s, device=device)   # noqa: E731
    return (tuple(z(batch, hp.decoder_depth) for _ in range(hp.decoder_layers)),
            z(batch, hp.encoder_depth), z(batch, n_text), z(batch, cfg.audio.n_mel),
            torch.zeros(batch, dtype=torch.bool, device=device))


def out_lengths(finished: torch.Tensor, r: int) -> torch.Tensor:
    """``[T, B]`` finished trace -> frames up to and including the stop step."""
    steps = finished.shape[0]
    fin_any = finished.any(0)
    first = finished.float().argmax(0)
    return torch.where(fin_any, first + 1, torch.full_like(first, steps)) * r


@torch.no_grad()
def decode(cell: CellBase, attn: AttentionParams,
           steps: int) -> Dict[str, torch.Tensor]:
    """Fixed-length inference decode (``Tacotron.__call__(train=False)``'s
    decoder outputs): mel [B, steps*r, M], stop [B, steps*r], alignments
    [B, N, steps], out_lengths [B]."""
    cfg = cell.cfg
    b, n = attn.mask.shape
    r, n_mel = cfg.acoustic.outputs_per_step, cfg.audio.n_mel
    carry = init_carry(b, n, cfg, attn.keys.device)
    frames, stops, aligns, fins = [], [], [], []
    for _ in range(steps):
        carry, f, s, a = cell.step(carry, attn)
        frames.append(f)
        stops.append(s)
        aligns.append(a)
        fins.append(carry[-1])
    return {'mel_outputs': torch.stack(frames, 1).reshape(b, steps * r, n_mel),
            'stop_token_outputs': torch.stack(stops, 1).reshape(b, steps * r),
            'alignments': torch.stack(aligns, -1),
            'out_lengths': out_lengths(torch.stack(fins), r)}


def teacher_inputs(mel_targets: torch.Tensor, r: int) -> torch.Tensor:
    """Per-step inputs ``[T/r, B, n_mel]``: step t gets group t-1's last
    target frame, zeros (<GO>) at t=0."""
    tgt = mel_targets[:, r - 1::r, :]
    shifted = F.pad(tgt[:, :-1, :], (0, 0, 1, 0))
    return shifted.transpose(0, 1)


def prenet_keep(cell: CellBase, steps: int, batch: int, draws: Draws,
                device) -> Optional[List[torch.Tensor]]:
    """The decoder prenet's dropout masks for every step, [S, B, width]
    per layer: ``draws.prenet_keep``, else drawn at once from
    ``draws.dropout``, else None (no dropout)."""
    if draws.prenet_keep is not None:
        return draws.prenet_keep
    if draws.dropout is None:
        return None
    return [keep_mask((steps, batch, w), Prenet.RATE, draws.dropout, device,
                      batch_axis=1, shard=draws.shard)
            for w in cell.cfg.acoustic.prenet_depths]


def train_decode(cell: CellBase, attn: AttentionParams, mel_targets: torch.Tensor,
                 tf_ratio, draws: Draws, remat: bool = False):
    """Teacher-forced training decode over ``T/r`` steps; returns mel
    [B, T, M], raw stop logits [B, T] and alignments [B, N, T/r].

    The masks and coins are drawn before the loop, so a step recomputed
    under ``remat`` (``torch.utils.checkpoint``, ``use_reentrant=False``)
    sees the same draws.  The JAX config's ``scan_unroll`` is an XLA scan
    knob with no counterpart in a Python loop and is ignored here."""
    cfg = cell.cfg
    hp = cfg.acoustic
    r, n_mel = hp.outputs_per_step, cfg.audio.n_mel
    xs = teacher_inputs(mel_targets, r)
    steps, b = xs.shape[0], xs.shape[1]
    device = xs.device
    keep = prenet_keep(cell, steps, b, draws, device)
    coins = None
    if hp.tf_method == 'random':
        coins = draws.coins
        if coins is None:
            if draws.tf is None:
                raise ValueError("tf_method='random' needs draws.tf or draws.coins")
            coins = torch.rand(steps, generator=draws.tf, device=device)
    hs = tuple(xs.new_zeros(b, hp.decoder_depth) for _ in range(hp.decoder_layers))
    carry = (hs, xs.new_zeros(b, hp.encoder_depth),
             xs.new_zeros(b, attn.mask.shape[-1]), xs.new_zeros(b, n_mel))
    frames, stops, aligns = [], [], []
    for t in range(steps):
        args = (carry, xs[t], None if keep is None else [k[t] for k in keep],
                None if coins is None else coins[t], tf_ratio, attn)
        if remat:
            carry, (f, s, a) = checkpoint(cell.train_step, *args, use_reentrant=False)
        else:
            carry, (f, s, a) = cell.train_step(*args)
        frames.append(f)
        stops.append(s)
        aligns.append(a)
    return (torch.stack(frames, 1).reshape(b, steps * r, n_mel),
            torch.stack(stops, 1).reshape(b, steps * r),
            torch.stack(aligns, -1))
