"""Autoregressive decoder, inference mode: residual GRU stack +
location-sensitive attention, ported from
``transtacos_retunegan_tpu/models/decoder.py``.

``decode`` is the plain torch loop over decode steps.  It is the
model-level reference that the fused decode kernels
(``ops/fused_decoder.py``) are held to: prenet -> [prev context] -> dense ->
residual GRUs -> LSA over precomputed keys -> frame/stop projections, with
the stop rule "any of the r stop sigmoids >= 0.5" per row and
impute-finished semantics (finished rows emit zero frames and hold state).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn as nn

from ..config import Config
from .layers import Conv, Prenet, sequence_mask


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
            self.add_module(g, nn.Linear(cin, hidden))
        for g in ('hr', 'hz'):
            self.add_module(g, nn.Linear(hidden, hidden, bias=False))
        self.add_module('hn', nn.Linear(hidden, hidden))

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


class DecoderCell(nn.Module):
    """Parameters of one decode step (the flax ``decoder_cell`` subtree)."""

    def __init__(self, cfg: Config):
        super().__init__()
        hp = cfg.acoustic
        self.cfg = cfg
        n_mel, d, h = cfg.audio.n_mel, hp.encoder_depth, hp.decoder_depth
        self.decoder_prenet = Prenet(n_mel, hp.prenet_depths)
        self.rnn_in_proj = nn.Linear(hp.prenet_depths[-1] + d, h)
        for i in range(hp.decoder_layers):
            self.add_module(f'gru_{i}', GRUCell(h, h))
        self.lsa = LSA(h, hp.attention_depth)
        self.frame_projection = nn.Linear(h + d, n_mel * hp.outputs_per_step)
        self.stop_projection = nn.Linear(h + d, hp.outputs_per_step)

    def grus(self):
        return [self._modules[f'gru_{i}']
                for i in range(self.cfg.acoustic.decoder_layers)]

    def step(self, carry, attn: AttentionParams):
        """One inference step.  ``carry`` = (hs, ctx, cum, prev, finished)."""
        hs, ctx, cum, prev, was_fin = carry
        n_mel = self.cfg.audio.n_mel
        x = self.rnn_in_proj(torch.cat([self.decoder_prenet(prev), ctx], -1))
        h_news = []
        for gru, h in zip(self.grus(), hs):
            h_new = gru(h, x)
            h_news.append(h_new)
            x = h_new + x                                   # residual
        align, cum_new = self.lsa(x, cum, attn)
        ctx_new = torch.einsum('bn,bnd->bd', align, attn.values)
        proj_in = torch.cat([x, ctx_new], -1)
        frames = self.frame_projection(proj_in)
        stop = torch.sigmoid(self.stop_projection(proj_in))
        fin = was_fin | (stop >= 0.5).any(-1)
        held = was_fin[:, None]
        frames = frames * (~held).to(frames.dtype)
        carry = (tuple(torch.where(held, h0, h1) for h0, h1 in zip(hs, h_news)),
                 torch.where(held, ctx, ctx_new),
                 torch.where(held, cum, cum_new),
                 torch.where(held, prev, frames[:, -n_mel:]),
                 fin)
        return carry, frames, stop, align


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
def decode(cell: DecoderCell, attn: AttentionParams,
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

