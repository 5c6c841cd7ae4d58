"""Acoustic-model encoders, ported from
``transtacos_retunegan_tpu/models/encoder.py``: self-attention ('sa') with
the f0/c0 fusenet, and CBHG ('cb').

In training the fusenet cross-attends the text against the quantized f0/c0
embeddings (``ca_f0``/``ca_c0``); at inference it substitutes the conv
prednet outputs for them.  Both branches return ``(x, (slf_attns,
crx_attns), ((f0_r, f0_r_pred), (c0_r, c0_r_pred)))`` as the JAX module
does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import AcousticConfig
from ..parallel import Shard
from .decoder import GRUCell
from .layers import (GFFW, ConvBN, ConvStack, Dense, DotAttn, Highway, attn_mask,
                     dropout, leaky_relu, sequence_mask)

ENCODER_DROPOUT = 0.2


class EncoderSA(nn.Module):
    def __init__(self, hp: AcousticConfig, cin: int, var_in: int):
        super().__init__()
        self.hp = hp
        depth = hp.encoder_depth
        if hp.txt_use_posenc:
            self.prenet = nn.Linear(cin, depth)
        for i in range(hp.encoder_attn_layers):
            for h in range(hp.encoder_attn_nhead):
                self.add_module(f'sa_{i}_{h}', DotAttn(
                    depth, depth, depth // hp.encoder_attn_nhead, depth))
            self.add_module(f'proj_sa_{i}', Dense(depth, depth))
            self.add_module(f'gffw_sa_{i}', GFFW(depth, depth, hp.gffw_conv_k))
        if hp.encoder_fusenet:
            pd = hp.var_prednet_depth
            for name in ('ca_f0', 'ca_c0'):
                self.add_module(f'{name}_prednet', ConvStack(
                    2, hp.var_prednet_conv_k, depth, pd, pd, leaky_relu))
                self.add_module(name, DotAttn(depth, var_in, pd, depth))
            self.proj_ca = nn.Linear(2 * pd, depth)
            self.gffw_ca = GFFW(2 * depth, depth, hp.gffw_conv_k)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor,
                f0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None,
                y_len: Optional[torch.Tensor] = None, train: bool = False,
                drop: Optional[torch.Generator] = None, shard: Optional[Shard] = None):
        """``drop``: the dropout stream (used under ``encoder_dropout`` in
        training), drawn under the data-parallel ``shard``; ``f0``/``c0``
        [B, T, var_in] and ``y_len`` are the training inputs of the cross
        attentions."""
        hp = self.hp
        m = self._modules
        drop = drop if (train and hp.encoder_dropout) else None
        if hp.txt_use_posenc:
            x = dropout(self.prenet(x), ENCODER_DROPOUT, drop, shard)
        slf_mask = attn_mask(x_len, x.shape[-2])
        slf_attns = []
        for i in range(hp.encoder_attn_layers):
            heads = [m[f'sa_{i}_{h}'](x, x, slf_mask)
                     for h in range(hp.encoder_attn_nhead)]
            slf_attns.append([sc for _, sc in heads])
            sa = m[f'proj_sa_{i}'](torch.cat([r for r, _ in heads], -1))
            sa = dropout(sa, ENCODER_DROPOUT, drop, shard)
            x = x + m[f'gffw_sa_{i}'](x + sa)
        crx_attns = []
        zero = x.new_zeros(())
        f0_r = c0_r = f0_r_pred = c0_r_pred = zero
        if hp.encoder_fusenet:
            f0_r_pred = self.ca_f0_prednet(x)
            c0_r_pred = self.ca_c0_prednet(x)
            if train:
                crx_mask = attn_mask(x_len, x.shape[-2], y_len, f0.shape[-2])
                f0_r, sc_f0 = self.ca_f0(x, f0, crx_mask)
                c0_r, sc_c0 = self.ca_c0(x, c0, crx_mask)
                crx_attns = [sc_f0, sc_c0]
                f = self.proj_ca(torch.cat([f0_r, c0_r], -1))
            else:
                f = self.proj_ca(torch.cat([f0_r_pred, c0_r_pred], -1))
            f = dropout(f, ENCODER_DROPOUT, drop, shard)
            x = x + self.gffw_ca(torch.cat([x, f], -1))
        return x, (slf_attns, crx_attns), ((f0_r, f0_r_pred), (c0_r, c0_r_pred))


class CBHG(nn.Module):
    """Tacotron-1 CBHG encoder: a bank of K conv+BN layers (k = 1..K, flax
    SAME padding, asymmetric for even k), max-pool of width 2, two conv+BN
    projections, a residual (so the input width must be ``encoder_depth``,
    and the JAX module's ``Dense`` after it is never built),
    ``highway_layers`` highway layers and a bidirectional GRU over the whole
    padded length (the backward GRU starts at the padded end), masked
    beyond each text's length."""

    def __init__(self, hp: AcousticConfig, cin: int):
        super().__init__()
        self.hp = hp
        depth = hp.encoder_depth
        if cin != depth:
            raise ValueError(f"encoder_type='cb' needs embed_depth == encoder_depth "
                             f"({cin} != {depth}): its residual adds the embeddings "
                             'to the projections')
        for k in range(1, hp.encoder_conv_K + 1):
            self.add_module(f'conv1d_{k}', ConvBN(cin, depth // 2, k, F.relu))
        self.proj_1 = ConvBN(hp.encoder_conv_K * (depth // 2), depth // 2, 3, F.relu)
        self.proj_2 = ConvBN(depth // 2, depth, 3, lambda v: v)
        for i in range(hp.highway_layers):
            self.add_module(f'highway_{i + 1}', Highway(depth))
        # the cells are built in the JAX module's scope and handed to
        # nn.RNN, so flax names them GRUCell_0 (forward) and GRUCell_1
        self.GRUCell_0 = GRUCell(depth, depth // 2)
        self.GRUCell_1 = GRUCell(depth, depth // 2)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor, train: bool,
                shard: Optional[Shard] = None) -> torch.Tensor:
        """``shard``: batch norm over the data-parallel global batch."""
        hp, m = self.hp, self._modules
        conv = torch.cat([m[f'conv1d_{k}'](x, train, shard)
                          for k in range(1, hp.encoder_conv_K + 1)], -1)
        pooled = torch.maximum(conv, torch.cat([conv[:, 1:], conv[:, -1:]], 1))
        proj = self.proj_2(self.proj_1(pooled, train, shard), train, shard)
        highway = x + proj
        for i in range(hp.highway_layers):
            highway = m[f'highway_{i + 1}'](highway)
        mask = sequence_mask(x_len, highway.shape[-2])[..., None]
        fwd = _run(self.GRUCell_0, highway)
        bwd = _run(self.GRUCell_1, highway.flip(1)).flip(1)
        return torch.cat([fwd, bwd], -1) * mask


def _run(cell: GRUCell, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.RNN(cell)``: every time step from a zero state."""
    h = x.new_zeros(x.shape[0], cell.hn.out_features)
    outs = []
    for t in range(x.shape[1]):
        h = cell(h, x[:, t])
        outs.append(h)
    return torch.stack(outs, 1)


def var_embed_width(hp: AcousticConfig) -> int:
    """Width of the f0/c0 embeddings the train-only cross attention reads."""
    return hp.var_embed_depth + (hp.posenc_depth if hp.var_use_posenc else 0)
