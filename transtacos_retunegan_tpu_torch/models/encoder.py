"""Self-attention text encoder ('sa') with the f0/c0 fusenet, inference
branch, ported from ``transtacos_retunegan_tpu/models/encoder.py``.

At inference the fusenet substitutes the conv prednet outputs for the
cross-attended f0/c0 features.  The train-only cross attentions
(``ca_f0``/``ca_c0``) are still registered so that a full training
checkpoint maps onto this module with every leaf consumed.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import AcousticConfig
from .layers import GFFW, ConvStack, DotAttn, attn_mask, leaky_relu


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
            self.add_module(f'proj_sa_{i}', nn.Linear(depth, depth))
            self.add_module(f'gffw_sa_{i}', GFFW(depth, depth, hp.gffw_conv_k))
        if hp.encoder_fusenet:
            pd = hp.var_prednet_depth
            for name in ('ca_f0', 'ca_c0'):
                self.add_module(f'{name}_prednet', ConvStack(
                    2, hp.var_prednet_conv_k, depth, pd, pd, leaky_relu))
                # train-only cross attention, kept for the param tree
                self.add_module(name, DotAttn(depth, var_in, pd, depth))
            self.proj_ca = nn.Linear(2 * pd, depth)
            self.gffw_ca = GFFW(2 * depth, depth, hp.gffw_conv_k)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor) -> torch.Tensor:
        hp = self.hp
        m = dict(self.named_children())
        if hp.txt_use_posenc:
            x = self.prenet(x)
        slf_mask = attn_mask(x_len, x.shape[-2])
        for i in range(hp.encoder_attn_layers):
            rs = [m[f'sa_{i}_{h}'](x, x, slf_mask)[0]
                  for h in range(hp.encoder_attn_nhead)]
            sa = m[f'proj_sa_{i}'](torch.cat(rs, -1))
            x = x + m[f'gffw_sa_{i}'](x + sa)
        if hp.encoder_fusenet:
            f0 = self.ca_f0_prednet(x)
            c0 = self.ca_c0_prednet(x)
            f = self.proj_ca(torch.cat([f0, c0], -1))
            x = x + self.gffw_ca(torch.cat([x, f], -1))
        return x


def var_embed_width(hp: AcousticConfig) -> int:
    """Width of the f0/c0 embeddings the train-only cross attention reads."""
    return hp.var_embed_depth + (hp.posenc_depth if hp.var_use_posenc else 0)

