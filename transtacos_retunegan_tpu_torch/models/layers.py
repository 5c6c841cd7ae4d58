"""Acoustic-model building blocks (inference), ported from
``transtacos_retunegan_tpu/models/layers.py``.

Activations keep the JAX package's ``[B, T, C]`` layout.  Dense weights are
torch ``nn.Linear`` (``[out, in]``); conv weights are ``[out, in, k]``.  Each
module's child names equal the flax module names, so a flax param path maps
onto a torch state-dict key by joining with ``.`` (see ``weights.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoidal position-encoding table ``[n_position, d_hid]``."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """``[B] -> [B, maxlen]`` float 0/1 mask."""
    idx = torch.arange(maxlen, device=lengths.device)
    return (idx[None, :] < lengths[:, None]).float()


def attn_mask(xlen: torch.Tensor, max_xlen: int,
              ylen: Optional[torch.Tensor] = None,
              max_ylen: Optional[int] = None) -> torch.Tensor:
    """Outer-product ``[B, N, T]`` mask."""
    if ylen is None:
        ylen, max_ylen = xlen, max_xlen
    return torch.einsum('bn,bt->bnt', sequence_mask(xlen, max_xlen),
                        sequence_mask(ylen, max_ylen))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax ``nn.leaky_relu`` (default slope 0.01)."""
    return F.leaky_relu(x, slope)


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (k,), padding='SAME')`` over ``[B, T, C]``."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        x = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        return F.conv1d(x, self.weight, self.bias).transpose(1, 2)


class Prenet(nn.Module):
    """Dense+ReLU chain at inference (dropout is train-only)."""

    def __init__(self, cin: int, layer_sizes: Sequence[int]):
        super().__init__()
        for i, size in enumerate(layer_sizes):
            self.add_module(f'dense_{i + 1}', nn.Linear(cin, size))
            cin = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = F.relu(layer(x))
        return x


class ConvStack(nn.Module):
    """n-1 conv+act layers at d_in then a linear conv to d_out."""

    def __init__(self, n_layers: int, kernel: int, cin: int, d_in: int,
                 d_out: int, activation: Callable = F.relu):
        super().__init__()
        self.activation = activation
        for i in range(n_layers):
            cout = d_out if i == n_layers - 1 else d_in
            self.add_module(f'conv{i + 1}', Conv(cin, cout, kernel))
            cin = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.children())
        for conv in convs[:-1]:
            x = self.activation(conv(x))
        return convs[-1](x)


class DotAttn(nn.Module):
    """Masked scaled dot-product attention returning (values, scores).

    The reference quirk is kept: the energy is masked with -1e8 *before*
    the 1/sqrt(scale_depth) scaling, and the scale is the encoder depth.
    """

    def __init__(self, q_in: int, kv_in: int, attn_dim: int, scale_depth: int):
        super().__init__()
        self.scale_depth = scale_depth
        self.q = nn.Linear(q_in, attn_dim)
        self.k = nn.Linear(kv_in, attn_dim)
        self.v = nn.Linear(kv_in, attn_dim)

    def forward(self, x, y, mask):
        q, k, v = self.q(x), self.k(y), self.v(y)
        e = torch.einsum('bna,bta->bnt', q, k)
        e = e * mask + (1.0 - mask) * -1e8
        e = e / float(np.sqrt(np.float32(self.scale_depth)))
        sc = torch.softmax(e, dim=-1)
        return torch.einsum('bnt,bta->bna', sc, v), sc


class GLU(nn.Module):
    """Gated conv unit; the activation is applied to the conv output and
    again to the value half, as the reference does."""

    def __init__(self, cin: int, depth: int, kernel: int = 7,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.activation = activation
        self.conv = Conv(cin, depth * 2, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv(x)
        if self.activation is not None:
            conv = self.activation(conv)
        h, gate = torch.chunk(conv, 2, dim=-1)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(gate)


class GFFW(nn.Module):
    """Gated feed-forward: GLU(k, leaky_relu) + pointwise conv."""

    def __init__(self, cin: int, depth: int, kernel: int = 9):
        super().__init__()
        self.add_module('GLU', GLU(cin, depth, kernel, activation=leaky_relu))
        self.conv_pointwise = Conv(depth, depth, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_pointwise(self.GLU(x))
