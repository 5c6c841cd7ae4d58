"""Acoustic-model building blocks, ported from
``transtacos_retunegan_tpu/models/layers.py``.

Activations keep the JAX package's ``[B, T, C]`` layout.  Dense weights are
torch ``nn.Linear`` (``[out, in]``); conv weights are ``[out, in, k]``.  Each
module's child names equal the flax module names, so a flax param path maps
onto a torch state-dict key by joining with ``.`` (see ``weights.py``).

Training draws its random numbers from the ``torch.Generator``s of a
``Draws`` (the JAX package's 'noise', 'dropout' and 'tf' rng streams); a
stream left at None is off, which makes the Gaussian noises and the
dropouts identities.  A ``Draws`` with a data-parallel ``shard`` (set by
the train steps) makes each draw at the global batch's shape and keeps this
rank's rows (``parallel.shard_draw``), and batch norm given that shard takes
the global batch's statistics; without one everything is local.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import Shard, all_reduce_stats, copy_to_model, gather_from_model, shard_draw


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


@dataclass
class Draws:
    """The random draws of one training forward.  ``noise``, ``dropout``
    and ``tf``: a ``torch.Generator`` each, on the batch's device, or None
    for a stream that is off.  ``coins`` [S] replaces the 'random'
    teacher-forcing coins of the ``tf`` stream, and ``prenet_keep`` (one
    [S, B, width] mask per prenet layer, scaled as ``keep_mask``'s) the
    decoder prenet's dropout masks of the ``dropout`` stream.  ``shard``:
    this rank's share of a data-parallel step (the train steps set it from
    their state), under which draws are made at the global batch's shape
    and batch norm takes the global statistics; None is one process."""
    noise: Optional[torch.Generator] = None
    dropout: Optional[torch.Generator] = None
    tf: Optional[torch.Generator] = None
    coins: Optional[torch.Tensor] = None
    prenet_keep: Optional[List[torch.Tensor]] = None
    shard: Optional[Shard] = None


def gaussian_noise(x: torch.Tensor, std: float, gen: Optional[torch.Generator],
                   shard: Optional[Shard] = None) -> torch.Tensor:
    """Additive N(0, std) regularizer (the JAX ``GaussianNoise``); the
    identity when ``gen`` is None or ``std`` is 0."""
    if gen is None or not std:
        return x
    return x + std * shard_draw(lambda s: torch.randn(s, generator=gen, device=x.device,
                                                      dtype=x.dtype), x.shape, shard)


def keep_mask(shape, rate: float, gen: torch.Generator, device, batch_axis: int = 0,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """Dropout keep mask, scaled: 1/(1-rate) where kept, 0 elsewhere;
    ``shape[batch_axis]`` is the batch."""
    keep = shard_draw(lambda s: torch.rand(s, generator=gen, device=device),
                      shape, shard, batch_axis) < 1.0 - rate
    return keep.float() / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            shard: Optional[Shard] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=False)``; the identity when
    ``gen`` is None."""
    if gen is None:
        return x
    return x * keep_mask(x.shape, rate, gen, x.device, shard=shard)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax ``nn.leaky_relu`` (default slope 0.01)."""
    return F.leaky_relu(x, slope)


class Dense(nn.Linear):
    """flax ``nn.Dense``; under tensor parallelism
    (``parallel.shard_params_tp`` sets ``tp``) it holds this rank's rows of
    the weight, the columns of flax's kernel, computes that slice of the
    product, gathers it over the model group and adds the replicated
    bias."""

    TP_LEAVES = {'weight': 0}
    tp: Optional[Shard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return super().forward(x)
        y = gather_from_model(F.linear(copy_to_model(x, self.tp), self.weight), self.tp)
        return y if self.bias is None else y + self.bias


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
    """Dense+ReLU chain; in training each layer's output is multiplied by
    its dropout mask (``keep``: one scaled 0/1 tensor per layer, see
    ``keep_mask``; rate 0.5).  ``F.relu`` has gradient 0 at 0, as flax's
    ``nn.relu``: the <GO> zero frame with zero biases sits on that tie."""

    RATE = 0.5

    def __init__(self, cin: int, layer_sizes: Sequence[int]):
        super().__init__()
        for i, size in enumerate(layer_sizes):
            self.add_module(f'dense_{i + 1}', nn.Linear(cin, size))
            cin = size

    def forward(self, x: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i, layer in enumerate(self.children()):
            x = F.relu(layer(x))
            if keep is not None:
                x = x * keep[i]
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
        self.q = Dense(q_in, attn_dim)
        self.k = Dense(kv_in, attn_dim)
        self.v = Dense(kv_in, attn_dim)

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


class Highway(nn.Module):
    """Highway layer: relu(H x) * t + x * (1 - t), t = sigmoid(T x)."""

    def __init__(self, depth: int):
        super().__init__()
        self.H = nn.Linear(depth, depth)
        self.T = nn.Linear(depth, depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(self.T(x))
        return F.relu(self.H(x)) * t + x * (1.0 - t)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over ``[B, T, C]``: statistics over every axis
    but the last, the padded frames included; the variance is the biased
    one, E[x^2] - E[x]^2 clipped at 0; the running statistics (buffers
    ``mean``/``var``, flax's 'batch_stats') move with momentum 0.99 (torch's
    0.01) in training and normalise in evaluation; epsilon 1e-5.  Given a
    data-parallel ``shard``, training takes the statistics of the global
    batch (sums of x, x^2 and the count over the ranks, whose backward sums
    too), so the running statistics move alike on every rank."""

    MOMENTUM, EPS = 0.99, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                shard: Optional[Shard] = None) -> torch.Tensor:
        if train:
            dims = tuple(range(x.dim() - 1))
            count = x.new_full((1,), x[..., 0].numel())
            sums = all_reduce_stats(torch.cat([x.sum(dims), (x * x).sum(dims), count]),
                                    shard)
            c = x.shape[-1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (self.scale * torch.rsqrt(var + self.EPS)) + self.bias


class ConvBN(nn.Module):
    """conv1d + batch norm + activation; the children keep flax's automatic
    names ``Conv_0`` and ``BatchNorm_0``."""

    def __init__(self, cin: int, filters: int, kernel: int,
                 activation: Callable = F.relu):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv(cin, filters, kernel)
        self.BatchNorm_0 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool,
                shard: Optional[Shard] = None) -> torch.Tensor:
        return self.activation(self.BatchNorm_0(self.Conv_0(x), train, shard))


def cosine_similarity_matrix(e: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity of embedding rows."""
    n = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return (e @ e.t()) / (n @ n.t() + 1e-8)
