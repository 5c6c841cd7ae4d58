"""Seeded weights drawn on the card, in a few large calls.

The rule for each leaf is that of the port's ``weights.py::seeded_init``
(``transtacos_retunegan_tpu_torch/weights.py:163-218``): lecun-normal
denses and convs, orthogonal GRU hidden kernels, zero biases (the highway
gates' -1), truncated-normal(0.5) embeddings, kaiming-normal (leaky slope
0.15) weight-norm directions with the matching gain ``g``, the noise scale
``w`` 1e-6, ``alpha`` 4, batch-norm scales and variances 1.  Verdict on the
original: sound, but it draws leaf by leaf on the host; here one normal
and one uniform buffer come from a ``torch.Generator`` on the card and
every leaf is a scaled slice of them, so set-up stays short.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

SLOPE_GAIN = 2.0 / (1.0 + 0.15 ** 2)
_ZERO = ('bias', 'b', 'attention_bias', 'bi', 'bn', 'mean', 'running_mean')
_ONE = ('scale', 'var', 'running_var')
_GRU_HIDDEN = ('hr', 'hz', 'hn')


def _kind(name: str) -> str:
    leaf = name.rsplit('.', 1)[-1]
    parent = name.rsplit('.', 2)[-2] if name.count('.') >= 1 else ''
    if leaf == 'bias' and parent == 'T':
        return 'gate'
    if leaf in _ZERO:
        return 'zero'
    if leaf in _ONE:
        return 'one'
    if leaf in ('g', 'w', 'alpha'):
        return leaf
    if leaf.startswith('E_'):
        return 'embedding'
    if leaf == 'attention_variable':
        return 'uniform'
    if leaf == 'v':
        return 'v_t' if parent.startswith('WNConvTranspose') else 'v'
    if leaf == 'weight' and parent in _GRU_HIDDEN:
        return 'orthogonal'
    if leaf == 'weight':
        return 'weight'
    raise ValueError(f'no initialiser for {name}')


@torch.no_grad()
def seeded_state(factory: Callable[[], torch.nn.Module], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict of ``factory()`` (built on the meta device, so that
    nothing is drawn on the host) with seeded values on ``device``."""
    with torch.device('meta'):
        shapes = {k: tuple(v.shape) for k, v in factory().state_dict().items()}
    kinds = {k: _kind(k) for k in shapes}
    numel = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    normal_keys = [k for k in shapes if kinds[k] in ('embedding', 'v', 'v_t', 'weight',
                                                     'orthogonal')]
    uniform_keys = [k for k in shapes if kinds[k] == 'uniform']
    normal = torch.randn(sum(numel[k] for k in normal_keys) or 1, generator=gen,
                         device=device)
    uniform = torch.rand(sum(numel[k] for k in uniform_keys) or 1, generator=gen,
                         device=device)
    out, pos = {}, 0
    for k in normal_keys:
        out[k] = normal[pos:pos + numel[k]].view(shapes[k])
        pos += numel[k]
    pos = 0
    for k in uniform_keys:
        out[k] = uniform[pos:pos + numel[k]].view(shapes[k])
        pos += numel[k]
    ortho = [k for k in normal_keys if kinds[k] == 'orthogonal']
    for shape in sorted({shapes[k] for k in ortho}):
        same = [k for k in ortho if shapes[k] == shape]
        q, _ = torch.linalg.qr(torch.stack([out[k] for k in same]))
        for k, qk in zip(same, q):
            out[k] = qk
    for k, shape in shapes.items():
        kind = kinds[k]
        if kind == 'gate':
            out[k] = torch.full(shape, -1.0, device=device)
        elif kind == 'zero':
            out[k] = torch.zeros(shape, device=device)
        elif kind == 'one':
            out[k] = torch.ones(shape, device=device)
        elif kind == 'g':
            out[k] = torch.full(shape, SLOPE_GAIN ** 0.5, device=device)
        elif kind == 'w':
            out[k] = torch.full(shape, 1e-6, device=device)
        elif kind == 'alpha':
            out[k] = torch.full(shape, 4.0, device=device)
        elif kind == 'embedding':
            out[k] = (out[k] * 0.5).clamp(-1.0, 1.0)
        elif kind == 'uniform':
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            out[k] = (out[k] * 2 - 1) * lim
        elif kind in ('v', 'v_t'):
            fan_in = shape[0] * shape[2] if kind == 'v_t' else int(torch.Size(shape[1:]).numel())
            out[k] = out[k] * (SLOPE_GAIN / fan_in) ** 0.5
        elif kind == 'weight':
            fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
            out[k] = out[k] / fan_in ** 0.5
        out[k] = out[k].contiguous()
    return {k: out[k] for k in shapes}
