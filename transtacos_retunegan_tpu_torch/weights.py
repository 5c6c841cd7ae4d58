"""Weight bridge: flax param trees (numpy leaves) <-> the port's modules.

The port's modules name their children after the flax modules, so a flax
path ``a/b/kernel`` becomes the state-dict key ``a.b.weight``.  Layouts are
converted per leaf kind:

* Dense ``kernel [in, out]``             -> ``weight [out, in]``
* Conv ``kernel [k, in/g, out]``         -> ``weight [out, in/g, k]``
* WNConv ``v [k, in/g, out]``            -> ``v [out, in/g, k]``
* WNConvTranspose ``v [k, in, out]``     -> ``v [in, out, k]``
* WNConv2d ``v [kh, kw, in, out]``       -> ``v [out, in, kh, kw]``
* everything else (biases, ``g``/``b``, embeddings, ``attention_variable``,
  the shared ``noise/w``, the generators' ``alpha``, the fused decoder
  cell's ``wi``/``wh``/``bi``/``bn``, batch-norm ``scale``) is copied as is.

A model with batch norm (the acoustic model's CBHG encoder) also takes the
tree's ``batch_stats`` collection: its ``mean``/``var`` leaves land on the
modules' buffers of those names.

A tree of several models maps onto a module with one child per top-level
key, e.g. ``models.discriminators.Discriminators`` for the
``{'msd', 'mpd', 'mtd'}`` discriminator tree.

``flax_vocoder_init`` and ``flax_acoustic_init`` draw, without JAX, the
initial vocoder and acoustic weights the JAX package draws from a flax key
(``jax_random``).

``from_flax`` raises unless every leaf lands on a parameter of the module
and every parameter receives a leaf of its shape; ``to_flax`` maps a state
dict back to the flax layout (``from_flax(to_flax(sd)) == sd``).  Trees
travel between the packages as ``.npz`` files keyed by ``/``-joined paths
(``save_npz`` / ``load_npz``), so weights reach the card without JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import jax_random
from .models.vocoder_layers import WNConvTranspose


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _perm(module: nn.Module, parent: Tuple[str, ...], name: str,
          ndim: int) -> Optional[Tuple[int, ...]]:
    """The axes of a flax leaf in the port's layout (``torch =
    flax.transpose(perm)``), None for a leaf copied as is."""
    if name == 'kernel':
        return (1, 0) if ndim == 2 else (2, 1, 0)
    if name == 'v' and ndim == 4:
        return (3, 2, 0, 1)
    if name == 'v' and ndim == 3:
        try:
            owner = module.get_submodule('.'.join(parent))
        except AttributeError:
            owner = None                  # reported as unconsumed below
        return (1, 2, 0) if isinstance(owner, WNConvTranspose) else (2, 1, 0)
    return None


def _convert(module: nn.Module, path: Tuple[str, ...],
             leaf: np.ndarray) -> Tuple[str, np.ndarray]:
    perm = _perm(module, path[:-1], path[-1], leaf.ndim)
    name = 'weight' if path[-1] == 'kernel' else path[-1]
    if perm is not None:
        leaf = leaf.transpose(perm)
    return '.'.join(path[:-1] + (name,)), leaf


def flax_layout(module: nn.Module, key: str,
                ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """The inverse of ``_convert`` for one parameter of ``module``: its
    flax path (``/``-joined) and the permutation ``perm`` with ``torch
    leaf = flax leaf.transpose(perm)`` (None: the same layout)."""
    *parent, name = key.split('.')
    flax_name = 'kernel' if name == 'weight' else name
    return '/'.join(parent + [flax_name]), _perm(module, tuple(parent), flax_name, ndim)


def from_flax(module: nn.Module, tree: Dict[str, Any],
              batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """flax param tree (and ``batch_stats`` collection) -> state dict of
    ``module`` (float32, CPU)."""
    expect = module.state_dict()
    state, bad_shape = {}, []
    leaves = list(flatten(tree).items()) + list(flatten(batch_stats or {}).items())
    for path, leaf in leaves:
        key, arr = _convert(module, path, leaf)
        state[key] = torch.tensor(arr, dtype=torch.float32)
        if key in expect and tuple(expect[key].shape) != tuple(arr.shape):
            bad_shape.append(f'{"/".join(path)}: {tuple(arr.shape)} -> '
                             f'{key} {tuple(expect[key].shape)}')
    faults = [f'{what}: {keys}' for what, keys in (
        ('missing', sorted(set(expect) - set(state))),
        ('unconsumed', sorted(set(state) - set(expect))),
        ('shape mismatch', bad_shape)) if keys]
    if faults:
        raise ValueError(f'flax tree does not fit {type(module).__name__}; '
                         + '; '.join(faults))
    return state


def to_flax(module: nn.Module, state_dict: Dict[str, torch.Tensor]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``from_flax``: a state dict of ``module`` (or any
    subset of its keys, e.g. an optimizer's moments) -> ``(params,
    batch_stats)`` flax trees of numpy leaves in the JAX layout
    (``batch_stats`` holds the module's buffers, empty for a model without
    batch norm).  ``save_npz`` writes either with ``/``-joined keys."""
    names = {n for n, _ in module.named_parameters()}
    trees: Tuple[Dict[str, Any], Dict[str, Any]] = ({}, {})
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        path, perm = flax_layout(module, key, arr.ndim)
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        node = trees[key not in names]
        *parents, leaf = path.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return trees


def load_flax(module: nn.Module, tree: Dict[str, Any],
              batch_stats: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Copy a flax tree into ``module`` in place (on the module's device)."""
    module.load_state_dict(from_flax(module, tree, batch_stats), strict=True)
    return module


def save_npz(path: str, tree: Dict[str, Any]) -> None:
    np.savez(path, **{'/'.join(k): v for k, v in flatten(tree).items()})


def load_npz(path: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split('/')
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn on the CPU (the same on every
    device) with the JAX package's initialiser families: lecun-normal
    denses and convs, orthogonal GRU hidden kernels, zero biases,
    truncated-normal(0.5) embeddings, kaiming-normal (leaky slope 0.15)
    weight-norm directions (fan-in: every axis but the output channel) with
    the matching gain ``g``, the generators' ``alpha`` at 4, batch-norm
    scales at 1, the highway gates' bias at -1, and the fused GRU's ``wi``
    (lecun-normal) and ``wh`` (three orthogonal blocks) in flax's layout.
    Torch's random numbers, not JAX's: the trainers and the server start
    from the JAX package's draws (``flax_acoustic_init``,
    ``flax_vocoder_init``); ``tools/decode_phases.py`` and tests use this."""
    gen = torch.Generator().manual_seed(seed)
    slope_gain = 2.0 / (1.0 + 0.15 ** 2)
    for name, p in module.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        parent = name.rsplit('.', 2)[-2] if name.count('.') >= 1 else ''
        shape = p.shape
        if leaf == 'bias' and parent == 'T':
            val = torch.full(shape, -1.0)
        elif leaf in ('bias', 'b', 'attention_bias', 'bi', 'bn'):
            val = torch.zeros(shape)
        elif leaf == 'scale':
            val = torch.ones(shape)
        elif leaf == 'wi':
            val = torch.randn(shape, generator=gen) / shape[0] ** 0.5
        elif leaf == 'wh':
            val = torch.cat([torch.linalg.qr(torch.randn(shape[0], shape[0], generator=gen))[0]
                             for _ in range(shape[1] // shape[0])], 1)
        elif leaf == 'g':
            val = torch.full(shape, slope_gain ** 0.5)
        elif leaf == 'w':
            val = torch.full(shape, 1e-6)
        elif leaf == 'alpha':
            val = torch.full(shape, 4.0)
        elif leaf.startswith('E_'):
            val = (torch.randn(shape, generator=gen) * 0.5).clamp(-1.0, 1.0)
        elif leaf == 'attention_variable':
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            val = (torch.rand(shape, generator=gen) * 2 - 1) * lim
        elif leaf == 'v':
            transposed = parent.startswith('WNConvTranspose')
            fan_in = shape[0] * shape[2] if transposed else shape[1:].numel()
            val = torch.randn(shape, generator=gen) * (slope_gain / fan_in) ** 0.5
        elif leaf == 'weight' and parent in ('hr', 'hz', 'hn'):
            q, _ = torch.linalg.qr(torch.randn(shape, generator=gen))
            val = q
        elif leaf == 'weight':
            fan_in = shape[1] * (shape[2] if p.ndim == 3 else 1)
            val = torch.randn(shape, generator=gen) / fan_in ** 0.5
        else:
            raise ValueError(f'no initialiser for {name}')
        p.copy_(val)
    return module


# the JAX package's vocoder constants: weight-norm gain, biases, the
# shared noise scale, the generators' alpha
_VOCODER_CONSTANTS = {'g': (2.0 / (1.0 + 0.15 ** 2)) ** 0.5, 'b': 0.0, 'w': 1e-6,
                      'alpha': 4.0}


@torch.no_grad()
def flax_vocoder_init(module: nn.Module, key: jax_random.Key) -> nn.Module:
    """The weights the JAX package's ``init`` draws for a vocoder module (a
    generator, or one discriminator family) from the flax key ``key``, on
    the module's device: each weight-norm direction ``v`` kaiming-normal
    (leaky slope 0.15, fan-in every flax axis but the last) from
    ``jax_random.flax_key(key, (*scope, 1))`` (``v`` is the first
    parameter a weight-norm module creates), and the constants ``g``,
    ``b``, ``noise/w`` and ``alpha``."""
    for name, p in module.named_parameters():
        path, perm = flax_layout(module, name, p.ndim)
        *scope, leaf = path.split('/')
        if leaf in _VOCODER_CONSTANTS:
            p.fill_(_VOCODER_CONSTANTS[leaf])
        elif leaf == 'v':
            shape = [0] * p.ndim
            for i, axis in enumerate(perm):
                shape[axis] = p.shape[i]
            std = torch.sqrt(torch.tensor(2.0 / (1.0 + 0.15 ** 2) / np.prod(shape[:-1]),
                                          dtype=torch.float32))
            v = jax_random.normal(jax_random.flax_key(key, (*scope, 1)), shape, p.device)
            p.copy_((v * std.to(p.device)).permute(perm))
        else:
            raise ValueError(f'no flax initialiser for {name}')
    return module


# The acoustic model's flax initialisers.  Each parameter's key folds in
# its position among the parameters its scope creates (flax's counter):
# a Dense/Conv's kernel before its bias, the attention vector before its
# bias, the fused GRU's wi, wh, bi, bn, the Tacotron's own embeddings in
# the order below (those its configuration has).
_EMBEDDINGS = ('E_text', 'E_tone', 'E_prds', 'E_f0', 'E_c0')
_POSITION = {'kernel': 1, 'attention_variable': 1, 'wi': 1, 'wh': 2}
_GRU_HIDDEN = ('hr', 'hz', 'hn')
_LECUN_STD = 0.87962566103423978       # std of a standard normal cut to (-2, 2)


def _lecun_normal(key: jax_random.Key, shape) -> torch.Tensor:
    """flax's ``lecun_normal()``: truncated normal in (-2, 2) with std
    ``1 / sqrt(fan_in)`` (fan-in: every axis but the last)."""
    std = torch.sqrt(torch.tensor(1.0 / np.prod(shape[:-1]), dtype=torch.float32)) \
        / torch.tensor(_LECUN_STD, dtype=torch.float32)
    return jax_random.truncated_normal(key, -2.0, 2.0, shape) * std


def _xavier_uniform(key: jax_random.Key, shape) -> torch.Tensor:
    """flax's ``xavier_uniform()`` of a matrix ``[fan_in, fan_out]``."""
    variance = torch.tensor(2.0 / (shape[0] + shape[1]), dtype=torch.float32)
    return jax_random.uniform(key, shape, -1.0, 1.0) * torch.sqrt(3 * variance)


def _blocks(draw, key: jax_random.Key, shape, n: int = 3) -> torch.Tensor:
    """``decoder_fast._concat_init``: ``n`` draws from ``split(key, n)``
    side by side on the last axis."""
    block = tuple(shape[:-1]) + (shape[-1] // n,)
    return torch.cat([draw(k, block) for k in jax_random.split(key, n)], -1)


def _acoustic_leaf(key: jax_random.Key, scope, leaf: str, shape, embeddings,
                   gate: bool) -> Optional[torch.Tensor]:
    """What flax's ``init`` draws for the acoustic leaf ``scope/leaf`` of
    flax ``shape``; ``embeddings``: the module's embeddings in creation
    order; ``gate``: the leaf is a highway layer's ``T`` bias.  None: no
    initialiser."""
    if leaf == 'bias':
        return torch.full(shape, -1.0 if gate else 0.0)
    if leaf in ('attention_bias', 'bi', 'bn'):
        return torch.zeros(shape)
    if leaf == 'scale':
        return torch.ones(shape)
    if leaf in _EMBEDDINGS:
        k = jax_random.flax_key(key, (*scope, embeddings.index(leaf) + 1))
        return jax_random.truncated_normal(k, -2.0, 2.0, shape) * 0.5
    if leaf not in _POSITION:
        return None
    k = jax_random.flax_key(key, (*scope, _POSITION[leaf]))
    if leaf == 'kernel':
        if scope and scope[-1] in _GRU_HIDDEN:
            return jax_random.orthogonal(k, shape)
        return _lecun_normal(k, shape)
    if leaf == 'attention_variable':
        return _xavier_uniform(k, shape)
    if leaf == 'wi':
        return _blocks(_lecun_normal, k, shape)
    return _blocks(jax_random.orthogonal, k, shape)            # wh


@torch.no_grad()
def flax_acoustic_init(module: nn.Module, key: jax_random.Key,
                       scope: Tuple[str, ...] = ()) -> nn.Module:
    """The weights the JAX package's flax ``init`` draws from the
    ``'params'`` key ``key`` for an acoustic module (a ``Tacotron``, or a
    decoder cell initialised on its own) whose flax scope is ``scope``:
    Dense and Conv kernels ``lecun_normal``, GRU hidden kernels
    ``orthogonal``, the embeddings truncated-normal (std 0.5), the
    attention vector ``xavier_uniform``, the fused GRU's ``wi``/``wh`` as
    three such blocks from ``split(key, 3)``; biases 0 (the highway gates'
    -1), batch-norm scales and variances 1, means 0.  Drawn on the CPU and
    copied to the module's device, so every device and rank holds the same
    weights; a parameter with no initialiser raises."""
    from .models.layers import Highway
    gates = {'.'.join(filter(None, (n, 'T', 'bias')))
             for n, m in module.named_modules() if isinstance(m, Highway)}
    params = dict(module.named_parameters())
    embeddings = [n for n in _EMBEDDINGS if n in params]
    for name, p in params.items():
        path, perm = flax_layout(module, name, p.ndim)
        *sub, leaf = path.split('/')
        shape = [0] * p.ndim
        for i, axis in enumerate(perm or range(p.ndim)):
            shape[axis] = p.shape[i]
        val = _acoustic_leaf(key, (*scope, *sub), leaf, tuple(shape), embeddings,
                             name in gates)
        if val is None:
            raise ValueError(f'no flax initialiser for {name}')
        p.copy_((val if perm is None else val.permute(perm)).to(p.device))
    for name, buf in module.named_buffers():
        leaf = name.rsplit('.', 1)[-1]
        if leaf in ('mean', 'var'):
            buf.fill_(1.0 if leaf == 'var' else 0.0)
    return module
