"""Vocoder precision policy, ported from
``transtacos_retunegan_tpu/models/precision.py``.

``'float32'`` runs in full precision; ``'bfloat16'`` wraps the generator and
the discriminators in ``torch.autocast``: convolutions take bf16 operands
and emit bf16, and the elementwise work around them follows, while the
float32 master parameters and the weight-norm math on them stay float32
(autocast leaves them alone).  For training, as in the JAX package's GAN
step: the waveform and every discriminator score and feature map are cast
back to float32 (``float32``), and the STFT features and every loss are
computed outside the autocast region, in float32.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_dtype(name: str):
    """Map a config string to a torch dtype, or None for full precision."""
    if name in ('float32', 'f32', '', None):
        return None
    if name in ('bfloat16', 'bf16'):
        return torch.bfloat16
    raise ValueError(f'unsupported compute_dtype: {name!r}')


def compute_dtype(name: str, device: torch.device):
    """Context for a generator or discriminator forward at the named
    precision."""
    dtype = resolve_dtype(name)
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type, dtype=dtype)


def float32(tree):
    """Every 16-bit tensor of nested lists and tuples cast to float32 (the
    autocast outputs; wider ones pass through)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(float32(x) for x in tree)
    return tree.float() if tree.dtype in (torch.bfloat16, torch.float16) else tree
