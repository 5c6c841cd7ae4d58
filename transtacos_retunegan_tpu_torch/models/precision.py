"""Inference precision of the vocoder, ported from
``transtacos_retunegan_tpu/models/precision.py``.

``'float32'`` runs the generator in full precision; ``'bfloat16'`` wraps it
in ``torch.autocast``: convolutions take bf16 operands and emit bf16, and
the elementwise work around them follows, while the weight-norm math on the
float32 master weights stays float32 (autocast leaves it alone).  Callers
cast the waveform back to float32.
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
    """Context for the generator forward at the named precision."""
    dtype = resolve_dtype(name)
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type, dtype=dtype)
