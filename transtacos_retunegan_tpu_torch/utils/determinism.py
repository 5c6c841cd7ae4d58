"""Deterministic kernels for bit-for-bit comparisons of two runs on the
card (a data-parallel step at world size 1 against the step without a
process group)."""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Iterator, Set

import torch


@contextlib.contextmanager
def deterministic() -> Iterator[Set[str]]:
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (the STFT's framing has overlapping windows, whose
    gradient is an ``index_add_`` of atomics otherwise), restored after;
    yields a set that receives the distinct warnings of ops without one."""
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get('CUBLAS_WORKSPACE_CONFIG'))
    torch.backends.cudnn.deterministic = True
    # cuBLAS on one stream is deterministic; the variable only answers the check
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.use_deterministic_algorithms(True, warn_only=True)
    notes: Set[str] = set()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            yield notes
        notes.update(str(w.message).split('.')[0][:120] for w in caught)
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])
        if saved[3] is None:
            os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
