"""Gradient helpers shared by the trainers: the global norm (of the whole
gradient under tensor parallelism), and optax's
``clip_by_global_norm`` (no epsilon on the norm, unlike
``torch.nn.utils.clip_grad_norm_``), both without a host sync."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .parallel import Shard, reduce_from_model


def global_norm(grads: List[torch.Tensor], shard: Optional[Shard] = None,
                sharded: Sequence[bool] = ()) -> torch.Tensor:
    """The norm of the whole gradient.  Under tensor parallelism
    (``shard``) ``sharded[i]`` marks the gradients that are this rank's
    slice of a leaf: their squares are summed over the model group, and
    each replicated leaf is counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if shard is None or shard.model_count == 1 or not any(sharded):
        return torch.linalg.vector_norm(norms)
    sq = norms * norms
    mask = torch.tensor(sharded, dtype=sq.dtype, device=sq.device)
    part = reduce_from_model((sq * mask).sum(), shard)
    return torch.sqrt(part + (sq * (1.0 - mask)).sum())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` where the global
    norm reaches ``max_norm``."""
    norm = global_norm(grads) if norm is None else norm
    small = norm < max_norm
    div = torch.where(small, torch.ones_like(norm), norm)
    mul = torch.where(small, torch.ones_like(norm), torch.full_like(norm, max_norm))
    torch._foreach_div_(grads, div)
    torch._foreach_mul_(grads, mul)


def zero_grad_(params) -> None:
    """Zero gradients on every parameter (a zero tensor where there was
    none, so that parameters the loss does not reach take a zero
    gradient, as ``jax.grad`` gives them)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
