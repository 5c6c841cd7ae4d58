"""The one-process forms of the port's ``parallel`` helpers that the copied
models call (``transtacos_retunegan_tpu_torch/parallel/mesh.py``, the
``shard is None`` branch of each): the reference runs in one process, so
every collective is the identity."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

Shard = object


def shard_draw(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
               shard: Optional[Shard] = None, axis: int = 0) -> torch.Tensor:
    return draw(tuple(shape))


def all_reduce_grads(tensors: List[torch.Tensor], shard: Optional[Shard] = None) -> None:
    return None


def all_reduce_stats(x: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    return x


def global_mean(x: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    return x.mean()


def mean_over_ranks(values: Dict[str, torch.Tensor],
                    shard: Optional[Shard] = None) -> Dict[str, torch.Tensor]:
    return values


def copy_to_model(x: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    return x


def gather_from_model(x: torch.Tensor, shard: Optional[Shard] = None,
                      chunks: int = 1) -> torch.Tensor:
    return x


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    return x


def tp_sharded(model: torch.nn.Module) -> dict:
    return {}
