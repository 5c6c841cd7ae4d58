"""Data parallelism over processes, ported from
``transtacos_retunegan_tpu/parallel/mesh.py``.

The JAX package computes each train step on one global array sharded over
a ``(data, model)`` mesh and lets GSPMD insert the collectives.  Here each
process holds one replica of the model on one device (``cuda:LOCAL_RANK``,
or the CPU) and its contiguous share of the global batch,
``process_shard``; the trainers make the step equal the global one by hand.
A train state carries its ``Shard`` (``current_shard()``, set by the
trainer), and the step hands it to what needs it:

* the gradients are averaged over the ranks in one flat collective per
  update (``all_reduce_grads``), before the global-norm clip;
* batch-norm statistics are summed over the ranks, with a backward that
  sums the gradients too (``all_reduce_stats``), so that they are the
  global batch's;
* random draws of a batch shape are drawn at the global shape from the
  generator state every rank shares, and each rank keeps its rows
  (``shard_draw``);
* logged losses are averaged over the ranks (``mean_over_ranks``).

Each of these takes the shard explicitly and is the identity for None, so
a forward that is given no shard (inference, evaluation, a state built
without one) is local by construction and makes no collective.  The process
group is ``torch.distributed``'s: NCCL for CUDA tensors, gloo on the CPU.
The JAX package's tensor parallelism (``make_mesh``'s model axis,
``tp_param_specs``) has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device='cpu') -> bool:
    """Join the process group: ``tcp://<coordinator>`` with the given world
    size and rank, else ``env://`` where a launcher (torchrun) set ``RANK``
    and ``WORLD_SIZE``; a no-op without either, as the JAX hook is.
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo otherwise.
    Returns whether a group is up."""
    if dist.is_initialized():
        return True
    launched = 'RANK' in os.environ and 'WORLD_SIZE' in os.environ
    if coordinator is None and not launched:
        return False
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    if coordinator is not None:
        world = num_processes if num_processes is not None else int(os.environ['WORLD_SIZE'])
        rank_ = process_id if process_id is not None else int(os.environ['RANK'])
        dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                                world_size=world, rank=rank_)
    else:
        dist.init_process_group(backend, init_method='env://')
    return True


def free_port() -> int:
    """A free TCP port on this machine, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _worker(fn: Callable, args, i: int, n: int, port: int) -> None:
    os.environ.update(RANK=str(i), WORLD_SIZE=str(n), LOCAL_RANK=str(i),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    if 'OMP_NUM_THREADS' not in os.environ:    # as torchrun: share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    fn(args)


def start_workers(fn: Callable, args) -> bool:
    """``--num_devices N`` outside a launcher: run ``fn(args)`` in N local
    processes of one group (rank i on ``cuda:i`` or the CPU), wait for
    them, and return True; a worker that fails stops the others and its
    exit code is raised as ``SystemExit``.  False (nothing started) with
    one device, under a launcher (``RANK``/``WORLD_SIZE``) or with
    ``--coordinator``."""
    n = getattr(args, 'num_devices', 0) or 0
    if (n <= 1 or getattr(args, 'coordinator', None) is not None
            or ('RANK' in os.environ and 'WORLD_SIZE' in os.environ)):
        return False
    if torch.device(getattr(args, 'device', 'cuda')).type == 'cuda':
        have = torch.cuda.device_count()
        if have < n:
            raise SystemExit(f'--num_devices {n} but only {have} CUDA devices')
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, args, i, n, port)) for i in range(n)]
    for p in procs:
        p.start()
    failed = 0
    try:
        while any(p.is_alive() for p in procs):
            failed = next((p.exitcode for p in procs if p.exitcode), 0)
            if failed:
                break
            time.sleep(0.2)
        failed = failed or next((p.exitcode for p in procs if p.exitcode), 0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    if failed:
        raise SystemExit(failed if failed > 0 else 1)
    return True


def join_group(args, device) -> torch.device:
    """The trainers' entry: join the process group of ``--coordinator``/
    ``--num_processes``/``--process_id`` or of a launcher, and check it
    against ``--num_devices`` (one process per device).  Returns this
    process's device (``cuda:LOCAL_RANK``, or ``device`` itself)."""
    dev = local_device(device)
    if (getattr(args, 'coordinator', None) is not None
            and None in (getattr(args, 'num_processes', None), getattr(args, 'process_id', None))
            and not ('RANK' in os.environ and 'WORLD_SIZE' in os.environ)):
        raise SystemExit('--coordinator needs --num_processes and --process_id '
                         '(or a launcher\'s RANK and WORLD_SIZE)')
    maybe_initialize_distributed(getattr(args, 'coordinator', None),
                                 getattr(args, 'num_processes', None),
                                 getattr(args, 'process_id', None), device=dev)
    if dev.type == 'cuda' and torch.cuda.is_available():
        torch.cuda.set_device(dev)
    n, pc = getattr(args, 'num_devices', 0) or 0, world_size()
    if pc > 1 and n <= 1:
        # the feeder would shard the batch while nothing averages the
        # gradients: N processes would train N diverging models
        raise SystemExit(f'a process group of {pc} needs --num_devices {pc} so that '
                         'the ranks average their gradients')
    if n > 1 and pc != n:
        raise SystemExit(f'--num_devices {n} but the process group has {pc} '
                         'processes (one per device)')
    return dev


def single_host(args=None) -> bool:
    """Whether every rank of the run is a process of this machine: not a
    group joined through ``--coordinator`` (its ranks may be elsewhere),
    and under a launcher its ``LOCAL_WORLD_SIZE`` equal to its
    ``WORLD_SIZE``.  Known before the group is joined."""
    if args is not None and getattr(args, 'coordinator', None) is not None:
        return False
    if 'WORLD_SIZE' in os.environ:
        return os.environ.get('LOCAL_WORLD_SIZE') == os.environ['WORLD_SIZE']
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on rank 0, which alone writes logs, summaries and checkpoints."""
    return rank() == 0


def local_device(device) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for a CUDA device
    given without an index, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    return dev


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's share of a data-parallel step: rank ``index`` of the
    ``count`` processes of the process group, each holding ``1/count`` of
    the global batch."""
    index: int
    count: int


def current_shard() -> Optional[Shard]:
    """This process's shard of the process group (also at world size 1),
    None without a group."""
    return Shard(rank(), world_size()) if dist.is_initialized() else None


def process_shard(n: int) -> slice:
    """This process's contiguous slice of a leading batch axis of size n
    (everything in one process)."""
    pc = world_size()
    if n % pc:
        raise ValueError(f'batch axis {n} not divisible by {pc} processes')
    per = n // pc
    i = rank()
    return slice(i * per, (i + 1) * per)


def shard_draw(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
               shard: Optional[Shard], axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` with ``shape[axis]`` the local batch: under a
    ``shard`` the draw is made at the global batch's shape and this process
    keeps its rows, so that every rank advances the shared generator alike
    and row i of the global batch gets the draw it gets in one process."""
    if shard is None or shard.count == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[axis] *= shard.count
    return draw(tuple(full)).narrow(axis, shard.index * shape[axis], shape[axis])


def _comm_device(t: torch.Tensor) -> torch.device:
    """NCCL takes CUDA tensors only; gloo takes either."""
    if dist.get_backend() == 'nccl' and t.device.type != 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return t.device


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer from rank 0, in place."""
    if dist.is_initialized():
        for t in module.state_dict().values():
            dist.broadcast(t, 0)
    return module


def all_reduce_grads(tensors: List[torch.Tensor], shard: Optional[Shard]) -> None:
    """Average ``tensors`` (gradients, and any loss the update's guard
    reads) over the ranks of ``shard`` in place: one flat bucket per dtype,
    one collective each; nothing without a shard."""
    if shard is None:
        return
    pc = shard.count
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(pc)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients
    (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_stats(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``shard`` (``x``
    itself without one): batch statistics of the global batch."""
    if shard is None:
        return x
    return _AllReduceSum.apply(x)


def global_mean(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Differentiable mean of ``x`` over the global batch, for ranks that
    hold equal shares (``x.mean()`` without a shard)."""
    if shard is None:
        return x.mean()
    return all_reduce_stats(x.mean(), shard) / shard.count


def mean_over_ranks(values: Dict[str, torch.Tensor],
                    shard: Optional[Shard]) -> Dict[str, torch.Tensor]:
    """0-dim tensors averaged over the ranks of ``shard`` in one collective
    (what a step logs); other values, and all without a shard, pass
    through."""
    if shard is None:
        return values
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return values
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dev = _comm_device(flat)
    buf = flat.to(dev)
    dist.all_reduce(buf)
    buf = (buf / shard.count).to(flat.device)
    return {**values, **dict(zip(keys, buf.unbind()))}


def any_rank(flag: bool, device='cpu') -> bool:
    """True on every rank when ``flag`` is true on any (a decision that
    ends the run must be taken by all ranks together)."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    t = t.to(_comm_device(t))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
