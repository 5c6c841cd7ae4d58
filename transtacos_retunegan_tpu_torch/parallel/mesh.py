"""Data and tensor parallelism over processes, ported from
``transtacos_retunegan_tpu/parallel/mesh.py``.

The JAX package computes each train step on one global array sharded over
a ``(data, model)`` mesh and lets GSPMD insert the collectives.  Here each
process holds its share on one device (``cuda:LOCAL_RANK``, or the CPU),
and the trainers make the step equal the global one by hand.
``make_mesh(num_devices, model_parallel)`` lays the N ranks out as N/k
data coordinates times k model coordinates: a model group is k consecutive
ranks, which must be on one host (the JAX package keeps the model axis
within a host), and a data group is the N/k ranks of one model coordinate.
A train state carries this rank's place as its ``Shard``
(``current_shard()``, set by the trainer), and the step hands it to what
needs it:

* each model group holds the data coordinate's contiguous share of the
  global batch (``process_shard``, the feeders' defaults), so the k ranks
  of a model group compute on the same rows;
* the gradients are averaged over the data group in one flat collective
  per update (``all_reduce_grads``), before the global-norm clip;
* batch-norm statistics are summed over the data group, with a backward
  that sums the gradients too (``all_reduce_stats``), so that they are the
  global batch's;
* random draws of a batch shape are drawn at the global shape from the
  generator state every rank shares, and each rank keeps the rows of its
  data coordinate (``shard_draw``): the ranks of a model group draw alike;
* logged losses are averaged over the data group (``mean_over_ranks``).

Tensor parallelism (``k > 1``, the acoustic model): ``tp_param_specs``
names the parameters that the JAX package's ``_TP_PATTERNS`` shard, found
by their flax names and layouts (``weights.flax_layout``) and always split
on the flax layout's last (output) axis; ``shard_params_tp`` keeps this
rank's ``1/k`` of each, and of its Adam moments.  The modules that own
them (``models.layers.Dense``, ``models.decoder_fast.FusedGRU``) compute
their column slice of the product and gather it over the model group
(``copy_to_model`` forward is the identity and backward all-reduces the
input's gradient; ``gather_from_model`` all-gathers forward and keeps this
rank's slice backward), so that everything after a gather is replicated
and the same on every rank of the group.  Biases stay replicated and are
added after the gather.  ``gather_params_tp`` inverts the sharding for
checkpoints and evaluation.  The collectives are ``all_reduce``,
``all_gather`` and ``broadcast`` only, which NCCL and gloo both take on
CUDA tensors.

Each of these takes the shard explicitly and is the identity for None, so
a forward that is given no shard (inference, evaluation, a state built
without one) is local by construction and makes no collective.  The process
group is ``torch.distributed``'s: NCCL for CUDA tensors, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import re
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..weights import flax_layout


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


def check_model_parallel(args) -> None:
    """The trainers' checks of ``--model_parallel k``, made before any
    process starts: k divides ``--num_devices N``, and under a launcher
    its local world size, so that no model group spans hosts (``--
    coordinator`` groups are checked by ``make_mesh``, which sees the
    hosts)."""
    k = getattr(args, 'model_parallel', 1) or 1
    n = getattr(args, 'num_devices', 0) or 0
    if k < 1:
        raise SystemExit(f'--model_parallel {k}: must be at least 1')
    if k == 1 or n <= 1:
        return
    if n % k:
        raise SystemExit(f'--model_parallel {k} does not divide --num_devices {n}')
    if 'WORLD_SIZE' in os.environ and 'LOCAL_WORLD_SIZE' in os.environ:
        local = int(os.environ['LOCAL_WORLD_SIZE'])
        if local % k:
            raise SystemExit(f'--model_parallel {k}: model groups would span hosts '
                             f'({local} processes on this host)')


def join_mesh(args) -> Optional[Shard]:
    """The trainers' ``make_mesh`` after ``join_group``, with its faults
    as exits that name the flag."""
    try:
        return make_mesh(getattr(args, 'num_devices', 0) or None,
                         getattr(args, 'model_parallel', 1) or 1)
    except ValueError as e:
        raise SystemExit(f'--model_parallel {getattr(args, "model_parallel", 1)}: {e}')


def describe(mesh: Optional[Shard], per_shard: int, unit: str, args) -> Optional[str]:
    """The trainers' log line of the layout, ``per_shard`` ``unit`` in each
    data shard (None: one process)."""
    k = getattr(args, 'model_parallel', 1) or 1
    if mesh is None or mesh.count * mesh.model_count == 1:
        return f'--model_parallel {k} ignored: one device' if k > 1 else None
    if mesh.model_count == 1:
        return f'data parallel over {mesh.count} processes, {per_shard} {unit} each'
    return (f'data parallel over {mesh.count} shards, {per_shard} {unit} each; '
            f'tensor parallel over {mesh.model_count} processes per shard')


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
    """This process's place in the ``(data, model)`` layout: data
    coordinate ``index`` of ``count`` (its model group holds ``1/count`` of
    the global batch) and model coordinate ``model_index`` of
    ``model_count`` (its slice of each tensor-parallel parameter);
    ``data_group``/``model_group`` are the process groups along each axis
    (None: the world, and no model group at ``model_count`` 1); ``world``
    is the default group the layout was made in."""
    index: int
    count: int
    model_index: int = 0
    model_count: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    world: Any = dataclasses.field(default=None, compare=False, repr=False)


_MESH: Optional[Shard] = None


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1) -> Optional[Shard]:
    """Lay the process group out as ``(N / model_parallel) x
    model_parallel`` and make it this process's ``current_shard()``: model
    group j is ranks ``j*k .. j*k + k - 1``, data group m the ranks ``m,
    m + k, ...``.  Every rank calls it (it creates the groups).  None
    without a group; ``model_parallel`` is ignored at world size 1.
    Raises ValueError when k does not divide N, or when a model group's
    ranks are on more than one host.  Each call at ``k > 1`` makes new
    groups."""
    global _MESH
    if not dist.is_initialized():
        _MESH = None
        return None
    n = world_size()
    if num_devices and num_devices != n:
        raise ValueError(f'{num_devices} devices but the process group has {n} processes')
    k = model_parallel if n > 1 else 1
    if k < 1 or n % k:
        raise ValueError(f'model_parallel {k} does not divide the {n} processes')
    _MESH = _layout(n, k)
    return _MESH


def _layout(n: int, k: int) -> Shard:
    r, world = rank(), dist.group.WORLD
    if k == 1:
        return Shard(r, n, world=world)
    hosts: List[Optional[str]] = [None] * n
    dist.all_gather_object(hosts, socket.gethostname())
    for j in range(n // k):
        if len(set(hosts[j * k:(j + 1) * k])) > 1:
            raise ValueError(f'model group {j} (ranks {j * k}-{j * k + k - 1}) spans the '
                             f'hosts {sorted(set(hosts[j * k:(j + 1) * k]))}')
    groups = {}
    for j in range(n // k):                 # every rank creates every group
        groups['model', j] = dist.new_group(list(range(j * k, (j + 1) * k)))
    for m in range(k):
        groups['data', m] = dist.new_group(list(range(m, n, k)))
    return Shard(r // k, n // k, r % k, k, groups['data', r % k], groups['model', r // k],
                 world)


def current_shard() -> Optional[Shard]:
    """This process's shard: the layout of the last ``make_mesh`` in the
    current process group, else rank ``rank()`` of ``world_size()`` data
    coordinates (also at world size 1); None without a group."""
    if not dist.is_initialized():
        return None
    if _MESH is not None and _MESH.world is dist.group.WORLD:
        return _MESH
    return Shard(rank(), world_size(), world=dist.group.WORLD)


def process_shard(n: int) -> slice:
    """This process's contiguous slice of a leading batch axis of size n:
    its data coordinate's share (everything in one process)."""
    s = current_shard()
    pc, i = (1, 0) if s is None else (s.count, s.index)
    if n % pc:
        raise ValueError(f'batch axis {n} not divisible by {pc} data shards')
    per = n // pc
    return slice(i * per, (i + 1) * per)


def data_shards() -> Tuple[int, int]:
    """(count, index) of this process on the data axis: the feeders'
    default share of every global batch."""
    s = current_shard()
    return (1, 0) if s is None else (s.count, s.index)


def shard_draw(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
               shard: Optional[Shard], axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` with ``shape[axis]`` the local batch: under a
    ``shard`` the draw is made at the global batch's shape and this process
    keeps the rows of its data coordinate, so that every rank advances the
    shared generator alike and row i of the global batch gets the draw it
    gets in one process."""
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
    """Broadcast every parameter and buffer from rank 0, in place (before
    ``shard_params_tp``: the slices differ by rank)."""
    if dist.is_initialized():
        for t in module.state_dict().values():
            dist.broadcast(t, 0)
    return module


def all_reduce_grads(tensors: List[torch.Tensor], shard: Optional[Shard]) -> None:
    """Average ``tensors`` (gradients, and any loss the update's guard
    reads) over the data group of ``shard`` in place: one flat bucket per
    dtype, one collective each; nothing without a shard."""
    if shard is None:
        return
    pc = shard.count
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=shard.data_group)
        flat.div_(pc)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; its gradient is the sum of the
    ranks' gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_stats(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Differentiable sum of ``x`` over the data group of ``shard`` (``x``
    itself without one): batch statistics of the global batch."""
    if shard is None:
        return x
    return _AllReduceSum.apply(x, shard.data_group)


def global_mean(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Differentiable mean of ``x`` over the global batch, for data shards
    of equal size (``x.mean()`` without a shard)."""
    if shard is None:
        return x.mean()
    return all_reduce_stats(x.mean(), shard) / shard.count


def mean_over_ranks(values: Dict[str, torch.Tensor],
                    shard: Optional[Shard]) -> Dict[str, torch.Tensor]:
    """0-dim tensors averaged over the data group of ``shard`` in one
    collective (what a step logs), in float32 (float64 if any is); other
    values, and all without a shard, pass through."""
    if shard is None:
        return values
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return values
    wide = any(values[k].dtype == torch.float64 for k in keys)
    flat = torch.stack([values[k].detach().to(torch.float64 if wide else torch.float32)
                        .reshape(()) for k in keys])
    dev = _comm_device(flat)
    buf = flat.to(dev)
    dist.all_reduce(buf, group=shard.data_group)
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


# -- tensor parallelism -----------------------------------------------------
# The JAX package's rules (``parallel/mesh.py``), on flax names: pattern ->
# the axis of the flax leaf to shard over 'model'.  Only leaves of ndim >= 2
# and size >= 4096 whose axis divides by k are sharded; the rest replicate.
_TP_PATTERNS = [
    (re.compile(r'.*(posnet4_\d+|posnet3|posnet2).*'), -1),   # grouped heads
    (re.compile(r'.*decoder_cell.*(gru_\d+|rnn_in_proj).*'), -1),
    (re.compile(r'.*(sa_\d+_\d+|proj_sa_\d+).*'), -1),        # attention heads
    (re.compile(r'.*(conv_fuse|merge_\d+|dec_rb.*|enc_r.*|ups.*|WNConv.*).*'), -1),
]


def tp_param_specs(model: torch.nn.Module, mesh) -> Dict[str, int]:
    """``{parameter name: the axis of its tensor split over the model
    axis}`` for the parameters of ``model`` that the JAX package's
    ``tp_param_specs`` shards, by their flax names and layouts; ``mesh`` is
    a ``Shard`` or the model-axis size.  Empty at size 1."""
    k = mesh if isinstance(mesh, int) else (1 if mesh is None else mesh.model_count)
    specs: Dict[str, int] = {}
    if k <= 1:
        return specs
    for name, p in model.named_parameters():
        if p.dim() < 2 or p.numel() < 4096:
            continue
        path, perm = flax_layout(model, name, p.dim())
        for pat, axis in _TP_PATTERNS:
            if pat.match(path):
                ax = axis % p.dim()
                ax = ax if perm is None else perm.index(ax)
                if p.shape[ax] % k == 0:
                    specs[name] = ax
                    break
    return specs


def _keep(t: torch.Tensor, axis: int, shard: Shard) -> torch.Tensor:
    n = t.shape[axis] // shard.model_count
    return t.narrow(axis, shard.model_index * n, n).clone(memory_format=torch.contiguous_format)


def tp_sharded(model: torch.nn.Module) -> Dict[str, Tuple[int, Shard]]:
    """``{parameter name: (its split axis, the shard)}`` of a model after
    ``shard_params_tp``; empty for a whole model."""
    out = {}
    for mname, m in model.named_modules():
        tp = getattr(m, 'tp', None)
        if tp is not None:
            for leaf, axis in type(m).TP_LEAVES.items():
                out[f'{mname}.{leaf}' if mname else leaf] = (axis, tp)
    return out


def shard_params_tp(mesh: Optional[Shard], model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> torch.nn.Module:
    """Keep this rank's slice of every parameter ``tp_param_specs`` names
    (and of its moments in ``optimizer``'s state), in place, and hand the
    owning modules the shard, whose forward then computes its column slice
    and gathers the product over the model group.  Raises
    NotImplementedError for a parameter whose module has no such forward."""
    specs = tp_param_specs(model, mesh)
    owners: Dict[str, Dict[str, int]] = {}
    for name, axis in specs.items():
        mname, _, leaf = name.rpartition('.')
        owners.setdefault(mname, {})[leaf] = axis
    for mname, leaves in owners.items():
        if leaves != getattr(type(model.get_submodule(mname)), 'TP_LEAVES', None):
            raise NotImplementedError(f'{mname}: no column-parallel forward for {leaves}')
    with torch.no_grad():
        for name, axis in specs.items():
            p = model.get_parameter(name)
            p.data = _keep(p.data, axis, mesh)
            p.grad = None
    for mname in owners:
        model.get_submodule(mname).tp = mesh
    if optimizer is not None:
        slice_moments(model, optimizer)
    return model


def slice_moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> None:
    """Cut the optimizer's whole-leaf moments of the sharded parameters to
    this rank's slices (after ``shard_params_tp`` or a restore)."""
    for name, (axis, tp) in tp_sharded(model).items():
        p = model.get_parameter(name)
        st = optimizer.state.get(p, {})
        for key, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() == p.dim() and v.shape != p.shape:
                st[key] = _keep(v, axis, tp)


def tp_local(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole leaves (a checkpoint's) -> this rank's slices of the sharded
    ones; the rest pass through."""
    sharded = tp_sharded(model)
    return {n: _keep(t, *sharded[n]) if n in sharded else t for n, t in tensors.items()}


def _gather_leaf(t: torch.Tensor, axis: int, shard: Shard) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(shard.model_count)]
    dist.all_gather(parts, t.contiguous(), group=shard.model_group)
    return torch.cat(parts, axis)


@torch.no_grad()
def gather_tp(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{parameter name: tensor}`` of this rank's slices (parameters,
    gradients) -> the whole leaves of the names ``model`` shards, the rest
    as they are.  A collective over each model group: every rank calls it,
    in the same order."""
    sharded = tp_sharded(model)
    return {n: _gather_leaf(t, *sharded[n]) if n in sharded else t.detach()
            for n, t in tensors.items()}


@torch.no_grad()
def gather_params_tp(model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None):
    """The whole parameters of a sharded model, on every rank, and the
    optimizer's ``state_dict`` with whole moments (None without one): the
    inverse of ``shard_params_tp``, for checkpoints and evaluation.  A
    collective over each model group: every rank calls it, in the same
    order."""
    sharded = tp_sharded(model)
    params = gather_tp(model, dict(model.named_parameters()))
    if optimizer is None:
        return params, None
    names = {id(p): n for n, p in model.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g['params']]
    sd = optimizer.state_dict()
    for i, p in enumerate(flat):
        name = names.get(id(p))
        if name in sharded and i in sd['state']:
            sd['state'][i] = {k: _gather_leaf(v, *sharded[name])
                              if isinstance(v, torch.Tensor) and v.shape == p.shape else v
                              for k, v in sd['state'][i].items()}
    return params, sd


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over the model group (each rank's
    slice of the product holds part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last axis, in ``chunks`` blocks (rank r's
    output is its slice of each block); the gradient is this rank's
    slice (the loss after the gather is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, shard, chunks):
        ctx.shard, ctx.chunks = shard, chunks
        parts = [torch.empty_like(x) for _ in range(shard.model_count)]
        dist.all_gather(parts, x.contiguous(), group=shard.model_group)
        return torch.stack([p.unflatten(-1, (chunks, -1)) for p in parts], -2).flatten(-3)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        g = g.unflatten(-1, (ctx.chunks, s.model_count, -1)).select(-2, s.model_index)
        return g.flatten(-2), None, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the gradient passes as it is (every rank
    computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return x if shard is None else _CopyToModel.apply(x, shard.model_group)


def gather_from_model(x: torch.Tensor, shard: Optional[Shard], chunks: int = 1) -> torch.Tensor:
    return x if shard is None else _GatherFromModel.apply(x, shard, chunks)


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return x if shard is None else _ReduceFromModel.apply(x, shard.model_group)


def column_matmul(x: torch.Tensor, w: torch.Tensor, shard: Optional[Shard],
                  chunks: int = 1) -> torch.Tensor:
    """``x @ W`` where ``w`` [in, out/k] is this rank's column slice of W
    under ``shard`` (made of ``chunks`` blocks, each split alike): the
    whole product on every rank of the model group; ``x @ w`` without one."""
    if shard is None:
        return x @ w
    return gather_from_model(copy_to_model(x, shard) @ w, shard, chunks)
