"""Process groups for ``tests/test_torch_port_parallel.py``: ``Group``
starts N spawned processes that join one gloo group and stay up for a test
module, and runs jobs on every rank at once.  The jobs below import only
torch and the port, so that a rank starts in a few seconds; called in the
test process itself, outside any group, they compute the one-process
reference on the whole global batch (``process_shard`` is then the whole
batch)."""

import datetime
import importlib
import multiprocessing
import os
import traceback
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.models.layers import Draws
from transtacos_retunegan_tpu_torch.data.feeder import DataFeeder
from transtacos_retunegan_tpu_torch.data.vocoder_data import VocoderLoader
from transtacos_retunegan_tpu_torch.parallel import (current_shard, free_port,
                                                    mean_over_ranks, process_shard, rank)
from transtacos_retunegan_tpu_torch.tools import multihost_smoke
from transtacos_retunegan_tpu_torch.train import acoustic_step as A
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.train import vocoder_step as V

JOB_TIMEOUT_S = 120.0


class Group:
    """N ranks of one gloo group on this machine's CPU."""

    def __init__(self, n: int = 2):
        ctx = multiprocessing.get_context('spawn')
        port = free_port()
        self.n = n
        self.broken = None
        self._in = [ctx.Queue() for _ in range(n)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_serve, args=(r, n, port, self._in[r], self._out),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; the ranks' results in rank order.
        A rank's failure or a timeout marks the group broken (a rank may be
        stuck in a collective) and raises."""
        if self.broken:
            raise RuntimeError(f'the group broke earlier: {self.broken}')
        for q in self._in:
            q.put((fn, args))
        got = {}
        try:
            for _ in range(self.n):
                r, ok, val = self._out.get(timeout=JOB_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f'rank {r} failed:\n{val}')
                got[r] = val
        except BaseException as e:
            self.broken = repr(e)[:200]
            raise
        return [got[r] for r in range(self.n)]

    def close(self):
        for q in self._in:
            q.put(None)
        for p in self._procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join()


def _serve(r, n, port, inq, outq):
    torch.set_num_threads(1)
    # as a launcher sets them: the trainers join this group
    os.environ.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(n))
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=n,
                            rank=r, timeout=datetime.timedelta(seconds=JOB_TIMEOUT_S / 2))
    try:
        while True:
            job = inq.get()
            if job is None:
                return
            fn, args = job
            try:
                outq.put((r, True, fn(*args)))
            except BaseException:
                outq.put((r, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def shard_defaults():
    """(shards, index) of a feeder built without them, and a loader's
    examples per batch of 4."""
    from transtacos_retunegan_tpu_torch.config import Config
    f = DataFeeder([None] * 8, Config())
    return f._pc, f._pidx, VocoderLoader([None] * 8, 4).bs


def device_data_lengths(pcfg, data_dir, split, n):
    """The loss lengths of this rank's first ``n`` planned batches of its
    block of the device-resident corpus (maxima over the ranks)."""
    from transtacos_retunegan_tpu_torch.data.device_data import (DevicePump,
                                                                  ShardedDeviceResidentData)
    from transtacos_retunegan_tpu_torch.data.feeder import AcousticDataset
    dd = ShardedDeviceResidentData(AcousticDataset(data_dir, pcfg, split), pcfg,
                                   current_shard(), 'cpu')
    pump = DevicePump(dd, seed=7)
    return [(int(b['frame_loss_len']), int(b['text_loss_len']))
            for b in (pump.get_batch() for _ in range(n))]


def smoke(argv):
    return multihost_smoke.run(argv)


def cli(module, argv, tensorboard=True):
    """``main(argv)`` of a port module, in this group as under a launcher;
    without ``tensorboard`` the trainers find no TensorBoard (whose
    writer imports TensorFlow where it is installed, about 20 s) and write
    no summaries."""
    import sys
    saved = sys.modules.get('tensorboard', False)
    if not tensorboard:
        sys.modules['tensorboard'] = None            # find_spec: not installed
    try:
        importlib.import_module(f'transtacos_retunegan_tpu_torch.{module}').main(argv)
    finally:
        if not tensorboard:
            if saved is False:
                del sys.modules['tensorboard']
            else:
                sys.modules['tensorboard'] = saved


def spawned_entry(args):
    """A trainer's stand-in for ``start_workers``: join the group as the
    trainers do, all-reduce the rank, write what this rank saw, then rank
    1 exits 3 while rank 0 waits in a second collective."""
    from transtacos_retunegan_tpu_torch.parallel import join_group, world_size
    dev = join_group(args, args.device)
    t = torch.tensor([float(rank())])
    dist.all_reduce(t)
    with open(os.path.join(args.out, f'rank{rank()}'), 'w') as fh:
        fh.write(f'{rank()} {world_size()} {dev} {float(t)}')
    if rank() == 1:
        raise SystemExit(3)
    dist.all_reduce(t)


def _local(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    sl = process_shard(len(batch['text'] if 'text' in batch else batch['wav']))
    return {k: torch.from_numpy(np.ascontiguousarray(v[sl] if v.ndim else v))
            for k, v in batch.items()}


def _np(named) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in named}


def acoustic_step(pcfg, tree, stats, batch, step, hoisted=False, keep=None, seeds=None):
    """One acoustic step from ``tree`` (and ``stats``) at ``step`` on this
    rank's rows of ``batch``: the prenet masks ``keep`` ([S, B, width] of
    the global batch; this rank's columns), or the noise, dropout and
    teacher-forcing streams seeded with ``seeds``, or no draws.  Returns
    the logged losses, the averaged (clipped) gradients, the updated
    parameters and the batch statistics."""
    model = weights.load_flax(Tacotron(pcfg), tree, stats)
    state = A.TrainState(step, model, A.make_optimizer(pcfg, model), current_shard())
    if seeds is not None:
        draws = Draws(*[torch.Generator().manual_seed(s) for s in seeds])
    else:
        sl = process_shard(batch['text'].shape[0])
        draws = Draws(prenet_keep=None if keep is None
                      else [torch.from_numpy(np.ascontiguousarray(k[:, sl])) for k in keep])
    fn = A.train_step_hoisted if hoisted else A.train_step
    state, losses = fn(pcfg, state, _local(batch), draws)
    return {'losses': {k: float(v) for k, v in losses.items()},
            'grads': _np((n, p.grad) for n, p in model.named_parameters()),
            'params': _np(model.named_parameters()),
            'buffers': _np(model.named_buffers())}


def acoustic_steps(pcfg, tree, stats, batches, seeds):
    """Consecutive steps with every stream on; the parameters, batch
    statistics and optimizer moments after them."""
    model = weights.load_flax(Tacotron(pcfg), tree, stats)
    state = A.TrainState(4000, model, A.make_optimizer(pcfg, model), current_shard())
    draws = Draws(*[torch.Generator().manual_seed(s) for s in seeds])
    for b in batches:
        state, _ = A.train_step(pcfg, state, _local(b), draws)
    moments = {n: state.opt.state[p]['exp_avg'] for n, p in model.named_parameters()}
    return {'params': _np(model.named_parameters()), 'buffers': _np(model.named_buffers()),
            'moments': _np(moments.items())}


def gan_phases(pcfg, gtree, dtree, batch, noise, new_dtree, steps_per_epoch,
               dtype=torch.float32):
    """The GAN step's phases on this rank's rows (``noise``: the global
    batch's noise tensors in call order, [B, C, T]), in ``dtype``: one
    discriminator update from the common start, then the generator update
    against the discriminators ``new_dtree``.  Metrics, gradients and
    parameters of both."""
    st = V.init_gan_state(pcfg, 0, 'cpu', current_shard())
    weights.load_flax(st.generator, gtree)
    weights.load_flax(st.discriminators, dtree)
    st.generator.to(dtype)
    st.discriminators.to(dtype)
    local = {k: v.to(dtype) if v.is_floating_point() else v for k, v in _local(batch).items()}
    sl = process_shard(batch['wav'].shape[0])
    nz = [torch.from_numpy(np.ascontiguousarray(n[sl])).to(dtype) for n in noise]
    y_g = V.apply_generator(pcfg, st.generator, local, nz)
    d_aux = V.discriminator_phase(pcfg, st, local['wav'], y_g.detach(), steps_per_epoch)
    disc = {'grads': _np((n, p.grad) for n, p in st.discriminators.named_parameters()),
            'params': _np(st.discriminators.named_parameters())}
    weights.load_flax(st.discriminators, new_dtree)
    g_aux = V.generator_phase(pcfg, st, local['wav'], y_g, steps_per_epoch)
    m = mean_over_ranks({k: v.detach() for k, v in {**d_aux, **g_aux}.items()}, st.shard)
    return {'metrics': {k: float(v) for k, v in m.items()}, 'disc': disc,
            'gen': {'grads': _np((n, p.grad) for n, p in st.generator.named_parameters()),
                    'params': _np(st.generator.named_parameters())}}


def gan_steps(pcfg, batches, seed):
    """Whole GAN steps from seeded weights with the noise drawn from a
    generator; the parameters and the metrics of the last step."""
    st = V.init_gan_state(pcfg, 5, 'cpu', current_shard())
    noise = torch.Generator().manual_seed(seed)
    for b in batches:
        st, m = V.gan_train_step(pcfg, st, _local(b), noise, 4)
    return {'params': {**_np(st.generator.named_parameters()),
                       **{f'd.{n}': v for n, v in _np(st.discriminators.named_parameters()).items()}},
            'metrics': {k: float(v) for k, v in m.items()}}


def checkpoint_round(pcfg, tree, batch, run_dir, k=1):
    """Save both trainers' checkpoints with every file write recorded (rank
    0 writes, the others wait), then restore into a state seeded
    differently and take one step; what each rank wrote, the restored step
    and the parameters after the step.  With the model axis of size ``k``
    the acoustic states are sharded before the step and before the
    restore, and the parameters returned are the whole ones."""
    from transtacos_retunegan_tpu_torch.parallel import (gather_params_tp, make_mesh,
                                                        shard_params_tp)
    mesh = make_mesh(None, k)

    def state_at(step, model):
        st = A.TrainState(step, model, A.make_optimizer(pcfg, model), current_shard())
        if k > 1:
            shard_params_tp(mesh, st.model, st.opt)
        return st

    writes = []
    save = ckpt.save_file
    ckpt.save_file = lambda path, obj: (writes.append(path), save(path, obj))
    try:
        state = state_at(7, weights.load_flax(Tacotron(pcfg), tree))
        state, _ = A.train_step(pcfg, state, _local(batch), Draws())
        ckpt.save_acoustic(run_dir, state)
        gst = V.init_gan_state(pcfg, 3, 'cpu', current_shard())
        gst.step = 5
        ckpt.save_gan(run_dir, gst, epoch=1)
    finally:
        ckpt.save_file = save
    fresh = state_at(0, weights.seeded_init(Tacotron(pcfg), 1000 + rank()))
    ckpt.restore_acoustic(run_dir, fresh)
    restored_equal = all(torch.equal(p, q) for p, q in zip(fresh.model.parameters(),
                                                           state.model.parameters()))
    moments_held = all(fresh.opt.state[p]['exp_avg'].shape == p.shape
                       for p in fresh.model.parameters())
    step = fresh.step
    fresh, _ = A.train_step(pcfg, fresh, _local(batch), Draws())
    g2 = V.init_gan_state(pcfg, 1000 + rank(), 'cpu', current_shard())
    _, epoch = ckpt.restore_gan(run_dir, g2)
    params = gather_params_tp(fresh.model)[0] if k > 1 else dict(fresh.model.named_parameters())
    return {'writes': [p.rsplit('/', 1)[-1] for p in writes], 'step': step,
            'restored_equal': restored_equal, 'moments_held': moments_held,
            'gan_step': g2.step, 'epoch': epoch, 'params': _np(params.items())}


# ---------------------------------------------------------------------------
# tensor parallelism (``tests/test_torch_port_tensor_parallel.py``): each job
# lays its group out with ``make_mesh(None, k)`` first (None, and so one
# process, outside a group)
# ---------------------------------------------------------------------------

def tp_acoustic_steps(pcfg, tree, stats, batches, step, hoisted, k, keep=None,
                      dtype=torch.float32, seeds=None):
    """Steps of the acoustic model from ``tree`` at ``step`` with the model
    axis of size ``k``, on this rank's rows of each global batch (the
    noise, dropout and teacher-forcing streams seeded with ``seeds``, else
    the prenet masks ``keep``, [S, B, width] of the global batch, else no
    draws), in ``dtype``.  After each step: the logged losses and the whole
    (gathered) gradients; at the end the summaries' gradient norms on the
    last batch, the whole parameters, the batch statistics, and the
    elements this rank holds of the parameters and of their Adam
    moments."""
    from transtacos_retunegan_tpu_torch.parallel import (gather_params_tp, gather_tp,
                                                        make_mesh, shard_params_tp,
                                                        tp_sharded)
    mesh = make_mesh(None, k)
    model = weights.load_flax(Tacotron(pcfg), tree, stats).to(dtype)
    state = A.TrainState(step, model, A.make_optimizer(pcfg, model), current_shard())
    shard_params_tp(mesh, model, state.opt)
    sharded = tp_sharded(model)
    sl = process_shard(batches[0]['text'].shape[0])
    if seeds is not None:
        draws = Draws(*[torch.Generator().manual_seed(s) for s in seeds])
    else:
        draws = Draws(prenet_keep=None if keep is None else [
            torch.from_numpy(np.ascontiguousarray(m[:, sl])).to(dtype) for m in keep])
    fn = A.train_step_hoisted if hoisted else A.train_step
    steps = []
    for b in batches:
        local = {n: v.to(dtype) if v.is_floating_point() else v for n, v in _local(b).items()}
        state, losses = fn(pcfg, state, local, draws)
        grads = gather_tp(model, {n: p.grad for n, p in model.named_parameters()})
        steps.append({'losses': {n: float(v) for n, v in losses.items()},
                      'grads': _np(grads.items())})
    norms = A.summary_stats(pcfg, state, local, draws)['grad_norms']
    params, _ = gather_params_tp(model)
    held = sum(p.numel() for p in model.parameters())
    moments = sum(v.numel() for st in state.opt.state.values()
                  for n, v in st.items() if n.startswith('exp_avg'))
    return {'steps': steps, 'params': _np(params.items()), 'buffers': _np(model.named_buffers()),
            'held': held, 'moments': moments, 'sharded': sorted(sharded),
            'grad_norms': {n: float(v) for n, v in norms.items()}}


def regroup(ports):
    """Lay the group out with the model axis, then leave it and join a new
    group at each of ``ports`` in turn, first as the other rank and then
    as this one: for each, ``current_shard()`` before any ``make_mesh``
    and the new ``make_mesh(None, n)``, checked live by a sum of the
    ranks over its model group."""
    from transtacos_retunegan_tpu_torch.parallel import make_mesh
    r, n = rank(), dist.get_world_size()
    make_mesh(None, n)
    seen = []
    for port, as_rank in zip(ports, [n - 1 - r, r]):
        dist.destroy_process_group()
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=n,
                                rank=as_rank,
                                timeout=datetime.timedelta(seconds=JOB_TIMEOUT_S / 2))
        s = current_shard()
        m = make_mesh(None, n)
        t = torch.tensor([float(rank())])
        dist.all_reduce(t, group=m.model_group)
        seen.append(((s.index, s.count, s.model_index, s.model_count),
                     (m.index, m.count, m.model_index, m.model_count), float(t)))
    return seen


def tp_step_flops(pcfg, batch, k, seed=3):
    """The FLOPs (``torch.utils.flop_counter``) of one hoisted acoustic step
    from seeded weights with the model axis of size ``k``, forward and
    backward, on this rank's rows of ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode
    from transtacos_retunegan_tpu_torch.parallel import make_mesh, shard_params_tp
    mesh = make_mesh(None, k)
    model = weights.seeded_init(Tacotron(pcfg), seed)
    state = A.TrainState(0, model, A.make_optimizer(pcfg, model), current_shard())
    shard_params_tp(mesh, model, state.opt)
    with FlopCounterMode(display=False) as fc:
        A.train_step_hoisted(pcfg, state, _local(batch), Draws())
    return fc.get_total_flops()


def tp_clip(grads, sharded_axes, k, max_norm):
    """``optim.global_norm`` and the clip on this rank's slices of
    ``grads`` (``sharded_axes``: {index: axis} of the sharded ones) with
    the model axis of size ``k``: the norm and the whole clipped
    gradients."""
    from transtacos_retunegan_tpu_torch.parallel import make_mesh
    from transtacos_retunegan_tpu_torch.train.optim import clip_by_global_norm_, global_norm
    mesh = make_mesh(None, k)
    ts, mask = [], []
    for i, g in enumerate(grads):
        t = torch.from_numpy(g.copy())
        if mesh is not None and i in sharded_axes:
            n = t.shape[sharded_axes[i]] // k
            t = t.narrow(sharded_axes[i], mesh.model_index * n, n).contiguous()
        ts.append(t)
        mask.append(mesh is not None and i in sharded_axes)
    norm = global_norm(ts, mesh, mask)
    clip_by_global_norm_(ts, max_norm, norm)
    whole = []
    for i, t in enumerate(ts):
        if mask[i]:
            parts = [torch.empty_like(t) for _ in range(k)]
            dist.all_gather(parts, t, group=mesh.model_group)
            t = torch.cat(parts, sharded_axes[i])
        whole.append(t.numpy())
    return float(norm), whole


def tp_gan_steps(pcfg, batches, seed, k):
    """``gan_steps`` with the model axis of size ``k`` (every vocoder
    parameter replicated)."""
    from transtacos_retunegan_tpu_torch.parallel import make_mesh
    make_mesh(None, k)
    return gan_steps(pcfg, batches, seed)
