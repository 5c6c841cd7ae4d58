"""Checkpoints of both trainers, ported from
``transtacos_retunegan_tpu/train/checkpoint.py`` with torch files in place
of orbax trees, under the JAX package's names and keep counts.

* acoustic: one ``ckpt_<step:08d>`` file per save (step, parameters, the
  batch statistics as ``extra_vars``, the optimizer's state), the newest
  ``keep`` kept (the config's ``max_ckpt``).
* vocoder: two files per save, ``g_<step:08d>`` (the generator's state
  dict, what inference loads) and ``do_<step:08d>`` (the discriminators,
  both optimizers' states, step and epoch).

``scan_checkpoint`` finds the newest by sorted prefix match.  Each file is
written under a temporary name and renamed into place.  A state with a
data-parallel ``shard`` is saved by rank 0 (the ranks' states are equal)
while every rank waits for it at a barrier; every rank restores from the
same files.  A tensor-parallel acoustic state is gathered over each model
group before rank 0 writes it, so its file is a one-process run's (each
resumes the other), and restoring it keeps each rank's slices.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..parallel import barrier, gather_params_tp, slice_moments, tp_local, tp_sharded


def scan_checkpoint(dirpath: str, prefix: str) -> Optional[str]:
    """Newest checkpoint matching ``prefix<digits>`` (sorted order)."""
    if not os.path.isdir(dirpath):
        return None
    pat = re.compile(re.escape(prefix) + r'(\d+)$')
    hits = sorted(p for p in os.listdir(dirpath) if pat.match(p))
    return os.path.join(dirpath, hits[-1]) if hits else None


def prune_old(dirpath: str, prefix: str, keep: int = 1) -> None:
    pat = re.compile(re.escape(prefix) + r'(\d+)$')
    hits = sorted(p for p in os.listdir(dirpath) if pat.match(p))
    for p in hits[:-keep] if keep > 0 else hits:
        full = os.path.join(dirpath, p)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        else:
            os.remove(full)


def save_file(path: str, obj) -> None:
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _writes(state) -> bool:
    """Whether this process writes ``state``'s checkpoint: the one process,
    or rank 0 of its layout (data and model coordinate 0)."""
    return state.shard is None or (state.shard.index == 0 and state.shard.model_index == 0)


def save_acoustic(run_dir: str, state, keep: int = 1) -> str:
    """Write ``ckpt_`` of ``state`` (an ``acoustic_step.TrainState``) at its
    step; keep the newest ``keep``.  Under the state's shard rank 0 writes
    the whole parameters and moments (gathered under tensor parallelism:
    every rank calls it) and all ranks return when the file is in place."""
    path = os.path.join(run_dir, f'ckpt_{state.step:08d}')
    if tp_sharded(state.model):
        params, opt_state = gather_params_tp(state.model, state.opt)
    else:
        params = {n: p.detach() for n, p in state.model.named_parameters()}
        opt_state = state.opt.state_dict()
    if _writes(state):
        os.makedirs(run_dir, exist_ok=True)
        save_file(path, {'step': state.step, 'params': params,
                         'extra_vars': state.extra_vars, 'opt_state': opt_state})
        prune_old(run_dir, 'ckpt_', keep)
    if state.shard is not None:
        barrier()
    return path


def restore_acoustic(run_dir: str, state):
    """Load the newest ``ckpt_`` into ``state`` in place (model, batch
    statistics, optimizer, step; this rank's slices of a tensor-parallel
    model's sharded leaves and moments); None when there is none."""
    path = scan_checkpoint(run_dir, 'ckpt_')
    if path is None:
        return None
    ck = torch.load(path, map_location=_device(state.model))
    state.model.load_state_dict({**tp_local(state.model, ck['params']), **ck['extra_vars']})
    state.opt.load_state_dict(ck['opt_state'])
    slice_moments(state.model, state.opt)
    state.step = int(ck['step'])
    return state


def load_acoustic_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``Tacotron`` state dict (parameters and batch statistics) of an
    acoustic checkpoint: a ``ckpt_`` file, or the newest in a run dir."""
    if os.path.isdir(path):
        found = scan_checkpoint(path, 'ckpt_')
        if found is None:
            raise FileNotFoundError(f'no ckpt_ checkpoint in {path}')
        path = found
    ck = torch.load(path, map_location='cpu')
    return {**ck['params'], **ck['extra_vars']}


def restore_acoustic_params(run_dir: str) -> Optional[Dict[str, torch.Tensor]]:
    """Inference: the state dict of the newest ``ckpt_`` in ``run_dir``,
    None for an empty or missing dir (the server keeps its initial weights)."""
    path = scan_checkpoint(run_dir, 'ckpt_')
    return None if path is None else load_acoustic_params(path)


def save_gan(run_dir: str, state, epoch: int, keep: int = 2) -> Tuple[str, str]:
    """Write ``g_``/``do_`` of ``state`` (a ``vocoder_step.GANState``) at
    its step; keep the newest ``keep`` of each.  Under the state's shard
    rank 0 writes and all ranks return when the files are in place."""
    g_path = os.path.join(run_dir, f'g_{state.step:08d}')
    do_path = os.path.join(run_dir, f'do_{state.step:08d}')
    if _writes(state):
        os.makedirs(run_dir, exist_ok=True)
        save_file(g_path, {'generator': state.generator.state_dict()})
        save_file(do_path, {'discriminators': state.discriminators.state_dict(),
                            'gen_opt': state.gen_opt.state_dict(),
                            'disc_opt': state.disc_opt.state_dict(),
                            'step': state.step, 'epoch': epoch})
        prune_old(run_dir, 'g_', keep)
        prune_old(run_dir, 'do_', keep)
    if state.shard is not None:
        barrier()
    return g_path, do_path


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def restore_gan(run_dir: str, state) -> Tuple[Optional[object], int]:
    """Load the newest ``g_``/``do_`` into ``state`` in place; returns
    ``(state, epoch)``, or ``(None, -1)`` when there is no checkpoint."""
    g_path = scan_checkpoint(run_dir, 'g_')
    do_path = scan_checkpoint(run_dir, 'do_')
    if g_path is None or do_path is None:
        return None, -1
    dev = _device(state.generator)
    g = torch.load(g_path, map_location=dev)
    do = torch.load(do_path, map_location=dev)
    state.generator.load_state_dict(g['generator'])
    state.discriminators.load_state_dict(do['discriminators'])
    state.gen_opt.load_state_dict(do['gen_opt'])
    state.disc_opt.load_state_dict(do['disc_opt'])
    state.step = int(do['step'])
    return state, int(do['epoch'])


def load_generator_params(path: str) -> Dict[str, torch.Tensor]:
    """The generator's state dict of a vocoder checkpoint: a ``g_`` file,
    or the newest in a run dir (``Synthesizer(gen_params=...)`` takes it)."""
    if os.path.isdir(path):
        found = scan_checkpoint(path, 'g_')
        if found is None:
            raise FileNotFoundError(f'no g_ checkpoint in {path}')
        path = found
    return torch.load(path, map_location='cpu')['generator']


def restore_generator_params(run_dir: str, generator: Optional[nn.Module] = None):
    """Inference: the generator's state dict of the newest ``g_`` in
    ``run_dir``, or ``generator`` with those weights loaded when one is
    given; None for an empty or missing dir."""
    g_path = scan_checkpoint(run_dir, 'g_')
    if g_path is None:
        return None
    sd = load_generator_params(g_path)
    if generator is None:
        return sd
    generator.load_state_dict(sd)
    return generator
