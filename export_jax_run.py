#!/usr/bin/env python3
"""Export a run of the JAX package's trainers as numpy trees: the first
half of carrying a JAX run to the PyTorch port.

    python export_jax_run.py --run_dir runs/acoustic --out_dir exported/acoustic

It runs where JAX and orbax are installed.  The second half runs on the
machine with the GPU, without JAX, and writes a run dir of the port that
its trainers resume and its server serves:

    python -m transtacos_retunegan_tpu_torch.tools.import_jax_run \\
        --in_dir exported/acoustic --out_dir runs/acoustic_port

The newest checkpoint of the run dir is read with the JAX package's own
``train.checkpoint.scan_checkpoint`` / ``restore_tree_np``.  Every tree is
written as an ``.npz`` file keyed by ``/``-joined flax paths (the port's
``weights.save_npz`` layout), the run's ``config.json`` is copied, and
``meta.json`` holds the counters:

* an acoustic run (``ckpt_<step>``): ``params.npz``, ``batch_stats.npz``
  (the 'cb' encoder's batch statistics, when there are any), Adam's
  moments ``adam_mu.npz`` / ``adam_nu.npz``; ``meta.json`` has ``step``,
  ``adam_count`` (``scale_by_adam``'s) and ``lr_count`` (the Noam
  schedule's, ``scale_by_learning_rate``'s) of the optax chain
  clip -> Adam -> Noam rate (``train/acoustic_step.py::make_optimizer``);
* a vocoder run (``g_<step>`` and ``do_<step>``): ``generator.npz``,
  ``discriminators.npz`` (top-level ``msd``/``mpd``/``mtd``), each AdamW's
  moments ``{gen,disc}_adam_{mu,nu}.npz``; ``meta.json`` has ``step``,
  ``epoch`` and each optimizer's ``*_adam_count`` and ``*_lr_count``
  (``train/vocoder_step.py::make_optimizers``: the optional clip, then
  ``adamw`` on a schedule that counts updates; the discriminators take
  ``d_train_times`` updates per step).  A run with a ``g_`` and no ``do_``
  exports the generator alone (enough to serve).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from typing import Any, Dict, List, Tuple

import numpy as np

from transtacos_retunegan_tpu.train import checkpoint as ckpt


def save_npz(path: str, tree: Dict[str, Any]) -> None:
    """A nested dict of arrays as ``.npz`` with ``/``-joined keys."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat['/'.join(prefix + (k,))] = np.asarray(v)
    walk(tree, ())
    np.savez(path, **flat)


def optax_counts(opt_state) -> Tuple[Dict[str, Any], int]:
    """(Adam's state {'count', 'mu', 'nu'}, the learning-rate schedule's
    count) of an optax chain as ``restore_tree_np`` gives it back: nested
    lists with ``None`` for the stateless links (the clip, the weight
    decay)."""
    adam: List[Dict[str, Any]] = []
    sched: List[int] = []

    def walk(node):
        if isinstance(node, dict) and {'mu', 'nu', 'count'} <= set(node):
            adam.append(node)
        elif isinstance(node, dict) and set(node) == {'count'}:
            sched.append(int(node['count']))
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
    walk(opt_state)
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(f'expected one Adam state and one schedule count in the '
                         f'optimizer state, found {len(adam)} and {len(sched)}')
    return adam[0], sched[0]


def export_acoustic(path: str, out_dir: str) -> Dict[str, Any]:
    tree = ckpt.restore_tree_np(path)
    adam, lr_count = optax_counts(tree['opt_state'])
    save_npz(os.path.join(out_dir, 'params.npz'), tree['params'])
    stats = (tree.get('extra_vars') or {}).get('batch_stats')
    if stats:
        save_npz(os.path.join(out_dir, 'batch_stats.npz'), stats)
    save_npz(os.path.join(out_dir, 'adam_mu.npz'), adam['mu'])
    save_npz(os.path.join(out_dir, 'adam_nu.npz'), adam['nu'])
    return {'kind': 'acoustic', 'step': int(tree['step']),
            'adam_count': int(adam['count']), 'lr_count': lr_count}


def export_vocoder(g_path: str, do_path, out_dir: str) -> Dict[str, Any]:
    save_npz(os.path.join(out_dir, 'generator.npz'),
             ckpt.restore_tree_np(g_path)['generator'])
    if do_path is None:
        step = int(re.search(r'(\d+)$', g_path).group(1))
        return {'kind': 'vocoder', 'step': step}
    do = ckpt.restore_tree_np(do_path)
    save_npz(os.path.join(out_dir, 'discriminators.npz'), do['disc_params'])
    meta = {'kind': 'vocoder', 'step': int(do['step']), 'epoch': int(do['epoch'])}
    for who in ('gen', 'disc'):
        adam, lr_count = optax_counts(do[f'{who}_opt'])
        save_npz(os.path.join(out_dir, f'{who}_adam_mu.npz'), adam['mu'])
        save_npz(os.path.join(out_dir, f'{who}_adam_nu.npz'), adam['nu'])
        meta.update({f'{who}_adam_count': int(adam['count']), f'{who}_lr_count': lr_count})
    return meta


def export_run(run_dir: str, out_dir: str) -> Dict[str, Any]:
    """Write the newest checkpoint of the JAX run ``run_dir`` into
    ``out_dir``; returns the ``meta.json`` written."""
    acoustic = ckpt.scan_checkpoint(run_dir, 'ckpt_')
    g_path = ckpt.scan_checkpoint(run_dir, 'g_')
    if (acoustic is None) == (g_path is None):
        raise SystemExit(f'{run_dir} holds ' + ('both ckpt_ and g_ checkpoints'
                                                 if acoustic else 'no checkpoint'))
    os.makedirs(out_dir, exist_ok=True)
    if acoustic is not None:
        meta = export_acoustic(acoustic, out_dir)
    else:
        meta = export_vocoder(g_path, ckpt.scan_checkpoint(run_dir, 'do_'), out_dir)
    meta['source'] = os.path.abspath(acoustic or g_path)
    shutil.copyfile(os.path.join(run_dir, 'config.json'), os.path.join(out_dir, 'config.json'))
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=1)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--run_dir', required=True, help='a JAX acoustic or vocoder run dir')
    p.add_argument('--out_dir', required=True)
    args = p.parse_args(argv)
    print(json.dumps(export_run(args.run_dir, args.out_dir)))


if __name__ == '__main__':
    main()
