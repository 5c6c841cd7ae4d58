"""Import a run of the JAX package's trainers into the port: the second
half of the conversion, with no JAX.

The first half, ``export_jax_run.py`` at the repo root, runs where JAX and
orbax are installed and writes the newest checkpoint of a JAX run dir as
``.npz`` flax trees with a ``meta.json`` of its counters (that file's
docstring lists them).  This tool maps the trees through
``weights.from_flax`` (Adam's moments too: they have the parameters'
layout, so they take the same map) and writes the port's own checkpoint
with ``train/checkpoint.py``, plus the run's ``config.json``.  The result
is a port run dir: ``train_acoustic`` / ``train_vocoder --log_path`` resume
it, and ``serve.app --acoustic_dir`` / ``--vocoder_dir`` serve it.

    python -m transtacos_retunegan_tpu_torch.tools.import_jax_run \\
        --in_dir exported/acoustic --out_dir runs/acoustic_port

* acoustic: ``ckpt_<step>`` with the parameters, the batch statistics and
  ``torch.optim.Adam``'s state, whose per-parameter ``step`` is optax's
  ``scale_by_adam`` count (the bias corrections).  optax applies the Noam
  rate at its schedule's own count; the port applies it at the train
  state's ``step``, so the two must be equal (they are in a JAX run, which
  advances both once per step) and the import refuses a run where they
  are not.  A ``fast_cell`` run converts as it is (its config says so).
* vocoder: ``g_<step>`` and, when the export has the discriminators,
  ``do_<step>`` with both ``torch.optim.AdamW`` states and the epoch.
  optax's schedules count updates and decay once per epoch of them; the
  port's rate is ``base * lr_decay ** (k // epoch_updates)`` with
  ``k = step`` for the generator and ``step * d_train_times + i`` for the
  discriminators, so the counts must be ``step`` and ``step *
  d_train_times``, which the import checks.  An export of the generator
  alone gives ``g_`` alone (enough to serve).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..models.acoustic import Tacotron
from ..models.discriminators import Discriminators
from ..models.generators import make_generator
from ..train import checkpoint as ckpt
from ..train.acoustic_step import TrainState, make_optimizer
from ..train.vocoder_step import GANState, make_optimizers
from ..weights import from_flax, load_flax, load_npz


def _tree(in_dir: str, name: str) -> Optional[dict]:
    path = os.path.join(in_dir, f'{name}.npz')
    return load_npz(path) if os.path.exists(path) else None


def _check_count(what: str, count: int, want: int) -> None:
    if count != want:
        raise SystemExit(f'{what}: the schedule count is {count} but the port would apply the '
                         f'rate of {want}; this run cannot resume with the same rate')


def set_moments(opt: torch.optim.Optimizer, module: nn.Module, in_dir: str, prefix: str,
                count: int, batch_stats: Optional[dict] = None) -> None:
    """Adam's state of every parameter of ``module`` from the exported
    ``<prefix>_mu``/``<prefix>_nu`` trees, at optax's ``count``."""
    names = dict(module.named_parameters())
    mu, nu = ({k: v for k, v in from_flax(module, _tree(in_dir, f'{prefix}_{m}'),
                                          batch_stats).items() if k in names}
              for m in ('mu', 'nu'))
    for name, p in names.items():
        opt.state[p] = {'step': torch.tensor(float(count)),
                        'exp_avg': mu[name].to(p.device), 'exp_avg_sq': nu[name].to(p.device)}


def import_acoustic(in_dir: str, out_dir: str, cfg: Config, meta: Dict) -> str:
    stats = _tree(in_dir, 'batch_stats')
    model = load_flax(Tacotron(cfg), _tree(in_dir, 'params'), stats)
    _check_count('the Noam rate', meta['lr_count'], meta['step'])
    opt = make_optimizer(cfg, model)
    set_moments(opt, model, in_dir, 'adam', meta['adam_count'], stats)
    return ckpt.save_acoustic(out_dir, TrainState(meta['step'], model, opt))


def import_vocoder(in_dir: str, out_dir: str, cfg: Config, meta: Dict) -> str:
    gen = load_flax(make_generator(cfg), _tree(in_dir, 'generator'))
    step = meta['step']
    discs = _tree(in_dir, 'discriminators')
    if discs is None:
        path = os.path.join(out_dir, f'g_{step:08d}')
        ckpt.save_file(path, {'generator': gen.state_dict()})
        return path
    disc = load_flax(Discriminators(cfg), discs)
    _check_count('the generator rate', meta['gen_lr_count'], step)
    _check_count('the discriminator rate', meta['disc_lr_count'],
                 step * cfg.vocoder.d_train_times)
    gen_opt, disc_opt = make_optimizers(cfg, gen, disc)
    set_moments(gen_opt, gen, in_dir, 'gen_adam', meta['gen_adam_count'])
    set_moments(disc_opt, disc, in_dir, 'disc_adam', meta['disc_adam_count'])
    g_path, _ = ckpt.save_gan(out_dir, GANState(step, gen, gen_opt, disc, disc_opt),
                              meta['epoch'])
    return g_path


def import_run(in_dir: str, out_dir: str) -> str:
    """Write the port's run dir ``out_dir`` from the export ``in_dir``;
    returns the checkpoint written (``ckpt_`` or ``g_``)."""
    with open(os.path.join(in_dir, 'meta.json')) as f:
        meta = json.load(f)
    cfg = Config.load(in_dir)
    os.makedirs(out_dir, exist_ok=True)
    fn = {'acoustic': import_acoustic, 'vocoder': import_vocoder}[meta['kind']]
    path = fn(in_dir, out_dir, cfg, meta)
    cfg.save(out_dir)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--in_dir', required=True, help='the output of export_jax_run.py')
    p.add_argument('--out_dir', required=True, help='the port run dir to write')
    args = p.parse_args(argv)
    print(f'wrote {import_run(args.in_dir, args.out_dir)}')


if __name__ == '__main__':
    main()
