"""Import a trained reference RetuneGAN checkpoint into the port, ported
from ``transtacos_retunegan_tpu/tools/import_reference_ckpt.py``.

The reference saves torch checkpoints as ``g_<step:08d>`` (the generator,
``{'generator': state_dict}``) and ``do_<step:08d>`` (msd/mpd/mtd and the
optimizers' states), written at ``retunegan/train.py:214-224``.  This tool
maps them through ``interop`` onto the port's modules (``weights.from_flax``)
and writes the port's own ``g_``/``do_`` files
(``train/checkpoint.py::save_gan``) and the run's ``config.json``, so
that ``Synthesizer``, ``serve.infer_vocoder`` and ``train_vocoder``'s
resume load the run as it is:

    python -m transtacos_retunegan_tpu_torch.tools.import_reference_ckpt \\
        --g /path/to/g_00400000 [--do /path/to/do_00400000] \\
        --out runs/imported [--ver RefineGAN_small]

* ``--g`` alone is enough for serving.
* ``--do`` also converts the three discriminators, so that fine-tuning can
  resume.  The optimizers' moments are not carried over (as in the JAX
  package): the ``do_`` file holds fresh AdamW states, so the first steps
  after the import behave like an optimizer restart at the checkpoint's
  step.

The run's config is ``Config()`` with ``generator_ver`` set to ``--ver``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import torch

from .. import interop
from ..config import Config
from ..models.discriminators import Discriminators
from ..models.generators import make_generator
from ..train import checkpoint as ckpt
from ..train.vocoder_step import make_optimizers
from ..weights import load_flax


def import_run(g_path: str, out_dir: str, ver: str = 'RefineGAN_small',
               do_path: Optional[str] = None, cfg: Optional[Config] = None) -> str:
    """Convert ``g_path`` (and optionally ``do_path``) into ``out_dir``;
    returns the ``g_`` path written.  The step is taken from the source's
    file name (``g_<step>``) when it parses, else from the ``do_``
    checkpoint's recorded step, else 0."""
    cfg = cfg or Config()
    cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder,
                                                               generator_ver=ver))
    os.makedirs(out_dir, exist_ok=True)
    g_sd = torch.load(g_path, map_location='cpu', weights_only=True)['generator']
    generator = load_flax(make_generator(cfg), interop.import_generator_state_dict(g_sd, ver))

    try:
        step = int(os.path.basename(g_path).split('_')[-1])
    except ValueError:
        step = 0

    do_state = None
    if do_path is not None:
        do = interop.import_do_checkpoint(do_path, cfg)
        step = step or do['steps']
        discs = load_flax(Discriminators(cfg), {k: do[k] for k in ('msd', 'mpd', 'mtd')})
        gen_opt, disc_opt = make_optimizers(cfg, generator, discs)
        do_state = {'discriminators': discs.state_dict(),
                    'gen_opt': gen_opt.state_dict(), 'disc_opt': disc_opt.state_dict(),
                    'step': step, 'epoch': do['epoch']}

    g_out = os.path.join(out_dir, f'g_{step:08d}')
    ckpt.save_file(g_out, {'generator': generator.state_dict()})
    if do_state is not None:
        ckpt.save_file(os.path.join(out_dir, f'do_{step:08d}'), do_state)
    if not os.path.exists(os.path.join(out_dir, 'config.json')):
        cfg.save(out_dir)
    return g_out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--g', required=True, help='reference g_<step> torch file')
    ap.add_argument('--do', dest='do_path', default=None,
                    help='reference do_<step> torch file (optional)')
    ap.add_argument('--out', required=True, help='output run dir')
    ap.add_argument('--ver', default='RefineGAN_small',
                    help=f'generator version; mapped: {sorted(interop.GENERATOR_MAPS)}')
    args = ap.parse_args(argv)
    print(f'wrote {import_run(args.g, args.out, args.ver, args.do_path)}')


if __name__ == '__main__':
    main()
