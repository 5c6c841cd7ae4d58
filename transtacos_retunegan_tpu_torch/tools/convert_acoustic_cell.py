"""Convert a stock-layout acoustic run to the fused (``fast_cell``) layout,
ported from ``transtacos_retunegan_tpu/tools/convert_acoustic_cell.py``.

``models/decoder_fast.py`` trains and serves the decoder with fused
parameter blocks (the GRU gate matrices concatenated, the location conv
and dense folded, one frame|stop head): the same function in fewer
kernels per step.  This converts the newest ``ckpt_`` of a stock run into
a ``fast_cell`` run directory:

* parameters: ``fuse_cell_params`` (exact);
* Adam's moments (``exp_avg``/``exp_avg_sq``) take the same mapping where
  it is a re-arrangement of elements (the GRU blocks, the head: Adam is
  element-wise, so they stay exact) and are zeroed for the folded location
  block (the fold is a contraction; its moments cannot be derived), as in
  the JAX package;
* the run's ``config.json`` is written with ``fast_cell: true``, so that
  a resume, an eval or the server builds the fast model.

The reverse is not provided: the fold removes parameters.  Serving needs
no conversion (``ops.fused_decoder.fold_params`` takes both layouts).

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.convert_acoustic_cell \\
      --run_dir <stock acoustic run> --out_dir <new fast run>
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List

import torch

from ..config import Config
from ..models.acoustic import Tacotron
from ..models.decoder_fast import fuse_cell_params
from ..train import checkpoint as ckpt

CELL = 'decoder_cell.'
FOLDED = ('lsa.loc_conv.weight', 'lsa.loc_conv.bias')


def fast_config(cfg: Config) -> Config:
    return dataclasses.replace(cfg, acoustic=dataclasses.replace(cfg.acoustic,
                                                                 fast_cell=True))


def _param_names(cfg: Config) -> List[str]:
    with torch.device('meta'):
        return [n for n, _ in Tacotron(cfg).named_parameters()]


def _fuse(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A model-level dict with a stock cell -> the same with the fast cell."""
    cell = {k[len(CELL):]: v for k, v in named.items() if k.startswith(CELL)}
    out = {k: v for k, v in named.items() if not k.startswith(CELL)}
    out.update({CELL + k: v for k, v in fuse_cell_params(cell).items()})
    return out


def convert_checkpoint(ck: dict, cfg: Config) -> dict:
    """One stock ``ckpt_`` (``train/checkpoint.py::save_acoustic``) of a run
    with config ``cfg`` -> the fast-cell checkpoint."""
    stock_names, fast_names = _param_names(cfg), _param_names(fast_config(cfg))
    state = {stock_names[int(i)]: s for i, s in ck['opt_state']['state'].items()}
    new_state = {}
    if state:
        moments = {m: _fuse({n: s[m] for n, s in state.items()})
                   for m in ('exp_avg', 'exp_avg_sq')}
        step = next(iter(state.values()))['step']
        for m in moments.values():
            for k in FOLDED:
                m[CELL + k] = torch.zeros_like(m[CELL + k])
        new_state = {j: {'step': step.clone(), **{m: moments[m][n] for m in moments}}
                     for j, n in enumerate(fast_names)}
    groups = [dict(g, params=list(range(len(fast_names))))
              for g in ck['opt_state']['param_groups']]
    return {'step': ck['step'], 'params': _fuse(ck['params']),
            'extra_vars': ck['extra_vars'],
            'opt_state': {'state': new_state, 'param_groups': groups}}


def convert_run(run_dir: str, out_dir: str) -> str:
    """Write the fast-cell conversion of ``run_dir``'s newest ``ckpt_`` and
    its config into ``out_dir``; returns the checkpoint written."""
    path = ckpt.scan_checkpoint(run_dir, 'ckpt_')
    if path is None:
        raise SystemExit(f'no ckpt_* under {run_dir}')
    cfg = Config.load(run_dir)
    if cfg.acoustic.fast_cell:
        raise SystemExit(f'{run_dir}/config.json is already fast_cell')
    ck = torch.load(path, map_location='cpu')
    if CELL + 'out_projection.weight' in ck['params']:
        raise SystemExit(f'{path} is already in the fast_cell layout')
    new = convert_checkpoint(ck, cfg)
    os.makedirs(out_dir, exist_ok=True)
    fast_config(cfg).save(out_dir)
    out_path = os.path.join(out_dir, f'ckpt_{int(ck["step"]):08d}')
    ckpt.save_file(out_path, new)
    n_old = sum(v.numel() for v in ck['params'].values())
    n_new = sum(v.numel() for v in new['params'].values())
    print(f'# {path} (step {ck["step"]}, {n_old:,} params)')
    print(f'# -> {out_path} ({n_new:,} params, fast_cell layout)')
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--run_dir', required=True)
    p.add_argument('--out_dir', required=True)
    args = p.parse_args(argv)
    convert_run(args.run_dir, args.out_dir)


if __name__ == '__main__':
    main()
