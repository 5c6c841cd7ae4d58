"""Embedding cosine-similarity heatmaps from an acoustic checkpoint.

Port of ``transtacos_retunegan_tpu/tools/draw_embd_sim.py``: reads the
phone/tone/prosody embedding tables of the newest ``ckpt_`` in
``--run_dir`` (``train.checkpoint.restore_acoustic_params``), computes
their pairwise cosine similarity on ``--device`` (default ``cuda``; raises
without a card) and writes each matrix as ``.npy`` and, where matplotlib is
installed, as a labeled heatmap PNG, to ``--out_dir`` (default under
``runs/torch_port/``).

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.draw_embd_sim \
      --run_dir runs/acoustic [--out_dir runs/torch_port/embd_sim] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..text.symbols import get_table
from ..train import checkpoint as ckpt

TABLES = (('E_text', 'phone'), ('E_tone', 'tone'), ('E_prds', 'prosody'))


def cosine_sim(e: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(e, dim=-1, keepdim=True)
    return (e @ e.T) / (n @ n.T + 1e-8)


def draw(sim: np.ndarray, labels, path: str, title: str):
    from ..utils.plotting import _pyplot
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 9))
    im = ax.imshow(sim, cmap='coolwarm', vmin=-1, vmax=1)
    fig.colorbar(im, ax=ax)
    if labels is not None and len(labels) <= 64:
        ax.set_xticks(range(len(labels)))
        ax.set_yticks(range(len(labels)))
        ax.set_xticklabels(labels, rotation=90, fontsize=6)
        ax.set_yticklabels(labels, fontsize=6)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--run_dir', required=True)
    p.add_argument('--out_dir', default='runs/torch_port/embd_sim')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> Dict[str, np.ndarray]:
    """The similarity matrices by table name (``E_tone`` and ``E_prds``
    only where the model has them)."""
    from ..serve.pipeline import resolve_device
    from ..utils.plotting import save_figure
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg_path = os.path.join(args.run_dir, 'config.json')
    cfg = Config.load(cfg_path) if os.path.exists(cfg_path) else Config()
    params = ckpt.restore_acoustic_params(args.run_dir)
    if params is None:
        raise SystemExit(f'no acoustic checkpoint under {args.run_dir}')
    os.makedirs(args.out_dir, exist_ok=True)

    labels = {'E_text': get_table(cfg.acoustic.g2p).symbols,
              'E_tone': list('012345'), 'E_prds': list('012345')}
    sims = {}
    for key, what in TABLES:
        if key not in params:
            continue
        sim = cosine_sim(params[key].to(device)).cpu().numpy()
        sims[key] = sim
        np.save(os.path.join(args.out_dir, f'{key}_sim.npy'), sim)
        save_figure(draw, sim, labels[key], os.path.join(args.out_dir, f'{key}_sim.png'),
                    f'{what} embedding cos-sim')
    print(f'wrote similarity matrices to {args.out_dir}')
    return sims


if __name__ == '__main__':
    main()
