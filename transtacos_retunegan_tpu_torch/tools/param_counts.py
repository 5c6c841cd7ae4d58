"""Parameter counts of every generator variant and the acoustic model,
ported from ``transtacos_retunegan_tpu/tools/param_counts.py``.

Parity evidence against the reference's measured table
(``retunegan/hparam.py:45-56``): MelGAN 4,524,290 / MelGANRetune 1,409,427 /
HiFiGAN 1,421,314 / HiFiGANRetune 1,716,627 / HiFiGANSplit 2,849,890 /
RefineGAN_small 2,748,371.  The modules are built on the ``meta`` device,
so no weights are materialized.

Usage: python -m transtacos_retunegan_tpu_torch.tools.param_counts
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..config import Config
from ..models.acoustic import Tacotron
from ..models.generators import GENERATORS, make_generator


def count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def generator_counts(cfg: Config) -> dict:
    out = {}
    for name in sorted(GENERATORS):
        c = dataclasses.replace(cfg, vocoder=dataclasses.replace(
            cfg.vocoder, generator_ver=name))
        with torch.device('meta'):
            out[name] = count(make_generator(c))
    return out


def acoustic_count(cfg: Config) -> int:
    with torch.device('meta'):
        return count(Tacotron(cfg))


REFERENCE = {
    'MelGAN': 4_524_290, 'MelGANRetune': 1_409_427, 'HiFiGAN': 1_421_314,
    'HiFiGANRetune': 1_716_627, 'HiFiGANSplit': 2_849_890,
    'RefineGAN_small': 2_748_371,
}


def main():
    cfg = Config()
    print(f'acoustic (TransTacoS): {acoustic_count(cfg):,}')
    for name, n in generator_counts(cfg).items():
        ref = REFERENCE.get(name)
        extra = f'  (reference: {ref:,}, {100 * n / ref - 100:+.2f}%)' if ref else ''
        print(f'{name:18s}: {n:,}{extra}')


if __name__ == '__main__':
    main()
