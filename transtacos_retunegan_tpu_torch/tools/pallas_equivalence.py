"""The decode kernels against the stepped decoder cell on the card.

Port of ``transtacos_retunegan_tpu/tools/pallas_equivalence.py``.  All
four decode paths run on ``--device`` with shared weights at the DEFAULT
model dims, from the same numpy inputs, and the max |delta| of each output
against the reference is recorded:

  * the reference: the stepped ``models.decoder.DecoderCell``
    (``models.decoder.decode``) in float32, TF32 off for the tool's run
  * ``ops.fused_decoder.fused_decode``: one ``decode_step_kernel`` launch
    per step
  * ``ops.fused_decoder.fused_decode_full``: one ``decode_full_kernel``
    launch, early exit off
  * the same with early exit on (emissions past the all-finished step are
    zero by contract, so the comparison trims to ``out_lengths``)

The fused paths run with float32 weights, so a disagreement is the
kernels' semantics, not precision; a bf16 row is recorded for context.
Exits non-zero when a float32 delta exceeds ``--atol`` or ``out_lengths``
differ.  The weights are the JAX tool's: flax's init of the stock cell at
``PRNGKey(0)`` (``weights.flax_acoustic_init``), or the decoder cell of
the newest checkpoint of a port run dir (``--ckpt``; trained biases are
non-zero).  ``--device cpu`` runs the kernels' plain versions (the JAX
tool's ``--interpret``); ``cuda`` is the default and raises without a card.
Writes ``--out`` (default under ``runs/torch_port/``) with the card's name
and power limit.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.pallas_equivalence \\
      [--out runs/torch_port/pallas_equivalence.json] [--steps 40] [--atol 2e-4] \\
      [--batch 1] [--n_text 80] [--ckpt RUN_DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..models import decoder as dec

F32_RUNS = ('fused_per_step_f32', 'fused_full_f32', 'fused_full_early_exit_f32')
OUTPUTS = ('mel_outputs', 'stop_token_outputs', 'alignments')


def inputs(cfg: Config, b: int, n: int, device) -> dec.AttentionParams:
    """The JAX tool's seeded keys, values and mask (``RandomState(0)``;
    rows after the first end 7 positions early)."""
    r_ = np.random.RandomState(0)
    keys = r_.randn(b, n, cfg.acoustic.attention_depth).astype(np.float32) * 0.3
    values = r_.randn(b, n, cfg.acoustic.encoder_depth).astype(np.float32) * 0.3
    lens = np.full((b,), n)
    lens[1:] = n - 7
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)    # noqa: E731
    return dec.AttentionParams(t(keys), t(values * mask[..., None]), t(mask))


def cell_weights(cfg: Config, ckpt: Optional[str], device):
    """(the stock decoder cell on ``device``, where its weights came from)."""
    from .. import jax_random
    from ..weights import flax_acoustic_init
    cell = dec.DecoderCell(cfg)
    if ckpt is None:
        flax_acoustic_init(cell, jax_random.prng_key(0))
        return cell.to(device), 'random init'
    from ..train import checkpoint as ckpt_io
    path = ckpt_io.scan_checkpoint(ckpt, 'ckpt_')
    if path is None:
        raise SystemExit(f'no ckpt_* under {ckpt}')
    params = ckpt_io.load_acoustic_params(path)
    prefix = 'decoder_cell.'
    cell.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                          if k.startswith(prefix)})
    return cell.to(device), path


def to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: out[k].float().cpu().numpy() for k in (*OUTPUTS, 'out_lengths')}


def deltas(ref, out, trim_frames=None, trim_steps=None) -> dict:
    """max |delta| per output against the reference; optionally trimmed to
    the valid region (early exit zeroes everything past the all-finished
    step)."""
    d = {}
    for k in ('mel_outputs', 'stop_token_outputs'):
        a, b_ = ref[k], out[k]
        if trim_frames is not None:
            a, b_ = a[:, :trim_frames], b_[:, :trim_frames]
        d[k] = float(np.abs(a - b_).max())
    a, b_ = ref['alignments'], out['alignments']
    if trim_steps is not None:
        a, b_ = a[:, :, :trim_steps], b_[:, :, :trim_steps]
    d['alignments'] = float(np.abs(a - b_).max())
    d['out_lengths_equal'] = bool((ref['out_lengths'] == out['out_lengths']).all())
    return d


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='runs/torch_port/pallas_equivalence.json')
    p.add_argument('--steps', type=int, default=40)
    p.add_argument('--batch', type=int, default=1,
                   help='serving geometry (batch 1) by default')
    p.add_argument('--n_text', type=int, default=80)
    p.add_argument('--atol', type=float, default=2e-4)
    p.add_argument('--ckpt', default=None,
                   help="a port acoustic run dir: its newest checkpoint's TRAINED "
                        'decoder cell instead of the initial weights')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu' (the "
                        "kernels' plain versions)")
    return p


def main(argv=None) -> dict:
    """The comparison; returns what it writes to ``--out``, or exits
    non-zero (SystemExit) when a float32 path disagrees."""
    from ..ops import fused_decoder as F
    from ..serve.pipeline import resolve_device
    from .acoustic_step_ab import true_float32, write_json
    from .convergence_session import device_line
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config()                                  # DEFAULT dims
    b, n, steps = args.batch, args.n_text, args.steps
    r = cfg.acoustic.outputs_per_step
    attn = inputs(cfg, b, n, device)
    cell, params_from = cell_weights(cfg, args.ckpt, device)
    print(f'# device: {device_line(device)}', flush=True)
    runs = {}
    with true_float32():
        ref = to_numpy(dec.decode(cell, attn, steps))
        print('# stepped cell done', flush=True)
        fp32 = F.fold_params(cell, torch.float32)
        args_ = (attn.keys, attn.values, attn.mask)
        runs['fused_per_step_f32'] = deltas(ref, to_numpy(F.fused_decode(fp32, *args_, steps)))
        print('# fused_decode f32 done', flush=True)
        full = to_numpy(F.fused_decode_full(fp32, *args_, steps, early_exit=False))
        runs['fused_full_f32'] = deltas(ref, full)
        print('# fused_decode_full f32 done', flush=True)
        ee32 = to_numpy(F.fused_decode_full(fp32, *args_, steps, early_exit=True))
        t_valid = int(ee32['out_lengths'].max())
        runs['fused_full_early_exit_f32'] = deltas(ref, ee32, trim_frames=t_valid,
                                                   trim_steps=t_valid // r)
        runs['fused_full_early_exit_f32']['trimmed_to_frames'] = t_valid
        print('# fused_decode_full early_exit done', flush=True)
        fpbf = F.fold_params(cell, torch.bfloat16)
        runs['fused_full_bf16_vs_f32_scan'] = deltas(
            ref, to_numpy(F.fused_decode_full(fpbf, *args_, steps, early_exit=False)))
        print('# bf16 context row done', flush=True)

    result = {
        'device': device_line(device),
        'platform': device.type,
        'interpret': device.type != 'cuda',
        'params_from': params_from,
        'config': 'DEFAULT dims',
        'shapes': {'batch': b, 'n_text': n, 'steps': steps, 'frames': steps * r},
        'atol_f32': args.atol,
        'runs': runs,
    }
    write_json(args.out, result)
    bad = []
    for tag in F32_RUNS:
        d = runs[tag]
        bad += [f'{tag}.{k}={d[k]:g}' for k in OUTPUTS if d[k] > args.atol]
        if not d['out_lengths_equal']:
            bad.append(f'{tag}.out_lengths differ')
    if bad:
        raise SystemExit('equivalence FAILED: ' + ', '.join(bad))
    print('# all f32 paths within atol', flush=True)
    return result


if __name__ == '__main__':
    main()
