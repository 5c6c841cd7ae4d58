"""The acoustic train step split into timed stages on the card.

Port of ``transtacos_retunegan_tpu/tools/acoustic_step_trace.py``: where
does the step's time go?  Each stage is timed on its own at bench geometry
(B16 x T400 x N32, ``acoustic_step_ab.make_batch``), after warm-up calls,
as the fastest of ``--trials`` trials of ``--steps`` calls between CUDA
events:

  * the full scanned ``train_step``              (the baseline)
  * the hoisted ``train_step_hoisted``           (the step before the decay)
  * the teacher-forced forward with the loss     (no gradient)
  * the encoder alone (``encoder_only``)
  * the stock training decode loop, forward and forward with backward (the
    gradient of sum |frames| to the cell's parameters), on fixed random
    encoder outputs with the trained cell's weights
  * the same loop over the fast cell (``decoder_fast.fuse_cell_params``)
  * the posnet alone (``posnet_apply``)
  * the optimizer alone: the global-norm clip and Adam (``train/optim.py``,
    ``torch.optim.Adam``) on precomputed gradients

Stages overlap, so the parts need not sum to the whole; ``derived`` keeps
the JAX tool's ratios.  Float32 with TF32 off, as the trainers run.
``--device`` defaults to ``cuda`` (raises without
a card).  Writes ``--out`` (default under ``runs/torch_port/``) with the
card's name and power limit.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.acoustic_step_trace \\
      [--out runs/torch_port/acoustic_step_trace.json] [--tiny] \\
      [--warm 8] [--steps 10] [--trials 3] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import Config
from ..models import decoder as dec
from .acoustic_step_ab import (make_batch, min_of_trials, tiny, time_forward, time_step,
                               true_float32, write_json)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='runs/torch_port/acoustic_step_trace.json')
    p.add_argument('--tiny', action='store_true', default=False,
                   help='tiny dims/geometry (CPU smoke of this script)')
    p.add_argument('--warm', type=int, default=8, help='warm-up calls after the first')
    p.add_argument('--steps', type=int, default=10, help='calls per trial')
    p.add_argument('--trials', type=int, default=3, help='trials; the fastest is kept')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The stages; returns what it writes to ``--out``."""
    from ..serve.pipeline import resolve_device
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    with true_float32():
        result = stages(args, device)
    write_json(args.out, result)
    return result


def stages(args, device: torch.device) -> dict:
    """Each stage's ms (float32) and the JAX tool's ratios."""
    from ..models.acoustic import posnet_apply
    from ..models.decoder_fast import DecoderCellFast, fuse_cell_params
    from ..models.layers import Draws
    from ..train import acoustic_step as A
    from ..train.optim import clip_by_global_norm_, global_norm
    from ..train.schedules import noam_lr
    from .convergence_session import device_line

    reps = dict(n_warm=args.warm, n=args.steps, n_trial=args.trials)
    cfg = tiny(Config()) if args.tiny else Config()
    batch = make_batch(cfg, b=2, n_txt=12, t=20, device=device) if args.tiny \
        else make_batch(cfg, device=device)
    hp = cfg.acoustic
    b, t = batch['prds'].shape[0], batch['mel_targets'].shape[1]
    n_txt = batch['prds'].shape[1]

    def ms(call):
        return 1000.0 * min_of_trials(call, device, **reps)

    res = {}
    # ---- full steps + forward-only
    step_s, state = time_step(cfg, batch, device=device, **reps)
    res['full_train_step'] = step_s * 1000.0
    hoist_s, state = time_step(cfg, batch, step_fn=A.train_step_hoisted, state=state,
                               device=device, **reps)
    res['full_train_step_hoisted'] = hoist_s * 1000.0
    model = state.model
    res['forward_loss'] = 1000.0 * time_forward(cfg, batch, state, **reps)

    # ---- encoder-only (embeddings + prdsnet + SA encoder + key proj)
    @torch.no_grad()
    def enc_only():
        return model(batch['text'], batch['text_lengths'])['keys']
    res['encoder_forward'] = ms(enc_only)

    # ---- the training decode loop alone, on fixed random encoder outputs
    rng = np.random.RandomState(7)
    enc_out = torch.from_numpy(rng.randn(b, n_txt, hp.encoder_depth).astype(np.float32)
                               ).to(device)
    keys = enc_out @ torch.from_numpy(
        rng.randn(hp.encoder_depth, hp.attention_depth).astype(np.float32) * 0.05
    ).to(device)
    attn = dec.prepare_attention(enc_out, batch['text_lengths'], keys)
    cell = model.decoder_cell

    def scan(c, grad: bool):
        def run():
            frames = dec.train_decode(c, attn, batch['mel_targets'], 1.0,
                                      Draws(dropout=torch.Generator(device=device)
                                            .manual_seed(2)),
                                      hp.remat_decoder)[0]
            if grad:
                params = list(c.parameters())
                return torch.autograd.grad(frames.abs().sum(), params, allow_unused=True)
            return frames
        if grad:
            return run
        return torch.no_grad()(run)
    res['decode_scan_forward'] = ms(scan(cell, False))
    res['decode_scan_fwd_bwd'] = ms(scan(cell, True))

    fast = DecoderCellFast(cfg).to(device)
    fast.load_state_dict(fuse_cell_params(cell.state_dict()))
    res['decode_scan_fast_forward'] = ms(scan(fast, False))
    res['decode_scan_fast_fwd_bwd'] = ms(scan(fast, True))

    # ---- posnet alone
    mel = torch.from_numpy(rng.randn(b, t, cfg.audio.n_mel).astype(np.float32)).to(device)
    res['posnet_forward'] = ms(torch.no_grad()(lambda: posnet_apply(model, mel)))

    # ---- optimizer alone: the gradients set to ones once, clip, Adam
    grads = []
    for p in model.parameters():
        p.grad = torch.ones_like(p)
        grads.append(p.grad)

    def opt_only():
        clip_by_global_norm_(grads, hp.grad_clip_norm, global_norm(grads))
        for group in state.opt.param_groups:
            group['lr'] = noam_lr(state.step, hp)
        state.opt.step()
    res['optimizer_apply'] = ms(opt_only)

    return {
        'device': device_line(device),
        'geometry': f'bs{b} x T{t} x N{n_txt}'
                    + (' (tiny smoke)' if args.tiny else ' (bench geometry)'),
        'note': 'standalone stages; their boundaries differ from the full step, so '
                'parts need not sum to the whole',
        'stages_ms': {k: round(v, 2) for k, v in res.items()},
        'derived': {
            'backward_minus_forward_ms': round(
                res['full_train_step'] - res['forward_loss'], 2),
            'decode_scan_share_of_step': round(
                res['decode_scan_fwd_bwd'] / res['full_train_step'], 3),
            'fast_cell_scan_speedup': round(
                res['decode_scan_fwd_bwd'] / res['decode_scan_fast_fwd_bwd'], 3),
            'hoisted_step_speedup': round(
                res['full_train_step'] / res['full_train_step_hoisted'], 3),
        },
    }


if __name__ == '__main__':
    main()
