"""The plain float32 reference of the vocoder's GAN step.

It follows ``transtacos_retunegan_tpu_torch/train/vocoder_step.py``'s
``gan_train_step`` for one process (no data-parallel shard): one generator
forward with the training noise drawn from a ``torch.Generator`` in call
order; ``d_train_times`` AdamW updates of MSD + MPD + MTD on the detached
fake (the R1 term when ``r1_gamma`` > 0); one generator update through the
mstft / env / dyn / sm, feature-matching and LSGAN losses against the
updated discriminators; the NaN guard and the optional global-norm clip
before each update; the per-epoch decayed rates.  AdamW is PyTorch's
single-tensor loop (``foreach=False``).  The caller sets the precision:
float32 with TF32 off for the reference, TF32 on for its control.
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import Config
from .models import vocoder_losses as L
from .models.discriminators import Discriminators
from .models.generators import make_generator
from .optim import clip_by_global_norm_, global_norm, zero_grad_


class State:
    """The generator, the discriminators, their AdamW and the step count."""

    def __init__(self, cfg: Config, generator: Dict[str, torch.Tensor],
                 discriminators: Dict[str, torch.Tensor], device):
        hv = cfg.vocoder
        self.cfg, self.step = cfg, 0
        self.generator = make_generator(cfg)
        self.generator.load_state_dict({k: v.float() for k, v in generator.items()})
        self.discriminators = Discriminators(cfg)
        self.discriminators.load_state_dict({k: v.float()
                                             for k, v in discriminators.items()})
        self.generator.to(device).train()
        self.discriminators.to(device).train()
        kw = dict(betas=(hv.adam_b1, hv.adam_b2), eps=1e-8, weight_decay=0.01,
                  foreach=False)
        self.gen_opt = torch.optim.AdamW(self.generator.parameters(),
                                         lr=hv.learning_rate_g, **kw)
        self.disc_opt = torch.optim.AdamW(self.discriminators.parameters(),
                                          lr=hv.learning_rate_d, **kw)


def learning_rate(base: float, decay: float, update: int, epoch_updates: int) -> float:
    return base * decay ** (update // epoch_updates)


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor, lr: float,
            clip_norm: float) -> None:
    grads = [p.grad for g in opt.param_groups for p in g['params']]
    ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads))
    for g in grads:
        g.masked_fill_(~ok, 0.0)
    if clip_norm > 0:
        clip_by_global_norm_(grads, clip_norm)
    for group in opt.param_groups:
        group['lr'] = lr
    opt.step()


def _disc(disc: Discriminators, y, y_hat, specs_r, specs_g):
    yh = None if y_hat is None else y_hat[:, None]
    return disc.msd(y[:, None], yh), disc.mpd(y[:, None], yh), disc.mtd(specs_r, specs_g)


def train_step(state: State, batch: Dict[str, torch.Tensor], noise: torch.Generator,
               steps_per_epoch: int = 568) -> Dict[str, torch.Tensor]:
    """One GAN step in place; its losses (the program's metric keys)."""
    cfg = state.cfg
    hv = cfg.vocoder
    y = batch['wav']
    gen, disc = state.generator, state.discriminators
    y_g = gen(batch['mel'], batch['tmpl'][..., None], noise=noise)[..., 0]
    y_det = y_g.detach()
    with torch.no_grad():
        _, specs_r, specs_g_det = L.multi_stft_specs_and_loss(y, y_det, cfg)
    d_params = list(disc.parameters())
    for i in range(hv.d_train_times):
        zero_grad_(d_params)
        (sr, sg, _, _), (pr, pg, _, _), (tr, tg, _, _) = _disc(disc, y, y_det, specs_r,
                                                              specs_g_det)
        ls = L.discriminator_loss(sr, sg, cfg)
        lp = L.discriminator_loss(pr, pg, cfg)
        lt = L.discriminator_loss(tr, tg, cfg)
        total = ls + lp + lt
        if hv.r1_gamma > 0.0:
            yy = y.detach().requires_grad_(True)
            (rs, _, _, _), (rp, _, _, _), (rt, _, _, _) = _disc(
                disc, yy, None, L.multi_stft_specs(yy, cfg), None)
            score = sum(torch.sum(x) for x in rs + rp + rt)
            gy, = torch.autograd.grad(score, yy, create_graph=True)
            total = total + 0.5 * hv.r1_gamma * torch.sum(gy * gy) / y.shape[0]
        total.backward()
        _update(state.disc_opt, total.detach(), learning_rate(
            hv.learning_rate_d, hv.lr_decay, state.step * hv.d_train_times + i,
            steps_per_epoch * hv.d_train_times), hv.grad_clip_norm)
    g_params = list(gen.parameters())
    zero_grad_(g_params)
    disc.requires_grad_(False)
    try:
        loss_mstft, sp_r, sp_g = L.multi_stft_specs_and_loss(y, y_g, cfg)
        zero = torch.zeros((), device=y.device)
        loss_env = L.envelope_loss(y, y_g, cfg) if hv.envelope_loss else zero
        loss_dyn = L.dynamic_loss(y, y_g, cfg) if hv.dynamic_loss else zero
        loss_sm = L.strip_mirror_loss(y_g) if hv.strip_mirror_loss else zero
        (sr, sg, fsr, fsg), (pr, pg, fpr, fpg), (tr, tg, ftr, ftg) = _disc(
            disc, y, y_g, sp_r, sp_g)
        g_total = (L.generator_loss(sg, sr, cfg) + L.generator_loss(pg, pr, cfg)
                   + L.generator_loss(tg, tr, cfg)
                   + (L.feature_loss(fsr, fsg) + L.feature_loss(fpr, fpg)
                      + L.feature_loss(ftr, ftg)) * hv.w_loss_fm
                   + loss_mstft * hv.w_loss_mstft + loss_env * hv.w_loss_env
                   + loss_dyn * hv.w_loss_dyn + loss_sm * hv.w_loss_sm)
        g_total.backward()
    finally:
        disc.requires_grad_(True)
    _update(state.gen_opt, g_total.detach(), learning_rate(
        hv.learning_rate_g, hv.lr_decay, state.step, steps_per_epoch), hv.grad_clip_norm)
    state.step += 1
    return {'loss_gen_all': g_total.detach(), 'loss_disc_all': (ls + lp + lt).detach()}
