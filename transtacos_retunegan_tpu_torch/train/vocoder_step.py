"""GAN train and eval steps of the vocoder, ported from
``transtacos_retunegan_tpu/train/vocoder_step.py``.

One generator forward; the discriminators (MSD + MPD + MTD) take
``d_train_times`` AdamW updates on the detached fake; then one generator
update against the updated discriminators with the mstft / env / dyn / sm,
feature-matching and LSGAN losses.  The JAX step runs the generator twice
with the same parameters and noise (once for D, once inside G's loss); here
it runs once and D gets ``detach()`` of that output.

Optimizer: ``torch.optim.AdamW(betas=(adam_b1, adam_b2), eps=1e-8,
weight_decay=0.01)`` on every parameter (``g``, ``b``, ``noise/w`` and
``alpha`` included), as ``optax.adamw``.  Update k (counted from 0) uses
``base * lr_decay ** (k // epoch_updates)``, where an epoch is
``steps_per_epoch`` generator updates and ``steps_per_epoch *
d_train_times`` discriminator updates.  The optional global-norm clip is
optax's ``clip_by_global_norm`` (no epsilon on the norm, unlike
``clip_grad_norm_``), applied before AdamW.  The NaN guard zeroes the
gradients of an update whose loss or gradient norm is not finite and still
steps the optimizer (the moments decay, weight decay applies, the count
advances), as the JAX step does.

A state with a data-parallel ``shard`` (``parallel.current_shard()``, set
by the trainer) computes the step on its share of the global batch: the
noise is drawn at the global batch's shape (this rank keeps its rows), the
strip-mirror loss takes the global means, each update averages its
gradients (and the loss its guard reads) over the ranks, and the metrics
are averaged after the step.  The explicit all-reduce also covers the R1
penalty's ``torch.autograd.grad(..., create_graph=True)``.  The eval step
takes no shard: it is local to the rank that runs it.

Nothing here waits for the card: metrics are 0-dim device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ..config import Config
from ..models import vocoder_losses as L
from ..models.discriminators import Discriminators
from ..models.generators import make_generator
from ..models.precision import compute_dtype, float32
from ..parallel import Shard, all_reduce_grads, mean_over_ranks, shard_draw
from ..serve.pipeline import resolve_device
from .. import jax_random
from ..weights import flax_vocoder_init
from .optim import clip_by_global_norm_, global_norm, zero_grad_

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GANState:
    """The generator, the discriminators and their optimizers (the modules
    hold the parameters; ``step`` counts train steps on the host), and the
    data-parallel shard the steps run under (None: one process)."""
    step: int
    generator: nn.Module
    gen_opt: torch.optim.Optimizer
    discriminators: Discriminators
    disc_opt: torch.optim.Optimizer
    shard: Optional[Shard] = None


def learning_rate(base: float, decay: float, update: int, epoch_updates: int) -> float:
    """The rate of update ``update`` (from 0): one decay per epoch."""
    return base * decay ** (update // epoch_updates)


def make_optimizers(cfg: Config, generator: nn.Module, discriminators: nn.Module
                    ) -> Tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
    hv = cfg.vocoder
    kw = dict(betas=(hv.adam_b1, hv.adam_b2), eps=1e-8, weight_decay=0.01)
    return (torch.optim.AdamW(generator.parameters(), lr=hv.learning_rate_g, **kw),
            torch.optim.AdamW(discriminators.parameters(), lr=hv.learning_rate_d, **kw))


def init_gan_state(cfg: Config, seed: int = 114514, device='cuda',
                   shard: Optional[Shard] = None) -> GANState:
    """The JAX package's initial weights for ``seed`` and fresh optimizers
    on ``device``, stepping under ``shard``: the generator from
    ``PRNGKey(seed)``, the discriminators from ``split(fold_in(PRNGKey(seed),
    11), 3)`` in the order MSD, MPD, MTD, as its ``init_gan_state`` draws
    them (``weights.flax_vocoder_init``, drawn on ``device``).  Load other
    weights with ``weights.load_flax`` on ``state.generator`` /
    ``state.discriminators``."""
    dev = resolve_device(device)
    key = jax_random.prng_key(seed)
    gen = flax_vocoder_init(make_generator(cfg).to(dev), key)
    disc = Discriminators(cfg).to(dev)
    for family, k in zip(('msd', 'mpd', 'mtd'), jax_random.split(jax_random.fold_in(key, 11), 3)):
        flax_vocoder_init(getattr(disc, family), k)
    gopt, dopt = make_optimizers(cfg, gen, disc)
    return GANState(0, gen, gopt, disc, dopt, shard)


def apply_generator(cfg: Config, generator: nn.Module, batch: Batch,
                    noise=None) -> torch.Tensor:
    """The configured generator on a batch; float32 wav ``[B, S]``.
    ``noise`` None is the inference forward, else the training noise (a
    ``torch.Generator`` or the tensors to add, in call order)."""
    with compute_dtype(cfg.vocoder.compute_dtype, batch['wav'].device):
        if cfg.vocoder.split_cv:
            out = generator(batch['mel_c'], batch['mel_v'], batch['tmpl_c'][..., None],
                            batch['tmpl_v'][..., None], batch['uv'][..., None],
                            noise=noise)
        else:
            out = generator(batch['mel'], batch['tmpl'][..., None], noise=noise)
    return float32(out[..., 0])


def _disc_forward(cfg: Config, disc: Discriminators, y, y_hat, specs_r, specs_g):
    """(MSD, MPD, MTD) outputs, float32; ``y_hat``/``specs_g`` None runs
    the real branch only."""
    yh = None if y_hat is None else y_hat[:, None]
    with compute_dtype(cfg.vocoder.compute_dtype, y.device):
        out = (disc.msd(y[:, None], yh), disc.mpd(y[:, None], yh),
               disc.mtd(specs_r, specs_g))
    return float32(out)


def _mean_score(scores: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean(d) for d in scores) / len(scores)


def _guarded_update(opt: torch.optim.Optimizer, loss: torch.Tensor, lr: float,
                    clip_norm: float, shard: Optional[Shard] = None) -> None:
    """The average over the ranks of ``shard``, NaN guard, optional
    global-norm clip, then the AdamW update at ``lr``, without a host
    sync."""
    params = [p for group in opt.param_groups for p in group['params']]
    grads = [p.grad for p in params]
    loss = loss.clone()
    all_reduce_grads(grads + [loss.view(1)], shard)
    ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads))
    for g in grads:
        g.masked_fill_(~ok, 0.0)
    if clip_norm > 0:
        clip_by_global_norm_(grads, clip_norm)
    for group in opt.param_groups:
        group['lr'] = lr
    opt.step()


def discriminator_phase(cfg: Config, state: GANState, y: torch.Tensor,
                        y_g_det: torch.Tensor, steps_per_epoch: int
                        ) -> Dict[str, torch.Tensor]:
    """``d_train_times`` updates of the discriminators on the real ``y``
    and the detached fake ``y_g_det``; the last update's losses and mean
    scores."""
    hv = cfg.vocoder
    disc = state.discriminators
    with torch.no_grad():
        _, specs_r, specs_g_det = L.multi_stft_specs_and_loss(y, y_g_det, cfg)
    d_params = list(disc.parameters())
    for i in range(hv.d_train_times):
        zero_grad_(d_params)
        (sr, sg, _, _), (pr, pg, _, _), (tr, tg, _, _) = _disc_forward(
            cfg, disc, y, y_g_det, specs_r, specs_g_det)
        ls = L.discriminator_loss(sr, sg, cfg)
        lp = L.discriminator_loss(pr, pg, cfg)
        lt = L.discriminator_loss(tr, tg, cfg)
        total = ls + lp + lt
        r1 = torch.zeros((), device=y.device)
        if hv.r1_gamma > 0.0:
            # R1: gamma/2 * E_x ||grad_x sum(D(x))||^2 on the real branch
            # only, differentiated again for the discriminators' update
            yy = y.detach().requires_grad_(True)
            (rs, _, _, _), (rp, _, _, _), (rt, _, _, _) = _disc_forward(
                cfg, disc, yy, None, L.multi_stft_specs(yy, cfg), None)
            score = sum(torch.sum(x) for x in rs + rp + rt)
            gy, = torch.autograd.grad(score, yy, create_graph=True)
            r1 = torch.sum(gy * gy) / y.shape[0]
            total = total + 0.5 * hv.r1_gamma * r1
        total.backward()
        _guarded_update(state.disc_opt, total.detach(), learning_rate(
            hv.learning_rate_d, hv.lr_decay, state.step * hv.d_train_times + i,
            steps_per_epoch * hv.d_train_times), hv.grad_clip_norm, state.shard)
        d_aux = {'loss_disc_s': ls, 'loss_disc_p': lp, 'loss_disc_t': lt,
                 'loss_r1': r1,
                 'sc_s_r': _mean_score(sr), 'sc_s_g': _mean_score(sg),
                 'sc_p_r': _mean_score(pr), 'sc_p_g': _mean_score(pg),
                 'sc_t_r': _mean_score(tr), 'sc_t_g': _mean_score(tg)}
    return d_aux


def generator_phase(cfg: Config, state: GANState, y: torch.Tensor,
                    y_g: torch.Tensor, steps_per_epoch: int
                    ) -> Dict[str, torch.Tensor]:
    """One generator update through ``y_g`` (the generator's output with
    its graph) against the discriminators as they are now; its losses.
    The discriminators' weights take no gradient."""
    hv = cfg.vocoder
    gen, disc = state.generator, state.discriminators
    g_params = list(gen.parameters())
    zero_grad_(g_params)
    disc.requires_grad_(False)
    try:
        loss_mstft, sp_r, sp_g = L.multi_stft_specs_and_loss(y, y_g, cfg)
        zero = torch.zeros((), device=y.device)
        loss_env = L.envelope_loss(y, y_g, cfg) if hv.envelope_loss else zero
        loss_dyn = L.dynamic_loss(y, y_g, cfg) if hv.dynamic_loss else zero
        loss_sm = L.strip_mirror_loss(y_g, state.shard) if hv.strip_mirror_loss else zero
        (sr, sg, fsr, fsg), (pr, pg, fpr, fpg), (tr, tg, ftr, ftg) = _disc_forward(
            cfg, disc, y, y_g, sp_r, sp_g)
        loss_fm_s = L.feature_loss(fsr, fsg)
        loss_fm_p = L.feature_loss(fpr, fpg)
        loss_fm_t = L.feature_loss(ftr, ftg)
        loss_gen_s = L.generator_loss(sg, sr, cfg)
        loss_gen_p = L.generator_loss(pg, pr, cfg)
        loss_gen_t = L.generator_loss(tg, tr, cfg)
        g_total = (loss_gen_s + loss_gen_p + loss_gen_t
                   + (loss_fm_s + loss_fm_p + loss_fm_t) * hv.w_loss_fm
                   + loss_mstft * hv.w_loss_mstft
                   + loss_env * hv.w_loss_env
                   + loss_dyn * hv.w_loss_dyn
                   + loss_sm * hv.w_loss_sm)
        g_total.backward()
    finally:
        disc.requires_grad_(True)
    _guarded_update(state.gen_opt, g_total.detach(), learning_rate(
        hv.learning_rate_g, hv.lr_decay, state.step, steps_per_epoch), hv.grad_clip_norm,
        state.shard)

    return {'loss_gen_all': g_total, 'loss_gen_s': loss_gen_s,
            'loss_gen_p': loss_gen_p, 'loss_gen_t': loss_gen_t,
            'loss_fm_s': loss_fm_s, 'loss_fm_p': loss_fm_p,
            'loss_fm_t': loss_fm_t, 'loss_mstft': loss_mstft,
            'loss_env': loss_env, 'loss_dyn': loss_dyn, 'loss_sm': loss_sm}


def gan_train_step(cfg: Config, state: GANState, batch: Batch, noise,
                   steps_per_epoch: int = 568) -> Tuple[GANState, Dict[str, torch.Tensor]]:
    """One GAN step in place: the generator forward, the discriminator
    phase on its detached output, the generator phase.  Returns ``(state,
    metrics)`` with the JAX step's metric keys.  ``noise``: a
    ``torch.Generator`` on the batch's device (drawn at the global batch's
    shape under ``state.shard``), or this rank's noise tensors in call
    order."""
    y = batch['wav']
    if isinstance(noise, torch.Generator) and state.shard is not None:
        gen, shard = noise, state.shard
        noise = lambda shape, device: shard_draw(           # noqa: E731
            lambda s: torch.rand(s, generator=gen, device=device), shape, shard)
    y_g = apply_generator(cfg, state.generator, batch, noise)
    d_aux = discriminator_phase(cfg, state, y, y_g.detach(), steps_per_epoch)
    g_aux = generator_phase(cfg, state, y, y_g, steps_per_epoch)
    metrics = mean_over_ranks({k: v.detach() for k, v in {**d_aux, **g_aux}.items()},
                              state.shard)
    metrics['loss_disc_all'] = (metrics['loss_disc_s'] + metrics['loss_disc_p']
                                + metrics['loss_disc_t'])
    state.step += 1
    return state, metrics


@torch.no_grad()
def gan_eval_step(cfg: Config, generator: nn.Module, batch: Batch
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Held-out metrics of the inference forward."""
    y = batch['wav']
    y_g = apply_generator(cfg, generator, batch)
    loss_mstft, _, _ = L.multi_stft_specs_and_loss(y, y_g, cfg)
    return y_g, {'loss_mstft': loss_mstft,
                 'loss_env': L.envelope_loss(y, y_g, cfg),
                 'loss_dyn': L.dynamic_loss(y, y_g, cfg),
                 'loss_sm': L.strip_mirror_loss(y_g)}

