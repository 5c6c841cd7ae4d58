"""Train and eval steps of the acoustic model, ported from
``transtacos_retunegan_tpu/train/acoustic_step.py``.

One optimizer step: the teacher-forced forward, the loss sum, then optax's
chain of the JAX package: the global-norm clip at ``grad_clip_norm`` (no
epsilon on the norm), Adam (b1 0.9, b2 0.999, eps 1e-7, no weight decay)
and the Noam rate of the step before its increment.  ``torch.optim.Adam``
computes ``mu_hat / (sqrt(nu_hat) + eps)``, as optax's ``scale_by_adam``
with ``eps_root=0``.

* ``train_step``: the scanned training decode (``models/decoder.py``).
* ``train_step_hoisted``: the same function while the decoder input is
  ground truth (``hoist_force_eligible``), with the prenet and the head
  batched over all steps (``models/decoder_fast.py``).

Random draws come from a ``models.layers.Draws`` (explicit
``torch.Generator``s for the noise, dropout and teacher-forcing streams).

A state with a data-parallel ``shard`` (``parallel.current_shard()``, set
by the trainer) computes the step on its share of the global batch: the
step hands the shard to its ``Draws`` (draws at the global batch's shape,
batch norm over the global batch), and averages the gradients over the
ranks before the clip and the logged losses after the step, so that the
step is the global batch's.  ``infer_step`` takes no shard: it is local.
The explicit all-reduce (not a ``DistributedDataParallel`` wrapper) also
serves ``train_step_hoisted``, whose backward is a plain ``.backward()``
as well, and keeps the ranks' parameters bitwise equal.

Under tensor parallelism (a model after ``parallel.shard_params_tp``, the
state's shard with ``model_count > 1``) the forward gathers the sharded
products over the model group; the gradients are averaged over the data
group, the clip takes the norm of the whole gradient (``optim.global_norm``
sums the slices' squares over the model group) and Adam updates this
rank's slices and their moments.  ``local_model`` gathers a whole model
for evaluation.

Nothing here waits for the card: the losses are 0-dim device tensors
(``tfr`` and ``learning_rate`` are host floats).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import jax_random
from ..config import Config
from ..models.acoustic import Tacotron, compute_losses, posnet_apply
from ..models.decoder_fast import hoisted_force_decode
from ..models.layers import Draws
from ..ops.fused_decoder import fold_params, fused_decode_full
from ..parallel import (Shard, all_reduce_grads, gather_params_tp, mean_over_ranks,
                        reduce_from_model, tp_sharded)
from ..serve.pipeline import resolve_device
from ..weights import flax_acoustic_init
from .optim import clip_by_global_norm_, global_norm, zero_grad_
from .schedules import noam_lr, teacher_forcing_ratio

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (which holds the parameters and, for the 'cb' encoder,
    the batch statistics) and its optimizer; ``step`` counts train steps
    on the host; ``shard`` is the data-parallel shard the steps run under
    (None: one process)."""
    step: int
    model: Tacotron
    opt: torch.optim.Optimizer
    shard: Optional[Shard] = None

    @property
    def extra_vars(self) -> Dict[str, torch.Tensor]:
        """The model's state that is not a parameter: the CBHG encoder's
        batch-norm statistics (empty for the 'sa' encoder)."""
        params = dict(self.model.named_parameters())
        return {k: v for k, v in self.model.state_dict().items() if k not in params}


def make_optimizer(cfg: Config, model: Tacotron) -> torch.optim.Optimizer:
    hp = cfg.acoustic
    return torch.optim.Adam(model.parameters(), lr=noam_lr(0, hp),
                            betas=(hp.adam_beta1, hp.adam_beta2), eps=hp.adam_eps)


def init_state(cfg: Config, seed: int = 114514, device='cuda',
               shard: Optional[Shard] = None) -> TrainState:
    """The JAX package's initial weights for ``seed`` (its ``init_state(cfg,
    PRNGKey(seed), batch)``, drawn by ``weights.flax_acoustic_init``: the
    same values on every device and rank) and a fresh optimizer on
    ``device``, stepping under ``shard``; load other weights with
    ``weights.load_flax`` on ``state.model`` before the first step."""
    dev = resolve_device(device)
    model = flax_acoustic_init(Tacotron(cfg), jax_random.prng_key(seed)).to(dev)
    return TrainState(0, model, make_optimizer(cfg, model), shard)


def _upcast_batch(batch: Batch) -> Batch:
    """float32 again for features that crossed to the card in a 16-bit
    wire dtype (``--wire_dtype``); other tensors pass through."""
    return {k: v.float() if v.dtype in (torch.float16, torch.bfloat16) else v
            for k, v in batch.items()}


def _sharded(draws: Optional[Draws], state: TrainState) -> Draws:
    """``draws`` under the state's data-parallel shard."""
    return dataclasses.replace(draws or Draws(), shard=state.shard)


def _forward(model: Tacotron, batch: Batch, tf_ratio, draws: Draws,
             encoder_only: bool = False):
    return model(batch['text'], batch['text_lengths'], batch['prds'],
                 batch['spec_lengths'], batch['mel_targets'], batch['f0_targets'],
                 batch['c0_targets'], tf_ratio, train=True,
                 encoder_only=encoder_only, draws=draws)


def _update(cfg: Config, state: TrainState, losses: Dict[str, torch.Tensor],
            tfr: float) -> Tuple[TrainState, Dict[str, Any]]:
    """Backward, the average over the ranks, clip, Adam at the Noam rate
    of ``state.step``."""
    hp = cfg.acoustic
    params = list(state.model.parameters())
    zero_grad_(params)
    losses['loss'].backward()
    grads = [p.grad for p in params]
    all_reduce_grads(grads, state.shard)
    sharded = tp_sharded(state.model)
    gnorm = global_norm(grads, state.shard,
                        [n in sharded for n, _ in state.model.named_parameters()])
    clip_by_global_norm_(grads, hp.grad_clip_norm, gnorm)
    lr = noam_lr(state.step, hp)
    for group in state.opt.param_groups:
        group['lr'] = lr
    state.opt.step()
    state.step += 1
    out: Dict[str, Any] = mean_over_ranks({k: v.detach() for k, v in losses.items()},
                                          state.shard)
    out.update(grad_norm=gnorm.detach(), tfr=tfr, learning_rate=lr)
    return state, out


def train_step(cfg: Config, state: TrainState, batch: Batch,
               draws: Optional[Draws] = None) -> Tuple[TrainState, Dict[str, Any]]:
    """One step in place with the scanned training decode, at the
    teacher-forcing ratio of ``state.step``."""
    batch = _upcast_batch(batch)
    tfr = teacher_forcing_ratio(state.step, cfg.acoustic)
    state.model.train()
    out = _forward(state.model, batch, tfr, _sharded(draws, state))
    return _update(cfg, state, compute_losses(out, batch, cfg, state.model), tfr)


def hoist_force_eligible(cfg: Config, step: int) -> bool:
    """True while ``train_step_hoisted`` computes ``train_step``'s function:
    the decoder input is pure ground truth (``force`` always; ``mix`` and
    ``random`` while the teacher-forcing ratio is still 1).  The sew layer
    is not in the hoisted path."""
    hp = cfg.acoustic
    if hp.decoder_sew_layer:
        return False
    if hp.tf_method == 'force':
        return True
    return hp.tf_init >= 1.0 and step < hp.tf_start_decay


def train_step_hoisted(cfg: Config, state: TrainState, batch: Batch,
                       draws: Optional[Draws] = None) -> Tuple[TrainState, Dict[str, Any]]:
    """``train_step`` with the decode's time-parallel work hoisted out of
    the step loop (``decoder_fast.hoisted_force_decode``); the prenet's
    dropout masks are ``draws.prenet_keep`` or drawn from
    ``draws.dropout``."""
    batch = _upcast_batch(batch)
    draws = _sharded(draws, state)
    model = state.model
    model.train()
    enc = _forward(model, batch, 1.0, draws, encoder_only=True)
    mel_out, stop_out, alignments = hoisted_force_decode(
        model.decoder_cell, cfg, batch['mel_targets'], enc['keys'], enc['values'],
        enc['mask'], keep=draws.prenet_keep, generator=draws.dropout, shard=draws.shard)
    out = dict(enc, mel_outputs=mel_out, stop_token_outputs=stop_out,
               mag_outputs=posnet_apply(model, mel_out), alignments=alignments)
    return _update(cfg, state, compute_losses(out, batch, cfg, model), 1.0)


@contextlib.contextmanager
def frozen_stats(model: Tacotron):
    """Run a training forward without keeping its batch-statistics update
    (the JAX package discards the mutated collection there)."""
    saved = {k: v.clone() for k, v in model.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])


def summary_stats(cfg: Config, state: TrainState, batch: Batch,
                  draws: Optional[Draws] = None) -> Dict[str, Any]:
    """TensorBoard histogram payloads: the training forward's mel and mag
    outputs (this rank's rows), each parameter's gradient norm (of the
    global batch's loss under the state's shard) and the predicted prosody
    marks; the state (parameters, gradients, batch statistics) is left
    as it was."""
    batch = _upcast_batch(batch)
    model = state.model
    tfr = teacher_forcing_ratio(state.step, cfg.acoustic)
    with frozen_stats(model):
        out = _forward(model, batch, tfr, _sharded(draws, state))
        loss = compute_losses(out, batch, cfg, model)['loss']
        names, params = zip(*model.named_parameters())
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
    all_reduce_grads(grads, state.shard)
    norms = {n: torch.linalg.vector_norm(g) for n, g in zip(names, grads)}
    sharded = list(tp_sharded(model))
    if sharded:                 # whole leaves: the slices' squares summed
        sq = reduce_from_model(torch.stack([norms[n] ** 2 for n in sharded]), state.shard)
        norms.update(zip(sharded, torch.sqrt(sq).unbind()))
    return {'mel_outputs': out['mel_outputs'].detach(),
            'mag_outputs': out['mag_outputs'].detach(),
            'prds_out': out['prds_out'], 'grad_norms': norms}


def local_model(cfg: Config, state: TrainState) -> Tacotron:
    """A model of this process alone with the state's whole parameters and
    batch statistics (the state's own model unless it is sharded), for
    evaluation without collectives.  Under tensor parallelism it gathers
    the leaves over each model group: every rank calls it."""
    if not tp_sharded(state.model):
        return state.model
    params, _ = gather_params_tp(state.model)
    model = Tacotron(cfg).to(next(state.model.parameters()).device)
    model.load_state_dict({**params, **state.extra_vars})
    return model


@torch.no_grad()
def infer_step(cfg: Config, model: Tacotron, batch: Batch,
               max_iters: int) -> Dict[str, torch.Tensor]:
    """Fixed-length inference decode through the whole-decode kernel
    (float32 weights; its plain version on the CPU), then the sew layer
    and the posnet: mel, mag, stop probabilities, alignments, out_lengths
    and the predicted prosody marks."""
    enc = model(batch['text'], batch['text_lengths'])
    fp = fold_params(model.decoder_cell, torch.float32)
    out = fused_decode_full(fp, enc['keys'], enc['values'], enc['mask'], max_iters)
    mel = out['mel_outputs']
    if cfg.acoustic.decoder_sew_layer:
        mel = mel + model.sew_up_layer(mel)
    return dict(out, mel_outputs=mel, mag_outputs=posnet_apply(model, mel),
                prds_out=enc['prds_out'])
