"""TransTacoS acoustic model, ported from
``transtacos_retunegan_tpu/models/acoustic.py``.

``Tacotron.forward`` has the JAX module's branches:

* ``train=False``: the ``encoder_only`` inference branch: phone/tone/prosody
  embeddings (prosody predicted by the prdsnet argmax) -> positional
  encoding -> encoder -> attention keys, masked values and mask for the
  decoder.  The decode itself runs in ``ops/fused_decoder.py`` on the
  ``decoder_cell`` child, and ``posnet_apply`` maps its mel to the linear
  spectrogram.
* ``train=True``: the teacher-forced training forward, with the prosody
  marks of the batch, the Gaussian noises on the embeddings, the f0/c0
  embeddings and the encoder output, the fusenet's cross attentions, the
  training decode (``models/decoder.py::train_decode``), the optional sew
  layer and the posnet; with ``encoder_only`` it stops before the decode
  and returns the loss-side outputs with the attention tensors (the
  hoisted train step decodes them itself).

The parameters are exactly the leaves of the JAX model's training tree
(``weights.from_flax`` maps one onto the other), so ``compute_losses``'s
L2 term runs over the same set.  Random draws come from a
``layers.Draws``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..parallel import reduce_from_model, tp_sharded
from ..text.symbols import get_vocab_size
from .decoder import DecoderCell, MemoryLayer, prepare_attention, train_decode
from .encoder import CBHG, EncoderSA, var_embed_width
from .layers import (Conv, ConvStack, Dense, Draws, cosine_similarity_matrix,
                     gaussian_noise, leaky_relu, sinusoid_table)


class Tacotron(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        hp, au = cfg.acoustic, cfg.audio
        self.cfg = cfg
        emb = lambda n: nn.Parameter(torch.zeros(n, hp.embed_depth))  # noqa: E731
        self.E_text = emb(get_vocab_size(hp.g2p))
        if hp.g2p == 'syl4':
            self.E_tone = emb(au.n_tone)
            self.E_prds = emb(au.n_prds)
            self.prdsnet = ConvStack(3, hp.prdsnet_conv_k, hp.embed_depth,
                                     hp.prdsnet_depth, au.n_prds, F.relu)
        if hp.encoder_type == 'sa':
            # the f0/c0 embedding tables of the fusenet's training branch
            self.E_f0 = nn.Parameter(torch.zeros(au.n_f0_bins, hp.var_embed_depth))
            self.E_c0 = nn.Parameter(torch.zeros(au.n_c0_bins, hp.var_embed_depth))
            cin = hp.embed_depth + (hp.posenc_depth if hp.txt_use_posenc else 0)
            self.encoder = EncoderSA(hp, cin, var_embed_width(hp))
        elif hp.encoder_type == 'cb':
            self.encoder = CBHG(hp, hp.embed_depth)
        else:
            raise ValueError(f'encoder_type={hp.encoder_type!r}')
        self.attn_memory = MemoryLayer(hp.encoder_depth, hp.attention_depth)
        if hp.fast_cell:
            raise ValueError('the reference has the stock decoder cell only')
        self.decoder_cell = DecoderCell(cfg)
        if hp.decoder_sew_layer:
            self.sew_up_layer = Conv(au.n_mel, au.n_mel, 7)
        widths = (hp.n_mel_low, hp.posnet_depth // 4, hp.posnet_depth // 2,
                  hp.posnet_depth)
        for i in range(3):
            self.add_module(f'posnet{i + 1}', Dense(widths[i], widths[i + 1]))
        g = hp.posnet_ngroup
        for i in range(g):
            self.add_module(f'posnet4_{i}', Dense(
                hp.posnet_depth // g, (au.n_freq - 1) // g))
        self.register_buffer('pe_table', torch.from_numpy(sinusoid_table(
            max(au.maxlen_text, au.maxlen_spec), hp.posenc_depth)),
            persistent=False)

    def _pe(self, b: int, n: int) -> torch.Tensor:
        return self.pe_table[None, :n].expand(b, n, self.pe_table.shape[-1])

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                prds: Optional[torch.Tensor] = None,
                spec_lengths: Optional[torch.Tensor] = None,
                mel_targets: Optional[torch.Tensor] = None,
                f0_targets: Optional[torch.Tensor] = None,
                c0_targets: Optional[torch.Tensor] = None,
                tf_ratio=0.0, train: bool = False, encoder_only: bool = False,
                draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """text [B, N, 2] int (phone id, tone), lengths [B].  Inference
        (``train=False``) returns keys [B, N, A], values [B, N, D], mask
        [B, N], prds_out [B, N] and prds_prob (None for 'seq').  Training
        also takes prds [B, N], spec_lengths [B], mel_targets [B, T, M],
        f0/c0_targets [B, T] int, the teacher-forcing ratio and ``draws``
        (None: no noise, no dropout)."""
        hp = self.cfg.acoustic
        draws = draws or Draws()
        b, n = text.shape[0], text.shape[1]
        prds_prob = prds_out = e_tone_sim = e_prds_sim = None
        if hp.g2p == 'syl4':
            text_embd = self.E_text[text[..., 0]] + self.E_tone[text[..., 1]]
            prds_prob = self.prdsnet(text_embd)
            prds_out = prds_prob.argmax(-1)
            embd = text_embd + self.E_prds[prds if train else prds_out]
            e_tone_sim = cosine_similarity_matrix(self.E_tone)
            e_prds_sim = cosine_similarity_matrix(self.E_prds)
        else:
            embd = self.E_text[text[..., 0]]
        std = hp.hidden_gauss_std
        if train:
            embd = gaussian_noise(embd, std, draws.noise, draws.shard)

        if hp.encoder_type == 'sa':
            if hp.txt_use_posenc:
                embd = torch.cat([embd, self._pe(b, n)], -1)
            f0_embd = c0_embd = None
            if train:
                f0_embd = gaussian_noise(self.E_f0[f0_targets], std, draws.noise, draws.shard)
                c0_embd = gaussian_noise(self.E_c0[c0_targets], std, draws.noise, draws.shard)
                if hp.var_use_posenc:
                    pe_t = self._pe(b, f0_targets.shape[-1])
                    f0_embd = torch.cat([f0_embd, pe_t], -1)
                    c0_embd = torch.cat([c0_embd, pe_t], -1)
            enc, attns, fuse = self.encoder(embd, text_lengths, f0_embd, c0_embd,
                                            spec_lengths, train, draws.dropout, draws.shard)
        else:
            enc = self.encoder(embd, text_lengths, train, draws.shard)
            zero = embd.new_zeros(())
            attns, fuse = ([], []), ((zero, zero), (zero, zero))
        if train:
            enc = gaussian_noise(enc, std, draws.noise, draws.shard)

        attn = prepare_attention(enc, text_lengths, self.attn_memory(enc))
        out = {'prds_out': prds_out, 'prds_prob': prds_prob}
        if train:
            (f0_r, f0_r_pred), (c0_r, c0_r_pred) = fuse
            out.update({'E_text_sim': cosine_similarity_matrix(self.E_text),
                        'E_tone_sim': e_tone_sim, 'E_prds_sim': e_prds_sim,
                        'f0_r': f0_r, 'f0_r_pred': f0_r_pred,
                        'c0_r': c0_r, 'c0_r_pred': c0_r_pred})
        if encoder_only or not train:
            out.update({'keys': attn.keys, 'values': attn.values, 'mask': attn.mask})
            return out

        mel_out, stop_out, alignments = train_decode(
            self.decoder_cell, attn, mel_targets, tf_ratio, draws, hp.remat_decoder)
        if hp.decoder_sew_layer:
            mel_out = mel_out + self.sew_up_layer(mel_out)
        out.update({'mel_outputs': mel_out, 'mag_outputs': posnet_apply(self, mel_out),
                    'stop_token_outputs': stop_out, 'alignments': alignments,
                    'slf_attn': attns[0], 'crx_attn': attns[1]})
        return out


def posnet_apply(model: Tacotron, mel_out: torch.Tensor) -> torch.Tensor:
    """Posnet: low mel bands -> dense stack -> grouped heads -> linear mag
    [..., T, n_freq - 1] (DC bin dropped)."""
    hp = model.cfg.acoustic
    m = dict(model.named_children())
    x = mel_out[..., :hp.n_mel_low]
    for i in range(3):
        x = leaky_relu(m[f'posnet{i + 1}'](x))
    groups = torch.chunk(x, hp.posnet_ngroup, dim=-1)
    return torch.cat([m[f'posnet4_{i}'](g) for i, g in enumerate(groups)], -1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at 0 (1, where ``torch.abs`` has 0)."""
    return torch.where(x >= 0, x, -x)


def _masked_mean(err: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """Mean over [B, T, ...] restricted to the frames where the mask is 1."""
    if err.dim() == 3:
        m = frame_mask[..., None]
        denom = frame_mask.sum() * err.shape[-1]
    else:
        m = frame_mask
        denom = frame_mask.sum()
    return (err * m).sum() / torch.clamp(denom, min=1.0)


def _sum_of_squares(model: nn.Module) -> torch.Tensor:
    """The sum of squares of every parameter; under tensor parallelism the
    sharded leaves' squares summed over the model group, each replicated
    leaf counted once."""
    sharded = tp_sharded(model)
    if not sharded:
        flat = torch.cat([p.reshape(-1) for p in model.parameters()])
        return torch.sum(flat * flat)
    named = list(model.named_parameters())
    rep = torch.cat([p.reshape(-1) for n, p in named if n not in sharded])
    part = torch.cat([p.reshape(-1) for n, p in named if n in sharded])
    shard = next(iter(sharded.values()))[1]
    return torch.sum(rep * rep) + reduce_from_model(torch.sum(part * part), shard)


def compute_losses(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   cfg: Config, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The training loss and its terms, as the JAX ``compute_losses``.

    Its quirks are kept: ``mel_loss`` is the L1 of the linear magnitudes
    and ``mag_loss`` that of the mels (the names are swapped; the sum is
    not); the frame and text masks are one length each for the whole batch
    (``frame_loss_len``/``text_loss_len``, the reference's padded lengths);
    the fusenet losses are unmasked MSEs; the similarity terms weigh the
    off-diagonal embedding cosine similarities; the stop loss is the
    stable sigmoid cross entropy of the raw logits; L2 is half the sum of
    squares of every parameter of ``model`` (its whole leaves under tensor
    parallelism).  The absolute values and the
    max take JAX's subgradients at 0 (1 and 1/2), so that a stop logit of
    exactly 0 gets JAX's gradient.
    """
    hp = cfg.acoustic
    bsz, t_pad = out['mel_outputs'].shape[:2]
    n_pad = batch['text'].shape[1]
    device = out['mel_outputs'].device
    fmask = (torch.arange(t_pad, device=device)[None, :]
             < batch['frame_loss_len']).float().expand(bsz, t_pad)
    tmask = (torch.arange(n_pad, device=device)[None, :]
             < batch['text_loss_len']).float().expand(bsz, n_pad)

    mel_loss = _masked_mean(_abs(batch['mag_targets'] - out['mag_outputs']), fmask)
    mag_loss = _masked_mean(_abs(batch['mel_targets'] - out['mel_outputs']), fmask)

    zero = torch.zeros((), device=device)
    if hp.encoder_type == 'sa' and hp.encoder_fusenet:
        f0_loss = torch.mean(torch.square(out['f0_r'] - out['f0_r_pred']))
        c0_loss = torch.mean(torch.square(out['c0_r'] - out['c0_r_pred']))
    else:
        f0_loss = c0_loss = zero

    vocab = out['E_text_sim'].shape[0]
    off_diag = lambda k: 1.0 - torch.eye(k, device=device)    # noqa: E731
    sim_loss = torch.mean(_abs(off_diag(vocab) * out['E_text_sim']))
    if hp.g2p == 'syl4':
        logp = F.log_softmax(out['prds_prob'], dim=-1)
        ce = -torch.gather(logp, -1, batch['prds'][..., None].long())[..., 0]
        prds_loss = (ce * tmask).sum() / torch.clamp(tmask.sum(), min=1.0)
        sim_loss = sim_loss + torch.mean(_abs(off_diag(cfg.audio.n_prds)
                                                   * out['E_prds_sim']))
    else:
        prds_loss = zero
    sim_loss = sim_loss * hp.sim_weight

    logits = out['stop_token_outputs']
    labels = batch['stop_token_targets']
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
          + torch.log1p(torch.exp(-_abs(logits))))
    stop_token_loss = _masked_mean(ce, fmask)

    reg_loss = _sum_of_squares(model) / 2.0 * hp.reg_weight

    loss = (prds_loss + mel_loss + mag_loss + f0_loss + c0_loss + sim_loss
            + stop_token_loss + reg_loss)
    return {'loss': loss, 'mel_loss': mel_loss, 'mag_loss': mag_loss,
            'f0_loss': f0_loss, 'c0_loss': c0_loss, 'prds_loss': prds_loss,
            'sim_loss': sim_loss, 'stop_token_loss': stop_token_loss,
            'reg_loss': reg_loss}
