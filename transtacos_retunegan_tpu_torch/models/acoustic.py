"""TransTacoS acoustic model at inference, ported from
``transtacos_retunegan_tpu/models/acoustic.py``.

``Tacotron.forward`` is the ``train=False, encoder_only=True`` branch:
phone/tone/prosody embeddings (prosody predicted by the prdsnet argmax) ->
positional-encoding concat -> self-attention encoder -> attention keys,
masked values and mask for the decoder.  The decode itself runs in
``ops/fused_decoder.py`` on the ``decoder_cell`` child, and ``posnet_apply``
maps its mel to the linear spectrogram.  The module registers the whole
parameter tree of the JAX model (train-only leaves included) so that any
checkpoint of it loads with every leaf consumed.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..text.symbols import get_vocab_size
from .decoder import DecoderCell, MemoryLayer, prepare_attention
from .encoder import EncoderSA, var_embed_width
from .layers import ConvStack, leaky_relu, sinusoid_table


class Tacotron(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        hp, au = cfg.acoustic, cfg.audio
        if hp.encoder_type != 'sa':
            raise NotImplementedError(f'encoder_type={hp.encoder_type!r}')
        if hp.decoder_sew_layer:
            raise NotImplementedError('decoder_sew_layer')
        self.cfg = cfg
        emb = lambda n: nn.Parameter(torch.zeros(n, hp.embed_depth))  # noqa: E731
        self.E_text = emb(get_vocab_size(hp.g2p))
        if hp.g2p == 'syl4':
            self.E_tone = emb(au.n_tone)
            self.E_prds = emb(au.n_prds)
            self.prdsnet = ConvStack(3, hp.prdsnet_conv_k, hp.embed_depth,
                                     hp.prdsnet_depth, au.n_prds, F.relu)
        # train-only f0/c0 embedding tables
        self.E_f0 = nn.Parameter(torch.zeros(au.n_f0_bins, hp.var_embed_depth))
        self.E_c0 = nn.Parameter(torch.zeros(au.n_c0_bins, hp.var_embed_depth))
        cin = hp.embed_depth + (hp.posenc_depth if hp.txt_use_posenc else 0)
        self.encoder = EncoderSA(hp, cin, var_embed_width(hp))
        self.attn_memory = MemoryLayer(hp.encoder_depth, hp.attention_depth)
        self.decoder_cell = DecoderCell(cfg)
        widths = (hp.n_mel_low, hp.posnet_depth // 4, hp.posnet_depth // 2,
                  hp.posnet_depth)
        for i in range(3):
            self.add_module(f'posnet{i + 1}', nn.Linear(widths[i], widths[i + 1]))
        g = hp.posnet_ngroup
        for i in range(g):
            self.add_module(f'posnet4_{i}', nn.Linear(
                hp.posnet_depth // g, (au.n_freq - 1) // g))
        self.register_buffer('pe_table', torch.from_numpy(sinusoid_table(
            max(au.maxlen_text, au.maxlen_spec), hp.posenc_depth)),
            persistent=False)

    def forward(self, text: torch.Tensor,
                text_lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """text [B, N, 2] int (phone id, tone), lengths [B] -> keys [B, N, A],
        values [B, N, D], mask [B, N], prds_out [B, N] (None for 'seq')."""
        hp = self.cfg.acoustic
        b, n = text.shape[0], text.shape[1]
        prds_out = None
        if hp.g2p == 'syl4':
            text_embd = self.E_text[text[..., 0]] + self.E_tone[text[..., 1]]
            prds_out = self.prdsnet(text_embd).argmax(-1)
            embd = text_embd + self.E_prds[prds_out]
        else:
            embd = self.E_text[text[..., 0]]
        if hp.txt_use_posenc:
            pe = self.pe_table[None, :n].expand(b, n, hp.posenc_depth)
            embd = torch.cat([embd, pe], -1)
        enc = self.encoder(embd, text_lengths)
        attn = prepare_attention(enc, text_lengths, self.attn_memory(enc))
        return {'keys': attn.keys, 'values': attn.values, 'mask': attn.mask,
                'prds_out': prds_out}


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
