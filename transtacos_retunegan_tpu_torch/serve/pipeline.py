"""Serving pipeline: text -> syl4 -> mag -> (mel, Griffin-Lim template) -> wav.

Port of ``transtacos_retunegan_tpu/serve/pipeline.py`` for one request at a
time.  Surfaces:

* ``tts_fused(pinyin)``      -- text -> wav in one pass: encoder, the
  whole-decode kernel (early exit), posnet, DSP, 4-iteration Griffin-Lim
  template and the RefineGAN_small vocoder, run at the full ``max_iters``
  length and trimmed on the host to the stop token
* ``synthesize_spec(pinyin)`` -- natural-scale linear spec [F, T], DC restored
* ``vocode(spec)``           -- neural vocoder on a supplied spec
* ``tts(text)``              -- clause split, then ``tts_fused`` for one
  clause or spec concat + ``vocode`` for several

Text pads to a multiple of ``text_bucket`` and specs to 64 frames, as in the
JAX package.  Everything runs on ``device`` (default ``'cuda'``); without a
card the constructor raises.  The Griffin-Lim phase of each request comes
from a ``torch.Generator`` seeded with ``(seed, request counter)``, or from
an explicit ``theta``.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional

import numpy as np
import torch

from ..audio import dsp
from ..config import Config
from ..models.acoustic import Tacotron, posnet_apply
from ..models.generators import make_generator
from ..models.precision import compute_dtype
from ..ops.fused_decoder import fold_params, fused_decode_full
from ..text import frontend
from ..weights import load_flax, load_npz, seeded_init


def _round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but no CUDA device is '
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def _weights(tree_or_path):
    return load_npz(tree_or_path) if isinstance(tree_or_path, str) else tree_or_path


class Synthesizer:
    """End-to-end TTS: acoustic model, fused decode kernel, vocoder."""

    def __init__(self, cfg: Optional[Config] = None,
                 acoustic_params: Any = None, gen_params: Any = None,
                 kanji_table: Optional[str] = None,
                 max_iters: Optional[int] = None,
                 infer_dtype: str = 'auto',
                 seed: int = 114514, device='cuda'):
        """``acoustic_params`` / ``gen_params``: a flax param tree (numpy
        leaves) or the path of one saved with ``weights.save_npz``; seeded
        random weights when None."""
        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        self.max_iters = max_iters or self.cfg.acoustic.max_iters
        if infer_dtype == 'auto':
            infer_dtype = ('bfloat16' if self.device.type == 'cuda'
                           else self.cfg.vocoder.compute_dtype)
        self.infer_dtype = infer_dtype
        self.seed = seed
        self._count = itertools.count()
        self.kanji2pinyin = frontend.KanjiPinyin(kanji_table)

        self.acoustic = Tacotron(self.cfg)
        self.generator = make_generator(self.cfg)
        for module, tree, s in ((self.acoustic, acoustic_params, seed),
                                (self.generator, gen_params, seed + 1)):
            if tree is None:
                seeded_init(module, s)
            else:
                load_flax(module, _weights(tree))
            module.to(self.device).eval().requires_grad_(False)
        self.decoder = fold_params(self.acoustic.decoder_cell)      # bf16

    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        """Per-request Griffin-Lim phase generator (thread-safe counter)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1000003 + next(self._count))
        return g

    def _text(self, pinyin: str):
        seq = frontend.serialize_inference(pinyin, self.cfg.acoustic.g2p)
        n = seq.shape[0]
        text = np.zeros((1, _round_up(max(n, 1), self.cfg.acoustic.text_bucket), 2),
                        np.int64)
        text[0, :n] = seq
        return (torch.from_numpy(text).to(self.device),
                torch.tensor([n], device=self.device))

    @torch.no_grad()
    def _encode(self, pinyin: str):
        """pinyin -> attention keys, values and mask of the padded text."""
        return self.acoustic(*self._text(pinyin))

    @torch.no_grad()
    def _decode(self, enc):
        """The whole decode in one kernel launch, stopping early per row."""
        return fused_decode_full(self.decoder, enc['keys'], enc['values'],
                                 enc['mask'], self.max_iters, early_exit=True)

    @torch.no_grad()
    def _acoustic(self, pinyin: str):
        """pinyin -> (normalised mag [1, steps*r, F-1], out_len [1])."""
        out = self._decode(self._encode(pinyin))
        return posnet_apply(self.acoustic, out['mel_outputs']), out['out_lengths']

    @torch.no_grad()
    def _template(self, s: torch.Tensor, theta=None):
        """natural |STFT| [F, T] -> (log mel [M, T], Griffin-Lim template
        [hop * T])."""
        au = self.cfg.audio
        mel = torch.log(torch.clamp(dsp.mag_to_mel(s, au), min=dsp.EPS_AMP))
        log_mag = torch.log(torch.clamp(s, min=dsp.EPS_AMP))
        wavlen = au.hop_length * s.shape[-1]
        # length hop*T - 1 then pad 1 keeps the template's STFT at T frames
        tmpl = dsp.inv_log_mag(log_mag, au, length=wavlen - 1, theta=theta,
                               generator=None if theta is not None else self._generator())
        return mel, torch.nn.functional.pad(tmpl, (0, 1))

    @torch.no_grad()
    def _generate(self, mel: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
        """Neural vocoder at ``infer_dtype`` -> float32 wav [hop * T]."""
        with compute_dtype(self.infer_dtype, self.device):
            wav = self.generator(mel.T[None], tmpl[None, :, None])
        return wav[0, :, 0].float()

    def _vocode_natural(self, s: torch.Tensor, theta=None) -> torch.Tensor:
        """natural |STFT| [F, T] -> wav [hop * T] (template + generator)."""
        return self._generate(*self._template(s, theta))

    def tts_fused(self, pinyin: str, theta: Optional[torch.Tensor] = None
                  ) -> np.ndarray:
        """pinyin -> wav (float32) for one request; ``theta`` optionally
        pins the Griffin-Lim initial phase [n_freq, max_iters * r]."""
        au = self.cfg.audio
        mag, out_len = self._acoustic(pinyin)
        s = dsp.fix_zero_dc(dsp.spec_to_natural_scale(mag[0].T, au), au)
        wav = self._vocode_natural(s, theta)
        return wav[:au.hop_length * int(out_len[0])].cpu().numpy()

    def synthesize_spec(self, pinyin: str) -> np.ndarray:
        """Natural-scale spec [F, T] with DC restored, trimmed at the stop."""
        mag, out_len = self._acoustic(pinyin)
        mag = mag[0, :int(out_len[0])].T
        s = dsp.fix_zero_dc(dsp.spec_to_natural_scale(mag, self.cfg.audio),
                            self.cfg.audio)
        return s.cpu().numpy()

    def _bucket_spec(self, spec: np.ndarray, bucket: int = 64) -> np.ndarray:
        """Pad [F, T] to a frame bucket with near-silence; callers trim the
        wav back to the true length."""
        t = spec.shape[1]
        t_pad = _round_up(max(t, bucket), bucket)
        if t_pad == t:
            return spec
        pad = np.full((spec.shape[0], t_pad - t), float(spec.min()), spec.dtype)
        return np.concatenate([spec, pad], axis=1)

    def vocode(self, spec: np.ndarray, theta: Optional[torch.Tensor] = None
               ) -> np.ndarray:
        """Natural-scale spec (either orientation) -> neural wav."""
        au = self.cfg.audio
        if spec.shape[0] not in (au.n_freq, au.n_freq - 1):
            spec = spec.T
        s = dsp.fix_zero_dc(torch.as_tensor(np.asarray(spec, np.float32)), au)
        t_real = s.shape[1]
        s = torch.from_numpy(self._bucket_spec(s.numpy())).to(self.device)
        wav = self._vocode_natural(s, theta)
        return wav[:au.hop_length * t_real].cpu().numpy()

    def tts(self, text: str, neural: bool = True) -> np.ndarray:
        """Text (numbered pinyin, or kanji with a pinyin provider) -> wav."""
        if not neural:
            raise NotImplementedError('Griffin-Lim-only synthesis is not ported yet')
        if frontend.looks_like_pinyin(text):
            segs: List[str] = [text.strip().lower()]
        else:
            segs = [self.kanji2pinyin(s) for s in frontend.normalize_text(text)]
        if len(segs) == 1:
            return self.tts_fused(segs[0])
        return self.vocode(np.concatenate([self.synthesize_spec(p) for p in segs],
                                          axis=1))

