"""Serving pipeline: text -> syl4 -> mag -> (mel, Griffin-Lim template) -> wav.

Port of ``transtacos_retunegan_tpu/serve/pipeline.py``.  Surfaces:

* ``tts_fused(pinyin)``      -- text -> wav for one request: encoder, the
  whole-decode kernel (early exit), posnet, DSP, 4-iteration Griffin-Lim
  template and the RefineGAN_small vocoder, run at the full ``max_iters``
  length and trimmed on the host to the stop token
* ``synthesize_spec(pinyin)`` / ``synthesize_spec_batch(pinyins)`` --
  natural-scale linear spec [F, T], DC restored, trimmed at each row's own
  stop; a batch is one ``decode_full`` launch over all its rows
* ``synthesize_wav(pinyin)``  -- the acoustic service's 30-iteration
  Griffin-Lim, inverse pre-emphasis and silence trim
* ``synthesize_with_alignment(pinyin)`` -- spec plus the decoder alignment
* ``vocode(spec)`` / ``vocode_batch(specs)`` -- neural vocoder on supplied
  specs, one generator forward per batch
* ``tts(text)`` / ``tts_batch(texts)`` -- text (pinyin, or kanji with a
  pinyin provider) -> wav, neural or Griffin-Lim

Text pads to a multiple of ``text_bucket``, specs to 64 frames and batches
to a power of two rows (fill rows repeat row 0 and are dropped), as in the
JAX package.  Everything runs on ``devices[0]`` (default ``'cuda'``);
without a card the constructor raises.

Data-parallel serving (several ``devices``, the app's ``--dp``): one replica
of both models per device, each with its own folded decoder weights.  The
batched surfaces (``synthesize_spec_batch``, ``vocode_batch``,
``tts_batch``) pad their rows to a multiple of the replica count and split
them contiguously over the replicas, each on a long-lived thread of its
own, and each replica launches the decode kernel on its rows; the results
come back in order.  The single-request surfaces run on replica 0, as in
the JAX package.  Each request's Griffin-Lim phase comes from a
``torch.Generator`` seeded with ``(seed, request counter)``, from
``content_generator(data)`` (seeded with the request's content, so that a
batching server's audio does not depend on arrival order), or from an
explicit ``theta``.

Spans (``utils/tracing.py``) split the two batched stages, each a child of
the span open where the stage was called (on a replica's thread, of the
call that sent the rows there): ``acoustic.text`` (the host text frontend
and batch assembly; ``rows``, ``real`` texts, text ``bucket``),
``acoustic.launch`` (the encoder, the decode and the posnet as enqueued;
``decode_full`` records the host time of its launch and of its error
word's read, which waits for the kernel), ``acoustic.sync`` (the copy of
the specs to the host; each row's ``steps``); ``vocoder.prep`` (the
specs oriented, DC-restored and padded in numpy, the phase drawn, then on
the replica the copy to the card; ``rows``, ``real`` specs, frame
``bucket``, ``frames``), ``vocoder.launch`` (template and generator, as
enqueued), ``vocoder.sync`` (the wav's copy to the host).
"""

from __future__ import annotations

import copy
import itertools
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import jax_random
from ..audio import dsp, features
from ..config import Config
from ..models.acoustic import Tacotron, posnet_apply
from ..models.generators import make_generator
from ..models.precision import compute_dtype
from ..ops.fused_decoder import fold_params, fused_decode_full
from ..text import frontend
from ..train import checkpoint as ckpt
from ..utils import tracing
from ..weights import flax_acoustic_init, flax_vocoder_init, load_flax, load_npz


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
                 seed: int = 114514, devices: Sequence = ('cuda',),
                 acoustic_dir: Optional[str] = None, vocoder_dir: Optional[str] = None):
        """``acoustic_params`` / ``gen_params``: a flax param tree (numpy
        leaves), the path of one saved with ``weights.save_npz``, or the
        module's own state dict (torch tensors; an acoustic training
        checkpoint gives one through ``train.checkpoint.load_acoustic_params``);
        when None, the JAX server's initial weights whatever the ``seed``
        (which seeds only the requests' draws): the acoustic model's from
        ``PRNGKey(0)`` (``weights.flax_acoustic_init``), the generator's
        from ``PRNGKey(1)`` (``weights.flax_vocoder_init``).
        ``acoustic_dir`` / ``vocoder_dir``: a trainer's run dir, whose
        newest ``ckpt_`` / ``g_`` is loaded (the initial weights stay when
        it has none), as the JAX constructor's;
        one model takes a dir or params, not both.  ``devices``: one
        replica per entry (replica 0 on the first)."""
        for what, params, run_dir in (('acoustic', acoustic_params, acoustic_dir),
                                      ('vocoder', gen_params, vocoder_dir)):
            if params is not None and run_dir:
                raise ValueError(f'the {what} model takes params or a run dir, not both')
        if acoustic_dir:
            acoustic_params = ckpt.restore_acoustic_params(acoustic_dir)
        if vocoder_dir:
            gen_params = ckpt.restore_generator_params(vocoder_dir)
        devs = [resolve_device(d) for d in devices]
        self.device = devs[0]
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
        for module, tree, init, key in (
                (self.acoustic, acoustic_params, flax_acoustic_init, 0),
                (self.generator, gen_params, flax_vocoder_init, 1)):
            if tree is None:
                init(module, jax_random.prng_key(key))
            elif isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                                for v in tree.values()):
                module.load_state_dict(tree)
            else:
                load_flax(module, _weights(tree))
            module.eval().requires_grad_(False)
        # replica 0 is self; the others are shallow copies with their own
        # models and folded decoder weights (bf16), placed before replica 0
        # leaves the host
        self.replicas = [self] + [copy.copy(self) for _ in devs[1:]]
        for rep, dev in reversed(list(zip(self.replicas, devs))):
            rep.device = dev
            for name in ('acoustic', 'generator'):
                module = getattr(self, name)
                setattr(rep, name, (module if rep is self else copy.deepcopy(module)).to(dev))
            rep.decoder = fold_params(rep.acoustic.decoder_cell)
        self.dp = len(devs)
        # one long-lived thread per replica (each thread builds its own
        # cuDNN plans once)
        self._threads = ([ThreadPoolExecutor(1, thread_name_prefix=f'replica-{i}')
                          for i in range(self.dp)] if self.dp > 1 else [])

    def _map_rows(self, fn: Callable, *batched: torch.Tensor, split: bool = True) -> list:
        """``fn(replica, *chunk)`` for contiguous, equal row chunks of the
        batched tensors, one per replica on its thread (replica 0 alone on
        the calling thread when ``split`` is off or there is one replica);
        the lists it returns, concatenated in order."""
        if not split or self.dp == 1:
            return list(fn(self, *batched))
        chunks = zip(*(t.chunk(self.dp) for t in batched))
        futs = [pool.submit(tracing.bind(fn), rep, *c)
                for pool, rep, c in zip(self._threads, self.replicas, chunks)]
        return [x for f in futs for x in f.result()]

    # ------------------------------------------------------------------
    # Griffin-Lim phase generators
    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        """Per-request phase generator (thread-safe counter)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1000003 + next(self._count))
        return g

    def content_generator(self, data: bytes) -> torch.Generator:
        """Phase generator seeded from the request's content: the same
        payload always gives the same audio, however requests coalesce."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) | zlib.crc32(data))
        return g

    # ------------------------------------------------------------------
    # acoustic stage
    # ------------------------------------------------------------------
    def _pad_rows(self, b: int, rows: int = 1, split: bool = False) -> int:
        """Rows to allocate for ``b`` requests: the next power of two, and at
        least ``rows``.  A batching server passes its largest batch as
        ``rows``, so that every cohort runs at one shape and a row's result
        does not depend on how many requests shared its call (cuBLAS and
        cuDNN pick their algorithms by shape).  Split over the replicas,
        a multiple of their count."""
        return _round_up(1 << (max(b, rows) - 1).bit_length(), self.dp if split else 1)

    def _text_batch(self, pinyins: Sequence[str], rows: int = 1, split: bool = False):
        """pinyins -> text ids [B_pad, N_pad, 2] and lengths [B_pad] on the
        host; fill rows repeat row 0."""
        if not pinyins:
            raise ValueError('at least one input is required')
        seqs = [frontend.serialize_inference(p, self.cfg.acoustic.g2p) for p in pinyins]
        n_pad = _round_up(max(max(s.shape[0] for s in seqs), 1),
                          self.cfg.acoustic.text_bucket)
        b_pad = self._pad_rows(len(seqs), rows, split)
        text = np.zeros((b_pad, n_pad, 2), np.int64)
        lens = np.zeros((b_pad,), np.int64)
        for i in range(b_pad):
            s = seqs[i if i < len(seqs) else 0]
            text[i, :s.shape[0]] = s
            lens[i] = s.shape[0]
        return torch.from_numpy(text), torch.from_numpy(lens)

    @torch.no_grad()
    def _encode_batch(self, pinyins: Sequence[str], rows: int = 1):
        """pinyins -> attention keys, values and mask of the padded batch."""
        text, lens = self._text_batch(pinyins, rows)
        return self.acoustic(text.to(self.device), lens.to(self.device))

    def _encode(self, pinyin: str):
        return self._encode_batch([pinyin])

    @torch.no_grad()
    def _decode(self, enc):
        """The whole decode of every row in one kernel launch, each row
        stopping early on its own."""
        return fused_decode_full(self.decoder, enc['keys'], enc['values'],
                                 enc['mask'], self.max_iters, early_exit=True)

    @torch.no_grad()
    def _acoustic_rows(self, text: torch.Tensor, lens: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """Text ids and lengths -> the decode's outputs plus 'mag_outputs'
        [B, steps*r, F-1] (normalised), on this replica."""
        out = self._decode(self.acoustic(text.to(self.device), lens.to(self.device)))
        out['mag_outputs'] = posnet_apply(self.acoustic, out['mel_outputs'])
        return out

    def _acoustic_batch(self, pinyins: Sequence[str], rows: int = 1
                        ) -> Dict[str, torch.Tensor]:
        """pinyins -> ``_acoustic_rows`` of the padded batch on replica 0."""
        return self._acoustic_rows(*self._text_batch(pinyins, rows))

    def _natural_specs(self, out, b: int) -> List[np.ndarray]:
        """Natural-scale specs [F, T_i] of the first ``b`` rows, each
        trimmed to its stop and with its DC row restored."""
        au = self.cfg.audio
        lengths = out['out_lengths'][:b].tolist()
        mags = out['mag_outputs'][:b, :max(lengths)]
        nat = dsp.spec_to_natural_scale(mags, au).cpu()
        return [dsp.fix_zero_dc(nat[i, :t].T, au).numpy() for i, t in enumerate(lengths)]

    def _spec_chunk(self, text: torch.Tensor, lens: torch.Tensor) -> List[np.ndarray]:
        """Text ids and lengths -> the natural specs of every row, on this
        replica."""
        with tracing.span('acoustic.launch'):
            out = self._acoustic_rows(text, lens)
        with tracing.span('acoustic.sync') as sp:
            specs = self._natural_specs(out, text.shape[0])
            if sp is not None:
                r = self.cfg.acoustic.outputs_per_step
                sp.set(steps=[s.shape[1] // r for s in specs])
        return specs

    def _spec_rows(self, pinyins: List[str], rows: int, split: bool) -> List[np.ndarray]:
        with tracing.span('acoustic.text') as sp:
            text, lens = self._text_batch(pinyins, rows, split)
            if sp is not None:
                sp.set(rows=text.shape[0], real=len(pinyins), bucket=text.shape[1])
        specs = self._map_rows(Synthesizer._spec_chunk, text, lens, split=split)
        return specs[:len(pinyins)]

    def synthesize_spec_batch(self, pinyins: List[str], rows: int = 1) -> List[np.ndarray]:
        """Batched acoustic synthesis: one decode kernel launch for all
        requests (at least ``rows`` rows, see ``_pad_rows``) on each
        replica, each request trimmed by its own stop."""
        return self._spec_rows(pinyins, rows, split=True)

    def synthesize_spec(self, pinyin: str) -> np.ndarray:
        """Natural-scale spec [F, T] with DC restored, trimmed at the stop."""
        return self._spec_rows([pinyin], 1, split=False)[0]

    def synthesize_with_alignment(self, pinyin: str) -> Dict[str, Any]:
        """The spec [F, T], the decoder alignment [n_text, T // r] trimmed to
        the text length and the stop, and the frame count T."""
        out = self._acoustic_batch([pinyin])
        n = frontend.serialize_inference(pinyin, self.cfg.acoustic.g2p).shape[0]
        t_real = int(out['out_lengths'][0])
        r = self.cfg.acoustic.outputs_per_step
        return {'spec': self._natural_specs(out, 1)[0],
                'alignment': out['alignments'][0, :n, :t_real // r].cpu().numpy(),
                'n_frames': t_real}

    # ------------------------------------------------------------------
    # vocoders
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _template(self, s: torch.Tensor, theta=None, generator=None):
        """natural |STFT| [B, F, T] -> (log mel [B, M, T], Griffin-Lim
        template [B, hop * T]); phase from ``theta`` or one generator per
        row."""
        au = self.cfg.audio
        mel = torch.log(torch.clamp(dsp.mag_to_mel(s, au), min=dsp.EPS_AMP))
        log_mag = torch.log(torch.clamp(s, min=dsp.EPS_AMP))
        wavlen = au.hop_length * s.shape[-1]
        # length hop*T - 1 then pad 1 keeps the template's STFT at T frames
        tmpl = dsp.inv_log_mag(log_mag, au, length=wavlen - 1, theta=theta,
                               generator=generator)
        return mel, F.pad(tmpl, (0, 1))

    @torch.no_grad()
    def _generate(self, mel: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
        """Neural vocoder at ``infer_dtype``: mel [B, M, T], template
        [B, hop * T] -> float32 wav [B, hop * T]."""
        with compute_dtype(self.infer_dtype, self.device):
            wav = self.generator(mel.transpose(1, 2), tmpl[..., None])
        return wav[..., 0].float()

    def _vocode_natural(self, s: torch.Tensor, theta=None, generator=None) -> torch.Tensor:
        """natural |STFT| [B, F, T] -> wav [B, hop * T]."""
        return self._generate(*self._template(s, theta, generator))

    def tts_fused(self, pinyin: str, theta: Optional[torch.Tensor] = None
                  ) -> np.ndarray:
        """pinyin -> wav (float32) for one request; ``theta`` optionally
        pins the Griffin-Lim initial phase [n_freq, max_iters * r]."""
        au = self.cfg.audio
        out = self._acoustic_batch([pinyin])
        s = dsp.fix_zero_dc(dsp.spec_to_natural_scale(out['mag_outputs'][0].T, au), au)
        wav = self._vocode_natural(s[None], None if theta is None else theta[None],
                                   None if theta is not None else [self._generator()])
        return wav[0, :au.hop_length * int(out['out_lengths'][0])].cpu().numpy()

    def _bucket_spec(self, spec: np.ndarray, bucket: int = 64) -> np.ndarray:
        """Pad [F, T] to a frame bucket with near-silence; callers trim the
        wav back to the true length."""
        t = spec.shape[1]
        t_pad = _round_up(max(t, bucket), bucket)
        if t_pad == t:
            return spec
        pad = np.full((spec.shape[0], t_pad - t), float(spec.min()), spec.dtype)
        return np.concatenate([spec, pad], axis=1)

    def vocode_batch(self, specs: List[np.ndarray],
                     generators: Optional[Sequence[torch.Generator]] = None,
                     thetas: Optional[Sequence[Any]] = None,
                     rows: int = 1) -> List[np.ndarray]:
        """Natural-scale specs (either orientation) -> neural wavs: one
        Griffin-Lim template and one generator forward for the batch (at
        least ``rows`` rows, see ``_pad_rows``) on each replica.
        Specs pad to a common 64-frame bucket with their own near-silence
        and each wav trims back to its spec's length.  Each row's phase is
        drawn from ``generators[i]`` (on replica 0's device) or given as
        ``thetas[i]`` [n_freq, T_bucket]; by default from the request
        counter."""
        return self._vocode_rows(specs, generators, thetas, rows, split=True)

    def _vocode_rows(self, specs, generators, thetas, rows: int,
                     split: bool) -> List[np.ndarray]:
        if not specs:
            return []
        for name, per_row in (('generators', generators), ('thetas', thetas)):
            if per_row is not None and len(per_row) != len(specs):
                raise ValueError(f'{len(per_row)} {name} for {len(specs)} specs')
        au = self.cfg.audio
        with tracing.span('vocoder.prep') as sp:
            oriented = []
            for s in specs:
                s = np.asarray(s, np.float32)
                if s.shape[0] not in (au.n_freq, au.n_freq - 1):
                    s = s.T
                oriented.append(dsp.fix_zero_dc(
                    torch.from_numpy(np.ascontiguousarray(s)), au).numpy())
            t_real = [s.shape[1] for s in oriented]
            t_pad = _round_up(max(max(t_real), 64), 64)
            b = len(oriented)
            mags = np.zeros((self._pad_rows(b, rows, split), au.n_freq, t_pad), np.float32)
            for i, s in enumerate(oriented):
                mags[i, :, :s.shape[1]] = s
                mags[i, :, s.shape[1]:] = float(s.min())
            mags[b:] = mags[:1]                       # fill rows = real work
            if thetas is not None:
                theta = torch.stack([torch.as_tensor(t, dtype=torch.float32)
                                     for t in thetas]).to(self.device)
            else:
                gens = generators if generators is not None else [
                    self._generator() for _ in range(b)]
                theta = dsp.random_phase((b, au.n_freq, t_pad), gens, self.device)
            theta = torch.cat([theta, theta[:1].expand(mags.shape[0] - b, -1, -1)])
            if sp is not None:
                sp.set(rows=mags.shape[0], real=b, bucket=t_pad, frames=t_real)
        wavs = self._map_rows(Synthesizer._vocode_chunk, torch.from_numpy(mags), theta,
                              split=split)
        return [wavs[i][:au.hop_length * t_real[i]] for i in range(b)]

    def _vocode_chunk(self, mags: torch.Tensor, theta: torch.Tensor) -> List[np.ndarray]:
        """Padded natural specs and phases -> wavs as numpy, on this replica."""
        with tracing.span('vocoder.prep'):
            mags, theta = mags.to(self.device), theta.to(self.device)
        with tracing.span('vocoder.launch'):
            wav = self._vocode_natural(mags, theta)
        with tracing.span('vocoder.sync'):
            return wav.cpu().numpy()

    def vocode(self, spec: np.ndarray, theta: Optional[torch.Tensor] = None
               ) -> np.ndarray:
        """Natural-scale spec (either orientation) -> neural wav."""
        return self._vocode_rows([spec], None, None if theta is None else [theta], 1,
                                 split=False)[0]

    def _griffin_lim(self, spec: np.ndarray, theta=None) -> np.ndarray:
        """natural spec [F, T] -> the acoustic service's Griffin-Lim wav
        [hop * (T - 1)] on the host."""
        s = torch.from_numpy(np.ascontiguousarray(spec, np.float32)).to(self.device)
        return dsp.inv_spec_acoustic(
            s, self.cfg.audio, theta=theta,
            generator=None if theta is not None else self._generator()).cpu().numpy()

    def _gl_wav(self, spec: np.ndarray, trim: bool = True, theta=None) -> np.ndarray:
        """natural spec [F, T] -> Griffin-Lim wav over the 64-frame bucket
        (``theta`` [n_freq, T_bucket]), cut to hop * T, silence-trimmed."""
        t_real = spec.shape[1]
        wav = self._griffin_lim(self._bucket_spec(spec), theta)
        wav = wav[:self.cfg.audio.hop_length * t_real]
        return features.trim_silence(wav, self.cfg.audio) if trim else wav

    def synthesize_wav(self, pinyin: str, trim: bool = True,
                       theta: Optional[torch.Tensor] = None) -> np.ndarray:
        """Internal Griffin-Lim vocoding (reference ``synth.py:80-83``)."""
        return self._gl_wav(self.synthesize_spec(pinyin), trim, theta)

    # ------------------------------------------------------------------
    # text surfaces
    # ------------------------------------------------------------------
    def clauses(self, text: str) -> List[str]:
        """Numbered pinyin as one clause; kanji normalised, clause-split and
        converted by the pinyin provider."""
        if frontend.looks_like_pinyin(text):
            return [text.strip().lower()]
        return [self.kanji2pinyin(s) for s in frontend.normalize_text(text)]

    def tts_batch(self, texts: List[str], neural: bool = True,
                  generators: Optional[Sequence[torch.Generator]] = None,
                  thetas: Optional[Sequence[Any]] = None) -> List[np.ndarray]:
        """Batched text -> wav: one decode launch for all texts (each text's
        clauses joined into one utterance), then one vocoder batch, or a
        Griffin-Lim wav per text (``thetas[i]`` [n_freq, T_bucket])."""
        specs = self.synthesize_spec_batch([' '.join(self.clauses(t)) for t in texts])
        if neural:
            return self.vocode_batch(specs, generators, thetas)
        return [self._gl_wav(s, theta=None if thetas is None else thetas[i])
                for i, s in enumerate(specs)]

    def tts(self, text: str, neural: bool = True,
            theta: Optional[torch.Tensor] = None) -> np.ndarray:
        """Text (numbered pinyin, or kanji with a pinyin provider) -> wav.
        One neural clause takes ``tts_fused``; several are synthesized one
        by one and vocoded together; ``neural=False`` vocodes with
        Griffin-Lim and trims the silence."""
        clauses = self.clauses(text)
        if neural and len(clauses) == 1:
            return self.tts_fused(clauses[0], theta)
        spec = np.concatenate([self.synthesize_spec(p) for p in clauses], axis=1)
        if neural:
            return self.vocode(spec, theta)
        return features.trim_silence(self._griffin_lim(spec, theta), self.cfg.audio)
