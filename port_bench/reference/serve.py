"""The plain float32 reference of one served request: text -> wav.

It follows what ``transtacos_retunegan_tpu_torch/serve/pipeline.py`` and
``serve/batcher.py`` do for a ``BatchingFrontend.tts`` request, worked out
again from the text, the weights and the seed alone: the text's ids padded
to its text bucket, the encoder, the stepped decoder cell
(``models/decoder.py``'s plain step, no kernel): once to its own stop
(``own_steps``, which judges the served stop) and once for as many steps
as the served answer took (``spec``, so that the two wavs have one
length), the posnet, the natural scale with its DC row, the spec padded to its 64-frame bucket with its own
minimum, the Griffin-Lim phase drawn from the request's content
(``Synthesizer.content_generator``: ``(seed << 32) | crc32(text)``), the
4-iteration template and the generator, all in float32 with TF32 off, one
request at a time.  ``lower`` computes the same in a lower precision, as
the controls that the limits are set against:

* ``'fp8'``: every weight matrix, and the input of every module that holds
  one, through float8 e4m3 with a per-tensor scale (the step below the
  served bf16; the control that has to fail the comparison);
* ``'bf16'``: the same through bfloat16, and the DSP's spec, mel, log
  magnitude and template too: the stages that the configuration runs in
  float32 (encoder, posnet, DSP) one step lower than that, the decode and
  the generator at their served precision;
* ``'bf16_served'``: only the decoder cell and the generator through
  bfloat16, the rest float32: the yardstick of the wav comparison (what
  rounding at the served precision moves the wav); run under TF32 (the
  caller's flags), the float32 stages' own next step down.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .audio import dsp
from .config import Config
from .models.acoustic import Tacotron, posnet_apply
from .models.decoder import AttentionParams, init_carry
from .models.generators import make_generator
from .text import frontend

FP8_MAX = 448.0


def round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


def plain_float32() -> None:
    """float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(v: torch.Tensor) -> torch.Tensor:
    """``v`` through float8 e4m3 and back, scaled per tensor to its largest
    magnitude."""
    s = v.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (v / s).to(torch.float8_e4m3fn).to(v.dtype) * s


def bf16(v: torch.Tensor) -> torch.Tensor:
    """``v`` through bfloat16 and back."""
    return v.to(torch.bfloat16).to(v.dtype)


def quantized(state: Dict[str, torch.Tensor], low=fp8,
              keep=lambda k: True) -> Dict[str, torch.Tensor]:
    """Every matrix and convolution weight whose key ``keep`` takes
    through ``low``."""
    return {k: low(v) if v.is_floating_point() and v.dim() >= 2 and keep(k) else v
            for k, v in state.items()}


def lowered_inputs(model: torch.nn.Module, low=fp8) -> None:
    """The floating input of every module that holds a matrix or
    convolution weight of its own goes through ``low`` first."""
    def hook(module, args):
        if args and torch.is_tensor(args[0]) and args[0].is_floating_point():
            return (low(args[0]),) + tuple(args[1:])
        return None
    for m in model.modules():
        if any(p.dim() >= 2 for p in m.parameters(recurse=False)):
            m.register_forward_pre_hook(hook)


class Reference:
    """The acoustic model and the generator of one configuration, float32."""

    def __init__(self, cfg: Config, acoustic: Dict[str, torch.Tensor],
                 generator: Dict[str, torch.Tensor], device, seed: int,
                 lower: Optional[str] = None):
        plain_float32()
        self.cfg, self.device, self.seed = cfg, torch.device(device), int(seed)
        low = fp8 if lower == 'fp8' else bf16
        served = lower == 'bf16_served'
        self.low = bf16 if lower == 'bf16' else (lambda v: v)   # the DSP's stages
        acoustic = {k: v.float() for k, v in acoustic.items()}
        generator = {k: v.float() for k, v in generator.items()}
        if lower:
            acoustic = quantized(acoustic, low, (lambda k: k.startswith('decoder_cell.'))
                                 if served else (lambda k: True))
            generator = quantized(generator, low)
        self.acoustic = Tacotron(cfg)
        self.acoustic.load_state_dict(acoustic)
        self.generator = make_generator(cfg)
        self.generator.load_state_dict(generator)
        for m in (self.acoustic, self.generator):
            m.to(self.device).eval().requires_grad_(False)
        if lower:
            for m in ((self.acoustic.decoder_cell, self.generator) if served
                      else (self.acoustic, self.generator)):
                lowered_inputs(m, low)

    # -- acoustic ------------------------------------------------------------
    def text_ids(self, text: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids [1, N_bucket, 2] and length [1], as ``Synthesizer._text_batch``."""
        seq = frontend.serialize_inference(text.strip().lower(), self.cfg.acoustic.g2p)
        n_pad = round_up(max(seq.shape[0], 1), self.cfg.acoustic.text_bucket)
        ids = np.zeros((1, n_pad, 2), np.int64)
        ids[0, :seq.shape[0]] = seq
        return (torch.from_numpy(ids).to(self.device),
                torch.tensor([seq.shape[0]], device=self.device))

    @torch.no_grad()
    def encode(self, text: str) -> Dict[str, torch.Tensor]:
        """The attention keys, masked values and mask of one text."""
        return self.acoustic(*self.text_ids(text))

    @torch.no_grad()
    def decode(self, enc, max_steps: int, stop: bool = True):
        """The stepped decoder cell from the encoder's keys, values and mask:
        frames ``[steps, r*M]`` (frame projections), stop probabilities
        ``[steps * r]`` and the frame count up to and including the stop
        step (``max_steps * r`` if it never stops); with ``stop`` the loop
        ends at the stop."""
        cell = self.acoustic.decoder_cell
        attn = AttentionParams(enc['keys'], enc['values'], enc['mask'])
        carry = init_carry(1, attn.mask.shape[1], self.cfg, self.device)
        frames, probs, stop_step = [], [], None
        for t in range(max_steps):
            carry, f, s, _ = cell.step(carry, attn)
            frames.append(f[0])
            probs.append(s[0])
            if stop_step is None and bool(carry[-1][0]):
                stop_step = t + 1
                if stop:
                    break
        r = self.cfg.acoustic.outputs_per_step
        n = (stop_step or max_steps) * r
        return torch.stack(frames), torch.cat(probs), n

    @torch.no_grad()
    def own_steps(self, text: str) -> int:
        """The steps of this text's decode up to and including its stop
        (``max_iters`` if it never stops)."""
        r = self.cfg.acoustic.outputs_per_step
        return self.decode(self.encode(text), self.cfg.acoustic.max_iters)[2] // r

    @torch.no_grad()
    def spec(self, text: str, steps: int) -> torch.Tensor:
        """The natural-scale spec [F, steps * r] with its DC row: the
        decode run for ``steps`` steps whatever its stop logits say (a
        served answer's own length), then the posnet."""
        proj = self.acoustic.decoder_cell.stop_projection
        bias = proj.bias.clone()
        with torch.no_grad():
            proj.bias.fill_(-1e4)
        try:
            frames, _, _ = self.decode(self.encode(text), steps, stop=False)
        finally:
            with torch.no_grad():
                proj.bias.copy_(bias)
        au = self.cfg.audio
        mel = frames.reshape(1, -1, au.n_mel)
        mag = posnet_apply(self.acoustic, mel)
        nat = self.low(dsp.spec_to_natural_scale(self.low(mag), au))
        return dsp.fix_zero_dc(nat[0].T, au)

    # -- vocoder -------------------------------------------------------------
    def phase(self, text: str, t_pad: int) -> torch.Tensor:
        data = ' '.join([text.strip().lower()]).encode('utf-8')
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) | zlib.crc32(data))
        return 2.0 * np.pi * torch.rand((self.cfg.audio.n_freq, t_pad), generator=g,
                                        device=self.device)

    @torch.no_grad()
    def vocode(self, spec: torch.Tensor, text: str) -> torch.Tensor:
        """spec [F, T] -> wav [hop * T]: padded to its 64-frame bucket with its
        own minimum, template from the content-seeded phase, generator."""
        au = self.cfg.audio
        t = spec.shape[1]
        t_pad = round_up(max(t, 64), 64)
        mags = torch.cat([spec, spec.min().expand(spec.shape[0], t_pad - t)], 1)[None]
        mel = self.low(torch.log(torch.clamp(dsp.mag_to_mel(mags, au), min=dsp.EPS_AMP)))
        log_mag = self.low(torch.log(torch.clamp(mags, min=dsp.EPS_AMP)))
        tmpl = dsp.inv_log_mag(log_mag, au, length=au.hop_length * t_pad - 1,
                               theta=self.phase(text, t_pad)[None])
        tmpl = self.low(F.pad(tmpl, (0, 1)))
        wav = self.generator(mel.transpose(1, 2), tmpl[..., None])[..., 0]
        return wav[0, :au.hop_length * t]

    def tts(self, text: str, steps: int) -> np.ndarray:
        """The wav (float32, on the host) of ``text`` decoded for ``steps``
        steps."""
        return self.vocode(self.spec(text, steps), text).float().cpu().numpy()

    def set_stop(self, ws: torch.Tensor, bias: float) -> None:
        """The fitted stop head: weights [H+D, r], one bias."""
        proj = self.acoustic.decoder_cell.stop_projection
        with torch.no_grad():
            proj.weight.copy_(ws.t())
            proj.bias.fill_(bias)


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """||got - ref|| / ||ref||, in float64."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
