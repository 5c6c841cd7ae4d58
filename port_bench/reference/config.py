"""Unified configuration for the TransTacoS + RetuneGAN stack (PyTorch port).

A copy of ``transtacos_retunegan_tpu/config.py``: the port keeps its own so
that it never imports the JAX package.  Field names, defaults and the JSON
layout are identical, so a ``config.json`` saved by either package loads in
the other.

The reference keeps two hand-synchronized ``hparam.py`` modules (one per model;
``retunegan/hparam.py:1`` literally says "proxy by trastacos, plz keep sync")
plus argparse CLIs and Makefiles.  Here everything lives in one place:

* ``AudioConfig``   -- the shared audio-geometry block (reference:
  ``transtacos/hparam.py:5-32`` == ``retunegan/hparam.py:3-30``).
* ``AcousticConfig`` -- TransTacoS model/training knobs
  (``transtacos/hparam.py:34-96``).
* ``VocoderConfig``  -- RetuneGAN model/loss/training knobs
  (``retunegan/hparam.py:34-118``).
* ``Config``         -- the bundle, JSON-serializable.  ``Config.save`` /
  ``Config.load`` reproduce the reference's freeze-config-into-run-dir
  behavior (``retunegan/train.py:37`` copies hparam.py; ``infer.py:74-75``
  re-imports it from the run dir).

Everything is a frozen dataclass (hashable, immutable).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Tuple


def _midi_from_hz(hz: float) -> float:
    return 12.0 * (math.log2(hz) - math.log2(440.0)) + 69.0


def _hz_from_note(note: str) -> float:
    """Scientific pitch notation -> Hz (equal temperament, A4=440)."""
    names = {'C': 0, 'D': 2, 'E': 4, 'F': 5, 'G': 7, 'A': 9, 'B': 11}
    pitch = names[note[0].upper()]
    rest = note[1:]
    while rest and rest[0] in '#b♯♭!':
        pitch += 1 if rest[0] in '#♯' else -1
        rest = rest[1:]
    octave = int(rest)
    midi = 12 * (octave + 1) + pitch
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


@dataclass(frozen=True)
class AudioConfig:
    """Shared audio geometry (reference ``transtacos/hparam.py:5-32``)."""

    sample_rate: int = 22050
    n_fft: int = 2048
    win_length: int = 1024
    hop_length: int = 256
    n_mel: int = 80
    n_freq: int = 1025            # n_fft // 2 + 1
    preemphasis: float = 0.97
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    max_abs_value: float = 4.0
    trim_below_peak_db: float = 35.0
    fmin: float = 125.0
    fmax: float = 7600.0
    rf0min: str = 'D2'            # pitch-tracking search range (note names)
    rf0max: str = 'D5'

    # corpus statistics used for f0/c0 quantization
    # (reference ``transtacos/hparam.py:22-25`` == ``stats/DataBaker.stats``)
    c0min: float = 4.6309418394230306e-05
    c0max: float = 0.3751049339771271
    f0min: float = 73.25581359863281
    f0max: float = 595.9459228515625
    n_tone: int = 6
    n_prds: int = 6
    n_c0_bins: int = 32
    maxlen_text: int = 128
    maxlen_spec: int = 1024

    # vocoder-side additions (reference ``retunegan/hparam.py:34-41``)
    segment_size: int = 8192
    window_fn: str = 'hann'
    mel_scale: str = 'slaney'
    # Griffin-Lim: acoustic flavor (30 iters, no momentum,
    # ``transtacos/hparam.py:90-91``) vs vocoder-template flavor
    # (4 iters, momentum .7, ``retunegan/hparam.py:38-40``)
    gl_iters_acoustic: int = 30
    gl_iters_vocoder: int = 4
    gl_momentum: float = 0.7
    gl_power: float = 1.2
    ref_wav: str = 'y'            # ['y', 'dy']
    postprocess: bool = False

    randseed: int = 114514

    # --- derived (match ``transtacos/audio.py:15-23``) ---
    @property
    def rf0min_hz(self) -> float:
        return _hz_from_note(self.rf0min)

    @property
    def rf0max_hz(self) -> float:
        return _hz_from_note(self.rf0max)

    @property
    def n_f0_min(self) -> int:
        """MIDI offset of the lowest f0 quantization bin."""
        return int(math.floor(_midi_from_hz(self.f0min)))

    @property
    def n_f0_bins(self) -> int:
        return int(math.ceil(_midi_from_hz(self.f0max))) - self.n_f0_min + 1

    @property
    def frames_per_segment(self) -> int:
        assert self.segment_size % self.hop_length == 0
        return self.segment_size // self.hop_length


@dataclass(frozen=True)
class AcousticConfig:
    """TransTacoS model + training knobs (reference ``transtacos/hparam.py:34-96``)."""

    g2p: str = 'syl4'             # ['seq', 'syl4']

    # model
    outputs_per_step: int = 5     # reduction factor r
    hidden_gauss_std: float = 1e-5
    embed_depth: int = 256
    var_embed_depth: int = 64
    posenc_depth: int = 32
    txt_use_posenc: bool = True
    var_use_posenc: bool = True
    prdsnet_depth: int = 64
    prdsnet_conv_k: int = 9
    embed_dropout: bool = False

    encoder_depth: int = 256
    encoder_type: str = 'sa'      # ['sa', 'cb']
    encoder_attn_layers: int = 2
    encoder_attn_nhead: int = 2
    encoder_dropout: bool = False
    encoder_fusenet: bool = True
    gffw_conv_k: int = 9
    var_prednet_depth: int = 64
    var_prednet_conv_k: int = 13
    encoder_conv_K: int = 16      # for 'cb' encoder
    highway_layers: int = 4

    decoder_layers: int = 2
    decoder_depth: int = 512
    attention_depth: int = 128
    prenet_depths: Tuple[int, ...] = (256,)
    decoder_sew_layer: bool = False

    n_mel_low: int = 42
    posnet_depth: int = 512
    posnet_ngroup: int = 8

    # training (reference ``transtacos/hparam.py:72-86``)
    max_steps: int = 320000
    max_ckpt: int = 1
    batch_size: int = 16
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-7
    reg_weight: float = 1e-6
    sim_weight: float = 1e-5
    initial_learning_rate: float = 1e-3
    decay_learning_rate: bool = True
    warmup_steps: int = 4000
    tf_method: str = 'mix'        # ['random', 'mix', 'force']
    tf_init: float = 1.0
    tf_start_decay: int = 20000
    tf_decay: int = 200000
    grad_clip_norm: float = 1.0

    # eval (reference ``transtacos/hparam.py:88-92``)
    max_iters: int = 300          # max AR decode steps (frames = r * max_iters)

    # static-shape bucketing (text padded to a multiple of text_bucket)
    text_bucket: int = 16         # pad text length up to a multiple of this
    frame_bucket: int = 80        # pad spec frames up to a multiple of this (mult of r)
    remat_decoder: bool = True    # rematerialize decoder steps in backward
    scan_unroll: int = 1          # unroll factor of the decode scan
    fast_cell: bool = False       # fused-layout decoder cell (exact same
                                  # math, fewer kernels/step; decoder_fast.py)


@dataclass(frozen=True)
class VocoderConfig:
    """RetuneGAN knobs (reference ``retunegan/hparam.py:44-118``)."""

    generator_ver: str = 'RefineGAN_small'
    upsample_rates: Tuple[int, ...] = (8, 8, 4)
    upsample_kernel_sizes: Tuple[int, ...] = (15, 15, 7)
    upsample_initial_channel: int = 256
    resblock_kernel_sizes: Tuple[int, ...] = (3, 5, 7)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 2), (2, 6), (3, 12))

    # discriminators (reference ``retunegan/hparam.py:69-83``)
    msd_layers: int = 3
    mpd_periods: Tuple[int, ...] = (3, 5, 7, 11)
    multi_stft_params: Tuple[Tuple[int, int, int], ...] = (
        (2048, 1024, 240),
        (1024, 512, 120),
        (512, 256, 60),
    )
    phd_input: str = 'stft'       # ['phase', 'stft']
    # channel-width multiplier for all discriminators (1.0 = reference
    # widths).  Small power-of-two fractions (0.5, 0.25, 0.125) shrink the
    # D stacks for dry-runs/CI so the jitted GAN step compiles in seconds
    # on a virtual CPU mesh instead of minutes.
    disc_width_mult: float = 1.0

    # loss switches (reference ``retunegan/hparam.py:85-91``)
    relative_gan_loss: bool = False
    strip_mirror_loss: bool = False
    dynamic_loss: bool = True
    envelope_loss: bool = False
    envelope_pool_k: int = 160
    downsample_pool_k: int = 4

    # training (reference ``retunegan/hparam.py:100-114``)
    num_workers: int = 4
    batch_size: int = 16
    learning_rate_d: float = 2e-4
    learning_rate_g: float = 1.8e-4
    d_train_times: int = 2
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999       # per-epoch exponential decay
    w_loss_fm: float = 2.0
    w_loss_mstft: float = 8.0
    w_loss_env: float = 4.0
    w_loss_dyn: float = 4.0
    w_loss_sm: float = 0.01
    lrelu_slope: float = 0.15     # reference ``retunegan/utils.py:11``
    # optional G/D global-norm gradient clip; 0 = off (reference has none).
    # A stability guard for corpora where the discriminators saturate early.
    grad_clip_norm: float = 0.0
    # optional R1 gradient penalty weight on real data; 0 = off (reference
    # semantics).  The principled stabilizer when the Ds separate real/fake
    # early (small corpora): gamma/2 * E||grad_x D(x)||^2.
    r1_gamma: float = 0.0
    # conv compute precision: 'float32' (reference semantics, default) or
    # 'bfloat16' (f32 weight-norm math, bf16 conv stacks --
    # models/precision.py).  Serving is governed separately by
    # ``Synthesizer(infer_dtype=...)``.
    compute_dtype: str = 'float32'

    @property
    def split_cv(self) -> bool:
        return self.generator_ver.endswith('Split')

    @property
    def valid_limit(self) -> int:
        return self.batch_size * 4


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    acoustic: AcousticConfig = field(default_factory=AcousticConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, run_dir: str, name: str = 'config.json') -> str:
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, name)
        with open(path, 'w') as fh:
            json.dump(self.to_dict(), fh, indent=2)
        return path

    @classmethod
    def prod(cls) -> 'Config':
        """Production recipe of the JAX package: batch 64 for both
        models and R1 weight 0.5 on the GAN step (kept so that a
        ``config.json`` naming ``prod`` loads identically)."""
        base = cls()
        return cls(
            audio=base.audio,
            acoustic=dataclasses.replace(base.acoustic, batch_size=64),
            vocoder=dataclasses.replace(base.vocoder, batch_size=64,
                                        r1_gamma=0.5),
        )

    @classmethod
    def load(cls, path: str) -> 'Config':
        if path in PRESETS:
            return PRESETS[path]()
        if os.path.isdir(path):
            path = os.path.join(path, 'config.json')
        with open(path) as fh:
            d = json.load(fh)

        def _mk(klass, dd):
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in dd.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                kwargs[k] = v
            return klass(**kwargs)

        return cls(audio=_mk(AudioConfig, d.get('audio', {})),
                   acoustic=_mk(AcousticConfig, d.get('acoustic', {})),
                   vocoder=_mk(VocoderConfig, d.get('vocoder', {})))


DEFAULT = Config()

# named presets accepted anywhere a --config path is: ``--config prod``
PRESETS = {
    'default': Config,
    'prod': Config.prod,
}
