"""Learning-rate and teacher-forcing schedules of acoustic training,
ported from ``transtacos_retunegan_tpu/train/schedules.py`` (host floats:
the step is a host integer).

* Noam decay with a warm-up: ``lr * w^0.5 * min((s+1) * w^-1.5, (s+1)^-0.5)``.
* Teacher forcing: ``tf_init`` until ``tf_start_decay``, then a cosine to 0
  over ``tf_decay`` steps.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import AcousticConfig


def noam_lr(step: int, cfg: AcousticConfig) -> float:
    """The rate of the update made at ``step`` (counted from 0)."""
    if not cfg.decay_learning_rate:
        return float(cfg.initial_learning_rate)
    w = float(cfg.warmup_steps)
    s = np.float32(step + 1)
    return float(np.float32(cfg.initial_learning_rate * w ** 0.5)
                 * min(s * np.float32(w ** -1.5), s ** np.float32(-0.5)))


def teacher_forcing_ratio(step: int, cfg: AcousticConfig) -> float:
    if step < cfg.tf_start_decay:
        return float(cfg.tf_init)
    t = np.float32(min(max(step - cfg.tf_start_decay, 0), cfg.tf_decay))
    return float(np.float32(cfg.tf_init * 0.5)
                 * (np.float32(1.0) + np.cos(np.float32(math.pi) * t / np.float32(cfg.tf_decay))))
