"""Evaluation metrics, ported from
``transtacos_retunegan_tpu/eval/metrics.py`` (numpy): so far only the
prosody accuracy the acoustic trainer logs."""

from __future__ import annotations

import numpy as np


def prds_accuracy(prds_true: np.ndarray, prds_pred: np.ndarray,
                  text_lengths: np.ndarray) -> float:
    """Fraction of the valid text positions (pos < text_length per row)
    where the predicted prosody mark equals the label."""
    prds_true = np.asarray(prds_true)
    prds_pred = np.asarray(prds_pred)
    lens = np.asarray(text_lengths)
    mask = np.arange(prds_true.shape[-1])[None, :] < lens[:, None]
    n = mask.sum()
    if n == 0:
        return 0.0
    return float(((prds_true == prds_pred) & mask).sum() / n)
