"""Spectrogram figure for TensorBoard, ported from
``transtacos_retunegan_tpu/utils/plotting.py``; matplotlib is imported when
a figure is drawn, so the port runs where it is missing."""

from __future__ import annotations

import numpy as np


def spectrogram_figure(spec: np.ndarray):
    """Single-spec matplotlib figure [F, T]."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(spec), aspect='auto', origin='lower',
                   interpolation='none')
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig
