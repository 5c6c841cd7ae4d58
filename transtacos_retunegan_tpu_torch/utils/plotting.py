"""Alignment and spectrogram figures, ported from
``transtacos_retunegan_tpu/utils/plotting.py``; matplotlib is imported when
a figure is drawn, so the port runs where it is missing (the caller then
gets the ``ImportError``, or ``save_figure`` skips the figure)."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def plot_alignment(alignment: np.ndarray, path: str, info: str = '') -> None:
    """alignment: [N_text, T_dec]."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect='auto', origin='lower',
                   interpolation='none')
    fig.colorbar(im, ax=ax)
    ax.set_xlabel('decoder step' + (f'\n{info}' if info else ''))
    ax.set_ylabel('encoder step')
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_specs(specs, path: str, titles=None) -> None:
    """2x2 heatmap grid of spectrograms [F, T] (reference utils.py:55-65)."""
    plt = _pyplot()
    n = len(specs)
    rows = cols = 2 if n > 1 else 1
    fig, axes = plt.subplots(rows, cols, figsize=(10, 8), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i < n:
            ax.imshow(np.asarray(specs[i]), aspect='auto', origin='lower')
            if titles and i < len(titles):
                ax.set_title(titles[i])
        else:
            ax.axis('off')
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def spectrogram_figure(spec: np.ndarray):
    """Single-spec matplotlib figure [F, T]."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(spec), aspect='auto', origin='lower',
                   interpolation='none')
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def save_figure(draw, *args, **kwargs) -> bool:
    """``draw(*args, **kwargs)`` (one of the functions above, or a tool's
    own); where matplotlib is missing, print that the figure was skipped
    and return False (the caller's numbers are written all the same)."""
    try:
        draw(*args, **kwargs)
    except ImportError:
        print(f'# figure skipped ({getattr(draw, "__name__", draw)}): matplotlib is '
              'not installed', flush=True)
        return False
    return True
