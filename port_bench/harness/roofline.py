"""Peaks, FLOP counting and the decode kernel's roofline.

* ``PEAKS``: NVIDIA's published dense rates of one H100 SXM at its 700 W
  limit (989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
  3.35 TB/s HBM).  A run prints the card's ``power.limit`` beside them.
* ``counted_flops``: a frozen copy of
  ``transtacos_retunegan_tpu_torch/tools/train_scaling.py::counted_flops``
  (lines 61-66; verdict: sound arithmetic, wrong time base there, since it
  times the minimum of trials: here the FLOPs are divided by the whole
  window).  It counts matrix products and convolutions only.
* ``step_cost`` / ``bound``: frozen copies of ``chip_smoke.py::step_cost``
  and ``::bound`` (lines 543-566; verdict: sound), with the kernel's weight
  counts worked out from the configuration's widths instead of read from
  the program's packed operands, and ``steps`` the steps the rows really
  take (with early exit, not ``max_iters``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

PEAKS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def counted_flops(call: Callable[[], object]) -> int:
    """The matrix-product and convolution FLOPs of one ``call()``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        call()
    return counter.get_total_flops()


class Dims(NamedTuple):
    n_mel: int
    d: int          # encoder depth (context width)
    h: int          # decoder depth
    a: int          # attention depth
    r: int          # outputs per step
    kwin: int       # location conv width
    prenet: Tuple[int, ...]
    n_gru: int


def decoder_dims(cfg) -> Dims:
    hp = cfg.acoustic
    return Dims(cfg.audio.n_mel, hp.encoder_depth, hp.decoder_depth, hp.attention_depth,
                hp.outputs_per_step, 31, tuple(hp.prenet_depths), hp.decoder_layers)


def matmul_weights(d: Dims) -> int:
    """Elements of the decode step's matrices: prenet, input projection,
    the GRUs' input and hidden kernels, query, frame and stop heads."""
    sizes = (d.n_mel,) + d.prenet
    pre = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return (pre + (d.prenet[-1] + d.d) * d.h + d.n_gru * 2 * d.h * 3 * d.h + d.h * d.a
            + (d.h + d.d) * (d.r * d.n_mel + d.r))


def vector_floats(d: Dims) -> int:
    """Elements of the step's float32 vectors and location matrix."""
    return (sum(d.prenet) + d.h + d.n_gru * 4 * d.h + d.kwin * d.a + 2 * d.a
            + d.r * d.n_mel + d.r)


def step_cost(d: Dims, b: int, n: int) -> Tuple[int, int]:
    """(matmul operations, other operations) of one decode step."""
    mm = 2 * b * matmul_weights(d)
    other = b * (n * (2 * d.kwin * d.a + 4 * d.a + 2 * d.d + 6)
                 + 12 * d.n_gru * d.h + 2 * d.r * (d.n_mel + 1))
    return mm, other


def bound(d: Dims, b: int, n: int, steps: int, weight_bytes: int = 2,
          carry_bytes: int = 0) -> Tuple[float, str]:
    """Least time on the card: every input read once and every output
    written once over the memory rate, or the operations over the peak rate
    of their type, whichever is larger.  Returns (ms, 'bytes'|'operations')."""
    io_bytes = (matmul_weights(d) * weight_bytes + vector_floats(d) * 4
                + 4 * b * n * (d.a + d.d + 1)                      # keys, values, mask
                + 4 * steps * b * (d.r * d.n_mel + d.r + n + 1)    # emissions
                + carry_bytes)
    mm, other = step_cost(d, b, n)
    mm_peak = PEAKS['bfloat16' if weight_bytes == 2 else 'float32']
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = steps * (mm / mm_peak + other / PEAKS['float32'])
    return (1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def mfu(flops: float, seconds: float, dtype: str) -> float:
    """Percent of the card's published peak for ``dtype``."""
    return 100.0 * flops / seconds / PEAKS[dtype]


def describe_peaks() -> Dict[str, float]:
    return dict(PEAKS, hbm_bytes_per_s=HBM_BYTES_PER_S)
