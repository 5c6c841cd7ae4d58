"""The copied roofline and FLOP arithmetic against hand counts."""

import pytest
import torch

from port_bench.harness import roofline
from port_bench.reference.config import Config


def test_decoder_weights_by_hand():
    """Prenet 80x256, input projection (256+256)x512, two GRUs of
    512x1536 input and hidden kernels, query 512x128, frame and stop heads
    768x(400+5): the default configuration's decode step."""
    d = roofline.decoder_dims(Config())
    hand = 80 * 256 + 512 * 512 + 2 * 2 * 512 * 1536 + 512 * 128 + 768 * 405
    assert roofline.matmul_weights(d) == hand
    mm, other = roofline.step_cost(d, 8, 32)
    assert mm == 2 * 8 * hand
    assert other == 8 * (32 * (2 * 31 * 128 + 4 * 128 + 2 * 256 + 6)
                         + 12 * 2 * 512 + 2 * 5 * 81)


def test_port_packs_the_same_weights():
    """The kernel's packed operands hold exactly the counted matrices."""
    from transtacos_retunegan_tpu_torch.config import Config as PConfig
    from transtacos_retunegan_tpu_torch.models.decoder import DecoderCell
    from transtacos_retunegan_tpu_torch.ops.fused_decoder import fold_params
    fp = fold_params(DecoderCell(PConfig()))
    assert sum(t.numel() for t in fp.w.values()) == roofline.matmul_weights(
        roofline.decoder_dims(Config()))


def test_bound_by_hand():
    d = roofline.decoder_dims(Config())
    steps, b, n = 60, 8, 48
    ms, by = roofline.bound(d, b, n, steps)
    io = (roofline.matmul_weights(d) * 2 + roofline.vector_floats(d) * 4
          + 4 * b * n * (128 + 256 + 1) + 4 * steps * b * (400 + 5 + n + 1))
    mm, other = roofline.step_cost(d, b, n)
    t_ops = steps * (mm / 989e12 + other / 67e12)
    assert ms == pytest.approx(1e3 * max(io / 3.35e12, t_ops))
    assert by == ('bytes' if io / 3.35e12 >= t_ops else 'operations')


def test_counted_flops_by_hand():
    lin = torch.nn.Linear(64, 32, bias=False)
    assert roofline.counted_flops(lambda: lin(torch.zeros(10, 64))) == 2 * 10 * 64 * 32
    conv = torch.nn.Conv1d(4, 8, 3, padding=1, bias=False)
    assert roofline.counted_flops(lambda: conv(torch.zeros(2, 4, 100))) == 2 * 2 * 8 * 100 * 4 * 3


def test_mfu_percent():
    assert roofline.mfu(989e12, 2.0, 'bfloat16') == pytest.approx(50.0)
    assert roofline.mfu(67e12, 1.0, 'float32') == pytest.approx(100.0)
