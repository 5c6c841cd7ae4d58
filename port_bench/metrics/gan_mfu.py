"""Matmul and convolution FLOPs of one GAN step, forward and backward
(``FlopCounterMode`` on the reference step at the cell's shapes), times the
steps completed in the window, over the window, over the card's published
float32 peak (67 TFLOP/s: the trainer runs float32 with TF32 off; the
power limit is printed on an earlier line)."""

from port_bench.harness import roofline


def read(record):
    flops = record.extra.get('step_flops')
    if not flops or not record.steps:
        return None
    return roofline.mfu(flops * record.steps, record.window_s, 'float32')
