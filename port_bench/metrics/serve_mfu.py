"""The models' matrix-product and convolution FLOPs for the requests
completed in the window, each at its own length (``FlopCounterMode`` on
the reference, plus the decode's ``step_cost`` times its steps), over the
window, over the card's published bf16 peak (989 TFLOP/s; the power limit
is printed on an earlier line)."""

from port_bench.harness import roofline


def read(record):
    flops = record.extra.get('request_flops')
    done = [r for r in record.in_window() if r.ok]
    if not flops or not done:
        return None
    return roofline.mfu(sum(flops[r.text] for r in done), record.window_s, 'bfloat16')
