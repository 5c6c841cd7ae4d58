"""Closed loop: ``clients`` threads, each calling ``BatchingFrontend.tts``
back to back on its share of the seeded order."""

from port_bench.harness import serving


def measure(record):
    return serving.serve(record)


def verify(record, state):
    served, answers = state
    device = record.extra.get('device', 'cuda')
    checks = serving.check(served, record, answers, device)
    if record.trace:
        record.extra['request_flops'] = serving.request_flops(served, device)
    return checks
