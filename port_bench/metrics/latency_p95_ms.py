"""95th percentile of the latency of every request completed in the
window, from its send; a
failed request counts as missing any limit, and a tail that reaches one
is not reported."""

from port_bench.harness.common import percentile


def read(record):
    done = record.in_window()
    if not done:
        return None
    missing = 1e300                     # a failed request: past any limit
    p95 = percentile([record.latency_ms(r) if r.ok else missing for r in done], 95)
    return p95 if p95 < 1e299 else None
