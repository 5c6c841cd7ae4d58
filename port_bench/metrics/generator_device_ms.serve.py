"""Device time of the kernels launched inside the generator's forward,
per call, from the profiler (a ``record_function`` around the forward)."""

from port_bench.harness.serving import GEN_RANGE


def read(record):
    if record.device is None:
        return None
    calls = [s for s in record.device.range_device_s.get(GEN_RANGE, []) if s > 0]
    return 1e3 * sum(calls) / len(calls) if calls else None
