"""Share of its roofline that ``decode_full_kernel`` reaches: the least
time of every call in the window (``roofline.bound`` at the call's rows,
text bucket and its rows' longest real steps, bf16 weights) over the
kernel's device time from the profiler."""

from port_bench.harness import roofline


def read(record):
    if record.device is None:
        return None
    kernel = record.device.kernel_s('decode_full')
    spans = [s for s in record.span('acoustic_stage')
             if record.t_start <= s['start'] <= record.t_end]
    if not kernel or not spans:
        return None
    dims = roofline.decoder_dims(record.extra['ref_cfg'])
    least = sum(roofline.bound(dims, s['rows'], s['n'], max(s['steps']))[0] for s in spans)
    # calls and kernels are matched by count (a call at the window's edge
    # may miss its kernel): the mean bound over the mean device time
    return 100.0 * (least / len(spans) / 1e3) / (sum(kernel) / len(kernel))
