"""Sustained-load serving tail latency through the ``BatchingFrontend``,
ported from ``transtacos_retunegan_tpu/tools/serving_latency.py``.

A closed-loop sustained load -- N worker threads, each issuing blocking
``vocode`` requests back to back for a fixed duration -- through the
port's micro-batching frontend on the card; it reports the per-request
latency distribution (p50/p90/p95/p99/max), overall and after a warm-up
window, which is what a serving objective sees.

Outlier diagnosis: every request records its start and end.  A request
slower than ``max(3 p50, p50 + 50 ms)`` is classified as

* ``global_stall``  -- most other requests in flight over the same interval
  were also slow (a host pause: garbage collection, the allocator), or
* ``cohort_local``  -- only its own cohort stalled (a long device queue,
  a cohort that waited for another's turn on the card).

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.serving_latency \\
      [--duration 60] [--concurrency 16] [--out latency.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Callable, Dict, List

import numpy as np
import torch


def warm_cohort_sizes(fe, specs: List[np.ndarray], sizes=(1, 2, 4, 8)) -> None:
    """One cohort of each size through the vocoder before measuring, so
    that no measured request pays for a first call (cuDNN plans, the
    allocator's first blocks); every cohort runs at the frontend's rows."""
    for b in sizes:
        fe.synth.vocode_batch(list(specs[:max(1, min(b, len(specs)))]), rows=fe.rows)


def percentiles(lat_ms: List[float]) -> Dict[str, float]:
    a = np.asarray(lat_ms, np.float64)
    return {
        'n': int(a.size),
        'p50_ms': float(np.percentile(a, 50)),
        'p90_ms': float(np.percentile(a, 90)),
        'p95_ms': float(np.percentile(a, 95)),
        'p99_ms': float(np.percentile(a, 99)),
        'max_ms': float(a.max()),
        'mean_ms': float(a.mean()),
    }


def run_load(request_fns: List[Callable[[], None]], duration_s: float,
             warmup_s: float = 5.0) -> Dict:
    """Closed-loop load: one worker per request function, looping until
    the deadline.  Returns the latency summaries (overall and steady state,
    i.e. requests started after the first ``warmup_s``) and the slow
    requests' classification."""
    records: List[tuple] = []      # (worker, t_start, t_end)
    lock = threading.Lock()
    t_begin = time.monotonic()
    deadline = t_begin + duration_s
    errors: List[str] = []

    def worker(idx: int, fn: Callable[[], None]):
        local = []
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            try:
                fn()
            except Exception as e:          # noqa: BLE001 -- reported below
                with lock:
                    errors.append(repr(e))
                break
            local.append((idx, t0, time.monotonic()))
        with lock:
            records.extend(local)

    threads = [threading.Thread(target=worker, args=(i, fn))
               for i, fn in enumerate(request_fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    records.sort(key=lambda r: r[1])
    lat_all = [(e - s) * 1000 for _, s, e in records]
    steady = [(e - s) * 1000 for _, s, e in records if s - t_begin >= warmup_s]
    out = {
        'duration_s': duration_s,
        'concurrency': len(request_fns),
        'errors': errors,
        'overall': percentiles(lat_all) if lat_all else None,
        'steady_state': percentiles(steady) if steady else None,
        'qps_steady': (len(steady) / max(duration_s - warmup_s, 1e-9)
                       if steady else None),
    }
    if steady:
        p50 = float(np.percentile(steady, 50))
        outliers = []
        for w, s, e in records:
            dt_ms = (e - s) * 1000
            if s - t_begin < warmup_s or dt_ms < max(3 * p50, p50 + 50):
                continue
            overlap = [(ee - ss) * 1000 for (ww, ss, ee) in records
                       if ww != w and ss < e and ee > s]
            slow_share = (float(np.mean([x >= 2 * p50 for x in overlap]))
                          if overlap else 0.0)
            outliers.append({
                't_s': s - t_begin,
                'latency_ms': dt_ms,
                'concurrent_slow_share': slow_share,
                'kind': 'global_stall' if slow_share >= 0.75 else 'cohort_local',
            })
        out['outliers_gt_3x_p50'] = outliers
    return out


def measure(synth, duration_s: float, warmup_s: float, concurrency: int,
            frames: int = 400, mixed_buckets: bool = False,
            window_ms: float = 6.0, max_batch: int = 8, seed: int = 7) -> Dict:
    """The closed-loop load of ``concurrency`` workers, each vocoding its
    own seeded natural-scale spec of ``frames`` frames (spread over three
    64-frame buckets with ``mixed_buckets``), through a fresh
    ``BatchingFrontend`` over ``synth``."""
    from ..serve.batcher import BatchingFrontend
    cfg = synth.cfg
    fe = BatchingFrontend(synth, max_batch=max_batch, window_s=window_ms / 1e3)
    rng = np.random.RandomState(seed)
    lengths = ([frames] * concurrency if not mixed_buckets
               else [frames + 64 * (i % 3) for i in range(concurrency)])
    specs = [np.abs(rng.randn(cfg.audio.n_freq, t) * 0.01).astype(np.float32)
             for t in lengths]
    for t in sorted(set(lengths)):
        warm_cohort_sizes(fe, [s for s, tl in zip(specs, lengths) if tl == t])
    res = run_load([(lambda s=s: fe.vocode(s)) for s in specs], duration_s, warmup_s)
    res['config'] = {'frames': lengths, 'window_ms': window_ms,
                     'infer_dtype': synth.infer_dtype, 'max_batch': max_batch}
    res['device'] = (torch.cuda.get_device_name(synth.device)
                     if synth.device.type == 'cuda' else str(synth.device))
    return res


def main(argv=None):
    from ..serve.pipeline import Synthesizer

    p = argparse.ArgumentParser()
    p.add_argument('--duration', type=float, default=60.0)
    p.add_argument('--warmup', type=float, default=8.0)
    p.add_argument('--concurrency', type=int, default=16)
    p.add_argument('--frames', type=int, default=400,
                   help='spec length per request')
    p.add_argument('--mixed_buckets', action='store_true', default=False,
                   help='spread request lengths over three frame buckets')
    p.add_argument('--infer_dtype', default='auto')
    p.add_argument('--window_ms', type=float, default=6.0)
    p.add_argument('--out', default=None, help='write the whole result here (JSON)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    synth = Synthesizer(infer_dtype=args.infer_dtype, devices=[args.device])
    print(f'# sustained load: {args.concurrency} workers, {args.duration:.0f}s, '
          f'window {args.window_ms}ms', flush=True)
    res = measure(synth, args.duration, args.warmup, args.concurrency, args.frames,
                  args.mixed_buckets, args.window_ms)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(res, fh, indent=2)
        print(f'# wrote {args.out}', flush=True)
    print(json.dumps({k: res[k] for k in ('steady_state', 'qps_steady', 'errors', 'device')},
                     indent=2))


if __name__ == '__main__':
    main()
