#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root, the cell's traffic file
``port_bench/workloads/<cell>.json`` (whose ``driver`` names a module of
``port_bench/drivers``) and its configuration file; builds and warms the
system (``setup_s``), measures for ``--seconds``, compares what the timed
path produced with the float32 reference, and prints the result as the
last line of standard output: ``--trace 0`` the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  Each metric
is read by ``port_bench/metrics/<name>.py``.  Exits non-zero, printing no
result, without enough CUDA devices, or if a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import common, roofline  # noqa: E402

common.set_cache_env()


def reader(name: str):
    path = common.BENCH / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'port_bench_metric_{len(sys.modules)}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str, record) -> dict:
    """The cell's metrics of ``kind`` that their readers find, by name."""
    out = {}
    for m in bench[kind]:
        if 'workloads' in m and cell not in m['workloads']:
            continue
        value = reader(m['name'])(record)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = next((w for w in bench['workloads'] if w['name'] == args.workload), None)
    if cell is None:
        common.log(f'no workload {args.workload!r} in BENCHMARK.json')
        return 2
    conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
    traffic = json.loads((common.BENCH / 'workloads' / f'{cell["name"]}.json').read_text())

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        common.log(f'{cell["name"]} needs {cell["chips"]} CUDA device(s); found '
                   f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 3
    common.log(f'card: {common.card_line()}; torch {torch.__version__}; published peaks '
               f'{json.dumps(roofline.describe_peaks())}')
    record = common.Record(cell=cell, workload=traffic, seed=args.seed,
                           trace=bool(args.trace),
                           extra={'config_file': str(ROOT / conf['file']),
                                  'seconds': args.seconds})
    driver = importlib.import_module(f'port_bench.drivers.{traffic["driver"]}')
    state = driver.measure(record)
    device = common.device_block(torch, cell['chips'])
    checks = driver.verify(record, state)
    kind = 'per_layer' if args.trace else 'end_to_end'
    metrics = metrics_of(bench, cell['name'], kind, record)
    failed = int(checks['failed']['value'])
    result = {'correct': all(c['ok'] for c in checks.values()),
              'attempted': len(record.requests) or record.steps,
              'failed': failed, 'metrics': metrics, 'device': device}
    if args.trace and record.device is not None:
        device['busy_s'] = record.device.busy_s
        device['window_s'] = record.device.window_s
        result['breakdown'] = {'device_ops': record.device.top_ops(10),
                               'idle_gaps': [list(g) for g in record.device.idle_gaps]}
    bad = common.forbidden_modules()
    if bad:
        common.log(f'JAX modules were loaded: {bad}')
        return 4
    common.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
