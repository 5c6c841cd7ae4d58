"""What every cell's run shares: the cache directories, the clocks, the
card's description, the check that no JAX module was loaded, the latency
arithmetic and the result line.

Runs import nothing of the JAX package: ``FORBIDDEN`` lists the top-level
module names that must be absent from ``sys.modules`` once the window has
closed, compared as whole names (the port's name begins with the JAX
package's).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'port_bench'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transtacos_retunegan_tpu')
CACHE = ROOT / '.bench_cache'


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in a checkout builds; the port's own CUDA build goes to
    ``transtacos_retunegan_tpu_torch/_build`` there already."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'), ('CUDA_CACHE_PATH', 'nv')):
        os.environ[var] = str(CACHE / sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def since_process_start() -> float:
    """Seconds since this process was started (``/proc/self/stat``'s start
    time against ``/proc/uptime``), so that set-up counts the
    interpreter's own start."""
    with open('/proc/self/stat') as fh:
        start_ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'


def forbidden_modules() -> List[str]:
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """``np.percentile`` (linear interpolation) over every value: a frozen
    copy of the arithmetic of
    ``transtacos_retunegan_tpu_torch/tools/serving_latency.py::percentiles``
    (lines 43-53; verdict: sound arithmetic)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class Request:
    """One request of a serving run: when it was sent and done (monotonic
    seconds), its pool text, the wav it got and whether it failed."""
    text: int
    sent: float = 0.0
    done: Optional[float] = None
    wav: Any = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.done is not None and self.error is None


@dataclass
class Record:
    """What a run leaves for the metric readers (``port_bench/metrics``):
    the window, set-up time, the requests or steps, the spans of the
    benchmark's wrappers, and the device trace of a ``--trace 1`` run."""
    cell: Dict[str, Any]
    workload: Dict[str, Any]
    seed: int
    trace: bool
    setup_s: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    requests: List[Request] = field(default_factory=list)
    steps: int = 0
    audio_s_per_step: float = 0.0
    spans: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)
    device: Any = None                    # trace.DeviceTrace of a traced run
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def in_window(self) -> List[Request]:
        """Requests completed inside the window."""
        return [r for r in self.requests
                if r.done is not None and self.t_start <= r.done <= self.t_end]

    def latency_ms(self, r: Request) -> float:
        """From the time it was sent."""
        return 1e3 * (r.done - r.sent)

    def span(self, name: str) -> List[Dict[str, Any]]:
        return self.spans.get(name, [])


def idle_share(record: Record) -> Optional[float]:
    """Percent of the profiled window with no operation on the device."""
    d = record.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def device_block(torch, count: int) -> Dict[str, Any]:
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': count,
            'memory_peak_bytes': int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result line, its ``checks`` key last, as the last line
    on standard output."""
    for name, c in checks.items():
        log(f'check {name}: {c["value"]!r} (limit {c["limit"]!r}, '
            f'{"pass" if c.get("ok") else "FAIL"})')
    line = dict(result)
    line['checks'] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
