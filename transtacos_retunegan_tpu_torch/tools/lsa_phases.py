"""Per-phase time of the LSA step kernel on the card.

    python -m transtacos_retunegan_tpu_torch.tools.lsa_phases [variant.cu ...]

Builds a copy of ``csrc/lsa_step.cu`` (and of each variant given, a source
with the same C interface) in which thread 0 of the CTA of rank 0 of row 0
reads its SM clock and the global timer at the kernel's entry, after
every ``__syncthreads()``, ``cluster.sync()``, ``cluster_wait()`` and
``__syncwarp()`` of ``lsa_step_kernel`` (a copy may add ``__syncwarp()``
lines outside loops to mark finer phases) and at its exit.
Then, for each build in turn and again in reverse order, it launches the
kernel ``LAUNCHES`` times at each (B, N) of ``SHAPES`` (A=128, D=256,
kwin=31) and prints the mean time of each phase, from the mark that ends
the previous phase to the one that ends it, in microseconds (clock cycles
over the cycles per microsecond that the two clocks give over all
launches).  The time from the launch to the first mark is not seen.
Needs a CUDA device and ``nvcc``; the builds go to ``_build/``.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import build
from ..ops import lsa_kernel as lk
from .lsa_ab import build_variant, inputs

SHAPES = ((8, 64), (1, 64), (8, 256))
LAUNCHES, MAX_MARKS = 200, 1 << 14
MARK = ('if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && g_nmark < %d) '
        '{ long long c_ = clock64(), t_; asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t_)); '
        'g_marks[2 * g_nmark] = c_; g_marks[2 * g_nmark + 1] = t_; ++g_nmark; }' % MAX_MARKS)
READ = '''extern "C" {
int read_marks(long long* host, int* n) {
  int zero = 0, err = (int)cudaMemcpyFromSymbol(n, g_nmark, sizeof(int));
  if (!err) err = (int)cudaMemcpyFromSymbol(host, g_marks, sizeof(long long) * 2 * %d);
  return err ? err : (int)cudaMemcpyToSymbol(g_nmark, &zero, sizeof(int));
}
''' % MAX_MARKS
ENTRY = 'extern __shared__ __align__(16) float s[];\n'
BARRIERS = ('__syncthreads();\n', 'cluster.sync();\n', 'cluster_wait();\n', '__syncwarp();\n')


def instrument(src: Path, name: str):
    """Build ``src`` with the marks; returns (library, phases per launch)."""
    s = src.read_text()
    head, rest = s.split('lsa_step_kernel(int N', 1)
    body, tail = rest.split('\n}\n', 1)
    body += '\n'
    if ENTRY not in body:
        raise ValueError(f'{src}: no {ENTRY.strip()!r} in lsa_step_kernel')
    body = body.replace(ENTRY, ENTRY + '  ' + MARK + '\n', 1)
    phases = 0
    for barrier in BARRIERS:
        phases += body.count(barrier)
        body = body.replace(barrier, barrier + '  ' + MARK + '\n')
    body += '  ' + MARK + '\n'                          # at the exit
    phases += 1
    head = head.replace('namespace {\n', 'namespace {\n__device__ long long g_marks[2 * %d];\n'
                        '__device__ int g_nmark;\n' % MAX_MARKS, 1)
    s = head + 'lsa_step_kernel(int N' + body + '}\n' + tail.replace('extern "C" {\n', READ, 1)
    build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD / f'lsa_phases_{name}.cu'
    cu.write_text(s)
    lib = build_variant(cu, f'phases_{name}')
    lib.read_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, phases


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('lsa_phases: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    sources = [build.CSRC / 'lsa_step.cu'] + [Path(p) for p in argv]
    libs = {str(p): instrument(p, f'v{i}') for i, p in enumerate(sources)}
    marks, count = np.zeros(2 * MAX_MARKS, np.int64), ctypes.c_int(0)
    print(torch.cuda.get_device_name(0), flush=True)
    cases = {(b, n): inputs(b, n, dev) for b, n in SHAPES}
    for src in list(libs) + list(libs)[::-1]:
        lib, phases = libs[src]
        for (b, n), args in cases.items():
            lk._launch(lib, *args)                          # warm-up
            torch.cuda.synchronize()
            lib.read_marks(marks.ctypes.data, ctypes.byref(count))
            for _ in range(LAUNCHES):
                lk._launch(lib, *args)
            torch.cuda.synchronize()
            if lib.read_marks(marks.ctypes.data, ctypes.byref(count)):
                raise RuntimeError('reading the clock marks failed')
            m = marks[:2 * count.value].reshape(LAUNCHES, phases + 1, 2)
            cycles, ns = np.diff(m[..., 0], axis=1), m[:, -1, 1] - m[:, 0, 1]
            per_us = 1e3 * cycles.sum() / ns.sum()
            us = cycles.mean(0) / per_us
            print(f'{Path(src).name} B={b} N={n} (C, P)={lk.lsa_plan(n)}: {per_us:.0f} cycles '
                  f'per us; us per phase: ' + ', '.join(f'{x:.3f}' for x in us)
                  + f'; entry to exit {us.sum():.3f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
