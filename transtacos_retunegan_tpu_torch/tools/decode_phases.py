"""Per-phase time of the ``decode_full`` kernel on the card.

    python -m transtacos_retunegan_tpu_torch.tools.decode_phases [variant.cu ...]

Builds a copy of ``csrc/fused_decoder.cu`` (and of each variant given, a
source with the same C interface and layout) in which thread 0 of block 0
reads its SM clock after every grid barrier.  Then, for each build in turn
and again in reverse order, it runs a 300-step decode at the default
``Config()`` with seeded weights in bf16, at B=1, N=48 and B=8, N=64, and
prints the mean time of each phase over steps 10-299: from the barrier that
ends the previous phase to the one that ends it, that barrier included.
Clock cycles become microseconds by the decode's time on CUDA events.
Needs a CUDA device and ``nvcc``; the builds go to ``_build/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..models.decoder import DecoderCell
from ..ops import build
from ..ops import fused_decoder as fd
from ..weights import seeded_init

STEPS, SKIP, MAX_MARKS = 300, 10, 1 << 14
SHAPES = ((1, 48), (8, 64))
MARK = ('if (threadIdx.x == 0 && blockIdx.x == 0 && g_nmark < %d) '
        'g_marks[g_nmark++] = clock64();' % MAX_MARKS)
READ = '''extern "C" {
int read_marks(long long* host, int* n) {
  int zero = 0, err = (int)cudaMemcpyFromSymbol(n, g_nmark, sizeof(int));
  if (!err) err = (int)cudaMemcpyFromSymbol(host, g_marks, sizeof(long long) * %d);
  return err ? err : (int)cudaMemcpyToSymbol(g_nmark, &zero, sizeof(int));
}
''' % MAX_MARKS


def instrument(src: Path, name: str) -> ctypes.CDLL:
    """Build ``src`` with a clock mark after each grid barrier of step()
    and before the step loop of decode_full_kernel."""
    s = src.read_text()
    edits = [('namespace {\n', 'namespace {\n__device__ long long g_marks[%d];\n'
              '__device__ int g_nmark;\n' % MAX_MARKS, 1),
             ('if (!grid_sync(gb, misc + 1)) return false;',
              'if (!grid_sync(gb, misc + 1)) return false;\n  ' + MARK, -1),
             ('  return grid_sync(gb, misc + 1);\n}',
              '  const bool ok_ = grid_sync(gb, misc + 1);\n  ' + MARK + '\n  return ok_;\n}', 1),
             ('  int st = 0;\n', '  ' + MARK + '\n  int st = 0;\n', 1),
             ('extern "C" {\n', READ, 1)]
    for old, new, count in edits:
        if old not in s:
            raise ValueError(f'{src}: no {old.strip()!r} to instrument')
        s = s.replace(old, new, count)
    build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD / f'phases_{name}.cu'
    cu.write_text(s)
    out = cu.with_suffix('.so')
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, '-o', str(out), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f'nvcc failed for {src}:\n{r.stdout}{r.stderr}')
    lib = ctypes.CDLL(str(out))
    lib.read_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the signatures ``fd._lib`` gives the production build."""
    load, build.load = build.load, lambda name: lib
    try:
        fd._lib.cache_clear()
        return fd._lib()
    finally:
        build.load = load
        fd._lib.cache_clear()


def phase_names(dims) -> list:
    return (['prenet0+gh'] + [f'prenet{l}' for l in range(1, len(dims.prenet))] + ['wx']
            + [f'gru{j}' for j in range(dims.n_gru)] + ['wq', 'energy', 'softmax+ctx', 'heads'])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('decode_phases: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    sources = [build.CSRC / 'fused_decoder.cu'] + [Path(p) for p in argv]
    libs = {str(p): bind(instrument(p, f'v{i}')) for i, p in enumerate(sources)}
    cell = seeded_init(DecoderCell(Config()), 20250101).to(dev)
    fp = fd.fold_params(cell, torch.bfloat16)
    fp.f['bs'].fill_(-20.0)                                  # every step runs
    names, nb = phase_names(fp.dims), fd.barriers_per_step(fp.dims)
    marks, count = np.zeros(MAX_MARKS, np.int64), ctypes.c_int(0)
    print(torch.cuda.get_device_name(0), fp.blocks, 'blocks', flush=True)
    production = fd._lib
    try:
        for src in list(libs) + list(libs)[::-1]:
            lib = libs[src]
            fd._lib = lambda lib=lib: lib
            for b, n in SHAPES:
                r = np.random.RandomState(7)
                mask = np.ones((b, n), np.float32)
                mem = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
                       (0.5 * r.randn(b, n, fp.dims.a), 0.5 * r.randn(b, n, fp.dims.d), mask)]
                fd.decode_full(fp, *mem, STEPS)                 # warm-up
                lib.read_marks(marks.ctypes.data, ctypes.byref(count))
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fd.decode_full(fp, *mem, STEPS)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
                if lib.read_marks(marks.ctypes.data, ctypes.byref(count)):
                    raise RuntimeError('reading the clock marks failed')
                m = marks[:count.value]
                per_us = (m[-1] - m[0]) / (1e3 * ms)              # cycles per microsecond
                steps = np.diff(m)[:STEPS * nb].reshape(STEPS, nb)[SKIP:]
                us = steps.mean(0) / per_us
                print(f'{Path(src).name} B={b} N={n}: {ms:.3f} ms per {STEPS}-step decode, '
                      f'{per_us:.0f} cycles per us; us per phase: '
                      + ', '.join(f'{k} {v:.2f}' for k, v in zip(names, us))
                      + f'; sum {us.sum():.2f}', flush=True)
    finally:
        fd._lib = production
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
