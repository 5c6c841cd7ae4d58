"""The LSA step kernel against other builds of it, in one process on one card.

    python -m transtacos_retunegan_tpu_torch.tools.lsa_ab [variant.cu ...]

Builds ``csrc/lsa_step.cu`` and each variant given (a source with the same
``lsa_step`` and ``lsa_error_string`` C interface, e.g. an earlier version
of the file), printing each build's ``-Xptxas -v`` report.  Then, for each
build in turn and again in reverse order (so that a drift of the card's
clock shows), at (B, N) in ``SHAPES`` with A=128, D=256, kwin=31: holds
the build's result to ``lsa_step_plain`` and prints the ms per launch
(``timings``): replayed from a CUDA graph of one launch and of ``CHAIN``
launches back to back (``replay_ms``), and the device time of the kernel
from torch.profiler (``device_ms``).  Last, the same for the empty kernel
of the current source's grid, cluster and shared memory (``lsa_floor``).
Needs a CUDA device and ``nvcc``; the builds go to ``_build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import build
from ..ops import lsa_kernel as lk

SHAPES = ((8, 64), (1, 64), (8, 128), (8, 256))
A, D, KWIN = 128, 256, 31
TOL = (1e-5, 1e-5, 1e-4)           # align, cum, ctx: tests/test_ops.py's bounds
# A graph of one launch replays at the rate the host launches graphs (about
# 6 us on an H100's host, for an empty kernel); a graph of CHAIN launches
# runs them back to back on the device.
CHAIN = 100


def replay_ms(fn, reps: int = 500, warm: int = 20, per_graph: int = 1) -> float:
    """Mean time per call of ``fn``'s device work: ``per_graph`` calls
    captured once in a CUDA graph, replayed ``reps`` times between two CUDA
    events after ``warm`` calls and replays (no host work of ``fn`` is
    timed).  With one call per graph a replay can wait on the host's graph
    launch; with many, the calls run back to back on the device."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    for _ in range(warm):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


def device_ms(fn, calls: int = 200) -> float:
    """Mean device time of the kernels ``fn`` launches, from torch.profiler
    over ``calls`` calls (None if the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, 'device_time_total', 0) or getattr(e, 'cuda_time_total', 0)
             for e in prof.key_averages() if 'lsa_' in e.key)
    return us / 1e3 / calls if us > 0 else None


def inputs(b: int, n: int, device, seed: int = 7):
    """Seeded LSA operands; row i of B > 1 has text length n - i * n // B."""
    r = np.random.RandomState(seed)
    lens = n - np.arange(b) * n // b
    mask = (np.arange(n)[None] < lens[:, None]).astype(np.float64)
    xs = (r.randn(b, A), np.abs(r.randn(b, n)), 0.1 * r.randn(b, n, A), r.randn(b, n, D),
          mask, 0.05 * r.randn(KWIN, A), 0.1 * r.randn(A), 0.01 * r.randn(A))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in xs]


def build_variant(src: Path, tag: str) -> ctypes.CDLL:
    """``src`` compiled with the production flags, bound as ``lk._launch``
    calls it."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    build.BUILD.mkdir(parents=True, exist_ok=True)
    out = build.BUILD / f'lsa_ab_{tag}_{digest}.so'
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, '-o', str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f'nvcc failed for {src}:\n{r.stdout}{r.stderr}')
    print(f'-- nvcc {src}\n{r.stdout.strip()}', flush=True)
    lib = ctypes.CDLL(str(out))
    lib.lsa_step.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 12
    lib.lsa_step.restype = ctypes.c_int
    lib.lsa_error_string.argtypes = [ctypes.c_int]
    lib.lsa_error_string.restype = ctypes.c_char_p
    return lib


def timings(fn) -> str:
    """ms per call: graph replay of 1 and of ``CHAIN`` calls per graph, and
    the profiler's device time."""
    dev = device_ms(fn)
    return (f'{replay_ms(fn):.5f} (1 per graph) {replay_ms(fn, reps=20, per_graph=CHAIN):.5f} '
            f'({CHAIN} per graph) ' + ('device not measured' if dev is None
                                       else f'{dev:.5f} device'))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('lsa_ab: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    print(f'-- nvcc {build.CSRC / "lsa_step.cu"}\n'
          f'{build.build_all(["lsa_step"])["lsa_step"].strip()}', flush=True)
    libs = {'csrc/lsa_step.cu': lk._lib()}
    libs.update({str(p): build_variant(Path(p), f'v{i}') for i, p in enumerate(argv)})
    cases = {(b, n): inputs(b, n, dev) for b, n in SHAPES}
    for name in list(libs) + list(libs)[::-1]:
        lib, times = libs[name], []
        for (b, n), args in cases.items():
            got = lk._launch(lib, *args)
            ref = lk.lsa_step_plain(*args)
            errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
            if not all(e <= t for e, t in zip(errs, TOL)):
                raise AssertionError(f'{name} B={b} N={n}: errors {errs} over {TOL}')
            times.append(f'B={b} N={n} ' + timings(lambda: lk._launch(lib, *args)))
        print(f'{name}: ' + '; '.join(times), flush=True)
    floors = [f'B={b} N={n} (C, P)={lk.lsa_plan(n)} '
              + timings(lambda: lk.lsa_floor(b, n, A, D, KWIN, dev)) for b, n in SHAPES]
    print('lsa_floor: ' + '; '.join(floors), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
