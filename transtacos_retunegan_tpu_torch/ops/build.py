"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``_build/lib<name>_<hash>.so`` (the hash covers the source and the
flags, so an edited source rebuilds), then loaded with ``ctypes``.  Builds
happen at first use, from the checkout's sources only.  ``build_all``
starts one ``nvcc`` per source at once and returns each build's
``-Xptxas -v`` report (registers, shared memory, spills per kernel).
``device_kind``, ``ptr`` and ``stream`` are what the wrappers hand the C
interface.

``load_host`` builds a host C++ library the same way with the host
compiler (``$CXX``, else ``c++``) and ``HOST_FLAGS`` (those of
``native/Makefile``): the native DSP library ``native/ttsdsp.cpp``, read in
place.  Its key also covers the compiler and this CPU's feature flags,
since ``-march=native`` code built on one host may not run on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD = PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')

HOST_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-march=native', '-ffast-math')

_LIBS: Dict[str, ctypes.CDLL] = {}
REPORTS: Dict[str, str] = {}
_HOST_LOCK = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME', '') + '/bin/nvcc',
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from csrc/ at first use')


def lib_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f'lib{name}_{digest}.so'


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    return out, (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        REPORTS.setdefault(name, f'{out.name}: already built')
        return
    tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
    os.replace(tmp, out)
    REPORTS[name] = log


def sources() -> List[str]:
    """Names of the CUDA sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source in parallel; returns name -> ptxas report."""
    jobs = {n: _start(n) for n in names}
    for n, (out, job) in jobs.items():
        _finish(n, out, job)
    return {n: REPORTS[n] for n in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        out, job = _start(name)
        _finish(name, out, job)
        _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def host_compiler() -> str:
    return os.environ.get('CXX') or 'c++'


def _cpu_tag() -> str:
    """This CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open('/proc/cpuinfo') as fh:
            flags = next((ln for ln in fh if ln.startswith(('flags', 'Features'))), '')
    except OSError:
        flags = ''
    return platform.machine() + flags


def host_lib_path(src: Path) -> Path:
    key = (src.read_bytes() + ' '.join((host_compiler(),) + HOST_FLAGS).encode()
           + _cpu_tag().encode())
    return BUILD / f'lib{src.stem}_{hashlib.sha256(key).hexdigest()[:16]}.so'


def load_host(src: Path) -> ctypes.CDLL:
    """The loaded host library built from the C++ source ``src`` with the
    host compiler and ``HOST_FLAGS``, built if needed; raises with the
    compiler's output when the build fails."""
    name = f'host:{src}'
    with _HOST_LOCK:
        if name not in _LIBS:
            out = host_lib_path(src)
            if not out.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f'.{os.getpid()}.tmp')
                cmd = [host_compiler(), *HOST_FLAGS, '-o', str(tmp), str(src)]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f'cannot run the host compiler for {src.name}: '
                                       f'{e}') from e
                if proc.returncode != 0:
                    raise RuntimeError(f'{" ".join(cmd)} failed:\n{proc.stderr}')
                os.replace(tmp, out)
            _LIBS[name] = ctypes.CDLL(str(out))
        return _LIBS[name]


def device_kind(t: torch.Tensor) -> str:
    """'cpu' (the wrapper runs its plain version) or 'cuda' (it launches)."""
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {t.device}')
    return t.device.type


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
