"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``_build/lib<name>_<hash>.so`` (the hash covers the source and the
flags, so an edited source rebuilds), then loaded with ``ctypes``.  Builds
happen at first use, from the checkout's sources only.  ``build_all``
starts one ``nvcc`` per source at once and returns each build's
``-Xptxas -v`` report (registers, shared memory, spills per kernel).
``device_kind``, ``ptr`` and ``stream`` are what the wrappers hand the C
interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD = PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')

_LIBS: Dict[str, ctypes.CDLL] = {}
REPORTS: Dict[str, str] = {}


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
