"""One location-sensitive attention step: CUDA kernel and plain version.

Port of ``transtacos_retunegan_tpu/ops/lsa_kernel.py``.  Per batch row:

    loc  = window(cum) @ loc_mat        (location conv and dense folded into
                                         one [kwin, A] matrix)
    e    = tanh(keys + q + loc + b) . v
    a    = softmax(e) masked to the text length
    cum' = cum + a
    ctx  = a @ values

``lsa_step_fused`` runs ``lsa_step_plain`` on CPU tensors and launches the
``lsa_step_kernel`` of ``csrc/lsa_step.cu`` on CUDA tensors; there is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches.  The
masking is the Pallas kernel's: masked energies are -1e30, the weights are
multiplied by the mask and the divisor gets +1e-30, so a row with no valid
position gives zeros (``lsa_step_reference``'s -inf would give NaN).

The kernel runs one thread-block cluster of C CTAs per row, each over P
text positions (``lsa_plan``); ``lsa_floor`` launches an empty kernel of the
same grid, cluster and shared memory, the launch floor the kernel is
measured against.

As in the JAX package, no serving or training path calls this op: the
decode kernels (``ops/fused_decoder.py``) do the same step inside their own
loop, and their plain versions call ``lsa_step_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import build
from .build import device_kind, ptr, stream

LAUNCHES: Dict[str, int] = {'lsa_step': 0}
KWIN = 31          # location conv width of the reference
MAX_KWIN = 63      # largest window the kernel takes (odd widths only)
MAX_CLUSTER = 8    # CTAs per row at most: the portable cluster size
MIN_TILE = 8       # text positions per CTA at least


def lsa_plan(n: int) -> Tuple[int, int]:
    """The kernel's split of N text positions (``csrc/lsa_step.cu::plan``):
    C CTAs per row, each over a tile of P positions, with
    P = max(8, ceil(N/8)) and C = ceil(N/P) <= 8.  Returns (C, P)."""
    p = max(MIN_TILE, -(-n // MAX_CLUSTER))
    return -(-n // p), p


def fold_location_params(conv_weight: torch.Tensor,
                         w_loc: torch.Tensor) -> torch.Tensor:
    """Location conv ``[F, 1, kwin]`` and dense ``[A, F]`` (torch layouts)
    -> one ``[kwin, A]`` matrix: both are linear, so folding is exact."""
    return torch.einsum('fik,af->ka', conv_weight, w_loc)


def lsa_step_plain(q, cum, keys, values, mask, loc_mat, v, b
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,A], cum [B,N], keys [B,N,A], values [B,N,D], mask [B,N],
    loc_mat [kwin,A], v [A], b [A] -> (align [B,N], cum' [B,N], ctx [B,D])."""
    kwin = loc_mat.shape[0]
    half = kwin // 2
    windows = F.pad(cum, (half, half)).unfold(1, kwin, 1)         # [B, N, kwin]
    pre = torch.tanh(keys + q[:, None, :] + windows @ loc_mat + b)
    e = pre @ v
    valid = mask > 0
    e = torch.where(valid, e, torch.full_like(e, -1e30))
    w = torch.exp(e - e.amax(-1, keepdim=True)) * valid
    align = w / (w.sum(-1, keepdim=True) + 1e-30)
    return align, cum + align, torch.einsum('bn,bnd->bd', align, values)


def _check(q, cum, keys, values, mask, loc_mat, v, b) -> None:
    """Shapes, device, dtype and layout, checked before any pointer reaches
    the kernel."""
    bsz, n = cum.shape
    a, d, kwin = keys.shape[-1], values.shape[-1], loc_mat.shape[0]
    if kwin % 2 == 0 or kwin > MAX_KWIN:
        raise ValueError(f'location window {kwin}: odd and at most {MAX_KWIN}')
    want = (('q', q, (bsz, a)), ('cum', cum, (bsz, n)), ('keys', keys, (bsz, n, a)),
            ('values', values, (bsz, n, d)), ('mask', mask, (bsz, n)),
            ('loc_mat', loc_mat, (kwin, a)), ('v', v, (a,)), ('b', b, (a,)))
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
        if t.device != keys.device:
            raise ValueError('all operands must be on one device')
        if t.dtype != torch.float32:
            raise ValueError(f'operands must be float32, got {t.dtype} for {name}')
        if not t.is_contiguous():
            raise ValueError(f'operands must be contiguous ({name} is not)')


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/lsa_step.cu`` built at first use, with its C signature."""
    lib = build.load('lsa_step')
    lib.lsa_step.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 12
    lib.lsa_step.restype = ctypes.c_int
    lib.lsa_floor.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lsa_floor.restype = ctypes.c_int
    lib.lsa_plan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lsa_plan.restype = None
    lib.lsa_error_string.argtypes = [ctypes.c_int]
    lib.lsa_error_string.restype = ctypes.c_char_p
    return lib


def _launch(lib, q, cum, keys, values, mask, loc_mat, v, b):
    bsz, n = cum.shape
    align, cum_out = torch.empty_like(cum), torch.empty_like(cum)
    ctx = torch.empty(bsz, values.shape[-1], device=keys.device)
    rc = lib.lsa_step(bsz, n, keys.shape[-1], values.shape[-1], loc_mat.shape[0],
                      ptr(q), ptr(cum), ptr(keys), ptr(values), ptr(mask),
                      ptr(loc_mat), ptr(v), ptr(b), ptr(align), ptr(cum_out),
                      ptr(ctx), stream(keys))
    _raise(lib, 'lsa_step', rc)
    return align, cum_out, ctx


def _raise(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: '
                           f'{lib.lsa_error_string(rc).decode()} ({rc})')


def lsa_step_fused(q, cum, keys, values, mask, loc_mat, v, b
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused LSA step with the JAX op's signature and outputs
    ``(align [B,N], cum' [B,N], ctx [B,D])``: the plain version on CPU
    tensors, one ``lsa_step_kernel`` launch on CUDA tensors."""
    args = (q, cum, keys, values, mask, loc_mat, v, b)
    if device_kind(keys) == 'cpu':
        return lsa_step_plain(*args)
    _check(*args)
    with torch.cuda.device(keys.device):
        out = _launch(_lib(), *args)
    LAUNCHES['lsa_step'] += 1
    return out


def lsa_floor(b: int, n: int, a: int, d: int, kwin: int, device) -> None:
    """One launch of an empty kernel with ``lsa_step_kernel``'s grid, cluster
    shape and shared memory for these sizes, on the current stream of
    ``device`` (a CUDA device); not counted in ``LAUNCHES``."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'lsa_floor needs a CUDA device, got {device}')
    with torch.cuda.device(device):
        lib = _lib()
        rc = lib.lsa_floor(b, n, a, d, kwin,
                           ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
        _raise(lib, 'lsa_floor', rc)
