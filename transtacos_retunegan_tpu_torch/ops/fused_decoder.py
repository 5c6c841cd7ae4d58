"""Fused autoregressive decode: CUDA kernels and their plain versions.

Port of ``transtacos_retunegan_tpu/ops/fused_decoder.py``.  The decoder
weights are packed once (``fold_params``): the matmul weights as ``[in,
out]`` matrices in bf16 (serving) or float32 (tight comparisons) in
``wsrc``, the float32 biases, folded location matrix and energy vector in
``fbuf``.  Two kernels in ``csrc/fused_decoder.cu`` consume them:

* ``decode_full``: the whole decode in one launch (the Pallas
  ``_make_full_kernel``); ``fused_decode_full`` is the serving decode, with
  ``early_exit`` skipping the work of rows that have finished.
* ``decode_step``: one decode step per launch (the Pallas
  ``_make_step_kernel``); ``fused_decode`` drives it from a torch loop, for
  shapes past the shared-memory fit check.

Both run a persistent cooperative grid of ``fp.blocks`` blocks (one per SM)
and split every weight matrix by output columns over the blocks, the GRU
matrices by hidden unit (columns c, H+c, 2H+c together).  ``fold_params``
pre-tiles the weights into ``wbuf`` so that each block's slice is one
contiguous piece (``_slice``; the CUDA ``slice`` computes the same layout);
``decode_full`` holds its slice in shared memory for the whole decode,
``decode_step`` reads it from L2.  What bounds the design is about
``barriers_per_step`` grid barriers per step plus the longest phase, not
bytes; a later PR would add ``mma.sync``/``wgmma`` over B rows padded to 8
or 16, a TMA bulk copy of the slices and fewer barriers per step.

``w`` holds named ``[in, out]`` views of ``wsrc``; edits to them in place
(a stop head, say) reach ``wbuf`` at the next launch, which re-tiles when
``wsrc`` has changed.  Each wrapper runs its plain PyTorch version
(``decode_step_plain``, ``decode_full_plain``) on CPU tensors and launches
its kernel on CUDA tensors; there is no fallback from one to the other.  A
launch error, a grid-barrier timeout or a layout mismatch raises.
``LAUNCHES`` counts kernel launches and ``LAST_GRID`` holds the number of
blocks of each kernel's last launch; while the tracer records
(``utils/tracing.py``), each ``decode_full`` launch adds its host time,
taken just before the launch call, to the innermost open span's
``decode_full_launch_ns``, and the time its error word was read (which
waits for the kernel) to ``decode_full_done_ns``.

A persistent grid takes every SM of its card, so launches on one card are
serialized by a per-device lock (taken with a timeout: a launch that cannot
get the card raises); serving replicas on different cards launch in
parallel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.decoder import out_lengths
from ..models.decoder_fast import cell_weights
from ..utils import tracing
from . import build
from .build import device_kind, ptr, stream
from .lsa_kernel import lsa_step_plain

LAUNCHES: Dict[str, int] = {'decode_step': 0, 'decode_full': 0}
LAST_GRID: Dict[str, Optional[int]] = {'decode_step': None, 'decode_full': None}

# Hopper: 227 KB of shared memory per block.  fused_decode_full takes the
# per-step path when a block's slice and activations do not fit (tests set
# this to 0 to pin that path).
SMEM_BUDGET_BYTES = 227 * 1024
THREADS = 512
LOCK_TIMEOUT_S = 60.0
_DEVICE_LOCKS: Dict[int, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


@contextlib.contextmanager
def _on_card(device: torch.device):
    """The current device set to ``device`` (the ctypes launches use it) and
    its launch lock held; counts the launch under the guard."""
    with _LOCKS_GUARD:
        lock = _DEVICE_LOCKS.setdefault(device.index, threading.Lock())
    if not lock.acquire(timeout=LOCK_TIMEOUT_S):
        raise RuntimeError(f'the decode kernels of {device} stayed busy for '
                           f'{LOCK_TIMEOUT_S} s')
    try:
        with torch.cuda.device(device):
            yield
    finally:
        lock.release()


def _count(name: str) -> None:
    with _LOCKS_GUARD:
        LAUNCHES[name] += 1
MAX_PRENET = MAX_GRU = 4
RB = 4                      # rows per GEMV work item (RB in the CUDA source)
SYNC_FLOATS = 4             # barrier counter and error word ahead of the scratch
ERRORS = {1: 'a grid barrier timed out'}


class Dims(NamedTuple):
    n_mel: int
    d: int          # encoder depth (context width)
    h: int          # decoder depth
    a: int          # attention depth
    r: int          # outputs per step
    kwin: int       # location conv width
    prenet: Tuple[int, ...]
    n_gru: int


@dataclass(frozen=True)
class FoldedParams:
    wsrc: torch.Tensor                  # matmul weights, bf16 or float32
    wbuf: torch.Tensor                  # the same, tiled per block (_tile_index)
    fbuf: torch.Tensor                  # float32 vectors and location matrix
    w: Dict[str, torch.Tensor]          # named [in, out] views into wsrc
    f: Dict[str, torch.Tensor]          # named views into fbuf
    woff: Dict[str, int]                # element offsets into wsrc
    foff: Dict[str, int]                # element offsets into fbuf
    dims: Dims
    blocks: int                         # G, the kernels' grid
    tiles: torch.Tensor                 # wbuf[i] = wsrc[tiles[i]]
    bases: torch.Tensor                 # int64 [blocks]: block g's slice in wbuf
    tiled: Dict[str, int]               # wsrc's version when wbuf was tiled


def _pack(named, dtype, device, extra=0):
    offs, pos = {}, 0
    for k, t in named:
        offs[k] = pos
        pos += (t.numel() + 7) // 8 * 8             # 16-byte aligned pieces
    buf = torch.zeros(max(pos + extra, 8), dtype=dtype, device=device)
    views = {}
    for k, t in named:
        v = buf[offs[k]:offs[k] + t.numel()].view(t.shape)
        v.copy_(t)
        views[k] = v
    return buf, views, offs


@torch.no_grad()
def fold_params(cell, dtype: torch.dtype = torch.bfloat16,
                blocks: Optional[int] = None) -> FoldedParams:
    """Pack a decoder cell, ``models.decoder.DecoderCell`` or
    ``models.decoder_fast.DecoderCellFast``, into kernel operands, tiled
    for a grid of ``blocks`` (default: the card's SM count; 1 on the CPU).

    Both layouts give the same operands (``decoder_fast.cell_weights``):
    the location conv's bias is a constant term on the pre-tanh energy
    (``Dense(conv(x) + b_c) == conv'(x) + b_c @ W``), so it folds into the
    attention bias.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'weight dtype {dtype} (bfloat16 or float32)')
    cw = cell_weights(cell)
    pre, grus = cw['prenet'], cw['grus']
    if len(pre) > MAX_PRENET or len(grus) > MAX_GRU:
        raise ValueError(f'at most {MAX_PRENET} prenet layers and {MAX_GRU} GRUs')
    named_w = [(f'pre{i}', w.float()) for i, (w, _) in enumerate(pre)]
    named_w.append(('wx', torch.cat([cw['wx_p'], cw['wx_c']]).float()))
    named_f = [(f'bpre{i}', b.float()) for i, (_, b) in enumerate(pre)]
    named_f.append(('bx', cw['bx'].float()))
    for j, (wi, bi, wh, bn) in enumerate(grus):
        named_w += [(f'wi{j}', wi.float()), (f'wh{j}', wh.float())]
        named_f += [(f'bi{j}', bi.float()), (f'bhn{j}', bn.float())]
    named_w += [('wq', cw['wq'].float()), ('wf', cw['wf'].float()),
                ('ws', cw['ws'].float())]
    named_f += [('loc', cw['loc'].float()), ('v', cw['v'].float()[:, 0]),
                ('ba', cw['ba'].float()), ('bf', cw['bf'].float()),
                ('bs', cw['bs'].float())]
    device = cell.rnn_in_proj.weight.device
    wsrc, w, woff = _pack(named_w, dtype, device, extra=8)     # + a zero slot
    fbuf, f, foff = _pack(named_f, torch.float32, device)
    h = w['wi0'].shape[0]
    dims = Dims(n_mel=w['pre0'].shape[0], d=w['wx'].shape[0] - pre[-1][0].shape[1],
                h=h, a=w['wq'].shape[1], r=f['bs'].shape[0],
                kwin=f['loc'].shape[0], prenet=tuple(pw.shape[1] for pw, _ in pre),
                n_gru=len(grus))
    if blocks is None:
        blocks = (torch.cuda.get_device_properties(device).multi_processor_count
                  if device.type == 'cuda' else 1)
    zero = wsrc.numel() - 8
    tiles = torch.from_numpy(_tile_index(dims, tuple(sorted(woff.items())), blocks, zero))
    tiles = tiles.to(device)
    sizes = _grid(dims, blocks)[0]
    bases = torch.tensor([0] + list(np.cumsum(sizes[:-1])), dtype=torch.int64, device=device)
    fp = FoldedParams(wsrc, torch.empty(tiles.numel(), dtype=dtype, device=device), fbuf,
                      w, f, woff, foff, dims, blocks, tiles, bases, {})
    retile(fp)
    return fp


# ---------------------------------------------------------------------------
# the per-block tiling (mirrors slice() in the CUDA source)
# ---------------------------------------------------------------------------

def _span(g: int, blocks: int, n: int) -> Tuple[int, int]:
    """Items [lo, hi) of n that block g of ``blocks`` owns."""
    return g * n // blocks, (g + 1) * n // blocks


def _up8(n: int) -> int:
    return (n + 7) // 8 * 8


def _slice(dims: Dims, g: int, blocks: int):
    """Block g's slice of the weights: [(name, columns of the [in, out]
    matrix, in)] in slice order (each piece column-major, padded to 8
    elements) and the slice's size in elements.  The GRU pieces hold the
    block's hidden units unit-major, gates r|z|n of each unit together; ws
    is whole in every block."""
    h, d = dims.h, dims.d
    pieces, k_in = [], dims.n_mel
    for i, out in enumerate(dims.prenet):
        pieces.append((f'pre{i}', range(*_span(g, blocks, out)), k_in))
        k_in = out
    units = range(*_span(g, blocks, h))
    pieces.append(('wx', units, k_in + d))
    gates = [gate * h + u for u in units for gate in range(3)]
    for j in range(dims.n_gru):
        pieces += [(f'wi{j}', gates, h), (f'wh{j}', gates, h)]
    pieces += [('wq', range(*_span(g, blocks, dims.a)), h),
               ('wf', range(*_span(g, blocks, dims.r * dims.n_mel)), h + d),
               ('ws', range(dims.r), h + d)]
    return pieces, sum(_up8(len(cols) * k) for _, cols, k in pieces)


@functools.lru_cache(maxsize=16)
def _grid(dims: Dims, blocks: int) -> Tuple[Tuple[int, ...], int]:
    """The size of every block's slice (elements) and the most GRU units
    that a block owns."""
    slices = [_slice(dims, g, blocks) for g in range(blocks)]
    numax = max(len(dict((k, c) for k, c, _ in p)['wx']) for p, _ in slices)
    return tuple(size for _, size in slices), numax


@functools.lru_cache(maxsize=8)
def _tile_index(dims: Dims, woff: Tuple[Tuple[str, int], ...], blocks: int,
                zero: int) -> np.ndarray:
    """For every element of the tiled buffer, its index in ``wsrc`` (the
    padding points at ``zero``, a zero element): block after block, each
    block's pieces in ``_slice`` order."""
    offs = dict(woff)
    outs = {'wx': dims.h, 'wq': dims.a, 'wf': dims.r * dims.n_mel, 'ws': dims.r}
    outs.update({f'pre{i}': p for i, p in enumerate(dims.prenet)})
    outs.update({f'w{s}{j}': 3 * dims.h for j in range(dims.n_gru) for s in 'ih'})
    parts = []
    for g in range(blocks):
        for name, cols, k in _slice(dims, g, blocks)[0]:
            idx = (offs[name] + np.asarray(cols, np.int64)[:, None]
                   + outs[name] * np.arange(k, dtype=np.int64)[None, :]).reshape(-1)
            parts += [idx, np.full(_up8(idx.size) - idx.size, zero, np.int64)]
    return np.concatenate(parts).astype(np.int32)


def retile(fp: FoldedParams) -> None:
    """Bring ``wbuf`` up to date with ``wsrc`` if ``wsrc`` (or a view of
    it in ``w``) changed in place since the last tiling (torch bumps a
    tensor's version counter on every in-place write)."""
    if fp.tiled.get('version') != fp.wsrc._version:
        torch.index_select(fp.wsrc, 0, fp.tiles, out=fp.wbuf)
        fp.tiled['version'] = fp.wsrc._version


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul as the kernels do it: the activation rounded to the weight
    type, products accumulated in float32."""
    return x.to(w.dtype).float() @ w.float()


def decode_step_plain(fp: FoldedParams, prev, ctx, hs, cum, keys, values,
                      mask, finished):
    """One step (``_step_math``).  ``finished`` is ``[B, 1]`` float; the
    next-carry outputs are already impute-selected.  Returns
    ((frames, stop, align, ctx_o, cum_o, prev_o, fin), hs_o)."""
    w, f, d = fp.w, fp.f, fp.dims
    act = prev
    for i in range(len(d.prenet)):
        act = torch.relu(_mm(act, w[f'pre{i}']) + f[f'bpre{i}'])
    x = _mm(torch.cat([act, ctx], -1), w['wx']) + f['bx']
    h_news = []
    for j in range(d.n_gru):
        gi = _mm(x, w[f'wi{j}']) + f[f'bi{j}']
        gh = _mm(hs[j], w[f'wh{j}'])
        hd = d.h
        r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
        z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
        n = torch.tanh(gi[:, 2 * hd:] + r * (gh[:, 2 * hd:] + f[f'bhn{j}']))
        h_new = (1.0 - z) * n + z * hs[j]
        h_news.append(h_new)
        x = h_new + x
    align, cum_new, ctx_new = lsa_step_plain(_mm(x, w['wq']), cum, keys, values,
                                             mask, f['loc'], f['v'], f['ba'])
    proj = torch.cat([x, ctx_new], -1)
    frames = _mm(proj, w['wf']) + f['bf']
    stop = torch.sigmoid(_mm(proj, w['ws']) + f['bs'])
    newly = (stop >= 0.5).any(-1, keepdim=True).float()
    fin = torch.maximum(finished, newly)
    frames = frames * (1.0 - finished)
    held = finished > 0
    outs = (frames, stop, align, torch.where(held, ctx, ctx_new),
            torch.where(held, cum, cum_new),
            torch.where(held, prev, frames[:, -d.n_mel:]), fin)
    return outs, tuple(torch.where(held, h0, h1) for h0, h1 in zip(hs, h_news))


def _zero_carry(fp: FoldedParams, b: int, n: int, device):
    d = fp.dims
    z = lambda *s: torch.zeros(*s, device=device)               # noqa: E731
    return (z(b, d.n_mel), z(b, d.d), tuple(z(b, d.h) for _ in range(d.n_gru)),
            z(b, n), z(b, 1))


@torch.no_grad()
def decode_full_plain(fp: FoldedParams, keys, values, mask, steps: int,
                      early_exit: bool = False):
    """Whole decode -> frames [steps, B, rM], stop [steps, B, r],
    align [steps, B, N], fin [steps, B, 1].  With ``early_exit`` a row that
    finished before a step emits zero frame/stop/align and fin = 1 there."""
    b, n = mask.shape
    prev, ctx, hs, cum, fin = _zero_carry(fp, b, n, keys.device)
    ys = []
    for _ in range(steps):
        was = fin
        (fr, st, al, ctx, cum, prev, fin), hs = decode_step_plain(
            fp, prev, ctx, hs, cum, keys, values, mask, fin)
        if early_exit:
            skip = was > 0
            fr, st, al = (torch.where(skip, torch.zeros_like(y), y)
                          for y in (fr, st, al))
        ys.append((fr, st, al, fin))
    return tuple(torch.stack(y) for y in zip(*ys))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def barriers_per_step(dims: Dims) -> int:
    """Grid barriers in one step: one per dependent phase."""
    return len(dims.prenet) + dims.n_gru + 5


@functools.lru_cache(maxsize=64)
def smem_bytes(dims: Dims, n: int, b: int, blocks: int, wsize: int,
               staged: bool = True) -> int:
    """Shared memory of one block (``layout`` in the CUDA source): the
    largest block's weight slice (``staged``: decode_full only) in 16-byte
    units, then float32 activations for ``b`` rows of ``n`` text positions."""
    up4 = lambda k: (k + 3) // 4 * 4                              # noqa: E731
    sizes, numax = _grid(dims, blocks)
    wbytes = (max(sizes) * wsize + 15) // 16 * 16 if staged else 0
    pmax = max(dims.prenet)
    vmax = max(dims.n_mel + dims.n_gru * dims.h, pmax, dims.prenet[-1] + dims.d,
               dims.h + dims.d)
    bp = (b + RB - 1) // RB * RB
    floats = (up4(dims.kwin * dims.a)                 # location matrix
              + bp * up4(vmax)                        # rounded GEMV inputs per row
              + (1 + dims.n_gru) * bp * up4(3 * numax)  # gi, gh of the block's units
              + bp * up4(n)                           # alignment
              + bp * up4(dims.r)                      # stop probabilities
              + 3 * up4(b) + 4                        # fin, rows, slot; misc
              + THREADS)                              # a location window per warp
    return wbytes + 4 * floats


def scratch_floats(dims: Dims, n: int, b: int) -> int:
    """Float32 words of the kernels' global scratch (``scratch_of``)."""
    d = dims
    return (SYNC_FLOATS + len(d.prenet) * b * max(d.prenet) + 2 * b * d.h + b * d.a
            + b * n + b * d.d + d.n_gru * b * d.h + b * d.d + b * n + b * d.n_mel)


def _meta(fp: FoldedParams, b: int, n: int, steps: int, early_exit: bool,
          staged: bool):
    """Launch parameters in the order ``unpack`` in the CUDA source reads."""
    d, nt = fp.dims, THREADS
    pad = lambda xs: (lambda l: l + [0] * (MAX_PRENET - len(l)))(list(xs))  # noqa: E731
    ng = lambda xs: (lambda l: l + [0] * (MAX_GRU - len(l)))(list(xs))      # noqa: E731
    fo, wsize = fp.foff, fp.wbuf.element_size()
    sizes, numax = _grid(d, fp.blocks)
    meta = ([b, n, d.n_mel, d.d, d.h, d.a, d.r, d.r * d.n_mel, d.kwin,
             len(d.prenet), d.n_gru, steps, int(early_exit), nt, fp.blocks, wsize,
             smem_bytes(d, n, b, fp.blocks, wsize, staged), fp.wbuf.numel(),
             scratch_floats(d, n, b), max(sizes), numax]
            + pad(d.prenet)
            + pad(fo[f'bpre{i}'] for i in range(len(d.prenet))) + [fo['bx']]
            + ng(fo[f'bi{j}'] for j in range(d.n_gru))
            + ng(fo[f'bhn{j}'] for j in range(d.n_gru))
            + [fo['loc'], fo['v'], fo['ba'], fo['bf'], fo['bs']])
    return (ctypes.c_longlong * len(meta))(*meta), len(meta)


def _check(fp: FoldedParams, keys, values, mask, prev=None, ctx=None, hs=(),
           cum=None, finished=None):
    """Shapes, device, dtype and layout of the operands (the carry only for
    the step kernel), checked before any pointer reaches the kernel."""
    b, n = mask.shape
    d = fp.dims
    if hs and len(hs) != d.n_gru:
        raise ValueError(f'{len(hs)} GRU states for {d.n_gru} GRU layers')
    want = [('keys', keys, (b, n, d.a)), ('values', values, (b, n, d.d)),
            ('mask', mask, (b, n)), ('prev', prev, (b, d.n_mel)),
            ('ctx', ctx, (b, d.d)), ('cum', cum, (b, n)),
            ('finished', finished, (b, 1))]
    want += [(f'hs[{j}]', h, (b, d.h)) for j, h in enumerate(hs)]
    for name, t, shape in want:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    for t in [keys, values, mask, fp.wbuf, fp.fbuf] + [w[1] for w in want[3:]]:
        if t is None:
            continue
        if t.device != keys.device:
            raise ValueError('all operands must be on one device')
        if t.dtype != torch.float32 and t is not fp.wbuf:
            raise ValueError(f'operands must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('operands must be contiguous')


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/fused_decoder.cu`` built at first use, with its C signatures
    (every pointer and the stream as ``void*``)."""
    lib = build.load('fused_decoder')
    i32, ptr_t = ctypes.c_int, ctypes.c_void_p
    meta = ctypes.POINTER(ctypes.c_longlong)
    lib.decode_full.argtypes = [i32, meta, i32] + [ptr_t] * 13
    lib.decode_step.argtypes = [i32, meta, i32] + [ptr_t] * 22
    lib.grid_barriers.argtypes = [meta, i32, ptr_t, i32, ptr_t, ptr_t]
    lib.decode_full.restype = lib.decode_step.restype = i32
    lib.grid_barriers.restype = i32
    lib.decoder_error_string.argtypes = [i32]
    lib.decoder_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.decoder_error_string(rc).decode()
        raise RuntimeError(f'{what} launch failed: {msg} ({rc})')


def _scratch(fp: FoldedParams, b: int, n: int, device) -> torch.Tensor:
    """Zeroed scratch: barrier words, then the vectors that cross blocks
    (and decode_full's carry, which starts at zero)."""
    return torch.zeros(scratch_floats(fp.dims, n, b), device=device)


def _finish(scratch: torch.Tensor, what: str) -> None:
    """Raise if a grid barrier of the launch failed (waits for it)."""
    err = int(scratch[:SYNC_FLOATS].view(torch.int32)[1])
    if err:
        raise RuntimeError(f'{what}: {ERRORS.get(err, f"error word {err}")}')


def _launch_full(lib, fp: FoldedParams, keys, values, mask, steps: int,
                 early_exit: bool):
    b, n = mask.shape
    d = fp.dims
    retile(fp)
    meta, n_meta = _meta(fp, b, n, steps, early_exit, staged=True)
    new = lambda *s: torch.empty(*s, device=keys.device)         # noqa: E731
    frames, stop = new(steps, b, d.r * d.n_mel), new(steps, b, d.r)
    align, fin = new(steps, b, n), new(steps, b, 1)
    scratch, grid = _scratch(fp, b, n, keys.device), ctypes.c_int(0)
    tracing.mark('decode_full_launch_ns')
    rc = lib.decode_full(
        ctypes.c_int(fp.wbuf.dtype == torch.bfloat16), meta, ctypes.c_int(n_meta),
        ptr(fp.wbuf), ptr(fp.bases), ptr(fp.fbuf), ptr(keys), ptr(values), ptr(mask),
        ptr(scratch),
        ptr(frames), ptr(stop), ptr(align), ptr(fin), ctypes.byref(grid),
        stream(keys))
    _raise(lib, rc, 'decode_full')
    _finish(scratch, 'decode_full')
    tracing.mark('decode_full_done_ns')
    LAST_GRID['decode_full'] = grid.value
    return frames, stop, align, fin


def _launch_step(lib, fp: FoldedParams, prev, ctx, hs, cum, keys, values,
                 mask, finished):
    b, n = mask.shape
    d = fp.dims
    retile(fp)
    meta, n_meta = _meta(fp, b, n, 1, False, staged=False)
    hs_in = torch.stack(hs).contiguous()
    new = torch.empty_like
    frames = torch.empty(b, d.r * d.n_mel, device=keys.device)
    stop = torch.empty(b, d.r, device=keys.device)
    align, ctx_o, cum_o, prev_o = new(cum), new(ctx), new(cum), new(prev)
    fin_o, hs_o = new(finished), new(hs_in)
    scratch, grid = _scratch(fp, b, n, keys.device), ctypes.c_int(0)
    rc = lib.decode_step(
        ctypes.c_int(fp.wbuf.dtype == torch.bfloat16), meta, ctypes.c_int(n_meta),
        ptr(fp.wbuf), ptr(fp.bases), ptr(fp.fbuf), ptr(prev), ptr(ctx), ptr(hs_in),
        ptr(cum), ptr(keys), ptr(values), ptr(mask), ptr(finished), ptr(scratch),
        ptr(frames), ptr(stop), ptr(align), ptr(ctx_o), ptr(cum_o),
        ptr(prev_o), ptr(fin_o), ptr(hs_o), ctypes.byref(grid), stream(keys))
    _raise(lib, rc, 'decode_step')
    _finish(scratch, 'decode_step')
    LAST_GRID['decode_step'] = grid.value
    return (frames, stop, align, ctx_o, cum_o, prev_o, fin_o), tuple(hs_o.unbind(0))


def decode_step(fp: FoldedParams, prev, ctx, hs, cum, keys, values, mask,
                finished):
    """One decode step: the plain version on CPU tensors, the
    ``decode_step_kernel`` launch on CUDA tensors."""
    if device_kind(keys) == 'cpu':
        return decode_step_plain(fp, prev, ctx, hs, cum, keys, values, mask,
                                 finished)
    _check(fp, keys, values, mask, prev, ctx, hs, cum, finished)
    with _on_card(keys.device):
        out = _launch_step(_lib(), fp, prev, ctx, hs, cum,
                           keys, values, mask, finished)
    _count('decode_step')
    return out


def decode_full(fp: FoldedParams, keys, values, mask, steps: int,
                early_exit: bool = False):
    """Whole decode: the plain version on CPU tensors, one
    ``decode_full_kernel`` launch on CUDA tensors."""
    if device_kind(keys) == 'cpu':
        return decode_full_plain(fp, keys, values, mask, steps, early_exit)
    _check(fp, keys, values, mask)
    with _on_card(keys.device):
        out = _launch_full(_lib(), fp, keys, values, mask,
                           steps, early_exit)
    _count('decode_full')
    return out


def grid_barriers(fp: FoldedParams, b: int, n: int, rounds: int,
                  device) -> int:
    """``rounds`` grid barriers and nothing else, on the grid, threads and
    shared memory that ``decode_full`` takes for ``b`` rows of ``n``
    positions: the floor of its time per step is ``barriers_per_step``
    rounds.  A diagnostic; returns the grid size."""
    meta, n_meta = _meta(fp, b, n, 1, False, staged=True)
    scratch, grid = _scratch(fp, b, n, device), ctypes.c_int(0)
    with torch.cuda.device(device):
        lib = _lib()
        rc = lib.grid_barriers(meta, ctypes.c_int(n_meta), ptr(scratch),
                               ctypes.c_int(rounds), ctypes.byref(grid),
                               stream(scratch))
        _raise(lib, rc, 'grid_barriers')
    _finish(scratch, 'grid_barriers')
    return grid.value


# ---------------------------------------------------------------------------
# drivers (the Pallas module's fused_decode / fused_decode_full)
# ---------------------------------------------------------------------------

def to_outputs(fp: FoldedParams, frames, stop, align, fin) -> Dict[str, torch.Tensor]:
    """Per-step emissions ``[steps, B, ...]`` -> the decoder's outputs."""
    steps, b = frames.shape[:2]
    d = fp.dims
    return {'mel_outputs': frames.transpose(0, 1).reshape(b, steps * d.r, d.n_mel),
            'stop_token_outputs': stop.transpose(0, 1).reshape(b, steps * d.r),
            'alignments': align.permute(1, 2, 0),                 # [B, N, T]
            'out_lengths': out_lengths(fin[..., 0] > 0.5, d.r)}


@torch.no_grad()
def fused_decode(fp: FoldedParams, keys, values, mask,
                 steps: int) -> Dict[str, torch.Tensor]:
    """Decode with one ``decode_step`` per step.  Returns mel [B, steps*r, M],
    stop probs [B, steps*r], alignments [B, N, steps], out_lengths [B]."""
    b, n = mask.shape
    prev, ctx, hs, cum, fin = _zero_carry(fp, b, n, keys.device)
    ys = []
    for _ in range(steps):
        (fr, st, al, ctx, cum, prev, fin), hs = decode_step(
            fp, prev, ctx, hs, cum, keys, values, mask, fin)
        ys.append((fr, st, al, fin))
    return to_outputs(fp, *(torch.stack(y) for y in zip(*ys)))


@torch.no_grad()
def fused_decode_full(fp: FoldedParams, keys, values, mask, steps: int,
                      early_exit: bool = False) -> Dict[str, torch.Tensor]:
    """The whole decode in one ``decode_full`` launch (same contract as
    ``fused_decode``).  With ``early_exit`` the emissions of a row after its
    stop step are zero; callers trim by ``out_lengths``.  Shapes whose
    per-block shared memory exceeds the budget take ``fused_decode``."""
    b, n = mask.shape
    if smem_bytes(fp.dims, n, b, fp.blocks, fp.wbuf.element_size()) > SMEM_BUDGET_BYTES:
        return fused_decode(fp, keys, values, mask, steps)
    return to_outputs(fp, *decode_full(fp, keys, values, mask, steps, early_exit))
