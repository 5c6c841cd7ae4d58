"""Fused autoregressive decode: CUDA kernels and their plain versions.

Port of ``transtacos_retunegan_tpu/ops/fused_decoder.py``.  The decoder
weights are packed once (``fold_params``) into two contiguous buffers: the
matmul weights as ``[in, out]`` matrices in bf16 (serving) or float32
(tight comparisons), and the float32 biases, folded location matrix and
energy vector.  Two kernels in ``csrc/fused_decoder.cu`` consume them:

* ``decode_step``: one decode step per launch (the Pallas
  ``_make_step_kernel``); ``fused_decode`` drives it from a torch loop.
* ``decode_full``: the whole decode in one launch (the Pallas
  ``_make_full_kernel``); ``fused_decode_full`` is the serving decode, with
  ``early_exit`` skipping the step math of rows that have finished.

Each wrapper runs its plain PyTorch version (``decode_step_plain``,
``decode_full_plain``) on CPU tensors and launches its kernel on CUDA
tensors; there is no fallback from one to the other.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from ..models.decoder import out_lengths
from . import build
from .build import device_kind, ptr, stream
from .lsa_kernel import fold_location_params, lsa_step_plain

LAUNCHES: Dict[str, int] = {'decode_step': 0, 'decode_full': 0}

# Hopper: 227 KB of shared memory per block.  fused_decode_full takes the
# per-step path when one row's working set does not fit (tests set this to
# 0 to pin that path).
SMEM_BUDGET_BYTES = 227 * 1024
THREADS = 512
MAX_PRENET = MAX_GRU = 4


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
    wbuf: torch.Tensor                  # matmul weights, bf16 or float32
    fbuf: torch.Tensor                  # float32 vectors and location matrix
    w: Dict[str, torch.Tensor]          # named [in, out] views into wbuf
    f: Dict[str, torch.Tensor]          # named views into fbuf
    woff: Dict[str, int]                # element offsets into wbuf
    foff: Dict[str, int]                # element offsets into fbuf
    dims: Dims


def _pack(named, dtype, device):
    offs, pos = {}, 0
    for k, t in named:
        offs[k] = pos
        pos += (t.numel() + 7) // 8 * 8             # 16-byte aligned pieces
    buf = torch.zeros(max(pos, 8), dtype=dtype, device=device)
    views = {}
    for k, t in named:
        v = buf[offs[k]:offs[k] + t.numel()].view(t.shape)
        v.copy_(t)
        views[k] = v
    return buf, views, offs


@torch.no_grad()
def fold_params(cell, dtype: torch.dtype = torch.bfloat16) -> FoldedParams:
    """Pack a ``models.decoder.DecoderCell`` into kernel operands.

    The location conv's bias is a constant term on the pre-tanh energy
    (``Dense(conv(x) + b_c) == conv'(x) + b_c @ W``), so it folds into the
    attention bias.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'weight dtype {dtype} (bfloat16 or float32)')
    m = cell._modules
    pre = list(m['decoder_prenet'].children())
    grus = cell.grus()
    lsa = m['lsa']
    if len(pre) > MAX_PRENET or len(grus) > MAX_GRU:
        raise ValueError(f'at most {MAX_PRENET} prenet layers and {MAX_GRU} GRUs')
    tw = lambda lin: lin.weight.detach().float().t()            # noqa: E731
    named_w = [(f'pre{i}', tw(l)) for i, l in enumerate(pre)]
    named_w.append(('wx', tw(m['rnn_in_proj'])))
    named_f = [(f'bpre{i}', l.bias.float()) for i, l in enumerate(pre)]
    named_f.append(('bx', m['rnn_in_proj'].bias.float()))
    for j, g in enumerate(grus):
        gm = g._modules
        named_w += [(f'wi{j}', torch.cat([tw(gm[k]) for k in ('ir', 'iz', 'in')], 1)),
                    (f'wh{j}', torch.cat([tw(gm[k]) for k in ('hr', 'hz', 'hn')], 1))]
        named_f += [(f'bi{j}', torch.cat([gm[k].bias.float() for k in ('ir', 'iz', 'in')])),
                    (f'bhn{j}', gm['hn'].bias.float())]
    named_w += [('wq', tw(lsa.query_layer)), ('wf', tw(m['frame_projection'])),
                ('ws', tw(m['stop_projection']))]
    conv, wloc = lsa.location_convolution, lsa.location_layer.weight.float()
    named_f += [('loc', fold_location_params(conv.weight.float(), wloc)),
                ('v', lsa.attention_variable.float()[:, 0]),
                ('ba', lsa.attention_bias.float() + conv.bias.float() @ wloc.t()),
                ('bf', m['frame_projection'].bias.float()),
                ('bs', m['stop_projection'].bias.float())]
    device = cell.rnn_in_proj.weight.device
    wbuf, w, woff = _pack(named_w, dtype, device)
    fbuf, f, foff = _pack(named_f, torch.float32, device)
    h = w['wi0'].shape[0]
    dims = Dims(n_mel=w['pre0'].shape[0], d=w['wx'].shape[0] - pre[-1].out_features,
                h=h, a=w['wq'].shape[1], r=f['bs'].shape[0],
                kwin=f['loc'].shape[0], prenet=tuple(l.out_features for l in pre),
                n_gru=len(grus))
    return FoldedParams(wbuf, fbuf, w, f, woff, foff, dims)


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

def smem_bytes(dims: Dims, n: int) -> int:
    """Shared memory of one block (``layout`` in the CUDA source)."""
    nt = THREADS
    up4 = lambda k: (k + 3) // 4 * 4                              # noqa: E731
    pmax = max(dims.prenet)
    vmax = max(dims.n_mel, pmax, dims.prenet[-1] + dims.d, dims.h + dims.d)
    rm = dims.r * dims.n_mel
    floats = (up4(dims.n_gru * dims.h) + up4(dims.d) + up4(n) + up4(dims.n_mel)
              + 4 + up4(pmax) + up4(vmax) + up4(dims.h) + 2 * up4(3 * dims.h)
              + up4(dims.a) + up4(dims.kwin * dims.a) + up4(n + dims.kwin - 1)
              + up4(n) + up4(dims.d) + up4(rm + dims.r) + up4(nt))
    return 4 * floats


def _meta(fp: FoldedParams, b: int, n: int, steps: int, early_exit: bool):
    """Launch parameters in the order ``unpack`` in the CUDA source reads."""
    d, nt = fp.dims, THREADS
    pad = lambda xs: (lambda l: l + [0] * (MAX_PRENET - len(l)))(list(xs))  # noqa: E731
    ng = lambda xs: (lambda l: l + [0] * (MAX_GRU - len(l)))(list(xs))      # noqa: E731
    wo, fo = fp.woff, fp.foff
    meta = ([b, n, d.n_mel, d.d, d.h, d.a, d.r, d.r * d.n_mel, d.kwin,
             len(d.prenet), d.n_gru, steps, int(early_exit), nt,
             smem_bytes(d, n)]
            + pad(d.prenet) + pad(wo[f'pre{i}'] for i in range(len(d.prenet)))
            + [wo['wx']] + ng(wo[f'wi{j}'] for j in range(d.n_gru))
            + ng(wo[f'wh{j}'] for j in range(d.n_gru))
            + [wo['wq'], wo['wf'], wo['ws']]
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
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    meta = ctypes.POINTER(ctypes.c_longlong)
    lib.decode_full.argtypes = [i32, meta, i32] + [ptr] * 10
    lib.decode_step.argtypes = [i32, meta, i32] + [ptr] * 19
    lib.decode_full.restype = lib.decode_step.restype = i32
    lib.decoder_error_string.argtypes = [i32]
    lib.decoder_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.decoder_error_string(rc).decode()
        raise RuntimeError(f'{what} launch failed: {msg} ({rc})')


def _launch_full(lib, fp: FoldedParams, keys, values, mask, steps: int,
                 early_exit: bool):
    b, n = mask.shape
    d = fp.dims
    meta, n_meta = _meta(fp, b, n, steps, early_exit)
    new = lambda *s: torch.empty(*s, device=keys.device)         # noqa: E731
    frames, stop = new(steps, b, d.r * d.n_mel), new(steps, b, d.r)
    align, fin = new(steps, b, n), new(steps, b, 1)
    rc = lib.decode_full(
        ctypes.c_int(fp.wbuf.dtype == torch.bfloat16), meta, ctypes.c_int(n_meta),
        ptr(fp.wbuf), ptr(fp.fbuf), ptr(keys), ptr(values), ptr(mask),
        ptr(frames), ptr(stop), ptr(align), ptr(fin), stream(keys))
    _raise(lib, rc, 'decode_full')
    return frames, stop, align, fin


def _launch_step(lib, fp: FoldedParams, prev, ctx, hs, cum, keys, values,
                 mask, finished):
    b, n = mask.shape
    d = fp.dims
    meta, n_meta = _meta(fp, b, n, 1, False)
    hs_in = torch.stack(hs).contiguous()
    new = torch.empty_like
    frames = torch.empty(b, d.r * d.n_mel, device=keys.device)
    stop = torch.empty(b, d.r, device=keys.device)
    align, ctx_o, cum_o, prev_o = new(cum), new(ctx), new(cum), new(prev)
    fin_o, hs_o = new(finished), new(hs_in)
    rc = lib.decode_step(
        ctypes.c_int(fp.wbuf.dtype == torch.bfloat16), meta, ctypes.c_int(n_meta),
        ptr(fp.wbuf), ptr(fp.fbuf), ptr(prev), ptr(ctx), ptr(hs_in),
        ptr(cum), ptr(keys), ptr(values), ptr(mask), ptr(finished),
        ptr(frames), ptr(stop), ptr(align), ptr(ctx_o), ptr(cum_o),
        ptr(prev_o), ptr(fin_o), ptr(hs_o), stream(keys))
    _raise(lib, rc, 'decode_step')
    return (frames, stop, align, ctx_o, cum_o, prev_o, fin_o), tuple(hs_o.unbind(0))


def decode_step(fp: FoldedParams, prev, ctx, hs, cum, keys, values, mask,
                finished):
    """One decode step: the plain version on CPU tensors, the
    ``decode_step_kernel`` launch on CUDA tensors."""
    if device_kind(keys) == 'cpu':
        return decode_step_plain(fp, prev, ctx, hs, cum, keys, values, mask,
                                 finished)
    _check(fp, keys, values, mask, prev, ctx, hs, cum, finished)
    with torch.cuda.device(keys.device):
        out = _launch_step(_lib(), fp, prev, ctx, hs, cum,
                           keys, values, mask, finished)
    LAUNCHES['decode_step'] += 1
    return out


def decode_full(fp: FoldedParams, keys, values, mask, steps: int,
                early_exit: bool = False):
    """Whole decode: the plain version on CPU tensors, one
    ``decode_full_kernel`` launch on CUDA tensors."""
    if device_kind(keys) == 'cpu':
        return decode_full_plain(fp, keys, values, mask, steps, early_exit)
    _check(fp, keys, values, mask)
    with torch.cuda.device(keys.device):
        out = _launch_full(_lib(), fp, keys, values, mask,
                           steps, early_exit)
    LAUNCHES['decode_full'] += 1
    return out


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
    shared-memory working set exceeds the budget take ``fused_decode``."""
    if smem_bytes(fp.dims, mask.shape[1]) > SMEM_BUDGET_BYTES:
        return fused_decode(fp, keys, values, mask, steps)
    return to_outputs(fp, *decode_full(fp, keys, values, mask, steps, early_exit))
