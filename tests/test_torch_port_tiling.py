"""The per-block weight tiling of the decode kernels, on the CPU.

``fold_params`` pre-tiles the decoder's matmul weights so that each block of
the kernels' grid finds its columns of every matrix in one contiguous piece
of ``wbuf``.  These tests reassemble the ``[in, out]`` matrices from the
tiled buffer by walking the blocks (independently of ``_tile_index``), at
the small test widths and the default widths, for grids that divide the
widths and grids that do not, including blocks that own no columns.
Everything is exact: tiling only moves elements.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu_torch.config import Config
from transtacos_retunegan_tpu_torch.models.decoder import DecoderCell
from transtacos_retunegan_tpu_torch.ops import fused_decoder as fd
from transtacos_retunegan_tpu_torch.weights import seeded_init

pytestmark = pytest.mark.usefixtures('few_threads')

DEFAULT = fd.Dims(n_mel=80, d=256, h=512, a=128, r=5, kwin=31, prenet=(256,), n_gru=2)


def _cell(small: bool):
    base = Config()
    if small:
        base = dataclasses.replace(base, acoustic=dataclasses.replace(
            base.acoustic, decoder_depth=64, attention_depth=16, prenet_depths=(48, 32),
            decoder_layers=3, encoder_depth=32))
    return seeded_init(DecoderCell(base), 11)


def _reassemble(fp):
    """The [in, out] matrices and the copies of ws, rebuilt from ``wbuf``
    block by block; every column is owned by exactly one block."""
    mats = {k: torch.full(v.shape, float('nan'), dtype=v.dtype) for k, v in fp.w.items()}
    ws_copies, owners = [], {k: np.zeros(v.shape[1], int) for k, v in fp.w.items()}
    o = 0
    for g in range(fp.blocks):
        pieces, size = fd._slice(fp.dims, g, fp.blocks)
        assert int(fp.bases[g]) == o, 'block bases'
        start = o
        for name, cols, k in pieces:
            n = len(cols) * k
            piece = fp.wbuf[o:o + n].view(len(cols), k).t()
            if name == 'ws':
                ws_copies.append(piece)
            else:
                mats[name][:, list(cols)] = piece
                owners[name][list(cols)] += 1
            assert not fp.wbuf[o + n:o + fd._up8(n)].any(), 'padding must be zero'
            o += fd._up8(n)
        assert o - start == size
    assert o == fp.wbuf.numel()
    return mats, ws_copies, owners


@pytest.mark.parametrize('small', [True, False], ids=['small', 'default'])
@pytest.mark.parametrize('blocks', [1, 3, 132])
def test_tiling_reassembles_the_matrices(small, blocks):
    dtype = torch.float32 if small else torch.bfloat16
    fp = fd.fold_params(_cell(small), dtype, blocks=blocks)
    assert fp.blocks == blocks
    mats, ws_copies, owners = _reassemble(fp)
    for name, m in mats.items():
        if name != 'ws':
            assert torch.equal(m, fp.w[name]), name
            assert (owners[name] == 1).all(), name
    assert len(ws_copies) == blocks
    for c in ws_copies:
        assert torch.equal(c, fp.w['ws'])
    if small and blocks == 132:      # most blocks own no column of wq (A = 16)
        empty = sum(not list(dict((k, c) for k, c, _ in fd._slice(fp.dims, g, 132)[0])['wq'])
                    for g in range(132))
        assert empty == 132 - 16


@pytest.mark.parametrize('blocks', [3, 7, 132])
def test_gru_slices_hold_the_three_gates_of_a_unit(blocks):
    fp = fd.fold_params(_cell(True), torch.float32, blocks=blocks)
    h = fp.dims.h
    covered = []
    o = 0
    for g in range(blocks):
        pieces, _ = fd._slice(fp.dims, g, blocks)
        cols = dict((k, c) for k, c, _ in pieces)
        units = list(cols['wx'])
        covered += units
        for name, c, k in pieces:
            n = len(c) * k
            if name.startswith(('wi', 'wh')):
                assert list(c) == [gate * h + u for u in units for gate in range(3)]
                piece = fp.wbuf[o:o + n].view(len(units), 3, k)
                for i, u in enumerate(units):
                    for gate in range(3):
                        assert torch.equal(piece[i, gate], fp.w[name][:, gate * h + u])
            o += fd._up8(n)
    assert covered == list(range(h))


def test_in_place_edit_reaches_the_tiled_buffer():
    fp = fd.fold_params(_cell(True), torch.float32, blocks=3)
    fp.w['ws'].mul_(2.0)
    fp.w['wi1'][5, 7] = 123.0
    fd.retile(fp)
    mats, ws_copies, _ = _reassemble(fp)
    assert torch.equal(mats['wi1'], fp.w['wi1']) and float(mats['wi1'][5, 7]) == 123.0
    assert all(torch.equal(c, fp.w['ws']) for c in ws_copies)


def test_smem_bytes_counts_the_layout():
    """G = 4 divides every default width, so each block holds a quarter of
    each matrix and all of ws: 80*64 + 512*128 + 4*(512*384) + 512*32 +
    768*100 + 768*5 = 954112 weights.  Then float32: the location matrix
    31*128, RB = 4 padded rows of 80 + 2*512 inputs (phase 1 stages prev
    and both GRU states side by side), gi and two gh of 4 x 384, 4 x 48
    alignment, 4 x 8 stop, fin/rows/slot of 4 and 4 misc, and a 32-float
    window per warp (512 threads)."""
    floats = 31 * 128 + 4 * 1104 + 3 * 4 * 384 + 4 * 48 + 4 * 8 + 3 * 4 + 4 + 512
    assert floats == 13744
    assert fd.smem_bytes(DEFAULT, 48, 1, 4, 2) == 2 * 954112 + 4 * floats
    assert fd.smem_bytes(DEFAULT, 48, 1, 4, 4) == 4 * 954112 + 4 * floats
    assert fd.smem_bytes(DEFAULT, 48, 1, 4, 2, staged=False) == 4 * floats
    # B = 8 rows: two RB chunks, fin/rows/slot of 8
    floats8 = 31 * 128 + 8 * 1104 + 3 * 8 * 384 + 8 * 64 + 8 * 8 + 3 * 8 + 4 + 512
    assert fd.smem_bytes(DEFAULT, 64, 8, 4, 2) == 2 * 954112 + 4 * floats8
    # the serving shapes fit one block per SM at G = 132, bf16 and float32
    for b, n in ((1, 48), (8, 64), (8, 128)):
        for wsize in (2, 4):
            assert fd.smem_bytes(DEFAULT, n, b, 132, wsize) <= fd.SMEM_BUDGET_BYTES


def test_scratch_floats_counts_the_vectors():
    # 4 barrier words; prenet act, 2 x, q, energies, ctxn; carry h, ctx, cum, prev
    b, n = 3, 20
    want = 4 + 256 * b + 2 * 512 * b + 128 * b + n * b + 256 * b + 2 * 512 * b \
        + 256 * b + n * b + 80 * b
    assert fd.scratch_floats(DEFAULT, n, b) == want
