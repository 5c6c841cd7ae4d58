#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure ends the run with a non-zero
exit:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA source in ``transtacos_retunegan_tpu_torch/csrc`` with the
   ``-Xptxas -v`` report (registers, shared memory, spills).
2. Each kernel against its plain PyTorch version.  The decode kernels run
   a cooperative grid of one block per SM (G, printed first, must exceed
   B).  At the full default width (H=512, A=128, D=256, r=5, M=80, 2 GRUs,
   prenet 256), N in {48, 128}, B in {1, 4}, 300 steps, float32 and bf16
   weights: ``decode_step`` looped, ``decode_full`` with and without early
   exit; every case without a stop, and the B=4 cases again with rows that
   stop at different steps.  Then bf16 rows decoded at B=8 against the same
   rows decoded at B=1, bit for bit, by both kernels.  The LSA step at the
   JAX test's shape and the decoder's serving shapes, with short texts and
   an all-masked row; then at the GPU tests' shapes (N from 1 to 256, kwin
   5, 31, 63) with full rows, a row that ends inside the first CTA's tile
   and an all-masked row, each B=8 row against the same row at B=1 and two
   launches against each other, bit for bit.
3. Timing with CUDA events after warm-up (decode at B=1, N=48, 300 steps;
   ``decode_full`` also at the cohort shapes B=8, N in {16, 64}; LSA step
   at B=8, N=64), beside the bound computed from the shapes; each decode
   kernel's device time alone (torch.profiler); and the barrier-only
   floor: the same grid and barriers per step with no math.  The LSA
   step's device time alone (torch.profiler), and, at B=8 with N in {64,
   128, 256} and at B=1, N=64, its launch alone replayed from CUDA graphs
   of 1 and of 100 launches beside its launch floor (``lsa_floor``: an
   empty kernel of the same grid, cluster and shared memory), with its
   cluster size C and tile P.
4. The main path one request at a time: ``Synthesizer(devices=['cuda'])`` at
   the default ``Config()`` with the JAX server's initial weights (no
   checkpoint: the acoustic model from ``PRNGKey(0)``, the generator from
   ``PRNGKey(1)``).  Each request gets a stop
   head under which it stops after the steps its syllables take at the
   training corpus's speaking rate, and its decode on the card is held to
   the plain version on its own encoder memory.  Then, with the launch
   counters set to 0 just before and read just after, it answers
   ``tts_fused`` and ``tts`` requests and three ``GET /synth`` through the
   HTTP server; one request is made to exceed the shared-memory fit check
   so that it takes the per-step kernel.
5. The batched path the app serves by default: 8 texts in one text bucket
   with one stop head under which each stops at its own step.  With the
   counters at 0, ``tts_batch`` answers cohorts of 1, 2, 4 and 8 texts (one
   ``decode_full`` launch each) and the batching server answers 8
   concurrent and 8 serial ``GET /synth``, each concurrent wav bit-identical
   to its serial one.  Before that run, each cohort's decode is held to the
   plain version and to its rows decoded alone (bit-identical), and each
   stage's dependence on its batch shape is measured.
6. The per-stage time of one request, the latency of each request, the
   cost of a fresh thread, and the wav of a small configuration on the card
   against the same ``Synthesizer`` on the CPU.
7. Vocoder training at the default ``Config()`` (``RefineGAN_small`` at 256
   channels, B=16, 8192-sample segments, full discriminators, float32 with
   TF32 off) on a seeded tone corpus (``tools/tone_corpus.py``):
   ``train_vocoder`` for 3 epochs with a checkpoint at step 10, then a
   restart that resumes from it (every metric finite, every family's
   parameters moved); the loader's host time per batch; the first step at
   B=2 on the card against the CPU; each of the 12 generators on the card
   against the CPU and under bf16 autocast; the GAN step's time (median and
   quartiles by CUDA events), its split into generator forward,
   discriminator phase and generator phase, throughput and peak memory, in
   float32 and bf16, and loss_mstft falling on one fixed batch (its
   weight raised, so that it leads the generator's gradient).  This path
   launches none of the three kernels.
8. Acoustic training at the default ``Config()`` (H=512, A=128, D=256,
   r=5, two GRUs, prenet 256, the 'sa' encoder with fusenet, B=16, float32
   with TF32 off): first the whole-decode kernel on a seeded stock cell
   against the same cell in the fused ``fast_cell`` layout; then a seeded
   synthetic Mandarin corpus (``tools/synth_corpus.py``) at DataBaker's
   mean utterance length, its frame distribution and the loader's host
   time; ``train_acoustic`` to step 24 with a checkpoint at step 20, then a
   restart that resumes from it to step 30 (step counter and optimizer
   state restored, every loss finite; training launches no kernel); the
   checkpoint serving one ``tts_fused`` request through ``decode_full``;
   the hoisted and the scanned step's time (median and quartiles by CUDA
   events), remat on and off, with peak memory; launches per step, device
   busy share and the largest kernels (``tools/acoustic_step_profile.py``);
   mel+mag L1 falling on one fixed batch; one hoisted and one scanned step
   on the card against the CPU.
9. Data parallelism (``transtacos_retunegan_tpu_torch/parallel``) at the
   default ``Config()``: (i) an NCCL group of world size 1 in this process,
   the acoustic (hoisted) and the GAN step bit for bit as without a group
   (deterministic algorithms on, see ``deterministic``; the step without
   a group run twice first as the control), and both steps' times with and without
   the group (the all-reduce's own cost); (ii) two spawned processes in a
   gloo group on ``cuda:0``, each on half of the global batch (8 rows):
   the losses and the averaged gradients against this process's step on
   the whole batch, in float32 (the acoustic step held to
   ``DP_ACOUSTIC_TOL``; the GAN step's figure printed beside
   ``DP_GAN_TOL``) and in float64 (``DP_F64_TOL``); the float32 GAN step
   (deterministic algorithms) against this process's step on the same two
   half-batches, summed in rank order (``paired_ranks``; ``DP_PAIR_TOL``);
   the ranks' parameters bit for bit after timed float32 steps, and the
   two-rank step times;
   (iii) ``Synthesizer(devices=['cuda:0', 'cuda:0'])`` (``--dp 2`` on one
   card): with the launch counters at 0, cohorts of 8 texts, one
   ``decode_full`` launch per replica, bit for bit as one replica at 4
   rows, and the cohort's time against one replica at 8 rows.
10. The host side and the vocoder tools at the default ``Config()``: the
   native Griffin-Lim library (``data/native.py``) built on this machine
   from ``native/ttsdsp.cpp``, templates with it and with numpy on 1 and 4
   threads, and the vocoder loader's first epoch with each (``num_workers``
   1 and 4); a seeded RefineGAN_small
   checkpoint in the reference RetuneGAN's layout imported
   (``tools/import_reference_ckpt.py``) and served by
   ``Synthesizer(devices=['cuda'])`` with the launch counters at 0 (one
   10-syllable request through ``decode_full``), bit for bit as the same
   weights loaded with ``from_flax``; ``serve/infer_vocoder.py``'s CLI over
   a folder of 3 mags and 2 wavs on the card against the CPU (``INFER_TOL``);
   ``train_acoustic --device_data`` (``data/device_data.py``) against the
   streaming feeder: its batches (float16 store, ``STORE_TOL``), step time,
   host-to-device bytes per step and the corpus's bytes on the card; a
   closed-loop ``tools/serving_latency.py`` load.
11. Tensor parallelism (``--model_parallel``) at the default ``Config()``:
   two spawned processes in a gloo group on ``cuda:0`` with a model axis of
   2 (one data shard), each holding half of every leaf the JAX package's
   ``tp_param_specs`` shards: one hoisted acoustic step on phase 9's global
   batch against this process's, in float32 (``DP_ACOUSTIC_TOL``) and in
   float64 (``DP_F64_TOL``); the parameters and Adam moments each rank
   holds; each rank's step time (no claim); the GAN step with the model
   axis bit for bit as one process's under deterministic algorithms; and
   the gathered checkpoint of the two ranks served by a ``Synthesizer``
   with the launch counters at 0 (one ``decode_full`` launch, a finite
   wav).
12. Run dirs at the default ``Config()``: (i) ``serve.app``'s ``start()``
   on the card with ``--acoustic_dir`` on phase 8's run and
   ``--vocoder_dir`` on phase 7's, one ``GET /synth`` with the launch
   counters at 0 (one ``decode_full`` launch), its WAV bit for bit as the
   same checkpoints loaded by hand; (ii) phase 8's run exported in the
   JAX package's layout with ``weights.to_flax`` (as
   ``export_jax_run.py`` writes a JAX run, Adam's moments included),
   imported by ``tools/import_jax_run.py`` (the checkpoint bit for bit as
   the original), resumed by ``train_acoustic`` for 2 steps beside a copy
   of the unconverted run (the first step's losses within
   ``RESUME_TOL``), then served through ``--acoustic_dir`` (one
   ``decode_full`` launch).
13. The training-quality study tools (``transtacos_retunegan_tpu_torch/tools``)
   on the card, their trainers as subprocesses there: ``convergence_session``
   at the default ``Config()`` with short legs (``STUDY_CONVERGENCE``): every
   held-out loss, alignment metric and vocoder-against-Griffin-Lim metric
   finite, the report and CSVs written,
   one launch per held-out text and one for its ``tts``; ``decay_session``
   on the same corpus (``STUDY_DECAY``): two segments, the second resuming
   from the first, the hoisted step before ``tf_start_decay`` and the
   scanned one after (``hoist_force_eligible`` at each step), the table's
   ratios equal to both schedules', one launch per text at each
   evaluation; on the convergence session's runs ``coverage_diagnosis``
   (one launch per text), ``draw_embd_sim`` (symmetric similarities with a
   unit diagonal), ``bf16_ab`` (both dtypes finite, the deviation
   printed), ``variant_ranking`` over the GAN leg and
   ``dsp_studies.run_all``; ``sanity_train`` at its defaults (300
   acoustic and 150 GAN steps asked at its reduced widths; its four checks
   and their margins; its synthesis one ``decode_full`` launch).
   ``sanity_train`` and, once the convergence corpus is built,
   ``decay_session`` run on threads beside ``convergence_session`` (the
   trainers are processes; each evaluation that launches a kernel holds
   ``EVALUATING`` while its launches are counted); each
   tool's time, and within the sessions the time of each corpus build,
   trainer run and evaluation.
14. The timing and equivalence tools (``transtacos_retunegan_tpu_torch/tools``)
   on the card at the default ``Config()``, in this process, repetitions cut
   (``TOOL_RUNS``): ``pallas_equivalence`` (the four decode paths against
   the stepped cell, 40 steps; its non-zero exit fails the run),
   ``acoustic_step_ab``, ``profile_stages``, ``acoustic_step_trace``,
   ``train_scaling --batches 16,32 --stages`` and ``bench_precision``; each
   tool's JSON and time, and the phase's ``decode_step``/``decode_full``
   launches held to ``TOOL_LAUNCHES``.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20250101
STEPS = 300
REQUESTS = ('ni3 hao3 shi4 jie4',
            'wo3 men5 yi4 qi3 qu4 gong1 yuan2 san4 bu4 ba5',
            'jin1 tian1 tian1 qi4 hen3 hao3 wo3 men5 yi4 qi3 qu4 gong1 yuan2 '
            'san4 bu4 ba5')
# Speaking rate of the reference's training corpus: DataBaker, after its
# 2-sigma filter, averages 307 spectrogram frames for 16.1 pinyin syllables
# (the reference's stats/DataBaker.stats, quoted in BASELINE.md), at the
# 22050 Hz and hop 256 of this Config.  The last request has the corpus's
# mean length.
FRAMES_PER_SYLLABLE = 307 / 16.1
HBM_BYTES_PER_S = 3.35e12              # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12,    # dense bf16 tensor-core rate
            torch.float32: 67e12}      # float32 outside the tensor cores
# kernel vs plain, per output on its own scale (``errors``): float32
# weights differ by summation order only.  With bf16 weights an order
# difference can flip the bf16 rounding of one activation, which the
# 300-step recurrence carries: 5e-2 absolute on the mel (as the JAX
# package's test_bf16_close), 5e-2 of the stop logits' scale, and 1e-1
# relative on the alignment weights, which a wrong stencil, mask or softmax
# gets wrong by about the whole weight.
OUTPUTS = ('mel', 'stop', 'align')
TOL = {torch.float32: {'mel': 1e-3, 'stop': 1e-3, 'align': 1e-3},
       torch.bfloat16: {'mel': 5e-2, 'stop': 5e-2, 'align': 1e-1}}
SLICE_TOL = 1e-3                       # card vs CPU wav, small config, float32
# The batched path: 8 distinct texts in one text bucket (16 ids), of 1 to 5
# syllables; cohorts of 1, 2, 4 and 8 are their prefixes, up to the app's
# default --max_batch 8.
BATCH_TEXTS = ('ni3 hao3 shi4 jie4', 'da4 jia1 hao3', 'yi1 er4 san1 si4 wu3',
               'xie4 xie5', 'wo3 men5 yi4 qi3', 'wo3 ai4 ni3', 'ma1 ma5 ai4 wo3 a1', 'a1')
COHORTS = (1, 2, 4, 8)
BATCH_REPS = 5
# Concurrent against serial GET /synth: bit-identical.  cuBLAS and cuDNN
# pick their algorithms by shape, so a row's result depends on the batch
# shape it ran in, and the bf16 decode and generator carry a last-bit
# difference into the wav (phase 5 measures both); the batching frontend
# therefore runs both stages of every cohort at max_batch rows.
# The LSA step (B, N, A, D, kwin): the JAX test's shape, then the decoder's
# serving shapes, B in {1, 8} and N in {16, 64}, and a 5-tap window.
LSA_CASES = ((4, 128, 128, 256, 31), (1, 16, 128, 256, 31), (1, 64, 128, 256, 31),
             (8, 16, 128, 256, 31), (8, 64, 128, 256, 31), (8, 64, 128, 256, 5))
LSA_TIMED = (8, 64, 128, 256, 31)
# The GPU tests' LSA shapes (B, N, kwin) at A=128, D=256, with the text
# lengths of ``cluster_lens``; and the (B, N) of the graph-replay timing.
LSA_CLUSTER_CASES = ((1, 1, 31), (1, 17, 31), (8, 64, 31), (8, 64, 5), (4, 128, 63),
                     (8, 256, 31))
LSA_REPLAYED = ((8, 64), (1, 64), (8, 128), (8, 256))
# decode_full timing: one request (B=1, N=48) and the cohort shapes
DECODE_TIMED = ((1, 48), (8, 16), (8, 64))
# tests/test_ops.py's bounds on (align, cum, ctx); float32 sums in another order
LSA_TOL = (1e-5, 1e-5, 1e-4)
# Vocoder training (phase 7): a tone corpus of 1-4 s utterances, 4 steps
# per epoch at the default B=16; GAN steps timed after a warm-up on one
# fixed batch.  From the seeded start, Adam's first updates (each weight
# moves by about lr, a large step for the small weight-norm directions)
# make loss_mstft on a fixed batch swing for several steps, and at the
# default loss weights the adversarial terms move it too (on an H100 the
# mean of steps 10-14 against steps 0-4 ranged from 0.79 to 0.99).  So the
# check that the step learns runs MSTFT_STEPS steps from the seeded start
# with the mstft weight MSTFT_BOOST times the default, where that loss
# leads the generator's gradient: the mean of the last 5 must be below
# MSTFT_FALL times the loss before the first update (0.61-0.68 in four
# runs on an H100).  Card against CPU, float32 with TF32
# off: the first step's losses and scores (STEP_TOL relative), the
# parameters as in the CPU tests, generator outputs in (-1, 1) (GEN_TOL).
# The gradients are printed, not held: cuDNN's float32 algorithms and the
# CPU's sum in other orders, and some leaves' gradients cancel to a small
# fraction of their terms (the noise weight's: 13% apart on an H100).
TRAIN_UTTS, TEST_UTTS = 68, 4
GAN_WARM, GAN_TIMED, MSTFT_STEPS, MSTFT_BOOST, MSTFT_FALL = 3, 12, 15, 50.0, 0.9
STEP_TOL, GEN_TOL = 1e-3, 1e-4
# Acoustic training (phase 8): a synthetic corpus at DataBaker's mean
# utterance length; step times by CUDA events after a warm-up; card
# against CPU with the same weights, batch and dropout masks, float32 with
# TF32 off: losses within ACOUSTIC_LOSS_TOL relative, gradients within
# ACOUSTIC_GRAD_TOL of each leaf's norm; mel+mag L1 on a fixed batch below
# DESCENT_FALL of its start after DESCENT_STEPS steps with the Noam
# warm-up shortened to DESCENT_WARMUP steps.  The four step timings take
# STEP_TIMED steps after STEP_WARM, few enough that the whole script stays
# inside its time limit (phase 14 times the same steps again).
ACOUSTIC_UTTS, SYLLABLES = 160, (8, 16)
STEP_WARM, STEP_TIMED, PROFILED = 1, 6, 1
ACOUSTIC_LOSS_TOL, ACOUSTIC_GRAD_TOL = 1e-4, 1e-3
DESCENT_STEPS, DESCENT_WARMUP, DESCENT_FALL = 40, 40, 0.9


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def full_width_cell(device):
    """The decoder cell at the default Config with seeded weights and small
    non-zero biases (a trained checkpoint's location-conv bias included)."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.decoder import DecoderCell
    from transtacos_retunegan_tpu_torch.weights import seeded_init
    cell = seeded_init(DecoderCell(Config()), SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            if name.endswith('bias'):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return cell.to(device)


def memory(dims, b: int, n: int, device, seed: int):
    """Encoder memory for the decode: keys [B,N,A], masked values [B,N,D],
    mask [B,N] with a different text length per row."""
    r = np.random.RandomState(seed)
    keys = 0.5 * r.randn(b, n, dims.a)
    values = 0.5 * r.randn(b, n, dims.d)
    lens = n - 7 * np.arange(b)
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.float64)
    values = values * mask[..., None]
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (keys, values, mask))


def stop_logits(fd, fp, mem, steps, decode=None):
    """Largest of the r stop logits per row and step, [B, steps], of a
    decode (the plain version unless ``decode`` is given) in which the stop
    bias is -20 and no row stops."""
    fp.f['bs'].fill_(-20.0)
    out = fd.to_outputs(fp, *(decode or fd.decode_full_plain)(fp, *mem, steps))
    if (out['out_lengths'] < steps * fp.dims.r).any():
        raise RuntimeError('a row stopped while probing the stop logits')
    p = out['stop_token_outputs'].double().cpu().numpy()
    z = np.log(p) - np.log1p(-p) + 20.0
    return z.reshape(p.shape[0], steps, fp.dims.r).max(-1)


def distinct_stop_bias(z: np.ndarray, margin: float = 0.05):
    """A stop bias under which the rows stop at different steps (a row that
    never stops counts as one more outcome), with at least one row stopping
    before the last step, and no logit within ``margin`` of the threshold
    (so that rounding cannot move a stop).  Until a row stops its
    trajectory does not depend on the bias, so with bias -c row b stops at
    the first step whose logit reaches c.  Among such thresholds the one
    with the most distinct outcomes, then the widest margin, wins.
    Returns (c, stop steps) or None."""
    best = None
    vals = np.unique(z)
    steps = z.shape[1]
    for c in (vals[1:] + vals[:-1]) / 2:
        hit = z >= c
        first = np.where(hit.any(1), hit.argmax(1), steps)
        gap = float(np.abs(z - c).min())
        if gap < margin or first.min() >= steps - 1:
            continue
        score = (len(set(first.tolist())), gap)
        if score[0] > 1 and (best is None or score > best[0]):
            best = (score, c, first)
    return None if best is None else best[1:]


def stop_logit(p: torch.Tensor) -> torch.Tensor:
    """Stop probabilities -> logits in float64, clipped to [-80, 8]: above 8
    a float32 probability no longer resolves the logit, and the 0 that a
    finished row emits maps to -80."""
    p = p.double().clamp(min=1e-300)
    return (torch.log(p) - torch.log1p(-p)).clamp(-80.0, 8.0)


def errors(fp, got, ref):
    """Differences of two decodes, each output on its own scale: 'mel'
    absolute; 'stop' on the logits, over the largest emitted reference
    logit without its bias (at least 1); 'align' relative to the larger of
    the reference weight and the uniform weight 1/N; 'abs' the largest
    absolute difference of the three.  Raises unless out_lengths agree."""
    if not torch.equal(got['out_lengths'], ref['out_lengths']):
        raise AssertionError(f"out_lengths {got['out_lengths'].tolist()} != "
                             f"{ref['out_lengths'].tolist()}")
    zr = stop_logit(ref['stop_token_outputs'])
    emitted = ref['stop_token_outputs'] > 0
    scale = max(1.0, float((zr - float(fp.f['bs'][0]))[emitted].abs().max()))
    a_ref = ref['alignments']
    return {
        'mel': float((got['mel_outputs'] - ref['mel_outputs']).abs().max()),
        'stop': float((stop_logit(got['stop_token_outputs']) - zr).abs().max()) / scale,
        'align': float(((got['alignments'] - a_ref).abs()
                        / a_ref.clamp(min=1.0 / a_ref.shape[1])).max()),
        'abs': max(float((got[k] - ref[k]).abs().max())
                   for k in ('mel_outputs', 'stop_token_outputs', 'alignments'))}


def within(errs, dtype) -> bool:
    return all(errs[k] <= TOL[dtype][k] for k in OUTPUTS)


def err_text(errs, dtype) -> str:
    return (' '.join(f'{k}={errs[k]:.2e}/{TOL[dtype][k]:.0e}' for k in OUTPUTS)
            + f' abs={errs["abs"]:.2e} {"ok" if within(errs, dtype) else "FAIL"}')


def grid_check(fd, device) -> int:
    """One ``decode_full`` launch at B=1: the grid is cooperative, one
    block per SM, so G > B.  Returns G."""
    fp = fd.fold_params(full_width_cell(device), torch.bfloat16)
    mem = memory(fp.dims, 1, 48, device, seed=1)
    fd.decode_full(fp, *mem, 2)
    torch.cuda.synchronize()
    g = fd.LAST_GRID['decode_full']
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f'  decode_full launched as a cooperative grid of G={g} blocks x {fd.THREADS} '
        f'threads for B=1 ({sms} SMs), {fd.barriers_per_step(fp.dims)} grid barriers '
        f'per step, {fd.smem_bytes(fp.dims, 48, 1, g, 2)} bytes of shared memory per block')
    if not (g and g > 1 and g == fp.blocks):
        raise AssertionError(f'decode_full grid {g}, expected {fp.blocks} > B')
    return g


def batch_invariance(fd, device, b: int = 8, n: int = 64, steps: int = STEPS):
    """bf16 rows decoded in a batch of ``b`` against the same rows decoded
    alone: ``decode_full`` over ``steps`` steps with rows that stop at
    different steps and early exit, ``decode_step`` looped over 20 steps
    from a zero carry.  Bit for bit."""
    fp = fd.fold_params(full_width_cell(device), torch.bfloat16)
    mem = memory(fp.dims, b, n, device, seed=11)
    found = None
    for gain in (1.0, 10.0, 30.0):
        fp = fd.fold_params(full_width_cell(device), torch.bfloat16)
        fp.w['ws'].mul_(gain)
        found = distinct_stop_bias(stop_logits(fd, fp, mem, steps, fd.decode_full))
        if found:
            break
    if found:
        fp.f['bs'].fill_(-found[0])
    else:
        fp.f['bs'].fill_(-20.0)
    row = lambda i: tuple(x[i:i + 1].contiguous() for x in mem)        # noqa: E731
    full = fd.fused_decode_full(fp, *mem, steps, early_exit=True)
    looped = fd.fused_decode(fp, *mem, 20)
    same_full = [all(torch.equal(a[k][0], full[k][i]) for k in full)
                 for i, a in enumerate(fd.fused_decode_full(fp, *row(i), steps, early_exit=True)
                                       for i in range(b))]
    same_step = [all(torch.equal(a[k][0], looped[k][i]) for k in looped)
                 for i, a in enumerate(fd.fused_decode(fp, *row(i), 20) for i in range(b))]
    torch.cuda.synchronize()
    log(f'  B={b} N={n} bf16 rows against the same rows at B=1, bit for bit: decode_full '
        f'({steps} steps, early exit, lengths {full["out_lengths"].tolist()}) '
        f'{sum(same_full)}/{b}; decode_step (20 steps) {sum(same_step)}/{b}')
    if not (all(same_full) and all(same_step)):
        raise AssertionError('a row decoded in a batch differs from the row decoded alone')


def compare_kernels(fd, device):
    cell = full_width_cell(device)
    worst = {'decode_step': 0.0, 'decode_full': 0.0}
    scaled = {dtype: dict.fromkeys(OUTPUTS, 0.0) for dtype in TOL}
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (48, 128):
            for b in (1, 4):
                for regime in ('no-stop', 'rows-stop') if b > 1 else ('no-stop',):
                    fp = fd.fold_params(cell, dtype)
                    mem = memory(fp.dims, b, n, device, seed=n + b)
                    if regime == 'rows-stop':
                        found = None
                        for gain in (1.0, 10.0, 30.0):
                            fp = fd.fold_params(cell, dtype)
                            fp.w['ws'].mul_(gain)
                            found = distinct_stop_bias(stop_logits(fd, fp, mem, STEPS))
                            if found:
                                break
                        if not found:
                            raise RuntimeError('no stop bias separates the rows')
                        fp.f['bs'].fill_(-found[0])
                    else:
                        fp.f['bs'].fill_(-20.0)
                    plain = fd.to_outputs(fp, *fd.decode_full_plain(fp, *mem, STEPS))
                    plain_ee = fd.to_outputs(
                        fp, *fd.decode_full_plain(fp, *mem, STEPS, early_exit=True))
                    lengths = plain['out_lengths'].tolist()
                    if regime == 'rows-stop':
                        want = (np.minimum(found[1] + 1, STEPS) * fp.dims.r).tolist()
                        if lengths != want or len(set(lengths)) < 2:
                            raise AssertionError(f'rows stop at {lengths}, not {want}')
                    runs = (('decode_step', fd.fused_decode(fp, *mem, STEPS), plain),
                            ('decode_full', fd.fused_decode_full(fp, *mem, STEPS), plain),
                            ('decode_full', fd.fused_decode_full(
                                fp, *mem, STEPS, early_exit=True), plain_ee))
                    torch.cuda.synchronize()
                    for (kernel, got, ref), mode in zip(runs, ('looped', 'no-exit', 'early-exit')):
                        errs = errors(fp, got, ref)
                        worst[kernel] = max(worst[kernel], errs['abs'])
                        for k in OUTPUTS:
                            scaled[dtype][k] = max(scaled[dtype][k], errs[k])
                        log(f'  {kernel:11s} {mode:10s} {str(dtype)[6:]:8s} N={n:3d} '
                            f'B={b} {regime:9s} lengths={lengths} ' + err_text(errs, dtype))
                        if not within(errs, dtype):
                            failures.append((kernel, mode, dtype, n, b, regime))
    for dtype, errs in scaled.items():
        log(f'  largest {str(dtype)[6:]}: '
            + ' '.join(f'{k}={v:.2e}' for k, v in errs.items()))
    if failures:
        raise AssertionError(f'kernels disagree with their plain versions: {failures}')
    return worst


# ---------------------------------------------------------------------------
# phase 3: timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int, kernel: str):
    """Mean device time per call of the kernels whose name contains
    ``kernel``, from torch.profiler over ``calls`` calls of ``fn`` (without
    the wrapper's host work); None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, 'device_time_total', 0) or getattr(e, 'cuda_time_total', 0)
          for e in prof.key_averages() if kernel in e.key]
    return sum(us) / 1e3 / calls if us and sum(us) > 0 else None


def step_cost(fp, b: int, n: int):
    """(matmul operations, other operations) of one decode step."""
    d = fp.dims
    weights = sum(t.numel() for t in fp.w.values())
    mm = 2 * b * weights
    other = b * (n * (2 * d.kwin * d.a + 4 * d.a + 2 * d.d + 6)
                 + 12 * d.n_gru * d.h + 2 * d.r * (d.n_mel + 1))
    return mm, other


def bound(fp, b: int, n: int, steps: int, carry_bytes: int):
    """Least time on the card: every input read once and every output
    written once over the memory rate, or the operations over the peak rate
    of their type, whichever is larger.  Returns (ms, 'bytes'|'operations')."""
    d = fp.dims
    weights = sum(t.numel() for t in fp.w.values())         # each weight once
    io_bytes = (weights * fp.wsrc.element_size() + fp.fbuf.numel() * 4
                + 4 * b * n * (d.a + d.d + 1)                      # keys, values, mask
                + 4 * steps * b * (d.r * d.n_mel + d.r + n + 1)    # emissions
                + carry_bytes)
    mm, other = step_cost(fp, b, n)
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = steps * (mm / PEAK_OPS[fp.wsrc.dtype] + other / PEAK_OPS[torch.float32])
    return (1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def time_kernels(fd, device):
    cell = full_width_cell(device)
    fp = fd.fold_params(cell, torch.bfloat16)        # the serving weights
    fp.f['bs'].fill_(-20.0)                          # every step runs
    b, n = 1, 48
    mem = memory(fp.dims, b, n, device, seed=7)
    prev, ctx, hs, cum, fin = fd._zero_carry(fp, b, n, device)
    d = fp.dims
    carry_bytes = 4 * b * (d.n_mel + d.d + d.n_gru * d.h + n + 1)
    res = {}
    step_ms = cuda_ms(lambda: fd.decode_step(fp, prev, ctx, hs, cum, *mem, fin), 100)
    step_plain = cuda_ms(lambda: fd.decode_step_plain(fp, prev, ctx, hs, cum, *mem, fin), 100)
    res['decode_step'] = dict(ms=step_ms, plain_ms=step_plain,
                              bound=bound(fp, b, n, 1, 2 * carry_bytes))
    full_ms = cuda_ms(lambda: fd.decode_full(fp, *mem, STEPS), 5)
    full_plain = cuda_ms(lambda: fd.decode_full_plain(fp, *mem, STEPS), 3, warm=1)
    res['decode_full'] = dict(ms=full_ms, plain_ms=full_plain,
                              bound=bound(fp, b, n, STEPS, 0))
    for k, v in res.items():
        log(f'  {k}: kernel {v["ms"]:.4f} ms, plain {v["plain_ms"]:.4f} ms, bound '
            f'{v["bound"][0]:.6f} ms ({v["bound"][1]}) per call, B={b} N={n} bf16 weights'
            + (f', {STEPS} steps' if k == 'decode_full' else ', one step'))
    log(f'  decode_step looped over a {STEPS}-step decode: '
        f'{STEPS * step_ms:.3f} ms kernel, {STEPS * step_plain:.3f} ms plain')
    alone = {'decode_step': device_ms(lambda: fd.decode_step(fp, prev, ctx, hs, cum, *mem, fin),
                                      50, 'decode_step_kernel'),
             'decode_full': device_ms(lambda: fd.decode_full(fp, *mem, STEPS), 3,
                                      'decode_full_kernel')}
    log('  device time of the kernel alone (torch.profiler), B=1 N=48: ' + ', '.join(
        f'{k} ' + ('not measured' if v is None else f'{v:.4f} ms') for k, v in alone.items()))
    per_step = fd.barriers_per_step(d)
    for b, n in DECODE_TIMED:
        mem = memory(fp.dims, b, n, device, seed=7)
        ms = full_ms if (b, n) == (1, 48) else cuda_ms(
            lambda: fd.decode_full(fp, *mem, STEPS), 5)
        floor = cuda_ms(lambda: fd.grid_barriers(fp, b, n, STEPS * per_step, device), 5)
        log(f'  decode_full B={b} N={n:3d}: {ms:.4f} ms per {STEPS}-step decode, '
            f'{1e3 * ms / STEPS:.2f} us per step; barrier-only floor ({per_step} grid '
            f'barriers per step, G={fd.LAST_GRID["decode_full"]}): {floor:.4f} ms, '
            f'{1e3 * floor / STEPS:.2f} us per step ({100 * floor / ms:.0f}%)')
    return res


# ---------------------------------------------------------------------------
# phases 2-3: the LSA step kernel (no path of the system calls it)
# ---------------------------------------------------------------------------

def lsa_inputs(device, b: int, n: int, a: int, d: int, kwin: int, seed: int, lens=None):
    """``tests/test_ops.py``'s LSA inputs; text lengths ``lens``, by default
    falling from N in the first row to 0 (every position masked) in the
    last, or N - 3 for B=1."""
    r = np.random.RandomState(seed)
    if lens is None:
        lens = np.rint(n * (1 - np.arange(b) / (b - 1))) if b > 1 else [n - 3]
    mask = (np.arange(n)[None] < np.asarray(lens)[:, None]).astype(np.float64)
    xs = (r.randn(b, a), np.abs(r.randn(b, n)), 0.1 * r.randn(b, n, a),
          r.randn(b, n, d), mask, 0.05 * r.randn(kwin, a), 0.1 * r.randn(a),
          0.01 * r.randn(a))
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in xs]


def compare_lsa(lk, device):
    """lsa_step against lsa_step_plain at the JAX test's shape and the
    decoder's serving shapes; returns the largest absolute difference."""
    worst, failures = 0.0, []
    for b, n, a, d, kwin in LSA_CASES:
        args = lsa_inputs(device, b, n, a, d, kwin, seed=b * n + kwin)
        got = lk.lsa_step_fused(*args)
        ref = lk.lsa_step_plain(*args)
        torch.cuda.synchronize()
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        ok = all(e <= tol for e, tol in zip(errs, LSA_TOL))
        if b > 1:           # the all-masked row: zeros, as the Pallas kernel gives
            ok = ok and not got[0][-1].any() and not got[2][-1].any()
        worst = max([worst] + errs)
        log(f'  lsa_step B={b} N={n:3d} A={a} D={d} kwin={kwin:2d}: align {errs[0]:.2e}, '
            f'cum {errs[1]:.2e}, ctx {errs[2]:.2e} (tol {LSA_TOL[0]:.0e}, {LSA_TOL[1]:.0e}, '
            f'{LSA_TOL[2]:.0e}) {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append((b, n, kwin))
    if failures:
        raise AssertionError(f'lsa_step disagrees with its plain version: {failures}')
    return max(worst, compare_lsa_clusters(lk, device))


def cluster_lens(lk, b: int, n: int):
    """Text lengths of the cluster cases: full rows; for B > 1 the second
    row ends inside the first CTA's tile (every other CTA of its cluster
    sees only masked positions) and the third, for B > 2, is all masked."""
    lens = [n] * b
    if b > 1:
        lens[1] = max(1, lk.lsa_plan(n)[1] // 2)
    if b > 2:
        lens[2] = 0
    return lens


def compare_lsa_clusters(lk, device):
    """lsa_step against lsa_step_plain at ``LSA_CLUSTER_CASES``; the
    all-masked row gives zeros; each row of a B > 1 launch is bit-identical
    to the same row launched alone, and two launches to each other.
    Returns the largest absolute difference."""
    worst, failures = 0.0, []
    for b, n, kwin in LSA_CLUSTER_CASES:
        lens = cluster_lens(lk, b, n)
        args = lsa_inputs(device, b, n, 128, 256, kwin, seed=n + kwin, lens=lens)
        got = lk.lsa_step_fused(*args)
        again = lk.lsa_step_fused(*args)
        ref = lk.lsa_step_plain(*args)
        rows = [lk.lsa_step_fused(*(x[i:i + 1].contiguous() if k < 5 else x
                                    for k, x in enumerate(args))) for i in range(b)]
        torch.cuda.synchronize()
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        zero = all(not got[0][i].any() and not got[2][i].any()
                   for i, ln in enumerate(lens) if ln == 0)
        repeat = all(torch.equal(g, a) for g, a in zip(got, again))
        alone = sum(all(torch.equal(o[0], g[i]) for o, g in zip(row, got))
                    for i, row in enumerate(rows))
        ok = (all(e <= tol for e, tol in zip(errs, LSA_TOL)) and zero and repeat
              and alone == b)
        worst = max([worst] + errs)
        c, p = lk.lsa_plan(n)
        log(f'  lsa_step B={b} N={n:3d} kwin={kwin:2d} (C={c}, P={p}) lengths {lens}: align '
            f'{errs[0]:.2e}, cum {errs[1]:.2e}, ctx {errs[2]:.2e}; all-masked rows zero '
            f'{zero}; two launches bit-identical {repeat}; rows bit-identical to the row '
            f'launched alone {alone}/{b} {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append((b, n, kwin))
    if failures:
        raise AssertionError(f'lsa_step cluster cases failed: {failures}')
    return worst


def lsa_bound(b: int, n: int, a: int, d: int, kwin: int):
    """Least time of one LSA step on the card: inputs read once and outputs
    written once (float32) over the memory rate, or the float32 operations
    (window stencil, energy, softmax, context) over the peak rate."""
    io_bytes = 4 * (b * a + b * n * (a + d + 2) + kwin * a + 2 * a    # inputs
                    + b * (2 * n + d))                                 # outputs
    ops = b * n * (2 * kwin * a + 6 * a + 2 * d + 5)
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def time_lsa(lk, device):
    """Per call through the wrapper, as a caller pays it; the kernel's
    device time alone (torch.profiler); and at ``LSA_REPLAYED`` the launch
    alone, captured once in a CUDA graph and replayed, without the
    wrapper's host work (checks, allocations, the ctypes call), beside the
    launch floor of the same grid (``lsa_floor``), replayed the same way;
    ``floor_ms`` is the floor back to back on the device (``CHAIN`` launches
    per graph)."""
    from transtacos_retunegan_tpu_torch.tools.lsa_ab import CHAIN, replay_ms
    b, n, a, d, kwin = LSA_TIMED
    args = lsa_inputs(device, b, n, a, d, kwin, seed=7)
    res = dict(ms=cuda_ms(lambda: lk.lsa_step_fused(*args), 200, warm=5),
               plain_ms=cuda_ms(lambda: lk.lsa_step_plain(*args), 200, warm=5),
               bound=lsa_bound(b, n, a, d, kwin))
    alone = device_ms(lambda: lk.lsa_step_fused(*args), 200, 'lsa_step_kernel')
    log(f'  lsa_step: kernel {res["ms"]:.4f} ms, plain {res["plain_ms"]:.4f} ms, bound '
        f'{res["bound"][0]:.6f} ms ({res["bound"][1]}) per call, B={b} N={n} A={a} '
        f'D={d} kwin={kwin}; device time of the kernel alone (torch.profiler): '
        + ('not measured' if alone is None else f'{alone:.5f} ms'))
    for bb, nn in LSA_REPLAYED:
        args = lsa_inputs(device, bb, nn, a, d, kwin, seed=7)
        c, p = lk.lsa_plan(nn)
        kernel, floor = ([replay_ms(fn), replay_ms(fn, reps=20, per_graph=CHAIN)]
                         for fn in (lambda: lk.lsa_step_fused(*args),
                                    lambda: lk.lsa_floor(bb, nn, a, d, kwin, device)))
        log(f'  lsa_step B={bb} N={nn:3d} (C={c}, P={p}, grid {c}x{bb}), ms per launch '
            f'replayed from a CUDA graph of 1 / {CHAIN} launches: kernel {kernel[0]:.5f} / '
            f'{kernel[1]:.5f}, launch floor {floor[0]:.5f} / {floor[1]:.5f} '
            f'({kernel[1] / floor[1]:.2f}x back to back); bound '
            f'{lsa_bound(bb, nn, a, d, kwin)[0]:.6f} ms')
        if (bb, nn) == (b, n):
            res['floor_ms'] = floor[1]
    return res


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def stop_bias_near(zs, target: int, margin: float = 0.05):
    """A stop bias under which each decode whose largest bias-free stop
    logit per step is one of ``zs`` stops after the same number of steps,
    the one nearest ``target``.  Until it stops, a decode does not depend on
    the stop bias, so with bias -c it stops at the first step whose logit
    reaches c.  c lies halfway between that step's logit and the largest
    earlier one, where the two are at least ``2 * margin`` apart in every
    decode, so that rounding cannot move the stop.  Returns (bias, steps)."""
    best = None
    for t in range(1, len(zs[0])):
        lo = max(float(z[:t].max()) for z in zs)
        hi = min(float(z[t]) for z in zs)
        if hi - lo >= 2 * margin and (best is None
                                      or abs(t + 1 - target) < abs(best[1] - target)):
            best = (-(lo + hi) / 2, t + 1)
    if best is None:
        raise RuntimeError('no stop bias gives an unambiguous stop step')
    return best


def stop_head(fd, fp, mem, targets) -> torch.Tensor:
    """Seeded weights have no learned stop.  Stop-projection weights
    [H+D, r] under which row b of the decode of ``mem`` stops after
    ``targets[b]`` steps, as a trained model stops at the end of its text.
    The head reads the frame projection (weights ``wf @ c``), so that its
    logit at step t is (frame_t - bf) . c, with ``c`` the minimum-norm
    solution of (frame_{b,t} - bf) . c = t - targets[b] + 1.5 over the first
    ``targets[b]`` frames of every row of the decode kernel: a ramp per row
    that crosses 0 at the last of them.  It is exact while the rows' steps
    add up to less than the frame width rM.  Until it stops, a decode does
    not depend on its stop head."""
    fp.f['bs'].fill_(-1e4)                                  # no stop
    frames = fd.decode_full(fp, *mem, max(targets))[0].double()
    f = torch.cat([frames[:t, b] for b, t in enumerate(targets)]) - fp.f['bf'].double()
    ramp = torch.cat([torch.arange(t, dtype=torch.float64, device=f.device) - t + 1.5
                      for t in targets])
    c = torch.linalg.pinv(f) @ ramp
    return (fp.w['wf'].double() @ c).float()[:, None].expand(-1, fp.dims.r).contiguous()


def plan_requests(fd, synth):
    """For each request: the number of steps its syllable count takes at
    ``FRAMES_PER_SYLLABLE``, a stop head for it (``stop_head``), and the
    stop bias from the stop logits of both the decode kernel and its plain
    version (the step nearest the target at which both stop unambiguously);
    then the kernel against the plain version on the request's own encoder
    memory, with the serving bf16 weights and that head.  Returns
    {text: ((weights, bias), steps)}."""
    r = synth.cfg.acoustic.outputs_per_step
    fp = fd.fold_params(synth.acoustic.decoder_cell)
    plan, failures = {}, []
    with torch.no_grad():
        for text in REQUESTS:
            enc = synth._encode(text)
            mem = (enc['keys'], enc['values'], enc['mask'])
            target = math.ceil(len(text.split()) * FRAMES_PER_SYLLABLE / r)
            ws = stop_head(fd, fp, mem, [target])
            fp.w['ws'].copy_(ws)
            zs = [stop_logits(fd, fp, mem, target + 1, decode)[0]
                  for decode in (fd.decode_full, fd.decode_full_plain)]
            bias, steps = stop_bias_near(zs, target)
            fp.f['bs'].fill_(bias)
            got = fd.fused_decode_full(fp, *mem, synth.max_iters, early_exit=True)
            ref = fd.to_outputs(fp, *fd.decode_full_plain(
                fp, *mem, synth.max_iters, early_exit=True))
            errs = errors(fp, got, ref)
            lengths = ref['out_lengths'].tolist()
            log(f'  {len(text.split())} syllables, N={mem[2].shape[1]}: target '
                f'{target} steps, stops after {steps} (bias {bias:.4f}); decode_full '
                f'early-exit bf16 vs plain: lengths={lengths} ' + err_text(errs, torch.bfloat16))
            if lengths != [steps * r] or not within(errs, torch.bfloat16):
                failures.append(text)
            plan[text] = ((ws, bias), steps)
    if failures:
        raise AssertionError(f'the decode of a request disagrees with its plan: {failures}')
    return plan


def use_stop(synth, head) -> None:
    """Give the served model the stop head (weights [H+D, r], bias) of the
    next request."""
    ws, bias = head
    synth.decoder.w['ws'].copy_(ws)
    synth.decoder.f['bs'].fill_(bias)
    proj = synth.acoustic.decoder_cell.stop_projection
    proj.weight.copy_(synth.decoder.w['ws'].t())
    proj.bias.fill_(bias)


def check_wav(wav: np.ndarray, hop: int, frames: int) -> None:
    if not (wav.dtype == np.float32 and wav.shape == (hop * frames,)
            and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise AssertionError(f'bad wav: {wav.dtype} {wav.shape}, '
                             f'expected {hop * frames} samples')


def main_path(fd, device):
    from transtacos_retunegan_tpu_torch.serve.httpd import serve
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    synth = Synthesizer(devices=[device])
    hop, r = synth.cfg.audio.hop_length, synth.cfg.acoustic.outputs_per_step
    log(f'  default Config, seeded weights, {FRAMES_PER_SYLLABLE:.3f} frames per syllable')
    plan = plan_requests(fd, synth)
    for text in REQUESTS:                                 # warm-up
        use_stop(synth, plan[text][0])
        check_wav(synth.tts_fused(text), hop, plan[text][1] * r)
    torch.cuda.synchronize()

    for k in fd.LAUNCHES:
        fd.LAUNCHES[k] = 0
    for surface in ('tts_fused', 'tts'):
        for text in REQUESTS:
            use_stop(synth, plan[text][0])
            before = dict(fd.LAUNCHES)
            t0 = time.perf_counter()
            wav = getattr(synth, surface)(text)
            ms = 1e3 * (time.perf_counter() - t0)
            check_wav(wav, hop, plan[text][1] * r)
            rose = {k: fd.LAUNCHES[k] - before[k] for k in before}
            log(f'  {surface}({text!r}): {ms:.2f} ms, {len(wav) // hop} frames, '
                f'launches {rose}')
            if rose != {'decode_step': 0, 'decode_full': 1}:
                raise AssertionError(f'decode_full must rise by one per request: {rose}')
    # the server's worker thread builds its per-thread caches (cuDNN plans)
    # on its first request, so three are timed
    from scipy.io import wavfile
    use_stop(synth, plan[REQUESTS[1]][0])
    server = serve(synth, port=0, host='127.0.0.1')
    try:
        url = (f'http://127.0.0.1:{server.server_address[1]}/synth?text='
               + REQUESTS[1].replace(' ', '%20'))
        for _ in range(3):
            before = fd.LAUNCHES['decode_full']
            t0 = time.perf_counter()
            body = urllib.request.urlopen(url, timeout=300).read()
            ms = 1e3 * (time.perf_counter() - t0)
            sr, wav = wavfile.read(io.BytesIO(body))
            check_wav(wav, hop, plan[REQUESTS[1]][1] * r)
            if (sr != synth.cfg.audio.sample_rate
                    or fd.LAUNCHES['decode_full'] != before + 1):
                raise AssertionError('GET /synth did not go through decode_full')
            log(f'  GET /synth: {ms:.2f} ms, {len(body)} bytes, '
                f'{len(wav) // hop} frames')
    finally:
        server.shutdown()
        server.server_close()
    # a request whose working set exceeds the fit check takes the step kernel
    use_stop(synth, plan[REQUESTS[0]][0])
    budget, fd.SMEM_BUDGET_BYTES = fd.SMEM_BUDGET_BYTES, 0
    try:
        before = dict(fd.LAUNCHES)
        t0 = time.perf_counter()
        wav = synth.tts_fused(REQUESTS[0])
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        fd.SMEM_BUDGET_BYTES = budget
    check_wav(wav, hop, plan[REQUESTS[0]][1] * r)
    rose = {k: fd.LAUNCHES[k] - before[k] for k in before}
    log(f'  tts_fused past the fit check: {ms:.2f} ms, launches {rose}')
    if rose != {'decode_step': synth.max_iters, 'decode_full': 0}:
        raise AssertionError(f'the step path must launch decode_step per step: {rose}')
    launches = dict(fd.LAUNCHES)
    log(f'  LAUNCHES after the main path: {launches}')
    return synth, plan, launches


# ---------------------------------------------------------------------------
# phase 5: the batched path (what the app serves by default)
# ---------------------------------------------------------------------------

def cohort_logits(fd, fp, mem, targets, decode):
    """Largest bias-free stop logit per row and step, [B, max(targets)], of
    a decode in which the stop bias is -20; only the steps before each
    row's target are read."""
    fp.f['bs'].fill_(-20.0)
    steps = max(targets)
    p = fd.to_outputs(fp, *decode(fp, *mem, steps))['stop_token_outputs']
    z = stop_logit(p).cpu().numpy() + 20.0
    return z.reshape(p.shape[0], steps, fp.dims.r).max(-1)


def cohort_bias(zs, targets, margin: float = 0.05) -> float:
    """The stop bias under which every row b of every decode in ``zs``
    stops after exactly ``targets[b]`` steps, halfway between the largest
    logit before those steps and the smallest at them; both must be at
    least ``2 * margin`` apart, so that rounding cannot move a stop."""
    lo = max((float(z[b, :t - 1].max()) for z in zs
              for b, t in zip(range(z.shape[0]), targets) if t > 1), default=-80.0)
    hi = min(float(z[b, t - 1]) for z in zs for b, t in zip(range(z.shape[0]), targets))
    if not hi - lo >= 2 * margin:
        raise RuntimeError(f'no stop bias stops every row at its target: '
                           f'largest logit before {lo:.3f}, smallest at {hi:.3f}')
    return -(lo + hi) / 2


def memory_of(enc):
    return enc['keys'], enc['values'], enc['mask']


def plan_cohorts(fd, synth):
    """A stop head fitted jointly to the rows of the largest cohort, and
    one stop bias under which every text stops after the steps its
    syllables take, whether it is decoded in any cohort, alone, or by the
    plain version.  Returns (head, targets)."""
    r = synth.cfg.acoustic.outputs_per_step
    targets = [math.ceil(len(t.split()) * FRAMES_PER_SYLLABLE / r) for t in BATCH_TEXTS]
    fp = fd.fold_params(synth.acoustic.decoder_cell)
    with torch.no_grad():
        mem = memory_of(synth._encode_batch(BATCH_TEXTS))
        ws = stop_head(fd, fp, mem, targets)
        fp.w['ws'].copy_(ws)
        alone = [memory_of(synth._encode(t)) for t in BATCH_TEXTS]
        alone = tuple(torch.cat(x) for x in zip(*alone))
        mems = [mem, alone] + [memory_of(synth._encode_batch(BATCH_TEXTS[:c]))
                               for c in COHORTS if c < len(BATCH_TEXTS)]
        zs = [cohort_logits(fd, fp, m, targets[:m[2].shape[0]], fd.decode_full) for m in mems]
        zs.append(cohort_logits(fd, fp, mem, targets, fd.decode_full_plain))
        bias = cohort_bias(zs, targets)
    log(f'  {len(BATCH_TEXTS)} texts in one text bucket (N={mem[2].shape[1]}), targets '
        f'{targets} steps, stop bias {bias:.4f} for every cohort, alone and plain')
    return (ws, bias), targets


def cohort_checks(fd, synth, targets):
    """Per cohort, outside the counted run: out_lengths against the plan
    and the plain decode of the same cohort; each row's mel bit-identical
    to that row decoded alone from the same encoder output (the kernel
    takes each row's sums in the same order whatever B is); each text encoded and decoded
    alone at the batching server's fixed 8 rows bit-identical to its row in
    the cohort of 8; the same text encoded alone at 1 row (the encoder's
    sums may differ in their last bits between batch shapes, which the
    bf16 decode carries) only logged; then the decode's time per cohort
    (CUDA events)."""
    r, rows, failures = synth.cfg.acoustic.outputs_per_step, max(COHORTS), []
    with torch.no_grad():
        fixed = [synth._acoustic_batch([t], rows)['mel_outputs'][0] for t in BATCH_TEXTS]
        for c in COHORTS:
            cohort = BATCH_TEXTS[:c]
            enc = synth._encode_batch(cohort)
            out = synth._decode(enc)
            ref = fd.to_outputs(synth.decoder, *fd.decode_full_plain(
                synth.decoder, *memory_of(enc), synth.max_iters, early_exit=True))
            lengths = out['out_lengths'][:c].tolist()
            errs = errors(synth.decoder, out, ref)
            rows_alone = [{k: enc[k][i:i + 1] for k in ('keys', 'values', 'mask')}
                          for i in range(c)]
            same = [torch.equal(synth._decode(row)['mel_outputs'][0], out['mel_outputs'][i])
                    for i, row in enumerate(rows_alone)]
            alone = [synth._encode(t) for t in cohort]
            enc_diff = max(float((a[k][0] - enc[k][i]).abs().max())
                           for i, a in enumerate(alone) for k in ('keys', 'values'))
            mel_diff = max(float((synth._decode(a)['mel_outputs'][0] - out['mel_outputs'][i]
                                  ).abs().max()) for i, a in enumerate(alone))
            decode_ms = cuda_ms(lambda: synth._decode(enc), 5)
            log(f'  cohort of {c}: lengths {lengths}, plain decode '
                + err_text(errs, torch.bfloat16) + f'; rows bit-identical to the row decoded alone: {sum(same)}/{c}; text '
                f'encoded alone: keys/values {enc_diff:.2e}, mel {mel_diff:.2e}; decode '
                f'{decode_ms:.3f} ms, {decode_ms / max(targets[:c]):.4f} ms per step of its '
                f'longest row')
            if (lengths != [t * r for t in targets[:c]] or not within(errs, torch.bfloat16)
                    or not all(same)):
                failures.append(c)
        same8 = [torch.equal(m, out['mel_outputs'][i]) for i, m in enumerate(fixed)]
        log(f'  each text alone at {rows} rows, bit-identical to its row in the cohort of '
            f'{rows}: {sum(same8)}/{len(same8)}')
        if not all(same8):
            failures.append(f'alone at {rows} rows')
    if failures:
        raise AssertionError(f'cohorts disagree with their plan: {failures}')


def vocoder_batch_spread(synth, targets):
    """The vocoder stage's dependence on its batch: the specs of each
    64-frame bucket vocoded together and one by one, with the same phase
    per spec; returns the largest difference of a wav."""
    r, au = synth.cfg.acoustic.outputs_per_step, synth.cfg.audio
    specs = synth.synthesize_spec_batch(list(BATCH_TEXTS))
    g = torch.Generator().manual_seed(SEED)
    worst = 0.0
    for bucket in sorted({math.ceil(t * r / 64) for t in targets}):
        group = [s for s, t in zip(specs, targets) if math.ceil(t * r / 64) == bucket]
        thetas = [2 * math.pi * torch.rand(au.n_freq, 64 * bucket, generator=g) for _ in group]
        together = synth.vocode_batch(group, thetas=thetas)
        diffs = [float(np.abs(w - synth.vocode_batch([s], thetas=[th])[0]).max())
                 for s, th, w in zip(group, thetas, together)]
        log(f'  vocode_batch of {len(group)} specs ({64 * bucket}-frame bucket) against each '
            f'alone, same phase: largest difference per wav {[f"{x:.2e}" for x in diffs]}')
        worst = max([worst] + diffs)
    return worst


def http_concurrent(fd, synth, targets):
    """8 concurrent GET /synth through serve_all(batching=True), twice, then
    the same 8 one after another; each wav must equal its serial answer."""
    from scipy.io import wavfile
    from transtacos_retunegan_tpu_torch.serve.httpd import serve_all
    hop, r = synth.cfg.audio.hop_length, synth.cfg.acoustic.outputs_per_step
    servers = serve_all(synth, host='127.0.0.1', webui_port=0, vocoder_port=0,
                        acoustic_port=0, batching=True, max_batch=max(COHORTS))
    try:
        servers[0].frontend.warm_up()
        port = servers[0].server_address[1]

        def get(text):
            body = urllib.request.urlopen(f'http://127.0.0.1:{port}/synth?text='
                                          + text.replace(' ', '%20'), timeout=300).read()
            return wavfile.read(io.BytesIO(body))[1]

        def concurrent():
            out = [None] * len(BATCH_TEXTS)
            threads = [threading.Thread(target=lambda i=i, t=t: out.__setitem__(i, get(t)))
                       for i, t in enumerate(BATCH_TEXTS)]
            before, t0 = fd.LAUNCHES['decode_full'], time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return out, 1e3 * (time.perf_counter() - t0), fd.LAUNCHES['decode_full'] - before

        # twice: the first round may meet shapes that the warm-up did not
        # (the 128-frame bucket on the vocoder thread)
        rounds = [concurrent() for _ in range(2)]
        t0 = time.perf_counter()
        serial = [get(t) for t in BATCH_TEXTS]
        serial_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
    for conc, conc_ms, cohorts in rounds:
        same = [np.array_equal(w, v) for w, v in zip(conc, serial)]
        log(f'  {len(BATCH_TEXTS)} concurrent GET /synth: {conc_ms:.2f} ms in {cohorts} acoustic '
            f'cohort(s); bit-identical to the serial answer: {sum(same)}/{len(same)}, largest '
            f'difference {max(float(np.abs(w - v).max()) for w, v in zip(conc, serial)):.2e}')
        if cohorts < 1 or not all(same):
            raise AssertionError('concurrent GET /synth disagrees with the serial answers')
    log(f'  the same {len(BATCH_TEXTS)} GET /synth one by one: {serial_ms:.2f} ms')
    for v, t in zip(serial, targets):
        check_wav(v, hop, t * r)


def batched_path(fd, lk, synth):
    """Phase 5.  Plans the stops, checks the cohorts against the plain
    decode and the texts decoded alone, measures the vocoder's dependence
    on its batch, warms each cohort size, then, with the launch counters at
    0, answers ``tts_batch`` for cohorts of 1, 2, 4 and 8 texts and 8
    concurrent plus 8 serial ``GET /synth`` through the batching server,
    and reads the counters.  Returns the launches."""
    hop, r = synth.cfg.audio.hop_length, synth.cfg.acoustic.outputs_per_step
    sr = synth.cfg.audio.sample_rate
    head, targets = plan_cohorts(fd, synth)
    use_stop(synth, head)
    cohort_checks(fd, synth, targets)
    vocoder_batch_spread(synth, targets)
    for c in COHORTS:                                    # warm-up per batch shape
        synth.tts_batch(list(BATCH_TEXTS[:c]))
    torch.cuda.synchronize()

    for counts in (fd.LAUNCHES, lk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    for c in COHORTS:
        ms = []
        for _ in range(BATCH_REPS):
            before = dict(fd.LAUNCHES)
            t0 = time.perf_counter()
            wavs = synth.tts_batch(list(BATCH_TEXTS[:c]))
            ms.append(1e3 * (time.perf_counter() - t0))
            rose = {k: fd.LAUNCHES[k] - before[k] for k in before}
            if rose != {'decode_step': 0, 'decode_full': 1}:
                raise AssertionError(f'a cohort must launch decode_full once: {rose}')
            for w, t in zip(wavs, targets):
                check_wav(w, hop, t * r)
        med = float(np.median(ms))
        secs = sum(len(w) for w in wavs) / sr
        log(f'  tts_batch cohort of {c}: median {med:.3f} ms over {BATCH_REPS} '
            f'(min {min(ms):.3f}), {secs:.3f} s of audio, '
            f'{secs / (med / 1e3):.2f} audio-seconds per second, launches {rose}')
    http_concurrent(fd, synth, targets)
    launches = {**fd.LAUNCHES, **lk.LAUNCHES}
    log(f'  LAUNCHES after the batched path: {launches}')
    if launches['decode_full'] < 1 or launches['decode_step'] != 0:
        raise AssertionError(f'the batched path must go through decode_full only: {launches}')
    return launches


def stage_times(synth, plan, text: str, reps: int = 5):
    """Per-stage time of one tts_fused request (host clock, synchronised
    after each stage), mean over ``reps`` runs after a warm-up."""
    from transtacos_retunegan_tpu_torch.audio import dsp
    from transtacos_retunegan_tpu_torch.models.acoustic import posnet_apply
    au = synth.cfg.audio
    acc = {}
    use_stop(synth, plan[text][0])

    def stage(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    for rep in range(reps + 1):
        if rep == 1:
            acc.clear()                                 # drop the warm-up
        enc = stage('encoder', synth._encode, text)
        out = stage('decode', synth._decode, enc)
        mag = stage('posnet', posnet_apply, synth.acoustic, out['mel_outputs'])
        s = dsp.fix_zero_dc(dsp.spec_to_natural_scale(mag[0].T, au), au)
        mel, tmpl = stage('gl_template', synth._template, s[None], None,
                          [synth._generator()])
        stage('generator', synth._generate, mel, tmpl)
    ms = {k: v / reps for k, v in acc.items()}
    log('  stages of tts_fused (ms): ' + ', '.join(f'{k} {v:.3f}' for k, v in ms.items())
        + f'; decode stopped at {int(out["out_lengths"][0]) // synth.cfg.acoustic.outputs_per_step}'
        f' of {synth.max_iters} steps')
    return ms


def request_latency(synth, plan, n: int = 10):
    """Host-clock time of ``n`` back-to-back tts_fused requests of each
    text, each ending with its wav on the host: median and quartiles, and
    the real-time factor (median time over the wav's duration)."""
    for text in REQUESTS:
        use_stop(synth, plan[text][0])
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            wav = synth.tts_fused(text)
            ms.append(1e3 * (time.perf_counter() - t0))
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        secs = len(wav) / synth.cfg.audio.sample_rate
        log(f'  tts_fused, {len(text.split())} syllables, {plan[text][1]} steps, '
            f'x{n}: median {med:.3f} ms (quartiles {q1:.3f}, {q3:.3f}), '
            f'{secs:.3f} s of audio, RTF {med / 1e3 / secs:.5f}')


def thread_cost(synth, plan, text: str, n: int = 3):
    """``tts`` on this thread and on a fresh thread per call.  PyTorch keeps
    some caches per thread (cuDNN's execution plans among them), which is
    why the HTTP server runs all work on the card on one worker thread."""
    def timed(out):
        t0 = time.perf_counter()
        synth.tts(text)
        out.append(1e3 * (time.perf_counter() - t0))
    use_stop(synth, plan[text][0])
    here, fresh = [], []
    for _ in range(n):
        timed(here)
    for _ in range(n):
        th = threading.Thread(target=timed, args=(fresh,))
        th.start()
        th.join()
    log(f'  tts({text!r}) ms on this thread {[round(x, 2) for x in here]}, '
        f'on a fresh thread each {[round(x, 2) for x in fresh]}')


def slice_against_cpu(device):
    """The whole slice at a small width: the wav on the card against the
    same Synthesizer on the CPU (plain decode), float32 throughout, the
    same seeded weights and Griffin-Lim phase."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.ops.fused_decoder import fold_params
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    base = Config()
    cfg = dataclasses.replace(
        base,
        acoustic=dataclasses.replace(
            base.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
            attention_depth=16, prenet_depths=(32,), posnet_depth=64,
            var_embed_depth=16, var_prednet_depth=16, prdsnet_depth=16,
            posenc_depth=8, max_iters=8),
        vocoder=dataclasses.replace(base.vocoder, upsample_initial_channel=64))
    kw = dict(infer_dtype='float32')
    gpu, cpu = Synthesizer(cfg, devices=[device], **kw), Synthesizer(cfg, devices=['cpu'], **kw)
    for s in (gpu, cpu):                  # decode every step on both
        s.acoustic.decoder_cell.stop_projection.bias.fill_(-20.0)
        s.decoder = fold_params(s.acoustic.decoder_cell, torch.float32)
    frames = cfg.acoustic.max_iters * cfg.acoustic.outputs_per_step
    theta = 2 * math.pi * torch.rand(cfg.audio.n_freq, frames,
                                     generator=torch.Generator().manual_seed(SEED))
    a = gpu.tts_fused(REQUESTS[0], theta=theta.to(device))
    b = cpu.tts_fused(REQUESTS[0], theta=theta)
    err = float(np.abs(a - b).max())
    log(f'  small config, card vs CPU: wav {a.shape}, max abs diff {err:.2e} '
        f'(tol {SLICE_TOL:.0e})')
    if a.shape != b.shape or not err <= SLICE_TOL:
        raise AssertionError('the slice on the card disagrees with the CPU')


# ---------------------------------------------------------------------------
# phase 7: vocoder training on the card
# ---------------------------------------------------------------------------

def drawn_noise(cfg, gen, batch, seed: int):
    """One generator forward's training noise, drawn on the CPU: the shape
    of each noise call from an inference forward (a pre-hook on the noise
    modules), one uniform tensor per call."""
    from transtacos_retunegan_tpu_torch.models.vocoder_layers import LearnedGaussianNoise
    from transtacos_retunegan_tpu_torch.train.vocoder_step import apply_generator
    shapes = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: shapes.append(args[0].shape))
             for m in gen.modules() if isinstance(m, LearnedGaussianNoise)]
    with torch.no_grad():
        apply_generator(cfg, gen, batch)
    for h in hooks:
        h.remove()
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=g) for s in shapes]


def leaf_errors(params, ref_params, grads, ref_grads, lr: float):
    """Over the leaves (dicts of name -> tensor): the gradient difference
    over the gradient, each as one vector; the leaf whose largest
    difference is largest against its own norm, as (name, that ratio); and
    the largest parameter difference over lr where the update's sign is
    resolved, the rule of ``tests/test_torch_port_gan_step.py`` (Adam's
    first update is lr x g / (|g| + 1e-8))."""
    sq_diff = sq_ref = worst_p = 0.0
    worst_leaf = ('', 0.0)
    for name, p in params.items():
        g, rg = grads[name].cpu(), ref_grads[name]
        sq_diff += float(((g - rg).double() ** 2).sum())
        sq_ref += float((rg.double() ** 2).sum())
        diff = float((g - rg).abs().max())
        ratio = diff / max(float(rg.norm()), 1e-30)
        if ratio > worst_leaf[1]:
            worst_leaf = (name, ratio)
        live = rg.abs() >= 1e-6 + diff
        err = (p.cpu() - ref_params[name]).abs()[live]
        if err.numel():
            worst_p = max(worst_p, float(err.max()) / lr)
    return math.sqrt(sq_diff / max(sq_ref, 1e-300)), worst_leaf, worst_p


def params_and_grads(module):
    return ({n: p.detach().clone() for n, p in module.named_parameters()},
            {n: p.grad.clone() for n, p in module.named_parameters()})


def step_card_vs_cpu(cfg, device, items):
    """The first GAN step at full width, B=2, on the card and on the CPU
    from the same seeded weights, batch and noise, compared as
    ``tests/test_torch_port_gan_step.py`` compares the port with the JAX
    package: one discriminator update from the common start, then the
    generator update against the CPU's updated discriminators (Adam's
    first update is lr x the gradient's sign, so a second update, or the
    generator against discriminators updated apart, would carry the sign
    of every gradient element within rounding of 0).  The losses within
    STEP_TOL relative, the mean scores within STEP_TOL, the parameters as
    in the CPU tests; the gradients printed."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    hv = cfg.vocoder
    cfg1 = dataclasses.replace(cfg, vocoder=dataclasses.replace(hv, d_train_times=1))
    cpu_b = {k: torch.from_numpy(v) for k, v in items.items()}
    gpu_b = {k: v.to(device) for k, v in cpu_b.items()}
    noise = drawn_noise(cfg1, vs.init_gan_state(cfg1, SEED, 'cpu').generator, cpu_b, SEED)
    disc, gen, metrics = {}, {}, {}
    cpu_d = None
    for where, b, nz in (('cpu', cpu_b, noise), ('gpu', gpu_b, [n.to(device) for n in noise])):
        st = vs.init_gan_state(cfg1, SEED, b['wav'].device)
        y_g = vs.apply_generator(cfg1, st.generator, b, nz)
        d_aux = vs.discriminator_phase(cfg1, st, b['wav'], y_g.detach(), 4)
        disc[where] = params_and_grads(st.discriminators)
        if where == 'cpu':
            cpu_d = st.discriminators.state_dict()
        else:
            st.discriminators.load_state_dict(cpu_d)
        g_aux = vs.generator_phase(cfg1, st, b['wav'], y_g, 4)
        gen[where] = params_and_grads(st.generator)
        metrics[where] = {k: float(v.detach()) for k, v in {**d_aux, **g_aux}.items()}
    # losses relative; the mean scores (sc_*) are means of outputs of order 1
    # that cancel, so against 1
    rel = {k: abs(metrics['gpu'][k] - v) / max(abs(v), 1.0 if k.startswith('sc_') else 1e-2)
           for k, v in metrics['cpu'].items()}
    worst_m = max(rel, key=rel.get)
    gd, wd, pd = leaf_errors(disc['gpu'][0], disc['cpu'][0], disc['gpu'][1], disc['cpu'][1],
                             hv.learning_rate_d)
    gg, wg, pg = leaf_errors(gen['gpu'][0], gen['cpu'][0], gen['gpu'][1], gen['cpu'][1],
                             hv.learning_rate_g)
    log(f'  first step, B=2, card vs CPU: losses and scores worst {worst_m} '
        f'{rel[worst_m]:.2e} (tol {STEP_TOL:.0e}); resolved parameter diff / lr: D {pd:.2e}, '
        f'G {pg:.2e} (tol 1e-2); gradient difference over the gradient: D {gd:.2e}, '
        f'G {gg:.2e}; largest against its leaf\'s norm: D {wd[0]} {wd[1]:.2e}, '
        f'G {wg[0]} {wg[1]:.2e}')
    if not (rel[worst_m] <= STEP_TOL and max(pd, pg) <= 1e-2):
        raise AssertionError('the GAN step on the card disagrees with the CPU')


def generators_card_vs_cpu(device):
    """Every generator of the registry at the default widths, seeded
    weights, B=1, 32 frames: the inference forward on the card against the
    CPU in float32, and a bf16-autocast forward that must be finite."""
    import copy
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.generators import GENERATORS, make_generator
    from transtacos_retunegan_tpu_torch.train.vocoder_step import apply_generator
    from transtacos_retunegan_tpu_torch.weights import seeded_init
    base = Config()
    r = np.random.RandomState(SEED)
    frames, hop = 32, base.audio.hop_length
    mel = r.randn(1, frames, base.audio.n_mel).astype(np.float32)
    tmpl = (0.1 * r.randn(1, frames * hop)).astype(np.float32)
    uv = (np.repeat(r.rand(1, frames), hop, 1) > 0.5).astype(np.float32)
    arrays = {'mel': mel, 'tmpl': tmpl, 'wav': tmpl, 'mel_c': mel, 'mel_v': mel[:, ::-1].copy(),
              'tmpl_c': tmpl * uv, 'tmpl_v': tmpl * (1 - uv), 'uv': uv}
    worst = {}
    for ver in sorted(GENERATORS):
        cfg = dataclasses.replace(base, vocoder=dataclasses.replace(
            base.vocoder, generator_ver=ver, compute_dtype='float32'))
        gen = seeded_init(make_generator(cfg), SEED)
        on_card = copy.deepcopy(gen).to(device)
        cpu_b = {k: torch.from_numpy(v) for k, v in arrays.items()}
        gpu_b = {k: v.to(device) for k, v in cpu_b.items()}
        with torch.no_grad():
            a = apply_generator(cfg, gen, cpu_b)
            b = apply_generator(cfg, on_card, gpu_b)
            bf = apply_generator(dataclasses.replace(cfg, vocoder=dataclasses.replace(
                cfg.vocoder, compute_dtype='bfloat16')), on_card, gpu_b)
        worst[ver] = float((b.cpu() - a).abs().max())
        if a.shape != (1, frames * hop) or not worst[ver] <= GEN_TOL \
                or not bool(torch.isfinite(bf).all()):
            raise AssertionError(f'{ver} on the card: diff {worst[ver]:.2e}, '
                                 f'bf16 finite {bool(torch.isfinite(bf).all())}')
    log('  12 generators, card vs CPU, B=1, 32 frames, float32 (tol '
        f'{GEN_TOL:.0e}); bf16 autocast finite: '
        + ', '.join(f'{k} {v:.1e}' for k, v in worst.items()))


def gan_step_times(cfg, device, batch, steps: int, warm: int):
    """``steps`` GAN steps at B=16 on one fixed batch after ``warm``, each
    timed by CUDA events; returns (ms per step, loss_mstft per step,
    max_memory_allocated in bytes)."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    state = vs.init_gan_state(cfg, SEED, device)
    noise = torch.Generator(device=device).manual_seed(SEED)
    for _ in range(warm):
        vs.gan_train_step(cfg, state, batch, noise, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    mstft = []
    marks[0].record()
    for i in range(steps):
        _, m = vs.gan_train_step(cfg, state, batch, noise, 4)
        marks[i + 1].record()
        mstft.append(m['loss_mstft'])
    torch.cuda.synchronize()
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(steps)]
    return ms, [float(x) for x in torch.stack(mstft).cpu()], torch.cuda.max_memory_allocated()


def gan_phase_times(cfg, device, batch, steps: int = 10, warm: int = 2):
    """Median ms of the generator forward, the discriminator phase and the
    generator phase, CUDA events between them, over ``steps`` steps."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    state = vs.init_gan_state(cfg, SEED, device)
    noise = torch.Generator(device=device).manual_seed(SEED)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(steps)]
    for i in range(warm + steps):
        e = ev[i - warm] if i >= warm else None
        e and e[0].record()
        y_g = vs.apply_generator(cfg, state.generator, batch, noise)
        e and e[1].record()
        vs.discriminator_phase(cfg, state, batch['wav'], y_g.detach(), 4)
        e and e[2].record()
        vs.generator_phase(cfg, state, batch['wav'], y_g, 4)
        e and e[3].record()
        state.step += 1
    torch.cuda.synchronize()
    return {name: float(np.median([x[j].elapsed_time(x[j + 1]) for x in ev]))
            for j, name in enumerate(('G forward', 'D phase', 'G phase'))}


def quartiles(ms):
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return f'median {med:.3f} ms, quartiles {q1:.3f} / {q3:.3f}'


def training_run(corpus: str, run_dir: str):
    """``train_vocoder`` on the card at the default Config: 3 epochs with
    a checkpoint at step 10, then a restart for 5 epochs that resumes from
    it.  Every step's metrics are recorded, with the parameters before the
    first step and after the last."""
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.train import train_vocoder as tv
    real, calls, snaps = tv.gan_train_step, [], {}

    def params(state):
        return {f'{k}.{n}': p.detach().clone() for k, m in
                (('generator', state.generator), ('disc', state.discriminators))
                for n, p in m.named_parameters()}

    def recording(cfg, state, batch, noise, spe):
        if 'first' not in snaps:
            snaps['first'] = params(state)
        calls.append(state.step)
        state, m = real(cfg, state, batch, noise, spe)
        snaps['metrics'] = snaps.get('metrics', []) + [m]
        snaps['last'] = state
        return state, m

    argv = ['--data_dir', corpus, '--log_path', run_dir, '--stdout_interval', '4',
            '--summary_interval', '1000', '--checkpoint_interval', '10',
            '--validation_interval', '12']
    tv.gan_train_step = recording
    try:
        t0 = time.perf_counter()
        tv.main(argv + ['--epochs', '3'])
        t_a = time.perf_counter() - t0
        steps_a = len(calls)
        saved = torch.load(ckpt.scan_checkpoint(run_dir, 'do_'), map_location='cpu')
        t0 = time.perf_counter()
        tv.main(argv + ['--epochs', '5'])
        t_b = time.perf_counter() - t0
    finally:
        tv.gan_train_step = real
    resumed_at = calls[steps_a]
    metrics = snaps['metrics']
    finite = all(bool(torch.isfinite(torch.stack(list(m.values()))).all()) for m in metrics)
    last = params(snaps['last'])
    moved = {part: any(not torch.equal(snaps['first'][k], last[k])
                       for k in last if k.startswith(part))
             for part in ('generator', 'disc.msd', 'disc.mpd', 'disc.mtd')}
    with open(f'{run_dir}/rtg.log') as fh:
        resumed_log = f"resumed from step {saved['step']} epoch {saved['epoch']}" in fh.read()
    log(f"  run A: {steps_a} steps in {t_a:.1f} s (epochs 0-2, dataset built), newest "
        f"checkpoint step {saved['step']} epoch {saved['epoch']}; run B resumed at step "
        f"{resumed_at} ({resumed_log and 'logged'}), {len(calls) - steps_a} steps in "
        f'{t_b:.1f} s; {len(metrics)} steps, every metric finite: {finite}; '
        f'parameters moved: {moved}')
    last_m = {k: round(float(v), 4) for k, v in metrics[-1].items()}
    log(f'  last step: {last_m}')
    if not (steps_a == 12 and (saved['step'], saved['epoch']) == (10, 2) and resumed_at == 10
            and resumed_log and len(calls) - steps_a == 12 and finite and all(moved.values())):
        raise AssertionError('the training run did not train, checkpoint or resume')


def loader_times(dataset, batch_size: int, workers: int):
    """Host ms per batch of the training loader: its first epoch (which
    builds the cached items it draws: augmentation, Griffin-Lim), then,
    with every item cached, an epoch of crops.  Returns (first, cached)."""
    from transtacos_retunegan_tpu_torch.data.vocoder_data import VocoderLoader
    loader = VocoderLoader(dataset, batch_size, num_workers=workers)
    t0 = time.perf_counter()
    n = len(list(loader))
    first = 1e3 * (time.perf_counter() - t0) / n
    for i in range(len(dataset)):
        dataset[i]
    t0 = time.perf_counter()
    list(loader)
    cached = 1e3 * (time.perf_counter() - t0) / n
    log(f'  loader ({workers} workers), ms per batch of {batch_size}: first epoch (builds '
        f'the cache: augmentation, Griffin-Lim) {first:.1f}, an epoch of cached items '
        f'(crops) {cached:.2f}')
    return first, cached


def vocoder_training(device, base: str):
    """Phase 7; its corpus and run dir stay in ``base`` (phase 12 serves
    the run)."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.data.vocoder_data import VocoderDataset
    from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
    cfg = Config()
    hv, au = cfg.vocoder, cfg.audio
    log(f'  default Config: {hv.generator_ver} at {hv.upsample_initial_channel} channels, '
        f'B={hv.batch_size}, segment {au.segment_size}, discriminator width '
        f'{hv.disc_width_mult}, {len(hv.multi_stft_params)} STFT resolutions, '
        f'd_train_times={hv.d_train_times}, {hv.compute_dtype} (TF32 off)')
    t0 = time.perf_counter()
    lengths = write_corpus(f'{base}/corpus', au, TRAIN_UTTS, TEST_UTTS, seed=SEED)
    log(f'  tone corpus: {TRAIN_UTTS} + {TEST_UTTS} utterances, '
        f'{sum(lengths) / au.sample_rate:.1f} s of audio, written in '
        f'{time.perf_counter() - t0:.1f} s')
    training_run(f'{base}/corpus', f'{base}/run')

    per_batch = loader_times(VocoderDataset('train', f'{base}/corpus', cfg),
                             hv.batch_size, hv.num_workers)
    # the fixed batch, its items built in order (the loader's threads
    # draw the augmentation's random numbers in the order they run)
    ds = VocoderDataset('train', f'{base}/corpus', cfg)
    rows = [ds[i] for i in range(hv.batch_size)]
    items = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    batch = {k: torch.from_numpy(v).to(device) for k, v in items.items()}

    ms, mstft, mem = gan_step_times(cfg, device, batch, GAN_TIMED, GAN_WARM)
    med = float(np.median(ms))
    samples = hv.batch_size * au.segment_size / (med / 1e3)
    log(f'  GAN step, float32, B={hv.batch_size}: {quartiles(ms)} ({GAN_TIMED} after '
        f'{GAN_WARM} warm-up); {samples:.0f} samples/s, {samples / au.sample_rate:.2f} s of '
        f'audio per s; max_memory_allocated {mem / 2 ** 30:.2f} GiB; loss_mstft on this '
        'fixed batch: ' + ' '.join(f'{x:.3f}' for x in mstft))
    boosted = dataclasses.replace(cfg, vocoder=dataclasses.replace(
        hv, w_loss_mstft=MSTFT_BOOST * hv.w_loss_mstft))
    _, mstft, _ = gan_step_times(boosted, device, batch, MSTFT_STEPS, 0)
    first, late = mstft[0], float(np.mean(mstft[-5:]))
    log(f'  loss_mstft on one fixed batch over {MSTFT_STEPS} GAN steps from the seeded '
        f'start, its weight x{MSTFT_BOOST:g}: ' + ' '.join(f'{x:.3f}' for x in mstft)
        + f'; before the first update {first:.4f}, mean of the last 5 {late:.4f} '
        f'(must be below {MSTFT_FALL:.2f} x)')
    phases = gan_phase_times(cfg, device, batch)
    log('  one step split (median of 10, ms): '
        + ', '.join(f'{k} {v:.3f}' for k, v in phases.items())
        + f' (sum {sum(phases.values()):.3f})')
    bf16 = dataclasses.replace(cfg, vocoder=dataclasses.replace(hv, compute_dtype='bfloat16'))
    ms_bf, _, mem_bf = gan_step_times(bf16, device, batch, GAN_TIMED, GAN_WARM)
    log(f'  GAN step, bf16 autocast, B={hv.batch_size}: {quartiles(ms_bf)}; '
        f'{hv.batch_size * au.segment_size / (float(np.median(ms_bf)) / 1e3) / au.sample_rate:.2f}'
        f' s of audio per s; max_memory_allocated {mem_bf / 2 ** 30:.2f} GiB')
    log(f'  host loader: {per_batch[1]:.2f} ms per batch after the first epoch against a '
        f'{med:.1f} ms step')
    step_card_vs_cpu(cfg, device, {k: v[:2] for k, v in items.items()})
    generators_card_vs_cpu(device)
    if not late < MSTFT_FALL * first:
        raise AssertionError('loss_mstft did not fall on a fixed batch')


# ---------------------------------------------------------------------------
# phase 8: acoustic-model training on the card
# ---------------------------------------------------------------------------

def acoustic_corpus(base: str, cfg):
    """The synthetic Mandarin corpus (``tools/synth_corpus.py``) at
    DataBaker's utterance length: its syllables take about 25 frames (the
    corpus's 19.07), so 8-16 syllables give the corpus mean of about 307
    frames.  Returns the processed data dir and the frame lengths."""
    from transtacos_retunegan_tpu_torch.data.feeder import AcousticDataset
    from transtacos_retunegan_tpu_torch.tools.synth_corpus import build_corpus
    t0 = time.perf_counter()
    data_dir = build_corpus(base, cfg, n_utts=ACOUSTIC_UTTS, seed=SEED, num_workers=4,
                            min_syl=SYLLABLES[0], max_syl=SYLLABLES[1])
    ds = AcousticDataset(data_dir, cfg)
    frames = np.asarray([ds.frame_len(i) for i in range(len(ds))])
    syl = np.asarray([len(m[2].split(' ')) for m in ds.metadata])
    q = np.percentile(frames, [0, 25, 50, 75, 100])
    log(f'  synthetic corpus: {ACOUSTIC_UTTS} utterances of {SYLLABLES[0]}-{SYLLABLES[1]} '
        f'syllables, {len(ds)} in train.txt after the 2-sigma filter and the test split, '
        f'built in {time.perf_counter() - t0:.1f} s; frames mean {frames.mean():.1f} '
        f'(DataBaker 307), min/quartiles/max {" / ".join(f"{x:.0f}" for x in q)}; '
        f'{frames.sum() / syl.sum():.2f} frames per syllable')
    return data_dir, ds


def fixed_batch(ds, cfg, rows):
    """One padded batch of the dataset's items ``rows`` (numpy)."""
    from transtacos_retunegan_tpu_torch.data.feeder import prepare_batch
    return prepare_batch([ds.load(i) for i in rows], cfg)


def loader_time(ds, cfg):
    """Host ms to load and pad a batch: from disk, then from the cache."""
    b = cfg.acoustic.batch_size
    rows = list(range(len(ds) - b, len(ds)))
    t0 = time.perf_counter()
    fixed_batch(ds, cfg, rows)
    first = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(5):
        fixed_batch(ds, cfg, rows)
    cached = 1e3 * (time.perf_counter() - t0) / 5
    return first, cached


def acoustic_cli_run(data_dir: str, run_dir: str):
    """``train_acoustic`` on the card at the default Config: a run to step
    24 with a checkpoint at step 20, then a restart to step 30 that resumes
    from it.  Every step's state and losses are recorded; the restored
    optimizer state is held to the checkpoint's."""
    import copy
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.train import train_acoustic as ta
    real = {'train_step': ta.train_step, 'train_step_hoisted': ta.train_step_hoisted}
    real_restore = ckpt.restore_acoustic
    calls, restored = [], {}

    def recording(name):
        def step(cfg, state, batch, draws):
            calls.append((name, state.step))
            state, losses = real[name](cfg, state, batch, draws)
            calls[-1] += (losses,)
            return state, losses
        return step

    def restore(run, state):
        out = real_restore(run, state)
        if out is not None:
            restored['state'] = copy.deepcopy(state.opt.state_dict())
            restored['step'] = state.step
        return out

    argv = ['--data_dir', data_dir, '--log_path', run_dir, '--log_interval', '4',
            '--summary_interval', '1000', '--checkpoint_interval', '20']
    for name in real:
        setattr(ta, name, recording(name))
    ta.ckpt.restore_acoustic = restore
    try:
        t0 = time.perf_counter()
        ta.main(argv + ['--max_steps', '24'])
        t_a = time.perf_counter() - t0
        steps_a = len(calls)
        saved = torch.load(ckpt.scan_checkpoint(run_dir, 'ckpt_'), map_location='cpu')
        t0 = time.perf_counter()
        ta.main(argv + ['--max_steps', '30'])
        t_b = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(ta, name, fn)
        ta.ckpt.restore_acoustic = real_restore
    opt_saved, opt_back = saved['opt_state']['state'], restored['state']['state']
    opt_equal = (opt_saved.keys() == opt_back.keys() and all(
        torch.equal(opt_saved[k][f].cpu(), opt_back[k][f].cpu())
        for k in opt_saved for f in ('step', 'exp_avg', 'exp_avg_sq')))
    adam_steps = {float(v['step']) for v in opt_back.values()}
    finite = all(bool(torch.isfinite(torch.stack([v for v in c[2].values()
                                                  if isinstance(v, torch.Tensor)])).all())
                 for c in calls)
    kinds = sorted({c[0] for c in calls})
    log(f'  train_acoustic run A: {steps_a} steps in {t_a:.1f} s (dataset, init, eval dump '
        f'included), checkpoint step {saved["step"]}; run B resumed at step '
        f'{calls[steps_a][1]}, {len(calls) - steps_a} steps in {t_b:.1f} s; optimizer state '
        f'restored equal to the checkpoint: {opt_equal} (Adam step {adam_steps}); steps '
        f'taken by {kinds}; every loss finite: {finite}; loss '
        f'{float(calls[0][2]["loss"]):.3f} at step 0, {float(calls[-1][2]["loss"]):.3f} '
        f'at step {calls[-1][1]}')
    if not (steps_a == 24 and saved['step'] == 20 and restored.get('step') == 20
            and calls[steps_a][1] == 20 and len(calls) - steps_a == 10 and opt_equal
            and adam_steps == {20.0} and finite):
        raise AssertionError('the acoustic training run did not train, checkpoint or resume')


def acoustic_step_times(cfg, device, batch):
    """Median and quartiles (CUDA events) of STEP_TIMED steps after
    STEP_WARM, for the hoisted step (before the teacher-forcing decay) and
    the scanned step (state.step past it, so tfr < 1), remat on and off;
    peak memory of each."""
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train.train_acoustic import make_draws
    hp = cfg.acoustic
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, acoustic=dataclasses.replace(hp, remat_decoder=remat))
        for name, fn, step0 in (('hoisted', A.train_step_hoisted, 0),
                                ('scanned', A.train_step, hp.tf_start_decay + 10000)):
            state = A.init_state(c, SEED, device)
            state.step = step0
            draws = make_draws(SEED, device)
            for _ in range(STEP_WARM):
                fn(c, state, batch, draws)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(STEP_TIMED + 1)]
            marks[0].record()
            for i in range(STEP_TIMED):
                fn(c, state, batch, draws)
                marks[i + 1].record()
            torch.cuda.synchronize()
            ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(STEP_TIMED)]
            out[(name, remat)] = float(np.median(ms))
            log(f'  {name} step, remat {"on" if remat else "off"}: {quartiles(ms)} '
                f'({STEP_TIMED} after {STEP_WARM} warm-up); max_memory_allocated '
                f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; '
                f'{threading.active_count()} Python threads')
    return out


def acoustic_profile(cfg, device, batch):
    """Launches per step, device busy share and the largest kernels of the
    hoisted and the scanned step at the default Config (remat on;
    ``tools/acoustic_step_profile.py``): STEP_WARM warm-up steps, PROFILED
    steps timed by CUDA events, the same number under the profiler
    (kernels only)."""
    from transtacos_retunegan_tpu_torch.tools.acoustic_step_profile import profile_steps
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    for name, fn, step0 in (('hoisted', A.train_step_hoisted, 0),
                            ('scanned', A.train_step, cfg.acoustic.tf_start_decay + 10000)):
        state = A.init_state(cfg, SEED, device)
        state.step = step0
        step_ms, busy_ms, launches, wall_ms, top = profile_steps(
            cfg, state, batch, fn, PROFILED, STEP_WARM)
        log(f'  profile, {name} step: {step_ms:.2f} ms per step (CUDA events, profiler off), '
            f'kernels {busy_ms:.2f} ms, device busy {100 * busy_ms / step_ms:.1f}%, '
            f'{launches:.0f} kernel launches per step, {1e3 * step_ms / launches:.1f} µs '
            f'of step per launch ({wall_ms:.2f} ms on the host clock with the profiler '
            'on); largest: '
            + '; '.join(f'{k[:60]} {ms:.3f} ms x{n:.0f}' for k, ms, n in top[:4]))


def grad_errors(model, ref_model, global_norm: float):
    """Over the parameters: the largest difference of a leaf's gradient
    from the reference's over the larger of that leaf's norm and 1e-6 of
    the global norm (the attention keys' biases have a gradient that is 0
    in exact arithmetic: a constant per query row under the softmax), as
    (name, ratio)."""
    ref = dict(ref_model.named_parameters())
    worst = ('', 0.0)
    for name, p in model.named_parameters():
        g, rg = p.grad.cpu(), ref[name].grad
        ratio = float((g - rg).abs().max()) / max(float(rg.norm()), 1e-6 * global_norm)
        if ratio > worst[1]:
            worst = (name, ratio)
    return worst


def acoustic_card_vs_cpu(cfg, device, batch_np):
    """One hoisted and one scanned step of the default Config on the card
    and on the CPU from the same seeded weights and batch, the prenet's
    dropout masks drawn once on the CPU and given to both, the Gaussian
    noises off (std 1e-5; a generator draws other numbers on each device).
    Losses within ACOUSTIC_LOSS_TOL relative, gradients within
    ACOUSTIC_GRAD_TOL of each leaf's norm (``grad_errors``)."""
    from transtacos_retunegan_tpu_torch.models.layers import Draws, keep_mask
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    hp = cfg.acoustic
    cpu_b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}
    s, b = cpu_b['mel_targets'].shape[1] // hp.outputs_per_step, cpu_b['text'].shape[0]
    g = torch.Generator().manual_seed(SEED)
    keep = [keep_mask((s, b, w), 0.5, g, 'cpu') for w in hp.prenet_depths]
    worst = {}
    for name, fn, step0 in (('hoisted', A.train_step_hoisted, 0),
                            ('scanned', A.train_step, hp.tf_start_decay + 10000)):
        runs = {}
        for where, dev in (('cpu', torch.device('cpu')), ('gpu', device)):
            state = A.init_state(cfg, SEED, dev)
            state.step = step0
            t0 = time.perf_counter()
            _, losses = fn(cfg, state, {k: v.to(dev) for k, v in cpu_b.items()},
                           Draws(prenet_keep=[k.to(dev) for k in keep]))
            runs[where] = (state.model, {k: float(v) for k, v in losses.items()},
                           time.perf_counter() - t0)
        ref = runs['cpu'][1]
        rel = {k: abs(runs['gpu'][1][k] - v) / max(abs(v), 1e-6) for k, v in ref.items()}
        wl = max(rel, key=rel.get)
        wg = grad_errors(runs['gpu'][0], runs['cpu'][0], ref['grad_norm'])
        worst[name] = (rel[wl], wg[1])
        log(f'  {name} step, B={b}, {s} decode steps, card vs CPU (CPU step '
            f'{runs["cpu"][2]:.1f} s): loss {ref["loss"]:.5f}, worst loss term {wl} '
            f'{rel[wl]:.2e} relative (tol {ACOUSTIC_LOSS_TOL:.0e}); worst gradient leaf '
            f'{wg[0]} {wg[1]:.2e} of its norm (tol {ACOUSTIC_GRAD_TOL:.0e})')
    if not all(l <= ACOUSTIC_LOSS_TOL and gr <= ACOUSTIC_GRAD_TOL for l, gr in worst.values()):
        raise AssertionError('the acoustic step on the card disagrees with the CPU')


def acoustic_descent(cfg, device, batch):
    """DESCENT_STEPS hoisted steps on one fixed batch from the seeded start
    with warmup_steps=DESCENT_WARMUP (the default 4000 puts the Noam rate
    at 2.5e-7 on step 0), remat off (the same function, in less time): mel+mag
    L1 must end below DESCENT_FALL of its first value."""
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train.train_acoustic import make_draws
    c = dataclasses.replace(cfg, acoustic=dataclasses.replace(
        cfg.acoustic, warmup_steps=DESCENT_WARMUP, remat_decoder=False))
    state = A.init_state(c, SEED, device)
    draws = make_draws(SEED, device)
    l1 = []
    for _ in range(DESCENT_STEPS):
        _, losses = A.train_step_hoisted(c, state, batch, draws)
        l1.append(losses['mel_loss'] + losses['mag_loss'])
    l1 = [float(x) for x in torch.stack(l1).cpu()]
    log(f'  mel+mag L1 on one fixed batch over {DESCENT_STEPS} hoisted steps from the seeded '
        f'start, warmup_steps shortened to {DESCENT_WARMUP} (default 4000), remat off: '
        + ' '.join(f'{x:.3f}' for x in l1[::5]) + f' ... {l1[-1]:.4f}; last/first '
        f'{l1[-1] / l1[0]:.3f} (must be below {DESCENT_FALL})')
    if not l1[-1] < DESCENT_FALL * l1[0]:
        raise AssertionError('the acoustic loss did not fall on a fixed batch')


def fast_cell_decode(fd, device):
    """The whole-decode kernel on a seeded stock cell and on the fused
    layout of it (``decoder_fast.fuse_cell_params``), float32 weights,
    B=4, N=48, no stop: the two decodes agree within the float32 kernel
    tolerance."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.decoder_fast import (DecoderCellFast,
                                                                    fuse_cell_params)
    stock = full_width_cell(device)
    fast = DecoderCellFast(Config()).to(device)
    fast.load_state_dict(fuse_cell_params(stock.state_dict()))
    outs = []
    for cell in (stock, fast):
        fp = fd.fold_params(cell, torch.float32)
        fp.f['bs'].fill_(-20.0)
        mem = memory(fp.dims, 4, 48, device, seed=8)
        outs.append(fd.to_outputs(fp, *fd.decode_full(fp, *mem, 100)))
    errs = errors(fp, outs[1], outs[0])
    log(f'  decode_full, stock cell against its fused layout (fast_cell), B=4, N=48, 100 '
        f'steps, float32: {err_text(errs, torch.float32)}')
    if not within(errs, torch.float32):
        raise AssertionError('the fused-layout cell decodes differently')


def served_from_checkpoint(fd, run_dir: str, device):
    """The run's newest checkpoint serves one ``tts_fused`` request through
    the decode kernel; returns the launches."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    from transtacos_retunegan_tpu_torch.train.checkpoint import load_acoustic_params
    synth = Synthesizer(acoustic_params=load_acoustic_params(run_dir), devices=[device])
    for k in fd.LAUNCHES:
        fd.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    wav = synth.tts_fused(REQUESTS[0])
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(fd.LAUNCHES)
    log(f'  the trained checkpoint serves tts_fused({REQUESTS[0]!r}): {ms:.1f} ms, '
        f'{len(wav)} samples, launches {launches}')
    if launches['decode_full'] != 1 or not np.isfinite(wav).all() or not len(wav):
        raise AssertionError('the trained checkpoint did not serve through decode_full')
    return launches


def acoustic_training(fd, device, base: str):
    """Phase 8; returns the kernel launches of its served request.  Its
    corpus and run dir stay in ``base`` (phase 12 resumes and serves the
    run)."""
    from transtacos_retunegan_tpu_torch.config import Config
    cfg = Config()
    hp = cfg.acoustic
    log(f'  default Config: H={hp.decoder_depth}, A={hp.attention_depth}, '
        f'D={hp.encoder_depth}, r={hp.outputs_per_step}, {hp.decoder_layers} GRUs, prenet '
        f'{hp.prenet_depths}, encoder {hp.encoder_type} (fusenet {hp.encoder_fusenet}), '
        f'B={hp.batch_size}, tf_method {hp.tf_method}, remat_decoder {hp.remat_decoder}, '
        'float32 (TF32 off)')

    def part(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f'  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)')
        return out

    part(fast_cell_decode, fd, device)
    data_dir, ds = part(acoustic_corpus, f'{base}/corpus', cfg)
    first, cached = loader_time(ds, cfg)
    rows = sorted(range(len(ds)), key=ds.frame_len)[-hp.batch_size:]
    batch_np = fixed_batch(ds, cfg, rows)
    n, t = batch_np['text'].shape[1], batch_np['mel_targets'].shape[1]
    log(f'  fixed batch (the {hp.batch_size} longest): text padded to N={n}, frames to '
        f'T={t}, T/r={t // hp.outputs_per_step} decode steps; loader, ms per batch of '
        f'{hp.batch_size}: {first:.1f} from disk, {cached:.2f} cached')
    for k in fd.LAUNCHES:
        fd.LAUNCHES[k] = 0
    part(acoustic_cli_run, data_dir, f'{base}/run')
    if any(fd.LAUNCHES.values()):
        raise AssertionError(f'training launched a serving kernel: {fd.LAUNCHES}')
    launches = part(served_from_checkpoint, fd, f'{base}/run', device)
    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch_np.items()}
    times = part(acoustic_step_times, cfg, device, batch)
    log(f'  host loader: {cached:.2f} ms per cached batch against a '
        f'{times[("hoisted", True)]:.1f} ms hoisted step')
    part(acoustic_profile, cfg, device, batch)
    part(acoustic_descent, cfg, device, batch)
    part(acoustic_card_vs_cpu, cfg, device, batch_np)
    return launches, data_dir


# Data parallelism (phase 9): the global batches at the default Config
# (B=16; the acoustic one of 240 frames, 64 decode steps with the
# frame bucket), the ranks' tolerances
# against the one-process step on the card (losses relative, gradients of
# each leaf's norm, floored at 1e-6 of the global norm), timed steps per
# measurement.  Half a batch runs other cuBLAS/cuDNN algorithms than the
# whole one, so the ranks' gradients differ from one process's by the
# sums' order: up to 3.3e-4 of a leaf's norm on an H100 (the posnet's
# first bias: the L1 loss's +-1 terms cancel in its sum over the frames),
# as card and CPU differ; both steps are held to 1e-3, and the ranks to
# each other bit for bit.  The GAN comparison starts both optimizers past
# their first update (see ``primed``): Adam's first update is a sign, and
# the generator update runs against the updated discriminators.
DP_FRAMES, DP_TEXT = 240, 48
# float32: half a batch runs other cuBLAS/cuDNN algorithms, and leaves that
# sum terms which cancel (the posnet's first bias, the weight-norm gains)
# move by a few 1e-4 of their norm with the summation order; in float64
# the same comparison checks the data-parallel arithmetic alone.  The GAN
# step has a leaf that is one scalar summing 131,072 terms which cancel
# (``WNConv_4.b``): its float32 rounding is of order eps x the sum of
# their magnitudes, which read up to 7e-3 of the leaf's norm against the
# whole batch, so no bound on that comparison is sound.  The two float32
# ranks' GAN step is held instead to this process's step on the same two
# half-batches (``paired_ranks``: the same algorithms, the same two-term
# sum), within DP_PAIR_TOL; the whole batch's figure is printed beside
# DP_GAN_TOL.
DP_ACOUSTIC_TOL, DP_GAN_TOL, DP_F64_TOL, DP_PAIR_TOL = 1e-3, 1e-3, 1e-5, 1e-6
DP_TIMED, DP_WARM = 5, 1
DP_TIMEOUT_S = 600


def dp_batches(cfg):
    """The global acoustic batch, its prenet masks (scaled as
    ``layers.keep_mask``'s, drawn at the global shape) and the GAN batch,
    on the CPU, all from SEED (every rank builds the same)."""
    from transtacos_retunegan_tpu_torch.tools.acoustic_step_profile import seeded_batch
    hp = cfg.acoustic
    acoustic = seeded_batch(cfg, hp.batch_size, DP_FRAMES, DP_TEXT, SEED, 'cpu')
    s = acoustic['mel_targets'].shape[1] // hp.outputs_per_step
    g = torch.Generator().manual_seed(SEED)
    keep = [(torch.rand((s, hp.batch_size, w), generator=g) < 0.5).float() / 0.5
            for w in hp.prenet_depths]
    r = np.random.RandomState(SEED)
    b, seg, hop = cfg.vocoder.batch_size, cfg.audio.segment_size, cfg.audio.hop_length
    gan = {'mel': r.randn(b, seg // hop, cfg.audio.n_mel), 'tmpl': 0.1 * r.randn(b, seg),
           'wav': 0.1 * r.randn(b, seg)}
    return acoustic, keep, {k: torch.tensor(v, dtype=torch.float32) for k, v in gan.items()}


def primed(opt) -> None:
    """Adam's state of a run past its first updates (step 1000, zero first
    moment, second moment 1e-6), so that the next update is smooth in the
    gradient rather than its sign."""
    for group in opt.param_groups:
        for p in group['params']:
            opt.state[p] = {'step': torch.tensor(1000.0), 'exp_avg': torch.zeros_like(p),
                            'exp_avg_sq': torch.full_like(p, 1e-6)}


def snapshot(named, metrics):
    return ({n: (p.detach().clone(), p.grad.clone()) for n, p in named},
            {k: float(v) for k, v in metrics.items()})


def local_batch(b, sl, device, dtype=torch.float32):
    """Rows ``sl`` of the global batch ``b`` on ``device``, its floating
    tensors in ``dtype``."""
    return {k: (v[sl] if v.dim() else v).to(device, dtype if v.is_floating_point()
                                             else v.dtype) for k, v in b.items()}


def acoustic_first_step(cfg, device, dtype, acoustic, keep, shard=None):
    """This process's share (``parallel.process_shard``: all of it outside
    a group) of one hoisted acoustic step from SEED in ``dtype`` with the
    global batch's prenet masks, the state first passed to ``shard`` (the
    model axis's ``shard_params_tp``).  Returns the state and the whole
    averaged gradients and losses."""
    from transtacos_retunegan_tpu_torch.models.layers import Draws
    from transtacos_retunegan_tpu_torch.parallel import current_shard, gather_tp, process_shard
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    sl = process_shard(cfg.acoustic.batch_size)
    state = A.init_state(cfg, SEED, device, current_shard())
    state.model.to(dtype)
    if shard is not None:
        shard(state)
    _, losses = A.train_step_hoisted(cfg, state, local_batch(acoustic, sl, device, dtype), Draws(
        prenet_keep=[k[:, sl].to(device, dtype) for k in keep]))
    grads = gather_tp(state.model, {n: p.grad for n, p in state.model.named_parameters()})
    return state, ({n: g.cpu().clone() for n, g in grads.items()},
                   {k: float(v) for k, v in losses.items()})


def gan_first_step(cfg, device, dtype, gan, shard):
    """One GAN step from SEED in ``dtype`` on ``shard``'s rows of the
    global batch ``gan`` (all of them without a shard) with the global
    batch's noise, both optimizers primed.  Returns the state and the
    averaged gradients and losses."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as V
    gst = V.init_gan_state(cfg, SEED, device, shard)
    gst.generator.to(dtype)
    gst.discriminators.to(dtype)
    primed(gst.gen_opt)
    primed(gst.disc_opt)
    b = cfg.vocoder.batch_size
    rows = (slice(None) if shard is None else
            slice(shard.index * b // shard.count, (shard.index + 1) * b // shard.count))
    noise = drawn_noise(cfg, gst.generator, local_batch(gan, slice(None), device, dtype), SEED)
    _, m = V.gan_train_step(cfg, gst, local_batch(gan, rows, device, dtype),
                            [n[rows].to(device, dtype) for n in noise], 4)
    params = list(gst.generator.named_parameters()) + [
        (f'disc.{n}', p) for n, p in gst.discriminators.named_parameters()]
    return gst, ({n: p.grad.cpu().clone() for n, p in params},
                 {k: float(v) for k, v in m.items()})


def dp_first_steps(cfg, device, dtype, acoustic, keep, gan):
    """``acoustic_first_step`` and ``gan_first_step`` (under deterministic
    algorithms) of this process's share.  Returns the two states and each
    step's averaged gradients and losses."""
    from transtacos_retunegan_tpu_torch.parallel import current_shard
    from transtacos_retunegan_tpu_torch.utils.determinism import deterministic
    state, grads = acoustic_first_step(cfg, device, dtype, acoustic, keep)
    out = {'acoustic': grads}
    with deterministic():
        gst, out['gan'] = gan_first_step(cfg, device, dtype, gan, current_shard())
    return state, gst, out


class PairRank:
    """Rank ``rank`` of two threads of this process that stand in for a
    gloo group of two (``paired_ranks``)."""

    def __init__(self, rank: int):
        self.rank = rank


def paired_ranks(fn):
    """``fn(shard)`` on two threads of this process, as data shards 0 and 1
    of a group of two whose all-reduce sums the two ranks' tensors in rank
    order, each rank then holding the sum: what gloo's all-reduce of two
    gives (one addition per element, which commutes exactly).  Each rank
    runs the same kernels as a process of its own on its half-batch.
    Returns the two results in rank order."""
    import torch.distributed as dist
    from transtacos_retunegan_tpu_torch.parallel import Shard
    meet = threading.Barrier(2, timeout=DP_TIMEOUT_S)
    slots = [None, None]

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if not isinstance(group, PairRank) or op != dist.ReduceOp.SUM or async_op:
            raise AssertionError('only the sum over a paired group is stood in for')
        slots[group.rank] = t
        meet.wait()
        total = slots[0] + slots[1]
        meet.wait()
        t.copy_(total)

    def rank(r):
        try:
            return fn(Shard(r, 2, data_group=PairRank(r)))
        except BaseException:
            meet.abort()
            raise

    saved = dist.all_reduce, dist.get_backend
    dist.all_reduce, dist.get_backend = all_reduce, lambda group=None: 'gloo'
    try:
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(rank, r) for r in range(2)]
            return [f.result() for f in futs]
    finally:
        dist.all_reduce, dist.get_backend = saved


def paired_gan_step(device):
    """Phase 9 (ii)'s float32 GAN reference: ``gan_first_step`` of the two
    half-batches in this process (``paired_ranks``), under deterministic
    algorithms, as the two ranks run it; rank 0's averaged gradients and
    losses."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.utils.determinism import deterministic
    cfg = Config()
    _, _, gan = dp_batches(cfg)
    with deterministic():
        out = paired_ranks(lambda shard: gan_first_step(cfg, device, torch.float32, gan,
                                                        shard)[1])
    if not (out[0][1] == out[1][1] and all(torch.equal(g, out[1][0][n])
                                           for n, g in out[0][0].items())):
        raise AssertionError('the paired ranks disagree with each other')
    return out[0]


def times(step, timed: int, warm: int):
    """CUDA-event times (ms) of ``timed`` calls of ``step`` after ``warm``."""
    for _ in range(warm):
        step()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    marks[0].record()
    for i in range(timed):
        step()
        marks[i + 1].record()
    torch.cuda.synchronize()
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(timed)]


def dp_steps(device, timed: int = DP_TIMED):
    """``dp_first_steps`` in float32 and in float64 (``*64``), then
    ``timed`` more float32 steps of each (CUDA events, after DP_WARM), the
    noise from a generator.  Returns the first steps' losses and averaged
    gradients, the step times and a hash of the parameters after them."""
    import hashlib
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.parallel import process_shard
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train import vocoder_step as V
    from transtacos_retunegan_tpu_torch.train.train_acoustic import make_draws
    cfg = Config()
    acoustic, keep, gan = dp_batches(cfg)
    _, _, out64 = dp_first_steps(cfg, device, torch.float64, acoustic, keep, gan)
    state, gst, out = dp_first_steps(cfg, device, torch.float32, acoustic, keep, gan)
    out.update({f'{k}64': v for k, v in out64.items()})
    batch = local_batch(acoustic, process_shard(cfg.acoustic.batch_size), device)
    draws = make_draws(SEED, device)
    out['acoustic_ms'] = times(lambda: A.train_step_hoisted(cfg, state, batch, draws),
                               timed, DP_WARM)
    gbatch = local_batch(gan, process_shard(cfg.vocoder.batch_size), device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out['gan_ms'] = times(lambda: V.gan_train_step(cfg, gst, gbatch, gen, 4), timed, DP_WARM)
    h = hashlib.sha1()
    for module in (state.model, gst.generator, gst.discriminators):
        for p in module.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    out['hash'] = h.hexdigest()
    return out


def gloo_rank(rank: int, port: int, out_dir: str, device: str, fn, *args) -> None:
    """One rank of phases 9 (ii) and 11: joins a gloo group of two on
    ``device`` and saves ``fn(device, *args)`` to ``out_dir``."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=2,
                            rank=rank)
    try:
        device = torch.device(device)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        torch.save(fn(device, *args), os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn_gloo_ranks(out_dir: str, device, fn, *args):
    """``gloo_rank`` of ``fn`` in two spawned processes on cuda:0 (on
    ``device`` itself off the card); their results in rank order and the
    seconds they took with their start.  Raises AssertionError when a rank
    fails; a rank still running after DP_TIMEOUT_S is stopped."""
    import multiprocessing
    from transtacos_retunegan_tpu_torch.parallel import free_port
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    where = 'cuda:0' if device.type == 'cuda' else str(device)
    procs = [ctx.Process(target=gloo_rank, args=(r, port, out_dir, where, fn) + args)
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f'a rank of the gloo group ({fn.__name__}) failed: '
                             f'exit codes {codes}')
    ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt')) for r in range(2)]
    return ranks, time.perf_counter() - t0


def dp_errors(got, ref, tol: float):
    """Worst loss term (relative, 1e-6 absolute floor) and worst gradient
    leaf (of the larger of its norm and 1e-6 of the global norm) of ``got``
    against ``ref``, each as (name, ratio); and whether both are within
    ``tol``.  The attention keys' biases, whose gradient is 0 in exact
    arithmetic (float32 rounding, a change of summation order moves it by
    1e-4 of that floor), are held apart: within 1e-6 of the global norm."""
    (grads, losses), (rgrads, rlosses) = got, ref
    rel = {k: abs(losses[k] - v) / max(abs(v), 1e-6) for k, v in rlosses.items()}
    wl = max(rel, key=rel.get)
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in rgrads.values())))
    diff = {n: float((grads[n] - g).abs().max()) for n, g in rgrads.items()}
    zero_ok = all(d <= 1e-6 * gnorm for n, d in diff.items() if n.endswith('.k.bias'))
    ratio = {n: d / max(float(rgrads[n].norm()), 1e-6 * gnorm)
             for n, d in diff.items() if not n.endswith('.k.bias')}
    wg = max(ratio, key=ratio.get)
    return (wl, rel[wl]), (wg, ratio[wg]), rel[wl] <= tol and ratio[wg] <= tol and zero_ok


def nccl_world_one(card: str, device):
    """Phase 9 (i): the acoustic and GAN steps in an NCCL group of world
    size 1, bit for bit as without a group, and their times with and
    without it."""
    import torch.distributed as dist
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.layers import Draws
    from transtacos_retunegan_tpu_torch.parallel import (current_shard, free_port,
                                                        maybe_initialize_distributed)
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train import vocoder_step as V
    from transtacos_retunegan_tpu_torch.utils.determinism import deterministic
    cfg = Config()
    acoustic, keep, gan = dp_batches(cfg)
    batch = {k: v.to(device) for k, v in acoustic.items()}
    draws = Draws(prenet_keep=[k.to(device) for k in keep])
    gbatch = {k: v.to(device) for k, v in gan.items()}
    noise = [n.to(device) for n in drawn_noise(
        cfg, V.init_gan_state(cfg, SEED, device).generator, gbatch, SEED)]

    def acoustic_step():
        state = A.init_state(cfg, SEED, device, current_shard())
        _, losses = A.train_step_hoisted(cfg, state, batch, draws)
        return snapshot(state.model.named_parameters(), losses)

    def gan_step():
        st = V.init_gan_state(cfg, SEED, device, current_shard())
        _, m = V.gan_train_step(cfg, st, gbatch, noise, 4)
        return snapshot(list(st.generator.named_parameters())
                        + list(st.discriminators.named_parameters()), m)

    def same(a, b):
        return a[1] == b[1] and all(torch.equal(x, y) for k in a[0]
                                    for x, y in zip(a[0][k], b[0][k]))

    def step_ms(fn, state_fn):
        st = state_fn()
        for _ in range(DP_WARM):
            fn(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            fn(st)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / DP_TIMED

    def timings():
        a = step_ms(lambda st: A.train_step_hoisted(cfg, st, batch, draws),
                    lambda: A.init_state(cfg, SEED, device, current_shard()))
        g = step_ms(lambda st: V.gan_train_step(cfg, st, gbatch, noise, 4),
                    lambda: V.init_gan_state(cfg, SEED, device, current_shard()))
        return a, g

    def group(on: bool):
        if on:
            maybe_initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0, device=device)
        else:
            dist.destroy_process_group()

    with deterministic() as notes:
        ref = {'acoustic': acoustic_step(), 'gan': gan_step()}
        control = {'acoustic': same(acoustic_step(), ref['acoustic']),
                   'gan': same(gan_step(), ref['gan'])}
        group(True)
        backend = dist.get_backend()
        dp = {'acoustic': same(acoustic_step(), ref['acoustic']),
              'gan': same(gan_step(), ref['gan'])}
        group(False)
    ms = {}
    for turn, on in enumerate((False, True, True, False)):
        if on:
            group(True)
        ms[turn] = (on, timings())
        if on:
            group(False)
    log(f'  (i) {backend} group of world size 1: hoisted acoustic step '
        f'(B={cfg.acoustic.batch_size}, {batch["mel_targets"].shape[1] // 5} decode steps) and '
        f'GAN step (B={cfg.vocoder.batch_size}) bit for bit as without a group: {dp} (control, '
        f'the step without a group run twice: {control}); ops without a deterministic '
        f'implementation: {sorted(notes) or "none"}')
    for name, i in (('acoustic', 0), ('GAN', 1)):
        without = [v[1][i] for v in ms.values() if not v[0]]
        with_ = [v[1][i] for v in ms.values() if v[0]]
        log(f'  (i) {name} step ms, mean of {DP_TIMED} after {DP_WARM} (host clock), in turns '
            f'without/with/with/without the group: '
            + ' / '.join(f'{v[1][i]:.2f}' for v in ms.values())
            + f'; the all-reduce at world size 1 costs {np.mean(with_) - np.mean(without):+.2f} '
            f'ms per step [{card}]')
    if not (all(control.values()) and all(dp.values())):
        raise AssertionError(f'world size 1 is not the step without a group: {dp}, '
                             f'control {control}')


def gloo_two_ranks(card: str, device):
    """Phase 9 (ii): two spawned ranks in a gloo group on cuda:0 against
    this process's step on the whole batch, and their float32 GAN step
    against this process's step on the same two half-batches."""
    import tempfile
    t0 = time.perf_counter()
    ref = dp_steps(device)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = paired_gan_step(device)
    pair_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_gloo_ranks(tmp, device, dp_steps)
    ok = ranks[0]['hash'] == ranks[1]['hash']
    for name, tol in (('acoustic', DP_ACOUSTIC_TOL), ('gan', DP_GAN_TOL),
                      ('acoustic64', DP_F64_TOL), ('gan64', DP_F64_TOL)):
        wl, wg, within_tol = dp_errors(ranks[0][name], ref[name], tol)
        gate = name != 'gan'
        ok = ok and (within_tol or not gate)
        log(f'  (ii) gloo, 2 ranks on one card, half the batch each, {name} step against '
            f'one process on the whole batch: worst loss {wl[0]} {wl[1]:.2e} relative, worst '
            f'gradient leaf {wg[0]} {wg[1]:.2e} of its norm (tol {tol:.0e}'
            + ('' if gate else ': printed, not held; see the paired half-batches') + ')')
    wl, wg, within_tol = dp_errors(ranks[0]['gan'], pair, DP_PAIR_TOL)
    same = ranks[0]['gan'][1] == pair[1] and all(
        torch.equal(g, pair[0][n]) for n, g in ranks[0]['gan'][0].items())
    ok = ok and within_tol
    log(f'  (ii) gan step of the 2 ranks against this process on the same two half-batches '
        f'(the same algorithms, the sum in rank order; deterministic algorithms): worst loss '
        f'{wl[0]} {wl[1]:.2e} relative, worst gradient leaf {wg[0]} {wg[1]:.2e} of its norm '
        f'(tol {DP_PAIR_TOL:.0e}); bit for bit: {same} ({pair_s:.1f} s)')
    for name in ('acoustic', 'gan'):
        log(f'  (ii) {name} step ms (CUDA events, {DP_TIMED} after {DP_WARM}): one process, '
            f'the whole batch: {quartiles(ref[name + "_ms"])}; rank 0 of 2 on one card, half '
            f'each: {quartiles(ranks[0][name + "_ms"])} [{card}]')
    log(f'  (ii) ranks bit for bit after {1 + DP_WARM + DP_TIMED} steps of each: '
        f'{ranks[0]["hash"] == ranks[1]["hash"]}; one-process reference {ref_s:.1f} s, '
        f'the two ranks {wall:.1f} s with their start')
    if not ok:
        raise AssertionError('the two-rank gloo steps disagree with one process')


def dp_serving(fd, synth, card: str, device):
    """Phase 9 (iii): two serving replicas on one card against one replica
    at the same rows per replica; returns the launches of the counted run."""
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    head, _ = plan_cohorts(fd, synth)
    use_stop(synth, head)
    dp2 = Synthesizer(devices=[device, device])
    for rep in dp2.replicas:
        use_stop(rep, head)
    texts = list(BATCH_TEXTS)
    half = len(texts) // 2
    gens = lambda s: [s.content_generator(t.encode()) for t in texts]     # noqa: E731
    for _ in range(2):                                   # warm-up, each replica's thread
        dp2.tts_batch(texts, generators=gens(dp2))
        synth.tts_batch(texts, generators=gens(synth))
    torch.cuda.synchronize()
    ref_specs = (synth.synthesize_spec_batch(texts[:half], rows=half)
                 + synth.synthesize_spec_batch(texts[half:], rows=half))
    g1 = gens(synth)
    ref_wavs = (synth.vocode_batch(ref_specs[:half], g1[:half], rows=half)
                + synth.vocode_batch(ref_specs[half:], g1[half:], rows=half))
    result = {}

    def counted():
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        specs = dp2.synthesize_spec_batch(texts, rows=len(texts))
        wavs = dp2.vocode_batch(specs, gens(dp2), rows=len(texts))
        result.update(launches=dict(fd.LAUNCHES), specs=specs, wavs=wavs)

    worker = threading.Thread(target=counted, daemon=True)
    worker.start()
    worker.join(DP_TIMEOUT_S)
    if worker.is_alive() or 'wavs' not in result:
        raise AssertionError('the two replicas on one card did not finish')
    launches = result['launches']
    same = (all(np.array_equal(a, b) for a, b in zip(result['specs'], ref_specs))
            and all(np.array_equal(a, b) for a, b in zip(result['wavs'], ref_wavs)))
    ms = {}
    for name, s in (('one replica', synth), ('two replicas', dp2), ('one replica ', synth),
                    ('two replicas ', dp2)):
        t = []
        for _ in range(BATCH_REPS):
            t0 = time.perf_counter()
            s.tts_batch(texts, generators=gens(s))
            t.append(1e3 * (time.perf_counter() - t0))
        ms[name] = float(np.median(t))
    log(f'  (iii) Synthesizer(devices=[cuda:0, cuda:0]), a cohort of {len(texts)} texts, '
        f'{half} rows per replica: launches {launches}, specs and wavs bit for bit as one '
        f'replica at {half} rows: {same}')
    log('  (iii) tts_batch of the cohort, median ms of '
        f'{BATCH_REPS}, in turns: ' + ', '.join(f'{k.strip()} {v:.2f}' for k, v in ms.items())
        + f' [{card}]')
    if launches != {'decode_step': 0, 'decode_full': 2} or not same:
        raise AssertionError(f'--dp 2 on one card: launches {launches}, bit for bit {same}')
    return launches


def data_parallel(fd, synth, card: str, device):
    """Phase 9; returns the launches of the serving replicas' counted run
    (the trainers launch none)."""
    for fn, args in ((nccl_world_one, (card, device)), (gloo_two_ranks, (card, device))):
        t0 = time.perf_counter()
        fn(*args)
        log(f'  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)')
    t0 = time.perf_counter()
    launches = dp_serving(fd, synth, card, device)
    log(f'  (dp_serving: {time.perf_counter() - t0:.1f} s)')
    return launches


# ---------------------------------------------------------------------------
# phase 10: the host side and the vocoder tools
# ---------------------------------------------------------------------------

# The loader's first epoch on LOADER_UTTS tone utterances of 1-4 s (four
# batches of 16: the loader's workers take whole batches, so that up to
# four run at once); the reference checkpoint's request (10 syllables); the
# vocoder CLI's card against CPU (float32, TF32 off: the generator's sums
# in other orders); the resident corpus's batches against the feeder's
# (its float16 store, relative to each array's largest value); the
# acoustic step timed over DD_STEPS steps of each data path; the
# closed-loop load of LATENCY_CONC workers for LATENCY_S seconds.
LOADER_UTTS, LOADER_WORKERS, TEMPLATE_FRAMES = 64, (1, 4), 300
INFER_TOL, STORE_TOL = 1e-3, 2e-3
DD_UTTS, DD_STEPS = 48, 6
LATENCY_S, LATENCY_WARM, LATENCY_CONC = 20.0, 3.0, 8


def native_loader(base: str):
    """The native library's build (a fresh compile of its source), one
    template with each engine, and the loader's first epoch (ms per batch of the
    default B) with each engine and worker count."""
    from transtacos_retunegan_tpu_torch.audio import features as F
    from transtacos_retunegan_tpu_torch.audio import transforms as T
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.data import native
    from transtacos_retunegan_tpu_torch.data.vocoder_data import VocoderDataset, VocoderLoader
    from transtacos_retunegan_tpu_torch.ops import build
    from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
    native.lib()              # built at first use (phase 7's loader); timed afresh here
    t0 = time.perf_counter()
    subprocess.run([build.host_compiler(), *build.HOST_FLAGS, '-o', f'{base}-lib.so',
                    str(native.SOURCE)], check=True)
    t_build = time.perf_counter() - t0
    cfg = Config()
    au, bs = cfg.audio, cfg.vocoder.batch_size
    write_corpus(base, au, LOADER_UTTS, 5, seed=SEED + 10)
    y = F.load_wav(f'{base}/wavs/tone0000.wav', au)
    log_mag = T.get_mag(np.resize(y, TEMPLATE_FRAMES * au.hop_length - 1), au)
    per_call = {}
    for engine in ('native', 'numpy'):
        for threads in LOADER_WORKERS:
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda _: T.inv_log_mag(log_mag, au, engine=engine), range(8)))
            per_call[(engine, threads)] = 1e3 * (time.perf_counter() - t0) / 8
    log(f'  native library built from {native.SOURCE.name} in {t_build:.1f} s '
        f'({build.host_compiler()} {" ".join(build.HOST_FLAGS)}); {TEMPLATE_FRAMES}-frame '
        f'templates, ms each over 8 on a pool of 1 and of {LOADER_WORKERS[-1]} threads: '
        + '; '.join(f'{e} x{w}: {ms:.1f}' for (e, w), ms in per_call.items()))
    out = {}
    for engine in ('native', 'numpy'):
        for workers in LOADER_WORKERS:
            loader = VocoderLoader(VocoderDataset('train', base, cfg, engine=engine), bs,
                                   num_workers=workers)
            t0 = time.perf_counter()
            n = len(list(loader))
            out[(engine, workers)] = 1e3 * (time.perf_counter() - t0) / n
    log(f'  vocoder loader, first epoch ({LOADER_UTTS} utterances of 1-4 s, {n} batches, '
        f'{os.cpu_count()} CPUs), ms per batch of {bs}: '
        + '; '.join(f'{e} x{w}: {ms:.1f}' for (e, w), ms in out.items()))
    return out


def imported_serving(fd, device, base: str):
    """A seeded reference-layout RefineGAN_small checkpoint, imported and
    served; returns the launches and the imported run dir."""
    from transtacos_retunegan_tpu_torch import interop
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    from transtacos_retunegan_tpu_torch.tools.import_reference_ckpt import import_run
    from transtacos_retunegan_tpu_torch.train.checkpoint import load_generator_params
    cfg = Config()
    with torch.device('meta'):
        shapes = make_generator(cfg)
    sd = interop.seeded_state_dict(shapes, interop.map_refinegan_small(), SEED)
    os.makedirs(f'{base}/reference')
    torch.save({'generator': sd}, f'{base}/reference/g_00400000')
    t0 = time.perf_counter()
    g_path = import_run(f'{base}/reference/g_00400000', f'{base}/imported', cfg=cfg)
    t_import = time.perf_counter() - t0
    served = Synthesizer(cfg, gen_params=load_generator_params(f'{base}/imported'),
                         devices=[device])
    direct = Synthesizer(cfg, gen_params=interop.import_generator_state_dict(
        sd, 'RefineGAN_small'), devices=[device])
    direct.tts_fused(REQUESTS[0])
    served.tts_fused(REQUESTS[0])
    for k in fd.LAUNCHES:
        fd.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    wav = served.tts_fused(REQUESTS[1])
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(fd.LAUNCHES)
    ref = direct.tts_fused(REQUESTS[1])
    same = wav.shape == ref.shape and np.array_equal(wav, ref)
    log(f'  reference-layout checkpoint imported in {t_import:.1f} s ({g_path}); served '
        f'tts_fused({REQUESTS[1]!r}): {ms:.1f} ms, {len(wav)} samples, launches {launches}; '
        f'bit for bit as from_flax: {same}')
    if not (same and launches['decode_full'] == 1 and np.isfinite(wav).all() and len(wav)):
        raise AssertionError('the imported checkpoint did not serve as its weights do')
    return launches, f'{base}/imported'


def infer_vocoder_cli(run: str, corpus: str, base: str, device):
    """``infer_vocoder``'s CLI over 3 mags and 2 wavs, on the card (twice:
    the first run builds cuDNN's plans) and on the CPU."""
    from transtacos_retunegan_tpu_torch.audio import features as F
    from transtacos_retunegan_tpu_torch.audio import transforms as T
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.serve import infer_vocoder
    au = Config().audio
    os.makedirs(f'{base}/in')
    for i in range(5):
        y = F.load_wav(f'{corpus}/wavs/tone{i:04d}.wav', au)
        if i < 3:             # the acoustic preprocessor's mag-*.npy
            y = F.align_wav(F.trim_silence(y, au), au.hop_length)
            np.save(f'{base}/in/mag-{i}.npy', T.get_specs(y[:-1], au)[0])
        else:
            F.save_wav(y, f'{base}/in/utt{i}.wav', au)
    secs = {}
    for out, dev in (('cold', str(device)), ('card', str(device)), ('cpu', 'cpu')):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            infer_vocoder.main(['--run_dir', run, '--input_dir', f'{base}/in',
                                '--output_dir', f'{base}/{out}', '--device', dev])
        secs[out] = (time.perf_counter() - t0) / 5
    worst, audio = 0.0, 0.0
    for f in sorted(os.listdir(f'{base}/card')):
        a, b = F.load_wav(f'{base}/card/{f}', au), F.load_wav(f'{base}/cpu/{f}', au)
        worst = max(worst, float(np.abs(a - b).max()) if a.shape == b.shape else np.inf)
        audio += len(a) / au.sample_rate
    log(f'  infer_vocoder CLI, 3 mags + 2 wavs ({audio:.1f} s of audio): s per file on the '
        f'card {secs["cold"]:.3f} (first run), {secs["card"]:.3f} (second), on the CPU '
        f'{secs["cpu"]:.3f}; card against CPU max|diff| {worst:.2e} (tolerance {INFER_TOL:g})')
    if not worst <= INFER_TOL:
        raise AssertionError('infer_vocoder on the card disagrees with the CPU')


def _batch_errors(got, ref):
    """Largest error of the gathered batch against the feeder's on the
    feeder's extent, relative to each array's largest value; whether the
    loss lengths are equal."""
    worst = 0.0
    for k, b in ref.items():
        if b.ndim == 0:
            continue
        a = got[k].float().cpu().numpy()[tuple(slice(0, n) for n in b.shape)]
        worst = max(worst, float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max())))
    lens = all(int(got[k]) == int(ref[k]) for k in ('frame_loss_len', 'text_loss_len'))
    return worst, lens


def acoustic_data_paths(device, base: str):
    """``train_acoustic`` with ``--device_data`` and with the streaming
    feeder: batches, bytes and step times."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.data.device_data import DeviceResidentData
    from transtacos_retunegan_tpu_torch.data.feeder import AcousticDataset, prepare_batch
    from transtacos_retunegan_tpu_torch.tools.synth_corpus import build_corpus
    from transtacos_retunegan_tpu_torch.train import train_acoustic as ta
    cfg = Config()
    bs = cfg.acoustic.batch_size
    data_dir = build_corpus(f'{base}/corpus', cfg, n_utts=DD_UTTS, seed=SEED, num_workers=4,
                            min_syl=SYLLABLES[0], max_syl=SYLLABLES[1])
    ds = AcousticDataset(data_dir, cfg)
    t0 = time.perf_counter()
    dd = DeviceResidentData(ds, cfg, device)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    plan = dd.plan(seed=cfg.audio.randseed)
    worst, lens, wire, frames = 0.0, True, [], []
    for _ in range(3):
        idx = next(plan)
        ref = prepare_batch([ds.load(int(i)) for i in idx], cfg)
        w, ok = _batch_errors(dd.gather(idx), ref)
        worst, lens = max(worst, w), lens and ok
        wire.append(sum(v.nbytes for v in ref.values()))
        frames.append(ref['mel_targets'].shape[1])
    log(f'  resident corpus: {dd.n} utterances, T{dd.t_pad} x N{dd.n_pad}, '
        f'{dd.nbytes() / 2 ** 20:.1f} MiB on the card, uploaded in {t_up:.2f} s; host-to-device '
        f'bytes per step: {4 * bs} (indices) against {np.median(wire):.0f} (the feeder\'s '
        f'float32 batch); the feeder pads the same batches to T {frames}, the resident '
        f'corpus to T{dd.t_pad}; gathered batches against the feeder\'s: worst {worst:.2e} of an '
        f'array\'s largest value (tolerance {STORE_TOL:g}), loss lengths equal: {lens}')
    if not (worst <= STORE_TOL and lens):
        raise AssertionError('the resident corpus gathered other batches than the feeder')

    real = {'train_step': ta.train_step, 'train_step_hoisted': ta.train_step_hoisted}
    marks = []

    def timed(name):
        def step(*args):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return real[name](*args)
        return step

    argv = ['--data_dir', data_dir, '--log_path', '', '--log_interval', str(DD_STEPS),
            '--summary_interval', '100000', '--checkpoint_interval', '100000',
            '--max_steps', str(DD_STEPS), '--device', device.type]
    ms = {}
    for name in real:
        setattr(ta, name, timed(name))
    try:
        for i, extra in enumerate(([], ['--device_data'])):
            marks.clear()
            argv[3] = f'{base}/run{i}'
            with contextlib.redirect_stdout(io.StringIO()):
                ta.main(argv + extra)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            gaps = 1e3 * np.diff(marks)[2:]
            ms.setdefault('device_data' if extra else 'streaming', []).append(
                float(np.median(gaps)))
    finally:
        for name, fn in real.items():
            setattr(ta, name, fn)
    log(f'  acoustic step with its data path, ms (median of steps 3-{DD_STEPS}, host clock '
        f'from one step\'s start to the next\'s; the streaming run first): streaming '
        f'{ms["streaming"][0]:.1f}, --device_data {ms["device_data"][0]:.1f}')
    return ms


def host_side(fd, synth, device):
    """Phase 10; returns the launches of the imported checkpoint's request."""
    import tempfile
    from transtacos_retunegan_tpu_torch.tools import serving_latency

    def part(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f'  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)')
        return out

    with tempfile.TemporaryDirectory() as tmp:
        part(native_loader, f'{tmp}/tones')
        launches, run = part(imported_serving, fd, device, tmp)
        part(infer_vocoder_cli, run, f'{tmp}/tones', f'{tmp}/infer', device)
        part(acoustic_data_paths, device, f'{tmp}/acoustic')
    t0 = time.perf_counter()
    res = serving_latency.measure(synth, LATENCY_S, LATENCY_WARM, LATENCY_CONC)
    st = res['steady_state']
    if res['errors'] or not st:
        raise AssertionError(f'serving_latency failed: {res["errors"] or "no request"}')
    kinds = [o['kind'] for o in res.get('outliers_gt_3x_p50', [])]
    log(f'  serving_latency: {LATENCY_CONC} workers vocoding 400-frame specs for '
        f'{LATENCY_S:g} s through BatchingFrontend (max_batch 8, window 6 ms), '
        f'{res["config"]["infer_dtype"]}: steady state (after {LATENCY_WARM:g} s) '
        f'n={st["n"]}, p50 {st["p50_ms"]:.3f} / p95 {st["p95_ms"]:.3f} / p99 '
        f'{st["p99_ms"]:.3f} / max {st["max_ms"]:.3f} ms, {res["qps_steady"]:.2f} requests '
        f'per s; slow requests (> 3 p50): {len(kinds)} '
        f'({kinds.count("global_stall")} global stalls); '
        f'{time.perf_counter() - t0:.1f} s')
    return launches


# ---------------------------------------------------------------------------
# phase 11: tensor parallelism
# ---------------------------------------------------------------------------
# Two gloo ranks on one card with --model_parallel 2 (one data shard: both
# ranks compute phase 9's whole global batch, each on its half of every
# sharded leaf) against this process's step, at phase 9's tolerances.
TP_K = 2
TP_TIMED, TP_WARM = 3, 1


def tp_rank_steps(device, k: int, run_dir=None):
    """This process under ``make_mesh(None, k)`` (one process outside a
    group): ``acoustic_first_step`` on phase 9's global batch and prenet
    masks in float64 and in float32, the state sharded over the model
    axis; the elements this rank holds of the parameters and of their Adam
    moments; TP_TIMED more float32 steps (CUDA events) and, under
    ``run_dir``, the gathered checkpoint of that state; one GAN step from
    SEED under deterministic algorithms and a hash of its parameters."""
    import hashlib
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.parallel import (current_shard, make_mesh,
                                                        process_shard, shard_params_tp)
    from transtacos_retunegan_tpu_torch.train import acoustic_step as A
    from transtacos_retunegan_tpu_torch.train import vocoder_step as V
    from transtacos_retunegan_tpu_torch.train.checkpoint import save_acoustic
    from transtacos_retunegan_tpu_torch.train.train_acoustic import make_draws
    from transtacos_retunegan_tpu_torch.utils.determinism import deterministic
    cfg = Config()
    acoustic, keep, gan = dp_batches(cfg)
    mesh = make_mesh(None, k)
    out = {}
    for dtype, name in ((torch.float64, 'acoustic64'), (torch.float32, 'acoustic')):
        state, out[name] = acoustic_first_step(
            cfg, device, dtype, acoustic, keep,
            lambda st: shard_params_tp(mesh, st.model, st.opt))
    out['held'] = sum(p.numel() for p in state.model.parameters())
    out['moments'] = sum(v.numel() for st in state.opt.state.values()
                         for n, v in st.items() if n.startswith('exp_avg'))
    batch = local_batch(acoustic, process_shard(cfg.acoustic.batch_size), device)
    draws = make_draws(SEED, device)
    out['acoustic_ms'] = times(lambda: A.train_step_hoisted(cfg, state, batch, draws),
                               TP_TIMED, TP_WARM)
    if run_dir is not None:
        save_acoustic(run_dir, state)
    with deterministic():
        gst = V.init_gan_state(cfg, SEED, device, current_shard())
        gsl = process_shard(cfg.vocoder.batch_size)
        gbatch = {n: v.to(device) for n, v in gan.items()}
        noise = drawn_noise(cfg, gst.generator, gbatch, SEED)
        _, m = V.gan_train_step(cfg, gst, {n: v[gsl] for n, v in gbatch.items()},
                                [n[gsl].to(device) for n in noise], 4)
        h = hashlib.sha1()
        for module in (gst.generator, gst.discriminators):
            for p in module.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
    out['gan'] = (h.hexdigest(), {n: float(v) for n, v in m.items()})
    return out


def tensor_parallel(fd, card: str, device):
    """Phase 11; returns the launches of the TP checkpoint's request."""
    import tempfile
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
    from transtacos_retunegan_tpu_torch.parallel import tp_param_specs
    t0 = time.perf_counter()
    ref = tp_rank_steps(device, 1)
    ref_s = time.perf_counter() - t0
    with torch.device('meta'):
        model = Tacotron(Config())
    total = sum(p.numel() for p in model.parameters())
    split = sum(model.get_parameter(n).numel() for n in tp_param_specs(model, TP_K))
    want = total - split + split // TP_K
    with tempfile.TemporaryDirectory() as tmp:
        ranks, wall = spawn_gloo_ranks(tmp, device, tp_rank_steps, TP_K,
                                       os.path.join(tmp, 'run'))
        launches = served_from_checkpoint(fd, os.path.join(tmp, 'run'), device)
    ok = True
    for name, tol in (('acoustic', DP_ACOUSTIC_TOL), ('acoustic64', DP_F64_TOL)):
        for r, got in enumerate(ranks):
            wl, wg, within_tol = dp_errors(got[name], ref[name], tol)
            ok = ok and within_tol
            log(f'  --model_parallel {TP_K}, rank {r} of 2 on one card, {name} step against one '
                f'process: worst loss {wl[0]} {wl[1]:.2e} relative, worst gradient leaf '
                f'{wg[0]} {wg[1]:.2e} of its norm (tol {tol:.0e})')
    held = [(got['held'], got['moments']) for got in ranks]
    log(f'  elements held per rank (parameters, Adam moments): {held}; one process: '
        f'({ref["held"]}, {ref["moments"]}); expected {want:,} parameters per rank '
        f'({total:,} less half of the {split:,} in the {len(tp_param_specs(model, TP_K))} '
        f'sharded leaves; biases replicate)')
    ok = ok and all(h == (want, 2 * want) for h in held) and ref['held'] == total
    for r, got in enumerate(ranks):
        log(f'  rank {r} hoisted step ms (CUDA events, {TP_TIMED} after {TP_WARM}; no claim: '
            f'two ranks share the card and gloo copies every collective through the host): '
            f'{quartiles(got["acoustic_ms"])}; one process: {quartiles(ref["acoustic_ms"])} '
            f'[{card}]')
    gan_same = all(got['gan'] == ref['gan'] for got in ranks)
    log(f'  GAN step with --model_parallel {TP_K} (every parameter replicated), deterministic '
        f'algorithms: both ranks bit for bit as one process: {gan_same}')
    log(f'  one-process reference {ref_s:.1f} s, the two ranks {wall:.1f} s with their start')
    if not (ok and gan_same):
        raise AssertionError('the tensor-parallel steps disagree with one process')
    return launches


# ---------------------------------------------------------------------------
# phase 12: run dirs on the card (the server's --acoustic_dir/--vocoder_dir;
# a run carried over in the JAX package's layout)
# ---------------------------------------------------------------------------

RESUMED_STEPS = 2
RESUME_TOL = 1e-6          # the converted run's first resumed losses, relative


def app_request(fd, argv, text: str, device):
    """``serve.app``'s ``start()`` with ``argv`` on ``device`` (the webui
    role on an ephemeral port, one request at a time), then one ``GET
    /synth`` with the launch counters at 0 just before it.  Returns the
    WAV's samples, the launches and the request's ms."""
    from scipy.io import wavfile
    from transtacos_retunegan_tpu_torch.serve import app
    (server,) = app.start(app.parse_args(
        ['--device', str(device), '--mode', 'webui', '--port', '0', '--host', '127.0.0.1',
         '--batch_window_ms', '0', *argv]))
    try:
        url = (f'http://127.0.0.1:{server.server_address[1]}/synth?text='
               + urllib.request.quote(text))
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=600) as r:
            body, ctype = r.read(), r.headers['Content-Type']
        ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(fd.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
    _, wav = wavfile.read(io.BytesIO(body))
    if ctype != 'audio/wav' or body[:4] != b'RIFF' or wav.dtype != np.float32:
        raise AssertionError(f'GET /synth did not return a float32 WAV ({ctype})')
    return wav, launches, ms


def port_runs_served(fd, acoustic_run: str, vocoder_run: str, device):
    """Phase 12 (i): phase 8's acoustic run and phase 7's vocoder run served
    by the app through ``--acoustic_dir``/``--vocoder_dir``, bit for bit
    as the same checkpoints loaded by hand (the app's warm-up request
    first on both sides: it draws the first Griffin-Lim phase)."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.serve.app import WARM_TEXT
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    text = REQUESTS[1]
    wav, launches, ms = app_request(fd, ['--config', acoustic_run, '--acoustic_dir',
                                         acoustic_run, '--vocoder_dir', vocoder_run],
                                    text, device)
    ref = Synthesizer(Config.load(acoustic_run),
                      acoustic_params=ckpt.load_acoustic_params(acoustic_run),
                      gen_params=ckpt.load_generator_params(vocoder_run), devices=[device])
    ref.tts(WARM_TEXT)
    want = ref.tts(text)
    same = wav.shape == want.shape and np.array_equal(wav, want)
    newest = [os.path.basename(ckpt.scan_checkpoint(d, p))
              for d, p in ((acoustic_run, 'ckpt_'), (vocoder_run, 'g_'))]
    log(f'  (i) serve.app --acoustic_dir (newest {newest[0]}) --vocoder_dir (newest '
        f'{newest[1]}): GET '
        f'/synth?text={text!r} {ms:.1f} ms, {len(wav)} samples, launches {launches}; bit for '
        f'bit as Synthesizer(acoustic_params=load_acoustic_params(..), '
        f'gen_params=load_generator_params(..)): {same}')
    if launches['decode_full'] != 1 or not same or not np.isfinite(wav).all():
        raise AssertionError('the run dirs did not serve through the app as loaded by hand')
    return launches


def jax_layout_export(run_dir: str, out_dir: str) -> dict:
    """The newest ``ckpt_`` of a port acoustic run written as
    ``export_jax_run.py`` writes a JAX run (``weights.to_flax`` of the
    parameters, the batch statistics and Adam's moments; ``meta.json`` with
    the step and optax's counts), without JAX."""
    import shutil
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.weights import save_npz, to_flax
    ck = torch.load(ckpt.scan_checkpoint(run_dir, 'ckpt_'), map_location='cpu')
    with torch.device('meta'):
        model = Tacotron(Config.load(run_dir))
    names = [n for n, _ in model.named_parameters()]
    os.makedirs(out_dir, exist_ok=True)
    params, stats = to_flax(model, {**ck['params'], **ck['extra_vars']})
    save_npz(f'{out_dir}/params.npz', params)
    if stats:
        save_npz(f'{out_dir}/batch_stats.npz', stats)
    state = ck['opt_state']['state']
    for moment, key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        save_npz(f'{out_dir}/adam_{moment}.npz',
                 to_flax(model, {n: state[i][key] for i, n in enumerate(names)})[0])
    counts = {float(v['step']) for v in state.values()}
    if len(counts) != 1:
        raise AssertionError(f'Adam steps differ over the parameters: {counts}')
    meta = {'kind': 'acoustic', 'step': int(ck['step']), 'adam_count': int(counts.pop()),
            'lr_count': int(ck['step'])}
    with open(f'{out_dir}/meta.json', 'w') as f:
        json.dump(meta, f)
    shutil.copyfile(f'{run_dir}/config.json', f'{out_dir}/config.json')
    return meta


def resumed_steps(data_dir: str, run_dir: str):
    """``train_acoustic`` resumed from ``run_dir`` on the card for
    RESUMED_STEPS steps; the first step's losses (floats)."""
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    from transtacos_retunegan_tpu_torch.train import train_acoustic as ta
    real = {'train_step': ta.train_step, 'train_step_hoisted': ta.train_step_hoisted}
    first = []

    def recording(name):
        def step(cfg, state, batch, draws):
            state, losses = real[name](cfg, state, batch, draws)
            if not first:
                first.append((name, {k: float(v) for k, v in losses.items()}))
            return state, losses
        return step

    start = int(torch.load(ckpt.scan_checkpoint(run_dir, 'ckpt_'), map_location='cpu')['step'])
    for name in real:
        setattr(ta, name, recording(name))
    try:
        ta.main(['--data_dir', data_dir, '--log_path', run_dir, '--log_interval', '1',
                 '--summary_interval', '1000', '--checkpoint_interval', '1000',
                 '--max_steps', str(start + RESUMED_STEPS)])
    finally:
        for name, fn in real.items():
            setattr(ta, name, fn)
    with open(f'{run_dir}/train.log') as fh:
        if f'resumed from step {start}' not in fh.read():
            raise AssertionError(f'{run_dir} did not resume from step {start}')
    return start, first[0]


def converted_run(fd, data_dir: str, acoustic_run: str, base: str, device):
    """Phase 12 (ii): phase 8's run exported in the JAX layout
    (``jax_layout_export``), imported (``tools/import_jax_run.py``),
    resumed by ``train_acoustic`` beside a copy of the unconverted run
    (the first resumed step's losses within RESUME_TOL), then served by
    the app through ``--acoustic_dir``."""
    import shutil
    from transtacos_retunegan_tpu_torch.tools.import_jax_run import import_run
    from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
    t0 = time.perf_counter()
    meta = jax_layout_export(acoustic_run, f'{base}/exported')
    written = import_run(f'{base}/exported', f'{base}/converted')
    convert_s = time.perf_counter() - t0
    original = torch.load(ckpt.scan_checkpoint(acoustic_run, 'ckpt_'), map_location='cpu')
    back = torch.load(written, map_location='cpu')
    same_ckpt = (back['step'] == original['step']
                 and all(torch.equal(v, original['params'][k])
                         for k, v in back['params'].items())
                 and all(torch.equal(back['opt_state']['state'][i][f],
                                     original['opt_state']['state'][i][f])
                         for i in original['opt_state']['state']
                         for f in ('step', 'exp_avg', 'exp_avg_sq')))
    os.makedirs(f'{base}/unconverted')
    for f in (ckpt.scan_checkpoint(acoustic_run, 'ckpt_'), f'{acoustic_run}/config.json'):
        shutil.copy(f, f'{base}/unconverted')
    t0 = time.perf_counter()
    start, (kind_a, ref) = resumed_steps(data_dir, f'{base}/unconverted')
    _, (kind_b, got) = resumed_steps(data_dir, f'{base}/converted')
    resume_s = time.perf_counter() - t0
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()}
    worst = max(rel, key=rel.get)
    log(f'  (ii) phase 8\'s run exported in the JAX layout (to_flax, moments included: '
        f'{meta}) and imported in {convert_s:.1f} s: the checkpoint equals the original bit '
        f'for bit: {same_ckpt}; train_acoustic resumed both from step {start} for '
        f'{RESUMED_STEPS} steps ({kind_a}/{kind_b}, {resume_s:.1f} s): first step losses '
        f'worst {worst} {rel[worst]:.2e} relative (tol {RESUME_TOL:.0e}), loss '
        f'{got["loss"]:.6f} against {ref["loss"]:.6f}')
    wav, launches, ms = app_request(fd, ['--config', f'{base}/converted', '--acoustic_dir',
                                         f'{base}/converted'], REQUESTS[0], device)
    log(f'  (ii) serve.app --acoustic_dir on the converted run (newest '
        f'{os.path.basename(ckpt.scan_checkpoint(f"{base}/converted", "ckpt_"))}): GET /synth '
        f'{ms:.1f} ms, {len(wav)} samples, launches {launches}')
    if not (same_ckpt and rel[worst] <= RESUME_TOL and kind_a == kind_b
            and launches['decode_full'] == 1 and len(wav) and np.isfinite(wav).all()):
        raise AssertionError('the converted run did not resume or serve as the original')
    return launches


def run_dirs(fd, runs: dict, base: str, device):
    """Phase 12; returns the launches of its two served requests."""
    a = port_runs_served(fd, runs['acoustic'], runs['vocoder'], device)
    b = converted_run(fd, runs['data'], runs['acoustic'], base, device)
    return {k: a[k] + b[k] for k in a}


# ---------------------------------------------------------------------------
# phase 13: the training-quality study tools on the card
# ---------------------------------------------------------------------------
# convergence_session at the default Config with short legs on a corpus of
# STUDY_UTTS utterances (5% held out: STUDY_TEXTS texts evaluated); then
# decay_session on the same corpus at B=16 with the decay compressed to
# steps 20-40 in two segments, each evaluated at its end (the trainer logs
# every 20 steps, so each segment logs its own last step).  sanity_train
# runs at its defaults.
STUDY_UTTS, STUDY_TEXTS = 100, 4
STUDY_CONVERGENCE = ('--acoustic_steps', '20', '--gan_steps', '10', '--n_utts',
                     str(STUDY_UTTS), '--max_texts', str(STUDY_TEXTS))
STUDY_EVALS = (20, 40)
STUDY_DECAY = ('--batch_size', '16', '--tf_start_decay', '20', '--tf_decay', '20',
               '--eval_steps', ','.join(map(str, STUDY_EVALS)), '--checkpoint_interval', '20',
               '--max_texts', str(STUDY_TEXTS), '--n_utts', str(STUDY_UTTS))
SIM_TOL = 1e-5             # embedding similarities: symmetric, unit diagonal


# Phase 13's tools run on threads side by side (their trainers are
# processes); each evaluation that launches a kernel holds EVALUATING from
# setting the launch counters to 0 to reading them, so that one tool's
# launches are never counted in another's.
EVALUATING = threading.Lock()


@contextlib.contextmanager
def counted(fd, module, name: str, calls: list):
    """``module.name`` replaced, while the block runs, by a wrapper that sets
    the launch counters to 0 just before each call and appends them, read
    just after it, to ``calls`` (holding EVALUATING)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        with EVALUATING:
            for k in fd.LAUNCHES:
                fd.LAUNCHES[k] = 0
            out = real(*args, **kwargs)
            calls.append(dict(fd.LAUNCHES))
        return out
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def timed(spent: list, *targets):
    """Each ``(module, name)`` of ``targets`` replaced, while the block runs,
    by a wrapper that appends ``(name, seconds)`` of each call to ``spent``
    (a trainer's run under ``run_cli`` with the trainer's name)."""
    saved = []
    for module, name in targets:
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                what = (f'{_name} {args[0].rsplit(".", 1)[-1]}' if _name == 'run_cli'
                        else _name)
                spent.append((what, round(time.perf_counter() - t0, 1)))
        saved.append((module, name, real))
        setattr(module, name, wrapper)
    try:
        yield spent
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def all_finite(tree) -> bool:
    """Every number in a nested dict/list of a tool's results is finite."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    if isinstance(tree, (bool, str)) or tree is None:
        return True
    return bool(np.isfinite(tree))


def sanity_on_card(fd, device, base: str):
    """(4) ``sanity_train`` at its defaults; its four checks raise when they
    fail.  Returns the launches of its synthesis."""
    from transtacos_retunegan_tpu_torch.tools import sanity_train as st
    calls, spent = [], []
    with counted(fd, st, 'synthesis_check', calls), timed(
            spent, (st, 'build_corpus'), (st, 'gan_leg'), (st, 'acoustic_leg'),
            (st, 'synthesis_check')):
        res = st.main(['--device', device.type, '--workdir', f'{base}/sanity'])
    lo, hi = st.PEAK_HZ
    margins = {'loss drop': (res['loss_drop'], st.LOSS_DROP),
               'mstft drop': (res['mstft_drop'], st.MSTFT_DROP),
               'separation': (res['separation'], st.SEPARATION)}
    log('  (4) sanity_train (300 acoustic / 150 GAN steps asked, tiny widths): ' + '; '.join(
        f'{k} {v:.4f} > {t} (margin {v - t:+.4f})' for k, (v, t) in margins.items())
        + f'; dominant frequency {res["peak_hz"]:.1f} Hz in ({lo:.0f}, {hi:.0f}) (margin '
        f'{min(res["peak_hz"] - lo, hi - res["peak_hz"]):.1f} Hz); loss {res["loss_first"]:.4f}'
        f' -> {res["loss_last"]:.4f}, mstft {res["mstft_early"]:.4f} -> '
        f'{res["mstft_late"]:.4f} over {res["gan_steps_run"]} GAN steps; its synthesis '
        f'launches {calls}; s: {spent}')
    if calls != [{'decode_step': 0, 'decode_full': 1}]:
        raise AssertionError(f'sanity_train\'s synthesis launched {calls}, not one decode_full')
    return calls[0]


def convergence_on_card(fd, device, base: str, corpus_ready: threading.Event):
    """(1) ``convergence_session`` at the default ``Config()`` with short
    legs, setting ``corpus_ready`` once its corpus is built (or it failed
    before); returns its run dirs and data and the launches of
    ``eval_synthesis``."""
    from transtacos_retunegan_tpu_torch.tools import convergence_session as cs
    out_dir = f'{base}/legs/gan_RefineGAN_small'
    calls, spent = [], []
    build = cs.build_corpus

    def build_corpus(*args, **kwargs):
        try:
            return build(*args, **kwargs)
        finally:
            corpus_ready.set()
    cs.build_corpus = build_corpus
    try:
        with counted(fd, cs, 'eval_synthesis', calls), timed(
                spent, (cs, 'build_corpus'), (cs, 'run_cli'), (cs, 'eval_teacher_forced'),
                (cs, 'eval_synthesis'), (cs, 'eval_vocoder_vs_gl')):
            ev = cs.main([*STUDY_CONVERGENCE, '--workdir', f'{base}/conv', '--out_dir',
                          out_dir, '--device', device.type])
    finally:
        cs.build_corpus = build
        corpus_ready.set()
    data = f'{base}/conv/processed'
    n_texts = min(STUDY_TEXTS, len(cs.held_out_texts(data)))
    files = ('README.md', 'acoustic_loss.csv', 'gan_loss.csv', 'quality_eval.json')
    written = all(os.path.getsize(os.path.join(out_dir, f)) > 0 for f in files)
    tf, sy, vg = ev['teacher_forced'], ev['synthesis'], ev['vocoder_vs_gl']
    log(f'  (1) convergence_session {" ".join(STUDY_CONVERGENCE)}: held out '
        f'{tf["n_test_items"]} items, teacher-forced mel L1 {tf["held_out_mel_l1"]:.4f} '
        f'(per item {tf["held_out_mel_l1_item"]:.4f}), stop CE {tf["held_out_stop_ce"]:.4f}; '
        f'{len(sy["per_utt"])} texts synthesized: diagonality {sy["mean_diagonality"]:.4f}, '
        f'focus {sy["mean_focus"]:.4f}, coverage {sy["mean_coverage"]:.4f}, mass coverage '
        f'{sy["mean_mass_coverage"]:.4f}, frames {[r["n_frames"] for r in sy["per_utt"]]}; '
        f'vocoder vs its Griffin-Lim template ({vg["n_items"]} items): GAN {vg["gan"]}, GL '
        f'{vg["gl"]}, GAN beats GL {vg["gan_beats_gl"]}; report and CSVs written: {written}; '
        f'eval_synthesis launches {calls}; s: {spent}')
    want = [{'decode_step': 0, 'decode_full': n_texts + 1}]
    if not (all_finite(ev) and written and len(sy['per_utt']) == n_texts and calls == want):
        raise AssertionError(f'convergence_session: not every number finite, a file missing '
                             f'or launches {calls} (expected {want})')
    return {'ac_run': f'{base}/conv/ac_run', 'vo_run': f'{base}/conv/vo_run', 'data': data,
            'cfg': f'{base}/conv/cfg', 'legs': f'{base}/legs'}, calls[0]


def decay_on_card(fd, device, base: str, data: str):
    """(2) ``decay_session`` on (1)'s corpus: the segments resume from
    each other, the hoisted step runs before ``tf_start_decay`` and the
    scanned one after, the table's ratios are both schedules'; returns the
    launches of its three evaluations."""
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.tools import decay_session as ds
    from transtacos_retunegan_tpu_torch.tools.convergence_session import held_out_texts
    from transtacos_retunegan_tpu_torch.train.acoustic_step import hoist_force_eligible
    from transtacos_retunegan_tpu_torch.train.schedules import teacher_forcing_ratio
    work, out_dir = f'{base}/decay', f'{base}/decay_out'
    os.makedirs(work)
    os.symlink(data, f'{work}/processed')
    calls, spent = [], []
    with counted(fd, ds, 'eval_synthesis_alignment', calls), timed(
            spent, (ds, 'run_cli'), (ds, 'eval_teacher_forced'),
            (ds, 'eval_synthesis_alignment')):
        table = ds.main([*STUDY_DECAY, '--workdir', work, '--out_dir', out_dir,
                         '--device', device.type])
    cfg = Config.load(f'{work}/cfg')
    hp = cfg.acoustic
    with open(f'{out_dir}/acoustic_loss.csv') as f:
        rows = [line.split(',') for line in f.read().split()[1:]]
    steps = [int(r[0]) for r in rows]
    with open(f'{work}/ac_run/train.log') as f:
        resumed = [int(x) for x in re.findall(r'resumed from step (\d+)', f.read())]
    kinds, prev = [], 0
    for target in STUDY_EVALS:
        kinds.append(sorted({'hoisted' if hoist_force_eligible(cfg, k) else 'scanned'
                             for k in range(prev, target)}))
        prev = target
    ratios = [(r['step'], r['tf_ratio'], ds.tf_ratio_at(r['step'], hp),
               teacher_forcing_ratio(r['step'], hp)) for r in table['rows']]
    ratios_ok = all(abs(a - b) <= 1e-6 and abs(a - c) <= 1e-6 for _, a, b, c in ratios)
    n_texts = min(STUDY_TEXTS, len(held_out_texts(data)))
    log(f'  (2) decay_session {" ".join(STUDY_DECAY)}: logged steps {steps} at '
        f'{[float(r[1]) for r in rows]} s/step, tfr {[float(r[5]) for r in rows]}, loss '
        f'{[float(r[2]) for r in rows]}; segments resumed from steps {resumed}; the steps '
        f'of each segment ran {kinds} (hoist_force_eligible, tf_start_decay '
        f'{hp.tf_start_decay}); table ratios (step, row, tf_ratio_at, teacher_forcing_ratio) '
        f'{ratios}; coverage {[r["coverage"] for r in table["rows"]]}, diagonality '
        f'{[r["diagonality"] for r in table["rows"]]}, mel L1 (item) '
        f'{[r["held_out_mel_l1_item"] for r in table["rows"]]}; evaluation launches {calls}; '
        f's: {spent}')
    want = [{'decode_step': 0, 'decode_full': n_texts}] * len(STUDY_EVALS)
    if not (steps == list(STUDY_EVALS) and len(table['rows']) == len(STUDY_EVALS)
            and resumed == list(STUDY_EVALS[:-1])
            and kinds == [['hoisted']] + [['scanned']] * (len(STUDY_EVALS) - 1)
            and ratios_ok and all_finite(table['rows']) and calls == want):
        raise AssertionError('decay_session did not resume, switch steps, or evaluate as '
                             f'expected (launches {calls}, expected {want})')
    return {k: sum(c[k] for c in calls) for k in fd.LAUNCHES}


def tools_on_runs(fd, device, base: str, runs: dict):
    """(3) The other tools on (1)'s runs; returns the launches of
    ``coverage_diagnosis``."""
    from transtacos_retunegan_tpu_torch.config import AudioConfig
    from transtacos_retunegan_tpu_torch.tools import (bf16_ab, coverage_diagnosis,
                                                      draw_embd_sim, dsp_studies,
                                                      variant_ranking)
    times = {}
    t0 = time.perf_counter()
    with EVALUATING:
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        cov = coverage_diagnosis.main(['--data_dir', runs['data'], '--acoustic_dir',
                                       runs['ac_run'], '--config', runs['cfg'], '--out',
                                       f'{base}/coverage.json', '--max_texts',
                                       str(STUDY_TEXTS), '--device', device.type])
        launches = dict(fd.LAUNCHES)
    times['coverage_diagnosis'] = time.perf_counter() - t0
    log(f'  (3) coverage_diagnosis: mean coverage {cov["mean_coverage"]}, winnable '
        f'{cov["mean_coverage_winnable"]}, structural {cov["total_structural"]}, genuine skips '
        f'{cov["total_genuine_skip"]}; launches {launches}')
    if launches != {'decode_step': 0, 'decode_full': len(cov['per_utt'])} or not cov['per_utt']:
        raise AssertionError(f'coverage_diagnosis launched {launches}')

    t0 = time.perf_counter()
    sims = draw_embd_sim.main(['--run_dir', runs['ac_run'], '--out_dir', f'{base}/embd',
                               '--device', device.type])
    times['draw_embd_sim'] = time.perf_counter() - t0
    errs = {k: (float(np.abs(s - s.T).max()), float(np.abs(np.diag(s) - 1).max()))
            for k, s in sims.items()}
    log(f'  (3) draw_embd_sim: {({k: s.shape for k, s in sims.items()})}, largest asymmetry '
        f'and diagonal error {errs} (tol {SIM_TOL:.0e})')
    if not sims or any(max(e) > SIM_TOL for e in errs.values()):
        raise AssertionError('draw_embd_sim: a similarity matrix is not symmetric with a '
                             'unit diagonal')

    t0 = time.perf_counter()
    ab = bf16_ab.main(['--data_dir', runs['data'], '--vocoder_dir', runs['vo_run'], '--config',
                       runs['cfg'], '--out', f'{base}/bf16_ab.json', '--max_items',
                       str(STUDY_TEXTS), '--device', device.type])
    times['bf16_ab'] = time.perf_counter() - t0
    log(f'  (3) bf16_ab ({ab["n_items"]} items, {ab["device"]}): float32 '
        f'{ab["per_dtype"]["float32"]}, bfloat16 {ab["per_dtype"]["bfloat16"]}; largest '
        f'waveform deviation {ab["max_abs_waveform_deviation"]} (printed, not held)')
    if not all_finite(ab['per_dtype']):
        raise AssertionError('bf16_ab: a metric is not finite')

    t0 = time.perf_counter()
    rows = variant_ranking.main(['--base', runs['legs'], '--legs', 'RefineGAN_small',
                                 '--out', f'{base}/RANKING.md', '--device', device.type])
    times['variant_ranking'] = time.perf_counter() - t0
    leg = [r for r in rows if r['variant'] == 'RefineGAN_small']
    log(f'  (3) variant_ranking over (1)\'s GAN leg: {rows}')
    if not (leg and 'heldout_mstft' in leg[0]):
        raise AssertionError('variant_ranking did not read (1)\'s GAN leg')

    t0 = time.perf_counter()
    au = AudioConfig()
    studies = dsp_studies.run_all(au, dsp_studies._test_signal(au))
    times['dsp_studies'] = time.perf_counter() - t0
    log(f'  (3) dsp_studies.run_all (host numpy): {json.dumps(studies)}')
    if not all_finite(studies):
        raise AssertionError('dsp_studies: a number is not finite')
    return launches, times


def study_tools(fd, device, base: str):
    """Phase 13; returns the ``decode_full`` launches of every evaluated
    text (the trainers launch no kernel).  ``sanity_train`` and, once
    (1)'s corpus is built, ``decay_session`` run on threads of their own
    beside ``convergence_session``; the tools on (1)'s runs follow it."""
    t0 = time.perf_counter()
    times = {}
    total = dict.fromkeys(fd.LAUNCHES, 0)
    corpus_ready = threading.Event()
    results = {}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    def run(name, fn, *args):
        try:
            results[name] = fn(*args)
        except BaseException as e:     # handed to the main thread below
            results[name] = e
        finally:
            times[name] = time.perf_counter() - t0

    def decay():
        corpus_ready.wait()
        return decay_on_card(fd, device, base, f'{base}/conv/processed')
    workers = [threading.Thread(target=run, args=('sanity_train', sanity_on_card, fd, device,
                                                  base)),
               threading.Thread(target=run, args=('decay_session', decay))]
    for w in workers:
        w.start()
    try:
        runs, launches = convergence_on_card(fd, device, base, corpus_ready)
        add(launches)
        times['convergence_session'] = time.perf_counter() - t0
        launches, tool_times = tools_on_runs(fd, device, base, runs)
        add(launches)
        times.update(tool_times)
    finally:
        corpus_ready.set()
        for w in workers:
            w.join()
        log(f'  phase 13 tools\' s (the sessions and sanity_train from the phase\'s start, '
            f'side by side): {({k: round(v, 1) for k, v in times.items()})}')
    for name in ('decay_session', 'sanity_train'):
        if isinstance(results[name], BaseException):
            raise results[name]
        add(results[name])
    log(f'  phase 13 launches {total}')
    return total


# ---------------------------------------------------------------------------
# phase 14: the timing and equivalence tools on the card
# ---------------------------------------------------------------------------
# Each tool at the default Config() (widths and geometries its own), run in
# this process through its main(), with its repetitions cut (TOOL_RUNS);
# the launch counters set to 0 just before each tool and read just after.
# pallas_equivalence decodes 40 steps with decode_step and three times with
# decode_full; profile_stages's acoustic stage decodes 80 steps with
# decode_step in each of its 1 + warmup + reps calls; no other tool
# launches a kernel.
EQUIVALENCE_STEPS = 40
PROFILE_STEPS, PROFILE_WARMUP, PROFILE_REPS = 80, 0, 1
CUT = ['--warm', '0', '--steps', '1', '--trials', '1']
TOOL_RUNS = (
    ('pallas_equivalence', ['--steps', str(EQUIVALENCE_STEPS)]),
    ('acoustic_step_ab', CUT),
    ('profile_stages', ['--reps', str(PROFILE_REPS), '--warmup', str(PROFILE_WARMUP)]),
    ('acoustic_step_trace', CUT),
    ('train_scaling', ['--batches', '16,32', '--stages'] + CUT),
    ('bench_precision', ['--steps', '1', '--trials', '1']),
)
TOOL_LAUNCHES = {'decode_step': EQUIVALENCE_STEPS
                 + PROFILE_STEPS * (1 + PROFILE_WARMUP + PROFILE_REPS),
                 'decode_full': 3}


def timing_tools(fd, card: str, base: str, device):
    """Phase 14; returns the launches of its six tools.  pallas_equivalence
    exits non-zero when a float32 path leaves its tolerance; the launches
    must be the predicted ones."""
    import importlib
    os.makedirs(base, exist_ok=True)
    total = dict.fromkeys(fd.LAUNCHES, 0)
    spent = {}
    for name, argv in TOOL_RUNS:
        tool = importlib.import_module(f'transtacos_retunegan_tpu_torch.tools.{name}')
        if tool.parser().get_default('out') is not None:
            argv = argv + ['--out', f'{base}/{name}.json']
        for k in fd.LAUNCHES:
            fd.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        try:
            result = tool.main(argv + ['--device', str(device)])
        except SystemExit as e:
            raise AssertionError(f'{name} exited: {e}') from e
        spent[name] = round(time.perf_counter() - t0, 1)
        launches = dict(fd.LAUNCHES)
        for k in total:
            total[k] += launches[k]
        if not all_finite({k: v for k, v in result.items() if k != 'device'}):
            raise AssertionError(f'{name}: a number is not finite: {result}')
        log(f'  {name} ({spent[name]} s, launches {launches}): {json.dumps(result)}')
    log(f'  phase 14 tools\' s: {spent} [{card}]')
    log(f'  phase 14 launches {total}, predicted {TOOL_LAUNCHES}')
    if total != TOOL_LAUNCHES:
        raise AssertionError(f'phase 14 launched {total}, predicted {TOOL_LAUNCHES}')
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as work:
        return phases(work)


def phases(work: str) -> int:
    """Every phase and the record; phases 7 and 8 keep their runs in
    ``work`` for phase 12."""
    from transtacos_retunegan_tpu_torch.ops import build
    from transtacos_retunegan_tpu_torch.ops import fused_decoder as fd
    from transtacos_retunegan_tpu_torch.ops import lsa_kernel as lk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    t_start = time.perf_counter()

    log('== phase 1: card and build')
    card = card_line()
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    for name, report in build.build_all(build.sources()).items():
        log(f'-- nvcc {name}.cu')
        log(report.strip())
    log(f'  built in {time.perf_counter() - t0:.1f} s')

    log('== phase 2: kernels against their plain versions, full width')
    grid_check(fd, device)
    worst = compare_kernels(fd, device)
    batch_invariance(fd, device)
    worst['lsa_step'] = compare_lsa(lk, device)

    log('== phase 3: timing (CUDA events)')
    times = time_kernels(fd, device)
    times['lsa_step'] = time_lsa(lk, device)

    log('== phase 4: main path, one request at a time (Synthesizer on the card)')
    lk.LAUNCHES['lsa_step'] = 0
    synth, plan, launches = main_path(fd, device)
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f'a kernel of the path was not launched: {launches}')
    launches['lsa_step'] = lk.LAUNCHES['lsa_step']

    log('== phase 5: batched path (tts_batch and the batching server, max_batch 8)')
    batched = batched_path(fd, lk, synth)
    launches = {k: launches[k] + batched[k] for k in launches}
    log(f'  LAUNCHES over both paths: {launches} (lsa_step: no path of the system calls it)')

    log('== phase 6: per-stage time, latency, threads, small config against the CPU')
    stage_times(synth, plan, REQUESTS[-1])
    request_latency(synth, plan)
    thread_cost(synth, plan, REQUESTS[1])
    slice_against_cpu(device)

    log('== phase 7: vocoder training on the card (train_vocoder, default Config)')
    t0 = time.perf_counter()
    vocoder_training(device, f'{work}/vocoder')
    log(f'  phase 7 took {time.perf_counter() - t0:.1f} s; it launches none of the kernels')

    log('== phase 8: acoustic training on the card (train_acoustic, default Config)')
    t0 = time.perf_counter()
    served, data_dir = acoustic_training(fd, device, f'{work}/acoustic')
    launches = {k: launches[k] + served.get(k, 0) for k in launches}
    log(f'  phase 8 took {time.perf_counter() - t0:.1f} s; training launches none of the '
        f'kernels, its served request {served}; LAUNCHES over the paths of phases 4, 5 and '
        f'8: {launches}')

    log('== phase 9: data parallelism (process groups on the card, serving replicas)')
    t0 = time.perf_counter()
    replicas = data_parallel(fd, synth, card, device)
    launches = {k: launches[k] + replicas.get(k, 0) for k in launches}
    log(f'  phase 9 took {time.perf_counter() - t0:.1f} s; the trainers launch none of the '
        f'kernels, the replicas {replicas}; LAUNCHES over the paths of phases 4, 5, 8 and 9: '
        f'{launches}')

    log('== phase 10: host side and vocoder tools (native Griffin-Lim, reference checkpoint '
        'import, infer_vocoder, --device_data, serving_latency)')
    t0 = time.perf_counter()
    imported = host_side(fd, synth, device)
    launches = {k: launches[k] + imported.get(k, 0) for k in launches}
    log(f'  phase 10 took {time.perf_counter() - t0:.1f} s; the imported checkpoint\'s request '
        f'{imported}; LAUNCHES over the paths of phases 4, 5, 8, 9 and 10: {launches}')

    log(f'== phase 11: tensor parallelism (--model_parallel {TP_K}, two gloo ranks on '
        'one card)')
    t0 = time.perf_counter()
    served = tensor_parallel(fd, card, device)
    launches = {k: launches[k] + served.get(k, 0) for k in launches}
    log(f'  phase 11 took {time.perf_counter() - t0:.1f} s; the TP checkpoint\'s request '
        f'{served}; LAUNCHES over the paths of phases 4, 5 and 8-11: {launches}')

    log('== phase 12: run dirs on the card (serve.app --acoustic_dir/--vocoder_dir; a run '
        'in the JAX layout imported, resumed and served)')
    t0 = time.perf_counter()
    runs = {'acoustic': f'{work}/acoustic/run', 'vocoder': f'{work}/vocoder/run',
            'data': data_dir}
    served = run_dirs(fd, runs, f'{work}/run_dirs', device)
    launches = {k: launches[k] + served.get(k, 0) for k in launches}
    log(f'  phase 12 took {time.perf_counter() - t0:.1f} s [{card}]; its two requests '
        f'{served}; LAUNCHES over the paths of phases 4, 5, 8-12: {launches}')

    log('== phase 13: the training-quality study tools on the card (sanity_train, '
        'convergence_session, decay_session, coverage_diagnosis, draw_embd_sim, bf16_ab, '
        'variant_ranking, dsp_studies)')
    t0 = time.perf_counter()
    served = study_tools(fd, device, f'{work}/study')
    launches = {k: launches[k] + served.get(k, 0) for k in launches}
    log(f'  phase 13 took {time.perf_counter() - t0:.1f} s [{card}]; its evaluated texts '
        f'{served}; LAUNCHES over the paths of phases 4, 5, 8-13: {launches}')

    log('== phase 14: the timing and equivalence tools on the card (pallas_equivalence, '
        'acoustic_step_ab, profile_stages, acoustic_step_trace, train_scaling, '
        'bench_precision)')
    t0 = time.perf_counter()
    served = timing_tools(fd, card, f'{work}/tools', device)
    launches = {k: launches[k] + served.get(k, 0) for k in launches}
    log(f'  phase 14 took {time.perf_counter() - t0:.1f} s [{card}]; its tools {served}; '
        f'LAUNCHES over the paths of phases 4, 5, 8-14: {launches}')

    sources = {'decode_step': 'fused_decoder.cu', 'decode_full': 'fused_decoder.cu',
               'lsa_step': 'lsa_step.cu'}
    replaces = {'decode_step': 'transtacos_retunegan_tpu/ops/fused_decoder.py:273',
                'decode_full': 'transtacos_retunegan_tpu/ops/fused_decoder.py:402',
                'lsa_step': 'transtacos_retunegan_tpu/ops/lsa_kernel.py:65'}
    record = {'kernels': [
        {'name': k, 'route': 'cuda',
         'source': f'transtacos_retunegan_tpu_torch/csrc/{sources[k]}',
         'replaces': replaces[k], 'launches': launches[k],
         'max_abs_err': worst[k], 'ms': times[k]['ms'],
         'plain_ms': times[k]['plain_ms'], 'bound_ms': times[k]['bound'][0],
         'bound_by': times[k]['bound'][1], 'library_ms': None,
         **({'floor_ms': times[k]['floor_ms']} if 'floor_ms' in times[k] else {})}
        for k in ('decode_step', 'decode_full', 'lsa_step')]}
    log(f'total {time.perf_counter() - t_start:.1f} s')
    log(card)
    log(json.dumps(record))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
