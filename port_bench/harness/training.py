"""A training cell: the port's ``gan_train_step`` on one ``GANState``, then
held to the float32 reference over its first steps.

Set-up (counted in ``setup_s``): seeded generator and discriminator
weights on the card, a pool of batches made on the card from the seed
(synthetic voiced speech: harmonics of a gliding pitch under a syllable
envelope, plus noise; its log-mel and 4-iteration Griffin-Lim template
through the reference's DSP, as the vocoder loader makes them), one
``GANState`` with fresh AdamW, and its first ``FIRST_STEPS`` steps through
the window's own call on pool batches that all differ, then ``WARM_STEPS``
more.  The same state object then runs the window, cycling the pool, until
``--seconds`` have passed; the window closes on the device's completion.

The check (after the peak memory is read): the reference starts from the
same weights, batches and noise seed and takes the first ``FIRST_STEPS``
steps.  Compared, each by its worst case: every step's losses (relative
gap), the first gradient of every leaf as its optimizer got it (from
AdamW's first moment after its first update: ``exp_avg / (1 - beta1)``),
and every leaf's change after ``FIRST_STEPS`` steps; a leaf's gap is the
gap between the two norms over the larger of the reference's norm and the
median leaf's.  Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of both.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import common, trace
from .common import Record
from .weights import seeded_state

FIRST_STEPS = 3
WARM_STEPS = 3
TRACED_STEPS = 3
NEGLIGIBLE = 1e-3
LOSS_STEPS = 1             # steps whose losses are compared (see PERF.md)


def speech(n: int, length: int, sr: int, seed: int, device) -> torch.Tensor:
    """``n`` clips of synthetic voiced speech ``[n, length]`` from the seed,
    made on ``device`` in a few large calls: 40 harmonics of a pitch that
    glides between two draws in 90-260 Hz, with a spectral tilt, under a
    syllable-rate envelope, plus a noise floor."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(n, 6, generator=g, device=device)
    t = torch.arange(length, device=device) / sr
    f0 = 90 + 170 * (u[:, :1] + (u[:, 1:2] - u[:, :1]) * t / t[-1])       # [n, T]
    phase = 2 * math.pi * torch.cumsum(f0 / sr, 1)
    k = torch.arange(1, 41, device=device, dtype=torch.float32)[:, None]
    tilt = k ** -(0.8 + 0.6 * u[:, 2])[None]                                # [40, n]
    voiced = (tilt[..., None] * torch.sin(k[..., None] * phase[None])).sum(0)
    rate = 3 + 3 * u[:, 3:4]
    env = torch.sin(math.pi * rate * t + 2 * math.pi * u[:, 4:5]).abs() ** 1.5
    y = env * voiced + 0.01 * torch.randn(n, length, generator=g, device=device)
    return 0.8 * y / y.abs().amax(1, keepdim=True)


def batches(ref_cfg, pool: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` batches {mel [B, T, M], tmpl [B, S], wav [B, S]}: the
    vocoder loader's features (``data/vocoder_data.py``: log mel of the
    natural magnitude, the fast Griffin-Lim template of its log magnitude
    with a seeded phase, padded by one sample) of ``speech`` clips."""
    from port_bench.reference.audio import dsp
    au, b = ref_cfg.audio, ref_cfg.vocoder.batch_size
    seg = au.segment_size
    wav = speech(pool * b, seg, au.sample_rate, seed, device)
    out = []
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + 7) % (2 ** 63))
    with torch.no_grad():
        for i in range(pool):
            y = wav[i * b:(i + 1) * b]
            mag = dsp.stft(y, au.n_fft, au.hop_length, au.win_length, au.window_fn
                           ).abs()[..., :seg // au.hop_length]
            mel = torch.log(torch.clamp(dsp.mag_to_mel(mag, au), min=1e-5))
            log_mag = torch.log(torch.clamp(mag, min=dsp.EPS_AMP))
            tmpl = dsp.inv_log_mag(log_mag, au, length=seg - 1, generator=g)
            tmpl = torch.nn.functional.pad(tmpl, (0, 1))
            out.append({'mel': mel.transpose(1, 2).contiguous(), 'tmpl': tmpl.contiguous(),
                        'wav': y.contiguous()})
    return out


class FirstMoments:
    """AdamW's first moment of every parameter after the optimizer's
    first update (a step post-hook: the program's code is not touched)."""

    def __init__(self, opt: torch.optim.Optimizer, names: Dict[int, str]):
        self.moments: Dict[str, torch.Tensor] = {}
        self.beta1 = opt.param_groups[0]['betas'][0]
        self._names = names
        self._hook = opt.register_step_post_hook(self._after)

    def _after(self, opt, args, kwargs):
        for group in opt.param_groups:
            for p in group['params']:
                self.moments[self._names[id(p)]] = opt.state[p]['exp_avg'].detach().clone()
        self._hook.remove()

    def grads(self) -> Dict[str, torch.Tensor]:
        return {k: v / (1 - self.beta1) for k, v in self.moments.items()}


@dataclass
class Trained:
    cfg: Any
    ref_cfg: Any
    generator: Dict[str, torch.Tensor]
    discriminators: Dict[str, torch.Tensor]
    pool: List[Dict[str, torch.Tensor]]
    noise_seed: int
    state: Any
    losses: List[Dict[str, float]] = field(default_factory=list)
    first_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    start: Dict[str, torch.Tensor] = field(default_factory=dict)
    after: Dict[str, torch.Tensor] = field(default_factory=dict)
    noise: Any = None


def named(state) -> Dict[str, torch.nn.Parameter]:
    return {**{f'generator.{k}': v for k, v in state.generator.named_parameters()},
            **{f'discriminators.{k}': v for k, v in state.discriminators.named_parameters()}}


def build(run: Record, device: str = 'cuda',
          step_fn: Optional[Callable] = None) -> Trained:
    """Everything before the window.  ``step_fn(cfg, state, batch, noise)``
    replaces the program's step (the tests' faults)."""
    from port_bench.reference.config import Config as RefConfig
    from port_bench.reference.models.discriminators import Discriminators as RD
    from port_bench.reference.models.generators import make_generator as rg
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.models.discriminators import Discriminators
    from transtacos_retunegan_tpu_torch.models.generators import make_generator
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = run.extra['config_file']
    cfg, ref_cfg = Config.load(path), RefConfig.load(path)
    gen_sd = seeded_state(lambda: rg(ref_cfg), run.seed * 2 + 1, device)
    disc_sd = seeded_state(lambda: RD(ref_cfg), run.seed * 2 + 2, device)
    pool = batches(ref_cfg, int(run.workload['pool']), run.seed, device)
    gen = make_generator(cfg).to(device)
    gen.load_state_dict(gen_sd)
    disc = Discriminators(cfg).to(device)
    disc.load_state_dict(disc_sd)
    gen_opt, disc_opt = vs.make_optimizers(cfg, gen, disc)
    state = vs.GANState(0, gen, gen_opt, disc, disc_opt)
    noise_seed = run.seed % (2 ** 62) + 11
    t = Trained(cfg, ref_cfg, gen_sd, disc_sd, pool, noise_seed, state)
    t.noise = torch.Generator(device=device)
    t.noise.manual_seed(noise_seed)
    ids = {id(p): k for k, p in named(state).items()}
    moments = [FirstMoments(state.gen_opt, ids), FirstMoments(state.disc_opt, ids)]
    step = step_fn or vs.gan_train_step
    run.extra['step_fn'] = step
    t.start = {k: p.detach().clone() for k, p in named(state).items()}
    for i in range(FIRST_STEPS):
        _, m = step(cfg, state, pool[i % len(pool)], t.noise)
        t.losses.append({k: float(m[k]) for k in ('loss_gen_all', 'loss_disc_all')})
    t.after = {k: p.detach().clone() for k, p in named(state).items()}
    for mo in moments:
        t.first_grads.update(mo.grads())
    for i in range(WARM_STEPS):
        step(cfg, state, pool[(FIRST_STEPS + i) % len(pool)], t.noise)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    hv, au = cfg.vocoder, cfg.audio
    run.audio_s_per_step = hv.batch_size * au.segment_size / au.sample_rate
    return t


def instrument(run: Record) -> List[Tuple[str, Any, Any]]:
    """CUDA events around each call of the two phase functions: the
    program's module globals are replaced by wrappers (for the rest of the
    process)."""
    from transtacos_retunegan_tpu_torch.train import vocoder_step as vs
    events: List[Tuple[str, Any, Any]] = []
    for name in ('discriminator_phase', 'generator_phase'):
        fn = getattr(vs, name)

        def timed(*args, _fn=fn, _name=name, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = _fn(*args, **kwargs)
            b.record()
            events.append((_name, a, b))
            return out

        setattr(vs, name, timed)
    return events


def window(t: Trained, run: Record) -> None:
    """Steps until ``--seconds`` have passed, closed on the device's
    completion.  A traced run times the two phases by CUDA events inside
    the window and, after it, profiles ``TRACED_STEPS`` more steps."""
    step = run.extra['step_fn']
    cuda = t.pool[0]['wav'].device.type == 'cuda'
    events = instrument(run) if run.trace and cuda else []
    seconds, i, n = run.extra['seconds'], FIRST_STEPS + WARM_STEPS, 0
    run.setup_s = common.since_process_start()
    run.t_start = time.monotonic()
    while time.monotonic() - run.t_start < seconds:
        step(t.cfg, t.state, t.pool[i % len(t.pool)], t.noise)
        i += 1
        n += 1
    if cuda:
        torch.cuda.synchronize()
    run.t_end = time.monotonic()
    run.steps = n
    for name in ('discriminator_phase', 'generator_phase'):
        run.spans[name] = [{'ms': a.elapsed_time(b)} for k, a, b in events if k == name]
    if run.trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p0 = time.monotonic()
            for k in range(TRACED_STEPS):
                step(t.cfg, t.state, t.pool[(i + k) % len(t.pool)], t.noise)
            torch.cuda.synchronize()
            p1 = time.monotonic()
        run.device = trace.summarize(prof, p0, p1)
        run.extra['traced_steps'] = TRACED_STEPS


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Tuple[float, str, float]:
    """Per leaf, |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's norm):
    the worst, its leaf, and the median over the leaves.  A leaf missing
    from ``prog`` (an optimizer that never stepped) has norm 0."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    got = {k: float(prog[k].double().norm()) if k in prog else 0.0 for k in keep}
    gaps = {k: abs(got[k] - norms[k]) / max(norms[k], med, 1e-30) for k in keep}
    at = max(gaps, key=gaps.get)
    return gaps[at], at, float(np.median(list(gaps.values())))


def reference_steps(t: Trained, device: str, tf32: bool = False,
                    benchmark: bool = False, deterministic: bool = False):
    """The reference's first ``FIRST_STEPS`` steps from the same start:
    its losses, first gradients and parameters after them.  ``benchmark``
    and ``deterministic`` set cuDNN's choice of algorithms, and so the
    order of its sums (readings of the reference against itself)."""
    from port_bench.reference import gan
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.deterministic = deterministic
    try:
        st = gan.State(t.ref_cfg, t.generator, t.discriminators, device)
        ids = {id(p): k for k, p in named(st).items()}
        moments = [FirstMoments(st.gen_opt, ids), FirstMoments(st.disc_opt, ids)]
        noise = torch.Generator(device=device)
        noise.manual_seed(t.noise_seed)
        losses = []
        for i in range(FIRST_STEPS):
            m = gan.train_step(st, t.pool[i % len(t.pool)], noise)
            losses.append({k: float(v) for k, v in m.items()})
        grads = {}
        for mo in moments:
            grads.update(mo.grads())
        return losses, grads, {k: p.detach().clone() for k, p in named(st).items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False


def compare(t: Trained, losses, grads, after) -> Dict[str, Any]:
    """The numbers of the check (see the module's docstring), and beside
    them what the readings need: the loss gap of each step, the median
    leaf's gaps."""
    by_step = [max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r)
               for p, r in zip(t.losses, losses)]
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= NEGLIGIBLE * med]
    grad_gap, grad_at, grad_med = leaf_gaps(t.first_grads, grads, keep)
    moved = {k: after[k] - t.start[k] for k in keep}
    moved_p = {k: t.after[k] - t.start[k] for k in keep}
    move_gap, move_at, move_med = leaf_gaps(moved_p, moved, keep)
    common.log(f'check leaves: {len(keep)} of {len(norms)} compared; worst gradient '
               f'{grad_at}, worst change {move_at}; loss gap by step {by_step}')
    return {'loss_rel_gap': max(by_step[:LOSS_STEPS]), 'grad_norm_gap': grad_gap,
            'update_median_gap': move_med, 'loss_gap_by_step': by_step,
            'grad_median_gap': grad_med, 'update_norm_gap': move_gap,
            'worst_leaves': [grad_at, move_at]}


def check(t: Trained, run: Record, device: str = 'cuda') -> Dict[str, Dict[str, Any]]:
    lim = run.workload['limits']
    out = compare(t, *reference_steps(t, device))
    checks = {'failed': {'value': 0, 'limit': 0, 'ok': True}}
    for k, limit in lim.items():
        checks[k] = {'value': out[k], 'limit': limit, 'ok': bool(out[k] <= limit)}
    return checks


def step_flops(t: Trained, device: str) -> float:
    """Matmul and convolution FLOPs of one reference GAN step, forward and
    backward (``FlopCounterMode``)."""
    from port_bench.reference import gan
    from . import roofline
    st = gan.State(t.ref_cfg, t.generator, t.discriminators, device)
    noise = torch.Generator(device=device)
    noise.manual_seed(t.noise_seed)
    return float(roofline.counted_flops(lambda: gan.train_step(st, t.pool[0], noise)))
