"""A serving cell: the port's ``BatchingFrontend`` over its ``Synthesizer``,
driven by the cell's traffic, then held to the float32 reference.

Set-up (counted in ``setup_s``): seeded weights on the card, the pool of
texts, the stop head fitted to the float32 reference's decode of each
pool text (``stophead.py``; the served bf16 decode stops within a step or
two of it), the ``Synthesizer`` built from those weights, and every shape
of the cell's traffic warmed on the frontend's long-lived threads: each
pool text alone, then one burst of concurrent requests.

The window: a closed loop of ``clients`` threads, each calling
``BatchingFrontend.tts`` back to back on its share of the seeded order: a
rewrite of ``transtacos_retunegan_tpu_torch/tools/serving_latency.py::run_load``
(lines 56-118; verdict: right idea, wrong traffic, since every request
there vocodes the same noise spec), here through ``tts`` on the pool's
texts.  After the window, in-flight requests are awaited (up to a
minute), the peak memory is read, and then the reference judges every
distinct answer the program gave, in the window or not (``compare``):
its stop against the reference's own, its wav against the reference's
at the answer's length (in units of what bf16 rounding of the decode and
the generator moves it), and the first spec served for each text.
"""

from __future__ import annotations

import gc
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import common, stophead, trace, traffic
from .common import Record, Request
from .weights import seeded_state

DRAIN_S = 60.0
TRACED_S = 6.0            # a traced run profiles at most this much of its window
GEN_RANGE = 'port_bench::generator'
YARD_FLOOR = 1e-3         # the least unit of the wav comparison (see ``compare``)


@dataclass
class Served:
    """One cell's served system and its inputs, ready for a window."""
    cfg: Any                      # the port's Config
    ref_cfg: Any                  # the reference's Config (same file)
    texts: List[str]
    targets: List[int]
    acoustic: Dict[str, torch.Tensor]
    generator: Dict[str, torch.Tensor]
    head: Tuple[torch.Tensor, float]
    synth: Any
    frontend: Any
    synth_seed: int
    spans: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)


def weights(ref_cfg, seed: int, device) -> Tuple[Dict, Dict]:
    from port_bench.reference.models.acoustic import Tacotron
    from port_bench.reference.models.generators import make_generator
    return (seeded_state(lambda: Tacotron(ref_cfg), seed * 2 + 1, device),
            seeded_state(lambda: make_generator(ref_cfg), seed * 2 + 2, device))


def fit_stop(ref, texts: List[str], targets: List[int]) -> torch.Tensor:
    """The stop head fitted to what the reference's stop projection reads
    at each step of each text (no stop: bias -1e4)."""
    r = ref.cfg.acoustic.outputs_per_step
    proj = ref.acoustic.decoder_cell.stop_projection
    ref.set_stop(torch.zeros_like(proj.weight.t()), -1e4)
    inputs = []
    for t, n in zip(texts, targets):
        seen: List[torch.Tensor] = []
        hook = proj.register_forward_pre_hook(lambda m, a: seen.append(a[0][0]))
        try:
            ref.decode(ref.encode(t), n + 1, stop=False)
        finally:
            hook.remove()
        inputs.append(torch.stack(seen))
    return stophead.stop_head(inputs, targets, r)


def reference_logits(ref, texts, targets) -> List[np.ndarray]:
    """Bias-free stop logits per step of each text, reference at bias -20."""
    r = ref.cfg.acoustic.outputs_per_step
    return [stophead.logits_from_probs(
        ref.decode(ref.encode(t), n + 1, stop=False)[1][None], -20.0, r)[0]
        for t, n in zip(texts, targets)]


def build(run: Record, device: str = 'cuda') -> Served:
    """Everything before the window, on ``device``."""
    from port_bench.reference.config import Config as RefConfig
    from port_bench.reference.serve import Reference
    from transtacos_retunegan_tpu_torch.config import Config
    from transtacos_retunegan_tpu_torch.serve.batcher import BatchingFrontend
    from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, path = run.workload, run.extra['config_file']
    cfg, ref_cfg = Config.load(path), RefConfig.load(path)
    r = ref_cfg.acoustic.outputs_per_step
    synth_seed = run.seed % (2 ** 31)
    acoustic, generator = weights(ref_cfg, run.seed, device)
    texts = traffic.pool_texts(wl, run.seed)
    targets = traffic.target_steps(wl, r)
    ref = Reference(ref_cfg, acoustic, generator, device, synth_seed)
    ws = fit_stop(ref, texts, targets)
    ref.set_stop(ws, -20.0)
    bias = stophead.cohort_bias(list(zip(reference_logits(ref, texts, targets), targets)))
    del ref
    served = dict(acoustic)
    served['decoder_cell.stop_projection.weight'] = ws.t().contiguous()
    served['decoder_cell.stop_projection.bias'] = torch.full((r,), bias, device=device)
    synth = Synthesizer(cfg, acoustic_params=served, gen_params=generator,
                        seed=synth_seed, devices=[device])
    common.log(f'pool: {len(texts)} texts, targets {targets} steps, |head| '
               f'{float(ws[:, 0].norm()):.3f}, stop bias {bias:.4f}')
    run.extra.update(sample_rate=cfg.audio.sample_rate, ref_cfg=ref_cfg)
    fe = BatchingFrontend(synth, max_batch=wl['max_batch'], window_s=wl['window_ms'] / 1e3)
    s = Served(cfg, ref_cfg, texts, targets, acoustic, generator, (ws, bias), synth, fe,
               synth_seed)
    warm(s, wl)
    return s


def warm(s: Served, wl: Dict) -> None:
    """Every shape of the traffic on the frontend's threads: each pool
    text alone, then a burst of ``clients`` concurrent requests over the
    pool."""
    hop, r = s.cfg.audio.hop_length, s.cfg.acoustic.outputs_per_step
    steps = [s.frontend.tts(t).shape[0] // (hop * r) for t in s.texts]
    common.log(f'served steps per pool text: {steps} (targets {s.targets})')
    burst = int(wl['clients'])
    with ThreadPoolExecutor(burst) as pool:
        list(pool.map(lambda i: s.frontend.tts(s.texts[i % len(s.texts)]), range(burst)))
    if s.synth.device.type == 'cuda':
        torch.cuda.synchronize()


def instrument(s: Served) -> None:
    """Spans around the two stages and a range around the generator."""
    cfg = s.cfg
    r = cfg.acoustic.outputs_per_step
    bucket = cfg.acoustic.text_bucket
    from port_bench.reference.text import frontend as tf

    def acoustic_attrs(args, kwargs, out):
        pinyins, rows = args[0], kwargs.get('rows', args[1] if len(args) > 1 else 1)
        n = max(tf.serialize_inference(p, cfg.acoustic.g2p).shape[0] for p in pinyins)
        b = s.synth._pad_rows(len(pinyins), rows)
        steps = [spec.shape[1] // r for spec in out]
        steps += [steps[0]] * (b - len(steps))         # fill rows repeat row 0
        return {'rows': b, 'n': -(-n // bucket) * bucket, 'steps': steps,
                'real': len(pinyins)}

    def vocoder_attrs(args, kwargs, out):
        specs = args[0]
        rows = kwargs.get('rows', args[3] if len(args) > 3 else 1)
        t = [spec.shape[1] if spec.shape[0] in (cfg.audio.n_freq, cfg.audio.n_freq - 1)
             else spec.shape[0] for spec in specs]
        return {'rows': s.synth._pad_rows(len(specs), rows), 'frames': t,
                'bucket': -(-max(max(t), 64) // 64) * 64}

    trace.wrap(s.synth, 'synthesize_spec_batch', s.spans, 'acoustic_stage', acoustic_attrs)
    trace.wrap(s.synth, 'vocode_batch', s.spans, 'vocoder_stage', vocoder_attrs)
    trace.ranged(s.synth.generator, GEN_RANGE)


class Answers:
    """Each request's wav, kept once per distinct content, and the first
    spec served for each text."""

    def __init__(self):
        self.lock = threading.Lock()
        self.distinct: Dict[Tuple[int, str], np.ndarray] = {}
        self.count: Dict[Tuple[int, str], int] = {}
        self.specs: Dict[int, np.ndarray] = {}
        self.cohorts: List[int] = []

    def watch_specs(self, s: 'Served') -> None:
        """Keep the first spec the acoustic stage serves for each text."""
        index = {t: i for i, t in enumerate(s.texts)}
        fn = s.synth.synthesize_spec_batch

        def kept(pinyins, *args, **kwargs):
            out = fn(pinyins, *args, **kwargs)
            self.cohorts.append(len(pinyins))
            for p, spec in zip(pinyins, out):
                self.specs.setdefault(index[p], spec)
            return out

        s.synth.synthesize_spec_batch = kept

    def keep(self, text: int, wav: np.ndarray) -> None:
        key = (text, hashlib.sha1(np.ascontiguousarray(wav).tobytes()).hexdigest())
        with self.lock:
            if key not in self.distinct:
                self.distinct[key] = wav
            self.count[key] = self.count.get(key, 0) + 1


def _call(s: Served, req: Request, answers: Answers) -> None:
    req.sent = time.monotonic()
    try:
        wav = s.frontend.tts(s.texts[req.text])
        req.done = time.monotonic()
        answers.keep(req.text, wav)
        req.wav = wav.shape[0]
    except Exception as e:                       # noqa: BLE001 -- a failed request
        req.done = time.monotonic()
        req.error = repr(e)


def closed_loop(s: Served, run: Record, seconds: float, answers: Answers) -> None:
    wl = run.workload
    clients = int(wl['clients'])
    seq = traffic.order(wl, run.seed, 200_000)
    go, stop = threading.Event(), threading.Event()
    per_client: List[List[Request]] = [[] for _ in range(clients)]

    def client(c: int):
        go.wait()
        i = c
        while not stop.is_set():
            req = Request(seq[i % len(seq)])
            per_client[c].append(req)
            _call(s, req, answers)
            i += clients

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    run.t_start = time.monotonic()
    go.set()
    time.sleep(max(0.0, run.t_start + seconds - time.monotonic()))
    run.t_end = time.monotonic()
    stop.set()
    for t in threads:
        t.join(timeout=DRAIN_S)
    run.requests = [r for rs in per_client for r in rs]
    if any(t.is_alive() for t in threads):
        run.extra['undrained'] = sum(t.is_alive() for t in threads)


def serve(run: Record, served: Optional[Served] = None) -> Tuple[Served, Answers]:
    """Set-up, the window (profiled in a traced run) and the drain, on
    ``run.extra['device']`` (default the card)."""
    s = served or build(run, run.extra.get('device', 'cuda'))
    answers = Answers()
    if run.trace:
        instrument(s)
    answers.watch_specs(s)
    run.setup_s = common.since_process_start()
    if run.trace and s.synth.device.type == 'cuda':
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=torch._C._profiler._ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            t0 = time.monotonic()
            closed_loop(s, run, min(run.extra['seconds'], TRACED_S), answers)
            torch.cuda.synchronize()
            t1 = time.monotonic()
        run.device = trace.summarize(prof, t0, t1, (GEN_RANGE,), s.spans)
        del prof
    else:
        closed_loop(s, run, run.extra['seconds'], answers)
    run.spans = s.spans
    c = answers.cohorts
    common.log(f'window: {len(run.in_window())} requests done in {run.window_s:.3f} s; '
               f'{len(c)} acoustic cohorts of {np.mean(c) if c else 0:.3f} texts')
    return s, answers


def spec_db_rms(got: np.ndarray, want: np.ndarray) -> float:
    """RMS over the bins and frames of the difference in dB of two
    natural-scale specs [F, T] (each floored at -100 dB)."""
    db = lambda s: 20 * np.log10(np.maximum(np.asarray(s, np.float64), 1e-5))  # noqa: E731
    return float(np.sqrt(np.mean((db(got) - db(want)) ** 2)))


def references(s: Served, device) -> Tuple[Any, Any]:
    """The float32 reference and its bf16 yardstick (the decoder cell and
    the generator through bfloat16, as served; the rest float32), both
    with the fitted stop head."""
    from port_bench.reference.serve import Reference
    refs = tuple(Reference(s.ref_cfg, s.acoustic, s.generator, device, s.synth_seed,
                           lower=mode) for mode in (None, 'bf16_served'))
    for ref in refs:
        ref.set_stop(*s.head)
    return refs


def compare(refs, texts: List[str], answers: Dict[Tuple[int, str], np.ndarray],
            specs: Dict[int, np.ndarray], hop: int, r: int) -> Dict[str, Any]:
    """The answers against the reference (``refs``: the float32 reference
    and its bf16 yardstick, from ``references``): per distinct answer, the
    gap in steps between its stop and the reference's own, and the
    relative L2 error of its wav against the reference's wav at the
    answer's own length, in units of the yardstick's error there, or of
    ``YARD_FLOOR`` where that is larger (``wav_err_ratio``: the seeded
    generator's weights set how far any rounding moves its wav, by 10x
    from seed to seed, and the unit takes that out; on the rare seed whose
    wav rounding barely moves, the floor keeps the unit from a ratio of
    two round-offs); per text, the dB RMS error of the first spec served
    for it against the reference's at its length.  Each number is the worst;
    ``each`` keeps every answer's readings (text, steps, the reference's
    own steps, wav error, the yardstick's) and every spec's (text, dB
    error)."""
    from port_bench.reference.serve import rel_err
    ref, unit = refs
    own = {i: ref.own_steps(texts[i]) for i in {k[0] for k in answers} | set(specs)}
    gap, wav_err, ratio, spec_err = 0, 0.0, 0.0, 0.0
    each = {'wav': [], 'spec': []}
    for (i, _), wav in answers.items():
        steps = wav.shape[0] // (hop * r)
        gap = max(gap, abs(steps - own[i]))
        want = ref.tts(texts[i], steps)
        err, yard = rel_err(wav, want), rel_err(unit.tts(texts[i], steps), want)
        wav_err = max(wav_err, err)
        ratio = max(ratio, err / max(yard, YARD_FLOOR))
        each['wav'].append([i, steps, own[i], err, yard])
    for i, spec in specs.items():
        gap = max(gap, abs(spec.shape[1] // r - own[i]))
        want = ref.spec(texts[i], spec.shape[1] // r).cpu().numpy()
        err = spec_db_rms(spec, want)
        spec_err = max(spec_err, err)
        each['spec'].append([i, err])
    return {'stop_gap_steps': gap, 'wav_err_ratio': ratio, 'spec_db_rms': spec_err,
            'wav_rel_err': wav_err, 'each': each}


def check(s: Served, run: Record, answers: Answers,
          device: str = 'cuda') -> Dict[str, Dict[str, float]]:
    """Every answer against the reference (``compare``)."""
    lim = run.workload['limits']
    gc.collect()
    if s.synth.device.type == 'cuda':
        torch.cuda.empty_cache()
    got = compare(references(s, device), s.texts, answers.distinct, answers.specs,
                  s.cfg.audio.hop_length, s.cfg.acoustic.outputs_per_step)
    failed = sum(1 for q in run.requests if not q.ok)
    run.extra['distinct_answers'] = len(answers.distinct)
    checks = {'failed': {'value': failed, 'limit': 0, 'ok': failed == 0}}
    for k, limit in lim.items():
        checks[k] = {'value': got[k], 'limit': limit, 'ok': bool(got[k] <= limit)}
    run.extra['each'] = got['each']
    common.log(f'wav relative L2 error, worst: {got["wav_rel_err"]!r}')
    return checks


def request_flops(s: Served, device: str = 'cuda') -> Dict[int, float]:
    """Matmul and convolution FLOPs of each pool text at its own length
    (one row, its unpadded ids and frames): the reference's encoder,
    posnet and generator under ``FlopCounterMode``, plus the decode's
    ``step_cost`` times its steps."""
    from port_bench.reference.models.acoustic import posnet_apply
    from port_bench.reference.serve import Reference
    from . import roofline
    ref = Reference(s.ref_cfg, s.acoustic, s.generator, device, s.synth_seed)
    dims = roofline.decoder_dims(s.ref_cfg)
    au, r = s.ref_cfg.audio, s.ref_cfg.acoustic.outputs_per_step
    out = {}
    with torch.no_grad():
        for i, (t, steps) in enumerate(zip(s.texts, s.targets)):
            ids, lens = ref.text_ids(t)
            n = int(lens[0])
            frames = steps * r
            enc = roofline.counted_flops(lambda: ref.acoustic(ids[:, :n], lens))
            mel = torch.zeros(1, frames, au.n_mel, device=device)
            post = roofline.counted_flops(lambda: posnet_apply(ref.acoustic, mel))
            gen = roofline.counted_flops(lambda: ref.generator(
                torch.zeros(1, frames, au.n_mel, device=device),
                torch.zeros(1, frames * au.hop_length, 1, device=device)))
            mm, _ = roofline.step_cost(dims, 1, n)
            out[i] = float(enc + post + gen + mm * steps)
    return out
