#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (set-up is long, so the seeds share it).

A serving cell, for each seed: the cell's set-up, a short window at the
cell's own load (``--seconds``) and the comparison of every answer with
the float32 reference, as a run makes it (the program); then the
reference in a lower precision put in the program's place, on the same
pool texts and stop head, compared by the same numbers:

* ``fp8``: every weight matrix and module input through float8 e4m3, the
  step below the served bf16: the control, which has to fail;
* ``bf16``: everything through bfloat16, so the stages that the
  configuration runs in float32 (encoder, posnet, DSP) one step below
  that, the decode and the generator at their served precision;
* ``tf32``: the decode and the generator through bfloat16 as served, the
  rest under TF32: the float32 stages' own next step down.

A training cell, for each seed: the program's first steps against the
float32 reference's; the reference with TF32 on (the control) and the
program on half of each batch (a fault) against the same; and the
float32 reference against itself, run again and under cuDNN's other
choices of algorithm (``benchmark``, ``deterministic``), which sum in
other orders.  For the leaf whose change is worst in each, its first
gradient's size against AdamW's eps and the share of its elements whose
first gradient has the other sign on the two sides.

    python3 port_bench/control.py --workload rgs-serve-c32 --seeds 1,2,3 --seconds 4

Prints one JSON line per seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import common  # noqa: E402

common.set_cache_env()

# control -> (the reference's ``lower`` mode, TF32 on)
CONTROLS = {'fp8': ('fp8', False), 'bf16': ('bf16', False), 'tf32': ('bf16_served', True)}
ADAM_EPS = 1e-8


def control_reading(served, control: str = 'fp8') -> dict:
    """The reference at ``control``'s precision in the program's place: its
    answers (each pool text decoded to its own stop) compared with the
    float32 reference as ``serving.compare`` compares the program's."""
    import torch
    from port_bench.harness.serving import compare, references
    from port_bench.reference.serve import Reference, plain_float32
    lower, tf32 = CONTROLS[control]
    device = served.synth.device
    low = Reference(served.ref_cfg, served.acoustic, served.generator, device,
                    served.synth_seed, lower=lower)
    low.set_stop(*served.head)
    refs = references(served, device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        steps = [low.own_steps(t) for t in served.texts]
        answers = {(i, ''): low.tts(t, n) for i, (t, n) in enumerate(zip(served.texts, steps))}
        specs = {i: low.spec(t, n).cpu().numpy()
                 for i, (t, n) in enumerate(zip(served.texts, steps))}
    finally:
        plain_float32()
    return compare(refs, served.texts, answers, specs, served.cfg.audio.hop_length,
                   served.cfg.acoustic.outputs_per_step)


def half_batch(cfg, state, batch, noise, steps_per_epoch: int = 568):
    """A fault: the step on the first half of the batch, its mean over
    those rows alone."""
    from transtacos_retunegan_tpu_torch.train.vocoder_step import gan_train_step
    half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    return gan_train_step(cfg, state, half, noise, steps_per_epoch)


def worst_change(side, ref, reading: dict) -> dict:
    """The leaf whose change after the first steps is worst in ``reading``:
    its gap, its size, its reference first gradient against AdamW's eps,
    and the share of its elements whose first gradient has the other sign
    on ``side`` (AdamW's first update moves each element by about the
    rate times that sign)."""
    leaf = reading['worst_leaves'][1]
    g, got = ref[1][leaf].double().flatten(), side.first_grads[leaf].double().flatten()
    return {'leaf': leaf, 'gap': reading['update_norm_gap'], 'numel': g.numel(),
            'grad_rms': float(g.norm() / g.numel() ** 0.5),
            'grad_abs_median': float(g.abs().median()),
            'share_under_100_eps': float((g.abs() < 100 * ADAM_EPS).double().mean()),
            'sign_flips': float(((g > 0) != (got > 0)).double().mean())}


def training_readings(rec, device: str = 'cuda') -> dict:
    """The program, the TF32 control, the half-batch fault and the
    reference under other orders of summation, each against the float32
    reference over the first steps."""
    from port_bench.harness import training
    t = training.build(rec, device)
    ref = training.reference_steps(t, device)

    def against(side):
        got = training.compare(side, *ref)
        return {**got, 'worst_change': worst_change(side, ref, got)}

    def as_program(steps):
        return dataclasses.replace(t, losses=steps[0], first_grads=steps[1], after=steps[2])

    out = {'program': against(t)}
    out['control'] = against(as_program(training.reference_steps(t, device, tf32=True)))
    for name, flags in (('again', {}), ('benchmark', {'benchmark': True}),
                        ('deterministic', {'deterministic': True})):
        out[f'reference_{name}'] = against(as_program(
            training.reference_steps(t, device, **flags)))
    del t
    out['half_batch'] = against(training.build(rec, device, step_fn=half_batch))
    return out


def main(argv=None) -> int:
    from port_bench.harness import serving
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=4.0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = next(w for w in bench['workloads'] if w['name'] == args.workload)
    conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
    wl = json.loads((common.BENCH / 'workloads' / f'{cell["name"]}.json').read_text())
    common.log(f'card: {common.card_line()}')
    for seed in (int(s) for s in args.seeds.split(',')):
        rec = common.Record(cell=cell, workload=wl, seed=seed, trace=False,
                            extra={'config_file': str(ROOT / conf['file']),
                                   'seconds': args.seconds})
        t0 = time.monotonic()
        if wl['driver'] == 'gan_train':
            print(json.dumps({'seed': seed, **training_readings(rec),
                              'seconds': time.monotonic() - t0}), flush=True)
            continue
        served = serving.build(rec, 'cuda')
        out = {'seed': seed, 'setup_s': time.monotonic() - t0}
        _, answers = serving.serve(rec, served)
        t1 = time.monotonic()
        checks = serving.check(served, rec, answers, 'cuda')
        out.update(program={k: c['value'] for k, c in checks.items()},
                   program_each=rec.extra['each'], requests=len(rec.requests),
                   distinct=rec.extra['distinct_answers'], check_s=time.monotonic() - t1)
        for control in CONTROLS:
            t2 = time.monotonic()
            out[control] = control_reading(served, control)
            out[f'{control}_s'] = time.monotonic() - t2
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
