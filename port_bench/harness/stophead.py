"""Seeded weights have no learned stop: a stop head is fitted in set-up so
that each pool text stops after the steps its syllables take, as a trained
model stops at the end of its text.

Frozen copies of ``chip_smoke.py::stop_head`` (lines 772-789) and
``chip_smoke.py::cohort_bias`` (lines 933-944).  Verdict on the originals:
sound; without them no request ends at its own length (seeded weights
stop every row at step 1).  Changed here: the head is fitted to the
inputs of the float32 reference's stop projection in its decode of each
text alone (so the program makes nothing the reference is given), on
fewer steps (see ``stop_head``), and the bias is chosen from the stop
logits of both the reference and the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def stop_head(inputs: Sequence[torch.Tensor], targets: Sequence[int], r: int,
              keep: int = 4, rounds: int = 32) -> torch.Tensor:
    """Stop-projection weights ``[H+D, r]`` under which text ``b``, whose
    decode feeds its stop projection ``inputs[b]`` ``[>= targets[b], H+D]``
    (one row per step), stops after ``targets[b]`` steps: its logit at
    step t is inputs[b][t] . c, with ``c`` the minimum-norm solution of
    inputs[b][t] . c = t - targets[b] + 1.5 (a ramp that crosses 0 at the
    target step) over the last ``keep`` steps before each target, and over
    every earlier step whose logit would otherwise reach -0.5 (added
    round by round).  Until it stops, a decode does not depend on its stop
    head.

    The original (``chip_smoke.py::stop_head``) reads the frame projection
    (``wf @ c``, width rM = 400) and fits the ramp at every step of every
    text, exact while the steps add up to under 400: a pool of 372 steps
    leaves ``c`` so long that the bf16 decode's rounding moved a logit by
    more than 1 on an H100.  Fewer equations over the full
    width H+D keep ``c`` short."""
    xs = [x[:t].double() for x, t in zip(inputs, targets)]
    active = [set(range(max(0, t - keep), t)) for t in targets]
    for _ in range(rounds):
        rows = torch.cat([x[sorted(a)] for x, a in zip(xs, active)])
        ramp = torch.cat([torch.tensor(sorted(a), dtype=torch.float64, device=rows.device)
                          - t + 1.5 for a, t in zip(active, targets)])
        c = torch.linalg.pinv(rows) @ ramp
        grew = False
        for x, a, t in zip(xs, active, targets):
            z = (x @ c).cpu().numpy()
            late = {i for i in range(t - 1) if z[i] > -0.5 and i not in a}
            a |= late
            grew |= bool(late)
        if not grew:
            break
    return c.float()[:, None].expand(-1, r).contiguous()


def cohort_bias(rows: Sequence[Tuple[np.ndarray, int]], margin: float = 0.05) -> float:
    """The stop bias under which every decode row ``z`` of ``rows`` (its
    bias-free stop logits per step, paired with its target) stops after
    exactly its target's steps, halfway between the largest logit before
    those steps and the smallest at them; both must be at least
    ``2 * margin`` apart, so that rounding cannot move a stop.  (The
    original takes a list of ``[B, steps]`` arrays and one target per row;
    here each row carries its own target.)"""
    lo = max((float(z[:t - 1].max()) for z, t in rows if t > 1), default=-80.0)
    hi = min(float(z[t - 1]) for z, t in rows)
    if not hi - lo >= 2 * margin:
        raise RuntimeError(f'no stop bias stops every row at its target: '
                           f'largest logit before {lo:.3f}, smallest at {hi:.3f}')
    return -(lo + hi) / 2


def logits_from_probs(p: torch.Tensor, bias: float, r: int) -> np.ndarray:
    """Bias-free stop logits ``[B, steps]`` (the largest of the r per step)
    from a decode's stop probabilities ``[B, steps * r]`` at stop bias
    ``bias``."""
    p = p.double().cpu().numpy()
    z = np.log(p) - np.log1p(-p) - bias
    return z.reshape(p.shape[0], -1, r).max(-1)
