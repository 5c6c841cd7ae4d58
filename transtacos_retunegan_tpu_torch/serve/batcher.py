"""Dynamic micro-batching for the HTTP server, ported from
``transtacos_retunegan_tpu/serve/batcher.py``.

Concurrent requests coalesce: a dispatcher gathers requests of the same
shape bucket that arrive within a small window and runs ONE batched call
(``Synthesizer.synthesize_spec_batch``: one ``decode_full`` launch for the
cohort; ``vocode_batch``: one generator forward).

* **Cohorts filled per bucket.**  A collection round takes everything
  waiting and gives each bucket up to ``max_batch`` of it, so a deep queue
  spread over several buckets fills each bucket's call instead of sharing
  ``max_batch`` among them.  What a full bucket cannot take is held over to
  the next round, ahead of anything that round collects, so no submission
  is overtaken within its bucket.  The round runs its calls in the order
  of each group's oldest submission.

* **Arrival-order independence.**  Each request's Griffin-Lim phase comes
  from its content (``Synthesizer.content_generator``), requests group only
  within one shape bucket (text bucket for the acoustic stage, frame bucket
  for the vocoder), and both stages always run at ``max_batch`` rows.  So
  every call of a stage has one shape, whatever the cohort: cuBLAS and
  cuDNN pick their algorithms by shape, each row's result then depends on
  that row alone, and N concurrent requests give bit for bit the audio of
  the same N requests issued one by one.  At the shape of its own cohort a
  row differs in its last bits, which the bf16 decode and the bf16
  generator carry into differences of up to 0.16 in the wav (H100, seeded
  weights, ``chip_smoke.py``).  The extra rows cost the decode little: its
  kernel reads each weight from shared memory once per four rows.
* **Card work on long-lived threads.**  PyTorch builds some caches per
  thread (cuDNN's execution plans among them); a call on a fresh thread
  took 160-250 ms against 30-40 ms on a long-lived one on an H100.  So every
  call that touches the card runs on one of three long-lived threads: the
  acoustic and vocoder dispatchers, and a worker for the calls the
  dispatchers do not take (Griffin-Lim synthesis).  HTTP handler threads
  only queue and wait.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..text import frontend
from ..utils import tracing
from .pipeline import Synthesizer, _round_up

Stamp = Optional[Tuple[int, int, int]]          # tracing.stamp of a submission
Item = Tuple[object, Future, Stamp]             # payload, its future, its stamp
Entry = Tuple[Hashable, object, Future, Stamp, float]  # key, an Item, its submit's time.monotonic()


class Coalescer:
    """Gathers concurrent same-bucket submissions into batched calls.

    ``fn(bucket_key, payloads) -> results`` runs on the dispatcher thread
    with 1..max_batch payloads that share ``bucket_key``; submitters block
    on a Future.  Each round runs one call per bucket it collected, each
    call carrying up to ``max_batch`` of that bucket's submissions (see
    ``_collect``).  When a batched call fails with more than one payload,
    the dispatcher retries each payload alone, so only the payloads that
    fail on their own receive the exception.  The dispatcher outlives every
    failure.

    Spans (``utils/tracing.py``, named by ``name``): ``<name>.wait`` per
    submission, from ``submit`` to the start of the first call that
    carries it, child of the submission's ``cause`` (its request), with
    that ``call`` and ``round``; ``<name>.round`` per collection, from its
    first item to the window's close, with the ``submissions``, bucket
    ``groups`` and ``requests`` its calls carry, and how many of those
    submissions were ``carried`` (held over from the round before);
    ``<name>.call`` per batched call, child of its round, with its
    ``bucket``, ``payloads``, ``solo`` (a retry alone) and ``requests``."""

    def __init__(self, fn: Callable[[Hashable, List], Sequence],
                 max_batch: int = 8, window_s: float = 0.006,
                 name: str = 'coalescer'):
        self._fn = fn
        self._max = max(1, int(max_batch))
        self._win = float(window_s)
        self._wait, self._round, self._call = (f'{name}.wait', f'{name}.round',
                                               f'{name}.call')
        self._q: 'queue.SimpleQueue[Entry]' = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, bucket_key: Hashable, payload, cause: int = 0) -> Future:
        """Queue ``payload``; ``cause``: the id of its request's span."""
        fut: Future = Future()
        self._q.put((bucket_key, payload, fut, tracing.stamp(cause), time.monotonic()))
        return fut

    def __call__(self, bucket_key: Hashable, payload):
        return self.submit(bucket_key, payload).result()

    def _collect(self, held: List[Entry]) -> Tuple[Dict[Hashable, List[Item]], List[Entry],
                                                   Optional[tracing.Span]]:
        """One round: the entries held over from the round before, or else
        one entry waited for; then everything queued, and arrivals until
        ``window_s`` after the first entry's submission (so a round whose
        first entry has waited that long only drains the queue).  In that
        order, each bucket's group takes up to ``max_batch`` entries and the
        rest is held over.  The groups, in the order of their oldest entry;
        the entries held over; the round's span (None when the tracer is
        off), whose ``carried`` counts the held-over entries the groups
        take."""
        pending = held or [self._q.get()]
        rnd = tracing.begin(self._round)
        n_held = len(held)
        deadline = pending[0][4] + self._win
        while True:
            left = deadline - time.monotonic()
            try:
                pending.append(self._q.get(timeout=left) if left > 0 else self._q.get_nowait())
            except queue.Empty:
                break
        groups: Dict[Hashable, List[Item]] = {}
        over: List[Entry] = []
        carried = 0
        for i, (key, payload, fut, stamped, _) in enumerate(pending):
            group = groups.setdefault(key, [])
            if len(group) < self._max:
                group.append((payload, fut, stamped))
                if i < n_held:
                    carried += 1
            else:
                over.append(pending[i])
        if rnd is not None:
            items = [it for g in groups.values() for it in g]
            rnd.set(submissions=len(items), groups=len(groups), carried=carried,
                    requests=[s[1] for _, _, s in items if s])
            tracing.end(rnd)
        return groups, over, rnd

    def _run(self, key: Hashable, items: List[Item], rnd: Optional[tracing.Span],
             solo: bool = False) -> Sequence:
        with tracing.span(self._call, rnd.id if rnd is not None else 0) as call:
            if call is not None:
                self._traced(call, key, items, rnd, solo)
            results = self._fn(key, [p for p, _, _ in items])
        if len(results) != len(items):
            raise RuntimeError(f'batch fn returned {len(results)} results '
                               f'for {len(items)} payloads')
        return results

    def _traced(self, call: tracing.Span, key: Hashable, items: List[Item],
                rnd: Optional[tracing.Span], solo: bool) -> None:
        """The call's numbers, and the wait of each payload it carries
        first (a solo retry carries none first)."""
        rid = rnd.id if rnd is not None else 0
        call.set(payloads=len(items), solo=int(solo), round=rid,
                 requests=[s[1] for _, _, s in items if s])
        if isinstance(key, int):
            call.set(bucket=key)
        if not solo:
            for _, _, s in items:
                if s:
                    tracing.record(self._wait, s, call.start, call=call.id, round=rid)

    def _loop(self):
        held: List[Entry] = []
        while True:
            groups, held, rnd = self._collect(held)
            for key, items in groups.items():
                try:
                    results = self._run(key, items, rnd)
                except Exception as e:                       # noqa: BLE001
                    if len(items) == 1:
                        items[0][1].set_exception(e)
                        continue
                    # one bad payload must not fail its cohort: retry alone
                    for item in items:
                        try:
                            item[1].set_result(self._run(key, [item], rnd, solo=True)[0])
                        except Exception as ee:              # noqa: BLE001
                            item[1].set_exception(ee)
                    continue
                for (_, f, _), r in zip(items, results):
                    f.set_result(r)


class BatchingFrontend:
    """Self-batching serving surface over a ``Synthesizer``.

    Two coalescing stages mirror the pipeline: acoustic (text bucket ->
    specs through ``synthesize_spec_batch``) and vocoder (frame bucket ->
    wavs through ``vocode_batch`` with content-seeded phases).  A ``tts``
    request goes through both.  ``solo`` runs any other call on the card on
    a third long-lived thread."""

    def __init__(self, synth: Synthesizer, max_batch: int = 8,
                 window_s: float = 0.006):
        self.synth = synth
        self.rows = max(1, int(max_batch))
        self._ac = Coalescer(self._run_acoustic, max_batch, window_s,
                             name='batch-acoustic')
        self._vo = Coalescer(self._run_vocode, max_batch, window_s,
                             name='batch-vocoder')
        self._worker = Coalescer(lambda _, calls: [call() for call in calls],
                                 max_batch=1, window_s=0.0, name='batch-worker')

    # -- bucket keys (must match the padding the surfaces compute) -------
    def _text_bucket(self, pinyin: str) -> int:
        n = frontend.serialize_inference(pinyin, self.synth.cfg.acoustic.g2p).shape[0]
        return _round_up(max(n, 1), self.synth.cfg.acoustic.text_bucket)

    def _frame_bucket(self, spec: np.ndarray) -> int:
        au = self.synth.cfg.audio
        t = spec.shape[1] if spec.shape[0] in (au.n_freq, au.n_freq - 1) else spec.shape[0]
        return _round_up(max(t, 64), 64)

    # -- dispatcher bodies ------------------------------------------------
    def _run_acoustic(self, bucket: int, pinyins: List[str]) -> List[np.ndarray]:
        return self.synth.synthesize_spec_batch(pinyins, rows=self.rows)

    def _run_vocode(self, bucket: int,
                    items: List[Tuple[np.ndarray, bytes]]) -> List[np.ndarray]:
        # generators are made here, so that a solo retry draws afresh
        gens = [self.synth.content_generator(data) for _, data in items]
        return self.synth.vocode_batch([s for s, _ in items], generators=gens,
                                       rows=self.rows)

    # -- public surfaces ---------------------------------------------------
    def solo(self, fn: Callable, *args):
        """``fn(*args)`` on the worker thread, alone."""
        return self._worker(None, functools.partial(fn, *args))

    def synth_spec(self, pinyin: str) -> np.ndarray:
        return self._ac(self._text_bucket(pinyin), pinyin)

    def vocode(self, spec: np.ndarray, content: Optional[bytes] = None) -> np.ndarray:
        """``content`` seeds the phase; by default the spec's bytes, so a
        client re-posting a payload gets the same audio.  Stages that
        compute the spec pass their request text instead: the spec's last
        bits may differ between cohorts, and a different seed would change
        the audio audibly."""
        spec = np.asarray(spec, np.float32)
        if content is None:
            content = np.ascontiguousarray(spec).tobytes()
        return self._vo(self._frame_bucket(spec), (spec, content))

    def _specs(self, clause_lists: List[List[str]],
               reqs: Sequence[tracing.Span] = ()) -> List[np.ndarray]:
        """Every clause submitted before any result is awaited, so that
        they coalesce; a text's clauses are concatenated in time.  ``reqs``:
        the texts' request spans (empty while the tracer is off)."""
        futs = [[self._ac.submit(self._text_bucket(p), p, reqs[i].id if reqs else 0)
                 for p in cl] for i, cl in enumerate(clause_lists)]
        specs = []
        for fs in futs:
            parts = [np.asarray(f.result(), np.float32) for f in fs]
            specs.append(parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1))
        return specs

    def tts(self, text: str) -> np.ndarray:
        """Text -> neural wav through both coalescing stages."""
        return self.tts_batch([text])[0]

    def tts_batch(self, texts: List[str], neural: bool = True) -> List[np.ndarray]:
        """Texts -> wavs, each as ``tts`` would give it (clauses synthesized
        one by one, then concatenated); Griffin-Lim synthesis runs on the
        worker.  Traced, each text is a ``request`` span, from the call to
        the return of every wav, and the cause of its submissions."""
        if not neural:
            return self.solo(self.synth.tts_batch, texts, False)
        reqs = tracing.begin_many('request', len(texts))
        try:
            clause_lists = [self.synth.clauses(t) for t in texts]
            specs = self._specs(clause_lists, reqs)
            wav_futs = [self._vo.submit(self._frame_bucket(s),
                                        (s, ' '.join(cl).encode('utf-8')),
                                        reqs[i].id if reqs else 0)
                        for i, (cl, s) in enumerate(zip(clause_lists, specs))]
            return [f.result() for f in wav_futs]
        finally:
            for r in reqs:
                tracing.end(r)

    def warm_up(self, text: str = 'ni3 hao3') -> None:
        """One request through each long-lived thread, so that no client's
        request pays for the thread's first call on the card."""
        self.tts(text)
        self.solo(self.synth.tts, text, False)
