"""Host-to-device batch pipeline of the trainers: a thread copies each
batch to the card (pinned memory, ``non_blocking``, its own CUDA stream)
while the previous step runs."""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch


def _narrow(t: torch.Tensor, wire_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if wire_dtype is not None and t.dtype == torch.float32:
        return t.to(wire_dtype)
    return t


def device_batches(loader, device: torch.device, depth: int = 2,
                   wire_dtype: Optional[torch.dtype] = None):
    """Batches of ``loader`` (dicts of numpy arrays) as tensors on
    ``device``, copied by a thread up to ``depth`` batches ahead (on the
    card: pinned host memory, a side stream, ``non_blocking``); a loader
    error is raised here.  ``wire_dtype`` (float16 or bfloat16) narrows
    the float32 arrays on the host before the copy; the consumer widens
    them on the device."""
    q: 'queue.Queue' = queue.Queue(max(1, depth))
    done = object()
    stop = threading.Event()
    cuda = device.type == 'cuda'
    stream = torch.cuda.Stream(device) if cuda else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in loader:
                host = {k: _narrow(torch.from_numpy(np.asarray(v)), wire_dtype)
                        for k, v in b.items()}
                if cuda:
                    with torch.cuda.stream(stream):
                        out = {k: v.pin_memory().to(device, non_blocking=True)
                               for k, v in host.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    item = (out, ready)
                else:
                    item = (host, None)
                if not put(item):
                    return
            put(done)
        except BaseException as e:               # surfaces in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if cuda:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ready)
                for v in batch.values():
                    v.record_stream(cur)
            yield batch
    finally:
        stop.set()
        t.join(timeout=10)
