"""Background prefetch of host batches (a copy of
``vlm_tpu.data.pipeline.prefetch_batches``, so the batcher needs nothing
from ``vlm_tpu.data``): a producer thread builds batch i+1 while the device
works on batch i."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")
_SENTINEL = object()


def prefetch_batches(items: Sequence[Any],
                     make_batch: Callable[[Any], T],
                     depth: int = 2) -> Iterator[T]:
    """Yield ``make_batch(item)`` for each item, produced ``depth`` ahead on
    a background thread. Exceptions propagate to the consumer; abandoning
    the generator early stops the producer instead of leaving it blocked on
    a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: list = []
    stop = threading.Event()

    def producer():
        try:
            for it in items:
                batch = make_batch(it)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:       # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            out = q.get()
            if out is _SENTINEL:
                break
            yield out
    finally:
        stop.set()
        th.join()
    if err:
        raise err[0]
