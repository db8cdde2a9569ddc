"""Moving small values between the host and the device without stalling
the host's loop.

On the card a plain ``.cpu()``, ``.item()`` or ``bool(t)`` waits until
every kernel queued before it has run, and a plain upload from pageable
memory waits for the stream as well. The generation loops instead:

- upload host arrays through pinned memory, ``non_blocking``
  (:func:`upload`);
- pull a chunk's packed result into pinned memory when the chunk is
  dispatched and read it only when it is needed (:class:`Pull`: the one
  blocking read of an admission cycle);
- read each decode step's "go on" flag once the card has written it and
  never wait for it (:class:`StepFlags`), enqueueing steps ahead in the
  meantime; a step whose flag on the device is False changes nothing (the
  loops guard their updates with it), so a step enqueued past the stop
  only costs its device time.

On the CPU every value is known at once and nothing waits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def upload(array, device) -> torch.Tensor:
    """``array`` (numpy or a CPU tensor) on ``device``; to the card through
    pinned memory without waiting (the caching host allocator keeps the
    pinned buffer until the copy has run)."""
    t = torch.as_tensor(array)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Pull:
    """A device tensor's copy to the host, enqueued now and read later:
    :meth:`get` waits for it (one blocking read) on the card; on the CPU
    the tensor itself is the result."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class StepFlags:
    """The flags of one loop's steps, ``flag[j]``: whether step ``j`` takes
    effect. The loop pushes ``flag[0]`` before its first step and
    ``flag[j + 1]`` as step ``j`` ends. The flags are monotone (a step that
    takes no effect leaves the state, and so the next flag, as it was): the
    first False one, once read, says how many steps took effect.

    On the card a pushed flag is copied into a ring of pinned host memory
    and an event is recorded behind it; :meth:`poll` reads the flags whose
    events have completed, in order, and never waits; :meth:`wait` blocks
    for one (a blocking read, counted in :attr:`waits`). On the CPU a
    pushed flag is known at once.

    ``lockstep`` (the ranks of a mesh): :meth:`poll` reads nothing new, so
    the flags read, and with them the steps a loop enqueues, depend only on
    the loop's own :meth:`wait` calls and never on when a flag happened to
    complete: every rank enqueues the same steps and meets its peers in
    each collective.
    """

    RING = 64   # more than a loop ever leaves unread (its steps ahead)

    def __init__(self, device, lockstep: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.lockstep = lockstep
        if self.cuda:
            self._host = torch.zeros(self.RING, dtype=torch.bool,
                                     pin_memory=True)
            self._view = self._host.numpy()
            self._events = [torch.cuda.Event() for _ in range(self.RING)]
        self._base = 0
        self.waits = 0
        self.start()

    def start(self) -> None:
        """Begin a new loop: its flags count from 0."""
        self._base += getattr(self, "pushed", 0)
        self._cpu = []
        self.pushed = 0      # flags pushed
        self.read = 0        # leading flags read
        self.stop = None     # the index of the first False flag read

    def push(self, flag: torch.Tensor) -> None:
        """Enqueue ``flag`` (a 0-d bool tensor on the loop's device)."""
        if self.cuda:
            i = (self._base + self.pushed) % self.RING
            self._host[i].copy_(flag, non_blocking=True)
            self._events[i].record()
        else:
            self._cpu.append(bool(flag))
        self.pushed += 1

    def _ready(self) -> int:
        """How many of the pushed flags the host can read now without
        waiting (a prefix: the card completes them in order)."""
        if not self.cuda:
            return self.pushed
        n = self.read
        while n < self.pushed and \
                self._events[(self._base + n) % self.RING].query():
            n += 1
        return n

    def _take(self, n: int) -> None:
        for j in range(self.read, n):
            v = self._view[(self._base + j) % self.RING] if self.cuda \
                else self._cpu[j]
            if not v:
                self.stop = j
                break
        self.read = n

    def poll(self) -> Optional[int]:
        """Read the flags that are ready; the index of the first False
        flag, or None while none has been read."""
        if self.stop is None and not self.lockstep:
            self._take(self._ready())
        return self.stop

    def wait(self, n: int) -> Optional[int]:
        """Block until the first ``n`` flags are read; as :meth:`poll`."""
        if self.stop is None and self.read < n:
            self.waits += 1
            if self.cuda:
                self._events[(self._base + n - 1) % self.RING].synchronize()
            self._take(n)
        return self.stop

    def drain(self) -> None:
        """Block until every pushed flag is written (the loop's last step
        has run) and read them: the one blocking read at a loop's end."""
        if self.pushed:
            self.waits += 1
            if self.cuda:
                self._events[(self._base + self.pushed - 1)
                             % self.RING].synchronize()
            if self.stop is None:
                self._take(self.pushed)

    def effective(self, steps: int) -> int:
        """Of ``steps`` dispatched steps, how many are known to have taken
        effect: the first False flag's index, else the leading True flags
        read (all of them, once every flag is read)."""
        return min(steps, self.read if self.stop is None else self.stop)
