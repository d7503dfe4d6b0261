"""Bounded-lookahead background producer and the pinned staging ring: the
port of ``tpu_sgd/io/prefetch.py``.

:class:`Prefetcher` runs ``producer(item)`` on one worker thread while the
consumer thread drives the card: host assembly of item ``j+1`` (slice,
gather, pad, wire cast, checksum) and its host->device copy overlap item
``j``'s kernels.  Semantics the consumers rely on, as in the JAX package:

* ORDER: one worker thread, FIFO submission, results in item order.
* EXCEPTIONS: a producer error re-raises at the consumer's ``next()`` for
  exactly that item; the prefetcher then closes itself.
* BOUNDED STAGING: at most ``depth`` items are materialized at once,
  INCLUDING the one the consumer holds (the default 2 = one consumed +
  one in flight).
* ``depth <= 1``: synchronous passthrough (no thread), the exact serial
  loop, kept for bitwise A/B tests.

Every producer call passes the ``io.prefetch.produce`` failpoint inside
the optional ``retry_policy``'s scope, so a transient fault heals in
place.  An optional ``heartbeat`` (``reliability.health.Heartbeat``)
beats once per produced item, after the producer returns: a wedged feed
stops beating, which the heartbeat-stall detector (``obs/detect.py``)
sees while its peers beat on.

:class:`PinnedRing` holds the staging memory of such a stream: ``depth``
slots of host buffers, page-locked on the card's host (never the whole
dataset: a slot holds one batch), and per slot two CUDA events.  The
worker fills slot ``j % depth`` and issues its copies to the card on a
side stream (``copy_(non_blocking=True)``), then records the slot's
READY event; the consumer makes its stream wait on READY, runs the step
that reads the slot's device buffers, and records the slot's FREE event
right after it.  The worker refills a slot only after FREE has completed
on the card, because overwriting the pinned buffer or the device buffer
while the last step still reads it is the classic bug of this design.
The ordering that makes this sound: the consumer records FREE for item
``j`` before it asks the prefetcher for item ``j+1``, and only that call
submits item ``j+depth`` (the next user of the slot) to the worker.
On the CPU a slot is one pageable buffer set that the step reads
directly, and the events are not needed (the step runs synchronously).

With tracing on (``obs.spans.enable_tracing``) the ring reports what it
costs: an ``ingest.ring`` event with its pinned bytes when it is made,
and an ``ingest.h2d`` event (``bytes``, the card's ``ms`` between two
timing events around the copies on the side stream) for each send, once
the copies are known to be done: when the slot is claimed again, or at
:meth:`PinnedRing.drain`.  So at most one pair of timing events a slot is
pending.  Tracing off, the ring records no timing events.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, \
    TypeVar

import torch

from tpu_sgd_torch.obs import spans
from tpu_sgd_torch.obs.spans import event, span
from tpu_sgd_torch.reliability.failpoints import failpoint

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: EMPTY on purpose.  The prefetcher's mutable state is touched only from
#: the consumer thread; the worker receives work through executor
#: submission and answers through Futures.  A ring slot is written by the
#: worker only between the consumer's FREE record and its READY wait (see
#: the module docstring), so the ring needs no lock either.
GRAFTLINT_LOCKS: dict = {}

T = TypeVar("T")
R = TypeVar("R")


def _on_card(card: Optional[int]) -> None:
    """A worker thread's start: make ``card`` its current card."""
    if card is not None:
        torch.cuda.set_device(card)


class Prefetcher:
    """Iterate ``producer(item) for item in items`` with background
    lookahead.  Use as an iterator; call :meth:`close` (or leave a
    ``with`` block) to cancel outstanding work on early exit."""

    def __init__(self, producer: Callable[[T], R], items: Iterable[T],
                 depth: int = 2, *, retry_policy=None, heartbeat=None):
        if int(depth) < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self._producer = producer
        self._retry_policy = retry_policy
        self._heartbeat = heartbeat
        self._items = iter(items)
        self._depth = int(depth)
        self._pending = collections.deque()
        self._pool = None
        self._exhausted = False
        if self._depth > 1:  # <=1: serial, one item live at a time
            # the worker runs on the consumer's card: a thread's current
            # card is its own (the first, unless it sets one), and a
            # producer that makes a tensor, a pinned buffer or a stream
            # switch on "cuda" must not land on (or set up) another card
            card = (torch.cuda.current_device()
                    if torch.cuda.is_initialized() else None)
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tpu-sgd-torch-ingest",
                initializer=_on_card, initargs=(card,))
            self._fill()

    def _run_producer(self, item: T) -> R:
        """One produce, through the failpoint (inside the retry scope, so
        an injected one-shot fault is healed by the retry), then one beat
        of the heartbeat."""
        def attempt():
            failpoint("io.prefetch.produce")
            return self._producer(item)

        with span("ingest.produce"):
            if self._retry_policy is not None:
                out = self._retry_policy.call(attempt)
            else:
                out = attempt()
        if self._heartbeat is not None:
            self._heartbeat.beat()
        return out

    def _fill(self) -> None:
        # pending is capped at depth-1: the consumer's in-hand item plus
        # the pending window stay within the depth-item staging budget
        cap = self._depth - 1
        while not self._exhausted and len(self._pending) < cap:
            try:
                item = next(self._items)
            except StopIteration:
                self._exhausted = True
                return
            self._pending.append(self._pool.submit(self._run_producer, item))

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> R:
        if self._depth <= 1:  # synchronous passthrough
            return self._run_producer(next(self._items))
        if self._pool is None:
            raise StopIteration  # closed
        if not self._pending:
            self.close()
            raise StopIteration
        fut = self._pending.popleft()
        self._fill()  # keep the lookahead window full while we wait
        try:
            return fut.result()
        except BaseException:
            # the future holds the exception, whose traceback holds this
            # frame: drop it, or the cycle keeps the caller's frames (and
            # their device buffers) alive until the garbage collector runs
            del fut
            self.close()
            raise

    def close(self) -> None:
        """Cancel queued work and release the worker.  Idempotent; the
        in-flight producer call (if any) is waited for, so that no copy
        into a staging slot outlives the run that owns the slot.  The
        producer is let go of: it often holds its owner (and the owner
        this prefetcher), a cycle that would keep the staging buffers
        alive until the next garbage collection."""
        pool, self._pool = self._pool, None
        self._pending.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        self._producer = None
        self._items = iter(())
        self._exhausted = True

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def ring_slots(depth: int) -> int:
    """Staging slots for a prefetch ``depth``: one per item live at once
    (the synchronous depths 0 and 1 hold one)."""
    return max(1, int(depth))


class PinnedRing:
    """``slots`` staging slots, each a set of named host buffers (pinned
    when ``device`` is a CUDA device), the device buffers the caller
    copies them to, and the slot's READY and FREE events (see the module
    docstring).  ``specs`` maps a name to ``(shape, dtype)``; ``device_specs``
    names device-only buffers (filled on the card, e.g. a transposed
    CSR), default none.  ``device_buffers=False`` allocates no device
    side: the caller copies each slot to destinations of its own."""

    def __init__(self, specs: Dict[str, Tuple[Sequence[int], torch.dtype]],
                 slots: int, device: torch.device,
                 device_specs: Optional[Dict] = None,
                 device_buffers: bool = True):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = int(slots)
        pin = self.cuda
        self.host = [{name: torch.empty(tuple(shape), dtype=dt,
                                        pin_memory=pin)
                      for name, (shape, dt) in specs.items()}
                     for _ in range(self.slots)]
        if not device_buffers:
            self.dev = [{} for _ in range(self.slots)]
        elif self.cuda:
            self.dev = [{name: torch.empty(tuple(shape), dtype=dt,
                                           device=self.device)
                         for name, (shape, dt) in specs.items()}
                        for _ in range(self.slots)]
        else:
            self.dev = self.host
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        for slot in self.dev:
            for name, (shape, dt) in (device_specs or {}).items():
                slot[name] = torch.empty(tuple(shape), dtype=dt,
                                         device=self.device)
        self._ready = [None] * self.slots
        self._free = [None] * self.slots
        self._timed = [None] * self.slots  # (start, stop, bytes) a slot
        event("ingest.ring", pinned_bytes=self.pinned_bytes)

    @property
    def pinned_bytes(self) -> int:
        """Bytes of page-locked host memory the ring holds (0 on the
        CPU)."""
        if not self.cuda:
            return 0
        return sum(t.numel() * t.element_size()
                   for slot in self.host for t in slot.values())

    def claim(self, slot: int) -> dict:
        """Worker side: wait until the last step that read ``slot`` has
        finished on the card, then hand out its host buffers."""
        ev = self._free[slot]
        if ev is not None:
            ev.synchronize()
        self._report_copy(slot)
        return self.host[slot]

    def _report_copy(self, slot: int) -> None:
        """The ``ingest.h2d`` event of the slot's last timed send, whose
        copies are done (its FREE event, or the side stream, completed)."""
        timed, self._timed[slot] = self._timed[slot], None
        if timed is not None:
            start, stop, nbytes = timed
            event("ingest.h2d", bytes=nbytes, ms=start.elapsed_time(stop))

    def send(self, slot: int, copies: Sequence[Tuple[torch.Tensor,
                                                     torch.Tensor]] = (),
             after: Optional[Callable[[], None]] = None) -> None:
        """Worker side: issue ``dst.copy_(src)`` for each pair on the side
        stream (host->device from pinned memory asynchronous), then
        ``after()`` on the same stream (device work on the staged data),
        then record the slot's READY event.  On the CPU the copies run
        inline.  With tracing on, the copies are timed on the card (see
        the module docstring)."""
        if not self.cuda:
            for dst, src in copies:
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            if after is not None:
                after()
            return
        timed = spans.is_enabled() and bool(copies)
        with torch.cuda.stream(self.stream):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
            for dst, src in copies:
                dst.copy_(src, non_blocking=True)
            if timed:
                stop.record(self.stream)
                self._timed[slot] = (start, stop, sum(
                    src.numel() * src.element_size() for _, src in copies))
            if after is not None:
                after()
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._ready[slot] = ev

    def take(self, slot: int) -> dict:
        """Consumer side: the current stream waits for the slot's copies;
        returns its device buffers."""
        ev = self._ready[slot]
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return self.dev[slot]

    def release(self, slot: int) -> None:
        """Consumer side: record, after the work just queued on the
        current stream (the step that read the slot), the event the
        worker waits for before it refills the slot."""
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._free[slot] = ev

    def drain(self) -> None:
        """Wait for every copy the ring issued (the end of a run)."""
        if self.cuda:
            self.stream.synchronize()
            for slot in range(self.slots):
                self._report_copy(slot)
