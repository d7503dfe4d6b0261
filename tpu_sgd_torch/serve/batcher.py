"""Dynamic micro-batching request queue with admission control (the port
of ``tpu_sgd/serve/batcher.py``; host work only).

Single-row requests arrive at wire rate; the predict path wants
bucket-sized batches (``serve/engine.py``).  The batcher bridges the two
with the classic serving trade: coalesce queued requests into one batch
call, flushing when EITHER the batch is full OR the oldest queued request
has waited ``max_latency_s`` — so an idle endpoint still answers a lone
request within the deadline, and a saturated one amortizes the per-call
overhead across ``max_batch`` rows.  The flush thread runs every device op
of a batch; client threads do host work only.

Overload is a handled condition, not a latency cliff: reject at
admission, never at completion.  Every admission decision happens at
``submit`` time, under one lock, and a request that cannot be served
within its constraints is answered immediately with a typed
:class:`Overloaded` — never queued to rot, never silently dropped:

* **Priority lanes** — ``interactive`` > ``batch`` > ``shadow``
  (:data:`LANES`).  Every flush drains the interactive queue first, so
  a full batch lane cannot starve an interactive request by
  construction.
* **Deadline-aware early rejection** — a request submitted with a
  ``deadline_s`` budget that cannot cover the predicted wait (rolling
  p99 of recent batch walls × batches queued ahead) is rejected at
  enqueue with ``reason="deadline"``.  Once ADMITTED, a request is
  always answered, even if its slack goes negative while queued.
* **Utilization-triggered shedding** — when queue utilization crosses a
  lane's threshold (``ServingConfig.shed_utilization``: shadow sheds at
  50%, batch at 75%), NEW arrivals to that lane are rejected with
  ``reason="shed"`` while higher lanes keep admitting.
* **Displacement** — when the queue is FULL and a higher-priority
  request arrives, the newest queued request of the lowest queued lane
  is evicted (its future gets a typed ``reason="displaced"`` answer)
  and the arrival takes its slot; only when no lower-priority victim
  exists does the arrival itself get ``reason="queue_full"`` (the
  :class:`BackpressureError` contract — ``Overloaded`` subclasses it).

Admit/reject/shed/displace tallies per lane ride ``lane_counts``
(surfaced by ``Server.healthz``), the ``serve.admitted.<lane>`` /
``serve.rejected.<lane>`` / ``serve.shed.<lane>`` /
``serve.displaced.<lane>`` obs counters (displaced is its own bucket
because a displaced request was ALSO admitted), and the per-batch lane
composition on ``ServeBatchEvent.lanes``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from tpu_sgd_torch.obs.counters import inc as obs_inc
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.reliability.failpoints import failpoint
from tpu_sgd_torch.reliability.health import Heartbeat
from tpu_sgd_torch.serve.engine import stack_rows
from tpu_sgd_torch.serve.metrics import nearest_rank


#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the per-lane request queues, the stop flag, the admission tallies, and
#: the rolling flush-wall window are shared between client threads
#: (submit), the flush thread (_collect/_flush), and the lifecycle caller
#: (stop) — every touch must hold the condition's lock.
GRAFTLINT_LOCKS = {
    "MicroBatcher": {
        "_lanes": "_cond",
        "_stopped": "_cond",
        "_flush_walls": "_cond",
        "_p99_wall": "_cond",
        "lane_counts": "_cond",
        "shed_utilization": "_cond",
        "admission_lock_rounds": "_cond",
        "admission_priced": "_cond",
        "batch_count": "_cond",
        "reject_count": "_cond",
        "_thread": "_cond",
    },
}

#: priority lanes, HIGHEST first — the drain order of every flush and
#: the protection order of admission control (lower lanes shed first)
LANES = ("interactive", "batch", "shadow")

_LANE_PRIORITY = {lane: i for i, lane in enumerate(LANES)}

def _default_shed_utilization() -> Dict[str, float]:
    """Per-lane shed thresholds from the process :class:`ServingConfig`
    (``tpu_sgd_torch.config.serving_config``) — the control plane actuates
    these through config, never by monkey-patching a module constant.
    ``interactive`` is absent by default: it sheds only at
    queue-full-with-no-victim, the last line, so the premium lane
    degrades last."""
    from tpu_sgd_torch.config import serving_config

    return dict(serving_config().shed_utilization)


#: legacy alias — the historical constants now live in
#: ``ServingConfig``'s defaults; kept so pre-config callers (and tests
#: pinning the defaults) keep reading the same numbers
DEFAULT_SHED_UTILIZATION = {"batch": 0.75, "shadow": 0.50}


class BackpressureError(RuntimeError):
    """The serving queue is full; the request was rejected, not queued."""


class Overloaded(BackpressureError):
    """Typed admission rejection: the endpoint chose to answer this
    request with "no, now" instead of queueing it into a latency
    balloon.  ``reason`` says which admission rule fired:

    * ``"queue_full"`` — the bounded queue is full and no lower-priority
      victim exists (the legacy backpressure case);
    * ``"deadline"`` — the request's ``deadline_s`` budget cannot cover
      the predicted wait (p99 batch wall × batches ahead);
    * ``"shed"`` — queue utilization crossed this lane's shed threshold;
    * ``"displaced"`` — the request WAS queued, then evicted to make
      room for a higher-priority arrival under a full queue.

    Subclasses :class:`BackpressureError` so pre-lane callers that catch
    backpressure keep working unchanged.
    """

    def __init__(self, reason: str, lane: str, detail: str = ""):
        self.reason = reason
        self.lane = lane
        msg = f"request rejected at admission ({reason}, lane={lane!r})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class _Request:
    __slots__ = ("x", "future", "t_enqueue", "enqueue_depth", "lane",
                 "deadline_s")

    def __init__(self, x, lane: str = "interactive",
                 enqueue_depth: int = 0,
                 deadline_s: Optional[float] = None):
        self.x = x
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.lane = lane
        self.deadline_s = deadline_s
        #: queue depth THIS request saw at its own enqueue — the batch's
        #: oldest request's value rides the serve_batch event as the
        #: admission-control signal (sustained high depth at enqueue
        #: says shed load earlier)
        self.enqueue_depth = enqueue_depth


class MicroBatcher:
    """Bounded multi-lane request queue + background flush thread.

    ``predict_batch`` receives the stacked feature matrix of one coalesced
    batch and returns per-row predictions in order.  Requests submitted
    before :meth:`start` queue up and coalesce into the first flush —
    which is also what makes the coalescing behavior deterministic to
    test.

    ``shed_utilization`` maps lane -> utilization fraction at which NEW
    arrivals to that lane are shed (:data:`DEFAULT_SHED_UTILIZATION`
    when None; pass ``{}`` to disable threshold shedding entirely, e.g.
    for an A/B against the pure-backpressure legacy behavior).
    """

    def __init__(
        self,
        predict_batch: Callable,
        *,
        max_batch: int = 128,
        max_latency_s: float = 0.005,
        max_queue: int = 1024,
        metrics=None,
        padded_size_fn: Optional[Callable[[int], int]] = None,
        shed_utilization: Optional[Dict[str, float]] = None,
        wall_window: int = 64,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if max_latency_s < 0:
            raise ValueError(f"max_latency_s must be >= 0, got {max_latency_s}")
        self.predict_batch = predict_batch
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.padded_size_fn = padded_size_fn or (lambda n: n)
        self.shed_utilization = dict(
            _default_shed_utilization() if shed_utilization is None
            else shed_utilization)
        unknown = set(self.shed_utilization) - set(LANES)
        if unknown:
            raise ValueError(f"unknown shed_utilization lanes: {unknown}")
        self._lanes: Dict[str, deque] = {lane: deque() for lane in LANES}
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        #: rolling window of recent predict-call walls — the p99 the
        #: deadline admission rule prices a new request's wait against
        self._flush_walls: deque = deque(maxlen=int(wall_window))
        #: that window's p99, recomputed ONCE per flush (not per
        #: submit: sorting under the admission lock at wire rate would
        #: lengthen the very queue waits it prices); 0.0 while warming
        self._p99_wall = 0.0
        self.reject_count = 0
        self.batch_count = 0
        #: admission-cost ledger: ``admission_lock_rounds`` counts
        #: acquisitions of ``_cond`` for admission (one per
        #: :meth:`submit`, one per WHOLE :meth:`submit_burst`),
        #: ``admission_priced`` counts requests priced under them — the
        #: rounds/priced ratio is the per-request lock amortization the
        #: vectorized burst path exists to buy
        self.admission_lock_rounds = 0
        self.admission_priced = 0
        #: per-lane admission tallies: admitted / rejected (queue_full +
        #: deadline) / shed (threshold sheds, never admitted) /
        #: displaced (admitted, then evicted) — the healthz scrape
        #: surface, mutated only under ``_cond``
        self.lane_counts: Dict[str, Dict[str, int]] = {
            lane: {"admitted": 0, "rejected": 0, "shed": 0,
                   "displaced": 0}
            for lane in LANES
        }
        #: ticked once per flushed batch — register with a
        #: ``reliability.HealthMonitor`` to flag a wedged flush thread
        #: as a straggler (reliability/health.py)
        self.heartbeat = Heartbeat("serve.batcher")

    # -- client side -------------------------------------------------------
    def submit(self, x, lane: str = "interactive",
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one feature row; resolves to its prediction.

        ``lane`` picks the priority lane (:data:`LANES`); ``deadline_s``
        is the request's REMAINING latency budget at enqueue — when the
        endpoint predicts it cannot answer within it, the request is
        rejected now (``Overloaded(reason="deadline")``) instead of
        being queued past its own usefulness.  Raises
        :class:`Overloaded` (a :class:`BackpressureError`) on any
        admission rejection.

        Passes the ``serve.admit`` failpoint FIRST — before any queue
        mutation or tally, so a retry after a healed admission fault
        replays nothing twice — then the legacy
        ``serve.batcher.enqueue`` site (pre-lane fault injection).
        """
        if lane not in _LANE_PRIORITY:
            raise ValueError(f"unknown lane {lane!r}; expected one of {LANES}")
        failpoint("serve.admit")
        failpoint("serve.batcher.enqueue")
        victim: Optional[_Request] = None
        with self._cond:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self.admission_lock_rounds += 1
            self.admission_priced += 1
            depth = sum(len(q) for q in self._lanes.values())
            thr = self.shed_utilization.get(lane)
            if thr is not None and depth >= thr * self.max_queue:
                raise self._reject_locked(
                    "shed", lane,
                    f"utilization {depth}/{self.max_queue} >= {thr:.0%}")
            if deadline_s is not None:
                # lane-aware: only requests that will board BEFORE this
                # one (its own lane and higher) are ahead of it — a
                # standing low-priority backlog must not scare a
                # premium request into rejecting itself
                depth_ahead = sum(
                    len(self._lanes[ln]) for ln in LANES
                    if _LANE_PRIORITY[ln] <= _LANE_PRIORITY[lane])
                predicted = self._predicted_wait_locked(depth_ahead)
                if predicted > 0.0 and deadline_s < predicted:
                    raise self._reject_locked(
                        "deadline", lane,
                        f"budget {deadline_s * 1e3:.1f}ms < predicted "
                        f"wait {predicted * 1e3:.1f}ms")
            if depth >= self.max_queue:
                victim = self._pop_victim_locked(lane)
                if victim is None:
                    raise self._reject_locked(
                        "queue_full", lane,
                        f"{self.max_queue} pending, no lower-priority "
                        "victim")
                # the victim's tally is a displacement of ITS lane —
                # a separate bucket from submit-time sheds, because the
                # victim was ALSO admitted and a shared bucket would
                # double-count it in any offered-requests denominator
                # (recorded here, under the lock; its future is
                # answered below, outside it)
                self.lane_counts[victim.lane]["displaced"] += 1
                self.reject_count += 1
                obs_inc("serve.reject")
                obs_inc(f"serve.displaced.{victim.lane}")
                if self.metrics is not None:
                    try:
                        self.metrics.record_reject(lane=victim.lane,
                                                   reason="displaced")
                    except Exception:
                        logging.getLogger(
                            "tpu_sgd_torch.serve.batcher").warning(
                            "serving metrics raised on displace; "
                            "dropped", exc_info=True)
            req = _Request(x, lane=lane, enqueue_depth=depth,
                           deadline_s=deadline_s)
            self._lanes[lane].append(req)
            self.lane_counts[lane]["admitted"] += 1
            obs_inc(f"serve.admitted.{lane}")
            self._cond.notify_all()
        if victim is not None:
            self._answer_displaced(victim)
        return req.future

    def submit_burst(self, xs, lane: str = "interactive",
                     deadline_s: Optional[float] = None) -> List[Future]:
        """Admit a whole arrival burst under ONE lock round: the shed,
        deadline, and capacity rules are priced for every position of
        the burst in one numpy pass, then the queue mutates once —
        instead of ``len(xs)`` per-request lock round-trips through
        :meth:`submit` (the ``admission_lock_rounds`` /
        ``admission_priced`` ledger counts the difference).

        Decision-equivalent to submitting the rows one by one: each
        admission rule's predicate is monotone in the number of earlier
        admissions from the same burst, so the burst splits into an
        admitted prefix and a rejected tail labeled by whichever rule
        fires first at the boundary.  Displacement is folded in the same
        way — every victim a full queue owes the burst is popped under
        the one lock and answered afterwards, batched.

        Returns one :class:`~concurrent.futures.Future` per row, in
        order.  Rejected rows get a future with the typed
        :class:`Overloaded` already set (never a raise — a burst is not
        all-or-nothing), so callers handle both outcomes through the
        same future interface.
        """
        if lane not in _LANE_PRIORITY:
            raise ValueError(f"unknown lane {lane!r}; expected one of {LANES}")
        n = len(xs)
        if n == 0:
            return []
        failpoint("serve.admit")
        failpoint("serve.batcher.enqueue")
        victims: List[_Request] = []
        with self._cond:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self.admission_lock_rounds += 1
            self.admission_priced += n
            depth = sum(len(q) for q in self._lanes.values())
            # -- one numpy pass: admissible prefix length per rule ------
            # each predicate is monotone in the count of earlier burst
            # admissions (depth and depth_ahead only grow), so "first
            # failing position" fully determines the split
            a_shed = n
            thr = self.shed_utilization.get(lane)
            if thr is not None:
                # position a is shed when depth + a >= thr * max_queue
                a_shed = int(np.clip(
                    np.ceil(thr * self.max_queue - depth), 0, n))
            a_deadline = n
            if deadline_s is not None and self._p99_wall > 0.0:
                depth_ahead = sum(
                    len(self._lanes[ln]) for ln in LANES
                    if _LANE_PRIORITY[ln] <= _LANE_PRIORITY[lane])
                predicted = self._p99_wall * (
                    1 + (depth_ahead + np.arange(n)) // self.max_batch)
                ok = deadline_s >= predicted
                a_deadline = n if bool(ok.all()) else int(np.argmin(ok))
            admit = min(a_shed, a_deadline)
            # -- capacity: pop every owed victim under this same lock ---
            free = self.max_queue - depth
            need_victims = max(0, admit - max(0, free))
            for _ in range(need_victims):
                v = self._pop_victim_locked(lane)
                if v is None:
                    break
                victims.append(v)
            admit = min(admit, max(0, free) + len(victims))
            # -- mutate the queue once ----------------------------------
            reqs = [_Request(x, lane=lane, enqueue_depth=depth,
                             deadline_s=deadline_s) for x in xs]
            if admit:
                self._lanes[lane].extend(reqs[:admit])
                self.lane_counts[lane]["admitted"] += admit
                obs_inc(f"serve.admitted.{lane}", admit)
            # -- batched tallies for the rejected tail ------------------
            rejected = n - admit
            if rejected:
                if admit < min(a_shed, a_deadline):
                    reason = "queue_full"
                    detail = (f"{self.max_queue} pending, no lower-"
                              "priority victim")
                elif a_shed <= a_deadline:
                    reason = "shed"
                    detail = (f"utilization >= {thr:.0%} of "
                              f"{self.max_queue}")
                else:
                    reason = "deadline"
                    detail = (f"budget {deadline_s * 1e3:.1f}ms < "
                              "predicted wait")
                bucket = "shed" if reason == "shed" else "rejected"
                self.lane_counts[lane][bucket] += rejected
                self.reject_count += rejected
                obs_inc("serve.reject", rejected)
                obs_inc(f"serve.{bucket}.{lane}", rejected)
            if victims:
                for v in victims:
                    self.lane_counts[v.lane]["displaced"] += 1
                    obs_inc(f"serve.displaced.{v.lane}")
                self.reject_count += len(victims)
                obs_inc("serve.reject", len(victims))
            if admit:
                self._cond.notify_all()
        # answer victims and settle rejected futures OUTSIDE the lock
        # (future callbacks run synchronously in this thread)
        for v in victims:
            self._answer_displaced(v)
            if self.metrics is not None:
                try:
                    self.metrics.record_reject(lane=v.lane,
                                               reason="displaced")
                except Exception:
                    logging.getLogger("tpu_sgd_torch.serve.batcher").warning(
                        "serving metrics raised on displace; dropped",
                        exc_info=True)
        for r in reqs[admit:]:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(Overloaded(reason, lane, detail))
            if self.metrics is not None:
                try:
                    self.metrics.record_reject(lane=lane, reason=reason)
                except Exception:
                    logging.getLogger("tpu_sgd_torch.serve.batcher").warning(
                        "serving metrics raised on reject; dropped",
                        exc_info=True)
        return [r.future for r in reqs]

    def set_shed_utilization(self, thresholds: Dict[str, float]) -> None:
        """Actuate the per-lane shed thresholds on a RUNNING batcher —
        the control-plane hook.  Validates like the
        constructor; replaces the whole mapping atomically under the
        admission lock, so no submit ever sees a half-updated policy."""
        unknown = set(thresholds) - set(LANES)
        if unknown:
            raise ValueError(f"unknown shed_utilization lanes: {unknown}")
        for ln, thr in thresholds.items():
            if not (0.0 < float(thr) <= 1.0):
                raise ValueError(
                    f"shed_utilization[{ln!r}] must be in (0, 1], got {thr}")
        with self._cond:
            self.shed_utilization = dict(thresholds)

    def admission_snapshot(self) -> dict:
        """The admission-cost ledger: lock rounds taken vs requests
        priced under them (rounds == priced means pure per-request
        admission; rounds << priced means bursts are amortizing)."""
        with self._cond:
            return {"lock_rounds": self.admission_lock_rounds,
                    "priced": self.admission_priced}

    def _reject_locked(self, reason: str, lane: str,
                       detail: str) -> Overloaded:
        """Build the typed rejection and record it (caller holds
        ``_cond`` and raises the returned exception)."""
        bucket = "shed" if reason == "shed" else "rejected"
        self.lane_counts[lane][bucket] += 1
        self.reject_count += 1
        obs_inc("serve.reject")
        obs_inc(f"serve.{'shed' if reason == 'shed' else 'rejected'}.{lane}")
        if self.metrics is not None:
            try:
                self.metrics.record_reject(lane=lane, reason=reason)
            except Exception:
                logging.getLogger("tpu_sgd_torch.serve.batcher").warning(
                    "serving metrics raised on reject; dropped",
                    exc_info=True)
        return Overloaded(reason, lane, detail)

    def _predicted_wait_locked(self, depth: int) -> float:
        """What a request admitted NOW should expect to wait: the rolling
        p99 batch wall times the number of batches ahead of it (the
        depth that will board before it / max_batch, plus its own).
        Returns 0.0 until the window holds enough samples — a cold
        endpoint (whose first flushes pay one-off set-up) must not reject its
        warm-up traffic on them."""
        return self._p99_wall * (1 + depth // self.max_batch)

    def _pop_victim_locked(self, lane: str) -> Optional[_Request]:
        """Under a FULL queue, find the request to displace for an
        arrival on ``lane``: the NEWEST queued request of the
        lowest-priority non-empty lane strictly below ``lane`` (newest =
        least sunk wait, so the eviction wastes the least already-paid
        latency).  None when no strictly-lower lane has anything."""
        for victim_lane in reversed(LANES):
            if _LANE_PRIORITY[victim_lane] <= _LANE_PRIORITY[lane]:
                return None
            q = self._lanes[victim_lane]
            if q:
                return q.pop()
        return None

    @staticmethod
    def _answer_displaced(victim: _Request) -> None:
        """Answer an evicted request with its typed rejection — OUTSIDE
        the lock (Future callbacks run synchronously in the caller).  A
        client that already cancelled simply keeps its cancellation."""
        if victim.future.set_running_or_notify_cancel():
            victim.future.set_exception(Overloaded(
                "displaced", victim.lane,
                "evicted for a higher-priority arrival under a full "
                "queue"))

    def predict(self, x, timeout: Optional[float] = None, *,
                lane: str = "interactive",
                deadline_s: Optional[float] = None):
        """Blocking single-row convenience wrapper around :meth:`submit`."""
        return self.submit(x, lane=lane, deadline_s=deadline_s).result(timeout)

    @property
    def queue_depth(self) -> int:
        # racy by design: an ops-probe sample of deques whose len() is
        # itself atomic under the GIL — taking the lock here would make
        # every healthz scrape contend with the flush thread
        return sum(len(q) for q in self._lanes.values())  # graftlint: disable=lock-discipline -- atomic snapshot for ops probes; deque lens are GIL-atomic

    def p99_batch_wall_s(self) -> float:
        """Rolling p99 of recent predict-call walls — the number the
        deadline admission rule prices against (0.0 while warming)."""
        with self._cond:
            return self._p99_wall

    def lane_snapshot(self) -> dict:
        """Per-lane ops snapshot: admission tallies + current depth."""
        with self._cond:
            return {
                lane: {**self.lane_counts[lane],
                       "depth": len(self._lanes[lane])}
                for lane in LANES
            }

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._cond:
            # the whole check-then-spawn under the lock: two concurrent
            # start() calls must never each see _thread None and spawn
            # two flush threads over one queue, and a submit() racing a
            # restart must see either the stopped batcher or the
            # restarted one, never a torn flag
            if self._thread is not None:
                return self
            self._stopped = False
            t = self._thread = threading.Thread(
                target=self._run, name="tpu-sgd-serve-batcher",
                daemon=True
            )
        t.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the flush thread; with ``drain`` (default) queued requests
        are answered first, otherwise they fail with CancelledError."""
        with self._cond:
            if self._stopped and self._thread is None:
                return
            self._stopped = True
            if not drain:
                for q in self._lanes.values():
                    while q:
                        q.popleft().future.cancel()
            self._cond.notify_all()
            t = self._thread  # snapshot under the lock; join OUTSIDE it
        if t is not None:
            t.join(timeout=10.0)
            if t.is_alive():
                # flush wedged (a first batch on a slow host, an NFS
                # checkpoint scan): keep the handle so a restart cannot
                # spawn a SECOND flush thread over the same queue, and
                # fail loudly instead of silently stranding futures
                raise RuntimeError(
                    "flush thread did not stop within 10s (a batch is "
                    "still in flight); call stop() again to re-join"
                )
            with self._cond:
                self._thread = None
        elif drain:
            # never started: no flush thread exists to honor the drain
            # promise, so drain synchronously here — a waiter blocked on
            # fut.result() must not hang forever
            while True:
                collected = self._collect()
                if collected is None:
                    break
                batch, slack = collected
                if batch:
                    self._flush(batch, slack)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- flush thread ------------------------------------------------------
    def _run(self):
        while True:
            collected = self._collect()
            if collected is None:
                return
            batch, slack = collected
            if batch:
                self._flush(batch, slack)

    def _oldest_locked(self) -> Optional[_Request]:
        """The oldest queued request across every lane (the flush
        deadline anchor); None when all lanes are empty."""
        heads = [q[0] for q in self._lanes.values() if q]
        if not heads:
            return None
        return min(heads, key=lambda r: r.t_enqueue)

    def _collect(self):
        """Block until a flushable batch exists: full, past the oldest
        request's deadline, or stopping (drain).  None means exit;
        otherwise ``(batch, deadline_slack_s)`` — the slack is how much
        of the oldest request's deadline remained when the batch was
        actually taken (negative = the deadline was missed by that
        much: a saturated predict call or a scheduling stall).

        The batch drains lanes in priority order — ALL queued
        interactive requests board before the first batch-lane one,
        which before the first shadow one — so a flood on a low lane
        cannot starve a high one by construction."""
        with self._cond:
            while self._oldest_locked() is None and not self._stopped:
                # untimed: submit() and stop() both notify, so a timeout
                # here would only wake an idle endpoint for nothing
                self._cond.wait()
            oldest = self._oldest_locked()
            if oldest is None:
                return None  # stopped and drained
            deadline = oldest.t_enqueue + self.max_latency_s
            while (
                sum(len(q) for q in self._lanes.values()) < self.max_batch
                and not self._stopped
            ):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            # slack measured when the batch is TAKEN (the flush decision
            # point): a full batch flushes early with positive slack, a
            # deadline flush reads ~0, and a stalled flush thread goes
            # negative by exactly the miss
            slack = deadline - time.perf_counter()
            batch = []
            for lane in LANES:  # priority drain order
                q = self._lanes[lane]
                room = self.max_batch - len(batch)
                if room <= 0:
                    break
                if len(q) <= room:
                    # batched drain: take the whole lane in one extend +
                    # clear instead of a per-item popleft loop — the
                    # common saturated case moves max_batch requests with
                    # O(lanes) python-level operations under the lock
                    batch.extend(q)
                    q.clear()
                else:
                    batch.extend(q.popleft() for _ in range(room))
            # claim each future NOW (running state): a client cancel() from
            # here on fails instead of racing set_result into an
            # InvalidStateError that would kill the flush thread; already-
            # cancelled requests are dropped from the batch
            return [
                r for r in batch
                if r.future.set_running_or_notify_cancel()
            ], slack

    def _flush(self, batch: List[_Request], deadline_slack_s: float = 0.0):
        t_done = None
        sp = span("serve.batch", batch=len(batch))
        t_predict = time.perf_counter()
        try:
            with sp:
                X = stack_rows([r.x for r in batch])
                out = self.predict_batch(X)
            t_done = time.perf_counter()
        except Exception as e:  # one bad row fails its batch, not the server
            for r in batch:
                r.future.set_exception(e)
            return
        with self._cond:
            # feed the deadline-admission predictor: the wall of THIS
            # predict call (stack + score + result fetch),
            # and recompute the window p99 once per flush — submit()
            # then reads it lock-cheap at wire rate
            self._flush_walls.append(t_done - t_predict)
            if len(self._flush_walls) >= 8:
                self._p99_wall = nearest_rank(
                    sorted(self._flush_walls), 99)
            self.batch_count += 1
            # snapshot for the metrics record below: the tally is read
            # outside the lock, and an unlocked read races every
            # admission-path increment
            reject_count = self.reject_count
        self.heartbeat.beat()
        for i, r in enumerate(batch):
            r.future.set_result(out[i])
        if self.metrics is not None:
            lanes: Dict[str, dict] = {}
            for r in batch:
                st = lanes.setdefault(r.lane,
                                      {"n": 0, "max_latency_s": 0.0})
                st["n"] += 1
                st["max_latency_s"] = max(st["max_latency_s"],
                                          t_done - r.t_enqueue)
            try:
                self.metrics.record_batch(
                    # graftlint: disable=lock-discipline -- metrics sample only; GIL-atomic lens, a stale depth is fine
                    queue_depth=sum(len(q) for q in self._lanes.values()),
                    batch_size=len(batch),
                    padded_size=self.padded_size_fn(len(batch)),
                    latencies=[t_done - r.t_enqueue for r in batch],
                    reject_count=reject_count,
                    enqueue_depth=batch[0].enqueue_depth,
                    deadline_slack_s=deadline_slack_s,
                    lanes=lanes,
                )
            except Exception:  # observability must never kill serving
                logging.getLogger("tpu_sgd_torch.serve.batcher").warning(
                    "serving metrics/listener raised; event dropped",
                    exc_info=True,
                )
