"""Elastic fleet membership: who is in, who died, who came back (the
port of ``tpu_sgd/replica/membership.py``; pure host code).

The async design's second half (the first is the staleness contract):
replica workers are EXPECTED to die — preemptible VMs, injected faults,
stragglers evicted by an operator — and the fleet must keep training
while they are gone and absorb them when they return.  This module is
the driver's bookkeeping for that churn:

* a :class:`WorkerRecord` per worker — shard index, join/failure
  counts, last error, and a ``reliability.Heartbeat`` the worker ticks
  once per pull-compute-push cycle (the straggler probe; a
  ``HealthMonitor`` can watch it via :meth:`heartbeats`);
* join / leave / rejoin transitions emitted as ``replica.join`` /
  ``replica.leave`` / ``replica.rejoin`` trace events
  (``tpu_sgd_torch.obs``) and as ``ReliabilityEvent`` records on the run's listener — the soak
  report's evidence that elasticity actually happened;
* store **failover** records (:meth:`ReplicaMembership.failover` —
  old primary, new primary, epoch, log gap replayed) alongside the
  worker churn, emitted as ``replica.failover`` events fanned through
  ``timeseries.EVENT_FANOUT`` — the straggler detector
  (``obs/detect.py``) reads the failover window as a deficit reset, so
  a promotion's fleet-wide stall never false-trips a worker that was
  merely re-routing, and the failover detector trips on it;
* :meth:`stragglers` — workers whose heartbeat age exceeds a stall
  bound (observation only: eviction policy belongs to the caller, the
  same observe-don't-kill split as ``reliability/health.py``).

Membership does NOT own the τ=0 barrier's active set — that lives in
the store under the store's own lock (the barrier must re-check
atomically with inbox state).  The driver wires the two: every join
calls ``store.register_worker``, every leave
``store.deregister_worker``, so a death can never stall a synchronous
round (``tests/test_torch_replica.py`` kills one mid-run to prove it).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from tpu_sgd_torch.obs.spans import event
from tpu_sgd_torch.reliability.health import Heartbeat
from tpu_sgd_torch.utils.events import ReliabilityEvent

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the record table is mutated by dying worker threads (leave) and the driver's
#: monitor thread (join/rejoin) concurrently.
GRAFTLINT_LOCKS = {
    "ReplicaMembership": {
        "_workers": "_lock",
        "_failovers": "_lock",
    },
}


@dataclasses.dataclass
class WorkerRecord:
    """One worker's membership state.  ``joins > 1`` means it rejoined
    after a death; ``failures`` counts the deaths."""

    worker_id: str
    shard_index: int
    status: str = "active"  # "active" | "left"
    joins: int = 0
    failures: int = 0
    last_error: str = ""
    heartbeat: Heartbeat = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.heartbeat is None:
            self.heartbeat = Heartbeat(f"replica.{self.worker_id}")


class ReplicaMembership:
    """See module docstring."""

    def __init__(self, listener=None):
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerRecord] = {}
        self._failovers: List[dict] = []
        self.listener = listener

    def join(self, worker_id: str, shard_index: int) -> WorkerRecord:
        """Admit (or re-admit) a worker.  A re-join keeps the record —
        its failure history, and crucially its identity, which is what
        lets the store hand back the SAME error-feedback accumulator."""
        with self._lock:
            rec = self._workers.get(worker_id)
            rejoin = rec is not None
            if rec is None:
                rec = self._workers[worker_id] = WorkerRecord(
                    worker_id, int(shard_index))
            rec.status = "active"
            rec.joins += 1
            kind = "rejoin" if rejoin else "join"
        event(f"replica.{kind}", worker=worker_id,
              shard=int(shard_index))
        self._emit(kind, worker_id)
        return rec

    def leave(self, worker_id: str,
              error: Optional[BaseException] = None) -> None:
        """Record a departure (clean exit or death).  ``error`` marks a
        death and bumps the failure count the driver's rejoin budget
        reads."""
        with self._lock:
            rec = self._workers.get(worker_id)
            if rec is None:
                return
            rec.status = "left"
            if error is not None:
                rec.failures += 1
                rec.last_error = f"{type(error).__name__}: {error}"
        event("replica.leave", worker=worker_id,
              error=(type(error).__name__ if error is not None else None))
        self._emit("leave", worker_id,
                   detail=(f"{type(error).__name__}" if error else "clean"))

    def failover(self, old_primary: str, new_primary: str, epoch: int,
                 gap_replayed: int, cold: bool = False) -> None:
        """Record a store failover in the membership log, next to the
        worker churn it rode through.  Emitted as a ``replica.failover``
        event (``timeseries.EVENT_FANOUT`` fans it per new primary,
        the series a failover detector keys on) and a
        ``ReliabilityEvent`` on the listener."""
        rec = {"old_primary": old_primary, "new_primary": new_primary,
               "epoch": int(epoch), "gap_replayed": int(gap_replayed),
               "cold_recovery": bool(cold)}
        with self._lock:
            self._failovers.append(rec)
        event("replica.failover", old_primary=old_primary,
              new_primary=new_primary, epoch=int(epoch),
              gap=int(gap_replayed), cold=bool(cold))
        self._emit("failover", new_primary,
                   detail=(f"from {old_primary} epoch={epoch} "
                           f"gap={gap_replayed}"
                           + (" (cold recovery)" if cold else "")))

    def failover_records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._failovers]

    def record(self, worker_id: str) -> Optional[WorkerRecord]:
        with self._lock:
            return self._workers.get(worker_id)

    def active_ids(self) -> List[str]:
        with self._lock:
            return [w for w, r in self._workers.items()
                    if r.status == "active"]

    def heartbeats(self) -> List[Heartbeat]:
        """Every worker's heartbeat — hand these to a ``HealthMonitor``
        (``monitor.watch_heartbeat``) for straggler events on the
        shared log."""
        with self._lock:
            return [r.heartbeat for r in self._workers.values()]

    def stragglers(self, stall_after_s: float) -> List[str]:
        """Active workers silent longer than ``stall_after_s`` —
        observation for the caller's policy, never an eviction."""
        with self._lock:
            out = []
            for wid, rec in self._workers.items():
                if rec.status != "active":
                    continue
                age = rec.heartbeat.age_s()
                if age is not None and age > stall_after_s:
                    out.append(wid)
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                wid: {
                    "shard": rec.shard_index,
                    "status": rec.status,
                    "joins": rec.joins,
                    "failures": rec.failures,
                    "last_error": rec.last_error,
                }
                for wid, rec in self._workers.items()
            }

    def _emit(self, kind: str, worker_id: str, detail: str = "") -> None:
        if self.listener is None or not hasattr(self.listener,
                                                "on_reliability"):
            return
        try:
            self.listener.on_reliability(ReliabilityEvent(
                kind=f"replica_{kind}", source=worker_id, value=0.0,
                detail=detail))
        except Exception:  # observation must never kill membership
            pass
