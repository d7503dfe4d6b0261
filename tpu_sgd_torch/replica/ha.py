"""Highly-available parameter store: replicated delta log, deterministic
failover, and partition-tolerant access (the port of
``tpu_sgd/replica/ha.py``; host code, apart from the replayed apply,
which is the store's).

The store made the *workers* elastic; the store itself would stay a
single point of failure.  This module adds the availability layer
(README "Store failover"; ADVICE.md "Failover is a replay, not a
restart"), four pieces:

* :class:`DeltaLog` — the replication unit is the **delta-log record**,
  not the weights: every ACCEPTED apply on the primary ships one
  version-stamped :class:`DeltaRecord` carrying the round's raw
  gradient contributions in SHARD ORDER (host bytes, captured before
  the apply).  A standby replaying the log runs the exact same combine
  and ``observe_step`` bookkeeping, so its trajectory — weights AND
  loss history — is bitwise the primary's at every version (pinned in
  ``tests/test_torch_replica_ha.py``).  Shipping weights instead would
  replicate a *result* no one can re-derive; shipping deltas replicates
  the *computation*, which determinism (every iteration a function of
  ``(seed, version)``) makes cheap.  The log is also the **fence**:
  :meth:`DeltaLog.append` rejects any record whose epoch is not the
  log's current epoch, so a resurrected old primary's stale applies are
  refused at the serialization point, never silently merged.

* :class:`StandbyReplica` — one applier thread per standby store,
  draining the shared log in version order.  A standby that falls
  behind simply lags (the log is bounded; falling off the retention
  window marks it failed — cold-recovery territory, loudly).

* :class:`StoreSupervisor` — owns the primary, the standbys, and the
  **epoch** counter.  On primary loss (a :class:`StoreFailed` surfaced
  by any client access, or an operator/chaos :meth:`kill_primary`) it
  promotes deterministically under ONE lock: fence the old primary
  (its τ=0 barrier waiters wake and re-route; its late checkpoint
  saves are refused AND epoch-stamped so ``CheckpointManager.restore``
  prefers the promoted line), pick the most-advanced live standby,
  **replay its log gap** (the records it had not yet drained), bump
  the epoch on the log and every surviving store, re-register the
  active worker set (the τ=0 barrier denominator must be complete
  before the first re-routed push, or a partial round would apply),
  and attach the checkpoint manager + listener.  Both stores down
  (double failure) falls back to **cold recovery**: a fresh store from
  the last ``CheckpointManager`` save — a loud warning, and at τ=0
  still bitwise, because the lost versions are recomputed from the
  same ``(seed, version)`` recipe.  The whole promotion runs inside a
  ``span("replica.failover")`` (the downtime surface) behind the
  ``replica.failover`` failpoint.

* :class:`StoreClient` — the workers' store handle.  Every access runs
  behind the ``replica.store_fail`` failpoint; a :class:`StoreFailed`
  (store crashed at this access) reports the failure, waits for
  promotion to settle, and retries against the NEW primary — a push
  whose basis belongs to the superseded epoch comes back ``fenced``
  and the worker re-pulls.  A **partitioned** worker
  (:meth:`StoreClient.partition`, or a transient fault) sees
  :class:`StoreUnreachable`, which propagates to the worker's own
  ``RetryPolicy``: the compressed-wire path already restores the
  extracted top-k segment into the error-feedback accumulator on any
  raise, so a partition is just a longer rejection — zero gradient
  mass lost, the worker rejoins the τ contract when the partition
  heals (at τ=0 the fleet waits for it; at τ>=1 the SSP progress
  bound caps how far the fleet streams ahead).

The τ contract holds ACROSS a failover: the promoted store enforces
the same basis bound and the same SSP progress bound from its own
version line, stale-epoch pushes are fenced (never discounted into the
new line), and at τ=0 the post-failover trajectory is bitwise the
fault-free run's.

The integrity half (ADVICE.md "Corruption is a payload, not an
exception"): delta-log records carry a checksum sealed at the
primary's capture and verified at the standby's replay
(:func:`verified_record` — a damaged hop heals by re-reading the
intact retained record), and :class:`RollbackController` reuses the
epoch fencing for **corrupt-state rollback** — poison that reached the
weights is already replicated to every standby, so the heal is a
forced COLD promotion from the last checksummed-good, finite-weights
checkpoint: failover to your own past.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import (TYPE_CHECKING, Callable, Dict, List, NamedTuple,
                    Optional)

if TYPE_CHECKING:  # the lock-order graph reads this annotation too
    from tpu_sgd_torch.replica.store import ParameterStore

import numpy as np

from tpu_sgd_torch.io.integrity import IntegrityError, verify
from tpu_sgd_torch.obs.counters import inc
from tpu_sgd_torch.obs.spans import event, span
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint
from tpu_sgd_torch.reliability.health import Heartbeat

logger = logging.getLogger("tpu_sgd_torch.replica.ha")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the supervisor's roster/epoch/promotion state is touched by every worker
#: thread reporting a failure plus the driver's monitor thread; the log
#: ring is appended by the primary's apply (any pushing thread) and
#: drained by standby applier threads; the client's partition set is
#: flipped by chaos/ops threads while workers read it per access.
GRAFTLINT_LOCKS = {
    "DeltaLog": {
        "_records": "_cond",
        "_epoch": "_cond",
        "_readers": "_cond",
    },
    "StoreSupervisor": {
        "_stores": "_lock",
        "_primary_index": "_lock",
        "_standbys": "_lock",
        "_epoch": "_lock",
        "_active": "_lock",
        "_failovers": "_lock",
        "_promoting": "_lock",
    },
    "StoreClient": {
        "_partitioned": "_plock",
    },
    # StandbyReplica: `_stop` is a threading.Event (own lock);
    # `applied` is written only by the applier thread and read after
    # stop()'s join — a happens-before edge, no lock needed.
}


class StoreFailed(RuntimeError):
    """The store is dead (crashed, killed, or superseded): the caller
    must re-route to the current primary.  Subclasses ``RuntimeError``
    so retry/rejoin policies treat an un-routed escape as transient."""


class StoreFenced(StoreFailed):
    """The store (or a record) belongs to a superseded epoch — the
    deterministic-failover fence.  A fenced apply/save/append is
    REFUSED, never silently merged into the promoted line."""


class StoreUnreachable(RuntimeError):
    """This worker cannot reach ANY store (network partition).  Heals
    under the worker's own ``RetryPolicy``; an exhausted budget kills
    the worker, which the elastic driver rejoins — either way the
    error-feedback accumulator keeps the extracted mass."""


class DeltaRecord(NamedTuple):
    """One applied version, as replayable bytes: the round's admitted
    gradient contributions (HOST numpy, shard order) plus the epoch and
    the version the apply produced.  ``kind`` is ``"sums"`` (dense
    wire), ``"topk"`` (compressed wire), or their sharded-store
    spellings ``"ssums"`` / ``"stopk"`` whose payloads carry per-shard
    groups — ``None`` for an untouched shard, so replication bytes
    scale with the touched coordinate range
    (``replica/shard.py``).  ``checksum`` seals the
    payload bytes at capture (the primary's apply) and is verified at
    the CONSUME site — the standby's replay — so a record damaged in
    the log (or on a real network hop) raises typed
    :class:`~tpu_sgd_torch.io.integrity.IntegrityError` instead of silently
    forking the standby's bitwise trajectory.  ``None`` = unsealed
    (integrity disabled)."""

    epoch: int
    version: int
    kind: str
    payloads: tuple
    checksum: Optional[int] = None


def record_arrays(record: DeltaRecord) -> list:
    """The array leaves of one record's payloads, in a canonical order
    — ONE definition shared by the seal (the primary's capture,
    ``ParameterStore._apply_payloads_locked``) and the verify (the
    standby's :func:`verified_record`), so the two sides can never
    digest different bytes.  Host scalars ride as a packed array so a
    damaged loss/count is caught too."""
    out = []
    for p in record.payloads:
        if p[0] == "sums":
            out.extend((np.asarray(p[1]), np.asarray(p[2]),
                        np.asarray(p[3])))
        elif p[0] == "ssums":
            # sharded dense (replica/shard.py): the per-shard
            # slices in shard order, then the scalar pair
            out.extend(np.asarray(s) for s in p[1])
            out.extend((np.asarray(p[2]), np.asarray(p[3])))
        elif p[0] == "stopk":
            # sharded compressed: a shard-presence mask FIRST (None
            # groups carry no arrays, so without it a damaged mask —
            # a segment silently dropped or misrouted in the log —
            # would digest identically), then each touched shard's
            # (local idx, vals), then the packed scalars
            out.append(np.asarray(
                [0 if s is None else 1 for s in p[1]], np.int64))
            for s in p[1]:
                if s is not None:
                    out.extend((np.asarray(s[0]), np.asarray(s[1])))
            out.append(np.asarray([p[2], p[3]], np.float64))
        else:  # topk: (tag, idx, vals, loss_sum, count)
            out.extend((np.asarray(p[1]), np.asarray(p[2]),
                        np.asarray([p[3], p[4]], np.float64)))
    return out


def verified_record(record: DeltaRecord) -> DeltaRecord:
    """The delta-log wire's consume-site check: the record passes the
    ``replica.log.record`` corrupting failpoint (the modeled log/wire
    damage window — the RETAINED record stays intact, so the healing
    retry re-reads it clean) and its checksum verifies against the
    payload bytes about to replay."""
    record = corruptpoint("replica.log.record", record)
    verify("replica.log.record", record.checksum,
           *record_arrays(record))
    return record


class DeltaLog:
    """Bounded, version-ordered ring of :class:`DeltaRecord`s — the
    replication channel AND the epoch fence (module docstring).

    Memory discipline: ``retain`` is a hard BACKSTOP, not the working
    set.  Every standby registers as a reader and advances its cursor
    per applied record; :meth:`append` trims records every reader has
    already applied, so the steady-state log holds only the live
    replication gap (typically a handful of records), never ``retain``
    full gradient payloads — the payloads are per-version dense
    contributions, and ``retain × W × d`` bytes would dwarf the model
    at production widths."""

    def __init__(self, retain: int = 4096):
        self._cond = threading.Condition()
        self._records: deque = deque(maxlen=int(retain))
        self._epoch = 0
        self._readers: Dict[str, int] = {}

    def set_epoch(self, epoch: int) -> None:
        """Bump the fence (promotion only moves it forward)."""
        with self._cond:
            if epoch < self._epoch:
                raise ValueError(
                    f"log epoch can only advance: {self._epoch} -> {epoch}")
            self._epoch = epoch
            self._cond.notify_all()

    @property
    def epoch(self) -> int:
        with self._cond:
            return self._epoch

    def append(self, record: DeltaRecord) -> None:
        """Primary-side ship.  A record from a superseded epoch — a
        resurrected old primary still applying — is REJECTED here, at
        the serialization point (the deterministic-failover fence)."""
        with self._cond:
            if record.epoch != self._epoch:
                raise StoreFenced(
                    f"delta record epoch {record.epoch} fenced "
                    f"(log epoch {self._epoch}): a superseded primary's "
                    "applies are rejected, never merged")
            if self._records and (record.version
                                  != self._records[-1].version + 1):
                raise StoreFailed(
                    f"delta log version gap: {self._records[-1].version} "
                    f"-> {record.version}")
            self._records.append(record)
            self._trim_locked()
            self._cond.notify_all()

    # -- reader cursors (what bounds the working set) -----------------------
    def register_reader(self, name: str, version: int) -> None:
        with self._cond:
            self._readers[name] = int(version)

    def advance_reader(self, name: str, version: int) -> None:
        with self._cond:
            self._readers[name] = int(version)
            self._trim_locked()

    def unregister_reader(self, name: str) -> None:
        """A promoted or dead standby stops reading — its stale cursor
        must not pin the log's memory forever."""
        with self._cond:
            self._readers.pop(name, None)
            self._trim_locked()

    def _trim_locked(self) -> None:
        # drop records every live reader has applied; with no readers
        # left (last standby promoted/dead) keep only the tail record,
        # which the append continuity check needs
        if not self._records:
            return
        floor = (min(self._readers.values()) if self._readers
                 else self._records[-1].version - 1)
        while self._records and self._records[0].version <= floor:
            self._records.popleft()

    def since(self, version: int, timeout_s: float = 0.1) -> List[DeltaRecord]:
        """Records with ``version > version``, in order; blocks up to
        ``timeout_s`` for news, ``[]`` on timeout.  Raises
        :class:`StoreFailed` when the caller has fallen off the
        retention window (its next record was evicted)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not (self._records
                       and self._records[-1].version > version):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(timeout=remaining)
            out = [r for r in self._records if r.version > version]
            if out and out[0].version != version + 1:
                raise StoreFailed(
                    f"standby at version {version} fell off the delta "
                    f"log retention window (oldest retained: "
                    f"{out[0].version})")
            return out

    def head_version(self) -> Optional[int]:
        with self._cond:
            return self._records[-1].version if self._records else None

    def reset(self, epoch: int) -> None:
        """Cold recovery: the promoted store's version line restarts
        from a checkpoint, so retained records no longer chain onto it
        — clear them (no standby remains to want them)."""
        with self._cond:
            self._records.clear()
            self._epoch = epoch
            self._cond.notify_all()


class StandbyReplica:
    """One standby store + the applier thread draining the shared log
    into it (module docstring)."""

    #: consecutive same-record corruption detections before the standby
    #: gives up (a retained record that NEVER verifies is real storage
    #: rot, not a transient wire fault — cold-recovery territory)
    MAX_CORRUPT_RETRIES = 8

    def __init__(self, store, log: DeltaLog, name: str = ""):
        self.store = store
        self.log = log
        self.name = name or getattr(store, "name", "standby")
        self.applied = 0
        self.corrupt_healed = 0
        self._corrupt_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StandbyReplica":
        if self._thread is None:
            self.log.register_reader(self.name, self.store.version)
            self._thread = threading.Thread(
                target=self._run, name=f"replica-standby-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def _apply_verified(self, rec: DeltaRecord) -> bool:
        """Verify + apply one record; a detected corruption is retried
        by RE-READING the log (the retained record is intact — the
        damage model is the hop, not the store), bounded by
        :data:`MAX_CORRUPT_RETRIES` so real storage rot still fails
        LOUDLY into the standby's cold-recovery path.  Returns False
        when the caller should re-read the log and try again."""
        try:
            self.store.apply_replica_record(verified_record(rec))
        except IntegrityError:
            self._corrupt_streak += 1
            if self._corrupt_streak > self.MAX_CORRUPT_RETRIES:
                inc("integrity.unhealed")
                raise StoreFailed(
                    f"standby {self.name}: record v{rec.version} failed "
                    f"its checksum {self._corrupt_streak} consecutive "
                    "times — unhealable corruption") from None
            return False
        if self._corrupt_streak:
            self.corrupt_healed += 1
        self._corrupt_streak = 0
        self.applied += 1
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                for rec in self.log.since(self.store.version,
                                          timeout_s=0.05):
                    if self._stop.is_set():
                        return
                    if not self._apply_verified(rec):
                        break  # corrupt copy: re-read the intact record
                    self.log.advance_reader(self.name,
                                            self.store.version)
            except StoreFailed as e:
                if (self._stop.is_set() or self.store.fenced
                        or self.store.failed):
                    return  # promotion/shutdown owns us now
                # a retention fall-off or a continuity break: this
                # standby can never catch up again — it must stop
                # being a promotion candidate, LOUDLY (cold-recovery
                # territory), and release its log cursor
                logger.warning(
                    "standby %s cannot continue replaying (%s); store "
                    "marked failed — cold-recovery territory",
                    self.name, e)
                self.store.mark_failed()
                self.log.unregister_reader(self.name)
                return
            except Exception:
                logger.warning(
                    "standby %s applier died; store marked failed",
                    self.name, exc_info=True)
                self.store.mark_failed()
                self.log.unregister_reader(self.name)
                return

    def halt(self) -> None:
        """Stop the applier thread (joining its in-flight apply) while
        KEEPING the log cursor — the promotion path halts, then drains
        the gap, then releases; releasing first would let the log trim
        the very records the gap replay needs."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def release(self) -> None:
        """Drop the log cursor: a promoted (or abandoned) standby stops
        reading, and its stale cursor must not pin the log's memory."""
        self.log.unregister_reader(self.name)

    def stop(self, drain: bool = False) -> None:
        """Halt the applier; ``drain`` then applies every record still
        in the log synchronously; the cursor is released either way."""
        self.halt()
        try:
            if drain:
                self.drain()
        finally:
            self.release()

    def drain(self) -> int:
        """Apply everything the log still holds beyond this store's
        version (same verify-at-consume + bounded corrupt-retry as the
        live applier — the promotion gap replay must not trust a
        damaged hop either); returns the number of records replayed."""
        n = 0
        while True:
            recs = self.log.since(self.store.version, timeout_s=0.0)
            if not recs:
                return n
            for rec in recs:
                if not self._apply_verified(rec):
                    break  # corrupt copy: re-read the intact record
                n += 1

    def lag(self) -> int:
        head = self.log.head_version()
        return 0 if head is None else max(0, head - self.store.version)


class StoreSupervisor:
    """Owns the replicated store group and the deterministic failover
    (module docstring).  ``stores[0]`` starts as primary; the rest are
    standbys.  ``store_factory(resume_state, name)`` builds the
    cold-recovery store (double failure); ``membership`` (a
    :class:`~tpu_sgd_torch.replica.membership.ReplicaMembership`) records
    failover events next to join/leave."""

    def __init__(
        self,
        stores,
        *,
        membership=None,
        checkpoint_manager=None,
        checkpoint_every: int = 10,
        listener=None,
        store_factory: Optional[Callable] = None,
        health_monitor=None,
        log_retain: int = 4096,
        max_failovers: int = 8,
    ):
        if not stores:
            raise ValueError("StoreSupervisor needs at least one store")
        self._lock = threading.Condition()
        #: the element annotation is load-bearing: the static lock-order
        #: graph (analysis/rules_order.py) types `self._stores[i]` /
        #: `for s in self._stores` receivers from it, which is how the
        #: StoreSupervisor._lock -> ParameterStore._cond nesting in
        #: _promote_locked is proven rather than taken on faith
        self._stores: "List[ParameterStore]" = list(stores)
        self._primary_index = 0
        self._epoch = int(stores[0].epoch)
        self._membership = membership
        self._checkpoint_manager = checkpoint_manager
        self._checkpoint_every = int(checkpoint_every)
        self._listener = listener
        self._store_factory = store_factory
        self.max_failovers = int(max_failovers)
        self._log = DeltaLog(retain=log_retain)
        self._log.reset(self._epoch)
        self._active: Dict[str, int] = {}
        self._failovers: List[dict] = []
        self._promoting = False
        stores[0].set_replication(self._log.append)
        self._standbys: Dict[int, StandbyReplica] = {
            i: StandbyReplica(s, self._log, name=s.name).start()
            for i, s in enumerate(self._stores) if i > 0
        }
        if health_monitor is not None:
            # the liveness surface an external watchdog reads (the
            # in-process trigger is always a signaled failure: a
            # StoreFailed surfaced by a client access or kill_primary)
            for s in self._stores:
                health_monitor.watch_heartbeat(s.heartbeat)

    # -- surfaces ------------------------------------------------------------
    def client(self) -> "StoreClient":
        return StoreClient(self)

    def primary(self):
        with self._lock:
            return self._stores[self._primary_index]

    def heartbeats(self) -> List[Heartbeat]:
        with self._lock:
            return [s.heartbeat for s in self._stores]

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def failover_count(self) -> int:
        with self._lock:
            return len(self._failovers)

    def await_settled(self, timeout_s: float = 30.0) -> bool:
        """Block while a promotion is in flight — the preemption path
        MUST wait here so ``TrainingPreempted`` unwinds from a
        consistent ``(epoch, version)``."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._promoting:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(timeout=remaining)
            return True

    def settled_primary(self, timeout_s: float = 30.0):
        if not self.await_settled(timeout_s):
            raise StoreFailed("failover did not settle in time")
        return self.primary()

    # -- worker roster (the promote-time re-registration source) ------------
    def register_worker(self, worker_id: str, shard_index: int) -> None:
        with self._lock:
            self._active[worker_id] = int(shard_index)
            store = self._stores[self._primary_index]
        store.register_worker(worker_id, shard_index)

    def deregister_worker(self, worker_id: str) -> None:
        with self._lock:
            self._active.pop(worker_id, None)
            store = self._stores[self._primary_index]
        store.deregister_worker(worker_id)

    def error_feedback(self, worker_id: str, frac: float):
        # ONE registry shared by every store in the group (the driver
        # passes the same ef_registry dict to all), so the accumulator
        # — and its carried mass — survives any number of failovers
        return self.primary().error_feedback(worker_id, frac)

    # -- failure handling ----------------------------------------------------
    def kill_primary(self) -> bool:
        """Operator/chaos kill switch: fail the current primary and
        promote.  Returns False when nothing was promoted (already
        superseded)."""
        return self.on_store_failure(
            self.primary(), StoreFailed("primary killed"))

    def on_store_failure(self, store, error=None) -> bool:
        """A client (or operator) observed ``store`` fail.  Promotes iff
        ``store`` is still the current primary — stale reports from
        other threads racing the same incident are no-ops."""
        with self._lock:
            if store is not self._stores[self._primary_index]:
                return False
            if len(self._failovers) >= self.max_failovers:
                raise StoreFailed(
                    f"failover budget exhausted "
                    f"({self.max_failovers}); last error: {error}")
            self._promoting = True
            try:
                self._promote_locked(error)
            finally:
                self._promoting = False
                self._lock.notify_all()
            return True

    def _promote_locked(self, error) -> None:
        old = self._stores[self._primary_index]
        old_version = old.version
        new_epoch = self._epoch + 1
        with span("replica.failover", old_primary=old.name,
                  old_version=old_version, epoch=new_epoch) as sp:
            failpoint("replica.failover")
            # fence FIRST: τ=0 barrier waiters wake and re-route, the
            # old primary's in-flight apply (fence waits on its lock)
            # lands in the log before the epoch bump below, and its
            # LATE saves are refused (plus epoch-stamped, so restore()
            # prefers the promoted line either way)
            old.fence()
            candidates = sorted(
                ((self._stores[i].version, -i, i)
                 for i in self._standbys
                 if not (self._stores[i].failed
                         or self._stores[i].fenced)),
                reverse=True)
            promoted = None
            gap = 0
            for _, _, idx in candidates:
                # the most-advanced standby wins (ties: lowest index —
                # deterministic), and its remaining log gap replays
                # BEFORE it takes pushes; a candidate whose gap replay
                # fails (retention fall-off raced the failure) is
                # marked failed and the NEXT candidate tries
                rep = self._standbys.pop(idx)
                rep.halt()
                try:
                    gap = rep.drain()
                except StoreFailed as gap_err:
                    logger.warning(
                        "standby %s failed its promotion gap replay "
                        "(%s); trying the next candidate", rep.name,
                        gap_err)
                    self._stores[idx].mark_failed()
                    rep.release()
                    continue
                rep.release()
                promoted = self._stores[idx]
                break
            cold = promoted is None
            if cold:
                # DOUBLE FAILURE: no live standby — cold recovery from
                # the last GOOD checkpoint (or from scratch).  Loud:
                # this is a data-loss-adjacent event even though τ=0
                # stays bitwise (lost versions recompute from (seed,
                # i)).  "Good" is two checks deep: the content checksum
                # (CheckpointManager quarantines a failed verify and
                # falls back on its own) plus a finite-weights walk —
                # the rollback path lands here precisely BECAUSE the
                # live weights went bad, and a cadence save may have
                # persisted the poison before anyone noticed
                state = (_restore_good(self._checkpoint_manager)
                         if self._checkpoint_manager is not None else None)
                logger.warning(
                    "replica HA: primary %s AND every standby are down; "
                    "cold-recovering a fresh store from %s",
                    old.name,
                    (f"checkpoint version {state['iteration']}"
                     if state is not None else "initial weights"))
                if self._store_factory is None:
                    raise StoreFailed(
                        "double store failure with no store_factory: "
                        "cold recovery impossible") from error
                promoted = self._store_factory(
                    state, f"s{len(self._stores)}")
                self._stores.append(promoted)
                idx = len(self._stores) - 1
                gap = 0
                self._log.reset(new_epoch)
            self._log.set_epoch(new_epoch)
            for s in self._stores:
                if not (s.failed or s.fenced):
                    s.set_epoch(new_epoch)
            promoted.attach_primary(
                checkpoint_manager=self._checkpoint_manager,
                checkpoint_every=self._checkpoint_every,
                listener=self._listener)
            # the τ=0 barrier denominator must be COMPLETE before the
            # first re-routed push, or a partial round would apply
            for wid, shard in sorted(self._active.items()):
                promoted.register_worker(wid, shard)
            promoted.set_replication(self._log.append)
            self._primary_index = idx
            self._epoch = new_epoch
            record = {
                "old_primary": old.name,
                "new_primary": promoted.name,
                "epoch": new_epoch,
                "old_version": old_version,
                "new_version": promoted.version,
                "gap_replayed": gap,
                "cold_recovery": cold,
                "error": (f"{type(error).__name__}: {error}"
                          if error is not None else ""),
            }
            self._failovers.append(record)
            sp.set(new_primary=promoted.name,
                   new_version=promoted.version, gap=gap, cold=cold)
            inc("replica.failover")
        if self._membership is not None:
            self._membership.failover(
                old.name, promoted.name, new_epoch, gap, cold=cold)

    def rollback(self, error=None) -> bool:
        """Corrupt-state rollback (driven by
        :class:`RollbackController`): force a COLD promotion even while
        standbys are live.  The standbys replayed the same poisoned
        delta records the primary applied — the standby-bitwise
        invariant cuts both ways — so every live store is marked failed
        first and :meth:`_promote_locked` falls through to its
        cold-recovery branch: fence the old primary, restore the last
        good checkpoint (:func:`_restore_good`), bump the epoch so
        in-flight pushes against the poisoned line come back fenced,
        re-register the roster, replay forward."""
        with self._lock:
            if len(self._failovers) >= self.max_failovers:
                raise StoreFailed(
                    f"rollback refused: failover budget exhausted "
                    f"({self.max_failovers}); last error: {error}"
                ) from error
            self._promoting = True
            try:
                n_live = 0
                for i, rep in list(self._standbys.items()):
                    if not (self._stores[i].failed
                            or self._stores[i].fenced):
                        n_live += 1
                    rep.halt()
                    rep.release()
                    self._stores[i].mark_failed()
                self._standbys.clear()
                self._promote_locked(error)
                # re-establish the set_standbys(n) redundancy the
                # caller configured: the poisoned standbys are gone for
                # good (they replayed the poison), so fresh ones resume
                # from the SAME restored state the new primary did —
                # still under this lock, so no push can route (and no
                # save can land) between the promotion and the rebuild,
                # which keeps the new standbys version-chained onto the
                # reset log
                if n_live and self._store_factory is not None:
                    state = (_restore_good(self._checkpoint_manager)
                             if self._checkpoint_manager is not None
                             else None)
                    for _ in range(n_live):
                        s = self._store_factory(
                            state, f"s{len(self._stores)}")
                        s.set_epoch(self._epoch)
                        self._stores.append(s)
                        idx = len(self._stores) - 1
                        self._standbys[idx] = StandbyReplica(
                            s, self._log, name=s.name).start()
            finally:
                self._promoting = False
                self._lock.notify_all()
            return True

    # -- lifecycle -----------------------------------------------------------
    def stop(self) -> None:
        """Settle any in-flight promotion, stop the primary (τ=0
        waiters wake), drain every live standby to the log head (the
        standby-bitwise invariant stays observable at rest), stop
        everything."""
        self.await_settled()
        with self._lock:
            primary = self._stores[self._primary_index]
            appliers = list(self._standbys.values())
            stores = list(self._stores)
        primary.stop()
        for rep in appliers:
            try:
                rep.stop(drain=not (rep.store.failed or rep.store.fenced))
            except StoreFailed:
                pass  # a lagging standby off the retention window
        for s in stores:
            s.stop()

    def save_now(self) -> None:
        self.settled_primary().save_now()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "primary": self._stores[self._primary_index].name,
                "failovers": len(self._failovers),
                "records": [dict(r) for r in self._failovers],
                "stores": {
                    s.name: {"version": s.version, "failed": s.failed,
                             "fenced": s.fenced}
                    for s in self._stores
                },
            }


def _restore_good(manager) -> Optional[dict]:
    """The rollback/cold-recovery restore: the newest retained
    checkpoint that passes its content checksum AND carries finite
    weights.  ``CheckpointManager.restore()`` already quarantines
    checksum-corrupt files; the finite walk guards the OTHER corruption
    shape — a cadence save that faithfully persisted already-poisoned
    weights (checksummed garbage is still garbage)."""
    state = manager.restore()
    if state is None or bool(np.isfinite(
            np.asarray(state["weights"])).all()):
        return state
    logger.warning(
        "rollback restore: checkpoint at iteration %d carries "
        "non-finite weights (the poison was saved before it was "
        "detected); walking back through retained versions",
        state["iteration"])
    for v in reversed(manager.versions()):
        try:
            st = manager.restore_version(v)
        except Exception:
            continue  # corrupt/unreadable retained copy: keep walking
        if bool(np.isfinite(np.asarray(st["weights"])).all()):
            return st
    logger.warning(
        "rollback restore: NO retained checkpoint carries finite "
        "weights; recovering from initial weights")
    return None


class RollbackController:
    """Corrupt-state rollback: **failover to your own past** (ADVICE.md
    "Corruption is a payload, not an exception").

    The admission guard (``ParameterStore`` poison gate) rejects the
    poison it can SEE at push time.  This controller is for the poison
    that slips through — the guard disabled, or the resident weights
    themselves damaged — where the corrupt state is already replicated
    (every standby replayed the same poisoned delta, so promotion
    cannot help).  :meth:`rollback` reuses the epoch fencing end to
    end: fence the whole present (primary and standbys), cold-recover a
    fresh store from the last checksummed-good, finite-weights
    checkpoint with an EPOCH BUMP — so in-flight pushes against the
    poisoned line come back ``fenced`` and are never discounted into
    the clean one — and let the workers replay forward from ``(seed,
    version)``.  Runs under ``span("integrity.rollback")`` with a
    flight-record dump, so the post-mortem starts at the incident.

    :meth:`check_and_rollback` is the polling spelling the
    ``ReplicaDriver`` monitor loop calls when
    ``set_integrity_rollback(True)`` arms it."""

    def __init__(self, supervisor: StoreSupervisor):
        self._sup = supervisor

    def check_and_rollback(self) -> bool:
        """Roll back iff the current primary's weights went non-finite;
        returns True when a rollback ran."""
        try:
            healthy = self._sup.primary().weights_healthy()
        except Exception:
            return False  # mid-promotion churn: the next poll re-checks
        if healthy:
            return False
        return self.rollback("non-finite weights detected")

    def rollback(self, reason: str = "corrupt-state") -> bool:
        from tpu_sgd_torch.obs import flightrec

        with span("integrity.rollback", reason=reason) as sp:
            inc("integrity.rollback")
            event("integrity.rollback", reason=reason)
            ok = self._sup.rollback(
                IntegrityError("store.weights", "poison", reason))
            sp.set(rolled_back=ok, epoch=self._sup.epoch)
        # dump AFTER the span closes so the incident's own records —
        # the rollback span included — are in the ring being dumped
        flightrec.trigger("integrity.rollback", detail=reason)
        return ok


class StoreClient:
    """The workers' partition-tolerant store handle (module
    docstring).  Duck-types the :class:`ParameterStore` worker/driver
    surface; every access re-routes through the supervisor's CURRENT
    primary and turns a :class:`StoreFailed` into a failover +
    retry."""

    def __init__(self, supervisor: StoreSupervisor,
                 failover_retries: int = 8):
        self._sup = supervisor
        self._failover_retries = int(failover_retries)
        self._plock = threading.Lock()
        self._partitioned: set = set()

    # -- chaos/ops: network partition ---------------------------------------
    def partition(self, worker_id: str) -> None:
        """Cut ``worker_id`` off from every store: its accesses raise
        :class:`StoreUnreachable` until :meth:`heal`."""
        with self._plock:
            self._partitioned.add(worker_id)

    def heal(self, worker_id: str) -> None:
        with self._plock:
            self._partitioned.discard(worker_id)

    # -- the routed protocol -------------------------------------------------
    def _op(self, worker_id: str, op: str, *args, **kwargs):
        with self._plock:
            cut = worker_id in self._partitioned
        if cut:
            raise StoreUnreachable(
                f"worker {worker_id!r} is partitioned from the store "
                "group (heals under the worker RetryPolicy)")
        last: Optional[BaseException] = None
        for _ in range(self._failover_retries):
            store = self._sup.primary()
            try:
                failpoint("replica.store_fail")
                return getattr(store, op)(*args, **kwargs)
            except StoreFailed as e:  # incl. StoreFenced: re-route
                last = e
                self._sup.on_store_failure(store, e)
                if not self._sup.await_settled():
                    break
        raise StoreFailed(
            f"store access {op!r} failed across "
            f"{self._failover_retries} failover attempts") from last

    def pull(self, worker_id: str = ""):
        return self._op(worker_id, "pull", worker_id)

    def push(self, worker_id: str, basis_version: int, grad_sum,
             loss_sum, count, *, basis_epoch: Optional[int] = None,
             checksum: Optional[int] = None):
        return self._op(worker_id, "push", worker_id, basis_version,
                        grad_sum, loss_sum, count,
                        basis_epoch=basis_epoch, checksum=checksum)

    def push_compressed(self, worker_id: str, basis_version: int,
                        indices, values, loss_sum: float, count: float,
                        *, basis_epoch: Optional[int] = None,
                        checksum: Optional[int] = None,
                        shard_seals=None):
        if shard_seals is None:
            # a plain (unsharded) store's signature has no shard_seals
            # kwarg — forward only what the callee accepts
            return self._op(worker_id, "push_compressed", worker_id,
                            basis_version, indices, values, loss_sum,
                            count, basis_epoch=basis_epoch,
                            checksum=checksum)
        return self._op(worker_id, "push_compressed", worker_id,
                        basis_version, indices, values, loss_sum, count,
                        basis_epoch=basis_epoch, checksum=checksum,
                        shard_seals=shard_seals)

    def shard_layout(self):
        """The settled primary's per-shard coordinate ranges (or
        ``None`` — unsharded).  Every store in a supervised group is
        built with the SAME shard count (the driver's ``_mk_store``),
        so the layout is failover-stable and workers may cache it."""
        return self._sup.settled_primary().shard_layout()

    # -- driver surface (forwarded to the settled primary) -------------------
    def register_worker(self, worker_id: str, shard_index: int) -> None:
        self._sup.register_worker(worker_id, shard_index)

    def deregister_worker(self, worker_id: str) -> None:
        self._sup.deregister_worker(worker_id)

    def error_feedback(self, worker_id: str, frac: float):
        return self._sup.error_feedback(worker_id, frac)

    def stop(self) -> None:
        self._sup.stop()

    def save_now(self) -> None:
        self._sup.save_now()

    def wait_done(self, timeout_s: Optional[float] = None) -> bool:
        return self._sup.primary().wait_done(timeout_s)

    def snapshot(self) -> dict:
        snap = self._sup.settled_primary().snapshot()
        snap["failovers"] = self._sup.failover_count
        return snap

    def loss_history(self):
        return self._sup.settled_primary().loss_history()

    @property
    def version(self) -> int:
        return self._sup.settled_primary().version

    @property
    def weights(self):
        return self._sup.settled_primary().weights

    @property
    def converged(self) -> bool:
        return self._sup.settled_primary().converged

    @property
    def supervisor(self) -> StoreSupervisor:
        return self._sup
