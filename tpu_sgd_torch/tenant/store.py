"""Tenant model store: durable per-tenant checkpoints under one slab (the
port of ``tpu_sgd/tenant/store.py``).

The persistence half of the tenant plane, layered on the same machinery
single-model serving trusts:

* every tenant owns a ``CheckpointManager`` directory
  (``<root>/tenant_<id>/`` — numbered, atomically-renamed,
  content-checksummed npz files, the JAX package's format), written by
  :meth:`publish` — the per-tenant retraining trickle's sink;
* residency is lazy: a request for a non-resident tenant loads its
  newest checkpoint (corrupt versions raise at restore — the CRC rides
  the file) and admits it into the :class:`~tpu_sgd_torch.tenant.slab.
  WeightSlab`, evicting the LRU tenant when full;
* a publish to a RESIDENT tenant hot-swaps its one row — neighbours
  untouched;
* the slab itself checkpoints as one frame (:meth:`save_state` /
  :meth:`restore_state`): the packed weight matrix plus the residency
  map ride a ``CheckpointManager`` entry, sealed with the io-plane CRC
  (``io/integrity.py`` — site ``tenant.slab``) so a bit-flipped slab
  restore is a typed :class:`IntegrityError`; either package reads the
  other's frames;
* the shadow/canary special case (:meth:`admit_versions`): M = the
  registry VERSIONS of one model — several checkpoint versions packed
  as slab rows and scored per batch (``TenantPredictEngine.predict_all``).

Obs events (``tenant.admit`` / ``tenant.evict`` / ``tenant.swap``,
fanned per tenant by ``obs.timeseries.EVENT_FANOUT``) and counters ride
every residency transition.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tpu_sgd_torch.obs.counters import inc as obs_inc
from tpu_sgd_torch.obs.spans import event as obs_event
from tpu_sgd_torch.tenant.slab import SlabFullError, WeightSlab
from tpu_sgd_torch.utils.checkpoint import CheckpointManager

logger = logging.getLogger("tpu_sgd_torch.tenant.store")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the lazy per-tenant manager cache is shared between serving threads (miss
#: loads) and publishers; the slab has its own internal lock.
GRAFTLINT_LOCKS = {
    "TenantModelStore": {
        "_managers": "_lock",
        "_publish_locks": "_lock",
        "_state_seq": "_lock",
    },
}


class TenantMissingError(RuntimeError):
    """No checkpoint exists for this tenant — it was never published."""


class TenantModelStore:
    """Durable multi-tenant model store over one device-resident slab.

    ``activation`` fixes the GLM family every tenant of this store
    shares (``None`` = margin/regression, ``"sigmoid"`` = logistic
    score) — one family per store keeps the slab's shapes shared across
    all tenants; run a second store for a second family.  The slab lives
    on ``device`` (``None``: the card).
    """

    def __init__(self, directory: str, *, capacity: int, d: int,
                 activation: Optional[str] = None, keep: int = 4,
                 device=None):
        if activation not in (None, "sigmoid"):
            raise ValueError(
                f"activation must be None or 'sigmoid', got {activation!r}")
        self.slab = WeightSlab(capacity, d, device=device)
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.activation = activation
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._managers: Dict[int, CheckpointManager] = {}
        #: per-tenant publish serialization: two concurrent publishers
        #: of the SAME tenant would both compute version = latest+1 and
        #: collide on the checkpoint's tmp filename (publishes to
        #: DIFFERENT tenants stay fully concurrent)
        self._publish_locks: Dict[int, threading.Lock] = {}
        self._state_seq = 0

    # -- internals ---------------------------------------------------------
    def _manager(self, tenant_id: int) -> CheckpointManager:
        tid = int(tenant_id)
        with self._lock:
            m = self._managers.get(tid)
            if m is None:
                m = self._managers[tid] = CheckpointManager(
                    os.path.join(self.directory, f"tenant_{tid}"),
                    keep=self.keep)
            return m

    def _publish_lock(self, tenant_id: int) -> threading.Lock:
        with self._lock:
            lk = self._publish_locks.get(tenant_id)
            if lk is None:
                lk = self._publish_locks[tenant_id] = threading.Lock()
            return lk

    def _emit(self, kind: str, tenant: int) -> None:
        obs_inc(f"tenant.{kind}")
        obs_event(f"tenant.{kind}", tenant=int(tenant))

    # -- training side -----------------------------------------------------
    def publish(self, tenant_id: int, weights, intercept: float = 0.0) -> int:
        """Durably publish one tenant's new model (one checkpoint write)
        and — when the tenant is resident — hot-swap its slab row in
        place.  Returns the new version number.  The per-tenant
        retraining trickle calls this continuously under live traffic."""
        tid = int(tenant_id)
        m = self._manager(tid)
        with self._publish_lock(tid):
            version = (m.latest_version() or 0) + 1
            m.save(version, np.asarray(weights, np.float32), 0.0, [],
                   config_key=f"tenant-{tid}",
                   extras={"intercept": np.float32(intercept)})
            if self.slab.slot_of(tid) is not None:
                _, _, kind = self.slab.put(tid, weights, intercept,
                                           version=version)
                self._emit("swap" if kind == "swapped" else "admit", tid)
        return version

    # -- residency ---------------------------------------------------------
    def load(self, tenant_id: int) -> int:
        """Admit (or refresh) ``tenant_id`` from its newest checkpoint;
        returns the loaded version.  Raises :class:`TenantMissingError`
        when the tenant has no checkpoints; a corrupt newest checkpoint
        raises whatever ``CheckpointManager.restore_version`` raises
        (incl. ``IntegrityError``) — residency never swallows it."""
        _, _, (latest,) = self._admit([tenant_id], None)
        return latest

    def _restore_latest(self, m: CheckpointManager, tid: int):
        """``(checkpoint, version)`` of the tenant's newest checkpoint
        (the caller holds its publish lock)."""
        last_err: Optional[BaseException] = None
        for _ in range(3):
            latest = m.latest_version()
            if latest is None:
                raise TenantMissingError(
                    f"tenant {tid}: no published checkpoint under "
                    f"{self.directory!r}")
            try:
                return m.restore_version(latest), latest
            except Exception as e:
                # a concurrent publish can prune `latest` between the
                # version scan and the read (keep=N retention); re-scan
                # and retry — a persistent failure (e.g. a corrupt newest
                # checkpoint) still raises after the bounded retries,
                # never silently served
                last_err = e
        raise last_err

    def _admit(self, tenant_ids, resolve):
        """Admit (or refresh) each of ``tenant_ids`` from its newest
        checkpoint, in sorted order, and resolve the batch ``resolve``
        (``None``: none) in the same slab lock round as the admissions
        (``WeightSlab.put_then_resolve``): a concurrent admission cannot
        evict this batch's rows before it resolves.  Returns ``(snapshot,
        missing, versions)``.

        Each tenant's scan-restore-put runs under its publish lock (taken
        in sorted order): a concurrent publish(tid) bumps the checkpoint
        AND the slab row between an unserialized load's restore and its
        put, and the load would then overwrite the newer slab row with the
        older checkpoint — a silent version regression served until the
        next swap.  Loads of DIFFERENT tenants stay fully concurrent."""
        tids = sorted(int(t) for t in tenant_ids)
        with contextlib.ExitStack() as held:
            for tid in tids:
                held.enter_context(self._publish_lock(tid))
            rows = []
            for tid in tids:
                ck, latest = self._restore_latest(self._manager(tid), tid)
                rows.append((tid, ck["weights"],
                             float(ck["extras"].get("intercept", 0.0)),
                             latest))
            puts, snap, missing = self.slab.put_then_resolve(rows, resolve)
            for tid, (_, evicted, kind) in zip(tids, puts):
                self._emit("swap" if kind == "swapped" else "admit", tid)
                if evicted is not None:
                    self._emit("evict", evicted)
        return snap, missing, [row[3] for row in rows]

    # alias: the hot-reload spelling (reload tenant i; neighbors untouched)
    reload = load

    def slots_for(self, tenant_ids):
        """The serving resolve: tenants -> ``(slots, W, b)`` snapshot,
        admitting non-resident tenants from disk on miss.  Bounded
        retries guard against admission thrash (a burst whose distinct
        tenant count exceeds capacity cannot be scored in one batch —
        :class:`SlabFullError` instead of livelock).  Five resolves and
        five admission rounds, as the JAX package's loop; each round's
        admissions and the next resolve share one slab lock round."""
        missing = None
        for _ in range(5):
            if missing is None:
                try:
                    return self.slab.snapshot_for(tenant_ids)
                except KeyError as e:
                    (missing,) = e.args
                continue
            snap, missing, _ = self._admit(missing, tenant_ids)
            if snap is not None:
                return snap
        self._admit(missing, None)
        raise SlabFullError(
            f"slab thrash: {self.slab.capacity} slots cannot hold this "
            "batch's distinct tenants; raise capacity "
            "(plan.choose_slab_capacity) or shrink the batch")

    def admit_versions(self, manager_or_directory,
                       versions: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        """The multi-model (shadow/canary) special case: pack several
        checkpoint VERSIONS of one model registry stream as slab rows,
        keyed by version number — ``TenantPredictEngine.predict_all``
        then scores a batch against every admitted version in one
        dispatch.  ``versions=None`` admits all of them (newest last,
        so the newest is the hottest row).  Returns the version ids
        admitted."""
        m = manager_or_directory
        if isinstance(m, (str, os.PathLike)):
            m = CheckpointManager(str(m))
        vs = list(versions) if versions is not None else list(m.versions())
        for v in vs:
            ck = m.restore_version(int(v))
            _, evicted, kind = self.slab.put(
                int(v), ck["weights"],
                float(ck["extras"].get("intercept", 0.0)), version=int(v))
            self._emit("swap" if kind == "swapped" else "admit", int(v))
            if evicted is not None:
                self._emit("evict", evicted)
        return tuple(int(v) for v in vs)

    def staleness_s(self, tenant_id: int) -> float:
        return self.slab.staleness_s(tenant_id)

    # -- slab state checkpointing ------------------------------------------
    def save_state(self, manager: CheckpointManager) -> int:
        """Checkpoint the WHOLE slab (weights + residency map) as one
        CRC-sealed frame through the standard checkpoint machinery: the
        npz content checksum covers every entry, and an io-plane seal
        over the packed arrays (site ``tenant.slab``) is stored
        alongside so :meth:`restore_state` re-verifies the slab bytes
        end-to-end.  Returns the state version written."""
        from tpu_sgd_torch.io.integrity import seal

        st = self.slab.state()
        crc = seal(st["weights"], st["intercepts"], st["tenant_ids"],
                   st["slots"], st["versions"])
        with self._lock:
            self._state_seq += 1
            seq = self._state_seq
        manager.save(
            seq, st["weights"], 0.0, [], config_key="tenant-slab",
            extras={
                "slab_intercepts": st["intercepts"],
                "slab_tenant_ids": st["tenant_ids"],
                "slab_slots": st["slots"],
                "slab_versions": st["versions"],
                "slab_crc": np.int64(-1 if crc is None else crc),
            })
        return seq

    def restore_state(self, manager: CheckpointManager,
                      version: Optional[int] = None) -> int:
        """Restore a :meth:`save_state` frame into the slab, verifying
        the io-plane seal first (``IntegrityError`` on mismatch — a
        corrupt slab restore must fail loudly, not mis-serve every
        tenant).  Returns the state version restored."""
        from tpu_sgd_torch.io.integrity import verify

        v = version if version is not None else manager.latest_version()
        if v is None:
            raise TenantMissingError(
                f"no slab state checkpoint under {manager.directory!r}")
        ck = manager.restore_version(int(v))
        ex = ck["extras"]
        st = {
            "weights": ck["weights"],
            "intercepts": ex["slab_intercepts"],
            "tenant_ids": ex["slab_tenant_ids"],
            "slots": ex["slab_slots"],
            "versions": ex["slab_versions"],
        }
        crc = int(ex["slab_crc"])
        if crc >= 0:
            verify("tenant.slab", crc, st["weights"], st["intercepts"],
                   st["tenant_ids"], st["slots"], st["versions"])
        self.slab.load_state(st)
        with self._lock:
            self._state_seq = max(self._state_seq, int(v))
        return int(v)

    # -- ops ---------------------------------------------------------------
    def healthz(self) -> dict:
        with self._lock:
            n_mgr = len(self._managers)
        return {
            "slab": self.slab.ledger_snapshot(),
            "tenant_dirs_open": n_mgr,
            "activation": self.activation,
        }
