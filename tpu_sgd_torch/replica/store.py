"""Device-resident, version-stamped parameter store with bounded
staleness (the port of ``tpu_sgd/replica/store.py``).

The store owns the three things the async fleet must agree on:

* **the weights** — ONE device tensor, replaced (never written in place)
  by each applied update, so a pulled reference stays valid for as long
  as the worker computes on it.  Nothing is donated: an apply allocates
  its result;
* **the version** — the number of applied optimization steps.  A pull
  returns ``(weights, version)``; a push carries the ``basis_version``
  it computed against and is admitted by the
  :class:`~tpu_sgd_torch.replica.staleness.StalenessContract` at APPLY
  time (``head - basis <= tau``; ADVICE.md "Staleness is a contract, not
  a tuning knob");
* **the update rule** — workers push *gradient contributions*
  ``(grad_sum, loss_sum, count)``, the store runs the updater.  This
  is the division of labor that makes ``tau = 0`` degenerate to the
  synchronous data-parallel path **bitwise**: a τ=0 round barriers
  until every active worker's contribution is in, adds them in shard
  order exactly as ``parallel.mesh.combine_sums`` adds its ranks' (each
  contribution flattened at the promoted dtype, then
  ``rank_order_sum``), and applies ONE combined update through
  ``optimize.gradient_descent.apply_sums``, the function the meshed
  synchronous step calls (pinned in ``tests/test_torch_replica.py``).
  Pushing *applied deltas* instead would compose per-shard updater
  steps, which no synchronous trajectory matches (ADVICE.md).

Async mode (``tau >= 1`` or unbounded): each admitted push applies
immediately as its own update step — version increments per push, the
step index ``version + 1`` (the ``(1,)`` int64 device counter the
updaters take) drives the step-size decay, and the loss history records
one entry per applied step through the SAME shared ``observe_step``
bookkeeping the observed drivers use.

Compressed pushes (``wire_compress="topk:<frac>"``): the worker
normalizes its contribution to a batch-mean gradient, folds it through
its persistent per-worker :class:`ErrorFeedback` accumulator, and ships
only the top-k ``(indices, values)`` segment; the store adds segments
into a dense vector (a gather, an add and a store at each segment's
unique indices, in payload order: no float atomics) and applies the
mean.  EF state is OPTIMIZER STATE: it is registered here so every
checkpoint the store saves carries every worker's accumulator (extras
``ef_<worker_id>``) and a rejoining worker re-attaches its dropped mass
instead of losing it.

High availability (``replica/ha.py``; ADVICE.md "Failover is a replay,
not a restart"): a store carries an **epoch** — the failover
generation.  The primary ships every applied version as a delta-log
record (:meth:`set_replication`; the raw admitted contributions in
shard order, captured as host bytes) and standbys replay them through
:meth:`apply_replica_record` — the same combine, the same
``observe_step``, so a standby's trajectory is bitwise the primary's at
every version.  On promotion the old primary is **fenced**
(:meth:`fence`): its τ=0 barrier waiters wake with
:class:`~tpu_sgd_torch.replica.ha.StoreFenced` and re-route, pushes
whose ``basis_epoch`` belongs to the superseded epoch come back
``fenced=True`` (the worker re-pulls — stale work is never discounted
into the new version line), and its late checkpoint saves are refused
AND epoch-stamped so ``CheckpointManager.restore`` prefers the promoted
``(epoch, version)`` line.

Integrity (ADVICE.md "Corruption is a payload, not an exception"): push
payloads arrive as checksummed frames verified at THIS consume site (a
mismatch raises typed ``IntegrityError`` and the worker's retry
re-sends the intact bytes); a numerically implausible payload —
non-finite, or a norm beyond the ``poison_guard`` gate — is rejected
WHOLE as ``PushResult.poisoned`` exactly like a stale push; and poison
that slips through anyway (guard off, or the weights damaged in place —
see :meth:`weights_healthy`) is healed by ``ha.RollbackController``:
fence this line, restore the last good checkpoint with an epoch bump,
replay.

Sharding (``replica/shard.py``; README "Sharded store"; ADVICE.md
"Shard the apply, not the contract"): the combine — NOT the updater —
is where per-push work is separable, so
:class:`~tpu_sgd_torch.replica.shard.ShardedParameterStore` overrides
the ``_combine_*_locked`` hooks below to accumulate disjoint contiguous
coordinate ranges on S parallel per-shard pipelines and reassembles
before the ONE whole-vector apply, keeping every contract on this page.

Streams: every device op of the store and of the workers runs on the
device's current stream, the same default stream on every thread, so a
worker's sums are ordered before the apply that consumes them with no
event.

Lock discipline: ONE condition (``_cond``) guards all mutable state —
version/weights/inbox/membership mirror/EF registry — because the τ=0
barrier needs to *wait* on round application, and a second lock would
invite ordering bugs for zero concurrency win (applies must serialize
anyway: version order is the contract).  Declared in
``GRAFTLINT_LOCKS`` below.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.io.integrity import seal, verify
from tpu_sgd_torch.io.sparse_wire import ErrorFeedback
from tpu_sgd_torch.obs.counters import inc, record_wire
from tpu_sgd_torch.obs.spans import event, span
from tpu_sgd_torch.optimize.gradient_descent import (_host, apply_sums,
                                                     observe_step)
from tpu_sgd_torch.parallel.mesh import (flatten_parts, rank_order_sum,
                                         split_parts)
from tpu_sgd_torch.reliability import failpoints as _fp
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint
from tpu_sgd_torch.reliability.health import Heartbeat
from tpu_sgd_torch.replica import ha as _ha
from tpu_sgd_torch.replica.ha import DeltaRecord, StoreFailed, StoreFenced
from tpu_sgd_torch.replica.staleness import StalenessContract

logger = logging.getLogger("tpu_sgd_torch.replica.store")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: every field below is read/written from N worker threads plus the
#: driver's monitor thread; the barrier waits on ``_cond``, so the
#: condition's lock is THE lock.
GRAFTLINT_LOCKS = {
    "ParameterStore": {
        "_w": "_cond",
        "_version": "_cond",
        "_reg_val": "_cond",
        "_losses": "_cond",
        "_inbox": "_cond",
        "_inbox_order": "_cond",
        "_active": "_cond",
        "_clocks": "_cond",
        "_ef": "_cond",
        "_ef_pending": "_cond",
        "_converged": "_cond",
        "_stopped": "_cond",
        "_pushes_accepted": "_cond",
        "_pushes_rejected": "_cond",
        "_pushes_poisoned": "_cond",
        "_accepted_norms": "_cond",
        "_pulls": "_cond",
        "_max_accepted_staleness": "_cond",
        "_t_last_apply": "_cond",
        "_epoch": "_cond",
        "_fenced": "_cond",
        "_failed": "_cond",
        "_pushes_fenced": "_cond",
        "_pushes_after_done": "_cond",
        "_replication": "_cond",
        "_checkpoint_manager": "_cond:w",
        "_checkpoint_every": "_cond:w",
        "_listener": "_cond:w",
    },
}


class PulledState(NamedTuple):
    """One pull's snapshot: an immutable device weights reference plus
    the version it is HEAD at.  ``done`` tells the worker the run is
    over (budget exhausted, converged, or stopped) — no more pushes
    will be admitted.  ``epoch`` is the failover generation the
    version belongs to: a push must carry it back, so a pull taken
    against a later-superseded primary is fenced instead of silently
    merged (``replica/ha.py``)."""

    weights: object
    version: int
    reg_val: float
    done: bool
    epoch: int = 0


class PushResult(NamedTuple):
    """One push's outcome.  ``accepted=False, done=False`` means the
    push was STALE (``staleness > tau``): the worker must re-pull and
    recompute — the contract's whole point is that this work is
    discarded, not applied late.  ``fenced=True`` marks the epoch
    spelling of the same verdict: the basis belongs to a superseded
    primary, so the worker must re-pull from the promoted store.
    ``poisoned=True`` is the INTEGRITY spelling: the payload failed the
    numerical admission guard (non-finite entries, or a gradient norm
    beyond the k×rolling-median gate) — rejected WHOLE exactly like a
    stale push, so the worker restores its EF segment, re-pulls, and
    recomputes the deterministic ``(seed, version)`` contribution; the
    heal is a replay."""

    accepted: bool
    version: int
    staleness: int
    done: bool
    fenced: bool = False
    poisoned: bool = False


class ParameterStore:
    """See module docstring.  Construct once per run; workers interact
    through :meth:`pull` / :meth:`push` / :meth:`push_compressed` only.

    ``device``: where the weights live and every apply runs (``None``:
    the card, and a raise without one; tests pass ``"cpu"``).
    ``resume_state``: a ``CheckpointManager.restore()`` dict — the
    driver passes it so version / reg_val / loss history / per-worker
    EF accumulators resume exactly (weights ride ``initial_weights``).
    """

    def __init__(
        self,
        updater,
        config,
        initial_weights,
        *,
        staleness=0,
        device=None,
        listener=None,
        checkpoint_manager=None,
        checkpoint_every: int = 10,
        config_key: str = "",
        resume_state: Optional[dict] = None,
        epoch: int = 0,
        ef_registry: Optional[Dict[str, ErrorFeedback]] = None,
        name: str = "store",
        poison_guard: Optional[float] = 10.0,
        poison_warmup: int = 16,
    ):
        self.updater = updater
        self.config = config
        self.name = name
        self.contract = (staleness
                         if isinstance(staleness, StalenessContract)
                         else StalenessContract(staleness))
        self._device = resolve_device(device)
        self._listener = listener
        self._checkpoint_manager = checkpoint_manager
        self._checkpoint_every = int(checkpoint_every)
        self._config_key = config_key
        self._cond = threading.Condition()
        #: liveness marker for external watchdogs (its own lock) —
        #: ticked per pull/admit/apply; the in-process failover trigger
        #: is always a signaled StoreFailed, never a heartbeat age
        self.heartbeat = Heartbeat(f"replica.store.{name}")

        w = as_tensor(initial_weights, self._device)
        if not w.is_floating_point():
            w = w.to(torch.float32)
        # the store owns its weights: a caller's tensor is copied once
        self._w = w.clone()
        self._dim = int(self._w.numel())
        # regVal probe init, exactly as every driver initializes it
        _, rv0 = updater.compute(self._w, torch.zeros_like(self._w), 0.0,
                                 1, config.reg_param)
        self._reg_val = float(rv0)
        self._version = 0
        self._losses: list = []
        self._inbox: Dict[str, tuple] = {}
        self._inbox_order: Dict[str, int] = {}
        self._active: Dict[str, int] = {}
        self._clocks: Dict[str, int] = {}
        # ``ef_registry``: the HA driver hands ONE shared dict to every
        # store in a replicated group, so the per-worker accumulators —
        # and their carried dropped mass — survive a failover by
        # construction.  Only the CURRENT primary ever mutates it (the
        # promotion handoff is a happens-before edge under the
        # supervisor lock), so the per-store lock discipline holds.
        self._ef: Dict[str, ErrorFeedback] = (
            ef_registry if ef_registry is not None else {})
        self._ef_pending: Dict[str, np.ndarray] = {}
        self._converged = False
        self._stopped = False
        self._epoch = int(epoch)
        self._fenced = False
        self._failed = False
        self._replication = None
        # the poison-admission guard: ``poison_guard=k`` rejects a push
        # whose payload carries non-finite entries, or whose batch-mean
        # gradient norm exceeds k× the rolling median of the last 64
        # ACCEPTED norms (after ``poison_warmup`` accepted pushes —
        # early training norms are legitimately noisy).  ``None``
        # disables — the configuration whose poison the
        # RollbackController exists for
        self._poison_k = (None if poison_guard is None
                          else float(poison_guard))
        self._poison_warmup = int(poison_warmup)
        self._accepted_norms: list = []
        self._pushes_accepted = 0
        self._pushes_rejected = 0
        self._pushes_poisoned = 0
        self._pushes_fenced = 0
        # pushes answered ``done`` (the run ended while they computed):
        # with the accepted, rejected, fenced and poisoned ones, every
        # push attempt is counted once
        self._pushes_after_done = 0
        self._pulls = 0
        self._max_accepted_staleness = 0
        self._t_last_apply = time.perf_counter()

        if resume_state is not None:
            self._version = int(resume_state["iteration"])
            self._epoch = int(resume_state.get("epoch", epoch))
            self._reg_val = float(resume_state["reg_val"])
            self._losses = list(np.asarray(resume_state["loss_history"],
                                           np.float32))
            for k, v in resume_state.get("extras", {}).items():
                if k.startswith("ef_"):
                    self._ef_pending[k[3:]] = np.asarray(v, np.float32)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- membership mirror --------------------------------------------------
    def register_worker(self, worker_id: str, shard_index: int) -> None:
        """Admit ``worker_id`` to the active set (the τ=0 barrier's
        denominator and the progress bound's clock set).  A joining —
        or REJOINING — worker's clock starts at the slowest active
        worker's: a zero (or stale pre-death) clock would make every
        faster worker progress-block until the newcomer ground through
        the whole backlog, which is exactly the fleet-wide stall
        elasticity exists to avoid; it resumes at the fleet's slowest
        pace instead.  Re-registering a still-active worker is
        idempotent (its clock is live)."""
        with self._cond:
            rejoining = worker_id not in self._active
            self._active[worker_id] = int(shard_index)
            if rejoining:
                others = [self._clocks.get(w, 0) for w in self._active
                          if w != worker_id]
                self._clocks[worker_id] = min(others) if others else \
                    self._clocks.get(worker_id, 0)
            self._cond.notify_all()

    def deregister_worker(self, worker_id: str) -> None:
        """Remove a (dead or leaving) worker from the active set.  At
        τ=0 this may complete a pending round — the remaining workers'
        contributions apply rather than waiting forever on a corpse
        (elasticity: the fleet never stalls on a death)."""
        with self._cond:
            self._active.pop(worker_id, None)
            # a fenced/failed store must not apply (its inbox deposits
            # are dead — the promoted primary re-forms the round from
            # the re-routed pushes), and neither must a STOPPED one: at
            # preemption, a worker exiting between its peer's deposit
            # and its own would otherwise "complete" the round with a
            # partial batch — a half-round applied after the preempt
            # version was read, silently poisoning the resume trajectory
            if (not self._fenced and not self._failed
                    and not self._stopped
                    and self.contract.synchronous
                    and self._round_complete_locked()):
                self._apply_payloads_locked(self._drain_inbox_locked())
            self._cond.notify_all()

    def error_feedback(self, worker_id: str, frac: float) -> ErrorFeedback:
        """The per-worker EF accumulator for the compressed wire —
        created on first request, re-attached (with its carried dropped
        mass, or its checkpointed state) on rejoin/resume."""
        with self._cond:
            ef = self._ef.get(worker_id)
            if ef is None:
                ef = ErrorFeedback(self._dim, frac)
                pending = self._ef_pending.pop(worker_id, None)
                if pending is not None:
                    ef.load_state(pending)
                self._ef[worker_id] = ef
            return ef

    # -- the worker protocol ------------------------------------------------
    def pull(self, worker_id: str = "") -> PulledState:
        """Snapshot ``(weights, version, reg_val)`` at HEAD.  Never
        blocks and never gates on staleness (the contract lives at
        push-accept; see ``staleness.py``).  The returned weights are a
        tensor the store never writes — safe to compute on for as long
        as the worker likes; only its eventual push pays for the lag."""
        failpoint("replica.pull")
        with self._cond:
            self._check_live_locked("pull")
            self._pulls += 1
            inc("replica.pull")
            nbytes = self._w.numel() * self._w.element_size()
            record_wire("dense-f32", logical_nbytes=nbytes,
                        physical_nbytes=nbytes)
            event("replica.pull", worker=worker_id,
                  version=self._version)
            self.heartbeat.beat()
            return PulledState(self._w, self._version, self._reg_val,
                               self._done_locked(), self._epoch)

    def push(self, worker_id: str, basis_version: int, grad_sum,
             loss_sum, count, *,
             basis_epoch: Optional[int] = None,
             checksum: Optional[int] = None) -> PushResult:
        """One DENSE gradient-contribution push (the bitwise sync
        wire).  ``grad_sum``/``loss_sum``/``count`` are the worker's
        raw local sums (tensors on any device, or host arrays) — the
        store normalizes, exactly like the meshed combine.  Blocks at
        τ=0 until the round containing this contribution applies (or
        the run ends).  ``basis_epoch``: the epoch the basis was pulled
        at (``None`` = this store's — the single-store spelling).
        ``checksum``: the worker's seal over the payload's host bytes,
        verified HERE — the consume site — after the
        ``replica.push.wire`` corrupting failpoint (the modeled network
        hop); a mismatch raises typed IntegrityError, which the worker's
        RetryPolicy heals by re-sending the intact originals.  The host
        staging copies byte-identical values back to the device, so the
        τ=0 bitwise contract is untouched."""
        failpoint("replica.push")
        # host staging is NEEDED by exactly three consumers — the
        # checksum verify, an armed corruptpoint, and the poison gate —
        # and is a device→host copy on the card, so with all three off
        # (checksum-less push, failpoints disarmed, poison_guard=None)
        # the payload stays on the device
        stage_host = (checksum is not None or self._poison_k is not None
                      or _fp.is_enabled())
        poison = None
        if stage_host:
            g_h = _host(grad_sum)
            l_h = _host(loss_sum)
            c_h = _host(count)
            g_h, l_h, c_h = corruptpoint("replica.push.wire",
                                         (g_h, l_h, c_h))
            verify("replica.push.wire", checksum, g_h, l_h, c_h)
            poison = self._poison_stats(g_h, l_h, float(c_h))
            grad_sum, loss_sum, count = g_h, l_h, c_h
        # the explicit hop of the payload to this store's device
        g = as_tensor(grad_sum, self._device)
        l = as_tensor(loss_sum, self._device)
        c = as_tensor(count, self._device)
        nbytes = sum(t.numel() * t.element_size() for t in (g, l, c))
        record_wire("dense-f32", logical_nbytes=nbytes,
                    physical_nbytes=nbytes)
        return self._admit(worker_id, basis_version, ("sums", g, l, c),
                           basis_epoch=basis_epoch, poison=poison)

    def push_compressed(self, worker_id: str, basis_version: int,
                        indices, values, loss_sum: float,
                        count: float, *,
                        basis_epoch: Optional[int] = None,
                        checksum: Optional[int] = None) -> PushResult:
        """One COMPRESSED push: the top-k ``(indices, values)`` segment
        of the worker's EF-folded batch-mean gradient (selected by the
        worker's :class:`ErrorFeedback`, which already counted the wire
        bytes), plus host-scalar loss/count.  Matched-final-loss, not
        bitwise — the dropped mass ships on later pushes.  A segment's
        indices must be unique (a top-k segment's are): the combine
        adds each segment by a gather and a store.  Same consume-site
        checksum contract as :meth:`push`; a rejected (stale, fenced,
        poisoned, OR corrupt-retried) segment's mass is the worker's to
        restore — reject whole, never leak."""
        failpoint("replica.push")
        idx_h = np.asarray(_host(indices), np.int32).reshape(-1)
        vals_h = np.asarray(_host(values), np.float32).reshape(-1)
        idx_h, vals_h = corruptpoint("replica.push.wire",
                                     (idx_h, vals_h))
        verify("replica.push.wire", checksum, idx_h, vals_h)
        if np.unique(idx_h).size != idx_h.size:
            raise ValueError(
                f"push_compressed from {worker_id!r}: the segment repeats "
                "an index; a segment adds by a gather and a store, so its "
                "indices must be unique (a top-k segment's are)")
        idx = as_tensor(idx_h.astype(np.int64), self._device)
        vals = as_tensor(vals_h, self._device)
        poison = self._poison_stats(vals_h, np.asarray(loss_sum), None)
        return self._admit(worker_id, basis_version,
                           ("topk", idx, vals, float(loss_sum),
                            float(count)), basis_epoch=basis_epoch,
                           poison=poison)

    def _poison_stats(self, g_h, l_h, count: Optional[float]):
        """``(finite, batch_mean_norm)`` of one payload's HOST bytes —
        computed outside the lock on arrays the push already staged
        (zero added syncs).  Dense payloads normalize by the count so
        the gate compares batch-MEAN magnitudes across batch sizes;
        compressed segments already arrive at mean scale."""
        if self._poison_k is None:
            return None
        finite = bool(np.isfinite(g_h).all()) and bool(
            np.isfinite(l_h).all()) and (
            count is None or bool(np.isfinite(count)))
        norm = float(np.linalg.norm(
            np.asarray(g_h).astype(np.float64, copy=False)))
        if count is not None:
            norm /= max(float(count), 1.0)
        return (finite, norm)

    # -- internals ----------------------------------------------------------
    def _check_live_locked(self, op: str) -> None:
        """Caller holds ``_cond``.  A fenced/failed store refuses the
        worker protocol with the typed error the
        :class:`~tpu_sgd_torch.replica.ha.StoreClient` re-routes on."""
        if self._fenced:
            raise StoreFenced(
                f"store {self.name} (epoch {self._epoch}) is fenced: "
                f"{op} must re-route to the promoted primary")
        if self._failed:
            raise StoreFailed(f"store {self.name} is failed: {op} must "
                              "re-route to the promoted primary")

    def _poison_verdict_locked(self, poison) -> Optional[str]:
        """Caller holds ``_cond``.  The numerical admission gate's
        verdict for one payload's ``(finite, norm)`` stats, or None
        when the push is clean (or the guard is off)."""
        if poison is None:
            return None
        finite, norm = poison
        if not finite:
            return "non-finite payload entries"
        if len(self._accepted_norms) >= self._poison_warmup:
            med = float(np.median(self._accepted_norms))
            if med > 0.0 and norm > self._poison_k * med:
                return (f"gradient norm {norm:.4g} > {self._poison_k:g}x "
                        f"rolling median {med:.4g}")
        return None

    def _admit(self, worker_id: str, basis_version: int,
               payload: tuple,
               basis_epoch: Optional[int] = None,
               poison=None) -> PushResult:
        with self._cond:
            self._check_live_locked("push")
            self.heartbeat.beat()
            if basis_epoch is not None and basis_epoch != self._epoch:
                # the epoch fence: this basis belongs to a superseded
                # primary's version line — never discount it into ours
                # (the versions may not even be comparable); the worker
                # re-pulls HEAD from this store and recomputes
                self._pushes_fenced += 1
                inc("replica.push.fenced")
                event("replica.push", worker=worker_id,
                      basis=int(basis_version), staleness=0,
                      accepted=False, fenced=True, version=self._version)
                return PushResult(False, self._version, 0,
                                  self._done_locked(), True)
            if self._done_locked():
                self._pushes_after_done += 1
                return PushResult(False, self._version, 0, True)
            if (self.contract.bounded and not self.contract.synchronous
                    and worker_id in self._active):
                # the SSP PROGRESS bound, the basis bound's fairness
                # twin: a worker more than τ accepted pushes ahead of
                # the slowest active worker WAITS here.  Without it a
                # tight bound self-selects the fastest worker — it
                # re-pulls right after its own apply, so its next push
                # is always freshest while everyone else's goes stale,
                # and the fixed point drifts toward ITS shard's
                # objective.  The slowest active worker is never
                # blocked, so the fleet always progresses; deaths
                # deregister and re-evaluate (notify_all).
                while (not self._done_locked()
                       and worker_id in self._active
                       and self._clocks.get(worker_id, 0)
                       - min(self._clocks.get(w, 0)
                             for w in self._active)
                       >= self.contract.tau):
                    self._check_live_locked("push")  # fence wakes us
                    self._cond.wait(timeout=0.5)
                self._check_live_locked("push")
                if self._done_locked():
                    self._pushes_after_done += 1
                    return PushResult(False, self._version, 0, True)
            decision = self.contract.check(self._version,
                                           int(basis_version))
            if not decision.admissible:
                self._pushes_rejected += 1
                inc("replica.push.rejected")
                event("replica.push", worker=worker_id,
                      basis=int(basis_version),
                      staleness=decision.staleness, accepted=False,
                      version=self._version)
                return PushResult(False, self._version,
                                  decision.staleness, False)
            # the poison-admission gate: a numerically implausible
            # payload is rejected WHOLE before it can touch the inbox or
            # the version line — the worker restores its EF segment and
            # recomputes from (seed, version), so the heal is a
            # deterministic replay, exactly like a staleness rejection
            bad = self._poison_verdict_locked(poison)
            if bad is not None:
                self._pushes_poisoned += 1
                inc("replica.push.poisoned")
                inc("integrity.corrupt")
                inc("integrity.corrupt.replica.push.poison")
                event("replica.push", worker=worker_id,
                      basis=int(basis_version),
                      staleness=decision.staleness, accepted=False,
                      poisoned=True, version=self._version,
                      detail=bad)
                return PushResult(False, self._version,
                                  decision.staleness,
                                  self._done_locked(), poisoned=True)
            self._pushes_accepted += 1
            if poison is not None:
                # the gate's rolling baseline grows from ACCEPTED
                # norms only (a rejected spike must not legitimize the
                # next one), bounded to the trailing 64
                self._accepted_norms.append(poison[1])
                if len(self._accepted_norms) > 64:
                    del self._accepted_norms[0]
            if decision.staleness > self._max_accepted_staleness:
                self._max_accepted_staleness = decision.staleness
            inc("replica.push.accepted")
            event("replica.push", worker=worker_id,
                  basis=int(basis_version),
                  staleness=decision.staleness, accepted=True,
                  version=self._version)
            if self.contract.synchronous:
                # τ=0: deposit into the round's inbox; the contribution
                # that completes the round applies it (combined, shard
                # order), everyone else waits for the version to move
                self._inbox[worker_id] = payload
                self._inbox_order[worker_id] = self._active.get(
                    worker_id, 1 << 30)
                if self._round_complete_locked():
                    self._apply_payloads_locked(
                        self._drain_inbox_locked())
                else:
                    basis = int(basis_version)
                    while (self._version <= basis
                           and not self._done_locked()
                           and worker_id in self._inbox):
                        if self._fenced or self._failed:
                            # the round died with this store: drop the
                            # deposit (the promoted primary re-forms
                            # the round from re-routed pushes) and
                            # re-route the waiter
                            self._inbox.pop(worker_id, None)
                            self._inbox_order.pop(worker_id, None)
                            self._check_live_locked("push")
                        self._cond.wait(timeout=0.5)
                return PushResult(True, self._version, decision.staleness,
                                  self._done_locked())
            # async (τ >= 1 / unbounded): this push IS the next step
            self._clocks[worker_id] = self._clocks.get(worker_id, 0) + 1
            self._apply_payloads_locked([payload])
            return PushResult(True, self._version, decision.staleness,
                              self._done_locked())

    def _combine_sums_locked(self, payloads):
        """Combine admitted DENSE payloads (payload order = shard order
        for a τ=0 round) into device ``(grad_sum, loss_sum, count)``:
        each payload's three parts flattened at their promoted dtype and
        added one payload at a time (``parallel.mesh.combine_sums``'s
        arithmetic, which the τ=0 bitwise contract pins).  The sharded
        store (``replica/shard.py``) overrides this to run the same
        coordinate-wise add chain per shard in parallel; the apply
        itself stays whole-vector either way."""
        parts = payloads[0][1:]
        if len(payloads) == 1:
            return parts
        total = rank_order_sum([flatten_parts(*p[1:]) for p in payloads])
        return split_parts(total, parts)

    def _combine_topk_locked(self, payloads):
        """Combine admitted COMPRESSED payloads into a dense device
        accumulator plus host ``(loss_sum, count)`` scalars: each
        segment added in payload order by a gather, an add and a store
        at its (unique) indices, never a float atomic; the sharded
        store overrides this with the SparCML per-shard tree merge
        (:func:`~tpu_sgd_torch.io.sparse_wire.merge_sparse_segments`)."""
        g = torch.zeros((self._dim,), dtype=torch.float32,
                        device=self._device)
        l_host = 0.0
        c_host = 0.0
        for _, idx, vals, li, ci in payloads:
            g.index_put_((idx,), g.index_select(0, idx)
                         + vals.to(torch.float32))
            l_host += li
            c_host += ci
        return g, l_host, c_host

    def shard_layout(self):
        """Per-shard ``(start, stop)`` coordinate ranges of a SHARDED
        store (``replica/shard.py``), or ``None``: this store applies
        the whole vector through one pipeline.  Workers probe this once
        to decide whether to seal compressed segments per-shard."""
        return None

    def _round_complete_locked(self) -> bool:
        return bool(self._active) and set(self._active) <= set(self._inbox)

    def _drain_inbox_locked(self) -> list:
        """Pop the round's contributions in SHARD order — the
        deterministic combine order the τ=0 bitwise contract needs
        (arrival order is thread-scheduling noise)."""
        order = sorted(self._inbox,
                       key=lambda k: (self._inbox_order.get(k, 1 << 30), k))
        payloads = [self._inbox.pop(k) for k in order]
        self._inbox_order.clear()
        return payloads

    def _apply_payloads_locked(self, payloads) -> None:
        """Combine ``payloads`` (already admitted; shard order for a
        τ=0 round) into ONE applied update: version += 1 and the shared
        observed-loop bookkeeping (``observe_step`` — loss history,
        listener event, convergence, checkpoint cadence)."""
        i = self._version + 1
        dev = self._device
        i_dev = torch.full((1,), i, dtype=torch.int64, device=dev)
        rv_dev = torch.full((), self._reg_val, dtype=torch.float32,
                            device=dev)
        # replication wire: capture the record's host bytes (the delta
        # log — not the weights — is the replication unit; ha.py)
        ship = (None if self._replication is None
                else [self._host_payload(p) for p in payloads])
        with span("replica.apply", version=i, n_payloads=len(payloads)):
            if payloads[0][0] in ("sums", "ssums"):
                # the synchronous step's post-combine math (the store IS
                # the combine): the meshed step's own function and bits
                g, l, c = self._combine_sums_locked(payloads)
                new_w, loss_i, new_reg = apply_sums(
                    self.updater, self.config, self._w, g, l, c, i_dev,
                    rv_dev)
                count = c
            else:
                # compressed: g is a sum of len(payloads) batch-mean
                # gradient approximations; only the loss needs the count
                g, l_host, c_host = self._combine_topk_locked(payloads)
                new_w, loss_i, new_reg = apply_sums(
                    self.updater, self.config, self._w, g,
                    torch.full((), l_host, dtype=torch.float32, device=dev),
                    torch.full((), c_host, dtype=torch.float32, device=dev),
                    i_dev, rv_dev,
                    denom=torch.full((), float(len(payloads)),
                                     dtype=torch.float32, device=dev))
                count = c_host
            inc("replica.apply")
            now = time.perf_counter()
            dt, self._t_last_apply = now - self._t_last_apply, now
            # the shared observed-loop bookkeeping — this store is a
            # consumer beside the streamed drivers
            self._w, self._reg_val, conv = observe_step(
                i, self._w, new_w, loss_i, new_reg, count,
                self._losses, self._reg_val, self.config,
                listener=self._listener, wall_dt=dt,
                save_cb=(self._save
                         if self._checkpoint_manager is not None
                         else None),
                save_every=self._checkpoint_every,
            )
        self._version = i
        if conv:
            self._converged = True
        self.heartbeat.beat()
        if ship is not None:
            try:
                record = DeltaRecord(self._epoch, i, ship[0][0],
                                     tuple(ship))
                # seal the record's payload bytes at capture — the
                # standby's replay verifies at ITS consume site, so a
                # record damaged in the log/wire can never silently
                # fork the standby-bitwise trajectory (ha.py)
                record = record._replace(
                    checksum=seal(*_ha.record_arrays(record)))
                self._replication(record)
                inc("replica.replicate")
            except StoreFenced:
                # we were promoted over DURING this apply (the fence
                # serialized after our lock): this version is ours
                # alone — the promoted line recomputes it from
                # (seed, version), so refusing the record loses nothing
                self._fenced = True
                logger.warning(
                    "store %s: version %d applied after fencing; record "
                    "refused by the delta log (the promoted primary "
                    "recomputes it)", self.name, i)
            except Exception:
                # replication must not kill the primary's apply; a
                # standby that misses a record fails its continuity
                # check and drops to cold-recovery territory, loudly
                logger.warning(
                    "store %s: delta record for version %d failed to "
                    "replicate", self.name, i, exc_info=True)
        self._cond.notify_all()

    # -- replication (the HA delta log; replica/ha.py) ------------------------
    def _host_payload(self, p: tuple) -> tuple:
        """One admitted payload as replayable HOST bytes."""
        if p[0] == "sums":
            return ("sums", _host(p[1]), _host(p[2]), _host(p[3]))
        return ("topk", np.asarray(_host(p[1]), np.int32), _host(p[2]),
                float(p[3]), float(p[4]))

    def _device_payload(self, p: tuple) -> tuple:
        """The standby-side inverse of :meth:`_host_payload`: the same
        bytes staged on THIS store's device, so the replayed combine is
        bit-identical to the primary's."""
        if p[0] == "sums":
            return ("sums",) + tuple(
                as_tensor(np.asarray(a, np.float32), self._device)
                for a in p[1:4])
        return ("topk",
                as_tensor(np.asarray(p[1], np.int64), self._device),
                as_tensor(np.asarray(p[2], np.float32), self._device),
                float(p[3]), float(p[4]))

    def set_replication(self, ship) -> None:
        """Route every applied version's delta record through ``ship``
        (the supervisor wires ``DeltaLog.append`` here; ``None``
        disables)."""
        with self._cond:
            self._replication = ship

    def apply_replica_record(self, record) -> None:
        """Standby-side replay of one delta record: the same shard-order
        combine and the same ``observe_step`` bookkeeping as the
        primary's apply, so the trajectory is bitwise at every version.
        Records must arrive in version order (the log guarantees it);
        a fenced/failed store refuses."""
        with self._cond:
            self._check_live_locked("apply_replica_record")
            if record.version != self._version + 1:
                raise StoreFailed(
                    f"store {self.name}: replica record version "
                    f"{record.version} does not chain onto local "
                    f"version {self._version}")
            self._apply_payloads_locked(
                [self._device_payload(p) for p in record.payloads])

    # -- the failover surface (driven by ha.StoreSupervisor) -----------------
    def fence(self) -> None:
        """Supersede this store: every τ=0 barrier / SSP waiter wakes
        with :class:`StoreFenced` and re-routes, later pushes/pulls are
        refused, and late checkpoint saves are dropped (loudly)."""
        with self._cond:
            self._fenced = True
            self._cond.notify_all()

    def mark_failed(self) -> None:
        """Record a crash (a dead standby, an operator kill): the store
        refuses the protocol but is NOT epoch-superseded."""
        with self._cond:
            self._failed = True
            self._cond.notify_all()

    def set_epoch(self, epoch: int) -> None:
        """Promotion-time epoch bump (the supervisor moves every
        surviving store forward together)."""
        with self._cond:
            if epoch < self._epoch:
                raise ValueError(
                    f"store epoch can only advance: {self._epoch} -> "
                    f"{epoch}")
            self._epoch = int(epoch)
            self._cond.notify_all()

    def attach_primary(self, *, checkpoint_manager=None,
                       checkpoint_every: int = 10,
                       listener=None) -> None:
        """Promotion: a standby inherits the primary surface —
        checkpoint cadence and the run listener (its applies were
        silent until now; events resume from the promoted version)."""
        with self._cond:
            self._checkpoint_manager = checkpoint_manager
            self._checkpoint_every = int(checkpoint_every)
            self._listener = listener

    # -- the integrity surface (ha.RollbackController) -----------------------
    def weights_healthy(self) -> bool:
        """True iff every resident weight is finite — the cheap
        corruption probe the rollback controller polls.  A False here
        means poison already REACHED the version line (guard off, or the
        weights damaged in place): promotion cannot help — every standby
        replayed the same delta — so the answer is a rollback, not a
        failover."""
        with self._cond:
            w = self._w
        return bool(torch.isfinite(w).all())

    def corrupt_weights_for_chaos(self, index: int = 0) -> None:
        """Chaos/test handle (never called by production code): damage
        ONE resident weight with NaN — modeling poison that slipped past
        the admission guard into the weights themselves.  The weights
        are replaced by a damaged copy (pulled references stay intact).
        The fleet then spins on poisoned-rejected pushes (every pulled
        basis is non-finite) until the RollbackController fences this
        line and restores the last good checkpoint."""
        with self._cond:
            w = self._w.clone()
            flat = w.reshape(-1)
            flat[int(index) % flat.numel()] = float("nan")
            self._w = w
            self._cond.notify_all()

    @property
    def epoch(self) -> int:
        with self._cond:
            return self._epoch

    @property
    def fenced(self) -> bool:
        with self._cond:
            return self._fenced

    @property
    def failed(self) -> bool:
        with self._cond:
            return self._failed

    def _save(self, iteration: int, w_np, reg_val: float) -> None:
        """Checkpoint the store: weights + version (the ``iteration``
        field) + loss history + every worker's EF accumulator as
        ``ef_<worker_id>`` extras, stamped with the store EPOCH so
        ``CheckpointManager.restore`` prefers the promoted ``(epoch,
        version)`` line over a fenced primary's late save.  Runs under
        ``_cond`` always: its direct call site (``save_now``) holds it,
        and as ``observe_step``'s ``save_cb`` it fires inside
        ``_apply_payloads_locked``'s locked region."""
        if self._fenced:
            # belt (the epoch stamp is the braces): a fenced primary
            # must never shadow the promoted store's newer state
            logger.warning(
                "store %s: refusing checkpoint save at version %d — "
                "fenced (epoch %d superseded)", self.name, iteration,
                self._epoch)
            return
        extras = ({f"ef_{wid}": ef.state()
                   for wid, ef in self._ef.items()}
                  or None)
        self._checkpoint_manager.save(
            iteration, _host(w_np), reg_val,
            np.asarray(self._losses), self._config_key,
            extras=extras, epoch=self._epoch)

    def _done_locked(self) -> bool:
        return (self._version >= self.config.num_iterations
                or self._converged or self._stopped)

    # -- driver surface -----------------------------------------------------
    def stop(self) -> None:
        """Cooperative stop: wakes every τ=0 waiter and makes the next
        pull/push report ``done`` — the preemption path's first half
        (the driver then checkpoints via :meth:`save_now`)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def save_now(self) -> None:
        """Persist the CURRENT state (preemption / final save) through
        the attached ``CheckpointManager`` — weights, version (as the
        ``iteration`` field), reg_val, loss history, and every
        registered worker's EF accumulator as ``ef_<worker_id>``
        extras."""
        with self._cond:
            if self._checkpoint_manager is not None:
                self._save(self._version, _host(self._w),
                           self._reg_val)

    def wait_done(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the run is done (budget / convergence / stop);
        returns False on timeout."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cond:
            while not self._done_locked():
                if self._fenced or self._failed:
                    return False  # superseded: the caller re-polls the
                    # promoted primary (never "done" — never hangs)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=(0.5 if remaining is None
                                         else min(0.5, remaining)))
            return True

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    @property
    def weights(self):
        with self._cond:
            return self._w

    @property
    def converged(self) -> bool:
        with self._cond:
            return self._converged

    def loss_history(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._losses, np.float32)

    def snapshot(self) -> dict:
        """Ops/bench snapshot: version, push/pull counters (every push
        attempt lands in exactly one of accepted, rejected, poisoned,
        fenced and after-done), the maximum staleness any ACCEPTED push
        carried (the trace-level bound assertion's cheap twin), and the
        active-worker count."""
        with self._cond:
            return {
                "version": self._version,
                "epoch": self._epoch,
                "pulls": self._pulls,
                "pushes_accepted": self._pushes_accepted,
                "pushes_rejected": self._pushes_rejected,
                "pushes_poisoned": self._pushes_poisoned,
                "pushes_fenced": self._pushes_fenced,
                "pushes_after_done": self._pushes_after_done,
                "max_accepted_staleness": self._max_accepted_staleness,
                "active_workers": len(self._active),
                "converged": self._converged,
                "stopped": self._stopped,
                "fenced": self._fenced,
                "failed": self._failed,
            }
