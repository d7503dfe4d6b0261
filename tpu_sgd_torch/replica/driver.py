"""Async elastic multi-replica training driver (the port of
``tpu_sgd/replica/driver.py``).

``ReplicaDriver`` is the user-facing entry of ``tpu_sgd_torch.replica``:
N worker threads (one data shard each, the mesh's row-block layout)
train against one bounded-staleness
:class:`~tpu_sgd_torch.replica.store.ParameterStore` (README "Async
replicas"; the staleness semantics — and why the bound is enforced at
push-accept, not pull — are in ``staleness.py`` and ADVICE.md
"Staleness is a contract, not a tuning knob")::

    from tpu_sgd_torch.replica import ReplicaDriver

    w, hist = (ReplicaDriver(gradient, updater)
               .set_num_iterations(200).set_mini_batch_fraction(0.2)
               .set_workers(4).set_staleness(2)
               .optimize_with_history((X, y), w0))

* Devices: every visible CUDA device by default, the store on the
  first and the workers round-robin over them; without a card it
  raises, unless ``set_devices(["cpu"])`` (or ``device="cpu"``) asks
  for the CPU.  Rows already on a worker's device stay where they are
  (each worker gets a view of its row block); host rows are staged to
  each worker's device once.
* ``staleness=0`` runs bulk-synchronous rounds whose trajectory is
  BITWISE the synchronous data-parallel path's (the meshed run over the
  same shard count, which equals a one-process rank-order sum — pinned
  in ``tests/test_torch_replica.py``); ``staleness=tau >= 1`` admits
  pushes up to ``tau`` versions stale, each applied as its own update
  step; ``staleness=None`` is unbounded.
* **Elasticity**: a worker thread that dies (injected fault, real
  crash) deregisters from the store — a τ=0 round in flight completes
  with the survivors — and the driver rejoins it with seeded backoff
  (``rejoin`` RetryPolicy budget); the rejoined worker re-pulls HEAD
  and re-attaches its error-feedback accumulator, so no fleet-wide
  stall and no lost EF mass.  Straggling workers simply lag: at
  ``tau >= 1`` the fleet streams past them (their eventual pushes are
  rejected once beyond the bound and recomputed fresh).
* **Reliability reuse**: the ``replica.pull`` / ``replica.push``
  failpoints heal under the per-worker ``RetryPolicy``
  (``set_retry``); membership heartbeats feed a ``HealthMonitor``;
  ``set_checkpoint`` + ``set_stop_signal`` make the driver a drop-in
  ``TrainingSupervisor`` citizen — preemption checkpoints the store
  (weights, version, loss history, per-worker EF extras) and unwinds
  with ``TrainingPreempted``; a re-run resumes from that exact
  version.  The checkpoints are the JAX package's format both ways.
* **Compressed wire**: ``set_wire_compress("topk:<frac>")`` ships each
  push as a top-k segment through the worker's persistent
  ``ErrorFeedback`` accumulator — matched final loss, ~``2*frac``× the
  dense push bytes.
* **High availability**: ``set_standbys(n)`` replicates the store —
  every applied version ships as a delta-log record to ``n`` standby
  stores, a ``StoreSupervisor`` promotes the most-advanced standby on
  primary loss (epoch-fenced, gap-replayed; README "Store failover",
  ADVICE.md "Failover is a replay, not a restart"), and workers reach
  the group through a partition-tolerant ``StoreClient``
  (``replica/ha.py``).  τ=0 with a primary killed mid-round stays
  BITWISE the fault-free run.  Runtime chaos/ops handles while a run
  is live: :meth:`kill_primary`, :meth:`partition_worker`,
  :meth:`heal_worker`.

The driver deliberately does NOT subclass ``GradientDescent``: the
async update rule is the store's, not a schedule knob on the sync
optimizer — a τ>0 run is a DIFFERENT algorithm (matched loss, not
matched trajectory), and hiding that behind flags would blur the one
line users must see.
"""

from __future__ import annotations

import threading
import time
import warnings
import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.io.sparse_wire import parse_wire_compress
from tpu_sgd_torch.ops.gradients import Gradient, LeastSquaresGradient
from tpu_sgd_torch.ops.sparse import is_sparse
from tpu_sgd_torch.ops.updaters import SimpleUpdater, Updater
from tpu_sgd_torch.replica.membership import ReplicaMembership
from tpu_sgd_torch.replica.staleness import StalenessContract
from tpu_sgd_torch.replica.store import ParameterStore
from tpu_sgd_torch.replica.worker import ReplicaWorker
from tpu_sgd_torch.utils.events import RunEvent


def shard_rows(X, y, n_shards: int):
    """Split rows into ``n_shards`` equal blocks — the SAME layout a mesh
    gets (``parallel.data_parallel.pad_to_multiple``: zero-pad to a shard
    multiple, contiguous row blocks, padding masked invalid), so shard
    ``i`` here holds bit-identical rows to mesh shard ``i`` and the τ=0
    trajectory can be compared bitwise.  Returns a list of ``(X_i, y_i,
    valid_i-or-None)``.  Host rows (numpy) come back as numpy.  A
    tensor's blocks are VIEWS of it when no padding is needed (a 20 GB X
    on the card is not copied); otherwise the padded rows are one new
    tensor on X's device, and ``valid_i`` a bool tensor."""
    n = X.shape[0]
    if not isinstance(X, torch.Tensor):
        from tpu_sgd_torch.parallel.data_parallel import pad_to_multiple

        Xp, yp, valid = pad_to_multiple(np.asarray(X), np.asarray(y),
                                        n_shards)
        no_pad = Xp.shape[0] == n
    else:
        y = torch.as_tensor(y, device=X.device)
        rem = (-n) % n_shards
        no_pad = rem == 0
        Xp, yp, valid = X, y, None
        if not no_pad:
            Xp = torch.cat([X, X.new_zeros((rem,) + tuple(X.shape[1:]))])
            yp = torch.cat([y, y.new_zeros((rem,))])
            valid = torch.arange(n + rem, device=X.device) < n
    n_local = Xp.shape[0] // n_shards
    out = []
    for s in range(n_shards):
        sl = slice(s * n_local, (s + 1) * n_local)
        out.append((Xp[sl], yp[sl], None if no_pad else valid[sl]))
    return out


class ReplicaDriver:
    """See module docstring.  ``device``: the one device of the store and
    every worker (``None``: every visible CUDA device, or
    :meth:`set_devices`'s list)."""

    def __init__(
        self,
        gradient: Gradient = None,
        updater: Updater = None,
        config: SGDConfig = None,
        *,
        n_workers: int = 2,
        staleness=0,
        device=None,
    ):
        self.gradient = (gradient if gradient is not None
                         else LeastSquaresGradient())
        self.updater = updater if updater is not None else SimpleUpdater()
        self.config = config if config is not None else SGDConfig()
        self.n_workers = int(n_workers)
        self.staleness = staleness
        self.n_standbys = 0
        self.store_shards = 1
        self.poison_guard: object = 10.0
        self._integrity_rollback = False
        self.wire_compress = None
        self.resident_rounds = 0
        self.listener = None
        self.checkpoint_manager = None
        self.checkpoint_every = 10
        self.retry_policy = None
        self.rejoin_policy = None
        self.devices = None if device is None else [device]
        self._stop_signal = None
        self._loss_history = None
        self._live_client = None
        self._live_supervisor = None
        self.last_store_snapshot = None
        self.last_membership_snapshot = None
        self.last_windows_snapshot = None
        self.last_failover_snapshot = None
        self.last_supervisor = None

    # -- fluent config (the GradientDescent subset that applies) -----------
    def set_step_size(self, s: float):
        self.config = self.config.replace(step_size=float(s))
        return self

    def set_num_iterations(self, n: int):
        if n < 1:
            raise ValueError(f"num_iterations must be positive, got {n}")
        self.config = self.config.replace(num_iterations=int(n))
        return self

    def set_reg_param(self, r: float):
        self.config = self.config.replace(reg_param=float(r))
        return self

    def set_mini_batch_fraction(self, f: float):
        if not 0.0 < f <= 1.0:
            raise ValueError("mini_batch_fraction must be in (0, 1]")
        self.config = self.config.replace(mini_batch_fraction=float(f))
        return self

    def set_convergence_tol(self, t: float):
        if not 0.0 <= t <= 1.0:
            raise ValueError("convergence_tol must be in [0, 1]")
        self.config = self.config.replace(convergence_tol=float(t))
        return self

    def set_seed(self, s: int):
        self.config = self.config.replace(seed=int(s))
        return self

    def set_sampling(self, mode: str):
        self.config = self.config.replace(sampling=mode)
        return self

    def set_workers(self, n: int):
        if int(n) < 1:
            raise ValueError(f"n_workers must be >= 1, got {n}")
        self.n_workers = int(n)
        return self

    def set_staleness(self, tau):
        """``0`` = synchronous rounds (bitwise vs the meshed sync
        path), ``tau >= 1`` = bounded async, ``None`` = unbounded.
        Validated eagerly through :class:`StalenessContract`."""
        StalenessContract(tau)  # validate now, not mid-run
        self.staleness = tau
        return self

    def set_standbys(self, n: int):
        """``n >= 1`` replicates the parameter store: every applied
        version ships as a delta-log record to ``n`` standbys, and a
        ``StoreSupervisor`` fails over deterministically on primary
        loss (``replica/ha.py``).  ``0`` (default) keeps the
        single-store path."""
        if int(n) < 0:
            raise ValueError(f"n_standbys must be >= 0, got {n}")
        self.n_standbys = int(n)
        return self

    def set_store_shards(self, n: int):
        """``n >= 2`` shards the parameter store's apply plane: each
        push's coordinates split across ``n`` per-shard pipelines that
        combine in parallel before the ONE whole-vector apply
        (``replica/shard.py``; README "Sharded store").  Every store
        contract — τ=0 bitwise, the delta log, failover — is preserved
        at any ``n``.  ``1`` (default) keeps the unsharded store."""
        if int(n) < 1:
            raise ValueError(f"store_shards must be >= 1, got {n}")
        self.store_shards = int(n)
        return self

    def set_poison_guard(self, k):
        """``k`` arms the store's numerical admission gate: a push
        with non-finite entries — or a batch-mean gradient norm beyond
        ``k``× the rolling median of recent accepted norms — comes back
        ``PushResult.poisoned`` and the worker recomputes from ``(seed,
        version)`` (default ``10.0``).  ``None``/``False`` disables —
        the configuration whose slipped-through poison
        :meth:`set_integrity_rollback` exists for."""
        if k is False:
            k = None
        if k is not None and float(k) <= 1.0:
            raise ValueError(
                f"poison_guard must be > 1 (a gate at <= 1x the median "
                f"rejects healthy noise), got {k}")
        self.poison_guard = None if k is None else float(k)
        return self

    def set_integrity_rollback(self, enabled: bool = True):
        """Arm corrupt-state rollback: the monitor loop polls the
        primary's :meth:`ParameterStore.weights_healthy` and, on
        non-finite weights, drives
        :class:`~tpu_sgd_torch.replica.ha.RollbackController` — fence the
        poisoned line, restore the last checksummed-good finite
        checkpoint with an epoch bump, replay.  Implies the HA
        supervisor (a rollback IS a failover to your own past), so a
        run with ``n_standbys=0`` still gets one, with zero standby
        stores."""
        self._integrity_rollback = bool(enabled)
        return self

    def set_wire_compress(self, spec):
        """``"topk:<frac>"`` routes every push through the compressed
        wire (per-worker error feedback; matched final loss);
        ``None``/``False`` restores the dense bitwise wire."""
        if spec is False:
            spec = None
        parse_wire_compress(spec)  # eager validation
        self.wire_compress = spec
        return self

    def set_resident_rounds(self, k):
        """``k >= 1`` runs every worker in RESIDENT mode (the JAX
        package's): a round is ``k`` supersteps of the shared local sums
        against one pulled basis, one push and one pull, and on a card the
        round is one CUDA graph, captured once a worker on its own card and
        replayed once a round (``replica/worker.py``).  ``k=1`` is per-push
        bitwise with the per-cycle loop (τ=0 keeps the sync pin); ``k >=
        2`` folds ``k`` sampled batches into one contribution per protocol
        round — matched loss, not bitwise.  Needs one device per worker (a
        resident worker owns its card for its captures and replays); a
        fleet that shares a device falls back LOUDLY to the per-cycle loop.
        On the CPU (``device="cpu"``, one device) a one-worker fleet runs
        the rounds eagerly.  ``0``/``None``/``False`` (default) keeps the
        per-cycle loop."""
        if k is None or k is False:
            k = 0
        if int(k) < 0:
            raise ValueError(f"resident_rounds must be >= 0, got {k}")
        self.resident_rounds = int(k)
        return self

    def set_retry(self, policy):
        """Per-worker ``RetryPolicy`` healing transient pull/push
        faults (the ``replica.pull``/``replica.push`` failpoints) in
        place."""
        self.retry_policy = policy
        return self

    def set_rejoin(self, policy):
        """``RetryPolicy`` bounding worker REJOINS: ``max_attempts``
        deaths per worker before the run aborts (backoff seeds the
        rejoin delay).  Defaults to a 5-attempt seeded policy."""
        self.rejoin_policy = policy
        return self

    def set_devices(self, devices):
        """Explicit device list; workers round-robin over it, the store
        lives on the first.  ``None`` (default): every visible CUDA
        device (and a raise without one)."""
        self.devices = list(devices) if devices is not None else None
        return self

    def set_listener(self, listener):
        self.listener = listener
        return self

    def set_checkpoint(self, manager, every: int = 10):
        self.checkpoint_manager = manager
        self.checkpoint_every = int(every)
        return self

    def set_stop_signal(self, stop_signal):
        self._stop_signal = stop_signal
        return self

    # -- run ---------------------------------------------------------------
    @property
    def loss_history(self):
        return self._loss_history

    def windows(self):
        """The LIVE windowed time-series for the replica subsystem
        (``tpu_sgd_torch.obs.timeseries``): per-window
        ``replica.step[wid]`` durations/counts (the per-worker
        straggler-skew surface), push/pull counters, and the
        accepted-push ``staleness`` value series.  Scrape it from
        another thread mid-run; ``None`` when the time series is off.
        The final snapshot of a finished run survives as
        ``last_windows_snapshot``."""
        from tpu_sgd_torch.obs import timeseries

        return timeseries.snapshot(prefix="replica")

    def resolved_devices(self) -> list:
        """The run's devices: :meth:`set_devices`'s list (or the
        constructor's ``device``), else every visible CUDA device.
        Raises without a card unless the CPU was asked for."""
        if self.devices is not None:
            return [resolve_device(d) for d in self.devices]
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    # -- runtime chaos/ops handles (HA runs only, while live) ---------------
    def kill_primary(self) -> bool:
        """Fail the CURRENT primary store of a live HA run and promote
        (the chaos/ops kill switch).  False when no HA run is live or
        the run already finished."""
        sup = self._live_supervisor
        if sup is None:
            return False
        try:
            if sup.primary().wait_done(timeout_s=0.0):
                return False  # the run is over: nothing to fail over
        except Exception:
            pass
        return sup.kill_primary()

    def partition_worker(self, worker_id: str) -> bool:
        """Cut one worker of a live HA run off from every store (its
        accesses raise ``StoreUnreachable`` until :meth:`heal_worker`)."""
        client = self._live_client
        if client is None:
            return False
        client.partition(worker_id)
        return True

    def heal_worker(self, worker_id: str) -> bool:
        client = self._live_client
        if client is None:
            return False
        client.heal(worker_id)
        return True

    def chaos_corrupt_weights(self, index: int = 0) -> bool:
        """Damage ONE resident weight of the live primary with NaN (the
        forced weight-corruption chaos cell — models poison past the
        admission guard).  False when no HA run is live."""
        sup = self._live_supervisor
        if sup is None:
            return False
        try:
            sup.settled_primary().corrupt_weights_for_chaos(index)
            return True
        except Exception:
            return False

    def rollback(self, reason: str = "operator rollback") -> bool:
        """Manually drive the corrupt-state rollback of a live HA run
        (the automatic spelling is :meth:`set_integrity_rollback`)."""
        sup = self._live_supervisor
        if sup is None:
            return False
        from tpu_sgd_torch.replica.ha import RollbackController

        return RollbackController(sup).rollback(reason)

    def optimize(self, data, initial_weights):
        w, _ = self.optimize_with_history(data, initial_weights)
        return w

    def _resident_rounds_for(self, devices) -> int:
        """The rounds a worker of this run folds
        (:meth:`set_resident_rounds`): ``k`` when every worker gets a
        device of its own from the round-robin over ``devices``, else 0
        with the JAX package's warning (the per-cycle loop)."""
        k = self.resident_rounds
        if k < 1:
            return 0
        own = {devices[s % len(devices)] for s in range(self.n_workers)}
        if len(own) < self.n_workers:
            warnings.warn(
                f"resident replica mode needs one device per worker "
                f"({self.n_workers} workers, {len(set(devices))} "
                "devices): a resident worker holds its device for the "
                "whole run, so co-scheduled fleets serialize (and "
                "deadlock on the τ=0 round barrier) — falling back to "
                "the per-cycle threaded loop",
                RuntimeWarning, stacklevel=3)
            return 0
        return k

    def optimize_with_history(self, data, initial_weights):
        from tpu_sgd_torch.optimize.gradient_descent import _coerce_w0
        from tpu_sgd_torch.reliability.retry import RetryPolicy
        from tpu_sgd_torch.reliability.supervisor import TrainingPreempted

        X, y = data
        if is_sparse(X):
            raise NotImplementedError(
                "ReplicaDriver trains dense rows, as the JAX package's "
                "does; densify X or train sparse features with "
                "GradientDescent")
        cfg = self.config
        devices = self.resolved_devices()
        resident_rounds = self._resident_rounds_for(devices)
        store_dev = devices[0]
        w0 = _coerce_w0(self.gradient, initial_weights, X.shape[1],
                        store_dev)
        frac = parse_wire_compress(self.wire_compress)
        config_key = repr((
            "replica", type(self.gradient).__name__,
            type(self.updater).__name__, cfg, self.n_workers,
            StalenessContract(self.staleness).tau, self.wire_compress,
            self.resident_rounds,
        ))

        resume_state = None
        if self.checkpoint_manager is not None:
            resume_state = self.checkpoint_manager.restore()
            if resume_state is not None:
                if (resume_state["config_key"]
                        and resume_state["config_key"] != config_key):
                    warnings.warn(
                        "checkpoint config differs from current config; "
                        "resuming anyway",
                        RuntimeWarning, stacklevel=3,
                    )
                w0 = np.asarray(resume_state["weights"])
        membership = ReplicaMembership(listener=self.listener)
        # store_shards > 1 swaps in the sharded store; at 1 the plain
        # store is constructed (replica/shard.py)
        if self.store_shards > 1:
            from tpu_sgd_torch.replica.shard import ShardedParameterStore
            _store_cls = ShardedParameterStore
            _shard_kw: dict = {"n_shards": self.store_shards}
        else:
            _store_cls = ParameterStore
            _shard_kw = {}
        supervisor = None
        # armed integrity rollback implies the HA supervisor even with
        # zero standbys: a rollback IS a (cold) failover to your own
        # past, and the epoch fence is what keeps in-flight poisoned
        # pushes out of the restored line
        if self.n_standbys > 0 or self._integrity_rollback:
            from tpu_sgd_torch.replica.ha import StoreSupervisor

            # ONE error-feedback registry shared by every store in the
            # group: the per-worker accumulators (and their carried
            # dropped mass) survive any failover by construction
            shared_ef: dict = {}
            epoch0 = (int(resume_state.get("epoch", 0))
                      if resume_state is not None else 0)

            def _mk_store(name, *, listener=None, manager=None,
                          resume=resume_state, weights=w0):
                # every store in the group gets the SAME shard count:
                # a standby's replay of a per-shard payload group must
                # route identically to the primary's combine
                return _store_cls(
                    self.updater, cfg, weights,
                    staleness=self.staleness, device=store_dev,
                    listener=listener, checkpoint_manager=manager,
                    checkpoint_every=self.checkpoint_every,
                    **_shard_kw,
                    config_key=config_key, resume_state=resume,
                    epoch=epoch0, ef_registry=shared_ef, name=name,
                    poison_guard=self.poison_guard,
                )

            def _cold_factory(state, name):
                # double-failure cold recovery: a fresh store from the
                # last checkpoint (or from scratch — τ=0 recomputes the
                # lost versions bitwise from (seed, version))
                return _mk_store(
                    name, resume=state,
                    weights=(np.asarray(state["weights"])
                             if state is not None else w0))

            primary = _mk_store("s0", listener=self.listener,
                                manager=self.checkpoint_manager)
            standby_stores = [_mk_store(f"s{i}")
                              for i in range(1, self.n_standbys + 1)]
            supervisor = StoreSupervisor(
                [primary] + standby_stores,
                membership=membership,
                checkpoint_manager=self.checkpoint_manager,
                checkpoint_every=self.checkpoint_every,
                listener=self.listener,
                store_factory=_cold_factory,
            )
            store = supervisor.client()
        else:
            store = _store_cls(
                self.updater, cfg, w0,
                staleness=self.staleness, device=store_dev,
                listener=self.listener,
                checkpoint_manager=self.checkpoint_manager,
                checkpoint_every=self.checkpoint_every,
                config_key=config_key, resume_state=resume_state,
                poison_guard=self.poison_guard,
                **_shard_kw,
            )
        rejoin = (self.rejoin_policy if self.rejoin_policy is not None
                  else RetryPolicy(max_attempts=5, base_backoff_s=0.01,
                                   seed=cfg.seed))
        shards = shard_rows(X, y, self.n_workers)

        if self.listener is not None:
            self.listener.on_run_start(cfg)

        threads: dict = {}
        errors: dict = {}

        def _join(s: int):
            rec = membership.join(f"w{s}", s)
            store.register_worker(f"w{s}", s)
            return rec

        def _spawn(s: int, rec) -> None:
            wid = f"w{s}"
            worker = ReplicaWorker(
                wid, s, store, self.gradient, cfg, *shards[s],
                device=devices[s % len(devices)],
                retry_policy=self.retry_policy,
                heartbeat=rec.heartbeat, wire_frac=frac,
                resident_rounds=resident_rounds,
            )

            def _main():
                try:
                    worker.run()
                    membership.leave(wid)
                    store.deregister_worker(wid)
                except BaseException as e:  # the thread must not die silent
                    membership.leave(wid, error=e)
                    store.deregister_worker(wid)
                    errors[wid] = e

            t = threading.Thread(target=_main, name=f"replica-{wid}",
                                 daemon=True)
            threads[wid] = (t, s)
            t.start()

        t_run = time.perf_counter()
        preempted_at = None
        fatal = None
        pending_rejoins: dict = {}  # wid -> (shard, due_monotonic)
        self._live_supervisor = supervisor
        self._live_client = store if supervisor is not None else None
        rollback_ctl = None
        next_health_check = 0.0
        if self._integrity_rollback and supervisor is not None:
            from tpu_sgd_torch.replica.ha import RollbackController

            rollback_ctl = RollbackController(supervisor)
        try:
            # the whole fleet joins before any worker starts: a τ=0
            # round is complete when every REGISTERED worker has
            # pushed, so a worker that pushed before its peers joined
            # would apply a partial round
            recs = [_join(s) for s in range(self.n_workers)]
            for s, rec in enumerate(recs):
                _spawn(s, rec)
            # -- the elastic monitor loop ---------------------------------
            # 10ms poll: the monitor cadence bounds death-DETECTION
            # latency (and with it the earliest possible rejoin), and a
            # fleet that finishes its remaining budget before a pending
            # rejoin comes due simply never rejoins — a short poll keeps
            # that window tight without measurable idle cost
            while not store.wait_done(timeout_s=0.01):
                if self._stop_signal is not None and self._stop_signal():
                    store.stop()
                    preempted_at = store.version
                    break
                for wid in list(errors):
                    e = errors.pop(wid)
                    rec = membership.record(wid)
                    _, s = threads[wid]
                    if (not rejoin.is_retryable(e)
                            or rec.failures >= rejoin.max_attempts):
                        fatal = e
                        store.stop()
                        break
                    # seeded rejoin backoff as a DUE TIME, never a
                    # sleep: the monitor keeps polling the stop signal
                    # and other workers' deaths at its own cadence —
                    # one worker's backoff must not stall the loop
                    pending_rejoins[wid] = (
                        s, time.monotonic() + rejoin.backoff_s(
                            rec.failures))
                if fatal is not None:
                    break
                now = time.monotonic()
                if rollback_ctl is not None and now >= next_health_check:
                    # the corrupt-state probe rides the monitor loop at
                    # a 0.1s cadence (a full finite scan per 10ms poll
                    # would tax wide models for no detection-latency
                    # win): non-finite primary weights → fence, restore
                    # the last good checkpoint, epoch-bump, replay
                    next_health_check = now + 0.1
                    try:
                        rollback_ctl.check_and_rollback()
                    except Exception as e:  # budget exhausted: fatal
                        fatal = e
                        store.stop()
                        break
                for wid in [w for w, (_, due) in pending_rejoins.items()
                            if due <= now]:
                    s, _ = pending_rejoins.pop(wid)
                    # re-admit: the worker re-pulls HEAD and re-attaches
                    # its EF accumulator
                    _spawn(s, _join(s))
        finally:
            # idempotent: a completed run is already done; an error or
            # preemption unwind must wake every τ=0 barrier waiter so
            # the joins below cannot hang.  Under HA, stop() first
            # WAITS for any in-flight promotion to settle — preemption
            # must unwind from a consistent (epoch, version), never
            # from the middle of a failover
            store.stop()
            for t, _ in threads.values():
                t.join(timeout=60.0)
            self._live_supervisor = None
            self._live_client = None
            self.last_store_snapshot = store.snapshot()
            self.last_membership_snapshot = membership.snapshot()
            self.last_windows_snapshot = self.windows()
            self.last_supervisor = supervisor
            self.last_failover_snapshot = (
                supervisor.snapshot() if supervisor is not None else None)

        if fatal is not None:
            from tpu_sgd_torch.io.integrity import IntegrityError
            from tpu_sgd_torch.obs.counters import inc

            cause, seen = fatal, set()
            while cause is not None and id(cause) not in seen:
                if isinstance(cause, IntegrityError):
                    # detected corruption that exhausted every healing
                    # layer: the one number an integrity-zero-unhealed
                    # gate reads
                    inc("integrity.unhealed")
                    break
                seen.add(id(cause))
                cause = cause.__cause__ or cause.__context__
            raise fatal
        if preempted_at is not None:
            store.save_now()
            raise TrainingPreempted(preempted_at)

        hist = store.loss_history()
        self._loss_history = hist
        if self.listener is not None:
            self.listener.on_run_end(RunEvent(
                event="run_completed",
                num_iterations=len(hist),
                final_loss=float(hist[-1]) if len(hist) else None,
                converged_early=store.converged,
                wall_time_s=time.perf_counter() - t_run,
            ))
        return store.weights, hist
