"""tpu_sgd_torch.serve: online model serving for trained GLM families
(the port of ``tpu_sgd/serve``), on one device (``device=None``: the
card).

A trained or streaming-trained model becomes a low-latency endpoint with

  * dynamic micro-batching — single-row requests coalesce into
    bucket-padded batches under a max-latency deadline, with bounded
    queueing, priority lanes and typed admission rejections
    (:mod:`tpu_sgd_torch.serve.batcher`);
  * a shape-bucketed predict path shared by the dense and sparse feature
    layouts of all GLM families (:mod:`tpu_sgd_torch.serve.engine`),
    bitwise ``model.predict`` on dense rows;
  * hot model reload — a ``StreamingLinearAlgorithm`` training loop
    publishes checkpoints and the serving side atomically swaps to the
    newest loadable version, rolling back past corrupt files
    (:mod:`tpu_sgd_torch.serve.registry`);
  * observability into the event-log contract
    (:mod:`tpu_sgd_torch.serve.metrics`).

Quickstart::

    from tpu_sgd_torch.serve import ModelRegistry, Server

    server = Server(model, max_latency_s=0.002)     # on the card
    with server:
        y = server.predict(x_row)

    registry = ModelRegistry(ckpt_dir, algorithm.create_model)
    with Server(registry=registry) as server:        # hot-reloading
        fut = server.submit(x_row)                   # async handle
        y = fut.result()

On the CPU, pass ``device="cpu"`` to the model, the registry and the
server alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tpu_sgd_torch.obs import timeseries as obs_timeseries
from tpu_sgd_torch.ops.bucketed import DEFAULT_BUCKETS
from tpu_sgd_torch.serve.batcher import (LANES, BackpressureError,
                                         MicroBatcher, Overloaded)
from tpu_sgd_torch.serve.engine import (PredictEngine, _same_device,
                                        stack_rows)
from tpu_sgd_torch.serve.metrics import ServingMetrics
from tpu_sgd_torch.serve.registry import ModelRegistry, NoModelError


class Server:
    """Facade wiring engine + batcher + registry + metrics into one
    endpoint.  Exactly one of ``model`` (static) or ``registry``
    (hot-reloading) must be given.

    Overload (reject at admission, never at completion): :meth:`submit`
    takes a priority
    ``lane`` and an optional ``deadline_s`` budget, and every admission
    rejection — queue-full, unmeetable deadline, utilization shed, or
    displacement by a higher lane — is a typed
    :class:`~tpu_sgd_torch.serve.batcher.Overloaded` answer, never a silent
    drop; ``shed_utilization`` tunes (or with ``{}`` disables) the
    per-lane shed thresholds.

    Reliability (``tpu_sgd_torch/reliability``): pass the registry a
    ``CircuitBreaker`` (``ModelRegistry(...,
    breaker=...)``) so repeated corrupt/unreadable reloads stop
    hammering disk and serving degrades to the current (or pinned)
    model; :meth:`healthz` is the ops-probe snapshot (version, pinned?,
    queue depth, breaker state), and the batcher's ``heartbeat`` plugs
    into a ``reliability.HealthMonitor`` for straggler detection.

    Device: the engine serves on ``device`` (``None``: the card); a static
    model and a registry must live there (a mismatch raises).  The
    flush thread runs every device op of a batch on that device's
    current stream."""

    def __init__(
        self,
        model=None,
        *,
        registry: Optional[ModelRegistry] = None,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        max_batch: Optional[int] = None,
        max_latency_s: float = 0.005,
        max_queue: int = 1024,
        event_log=None,
        auto_reload: bool = True,
        reload_interval_s: float = 0.1,
        shed_utilization=None,
        device=None,
    ):
        if (model is None) == (registry is None):
            raise ValueError("pass exactly one of model= or registry=")
        self.engine = PredictEngine(buckets, device=device)
        if model is not None:
            self.engine.check_model(model)
        elif not _same_device(registry.device, self.engine.device):
            raise ValueError(
                f"the registry loads models onto {registry.device}, and "
                f"this server serves on {self.engine.device}")
        self._model = model
        self.registry = registry
        self.auto_reload = bool(auto_reload) and registry is not None
        self.reload_interval_s = float(reload_interval_s)
        self._last_reload_check = float("-inf")
        if max_batch is None:
            max_batch = self.engine.max_batch
        elif max_batch > self.engine.max_batch:
            # a coalesced batch beyond the largest bucket would fall off
            # the bucketed shapes onto the natural-shape path (and the
            # padded_size metric would lie)
            raise ValueError(
                f"max_batch={max_batch} exceeds the largest engine "
                f"bucket ({self.engine.max_batch}); raise buckets= or "
                "lower max_batch"
            )
        self.metrics = ServingMetrics(listener=event_log)
        if registry is not None:
            if registry.metrics is None:
                # adopt the registry into this server's metrics stream;
                # a metrics object the user attached themselves (or a
                # previous server's) is left in place — reload events
                # keep flowing wherever they already flow
                registry.metrics = self.metrics
            self.metrics.version_source = lambda: (
                -1 if registry.current_version is None
                else registry.current_version
            )
        self.batcher = MicroBatcher(
            self._predict_batch,
            max_batch=max_batch,
            max_latency_s=max_latency_s,
            max_queue=max_queue,
            metrics=self.metrics,
            padded_size_fn=self.engine.bucket_for,
            shed_utilization=shed_utilization,
        )

    # -- model access ------------------------------------------------------
    @property
    def model(self):
        if self.registry is not None:
            return self.registry.model()
        return self._model

    @property
    def model_version(self) -> Optional[int]:
        return None if self.registry is None else self.registry.current_version

    def reload(self) -> bool:
        """Explicitly check for and swap to a newer checkpoint version."""
        if self.registry is None:
            return False
        return self.registry.maybe_reload()

    def _predict_batch(self, X):
        if self.auto_reload:
            # throttled directory scan (not per batch, never per request):
            # a slow/hung filesystem listing must not sit on the serving
            # critical path, and ``reload_interval_s`` bounds staleness;
            # a trainer wired through add_model_update_listener ->
            # registry.on_model_update swaps immediately regardless
            import time

            now = time.monotonic()
            if now - self._last_reload_check >= self.reload_interval_s:
                self._last_reload_check = now
                self.registry.maybe_reload()
        return self.engine.predict_batch(self.model, X)

    # -- request path ------------------------------------------------------
    def submit(self, x, lane: str = "interactive",
               deadline_s: Optional[float] = None):
        """Async single-row predict; returns a ``concurrent.futures.Future``.

        ``lane`` picks the priority lane (``serve.LANES``:
        interactive > batch > shadow) and ``deadline_s`` the request's
        remaining latency budget.
        Raises :class:`Overloaded` (a :class:`BackpressureError`) on any
        typed admission rejection."""
        return self.batcher.submit(x, lane=lane, deadline_s=deadline_s)

    def predict(self, x, timeout: Optional[float] = None, *,
                lane: str = "interactive",
                deadline_s: Optional[float] = None):
        """Blocking single-row predict through the micro-batching path."""
        return self.batcher.predict(x, timeout, lane=lane,
                                    deadline_s=deadline_s)

    def predict_batch(self, X):
        """Direct batch predict through the bucketed path,
        bypassing the queue (bulk/offline scoring against the same
        serving model)."""
        return self._predict_batch(X)

    def healthz(self) -> dict:
        """Liveness/readiness snapshot for ops probes: the serving
        version and pin state, queue pressure, flush-thread liveness,
        and (when a registry is attached) the reload/breaker picture.
        Cheap enough to scrape per second — no locks beyond the
        registry's own, no model access, never raises."""
        lanes = self.batcher.lane_snapshot()
        h = {
            "serving": self.batcher._thread is not None,
            "model_version": self.model_version,
            "queue_depth": self.batcher.queue_depth,
            "reject_count": self.batcher.reject_count,
            "batch_count": self.batcher.batch_count,
            "flush_heartbeat_age_s": self.batcher.heartbeat.age_s(),
            # admission-control picture: per-lane
            # admit/shed/reject tallies + depth, the aggregate counts,
            # and the p99 batch wall the deadline rule prices against
            "lanes": lanes,
            "admit_count": sum(s["admitted"] for s in lanes.values()),
            "shed_count": sum(s["shed"] + s["displaced"]
                              for s in lanes.values()),
            "p99_batch_wall_s": self.batcher.p99_batch_wall_s(),
            # admission lock amortization: lock rounds taken
            # vs requests priced — rounds << priced means the burst
            # path is doing its job
            "admission": self.batcher.admission_snapshot(),
            # the live windowed time-series for the serve subsystem:
            # per-window span/counter aggregates from the
            # bounded obs.timeseries ring, or None when the layer is
            # off — pure host dict reads, still cheap enough to scrape
            "windows": obs_timeseries.snapshot(prefix="serve", last=8),
        }
        if self.registry is not None:
            h["registry"] = self.registry.healthz()
            # the breaker state, surfaced at the top level too — the
            # one field an overload dashboard alerts on
            h["breaker"] = h["registry"]["breaker"]
        return h

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.batcher.start()
        return self

    def stop(self, drain: bool = True):
        self.batcher.stop(drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


__all__ = [
    "BackpressureError",
    "DEFAULT_BUCKETS",
    "LANES",
    "MicroBatcher",
    "ModelRegistry",
    "NoModelError",
    "Overloaded",
    "PredictEngine",
    "Server",
    "ServingMetrics",
    "stack_rows",
]
