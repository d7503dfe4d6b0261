"""Model registry: hot-reload trained checkpoints into the serving path
(the port of ``tpu_sgd/serve/registry.py``).

The training side publishes through ``CheckpointManager`` (a
``StreamingLinearAlgorithm`` with ``set_checkpoint`` writes one numbered,
atomically-renamed npz per K micro-batches; the JAX package's manager
writes the same files); the registry is the consuming half: it watches
the checkpoint directory, loads any newer version onto its device, and
atomically swaps the serving model under a lock — prediction threads only
ever observe the old model or the new one, never a half-built one.  The
new model's tensors are built (copied to the device) BEFORE the swap, and
a predict that took the old model keeps its tensors alive until it ends:
the swap replaces a reference and never writes a tensor a predict reads.

Failure containment is the point of the design: a corrupt or truncated
newest checkpoint must never take down the endpoint.  ``maybe_reload``
walks candidate versions newest-first, and a version that fails to load
is recorded as bad (never retried) while the endpoint keeps serving the
previous-good model — rollback is the *absence* of the swap.  An
explicitly pinned version (``pin``) disables auto-reload entirely, the
version-pinning escape hatch for incident response.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.reliability.failpoints import FaultInjected, failpoint
from tpu_sgd_torch.utils.checkpoint import CheckpointManager

logger = logging.getLogger("tpu_sgd_torch.serve.registry")

#: lock-discipline declaration (the JAX package's analyzer reads these).
#: The serving model is an atomic-reference swap: prediction threads READ
#: ``_model``/``_version`` lock-free (old model or new, never torn — the
#: documented design), so those are ``:w`` — only mutations serialize.
#: ``bad_versions`` is a plain dict mutated during reload walks; copying
#: or iterating it concurrently with an insert can raise, so both sides
#: hold the lock.
GRAFTLINT_LOCKS = {
    "ModelRegistry": {
        "_model": "_lock:w",
        "_version": "_lock:w",
        "_previous_version": "_lock:w",
        "_pinned": "_lock:w",
        "bad_versions": "_lock",
        "load_failed_count": "_lock:w",
    },
}


class NoModelError(RuntimeError):
    """No loadable checkpoint exists yet in the registry's directory."""


class ModelRegistry:
    """Versioned, hot-reloadable model source over a checkpoint directory.

    ``model_factory(weights, intercept)`` builds the servable model from
    checkpoint state — typically ``algorithm.create_model`` of the family
    that trains into the directory (a streaming checkpoint's version
    number is its stream position, i.e. micro-batches consumed).  The
    factory receives the weights as a float32 tensor already on
    ``device`` (``None``: the card), so a model built from it lives
    there.
    """

    def __init__(
        self,
        manager_or_directory,
        model_factory: Callable,
        *,
        metrics=None,
        breaker=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(manager_or_directory, (str, os.PathLike)):
            manager_or_directory = CheckpointManager(str(manager_or_directory))
        self.manager: CheckpointManager = manager_or_directory
        self.model_factory = model_factory
        self.metrics = metrics
        #: optional reliability.CircuitBreaker: consecutive
        #: reload failures OPEN it and maybe_reload short-circuits (no
        #: directory scan, no load attempt) until the cooldown probe —
        #: serving keeps degrading gracefully to the current/pinned
        #: model instead of hammering a sick checkpoint directory
        self.breaker = breaker
        self._lock = threading.Lock()
        self._model = None
        self._version: Optional[int] = None
        self._previous_version: Optional[int] = None
        self._pinned = False
        #: versions that failed to load, with the error string — never
        #: retried, so one corrupt file cannot wedge reload in a loop
        self.bad_versions: Dict[int, str] = {}
        self.reload_count = 0
        #: cumulative failed load ATTEMPTS (transient + corrupt) — the
        #: registry-side rejection counter healthz surfaces next to the
        #: serving tier's admit/shed/reject tallies
        self.load_failed_count = 0

    # -- read side ---------------------------------------------------------
    @property
    def current_version(self) -> Optional[int]:
        return self._version

    @property
    def previous_version(self) -> Optional[int]:
        return self._previous_version

    def model(self):
        """The current serving model; loads the newest checkpoint on first
        use.  Raises :class:`NoModelError` when nothing is loadable."""
        m = self._model
        if m is None:
            self.maybe_reload()
            m = self._model
            if m is None:
                raise NoModelError(
                    f"no loadable checkpoint in {self.manager.directory!r}"
                )
        return m

    # -- pinning -----------------------------------------------------------
    def pin(self, version: int):
        """Serve exactly ``version`` and disable auto-reload.  An
        explicitly pinned version raises on load failure (same contract as
        ``CheckpointManager.restore(path=...)``): pinning a bad version is
        an operator error, not something to paper over."""
        ck = self.manager.restore_version(int(version))
        with self._lock:
            self._swap(int(version), self._build(ck))
            self._pinned = True
        self._emit_reload("reloaded", int(version), None)
        return self

    def unpin(self):
        """Re-enable auto-reload (the next ``maybe_reload`` catches up)."""
        with self._lock:
            # under the lock like pin(): an unpin racing a maybe_reload
            # must order against the pinned-check inside the reload's
            # critical section
            self._pinned = False
        return self

    @property
    def pinned(self) -> bool:
        return self._pinned

    # -- reload ------------------------------------------------------------
    def maybe_reload(self) -> bool:
        """Load the newest loadable version newer than the current one;
        returns True when the serving model was swapped.  Corrupt versions
        are logged, marked bad, and skipped — the previous-good model
        keeps serving (rollback)."""
        # listener events collected here and emitted AFTER the lock is
        # released: a listener that calls back into the registry (pin,
        # clear_bad_versions, another reload) must not deadlock on the
        # non-reentrant lock the emitting thread still holds
        from tpu_sgd_torch.obs.spans import span

        if self.breaker is not None and not self.breaker.allow():
            # OPEN breaker: the directory has been failing repeatedly —
            # skip the scan entirely and keep serving the current model
            # until the cooldown lets one probe through (HALF_OPEN)
            return False
        emits = []
        swapped = False
        sp = span("serve.reload")
        with sp, self._lock:
            if self._pinned:
                # checked INSIDE the lock: a pin() that completed while
                # this reload waited must win, not be silently undone
                return False
            current = self._version if self._version is not None else -1
            for v in reversed(self.manager.versions()):
                if v <= current:
                    break
                if v in self.bad_versions:
                    continue
                try:
                    failpoint("serve.registry.reload")
                    ck = self.manager.restore_version(v)
                    model = self._build(ck)
                except FileNotFoundError:
                    continue  # pruned between listing and load: no error
                except (OSError, FaultInjected) as e:
                    # transient I/O (EMFILE, NFS hiccup) or an injected
                    # chaos fault: NOT corruption — retry on the next
                    # reload attempt instead of permanently blacklisting
                    # what may be the last checkpoint a finished
                    # training run ever writes
                    logger.warning(
                        "transient I/O error loading checkpoint version "
                        "%d (%s: %s); will retry", v, type(e).__name__, e,
                    )
                    self.load_failed_count += 1
                    emits.append(("load_failed", v, str(e)))
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    continue
                except Exception as e:
                    # incl. IntegrityError: a checkpoint
                    # whose content checksum fails at restore is PROVEN
                    # corrupt — blacklist the version (the breaker
                    # counts it, repeated corruption stops the disk
                    # scan) and keep serving the previous good model;
                    # the ``integrity.corrupt.checkpoint`` counter and
                    # its detector alert already fired at the verify
                    self.bad_versions[v] = f"{type(e).__name__}: {e}"
                    self.load_failed_count += 1
                    logger.warning(
                        "serving reload of checkpoint version %d failed "
                        "(%s: %s); keeping version %s",
                        v, type(e).__name__, e, self._version,
                    )
                    emits.append(("load_failed", v, str(e)))
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    continue
                self._swap(v, model)
                emits.append(("reloaded", v, None))
                swapped = True
                if self.breaker is not None:
                    self.breaker.record_success()
                break
            sp.set(swapped=swapped,
                   version=self._version if swapped else None)
        for kind, v, err in emits:
            self._emit_reload(kind, v, err)
        return swapped

    def healthz(self) -> dict:
        """Ops-probe snapshot: what is serving, is it pinned, what has
        been rejected, and the breaker state (``Server.healthz`` wraps
        this with the queue-side numbers)."""
        with self._lock:
            # the dict() copy of bad_versions iterates it — concurrent
            # with a reload-walk insert that raises RuntimeError, so the
            # snapshot takes the lock; the scalar reads ride along free
            bad = dict(self.bad_versions)
        return {
            "current_version": self._version,
            "previous_version": self._previous_version,
            "pinned": self._pinned,
            "bad_versions": bad,
            "reload_count": self.reload_count,
            "load_failed_count": self.load_failed_count,
            "breaker": (None if self.breaker is None
                        else self.breaker.snapshot()),
        }

    def clear_bad_versions(self):
        """Forget recorded-bad versions so the next reload retries them —
        the operator escape hatch after repairing a checkpoint file."""
        with self._lock:
            self.bad_versions.clear()
        return self

    def on_model_update(self, model=None, batch_index=None):
        """`StreamingLinearAlgorithm.add_model_update_listener` adapter:
        the trainer publishes, the registry picks up whatever checkpoint
        the publish produced (the in-memory model argument is ignored —
        serving state must round-trip through the durable checkpoint)."""
        del model, batch_index
        self.maybe_reload()

    # -- internals ---------------------------------------------------------
    def _build(self, ck: dict):
        if "intercept" not in ck["extras"]:
            # a non-streaming (optimizer-state) checkpoint: intercept 0.0
            # is correct for intercept=False training but silently WRONG
            # for an intercept=True batch run whose bias still rides the
            # weight vector — say so instead of guessing quietly
            logger.warning(
                "checkpoint (config_key=%r) carries no intercept extra; "
                "serving with intercept=0.0 — for an intercept-trained "
                "batch checkpoint split the bias out via a custom "
                "model_factory", ck.get("config_key", ""),
            )
        intercept = float(ck["extras"].get("intercept", 0.0))
        weights = torch.as_tensor(np.asarray(ck["weights"], np.float32),
                                  device=self.device)
        return self.model_factory(weights, intercept)

    def _swap(self, version: int, model):
        """Caller holds ``self._lock`` and is responsible for emitting the
        'reloaded' event AFTER releasing it (re-entrant listeners).
        Every in-class call site of this private helper is under the
        lock."""
        if self._version is not None and version != self._version:
            self._previous_version = self._version
        self._model = model  # atomic reference swap: readers see old or new
        self._version = version
        self.reload_count += 1
        logger.info("serving model hot-swapped to version %d", version)

    def _emit_reload(self, kind: str, version: int, error: Optional[str]):
        if self.metrics is None:
            return
        from tpu_sgd_torch.utils.events import ServeReloadEvent

        try:
            self.metrics.record_reload(ServeReloadEvent(
                event=kind,
                version=int(version),
                previous_version=self._previous_version
                if kind == "reloaded" else self._version,
                error=error,
            ))
        except Exception:  # observability must never kill serving
            logger.warning(
                "serve_reload listener raised; event dropped", exc_info=True
            )
