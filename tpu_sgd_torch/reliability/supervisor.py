"""Preemption-safe, crash-resuming training runs: the port of
``tpu_sgd/reliability/supervisor.py`` (copied whole).

:class:`TrainingSupervisor` wraps an optimizer without changing its
math:

* **auto-checkpoint**: attaches a ``CheckpointManager`` at a cadence
  (``GradientDescent.set_checkpoint``), so durable state trails the run
  by at most ``checkpoint_every`` iterations;
* **preemption**: a SIGTERM/SIGINT handler flips a cooperative stop
  flag; the observed driver polls it once per iteration, or, with
  ``set_superstep(K)``, once per block BOUNDARY (a captured K-iteration
  block cannot stop mid-replay), and with ``set_residency(C)`` once per
  window of C blocks.  The boundary iteration is checkpointed exactly,
  and the run unwinds with :class:`TrainingPreempted`: a clean exit
  inside the grace window, never a torn write (the checkpoint rename is
  atomic);
* **crash-resume**: a retryable crash (an injected fault, a flaky
  disk) restarts the run under a seeded
  :class:`~tpu_sgd_torch.reliability.retry.RetryPolicy`; the optimizer's
  own resume path restores the latest checkpoint and replays forward.

Every iteration is deterministic in ``(seed, i)``, so a resumed run
replays the exact trajectory: its final weights are bitwise those of an
uninterrupted run.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import threading
from typing import Optional

import numpy as np

from tpu_sgd_torch.reliability.retry import RetryPolicy
from tpu_sgd_torch.utils.events import ReliabilityEvent

logger = logging.getLogger("tpu_sgd_torch_torch.reliability.supervisor")


class TrainingPreempted(RuntimeError):
    """A cooperative stop request was honored: state up to and including
    ``iteration`` is checkpointed and the run exited cleanly.  Re-running
    (``TrainingSupervisor.run`` again, or the bare optimizer with the
    same checkpoint manager) resumes from exactly that iteration."""

    def __init__(self, iteration: int):
        super().__init__(
            f"training preempted at iteration {iteration} "
            "(state checkpointed; re-run to resume)"
        )
        self.iteration = int(iteration)


@dataclasses.dataclass
class SupervisedResult:
    """Outcome of one :meth:`TrainingSupervisor.run` call."""

    weights: object
    loss_history: Optional[np.ndarray]
    status: str          # "completed" | "preempted"
    attempts: int        # optimizer runs launched (1 = no crash)
    preempted_at: Optional[int] = None  # iteration, when preempted

    @property
    def completed(self) -> bool:
        return self.status == "completed"


class TrainingSupervisor:
    """Run an optimizer to completion across crashes and preemptions.

    ``optimizer`` is a configured ``GradientDescent`` (or ``LBFGS`` —
    which has no checkpoint path, so it gets crash-RETRY from scratch:
    its full-batch runs are deterministic, so a restart reproduces the
    same result).  ``checkpoint_manager`` may be a ``CheckpointManager``
    or a directory path; ``retry`` bounds how many crashes one ``run``
    absorbs before giving up — once the budget is spent (or the crash is
    not a ``retry.retryable`` class) the LAST crash propagates raw, so
    the caller sees exactly what killed the run.

    Signal handling is opt-out (``install_signal_handlers=False``) and
    only possible on the main thread (CPython restricts ``signal.signal``
    there); :meth:`request_preempt` triggers the same cooperative path
    programmatically, which is what the tests drive.
    """

    def __init__(
        self,
        optimizer,
        *,
        checkpoint_manager=None,
        checkpoint_every: int = 10,
        retry: Optional[RetryPolicy] = None,
        listener=None,
        preempt_signals=(signal.SIGTERM, signal.SIGINT),
        install_signal_handlers: bool = True,
    ):
        from tpu_sgd_torch.utils.checkpoint import CheckpointManager

        if isinstance(checkpoint_manager, str):
            checkpoint_manager = CheckpointManager(checkpoint_manager)
        self.optimizer = optimizer
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_every = int(checkpoint_every)
        self.retry = retry if retry is not None else RetryPolicy()
        self.listener = listener
        self.preempt_signals = tuple(preempt_signals)
        self.install_signal_handlers = bool(install_signal_handlers)
        self._preempt = threading.Event()

    # -- preemption --------------------------------------------------------
    def request_preempt(self) -> None:
        """Ask the supervised run to checkpoint and exit at the next
        iteration boundary (what the signal handler calls; also the
        programmatic path for tests/other threads)."""
        self._preempt.set()

    @property
    def preempt_requested(self) -> bool:
        return self._preempt.is_set()

    def _handle_signal(self, signum, frame):
        logger.warning(
            "signal %s received: checkpointing and exiting at the next "
            "iteration boundary", signum)
        self._emit("preempt_signal", value=float(signum))
        self._preempt.set()

    # -- run ---------------------------------------------------------------
    def run(self, data, initial_weights) -> SupervisedResult:
        """Run ``optimizer.optimize_with_history(data, initial_weights)``
        under supervision; see the class docstring for the contract."""
        opt = self.optimizer
        self._preempt.clear()
        if self.checkpoint_manager is not None:
            if not hasattr(opt, "set_checkpoint"):
                raise TypeError(
                    f"{type(opt).__name__} has no set_checkpoint; pass "
                    "checkpoint_manager=None to supervise it retry-only"
                )
            opt.set_checkpoint(self.checkpoint_manager,
                               every=self.checkpoint_every)
        if hasattr(opt, "set_stop_signal"):
            opt.set_stop_signal(self._preempt.is_set)
        previous = self._install_handlers()
        try:
            return self._attempt_loop(data, initial_weights)
        finally:
            self._restore_handlers(previous)
            if hasattr(opt, "set_stop_signal"):
                opt.set_stop_signal(None)

    def _attempt_loop(self, data, initial_weights) -> SupervisedResult:
        attempt = 0
        while True:
            attempt += 1
            try:
                w, hist = self.optimizer.optimize_with_history(
                    data, initial_weights)
            except TrainingPreempted as e:
                self._emit("preempted", value=float(e.iteration))
                logger.info("run preempted cleanly at iteration %d",
                            e.iteration)
                return SupervisedResult(
                    weights=None, loss_history=None, status="preempted",
                    attempts=attempt, preempted_at=e.iteration)
            except BaseException as e:
                if (not self.retry.is_retryable(e)
                        or attempt >= self.retry.max_attempts):
                    raise
                self._emit("retry", value=float(attempt),
                           detail=f"{type(e).__name__}: {e}")
                logger.warning(
                    "training attempt %d crashed (%s: %s); resuming from "
                    "the latest checkpoint", attempt, type(e).__name__, e)
                pause = self.retry.backoff_s(attempt)
                if pause > 0:
                    self.retry._sleep(pause)
                continue  # resume path restores the latest checkpoint
            self._emit("completed", value=float(attempt))
            return SupervisedResult(
                weights=w, loss_history=hist, status="completed",
                attempts=attempt)

    # -- internals ---------------------------------------------------------
    def _install_handlers(self):
        if (not self.install_signal_handlers
                or threading.current_thread()
                is not threading.main_thread()):
            return None
        previous = {}
        for sig in self.preempt_signals:
            previous[sig] = signal.signal(sig, self._handle_signal)
        return previous

    @staticmethod
    def _restore_handlers(previous) -> None:
        if previous:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _emit(self, kind: str, value: float = 0.0, detail: str = ""):
        if self.listener is None:
            return
        try:
            self.listener.on_reliability(ReliabilityEvent(
                kind=kind, source="supervisor", value=value, detail=detail))
        except Exception:
            logger.warning("reliability listener raised; event dropped",
                           exc_info=True)
