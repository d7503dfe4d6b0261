"""Failure-handling policies: the port of ``tpu_sgd/reliability/retry.py``
(pure Python, copied whole).

* ``RetryPolicy``: transient faults on the feed and the disk, retried a
  bounded number of times with exponential backoff and *seeded* jitter,
  so a chaos run replays bit-identically;
* ``Deadline``: a wall-clock budget threaded through polling loops, so
  no wait hangs;
* ``CircuitBreaker``: stop calling a dependency that keeps failing,
  serve degraded from the last-good state, probe again after a
  cooldown.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("tpu_sgd_torch_torch.reliability.retry")


class RetriesExhausted(RuntimeError):
    """Every attempt failed; ``__cause__`` carries the last error."""


class DeadlineExceeded(TimeoutError):
    """A ``Deadline`` expired before the guarded work finished."""


class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    ``max_attempts`` counts the first try: ``max_attempts=3`` means one
    call plus at most two retries.  Sleep before retry ``k`` (1-based)
    is ``base_backoff_s * multiplier**(k-1)``, capped at
    ``max_backoff_s``, then scaled by a jitter factor drawn uniformly
    from ``[1 - jitter, 1]`` out of a private ``random.Random(seed)``
    stream — deterministic per policy instance, so a seeded chaos run
    has a reproducible schedule (decorrelation across workers comes from
    giving each its own seed, not from wall-clock entropy).

    Only ``retryable`` exception classes are retried; anything else
    propagates immediately — a shape error or a corrupt-format error is
    not transient and retrying it would just burn the budget.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        *,
        base_backoff_s: float = 0.05,
        multiplier: float = 2.0,
        max_backoff_s: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
        retryable: Tuple[Type[BaseException], ...] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        if retryable is None:
            from tpu_sgd_torch.reliability.failpoints import FaultInjected

            # transient by default: injected faults, I/O hiccups, and
            # flaky-runtime errors; ValueError/TypeError stay fatal
            retryable = (FaultInjected, OSError, TimeoutError, RuntimeError)
        self.max_attempts = int(max_attempts)
        self.base_backoff_s = float(base_backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.retryable = tuple(retryable)
        self._sleep = sleep
        self._rng = random.Random(self.seed)

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def backoff_s(self, retry_index: int) -> float:
        """Jittered sleep before retry ``retry_index`` (1-based)."""
        raw = min(
            self.base_backoff_s * self.multiplier ** (retry_index - 1),
            self.max_backoff_s,
        )
        return raw * (1.0 - self.jitter * self._rng.random())

    def call(self, fn: Callable, *args,
             deadline: Optional["Deadline"] = None,
             on_retry: Optional[Callable] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy.

        ``on_retry(attempt, exc)`` fires before each backoff sleep (the
        supervisor logs a reliability event there).  A ``deadline``
        bounds the whole loop: no attempt starts past it, and backoff
        sleeps are clipped to the remaining budget.  Raises
        :class:`RetriesExhausted` (with ``__cause__``) when the budget
        is spent, or :class:`DeadlineExceeded` at the deadline."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded(
                    f"deadline expired before attempt {attempt}"
                ) from last
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not self.is_retryable(e) or attempt == self.max_attempts:
                    if isinstance(e, self.retryable):
                        raise RetriesExhausted(
                            f"{attempt} attempt(s) failed; last: "
                            f"{type(e).__name__}: {e}"
                        ) from e
                    raise
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
                # the heal-in-progress breadcrumb: a trace shows
                # WHICH attempt of WHAT error class healed where
                # (disabled-mode cost: one global load + branch)
                from tpu_sgd_torch.obs.spans import event as obs_event

                obs_event("reliability.retry", attempt=attempt,
                          error=type(e).__name__)
                logger.debug("attempt %d failed (%s: %s); retrying",
                             attempt, type(e).__name__, e)
                pause = self.backoff_s(attempt)
                if deadline is not None:
                    pause = min(pause, max(0.0, deadline.remaining_s))
                if pause > 0:
                    self._sleep(pause)
        raise AssertionError("unreachable")  # loop always returns/raises


class Deadline:
    """Wall-clock budget (monotonic).  Thread the same instance through
    a multi-step operation so the budget is shared, not per-step."""

    def __init__(self, budget_s: float):
        if budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {budget_s}")
        self.budget_s = float(budget_s)
        self._t0 = time.monotonic()

    @property
    def remaining_s(self) -> float:
        return self.budget_s - (time.monotonic() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining_s <= 0

    def check(self, what: str = "operation") -> None:
        """Raise :class:`DeadlineExceeded` when the budget is spent —
        the one-liner for polling loops."""
        if self.expired:
            raise DeadlineExceeded(
                f"{what} exceeded its {self.budget_s:.3f}s deadline"
            )


class CircuitBreaker:
    """Three-state breaker: CLOSED (normal) → OPEN after
    ``failure_threshold`` consecutive failures (calls short-circuit) →
    HALF_OPEN after ``reset_timeout_s`` (ONE probe allowed; success
    closes, failure re-opens).

    Thread-compatible by design: state transitions are single
    assignments and the worst interleaving admits an extra probe, never
    a lost open — callers that need strict single-probe semantics hold
    their own lock (the serve registry already serializes reloads).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 30.0):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.consecutive_failures = 0
        self.total_opens = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return self.CLOSED
        if time.monotonic() - self._opened_at >= self.reset_timeout_s:
            return self.HALF_OPEN
        return self.OPEN

    def allow(self) -> bool:
        """May the caller attempt the guarded operation right now?"""
        return self.state != self.OPEN

    def record_success(self) -> None:
        if self._opened_at is not None:
            # a successful HALF_OPEN probe closed the breaker — the
            # recovery edge an incident replay wants timestamped
            from tpu_sgd_torch.obs.spans import event as obs_event

            obs_event("reliability.breaker_close",
                      total_opens=self.total_opens)
        self.consecutive_failures = 0
        self._opened_at = None

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        opened = False
        if self.state == self.HALF_OPEN:
            # failed probe: re-open with a fresh cooldown
            self.total_opens += 1
            self._opened_at = time.monotonic()
            opened = True
        elif (self._opened_at is None
              and self.consecutive_failures >= self.failure_threshold):
            self.total_opens += 1
            self._opened_at = time.monotonic()
            opened = True
        if opened:
            from tpu_sgd_torch.obs.spans import event as obs_event

            obs_event("reliability.breaker_open",
                      consecutive_failures=self.consecutive_failures,
                      total_opens=self.total_opens)

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "total_opens": self.total_opens,
        }
