"""The bounded-staleness contract: who may push, and when (the port of
``tpu_sgd/replica/staleness.py``; pure host code, the same rules).

Asynchronous data-parallel SGD (arXiv:1505.04956) trades the
synchronous barrier for a *bound*: a worker may compute on weights that
lag the store's HEAD, but only by at most ``tau`` applied updates.  The
bound is a CONTRACT, not a tuning knob (ADVICE.md "Staleness is a
contract, not a tuning knob"): it is enforced at **push-accept time**,
never at pull time —

* a *pull* always succeeds and always returns HEAD.  Gating pulls
  would re-introduce the barrier the async design exists to remove
  (a straggler waiting to pull stalls nobody but itself), and a pull
  that returns anything older than HEAD would manufacture staleness.
* a *push* carries the ``basis_version`` its gradient was computed at;
  the store accepts it iff ``head - basis <= tau`` at the moment of
  application.  A stale push is rejected whole — the worker must
  re-pull and recompute — so no applied update ever used weights
  older than the bound, which is the invariant the convergence theory
  (and the trace assertion in ``tests/test_torch_replica.py``) rests on.

The bound is TWO-SIDED at ``1 <= tau < inf`` (the SSP formulation the
source paper builds on): the basis bound above caps how OLD an applied
gradient may be, and its fairness twin — the **progress bound**, also
enforced at push-accept (``ParameterStore._admit``) — caps how far any
worker's accepted-push clock may run AHEAD of the slowest active
worker's.  One without the other is broken in practice: with only the
basis bound, a tight ``tau`` self-selects the fastest worker (it
re-pulls right after its own apply, so its next push is always the
freshest while everyone else's goes stale), acceptance skews ~2x
toward one shard, and the fixed point drifts toward that shard's
objective — measured ~5% off the synchronous final loss at τ=1 with 4
workers before the progress bound existed.  A progress-blocked push
WAITS (the gradient is valid; the slow shard must land first); the
slowest active worker is never blocked, so the fleet always
progresses, and worker deaths deregister and re-evaluate the bound.

Degenerate ends:

* ``tau = 0`` is **bulk-synchronous**: a push is admissible only at
  ``basis == head``, so updates can only apply when every active
  worker's contribution for the round is in — the store barriers the
  round and applies ONE combined update, reproducing the synchronous
  data-parallel trajectory bitwise (``tpu_sgd_torch/replica/store.py``).
* ``tau = None`` (or ``math.inf``) is **unbounded hogwild-style**
  async: every push is admissible, no progress throttle; convergence
  leans entirely on the step-size schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class PushDecision:
    """The contract's verdict on one push attempt."""

    admissible: bool
    staleness: int  # head - basis at decision time


class StalenessContract:
    """Pure admission policy for a bounded-staleness parameter store.

    ``tau``: the maximum number of applied updates a push's basis
    version may lag HEAD.  ``0`` = synchronous (see module docstring);
    ``None``/``math.inf`` = unbounded.  Negative or non-integral
    finite values are rejected eagerly — a typo must fail at
    construction, not silently admit everything mid-run.
    """

    def __init__(self, tau: Optional[Union[int, float]] = 0):
        if tau is None or (isinstance(tau, float) and math.isinf(tau)):
            self.tau: Optional[int] = None
        else:
            t = int(tau)
            if t != tau or t < 0:
                raise ValueError(
                    f"staleness bound must be a non-negative integer, "
                    f"None, or math.inf; got {tau!r}"
                )
            self.tau = t

    @property
    def synchronous(self) -> bool:
        """True iff the bound degenerates to bulk-synchronous rounds
        (``tau == 0``) — the store switches to barrier-and-combine
        application, the mode whose trajectory is bitwise the
        synchronous data-parallel path's."""
        return self.tau == 0

    @property
    def bounded(self) -> bool:
        return self.tau is not None

    def check(self, head_version: int, basis_version: int) -> PushDecision:
        """Admissibility of a push computed at ``basis_version`` against
        the store's current ``head_version``.  A basis ahead of head is
        a protocol violation (the store never publishes the future) and
        raises rather than returning a decision."""
        st = int(head_version) - int(basis_version)
        if st < 0:
            raise ValueError(
                f"push basis {basis_version} is ahead of head "
                f"{head_version}: pulls always return HEAD, so this "
                "worker's basis is corrupt"
            )
        return PushDecision(
            admissible=(self.tau is None or st <= self.tau),
            staleness=st,
        )

    def describe(self) -> str:
        if self.tau is None:
            return "unbounded (hogwild-style async)"
        if self.tau == 0:
            return "0 (bulk-synchronous rounds)"
        return f"{self.tau} (bounded-staleness async)"

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"StalenessContract(tau={self.tau!r})"
