"""Open-loop load generator for the production scenario harness: the
port of ``tpu_sgd/scenario/loadgen.py``.  It touches no device; the
server behind ``submit`` decides where a request is scored.

Open-loop on purpose: arrivals follow the offered schedule regardless
of how the endpoint is coping — a closed loop (submit, wait, submit)
self-throttles exactly when the system saturates, which hides the
overload behavior this harness exists to measure.  The generator is the
same credit-paced design as ``bench_serving.py``: credits accrue at the
phase's offered rate, a bounded burst cap sheds arrivals the GENERATOR
fell behind on (a GIL stall must not compound into a thundering herd
that measures the generator, not the server), and a small sleep between
bursts keeps the flush thread scheduled.

Every submission is accounted for exactly once — the zero-silent-drops
ledger the scenario SLO gate audits:

* ``answered``   — the future resolved with a prediction;
* ``rejected``   — a typed :class:`~tpu_sgd_torch.serve.Overloaded`
  raised at submit (queue_full / deadline / shed);
* ``displaced``  — admitted, then evicted for a higher-priority arrival
  (the future resolved with a typed ``Overloaded``);
* ``errored``    — the future resolved with (or ``submit`` raised) any
  OTHER exception; the report counts these by exception class too
  (``error_classes``), so a failure names itself;
* ``dropped``    — the future never resolved within the drain timeout:
  the one bucket that must stay at ZERO.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from tpu_sgd_torch.serve.batcher import Overloaded

#: graftlint lock-discipline declaration (tpu_sgd_torch/analysis): the
#: tally ledger is mutated by the generator thread (submit-side outcomes) AND
#: by future done-callbacks running on the serving flush threads
#: (completion-side outcomes) — every touch holds the lock.
GRAFTLINT_LOCKS = {
    "OpenLoopLoadGen": {
        "_tallies": "_lock",
    },
}


def _count_error(tally: dict, err: BaseException) -> None:
    """One ``errored`` outcome, counted under its exception class too."""
    tally["errored"] += 1
    cls = type(err).__name__
    tally["error_classes"][cls] = tally["error_classes"].get(cls, 0) + 1


class TrafficSpec(NamedTuple):
    """One traffic class of the mix: a name for the ledger, the serving
    lane it rides, its share of arrivals, and the per-request deadline
    budget (None = no deadline).  The harness maps ``name`` to a
    concrete (server, row kind) in its submit callable."""

    name: str
    lane: str
    weight: float
    deadline_s: Optional[float] = None


class Phase(NamedTuple):
    """One segment of the open-loop schedule (e.g. warm / burst / cool)."""

    name: str
    duration_s: float
    offered_rps: float


class OpenLoopLoadGen:
    """See module docstring.  ``submit(spec, i, rng)`` is the harness's
    routing callable: it must return a ``concurrent.futures.Future`` or
    raise (``Overloaded`` = typed rejection, anything else = error)."""

    def __init__(
        self,
        submit: Callable,
        mix: Sequence[TrafficSpec],
        phases: Sequence[Phase],
        *,
        seed: int = 0,
        tick_s: float = 0.002,
        drain_timeout_s: float = 60.0,
    ):
        if not mix:
            raise ValueError("traffic mix must not be empty")
        total = sum(s.weight for s in mix)
        if total <= 0:
            raise ValueError("traffic mix weights must sum positive")
        self.submit = submit
        self.mix = list(mix)
        self._weights = [s.weight / total for s in mix]
        self.phases = list(phases)
        self.seed = int(seed)
        self.tick_s = float(tick_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._tallies: Dict[str, Dict[str, object]] = {}
        self._futures: List = []

    # -- ledger ------------------------------------------------------------
    def _tally_locked(self, name: str) -> dict:
        t = self._tallies.get(name)
        if t is None:
            t = self._tallies[name] = {
                "submitted": 0, "answered": 0, "rejected": 0,
                "displaced": 0, "errored": 0, "dropped": 0,
                "latencies": [], "error_classes": {},
            }
        return t

    def _on_done(self, fut, name: str, t_submit: float) -> None:
        # runs on the serving flush thread (or inline when already done)
        err = fut.exception()
        with self._lock:
            t = self._tally_locked(name)
            if err is None:
                t["answered"] += 1
                t["latencies"].append(time.perf_counter() - t_submit)
            elif isinstance(err, Overloaded):
                t["displaced"] += 1  # admitted, then typed-evicted
            else:
                _count_error(t, err)

    # -- the open loop -----------------------------------------------------
    def run(self) -> dict:
        """Drive every phase, drain, and return the report (see
        :meth:`report`)."""
        rng = np.random.default_rng(self.seed)
        n_specs = len(self.mix)
        per_phase: Dict[str, dict] = {}
        for phase in self.phases:
            stats = {"offered": 0, "rejected": 0}
            max_credit = max(phase.offered_rps * 0.05, 1.0)
            t_start = time.perf_counter()
            deadline = t_start + phase.duration_s
            t_last = t_start
            credit = 0.0
            i = 0
            while True:
                time.sleep(self.tick_s)
                now = time.perf_counter()
                if now >= deadline:
                    break
                credit = min(
                    credit + (now - t_last) * phase.offered_rps, max_credit)
                t_last = now
                while credit >= 1.0:
                    credit -= 1.0
                    spec = self.mix[int(rng.choice(n_specs,
                                                   p=self._weights))]
                    stats["offered"] += 1
                    t_sub = time.perf_counter()
                    try:
                        fut = self.submit(spec, i, rng)
                    except Overloaded:
                        stats["rejected"] += 1
                        with self._lock:
                            self._tally_locked(spec.name)["submitted"] += 1
                            self._tally_locked(spec.name)["rejected"] += 1
                    except Exception as err:
                        with self._lock:
                            t = self._tally_locked(spec.name)
                            t["submitted"] += 1
                            _count_error(t, err)
                    else:
                        with self._lock:
                            self._tally_locked(spec.name)["submitted"] += 1
                            self._futures.append(fut)
                        fut.add_done_callback(
                            lambda f, n=spec.name, t=t_sub:
                            self._on_done(f, n, t))
                    i += 1
            per_phase[phase.name] = stats
        self._drain()
        rep = self.report()
        rep["phases"] = per_phase
        return rep

    def _drain(self) -> None:
        """Wait for every outstanding future to resolve; whatever does
        not inside the budget is a DROP (the invariant violation this
        harness exists to catch, not an error to hide)."""
        with self._lock:
            futures = list(self._futures)
        deadline = time.monotonic() + self.drain_timeout_s
        for fut in futures:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                fut.exception(timeout=remaining)  # outcome via _on_done
            except (TimeoutError, _FutureTimeout):
                break
            except Exception:
                pass  # CancelledError etc.: the callback tallied it
        # done-callbacks fire after result-waiters wake; give the flush
        # threads a moment to finish writing the ledger.  Keyed on
        # futures actually DONE (not on submitted-minus-rejected): a
        # genuinely dropped future must cost the drain timeout above,
        # not another full settle window here
        t_wait = time.monotonic() + 5.0
        while time.monotonic() < t_wait:
            done = sum(1 for f in futures if f.done())
            with self._lock:
                settled = sum(
                    t["answered"] + t["displaced"] + t["errored"]
                    for t in self._tallies.values())
            if settled >= done:
                break
            time.sleep(0.005)

    # -- results -----------------------------------------------------------
    def report(self) -> dict:
        """Per-traffic-class ledger + per-lane rollup.  ``dropped`` is
        computed by conservation: submitted minus every accounted
        outcome — a future that simply never resolved."""
        from tpu_sgd_torch.serve.metrics import nearest_rank

        with self._lock:
            tallies = {k: dict(v, error_classes=dict(v["error_classes"]))
                       for k, v in self._tallies.items()}
        by_lane: Dict[str, dict] = {}
        classes = {}
        error_classes: Dict[str, int] = {}
        for spec in self.mix:
            t = tallies.get(spec.name)
            if t is None:
                continue
            t["dropped"] = (t["submitted"] - t["answered"] - t["rejected"]
                            - t["displaced"] - t["errored"])
            lats = sorted(t.pop("latencies"))
            t["p50_s"] = nearest_rank(lats, 50)
            t["p99_s"] = nearest_rank(lats, 99)
            classes[spec.name] = t
            for cls, n in t["error_classes"].items():
                error_classes[cls] = error_classes.get(cls, 0) + n
            lane = by_lane.setdefault(
                spec.lane, {"submitted": 0, "answered": 0, "rejected": 0,
                            "displaced": 0, "errored": 0, "dropped": 0})
            for k in lane:
                lane[k] += t[k]
        totals = {k: sum(lane[k] for lane in by_lane.values())
                  for k in ("submitted", "answered", "rejected",
                            "displaced", "errored", "dropped")}
        return {"classes": classes, "lanes": by_lane, "totals": totals,
                "error_classes": error_classes}
