"""Declarative anomaly detectors over the windowed time-series (the
port of ``tpu_sgd/obs/detect.py``; pure host code, rule for rule the
JAX package's: the same names, defaults, messages and trip semantics).

Alerts are TYPED EVENTS, not log lines (ADVICE.md "Alerts are typed
events, not log lines"): a detector never greps raw records — it
evaluates a CLOSED window's aggregates against a declared rule, and a
trip is DATA: one ``obs_alert`` record on the shared event stream (the
same lock-serialized JSONL every span/counter/listener record rides,
so ``obs.report``'s alerts section, the watch CLI, and the future
adaptive control plane all consume trips the same way they consume
everything else) plus an ``obs.alert.<rule>`` counter bump.  On every
trip the flight recorder dumps its ring
(``tpu_sgd_torch.obs.flightrec``) so the post-mortem starts with the record, not a grep.

The rules (each a small class; :func:`default_detectors` builds the
production set):

* **loss-divergence** — the ``train.loss`` window mean grows past
  ``factor`` x the best trailing window mean (or goes non-finite).
  The companion :class:`LossPlateauDetector` (NOT in the defaults — a
  converged run plateaus legitimately; this one is the AdaBatch
  grow-the-batch sensor the control plane opts into) trips when the
  relative improvement across ``windows`` closed windows falls under
  ``eps``.
* **staleness-creep** — the ``replica.push.staleness`` window max (the
  store version gap of ACCEPTED pushes) exceeds ``max_staleness``.
* **shed-rate** — per serving lane, typed rejections over offered
  requests in the window (from the ``serve.admitted/rejected/shed/
  displaced.<lane>`` counter series) exceed ``threshold`` with at
  least ``min_offered`` offered.
* **replica-straggler** — a worker's ``replica.step[<wid>]`` series is
  SILENT while the rest of the fleet accumulates ``min_fleet_steps``
  steps (per-worker progress skew from the heartbeat-per-cycle span
  records, cumulative across windows so a loaded host that slows
  everyone equally trips nothing; fleet-wide silence — a finished
  round — trips nothing either).
* **wire-ratio-collapse** — a COMPRESSED wire format's window ratio
  (logical / physical bytes from the ``*.wire.<fmt>`` series) falls
  under ``min_ratio`` (dense-f32/bf16 are exempt: their ratios are 1x
  and 2x by construction).
* **dispatch-regression** — the ``train.dispatch`` window count jumps
  past ``factor`` x the median of the trailing closed windows (with a
  floor so idle phases cannot trip on noise): the live spelling of the
  bench gate's dispatch-count headline.
* **failover** — a ``replica.failover`` observation landed in the
  window (the promotion span and the membership event both feed the
  series): a store promotion is ALWAYS an incident worth a typed
  alert + flight-recorder dump, even when the system healed itself —
  a failover nobody noticed is a standby budget silently spent.
* **integrity** — any ``integrity.corrupt.<site>`` counter moved in
  the window (a checksum mismatch at a verified wire, a poisoned
  push): detected-and-HEALED corruption is still an incident — a bit
  flipping somewhere is a hardware/storage signal, and the one that
  finally slips through will look exactly like the ones that did not.
  A clean run never records the series, so the rule has no
  false-positive surface.
* **heartbeat-stall** — a WATCHED component's heartbeat series went
  silent for ``stall_windows`` consecutive windows while another
  watched component kept beating (hang was the one failure mode chaos
  could not see: a wedged feed raises nothing, it just stops).  The
  roster is membership-driven like the straggler rule:
  ``HealthMonitor.watch_heartbeat`` admits, ``unwatch_heartbeat``
  retires (so a finished run's silence never false-trips the next),
  and fleet-wide silence — an idle process — trips nothing.

Trip semantics: the engine tracks active ``(rule, series)`` pairs and
emits one ``obs_alert`` per TRANSITION into the tripped state; a rule
that stays tripped across consecutive windows stays one alert, and it
re-arms after a window that does not trip.  A raising detector is
logged and dropped — detection must never kill the observed path.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Alert", "Detector", "DetectorEngine", "default_detectors",
           "LossDivergenceDetector", "LossPlateauDetector",
           "StalenessCreepDetector", "LaneRejectionDetector",
           "StragglerDetector", "WireRatioDetector",
           "DispatchRegressionDetector", "FailoverDetector",
           "IntegrityDetector", "HeartbeatStallDetector",
           "ShardImbalanceDetector", "SlabThrashDetector"]

logger = logging.getLogger("tpu_sgd_torch.obs")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the engine's history ring, active-alert set, and trip tallies are
#: touched by whichever observing thread closed the window.
GRAFTLINT_LOCKS = {
    "DetectorEngine": {
        "_history": "_lock",
        "_active": "_lock",
        "_trips": "_lock",
    },
}


@dataclasses.dataclass
class Alert:
    """One typed detector trip — serialized verbatim as the
    ``obs_alert`` record's payload (plus the emit timestamp)."""

    rule: str
    series: str
    value: float
    bound: float
    window_index: int
    t_start: float
    t_end: float
    detail: str = ""


def _series(window: dict, name: str) -> Optional[dict]:
    return window["series"].get(name)


def _count(window: dict, name: str) -> int:
    s = _series(window, name)
    return int(s["count"]) if s else 0


class Detector:
    """One rule.  ``evaluate(window, history)`` receives the CLOSED
    window's snapshot and the engine's trailing closed-window snapshots
    (oldest first, NOT including ``window``) and returns the trips."""

    rule = "base"

    def evaluate(self, window: dict, history: List[dict]) -> List[Alert]:
        raise NotImplementedError

    def _alert(self, window: dict, series: str, value: float,
               bound: float, detail: str = "") -> Alert:
        return Alert(rule=self.rule, series=series, value=float(value),
                     bound=float(bound), window_index=window["index"],
                     t_start=window["t_start"], t_end=window["t_end"],
                     detail=detail)


class LossDivergenceDetector(Detector):
    rule = "loss-divergence"

    def __init__(self, series: str = "train.loss", factor: float = 2.5,
                 min_history: int = 3):
        self.series = series
        self.factor = float(factor)
        self.min_history = int(min_history)

    def evaluate(self, window, history):
        import math

        s = _series(window, self.series)
        if s is None or not s["count"]:
            return []
        mean = s["mean"]
        if not math.isfinite(mean):
            return [self._alert(window, self.series, mean, self.factor,
                                "non-finite window loss")]
        past = [w["series"][self.series]["mean"] for w in history
                if self.series in w["series"]
                and w["series"][self.series]["count"]]
        if len(past) < self.min_history:
            return []
        best = min(past)
        if best > 0 and mean > self.factor * best:
            return [self._alert(
                window, self.series, mean, self.factor * best,
                f"window mean loss {mean:.4g} vs best trailing "
                f"{best:.4g}")]
        return []


class LossPlateauDetector(Detector):
    """The AdaBatch grow-the-batch sensor (NOT in the defaults: a
    converged run plateaus legitimately — this is a control-plane
    actuation signal, an anomaly only when the operator says so)."""

    rule = "loss-plateau"

    def __init__(self, series: str = "train.loss", eps: float = 1e-3,
                 windows: int = 4):
        self.series = series
        self.eps = float(eps)
        self.windows = int(windows)

    def evaluate(self, window, history):
        means = [w["series"][self.series]["mean"] for w in history
                 if self.series in w["series"]
                 and w["series"][self.series]["count"]]
        s = _series(window, self.series)
        if s is None or not s["count"]:
            return []
        means.append(s["mean"])
        if len(means) < self.windows:
            return []
        tail = means[-self.windows:]
        lo, hi = min(tail), max(tail)
        denom = max(abs(hi), 1e-12)
        rel = (hi - lo) / denom
        if rel < self.eps:
            return [self._alert(window, self.series, rel, self.eps,
                                f"loss flat across {self.windows} "
                                "windows")]
        return []


class StalenessCreepDetector(Detector):
    rule = "staleness-creep"

    def __init__(self, series: str = "replica.push.staleness",
                 max_staleness: float = 8.0):
        self.series = series
        self.max_staleness = float(max_staleness)

    def evaluate(self, window, history):
        s = _series(window, self.series)
        if s is None or s["max"] is None:
            return []
        if s["max"] > self.max_staleness:
            return [self._alert(window, self.series, s["max"],
                                self.max_staleness,
                                "accepted-push version gap creeping")]
        return []


class LaneRejectionDetector(Detector):
    """shed-rate AND rejection-rate spikes, per lane, one rule: the
    typed-rejection fraction of the window's offered requests."""

    rule = "shed-rate"

    def __init__(self, threshold: float = 0.3, min_offered: int = 20):
        self.threshold = float(threshold)
        self.min_offered = int(min_offered)

    def evaluate(self, window, history):
        lanes = set()
        for name in window["series"]:
            for pref in ("serve.admitted.", "serve.rejected.",
                         "serve.shed.", "serve.displaced."):
                if name.startswith(pref):
                    lane = name[len(pref):]
                    if "." not in lane:
                        lanes.add(lane)
        out = []
        for lane in sorted(lanes):
            admitted = _count(window, f"serve.admitted.{lane}")
            rejected = _count(window, f"serve.rejected.{lane}")
            shed = _count(window, f"serve.shed.{lane}")
            displaced = _count(window, f"serve.displaced.{lane}")
            # offered counts each request once (a displaced request
            # already sits in admitted — the report's accounting rule)
            offered = admitted + rejected + shed
            if offered < self.min_offered:
                continue
            rate = (rejected + shed + displaced) / offered
            if rate > self.threshold:
                out.append(self._alert(
                    window, f"serve.lane.{lane}", rate, self.threshold,
                    f"{rejected + shed + displaced} typed rejections "
                    f"of {offered} offered"))
        return out


class StragglerDetector(Detector):
    """Trips when a worker has been SILENT while the rest of the fleet
    accumulated >= ``min_fleet_steps`` steps since its last step —
    cumulative across windows, so detection latency scales with fleet
    PROGRESS, not wall clock: a loaded host that slows everyone down
    equally never trips (the window-count spelling flaked exactly
    there — under ambient load no single window held enough survivor
    steps), while a dead worker trips on any host once its peers have
    provably moved on without it.  Fleet-wide silence (a finished
    round) accumulates nothing and can never trip.

    Threshold guidance: the replica store's SSP progress bound caps a
    LIVE worker's lag at ~``(n_workers - 1) * tau`` peer steps, so any
    ``min_fleet_steps`` above that is structurally reachable only by a
    dead/stalled worker.  Stateful (peer-step deficits per worker);
    the engine serializes evaluation under its lock.

    Membership rides the ``replica.join/rejoin/leave`` event fan-out
    (``timeseries.EVENT_FANOUT``): a join/rejoin admits (or resets) a
    worker — so one that joined but never stepped IS tracked and a
    spawn-stall becomes visible once peers move; a CLEAN leave removes
    the entry (a finished run or a deliberate scale-down must not
    leave a phantom accumulating deficit that false-trips the next
    fleet sharing this engine); a leave carrying an error (the
    ``replica.leave.error[...]`` twin) KEEPS the entry accumulating —
    a death is exactly what this rule exists to surface until the
    rejoin resets it."""

    rule = "replica-straggler"

    def __init__(self, prefix: str = "replica.step[",
                 min_fleet_steps: int = 10,
                 membership_prefix: str = "replica."):
        self.prefix = prefix
        self.min_fleet_steps = int(min_fleet_steps)
        self.membership_prefix = membership_prefix
        self._behind: Dict[str, int] = {}  # wid -> peer steps since its last

    def _membership(self, window) -> None:
        mp = self.membership_prefix
        if (mp + "failover") in window["series"]:
            # a store failover stalls the WHOLE fleet (workers re-route,
            # re-pull, recompute): the roster survives, but accumulated
            # deficits from the promotion window are re-routing latency,
            # not straggling — reset so a healed failover never
            # false-trips the worker that happened to be mid-push
            for wid in self._behind:
                self._behind[wid] = 0
        for name in window["series"]:
            for kind in ("join[", "rejoin["):
                pre = mp + kind
                if name.startswith(pre) and name.endswith("]"):
                    actor = name[len(pre):-1]
                    self._behind[f"{self.prefix}{actor}]"] = 0
            pre = mp + "leave["  # the CLEAN leave only — never .error
            if name.startswith(pre) and name.endswith("]"):
                actor = name[len(pre):-1]
                self._behind.pop(f"{self.prefix}{actor}]", None)

    def evaluate(self, window, history):
        self._membership(window)
        counts = {n: int(window["series"][n]["count"])
                  for n in window["series"]
                  if n.startswith(self.prefix)}
        for wid in counts:
            self._behind.setdefault(wid, 0)
        if len(self._behind) < 2:
            return []
        total = sum(counts.values())
        out = []
        for wid in sorted(self._behind):
            c = counts.get(wid, 0)
            if c > 0:
                self._behind[wid] = 0  # it stepped: caught up
                continue
            self._behind[wid] += total - c
            if self._behind[wid] >= self.min_fleet_steps:
                out.append(self._alert(
                    window, wid, float(self._behind[wid]),
                    float(self.min_fleet_steps),
                    f"fleet ran {self._behind[wid]} step(s) since this "
                    "worker's last"))
        return out


class WireRatioDetector(Detector):
    rule = "wire-ratio-collapse"

    #: formats whose ratio is fixed by construction, never a collapse
    EXEMPT = ("dense-f32", "bf16")

    def __init__(self, min_ratio: float = 1.1, min_bytes: int = 4096):
        self.min_ratio = float(min_ratio)
        self.min_bytes = int(min_bytes)

    def evaluate(self, window, history):
        out = []
        for name, s in sorted(window["series"].items()):
            if ".wire." not in name or name.endswith(".logical"):
                continue
            fmt = name.rsplit(".", 1)[1]
            # per-instance fan-out (record_wire's tag arg — e.g. the
            # sharded store's ``...wire.dense-f32[s0]``): the exempt
            # list keys on the FORMAT, so strip the bracket suffix
            if fmt.endswith("]") and "[" in fmt:
                fmt = fmt[:fmt.index("[")]
            if fmt in self.EXEMPT:
                continue
            phys = s["bytes"]
            if phys < self.min_bytes:
                continue
            logical = window["series"].get(name + ".logical",
                                           {"bytes": 0})["bytes"]
            if logical <= 0:
                # record_wire emits physical and logical as two incs; a
                # window roll can land them one window apart, leaving a
                # physical-only window — unevaluable, not a collapse
                continue
            ratio = logical / phys
            if ratio < self.min_ratio:
                out.append(self._alert(
                    window, name, ratio, self.min_ratio,
                    f"{phys} physical vs {logical} logical bytes"))
        return out


class ShardImbalanceDetector(Detector):
    """Sharded-store balance sensor (NOT in the defaults — the
    ``LossPlateauDetector`` precedent: an operator opt-in, not an
    anomaly by default).  Contiguous equal-width ranges make DENSE
    push routing balanced by construction; on a COMPRESSED workload
    the per-shard ``replica.shard.push[sK]`` counts follow where the
    top-k mass concentrates, and a shard going quiet means one
    pipeline does most of the combine work — the sharding stopped
    paying.  Trips per lagging shard when its window count falls below
    ``min_frac`` of the busiest shard's (floor ``min_count`` on the
    busiest, so idle windows cannot trip on noise)."""

    rule = "shard-imbalance"

    def __init__(self, prefix: str = "replica.shard.push",
                 min_frac: float = 0.5, min_count: int = 8):
        self.prefix = prefix
        self.min_frac = float(min_frac)
        self.min_count = int(min_count)

    def evaluate(self, window, history):
        counts = {}
        for name, s in window["series"].items():
            if (name.startswith(self.prefix + "[")
                    and name.endswith("]")):
                counts[name] = int(s["count"])
        if len(counts) < 2:
            return []
        busiest = max(counts.values())
        if busiest < self.min_count:
            return []
        out = []
        for name, c in sorted(counts.items()):
            if c < self.min_frac * busiest:
                out.append(self._alert(
                    window, name, float(c), self.min_frac * busiest,
                    f"{c} shard pushes vs busiest shard's {busiest}"))
        return out


class SlabThrashDetector(Detector):
    """Tenant-slab churn sensor (NOT in the defaults — the
    ``ShardImbalanceDetector`` precedent: an operator opt-in for
    deployments running ``tpu_sgd_torch/tenant``).  A healthy slab admits a
    tenant once and serves it many times; when the working set exceeds
    capacity, every admission evicts a tenant the NEXT batch re-admits
    — each predict pays a disk restore plus a row-set dispatch, the
    latency cliff ``plan.choose_slab_capacity`` exists to prevent.
    Trips when the window's ``tenant.evict`` count exceeds
    ``max_evict_frac`` of its ``tenant.admit`` count (floor
    ``min_admits`` on admissions, so a cold-start fill — all admits,
    no evicts — and idle windows cannot trip)."""

    rule = "slab-thrash"

    def __init__(self, max_evict_frac: float = 0.5, min_admits: int = 16):
        self.max_evict_frac = float(max_evict_frac)
        self.min_admits = int(min_admits)

    def evaluate(self, window, history):
        admits = _count(window, "tenant.admit")
        if admits < self.min_admits:
            return []
        evicts = _count(window, "tenant.evict")
        bound = self.max_evict_frac * admits
        if evicts > bound:
            return [self._alert(
                window, "tenant.evict", float(evicts), bound,
                f"{evicts} evictions vs {admits} admissions — working "
                "set exceeds slab capacity")]
        return []


class DispatchRegressionDetector(Detector):
    rule = "dispatch-regression"

    def __init__(self, series: str = "train.dispatch",
                 factor: float = 3.0, min_history: int = 3,
                 floor: int = 20):
        self.series = series
        self.factor = float(factor)
        self.min_history = int(min_history)
        self.floor = int(floor)

    def evaluate(self, window, history):
        n = _count(window, self.series)
        past = sorted(_count(w, self.series) for w in history
                      if self.series in w["series"])
        if len(past) < self.min_history:
            return []
        median = past[len(past) // 2]
        if median < self.floor:
            return []  # idle/low-rate phases cannot trip on noise
        if n > self.factor * median:
            return [self._alert(
                window, self.series, n, self.factor * median,
                f"{n} dispatches vs trailing median {median}")]
        return []


class FailoverDetector(Detector):
    """Trips whenever a ``replica.failover`` observation lands in the
    window — the promotion span close and the membership event both
    feed the series, and a clean run records neither, so the rule has
    no false-positive surface.  The trip's ``obs_alert`` (plus the
    flight-recorder dump the engine's ``on_alert`` hook triggers) is
    the post-mortem's entry point for a store promotion."""

    rule = "failover"

    def __init__(self, series: str = "replica.failover"):
        self.series = series

    def evaluate(self, window, history):
        n = _count(window, self.series)
        if n < 1:
            return []
        return [self._alert(
            window, self.series, float(n), 1.0,
            "store primary promoted (see the replica.failover span / "
            "membership record for old/new primary, epoch, gap)")]


class IntegrityDetector(Detector):
    """Trips when any ``integrity.corrupt.<site>`` counter series moved
    in the window — one alert per site, value = corrupt frames seen.
    Detected-and-healed corruption still alerts ON PURPOSE (module
    docstring): the checksum plane turns silent damage into typed
    retries, and this rule turns the retries into an incident a human
    sees.  A clean run never records the series — no false-positive
    surface, same construction as :class:`FailoverDetector`."""

    rule = "integrity"

    def __init__(self, prefix: str = "integrity.corrupt.",
                 min_frames: int = 1):
        self.prefix = prefix
        self.min_frames = int(min_frames)

    def evaluate(self, window, history):
        out = []
        for name in sorted(window["series"]):
            if not name.startswith(self.prefix):
                continue
            n = _count(window, name)
            if n >= self.min_frames:
                out.append(self._alert(
                    window, name, float(n), float(self.min_frames),
                    f"{n} corrupt frame(s) detected at "
                    f"{name[len(self.prefix):]!r} this window"))
        return out


class HeartbeatStallDetector(Detector):
    """Trips when a WATCHED heartbeat is silent ``stall_windows``
    consecutive windows while at least one other watched heartbeat
    kept beating — the hang detector (class-level rationale in the
    module docstring).

    Roster discipline mirrors :class:`StragglerDetector`'s membership
    rule, with ``HealthMonitor.watch_heartbeat`` /
    ``unwatch_heartbeat`` as the join/leave events
    (``reliability.hb.watch[...]`` / ``...unwatch[...]`` series): only
    DECLARED-should-beat components are candidates (an idle batcher is
    silent and healthy — first-beat auto-join would false-trip every
    quiet component), a retire removes the entry so a clean shutdown
    cannot leave a phantom for the next run sharing this engine, and
    the any-peer-progressed gate makes fleet-wide silence (an idle or
    finished process) trip nothing.  Stateful; the engine serializes
    evaluation under its lock."""

    rule = "heartbeat-stall"

    def __init__(self, prefix: str = "reliability.heartbeat[",
                 roster_prefix: str = "reliability.hb.",
                 stall_windows: int = 4):
        self.prefix = prefix
        self.roster_prefix = roster_prefix
        self.stall_windows = int(stall_windows)
        self._silent: Dict[str, int] = {}  # name -> silent windows

    def _membership(self, window) -> None:
        rp = self.roster_prefix
        for name in window["series"]:
            if name.startswith(rp + "watch[") and name.endswith("]"):
                self._silent.setdefault(
                    name[len(rp) + len("watch["):-1], 0)
            elif name.startswith(rp + "unwatch[") and name.endswith("]"):
                self._silent.pop(
                    name[len(rp) + len("unwatch["):-1], None)

    def evaluate(self, window, history):
        self._membership(window)
        if not self._silent:
            return []
        beats = {name: _count(window, f"{self.prefix}{name}]")
                 for name in self._silent}
        if not any(beats.values()):
            return []  # fleet-wide silence: idle/finished, not a hang
        out = []
        for name in sorted(self._silent):
            if beats[name] > 0:
                self._silent[name] = 0
                continue
            self._silent[name] += 1
            if self._silent[name] >= self.stall_windows:
                out.append(self._alert(
                    window, f"{self.prefix}{name}]",
                    float(self._silent[name]),
                    float(self.stall_windows),
                    f"watched heartbeat {name!r} silent for "
                    f"{self._silent[name]} windows while peers beat"))
        return out


def default_detectors() -> List[Detector]:
    """The production rule set (loss divergence, staleness creep, shed
    rate, straggler, wire ratio, dispatch regression, failover,
    integrity and heartbeat stall).  Thresholds are
    the wide, low-false-positive defaults a clean seeded run never
    trips (pinned in tests); harnesses tighten per scenario."""
    return [
        LossDivergenceDetector(),
        StalenessCreepDetector(),
        LaneRejectionDetector(),
        StragglerDetector(),
        WireRatioDetector(),
        DispatchRegressionDetector(),
        FailoverDetector(),
        IntegrityDetector(),
        HeartbeatStallDetector(),
    ]


class DetectorEngine:
    """Evaluates a detector set per window close; registered with the
    live :class:`~tpu_sgd_torch.obs.timeseries.WindowStore` by the
    ``tpu_sgd_torch.obs.enable`` facade."""

    def __init__(self, detectors: Optional[Sequence[Detector]] = None,
                 history: int = 16,
                 on_alert: Optional[Callable[[Alert], None]] = None):
        self.detectors = list(detectors if detectors is not None
                              else default_detectors())
        self.on_alert = on_alert
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=int(history))
        self._active: Dict[tuple, Alert] = {}
        self._trips: Dict[str, int] = {}

    # -- the window-close listener ----------------------------------------
    def on_window_close(self, window: dict) -> None:
        tripped: Dict[tuple, Alert] = {}
        # evaluation runs UNDER the lock: two threads can close
        # back-to-back windows concurrently (closes fire outside the
        # store lock), and stateful detectors (StragglerDetector's
        # per-worker deficits) must see them serialized
        with self._lock:
            history = list(self._history)
            self._history.append(window)
            for det in self.detectors:
                try:
                    for alert in det.evaluate(window, history):
                        tripped[(alert.rule, alert.series)] = alert
                except Exception:
                    logger.warning(
                        "detector %r raised; skipped this window",
                        getattr(det, "rule", det), exc_info=True)
            fresh = [a for k, a in tripped.items()
                     if k not in self._active]
            self._active = tripped
            for a in fresh:
                self._trips[a.rule] = self._trips.get(a.rule, 0) + 1
        for alert in fresh:  # emit OUTSIDE the lock (sink IO, counters)
            self._emit(alert)

    def _emit(self, alert: Alert) -> None:
        from tpu_sgd_torch.obs import counters as _counters
        from tpu_sgd_torch.obs import spans as _spans

        _counters.inc(f"obs.alert.{alert.rule}")
        sink = _spans._SINK
        if sink is not None:
            payload = dataclasses.asdict(alert)
            payload["ts"] = time.time()
            try:
                sink.emit("obs_alert", payload)
            except Exception:
                logger.warning("trace sink raised; alert record dropped",
                               exc_info=True)
        if self.on_alert is not None:
            try:
                self.on_alert(alert)
            except Exception:
                logger.warning("on_alert hook raised; dropped",
                               exc_info=True)

    # -- scrape surface ----------------------------------------------------
    def active_alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def trip_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._trips)
