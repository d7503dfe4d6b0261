"""Trace/SLO report pipeline: JSONL trace -> breakdowns, Chrome trace,
SLO verdict (the port of ``tpu_sgd/obs/report.py``; pure host code).
The record layout is the JAX package's, so each package's report reads
the other's traces.

The consuming half of the observability layer (spans + counters write,
this module reads)::

    python -m tpu_sgd_torch.obs.report events.jsonl            # stage tables
    python -m tpu_sgd_torch.obs.report events.jsonl --chrome t.json   # Perfetto
    python -m tpu_sgd_torch.obs.report events.jsonl --slo slo.json    # verdict

* **Per-stage breakdowns** — ``trace_span`` records grouped by name:
  count, total/mean wall, p50/p99/max (nearest-rank, the same
  percentile rule ``serve.metrics.ServingMetrics`` scrapes with).
* **Counter deltas** — ``metric_counters`` records (cumulative
  snapshots flushed by ``tpu_sgd_torch.obs``): last minus first, so a trace
  covering one soak reports what THAT soak spent.
* **Chrome trace-event export** — spans become ``ph:"X"`` complete
  events and instant events become ``ph:"i"`` on a per-thread-named
  timeline; the file loads in Perfetto / ``chrome://tracing``.
* **SLO evaluation** — a declarative JSON file of assertions over the
  trace; exit code 0 = all hold, 1 = violation, 2 = usage/parse error.
  This is the harness ROADMAP open item 3's continuous-deployment
  scenario asserts through (p99 bound, served-weight staleness, zero
  dropped requests across reloads).

SLO file format (README "Observability")::

    {"slos": [
      {"name": "serve-p99",  "metric": "span_p99_s",
       "span": "serve.batch", "max": 0.050},
      {"name": "no-drops",   "metric": "counter",
       "counter": "serve.reject", "max": 0},
      {"name": "fresh-weights", "metric": "staleness_s", "max": 30.0}
    ]}

``metric`` kinds: ``span_p50_s`` / ``span_p99_s`` / ``span_max_s`` /
``span_mean_s`` / ``span_count`` (over ``span`` name), ``counter``
(delta ``n`` of ``counter``; ``field: "bytes"`` selects bytes),
``staleness_s`` — for every ``serve_reload``-kind ``reloaded`` record,
the age of the served weights at swap time: reload ts minus the ts of
the ``checkpoint.save`` span that wrote that version (reloads of
checkpoints older than the trace window are skipped — their save is
simply not in the trace) — and two per-lane serving metrics (both
take a ``"lane"`` field): ``lane_p99_s`` — p99 over the per-batch
per-lane max latencies the ``serve_batch`` records carry (a
conservative UPPER estimate of the per-request p99, since each sample
is a batch's worst row) — and ``lane_shed_fraction`` — typed
rejections (rejected + shed + displaced) over offered requests for the
lane, from the ``serve.admitted/rejected/shed/displaced.<lane>``
counter deltas (offered counts each request once: displaced requests
already sit in admitted); ``alert_count`` (``obs_alert``
records, optional ``rule`` filter; absent = 0, honest for both a
``max: 0`` clean gate and a ``min: 1`` the-detector-tripped gate) and
two WINDOWED metrics taking ``span`` + ``window_s``:
``window_span_p99_s`` (the worst per-window p99 — unevaluable when the
span fired in no window, a violation, never silent green) and
``window_span_count_min`` (the minimum per-window count over the
trace's whole window grid — a window the span skipped counts ZERO, so
a mid-run stall fails a ``min`` bound).  Every SLO takes ``max``
and/or ``min``.

Parsing reuses ``JsonLinesEventLog.read`` — a crash-torn trailing line
is tolerated (the soak/crash forensics contract), a malformed interior
line still raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from tpu_sgd_torch.utils.events import JsonLinesEventLog

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: EMPTY on purpose — this module is a single-threaded offline reader; it
#: owns no shared mutable state and no locks.
GRAFTLINT_LOCKS: dict = {}


def load_trace(path: str) -> List[dict]:
    """All records of a trace JSONL, via the shared torn-tail-tolerant
    ``read()`` semantics."""
    return JsonLinesEventLog.read(path)


def _percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile — ONE shared definition with the live
    scrape (``serve.metrics.nearest_rank``), so an SLO written against
    a live p99 means the same thing evaluated offline."""
    from tpu_sgd_torch.serve.metrics import nearest_rank

    return nearest_rank(sorted(xs), p)


def span_stats(records: List[dict]) -> Dict[str, dict]:
    """Per-span-name aggregate: ``{name: {count, total_s, mean_s,
    p50_s, p99_s, max_s, errors}}``."""
    by_name: Dict[str, List[float]] = {}
    errors: Dict[str, int] = {}
    for r in records:
        if r.get("kind") != "trace_span":
            continue
        by_name.setdefault(r["name"], []).append(float(r["dur_s"]))
        if r.get("error"):
            errors[r["name"]] = errors.get(r["name"], 0) + 1
    out = {}
    for name, durs in sorted(by_name.items()):
        out[name] = {
            "count": len(durs),
            "total_s": sum(durs),
            "mean_s": sum(durs) / len(durs),
            "p50_s": _percentile(durs, 50),
            "p99_s": _percentile(durs, 99),
            "max_s": max(durs),
            "errors": errors.get(name, 0),
        }
    return out


def counter_deltas(records: List[dict]) -> Dict[str, Dict[str, int]]:
    """What the traced window spent: last ``metric_counters`` snapshot
    minus the first (one snapshot = that snapshot verbatim — cumulative
    from its enable())."""
    snaps = [r["counters"] for r in records
             if r.get("kind") == "metric_counters"]
    if not snaps:
        return {}
    first, last = snaps[0], snaps[-1]
    if len(snaps) == 1:
        first = {}
    out = {}
    for name, c in last.items():
        s = first.get(name, {"n": 0, "bytes": 0})
        dn = int(c["n"]) - int(s["n"])
        db = int(c["bytes"]) - int(s["bytes"])
        if dn or db:
            out[name] = {"n": dn, "bytes": db}
    return out


def staleness_samples(records: List[dict]) -> List[dict]:
    """Served-weight staleness per hot reload: for each ``serve_reload``
    record with ``event == "reloaded"``, the wall-clock age of the
    swapped-in version — reload ts minus the ts of the
    ``checkpoint.save`` span that wrote that version.  Reloads whose
    save predates the trace are skipped, not guessed."""
    save_ts: Dict[int, float] = {}
    for r in records:
        if r.get("kind") == "trace_span" \
                and r.get("name") == "checkpoint.save" \
                and "iteration" in r:
            # last save of a version wins (re-saves replace the file)
            save_ts[int(r["iteration"])] = float(r["ts"])
    out = []
    for r in records:
        if r.get("kind") == "serve_reload" and r.get("event") == "reloaded":
            v = int(r["version"])
            if v in save_ts:
                out.append({"version": v,
                            "staleness_s": float(r["ts"]) - save_ts[v]})
    return out


def alert_stats(records: List[dict]) -> dict:
    """The trace's typed detector trips (``obs_alert`` records,
    ``tpu_sgd_torch.obs.detect``): ``{"count", "by_rule": {rule: n},
    "alerts": [records...]}`` — the report's alerts section and the
    ``alert_count`` SLO metric both read this."""
    alerts = [r for r in records if r.get("kind") == "obs_alert"]
    by_rule: Dict[str, int] = {}
    for a in alerts:
        rule = a.get("rule", "?")
        by_rule[rule] = by_rule.get(rule, 0) + 1
    return {"count": len(alerts), "by_rule": by_rule, "alerts": alerts}


def windowed_stats(records: List[dict], width_s: float) -> List[dict]:
    """Time-bucketed per-stage tables: ``trace_span`` records bucketed
    by their epoch ``ts`` into fixed ``width_s`` windows — the OFFLINE
    twin of the live ``obs.timeseries`` ring (same fixed-width
    windowing, same nearest-rank percentiles), computed from the raw
    records so any trace gains a time dimension after the fact.  Each
    entry: ``{index, t_start, t_end, spans: {name: span_stats-row},
    alerts: [obs_alert records], staleness: [samples]}``.  Windows the
    trace never touched are ABSENT here; the window SLO metrics treat
    absent as zero/violation, never silent green."""
    if width_s <= 0:
        raise ValueError(f"window width must be > 0, got {width_s}")
    buckets: Dict[int, List[dict]] = {}
    for r in records:
        kind = r.get("kind")
        if kind not in ("trace_span", "obs_alert") or "ts" not in r:
            continue
        # an alert DESCRIBES a window (its t_start) but is EMITTED at
        # dispatch time, at least one window later (arbitrarily later
        # after a stall) — bucket it where the anomaly happened, next
        # to the spans it indicts, not where the detector ran
        ts = (float(r.get("t_start", r["ts"])) if kind == "obs_alert"
              else float(r["ts"]))
        buckets.setdefault(int(ts // width_s), []).append(r)
    # the staleness join gains its time dimension here: each sample is
    # bucketed at its RELOAD's ts (the moment the gap was served)
    stale_by_idx: Dict[int, List[dict]] = {}
    reload_ts = {int(r["version"]): float(r["ts"]) for r in records
                 if r.get("kind") == "serve_reload"
                 and r.get("event") == "reloaded"}
    for s in staleness_samples(records):
        ts = reload_ts.get(s["version"])
        if ts is not None:
            stale_by_idx.setdefault(int(ts // width_s), []).append(s)
    out = []
    for idx in sorted(set(buckets) | set(stale_by_idx)):
        bucket = buckets.get(idx, [])
        out.append({
            "index": idx,
            "t_start": idx * width_s,
            "t_end": (idx + 1) * width_s,
            "spans": span_stats(bucket),
            "alerts": [r for r in bucket if r.get("kind") == "obs_alert"],
            "staleness": stale_by_idx.get(idx, []),
        })
    return out


def lane_latency_stats(records: List[dict]) -> Dict[str, dict]:
    """Per-priority-lane serving latency aggregate from the
    ``serve_batch`` records' ``lanes`` composition: ``{lane: {batches,
    requests, p50_s, p99_s, max_s}}``.  The percentile samples are each
    batch's per-lane MAX latency, so p99 here upper-bounds the true
    per-request p99 — the conservative direction for an SLO gate."""
    by_lane: Dict[str, List[float]] = {}
    requests: Dict[str, int] = {}
    for r in records:
        if r.get("kind") != "serve_batch" or not r.get("lanes"):
            continue
        for lane, st in r["lanes"].items():
            by_lane.setdefault(lane, []).append(float(st["max_latency_s"]))
            requests[lane] = requests.get(lane, 0) + int(st["n"])
    out = {}
    for lane, maxima in sorted(by_lane.items()):
        out[lane] = {
            "batches": len(maxima),
            "requests": requests[lane],
            "p50_s": _percentile(maxima, 50),
            "p99_s": _percentile(maxima, 99),
            "max_s": max(maxima),
        }
    return out


def lane_admission_stats(records: List[dict]) -> Dict[str, dict]:
    """Per-lane admission-control table from the counter deltas:
    ``{lane: {admitted, rejected, shed, displaced, offered,
    reject_rate}}``.  ``offered`` counts each request ONCE —
    admitted + rejected + shed (a displaced request already sits in
    ``admitted``; that is why displacement is its own counter) — and
    ``reject_rate = (rejected + shed + displaced) / offered``: the
    fraction of offered requests that ended in a typed rejection, the
    number the overload scenario's verdict gates on."""
    deltas = counter_deltas(records)
    lanes: Dict[str, dict] = {}

    def bucket(prefix: str, key: str):
        for name, c in deltas.items():
            if name.startswith(prefix):
                lane = name[len(prefix):]
                if "." in lane:
                    continue  # not a lane leaf (e.g. a wire counter)
                st = lanes.setdefault(
                    lane, {"admitted": 0, "rejected": 0, "shed": 0,
                           "displaced": 0})
                st[key] += int(c["n"])

    bucket("serve.admitted.", "admitted")
    bucket("serve.rejected.", "rejected")
    bucket("serve.shed.", "shed")
    bucket("serve.displaced.", "displaced")
    for st in lanes.values():
        st["offered"] = st["admitted"] + st["rejected"] + st["shed"]
        st["reject_rate"] = (
            (st["rejected"] + st["shed"] + st["displaced"])
            / st["offered"] if st["offered"] else 0.0)
    return dict(sorted(lanes.items()))


# -- Chrome trace-event export ----------------------------------------------

def to_chrome_trace(records: List[dict]) -> dict:
    """Chrome trace-event JSON (object form), loadable in Perfetto /
    chrome://tracing.  Spans -> ``ph:"X"`` complete events on their
    thread's track (monotonic ``t0_s`` timebase, µs); instant events ->
    ``ph:"i"``; thread-name metadata rides ``ph:"M"`` records."""
    events = []
    tids: Dict[str, int] = {}

    def tid_of(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tids[thread],
                           "args": {"name": thread}})
        return tids[thread]

    core = {"kind", "name", "ts", "t0_s", "dur_s", "span_id",
            "parent_id", "thread", "subsystem"}
    for r in records:
        kind = r.get("kind")
        if kind == "trace_span":
            events.append({
                "ph": "X",
                "name": r["name"],
                "cat": r["name"].split(".", 1)[0],
                "pid": 1,
                "tid": tid_of(r.get("thread", "?")),
                "ts": float(r["t0_s"]) * 1e6,
                "dur": float(r["dur_s"]) * 1e6,
                "args": {k: v for k, v in r.items() if k not in core},
            })
        elif kind == "trace_event":
            events.append({
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "name": r["name"],
                "cat": r.get("subsystem", "event"),
                "pid": 1,
                "tid": tid_of(r.get("thread", "?")),
                "ts": float(r["t0_s"]) * 1e6,
                "args": {k: v for k, v in r.items() if k not in core},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- SLO evaluation ----------------------------------------------------------

_SPAN_METRICS = {"span_p50_s": "p50_s", "span_p99_s": "p99_s",
                 "span_max_s": "max_s", "span_mean_s": "mean_s",
                 "span_count": "count"}


def evaluate_slos(records: List[dict], slo_doc: dict) -> List[dict]:
    """Evaluate a declarative SLO document against a trace; returns one
    verdict dict per SLO: ``{name, metric, value, max?, min?, ok,
    detail?}``.  Unknown metric kinds and malformed entries raise
    ``ValueError`` (a typo'd SLO must fail the gate loudly, never pass
    green unevaluated)."""
    slos = slo_doc.get("slos")
    if not isinstance(slos, list):
        raise ValueError('SLO document must have a "slos" list')
    stats = span_stats(records)
    counters = counter_deltas(records)
    # pure functions of the records: compute once per document, not
    # once per SLO (a soak trace runs to 10^5 records, and the harness
    # documents carry several alert/window entries)
    alerts_memo: List[Optional[dict]] = [None]
    windows_memo: Dict[float, List[dict]] = {}

    def _alerts() -> dict:
        if alerts_memo[0] is None:
            alerts_memo[0] = alert_stats(records)
        return alerts_memo[0]

    def _windows(width: float) -> List[dict]:
        if width not in windows_memo:
            windows_memo[width] = windowed_stats(records, width)
        return windows_memo[width]

    verdicts = []
    for i, slo in enumerate(slos):
        metric = slo.get("metric")
        name = slo.get("name", f"slo-{i}")
        detail = None
        if metric in _SPAN_METRICS:
            span_name = slo.get("span")
            if not span_name:
                raise ValueError(f"SLO {name!r}: span metrics need a "
                                 '"span" field')
            st = stats.get(span_name)
            if st is None:
                # an SLO over a span that never fired: a count bound of
                # 0 legitimately passes; a latency bound cannot be
                # evaluated and must not silently pass
                if metric == "span_count":
                    value: Optional[float] = 0
                else:
                    value = None
                    detail = f"span {span_name!r} absent from trace"
            else:
                value = st[_SPAN_METRICS[metric]]
        elif metric == "counter":
            cname = slo.get("counter")
            if not cname:
                raise ValueError(f"SLO {name!r}: counter metric needs a "
                                 '"counter" field')
            field = slo.get("field", "n")
            if field not in ("n", "bytes"):
                raise ValueError(f"SLO {name!r}: field must be n|bytes")
            value = counters.get(cname, {"n": 0, "bytes": 0})[field]
        elif metric == "staleness_s":
            samples = staleness_samples(records)
            if not samples:
                value = None
                detail = "no reload-with-traced-save pairs in trace"
            else:
                value = max(s["staleness_s"] for s in samples)
        elif metric == "lane_p99_s":
            lane = slo.get("lane")
            if not lane:
                raise ValueError(f"SLO {name!r}: lane metrics need a "
                                 '"lane" field')
            st = lane_latency_stats(records).get(lane)
            if st is None:
                # a latency bound over a lane that never served cannot
                # be evaluated and must not silently pass
                value = None
                detail = f"lane {lane!r} absent from serve_batch records"
            else:
                value = st["p99_s"]
        elif metric == "lane_shed_fraction":
            lane = slo.get("lane")
            if not lane:
                raise ValueError(f"SLO {name!r}: lane metrics need a "
                                 '"lane" field')
            st = lane_admission_stats(records).get(lane)
            if st is None:
                # no admission counters for the lane at all: the trace
                # never ran admission control — unevaluable, not green
                value = None
                detail = (f"no serve.admitted/rejected/shed.{lane} "
                          "counters in trace")
            else:
                value = st["reject_rate"]
        elif metric == "alert_count":
            # typed detector trips: an absent rule counts 0
            # — honest for both directions (max 0 = clean-run gate,
            # min 1 = the-detector-really-tripped gate)
            rule = slo.get("rule")
            stats_a = _alerts()
            value = (stats_a["by_rule"].get(rule, 0)
                     if rule else stats_a["count"])
        elif metric in ("window_span_p99_s", "window_span_count_min"):
            span_name = slo.get("span")
            width = slo.get("window_s")
            if not span_name or not width:
                raise ValueError(f"SLO {name!r}: window metrics need "
                                 '"span" and "window_s" fields')
            wins = _windows(float(width))
            per = [w["spans"][span_name] for w in wins
                   if span_name in w["spans"]]
            if metric == "window_span_p99_s":
                if not per:
                    # a windowed latency bound over a span that never
                    # fired cannot be evaluated — a violation, never
                    # silent green
                    value = None
                    detail = (f"span {span_name!r} absent from every "
                              "window")
                else:
                    value = max(st["p99_s"] for st in per)
            else:
                if not wins:
                    value = None
                    detail = "trace has no windows at all"
                else:
                    # the MINIMUM per-window count over the trace's
                    # whole [first, last] window grid: a window the
                    # span skipped counts ZERO (a serving stall is a
                    # gap, not a missing row)
                    lo = min(w["index"] for w in wins)
                    hi = max(w["index"] for w in wins)
                    by_idx = {w["index"]: w for w in wins}
                    value = min(
                        by_idx.get(i, {"spans": {}})["spans"]
                        .get(span_name, {"count": 0})["count"]
                        for i in range(lo, hi + 1))
        else:
            raise ValueError(f"SLO {name!r}: unknown metric {metric!r}")
        lo, hi = slo.get("min"), slo.get("max")
        if lo is None and hi is None:
            raise ValueError(f"SLO {name!r}: needs max and/or min")
        if value is None:
            ok = False  # unevaluable is a violation, not a free pass
        else:
            ok = ((hi is None or value <= hi)
                  and (lo is None or value >= lo))
        v = {"name": name, "metric": metric, "value": value, "ok": ok}
        if hi is not None:
            v["max"] = hi
        if lo is not None:
            v["min"] = lo
        if detail:
            v["detail"] = detail
        verdicts.append(v)
    return verdicts


# -- CLI ---------------------------------------------------------------------

def _fmt_s(x: float) -> str:
    return f"{x * 1e3:9.3f}ms" if x < 1.0 else f"{x:8.3f}s "


def _fmt_num(x) -> str:
    """Alert value/bound formatting that survives a record missing the
    field (a foreign producer or schema drift must degrade the render,
    never crash the report or the live watcher)."""
    return f"{x:.4g}" if isinstance(x, (int, float)) else "?"


def render_report(records: List[dict]) -> str:
    lines = []
    stats = span_stats(records)
    if stats:
        lines.append("per-stage breakdown (trace_span records):")
        lines.append(f"  {'span':<28}{'count':>7}{'total':>12}"
                     f"{'p50':>12}{'p99':>12}{'max':>12}{'err':>5}")
        for name, st in stats.items():
            lines.append(
                f"  {name:<28}{st['count']:>7}"
                f"{_fmt_s(st['total_s']):>12}{_fmt_s(st['p50_s']):>12}"
                f"{_fmt_s(st['p99_s']):>12}{_fmt_s(st['max_s']):>12}"
                f"{st['errors']:>5}")
    else:
        lines.append("no trace_span records in trace")
    deltas = counter_deltas(records)
    if deltas:
        lines.append("counter deltas (metric_counters records):")
        for name, c in sorted(deltas.items()):
            extra = f"  bytes={c['bytes']}" if c["bytes"] else ""
            lines.append(f"  {name:<40}{c['n']:>10}{extra}")
        from tpu_sgd_torch.obs.counters import wire_ratios

        ratios = wire_ratios(deltas)
        if ratios:
            lines.append("wire formats (physical vs dense-f32-logical "
                         "bytes; ratio = compression):")
            for name, r in sorted(ratios.items()):
                lines.append(
                    f"  {name:<34}{r['n']:>8}"
                    f"  physical={r['physical_bytes']:>12}"
                    f"  logical={r['logical_bytes']:>12}"
                    f"  ratio={r['ratio']:.1f}x")
    lane_lat = lane_latency_stats(records)
    lane_adm = lane_admission_stats(records)
    if lane_lat or lane_adm:
        lines.append("serving lanes (admission control + per-batch "
                     "lane-max latency):")
        lines.append(f"  {'lane':<14}{'admitted':>9}{'rejected':>9}"
                     f"{'shed':>7}{'displ':>7}{'rej-rate':>9}"
                     f"{'p50':>12}{'p99':>12}")
        for lane in sorted(set(lane_lat) | set(lane_adm)):
            a = lane_adm.get(lane, {})
            lt = lane_lat.get(lane)
            lines.append(
                f"  {lane:<14}{a.get('admitted', 0):>9}"
                f"{a.get('rejected', 0):>9}{a.get('shed', 0):>7}"
                f"{a.get('displaced', 0):>7}"
                f"{a.get('reject_rate', 0.0):>8.1%}"
                + (f"{_fmt_s(lt['p50_s']):>12}{_fmt_s(lt['p99_s']):>12}"
                   if lt else f"{'-':>12}{'-':>12}"))
    stale = staleness_samples(records)
    if stale:
        worst = max(s["staleness_s"] for s in stale)
        lines.append(f"served-weight staleness: {len(stale)} reload(s), "
                     f"worst {worst:.3f}s")
    alerts = alert_stats(records)
    if alerts["count"]:
        lines.append(f"alerts ({alerts['count']} typed obs_alert "
                     "trips):")
        for rule, n in sorted(alerts["by_rule"].items()):
            lines.append(f"  {rule:<28}{n:>5}")
        for a in alerts["alerts"][:20]:
            lines.append(
                f"    [{a.get('rule')}] {a.get('series')}: "
                f"value={_fmt_num(a.get('value'))} "
                f"bound={_fmt_num(a.get('bound'))}"
                f"  {a.get('detail', '')}")
        if alerts["count"] > 20:
            lines.append(f"    ... {alerts['count'] - 20} more")
    return "\n".join(lines)


def render_windows(windows: List[dict], last: Optional[int] = None) -> str:
    """Text tables for :func:`windowed_stats` output (shared by the
    report CLI's ``--window`` and the live watch CLI)."""
    lines = []
    if last is not None:
        windows = windows[-int(last):]
    if not windows:
        return "no windowed records"
    for w in windows:
        head = (f"window {w['index']}  [{w['t_start']:.3f}, "
                f"{w['t_end']:.3f})")
        if w["alerts"]:
            head += f"  ALERTS={len(w['alerts'])}"
        lines.append(head)
        if w["spans"]:
            lines.append(f"  {'span':<28}{'count':>7}{'p50':>12}"
                         f"{'p99':>12}{'max':>12}{'err':>5}")
            for name, st in w["spans"].items():
                lines.append(
                    f"  {name:<28}{st['count']:>7}"
                    f"{_fmt_s(st['p50_s']):>12}{_fmt_s(st['p99_s']):>12}"
                    f"{_fmt_s(st['max_s']):>12}{st['errors']:>5}")
        for a in w["alerts"]:
            lines.append(f"  ALERT [{a.get('rule')}] {a.get('series')}: "
                         f"value={_fmt_num(a.get('value'))} "
                         f"bound={_fmt_num(a.get('bound'))}")
        for s in w["staleness"]:
            lines.append(f"  staleness: version {s['version']} served "
                         f"{s['staleness_s']:.3f}s old")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_sgd_torch.obs.report",
        description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="trace JSONL path (JsonLinesEventLog)")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--slo", metavar="SLO.json",
                    help="evaluate a declarative SLO file; exit 1 on "
                         "violation")
    ap.add_argument("--window", metavar="SECONDS", type=float,
                    default=None,
                    help="add time-bucketed per-stage tables at this "
                         "window width (the offline twin of the live "
                         "obs.timeseries ring)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)
    if args.window is not None and args.window <= 0:
        # the exit-code contract: 2 is the usage-error class, never a
        # traceback (1 is reserved for SLO violations)
        print(f"error: --window must be > 0, got {args.window}",
              file=sys.stderr)
        return 2
    try:
        records = load_trace(args.trace)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read trace {args.trace!r}: {e}",
              file=sys.stderr)
        return 2

    verdicts = None
    if args.slo:
        try:
            with open(args.slo) as f:
                slo_doc = json.load(f)
            verdicts = evaluate_slos(records, slo_doc)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"error: bad SLO file {args.slo!r}: {e}",
                  file=sys.stderr)
            return 2

    if args.chrome:
        try:
            with open(args.chrome, "w") as f:
                json.dump(to_chrome_trace(records), f)
        except OSError as e:
            # an unwritable export path is the usage-error class (2),
            # NOT the SLO-violation class (1) chaos_soak gates on
            print(f"error: cannot write Chrome trace {args.chrome!r}: "
                  f"{e}", file=sys.stderr)
            return 2

    if args.json:
        from tpu_sgd_torch.obs.counters import wire_ratios

        out = {"spans": span_stats(records),
               "counters": counter_deltas(records),
               "wire": wire_ratios(counter_deltas(records)),
               "staleness": staleness_samples(records),
               "lanes": {"latency": lane_latency_stats(records),
                         "admission": lane_admission_stats(records)},
               "alerts": alert_stats(records)}
        if args.window:
            out["windows"] = windowed_stats(records, args.window)
        if verdicts is not None:
            out["slos"] = verdicts
        print(json.dumps(out, indent=2))
    else:
        print(render_report(records))
        if args.window:
            print(f"time-bucketed tables ({args.window:g}s windows):")
            print(render_windows(windowed_stats(records, args.window)))
        if verdicts is not None:
            for v in verdicts:
                bound = " ".join(
                    f"{k}={v[k]}" for k in ("min", "max") if k in v)
                state = "PASS" if v["ok"] else "FAIL"
                val = ("<unevaluable>" if v["value"] is None
                       else f"{v['value']:.6g}")
                extra = f"  ({v['detail']})" if v.get("detail") else ""
                print(f"SLO {state}: {v['name']}: {v['metric']}="
                      f"{val} vs {bound}{extra}")

    if verdicts is not None and not all(v["ok"] for v in verdicts):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
