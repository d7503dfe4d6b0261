"""Live trace watcher: tail a RUNNING trace, render windowed tables +
active alerts (the port of ``tpu_sgd/obs/watch.py``; pure host code).

``obs.report`` is the post-mortem; this is the pager screen::

    python -m tpu_sgd_torch.obs.watch run_trace.jsonl            # follow
    python -m tpu_sgd_torch.obs.watch run_trace.jsonl --once     # one render

The watcher tails the JSONL file the way ``tail -f`` would — an
incremental reader that buffers a torn/in-flight final line until its
newline arrives (the shared crash-forensics contract) and SKIPS (but
counts) malformed interior lines instead of dying: a live view must
survive whatever a crashing producer wrote.  Records feed the same
fixed-width windowing the offline report uses
(:func:`tpu_sgd_torch.obs.report.windowed_stats` over a BOUNDED deque of
recent records — memory is bounded by the retention cap, never by how
long the watched run has been going), so the table on this screen and
the table in the post-mortem report are the same numbers.

Rendered per refresh: the last ``--last`` windows' per-span
count/p50/p99/max tables, the latest cumulative counter snapshot's
headline counts, and the ACTIVE alerts — ``obs_alert`` records whose
window falls inside the last ``--active-s`` seconds of trace time
(typed records from ``tpu_sgd_torch.obs.detect``, not grepped log lines).

Exit codes: 0 on EOF (``--once``) or Ctrl-C (follow mode), 2 on an
unreadable trace path — the report CLI's usage-error class.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque
from typing import List, Optional

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: EMPTY on purpose — the watcher is a single-threaded reader; it owns no
#: shared mutable state and no locks.
GRAFTLINT_LOCKS: dict = {}


class TraceTail:
    """Incremental JSONL reader: ``poll()`` returns the records whose
    lines completed since the last poll.  A final line with no newline
    yet is buffered (the producer is mid-write); a malformed
    newline-terminated line is counted in ``parse_errors`` and
    skipped — the live view renders on, the post-mortem ``read()``
    still treats interior corruption as fatal."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path)
        self._buf = ""
        self.parse_errors = 0
        self.records_seen = 0

    def poll(self) -> List[dict]:
        chunk = self._f.read()
        if not chunk:
            return []
        self._buf += chunk
        *complete, self._buf = self._buf.split("\n")
        out = []
        for line in complete:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                self.parse_errors += 1
        self.records_seen += len(out)
        return out

    def close(self):
        self._f.close()


class WatchState:
    """Bounded rolling state: recent records for the window tables,
    alerts, and the newest cumulative counter snapshot."""

    def __init__(self, retain: int = 20000, alert_retain: int = 256):
        self.recent: deque = deque(maxlen=int(retain))
        self.alerts: deque = deque(maxlen=int(alert_retain))
        self.counters: Optional[dict] = None
        self.last_ts: float = 0.0

    def feed(self, records: List[dict]) -> None:
        for r in records:
            kind = r.get("kind")
            ts = r.get("ts")
            if ts is not None:
                self.last_ts = max(self.last_ts, float(ts))
            if kind in ("trace_span", "obs_alert"):
                self.recent.append(r)
            if kind == "obs_alert":
                self.alerts.append(r)
            elif kind == "metric_counters":
                self.counters = r.get("counters")

    def active_alerts(self, horizon_s: float) -> List[dict]:
        cutoff = self.last_ts - horizon_s
        return [a for a in self.alerts
                if float(a.get("ts", 0.0)) >= cutoff]


def render(state: WatchState, tail: TraceTail, window_s: float,
           last: int, active_s: float) -> str:
    from tpu_sgd_torch.obs.report import (_fmt_num, render_windows,
                                          windowed_stats)

    lines = [
        f"== obs.watch {tail.path}  records={tail.records_seen}"
        + (f"  parse_errors={tail.parse_errors}"
           if tail.parse_errors else "")
    ]
    wins = windowed_stats(list(state.recent), window_s)
    lines.append(render_windows(wins, last=last))
    active = state.active_alerts(active_s)
    if active:
        lines.append(f"ACTIVE ALERTS (last {active_s:g}s):")
        for a in active:
            lines.append(
                f"  [{a.get('rule')}] {a.get('series')}: "
                f"value={_fmt_num(a.get('value'))} "
                f"bound={_fmt_num(a.get('bound'))}"
                f"  {a.get('detail', '')}")
    else:
        lines.append(f"no active alerts (last {active_s:g}s)")
    if state.counters:
        headline = {k: v for k, v in sorted(state.counters.items())
                    if k.endswith((".dispatch", ".compile",
                                   ".host_sync")) or
                    k.startswith("obs.alert.")}
        if headline:
            lines.append("counters (cumulative):")
            for k, v in headline.items():
                lines.append(f"  {k:<40}{v['n']:>10}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_sgd_torch.obs.watch",
        description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="trace JSONL path being written")
    ap.add_argument("--window", metavar="SECONDS", type=float,
                    default=1.0, help="window width (default 1s)")
    ap.add_argument("--last", type=int, default=6,
                    help="windows to render (default 6)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh interval in follow mode (default 1s)")
    ap.add_argument("--active-s", type=float, default=30.0,
                    help="alert active horizon in trace seconds")
    ap.add_argument("--once", action="store_true",
                    help="read to EOF, render once, exit (the CI/test "
                         "spelling)")
    args = ap.parse_args(argv)
    try:
        tail = TraceTail(args.trace)
    except OSError as e:
        print(f"error: cannot open trace {args.trace!r}: {e}",
              file=sys.stderr)
        return 2
    state = WatchState()
    try:
        if args.once:
            state.feed(tail.poll())
            print(render(state, tail, args.window, args.last,
                         args.active_s))
            return 0
        while True:
            fed = tail.poll()
            if fed:
                state.feed(fed)
            print(render(state, tail, args.window, args.last,
                         args.active_s), flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        tail.close()


if __name__ == "__main__":
    sys.exit(main())
