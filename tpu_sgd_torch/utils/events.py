"""Listeners, event logs and step timing: the port of
``tpu_sgd/utils/events.py``.

  * :class:`SGDListener`: per-iteration callbacks of the observed
    driver (``GradientDescent.set_listener``).
  * :class:`JsonLinesEventLog`: an append-only JSONL log of run and
    iteration events.
  * :func:`profile_trace`: a ``torch.profiler`` capture of a region,
    written as a Chrome trace (Perfetto).
  * :class:`StepTimer`: wall-clock per-call timing that ends with
    ``torch.cuda.synchronize()`` when the call returned tensors on the
    card.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass
from typing import List, Optional


#: lock-discipline declaration (the JAX package's analyzer reads these): the JSONL
#: file handle is shared by the serving flush thread, user threads, and
#: close() — every write/flush/close must hold the write lock so lines
#: stay whole and close never races a writer.
GRAFTLINT_LOCKS = {
    "JsonLinesEventLog": {
        "_f": "_write_lock",
    },
}


@dataclass
class IterationEvent:
    """One optimizer iteration (the analogue of a Spark job for one
    treeAggregate round)."""

    iteration: int
    loss: float
    weight_delta_norm: float
    mini_batch_size: int
    wall_time_s: float


@dataclass
class RunEvent:
    """Run-level summary (the analogue of SparkListenerJobEnd + logged
    loss history)."""

    event: str  # "run_started" | "run_completed"
    num_iterations: int = 0
    final_loss: Optional[float] = None
    converged_early: bool = False
    wall_time_s: float = 0.0


@dataclass
class ServeBatchEvent:
    """One coalesced serving batch (the JAX package's serving) — the observability
    record for the micro-batching path: how deep the queue ran, how many
    requests coalesced, the padded bucket actually compiled against, the
    oldest request's end-to-end latency, cumulative rejects, and which
    model version answered.

    ``enqueue_depth`` is the queue depth the batch's OLDEST request saw
    at its own enqueue, and ``deadline_slack_s`` is how much of the
    flush deadline was left when the batch actually flushed (negative =
    the deadline was missed by that much) — the two admission-control
    inputs: sustained high enqueue depth says shed earlier, sustained
    negative slack says the deadline is unkeepable at this load.

    ``lanes`` is the batch's priority-lane composition:
    ``{lane: {"n": rows, "max_latency_s": worst end-to-end latency of
    that lane's rows in this batch}}`` — what the per-lane p99 SLOs in
    ``obs.report`` evaluate over (a per-batch lane MAX, so the offline
    p99 is a conservative upper estimate of the per-request p99).

    All extras default (old readers of the JSONL stream and positional
    constructors keep working; new records simply carry more keys).
    """

    queue_depth: int
    batch_size: int
    padded_size: int
    latency_s: float
    reject_count: int
    model_version: int
    enqueue_depth: int = 0
    deadline_slack_s: float = 0.0
    lanes: Optional[dict] = None


@dataclass
class ServeReloadEvent:
    """A serving model hot-reload attempt: either a
    successful atomic swap to ``version`` or a rejected load (corrupt /
    unreadable checkpoint) with the retained previous-good version."""

    event: str  # "reloaded" | "load_failed"
    version: int
    previous_version: Optional[int] = None
    error: Optional[str] = None


@dataclass
class ReliabilityEvent:
    """One reliability observation (``tpu_sgd_torch.reliability``): a component
    heartbeat, a flagged straggler, a queue-depth sample, a supervisor
    retry/preemption/resume, or a quarantined checkpoint.  Logged as
    ``reliability_<kind>`` JSONL records so an incident replay can
    filter them with one prefix match."""

    kind: str    # "heartbeat" | "straggler" | "queue_depth" | "retry" | ...
    source: str  # emitting component, e.g. "prefetcher" | "supervisor"
    value: float = 0.0
    detail: str = ""


class SGDListener:
    """Override any subset; attached via ``GradientDescent.set_listener``."""

    def on_run_start(self, config) -> None: ...

    def on_iteration(self, event: IterationEvent) -> None: ...

    def on_run_end(self, event: RunEvent) -> None: ...

    def on_serve_batch(self, event: ServeBatchEvent) -> None: ...

    def on_serve_reload(self, event: ServeReloadEvent) -> None: ...

    def on_reliability(self, event: ReliabilityEvent) -> None: ...


class CollectingListener(SGDListener):
    """Buffers every event in memory (test/introspection helper)."""

    def __init__(self):
        self.iterations: List[IterationEvent] = []
        self.runs: List[RunEvent] = []
        self.serve_batches: List[ServeBatchEvent] = []
        self.serve_reloads: List[ServeReloadEvent] = []
        self.reliability: List[ReliabilityEvent] = []

    def on_run_start(self, config):
        self.runs.append(RunEvent(event="run_started"))

    def on_iteration(self, event):
        self.iterations.append(event)

    def on_run_end(self, event):
        self.runs.append(event)

    def on_serve_batch(self, event):
        self.serve_batches.append(event)

    def on_serve_reload(self, event):
        self.serve_reloads.append(event)

    def on_reliability(self, event):
        self.reliability.append(event)


class JsonLinesEventLog(SGDListener):
    """Append-only JSONL event log (the ``spark.eventLog`` analogue).

    ``fsync=True`` forces each record to stable storage before the
    write returns — the durability knob for post-mortem forensics (a
    host preemption must not eat the events explaining it).  Default
    off: an fsync per event is an O(ms) tax the serving flush thread
    cannot afford in steady state.
    """

    def __init__(self, path: str, fsync: bool = False):
        import threading

        self.path = path
        self.fsync = bool(fsync)
        self._f = open(path, "a")
        # the serving subsystem logs from its flush thread while user
        # threads log reloads/bulk scores through the same instance; the
        # lock keeps every JSONL line whole (a torn line breaks replay)
        self._write_lock = threading.Lock()

    def _write(self, kind: str, payload: dict):
        line = json.dumps({"kind": kind, "ts": time.time(),
                           **payload}, default=float) + "\n"
        with self._write_lock:
            if self._f.closed:
                return  # closed mid-shutdown: drop, don't raise in servers
            self._f.write(line)
            self._f.flush()
            if self.fsync:
                import os

                os.fsync(self._f.fileno())

    def emit(self, kind: str, payload: dict) -> None:
        """Public record-writer for EXTERNAL producers on this log's
        contract — the observability layer (``tpu_sgd_torch.obs``) emits its
        ``trace_span``/``trace_event``/``metric_counters`` records
        through here, so traces interleave with the listener events on
        one lock-serialized, torn-tail-tolerant JSONL stream that
        ``read()`` (and ``obs.report``) replays whole.  ``payload``'s
        own ``ts`` (the producer's timestamp) wins over the write-time
        default."""
        self._write(kind, payload)

    def on_run_start(self, config):
        self._write("run_started", {"config": asdict(config)})

    def on_iteration(self, event: IterationEvent):
        self._write("iteration", asdict(event))

    def on_run_end(self, event: RunEvent):
        self._write("run_completed", asdict(event))

    def on_serve_batch(self, event: ServeBatchEvent):
        self._write("serve_batch", asdict(event))

    def on_serve_reload(self, event: ServeReloadEvent):
        self._write("serve_reload", asdict(event))

    def on_reliability(self, event: ReliabilityEvent):
        payload = asdict(event)
        # the record's kind IS the prefixed form; the raw sub-kind field
        # would otherwise win the dict merge in _write and erase the
        # reliability_ prefix replay filters key on
        del payload["kind"]
        self._write(f"reliability_{event.kind}", payload)

    def close(self):
        with self._write_lock:  # never close out from under a writer
            self._f.close()

    @staticmethod
    def read(path: str):
        """Parse an event log back into a list of dicts.

        A crash (or preemption, without ``fsync=True``) can leave the
        final line torn mid-record; that trailing partial line is
        SKIPPED — losing the last event is the expected cost of a crash,
        not corruption.  Every record is written as one line ending in
        ``\\n``, so a torn tail is recognizable by the MISSING final
        newline; a malformed line that IS newline-terminated (anywhere,
        including last) still raises: that is real corruption replay
        must not paper over."""
        events = []
        with open(path) as f:
            content = f.read()
        lines = [ln for ln in content.split("\n") if ln.strip()]
        unterminated_tail = bool(content) and not content.endswith("\n")
        for i, ln in enumerate(lines):
            try:
                events.append(json.loads(ln))
            except json.JSONDecodeError:
                if i == len(lines) - 1 and unterminated_tail:
                    break  # crash-truncated tail: tolerate
                raise
        return events


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` capture of the enclosed region (the card's
    kernels too, when there is one), written to ``log_dir`` as a Chrome
    trace: open it in Perfetto."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (the port's
    ``block_until_ready``): each device of the tensors found in a nested
    tuple, list or dict is synchronized once."""
    import torch

    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Step-time harness.  :meth:`timed_call` waits for the card when the
    call returns CUDA tensors (``torch.cuda.synchronize``), so device work
    is included; the raw :meth:`time` context manager measures the plain
    wall clock of the enclosed block (queued device work is NOT
    awaited)."""

    def __init__(self):
        self.times: List[float] = []

    def timed_call(self, fn, *args, **kwargs):
        """Call ``fn``, wait for its outputs on the card, record the
        time."""
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            _synchronize(out)
        finally:
            # same contract as time(): failed work still spent the clock
            self.times.append(time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # a raising timed block still spent the wall clock; dropping
            # it would skew mean_s optimistic
            self.times.append(time.perf_counter() - t0)

    @property
    def mean_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
