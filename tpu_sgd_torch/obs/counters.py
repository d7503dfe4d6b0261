"""Runtime counters, the registry half: the port of the registry in
``tpu_sgd/obs/counters.py``.

Explicit hook sites (``inc("train.io_callback")``, ``inc(
"integrity.corrupt")``) bump named counters in one thread-safe registry.
Names are dotted, the leading segment the subsystem; each counter holds
a count ``n`` and a byte total ``bytes``.

Cost contract: DISABLED is one module-global load and a falsy branch per
``inc()`` call, and nothing else.  :func:`enable` opens the gate and
:func:`disable` closes it; counter values survive :func:`disable`, and
:func:`reset` clears them.

Not ported yet: the JAX package's ``enable`` also patches the runtime's
dispatch, sync and transfer funnels so that launches and host syncs count
themselves.  Their counterparts here (kernel launches, graph replays and
host syncs) wait for ROADMAP A11.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

__all__ = ["RuntimeCounters", "inc", "record_wire", "wire_ratios",
           "enable", "disable", "is_enabled", "snapshot", "reset", "deltas"]

logger = logging.getLogger("tpu_sgd_torch.obs")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the counts dict is written from every thread that calls ``inc`` —
#: ``a += 1`` on a dict entry is a read-modify-write that loses updates
#: without the lock.
GRAFTLINT_LOCKS = {
    "RuntimeCounters": {
        "_counts": "_lock",
    },
}

#: fast-path gate: ``inc()`` reads this ONE module global and returns
#: when falsy — the entire disabled-mode cost
_ENABLED = False


class RuntimeCounters:
    """Thread-safe ``name -> {n, bytes}`` accumulator.

    ``forward`` (a GIL-atomic single reference, default ``None``) tees
    every inc to a second consumer.  It is called OUTSIDE the lock and
    must be pure host work; a raising forward target is dropped."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, Dict[str, int]] = {}
        self.forward = None

    def inc(self, name: str, n: int = 1, nbytes: int = 0) -> None:
        with self._lock:
            c = self._counts.get(name)
            if c is None:
                c = self._counts[name] = {"n": 0, "bytes": 0}
            c["n"] += n
            c["bytes"] += nbytes
        fwd = self.forward
        if fwd is not None:
            try:
                fwd(name, n, nbytes)
            except Exception:  # accounting must never kill the hot path
                logger.warning("counter forward raised; dropped",
                               exc_info=True)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._counts.items()}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: THE process-wide registry instance (tests may build private ones)
_GLOBAL = RuntimeCounters()


def inc(name: str, n: int = 1, nbytes: int = 0) -> None:
    """Hot-path hook: bump a named counter.  Keep the disabled branch to
    the single global check."""
    if not _ENABLED:
        return
    _GLOBAL.inc(name, n, nbytes)


def record_wire(fmt: str, logical_nbytes: int, physical_nbytes: int,
                tag: Optional[str] = None) -> None:
    """Tag one wire transfer by FORMAT (``dense-f32`` / ``bf16`` / ``csr``
    / ``topk``): ``physical`` is what actually crosses the link, ``logical``
    the dense-f32-equivalent payload it represents.  Counter names:
    ``<subsystem>.wire.<fmt>`` carries the physical bytes,
    ``<subsystem>.wire.<fmt>.logical`` the logical bytes, both with one
    ``n`` per transfer (``<subsystem>`` is the calling thread's span tag,
    ``obs.spans.current_subsystem``).  ``tag`` fans the format out per
    instance with the span fan-outs' bracket syntax
    (``<subsystem>.wire.<fmt>[<tag>]``: the sharded store's per-shard
    wires tag ``s0..s{S-1}``).  Same disabled-mode cost contract as
    :func:`inc`."""
    if not _ENABLED:
        return
    from tpu_sgd_torch.obs.spans import current_subsystem

    base = f"{current_subsystem()}.wire.{fmt}"
    if tag is not None:
        base = f"{base}[{tag}]"
    _GLOBAL.inc(base, nbytes=int(physical_nbytes))
    _GLOBAL.inc(base + ".logical", nbytes=int(logical_nbytes))


def wire_ratios(counts: Optional[Dict[str, Dict[str, int]]] = None
                ) -> Dict[str, Dict[str, float]]:
    """Per-stage wire compression table from a counter snapshot:
    ``{"<subsystem>.wire.<fmt>": {n, physical_bytes, logical_bytes,
    ratio}}`` with ``ratio = logical / physical``."""
    counts = snapshot() if counts is None else counts
    out: Dict[str, Dict[str, float]] = {}
    for name, c in counts.items():
        if ".wire." not in name or name.endswith(".logical"):
            continue
        logical = counts.get(name + ".logical", {"bytes": 0})["bytes"]
        phys = c["bytes"]
        out[name] = {
            "n": c["n"],
            "physical_bytes": phys,
            "logical_bytes": logical,
            "ratio": (logical / phys) if phys else float("inf"),
        }
    return out


def snapshot() -> Dict[str, Dict[str, int]]:
    """Cumulative counters since ``enable()``/``reset()`` — the scrape
    surface.  ``{name: {"n": count, "bytes": bytes}}``."""
    return _GLOBAL.snapshot()


def reset() -> None:
    _GLOBAL.reset()


class deltas:
    """Region helper over the GLOBAL registry: ``with deltas() as d:``
    then ``d.get()`` returns the per-name count/byte deltas the region
    produced (requires counters already enabled)."""

    def __enter__(self):
        self._start = snapshot()
        return self

    def get(self) -> Dict[str, Dict[str, int]]:
        out = {}
        for name, c in snapshot().items():
            s = self._start.get(name, {"n": 0, "bytes": 0})
            dn, db = c["n"] - s["n"], c["bytes"] - s["bytes"]
            if dn or db:
                out[name] = {"n": dn, "bytes": db}
        return out

    def __exit__(self, *exc):
        return False


def enable() -> None:
    """Open the ``inc`` gate.  Idempotent."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Close the gate.  Idempotent; counter VALUES survive."""
    global _ENABLED
    _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED
