"""Runtime counters: the port of ``tpu_sgd/obs/counters.py``.

Explicit hook sites (``inc("train.io_callback")``, ``inc(
"integrity.corrupt")``) bump named counters in one thread-safe registry.
Names are dotted, the leading segment the subsystem; each counter holds
a count ``n`` and a byte total ``bytes``.

:func:`enable` also installs counting hooks on the port's own funnels,
once, and :func:`disable` removes them in the reverse order (so hooks
installed over them by someone else, or under them, nest cleanly).
Every count is tagged ``<subsystem>.<kind>`` with the calling thread's
span tag (``obs.spans.current_subsystem()``: a replica worker's launches
land under its span's subsystem, the training loop's under ``train``).
The kinds keep the JAX package's names, so its rules (the detectors'
``train.dispatch``) read the port's counts; what each counts here:

* ``dispatch`` -- one per host call that puts device work in flight
  through the port's funnels: one per CUDA-graph replay of a captured
  SGD block (``optimize/gradient_descent.py``, ``_BlockRunner``, through
  ``cuda_kernels.add_replayed_launches``), and one per call of a
  hand-written kernel's launch made outside a capture
  (``cuda_kernels.count_launch`` with a ``source`` or a CSR column
  count: the dense sources' launches of ``kernel_launch_counts()`` and
  the CSR wrappers' calls).  A captured block counts once per replay,
  however many kernels it holds, as the JAX package counts a
  ``while_loop`` program once.  Library ops (``torch.matmul``, the
  eager elementwise ops, cuSPARSE) go through no funnel of the port and
  are not counted.
* ``compile`` -- one per CUDA-graph capture (``cuda_kernels.
  captured_launches``) and one per kernel source that ``nvcc`` builds
  at first use (``ops/_build.py``; a library already built counts 0).
* ``host_sync`` -- one per device-to-host read of a CUDA tensor through
  ``item``, ``tolist``, ``cpu``, ``numpy``, ``__bool__``, ``__float__``,
  ``__int__`` or ``__array__`` (patched on ``torch.Tensor``), and one per
  fetch of the observed drivers' ys rows (``optimize.gradient_descent.
  _fetch_rows``: a copy into pinned memory, then a wait for the stream),
  with the bytes read.  CPU tensors never count.  A read by another route
  (``Tensor.to("cpu")``, ``copy_`` into a host tensor, an op whose
  output size depends on the data) is not seen, nor is a wait that
  reads nothing (``torch.cuda.synchronize``, a staging slot's event).
* ``h2d`` -- bytes copied host-to-device at the port's two staging
  funnels: the pinned ring's send (``io.prefetch.PinnedRing.send``) and
  the one copy of a padded serving batch (``ops/bucketed.py``).

Cost contract: DISABLED is one module-global load and a falsy branch per
``inc()`` call, and no hook is installed at all.  ENABLED costs host
time only: the hooks are Python wrappers around the funnels; they add no
launch, capture or sync of their own.  Counter values survive
:func:`disable`, and :func:`reset` clears them.
"""

from __future__ import annotations

import contextlib
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
    base = f"{_tagged('wire')}.{fmt}"
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


# -- runtime hooks -----------------------------------------------------------

#: the originals the hooks replaced, in install order, while enabled:
#: ``(owner, name, original, owned)``; ``owned`` says whether the name was
#: in the owner's own ``__dict__`` (else the hook is deleted on restore,
#: and the inherited attribute shows through again)
_PATCHES: Optional[list] = None

#: the device-to-host reads counted as ``host_sync``
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
                "__int__", "__array__")

_TLS = threading.local()  # .capturing / .reading: per-thread depths


def _tagged(kind: str) -> str:
    from tpu_sgd_torch.obs.spans import current_subsystem

    return f"{current_subsystem()}.{kind}"


def _card(x) -> bool:
    """Whether a tensor (or a device) is the card's: the one test of the
    ``host_sync`` and ``h2d`` hooks (CPU tensors never count)."""
    return getattr(x, "is_cuda", False) or getattr(x, "type", None) == "cuda"


def _depth(name: str) -> int:
    return getattr(_TLS, name, 0)


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _read_hook(orig, nbytes):
    """A device-to-host read, counted once when its first argument is on
    the card (a read inside it counts nothing), with ``nbytes(arg,
    result)`` bytes."""
    def counted(t, *args, **kwargs):
        if _depth("reading") or not _card(t):
            return orig(t, *args, **kwargs)
        _TLS.reading = 1
        try:
            out = orig(t, *args, **kwargs)
        finally:
            _TLS.reading = 0
        _GLOBAL.inc(_tagged("host_sync"), nbytes=nbytes(t, out))
        return out

    counted.__wrapped__ = orig
    return counted


def _sync_hook(orig):
    return _read_hook(orig, lambda t, out: _nbytes(t))


def _fetch_hook(orig):
    return _read_hook(orig, lambda src, out: int(out.nbytes))


def _launch_hook(orig):
    def counted(wrapper=None, source=None, route=None, csr_columns=None):
        if (source is not None or csr_columns is not None) \
                and not _depth("capturing"):
            _GLOBAL.inc(_tagged("dispatch"))
        return orig(wrapper, source=source, route=route,
                    csr_columns=csr_columns)

    counted.__wrapped__ = orig
    return counted


def _replay_hook(orig):
    def counted(record):
        _GLOBAL.inc(_tagged("dispatch"))
        return orig(record)

    counted.__wrapped__ = orig
    return counted


def _capture_hook(orig):
    @contextlib.contextmanager
    def counted():
        _GLOBAL.inc(_tagged("compile"))
        _TLS.capturing = _depth("capturing") + 1
        try:
            with orig() as record:
                yield record
        finally:
            _TLS.capturing -= 1

    counted.__wrapped__ = orig
    return counted


def _build_hook(orig):
    def counted(name):
        job = orig(name)
        if job is not None:  # nvcc started: a build, not a cache hit
            _GLOBAL.inc(_tagged("compile"))
        return job

    counted.__wrapped__ = orig
    return counted


def _send_hook(orig):
    def counted(self, slot, copies=(), after=None):
        copies = list(copies)
        nbytes = sum(_nbytes(src) for dst, src in copies
                     if _card(dst) and dst.data_ptr() != src.data_ptr())
        if nbytes:
            _GLOBAL.inc(_tagged("h2d"), nbytes=nbytes)
        return orig(self, slot, copies, after)

    counted.__wrapped__ = orig
    return counted


def _padded_hook(orig):
    def counted(X, rows, dev):
        out = orig(X, rows, dev)
        if _card(dev) and not _card(X):
            _GLOBAL.inc(_tagged("h2d"), nbytes=_nbytes(out))
        return out

    counted.__wrapped__ = orig
    return counted


def _hooks():
    """``(owner, name, make_hook)`` for every hook, in install order."""
    import torch

    from tpu_sgd_torch.io.prefetch import PinnedRing
    from tpu_sgd_torch.ops import _build, bucketed
    from tpu_sgd_torch.ops import cuda_kernels as ck
    from tpu_sgd_torch.optimize import gradient_descent

    return ([(torch.Tensor, name, _sync_hook) for name in SYNC_METHODS]
            + [(gradient_descent, "_fetch_rows", _fetch_hook),
               (ck, "count_launch", _launch_hook),
               (ck, "add_replayed_launches", _replay_hook),
               (ck, "captured_launches", _capture_hook),
               (_build, "_start", _build_hook),
               (PinnedRing, "send", _send_hook),
               (bucketed, "_padded", _padded_hook)])


def enable() -> None:
    """Install the counting hooks and open the ``inc`` gate.  Idempotent.
    Prefer the ``tpu_sgd_torch.obs.enable`` facade, which also wires
    tracing and flushes counters into the trace on disable."""
    global _ENABLED, _PATCHES
    if _ENABLED:
        return
    saved = []
    try:
        for owner, name, make in _hooks():
            orig = getattr(owner, name)
            owned = name in vars(owner)
            setattr(owner, name, make(orig))
            saved.append((owner, name, orig, owned))
    except Exception:
        _restore(saved)
        raise
    _PATCHES = saved
    _ENABLED = True


def _restore(saved: list) -> None:
    """Put back every original, the last installed first."""
    for owner, name, orig, owned in reversed(saved):
        if owned:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


def disable() -> None:
    """Remove every hook and close the gate.  Idempotent; counter VALUES
    survive (scrape after disable is fine); ``reset()`` clears."""
    global _ENABLED, _PATCHES
    if not _ENABLED:
        return
    _ENABLED = False
    saved, _PATCHES = _PATCHES, None
    if saved is not None:
        _restore(saved)


def is_enabled() -> bool:
    return _ENABLED
