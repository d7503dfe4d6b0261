"""Named, seedable, deterministic fault injection: the port of
``tpu_sgd/reliability/failpoints.py`` (pure Python, copied whole).

A **failpoint** is a named hook site compiled into a hot path::

    from tpu_sgd_torch.reliability.failpoints import failpoint
    failpoint("io.resident_callback")     # zero-overhead when disabled

and a **spec** arms it from a test or a chaos harness::

    from tpu_sgd_torch.reliability import failpoints as fp
    with fp.inject_faults({"checkpoint.save": fp.fail_nth(3)}):
        ...   # the 3rd save raises FaultInjected, then it heals

Specs are deterministic: ``fail_nth(k)`` triggers on exactly the k-th
hit (one-shot: the retry that follows succeeds, which is the behavior
under test); ``fail_prob(p, seed)`` draws from a private seeded stream
so a chaos run replays bit-identically from its seed; and
``inject_latency(ms)`` delays without raising.  The exception class is
configurable per spec, so a site can be made to throw exactly what its
caller claims to tolerate.

Corrupting mode: a payload-carrying hook site passes its frame through
:func:`corruptpoint`, and a ``corrupt_nth(k, kind=...)`` /
``corrupt_prob(p, seed, kind=...)`` spec returns a deterministically
mutated COPY of the payload instead of raising (``"bitflip"``,
``"nan"``, ``"truncate"``); the checksummed frames of
``tpu_sgd_torch/io/integrity.py`` detect the damage at their consume
site.

Cost when disabled, the only state a production process ever runs in,
is one module-global load and a falsy branch per hit: no dict lookup,
no lock, no allocation.  The hook sites this package compiles in are
declared in :data:`HOOK_SITES`.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Dict, Optional, Type


class FaultInjected(RuntimeError):
    """The default exception a triggered failpoint raises.  A transient
    fault by construction: retry policies treat it as retryable."""


class FailpointSpec:
    """Arming rule for one site.  Exactly one trigger mode:

    * ``nth``  — trigger on the nth hit (1-based), ONE-SHOT: later hits
      pass, so a retry/resume after the injected fault succeeds.
    * ``prob`` — trigger each hit with probability ``prob`` from a
      private ``random.Random(seed)`` stream (deterministic replay).

    On trigger: sleep ``latency_s`` (if set), then — when ``corrupt``
    names a mutation kind and the site passed a payload through
    :func:`corruptpoint` — mutate a COPY of the payload and return it;
    otherwise raise ``exc``, or return normally when ``exc`` is None
    (latency-only fault).  A corrupting spec armed at a plain
    payload-less ``failpoint()`` site triggers but mutates nothing
    (there is no frame to damage — arm it at a ``corruptpoint`` site).
    """

    CORRUPT_KINDS = ("bitflip", "nan", "truncate")

    def __init__(self, *, nth: int = 0, prob: float = 0.0, seed: int = 0,
                 latency_s: float = 0.0,
                 exc: Optional[Type[BaseException]] = FaultInjected,
                 corrupt: Optional[str] = None):
        if nth and prob:
            raise ValueError("pass nth= or prob=, not both")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        if nth < 0 or latency_s < 0:
            raise ValueError("nth and latency_s must be >= 0")
        if corrupt is not None and corrupt not in self.CORRUPT_KINDS:
            raise ValueError(
                f"corrupt kind must be one of {self.CORRUPT_KINDS}, "
                f"got {corrupt!r}")
        self.nth = int(nth)
        self.prob = float(prob)
        self.seed = int(seed)
        self.latency_s = float(latency_s)
        self.exc = exc
        self.corrupt = corrupt
        # armed state (reset on every activation)
        self.hits = 0
        self.triggers = 0
        self._rng = random.Random(self.seed)

    def _rearm(self) -> "FailpointSpec":
        self.hits = 0
        self.triggers = 0
        self._rng = random.Random(self.seed)
        return self

    def _fire(self, name: str) -> bool:
        """Count the hit, decide whether this one triggers, and record
        the trace event when it does (shared by the raising and the
        corrupting paths)."""
        self.hits += 1
        if self.nth:
            fire = self.hits == self.nth
        elif self.prob:
            fire = self._rng.random() < self.prob
        else:
            fire = True  # bare spec: every hit
        if not fire:
            return False
        self.triggers += 1
        # an injected fault that the retry layer then heals leaves TWO
        # trace records: this one and the reliability.retry that healed
        # it (local import: obs is optional machinery, failpoints is not)
        from tpu_sgd_torch.obs.spans import event as obs_event

        obs_event("reliability.failpoint", site=name, hit=self.hits,
                  latency_s=self.latency_s, corrupt=self.corrupt,
                  raises=(self.exc.__name__
                          if self.exc is not None and self.corrupt is None
                          else None))
        if self.latency_s:
            time.sleep(self.latency_s)
        return True

    def _on_hit(self, name: str) -> None:
        if not self._fire(name):
            return
        if self.corrupt is not None:
            return  # no payload at this site: nothing to damage
        if self.exc is not None:
            raise self.exc(
                f"failpoint {name!r} triggered (hit {self.hits})"
            )

    def _on_hit_payload(self, name: str, payload):
        """The :func:`corruptpoint` spelling of :meth:`_on_hit`: a
        corrupting spec returns a deterministically mutated COPY of the
        payload; a raising spec behaves exactly as at a plain site (so
        ``fail_nth``/``fail_prob`` still work at payload hops)."""
        if not self._fire(name):
            return payload
        if self.corrupt is not None:
            return _corrupt_payload(payload, self.corrupt, self._rng)
        if self.exc is not None:
            raise self.exc(
                f"failpoint {name!r} triggered (hit {self.hits})"
            )
        return payload


def fail_nth(k: int, exc: Type[BaseException] = FaultInjected,
             latency_ms: float = 0.0) -> FailpointSpec:
    """Trigger on exactly the k-th hit (1-based), once."""
    return FailpointSpec(nth=k, exc=exc, latency_s=latency_ms / 1e3)


def fail_prob(p: float, seed: int = 0,
              exc: Type[BaseException] = FaultInjected,
              latency_ms: float = 0.0) -> FailpointSpec:
    """Trigger each hit with probability ``p`` from a ``seed``-keyed
    private stream — bit-identical replay for a fixed seed."""
    return FailpointSpec(prob=p, seed=seed, exc=exc,
                         latency_s=latency_ms / 1e3)


def inject_latency(ms: float, *, nth: int = 0, prob: float = 0.0,
                   seed: int = 0) -> FailpointSpec:
    """Delay without raising — straggler simulation.  By default every
    hit sleeps; ``nth``/``prob`` restrict which hits do."""
    return FailpointSpec(nth=nth, prob=prob, seed=seed,
                         latency_s=ms / 1e3, exc=None)


def corrupt_nth(k: int, kind: str = "bitflip") -> FailpointSpec:
    """Corrupt the payload of exactly the k-th hit (1-based) at a
    :func:`corruptpoint` site, once — the one-shot corruption whose
    consume-site detection and retry-heal is the behavior under test."""
    return FailpointSpec(nth=k, corrupt=kind, exc=None)


def corrupt_prob(p: float, seed: int = 0,
                 kind: str = "bitflip") -> FailpointSpec:
    """Corrupt each payload with probability ``p`` from a ``seed``-keyed
    private stream — the ``fail_prob`` of silent data damage, replayed
    bit-identically from its seed."""
    return FailpointSpec(prob=p, seed=seed, corrupt=kind, exc=None)


def _corrupt_payload(payload, kind: str, rng: random.Random):
    """Deterministically damage ONE array leaf of ``payload`` — a
    (possibly nested) tuple/list structure whose array leaves are host
    numpy — and rebuild the structure around a mutated COPY.

    The original arrays are never written: the producer's retry
    re-sends them intact, which is what makes a healed corruption run
    bitwise the fault-free one.  Non-array leaves (tags, scalars, None)
    pass through; a payload with no non-empty array leaf returns
    unchanged (an empty segment has no bytes to damage)."""
    import numpy as np

    leaves: list = []

    def _walk(obj, path):
        if isinstance(obj, np.ndarray):
            if obj.nbytes > 0:
                leaves.append(path)
        elif isinstance(obj, (tuple, list)):
            for j, item in enumerate(obj):
                _walk(item, path + (j,))

    def _rebuild(obj, path, new_leaf):
        if not path:
            return new_leaf
        items = [(_rebuild(item, path[1:], new_leaf)
                  if j == path[0] else item)
                 for j, item in enumerate(obj)]
        if isinstance(obj, tuple):
            # NamedTuples rebuild from field args
            return (type(obj)(*items) if hasattr(obj, "_fields")
                    else tuple(items))
        return items

    _walk(payload, ())
    if not leaves:
        return payload
    path = leaves[rng.randrange(len(leaves))]
    leaf = payload
    for j in path:
        leaf = leaf[j]
    arr = np.array(leaf, copy=True)
    if kind == "truncate" and arr.ndim >= 1 and arr.shape[0] > 0:
        keep = rng.randrange(arr.shape[0])  # drop a seeded tail
        arr = np.ascontiguousarray(arr[:keep])
    elif kind == "nan" and np.issubdtype(arr.dtype, np.floating):
        flat = arr.reshape(-1)
        flat[rng.randrange(flat.size)] = rng.choice(
            (np.nan, np.inf, -np.inf))
    else:  # bitflip (and the nan-on-int fallback)
        buf = bytearray(arr.tobytes())
        bit = rng.randrange(len(buf) * 8)
        buf[bit // 8] ^= 1 << (bit % 8)
        arr = np.frombuffer(bytes(buf), dtype=arr.dtype).reshape(arr.shape)
    return _rebuild(payload, path, arr)


# -- hook-site registry -----------------------------------------------------

#: every compiled-in hook site of this package and the module that holds
#: its ``failpoint("<name>")`` call: the JAX package's sites, each in the
#: port's module of the same name
HOOK_SITES = {
    "io.resident_callback": "tpu_sgd_torch/optimize/resident_driver.py",
    "io.prefetch.produce": "tpu_sgd_torch/io/prefetch.py",
    "io.superstep": "tpu_sgd_torch/io/chunking.py",
    "io.sparse_wire": "tpu_sgd_torch/io/sparse_wire.py",
    "io.device_put": "tpu_sgd_torch/optimize/streamed.py",
    "optimize.streamed.step": "tpu_sgd_torch/optimize/streamed.py",
    "checkpoint.save": "tpu_sgd_torch/utils/checkpoint.py",
    "checkpoint.load": "tpu_sgd_torch/utils/checkpoint.py",
    "serve.registry.reload": "tpu_sgd_torch/serve/registry.py",
    "serve.batcher.enqueue": "tpu_sgd_torch/serve/batcher.py",
    "serve.admit": "tpu_sgd_torch/serve/batcher.py",
    "replica.pull": "tpu_sgd_torch/replica/store.py",
    "replica.push": "tpu_sgd_torch/replica/store.py",
    # fires on every routed store access of the HA client, before the
    # store is touched: armed with exc=StoreFailed it is the primary kill
    # switch (the client reports the failure and the supervisor
    # promotes); with the default FaultInjected a transient network blip
    # that the worker's own RetryPolicy heals
    "replica.store_fail": "tpu_sgd_torch/replica/ha.py",
    # fires at the top of the promotion (inside the replica.failover
    # span): latency here stretches a failover
    "replica.failover": "tpu_sgd_torch/replica/ha.py",
}

#: the corrupting sites and the module that holds each one's
#: ``corruptpoint("<name>", ...)`` call: each passes a host-bytes frame
#: between its ``seal()`` and its consume-site ``verify()``
#: (``io/integrity.py``), so an armed corrupting spec models silent wire
#: damage exactly where the checksum must catch it
CORRUPT_SITES = {
    "io.chunk": "tpu_sgd_torch/optimize/streamed.py",
    "io.sparse_chunk": "tpu_sgd_torch/optimize/streamed_sparse.py",
    "io.segment": "tpu_sgd_torch/io/sparse_wire.py",
    "replica.push.wire": "tpu_sgd_torch/replica/store.py",
    "replica.log.record": "tpu_sgd_torch/replica/ha.py",
}

# -- arming registry --------------------------------------------------------

#: fast-path gate: ``failpoint()`` reads this ONE module global and
#: returns when falsy — the entire disabled-mode cost.
_ENABLED = False

_SPECS: Dict[str, FailpointSpec] = {}
_HITS: Dict[str, int] = {}  # per-site hit counters while enabled
_LOCK = threading.RLock()   # specs fire from prefetch/serve worker threads


def failpoint(name: str) -> None:
    """Hook-site entry: no-op unless a spec for ``name`` is armed.

    This function sits on hot paths (per-iteration, per-request); keep
    the disabled branch to the single global check."""
    if not _ENABLED:
        return
    _hit(name)


def corruptpoint(name: str, payload):
    """Payload-carrying hook-site entry: returns ``payload`` untouched
    unless a spec for ``name`` is armed — a corrupting spec returns a
    deterministically damaged COPY (the originals stay intact for the
    healing retry), a raising spec raises like a plain failpoint.

    Sits between a frame's :func:`~tpu_sgd_torch.io.integrity.seal` and
    its consume-site :func:`~tpu_sgd_torch.io.integrity.verify`; same
    disabled-mode cost contract as :func:`failpoint`."""
    if not _ENABLED:
        return payload
    return _hit_payload(name, payload)


def _hit(name: str) -> None:
    with _LOCK:
        _HITS[name] = _HITS.get(name, 0) + 1
        spec = _SPECS.get(name)
        if spec is not None:
            spec._on_hit(name)


def _hit_payload(name: str, payload):
    with _LOCK:
        _HITS[name] = _HITS.get(name, 0) + 1
        spec = _SPECS.get(name)
        if spec is None:
            return payload
        return spec._on_hit_payload(name, payload)


def configure(name: str, spec: FailpointSpec) -> None:
    """Arm ``spec`` at site ``name`` and enable the registry."""
    global _ENABLED
    with _LOCK:
        _SPECS[name] = spec._rearm()
        _ENABLED = True


def deactivate() -> None:
    """Disarm every site and restore the zero-overhead disabled mode."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _SPECS.clear()
        _HITS.clear()


def is_enabled() -> bool:
    return _ENABLED


def hits(name: str) -> int:
    """Hits recorded at ``name`` while the registry was enabled (counts
    every hit at an armed REGISTRY, even for sites with no spec, which
    proves a hook site was actually reached)."""
    with _LOCK:
        return _HITS.get(name, 0)


def triggers(name: str) -> int:
    """Times the spec at ``name`` actually fired."""
    with _LOCK:
        spec = _SPECS.get(name)
        return 0 if spec is None else spec.triggers


@contextlib.contextmanager
def inject_faults(config: Dict[str, FailpointSpec]):
    """Arm a set of sites for the duration of a ``with`` block::

        with inject_faults({"checkpoint.save": fail_nth(2)}):
            ...

    Deactivates (and clears counters) on exit, even on error.  Not
    reentrant — nested activations share the one global registry, so the
    inner exit disarms everything; pass one flat dict."""
    with _LOCK:
        for name, spec in config.items():
            configure(name, spec)
    try:
        yield
    finally:
        deactivate()
