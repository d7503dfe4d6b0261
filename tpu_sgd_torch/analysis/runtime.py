"""Runtime counterparts of the static rules: the port of
``tpu_sgd/analysis/runtime.py``.

:func:`count_dispatches` / :func:`assert_dispatch_count`,
:func:`count_host_syncs` / :func:`assert_no_host_sync` and
:func:`assert_compile_count` count what a region really did on the card,
through the port's own funnels (``obs.counters``' hooks, installed for
the region by ``obs.counters.listen``; no new hook):

* a **dispatch** is one CUDA-graph replay of a captured block
  (``cuda_kernels.add_replayed_launches``) or one launch of a
  hand-written kernel made outside a capture (``cuda_kernels.
  count_launch``); library ops (``torch.matmul``, eager elementwise
  ops, cuSPARSE) pass no funnel and are not counted;
* a **host sync** is one read of a CUDA tensor through ``item``,
  ``tolist``, ``cpu``, ``numpy``, ``__bool__``, ``__float__``,
  ``__int__`` or ``__array__``, or one fetch of the observed drivers' ys
  rows (``gradient_descent._fetch_rows``), counted once however the
  funnels call each other, with its ``(shape, dtype)``; CPU tensors
  never count, nor does a wait that reads nothing
  (``torch.cuda.synchronize``);
* a **compile** is one CUDA-graph capture (``cuda_kernels.
  captured_launches``) or one ``nvcc`` build (``ops/_build.py``): what
  :func:`assert_compile_count` counts when given no ``of=``.

These are the static ``shape-trap``, ``host-sync`` and ``eager-in-loop``
rules' runtime twins: the rules catch the pattern in source, the
checkers the effect on a live run.  Events of every thread count (keep
the region single-actor), and regions nest.
:func:`assert_bounded_callback_buffer` is the JAX package's, as is.

:class:`InstrumentedLock` + :class:`LocksetRecorder` +
:func:`instrument_object` are the lock-discipline rule's runtime twin:
wrap a live object's declared locks, swap in a checking subclass, run a
real concurrent workload, and every guarded-attribute access that
happens WITHOUT the declared lock held by the accessing thread is
recorded (never raised — a checker must not kill the flush thread it is
observing).  The port's tests validate the modules' actual
``GRAFTLINT_LOCKS`` declarations this way, including the helpers the
lexical rule must take on faith (a callee running under its caller's
lock passes here, because the lock really is held).
:func:`assert_lock_order` replays the acquisition pairs a recorder saw
against the committed ``GRAFTLINT_LOCK_ORDER`` — the lock-order rule's
runtime twin.

The module imports nothing but the standard library until a counting
region opens (then ``tpu_sgd_torch.obs.counters``, and torch with it).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Dict, Iterable, List, Optional, Union

__all__ = [
    "CompileCountError", "DispatchCountError", "HostSyncError",
    "CallbackBufferError", "LockOrderError",
    "assert_compile_count", "assert_dispatch_count", "count_dispatches",
    "assert_no_host_sync", "count_host_syncs",
    "assert_bounded_callback_buffer",
    "InstrumentedLock", "LocksetRecorder", "LockViolation",
    "RaceReport", "instrument_object", "assert_lock_order",
]


@contextlib.contextmanager
def _counting(kind: str):
    """A region's count of the hooks' ``kind`` events: yields ``{"n":
    ..., "shapes": [...]}`` (``shapes``: each event's detail, for a
    ``host_sync`` its ``(shape, dtype)``)."""
    from tpu_sgd_torch.obs import counters

    counter = {"n": 0, "shapes": []}
    lock = threading.Lock()

    def listener(k, detail):
        if k != kind:
            return
        with lock:
            counter["n"] += 1
            if detail is not None:
                counter["shapes"].append(detail)

    with counters.listen(listener):
        yield counter


# -- compile counting -------------------------------------------------------

class CompileCountError(AssertionError):
    """The wrapped region compiled a different number of programs than
    the contract allows."""


CacheSource = Union[Callable[[], int], object]


def _cache_size(of: CacheSource) -> int:
    """Current count behind ``of``: an object with ``_cache_size()``, a
    zero-arg int callable (``ops.bucketed.program_cache_size``,
    ``lambda: engine.compile_count``), or an iterable of either
    (summed)."""
    size_fn = getattr(of, "_cache_size", None)
    if callable(size_fn):
        return int(size_fn())
    if callable(of):
        return int(of())
    if isinstance(of, Iterable):
        return sum(_cache_size(o) for o in of)
    raise TypeError(
        f"cannot read a compile-cache size from {of!r}: pass an object "
        "with _cache_size(), a zero-arg callable returning an int, or an "
        "iterable of those")


@contextlib.contextmanager
def assert_compile_count(expected: int, *, of: Optional[CacheSource] = None,
                         at_most: bool = False):
    """Assert the region compiles exactly ``expected`` new programs.

    ``of=None`` counts the card's compiles: CUDA-graph captures and
    ``nvcc`` builds (module docstring).  ``of`` names another measure: a
    zero-arg size callable (``ops.bucketed.program_cache_size``, the
    padded shapes scored), an object with ``_cache_size()``, or an
    iterable mixing them, deltas summed.  ``at_most=True`` relaxes
    equality to an upper bound (warm-loop guards: "no growth" is
    ``expected=0``)."""
    if expected < 0:
        raise ValueError(f"expected must be >= 0, got {expected}")
    if of is None:
        with _counting("compile") as counter:
            yield
        delta = counter["n"]
    else:
        start = _cache_size(of)
        yield
        delta = _cache_size(of) - start
    if (delta > expected) if at_most else (delta != expected):
        bound = "at most" if at_most else "exactly"
        raise CompileCountError(
            f"region compiled {delta} new program(s); the contract "
            f"allows {bound} {expected}.  A growing count on a hot path "
            "usually means a capture per new size or a graph rebuilt in a "
            "loop — pad to a bucket and memoize the capture (see the "
            "shape-trap and eager-in-loop rules, tpu_sgd_torch/analysis)")


# -- dispatch counting ------------------------------------------------------

class DispatchCountError(AssertionError):
    """The wrapped region launched a different number of programs than
    the contract allows."""


def count_dispatches():
    """Count the region's dispatches: yields a dict whose ``"n"`` entry
    is the number of CUDA-graph replays plus hand-written-kernel launches
    made outside a capture so far inside the region (module docstring).
    A captured block counts once per replay however many kernels it
    holds, as the JAX package counts a ``while_loop`` program once."""
    return _counting("dispatch")


@contextlib.contextmanager
def assert_dispatch_count(expected: int, *, at_most: bool = False):
    """Assert the region dispatches exactly ``expected`` programs (see
    :func:`count_dispatches`); ``at_most=True`` relaxes to an upper
    bound."""
    if expected < 0:
        raise ValueError(f"expected must be >= 0, got {expected}")
    with count_dispatches() as counter:
        yield counter
    if (counter["n"] > expected) if at_most else (counter["n"] != expected):
        bound = "at most" if at_most else "exactly"
        raise DispatchCountError(
            f"region launched {counter['n']} program(s); the contract "
            f"allows {bound} {expected}.  Extra launches on a captured "
            "path usually mean a block that ran eagerly instead of "
            "replaying its graph (see optimize/gradient_descent.py)")


# -- host-sync counting -----------------------------------------------------

class HostSyncError(AssertionError):
    """The wrapped region forced more device→host transfers than the
    contract allows."""


def count_host_syncs():
    """Count the region's reads of CUDA tensors: yields a dict whose
    ``"n"`` entry is the number of device-to-host reads so far inside the
    region and whose ``"shapes"`` lists ``(shape, dtype)`` per read (the
    breadcrumb: WHICH fetch fired).  One read counts once, however the
    funnels call each other (``.numpy()`` through ``__array__``)."""
    return _counting("host_sync")


def assert_no_host_sync(fn: Optional[Callable] = None, *, allow: int = 0):
    """Assert a region (or ``fn()``) reads no CUDA tensor back; ``allow``
    admits the documented boundary fetches.  Use as a context manager
    (``with assert_no_host_sync(): ...``) or call-through (``result =
    assert_no_host_sync(lambda: runner.run(i0, k))``)."""
    if fn is not None:
        with _no_host_sync_region(allow):
            return fn()
    return _no_host_sync_region(allow)


@contextlib.contextmanager
def _no_host_sync_region(allow: int):
    with count_host_syncs() as counter:
        yield counter
    if counter["n"] > allow:
        shown = ", ".join(
            f"{s}:{d}" for s, d in counter["shapes"][:8])
        raise HostSyncError(
            f"region forced {counter['n']} device->host transfer(s); "
            f"the contract allows {allow}.  Transfers seen (first 8): "
            f"[{shown}].  A sync on a hot path usually means an "
            ".item()/float()/.cpu() on a card tensor — fetch at the "
            "cadence boundary instead (see the host-sync rule, "
            "tpu_sgd_torch/analysis)")


# -- callback buffer bounds -------------------------------------------------

class CallbackBufferError(AssertionError):
    """A callback-carried host buffer grew beyond its declared bound."""


@contextlib.contextmanager
def assert_bounded_callback_buffer(buf, *, max_len: Optional[int] = None):
    """Assert a host buffer a callback feeds stays bounded across the
    region — the runtime twin of ``callback-discipline``'s bounded-buffer
    check.  ``buf`` is the buffer itself or a zero-arg callable returning
    it (anything sized: list, deque, ndarray ring).  ``max_len`` defaults
    to the ENTRY length — the no-growth contract a preallocated ring
    satisfies and an append-per-firing history violates."""
    get = buf if callable(buf) else (lambda: buf)
    start = len(get())
    bound = start if max_len is None else max_len
    yield
    end = len(get())
    if end > bound:
        raise CallbackBufferError(
            f"callback buffer grew to {end} element(s); the bound is "
            f"{bound} (entry length {start}).  An unbounded host buffer "
            "fed once per block accumulates for the whole run — hand "
            "windows to a bookkeeper with a documented bound instead")


# -- lock instrumentation ---------------------------------------------------

class LockViolation:
    """One guarded-attribute access without its declared lock held."""

    __slots__ = ("cls_name", "attr", "op", "thread", "function", "line")

    def __init__(self, cls_name: str, attr: str, op: str, thread: str,
                 function: str, line: int):
        self.cls_name = cls_name
        self.attr = attr
        self.op = op            # "read" | "write"
        self.thread = thread
        self.function = function  # code object name of the accessor
        self.line = line

    def __repr__(self) -> str:
        return (f"LockViolation({self.cls_name}.{self.attr} {self.op} in "
                f"{self.function}:{self.line} on thread {self.thread})")


class RaceReport:
    """One Eraser-style runtime race: a written attribute whose observed
    accesses from >= 2 threads share NO common lock.  Carries one
    representative site per thread (writes preferred) — the two stacks
    a human needs to see the schedule."""

    __slots__ = ("cls_name", "attr", "threads", "sites")

    def __init__(self, cls_name: str, attr: str, threads: set,
                 sites: List[tuple]):
        self.cls_name = cls_name
        self.attr = attr
        self.threads = threads
        self.sites = sites  # [(thread, op, function, line), ...]

    def __repr__(self) -> str:
        shown = "; ".join(f"{t}: {op} in {fn}:{ln}"
                          for t, op, fn, ln in self.sites)
        return (f"RaceReport({self.cls_name}.{self.attr} written from "
                f"{len(self.threads)} threads with empty common lockset"
                f" — {shown})")


class _AttrState:
    """Per-(object, attribute) Eraser state: the candidate lockset is
    the intersection of locksets held across every observed access."""

    __slots__ = ("cls_name", "attr", "candidate", "threads", "written",
                 "site_by_thread")

    def __init__(self, cls_name: str, attr: str):
        self.cls_name = cls_name
        self.attr = attr
        self.candidate = None  # None = no access observed yet
        self.threads: set = set()
        self.written = False
        #: thread name -> (thread, op, function, line); a write replaces
        #: a read site so the report shows the racing mutation
        self.site_by_thread: Dict[str, tuple] = {}


class LocksetRecorder:
    """Thread-aware ledger: which instrumented locks does each thread
    hold right now, which guarded accesses happened without the declared
    lock, which attribute locksets intersect to empty across threads
    (Eraser), and which acquisition ORDER pairs were observed."""

    def __init__(self):
        self._held = threading.local()
        self._mu = threading.Lock()
        self.violations: List[LockViolation] = []
        self.checked_accesses = 0
        #: id(lock) -> qualified name ("Class.lockattr")
        self._by_id: Dict[int, str] = {}
        #: (outer name, inner name) -> first-seen acquisition site
        #: (thread, function, line)
        self.order_pairs: Dict[tuple, tuple] = {}
        #: (id(obj), attr) -> Eraser state
        self._eraser: Dict[tuple, _AttrState] = {}

    # -- lockset -----------------------------------------------------------
    def _counts(self) -> Dict[int, int]:
        counts = getattr(self._held, "counts", None)
        if counts is None:
            counts = self._held.counts = {}
        return counts

    def acquired(self, lock: "InstrumentedLock") -> None:
        c = self._counts()
        prev = [i for i, n in c.items() if n > 0 and i != id(lock)]
        c[id(lock)] = c.get(id(lock), 0) + 1
        first = c[id(lock)] == 1
        with self._mu:
            self._by_id[id(lock)] = lock.name
            if not (first and prev):
                return  # reentrant re-acquire adds no ordering fact
            try:
                frame = sys._getframe(2)
                site = (threading.current_thread().name,
                        frame.f_code.co_name, frame.f_lineno)
            except ValueError:  # shallow stack (direct test calls)
                site = (threading.current_thread().name, "?", 0)
            for i in prev:
                outer = self._by_id.get(i)
                if outer is not None and outer != lock.name:
                    self.order_pairs.setdefault((outer, lock.name), site)

    def released(self, lock: "InstrumentedLock") -> None:
        c = self._counts()
        n = c.get(id(lock), 0) - 1
        if n <= 0:
            c.pop(id(lock), None)
        else:
            c[id(lock)] = n

    def holds(self, lock: "InstrumentedLock") -> bool:
        return self._counts().get(id(lock), 0) > 0

    def held_names(self) -> set:
        """Qualified names of every instrumented lock the CURRENT thread
        holds right now — the Eraser lockset."""
        c = self._counts()
        held = [i for i, n in c.items() if n > 0]
        with self._mu:
            return {self._by_id[i] for i in held if i in self._by_id}

    # -- violations --------------------------------------------------------
    def count_checked(self) -> None:
        # under _mu: += from concurrent checked threads loses updates,
        # a sloppiness a lock-discipline validator cannot afford itself
        with self._mu:
            self.checked_accesses += 1

    def record(self, violation: LockViolation) -> None:
        with self._mu:
            self.violations.append(violation)

    def violating_functions(self) -> set:
        with self._mu:
            return {v.function for v in self.violations}

    # -- Eraser ------------------------------------------------------------
    def eraser_access(self, obj_id: int, cls_name: str, attr: str,
                      op: str, held: set, site: tuple) -> None:
        """Fold one guarded access into the per-attribute candidate
        lockset: ``C(attr) ∩= locks held at this access``.  Called by
        the ``instrument_object`` hooks; ``site`` is ``(thread,
        function, line)``."""
        thread = site[0]
        with self._mu:
            st = self._eraser.get((obj_id, attr))
            if st is None:
                st = self._eraser[(obj_id, attr)] = _AttrState(
                    cls_name, attr)
            st.threads.add(thread)
            if op != "read":
                st.written = True
            if st.candidate is None:
                st.candidate = set(held)
            else:
                st.candidate &= held
            old = st.site_by_thread.get(thread)
            if old is None or (op != "read" and old[1] == "read"):
                st.site_by_thread[thread] = (thread, op, site[1], site[2])

    def races(self) -> List[RaceReport]:
        """Every WRITTEN attribute observed from >= 2 threads whose
        candidate lockset intersected to empty — the Eraser verdict.
        Sites: one per thread (writes preferred), so a report names both
        sides of the racing schedule."""
        out = []
        with self._mu:
            for st in self._eraser.values():
                if (st.written and len(st.threads) >= 2
                        and not st.candidate):
                    sites = sorted(st.site_by_thread.values())
                    writes = [s for s in sites if s[1] != "read"]
                    others = [s for s in sites if s[1] == "read"]
                    out.append(RaceReport(
                        st.cls_name, st.attr, set(st.threads),
                        (writes + others)[:4]))
        return sorted(out, key=lambda r: (r.cls_name, r.attr))


class InstrumentedLock:
    """Wrap a Lock / RLock / Condition so acquisitions register in a
    :class:`LocksetRecorder`.  Proxies everything else (``notify_all``,
    ``wait_for``, ...) to the inner primitive; ``wait`` is intercepted
    because a Condition.wait RELEASES the lock while blocked — the
    recorder must not count the waiter as a holder."""

    def __init__(self, inner, *, name: str = "?",
                 recorder: Optional[LocksetRecorder] = None):
        self._inner = inner
        self.name = name
        self.recorder = recorder or LocksetRecorder()

    def held_by_current_thread(self) -> bool:
        return self.recorder.holds(self)

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got is not False:  # Lock.acquire() returns True; timeouts False
            self.recorder.acquired(self)
        return got

    def release(self):
        self._inner.release()
        self.recorder.released(self)

    def __enter__(self):
        self._inner.__enter__()
        self.recorder.acquired(self)
        return self

    def __exit__(self, *exc):
        out = self._inner.__exit__(*exc)
        self.recorder.released(self)
        return out

    def wait(self, timeout=None):
        self.recorder.released(self)
        try:
            return self._inner.wait(timeout)
        finally:
            self.recorder.acquired(self)

    def wait_for(self, predicate, timeout=None):
        self.recorder.released(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self.recorder.acquired(self)

    def __getattr__(self, item):
        return getattr(self._inner, item)


def instrument_object(obj, lock_map: Dict[str, str],
                      recorder: Optional[LocksetRecorder] = None,
                      *, owner: Optional[str] = None) -> LocksetRecorder:
    """Arm ``obj`` with the runtime lock-discipline + Eraser check.

    ``lock_map`` is one class's entry of a module ``GRAFTLINT_LOCKS``
    declaration: ``{attr: "lock_attr[:w]"}``.  Each named lock attribute
    on ``obj`` is wrapped in an :class:`InstrumentedLock` (idempotent)
    named ``<owner>.<lock_attr>`` — ``owner`` defaults to the object's
    class name and should be passed explicitly when instrumenting a
    SUBCLASS with its base's declaration (``ShardedParameterStore`` under
    ``GRAFTLINT_LOCKS["ParameterStore"]``), so acquisition-order pairs
    match the committed ``GRAFTLINT_LOCK_ORDER`` node names.  ``obj``'s
    class is swapped for a dynamically-built checking subclass whose
    ``__getattribute__`` / ``__setattr__``:

    * verify the DECLARED lock is held by the accessing thread
      (recorded as :class:`LockViolation`, never raised — a checker
      must not kill the flush thread it is observing), and
    * fold the access into the Eraser candidate lockset
      (``C(attr) ∩= locks held``): :meth:`LocksetRecorder.races` then
      reports every written attribute whose accesses from >= 2 threads
      share no lock at all — the race class the declaration check
      misses when the declaration itself names the wrong lock.

    ``:w`` attrs participate with writes only (the atomic-reference
    idiom sanctions lock-free reads).  Accesses from within this
    module's own machinery (the lock wrappers) are not counted.
    """
    from tpu_sgd_torch.analysis.core import parse_guard

    recorder = recorder or LocksetRecorder()
    base = type(obj)
    base_name = base.__name__
    if base_name.endswith("LockChecked"):  # re-instrumenting
        base_name = base_name[: -len("LockChecked")]
    owner = owner or base_name
    guards = {attr: parse_guard(spec) for attr, spec in lock_map.items()}
    for lock_name in {ln for ln, _ in guards.values()}:
        inner = getattr(obj, lock_name)
        if not isinstance(inner, InstrumentedLock):
            object.__setattr__(
                obj, lock_name,
                InstrumentedLock(inner, name=f"{owner}.{lock_name}",
                                 recorder=recorder))
        else:
            inner.recorder = recorder
            inner.name = f"{owner}.{lock_name}"

    def _check(self, attr: str, op: str) -> None:
        lock_name, mode = guards[attr]
        if mode == "w" and op == "read":
            return
        lock = object.__getattribute__(self, lock_name)
        recorder.count_checked()
        held = isinstance(lock, InstrumentedLock) and \
            lock.held_by_current_thread()
        frame = sys._getframe(2)
        site = (threading.current_thread().name,
                frame.f_code.co_name, frame.f_lineno)
        recorder.eraser_access(id(self), owner, attr, op,
                               recorder.held_names(), site)
        if held:
            return
        recorder.record(LockViolation(
            base.__name__, attr, op, site[0], site[1], site[2]))

    class _Checked(base):  # type: ignore[misc, valid-type]
        def __getattribute__(self, name):
            if name in guards:
                _check(self, name, "read")
            return object.__getattribute__(self, name)

        def __setattr__(self, name, value):
            if name in guards:
                _check(self, name, "write")
            object.__setattr__(self, name, value)

        def __delattr__(self, name):
            if name in guards:
                _check(self, name, "write")
            object.__delattr__(self, name)

    _Checked.__name__ = base.__name__ + "LockChecked"
    _Checked.__qualname__ = _Checked.__name__
    obj.__class__ = _Checked
    return recorder


# -- lock-order replay ------------------------------------------------------

class LockOrderError(AssertionError):
    """A recorded acquisition sequence inverted the committed
    ``GRAFTLINT_LOCK_ORDER``."""


def assert_lock_order(recorder: LocksetRecorder, order=None) -> None:
    """Replay the acquisition pairs a :class:`LocksetRecorder` observed
    against the committed ``GRAFTLINT_LOCK_ORDER`` — the runtime twin of
    the static lock-order graph (``rules_order.py``), covering the
    acquisitions static analysis cannot resolve (callback hooks like the
    HA ``set_replication(log.append)`` replication path).

    An observed pair ``(A held, B acquired)`` whose INVERSE is reachable
    in the transitively-closed declared order (B before A) raises
    :class:`LockOrderError` naming the observed site and the declared
    chain.  Pairs the declaration does not relate pass — the static rule
    is the side that forces new nestings INTO the declaration.
    """
    if order is None:
        from tpu_sgd_torch.analysis import GRAFTLINT_LOCK_ORDER as order
    adj: Dict[str, set] = {}
    for a, b in order:
        adj.setdefault(a, set()).add(b)
    reach_memo: Dict[str, set] = {}

    def reach(a: str) -> set:
        if a in reach_memo:
            return reach_memo[a]
        out: set = set()
        stack = list(adj.get(a, ()))
        while stack:
            v = stack.pop()
            if v in out:
                continue
            out.add(v)
            stack.extend(adj.get(v, ()))
        reach_memo[a] = out
        return out

    with recorder._mu:
        observed = dict(recorder.order_pairs)
    for (outer, inner), site in sorted(observed.items()):
        if outer in reach(inner):
            thread, fn, line = site
            raise LockOrderError(
                f"observed acquisition {outer} -> {inner} (thread "
                f"{thread}, {fn}:{line}) INVERTS the committed "
                f"GRAFTLINT_LOCK_ORDER, which orders {inner} before "
                f"{outer}.  Either this code path is a deadlock with "
                "the declared-direction path, or the order declaration "
                "in tpu_sgd_torch/analysis/__init__.py is stale — fix the "
                "code or re-run the static lock-order rule and update "
                "the declaration")
