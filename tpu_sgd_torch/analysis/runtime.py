"""Runtime counterparts of the static lock rules: the lock half of
``tpu_sgd/analysis/runtime.py``.

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

The JAX package's module also counts compiles, dispatches and host
syncs and bounds callback buffers (``assert_compile_count``,
``count_dispatches``, ``count_host_syncs``, ...).  Their torch
counterparts (captures and builds, launches, reads of CUDA tensors)
wait for ROADMAP A12 step 2.

This module is stdlib-only.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional

__all__ = [
    "InstrumentedLock", "LocksetRecorder", "LockOrderError",
    "LockViolation", "RaceReport", "assert_lock_order",
    "instrument_object",
]


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
