"""cond-discipline: condition variables, shutdown paths, and thread
lifecycles follow the discipline the threaded planes already promise
(the port of ``tpu_sgd/analysis/rules_cond.py``).

The lock-discipline rule checks WHERE guarded state is touched; this
rule checks HOW the coordination primitives themselves are used — the
bug class every hand-found concurrency fix in this repo belongs to:

* **wait-without-while** — ``self.<cond>.wait(...)`` whose enclosing
  statement is not inside a ``while`` re-checking the predicate.
  Condition waits wake spuriously and wake STALE (another consumer can
  run between notify and wakeup); an ``if`` around a wait is a latent
  lost-wakeup.  ``wait_for`` re-checks internally and is exempt.
* **notify-outside-lock** — ``notify`` / ``notify_all`` on a declared
  condition without holding it: raises ``RuntimeError`` at runtime on
  the paths tests exercise, silently lost on the ones they don't.  The
  caller-holds-lock helper proof from ``rules_lock`` applies here too.
* **untimed-wait-on-stop-path** — a ``wait()`` with NO timeout
  reachable (class-local self-calls) from a ``stop()`` / ``close()`` /
  ``shutdown()`` / ``halt()``: the shutdown-hang class — if the
  notifying thread is already gone, shutdown blocks forever.  Exempt
  when the wait's ``while`` predicate reads a ``self`` attribute the
  stop-ish method itself assigns (the stop-flag pattern: the flag flips
  before the notify, so the wait cannot outlive the stop).
* **unjoined-daemon-thread** — a class starts ``Thread(daemon=True)``
  but contains no ``.join(`` anywhere: its work can be killed mid-write
  at interpreter exit, and nothing ever observes its death.  Daemon is
  a backstop, not a lifecycle.
* **unobserved-future-exception** — some code path can
  ``set_exception`` on a Future, but NO linted module ever calls
  ``.result(`` / ``.exception(``: the error is recorded and dropped,
  the silent-failure twin of a bare ``except``.

Declared-lock identity (which ``self.<X>`` is a condition worth
checking) comes from the same ``GRAFTLINT_LOCKS`` declarations the
lock rules use, resolved through base classes, so a subclass waiting on
its base's condition is checked too.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.rules_lock import LockDisciplineRule
from tpu_sgd_torch.analysis.rules_order import _Classes
from tpu_sgd_torch.analysis.tracing import build_parents, dotted_name

#: method names that are shutdown entry points
STOPISH = ("stop", "close", "shutdown", "halt")

DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _self_attr_call(node: ast.Call) -> Optional[tuple]:
    """``self.<X>.<meth>(...)`` -> ``(X, meth)``."""
    f = node.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute)
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "self"):
        return f.value.attr, f.attr
    return None


class CondDisciplineRule(Rule):
    name = "cond-discipline"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project = options.get("project")
        if project is None:
            from tpu_sgd_torch.analysis.dataflow import ProjectIndex
            project = ProjectIndex(modules)
        classes = _Classes(modules, project)
        lock_rule = LockDisciplineRule()

        for mod in modules:
            if mod.tree is None:
                continue
            for cls in ast.walk(mod.tree):
                if isinstance(cls, ast.ClassDef):
                    yield from self._check_class(mod, cls, classes,
                                                 lock_rule)
        yield from self._future_exceptions(modules)

    # -- per-class checks ----------------------------------------------------
    def _check_class(self, mod: ModuleFile, cls: ast.ClassDef,
                     classes: _Classes,
                     lock_rule: LockDisciplineRule) -> Iterable[Finding]:
        parents = build_parents(cls)
        is_lock = {}  # attr -> bool: a declared lock of this class line?

        def declared(attr: str) -> bool:
            if attr not in is_lock:
                is_lock[attr] = classes.lock_node(cls.name, attr) \
                    is not None
            return is_lock[attr]

        # the caller-holds-lock proof needs a guards-shaped dict; only
        # the lock NAMES matter to _locked_helpers
        all_locks: Set[str] = set()
        seen: Set[str] = set()
        stack = [cls.name]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            all_locks |= classes.declared.get(c, set())
            stack.extend(classes.bases.get(c, ()))
        guards = {lk: (lk, "rw") for lk in all_locks}
        locked_helpers = lock_rule._locked_helpers(cls, parents, guards) \
            if all_locks else set()

        methods = {m.name: m for m in cls.body if isinstance(m, DefNode)}
        # class-local self-call graph for the stop-path reachability
        calls_of: Dict[str, Set[str]] = {}
        for name, m in methods.items():
            out = set()
            for n in ast.walk(m):
                if isinstance(n, ast.Call):
                    dn = dotted_name(n.func)
                    if dn and dn.startswith("self.") \
                            and dn.count(".") == 1:
                        out.add(dn.split(".")[1])
            calls_of[name] = out

        stop_reached: Dict[str, str] = {}  # method -> stop entry name
        for entry in STOPISH:
            if entry not in methods:
                continue
            stack2 = [entry]
            while stack2:
                m = stack2.pop()
                if m in stop_reached or m not in methods:
                    continue
                stop_reached[m] = stop_reached.get(m, entry)
                stack2.extend(calls_of.get(m, ()))

        #: self attributes any stop-ish method assigns (the stop flags)
        stop_writes: Set[str] = set()
        for entry in STOPISH:
            m = methods.get(entry)
            if m is None:
                continue
            for n in ast.walk(m):
                if (isinstance(n, ast.Attribute)
                        and isinstance(n.ctx, (ast.Store, ast.Del))
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"):
                    stop_writes.add(n.attr)

        for meth_name, meth in methods.items():
            for n in ast.walk(meth):
                if not isinstance(n, ast.Call):
                    continue
                sc = _self_attr_call(n)
                if sc is None:
                    continue
                attr, target = sc
                if not declared(attr):
                    continue
                if target == "wait":
                    yield from self._check_wait(
                        mod, cls, meth_name, n, attr, parents,
                        stop_reached, stop_writes)
                elif target in ("notify", "notify_all"):
                    if lock_rule._under_lock(n, parents, attr):
                        continue
                    if (meth_name, attr) in locked_helpers:
                        continue
                    method = lock_rule._enclosing_method(n, parents, cls)
                    if method is not None and method.name == "__init__":
                        continue  # pre-publication
                    yield Finding(
                        self.name, mod.relpath, n.lineno, n.col_offset,
                        f"self.{attr}.{target}() outside `with "
                        f"self.{attr}:` — notify without the owning "
                        "lock raises RuntimeError (or is silently lost "
                        "through a non-checking wrapper); move it under "
                        "the lock")

        yield from self._daemon_threads(mod, cls)

    def _check_wait(self, mod, cls, meth_name, call, attr, parents,
                    stop_reached, stop_writes) -> Iterable[Finding]:
        enclosing_while = None
        cur = parents.get(call)
        while cur is not None and not isinstance(cur, DefNode):
            if isinstance(cur, ast.While) and enclosing_while is None:
                enclosing_while = cur
            cur = parents.get(cur)
        if enclosing_while is None:
            yield Finding(
                self.name, mod.relpath, call.lineno, call.col_offset,
                f"self.{attr}.wait() not re-checked in a `while` "
                "predicate loop — condition waits wake spuriously and "
                "stale; wrap in `while <predicate>:` (or use "
                "wait_for)")
            return  # the stop-path check presumes the while shape
        untimed = not call.args and not call.keywords
        if untimed and meth_name in stop_reached:
            predicate_reads = {
                n.attr for n in ast.walk(enclosing_while.test)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"}
            if predicate_reads & stop_writes:
                return  # stop-flag pattern: stop() flips the predicate
            yield Finding(
                self.name, mod.relpath, call.lineno, call.col_offset,
                f"untimed self.{attr}.wait() is reachable from "
                f"{cls.name}.{stop_reached[meth_name]}() and its "
                "`while` predicate reads no attribute that method "
                "assigns — a shutdown can hang forever if the "
                "notifying thread is already gone; add a timeout or a "
                "stop flag the predicate checks")

    def _daemon_threads(self, mod: ModuleFile,
                        cls: ast.ClassDef) -> Iterable[Finding]:
        has_join = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
            for n in ast.walk(cls))
        if has_join:
            return
        for n in ast.walk(cls):
            if not isinstance(n, ast.Call):
                continue
            dn = dotted_name(n.func)
            if dn is None or dn.split(".")[-1] != "Thread":
                continue
            daemon = any(
                kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in n.keywords)
            if daemon:
                yield Finding(
                    self.name, mod.relpath, n.lineno, n.col_offset,
                    f"class {cls.name} starts a Thread(daemon=True) but "
                    "never joins any thread — daemon is a backstop, not "
                    "a lifecycle; give it a stop path that joins (or "
                    "suppress with the reason it may be abandoned)")

    # -- cross-module future check -------------------------------------------
    def _future_exceptions(self, modules: Sequence[ModuleFile]
                           ) -> Iterable[Finding]:
        setters: List[tuple] = []
        observed = False
        for mod in modules:
            if mod.tree is None:
                continue
            for n in ast.walk(mod.tree):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)):
                    continue
                if n.func.attr == "set_exception":
                    setters.append((mod.relpath, n.lineno, n.col_offset))
                elif n.func.attr in ("result", "exception"):
                    observed = True
        if observed:
            return
        for rel, line, col in setters:
            yield Finding(
                self.name, rel, line, col,
                "a Future's exception can be set here but no linted "
                "module ever calls .result()/.exception() — the error "
                "is recorded and dropped; observe the future somewhere "
                "or fail loudly instead")
