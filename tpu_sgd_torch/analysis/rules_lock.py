"""lock-discipline: declared shared state must be touched under its lock
(the port of ``tpu_sgd/analysis/rules_lock.py``; AST-only, so the rule
is the JAX package's, finding for finding).

The threaded modules (``io/prefetch.py``, ``serve/batcher.py``,
``serve/registry.py``, ``utils/events.py``, ``reliability/health.py``,
the replica and tenant planes) each carry a module-level declaration::

    GRAFTLINT_LOCKS = {
        "MicroBatcher": {
            "_pending": "_cond",       # reads AND writes need the lock
            "_model":   "_lock:w",     # writes need it; bare reads are
        },                             # sanctioned (atomic-ref pattern)
    }

and this rule enforces it lexically: every ``self.<attr>`` access of a
guarded attribute inside the class's methods must sit within a
``with self.<lock>:`` block.  ``__init__`` is exempt — construction
happens before the object is published to another thread.  The ``:w``
mode suffix encodes the atomic-reference-swap idiom (registry hot
reload): readers may race on the reference, but every mutation must
serialize.

Since graftlint v2 the check is one call level deep: a PRIVATE helper
(leading-underscore method) whose guarded accesses are unlocked passes
when every ``self._helper(...)`` call site inside the class holds the
declared lock — the call graph proves the caller-holds-lock contract
that previously needed a suppression (``ModelRegistry._swap``).  A
public method gets no such proof (external callers are invisible), and
ONE unlocked call site voids the proof for every access in the helper.

Honest limitations, by design:

* the caller-holds-lock proof is class-local and one level deep — a
  helper's helper still needs a suppression; the runtime side
  (``tpu_sgd_torch.analysis.runtime.instrument_object``) validates the same
  declarations dynamically in ``tests/test_torch_*.py``, covering
  what lexical analysis must take on faith;
* a closure defined inside a ``with`` block but executed later passes
  — none exist in the declared modules, and the runtime validator
  would catch one.

A declared class or lock attribute that does not exist in the module is
itself a finding: declarations must not drift from the code they guard.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Sequence, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule, parse_guard
from tpu_sgd_torch.analysis.tracing import build_parents, dotted_name

DECLARATION = "GRAFTLINT_LOCKS"

#: methods that run before the object can be shared across threads
CONSTRUCTION_EXEMPT = {"__init__", "__new__", "__init_subclass__"}


#: extract_lock_map result when the module carries no declaration at all
#: (distinct from a malformed one, which is a finding)
NO_DECLARATION = object()


def extract_lock_map(tree: ast.Module):
    """The module's ``GRAFTLINT_LOCKS`` dict literal; ``NO_DECLARATION``
    when the module has none; ``None`` when present but malformed."""
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == DECLARATION
                   for t in targets):
            continue
        try:
            lit = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return None  # caller reports the malformed declaration
        if not isinstance(lit, dict):
            return None
        return lit
    return NO_DECLARATION


class LockDisciplineRule(Rule):
    name = "lock-discipline"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        for mod in modules:
            if mod.tree is None:
                continue
            lock_map = extract_lock_map(mod.tree)
            if lock_map is NO_DECLARATION:
                continue
            if lock_map is None:
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{DECLARATION} must be a literal "
                    "{class: {attr: 'lock[:w]'}} dict")
                continue
            yield from self._check_module(mod, lock_map)

    def _check_module(self, mod: ModuleFile,
                      lock_map: Dict[str, Dict[str, str]]
                      ) -> Iterable[Finding]:
        classes = {n.name: n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.ClassDef)}
        for cls_name, guards in lock_map.items():
            cls = classes.get(cls_name)
            if cls is None:
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{DECLARATION} declares locks for {cls_name!r} but "
                    "no such class exists in this module")
                continue
            try:
                parsed = {attr: parse_guard(spec)
                          for attr, spec in guards.items()}
            except ValueError as e:
                yield Finding(self.name, mod.relpath, cls.lineno, 0, str(e))
                continue
            yield from self._check_class(mod, cls, parsed)

    def _check_class(self, mod: ModuleFile, cls: ast.ClassDef,
                     guards: Dict[str, Tuple[str, str]]
                     ) -> Iterable[Finding]:
        parents = build_parents(cls)
        locked_helpers = self._locked_helpers(cls, parents, guards)
        # declared locks must exist: self.<lock> must be assigned
        # somewhere in the class (almost always __init__)
        assigned = {
            n.attr for n in ast.walk(cls)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}
        for attr, (lock, _mode) in guards.items():
            if lock not in assigned:
                yield Finding(
                    self.name, mod.relpath, cls.lineno, 0,
                    f"declared lock {lock!r} guarding {attr!r} is never "
                    f"assigned on self in class {cls.name}")
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guards):
                continue
            lock, mode = guards[node.attr]
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            # an AugAssign target parses as Store but reads too; either
            # way it is at least a write, so `write` stays correct
            if mode == "w" and not write:
                continue
            method = self._enclosing_method(node, parents, cls)
            if method is not None and method.name in CONSTRUCTION_EXEMPT:
                continue
            if self._under_lock(node, parents, lock):
                continue
            if method is not None \
                    and (method.name, lock) in locked_helpers:
                # call-graph proof: every in-class call site of this
                # private helper holds the lock, so the access runs
                # under it even though no `with` is lexically visible
                continue
            verb = "write of" if write else "read of"
            yield Finding(
                self.name, mod.relpath, node.lineno, node.col_offset,
                f"{verb} guarded attribute self.{node.attr} outside "
                f"`with self.{lock}:` (declared in {DECLARATION} for "
                f"{cls.name})")

    def _locked_helpers(self, cls: ast.ClassDef, parents,
                        guards: Dict[str, Tuple[str, str]]
                        ) -> set:
        """``(method_name, lock)`` pairs proven caller-locked: the
        method is private (external callers are out of static reach for
        a public one), it has at least one ``self.<method>(...)`` call
        site in this class, and EVERY such site sits under ``with
        self.<lock>:``.  One unlocked site voids the proof — the helper
        really can run without the lock then."""
        sites: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(cls):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr.startswith("_")):
                sites.setdefault(node.func.attr, []).append(node)
        locks = {lk for lk, _ in guards.values()}
        out = set()
        for name, calls in sites.items():
            # a call site inside the helper itself (recursion) proves
            # nothing — it is only reached through the outer sites
            outer = [c for c in calls
                     if getattr(self._enclosing_method(c, parents, cls),
                                "name", None) != name]
            if not outer:
                continue
            for lock in locks:
                if all(self._under_lock(c, parents, lock) for c in outer):
                    out.add((name, lock))
        return out

    @staticmethod
    def _enclosing_method(node: ast.AST, parents, cls: ast.ClassDef
                          ) -> Optional[ast.FunctionDef]:
        """The OUTERMOST function between ``node`` and the class body —
        i.e. the method, even when the access sits in a nested closure."""
        method = None
        cur = parents.get(node)
        while cur is not None and cur is not cls:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                method = cur
            cur = parents.get(cur)
        return method

    @staticmethod
    def _under_lock(node: ast.AST, parents, lock: str) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    expr = item.context_expr
                    if dotted_name(expr) == f"self.{lock}":
                        return True
                    # `with self._lock.acquire_timeout(...)` style
                    if (isinstance(expr, ast.Call)
                            and dotted_name(expr.func) is not None
                            and dotted_name(expr.func).startswith(
                                f"self.{lock}.")):
                        return True
            cur = parents.get(cur)
        return False
