"""carry-stability: a capture must not bake in a Python number the host
loop changes — the port of ``tpu_sgd/analysis/rules_carry.py``.

The JAX rule pins a ``lax`` loop's carry to dtype-stable device arrays: a
Python scalar in the carry traces weak-typed and the program drifts or
recompiles.  The same class in a CUDA graph is worse, because it is
silent: a capture runs its host code ONCE, so every Python number the
captured code reads — a step size, an iteration counter, a ``k`` valid
corrections — is baked into the graph's kernels as an argument.  When
the host loop then changes that number and replays, the card still runs
the captured value.  The fix is the JAX rule's: carry it as a card
tensor (``torch.full((), x, device=dev)`` updated in place, as the port's
``_RunState`` carries its iteration counter), read by the captured
kernels on every replay.

The rule checks each capture region (``with torch.cuda.graph(g):``, the
port's ``with ck.captured_launches():``, or ``capture_begin`` ..
``capture_end``) that sits in a host ``for``/``while`` body, and flags a
read in it of a **host number the loop changes**: the loop's counter
(``for i in range(n)``, the index of ``enumerate``), or a name the loop
assigns from a Python-number
expression (a constant, ``float()`` / ``int()`` / ``bool()``, or
arithmetic over such names, ``i += 1`` included).  A call in the region
that passes such a name is flagged at the name.  Names the rule cannot
prove to be host numbers (tensors, attributes, call results) are
silent, as in the JAX rule.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Sequence, Set

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import ModuleInfo, ProjectIndex
from tpu_sgd_torch.analysis.tracing import FuncNode

SCALAR_COERCIONS = {"float", "int", "bool"}
LOOP_KINDS = (ast.For, ast.While)


def _is_py_scalar(node: ast.AST, numbers: Set[str]) -> Optional[str]:
    """A Python-number expression: constant, negated constant, a
    float()/int()/bool() coercion, or arithmetic over host numbers.
    Returns a display string or None."""
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, bool, complex)):
        return repr(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and _is_py_scalar(node.operand, numbers):
        return "-" + _is_py_scalar(node.operand, numbers)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in SCALAR_COERCIONS:
        return f"{node.func.id}(...)"
    if isinstance(node, ast.Name) and node.id in numbers:
        return node.id
    if isinstance(node, ast.BinOp) and (
            _is_py_scalar(node.left, numbers)
            and _is_py_scalar(node.right, numbers)):
        return "arithmetic"
    return None


def _counter_targets(loop: ast.For) -> Set[str]:
    """The host numbers a ``for`` binds: its target over ``range(...)``,
    or the index of ``enumerate(...)``."""
    it, target = loop.iter, loop.target
    if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)):
        return set()
    if it.func.id == "range" and isinstance(target, ast.Name):
        return {target.id}
    if it.func.id == "enumerate" and isinstance(target, ast.Tuple) \
            and target.elts and isinstance(target.elts[0], ast.Name):
        return {target.elts[0].id}
    return set()


class CarryStabilityRule(Rule):
    name = "carry-stability"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            numbers = {}
            for n in ast.walk(mod.tree):
                if not (isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Load)
                        and mi.traced.in_capture(n)):
                    continue
                for loop in self._enclosing_loops(mi, n):
                    if loop not in numbers:
                        numbers[loop] = self._loop_numbers(loop)
                    if n.id in numbers[loop]:
                        yield self._finding(mod, n)
                        break

    def _loop_numbers(self, loop: ast.AST) -> Set[str]:
        """Names of host numbers the loop changes each trip."""
        names: Set[str] = set()
        if isinstance(loop, ast.For):
            names.update(_counter_targets(loop))
        body = [n for st in loop.body for n in self._own(st)]
        changed = True
        while changed:
            changed = False
            for n in body:
                if isinstance(n, ast.AugAssign) \
                        and isinstance(n.target, ast.Name) \
                        and _is_py_scalar(n.value, names | {n.target.id}):
                    new = {n.target.id}
                elif isinstance(n, ast.Assign) and _is_py_scalar(
                        n.value, names | {t.id for t in n.targets
                                          if isinstance(t, ast.Name)}):
                    new = {t.id for t in n.targets
                           if isinstance(t, ast.Name)}
                else:
                    continue
                if not new <= names:
                    names |= new
                    changed = True
        return names

    @staticmethod
    def _own(stmt: ast.AST):
        """``stmt``'s nodes, nested defs excluded (they run when
        called)."""
        stack = [stmt]
        while stack:
            n = stack.pop()
            if isinstance(n, FuncNode):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _finding(self, mod: ModuleFile, n: ast.Name) -> Finding:
        return Finding(
            self.name, mod.relpath, n.lineno, n.col_offset,
            f"capture reads `{n.id}`, a Python number this host loop "
            "changes between replays: it is baked into the graph at "
            "capture, so every replay runs the captured value (silently "
            "stale, the WEAK-typed carry of the JAX rule); carry it as a "
            "card tensor updated in place, which re-enters each replay "
            "from the card (see _RunState in "
            "optimize/gradient_descent.py)")

    @staticmethod
    def _enclosing_loops(mi: ModuleInfo, node: ast.AST):
        """The host loops around ``node`` whose BODY holds it, nearest
        first, up to its function."""
        child, cur = node, mi.parents.get(node)
        while cur is not None and not isinstance(cur, FuncNode):
            if isinstance(cur, LOOP_KINDS) and child in cur.body:
                yield cur
            child, cur = cur, mi.parents.get(cur)
