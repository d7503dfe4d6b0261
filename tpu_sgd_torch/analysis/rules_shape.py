"""shape-trap and eager-in-loop: the per-shape-program rules — the port
of ``tpu_sgd/analysis/rules_shape.py``.

Both rules police one cost model, read for PyTorch.  An eager torch op
compiles nothing: ``F.pad`` of a ragged tail or ``torch.cat`` of a
coalesced batch on a host path is one kernel at any size, which is why
the JAX rule's "every eager op is a program" has no torch meaning.  What
costs per shape in the port are the programs that SPECIALIZE on shape: a
CUDA graph replays the shapes (and addresses) of its capture, so a new
size needs a new capture; ``torch.compile`` recompiles for a new input
size; a launch plan is cached per shape.  ``ops/bucketed.py`` is the
sanctioned pattern: pad ON THE HOST to a fixed bucket, so a handful of
shapes ever reach the card.

``shape-trap`` flags the data-dependent size where it enters such a
program: an eager ``pad`` / ``cat`` / ``concatenate`` of card values, or
a slice of a card value with a non-constant bound (``out[:n]``), on a
host path, whose result is passed to a compiled callable or read inside
a capture region of the same function (directly, or through the locals
it is assigned to).  The same ops feeding eager code only, and the ops
inside a capture or a traced function (fixed at capture), are silent.

``eager-in-loop`` flags the second spelling of the same bug — a program
*constructed inside a loop body*: ``torch.compile(...)``,
``torch.cuda.CUDAGraph()``, ``torch.cuda.make_graphed_callables(...)``,
a capture ``with torch.cuda.graph(...)`` opened per iteration, or a
kernel library loaded per iteration (``ctypes.CDLL``, ``ops/_build``'s
``load``).  Every iteration then pays a fresh capture or compile with an
empty cache, however stable the shapes.  Memoized factories
(``functools.lru_cache``-wrapped builders, a graph kept on ``self``) are
the sanctioned pattern and do not fire: the rule matches direct
constructor calls only.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Sequence, Set

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import (DefNode, ModuleInfo,
                                             ProjectIndex, expr_reads,
                                             scope_nodes)
from tpu_sgd_torch.analysis.tracing import (CAPTURE_CONTEXTS,
                                            JIT_CONSTRUCTORS,
                                            _is_partial_of_tracer,
                                            _is_tracer_callable, canonical,
                                            dotted_name, enclosing,
                                            last_seg)

#: eager torch ops whose output size is the sum of data-dependent sizes
SHAPE_OPS = {"torch.nn.functional.pad", "torch.cat", "torch.concatenate",
             "torch.concat"}


class ShapeTrapRule(Rule):
    name = "shape-trap"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            for node in ast.walk(mod.tree):
                if isinstance(node, DefNode) \
                        and not project.is_traced(mod, node):
                    yield from self._check_function(mod, mi, project, node)

    def _check_function(self, mod: ModuleFile, mi: ModuleInfo,
                        project: ProjectIndex,
                        fn: ast.AST) -> Iterable[Finding]:
        jitted = project.jitted_value_names(mi, fn)
        dev = project.device_value_names(mi, fn, jitted)
        nodes = scope_nodes(fn)
        # the sinks: argument expressions of compiled calls, and names
        # read inside a capture region, closed backwards over locals
        sink_exprs: List[ast.AST] = []
        sink_names: Set[str] = set()
        for n in nodes:
            if isinstance(n, ast.Call) and not mi.traced.in_capture(n) \
                    and self._specializes(mi, n, jitted):
                sink_exprs.extend(list(n.args)
                                  + [kw.value for kw in n.keywords])
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and mi.traced.in_capture(n):
                sink_names.add(n.id)
        for e in sink_exprs:
            sink_names |= expr_reads(e)
        assigns = [n for n in nodes if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for a in assigns:
                if mi.traced.in_capture(a):
                    continue
                if any(t.id in sink_names for tg in a.targets
                       for t in ast.walk(tg) if isinstance(t, ast.Name)):
                    new = expr_reads(a.value) - sink_names
                    if new:
                        sink_names |= new
                        changed = True
        sinks = list(sink_exprs) + [
            a.value for a in assigns if not mi.traced.in_capture(a)
            and any(t.id in sink_names for tg in a.targets
                    for t in ast.walk(tg) if isinstance(t, ast.Name))]
        seen: Set[ast.AST] = set()
        for root in sinks:
            for n in ast.walk(root):
                if n in seen:
                    continue
                seen.add(n)
                if isinstance(n, ast.Call):
                    name = mi.canonical(n.func)
                    if name in SHAPE_OPS and (
                            expr_reads(n) & dev or any(
                                project._device_expr(mi, fn, a, dev, jitted)
                                for a in n.args)):
                        yield Finding(
                            self.name, mod.relpath, n.lineno, n.col_offset,
                            f"eager `{dotted_name(n.func)}` of a card value "
                            "feeds a program that specializes on shape "
                            "(a compiled callable or a capture): each new "
                            "size is a new capture or compile; pad on the "
                            "host to a bucket first (ops/bucketed.py)")
                elif isinstance(n, ast.Subscript) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id in dev \
                        and isinstance(n.ctx, ast.Load) \
                        and _dynamic_slice(n.slice):
                    yield Finding(
                        self.name, mod.relpath, n.lineno, n.col_offset,
                        f"dynamic slice of card value `{n.value.id}` feeds "
                        "a program that specializes on shape: every bound "
                        "value is a new shape, a new capture or compile; "
                        "pad to a bucket and mask instead")

    @staticmethod
    def _specializes(mi: ModuleInfo, call: ast.Call,
                     jitted: Set[str]) -> bool:
        """A call of a compiled callable (which specializes on its
        inputs' shapes)."""
        func = call.func
        if isinstance(func, ast.Name) and func.id in jitted:
            return True
        name = dotted_name(func)
        if name is not None:
            parts = name.split(".")
            if parts[0] == "self" and len(parts) == 2 \
                    and parts[1] in mi.jitted_attrs:
                return True
        return isinstance(func, ast.Call) and (
            _is_tracer_callable(func.func, mi.prefixes)
            or _is_partial_of_tracer(func, mi.prefixes))


def _dynamic_slice(sl: ast.AST) -> bool:
    """A slice with a non-constant bound (``x[:n]``, ``x[i:j]``)."""
    if isinstance(sl, ast.Tuple):
        return any(_dynamic_slice(e) for e in sl.elts)
    if isinstance(sl, ast.Slice):
        return any(b is not None and not isinstance(b, ast.Constant)
                   and not _negated_constant(b)
                   for b in (sl.lower, sl.upper, sl.step))
    return False  # plain index: row pick, not a shape-carrying slice


def _negated_constant(node: ast.AST) -> bool:
    return (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant))


class EagerInLoopRule(Rule):
    name = "eager-in-loop"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            px = mi.prefixes
            parents = mi.parents
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                canon = canonical(dotted_name(node.func), px)
                is_ctor = (canon in JIT_CONSTRUCTORS
                           or canon in CAPTURE_CONTEXTS
                           and _opens_capture(node, parents)
                           or _is_partial_of_tracer(node, px)
                           or (isinstance(node.func, ast.Call)
                               and _is_partial_of_tracer(node.func, px)))
                if not is_ctor or canon in (
                        "tpu_sgd_torch.ops.cuda_kernels.captured_launches",):
                    continue
                # partial(torch.compile, ...)(f): the OUTER call reports;
                # the inner partial would double-count the same expression
                parent = parents.get(node)
                if (_is_partial_of_tracer(node, px)
                        and isinstance(parent, ast.Call)
                        and parent.func is node):
                    continue
                # the nearest loop must be closer than the nearest def: a
                # constructor inside a def that merely SITS in a loop runs
                # when the def runs, not per loop iteration.
                # Comprehensions count as loops.
                loop_kinds = (ast.For, ast.While, ast.ListComp,
                              ast.SetComp, ast.DictComp, ast.GeneratorExp)
                blocker = enclosing(
                    node, parents,
                    loop_kinds + (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
                if isinstance(blocker, loop_kinds):
                    shown = dotted_name(node.func) or last_seg(canon)
                    yield Finding(
                        self.name, mod.relpath, node.lineno,
                        node.col_offset,
                        f"`{shown}` constructed inside a loop body: every "
                        "iteration pays a fresh capture, compile or "
                        "library load with an empty cache; hoist it out of "
                        "the loop or memoize the factory "
                        "(functools.lru_cache, a graph kept on self)")


def _opens_capture(call: ast.Call, parents) -> bool:
    """``torch.cuda.graph(g)`` used as a ``with`` item."""
    return isinstance(parents.get(call), ast.withitem)
