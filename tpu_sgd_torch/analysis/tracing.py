"""Captured-context resolution: which code runs once at capture and is
replayed on the card?  The port of ``tpu_sgd/analysis/tracing.py``.

The JAX package asks "does JAX trace this body?".  In PyTorch an eager op
runs when it is reached; what plays the tracer's part is a **capture**:
the body of ``with torch.cuda.graph(g):`` (and of the port's
``with ck.captured_launches():`` bracket around it), or the statements
between ``g.capture_begin()`` and ``g.capture_end()``, runs its host code
ONCE while the kernels it launches are recorded, and every
``g.replay()`` re-runs only those kernels.  ``torch.compile`` (and the
``torch.func`` transforms, ``torch.jit.trace`` / ``script``,
``torch.cuda.make_graphed_callables``) trace the functions they are
given the same way.  Per function and per node we decide "does this run
under a capture or a tracer?" from three module-local signals, closed
transitively:

1. **decorators** — ``@torch.compile``, ``@torch.compile(mode=...)``,
   ``@partial(torch.compile, ...)`` and friends mark the def traced;
2. **wrap sites** — a function (or lambda) passed by name anywhere in
   the module to one of those tracers is traced;
3. **capture regions** — a node lexically inside a capture region is
   captured, and so is every def called by name from one;
4. **closure** — defs nested inside a traced def, and defs *called*
   from a traced def body, are traced (fixpoint).

Names are matched through the module's imports (:func:`module_prefixes`
maps ``torch``, ``torch.cuda``, ``F``, ``ck``, ``_build`` and names
imported from them to their canonical dotted paths), so ``re.compile``
or ``json.load`` never read as a tracer or a build.  The closure errs on
the side of "traced", so the rules stay quiet rather than crying wolf.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

#: canonical callables that TRACE their function argument(s)
TRACE_ENTRY = {
    "torch.compile", "torch.cuda.make_graphed_callables",
    "torch.func.vmap", "torch.func.grad", "torch.func.grad_and_value",
    "torch.func.jacrev", "torch.func.jacfwd", "torch.func.hessian",
    "torch.func.vjp", "torch.func.jvp", "torch.func.functional_call",
    "torch.vmap", "torch.jit.trace", "torch.jit.script",
    "torch.export.export",
}

#: canonical constructors whose RESULT is a fresh program: a compiled
#: callable, a graph to capture into, or a loaded kernel library —
#: building one per loop iteration is the eager-in-loop trap
JIT_CONSTRUCTORS = {
    "torch.compile", "torch.cuda.make_graphed_callables",
    "torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
    "torch.jit.trace", "torch.jit.script", "ctypes.CDLL",
    "tpu_sgd_torch.ops._build.load", "tpu_sgd_torch.ops._build.build_all",
}

#: canonical context managers that open a capture region
CAPTURE_CONTEXTS = {
    "torch.cuda.graph", "torch.cuda.graphs.graph",
    "tpu_sgd_torch.ops.cuda_kernels.captured_launches",
}

#: the module of the hand-written kernels' wrappers, and the wrappers
#: whose result is a tensor on the card (on a CUDA input)
KERNELS_MODULE = "tpu_sgd_torch.ops.cuda_kernels"
KERNEL_WRAPPERS = {
    "fused_gradient_sums", "fused_window_sums", "fused_window_sums_vpu",
    "csr_margins", "csr_grad_sum",
}

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for a Name/Attribute chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_seg(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing(node: ast.AST, parents: Dict[ast.AST, ast.AST],
              kinds) -> Optional[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None


def module_prefixes(tree: ast.Module) -> Dict[str, str]:
    """Local name -> canonical dotted path, for every name this file
    binds by import: ``import torch`` -> ``torch``; ``import
    torch.nn.functional as F`` -> ``F: torch.nn.functional``; ``from
    torch import cuda`` -> ``cuda: torch.cuda``; ``from tpu_sgd_torch.ops
    import cuda_kernels as ck`` -> ``ck: tpu_sgd_torch.ops.cuda_kernels``.
    Function-level imports count too (the port imports torch lazily)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    out.setdefault(head, head)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def canonical(name: Optional[str], prefixes: Dict[str, str]
              ) -> Optional[str]:
    """``F.pad`` -> ``torch.nn.functional.pad`` through the module's
    imports; None when the head is not an imported name."""
    if not name:
        return None
    head, _, rest = name.partition(".")
    base = prefixes.get(head)
    if base is None:
        return None
    return f"{base}.{rest}" if rest else base


def _is_partial_of_tracer(call: ast.Call, prefixes: Dict[str, str]) -> bool:
    """``partial(torch.compile, ...)`` / ``functools.partial(...)``."""
    if last_seg(dotted_name(call.func)) != "partial" or not call.args:
        return False
    return canonical(dotted_name(call.args[0]), prefixes) in TRACE_ENTRY


def _is_tracer_callable(node: ast.AST, prefixes: Dict[str, str]) -> bool:
    """Is ``node`` (a decorator or a call's func) a tracer?  The bare
    name (``torch.compile``), the configured factory call
    (``torch.compile(mode=...)`` as a decorator) and the partial form."""
    if canonical(dotted_name(node), prefixes) in TRACE_ENTRY:
        return True
    if isinstance(node, ast.Call):
        if _is_partial_of_tracer(node, prefixes):
            return True
        return canonical(dotted_name(node.func), prefixes) in TRACE_ENTRY
    return False


def is_capture_context(expr: ast.AST, prefixes: Dict[str, str]) -> bool:
    """A with-item expression that opens a capture region."""
    return isinstance(expr, ast.Call) and canonical(
        dotted_name(expr.func), prefixes) in CAPTURE_CONTEXTS


def capture_statements(tree: ast.AST,
                       prefixes: Dict[str, str]) -> Set[ast.AST]:
    """The statements that run under a capture: the bodies of ``with``
    blocks opening one, and the statements between ``<g>.capture_begin(
    ...)`` and ``<g>.capture_end()`` of one statement list."""
    out: Set[ast.AST] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                is_capture_context(it.context_expr, prefixes)
                for it in node.items):
            out.update(node.body)
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            inside = False
            for st in stmts:
                call = st.value if isinstance(st, ast.Expr) else None
                seg = last_seg(dotted_name(call.func)) \
                    if isinstance(call, ast.Call) else ""
                if seg == "capture_begin":
                    inside = True
                elif seg == "capture_end":
                    inside = False
                elif inside:
                    out.add(st)
    return out


class TracedIndex:
    """Per-module index answering :meth:`is_traced` for any node: inside
    a traced def, or inside a capture region.

    ``close=False`` stops after seeding: the project-wide index
    (``tpu_sgd_torch.analysis.dataflow.ProjectIndex``) runs its own
    cross-module closure over the seeds instead of the module-local
    one."""

    def __init__(self, tree: ast.Module,
                 parents: Optional[Dict[ast.AST, ast.AST]] = None,
                 close: bool = True,
                 prefixes: Optional[Dict[str, str]] = None):
        self.tree = tree
        self.parents = parents if parents is not None else \
            build_parents(tree)
        self.prefixes = prefixes if prefixes is not None else \
            module_prefixes(tree)
        self._defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs_by_name.setdefault(node.name, []).append(node)
        self.captured: Set[ast.AST] = capture_statements(tree,
                                                         self.prefixes)
        self._traced: Set[ast.AST] = set()
        self._seed()
        if close:
            self._close()

    # -- seeding -----------------------------------------------------------
    def _seed(self) -> None:
        px = self.prefixes
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_tracer_callable(d, px)
                       for d in node.decorator_list):
                    self._traced.add(node)
            elif isinstance(node, ast.Call):
                fn = node.func
                if self.captured and self.in_capture(node):
                    # a def called by name from a capture region runs
                    # under the capture
                    for d in self._defs_by_name.get(
                            last_seg(dotted_name(fn)), ()):
                        self._traced.add(d)
                traced_wrap = _is_tracer_callable(fn, px) or (
                    isinstance(fn, ast.Call)
                    and _is_partial_of_tracer(fn, px))
                if not traced_wrap:
                    continue
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    if isinstance(arg, ast.Lambda):
                        self._traced.add(arg)
                    elif isinstance(arg, ast.Name):
                        for d in self._defs_by_name.get(arg.id, ()):
                            self._traced.add(d)

    def _close(self) -> None:
        changed = True
        while changed:
            changed = False
            for root in list(self._traced):
                for node in ast.walk(root):
                    if node is root:
                        continue
                    if isinstance(node, FuncNode):
                        if node not in self._traced:
                            self._traced.add(node)
                            changed = True
                    elif isinstance(node, ast.Call):
                        callee = last_seg(dotted_name(node.func))
                        for d in self._defs_by_name.get(callee, ()):
                            if d not in self._traced:
                                self._traced.add(d)
                                changed = True

    # -- queries -----------------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        return enclosing(node, self.parents, FuncNode)

    def in_capture(self, node: ast.AST) -> bool:
        """True when ``node`` sits lexically in a capture region of its
        own function (a def nested in the region runs when called)."""
        if not self.captured:
            return False
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, FuncNode):
            if cur in self.captured:
                return True
            cur = self.parents.get(cur)
        return False

    def is_traced(self, node: ast.AST) -> bool:
        """True when ``node`` sits in a capture region or (lexically)
        inside a traced function."""
        if self.in_capture(node):
            return True
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, FuncNode) and cur in self._traced:
                return True
            cur = self.parents.get(cur)
        return False
