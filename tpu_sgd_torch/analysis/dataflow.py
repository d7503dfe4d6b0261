"""Project-wide dataflow: call graph, captured-ness, card values, sync
summaries and root decomposition — the port of
``tpu_sgd/analysis/dataflow.py``.

This module is the shared machinery of the port's rules, built once per
lint run over EVERY linted module:

* **call graph** — :meth:`ProjectIndex.resolve_call` maps a call
  expression to candidate defs: same-module by name, cross-module
  through explicit ``from x import y`` / ``import x as m; m.f`` edges,
  and ``self.f`` to same-module methods.  Unresolvable calls resolve to
  nothing — rules err toward silence on edges they cannot prove.
  Resolution is the JAX package's, edge for edge, so both packages'
  lock rules find the same lock graph.
* **captured-ness, project-wide** — the module-local fixpoint of
  ``tracing.TracedIndex`` (capture regions, ``torch.compile`` and the
  other tracers) generalized: a def called from a capture region or
  passed to a tracer in *another* module is traced too.
* **compiled values** — which names/attributes hold a program: a
  ``torch.compile`` result, a ``CUDAGraph``, a loaded kernel library
  (``ctypes.CDLL``, ``ops/_build.load``), factories that *return* one
  (closed transitively).
* **card values** — per function, which local names hold tensors on the
  card.  Seeds: the result of a compiled callable, ``x.cuda()``,
  ``x.to(<device>)``, a ``torch`` factory given ``device=``, the
  hand-written kernels' wrappers (``ops/cuda_kernels.py``), CUDA events
  and streams, and every name assigned inside a capture region (a
  captured graph's static tensors, read back after each replay).
  Closure: what a torch op, a tensor method, arithmetic, indexing or any
  call computes from a card value is a card value (through aliases and
  tuple unpacking), except host metadata (``.shape``, ``.numel()``,
  ...), builtins and numpy, whose results live on the host.
* **sync summaries** — per def, which parameter positions flow into a
  device→host read (``.item()``, ``.cpu()``, ``float()``, ...), closed
  over the call graph, so ``host-sync`` can flag a syncing helper at its
  loop-borne call site.
* **root decomposition** — :meth:`ProjectIndex.local_roots` rewrites a
  function-local name into the parameter / ``self.<attr>`` /
  free-variable reads it was derived from, which is how ``memo-key``
  decides whether a build-path read is covered by a cache key.

Everything here is AST-only; no checked module is ever imported.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import ModuleFile
from tpu_sgd_torch.analysis.tracing import (FuncNode, JIT_CONSTRUCTORS,
                                            KERNEL_WRAPPERS, KERNELS_MODULE,
                                            TracedIndex,
                                            _is_partial_of_tracer,
                                            _is_tracer_callable, canonical,
                                            dotted_name, enclosing,
                                            last_seg, module_prefixes)

DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)

#: tensor methods that read a card tensor back to the host, or (for a
#: CUDA event or stream) wait for the card: on a hot loop both stall the
#: launch queue the same way
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_BUILTINS = {"float", "int", "bool"}
SYNC_NUMPY = {"asarray", "array", "ascontiguousarray", "copy"}
#: module-level torch calls that wait for the whole card
SYNC_TORCH = {"torch.cuda.synchronize"}

#: attributes of a tensor that live on the host (no read of the card)
HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
              "is_sparse", "requires_grad", "is_leaf", "names", "grad_fn",
              "itemsize", "nbytes"}
#: tensor methods whose result lives on the host without a read of the
#: card's values
HOST_METHODS = {"size", "numel", "dim", "stride", "data_ptr",
                "element_size", "is_contiguous", "get_device", "nelement",
                "storage_offset", "is_pinned", "record", "query",
                "elapsed_time", "wait_event", "wait_stream", "replay",
                "capture_begin", "capture_end", "register_generator_state",
                "reset", "pool", "__len__"}
#: torch dtypes (a ``.to(<dtype>)`` moves nothing to the card)
_DTYPES = {"float32", "float64", "float16", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "bool", "complex64", "complex128",
           "float", "double", "half", "long", "int", "short"}
#: ``torch.cuda`` handles whose ``.synchronize()`` waits for the card
_CARD_HANDLES = {"torch.cuda.Event", "torch.cuda.Stream",
                 "torch.cuda.current_stream", "torch.cuda.default_stream"}

_BUILTIN_NAMES = set(dir(builtins))


def numpy_prefixes(tree: ast.Module) -> Set[str]:
    """Names bound to the numpy module in this file (``np``, ``numpy``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


class ModuleInfo:
    """Per-module slice of the project index."""

    def __init__(self, mod: ModuleFile):
        self.mod = mod
        self.tree = mod.tree
        self.prefixes: Dict[str, str] = module_prefixes(mod.tree) \
            if mod.tree is not None else {}
        self.traced = TracedIndex(mod.tree, close=False,
                                  prefixes=self.prefixes) \
            if mod.tree is not None else None
        self.parents = self.traced.parents if self.traced else {}
        self.defs_by_name: Dict[str, List[ast.AST]] = \
            dict(self.traced._defs_by_name) if self.traced else {}
        #: ``from x.y import f [as g]`` -> g: ("x.y", "f")
        self.imports_from: Dict[str, Tuple[str, str]] = {}
        #: ``import x.y as m`` -> m: "x.y"
        self.import_mods: Dict[str, str] = {}
        #: module-scope (and class-scope) names bound to programs
        self.jitted_names: Set[str] = set()
        #: ``self.<attr> = torch.compile(...)`` attribute names
        self.jitted_attrs: Set[str] = set()
        #: names assigned at MODULE level (constants, helpers, imports)
        self.module_names: Set[str] = set()
        self.np_prefixes: Set[str] = set()
        if mod.tree is None:
            return
        self.np_prefixes = numpy_prefixes(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_mods[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                for a in node.names:
                    if node.module:
                        self.imports_from[a.asname or a.name] = \
                            (node.module, a.name)
        for node in mod.tree.body:
            for t in _stmt_targets(node):
                self.module_names.add(t)
            if isinstance(node, DefNode + (ast.ClassDef,)):
                self.module_names.add(node.name)
        self.module_names.update(self.import_mods)
        self.module_names.update(self.imports_from)
        self._collect_jitted()

    def canonical(self, func: ast.AST) -> Optional[str]:
        return canonical(dotted_name(func), self.prefixes)

    def _collect_jitted(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, DefNode):
                if any(_is_tracer_callable(d, self.prefixes)
                       for d in node.decorator_list):
                    self.jitted_names.add(node.name)
            elif isinstance(node, ast.Assign):
                if not _is_jit_construction(node.value, self.prefixes):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.jitted_names.add(t.id)
                    elif (isinstance(t, ast.Attribute)
                          and isinstance(t.value, ast.Name)
                          and t.value.id == "self"):
                        self.jitted_attrs.add(t.attr)


def _stmt_targets(node: ast.AST) -> Iterable[str]:
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                yield t.id
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        yield e.id
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                       ast.Name):
        yield node.target.id


def _is_jit_construction(expr: ast.AST,
                         prefixes: Dict[str, str]) -> bool:
    """``torch.compile(...)``, ``torch.cuda.CUDAGraph()``,
    ``ctypes.CDLL(...)``, ``_build.load(...)``, ``partial(torch.compile,
    ...)(f)``: an expression that builds a program."""
    if not isinstance(expr, ast.Call):
        return False
    if canonical(dotted_name(expr.func), prefixes) in JIT_CONSTRUCTORS:
        return True
    if _is_tracer_callable(expr.func, prefixes):
        return True
    return (isinstance(expr.func, ast.Call)
            and _is_partial_of_tracer(expr.func, prefixes))


def _assigned_names(target: ast.AST) -> List[ast.Name]:
    if isinstance(target, ast.Name):
        return [target]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[ast.Name] = []
        for e in target.elts:
            out.extend(_assigned_names(e.value if isinstance(
                e, ast.Starred) else e))
        return out
    return []


def _pairs(assign: ast.Assign):
    """``(target, value)`` pairs of an assignment, element by element
    where a tuple is assigned to a tuple of the same length (``w, f =
    w_new, f_new``)."""
    v = assign.value
    for t in assign.targets:
        if isinstance(t, (ast.Tuple, ast.List)) \
                and isinstance(v, (ast.Tuple, ast.List)) \
                and len(t.elts) == len(v.elts) \
                and not any(isinstance(e, ast.Starred) for e in t.elts):
            yield from zip(t.elts, v.elts)
        else:
            yield t, v


def scope_nodes(fn: ast.AST, *, include_nested: bool = False
                ) -> List[ast.AST]:
    """Nodes in ``fn``'s own scope; nested defs/lambdas excluded unless
    asked for (comprehensions are transparent — they run inline)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if not include_nested and isinstance(n, FuncNode):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def expr_reads(expr: ast.AST) -> Set[str]:
    """Plain-name and ``self.<attr>`` loads in ``expr``, normalized
    (``self.gradient`` -> ``gradient``).  A nested lambda contributes
    only its FREE names, and comprehension loop variables are bound, not
    read."""
    out: Set[str] = set()
    bound: Set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Lambda):
            out.update(free_names(n))
            return
        if isinstance(n, ast.Name):
            if isinstance(n.ctx, ast.Load):
                out.add(n.id)
            else:  # comprehension targets parse as Store
                bound.add(n.id)
        elif (isinstance(n, ast.Attribute)
              and isinstance(n.value, ast.Name) and n.value.id == "self"
              and isinstance(n.ctx, ast.Load)):
            out.add(n.attr)
            return
        for c in ast.iter_child_nodes(n):
            visit(c)

    visit(expr)
    out -= bound
    out.discard("self")
    return out


def card_reads(expr: ast.AST) -> Set[str]:
    """:func:`expr_reads` less the names read only for host metadata
    (``w.device``, ``X.shape[0]``, ``t.numel()``): what reading ``expr``
    could fetch from the card."""
    def strip(n: ast.AST) -> ast.AST:
        if isinstance(n, ast.Attribute) and n.attr in HOST_ATTRS:
            return ast.Constant(None)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in HOST_METHODS:
            return ast.Constant(None)
        for field, value in ast.iter_fields(n):
            if isinstance(value, ast.AST):
                setattr(n, field, strip(value))
            elif isinstance(value, list):
                value[:] = [strip(v) if isinstance(v, ast.AST) else v
                            for v in value]
        return n

    import copy
    return expr_reads(strip(copy.deepcopy(expr)))


def func_params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if isinstance(fn, DefNode) and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def free_names(fn: ast.AST) -> Set[str]:
    """Names a nested def reads from its enclosing scope: loads minus
    its own params, locals, and nested-def names."""
    bound: Set[str] = set(p.arg for p in
                          fn.args.posonlyargs + fn.args.args
                          + fn.args.kwonlyargs)
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name):
            if isinstance(n.ctx, ast.Load):
                loads.add(n.id)
            else:
                bound.add(n.id)
        elif isinstance(n, DefNode) and n is not fn:
            bound.add(n.name)
    return loads - bound


class ProjectIndex:
    """All linted modules, cross-linked.  Build once per lint run."""

    def __init__(self, modules: Sequence[ModuleFile]):
        self.infos: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        #: per-def caches (the index lives for one lint run, so a node's
        #: id is stable): own-scope nodes, program names, card values
        self._scopes: Dict[int, List[ast.AST]] = {}
        self._jitted: Dict[int, Set[str]] = {}
        self._devices: Dict[int, Set[str]] = {}
        for m in modules:
            mi = ModuleInfo(m)
            self.infos[m.relpath] = mi
            self.by_dotted[m.dotted] = mi
        self._close_traced()
        self._returns_jitted: Set[ast.AST] = set()
        self._close_returns_jitted()
        self._syncing: Dict[ast.AST, Set[int]] = {}
        self._close_syncing()

    def info(self, mod: ModuleFile) -> ModuleInfo:
        return self.infos[mod.relpath]

    def scope(self, fn: ast.AST) -> List[ast.AST]:
        """:func:`scope_nodes` of ``fn``, computed once a run."""
        out = self._scopes.get(id(fn))
        if out is None:
            out = self._scopes[id(fn)] = scope_nodes(fn)
        return out

    # -- call resolution -----------------------------------------------------
    def resolve_call(self, mi: ModuleInfo,
                     call: ast.Call) -> List[Tuple[ModuleInfo, ast.AST]]:
        """Candidate (module, def) targets of ``call``; empty when the
        callee cannot be proven."""
        return self.resolve_name(mi, call.func)

    def resolve_name(self, mi: ModuleInfo,
                     func: ast.AST) -> List[Tuple[ModuleInfo, ast.AST]]:
        if isinstance(func, ast.Name):
            name = func.id
            if name in mi.defs_by_name:
                return [(mi, d) for d in mi.defs_by_name[name]]
            if name in mi.imports_from:
                dotted, orig = mi.imports_from[name]
                tgt = self.by_dotted.get(dotted)
                if tgt is not None and orig in tgt.defs_by_name:
                    return [(tgt, d) for d in tgt.defs_by_name[orig]]
            return []
        name = dotted_name(func)
        if name is None:
            return []
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2:
            return [(mi, d) for d in mi.defs_by_name.get(parts[1], ())]
        # m.f / m.sub.f through an ``import m [as alias]``
        if parts[0] in mi.import_mods and len(parts) >= 2:
            dotted = ".".join([mi.import_mods[parts[0]]] + parts[1:-1])
            tgt = self.by_dotted.get(dotted)
            if tgt is not None:
                return [(tgt, d)
                        for d in tgt.defs_by_name.get(parts[-1], ())]
        # mod.f through ``from pkg import mod``
        if parts[0] in mi.imports_from and len(parts) == 2:
            pkg, sub = mi.imports_from[parts[0]]
            tgt = self.by_dotted.get(f"{pkg}.{sub}")
            if tgt is not None:
                return [(tgt, d)
                        for d in tgt.defs_by_name.get(parts[1], ())]
        return []

    # -- captured-ness -------------------------------------------------------
    def _close_traced(self) -> None:
        """Project-wide closure over the per-module seeds: nested defs,
        same-module called-by-name defs, PLUS defs reached through
        import-resolved cross-module calls from a traced def or a
        capture region."""
        for mi in self.infos.values():
            if mi.traced is None:
                continue
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Call) \
                        and mi.traced.in_capture(node):
                    for tmi, d in self.resolve_call(mi, node):
                        if tmi is not mi:
                            tmi.traced._traced.add(d)
        changed = True
        while changed:
            changed = False
            for mi in self.infos.values():
                if mi.traced is None:
                    continue
                for root in list(mi.traced._traced):
                    for node in ast.walk(root):
                        if node is root:
                            continue
                        if isinstance(node, FuncNode):
                            if node not in mi.traced._traced:
                                mi.traced._traced.add(node)
                                changed = True
                        elif isinstance(node, ast.Call):
                            callee = last_seg(dotted_name(node.func))
                            for d in mi.defs_by_name.get(callee, ()):
                                if d not in mi.traced._traced:
                                    mi.traced._traced.add(d)
                                    changed = True
                            for tmi, d in self.resolve_call(mi, node):
                                if tmi is not mi \
                                        and d not in tmi.traced._traced:
                                    tmi.traced._traced.add(d)
                                    changed = True

    def is_traced(self, mod: ModuleFile, node: ast.AST) -> bool:
        mi = self.infos[mod.relpath]
        return mi.traced is not None and mi.traced.is_traced(node)

    def in_capture(self, mod: ModuleFile, node: ast.AST) -> bool:
        mi = self.infos[mod.relpath]
        return mi.traced is not None and mi.traced.in_capture(node)

    def enclosing_function(self, mod: ModuleFile,
                           node: ast.AST) -> Optional[ast.AST]:
        mi = self.infos[mod.relpath]
        return enclosing(node, mi.parents, FuncNode)

    # -- programs / card values ----------------------------------------------
    def _close_returns_jitted(self) -> None:
        """Defs whose RESULT is a program: a direct ``return
        torch.compile(...)``, a returned name locally assigned one, or a
        returned call to another such def — iterated to fixpoint."""
        changed = True
        while changed:
            changed = False
            for mi in self.infos.values():
                if mi.tree is None:
                    continue
                for name, defs in mi.defs_by_name.items():
                    for d in defs:
                        if d in self._returns_jitted:
                            continue
                        if self._def_returns_jitted(mi, d):
                            self._returns_jitted.add(d)
                            changed = True

    def _def_returns_jitted(self, mi: ModuleInfo, fn: ast.AST) -> bool:
        assigns: Dict[str, List[ast.AST]] = {}
        for n in self.scope(fn):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        assigns.setdefault(t.id, []).append(n.value)

        def _jitted_expr(expr: ast.AST, depth: int = 0) -> bool:
            if depth > 4 or expr is None:
                return False
            if _is_jit_construction(expr, mi.prefixes):
                return True
            if isinstance(expr, ast.Call):
                return any(d in self._returns_jitted
                           for _, d in self.resolve_call(mi, expr))
            if isinstance(expr, ast.Name):
                return any(_jitted_expr(v, depth + 1)
                           for v in assigns.get(expr.id, ()))
            return False
        for n in self.scope(fn):
            if isinstance(n, ast.Return) and _jitted_expr(n.value):
                return True
        return False

    def jitted_value_names(self, mi: ModuleInfo,
                           fn: ast.AST) -> Set[str]:
        """Local names in ``fn`` bound to programs."""
        cached = self._jitted.get(id(fn))
        if cached is not None:
            return set(cached)
        out = set(mi.jitted_names)
        changed = True
        while changed:
            changed = False
            for n in self.scope(fn):
                if isinstance(n, DefNode) and any(
                        _is_tracer_callable(d, mi.prefixes)
                        for d in n.decorator_list):
                    if n.name not in out:
                        out.add(n.name)
                        changed = True
                if not isinstance(n, ast.Assign):
                    continue
                val = n.value
                is_jitted = _is_jit_construction(val, mi.prefixes)
                if not is_jitted and isinstance(val, ast.Call):
                    is_jitted = any(
                        d in self._returns_jitted
                        for _, d in self.resolve_call(mi, val))
                if not is_jitted and isinstance(val, ast.Name):
                    is_jitted = val.id in out
                if not is_jitted and isinstance(val, ast.Attribute) \
                        and isinstance(val.value, ast.Name) \
                        and val.value.id == "self":
                    is_jitted = val.attr in mi.jitted_attrs
                if not is_jitted:
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id not in out:
                        out.add(t.id)
                        changed = True
        self._jitted[id(fn)] = set(out)
        return out

    def is_device_call(self, mi: ModuleInfo, fn: ast.AST,
                       call: ast.Call,
                       jitted_locals: Optional[Set[str]] = None) -> bool:
        """Is ``call`` a SEED of a card value: a program's dispatch, a
        move to the card, a factory given ``device=``, a hand-written
        kernel's wrapper, or a CUDA event or stream?"""
        if jitted_locals is None:
            jitted_locals = self.jitted_value_names(mi, fn)
        func = call.func
        if isinstance(func, ast.Name) and func.id in jitted_locals:
            return True
        name = dotted_name(func)
        if name is not None:
            parts = name.split(".")
            if parts[0] == "self" and len(parts) == 2 \
                    and parts[1] in mi.jitted_attrs:
                return True
        canon = mi.canonical(func)
        if canon is not None:
            if canon in _CARD_HANDLES:
                return True
            head, _, seg = canon.rpartition(".")
            if head == KERNELS_MODULE and seg in KERNEL_WRAPPERS:
                return True
            if canon.startswith("torch.") and _device_kw(call):
                return True
        if isinstance(func, ast.Attribute):
            if func.attr == "cuda":
                return True
            if func.attr == "to" and _moves_to_device(call, mi):
                return True
        # ``torch.compile(f)(x)``: dispatching a freshly-built program
        return isinstance(func, ast.Call) and _is_jit_construction(
            func, mi.prefixes)

    def _device_expr(self, mi: ModuleInfo, fn: ast.AST, expr: ast.AST,
                     dev: Set[str], jitted: Set[str]) -> bool:
        """Does ``expr`` evaluate to a card value?  (Seeds, or any op
        over a card value that does not bring its result to the host.)"""
        if isinstance(expr, ast.Name):
            return expr.id in dev
        if isinstance(expr, ast.Attribute):
            if expr.attr in HOST_ATTRS:
                return False
            return self._device_expr(mi, fn, expr.value, dev, jitted)
        if isinstance(expr, ast.Subscript):
            return self._device_expr(mi, fn, expr.value, dev, jitted)
        if isinstance(expr, ast.BinOp):
            return (self._device_expr(mi, fn, expr.left, dev, jitted)
                    or self._device_expr(mi, fn, expr.right, dev, jitted))
        if isinstance(expr, ast.UnaryOp) \
                and not isinstance(expr.op, ast.Not):
            return self._device_expr(mi, fn, expr.operand, dev, jitted)
        if isinstance(expr, ast.IfExp):
            return (self._device_expr(mi, fn, expr.body, dev, jitted)
                    or self._device_expr(mi, fn, expr.orelse, dev, jitted))
        if not isinstance(expr, ast.Call):
            return False
        if self.is_device_call(mi, fn, expr, jitted):
            return True
        func = expr.func
        if isinstance(func, ast.Name) and func.id in _BUILTIN_NAMES \
                and func.id not in mi.defs_by_name:
            return False
        name = dotted_name(func)
        if name is not None and name.split(".")[0] in mi.np_prefixes:
            return False
        if self.sync_op_kind(mi, expr) is not None:
            return False
        if isinstance(func, ast.Attribute):
            if func.attr in HOST_METHODS:
                return False
            if self._device_expr(mi, fn, func.value, dev, jitted):
                return True
        return any(self._device_expr(mi, fn, a, dev, jitted)
                   for a in list(expr.args)
                   + [kw.value for kw in expr.keywords]
                   if not isinstance(a, ast.Starred))

    def device_value_names(self, mi: ModuleInfo, fn: ast.AST,
                           jitted: Optional[Set[str]] = None) -> Set[str]:
        """Local names in ``fn`` holding card tensors (module docstring:
        seeds, names assigned in a capture region, and their closure over
        torch ops, aliases and tuple unpacking).  ``jitted`` lets a
        caller reuse an already-computed ``jitted_value_names``
        fixpoint."""
        cached = self._devices.get(id(fn))
        if cached is not None:
            return set(cached)
        if jitted is None:
            jitted = self.jitted_value_names(mi, fn)
        out: Set[str] = set()
        assigns = [n for n in self.scope(fn) if isinstance(n, ast.Assign)]
        for n in assigns:
            if mi.traced is not None and mi.traced.in_capture(n):
                # a capture's static tensors: read back after a replay
                for t in n.targets:
                    out.update(e.id for e in _assigned_names(t))
        changed = True
        while changed:
            changed = False
            for n in assigns:
                for t, v in _pairs(n):
                    if not self._device_expr(mi, fn, v, out, jitted):
                        continue
                    for e in _assigned_names(t):
                        if e.id not in out:
                            out.add(e.id)
                            changed = True
        self._devices[id(fn)] = set(out)
        return out

    # -- sync summaries ------------------------------------------------------
    def _is_method_form(self, mi: ModuleInfo,
                        func: ast.AST) -> bool:
        """``x.item()`` / ``ev.synchronize()`` — an attribute sync whose
        RECEIVER is the read value.  False for the module-function
        spellings (``np.copy(x)``, ``torch.cuda.synchronize()``)."""
        if not (isinstance(func, ast.Attribute)
                and func.attr in SYNC_METHODS):
            return False
        base = dotted_name(func.value)
        head = base.split(".")[0] if base else None
        return head not in mi.np_prefixes and head not in mi.prefixes

    def sync_op_kind(self, mi: ModuleInfo,
                     call: ast.Call) -> Optional[str]:
        """Is ``call`` a device→host read or a wait for the card?
        Returns a short label, or None."""
        func = call.func
        if self._is_method_form(mi, func):
            return f".{func.attr}()"
        name = dotted_name(func)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 1 and parts[0] in SYNC_BUILTINS and call.args:
            return f"{parts[0]}()"
        if len(parts) == 2 and parts[0] in mi.np_prefixes \
                and parts[1] in SYNC_NUMPY:
            return f"{name}()"
        if canonical(name, mi.prefixes) in SYNC_TORCH:
            return f"{name}()"
        return None

    def _sync_arg_expr(self, mi: ModuleInfo,
                       call: ast.Call) -> Optional[ast.AST]:
        """The expression a sync op reads: the receiver of ``.item()``
        style calls, the first argument otherwise; None for a wait on the
        whole card (``torch.cuda.synchronize()``)."""
        if self._is_method_form(mi, call.func):
            return call.func.value
        if canonical(dotted_name(call.func), mi.prefixes) in SYNC_TORCH:
            return None
        return call.args[0] if call.args else None

    def _close_syncing(self) -> None:
        changed = True
        while changed:
            changed = False
            for mi in self.infos.values():
                if mi.tree is None:
                    continue
                for defs in mi.defs_by_name.values():
                    for d in defs:
                        new = self._def_syncing_params(mi, d)
                        if new != self._syncing.get(d, set()):
                            self._syncing[d] = new
                            changed = True

    def _def_syncing_params(self, mi: ModuleInfo,
                            fn: ast.AST) -> Set[int]:
        params = func_params(fn)
        if not params:
            return set()
        idx = {p: i for i, p in enumerate(params)}
        out: Set[int] = set(self._syncing.get(fn, set()))
        for n in self.scope(fn):
            if not isinstance(n, ast.Call):
                continue
            if self.sync_op_kind(mi, n) is not None:
                arg = self._sync_arg_expr(mi, n)
                if arg is not None:
                    for name in expr_reads(arg):
                        if name in idx:
                            out.add(idx[name])
                continue
            for _, d in self.resolve_call(mi, n):
                for j in self._syncing.get(d, set()):
                    if j < len(n.args):
                        for name in expr_reads(n.args[j]):
                            if name in idx:
                                out.add(idx[name])
        return out

    def syncing_params(self, d: ast.AST) -> Set[int]:
        return self._syncing.get(d, set())

    # -- root decomposition --------------------------------------------------
    def local_roots(self, mi: ModuleInfo, fn: ast.AST, name: str,
                    stop: Set[str], _seen: Optional[Set[str]] = None
                    ) -> Set[str]:
        """Decompose local ``name`` into the reads it derives from,
        stopping at ``stop`` names (the key fields), parameters,
        ``self.<attr>``s, module-level names, and free variables.  A
        local function decomposes into its free variables."""
        if _seen is None:
            _seen = set()
        if name in stop or name in _seen:
            return {name} if name in stop else set()
        _seen.add(name)
        sources: List[Set[str]] = []
        for n in scope_nodes(fn):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in n.targets):
                sources.append(expr_reads(n.value))
            elif isinstance(n, ast.Assign) and any(
                    isinstance(t, (ast.Tuple, ast.List)) and any(
                        isinstance(e, ast.Name) and e.id == name
                        for e in t.elts)
                    for t in n.targets):
                sources.append(expr_reads(n.value))
        for n in scope_nodes(fn, include_nested=True):
            if isinstance(n, DefNode) and n.name == name:
                sources.append(free_names(n))
        if not sources:
            return {name}  # a parameter / free var: irreducible
        roots: Set[str] = set()
        for reads in sources:
            for r in reads:
                roots |= self.local_roots(mi, fn, r, stop, _seen)
        return roots


def _device_kw(call: ast.Call) -> bool:
    """A ``device=`` keyword naming anything but the host."""
    for kw in call.keywords:
        if kw.arg == "device":
            return not _is_host_device(kw.value)
    return False


def _is_host_device(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value is None or (isinstance(expr.value, str)
                                      and expr.value.startswith("cpu"))
    return False


def _moves_to_device(call: ast.Call, mi: ModuleInfo) -> bool:
    """``x.to(dev)`` / ``x.to(device=...)``: a move to a device (not a
    dtype cast, not the host)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return not _is_host_device(kw.value)
    if not call.args:
        return False
    a = call.args[0]
    if _is_host_device(a):
        return False
    canon = canonical(dotted_name(a), mi.prefixes)
    if canon is not None and canon.startswith("torch.") \
            and last_seg(canon) in _DTYPES:
        return False
    return not (isinstance(a, ast.Attribute) and a.attr == "dtype")
