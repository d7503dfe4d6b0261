"""lock-order: the project's lock-acquisition nesting is ONE graph (the
port of ``tpu_sgd/analysis/rules_order.py``).

Every concurrency fix so far ordered two locks by hand — the
``WindowStore`` fix pinned ``_lock -> _dispatch_cv`` in a docstring,
``RuntimeCounters.inc`` forwards OUTSIDE its lock with a comment
explaining the inversion it avoids — and nothing stopped the next
module from nesting the same pair the other way.  This rule promotes
those per-module conventions into a checked project-wide order:

* **nodes** are declared locks, named ``Class.lockattr`` — every lock
  that appears as a guard in some module's ``GRAFTLINT_LOCKS``
  declaration (``rules_lock.py`` grammar).  Undeclared locks are
  invisible here by design: declare first, then order.
* **edges** are observed nestings.  A ``with self.<A>:`` region whose
  BODY (the context expression itself evaluates before acquisition and
  does not count) acquires ``<B>`` — directly, or transitively through
  any call the :class:`~tpu_sgd_torch.analysis.dataflow.ProjectIndex`
  call graph plus a light receiver-type inference can resolve (self-calls,
  inherited and subclass-overridden methods, typed ``self.<attr>``
  receivers, module-level singletons like ``counters._GLOBAL``) — adds
  ``A -> B``, carrying the acquisition path that proves it.
* a **cycle** is a deadlock finding, naming every edge's path;
* the discovered order is COMMITTED as ``GRAFTLINT_LOCK_ORDER`` in
  ``tpu_sgd_torch/analysis/__init__.py`` — a tuple of ``(outer, inner)``
  pairs.  A discovered edge whose inverse is declared fails lint with
  both acquisition paths named; a discovered edge missing from the
  declaration, or a declared pair the graph no longer finds, is also a
  finding.  Drift fails in BOTH directions, so the declaration stays
  exactly the graph.

Honest limitations: acquisition through a stored callback
(``store.set_replication(log.append)`` — the HA replication hook) is
invisible to call resolution; the runtime twin
(``runtime.assert_lock_order`` over a :class:`~tpu_sgd_torch.analysis.
runtime.LocksetRecorder`) replays real acquisition sequences against
the same committed order and covers exactly that blind spot.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule, parse_guard
from tpu_sgd_torch.analysis.rules_lock import NO_DECLARATION, extract_lock_map
from tpu_sgd_torch.analysis.tracing import dotted_name, enclosing

ORDER_DECLARATION = "GRAFTLINT_LOCK_ORDER"

#: call-chain depth bound for the acquisition closure — deep enough for
#: every real chain in this repo (longest: region -> helper -> imported
#: function -> singleton method = 4), shallow enough that a pathological
#: fixture cannot make the closure quadratic in path length
MAX_DEPTH = 6

DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def extract_lock_order(tree: ast.Module):
    """The module's ``GRAFTLINT_LOCK_ORDER`` literal as a list of
    ``(outer, inner, lineno)`` triples; ``NO_DECLARATION`` when absent;
    ``None`` when present but not a literal sequence of string pairs."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == ORDER_DECLARATION
                   for t in targets):
            continue
        try:
            lit = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return None
        if not isinstance(lit, (tuple, list)):
            return None
        out = []
        for pair in lit:
            if not (isinstance(pair, (tuple, list)) and len(pair) == 2
                    and all(isinstance(p, str) for p in pair)):
                return None
            out.append((pair[0], pair[1], node.lineno))
        return out
    return NO_DECLARATION


def _scope(node: ast.AST) -> List[ast.AST]:
    """Child nodes of ``node``'s own scope — nested function/lambda
    bodies excluded (a closure runs later, under whatever locks its
    CALLER holds, not this region's)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, DefNode + (ast.Lambda,)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _self_lock_of(with_item: ast.withitem) -> Optional[str]:
    """``with self.<L>:`` -> ``L`` (plain attribute only — a CALL like
    ``self._publish_lock(tid)`` returns a per-key lock object, not a
    declared attribute, and is not a graph node)."""
    expr = with_item.context_expr
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


class _Classes:
    """Project-wide class table: defs, bases, methods, declared locks,
    and the receiver types the closure needs."""

    def __init__(self, modules: Sequence[ModuleFile], project):
        self.project = project
        #: class name -> (ModuleInfo, ClassDef); class names are unique
        #: across this project, and a collision just loses edges
        self.defs: Dict[str, Tuple[object, ast.ClassDef]] = {}
        #: class name -> direct base class names (last dotted segment)
        self.bases: Dict[str, List[str]] = {}
        self.subclasses: Dict[str, List[str]] = {}
        #: class name -> {method name: def node}
        self.methods: Dict[str, Dict[str, ast.AST]] = {}
        #: class name -> {declared lock attr names} (guard values)
        self.declared: Dict[str, Set[str]] = {}
        #: class name -> {self attr: {class names}} (scalar receivers)
        self.attr_types: Dict[str, Dict[str, Set[str]]] = {}
        #: class name -> {self attr: {element class names}} (lists)
        self.elem_types: Dict[str, Dict[str, Set[str]]] = {}
        #: relpath -> {module-global name: {class names}}
        self.global_types: Dict[str, Dict[str, Set[str]]] = {}

        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.infos[mod.relpath]
            lock_map = extract_lock_map(mod.tree)
            if isinstance(lock_map, dict):
                for cls_name, guards in lock_map.items():
                    locks = set()
                    for spec in guards.values():
                        try:
                            locks.add(parse_guard(spec)[0])
                        except ValueError:
                            continue  # rules_lock reports the bad spec
                    self.declared.setdefault(cls_name, set()).update(locks)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                self.defs.setdefault(node.name, (mi, node))
                base_names = []
                for b in node.bases:
                    bn = dotted_name(b)
                    if bn:
                        base_names.append(bn.split(".")[-1])
                self.bases[node.name] = base_names
                meths = {}
                for ch in node.body:
                    if isinstance(ch, DefNode):
                        meths[ch.name] = ch
                self.methods[node.name] = meths
        for cls, bs in self.bases.items():
            for b in bs:
                self.subclasses.setdefault(b, []).append(cls)
        for mod in modules:
            if mod.tree is None:
                continue
            self._infer_module_types(mod)

    # -- type inference ------------------------------------------------------
    def _ctor_class(self, expr: ast.AST) -> Optional[str]:
        """``ClassName(...)`` (possibly dotted) -> the class name when
        it is a project class."""
        if not isinstance(expr, ast.Call):
            return None
        dn = dotted_name(expr.func)
        if dn is None:
            return None
        name = dn.split(".")[-1]
        return name if name in self.defs else None

    def _infer_module_types(self, mod: ModuleFile) -> None:
        globals_here = self.global_types.setdefault(mod.relpath, {})
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                c = self._ctor_class(node.value)
                if c:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            globals_here.setdefault(t.id, set()).add(c)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            at = self.attr_types.setdefault(node.name, {})
            et = self.elem_types.setdefault(node.name, {})
            for n in ast.walk(node):
                if isinstance(n, ast.Assign):
                    self._infer_assign(n, at, et)
                elif isinstance(n, ast.AnnAssign):
                    self._infer_annassign(n, at, et)
                elif (isinstance(n, ast.Call)
                      and isinstance(n.func, ast.Attribute)
                      and n.func.attr == "append" and n.args):
                    tgt = dotted_name(n.func.value)
                    c = self._ctor_class(n.args[0])
                    if c and tgt and tgt.startswith("self.") \
                            and tgt.count(".") == 1:
                        et.setdefault(tgt.split(".")[1], set()).add(c)

    def _infer_assign(self, n: ast.Assign, at: Dict, et: Dict) -> None:
        self_attrs = [t.attr for t in n.targets
                      if isinstance(t, ast.Attribute)
                      and isinstance(t.value, ast.Name)
                      and t.value.id == "self"]
        if not self_attrs:
            return
        c = self._ctor_class(n.value)
        if c:
            for a in self_attrs:
                at.setdefault(a, set()).add(c)
            return
        elts: List[ast.AST] = []
        if isinstance(n.value, (ast.List, ast.Tuple)):
            elts = n.value.elts
        elif isinstance(n.value, ast.ListComp):
            elts = [n.value.elt]
        elif isinstance(n.value, ast.DictComp):
            elts = [n.value.value]
        for e in elts:
            c = self._ctor_class(e)
            if c:
                for a in self_attrs:
                    et.setdefault(a, set()).add(c)

    def _infer_annassign(self, n: ast.AnnAssign, at: Dict,
                         et: Dict) -> None:
        """``self._stores: List[ParameterStore] = ...`` — the annotation
        IS the receiver type (scalar, or the element/value type of a
        ``List``/``Dict``/... container).  Stringized annotations
        (``from __future__ import annotations`` does not stringize the
        AST, but hand-quoted forward refs do) are parsed."""
        t = n.target
        if not (isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"):
            return
        scalar, elems = self._annotation_classes(n.annotation)
        for c in scalar:
            at.setdefault(t.attr, set()).add(c)
        for c in elems:
            et.setdefault(t.attr, set()).add(c)
        if n.value is not None:
            self._infer_assign(
                ast.Assign(targets=[t], value=n.value), at, et)

    _CONTAINERS = {"List", "Sequence", "Tuple", "Set", "FrozenSet",
                   "Deque", "Iterable", "list", "tuple", "set", "deque"}
    _MAPPINGS = {"Dict", "Mapping", "MutableMapping", "OrderedDict",
                 "DefaultDict", "dict"}

    def _annotation_classes(self, ann: ast.AST
                            ) -> Tuple[Set[str], Set[str]]:
        """(scalar project classes, element/value project classes) an
        annotation expression names."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return set(), set()
        dn = dotted_name(ann)
        if dn is not None:
            name = dn.split(".")[-1]
            return ({name} if name in self.defs else set()), set()
        if isinstance(ann, ast.Subscript):
            base = dotted_name(ann.value)
            base = base.split(".")[-1] if base else ""
            args = ann.slice.elts if isinstance(ann.slice, ast.Tuple) \
                else [ann.slice]
            if base in self._MAPPINGS and len(args) == 2:
                args = args[1:]  # value type only
            elems: Set[str] = set()
            if base in self._CONTAINERS | self._MAPPINGS:
                for a in args:
                    s, _ = self._annotation_classes(a)
                    elems |= s
                return set(), elems
            if base == "Optional" and len(args) == 1:
                return self._annotation_classes(args[0])
        return set(), set()

    # -- lock identity -------------------------------------------------------
    def lock_node(self, cls_name: Optional[str],
                  lock_attr: str) -> Optional[str]:
        """``(class, attr)`` -> the graph node ``DeclaringClass.attr``,
        resolving through base classes (a subclass method's ``with
        self._cond:`` acquires the BASE's declared condition)."""
        seen: Set[str] = set()
        stack = [cls_name] if cls_name else []
        while stack:
            c = stack.pop()
            if c is None or c in seen:
                continue
            seen.add(c)
            if lock_attr in self.declared.get(c, ()):
                return f"{c}.{lock_attr}"
            stack.extend(self.bases.get(c, ()))
        return None

    # -- method lookup -------------------------------------------------------
    def find_method(self, cls_name: str, meth: str,
                    *, with_overrides: bool = True
                    ) -> List[Tuple[object, ast.AST, str]]:
        """Defs a ``<cls instance>.meth()`` call can reach: the def on
        ``cls_name`` or the nearest base, PLUS every subclass override
        (virtual dispatch — ``ParameterStore._apply_payloads_locked``
        really calls ``ShardedParameterStore._combine_sums_locked``)."""
        out: List[Tuple[object, ast.AST, str]] = []
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            c = stack.pop()
            if c in seen or c not in self.defs:
                continue
            seen.add(c)
            d = self.methods.get(c, {}).get(meth)
            if d is not None:
                out.append((self.defs[c][0], d, c))
                break  # nearest definition up the chain wins
            stack.extend(self.bases.get(c, ()))
        if with_overrides:
            stack = list(self.subclasses.get(cls_name, ()))
            while stack:
                c = stack.pop()
                if c in seen:
                    continue
                seen.add(c)
                d = self.methods.get(c, {}).get(meth)
                if d is not None:
                    out.append((self.defs[c][0], d, c))
                stack.extend(self.subclasses.get(c, ()))
        return out

    def owner_of(self, mi, d: ast.AST) -> Optional[str]:
        cls = enclosing(d, mi.parents, (ast.ClassDef,))
        return cls.name if cls is not None else None


class _Closure:
    """Per-def acquisition summaries: which declared locks can running
    this def acquire, and through which call path."""

    def __init__(self, classes: _Classes):
        self.classes = classes
        #: def node -> {lock node: path tuple}
        self._memo: Dict[int, Dict[str, Tuple[str, ...]]] = {}
        self._in_progress: Set[int] = set()

    def local_types(self, fn: ast.AST, owner: Optional[str],
                    mi) -> Dict[str, Set[str]]:
        """Function-local receiver types: ``v = ClassName(...)``,
        ``v = self.<typed attr>``, and ``for v in self.<list attr>``
        (plus the ``enumerate`` spelling)."""
        cl = self.classes
        at = cl.attr_types.get(owner, {}) if owner else {}
        et = cl.elem_types.get(owner, {}) if owner else {}
        out: Dict[str, Set[str]] = {}

        def _self_attr(expr: ast.AST) -> Optional[str]:
            if (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return expr.attr
            return None

        def _elem_source(expr: ast.AST) -> Set[str]:
            """Types of one ELEMENT of ``expr``: a subscript of a typed
            container attr (``self._stores[i]``), or ``.pop(...)`` /
            ``.get(...)`` on one."""
            if isinstance(expr, ast.Subscript):
                a = _self_attr(expr.value)
                if a and a in et:
                    return set(et[a])
            if (isinstance(expr, ast.Call)
                    and isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in ("pop", "get", "popitem")):
                a = _self_attr(expr.func.value)
                if a and a in et:
                    return set(et[a])
            return set()

        for n in _scope(fn):
            if isinstance(n, ast.Assign):
                c = cl._ctor_class(n.value)
                types = {c} if c else set()
                if not types:
                    a = _self_attr(n.value)
                    if a and a in at:
                        types = set(at[a])
                if not types:
                    types = _elem_source(n.value)
                if types:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, set()).update(types)
            elif isinstance(n, (ast.For, ast.comprehension)):
                it = n.iter
                if (isinstance(it, ast.Call)
                        and dotted_name(it.func) == "enumerate"
                        and it.args):
                    it = it.args[0]
                if (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Attribute)
                        and it.func.attr == "values"):
                    it = it.func.value
                a = _self_attr(it)
                if a and a in et:
                    tgt = n.target
                    if isinstance(tgt, ast.Tuple) and tgt.elts:
                        tgt = tgt.elts[-1]
                    if isinstance(tgt, ast.Name):
                        out.setdefault(tgt.id, set()).update(et[a])
        return out

    def resolve_call(self, call: ast.Call, owner: Optional[str], mi,
                     locals_: Dict[str, Set[str]]
                     ) -> List[Tuple[object, ast.AST, str]]:
        cl = self.classes
        func = call.func
        dn = dotted_name(func)
        if dn and dn.startswith("self.") and dn.count(".") == 1 and owner:
            return cl.find_method(owner, dn.split(".")[1])
        if isinstance(func, ast.Attribute):
            meth = func.attr
            recv_types: Set[str] = set()
            base = func.value
            bn = dotted_name(base)
            if bn and bn.startswith("self.") and bn.count(".") == 1 \
                    and owner:
                recv_types |= cl.attr_types.get(owner, {}).get(
                    bn.split(".")[1], set())
            elif isinstance(base, ast.Name):
                recv_types |= locals_.get(base.id, set())
                recv_types |= cl.global_types.get(
                    mi.mod.relpath, {}).get(base.id, set())
            elif isinstance(base, ast.Call):
                c = cl._ctor_class(base)
                if c:
                    recv_types.add(c)
            out = []
            for t in recv_types:
                out.extend(cl.find_method(t, meth))
            return out
        # plain / imported function, or a direct constructor call
        targets = []
        for tmi, d in cl.project.resolve_name(mi, func):
            if isinstance(d, DefNode):
                targets.append((tmi, d, cl.owner_of(tmi, d)))
        c = cl._ctor_class(call)
        if c:
            init = cl.methods.get(c, {}).get("__init__")
            if init is not None:
                targets.append((cl.defs[c][0], init, c))
        return targets

    def acquisitions(self, fn: ast.AST, owner: Optional[str], mi,
                     depth: int = 0) -> Dict[str, Tuple[str, ...]]:
        """{lock node: proof path} for everything running ``fn`` can
        acquire.  Memoized; recursion returns empty (a cycle through the
        call graph adds no acquisition its first visit missed)."""
        key = id(fn)
        if key in self._memo:
            return self._memo[key]
        if key in self._in_progress or depth > MAX_DEPTH:
            return {}
        self._in_progress.add(key)
        out: Dict[str, Tuple[str, ...]] = {}
        try:
            fn_name = getattr(fn, "name", "<fn>")
            where = f"{mi.mod.relpath}"
            locals_: Optional[Dict[str, Set[str]]] = None
            for n in _scope(fn):
                if isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        lk = _self_lock_of(item)
                        if lk is None:
                            continue
                        node = self.classes.lock_node(owner, lk)
                        if node is not None:
                            out.setdefault(node, (
                                f"{where}:{n.lineno} "
                                f"{(owner + '.') if owner else ''}"
                                f"{fn_name} takes self.{lk}",))
                elif isinstance(n, ast.Call):
                    if locals_ is None:
                        locals_ = self.local_types(fn, owner, mi)
                    for tmi, d, towner in self.resolve_call(
                            n, owner, mi, locals_):
                        sub = self.acquisitions(d, towner, tmi, depth + 1)
                        step = (f"{where}:{n.lineno} "
                                f"{(owner + '.') if owner else ''}"
                                f"{fn_name} calls "
                                f"{(towner + '.') if towner else ''}"
                                f"{getattr(d, 'name', '?')}")
                        for lock, path in sub.items():
                            out.setdefault(lock, (step,) + path)
        finally:
            self._in_progress.discard(key)
        self._memo[key] = out
        return out


class LockOrderRule(Rule):
    name = "lock-order"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project = options.get("project")
        if project is None:
            from tpu_sgd_torch.analysis.dataflow import ProjectIndex
            project = ProjectIndex(modules)
        classes = _Classes(modules, project)
        closure = _Closure(classes)

        #: (outer, inner) -> (path tuple, relpath, lineno)
        edges: Dict[Tuple[str, str], Tuple[Tuple[str, ...], str, int]] = {}
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.infos[mod.relpath]
            for cls in ast.walk(mod.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for meth in classes.methods.get(cls.name, {}).values():
                    self._scan_regions(mod, mi, cls.name, meth,
                                       classes, closure, edges)

        yield from self._graph_findings(modules, edges)

    # -- region scan ---------------------------------------------------------
    def _scan_regions(self, mod, mi, owner, meth, classes, closure,
                      edges) -> None:
        for n in _scope(meth):
            if not isinstance(n, (ast.With, ast.AsyncWith)):
                continue
            for item in n.items:
                lk = _self_lock_of(item)
                if lk is None:
                    continue
                outer = classes.lock_node(owner, lk)
                if outer is None:
                    continue
                head = (f"{mod.relpath}:{n.lineno} {owner}.{meth.name} "
                        f"holds self.{lk}")
                # the region is the BODY only: the context expression
                # evaluates before acquisition
                for b in n.body:
                    self._scan_body(b, mod, mi, owner, meth, outer, head,
                                    classes, closure, edges, n.lineno)

    def _scan_body(self, stmt, mod, mi, owner, meth, outer, head,
                   classes, closure, edges, region_line) -> None:
        locals_: Optional[Dict[str, Set[str]]] = None
        for n in [stmt] + _scope(stmt):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    lk = _self_lock_of(item)
                    if lk is None:
                        continue
                    inner = classes.lock_node(owner, lk)
                    if inner is not None and inner != outer:
                        path = (head, f"{mod.relpath}:{n.lineno} "
                                      f"{owner}.{meth.name} takes "
                                      f"self.{lk}")
                        edges.setdefault(
                            (outer, inner),
                            (path, mod.relpath, region_line))
            elif isinstance(n, ast.Call):
                if locals_ is None:
                    locals_ = closure.local_types(meth, owner, mi)
                for tmi, d, towner in closure.resolve_call(
                        n, owner, mi, locals_):
                    sub = closure.acquisitions(d, towner, tmi, depth=1)
                    step = (f"{mod.relpath}:{n.lineno} "
                            f"{owner}.{meth.name} calls "
                            f"{(towner + '.') if towner else ''}"
                            f"{getattr(d, 'name', '?')}")
                    for inner, path in sub.items():
                        if inner != outer:
                            edges.setdefault(
                                (outer, inner),
                                ((head, step) + path, mod.relpath,
                                 region_line))

    # -- graph findings ------------------------------------------------------
    def _graph_findings(self, modules, edges) -> Iterable[Finding]:
        # cycles first: a deadlock is a deadlock whether declared or not
        yield from self._cycles(edges)

        declared: List[Tuple[str, str, str, int]] = []  # (a, b, rel, line)
        decl_found = False
        for mod in modules:
            if mod.tree is None:
                continue
            order = extract_lock_order(mod.tree)
            if order is NO_DECLARATION:
                continue
            decl_found = True
            if order is None:
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{ORDER_DECLARATION} must be a literal sequence of "
                    "(outer, inner) lock-name pairs")
                continue
            declared.extend((a, b, mod.relpath, ln) for a, b, ln in order)
        if not decl_found:
            return  # fixtures without a declaration: cycles only

        declared_pairs = {(a, b) for a, b, _, _ in declared}
        for (a, b), (path, rel, line) in sorted(edges.items()):
            if (a, b) in declared_pairs:
                continue
            if (b, a) in declared_pairs:
                yield Finding(
                    self.name, rel, line, 0,
                    f"lock nesting {a} -> {b} INVERTS the declared order "
                    f"{b} -> {a} ({ORDER_DECLARATION}); this path: "
                    + " | ".join(path)
                    + "; declared-direction path: "
                    + " | ".join(edges[(b, a)][0]
                                 if (b, a) in edges
                                 else (f"committed in {ORDER_DECLARATION}",)))
            else:
                yield Finding(
                    self.name, rel, line, 0,
                    f"discovered lock nesting {a} -> {b} is not in "
                    f"{ORDER_DECLARATION}; add (\"{a}\", \"{b}\") "
                    "(path: " + " | ".join(path) + ")")
        discovered = set(edges)
        for a, b, rel, line in declared:
            if (a, b) not in discovered:
                yield Finding(
                    self.name, rel, line, 0,
                    f"declared lock order {a} -> {b} matches no nesting "
                    "the graph can find; delete the stale pair (or it "
                    "will silently sanction a future inversion)")

    def _cycles(self, edges) -> Iterable[Finding]:
        graph: Dict[str, List[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        color: Dict[str, int] = {}
        stack: List[str] = []
        cycles: List[List[str]] = []

        def visit(u: str) -> None:
            color[u] = 1
            stack.append(u)
            for v in sorted(graph[u]):
                if color.get(v, 0) == 0:
                    visit(v)
                elif color.get(v) == 1:
                    cycles.append(stack[stack.index(v):] + [v])
            stack.pop()
            color[u] = 2

        for u in sorted(graph):
            if color.get(u, 0) == 0:
                visit(u)
        for cyc in cycles:
            pairs = list(zip(cyc, cyc[1:]))
            path_bits = []
            rel, line = "?", 1
            for i, pair in enumerate(pairs):
                p, r, ln = edges[pair]
                if i == 0:
                    rel, line = r, ln
                path_bits.append(f"[{pair[0]} -> {pair[1]}: "
                                 + " | ".join(p) + "]")
            yield Finding(
                self.name, rel, line, 0,
                "lock-acquisition CYCLE (deadlock): "
                + " -> ".join(cyc) + "; " + "; ".join(path_bits))
