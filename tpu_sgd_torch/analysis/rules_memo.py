"""memo-key: a program cache's key must cover its factory — the port of
``tpu_sgd/analysis/rules_memo.py``.

The worst bug class of a cached program is silent: a memoized captured
graph (or compiled callable, or built library) whose cache key lost a
field.  The program still runs — it is just the WRONG program for one
of the configs sharing the key: a CUDA graph replays the kernels,
shapes, addresses and Python numbers of its capture, whatever the
caller meant this time.  Nothing fails until trajectories drift.

A module owning a cache of programs declares it, mirroring
``GRAFTLINT_LOCKS``::

    GRAFTLINT_MEMO = {
        "_loaded": ("name",),
        "GradientDescent._run_cache": ("gradient", "updater", ...),
    }

Keys are the cache's name — module-level, or ``Class.attr`` for an
instance cache — and values are the KEY FIELDS: the root value names
(``self.<attr>`` normalized to ``<attr>``) the cache key is built from.
A store site is ``cache[key] = value``; the port's single-slot idiom
``self._cache = (key, value)`` (read back as ``entry[0] == key``); and,
for a declared set of shape keys (``ops/bucketed.py``'s padded shapes),
``cache.add(key)``, whose key is all it holds.  The rule then checks,
over every store site:

1. **declaration drift**, both directions: a declared field no store
   site's key actually reads, and a key read no declaration mentions,
   are each findings — the declaration and the code must move together.
2. **factory coverage** (the dataflow check): the stored value's
   expression is decomposed through intra-function reaching definitions
   (:meth:`ProjectIndex.local_roots` — through local aliases, nested-def
   free variables, tuple unpacking) into the root reads the program was
   built from.  Every root that is not a key read, a module-level
   constant/import, or a builtin must appear in the key — a
   program-affecting read outside the key is precisely the
   incomplete-memo-key bug.
3. **undeclared caches**: a store of a program (``torch.compile(...)``,
   ``torch.cuda.CUDAGraph()``, ``ctypes.CDLL(...)``, ``_build.load(...)``,
   or a factory returning one) into an undeclared cache is a finding —
   new program caches cannot opt out by silence.  A factory memoized by
   ``functools.lru_cache`` keys on all its arguments and is sanctioned,
   as in the JAX package.

Declared-but-missing caches and malformed declarations are findings,
exactly like lock-declaration drift.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import (DefNode, ModuleInfo, ProjectIndex,
                                       _is_jit_construction, expr_reads,
                                       scope_nodes)
from tpu_sgd_torch.analysis.tracing import enclosing

DECLARATION = "GRAFTLINT_MEMO"

_BUILTIN_NAMES = set(dir(builtins))


def extract_memo_map(tree: ast.Module):
    """The module's ``GRAFTLINT_MEMO`` dict literal; None when absent;
    the string ``"malformed"`` when present but not a literal
    ``{str: (str, ...)}`` dict."""
    for node in tree.body:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == DECLARATION
                   for t in targets):
            continue
        try:
            lit = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return "malformed"
        if not isinstance(lit, dict) or not all(
                isinstance(k, str)
                and isinstance(v, (tuple, list))
                and all(isinstance(f, str) for f in v)
                for k, v in lit.items()):
            return "malformed"
        return {k: tuple(v) for k, v in lit.items()}
    return None


class _StoreSite:
    """One ``cache[key] = value`` assignment, ``cache = (key, value)``
    single-slot store or ``cache.add(key)`` (``value_expr`` None)."""

    __slots__ = ("node", "key_expr", "value_expr", "fn", "cls_name")

    def __init__(self, node: ast.AST, key_expr: ast.AST,
                 value_expr: Optional[ast.AST],
                 fn: Optional[ast.AST], cls_name: Optional[str]):
        self.node = node
        self.key_expr = key_expr
        self.value_expr = value_expr
        self.fn = fn           # enclosing def (None at module level)
        self.cls_name = cls_name  # for `self.<attr>[k] = v` sites


def _cache_ref(target: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """``(name, None)`` for ``name[k]`` / ``name``; ``(attr, "self")`` for
    ``self.attr[k]`` / ``self.attr``; None for anything else."""
    base = target.value if isinstance(target, ast.Subscript) else target
    if isinstance(base, ast.Name):
        return base.id, None
    if (isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "self"):
        return base.attr, "self"
    return None


def _scope_exempt_names(fn: Optional[ast.AST]) -> Set[str]:
    """Names bound in ``fn`` by imports or nested class defs: resolvable
    to code, not to per-call-varying values — never key material."""
    out: Set[str] = set()
    if fn is None:
        return out
    for n in scope_nodes(fn):
        if isinstance(n, ast.Import):
            out.update(a.asname or a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            out.update(a.asname or a.name for a in n.names)
        elif isinstance(n, ast.ClassDef):
            out.add(n.name)
    return out


class MemoKeyRule(Rule):
    name = "memo-key"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            memo_map = extract_memo_map(mod.tree)
            if memo_map == "malformed":
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{DECLARATION} must be a literal "
                    "{cache_name: (key_field, ...)} dict; use "
                    "'Class.attr' names for instance caches")
                continue
            memo_map = memo_map or {}
            stores = self._collect_stores(mi)
            declared = self._declared_lookup(memo_map)
            yield from self._check_declared(mod, mi, project, memo_map,
                                            stores)
            yield from self._check_undeclared(mod, mi, project, stores,
                                              declared)

    # -- store-site collection ----------------------------------------------
    @staticmethod
    def _collect_stores(mi: ModuleInfo
                        ) -> Dict[Tuple[str, Optional[str]],
                                  List[_StoreSite]]:
        out: Dict[Tuple[str, Optional[str]], List[_StoreSite]] = {}

        def add(node, target, key_expr, value_expr):
            ref = _cache_ref(target)
            if ref is None:
                return
            fn = enclosing(node, mi.parents, DefNode)
            if fn is not None:
                ref = MemoKeyRule._chase_store_alias(fn, ref)
            cls = enclosing(node, mi.parents, ast.ClassDef)
            out.setdefault(ref, []).append(_StoreSite(
                node, key_expr, value_expr, fn, cls.name if cls else None))

        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "add" and len(node.args) == 1:
                add(node, node.func.value, node.args[0], None)
                continue
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    add(node, t, t.slice, node.value)
                elif isinstance(node.value, ast.Tuple) \
                        and len(node.value.elts) == 2 \
                        and isinstance(t, (ast.Name, ast.Attribute)):
                    add(node, t, node.value.elts[0], node.value.elts[1])
        return out

    @staticmethod
    def _chase_store_alias(fn: ast.AST, ref: Tuple[str, Optional[str]]
                           ) -> Tuple[str, Optional[str]]:
        """Resolve the common local-alias store (``cache = self._cache``
        or ``cache = _CACHE`` then ``cache[key] = fn``) to the cache it
        actually stores into, so the site attaches to the declaration
        instead of double-misfiring (never-stores drift + undeclared
        alias).  Multiply-assigned names are ambiguous and stay as-is."""
        name, base = ref
        seen: Set[str] = set()
        while base is None and name not in seen:
            seen.add(name)
            assigns = [n.value for n in scope_nodes(fn)
                       if isinstance(n, ast.Assign)
                       and len(n.targets) == 1
                       and isinstance(n.targets[0], ast.Name)
                       and n.targets[0].id == name]
            if len(assigns) != 1:
                break
            val = assigns[0]
            if (isinstance(val, ast.Attribute)
                    and isinstance(val.value, ast.Name)
                    and val.value.id == "self"):
                return val.attr, "self"
            if isinstance(val, ast.Name):
                name = val.id
                continue
            break
        return name, base

    @staticmethod
    def _declared_lookup(memo_map: Dict[str, Tuple[str, ...]]
                         ) -> Set[Tuple[str, Optional[str]]]:
        """Declaration names -> the ``(name, base)`` forms store sites
        are keyed by: ``"Class.attr"`` declares the ``self.attr`` sites,
        a bare name declares the module-level dict's sites."""
        out: Set[Tuple[str, Optional[str]]] = set()
        for decl in memo_map:
            if "." in decl:
                out.add((decl.split(".", 1)[1], "self"))
            else:
                out.add((decl, None))
        return out

    # -- declared-cache checks ----------------------------------------------
    def _check_declared(self, mod: ModuleFile, mi: ModuleInfo,
                        project: ProjectIndex,
                        memo_map: Dict[str, Tuple[str, ...]],
                        stores: Dict[Tuple[str, Optional[str]],
                                     List[_StoreSite]]
                        ) -> Iterable[Finding]:
        for decl, fields in memo_map.items():
            if "." in decl:
                cls_name, attr = decl.split(".", 1)
                sites = [s for s in stores.get((attr, "self"), ())
                         if s.cls_name == cls_name]
                exists = any(
                    isinstance(n, ast.Attribute)
                    and isinstance(n.ctx, ast.Store) and n.attr == attr
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    for c in ast.walk(mi.tree)
                    if isinstance(c, ast.ClassDef) and c.name == cls_name
                    for n in ast.walk(c))
            else:
                sites = list(stores.get((decl, None), ()))
                exists = decl in mi.module_names
            if not exists:
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{DECLARATION} declares cache {decl!r} but no such "
                    "name exists in this module (declaration drift)")
                continue
            if not sites:
                yield Finding(
                    self.name, mod.relpath, 1, 0,
                    f"{DECLARATION} declares cache {decl!r} but this "
                    "module never stores into it; delete the "
                    "declaration or restore the store site")
                continue
            declared = set(fields)
            union_roots: Set[str] = set()
            for site in sites:
                key_reads = expr_reads(site.key_expr)
                # the declaration names ROOT fields: a key built through
                # a local (`key = (self.gradient, cfg, K)`) declares
                # gradient/config/K, not the throwaway name `key`.
                # Builtins / imports / module-level helpers the
                # decomposition passes through are plumbing, not key
                # material
                if site.fn is None:
                    site_roots = set(key_reads)
                else:
                    site_roots = set()
                    for r in key_reads:
                        site_roots |= project.local_roots(
                            mi, site.fn, r, set())
                    site_roots -= (set(mi.module_names) | _BUILTIN_NAMES
                                   | set(mi.defs_by_name)
                                   | _scope_exempt_names(site.fn)
                                   | {"self"})
                union_roots |= site_roots
                if site.value_expr is not None:
                    yield from self._check_factory(mod, mi, project, decl,
                                                   site, key_reads)
            line = sites[0].node.lineno
            for f in sorted(declared - union_roots):
                yield Finding(
                    self.name, mod.relpath, line, 0,
                    f"{DECLARATION} for {decl!r} declares key field "
                    f"{f!r} but no store site's key derives from it "
                    "(declaration drift: the field was removed from the "
                    "key, or renamed)")
            for f in sorted(union_roots - declared):
                yield Finding(
                    self.name, mod.relpath, line, 0,
                    f"cache {decl!r} key derives from {f!r} but the "
                    f"{DECLARATION} declaration does not list it; add "
                    "the field so the key contract stays reviewable")

    def _check_factory(self, mod: ModuleFile, mi: ModuleInfo,
                       project: ProjectIndex, decl: str, site: _StoreSite,
                       key_reads: Set[str]) -> Iterable[Finding]:
        """The dataflow check: every per-call-varying root the stored
        value derives from must be covered by the key."""
        if site.fn is None:
            return  # module-level store: key is whatever the module says
        covered = set(key_reads)
        for r in key_reads:
            covered |= project.local_roots(mi, site.fn, r, set())
        # the cache's own name is plumbing, not a program input: the
        # miss-check read (`fn = self._cache.get(key)`) flows into the
        # stored name on the hit branch of the usual memo idiom
        # def names (methods, helpers) are code resolvable statically,
        # not per-call-varying values — a factory may call them freely
        cache_base = decl.split(".", 1)[-1] if "." in decl else decl
        exempt = (set(mi.module_names) | _BUILTIN_NAMES
                  | set(mi.defs_by_name) | _scope_exempt_names(site.fn)
                  | {"self", cache_base})
        uncovered: Set[str] = set()
        for r in expr_reads(site.value_expr):
            for root in project.local_roots(mi, site.fn, r, covered):
                if root not in covered and root not in exempt:
                    uncovered.add(root)
        for root in sorted(uncovered):
            yield Finding(
                self.name, mod.relpath, site.node.lineno,
                site.node.col_offset,
                f"cache {decl!r} stores a program built from "
                f"`{root}`, but the key does not include it: two "
                "configs differing only in that value would share one "
                "program (a captured graph replays its capture's "
                "values); add it to the key and the declaration, or "
                "derive it from a keyed field")

    # -- undeclared-cache check ---------------------------------------------
    def _check_undeclared(self, mod: ModuleFile, mi: ModuleInfo,
                          project: ProjectIndex,
                          stores: Dict[Tuple[str, Optional[str]],
                                       List[_StoreSite]],
                          declared: Set[Tuple[str, Optional[str]]]
                          ) -> Iterable[Finding]:
        for ref, sites in stores.items():
            if ref in declared:
                continue
            for site in sites:
                if site.value_expr is None \
                        or not self._stores_compiled(mi, project, site):
                    continue
                name = ref[0] if ref[1] is None else f"self.{ref[0]}"
                yield Finding(
                    self.name, mod.relpath, site.node.lineno,
                    site.node.col_offset,
                    f"`{name}` caches a program (a compiled callable, a "
                    "captured graph or a built library) but the module "
                    f"has no {DECLARATION} "
                    "entry for it; declare the cache and its key fields "
                    "(see the memo-key contract in README 'Static "
                    "analysis in the port')")
                break  # one finding per cache is enough

    @staticmethod
    def _stores_compiled(mi: ModuleInfo, project: ProjectIndex,
                         site: _StoreSite) -> bool:
        val = site.value_expr
        if _is_jit_construction(val, mi.prefixes):
            return True
        if isinstance(val, ast.Call):
            if any(d in project._returns_jitted
                   for _, d in project.resolve_call(mi, val)):
                return True
        if site.fn is not None and isinstance(val, ast.Name):
            return val.id in project.jitted_value_names(mi, site.fn)
        return False
