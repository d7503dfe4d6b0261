"""Project-wide call graph: the framework-free half of
``tpu_sgd/analysis/dataflow.py``, which the lock-order and
cond-discipline rules resolve calls through.

:meth:`ProjectIndex.resolve_call` maps a call expression to candidate
defs: same-module by name, cross-module through explicit ``from x import
y`` / ``import x as m; m.f`` edges, and ``self.f`` to same-module
methods.  Unresolvable calls resolve to nothing — rules err toward
silence on edges they cannot prove.  Resolution is the JAX package's,
edge for edge, so both packages' rules find the same lock graph.

The JAX package's index also closes traced-ness, jitted values, device
values and host-sync summaries over this graph (for shape-trap,
host-sync, memo-key, ...).  Those wait for ROADMAP A12 step 2.

Everything here is AST-only; no checked module is ever imported.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Tuple

from tpu_sgd_torch.analysis.core import ModuleFile
from tpu_sgd_torch.analysis.tracing import build_parents, dotted_name

DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class ModuleInfo:
    """Per-module slice of the project index: its parent map, its defs
    by name and its import edges."""

    def __init__(self, mod: ModuleFile):
        self.mod = mod
        self.tree = mod.tree
        self.parents = build_parents(mod.tree) if mod.tree is not None \
            else {}
        self.defs_by_name: Dict[str, List[ast.AST]] = {}
        #: ``from x.y import f [as g]`` -> g: ("x.y", "f")
        self.imports_from: Dict[str, Tuple[str, str]] = {}
        #: ``import x.y as m`` -> m: "x.y"
        self.import_mods: Dict[str, str] = {}
        if mod.tree is None:
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, DefNode):
                self.defs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.import_mods[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                for a in node.names:
                    if node.module:
                        self.imports_from[a.asname or a.name] = \
                            (node.module, a.name)


class ProjectIndex:
    """All linted modules, cross-linked.  Build once per lint run."""

    def __init__(self, modules: Sequence[ModuleFile]):
        self.infos: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        for m in modules:
            mi = ModuleInfo(m)
            self.infos[m.relpath] = mi
            self.by_dotted[m.dotted] = mi

    def info(self, mod: ModuleFile) -> ModuleInfo:
        return self.infos[mod.relpath]

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
