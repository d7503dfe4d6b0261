"""donation-safety: a captured graph's static output must not be read
through an alias after a later replay — the port of
``tpu_sgd/analysis/rules_donation.py``.

``donate_argnums`` hands an argument's buffer to XLA, which may write its
output there; reading the Python name afterwards reads garbage.  A CUDA
graph does the same to its **static outputs**: the tensors a capture
assigns (``with torch.cuda.graph(g): out = step(x)``) are the graph's own
memory, and every ``g.replay()`` writes them again.  Reading ``out`` right
after a replay is the contract; keeping a reference ``kept = out`` (or a
view of it) and reading it after a LATER replay reads that replay's
values, not the ones it was taken for — use-after-donate at the buffer
level, silent on the card.  The safe idiom copies before the next
replay (``kept = out.clone()``, ``.cpu()``, ``.item()``) or rebinds the
name from the fresh output after it.

The rule, per function: the static outputs of each graph ``g`` are the
names assigned inside its capture region (``with torch.cuda.graph(g):``
or between ``g.capture_begin()`` and ``g.capture_end()``); an **alias**
is a name assigned from an expression reading a static output without a
copy.  After a call that replays ``g`` — ``g.replay()``, or a call of a
def that replays its parameter — any *load* of an alias assigned before
that call, with no rebind in between, is a finding, at the load.

Since graftlint v2 the JAX rule is one call level deep, and so is this
one: a def that replays its own parameter unconditionally (never
rebinding it first) REPLAYS that argument at its call sites, so
``step(g)`` followed by a read of a stale alias is a finding even though
the ``replay()`` lives inside ``step``.  Replaying defs are resolved
project-wide through imports, like the JAX rule's donators.

Line-granular rebind tracking, as in the JAX rule: an alias read
textually before an in-loop replay (hit on the next iteration) is
missed.  A graph held on an attribute (``self.graph.replay()``) replays
outputs the rule cannot name; those stay the owner's discipline (the
port's ``_BlockRunner`` reads its state only between replays).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import func_params
from tpu_sgd_torch.analysis.tracing import (build_parents,
                                            capture_statements, dotted_name,
                                            enclosing, is_capture_context,
                                            last_seg, module_prefixes)

#: methods whose result is a view of the output's memory
VIEWS = {"view", "reshape", "t", "transpose", "narrow", "select", "squeeze",
         "unsqueeze", "flatten", "view_as", "expand", "detach"}


def collect_donators(mod: ModuleFile) -> Dict[str, Tuple[int, ...]]:
    """Defs in ``mod`` that replay a parameter (``p.replay()``), never
    rebinding it in the def: calling one replays (donates) that
    argument."""
    out: Dict[str, Tuple[int, ...]] = {}
    if mod.tree is None or ".replay(" not in mod.source:
        return out
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = func_params(fn)
        idx = {p: i for i, p in enumerate(params)}
        stored = {n.id for n in ast.walk(fn)
                  if isinstance(n, ast.Name)
                  and not isinstance(n.ctx, ast.Load)}
        fwd = set()
        for call in ast.walk(fn):
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "replay" \
                    and isinstance(call.func.value, ast.Name):
                p = call.func.value.id
                if p in idx and p not in stored:
                    fwd.add(idx[p])
        if fwd:
            out[fn.name] = tuple(sorted(fwd))
    return out


def collect_forwarders(mod: ModuleFile,
                       donators: Dict[str, Tuple[int, ...]]
                       ) -> Dict[str, Tuple[int, ...]]:
    """One-level summaries: defs in ``mod`` that forward a parameter —
    never rebound in the def — into a replayed position of a known
    replaying def.  Calling such a def replays the argument too."""
    out: Dict[str, Tuple[int, ...]] = {}
    if mod.tree is None or not donators:
        return out
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = func_params(fn)
        idx = {p: i for i, p in enumerate(params)}
        stored = {n.id for n in ast.walk(fn)
                  if isinstance(n, ast.Name)
                  and not isinstance(n.ctx, ast.Load)}
        fwd = set()
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            nums = donators.get(last_seg(dotted_name(call.func)))
            if not nums:
                continue
            for i in nums:
                if i < len(call.args) and isinstance(call.args[i],
                                                     ast.Name):
                    p = call.args[i].id
                    if p in idx and p not in stored:
                        fwd.add(idx[p])
        if fwd:
            out[fn.name] = tuple(sorted(fwd))
    return out


class DonationSafetyRule(Rule):
    name = "donation-safety"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        by_module: Dict[str, Dict[str, Tuple[int, ...]]] = {
            mod.dotted: collect_donators(mod) for mod in modules}
        for mod in modules:
            if mod.tree is None:
                continue
            local = dict(by_module.get(mod.dotted, {}))
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ImportFrom) or node.level:
                    continue
                exported = by_module.get(node.module or "", {})
                for a in node.names:
                    if a.name in exported:
                        local[a.asname or a.name] = exported[a.name]
            # the call graph, one level: defs forwarding a param into a
            # replayed position replay it themselves
            for name, nums in collect_forwarders(mod, local).items():
                local[name] = tuple(sorted(set(local.get(name, ()))
                                           | set(nums)))
            yield from self._check_module(mod, local)

    def _check_module(self, mod: ModuleFile,
                      replayers: Dict[str, Tuple[int, ...]]
                      ) -> Iterable[Finding]:
        if "capture" not in mod.source and "graph(" not in mod.source:
            return  # no capture region: no static output to alias
        parents = build_parents(mod.tree)
        prefixes = module_prefixes(mod.tree)
        captured = capture_statements(mod.tree, prefixes)
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_scope(mod, fn, replayers, parents,
                                             prefixes, captured)

    def _check_scope(self, mod: ModuleFile, fn: ast.AST,
                     replayers: Dict[str, Tuple[int, ...]], parents,
                     prefixes, captured) -> Iterable[Finding]:
        own = self._scope_nodes(fn)
        if not any(n in captured for n in own):
            return
        # graph -> its static outputs (names assigned in its capture)
        outputs: Dict[str, Set[str]] = {}
        for node in own:
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            graph = self._captured_by(node, parents, prefixes, captured, fn)
            if graph is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                outputs.setdefault(graph, set()).update(
                    n.id for n in ast.walk(t) if isinstance(n, ast.Name))
        if not outputs:
            return
        stores: Dict[str, List[int]] = {}
        loads: Dict[str, List[ast.Name]] = {}
        #: alias -> (graph, line it was taken)
        aliases: List[Tuple[str, str, int]] = []
        replays: List[Tuple[str, int, ast.Call]] = []
        for node in own:
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node)
                else:
                    stmt = enclosing(node, parents,
                                     (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign, ast.For, ast.With,
                                      ast.withitem)) or node
                    line = getattr(stmt, "end_lineno", None) or node.lineno
                    stores.setdefault(node.id, []).append(line)
            elif isinstance(node, ast.Assign) and not self._captured_by(
                    node, parents, prefixes, captured, fn):
                for graph, outs in outputs.items():
                    if self._aliases(node.value, outs):
                        for t in node.targets:
                            for n in ast.walk(t):
                                if isinstance(n, ast.Name) \
                                        and n.id not in outs:
                                    aliases.append(
                                        (n.id, graph, node.end_lineno
                                         or node.lineno))
            elif isinstance(node, ast.Call):
                for graph in self._replayed(node, replayers):
                    replays.append((graph, node.end_lineno or node.lineno,
                                    node))
        for name, graph, taken in aliases:
            for g, call_end, call in replays:
                if g != graph or call_end <= taken:
                    continue
                rebinds = stores.get(name, [])
                for load in loads.get(name, []):
                    if load.lineno <= call_end:
                        continue
                    if any(call_end <= r <= load.lineno and r != taken
                           for r in rebinds):
                        continue
                    yield Finding(
                        self.name, mod.relpath, load.lineno,
                        load.col_offset,
                        f"`{name}` aliases a static output of graph "
                        f"`{graph}`, which was replayed again on line "
                        f"{call.lineno} (donated to "
                        f"`{dotted_name(call.func) or '?'}`); the replay "
                        "wrote the buffer, so this read sees its values — "
                        "copy the output (.clone()) before the next replay "
                        "or rebind the name after it")

    @staticmethod
    def _captured_by(node, parents, prefixes, captured, fn):
        """The graph name whose capture region holds ``node``, else
        None."""
        cur = node
        while cur is not None and cur is not fn:
            if cur in captured:
                host = parents.get(cur)
                if isinstance(host, (ast.With, ast.AsyncWith)) \
                        and cur in host.body:
                    for it in host.items:
                        if is_capture_context(it.context_expr, prefixes) \
                                and it.context_expr.args:
                            return dotted_name(it.context_expr.args[0])
                    return None
                # capture_begin/end: the graph of the nearest begin
                body = getattr(host, "body", [])
                if cur in body:
                    for st in reversed(body[:body.index(cur)]):
                        call = st.value if isinstance(st, ast.Expr) \
                            else None
                        if isinstance(call, ast.Call) and last_seg(
                                dotted_name(call.func)) == "capture_begin":
                            return dotted_name(call.func.value)
                return None
            cur = parents.get(cur)
        return None

    @staticmethod
    def _aliases(expr: ast.AST, outs: Set[str]) -> bool:
        """Does ``expr`` hand out a static output's memory (the name, a
        view, an index) rather than a copy of it?"""
        if isinstance(expr, ast.Name):
            return expr.id in outs
        if isinstance(expr, ast.Subscript):
            return DonationSafetyRule._aliases(expr.value, outs)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(DonationSafetyRule._aliases(e, outs)
                       for e in expr.elts)
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            if expr.func.attr in VIEWS:
                return DonationSafetyRule._aliases(expr.func.value, outs)
        return False

    @staticmethod
    def _replayed(call: ast.Call,
                  replayers: Dict[str, Tuple[int, ...]]) -> List[str]:
        """Graph names ``call`` replays: ``g.replay()`` or a replaying
        def given ``g`` at a replayed position."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "replay":
            g = dotted_name(func.value)
            return [g] if g else []
        nums = replayers.get(last_seg(dotted_name(func)))
        if not nums or dotted_name(func) is None:
            return []
        return [call.args[i].id for i in nums
                if i < len(call.args) and isinstance(call.args[i],
                                                     ast.Name)]

    @staticmethod
    def _scope_nodes(fn: ast.AST) -> List[ast.AST]:
        """Nodes belonging to ``fn``'s own scope (nested defs excluded —
        a closure's loads run at a time the linear line model cannot
        order)."""
        out: List[ast.AST] = []
        stack = [c for c in ast.iter_child_nodes(fn)]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            out.append(n)
            stack.extend(ast.iter_child_nodes(n))
        return out
