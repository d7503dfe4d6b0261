"""callback-discipline: no host side effect inside a capture — the port
of ``tpu_sgd/analysis/rules_callback.py``.

The JAX package's only window from a compiled program back to the host
is ``io_callback``, and its rule pins the callback's contract (ordered,
guarded, bounded).  A CUDA graph has no such window: a capture runs the
host code of its region ONCE, while it records the kernels, and a replay
runs the kernels only.  So a host call with a side effect inside a
capture region — a log line, a counter bump, a ``time`` read, a write to
a host buffer — happens once at capture and never again, silently: the
replays the run is made of never bump the counter or append the row.
(The port's own launch counts are the sanctioned exception: the wrappers
count as they would launch, and ``with ck.captured_launches()`` takes
the capture's counts back out and adds them again per replay.)

The rule's checks, at each capture region (``with torch.cuda.graph(g):``,
``with ck.captured_launches():``, ``capture_begin`` .. ``capture_end``):

1. **side effects at capture** — a call in the region to a host effect
   (``print``, ``time.*``, ``logging`` / ``logger.*``, the ``obs``
   producers ``inc`` / ``event`` / ``span`` / ``observe_scalar``,
   ``open``), or a call of a def (resolved through the call graph, and
   for attribute hops like ``keeper.on_window`` by the JAX rule's tiered
   unique-name fallback) whose body makes one, is a finding at the call
   site; an unresolvable hop that several modules define is itself a
   finding (the contract cannot attach);
2. **buffers fed at capture** — an ``append`` / ``extend`` /
   ``appendleft`` (or ``+= [..]``) to a closure or module-level name, in
   the region or in a def it calls, is a finding at that line: it grows
   once at capture and never on replay (state owned by ``self`` is
   exempt, as in the JAX rule: keeping the static outputs on the runner
   is what a capture is for).

Unresolvable targets are skipped: rules err toward silence on edges they
cannot prove.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import (DefNode, ModuleInfo,
                                             ProjectIndex, free_names)
from tpu_sgd_torch.analysis.tracing import dotted_name, last_seg

#: canonical module prefixes / names whose calls are host side effects
EFFECT_PREFIXES = ("time.", "logging.", "tpu_sgd_torch.obs.")
EFFECT_BUILTINS = {"print", "open", "input"}
EFFECT_OBS = {"inc", "event", "span", "observe_scalar", "record_wire"}
GROWERS = ("append", "extend", "appendleft")
#: names bound to loggers (``logger.info(...)``)
LOGGER_NAMES = {"logger", "log", "LOG", "_log", "_logger"}


def _effect_call(mi: ModuleInfo, call: ast.Call) -> Optional[str]:
    """The host side effect ``call`` makes directly, or None."""
    func = call.func
    name = dotted_name(func)
    if isinstance(func, ast.Name) and func.id in EFFECT_BUILTINS \
            and func.id not in mi.defs_by_name:
        return func.id
    canon = mi.canonical(func)
    if canon is not None and canon.startswith(EFFECT_PREFIXES):
        if not canon.startswith("tpu_sgd_torch.obs.") \
                or last_seg(canon) in EFFECT_OBS:
            return name
    if name is not None and name.split(".")[0] in LOGGER_NAMES:
        return name
    return None


def _grows(node: ast.AST, free: Set[str]) -> Optional[str]:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in GROWERS \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id in free:
        return node.func.value.id
    if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name) \
            and node.target.id in free \
            and isinstance(node.value, (ast.List, ast.ListComp)):
        return node.target.id
    return None


class CallbackDisciplineRule(Rule):
    name = "callback-discipline"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and mi.traced.in_capture(node):
                    yield from self._check_site(mod, mi, project, node)
                elif mi.traced.in_capture(node):
                    name = _grows(node, self._outer_names(mi, node))
                    if name is not None:
                        yield self._grow_finding(mod.relpath, node, name,
                                                 "the capture region")

    @staticmethod
    def _outer_names(mi: ModuleInfo, node: ast.AST) -> Set[str]:
        """Names ``node``'s function reads but does not bind: closure
        and module-level names."""
        fn = node
        while fn is not None and not isinstance(fn, DefNode):
            fn = mi.parents.get(fn)
        if fn is None:
            return set(mi.module_names)
        return free_names(fn)

    @staticmethod
    def _grow_finding(relpath: str, node: ast.AST, name: str,
                      where: str) -> Finding:
        return Finding(
            "callback-discipline", relpath, node.lineno, node.col_offset,
            f"{where} appends to closure variable `{name}`: the append "
            "runs once at capture and never on replay, so the buffer "
            "misses every replayed step; keep host bookkeeping outside "
            "the capture (read the static outputs after each replay)")

    # -- per-site checks -----------------------------------------------------
    def _check_site(self, mod: ModuleFile, mi: ModuleInfo,
                    project: ProjectIndex,
                    call: ast.Call) -> Iterable[Finding]:
        effect = _effect_call(mi, call)
        if effect is not None:
            yield Finding(
                self.name, mod.relpath, call.lineno, call.col_offset,
                f"host call `{effect}` inside a capture region runs once "
                "at capture and never on replay; move it outside the "
                "capture (after the replay that it should observe)")
            return
        targets, ambiguous = self._resolve_target(mi, project, call)
        for name in ambiguous:
            yield Finding(
                self.name, mod.relpath, call.lineno, call.col_offset,
                f"captured call `{name}` matches several defs across "
                "the lint set and none in this module, so the capture "
                "contract check cannot attach to this site; rename the "
                "target or bind it to a resolvable def — an ambiguity "
                "silently voiding a checked contract is itself the hazard")
        for tmi, d in targets:
            free = free_names(d)
            effect = self._def_effect(tmi, d) or next(
                (f"{name}.append" for name in (_grows(n, free)
                                               for n in ast.walk(d))
                 if name is not None), None)
            if effect is not None:
                yield Finding(
                    self.name, mod.relpath, call.lineno, call.col_offset,
                    f"captured call to `{getattr(d, 'name', '?')}` makes "
                    f"the host side effect `{effect}`: it runs once at "
                    "capture and never on replay; keep the effect outside "
                    "the capture")
            for n in ast.walk(d):
                name = _grows(n, free)
                if name is not None:
                    yield self._grow_finding(
                        tmi.mod.relpath, n, name,
                        f"captured def `{getattr(d, 'name', '?')}`")

    @staticmethod
    def _def_effect(tmi: ModuleInfo, d: ast.AST) -> Optional[str]:
        for n in ast.walk(d):
            if isinstance(n, ast.Call):
                effect = _effect_call(tmi, n)
                if effect is not None:
                    return effect
        return None

    # -- target resolution ---------------------------------------------------
    @staticmethod
    def _unique_def(project: ProjectIndex, name: str,
                    near: Optional[ModuleInfo] = None
                    ) -> Tuple[List[Tuple[ModuleInfo, ast.AST]], bool]:
        """Bare-name resolution for the attribute hops the call graph
        cannot type (``keeper.on_window``): a unique def in the call
        site's own module wins, else a unique def project-wide.  Returns
        ``(hits, ambiguous)``."""
        if near is not None:
            local = [(near, d) for d in near.defs_by_name.get(name, ())]
            if len(local) == 1:
                return local, False
        hits: List[Tuple[ModuleInfo, ast.AST]] = []
        for info in project.infos.values():
            for d in info.defs_by_name.get(name, ()):
                hits.append((info, d))
        if len(hits) == 1:
            return hits, False
        return [], len(hits) > 1

    def _resolve_target(self, mi: ModuleInfo, project: ProjectIndex,
                        call: ast.Call
                        ) -> Tuple[List[Tuple[ModuleInfo, ast.AST]],
                                   List[str]]:
        ambiguous: List[str] = []
        func = call.func
        resolved = project.resolve_name(mi, func)
        if not resolved and isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id not in mi.prefixes \
                and func.value.id not in mi.np_prefixes:
            # `keeper.on_window(...)`: an object hop the import machinery
            # cannot follow — tiered-name fallback
            resolved, amb = self._unique_def(project, func.attr, near=mi)
            if amb:
                ambiguous.append(func.attr)
        return resolved, ambiguous
