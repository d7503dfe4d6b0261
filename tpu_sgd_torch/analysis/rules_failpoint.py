"""failpoint-coverage: every declared hook site must exist in code (the
port of ``tpu_sgd/analysis/rules_failpoint.py``).

``tpu_sgd_torch/reliability/failpoints.py`` carries the authoritative
``HOOK_SITES`` table — hook-site name -> the module that must compile
it in.  The hooks were threaded into the real hot paths by hand; this
rule makes the wiring load-bearing: delete a ``failpoint("...")`` call
(or move the code it lived in) and **lint** fails, instead of the chaos
soak silently losing a fault-injection site and reporting green on a
path it no longer exercises.

Checked in both directions:

* every ``HOOK_SITES`` entry's declared module must contain a literal
  ``failpoint("<name>")`` call (anchored at the registry entry, so the
  finding points at the declaration that went stale — the message names
  any *other* module where the call actually turned up);
* every ``failpoint("<name>")`` call in linted code must be registered
  in ``HOOK_SITES`` (an unregistered site is invisible to the chaos
  soak's all-sites sweep, i.e. fault-injection coverage silently
  shrank).

The registry is read from the AST of the registry module (configurable
via ``failpoint-registry`` in ``[tool.graftlint]``) — never imported,
so lint stays side-effect-free.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.tracing import dotted_name, last_seg

REGISTRY_NAME = "HOOK_SITES"


def extract_registry(tree: ast.Module) -> Optional[Dict[str, Tuple[str, int]]]:
    """``{site: (declared_module_relpath, declaration_line)}`` from the
    registry module's ``HOOK_SITES`` literal, or None when absent."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == REGISTRY_NAME
                   for t in node.targets):
            continue
        if not isinstance(node.value, ast.Dict):
            return None
        out: Dict[str, Tuple[str, int]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                return None
            out[k.value] = (v.value, k.lineno)
        return out
    return None


#: the hook-entry spellings this rule recognizes: the plain raising
#: hook and the payload-carrying corrupting hook — both are
#: HOOK_SITES citizens, so deleting either kind of call fails lint
HOOK_FUNCS = ("failpoint", "corruptpoint")


def failpoint_calls(mod: ModuleFile) -> Iterable[Tuple[str, ast.Call]]:
    """Literal ``failpoint("name")`` / ``corruptpoint("name", ...)``
    calls in ``mod`` (any dotted spelling whose last segment is a
    :data:`HOOK_FUNCS` entry)."""
    if mod.tree is None:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if last_seg(dotted_name(node.func)) not in HOOK_FUNCS:
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value, node


class FailpointCoverageRule(Rule):
    name = "failpoint-coverage"

    def __init__(self, registry: Optional[Dict[str, str]] = None,
                 registry_path: Optional[str] = None):
        #: test override: a literal {site: module_relpath} map
        self._registry_override = registry
        self._registry_path_override = registry_path

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        reg_path = self._registry_path_override or options.get(
            "failpoint_registry", "tpu_sgd_torch/reliability/failpoints.py")
        reg_path = reg_path.replace(os.sep, "/")
        by_rel = {m.relpath: m for m in modules}

        if self._registry_override is not None:
            registry = {k: (v, 1) for k, v in
                        self._registry_override.items()}
            anchor = reg_path
        else:
            reg_mod = by_rel.get(reg_path)
            if reg_mod is None:
                cfg = options.get("config")
                root = getattr(cfg, "root", os.getcwd())
                full = os.path.join(root, reg_path)
                if not os.path.exists(full):
                    yield Finding(
                        self.name, reg_path, 1, 0,
                        f"failpoint registry module {reg_path!r} not "
                        "found; set failpoint-registry in "
                        "[tool.graftlint]")
                    return
                with open(full, encoding="utf-8") as f:
                    reg_mod = ModuleFile(full, reg_path, f.read())
            if reg_mod.tree is None:
                return  # parse-error finding comes from the runner
            registry = extract_registry(reg_mod.tree)
            anchor = reg_path
            if registry is None:
                yield Finding(
                    self.name, reg_path, 1, 0,
                    f"{REGISTRY_NAME} must be a literal "
                    "{'site.name': 'path/to/module.py'} dict in the "
                    "registry module")
                return

        # where does each site actually appear?
        sites_in: Dict[str, list] = {}
        for mod in modules:
            for site, call in failpoint_calls(mod):
                sites_in.setdefault(site, []).append((mod.relpath, call))

        # declared -> present in the declared module.  When a SUBSET of
        # files is linted (single-file CLI mode, fixture runs) a
        # declared module may be absent from `modules`; fall back to
        # parsing it from disk so a clean file never fails lint for
        # hooks that live elsewhere — a module findable nowhere is
        # still a finding (registry drift).
        cfg = options.get("config")
        root = getattr(cfg, "root", os.getcwd())
        disk_cache: Dict[str, Optional[ModuleFile]] = {}

        def _declared_module(rel: str) -> Optional[ModuleFile]:
            if rel in by_rel:
                return by_rel[rel]
            if rel not in disk_cache:
                full = os.path.join(root, rel)
                if os.path.exists(full):
                    with open(full, encoding="utf-8") as f:
                        disk_cache[rel] = ModuleFile(full, rel, f.read())
                else:
                    disk_cache[rel] = None
            return disk_cache[rel]

        for site, (declared_mod, line) in registry.items():
            declared_mod = declared_mod.replace(os.sep, "/")
            hits = sites_in.get(site, [])
            if any(rel == declared_mod for rel, _ in hits):
                continue
            target = _declared_module(declared_mod)
            if target is not None and target.relpath not in by_rel:
                # not part of this lint run: check the on-disk copy
                if any(s == site for s, _ in failpoint_calls(target)):
                    continue
            if target is None:
                yield Finding(
                    self.name, anchor, line, 0,
                    f"hook site {site!r} declares module "
                    f"{declared_mod!r}, which does not exist")
                continue
            elsewhere = sorted({rel for rel, _ in hits})
            where = (f"; the call now lives in {', '.join(elsewhere)} — "
                     "update the registry" if elsewhere else
                     "; the hook was deleted or never wired — chaos "
                     "coverage for this site is gone")
            yield Finding(
                self.name, anchor, line, 0,
                f"hook site {site!r} is declared in {REGISTRY_NAME} but "
                f"no failpoint({site!r}) call exists in "
                f"{declared_mod}{where}")

        # present -> registered (skip the registry module itself: its
        # docstring example and the failpoint() def are not hook sites)
        for site, hits in sites_in.items():
            if site in registry:
                continue
            for rel, call in hits:
                if rel == reg_path:
                    continue
                yield Finding(
                    self.name, rel, call.lineno, call.col_offset,
                    f"failpoint site {site!r} is not registered in "
                    f"{REGISTRY_NAME} ({reg_path}); unregistered sites "
                    "are invisible to the chaos soak's coverage sweep")
