"""host-sync: no device→host read inside a host loop's hot body — the
port of ``tpu_sgd/analysis/rules_sync.py``.

The port's drivers keep the card's launch queue full: the host queues
kernels (and CUDA-graph replays) ahead of the card and touches results
only at cadence boundaries.  One ``.item()`` / ``.tolist()`` / ``.cpu()``
/ ``.numpy()`` / ``float()`` / ``int()`` / ``bool()`` — or an implicit
truth test in an ``if``/``while`` — on a card tensor waits for the card
to drain and copies the value back, every iteration, turning the queued
loop back into lockstep.  ``torch.cuda.synchronize()`` and a CUDA event's
or stream's ``.synchronize()`` read nothing but stall identically, so
they count.

The rule fires when, inside a ``for``/``while`` statement body that is
NOT in a capture region or a traced function (a host loop, not a loop
unrolled into a graph at capture), such a read is applied to a **card
value** — a local name bound to a card tensor (see
:class:`~tpu_sgd_torch.analysis.dataflow.ProjectIndex`: the result of a
kernel wrapper, a compiled callable, ``.cuda()`` / ``.to(device)``, a
factory given ``device=``, a captured graph's static tensors, and torch
ops over those).  A ``torch.cuda.synchronize()`` fires in a host loop of
a function that holds card values.  It is interprocedural through the
sync summaries: a helper that reads internally is flagged at its
loop-borne call site, because that is the line that pays.

What does NOT fire, by design (the JAX rule's exemptions):

* reads of values the rule cannot prove on the card (host numpy through
  ``np.asarray`` is free) — silence over wolf-crying;
* the bulk fetch at a loop boundary, ``tuple(t.cpu() for t in ys)``: the
  generator variable is not itself a tracked name;
* reads outside any loop (a run-end fetch is the contract, not a bug).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule
from tpu_sgd_torch.analysis.dataflow import (DefNode, ModuleInfo,
                                             ProjectIndex, card_reads,
                                             func_params, scope_nodes)
from tpu_sgd_torch.analysis.tracing import FuncNode

#: host loop statements; comprehensions are deliberately excluded (the
#: bulk-fetch-at-the-boundary idiom is a genexp and is sanctioned)
LOOP_KINDS = (ast.For, ast.While)


def _enclosing_host_loop(node: ast.AST, parents,
                         fn: ast.AST) -> Optional[ast.AST]:
    """The nearest for/while whose PER-TRIP region contains ``node``.

    Per-trip means the loop's body (and, for ``while``, its test, which
    re-evaluates every trip).  A ``for``'s iterable and either loop's
    ``else`` clause evaluate exactly once, so a sync there belongs to
    the next loop out (if any) — ``for i in range(int(n_dev)):`` is the
    sanctioned one-fetch-then-iterate spelling, not a per-trip sync."""
    child: ast.AST = node
    cur = parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.For):
            if child in cur.body:
                return cur
        elif isinstance(cur, ast.While):
            if child in cur.body or child is cur.test:
                return cur
        elif isinstance(cur, FuncNode):
            return None  # nested def: runs when called, not per trip
        child, cur = cur, parents.get(cur)
    return None


class HostSyncRule(Rule):
    name = "host-sync"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            for node in ast.walk(mod.tree):
                if isinstance(node, DefNode):
                    yield from self._check_function(mod, mi, project, node)

    def _check_function(self, mod: ModuleFile, mi: ModuleInfo,
                        project: ProjectIndex,
                        fn: ast.AST) -> Iterable[Finding]:
        if project.is_traced(mod, fn):
            return  # a captured body's "loop" unrolls into the graph
        jitted = project.jitted_value_names(mi, fn)
        dev = project.device_value_names(mi, fn, jitted)
        if not dev:
            return
        # bool tests use the PURE subset: the name tracking is flow-
        # insensitive, and the idiomatic `c = int(c)` scalar rebind
        # followed by `if c > 0:` must not re-flag the (already
        # sync-checked) fetch as a second implicit-bool sync
        pure = dev - self._host_rebound(mi, project, fn, dev, jitted)
        parents = mi.parents
        for n in scope_nodes(fn):
            if isinstance(n, ast.While):
                # the while's own test re-evaluates every trip: it IS
                # the loop, whether or not another loop encloses it
                yield from self._check_bool_test(mod, pure, n)
                continue
            loop = _enclosing_host_loop(n, parents, fn)
            if loop is None or project.in_capture(mod, n):
                continue
            if isinstance(n, ast.Call):
                yield from self._check_call(mod, mi, project, fn, dev, n)
            elif isinstance(n, ast.If):
                yield from self._check_bool_test(mod, pure, n)

    def _check_call(self, mod: ModuleFile, mi: ModuleInfo,
                    project: ProjectIndex, fn: ast.AST, dev: Set[str],
                    call: ast.Call) -> Iterable[Finding]:
        kind = project.sync_op_kind(mi, call)
        if kind is not None:
            arg = project._sync_arg_expr(mi, call)
            if arg is None:  # torch.cuda.synchronize(): the whole card
                yield Finding(
                    self.name, mod.relpath, call.lineno, call.col_offset,
                    f"`{kind}` inside a host loop body waits for the "
                    "whole card every iteration, stalling the launch "
                    "queue; wait once after the loop, or on one event at "
                    "a cadence boundary")
                return
            touched = card_reads(arg) & dev
            if touched:
                name = sorted(touched)[0]
                yield Finding(
                    self.name, mod.relpath, call.lineno, call.col_offset,
                    f"`{kind}` on device value `{name}` inside a host "
                    "loop body forces a device->host sync every "
                    "iteration, stalling the launch queue; fetch once "
                    "after the loop, or keep the loop on the card (a "
                    "captured block, the flag read at a cadence "
                    "boundary)")
            return
        # interprocedural: a helper whose summary says parameter j flows
        # into a sync, called with a device value at position j
        for tmi, d in project.resolve_call(mi, call):
            syncing = project.syncing_params(d)
            if not syncing:
                continue
            params = func_params(d)
            for j in syncing:
                if j >= len(call.args):
                    continue
                touched = card_reads(call.args[j]) & dev
                if touched:
                    pname = params[j] if j < len(params) else f"#{j}"
                    yield Finding(
                        self.name, mod.relpath, call.lineno,
                        call.col_offset,
                        f"call to `{getattr(d, 'name', '?')}` forces a "
                        f"device->host sync on its parameter "
                        f"`{pname}` (receiving device value "
                        f"`{sorted(touched)[0]}`) inside a host loop "
                        "body; hoist the sync out of the loop or keep "
                        "the value on device")
                    break  # one finding per call site is enough

    @staticmethod
    def _host_rebound(mi: ModuleInfo, project: ProjectIndex, fn: ast.AST,
                      dev: Set[str], jitted: Set[str]) -> Set[str]:
        """Device names that are ALSO assigned a non-device value
        somewhere in ``fn`` (``c = int(c)``): ambiguous under the
        flow-insensitive tracking, so implicit-bool checks skip them."""
        out: Set[str] = set()
        for n in scope_nodes(fn):
            if not isinstance(n, ast.Assign):
                continue
            if project._device_expr(mi, fn, n.value, dev, jitted):
                continue
            for t in n.targets:
                names = [t] if isinstance(t, ast.Name) else (
                    [e for e in t.elts if isinstance(e, ast.Name)]
                    if isinstance(t, (ast.Tuple, ast.List)) else [])
                for e in names:
                    if e.id in dev:
                        out.add(e.id)
        return out

    @staticmethod
    def _test_names(test: ast.AST) -> List[str]:
        """Names whose truth/comparison drives a bool test: bare names,
        ``not x``, ``and``/``or`` arms, and comparison operands (``if
        c > 0:`` on a card tensor builds a card bool then coerces it
        — the same per-trip sync with one more hop)."""
        out: List[str] = []
        if isinstance(test, ast.Name):
            out.append(test.id)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            out.extend(HostSyncRule._test_names(test.operand))
        elif isinstance(test, ast.BoolOp):
            for v in test.values:
                out.extend(HostSyncRule._test_names(v))
        elif isinstance(test, ast.Compare):
            for side in [test.left] + list(test.comparators):
                if isinstance(side, ast.Name):
                    out.append(side.id)
        return out

    def _check_bool_test(self, mod: ModuleFile, dev: Set[str],
                         stmt: ast.AST) -> Iterable[Finding]:
        """``if device_val:`` / ``while device_val > 0:`` — the implicit
        ``bool()`` coercion is a sync with no visible call."""
        test = stmt.test
        for nm in dict.fromkeys(self._test_names(test)):
            if nm in dev:
                yield Finding(
                    self.name, mod.relpath, test.lineno, test.col_offset,
                    f"truth-testing device value `{nm}` inside a host "
                    "loop body is an implicit bool() device->host sync "
                    "every iteration; compare on device and fetch the "
                    "flag at a cadence boundary instead")


#: the observability layer's record producers: a ``span()`` attr, an
#: ``event()`` attr, an ``inc()`` count, or an ``observe_scalar()``
#: time-series value that receives a CARD value serializes it
#: (json.dumps / arithmetic on the payload), forcing a device->host read
#: at the record site — observability causing the stall it exists to
#: observe.
_OBS_MODULES = {"tpu_sgd_torch.obs", "tpu_sgd_torch.obs.spans",
                "tpu_sgd_torch.obs.counters", "tpu_sgd_torch.obs.timeseries"}
_OBS_FUNCS = {"span", "event", "inc", "observe_scalar", "observe"}


class ObsDisciplineRule(Rule):
    """obs-discipline: span/event/inc arguments must be host values.

    Rides the host-sync rule's dataflow machinery (the same
    ``ProjectIndex`` card-value tracking), but fires ANYWHERE in a
    function, loop or not: the record is serialized when it is emitted,
    so a card-valued attribute is a sync wherever the call sits.  The
    sanctioned spelling is to fetch once at the documented boundary
    (``loss = float(losses[i])`` once a block) and pass the host
    scalar.
    """

    name = "obs-discipline"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        project: ProjectIndex = options["project"]
        for mod in modules:
            if mod.tree is None:
                continue
            mi = project.info(mod)
            direct, mod_aliases = self._obs_names(mi)
            if not direct and not mod_aliases:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, DefNode):
                    yield from self._check_function(
                        mod, mi, project, node, direct, mod_aliases)

    @staticmethod
    def _obs_names(mi: ModuleInfo):
        """Resolve this module's spellings of the obs producers:
        ``direct`` maps a bare callable name (aliasing honored —
        ``from tpu_sgd_torch.obs.counters import inc as obs_inc``) to its
        canonical obs function; ``mod_aliases`` maps a module alias
        (``from tpu_sgd_torch.obs import spans`` / ``import
        tpu_sgd_torch.obs.spans as sp``) for attribute-form calls."""
        direct = {}
        mod_aliases = set()
        for alias, (dotted, orig) in mi.imports_from.items():
            if dotted in _OBS_MODULES and orig in _OBS_FUNCS:
                direct[alias] = orig
            elif f"{dotted}.{orig}" in _OBS_MODULES:
                mod_aliases.add(alias)
        for alias, dotted in mi.import_mods.items():
            if dotted in _OBS_MODULES:
                mod_aliases.add(alias)
        return direct, mod_aliases

    def _record_call(self, call: ast.Call, direct, mod_aliases):
        """The canonical obs function this call invokes, or None."""
        f = call.func
        if isinstance(f, ast.Name):
            return direct.get(f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id in mod_aliases and f.attr in _OBS_FUNCS:
                return f.attr
        return None

    def _check_function(self, mod: ModuleFile, mi: ModuleInfo,
                        project: ProjectIndex, fn: ast.AST,
                        direct, mod_aliases) -> Iterable[Finding]:
        jitted = project.jitted_value_names(mi, fn)
        dev = project.device_value_names(mi, fn, jitted)
        if not dev:
            return
        # names bound to an open span (`with span(...) as sp:` /
        # `sp = span(...)`): their `.set(...)` attrs are record
        # arguments too
        span_names: Set[str] = set()
        for n in scope_nodes(fn):
            if isinstance(n, ast.withitem) \
                    and isinstance(n.context_expr, ast.Call) \
                    and self._record_call(n.context_expr, direct,
                                          mod_aliases) == "span" \
                    and isinstance(n.optional_vars, ast.Name):
                span_names.add(n.optional_vars.id)
            elif isinstance(n, ast.Assign) \
                    and isinstance(n.value, ast.Call) \
                    and self._record_call(n.value, direct,
                                          mod_aliases) == "span":
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        span_names.add(t.id)
        for n in scope_nodes(fn):
            if not isinstance(n, ast.Call):
                continue
            kind = self._record_call(n, direct, mod_aliases)
            if kind is None and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "set" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id in span_names:
                kind = "span.set"
            if kind is None:
                continue
            for expr in list(n.args) + [kw.value for kw in n.keywords]:
                touched = card_reads(expr) & dev
                if touched:
                    name = sorted(touched)[0]
                    yield Finding(
                        self.name, mod.relpath, n.lineno, n.col_offset,
                        f"`{kind}(...)` records device value `{name}`: "
                        "serializing the payload forces a device->host "
                        "sync at the record site — observability "
                        "causing the stall it exists to observe.  "
                        "Fetch once at the documented boundary "
                        "(`x_host = float(x)` / the bulk `.cpu()` "
                        "fetch) and record the host scalar")
                    break  # one finding per record call is enough
