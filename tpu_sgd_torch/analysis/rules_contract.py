"""contract-drift: every observability name a gate consumes must still
be emitted somewhere — in the project index, not in somebody's memory
(the port of ``tpu_sgd/analysis/rules_contract.py``).

The ``HOOK_SITES`` idea (``rules_failpoint``) generalized.  Three
consumer surfaces reference counters / series / spans BY STRING:

* detector defaults (``obs.detect`` — ``series=``/``prefix=`` init
  defaults and the ``_series``/``_count`` window accessors),
* SLO documents (the scenario harnesses' ``build_slos`` and
  ``build_tenant_slos``, the JAX package's ``chaos_soak.DEFAULT_SLOS``:
  dicts with ``"metric"`` + ``"counter"``/``"span"``/``"rule"``
  fields),
* bench gates (a module-level ``GATES`` table of ``Gate(...)`` calls,
  ``/``-separated JSON paths into committed ``BENCH_*.json`` baselines:
  the JAX package's ``scripts/bench_gate.py``; the port has no such
  table yet, and the half stays so that both packages' rule agrees).

None of them fail when the emitting side is renamed: the detector goes
silent, the SLO reads 0-of-absent-counter and PASSES its ``max`` bound,
the gate raises at bench time but not at lint time.  A renamed counter
that silently greens an SLO gate is exactly the drift class the lock
declarations already fail loudly — this rule gives the obs contract the
same property, both directions: rename the emit and the consumer stops
resolving; rename the consumer and it stops resolving too.

Emit index (string-literal first args, so AST-only like every rule):

* exact names — ``inc``/``obs_inc``/``event``/``obs_event``/``span``/
  ``observe_scalar`` calls with a ``Constant`` first arg;
* prefixes — the same calls with an f-string first arg take the
  leading literal (``inc(f"tenant.{kind}")`` emits prefix
  ``tenant.``);
* fan-out tables — ``SPAN_FANOUT``/``EVENT_FANOUT`` keys emit
  ``<key>[`` (per-actor sub-series), ``EVENT_VALUES`` entries emit
  ``<key>.<attr>`` (value series);
* subsystem tagging — ``inc(_tagged("dispatch"))`` (the
  ``obs.counters`` idiom: subsystem prefix resolved at runtime) emits
  the SUFFIX ``.dispatch`` under any subsystem.

A consumed EXACT name resolves against an exact emit or any emit
prefix that covers it; a consumed PREFIX (trailing ``.`` / ``[``, or
any ``prefix``-named init default) resolves when some emit falls under
it.  ``"rule"`` SLO fields resolve against ``rule = "..."`` detector
class attributes.  Gate paths resolve by walking the committed
baseline JSON under the project root — a missing baseline or a dangling
path segment is a finding at the ``Gate(...)`` line.

Known blind spot, on purpose: names built entirely from variables
(no literal prefix) are invisible; every surface this rule guards uses
literal or literal-prefixed names today, and a new dynamic name should
get a reasoned suppression at the consumer, not silence.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Iterable, Optional, Sequence, Set, Tuple

from tpu_sgd_torch.analysis.core import Finding, ModuleFile, Rule

#: call names (last dotted segment) whose first string arg IS an
#: emitted counter / series / span name
EMIT_FUNCS = ("inc", "obs_inc", "event", "obs_event", "span",
              "observe_scalar")

#: init-parameter names whose string default is a consumed series name;
#: the ``prefix``-ish ones consume a namespace, not one series
CONSUMER_PARAMS = ("series", "prefix", "membership_prefix",
                   "roster_prefix")
PREFIX_PARAMS = ("prefix", "membership_prefix", "roster_prefix")

#: window accessors whose name arg is a consumed series
WINDOW_ACCESSORS = ("_series", "_count")

_GATE_SEG = re.compile(r"^(?P<key>[^\[\]]*)(?P<idx>(\[\d+\])*)$")


def _str_arg(node: ast.Call) -> Optional[Tuple[str, bool]]:
    """First-arg name literal -> ``(text, is_prefix)``; None when the
    first arg carries no leading literal at all."""
    if not node.args:
        return None
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr) and a.values:
        head = a.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value, True
    return None


def _last_seg(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _EmitIndex:
    """Every name the linted modules can emit, exact + prefix."""

    def __init__(self, modules: Sequence[ModuleFile]):
        self.exact: Set[str] = set()
        self.prefixes: Set[str] = set()
        self.suffixes: Set[str] = set()  # _tagged("x") -> ".x"
        self.rules: Set[str] = set()  # Detector.rule class attrs
        for mod in modules:
            if mod.tree is None:
                continue
            for n in ast.walk(mod.tree):
                if isinstance(n, ast.Call):
                    self._index_call(n)
                elif isinstance(n, ast.ClassDef):
                    self._index_class(n)
                elif isinstance(n, ast.Assign):
                    self._index_fanout(n)

    def _index_call(self, n: ast.Call) -> None:
        if _last_seg(n.func) not in EMIT_FUNCS:
            return
        got = _str_arg(n)
        if got is not None:
            text, is_prefix = got
            (self.prefixes if is_prefix else self.exact).add(text)
            return
        if (n.args and isinstance(n.args[0], ast.Call)
                and _last_seg(n.args[0].func) == "_tagged"
                and n.args[0].args
                and isinstance(n.args[0].args[0], ast.Constant)
                and isinstance(n.args[0].args[0].value, str)):
            self.suffixes.add("." + n.args[0].args[0].value)

    def _index_class(self, n: ast.ClassDef) -> None:
        for stmt in n.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "rule"
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)):
                self.rules.add(stmt.value.value)

    def _index_fanout(self, n: ast.Assign) -> None:
        """``SPAN_FANOUT``/``EVENT_FANOUT`` keys emit ``key[``;
        ``EVENT_VALUES`` entries emit ``key.attr`` value series."""
        if len(n.targets) != 1 or not isinstance(n.targets[0], ast.Name):
            return
        name = n.targets[0].id
        if not isinstance(n.value, ast.Dict):
            return
        if name in ("SPAN_FANOUT", "EVENT_FANOUT"):
            for k in n.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    self.prefixes.add(k.value + "[")
                    if name == "EVENT_FANOUT":
                        # error-twin convention: <name>.error[actor]
                        self.prefixes.add(k.value + ".error[")
        elif name == "EVENT_VALUES":
            for k, v in zip(n.value.keys, n.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                for attr in ast.walk(v):
                    if (isinstance(attr, ast.Constant)
                            and isinstance(attr.value, str)):
                        self.exact.add(f"{k.value}.{attr.value}")

    def resolves(self, name: str, is_prefix: bool) -> bool:
        if is_prefix:
            return (any(e.startswith(name) for e in self.exact)
                    or any(p.startswith(name) or name.startswith(p)
                           for p in self.prefixes))
        return (name in self.exact
                or any(name.startswith(p) for p in self.prefixes)
                or any(name.endswith(s) for s in self.suffixes))


class ContractDriftRule(Rule):
    name = "contract-drift"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        emits = _EmitIndex(modules)
        cfg = options.get("config")
        root = getattr(cfg, "root", None)
        for mod in modules:
            if mod.tree is None:
                continue
            yield from self._detector_consumers(mod, emits)
            yield from self._slo_consumers(mod, emits)
            yield from self._gate_consumers(mod, root)

    # -- detector defaults + window accessors --------------------------------
    def _detector_consumers(self, mod: ModuleFile,
                            emits: _EmitIndex) -> Iterable[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            # only classes that declare a rule id — the Detector shape
            if not any(isinstance(s, ast.Assign)
                       and isinstance(s.targets[0], ast.Name)
                       and s.targets[0].id == "rule"
                       for s in cls.body if isinstance(s, ast.Assign)):
                continue
            for n in ast.walk(cls):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and n.name == "__init__":
                    yield from self._init_defaults(mod, n, emits)
                elif isinstance(n, ast.Call) \
                        and _last_seg(n.func) in WINDOW_ACCESSORS:
                    yield from self._accessor_arg(mod, n, emits)

    def _init_defaults(self, mod, init, emits) -> Iterable[Finding]:
        args = init.args
        pos = args.args[-len(args.defaults):] if args.defaults else []
        pairs = list(zip(pos, args.defaults)) + \
            list(zip(args.kwonlyargs, args.kw_defaults))
        for arg, default in pairs:
            if default is None or arg.arg not in CONSUMER_PARAMS:
                continue
            if not (isinstance(default, ast.Constant)
                    and isinstance(default.value, str)):
                continue
            text = default.value
            is_prefix = (arg.arg in PREFIX_PARAMS
                         or text.endswith((".", "[")))
            if not emits.resolves(text, is_prefix):
                kind = "namespace" if is_prefix else "series"
                yield Finding(
                    self.name, mod.relpath, default.lineno,
                    default.col_offset,
                    f"detector default {arg.arg}={text!r} matches no "
                    f"emitted {kind} in the linted modules — a renamed "
                    "emit site leaves this detector permanently silent; "
                    "rename both sides together")

    def _accessor_arg(self, mod, call, emits) -> Iterable[Finding]:
        got = None
        for a in call.args:  # the name arg is the str one, any position
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                got = (a, a.value, False)
            elif isinstance(a, ast.JoinedStr) and a.values \
                    and isinstance(a.values[0], ast.Constant) \
                    and isinstance(a.values[0].value, str):
                got = (a, a.values[0].value, True)
        if got is None:
            return
        node, text, is_prefix = got
        if "." not in text:
            return  # not a dotted series name
        if not emits.resolves(text, is_prefix):
            yield Finding(
                self.name, mod.relpath, node.lineno, node.col_offset,
                f"window lookup of {text!r} matches no emitted series "
                "in the linted modules — the detector reads a series "
                "nobody writes; rename both sides together")

    # -- SLO documents -------------------------------------------------------
    def _slo_consumers(self, mod: ModuleFile,
                       emits: _EmitIndex) -> Iterable[Finding]:
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Dict):
                continue
            keys = {k.value: v for k, v in zip(n.keys, n.values)
                    if isinstance(k, ast.Constant)}
            if "metric" not in keys or "name" not in keys:
                continue  # not an SLO entry
            for field, pool, what in (
                    ("counter", None, "counter"),
                    ("span", None, "span"),
                    ("rule", emits.rules, "detector rule")):
                v = keys.get(field)
                if not (isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    continue
                text = v.value
                ok = (text in pool if pool is not None
                      else emits.resolves(text, False))
                if not ok:
                    yield Finding(
                        self.name, mod.relpath, v.lineno, v.col_offset,
                        f"SLO {field} {text!r} matches no {what} in the "
                        "linted modules — the gate would evaluate an "
                        "absent name (0 of nothing passes a max-bound "
                        "silently); rename both sides together")

    # -- bench gates ---------------------------------------------------------
    def _gate_consumers(self, mod: ModuleFile,
                        root: Optional[str]) -> Iterable[Finding]:
        gates = None
        for n in mod.tree.body:
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id == "GATES"
                    and isinstance(n.value, ast.Dict)):
                gates = n.value
        if gates is None:
            return
        for k, v in zip(gates.keys, gates.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            baseline = self._load_baseline(k.value, root)
            for call in ast.walk(v):
                if not (isinstance(call, ast.Call)
                        and _last_seg(call.func) == "Gate"
                        and call.args
                        and isinstance(call.args[0], ast.Constant)
                        and isinstance(call.args[0].value, str)):
                    continue
                path = call.args[0].value
                if baseline is None:
                    yield Finding(
                        self.name, mod.relpath, k.lineno, k.col_offset,
                        f"gate baseline {k.value!r} is missing or "
                        "unreadable under the project root — every "
                        "gate path under it is unverifiable")
                    break
                missing = self._lookup(baseline, path)
                if missing is not None:
                    yield Finding(
                        self.name, mod.relpath, call.args[0].lineno,
                        call.args[0].col_offset,
                        f"gate path {path!r} dangles in {k.value}: "
                        f"missing segment {missing!r} — a renamed bench "
                        "key fails at bench time, not lint time; rename "
                        "both sides together")

    @staticmethod
    def _load_baseline(fname: str, root: Optional[str]):
        if root is None:
            return None
        p = os.path.join(root, fname)
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def _lookup(doc, path: str) -> Optional[str]:
        """Walk a ``a/b[3]/c`` path; the failing segment, None if ok."""
        cur = doc
        for seg in path.split("/"):
            m = _GATE_SEG.match(seg)
            if m is None:
                return seg
            key = m.group("key")
            try:
                if key:
                    cur = cur[key]
                for idx in re.findall(r"\[(\d+)\]", m.group("idx")):
                    cur = cur[int(idx)]
            except (KeyError, IndexError, TypeError):
                return seg
        return None
