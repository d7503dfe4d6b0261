"""graftlint core (the port of ``tpu_sgd/analysis/core.py``): findings,
suppressions, config, and the rule runner.

graftlint turns the port's tribal invariants — no host read of a card
tensor in a hot loop, complete keys on cached CUDA graphs and built
libraries, no per-shape or per-iteration captures, no capture that bakes
in a changing Python number or a host side effect, lock-guarded shared
state, one project-wide lock order, condition-variable and thread
lifecycle discipline, failpoints compiled into every hot path, and every
observability name a detector or SLO gate consumes actually emitted —
into machine-checked rules over the AST.  The *analysis* never imports
the checked modules — it parses their source — so no checked module's
side effects run and no rule depends on an importable environment; the
CLI pays the ``tpu_sgd_torch`` package import (torch, no JAX).

Vocabulary:

* A **rule** is a named checker (``host-sync``, ``memo-key``,
  ``lock-discipline``, ...) run over every linted module's AST; it
  yields :class:`Finding`\\ s.  Rule names are a contract shared with
  the JAX package: :data:`KNOWN_RULES` is its tuple, and
  :func:`default_rules` runs all thirteen, each read for PyTorch and
  CUDA graphs (README "Static analysis in the port").
* A **suppression** is a per-line comment ``# graftlint:
  disable=<rule>[,<rule>...] -- <reason>`` — on the offending line, or
  standalone on the line above.  The reason string is mandatory by
  default (``require-reason`` in ``[tool.graftlint]``): an exception
  with no stated reason is exactly the tribal knowledge this tool
  exists to kill.
* Config: ``disable``, ``exclude`` and ``require-reason`` come from
  ``pyproject.toml`` ``[tool.graftlint]``, which the two packages
  share; its ``include`` and ``failpoint-registry`` name the JAX
  package, so the port keeps its own (:data:`PORT_INCLUDE`,
  :data:`PORT_FAILPOINT_REGISTRY`).

Run it as ``python -m tpu_sgd_torch.analysis.lint`` (see ``lint.py``),
or from tests via :func:`run_lint`.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

#: canonical rule ids, in display order (lint --list-rules)
KNOWN_RULES = (
    "shape-trap",
    "lock-discipline",
    "donation-safety",
    "failpoint-coverage",
    "eager-in-loop",
    "host-sync",
    "callback-discipline",
    "carry-stability",
    "memo-key",
    "obs-discipline",
    "lock-order",
    "cond-discipline",
    "contract-drift",
)

#: core policy checks (not AST rules; emitted by the runner itself)
POLICY_CHECKS = ("bare-suppression", "unknown-rule", "parse-error",
                 "stale-suppression")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+?)"
    r"(?:\s*--\s*(?P<reason>.*))?\s*$"
)


@dataclass
class Suppression:
    line: int          # line the comment sits on (1-based)
    rules: Set[str]    # rule ids, or {"all"}
    reason: str        # "" when none given
    standalone: bool   # comment-only line: applies to the NEXT code line


class ModuleFile:
    """One parsed source file: AST + raw lines + suppression table."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:  # surfaced as a parse-error finding
            self.parse_error = e
        self.suppressions: List[Suppression] = self._scan_suppressions()
        #: line -> set of suppressed rule ids ("all" wildcards)
        self._by_line: Dict[int, Set[str]] = {}
        for s in self.suppressions:
            target = self._target_line(s)
            self._by_line.setdefault(target, set()).update(s.rules)

    @property
    def dotted(self) -> str:
        """``tpu_sgd_torch/ops/gram.py`` -> ``tpu_sgd_torch.ops.gram``."""
        rel = self.relpath[:-3] if self.relpath.endswith(".py") else \
            self.relpath
        if rel.endswith("/__init__"):
            rel = rel[: -len("/__init__")]
        return rel.replace("/", ".")

    def _scan_suppressions(self) -> List[Suppression]:
        out = []
        for i, ln in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(ln)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            standalone = ln.strip().startswith("#")
            out.append(Suppression(
                line=i, rules=rules, reason=(m.group("reason") or "").strip(),
                standalone=standalone))
        return out

    def _target_line(self, s: Suppression) -> int:
        if not s.standalone:
            return s.line
        # standalone comment: applies to the next non-blank, non-comment
        # line (the statement it was written above)
        for j in range(s.line, len(self.lines)):
            stripped = self.lines[j].strip()
            if stripped and not stripped.startswith("#"):
                return j + 1
        return s.line

    def is_suppressed(self, rule: str, line: int) -> bool:
        rules = self._by_line.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


class Rule:
    """Base checker.  ``run`` sees EVERY linted module at once — rules
    like failpoint-coverage and donation-safety are cross-file."""

    name: str = "?"

    def run(self, modules: Sequence[ModuleFile],
            options: dict) -> Iterable[Finding]:
        raise NotImplementedError


def parse_guard(spec: str):
    """One guard spec of a ``GRAFTLINT_LOCKS`` declaration:
    ``"_lock"`` -> ``("_lock", "rw")``; ``"_lock:w"`` -> ``("_lock",
    "w")``.  Shared by the static lock-discipline rule and the runtime
    ``instrument_object`` so the grammar (and its validation) exists
    exactly once."""
    if ":" in spec:
        lock, mode = spec.split(":", 1)
        if mode not in ("w", "rw"):
            raise ValueError(f"bad lock mode {mode!r} in {spec!r}")
        return lock, mode
    return spec, "rw"


# -- config -----------------------------------------------------------------

#: what the port's lint covers when given no paths: the package and the
#: card's smoke script
PORT_INCLUDE = ("tpu_sgd_torch", "chip_smoke.py")
#: the module holding the port's ``HOOK_SITES`` table
PORT_FAILPOINT_REGISTRY = "tpu_sgd_torch/reliability/failpoints.py"


@dataclass
class Config:
    root: str
    include: List[str] = field(default_factory=lambda: list(PORT_INCLUDE))
    exclude: List[str] = field(default_factory=list)
    disable: List[str] = field(default_factory=list)
    failpoint_registry: str = PORT_FAILPOINT_REGISTRY
    require_reason: bool = True


def _load_toml(path: str) -> dict:
    try:
        import tomllib as toml_mod  # py >= 3.11
    except ImportError:  # py 3.10: the container ships tomli
        try:
            import tomli as toml_mod  # type: ignore[no-redef]
        except ImportError:
            return {}
    with open(path, "rb") as f:
        return toml_mod.load(f)


def find_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default cwd) to the pyproject.toml dir."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def load_config(root: Optional[str] = None) -> Config:
    """The port's config: its own include set and registry, and the
    shared ``[tool.graftlint]`` table's ``exclude``, ``disable`` and
    ``require-reason`` (its ``include`` and ``failpoint-registry`` are
    the JAX package's and are not read)."""
    root = root or find_root()
    cfg = Config(root=root)
    pyproject = os.path.join(root, "pyproject.toml")
    if os.path.exists(pyproject):
        tool = _load_toml(pyproject).get("tool", {}).get("graftlint", {})
        cfg.exclude = list(tool.get("exclude", cfg.exclude))
        cfg.disable = list(tool.get("disable", cfg.disable))
        cfg.require_reason = bool(
            tool.get("require-reason", cfg.require_reason))
    return cfg


# -- file collection --------------------------------------------------------

def _excluded(rel: str, excludes: Sequence[str]) -> bool:
    rel = rel.replace(os.sep, "/")
    return any(rel == e or rel.startswith(e.rstrip("/") + "/")
               for e in excludes)


def collect_files(cfg: Config,
                  paths: Optional[Sequence[str]] = None) -> List[str]:
    """Resolve include paths (or explicit CLI ``paths``) to .py files.

    Explicit ``paths`` resolve against the cwd first (what a shell user
    means), then the project root; config ``include`` entries resolve
    against the root.  Either kind resolving to nothing raises
    ``FileNotFoundError`` — a typo'd path or a renamed package must
    fail the lint gate loudly, never pass it green with zero files
    checked."""
    explicit = paths is not None and len(paths) > 0
    roots = list(paths) if explicit else list(cfg.include)
    seen, out = set(), []
    for p in roots:
        if os.path.isabs(p):
            absolute = p
        elif explicit and os.path.exists(p):
            absolute = os.path.abspath(p)
        else:
            absolute = os.path.join(cfg.root, p)
        if not os.path.exists(absolute):
            kind = "lint path" if explicit else "[tool.graftlint] include"
            raise FileNotFoundError(
                f"{kind} {p!r} does not exist (resolved to "
                f"{absolute!r})")
        if os.path.isfile(absolute):
            candidates = [absolute]
        else:
            candidates = []
            for dirpath, dirnames, filenames in os.walk(absolute):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d != "__pycache__"]
                candidates.extend(
                    os.path.join(dirpath, f) for f in sorted(filenames)
                    if f.endswith(".py"))
        for c in candidates:
            rel = os.path.relpath(c, cfg.root)
            if _excluded(rel, cfg.exclude) or c in seen:
                continue
            seen.add(c)
            out.append(c)
    return out


def load_modules(cfg: Config,
                 paths: Optional[Sequence[str]] = None) -> List[ModuleFile]:
    mods = []
    for f in collect_files(cfg, paths):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        mods.append(ModuleFile(f, os.path.relpath(f, cfg.root), src))
    return mods


# -- runner -----------------------------------------------------------------

def default_rules() -> List[Rule]:
    """Every rule, in :data:`KNOWN_RULES` order."""
    # imported here, not at module top: core must stay import-cycle-free
    # for the rule modules that import it
    from tpu_sgd_torch.analysis.rules_callback import CallbackDisciplineRule
    from tpu_sgd_torch.analysis.rules_carry import CarryStabilityRule
    from tpu_sgd_torch.analysis.rules_cond import CondDisciplineRule
    from tpu_sgd_torch.analysis.rules_contract import ContractDriftRule
    from tpu_sgd_torch.analysis.rules_donation import DonationSafetyRule
    from tpu_sgd_torch.analysis.rules_failpoint import FailpointCoverageRule
    from tpu_sgd_torch.analysis.rules_lock import LockDisciplineRule
    from tpu_sgd_torch.analysis.rules_memo import MemoKeyRule
    from tpu_sgd_torch.analysis.rules_order import LockOrderRule
    from tpu_sgd_torch.analysis.rules_shape import (EagerInLoopRule,
                                                    ShapeTrapRule)
    from tpu_sgd_torch.analysis.rules_sync import (HostSyncRule,
                                                   ObsDisciplineRule)

    return [ShapeTrapRule(), LockDisciplineRule(), DonationSafetyRule(),
            FailpointCoverageRule(), EagerInLoopRule(), HostSyncRule(),
            CallbackDisciplineRule(), CarryStabilityRule(), MemoKeyRule(),
            ObsDisciplineRule(), LockOrderRule(), CondDisciplineRule(),
            ContractDriftRule()]


def _policy_findings(modules: Sequence[ModuleFile],
                     cfg: Config) -> List[Finding]:
    out = []
    known = set(KNOWN_RULES) | {"all"}
    for mod in modules:
        if mod.parse_error is not None:
            e = mod.parse_error
            out.append(Finding(
                "parse-error", mod.relpath, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}"))
        for s in mod.suppressions:
            for r in s.rules - known:
                out.append(Finding(
                    "unknown-rule", mod.relpath, s.line, 0,
                    f"suppression names unknown rule {r!r} "
                    f"(known: {', '.join(KNOWN_RULES)})"))
            if cfg.require_reason and not s.reason:
                out.append(Finding(
                    "bare-suppression", mod.relpath, s.line, 0,
                    "suppression without a reason; write "
                    "'# graftlint: disable=<rule> -- <why this is safe>'"))
    return out


def run_lint(paths: Optional[Sequence[str]] = None, *,
             root: Optional[str] = None,
             config: Optional[Config] = None,
             rules: Optional[Sequence[Rule]] = None,
             modules: Optional[Sequence[ModuleFile]] = None,
             ) -> "LintResult":
    """Lint ``paths`` (default: config include set) and return the
    surviving findings plus counters.  ``modules`` overrides file
    discovery entirely — the test-fixture entry point."""
    cfg = config or load_config(root)
    mods = list(modules) if modules is not None else load_modules(cfg, paths)
    active = [r for r in (rules if rules is not None else default_rules())
              if r.name not in cfg.disable]
    # the project-wide call graph is built ONCE per run and shared by
    # every rule that needs cross-module facts
    from tpu_sgd_torch.analysis.dataflow import ProjectIndex
    options = {"config": cfg, "failpoint_registry": cfg.failpoint_registry,
               "project": ProjectIndex(mods)}
    raw: List[Finding] = []
    for rule in active:
        raw.extend(rule.run(mods, options))
    raw.extend(_policy_findings(mods, cfg))

    by_rel = {m.relpath: m for m in mods}
    kept, suppressed = [], 0
    #: (relpath, target line) -> rule ids a suppression actually ate
    hit_suppressions: Dict[tuple, Set[str]] = {}
    for f in raw:
        mod = by_rel.get(f.path)
        if (mod is not None and f.rule not in POLICY_CHECKS
                and mod.is_suppressed(f.rule, f.line)):
            suppressed += 1
            hit_suppressions.setdefault(
                (f.path, f.line), set()).add(f.rule)
            continue
        kept.append(f)
    kept.extend(_stale_suppressions(
        mods, cfg, {r.name for r in active}, hit_suppressions))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(findings=kept, suppressed=suppressed,
                      files=len(mods), rules=[r.name for r in active])


def _stale_suppressions(modules: Sequence[ModuleFile], cfg: Config,
                        active_rules: Set[str],
                        hit: Dict[tuple, Set[str]]) -> List[Finding]:
    """A ``# graftlint: disable=<rule>`` whose rule no longer fires on
    its line is itself a finding: dead suppressions read as live
    hazards and rot into folklore.  A rule that did not RUN (disabled,
    or a custom rule list) is skipped — staleness is only provable when
    the rule had its chance to fire."""
    out = []
    for mod in modules:
        for s in mod.suppressions:
            target = mod._target_line(s)
            ate = hit.get((mod.relpath, target), set())
            for r in sorted(s.rules):
                if r == "all":
                    # an 'all' wildcard is only provably stale when
                    # EVERY known rule had its chance to fire — under a
                    # --disable run or a custom rule list, the rule it
                    # was written for may simply not have run
                    if not ate and set(KNOWN_RULES) <= active_rules:
                        out.append(Finding(
                            "stale-suppression", mod.relpath, s.line, 0,
                            "suppression 'all' no longer matches any "
                            "finding on this line; delete it"))
                    continue
                if r not in active_rules:
                    continue  # unknown (already flagged) or not run
                if r not in ate:
                    out.append(Finding(
                        "stale-suppression", mod.relpath, s.line, 0,
                        f"suppressed rule {r!r} no longer fires on this "
                        "line; delete the suppression (or narrow it to "
                        "the rules that still fire)"))
    return out


@dataclass
class LintResult:
    findings: List[Finding]
    suppressed: int
    files: int
    rules: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings
