"""graftlint CLI of the port: ``python -m tpu_sgd_torch.analysis.lint
[paths...]`` (the port of ``tpu_sgd/analysis/lint.py``).

Exit codes: 0 clean, 1 findings, 2 usage/internal error.  Default
output is one ``path:line:col: rule: message`` line per finding
(editor/CI-clickable) plus a summary line on stderr.  ``--format
json`` emits one machine-readable object (findings + counters) for
tooling; ``--format github`` emits GitHub Actions workflow commands
(``::error file=...,line=...``) so CI findings surface as inline PR
annotations instead of a raw log grep.  With no paths, the port's
include set is linted (``tpu_sgd_torch`` and ``chip_smoke.py``; see
``core.PORT_INCLUDE``) with all thirteen rules
(``core.default_rules``); ``--list-rules`` prints every rule name of the
shared contract.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from tpu_sgd_torch.analysis.core import (KNOWN_RULES, LintResult,
                                         default_rules, load_config,
                                         run_lint)


def _emit_text(result: LintResult, quiet: bool, dt: float) -> None:
    for f in result.findings:
        print(f)
    if not quiet:
        status = ("clean" if result.ok
                  else f"{len(result.findings)} finding(s)")
        print(f"graftlint: {status} — {result.files} file(s), "
              f"{len(result.rules)} rule(s), {result.suppressed} "
              f"suppressed, {dt:.2f}s", file=sys.stderr)


def _emit_json(result: LintResult, dt: float) -> None:
    print(json.dumps({
        "ok": result.ok,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "col": f.col, "message": f.message}
            for f in result.findings],
        "files": result.files,
        "rules": result.rules,
        "suppressed": result.suppressed,
        "elapsed_s": round(dt, 3),
    }, indent=2))


def _emit_github(result: LintResult, quiet: bool, dt: float) -> None:
    """GitHub Actions workflow commands — one ``::error`` per finding.
    Newlines/percent in messages are escaped per the workflow-command
    grammar (a raw newline would truncate the annotation)."""
    def esc(s: str) -> str:
        return (s.replace("%", "%25").replace("\r", "%0D")
                 .replace("\n", "%0A"))

    for f in result.findings:
        print(f"::error file={f.path},line={f.line},"
              f"col={f.col + 1},title=graftlint {f.rule}::"
              f"{esc(f.message)}")
    if not quiet:
        status = ("clean" if result.ok
                  else f"{len(result.findings)} finding(s)")
        print(f"graftlint: {status} — {result.files} file(s), "
              f"{len(result.rules)} rule(s), {result.suppressed} "
              f"suppressed, {dt:.2f}s", file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_sgd_torch.analysis.lint",
        description="graftlint: lock-discipline, lock-order, "
                    "cond-discipline, failpoint-coverage and "
                    "contract-drift analysis for tpu_sgd_torch")
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: tpu_sgd_torch and "
             "chip_smoke.py)")
    parser.add_argument(
        "--root", default=None,
        help="project root containing pyproject.toml (default: walk up "
             "from cwd)")
    parser.add_argument(
        "--disable", default="", metavar="RULE[,RULE...]",
        help="disable rules for this run (adds to the config's list)")
    parser.add_argument(
        "--format", default="text", choices=("text", "json", "github"),
        help="output format: text (default), json (one machine-"
             "readable object), github (Actions ::error annotations)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule ids and exit")
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="findings only, no summary line")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in KNOWN_RULES:
            print(r)
        return 0

    t0 = time.perf_counter()
    try:
        cfg = load_config(args.root)
        cfg.disable = list(cfg.disable) + [
            r.strip() for r in args.disable.split(",") if r.strip()]
        result = run_lint(args.paths or None, config=cfg,
                          rules=default_rules())
    except (OSError, ValueError) as e:
        if args.format == "json":
            print(json.dumps({"ok": False, "error": str(e)}))
        else:
            print(f"graftlint: error: {e}", file=sys.stderr)
        return 2

    dt = time.perf_counter() - t0
    if args.format == "json":
        _emit_json(result, dt)
    elif args.format == "github":
        _emit_github(result, args.quiet, dt)
    else:
        _emit_text(result, args.quiet, dt)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
