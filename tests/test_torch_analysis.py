"""The port's graftlint (``tpu_sgd_torch/analysis``) on the CPU, held
against the JAX package's ``tpu_sgd/analysis`` and its tests
(``tests/test_analysis.py``).

* lint parity -- every test of ``tests/test_analysis.py`` that lints with
  one of the five ported rules (lock-discipline, failpoint-coverage,
  lock-order, cond-discipline, contract-drift) is run once more with its
  ``lint`` / ``run_lint`` recording: each fixture it lints goes through
  the port's rule too, and the findings must agree exactly (rule, path,
  line, column, message with the package names normalized).  The same
  for each rule over the source trees ``tpu_sgd/`` and
  ``tpu_sgd_torch/`` (with ``chip_smoke.py``), before suppressions;
* twins of the suppression, stale-suppression, CLI and lock-order
  declaration tests, on the port's runner and CLI;
* the runtime lock checkers: the JAX package's runtime tests run with the
  port's ``InstrumentedLock`` / ``LocksetRecorder`` /
  ``instrument_object`` / ``assert_lock_order`` in place of its own.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from tpu_sgd.analysis import GRAFTLINT_LOCK_ORDER as JAX_LOCK_ORDER
from tpu_sgd.analysis import core as jcore
from tpu_sgd.analysis import rules_cond as jcond
from tpu_sgd.analysis import rules_contract as jcontract
from tpu_sgd.analysis import rules_failpoint as jfailpoint
from tpu_sgd.analysis import rules_lock as jlock
from tpu_sgd.analysis import rules_order as jorder
from tpu_sgd_torch import analysis as panalysis
from tpu_sgd_torch.analysis import core as pcore
from tpu_sgd_torch.analysis import rules_cond as pcond
from tpu_sgd_torch.analysis import rules_contract as pcontract
from tpu_sgd_torch.analysis import rules_failpoint as pfailpoint
from tpu_sgd_torch.analysis import rules_lock as plock
from tpu_sgd_torch.analysis import rules_order as porder
from tpu_sgd_torch.analysis import runtime as pruntime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: rule name -> (the JAX package's rule class, the port's)
RULES = {
    "lock-discipline": (jlock.LockDisciplineRule, plock.LockDisciplineRule),
    "failpoint-coverage": (jfailpoint.FailpointCoverageRule,
                           pfailpoint.FailpointCoverageRule),
    "lock-order": (jorder.LockOrderRule, porder.LockOrderRule),
    "cond-discipline": (jcond.CondDisciplineRule, pcond.CondDisciplineRule),
    "contract-drift": (jcontract.ContractDriftRule,
                       pcontract.ContractDriftRule),
}
POLICY = ("bare-suppression", "unknown-rule", "parse-error")

#: the tests of ``tests/test_analysis.py`` that lint with a ported rule
#: (``test_every_parity_case_is_listed`` keeps this list whole)
PARITY_CASES = (
    "test_lock_discipline_clean_fixture",
    "test_lock_discipline_flags_unlocked_access_and_w_mode_write",
    "test_lock_discipline_init_exempt_and_declaration_drift",
    "test_failpoint_coverage_both_directions",
    "test_failpoint_coverage_points_at_moved_hook",
    "test_mutation_deleted_failpoint_hook_fails_lint",
    "test_mutation_deleted_lock_block_fails_lint",
    "test_every_rule_fires_on_its_seeded_violation",
    "test_lock_private_helper_proven_by_locked_call_sites",
    "test_lock_one_unlocked_call_site_voids_the_proof",
    "test_stale_all_wildcard_needs_every_rule_to_have_run",
    "test_lock_order_cycle_is_a_deadlock_finding",
    "test_lock_order_without_declaration_checks_cycles_only",
    "test_lock_order_inverted_edge_names_both_paths",
    "test_lock_order_undeclared_edge_and_stale_pair_both_fail",
    "test_lock_order_declaration_matching_graph_is_clean",
    "test_lock_order_rejects_malformed_declaration",
    "test_cond_wait_not_in_while_fires_wait_for_and_while_exempt",
    "test_cond_notify_outside_lock_fires_helper_proof_holds",
    "test_cond_untimed_wait_on_stop_path_fires_stop_flag_exempts",
    "test_cond_unjoined_daemon_thread_fires_join_anywhere_exempts",
    "test_cond_unobserved_future_exception_cross_module",
    "test_contract_slo_counter_and_rule_typos_fire",
    "test_contract_detector_default_series_must_resolve",
    "test_contract_fanout_tables_and_tagged_emits_resolve",
    "test_contract_gate_paths_validate_against_committed_baselines",
    "test_mutation_inverted_acquisition_fails_lock_order_lint",
    "test_mutation_unlocked_slab_access_fails_lint",
)

#: the JAX package's runtime lock tests, run with the port's checkers
RUNTIME_CASES = (
    "test_instrumented_lock_tracks_holding_thread",
    "test_instrument_object_records_unguarded_access",
    "test_instrumented_condition_wait_releases_lockset",
    "test_real_batcher_declaration_validates_at_runtime",
    "test_mutation_inverted_acquisition_fails_runtime_replay",
    "test_lock_order_replay_uses_transitive_closure",
    "test_mutation_unlocked_slab_write_flagged_by_eraser",
    "test_eraser_clean_on_consistently_locked_slab_workload",
    "test_batcher_burst_eraser_clean_and_counters_consistent",
)


def _jax_tests():
    """``tests/test_analysis.py`` as a module of its own (its functions
    and their globals, which the cases below patch)."""
    spec = importlib.util.spec_from_file_location(
        "_graftlint_reference_tests",
        os.path.join(ROOT, "tests", "test_analysis.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_module(m):
    return pcore.ModuleFile(m.path, m.relpath, m.source)


def _port_config(cfg):
    return pcore.Config(root=cfg.root, include=list(cfg.include),
                        exclude=list(cfg.exclude),
                        disable=list(cfg.disable),
                        failpoint_registry=cfg.failpoint_registry,
                        require_reason=cfg.require_reason)


def _port_rule(rule):
    cls = RULES[rule.name][1]
    if rule.name == "failpoint-coverage":
        return cls(registry=rule._registry_override,
                   registry_path=rule._registry_path_override)
    return cls()


def _key(f):
    norm = lambda s: s.replace("tpu_sgd_torch", "tpu_sgd")  # noqa: E731
    return (f.rule, norm(f.path), f.line, f.col, norm(f.message))


def _compared(result, all_ported):
    """The findings both packages must agree on: the ported rules', the
    runner's policy checks, and stale suppressions of a ported rule (a
    stale finding about another rule needs that rule to have run)."""
    out = []
    for f in result.findings:
        if f.rule in RULES or f.rule in POLICY:
            out.append(_key(f))
        elif f.rule == "stale-suppression" and (
                all_ported or any(f"{r!r}" in f.message for r in RULES)):
            out.append(_key(f))
    return sorted(out)


class _Recorder:
    """Wraps the reference tests' ``lint`` / ``run_lint``: each call also
    lints the same modules with the port's rules and keeps both
    results."""

    def __init__(self, module):
        self.pairs = []
        self._lint = module.lint
        self._run_lint = module.run_lint

    def lint(self, modules, rules, **cfg):
        res = self._lint(modules, rules, **cfg)
        cfg.setdefault("root", "/fixtures")
        mods = [modules] if isinstance(modules, jcore.ModuleFile) \
            else list(modules)
        self._port(res, mods, rules, jcore.Config(**cfg))
        return res

    def run_lint(self, paths=None, *, root=None, config=None, rules=None,
                 modules=None):
        res = self._run_lint(paths, root=root, config=config, rules=rules,
                             modules=modules)
        if rules is not None and modules is not None:
            self._port(res, list(modules), rules,
                       config or jcore.load_config(root))
        return res

    def _port(self, res, mods, rules, cfg):
        ported = [r for r in rules if r.name in RULES]
        if not ported:
            return
        pres = pcore.run_lint(config=_port_config(cfg),
                              rules=[_port_rule(r) for r in ported],
                              modules=[_port_module(m) for m in mods])
        self.pairs.append((res, pres, len(ported) == len(rules)))


@pytest.fixture(scope="module")
def reference_tests():
    return _jax_tests()


@pytest.mark.parametrize("case", PARITY_CASES)
def test_ported_rules_agree_with_the_jax_package_on_its_fixtures(
        reference_tests, monkeypatch, case):
    rec = _Recorder(reference_tests)
    monkeypatch.setattr(reference_tests, "lint", rec.lint)
    monkeypatch.setattr(reference_tests, "run_lint", rec.run_lint)
    getattr(reference_tests, case)()  # its own assertions hold too
    assert rec.pairs, f"{case} linted nothing with a ported rule"
    for jres, pres, all_ported in rec.pairs:
        assert _compared(pres, all_ported) == _compared(jres, all_ported)
        if all_ported:
            assert pres.suppressed == jres.suppressed
            assert pres.files == jres.files


def test_every_parity_case_is_listed():
    """Every test of ``tests/test_analysis.py`` that names a ported rule
    (or the whole default set) is a parity case."""
    tree = ast.parse(open(os.path.join(ROOT, "tests",
                                       "test_analysis.py")).read())
    classes = {cls.__name__ for pair in RULES.values() for cls in pair}
    found = set()
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
        calls = {n.func.id for n in ast.walk(fn)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        if (names & classes or "default_rules" in ast.dump(fn)) and (
                calls & {"lint", "run_lint"}):
            found.add(fn.name)
    assert found == set(PARITY_CASES)


# -- parity over the source trees ---------------------------------------------

#: each tree with its failpoint registry
TREES = {
    "tpu_sgd": (("tpu_sgd",), "tpu_sgd/reliability/failpoints.py"),
    "tpu_sgd_torch": (pcore.PORT_INCLUDE, pcore.PORT_FAILPOINT_REGISTRY),
}


@pytest.fixture(scope="module")
def trees():
    """Each tree's modules, parsed once, as the JAX package's and the
    port's ``ModuleFile``s, with the call graph each package's rules
    share within one run."""
    from tpu_sgd.analysis.dataflow import ProjectIndex as JIndex
    from tpu_sgd_torch.analysis.dataflow import ProjectIndex as PIndex

    out = {}
    for name, (include, registry) in TREES.items():
        jcfg = jcore.Config(root=ROOT, include=list(include),
                            failpoint_registry=registry)
        jmods = jcore.load_modules(jcfg)
        pmods = [_port_module(m) for m in jmods]
        pcfg = _port_config(jcfg)
        out[name] = (
            (jmods, {"config": jcfg, "failpoint_registry": registry,
                     "project": JIndex(jmods)}),
            (pmods, {"config": pcfg, "failpoint_registry": registry,
                     "project": PIndex(pmods)}))
    return out


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_ported_rules_agree_with_the_jax_package_on_the_source_trees(
        trees, tree, rule):
    """Raw findings (before suppressions) of both packages' rule over the
    same tree.  Over the port, each raw finding sits on a line whose
    suppression names the rule with a reason (the lint result is clean:
    ``tests/test_torch_port_rules.py``)."""
    (jmods, jopts), (pmods, popts) = trees[tree]
    jcls, pcls = RULES[rule]
    raw = list(pcls().run(pmods, popts))
    got = sorted(_key(f) for f in raw)
    ref = sorted(_key(f) for f in jcls().run(jmods, jopts))
    assert got == ref
    assert len(pmods) > 50
    if tree == "tpu_sgd_torch":
        by_rel = {m.relpath: m for m in pmods}
        for f in raw:
            mod = by_rel[f.path]
            assert mod.is_suppressed(rule, f.line), f
            assert all(s.reason for s in mod.suppressions), f.path


# -- suppressions (twins, on lock-discipline fixtures) -------------------------

def _mod(src, relpath="fixture_mod.py"):
    return pcore.ModuleFile("/fixtures/" + relpath, relpath,
                            textwrap.dedent(src))


def _lint(modules, rules, **cfg):
    cfg.setdefault("root", "/fixtures")
    if isinstance(modules, pcore.ModuleFile):
        modules = [modules]
    return pcore.run_lint(config=pcore.Config(**cfg), rules=rules,
                          modules=modules)


def _by_rule(result, rule):
    return [f for f in result.findings if f.rule == rule]


_UNLOCKED = '''
    import threading

    GRAFTLINT_LOCKS = {"Box": {"_val": "_lock"}}

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._val = 0

        def peek(self):
            {comment_above}
            return self._val{comment_inline}

        def peek2(self):
            {comment_above2}
            return self._val
'''


def _box(above="", inline="", above2=""):
    return _mod(_UNLOCKED.replace("{comment_above}", above or "pass")
                .replace("{comment_inline}", inline)
                .replace("{comment_above2}", above2 or "pass"))


def test_suppression_same_line_with_reason():
    res = _lint(_box(inline="  # graftlint: disable=lock-discipline -- "
                            "fixture reason",
                     above2="# graftlint: disable=lock-discipline -- "
                            "fixture reason"),
                [plock.LockDisciplineRule()])
    assert res.findings == [] and res.suppressed == 2


def test_suppression_standalone_line_above():
    res = _lint(_box(above="# graftlint: disable=lock-discipline -- "
                           "fixture reason",
                     above2="# graftlint: disable=lock-discipline -- "
                            "fixture reason"),
                [plock.LockDisciplineRule()])
    assert res.findings == [] and res.suppressed == 2


def test_suppression_all_wildcard_and_wrong_rule():
    res = _lint(_box(above="# graftlint: disable=all -- fixture reason",
                     above2="# graftlint: disable=lock-order -- wrong rule "
                            "on purpose"),
                [plock.LockDisciplineRule()])
    assert len(_by_rule(res, "lock-discipline")) == 1  # peek2 not covered
    assert res.suppressed == 1


def test_bare_suppression_and_unknown_rule_are_findings():
    res = _lint(_box(above="# graftlint: disable=lock-discipline",
                     above2="# graftlint: disable=lock_discipline -- "
                            "underscores, not a rule id"),
                [plock.LockDisciplineRule()])
    rules = {f.rule for f in res.findings}
    assert "bare-suppression" in rules and "unknown-rule" in rules


def test_stale_suppression_is_a_finding():
    res = _lint(_mod("""
        def clean(x):
            return x + 1  # graftlint: disable=lock-discipline -- historical
    """), [plock.LockDisciplineRule()])
    found = _by_rule(res, "stale-suppression")
    assert len(found) == 1 and "no longer fires" in found[0].message


def test_live_suppression_is_not_stale():
    res = _lint(_box(above="# graftlint: disable=lock-discipline -- "
                           "fixture: intentionally racy",
                     above2="# graftlint: disable=lock-discipline -- "
                            "fixture: intentionally racy"),
                [plock.LockDisciplineRule()])
    assert _by_rule(res, "stale-suppression") == []
    assert _by_rule(res, "lock-discipline") == []
    assert res.suppressed == 2


def test_stale_not_reported_for_rules_that_did_not_run():
    """Staleness is only provable when the rule had its chance to fire: a
    host-sync suppression is NOT stale under the port's rules (host-sync
    is a known rule name the port does not run yet), nor a lock-order one
    under a lock-discipline-only run."""
    for rule in ("host-sync", "lock-order"):
        res = _lint(_mod(f"""
            def clean(x):
                return x + 1  # graftlint: disable={rule} -- not checked
        """), [plock.LockDisciplineRule()])
        assert res.findings == [], res.findings
    res = _lint(_mod("""
        def clean(x):
            return x + 1  # graftlint: disable=host-sync -- not checked
    """), pcore.default_rules())
    # (a fixture root holds no failpoint registry: that rule says so)
    assert {f.rule for f in res.findings} == {"failpoint-coverage"}


def test_stale_all_wildcard_needs_every_rule_to_have_run():
    """A ``disable=all`` wildcard is provably stale only when EVERY known
    rule ran: the port runs five of the thirteen, so a clean line's
    wildcard is never reported under its default rules."""
    res = _lint(_mod("""
        def clean(x):
            return x + 1  # graftlint: disable=all -- nothing here
    """), pcore.default_rules())
    assert _by_rule(res, "stale-suppression") == []


def test_known_rules_are_the_contract_and_default_rules_the_ported_five():
    assert pcore.KNOWN_RULES == jcore.KNOWN_RULES
    assert pcore.POLICY_CHECKS == jcore.POLICY_CHECKS
    names = [r.name for r in pcore.default_rules()]
    assert names == [r for r in pcore.KNOWN_RULES if r in RULES]
    assert set(names) == set(RULES)


def test_config_reads_the_shared_table_but_keeps_the_port_paths(tmp_path):
    """``[tool.graftlint]`` names the JAX package's include set and
    registry; the port reads only ``exclude``, ``disable`` and
    ``require-reason`` from it."""
    (tmp_path / "pyproject.toml").write_text(textwrap.dedent("""
        [tool.graftlint]
        include = ["tpu_sgd"]
        exclude = ["tpu_sgd_torch/ops"]
        disable = ["contract-drift"]
        failpoint-registry = "tpu_sgd/reliability/failpoints.py"
        require-reason = false
    """))
    cfg = pcore.load_config(str(tmp_path))
    assert cfg.include == list(pcore.PORT_INCLUDE)
    assert cfg.failpoint_registry == pcore.PORT_FAILPOINT_REGISTRY
    assert cfg.exclude == ["tpu_sgd_torch/ops"]
    assert cfg.disable == ["contract-drift"]
    assert cfg.require_reason is False
    repo = pcore.load_config(ROOT)
    assert repo.include == ["tpu_sgd_torch", "chip_smoke.py"]
    assert repo.require_reason is True and repo.disable == []


# -- the CLI (twin of test_cli_exit_codes) ------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    from tpu_sgd_torch.analysis import lint as lint_cli

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading

        GRAFTLINT_LOCKS = {"Box": {"_val": "_lock"}}

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._val = 0

            def racy(self):
                return self._val
    """))
    (tmp_path / "pyproject.toml").write_text("")
    rc = lint_cli.main(["--root", str(tmp_path), str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and "lock-discipline" in out

    rc = lint_cli.main(["--root", str(tmp_path), "--format", "json",
                        str(bad)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and not doc["ok"]
    # the racy read, and the registry a bare root does not hold
    assert sorted(f["rule"] for f in doc["findings"]) == [
        "failpoint-coverage", "lock-discipline"]
    assert doc["rules"] == [r.name for r in pcore.default_rules()]

    rc = lint_cli.main(["--root", str(tmp_path), "--format", "github",
                        str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and out.startswith("::error file=")
    assert "title=graftlint lock-discipline" in out

    # a typo'd explicit path must fail loudly (exit 2), never report
    # clean with zero files checked
    rc = lint_cli.main(["--root", ROOT, "tpu_sgd_torch/no_such_file.py"])
    err = capsys.readouterr().err
    assert rc == 2 and "does not exist" in err

    # same for a typo'd include: a renamed package must not turn the
    # lint gate vacuously green
    with pytest.raises(FileNotFoundError, match="include"):
        pcore.run_lint(config=pcore.Config(root=ROOT,
                                           include=["tpu_sgd_renamed"]))

    assert lint_cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split()
    assert tuple(listed) == pcore.KNOWN_RULES


def test_cli_runs_without_jax():
    """``python -m tpu_sgd_torch.analysis.lint`` in a fresh process on
    one file: no JAX and no JAX package imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['lint', '-q', 'tpu_sgd_torch/analysis/core.py']\n"
            "try:\n"
            "    runpy.run_module('tpu_sgd_torch.analysis.lint', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
            "print(rc, bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


# -- the committed lock order -------------------------------------------------

def test_committed_lock_order_is_acyclic_and_names_declared_locks():
    adj = {}
    for a, b in panalysis.GRAFTLINT_LOCK_ORDER:
        adj.setdefault(a, set()).add(b)
    seen, done = set(), set()

    def dfs(u):
        seen.add(u)
        for v in adj.get(u, ()):
            assert v not in seen or v in done, (
                f"committed GRAFTLINT_LOCK_ORDER has a cycle through {v}")
            if v not in done:
                dfs(v)
        done.add(u)

    for node in list(adj):
        if node not in done:
            dfs(node)
    for a, b in panalysis.GRAFTLINT_LOCK_ORDER:
        assert "." in a and "." in b


def test_port_lock_order_inverts_no_pair_of_the_jax_package():
    """The port's declaration is its own graph over ``tpu_sgd_torch/``
    (the lint run holds it to that graph); no pair of it inverts a pair
    of the JAX package's, and today the two are equal."""
    port = set(panalysis.GRAFTLINT_LOCK_ORDER)
    ref = set(JAX_LOCK_ORDER)
    assert not {(b, a) for a, b in port} & ref
    assert port == ref


def test_port_lock_order_equals_its_lock_graph():
    """The lock-order rule over the port alone: no finding (a pair
    missing from the declaration, a stale pair or an inversion would be
    one)."""
    cfg = pcore.load_config(ROOT)
    res = pcore.run_lint(config=cfg, rules=[porder.LockOrderRule()])
    assert res.findings == [], "\n".join(str(f) for f in res.findings)


# -- the runtime lock checkers -------------------------------------------------

@pytest.mark.parametrize("case", RUNTIME_CASES)
def test_port_runtime_passes_the_jax_package_runtime_tests(
        reference_tests, monkeypatch, case):
    for name in ("InstrumentedLock", "LocksetRecorder", "instrument_object",
                 "assert_lock_order", "LockOrderError"):
        monkeypatch.setattr(reference_tests, name, getattr(pruntime, name))
    getattr(reference_tests, case)()


def test_port_runtime_replays_against_the_port_order_by_default():
    import threading

    rec = pruntime.LocksetRecorder()
    outer = pruntime.InstrumentedLock(
        threading.Lock(), name="WindowStore._dispatch_cv", recorder=rec)
    inner = pruntime.InstrumentedLock(
        threading.Lock(), name="WindowStore._lock", recorder=rec)
    with outer:
        with inner:
            pass
    with pytest.raises(pruntime.LockOrderError,
                       match="tpu_sgd_torch/analysis/__init__.py"):
        pruntime.assert_lock_order(rec)
