"""The port's graftlint (``tpu_sgd_torch/analysis``) on the CPU, held
against the JAX package's ``tpu_sgd/analysis`` and its tests
(``tests/test_analysis.py``).

* lint parity -- every test of ``tests/test_analysis.py`` that lints with
  one of the five framework-free rules (lock-discipline,
  failpoint-coverage, lock-order, cond-discipline, contract-drift) is run
  once more with its ``lint`` / ``run_lint`` recording: each fixture it
  lints goes through the port's rule too, and the findings must agree
  exactly (rule, path, line, column, message with the package names
  normalized).  The same for each of those rules over the source trees
  ``tpu_sgd/`` and ``tpu_sgd_torch/`` (with ``chip_smoke.py``), before
  suppressions, and for memo-key on its framework-neutral cases
  (declaration drift, malformed or missing declarations, the mutation of
  a real module's declaration).  The other JAX-only rules are held on
  torch spellings of their fixtures in
  ``tests/test_torch_analysis_jax_rules.py``;
* twins of the suppression, stale-suppression, CLI and lock-order
  declaration tests, on the port's runner and CLI;
* the runtime checkers: the JAX package's runtime tests run with the
  port's ``InstrumentedLock`` / ``LocksetRecorder`` /
  ``instrument_object`` / ``assert_lock_order`` in place of its own, and
  its framework-neutral compile-count and callback-buffer tests with the
  port's ``assert_compile_count`` / ``assert_bounded_callback_buffer``;
  the port's dispatch, host-sync and compile counting on the CPU, CPU
  tensors counted as the card's.
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
from tpu_sgd.analysis import rules_memo as jmemo
from tpu_sgd.analysis import rules_order as jorder
from tpu_sgd_torch import analysis as panalysis
from tpu_sgd_torch.analysis import core as pcore
from tpu_sgd_torch.analysis import rules_cond as pcond
from tpu_sgd_torch.analysis import rules_contract as pcontract
from tpu_sgd_torch.analysis import rules_failpoint as pfailpoint
from tpu_sgd_torch.analysis import rules_lock as plock
from tpu_sgd_torch.analysis import rules_memo as pmemo
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
#: the JAX-only rule whose declaration checks are framework-neutral: held
#: finding for finding on ``NEUTRAL_CASES`` only (its undeclared-cache and
#: factory checks read programs, which differ by framework)
NEUTRAL_RULES = {"memo-key": (jmemo.MemoKeyRule, pmemo.MemoKeyRule)}
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

#: the JAX package's memo-key tests whose checks are framework-neutral
NEUTRAL_CASES = (
    "test_memo_declaration_drift_both_directions",
    "test_memo_missing_cache_and_malformed_declaration",
    "test_mutation_deleted_memo_key_field_fails_lint",
)

#: the JAX package's tests of the rules and checkers that are neither
#: parity, neutral, twin nor runtime cases, each with why
UNTWINNED = {
    "test_repo_lints_clean": "the JAX package's own tree; the port's is "
    "tests/test_torch_port_rules.py::"
    "test_the_port_lints_clean_with_its_own_graftlint",
    "test_mutation_item_in_resident_loop_body_fails_lint": "mutates the "
    "JAX package's streamed loop; the port's twin mutates its own "
    "(test_torch_analysis_jax_rules.py::"
    "test_mutation_item_in_the_ports_observed_loop_fails_lint)",
    "test_mutation_unguarded_resident_callback_fails_lint": "the JAX "
    "package's io_callback handler; the port's twin puts a host effect "
    "in _BlockRunner's capture (test_torch_analysis_jax_rules.py::"
    "test_mutation_host_effect_in_the_ports_capture_fails_lint)",
    "test_assert_compile_count_on_real_jit": "jax.jit's cache; the port's "
    "compile count is its captures and builds (test_torch_analysis.py::"
    "test_compile_count_counts_captures_and_builds)",
    "test_count_host_syncs_counts_coercions_not_cache_hits": "jax.Array's "
    "host-value cache (the reference test fails on the CPU backend); the "
    "port's reads hold their own semantics (test_torch_analysis.py::"
    "test_count_host_syncs_counts_each_read_once)",
    "test_assert_no_host_sync_raises_and_allows": "jax arrays; twin: "
    "test_torch_analysis.py::test_assert_no_host_sync_raises_and_allows",
}

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
    "test_assert_compile_count_exact_and_at_most",
    "test_assert_compile_count_sums_mixed_sources",
    "test_assert_bounded_callback_buffer",
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
    cls = {**RULES, **NEUTRAL_RULES}[rule.name][1]
    if rule.name == "failpoint-coverage":
        return cls(registry=rule._registry_override,
                   registry_path=rule._registry_path_override)
    return cls()


def _key(f):
    norm = lambda s: s.replace("tpu_sgd_torch", "tpu_sgd")  # noqa: E731
    return (f.rule, norm(f.path), f.line, f.col, norm(f.message))


def _compared(result, all_ported, rules=RULES):
    """The findings both packages must agree on: the compared rules', the
    runner's policy checks, and stale suppressions of a compared rule (a
    stale finding about another rule needs that rule to have run)."""
    out = []
    for f in result.findings:
        if f.rule in rules or f.rule in POLICY:
            out.append(_key(f))
        elif f.rule == "stale-suppression" and (
                all_ported or any(f"{r!r}" in f.message for r in rules)):
            out.append(_key(f))
    return sorted(out)


class _Recorder:
    """Wraps the reference tests' ``lint`` / ``run_lint``: each call also
    lints the same modules with the port's rules and keeps both
    results."""

    def __init__(self, module, rules=RULES):
        self.pairs = []
        self.rules = rules
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
        ported = [r for r in rules if r.name in self.rules]
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


@pytest.mark.parametrize("case", NEUTRAL_CASES)
def test_memo_key_agrees_with_the_jax_package_on_its_neutral_cases(
        reference_tests, monkeypatch, case):
    """The declaration checks of memo-key read no program: on these JAX
    fixtures (and the JAX package's own ``optimize/streamed.py``, intact
    and with a key field deleted) the port's rule gives the JAX rule's
    findings exactly."""
    rec = _Recorder(reference_tests, NEUTRAL_RULES)
    monkeypatch.setattr(reference_tests, "lint", rec.lint)
    monkeypatch.setattr(reference_tests, "run_lint", rec.run_lint)
    getattr(reference_tests, case)()
    assert rec.pairs
    for jres, pres, all_ported in rec.pairs:
        assert _compared(pres, all_ported, NEUTRAL_RULES) == _compared(
            jres, all_ported, NEUTRAL_RULES)


def test_every_parity_case_is_listed():
    """Every test of ``tests/test_analysis.py`` that lints with a rule, or
    runs a runtime checker, is listed here: a parity case (the five
    framework-free rules), a neutral memo-key case, a torch twin
    (``tests/test_torch_analysis_jax_rules.py``), a runtime case, a twin
    of the same name in this file, or an untwinned test with its
    reason."""
    from test_torch_analysis_jax_rules import TWINS

    tree = ast.parse(open(os.path.join(ROOT, "tests",
                                       "test_analysis.py")).read())
    classes = {cls.__name__ for pair in RULES.values() for cls in pair}
    all_classes = set(classes)
    from tpu_sgd.analysis import (rules_callback, rules_carry,
                                  rules_donation, rules_shape, rules_sync)
    for m in (rules_callback, rules_carry, rules_donation, rules_shape,
              rules_sync, jmemo):
        all_classes |= {n for n in dir(m) if n.endswith("Rule")
                        and n != "Rule"}
    checkers = {"assert_compile_count", "count_host_syncs",
                "assert_no_host_sync", "assert_bounded_callback_buffer",
                "count_dispatches", "assert_dispatch_count",
                "InstrumentedLock", "LocksetRecorder", "instrument_object",
                "assert_lock_order"}
    found, parity = set(), set()
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
        calls = {n.func.id for n in ast.walk(fn)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        lints = bool(calls & {"lint", "run_lint"})
        if (names & classes or "default_rules" in ast.dump(fn)) and lints:
            parity.add(fn.name)
        if ((names & all_classes or "default_rules" in ast.dump(fn))
                and lints) or names & checkers or (
                    ast.dump(fn).count("analysis.runtime")):
            found.add(fn.name)
    assert parity == set(PARITY_CASES)
    same_name = {n for n in globals() if n.startswith("test_")}
    listed = (set(PARITY_CASES) | set(NEUTRAL_CASES) | set(TWINS)
              | set(RUNTIME_CASES) | set(UNTWINNED) | same_name)
    assert found <= listed, sorted(found - listed)
    assert not (set(UNTWINNED) & (set(TWINS) | set(NEUTRAL_CASES)))


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
    host-sync or lock-order suppression is NOT stale under a
    lock-discipline-only run.  Under the default rules all thirteen run,
    so the same host-sync suppression on a clean line IS stale."""
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
    assert sorted(f.rule for f in res.findings) == [
        "failpoint-coverage", "stale-suppression"]


def test_stale_all_wildcard_needs_every_rule_to_have_run():
    """A ``disable=all`` wildcard is provably stale only when EVERY known
    rule ran: under the default rules (all thirteen) a clean line's
    wildcard is reported; under a subset it is not."""
    src = """
        def clean(x):
            return x + 1  # graftlint: disable=all -- nothing here
    """
    res = _lint(_mod(src), pcore.default_rules())
    assert len(_by_rule(res, "stale-suppression")) == 1
    res = _lint(_mod(src), pcore.default_rules()[:12])
    assert _by_rule(res, "stale-suppression") == []


def test_known_rules_are_the_contract_and_default_rules_the_ported_five():
    """The port's ``default_rules()`` runs all thirteen names of the
    shared ``KNOWN_RULES``, in its order (the name is kept from step 1,
    when it pinned the five framework-free rules)."""
    assert pcore.KNOWN_RULES == jcore.KNOWN_RULES
    assert pcore.POLICY_CHECKS == jcore.POLICY_CHECKS
    names = [r.name for r in pcore.default_rules()]
    assert names == list(pcore.KNOWN_RULES)
    assert set(RULES) < set(names)


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
    from tpu_sgd.analysis import runtime as jruntime

    for name in ("InstrumentedLock", "LocksetRecorder", "instrument_object",
                 "assert_lock_order", "LockOrderError",
                 "assert_compile_count", "CompileCountError"):
        monkeypatch.setattr(reference_tests, name, getattr(pruntime, name))
    # the callback-buffer test imports its checker inside its body
    for name in ("assert_bounded_callback_buffer", "CallbackBufferError"):
        monkeypatch.setattr(jruntime, name, getattr(pruntime, name))
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


def test_real_eventlog_declaration_validates_at_runtime(tmp_path):
    """The twin of the JAX package's test of the same name: the port's
    ``JsonLinesEventLog`` under its ``GRAFTLINT_LOCKS`` declaration, three
    writer threads, no unguarded access and no torn line."""
    import threading

    from tpu_sgd_torch.utils.events import (GRAFTLINT_LOCKS, IterationEvent,
                                            JsonLinesEventLog)

    log = JsonLinesEventLog(str(tmp_path / "ev.jsonl"))
    rec = pruntime.instrument_object(log, GRAFTLINT_LOCKS["JsonLinesEventLog"])

    def writer(i):
        for j in range(20):
            log.on_iteration(IterationEvent(
                iteration=i * 100 + j, loss=0.0, weight_delta_norm=0.0,
                mini_batch_size=1, wall_time_s=0.0))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log.close()
    assert rec.violations == []
    assert len(JsonLinesEventLog.read(str(tmp_path / "ev.jsonl"))) == 60


def test_flightrec_concurrent_triggers_rate_limited_once(tmp_path):
    """The twin of the JAX package's test of the same name on the port's
    ``FlightRecorder``: four concurrent debounced triggers make exactly one
    dump, every ``_last_dump_t`` access under the declared lock."""
    import threading

    from tpu_sgd_torch.obs.flightrec import FlightRecorder, GRAFTLINT_LOCKS

    fr = FlightRecorder(str(tmp_path / "fr.jsonl"), capacity=8)
    fr.record("probe", {"i": 0})
    rec = pruntime.instrument_object(fr, GRAFTLINT_LOCKS["FlightRecorder"])
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(
            fr.trigger("race", min_interval_s=60.0)))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fr.dumps == 1
    assert sum(r is not None for r in results) == 1
    assert rec.violations == []
    assert rec.races() == []


# -- the runtime checkers' mechanics on the CPU --------------------------------
# (CPU tensors count as the card's here, as in tests/test_torch_obs.py; on
# real card tensors they run in chip_smoke.py phase ``analysis``)

@pytest.fixture
def card_reads(monkeypatch):
    from tpu_sgd_torch.obs import counters

    monkeypatch.setattr(counters, "_card", lambda x: True)
    return counters


def _replay_record():
    from tpu_sgd_torch.ops import cuda_kernels as ck

    return {"wrappers": {f.__name__: 0 for f in ck.WRAPPERS
                         + ck.CSR_WRAPPERS},
            "sources": {}, "routes": {}, "model_axis": {},
            "csr_columns": {}}


def test_count_host_syncs_counts_each_read_once(card_reads):
    """One count per read with its ``(shape, dtype)``, however the funnels
    call each other (``float`` of a 0-d tensor, ``.numpy()``); a region
    nested in another counts in both; the hooks come off when the last
    region closes (the counters stay disabled)."""
    import torch

    t = torch.arange(4.0)
    with pruntime.count_host_syncs() as outer:
        float(t[0])
        t.numpy()
        with pruntime.count_host_syncs() as inner:
            t.tolist()
            bool(t[1])
        t.cpu()
    assert outer["n"] == 5 and inner["n"] == 2
    assert outer["shapes"] == [((), "torch.float32"), ((4,), "torch.float32"),
                               ((4,), "torch.float32"), ((), "torch.float32"),
                               ((4,), "torch.float32")]
    assert card_reads._PATCHES is None and not card_reads.is_enabled()
    with pruntime.count_host_syncs() as none:
        t + 1  # no read
    assert none["n"] == 0


def test_count_host_syncs_skips_cpu_tensors():
    import torch

    with pruntime.count_host_syncs() as c:
        float(torch.ones(()))
    assert c["n"] == 0


def test_assert_no_host_sync_raises_and_allows(card_reads):
    """The twin of the JAX package's test of the same name: a read raises
    ``HostSyncError`` naming what it read, ``allow=`` admits the
    boundary's reads, and the call-through form returns the result."""
    import torch

    t = torch.arange(4.0)
    with pytest.raises(pruntime.HostSyncError) as ei:
        with pruntime.assert_no_host_sync():
            t[0].item()
    assert "device->host transfer" in str(ei.value)
    with pruntime.assert_no_host_sync(allow=1):
        float(t[1])
    out = pruntime.assert_no_host_sync(lambda: t * 2)
    assert out.shape == (4,)


def test_count_dispatches_counts_launches_outside_captures_and_replays():
    """A hand-written kernel's launch outside a capture counts one, the
    same launch inside ``ck.captured_launches()`` none (the capture
    launches nothing), each replay of the captured block one; exact and
    ``at_most`` contracts."""
    from tpu_sgd_torch.ops import cuda_kernels as ck

    with pruntime.count_dispatches() as d:
        ck.count_launch(source="fused_sums")
        with ck.captured_launches():
            ck.count_launch(source="window_sums")
        ck.add_replayed_launches(_replay_record())
        ck.add_replayed_launches(_replay_record())
        ck.count_launch(csr_columns="csr_margins/1")
        ck.count_launch()  # a wrapper's count alone launches nothing
    assert d["n"] == 4
    with pruntime.assert_dispatch_count(2):
        ck.add_replayed_launches(_replay_record())
        ck.count_launch(source="fused_sums")
    with pruntime.assert_dispatch_count(3, at_most=True):
        ck.count_launch(source="fused_sums")
    with pytest.raises(pruntime.DispatchCountError, match="exactly 0"):
        with pruntime.assert_dispatch_count(0):
            ck.count_launch(source="fused_sums")
    with pytest.raises(ValueError):
        pruntime.assert_dispatch_count(-1).__enter__()
    ck.reset_launch_counts()


def test_compile_count_counts_captures_and_builds(monkeypatch):
    """``assert_compile_count`` with no ``of=`` counts the card's compiles:
    one per capture bracket and one per ``nvcc`` build started
    (``_build._start`` returning a job); a library already built counts
    none."""
    from tpu_sgd_torch.ops import _build
    from tpu_sgd_torch.ops import cuda_kernels as ck

    jobs = iter([("proc", "tmp", "out"), None])
    monkeypatch.setattr(_build, "_start", lambda name: next(jobs))
    with pruntime.assert_compile_count(2):
        with ck.captured_launches():
            pass
        _build._start("fused_sums")
    with pruntime.assert_compile_count(0):
        _build._start("fused_sums")  # built already: no job
    with pytest.raises(pruntime.CompileCountError, match="exactly 0"):
        with pruntime.assert_compile_count(0):
            with ck.captured_launches():
                pass


def test_counting_regions_leave_the_counters_as_they_were(card_reads):
    """A region counts while the counters are enabled too, and both see
    the same read; the counters stay enabled after it and their hooks
    stay installed."""
    import torch

    card_reads.reset()
    card_reads.enable()
    try:
        with pruntime.count_host_syncs() as c:
            torch.ones(3).tolist()
        assert c["n"] == 1
        assert card_reads.is_enabled() and card_reads._PATCHES is not None
        snap = card_reads.snapshot()
        assert sum(v["n"] for k, v in snap.items()
                   if k.endswith(".host_sync")) == 1
    finally:
        card_reads.disable()
        card_reads.reset()
    assert card_reads._PATCHES is None
