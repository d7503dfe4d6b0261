"""The port's multi-tenant stress scenario
(``tpu_sgd_torch/scenario/tenant_stress.py``) on the CPU, held against the
JAX package's ``tpu_sgd/scenario/tenant_stress.py`` and its tests
(``tests/test_tenant.py`` (l), whose names the twins here keep).

* exact parity -- both packages' ``build_tenant_slos`` give the same
  document for each mode and every ``violate`` name (an unknown name
  raises in both), and ``_zipf_tenants`` gives bitwise equal draws;
* one smoke run on the CPU (``device="cpu"``), once per module: its trace
  meets every count, span and alert SLO one by one through the port's
  ``obs.report.evaluate_slos``, its ledger conserves, the chaos really
  churned the slab, serving scored no new shape after warm-up, and the
  run was made with ``violate=`` so its own gate must fail.  The
  wall-clock bound (``tenant-interactive-p99``) is held on the card by
  ``chip_smoke.py`` phase ``scenario``.
"""

import json

import numpy as np
import pytest
import torch

from tpu_sgd.scenario import build_tenant_slos as jbuild_tenant_slos
from tpu_sgd.scenario import tenant_stress as jtenant_stress
from tpu_sgd_torch.obs import counters
from tpu_sgd_torch.obs import report as obs_report
from tpu_sgd_torch.scenario import build_tenant_slos, run_tenant_scenario
from tpu_sgd_torch.scenario import tenant_stress

WALL_CLOCK_SLOS = ("tenant-interactive-p99",)
SLO_NAMES = [s["name"] for s in jbuild_tenant_slos("smoke")["slos"]]
#: the run's own gate is given this one broken SLO: it must fail
VIOLATED = "eviction-storm-churned"


# -- exact parity with the JAX package --------------------------------------
@pytest.mark.parametrize("violate", [None] + SLO_NAMES)
@pytest.mark.parametrize("mode", ["smoke", "full"])
def test_build_tenant_slos_equals_the_jax_package(mode, violate):
    assert build_tenant_slos(mode, violate=violate) == jbuild_tenant_slos(
        mode, violate=violate)


def test_build_tenant_slos_unknown_name_raises_in_both():
    for fn in (build_tenant_slos, jbuild_tenant_slos):
        with pytest.raises(ValueError, match="no such SLO"):
            fn("full", violate="not-an-slo")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_zipf_tenants_bitwise_the_jax_package(seed):
    for n_tenants, size in ((300, 8192), (4000, 8192), (7, 100)):
        got = tenant_stress._zipf_tenants(np.random.default_rng(seed),
                                          n_tenants, size)
        ref = jtenant_stress._zipf_tenants(np.random.default_rng(seed),
                                           n_tenants, size)
        assert got.dtype == ref.dtype
        assert got.tobytes() == ref.tobytes()
        assert 0 <= got.min() and got.max() < n_tenants


def test_tenant_scenario_knobs_equal_the_jax_package():
    assert tenant_stress.P99_BOUND_S == jtenant_stress.P99_BOUND_S


# -- the tenant stress scenario (smoke) on the CPU, once per module -----------
@pytest.fixture(scope="module")
def tenant_scenario_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tenant_scenario")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # the trace's one counter snapshot is cumulative in the process:
    # counts start at 0 here, so no earlier test's counts reach the gate
    counters.reset()
    try:
        rc = run_tenant_scenario(seed=0, smoke=True, out_dir=str(out),
                                 violate=VIOLATED, verbose=False,
                                 device="cpu")
    finally:
        torch.set_num_threads(threads)
    records = obs_report.load_trace(str(out / "tenant_trace.jsonl"))
    return rc, out, records


@pytest.mark.parametrize("name", [n for n in SLO_NAMES
                                  if n not in WALL_CLOCK_SLOS])
def test_tenant_scenario_count_span_and_alert_slos_pass(tenant_scenario_run,
                                                        name):
    _, _, records = tenant_scenario_run
    doc = build_tenant_slos("smoke")
    (verdict,) = [v for v in obs_report.evaluate_slos(records, doc)
                  if v["name"] == name]
    assert verdict["ok"], verdict


def test_tenant_scenario_ledger_conserves_and_chaos_churned(
        tenant_scenario_run):
    _, out, _ = tenant_scenario_run
    summary = json.loads((out / "tenant_summary.json").read_text())
    assert summary["device"] == "cpu"
    assert (summary["n_tenants"], summary["capacity"]) == (300, 64)
    t = summary["totals"]
    assert t["dropped"] == 0 and t["errored"] == 0
    assert t["submitted"] == (t["answered"] + t["rejected"]
                              + t["displaced"] + t["errored"]
                              + t["dropped"])
    # the chaos really happened: LRU churn past capacity AND hot swaps
    # under live traffic (the harness itself raises if serving scored a
    # new padded shape after warm-up)
    assert summary["slab"]["evicted"] >= 10
    assert summary["slab"]["swapped"] >= 5
    assert min(summary["chaos"].values()) > 0


def test_tenant_scenario_violated_slo_fails_the_gate(tenant_scenario_run,
                                                     tmp_path):
    rc, out, records = tenant_scenario_run
    assert rc == 1
    doc = json.loads((out / "tenant_slo.json").read_text())
    assert doc == build_tenant_slos("smoke", violate=VIOLATED)
    (verdict,) = [v for v in obs_report.evaluate_slos(records, doc)
                  if v["name"] == VIOLATED]
    assert not verdict["ok"]
    bad = tmp_path / "bad_slo.json"
    bad.write_text(json.dumps(build_tenant_slos(
        "smoke", violate="alert-slab-thrash")))
    assert obs_report.main([str(out / "tenant_trace.jsonl"),
                            "--slo", str(bad)]) == 1
    with pytest.raises(ValueError, match="no such SLO"):
        build_tenant_slos("smoke", violate="not-an-slo")


def test_run_tenant_scenario_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_tenant_scenario(out_dir=str(tmp_path / "t"), verbose=False)
    assert not (tmp_path / "t").exists()
