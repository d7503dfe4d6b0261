"""The port's flagship production scenario (``tpu_sgd_torch/scenario``:
``loadgen.py``, ``harness.py``) on the CPU, held against the JAX
package's ``tpu_sgd/scenario`` and its tests (``tests/test_scenario.py``,
whose names the twins here keep).

* exact parity -- both packages' ``build_slos`` give the same document
  for each mode and every ``violate`` name (an unknown name raises in
  both), and ``_drift_data`` gives bitwise equal arrays;
* twins of the loadgen and lane tests, through the port's loadgen and
  ``obs.report``;
* one smoke run on the CPU (``device="cpu"``), once per module: its trace
  meets every count, span and alert SLO, one by one through the port's
  ``obs.report.evaluate_slos``; its ledger conserves; its flight record
  is schema-valid; and the run was made with ``violate=`` so its own gate
  must fail.  The wall-clock bounds (``interactive-p99``,
  ``serve-sheds-bounded``, ``failover-downtime``) are held on the card by
  ``chip_smoke.py`` phase ``scenario``: on a CPU shared with the rest of
  the suite they measure the host's load.
"""

import json
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from tpu_sgd.scenario import build_slos as jbuild_slos
from tpu_sgd.scenario import harness as jharness
from tpu_sgd_torch.obs import counters
from tpu_sgd_torch.obs import report as obs_report
from tpu_sgd_torch.scenario import build_slos, harness, run_scenario
from tpu_sgd_torch.scenario.loadgen import OpenLoopLoadGen, Phase, TrafficSpec
from tpu_sgd_torch.serve.batcher import Overloaded

#: the SLOs whose bound is a wall-clock time or a share of a wall-clock
#: capacity: held on the card, not on a loaded CPU
WALL_CLOCK_SLOS = ("interactive-p99", "serve-sheds-bounded",
                   "failover-downtime")
SLO_NAMES = [s["name"] for s in jbuild_slos("smoke")["slos"]]
#: the run's own gate is given this one broken SLO: it must fail
VIOLATED = "zero-dropped"


# -- exact parity with the JAX package --------------------------------------
@pytest.mark.parametrize("violate", [None] + SLO_NAMES)
@pytest.mark.parametrize("mode", ["smoke", "full"])
def test_build_slos_equals_the_jax_package(mode, violate):
    assert build_slos(mode, violate=violate) == jbuild_slos(
        mode, violate=violate)


def test_build_slos_unknown_name_raises_in_both():
    for fn in (build_slos, jbuild_slos):
        with pytest.raises(ValueError, match="no such SLO"):
            fn("full", violate="not-an-slo")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drift_data_bitwise_the_jax_package(seed):
    for r in range(4):
        X, y = harness._drift_data(seed, r, 512, 16)
        jX, jy = jharness._drift_data(seed, r, 512, 16)
        assert X.dtype == jX.dtype == np.float32
        assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()


def test_scenario_knobs_equal_the_jax_package():
    """The bounds by mode are the JAX package's (no new knob)."""
    assert harness.P99_BOUND_S == jharness.P99_BOUND_S
    assert harness.INTERACTIVE_SHED_MAX == jharness.INTERACTIVE_SHED_MAX
    assert harness.STALENESS_MAX_S == jharness.STALENESS_MAX_S


# -- loadgen ledger (twins) -----------------------------------------------
def test_loadgen_ledger_conserves_every_outcome():
    """Answered, typed-rejected at submit, displaced (typed via the
    future), errored, and dropped (never resolved) must sum to
    submitted — the conservation the scenario SLO gate audits."""
    hang = Future()  # never resolves: the one deliberate drop

    def submit(spec, i, rng):
        if i % 7 == 3:
            raise Overloaded("shed", spec.lane)
        fut = Future()
        if i == 12:  # not on the i%7==3 reject grid: really submitted
            return hang
        if i % 11 == 5:
            fut.set_exception(ValueError("transport error"))
        elif i % 13 == 6:
            fut.set_exception(Overloaded("displaced", spec.lane))
        else:
            fut.set_result(1.0)
        return fut

    gen = OpenLoopLoadGen(
        submit,
        [TrafficSpec("a", "interactive", 0.7, deadline_s=0.1),
         TrafficSpec("b", "batch", 0.3)],
        [Phase("p", 0.25, 400)],
        seed=0, drain_timeout_s=0.5)
    rep = gen.run()
    t = rep["totals"]
    assert t["submitted"] > 20
    assert t["submitted"] == (t["answered"] + t["rejected"]
                              + t["displaced"] + t["errored"]
                              + t["dropped"])
    assert t["dropped"] == 1  # exactly the hung future
    assert t["rejected"] > 0 and t["errored"] > 0 and t["displaced"] > 0
    for lane in rep["lanes"].values():
        assert lane["submitted"] == sum(
            lane[k] for k in ("answered", "rejected", "displaced",
                              "errored", "dropped"))
    assert rep["phases"]["p"]["offered"] >= t["submitted"]


def test_loadgen_latency_percentiles_recorded():
    def submit(spec, i, rng):
        fut = Future()
        fut.set_result(0.0)
        return fut

    gen = OpenLoopLoadGen(
        submit, [TrafficSpec("a", "interactive", 1.0)],
        [Phase("p", 0.15, 300)], seed=1)
    rep = gen.run()
    cls = rep["classes"]["a"]
    assert cls["answered"] > 0
    assert 0.0 <= cls["p50_s"] <= cls["p99_s"]


def test_loadgen_rejects_empty_or_weightless_mix():
    with pytest.raises(ValueError, match="empty"):
        OpenLoopLoadGen(lambda *a: None, [], [Phase("p", 0.1, 1)])
    with pytest.raises(ValueError, match="positive"):
        OpenLoopLoadGen(lambda *a: None, [TrafficSpec("a", "batch", 0.0)],
                        [Phase("p", 0.1, 1)])


# -- per-lane SLO metrics over a synthetic trace (twins) ------------------
def _lane_trace():
    return [
        {"kind": "serve_batch", "ts": 1.0, "batch_size": 4,
         "lanes": {"interactive": {"n": 3, "max_latency_s": 0.010},
                   "batch": {"n": 1, "max_latency_s": 0.200}}},
        {"kind": "serve_batch", "ts": 2.0, "batch_size": 2,
         "lanes": {"interactive": {"n": 2, "max_latency_s": 0.030}}},
        {"kind": "metric_counters", "ts": 3.0, "counters": {
            "serve.admitted.interactive": {"n": 90, "bytes": 0},
            "serve.rejected.interactive": {"n": 6, "bytes": 0},
            "serve.shed.interactive": {"n": 4, "bytes": 0},
            "serve.shed.shadow": {"n": 40, "bytes": 0},
            "serve.admitted.batch": {"n": 20, "bytes": 0},
            "serve.displaced.batch": {"n": 5, "bytes": 0},
        }},
    ]


def test_lane_latency_and_admission_stats():
    lat = obs_report.lane_latency_stats(_lane_trace())
    assert lat["interactive"]["requests"] == 5
    assert lat["interactive"]["batches"] == 2
    assert lat["interactive"]["p99_s"] == pytest.approx(0.030)
    assert lat["batch"]["p99_s"] == pytest.approx(0.200)
    adm = obs_report.lane_admission_stats(_lane_trace())
    assert adm["interactive"]["offered"] == 100
    assert adm["interactive"]["reject_rate"] == pytest.approx(0.10)
    assert adm["shadow"]["offered"] == 40
    assert adm["shadow"]["reject_rate"] == pytest.approx(1.0)
    assert adm["batch"]["offered"] == 20
    assert adm["batch"]["reject_rate"] == pytest.approx(0.25)


def test_lane_slo_metrics_evaluate_and_gate():
    verdicts = obs_report.evaluate_slos(_lane_trace(), {"slos": [
        {"name": "i-p99", "metric": "lane_p99_s",
         "lane": "interactive", "max": 0.05},
        {"name": "b-p99-too-tight", "metric": "lane_p99_s",
         "lane": "batch", "max": 0.05},
        {"name": "i-sheds", "metric": "lane_shed_fraction",
         "lane": "interactive", "max": 0.5},
    ]})
    by_name = {v["name"]: v for v in verdicts}
    assert by_name["i-p99"]["ok"]
    assert not by_name["b-p99-too-tight"]["ok"]
    assert by_name["i-sheds"]["ok"]
    assert by_name["i-sheds"]["value"] == pytest.approx(0.10)


def test_lane_slo_unevaluable_is_violation_not_free_pass():
    verdicts = obs_report.evaluate_slos(_lane_trace(), {"slos": [
        {"name": "ghost-p99", "metric": "lane_p99_s",
         "lane": "ghost", "max": 1.0},
        {"name": "ghost-sheds", "metric": "lane_shed_fraction",
         "lane": "ghost", "max": 1.0},
    ]})
    assert all(v["value"] is None and not v["ok"] for v in verdicts)


def test_lane_slo_metrics_require_lane_field():
    with pytest.raises(ValueError, match="lane"):
        obs_report.evaluate_slos(
            _lane_trace(),
            {"slos": [{"name": "x", "metric": "lane_p99_s", "max": 1.0}]})


def test_build_slos_violation_spelling():
    doc = build_slos("smoke", violate="interactive-p99")
    slo = [s for s in doc["slos"] if s["name"] == "interactive-p99"][0]
    assert slo["max"] < 0  # impossible: p99 is never negative
    with pytest.raises(ValueError, match="no such SLO"):
        build_slos("smoke", violate="not-an-slo")


# -- the sparse endpoint's rows ---------------------------------------------
def test_sparse_row_of_column_zero_only_scores_through_the_csr_route(
        monkeypatch):
    """A request row whose only entry is column 0 (the harness sets it on
    every row) is a 1-D torch sparse vector, is coalesced with others into
    one CSR batch, and is scored through ``cuda_kernels.csr_margins`` —
    the CSR kernel's wrapper, never a dense fallback."""
    from tpu_sgd_torch import LinearRegressionModel
    from tpu_sgd_torch.ops import cuda_kernels as ck
    from tpu_sgd_torch.serve import PredictEngine, stack_rows

    d = 16
    only0 = np.zeros(d, np.float32)
    only0[0] = 1.0
    other = np.zeros(d, np.float32)
    other[[0, 3, 9]] = [1.0, -2.0, 0.5]
    rows = [harness._sparse_row(r) for r in (only0, other, only0)]
    for r, dense in zip(rows, (only0, other)):
        assert r.layout == torch.sparse_coo and r.dim() == 1
        np.testing.assert_array_equal(r.to_dense().numpy(), dense)
    calls = []
    real = ck.csr_margins

    def spy(X, rhs, mask=None):
        calls.append((X.layout, tuple(X.shape)))
        return real(X, rhs, mask)

    monkeypatch.setattr(ck, "csr_margins", spy)
    w = np.random.default_rng(0).normal(size=d).astype(np.float32)
    model = LinearRegressionModel(w, 0.25, device="cpu")
    engine = PredictEngine(device="cpu")
    one = engine.predict_batch(model, rows[0])
    batch = engine.predict_batch(model, stack_rows(rows))
    assert calls == [(torch.sparse_csr, (1, d)), (torch.sparse_csr, (3, d))]
    np.testing.assert_allclose(one, [w[0] + 0.25], rtol=1e-6)
    np.testing.assert_allclose(
        batch, np.stack([only0, other, only0]) @ w + 0.25, rtol=1e-6)


# -- the full smoke scenario on the CPU, once per module ----------------------
@pytest.fixture(scope="module")
def scenario_run(tmp_path_factory):
    """One smoke run on the CPU, its gate given ``violate=VIOLATED``.  The
    trace is the same whatever the SLO document says, so the tests below
    evaluate it against the unbroken document.  One torch thread: the
    run's threads share the host with the rest of the suite."""
    out = tmp_path_factory.mktemp("torch_scenario")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # the trace's one counter snapshot is cumulative in the process:
    # counts start at 0 here, so no earlier test's counts reach the gate
    counters.reset()
    try:
        rc = run_scenario(seed=0, smoke=True, out_dir=str(out),
                          violate=VIOLATED, verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    records = obs_report.load_trace(str(out / "scenario_trace.jsonl"))
    return rc, out, records


@pytest.mark.parametrize("name", [n for n in SLO_NAMES
                                  if n not in WALL_CLOCK_SLOS])
def test_scenario_smoke_count_span_and_alert_slos_pass(scenario_run, name):
    _, _, records = scenario_run
    doc = build_slos("smoke")
    (verdict,) = [v for v in obs_report.evaluate_slos(records, doc)
                  if v["name"] == name]
    assert verdict["ok"], verdict


def test_scenario_smoke_ledger_conserves(scenario_run):
    _, out, _ = scenario_run
    summary = json.loads((out / "scenario_summary.json").read_text())
    assert summary["device"] == "cpu"
    t = summary["totals"]
    assert t["dropped"] == 0 and t["errored"] == 0
    assert t["answered"] >= 50
    assert t["submitted"] == (t["answered"] + t["rejected"]
                              + t["displaced"] + t["errored"]
                              + t["dropped"])
    assert summary["hot_reloads"] >= 2
    assert summary["rejoins"] >= 1 and summary["failovers"] >= 1
    assert summary["corruptions_healed"] >= 1
    for lane in summary["lanes"].values():
        assert lane["submitted"] == sum(
            lane[k] for k in ("answered", "rejected", "displaced",
                              "errored", "dropped"))


def test_scenario_flight_record_has_meta_and_windows(scenario_run):
    from tpu_sgd_torch.utils.events import JsonLinesEventLog

    _, out, _ = scenario_run
    frec = JsonLinesEventLog.read(str(out / "flightrec.jsonl"))
    assert frec[0]["kind"] == "flightrec_meta"
    assert "obs_window" in {r["kind"] for r in frec}


def test_scenario_trace_shows_live_system(scenario_run):
    """The trace really contains the whole circulatory system: serve
    batches with lane composition, checkpoint saves, hot reloads, and
    replica pushes — not just a load test against a static model."""
    _, _, records = scenario_run
    kinds = {r.get("kind") for r in records}
    assert {"serve_batch", "serve_reload", "trace_span",
            "metric_counters"} <= kinds
    reloads = [r for r in records if r.get("kind") == "serve_reload"
               and r.get("event") == "reloaded"]
    assert len(reloads) >= 3  # initial load + >= 2 hot reloads
    lat = obs_report.lane_latency_stats(records)
    assert "interactive" in lat and "batch" in lat
    stale = obs_report.staleness_samples(records)
    assert stale and all(s["staleness_s"] >= 0.0 for s in stale)


def test_scenario_violated_slo_fails_the_gate(scenario_run, tmp_path):
    """The run's own gate had one impossible bound: it exited 1, and its
    SLO file holds that bound.  The report CLI on the same trace fails
    another violated document too."""
    rc, out, records = scenario_run
    assert rc == 1
    doc = json.loads((out / "scenario_slo.json").read_text())
    assert doc == build_slos("smoke", violate=VIOLATED)
    (verdict,) = [v for v in obs_report.evaluate_slos(records, doc)
                  if v["name"] == VIOLATED]
    assert not verdict["ok"]
    bad = tmp_path / "bad_slo.json"
    bad.write_text(json.dumps(build_slos(
        "smoke", violate="interactive-p99")))
    assert obs_report.main(
        [str(out / "scenario_trace.jsonl"), "--slo", str(bad)]) == 1


def test_run_scenario_without_a_card_raises(tmp_path):
    """No card and no ``device="cpu"``: the scenario raises before it
    writes anything, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(out_dir=str(tmp_path / "s"), verbose=False)
    assert not (tmp_path / "s").exists()
