"""The flagship "heavy traffic" production scenario: the port of
``tpu_sgd/scenario/harness.py``, on the card unless ``device="cpu"``.

One run exercises the whole circulatory system at once:

1. **Continuous retraining** — a
   :class:`~tpu_sgd_torch.replica.ReplicaDriver` fleet (bounded
   staleness, compressed top-k pushes, ONE standby store under the HA
   supervisor — ``tpu_sgd_torch/replica/ha.py``) trains round after
   round on a DRIFTING stream (each round regenerates labels from
   drifted true weights), checkpointing on a cadence through one
   ``CheckpointManager``.  Every worker's gradient sums are one launch
   of the fused gradient kernel on the card.  During one round a worker
   is KILLED by an armed ``replica.push`` failpoint and rejoins under
   the driver's seeded rejoin policy; during a LATER round the PRIMARY
   STORE is killed mid-round and the supervisor promotes the standby
   under live traffic — the SLO gate requires >= 1 failover, a bounded
   ``replica.failover`` span, the failover detector's typed alert, and
   (as ever) zero dropped requests.  The store-kill round is ALSO the
   corruption round: ``corrupt_prob`` damages delta-log records on the
   replication hop the whole round, so the standby being promoted is
   one whose replica stream healed through its consume-site checksums
   — gated by the ``integrity-*`` SLOs (corruption detected, zero
   unhealed, integrity alert fired).
2. **Live serving under admission control** — three endpoints serve
   while the fleet retrains underneath them: a hot-reloading dense
   endpoint (interactive + shadow lanes, per-request deadlines), a
   hot-reloading sparse endpoint (batch lane; 1-D torch sparse rows,
   coalesced into one CSR batch and scored by the CSR kernel on the
   card), and a static multinomial endpoint (batch lane).  The
   registry-backed servers auto-reload each fresh checkpoint.
3. **An overload burst** — the open-loop schedule includes a burst
   phase offered well above serving capacity, so shedding, deadline
   rejection, and displacement actually fire (a scenario that never
   saturates proves nothing about overload).
4. **The SLO gate** — the run's one JSONL trace (listener events,
   spans, counters) feeds ``python -m tpu_sgd_torch.obs.report
   --slo``; the report's exit code is the harness exit code.  The gate
   asserts: per-lane p99 bounds, a bounded interactive-lane shed
   fraction, served-weight staleness (the reload/save join), ZERO
   dropped requests (every submission answered or typed-rejected —
   audited by the loadgen's conservation ledger), >= 2 hot reloads, and
   the worker kill/rejoin.

Deterministic by construction: the arrival schedule, traffic mix, data
drift, and fault schedule all derive from ``seed``.  The widths, rounds,
phases, rates and SLO bounds are the JAX package's, by mode.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np

#: graftlint lock-discipline declaration (tpu_sgd_torch/analysis): EMPTY
#: on purpose — the harness's only cross-thread state is the retrain
#: result dict, written by the retrain thread and read only after
#: ``join()`` (a happens-before edge, no lock needed).
GRAFTLINT_LOCKS: dict = {}

#: declared SLO bounds, by mode.  The p99 bound is deliberately loose
#: for ``smoke`` (a small CI host runs kernel builds and replica
#: training under the serving GIL — wall clocks there are weather).
P99_BOUND_S = {"smoke": 1.5, "full": 1.0}
#: the interactive lane may shed under the deliberate burst, but must
#: stay MOSTLY served.  The shed fraction is a COUNT ratio but its
#: denominator is serving capacity, which on a timeshared CI box is the
#: same weather the p99 bound ducks — so ``smoke`` gets headroom and the
#: production bound of 0.5 stays on the full-size run.
INTERACTIVE_SHED_MAX = {"smoke": 0.7, "full": 0.5}
STALENESS_MAX_S = 60.0


def build_slos(mode: str = "smoke", violate: Optional[str] = None) -> dict:
    """The scenario's declarative SLO document (``obs.report`` format).

    ``violate`` deliberately breaks one named SLO (an impossible bound)
    so CI can assert the gate actually FAILS a bad run — a gate only
    ever seen passing is a gate nobody has tested."""
    slos = [
        {"name": "interactive-p99", "metric": "lane_p99_s",
         "lane": "interactive", "max": P99_BOUND_S[mode]},
        {"name": "serve-sheds-bounded", "metric": "lane_shed_fraction",
         "lane": "interactive", "max": INTERACTIVE_SHED_MAX[mode]},
        {"name": "zero-dropped", "metric": "counter",
         "counter": "scenario.dropped", "max": 0},
        {"name": "zero-transport-errors", "metric": "counter",
         "counter": "scenario.errors", "max": 0},
        {"name": "answered-volume", "metric": "counter",
         "counter": "scenario.answered", "min": 50},
        {"name": "hot-reloads", "metric": "counter",
         "counter": "scenario.reloads", "min": 2},
        {"name": "worker-rejoined", "metric": "counter",
         "counter": "scenario.rejoins", "min": 1},
        {"name": "fresh-weights", "metric": "staleness_s",
         "max": STALENESS_MAX_S},
        {"name": "serve-batches-traced", "metric": "span_count",
         "span": "serve.batch", "min": 1},
        # the live detectors really detected — the burst phase must trip
        # the shed-rate rule and the mid-round worker kill the
        # replica-straggler rule, both as typed obs_alert records on
        # this run's one trace
        {"name": "alert-shed-rate", "metric": "alert_count",
         "rule": "shed-rate", "min": 1},
        {"name": "alert-straggler", "metric": "alert_count",
         "rule": "replica-straggler", "min": 1},
        # the store-kill round really failed over (the promotion span is
        # the downtime surface — its bound is wall clock, so it gets the
        # same CI-weather headroom as the p99), and the failover
        # detector emitted its typed alert
        {"name": "store-failover", "metric": "span_count",
         "span": "replica.failover", "min": 1},
        {"name": "failover-downtime", "metric": "span_max_s",
         "span": "replica.failover",
         "max": (30.0 if mode == "smoke" else 10.0)},
        {"name": "alert-failover", "metric": "alert_count",
         "rule": "failover", "min": 1},
        # the store-kill round runs under active delta-log corruption —
        # the standby's consume-site checksums must have DETECTED frames
        # (corruption really injected), every one must have healed (the
        # unhealed counter stays zero — the retrain thread's own success
        # is the ground truth), and the integrity detector must have
        # turned the frames into a typed alert
        {"name": "integrity-corruption-detected", "metric": "counter",
         "counter": "integrity.corrupt", "min": 1},
        {"name": "integrity-zero-unhealed", "metric": "counter",
         "counter": "integrity.unhealed", "max": 0},
        {"name": "alert-integrity", "metric": "alert_count",
         "rule": "integrity", "min": 1},
    ]
    if violate is not None:
        matched = [s for s in slos if s["name"] == violate]
        if not matched:
            raise ValueError(
                f"--violate {violate!r}: no such SLO "
                f"(have {[s['name'] for s in slos]})")
        s = matched[0]
        # an impossible bound in whichever direction the SLO points
        if "max" in s:
            s["max"] = -1.0
        else:
            s["min"] = 10 ** 9
    return {"slos": slos}


def _drift_data(seed: int, round_index: int, n: int, d: int):
    """Round ``round_index`` of the drifting stream: labels regenerate
    from true weights that rotate a little every round — the live
    retraining actually has something to chase.  Host numpy, drawn
    exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    w_base = rng.normal(size=d).astype(np.float32)
    w_drift = rng.normal(size=d).astype(np.float32)
    theta = 0.15 * round_index
    w_true = (np.cos(theta) * w_base + np.sin(theta) * w_drift).astype(
        np.float32)
    rng_r = np.random.default_rng((seed << 8) + round_index)
    X = rng_r.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true + 0.01 * rng_r.normal(size=n)).astype(np.float32)
    return X, y


def _sparse_row(row: np.ndarray):
    """One request row as a 1-D torch sparse vector on the host (the
    serving engine coalesces a batch of them into one CSR matrix)."""
    import torch

    return torch.from_numpy(row).to_sparse()


def run_scenario(
    seed: int = 0,
    *,
    smoke: bool = True,
    out_dir: Optional[str] = None,
    violate: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> int:
    """Run the full scenario; returns the SLO gate's exit code (0 = all
    SLOs PASS, 1 = violation, 2 = usage error — the ``obs.report``
    contract).  ``out_dir`` keeps the trace/SLO/Chrome artifacts (a
    temp dir is used and discarded otherwise).  ``device``: where the
    replicas train and the endpoints serve (``None``: the card; without
    one this raises — pass ``device="cpu"`` for the plain CPU path)."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.device import resolve_device
    from tpu_sgd_torch.models import (LinearRegressionModel,
                                      MultinomialLogisticRegressionModel)
    from tpu_sgd_torch.obs import report as obs_report
    from tpu_sgd_torch.obs.detect import StragglerDetector, default_detectors
    from tpu_sgd_torch.reliability import (RetryPolicy, corrupt_prob,
                                           fail_nth, inject_faults)
    from tpu_sgd_torch.reliability.failpoints import triggers as fp_triggers
    from tpu_sgd_torch.replica import ReplicaDriver
    from tpu_sgd_torch.scenario.loadgen import (OpenLoopLoadGen, Phase,
                                                TrafficSpec)
    from tpu_sgd_torch.serve import ModelRegistry, Server
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager
    from tpu_sgd_torch.utils.events import JsonLinesEventLog

    mode = "smoke" if smoke else "full"
    # a typo'd --violate must fail BEFORE the run, not after paying it
    slo_doc = build_slos(mode, violate=violate)
    # no card and no device="cpu": raise before anything is written
    dev = resolve_device(device)
    # -- scale knobs -------------------------------------------------------
    d = 16
    n_rows = 512
    workers = 3
    tau = 2
    wire = "topk:0.25"
    iters_per_round = 20 if smoke else 40
    rounds = 3 if smoke else 4          # round 0 seeds, 1.. run live
    ckpt_every = 5
    kill_round = 1        # a WORKER dies and rejoins in this round
    store_kill_round = 2  # the PRIMARY STORE dies in this round
    phases = ([Phase("warm", 0.8, 250), Phase("burst", 1.5, 4000),
               Phase("cool", 0.8, 250)] if smoke else
              [Phase("warm", 2.0, 400), Phase("burst", 4.0, 6000),
               Phase("cool", 2.0, 400)])

    def say(msg: str):
        if verbose:
            print(f"[scenario seed={seed} mode={mode}] {msg}", flush=True)

    owned_tmp = None
    if out_dir is None:
        owned_tmp = tempfile.TemporaryDirectory()
        out_dir = owned_tmp.name
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "scenario_trace.jsonl")
    if os.path.exists(trace):
        os.truncate(trace, 0)  # a rerun must not concatenate traces
    flight_path = os.path.join(out_dir, "flightrec.jsonl")
    if os.path.exists(flight_path):
        os.remove(flight_path)  # a stale dump must not pass this run's check
    ckpt_dir = os.path.join(out_dir, "ckpt")

    event_log = JsonLinesEventLog(trace)
    # ONE stream: listener events + spans + counters, with the live
    # plane armed — 0.1s windows, the default detector set with ONE
    # tuning: the straggler threshold drops to 5 fleet steps.  The rule
    # is cumulative over fleet progress (load-invariant), and at tau=2 x
    # 3 workers the SSP progress bound caps a LIVE worker's lag at
    # ~(workers-1)*tau = 4 peer steps — 5 is the smallest threshold only
    # a dead worker can reach, which keeps detection inside the 0.5s
    # rejoin window even when ambient load slows the fleet to a crawl.
    # Flight recorder teed over the same sink, dumping on every alert
    # transition.
    detectors = ([det for det in default_detectors()
                  if det.rule != "replica-straggler"]
                 + [StragglerDetector(min_fleet_steps=5)])
    obs.enable(event_log, detect=True, window_s=0.1,
               detectors=detectors, flightrec=flight_path)
    try:
        manager = CheckpointManager(ckpt_dir, keep=64)

        # rounds resume from the shared checkpoint directory, so budgets
        # are CUMULATIVE; the kill round (and everything after, to keep
        # the budgets monotone) gets extra runway — the rejoin races the
        # surviving workers' remaining work, and a round that ends
        # before the seeded backoff comes due would never rejoin.  The
        # bonus is sized for the straggler detector: the victim stays
        # dead for the full 0.5s rejoin backoff, so the survivors need
        # enough budget to keep stepping PAST it (the cumulative rule
        # needs 5 fleet steps during the dead period; the rejoin needs
        # the round still running when the backoff expires)
        kill_bonus = 200 if smoke else 240

        def _budget(round_index: int) -> int:
            return (iters_per_round * (round_index + 1)
                    + (kill_bonus if round_index >= kill_round else 0))

        def make_driver(round_index: int) -> ReplicaDriver:
            return (ReplicaDriver(device=dev)
                    .set_num_iterations(_budget(round_index))
                    .set_step_size(0.1).set_mini_batch_fraction(1.0)
                    .set_convergence_tol(0.0).set_reg_param(0.01)
                    .set_seed(seed + 7).set_workers(workers)
                    .set_staleness(tau).set_wire_compress(wire)
                    # ONE standby: every round runs the HA store —
                    # rounds resume across epochs through the shared
                    # checkpoint directory's (epoch, version) ordering;
                    # the store-kill round promotes it live
                    .set_standbys(1)
                    .set_checkpoint(manager, every=ckpt_every)
                    # jitter=0: the killed worker's dead period is a
                    # deterministic 0.5s EVERY run, not a lucky draw —
                    # the straggler-alert SLO gates on the fleet
                    # accumulating its 5 steps inside that window
                    .set_rejoin(RetryPolicy(max_attempts=5,
                                            base_backoff_s=0.5,
                                            jitter=0.0,
                                            seed=seed + 43)))

        # -- round 0: seed the first servable versions ---------------------
        w0 = np.zeros(d, np.float32)
        make_driver(0).optimize_with_history(
            _drift_data(seed, 0, n_rows, d), w0)
        if not manager.versions():
            raise AssertionError("round 0 wrote no checkpoints")
        say(f"round 0 trained: versions {manager.versions()}")

        # -- serving tier --------------------------------------------------
        registry = ModelRegistry(
            manager, lambda w, b: LinearRegressionModel(w, b),
            device=dev)
        rng0 = np.random.default_rng(seed)
        live = Server(registry=registry, max_batch=32, max_latency_s=0.004,
                      max_queue=64, event_log=event_log,
                      reload_interval_s=0.05, device=dev)
        sparse_srv = Server(registry=registry, max_batch=32,
                            max_latency_s=0.01, max_queue=64,
                            event_log=event_log, reload_interval_s=0.05,
                            device=dev)
        n_classes = 4
        multi_model = MultinomialLogisticRegressionModel(
            rng0.normal(size=(n_classes - 1) * d).astype(np.float32), 0.0,
            num_classes=n_classes, num_features=d, device=dev)
        multi_srv = Server(multi_model, max_batch=32, max_latency_s=0.01,
                           max_queue=64, event_log=event_log, device=dev)

        # request pools (pre-built so the generator thread never pays
        # row assembly on the submit path)
        dense_rows = rng0.normal(size=(256, d)).astype(np.float32)
        sparse_rows = []
        for _ in range(64):
            row = np.where(rng0.random(d) < 0.25,
                           rng0.normal(size=d), 0.0).astype(np.float32)
            row[0] = 1.0  # never all-zero
            sparse_rows.append(_sparse_row(row))

        # warm every build and shape before traffic starts, so the
        # measured run never pays a compiler on the serving path (a real
        # endpoint warms at deploy): the dense bucketed route on every
        # bucket, one sparse batch through the CSR kernel (its nvcc
        # build at first use) and one multinomial batch
        model0 = registry.model()
        for b in live.engine.buckets:
            live.engine.predict_batch(model0, dense_rows[:1].repeat(b, 0))
        sparse_srv.engine.predict_batch(model0, sparse_rows[0])
        multi_srv.engine.predict_batch(multi_model, dense_rows[:2])

        # -- the retraining loop (background) ------------------------------
        retrain_result: dict = {}

        def retrain():
            try:
                rejoins = 0
                failovers = 0
                for r in range(1, rounds):
                    drv = make_driver(r)
                    data = _drift_data(seed, r, n_rows, d)
                    if r == kill_round:
                        # one-shot kill mid-round: the nth push of this
                        # round dies, the worker deregisters, and the
                        # driver rejoins it with seeded backoff.  The
                        # standby drains this whole round's delta log,
                        # so the log wire runs under corrupt_prob here
                        # too — every damaged record is detected by the
                        # consume-site checksum and healed by re-reading
                        # the intact retained copy
                        with inject_faults({
                                "replica.push": fail_nth(
                                    iters_per_round // 2),
                                "replica.log.record": corrupt_prob(
                                    0.05, seed=seed + 87)}):
                            drv.optimize_with_history(data, w0)
                            corruptions = fp_triggers(
                                "replica.log.record")
                        retrain_result["corruptions_healed"] = \
                            retrain_result.get("corruptions_healed",
                                               0) + corruptions
                        members = drv.last_membership_snapshot
                        rejoins += sum(max(0, m["joins"] - 1)
                                       for m in members.values())
                    elif r == store_kill_round:
                        # the PRIMARY STORE dies a few versions into
                        # this round's fresh work (the listener fires
                        # per applied version, so the kill lands at a
                        # deterministic version offset regardless of
                        # host load) and the supervisor promotes the
                        # standby under live serving traffic.  The SAME
                        # round is the CORRUPTION round: corrupt_prob
                        # silently damages delta-log records on the
                        # replication hop, the standby's consume-site
                        # checksum detects each one and heals by
                        # re-reading the intact retained record — so the
                        # store being promoted under traffic is one
                        # whose replica stream was under active
                        # corruption the whole time
                        start_v = manager.latest_version() or 0

                        class _KillStoreAt:
                            def __init__(self):
                                self.done = False

                            def on_run_start(self, c): ...

                            def on_run_end(self, ev): ...

                            def on_iteration(self, ev):
                                if (not self.done
                                        and ev.iteration >= start_v + 8):
                                    self.done = True
                                    drv.kill_primary()

                        drv.set_listener(_KillStoreAt())
                        with inject_faults({
                                "replica.log.record": corrupt_prob(
                                    0.35, seed=seed + 88)}):
                            drv.optimize_with_history(data, w0)
                            corruptions = fp_triggers(
                                "replica.log.record")
                        failovers += drv.last_failover_snapshot[
                            "failovers"]
                        retrain_result["corruptions_healed"] = \
                            retrain_result.get("corruptions_healed",
                                               0) + corruptions
                    else:
                        drv.optimize_with_history(data, w0)
                    # the reload CADENCE: the auto-reload scan catches
                    # mid-round checkpoints under traffic; this explicit
                    # end-of-round reload guarantees every round's final
                    # version reaches serving even when the load phase
                    # ends before the round does
                    live.reload()
                    say(f"round {r} retrained to version "
                        f"{manager.latest_version()}, serving "
                        f"version {registry.current_version}")
                retrain_result["rejoins"] = rejoins
                retrain_result["failovers"] = failovers
            except BaseException as e:  # surfaced after join
                retrain_result["error"] = e

        # -- traffic -------------------------------------------------------
        mix = [
            TrafficSpec("dense-interactive", "interactive", 0.60,
                        deadline_s=0.25),
            TrafficSpec("dense-shadow", "shadow", 0.15),
            TrafficSpec("sparse-batch", "batch", 0.15),
            TrafficSpec("multinomial-batch", "batch", 0.10),
        ]

        def route(spec: TrafficSpec, i: int, rng):
            if spec.name == "dense-interactive":
                return live.submit(dense_rows[i % len(dense_rows)],
                                   lane=spec.lane,
                                   deadline_s=spec.deadline_s)
            if spec.name == "dense-shadow":
                return live.submit(dense_rows[(i * 7) % len(dense_rows)],
                                   lane=spec.lane)
            if spec.name == "sparse-batch":
                return sparse_srv.submit(sparse_rows[i % len(sparse_rows)],
                                         lane=spec.lane)
            return multi_srv.submit(dense_rows[(i * 3) % len(dense_rows)],
                                    lane=spec.lane)

        gen = OpenLoopLoadGen(route, mix, phases, seed=seed + 1)

        t_run = time.perf_counter()
        retrain_thread = threading.Thread(target=retrain,
                                          name="scenario-retrain",
                                          daemon=True)
        with live, sparse_srv, multi_srv:
            retrain_thread.start()
            load_report = gen.run()
            retrain_thread.join(timeout=600.0)
            if retrain_thread.is_alive():
                raise AssertionError("retraining hung")
            healthz = live.healthz()
        wall_s = time.perf_counter() - t_run

        if "error" in retrain_result:
            raise AssertionError(
                "retraining failed under live traffic"
            ) from retrain_result["error"]

        # -- client-side ledger -> trace counters (the SLO inputs) ---------
        totals = load_report["totals"]
        hot_reloads = registry.reload_count - 1  # first swap = initial load
        rejoins = retrain_result.get("rejoins", 0)
        failovers = retrain_result.get("failovers", 0)
        obs.inc("scenario.answered", totals["answered"])
        obs.inc("scenario.rejected",
                totals["rejected"] + totals["displaced"])
        obs.inc("scenario.errors", totals["errored"])
        obs.inc("scenario.dropped", totals["dropped"])
        obs.inc("scenario.reloads", hot_reloads)
        obs.inc("scenario.rejoins", rejoins)
        obs.inc("scenario.failovers", failovers)

        say(f"load: {json.dumps(totals)} over {wall_s:.1f}s; "
            f"hot_reloads={hot_reloads} rejoins={rejoins} "
            f"failovers={failovers} breaker={healthz.get('breaker')}")
        say(f"lanes: {json.dumps(load_report['lanes'])}")

        # structural invariants the SLO file also gates on — checked
        # here too so a failure names the subsystem, not just the SLO
        if totals["submitted"] != (
                totals["answered"] + totals["rejected"]
                + totals["displaced"] + totals["errored"]
                + totals["dropped"]):
            raise AssertionError(f"ledger does not conserve: {totals}")
        if hot_reloads < 2:
            raise AssertionError(
                f"serving saw only {hot_reloads} hot reload(s); the live "
                "retraining never reached the endpoint")

        summary = {"seed": seed, "mode": mode, "device": str(dev),
                   "wall_s": wall_s,
                   "totals": totals,
                   "errors_by_class": load_report["error_classes"],
                   "lanes": load_report["lanes"],
                   "classes": load_report["classes"],
                   "phases": load_report["phases"],
                   "hot_reloads": hot_reloads, "rejoins": rejoins,
                   "failovers": failovers,
                   "corruptions_healed": retrain_result.get(
                       "corruptions_healed", 0),
                   "healthz": healthz}
        with open(os.path.join(out_dir, "scenario_summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=2, default=str)
    finally:
        # flushes the trailing detector window, then the final counter
        # snapshot (the alert SLOs need both evaluated before teardown)
        obs.disable()
        event_log.close()

    # -- flight record: dumped on the detector trips, schema-valid ---------
    if not os.path.exists(flight_path):
        raise AssertionError(
            "the detectors tripped (or must have) but no flight record "
            f"was dumped at {flight_path}")
    frec = JsonLinesEventLog.read(flight_path)
    if not (frec and frec[0]["kind"] == "flightrec_meta"):
        raise AssertionError("flight record missing its meta header")
    if not {"obs_window"} & {r["kind"] for r in frec}:
        raise AssertionError("flight record carries no window snapshots")

    # -- the SLO gate: obs.report's exit code IS ours ----------------------
    slo_path = os.path.join(out_dir, "scenario_slo.json")
    with open(slo_path, "w") as f:
        json.dump(slo_doc, f, indent=2)
    chrome = os.path.join(out_dir, "scenario_trace.chrome.json")
    rc = obs_report.main([trace, "--slo", slo_path, "--chrome", chrome])
    if owned_tmp is not None:
        owned_tmp.cleanup()
    return rc
