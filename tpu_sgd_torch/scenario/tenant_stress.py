"""Multi-tenant serving stress scenario: the port of
``tpu_sgd/scenario/tenant_stress.py``, on the card unless
``device="cpu"``.

The tenant-plane sibling of ``scenario/harness.py``: one run drives a
:class:`~tpu_sgd_torch.tenant.TenantServer` the way production would —

1. **Zipf traffic over thousands of tenants** — request tenant ids draw
   from a Zipf-shaped popularity curve, so a small head of hot tenants
   dominates while a long cold tail forces admission-on-miss; the slab
   is sized to hold the head, NOT the population.
2. **A continuous retraining trickle** — a background thread publishes
   fresh weights for hot tenants the whole run (``tenant.swap`` hot
   reloads landing under live traffic, at per-tenant granularity).
3. **Chaos phases** — a slab-EVICTION storm (a rotating sweep of cold
   tenants forced resident, churning the LRU well past capacity) and a
   RELOAD storm (rapid-fire publishes to the hottest tenants) run
   concurrently with the traffic's storm phase.
4. **The SLO gate** — same contract as the flagship scenario: the one
   JSONL trace feeds ``obs.report --slo`` and its exit code is ours.
   Gated: zero dropped / zero transport errors (the loadgen's
   conservation ledger), answered volume, the retrain trickle actually
   reached serving (``tenant.swap``), the eviction storm actually
   churned (``tenant.evict``), the opt-in ``SlabThrashDetector``
   tripped a typed alert, tenant batches traced, and a loose
   interactive p99.

Deterministic by construction: traffic schedule, Zipf draws, trickle
and chaos orders all derive from ``seed``.  The widths, tenant counts,
slab capacity, phases, rates and SLO bounds are the JAX package's, by
mode.
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
#: on purpose — the chaos/trickle threads share only a stop Event and
#: their own tally dicts, read after join() (a happens-before edge).
GRAFTLINT_LOCKS: dict = {}

P99_BOUND_S = {"smoke": 2.0, "full": 1.0}


def build_tenant_slos(mode: str = "smoke",
                      violate: Optional[str] = None) -> dict:
    """The tenant scenario's declarative SLO document (``obs.report``
    format); ``violate`` breaks one named SLO so CI can prove the gate
    fails a bad run (the harness's own convention)."""
    slos = [
        {"name": "tenant-interactive-p99", "metric": "lane_p99_s",
         "lane": "interactive", "max": P99_BOUND_S[mode]},
        {"name": "zero-dropped", "metric": "counter",
         "counter": "scenario.dropped", "max": 0},
        {"name": "zero-transport-errors", "metric": "counter",
         "counter": "scenario.errors", "max": 0},
        {"name": "answered-volume", "metric": "counter",
         "counter": "scenario.answered", "min": 50},
        {"name": "tenant-batches-traced", "metric": "span_count",
         "span": "tenant.batch", "min": 1},
        # the retraining trickle really reached serving: hot reloads of
        # RESIDENT rows landed under traffic
        {"name": "retrain-trickle-served", "metric": "counter",
         "counter": "tenant.swap", "min": 5},
        # the eviction storm really churned the LRU past capacity
        {"name": "eviction-storm-churned", "metric": "counter",
         "counter": "tenant.evict", "min": 10},
        # ...and the opt-in detector turned the churn into a typed alert
        {"name": "alert-slab-thrash", "metric": "alert_count",
         "rule": "slab-thrash", "min": 1},
    ]
    if violate is not None:
        matched = [s for s in slos if s["name"] == violate]
        if not matched:
            raise ValueError(
                f"--violate {violate!r}: no such SLO "
                f"(have {[s['name'] for s in slos]})")
        s = matched[0]
        if "max" in s:
            s["max"] = -1.0
        else:
            s["min"] = 10 ** 9
    return {"slos": slos}


def _zipf_tenants(rng, n_tenants: int, size: int, a: float = 1.2):
    """``size`` tenant ids drawn Zipf(a)-shaped over ``[0, n_tenants)``
    via an explicit normalized pmf — bounded support by construction
    (``rng.zipf`` is unbounded), deterministic in the generator."""
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    p = ranks ** -a
    p /= p.sum()
    return rng.choice(n_tenants, size=size, p=p)


def run_tenant_scenario(
    seed: int = 0,
    *,
    smoke: bool = True,
    out_dir: Optional[str] = None,
    violate: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> int:
    """Run the multi-tenant stress scenario; returns the SLO gate's
    exit code (the ``obs.report`` contract — 0 pass, 1 violation).
    ``device``: where the slab lives and batches are scored (``None``:
    the card; without one this raises — pass ``device="cpu"`` for the
    plain CPU path)."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.device import resolve_device
    from tpu_sgd_torch.obs import report as obs_report
    from tpu_sgd_torch.obs.detect import SlabThrashDetector, default_detectors
    from tpu_sgd_torch.scenario.loadgen import (OpenLoopLoadGen, Phase,
                                                TrafficSpec)
    from tpu_sgd_torch.tenant import TenantModelStore, TenantServer
    from tpu_sgd_torch.utils.events import JsonLinesEventLog

    mode = "smoke" if smoke else "full"
    slo_doc = build_tenant_slos(mode, violate=violate)
    # no card and no device="cpu": raise before anything is written
    dev = resolve_device(device)
    # -- scale knobs -------------------------------------------------------
    d = 16 if smoke else 32
    n_tenants = 300 if smoke else 4000
    capacity = 64 if smoke else 256      # holds the Zipf head only
    phases = ([Phase("warm", 0.6, 200), Phase("storm", 1.5, 800),
               Phase("cool", 0.6, 200)] if smoke else
              [Phase("warm", 2.0, 500), Phase("storm", 5.0, 3000),
               Phase("cool", 2.0, 500)])

    def say(msg: str):
        if verbose:
            print(f"[tenant-scenario seed={seed} mode={mode}] {msg}",
                  flush=True)

    owned_tmp = None
    if out_dir is None:
        owned_tmp = tempfile.TemporaryDirectory()
        out_dir = owned_tmp.name
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "tenant_trace.jsonl")
    if os.path.exists(trace):
        os.truncate(trace, 0)

    event_log = JsonLinesEventLog(trace)
    # the default live plane PLUS the opt-in slab detector — min_admits
    # lowered to the eviction storm's realistic per-window admission
    # rate (each admission pays a checkpoint restore from disk)
    obs.enable(event_log, detect=True, window_s=0.25,
               detectors=default_detectors()
               + [SlabThrashDetector(min_admits=8)])
    try:
        rng0 = np.random.default_rng(seed)
        store_dir = os.path.join(out_dir, "tenants")
        store = TenantModelStore(store_dir, capacity=capacity, d=d,
                                 keep=2, device=dev)
        # every tenant gets an initial published model (its durable
        # checkpoint — cold tenants restore from here on admission)
        base = rng0.normal(size=(n_tenants, d)).astype(np.float32)
        for t in range(n_tenants):
            store.publish(t, base[t], intercept=0.01 * (t % 7))
        say(f"published {n_tenants} tenants under {store_dir}")

        srv = TenantServer(store, max_batch=32, max_latency_s=0.004,
                           max_queue=256, event_log=event_log)

        # pre-drawn request schedule: Zipf tenant per request, features
        # from a small pool (the generator thread never pays assembly)
        pool = rng0.normal(size=(256, d)).astype(np.float32)
        zipf_ids = _zipf_tenants(rng0, n_tenants, 8192)
        hot = np.unique(zipf_ids[:capacity * 4])[:max(8, capacity // 4)]
        cold_base = n_tenants - max(2 * capacity, 16)

        # warm the slab with the Zipf head and the scoring routes with
        # every bucket shape (the mixed-tenant gather and the one-tenant
        # matvec), on the engine's device, so the measured run never
        # pays a first-use build or a new shape on the serving path (a
        # real endpoint warms at deploy)
        store.slots_for(np.unique(zipf_ids[:512])[:capacity])
        for b in srv.engine.buckets:
            ids = np.resize(np.unique(zipf_ids[:64])[:8], b)
            srv.engine.predict_batch(ids, pool[:1].repeat(b, 0))
            srv.engine.predict_batch(np.full(b, int(ids[0])),
                                     pool[:1].repeat(b, 0))
        compiles_warm = srv.engine.compile_count

        # -- background trickle + chaos ------------------------------------
        stop = threading.Event()
        tallies = {"trickle": 0, "evict_sweep": 0, "reload_storm": 0}

        def trickle():
            # the continuous per-tenant retraining trickle: fresh
            # weights for Zipf-hot tenants land all run long
            rng = np.random.default_rng(seed + 11)
            while not stop.is_set():
                tid = int(hot[rng.integers(len(hot))])
                store.publish(tid, rng.normal(size=d).astype(np.float32))
                tallies["trickle"] += 1
                time.sleep(0.01)

        def eviction_storm():
            # chaos: force a rotating window of COLD tenants resident,
            # churning the LRU well past capacity (the SlabThrash
            # detector's feed)
            rng = np.random.default_rng(seed + 23)
            i = 0
            while not stop.is_set():
                tid = cold_base + (i % max(2 * capacity, 16))
                store.load(int(tid))
                tallies["evict_sweep"] += 1
                i += 1
                if i % 8 == 0:
                    time.sleep(0.001 + 0.004 * rng.random())

        def reload_storm():
            # chaos: rapid-fire publishes to the HOTTEST tenants — a
            # reload storm under live traffic (hot swaps, no evictions)
            rng = np.random.default_rng(seed + 31)
            while not stop.is_set():
                for tid in hot[:8]:
                    if stop.is_set():
                        break
                    store.publish(int(tid),
                                  rng.normal(size=d).astype(np.float32))
                    tallies["reload_storm"] += 1
                time.sleep(0.005)

        # -- traffic -------------------------------------------------------
        mix = [
            TrafficSpec("tenant-interactive", "interactive", 0.70,
                        deadline_s=0.5),
            TrafficSpec("tenant-batch", "batch", 0.30),
        ]

        def route(spec: TrafficSpec, i: int, rng):
            tid = int(zipf_ids[i % len(zipf_ids)])
            row = pool[i % len(pool)]
            if spec.name == "tenant-interactive":
                return srv.submit(tid, row, lane=spec.lane,
                                  deadline_s=spec.deadline_s)
            return srv.submit(tid, row, lane=spec.lane)

        gen = OpenLoopLoadGen(route, mix, phases, seed=seed + 1)
        threads = [threading.Thread(target=f, name=f"tenant-{f.__name__}",
                                    daemon=True)
                   for f in (trickle, eviction_storm, reload_storm)]

        t_run = time.perf_counter()
        with srv:
            for t in threads:
                t.start()
            load_report = gen.run()
            stop.set()
            for t in threads:
                t.join(timeout=30.0)
                if t.is_alive():
                    raise AssertionError(f"{t.name} hung")
            healthz = srv.healthz()
        wall_s = time.perf_counter() - t_run

        # -- client ledger -> trace counters (the SLO inputs) --------------
        totals = load_report["totals"]
        obs.inc("scenario.answered", totals["answered"])
        obs.inc("scenario.rejected",
                totals["rejected"] + totals["displaced"])
        obs.inc("scenario.errors", totals["errored"])
        obs.inc("scenario.dropped", totals["dropped"])

        ledger = healthz["slab"]
        say(f"load: {json.dumps(totals)} over {wall_s:.1f}s; "
            f"slab: {json.dumps(ledger)}; chaos: {json.dumps(tallies)}")
        say(f"engine: {json.dumps(healthz['engine'])} "
            f"(compiles warm={compiles_warm})")

        # structural invariants, checked here so a failure names the
        # subsystem, not just the SLO
        if totals["submitted"] != (
                totals["answered"] + totals["rejected"]
                + totals["displaced"] + totals["errored"]
                + totals["dropped"]):
            raise AssertionError(f"ledger does not conserve: {totals}")
        if ledger["evicted"] < 10:
            raise AssertionError(
                f"eviction storm never churned the slab: {ledger}")
        if ledger["swapped"] < 5:
            raise AssertionError(
                f"retrain trickle/reload storm never hot-swapped: {ledger}")
        # the shape contract under chaos: serving scored NO new padded
        # shape after warm-up, across evictions, reloads, and every
        # tenant mix the storm produced
        if srv.engine.compile_count != compiles_warm:
            raise AssertionError(
                f"serving added shapes under chaos: {compiles_warm} -> "
                f"{srv.engine.compile_count}")

        summary = {"seed": seed, "mode": mode, "device": str(dev),
                   "wall_s": wall_s,
                   "n_tenants": n_tenants, "capacity": capacity,
                   "totals": totals,
                   "errors_by_class": load_report["error_classes"],
                   "lanes": load_report["lanes"],
                   "classes": load_report["classes"],
                   "phases": load_report["phases"], "slab": ledger,
                   "chaos": tallies, "healthz": healthz}
        with open(os.path.join(out_dir, "tenant_summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=2, default=str)
    finally:
        obs.disable()
        event_log.close()

    slo_path = os.path.join(out_dir, "tenant_slo.json")
    with open(slo_path, "w") as f:
        json.dump(slo_doc, f, indent=2)
    chrome = os.path.join(out_dir, "tenant_trace.chrome.json")
    rc = obs_report.main([trace, "--slo", slo_path, "--chrome", chrome])
    if owned_tmp is not None:
        owned_tmp.cleanup()
    return rc
