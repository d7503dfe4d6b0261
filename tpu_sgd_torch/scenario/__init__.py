"""tpu_sgd_torch.scenario: the production scenario harnesses (the port of
``tpu_sgd/scenario``), on the card unless ``device="cpu"``.

The subsystems — async replica training (``tpu_sgd_torch/replica``), hot
reload (``serve.ModelRegistry``), the admission-controlled micro-batcher
(``serve.batcher``), chaos failpoints, the live detectors and the
SLO-verdict trace report (``obs.report``) — run here *as one system*: an
open-loop load generator (:mod:`tpu_sgd_torch.scenario.loadgen`) drives
mixed dense/sparse/multinomial traffic across priority lanes, including
a deliberate overload burst, while a replica fleet retrains on a
drifting stream (compressed pushes, a worker killed and rejoined, the
primary store killed and its standby promoted) and the serving tier
hot-reloads the fleet's checkpoints on a cadence
(:mod:`tpu_sgd_torch.scenario.harness`); the multi-tenant sibling drives
a ``TenantServer`` under Zipf traffic, a retraining trickle and
eviction/reload storms (:mod:`tpu_sgd_torch.scenario.tenant_stress`).

Each run is gated by declarative SLOs evaluated over the run's own trace
by ``python -m tpu_sgd_torch.obs.report``, and the report's exit code is
the run's::

    from tpu_sgd_torch.scenario import run_scenario, run_tenant_scenario

    rc = run_scenario(seed=0, smoke=False)            # on the card
    rc = run_tenant_scenario(seed=0, device="cpu")    # smoke, on the CPU
"""

from __future__ import annotations

from tpu_sgd_torch.scenario.harness import build_slos, run_scenario
from tpu_sgd_torch.scenario.loadgen import OpenLoopLoadGen, Phase, TrafficSpec
from tpu_sgd_torch.scenario.tenant_stress import (build_tenant_slos,
                                                  run_tenant_scenario)

__all__ = [
    "OpenLoopLoadGen",
    "Phase",
    "TrafficSpec",
    "build_slos",
    "build_tenant_slos",
    "run_scenario",
    "run_tenant_scenario",
]
