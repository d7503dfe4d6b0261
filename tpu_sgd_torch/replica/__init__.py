"""Async elastic multi-replica training with a bounded-staleness
parameter store: the port of ``tpu_sgd/replica/`` (README "Async
replicas"; arXiv:1505.04956 plus SparCML-style compressed pushes over
the top-k / error-feedback wire).

Layers, bottom-up:

* ``staleness``  — the admission contract (``tau``; enforced at
  push-accept, never at pull — ADVICE.md "Staleness is a contract,
  not a tuning knob");
* ``store``      — the device-resident, version-stamped parameter
  store: lock-disciplined delta inbox, the apply as plain torch
  functions (``optimize.gradient_descent.apply_sums``), the τ=0
  barrier-and-combine (bitwise the synchronous data-parallel
  trajectory), checkpointing with per-worker EF extras;
* ``shard``      — the sharded store: S per-shard apply pipelines
  behind the same contract, SparCML tree-merged compressed pushes,
  per-shard delta-log payload groups;
* ``worker``     — one replica: pull → local shard gradient (the
  shared ``_make_local_sums`` recipe and the shard's sample stream; on
  the card one launch of the fused B1/B2 kernels) → push, under
  failpoint/retry healing;
* ``membership`` — elastic fleet bookkeeping: join/leave/rejoin,
  heartbeats, stragglers, store-failover records;
* ``ha``         — the availability layer (README "Store failover"):
  the replicated delta log, standby replicas, the deterministic
  ``StoreSupervisor`` failover, and the partition-tolerant
  ``StoreClient`` workers reach the group through;
* ``driver``     — the user-facing ``ReplicaDriver`` facade (a
  ``TrainingSupervisor``-compatible optimizer surface;
  ``set_standbys(n)`` turns the HA layer on).
"""

from tpu_sgd_torch.replica.driver import ReplicaDriver, shard_rows
from tpu_sgd_torch.replica.ha import (DeltaLog, DeltaRecord,
                                      StandbyReplica, StoreClient,
                                      StoreFailed, StoreFenced,
                                      StoreSupervisor, StoreUnreachable)
from tpu_sgd_torch.replica.membership import ReplicaMembership, WorkerRecord
from tpu_sgd_torch.replica.shard import (ShardedParameterStore,
                                         ShardPipeline, shard_offsets)
from tpu_sgd_torch.replica.staleness import PushDecision, StalenessContract
from tpu_sgd_torch.replica.store import (ParameterStore, PulledState,
                                         PushResult)
from tpu_sgd_torch.replica.worker import ReplicaWorker, make_shard_local_sums

__all__ = [
    "ReplicaDriver",
    "ReplicaMembership",
    "ReplicaWorker",
    "ParameterStore",
    "ShardedParameterStore",
    "ShardPipeline",
    "shard_offsets",
    "PulledState",
    "PushResult",
    "PushDecision",
    "StalenessContract",
    "WorkerRecord",
    "DeltaLog",
    "DeltaRecord",
    "StandbyReplica",
    "StoreClient",
    "StoreFailed",
    "StoreFenced",
    "StoreSupervisor",
    "StoreUnreachable",
    "make_shard_local_sums",
    "shard_rows",
]
