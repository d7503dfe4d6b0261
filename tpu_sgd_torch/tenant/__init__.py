"""Multi-tenant model store and serving plane (the port of
``tpu_sgd/tenant``).

Thousands of tenants, each owning a small GLM, served from ONE
device-resident ``(capacity, d)`` weight slab (``device=None``: the
card):

* :class:`WeightSlab` — LRU-admitted rows, copy-on-write hot reload,
  exact admission/eviction ledger (``tenant/slab.py``);
* :class:`TenantModelStore` — per-tenant ``CheckpointManager``
  durability, admission-on-miss, CRC-sealed whole-slab checkpoints,
  and the shadow/canary multi-version special case
  (``tenant/store.py``);
* :class:`TenantPredictEngine` — mixed-tenant batches scored by ONE
  gathered pass; uniform batches take the canonical single-model pass
  for the bitwise contract (``tenant/engine.py``);
* :class:`TenantServer` — the lanes/admission micro-batcher fronting
  it, tenant id riding each row as a float32 column
  (``tenant/serve.py``).

The organizing rule: pack tenants into one slab; gather, don't add
shapes — the ops and padded shapes a batch runs are independent of
tenant count, because tenant identity only enters them as an index
vector.
"""

from tpu_sgd_torch.tenant.engine import TenantPredictEngine
from tpu_sgd_torch.tenant.serve import TenantServer
from tpu_sgd_torch.tenant.slab import (SlabFullError, WeightSlab,
                                       row_set_program_cache_size)
from tpu_sgd_torch.tenant.store import TenantMissingError, TenantModelStore

__all__ = [
    "SlabFullError",
    "TenantMissingError",
    "TenantModelStore",
    "TenantPredictEngine",
    "TenantServer",
    "WeightSlab",
    "row_set_program_cache_size",
]
