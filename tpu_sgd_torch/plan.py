"""Execution planning: ``train()`` picks its schedule itself (the port of
``tpu_sgd/plan.py``).

The reference's user never chooses data placement: ``train()`` runs, and
Spark's scheduler plus ``cache()`` own where partitions live and how the
work is staged.  This module is that scheduler: it probes ``(n, d,
dtype, gradient family, sampling, free device memory)``, picks the
schedule a cost model says is fastest, and configures the optimizer, so a
zero-flag ``train()`` lands on a sensible schedule and an explicit
``schedule=...`` is honored with a warning when the estimate says it
loses.

=========================  ================================================
``resident_stock``         the data fit on the card; B1 / B2 over the
                           sampled rows each iteration
``resident_gram``          + least squares with sliced or full-batch
                           sampling: block-prefix sufficient statistics,
                           exact windows, no row reads per iteration
``partial_residency``      just beyond the card, sliced sampling, one
                           device: leading rows resident, windows inside
                           them cost no transfer
``host_streamed``          host-resident rows streamed a batch an
                           iteration; on one device the planner also picks
                           the fused-step count K (``choose_superstep``)
``streamed_virtual_gram``  least squares beyond the card, sliced or full
                           batch: ONE streaming pass builds the statistics
                           on the card, then iterations touch no rows;
                           windows are ALIGNED (block-floored), which the
                           plan's ``reason`` says
=========================  ================================================

The quasi-Newton optimizers plan a narrower menu through
:func:`plan_quasi_newton` (``QN_SCHEDULES``).

The decision formulas are the JAX package's, term for term, so under the
same :class:`CostModel` both packages make the same decision.  The
defaults of the measured fields are this port's, from ``chip_smoke.py``
on an H100 80GB HBM3 at a 700 W power limit (each field's comment names
the phase); the policy fractions keep the JAX package's values.  Every
number a decision used is recorded in ``Plan.estimates``.
:meth:`CostModel.calibrate` re-measures the two environment-sensitive
rates.

Budgets: ``device_budget`` reads the card's free memory (the driver's
free bytes plus the caching allocator's reserved-but-unused bytes).  On
the CPU (``device="cpu"``) it returns the cost model's ``hbm_bytes ×
hbm_safety``, source ``"fallback"``, as the JAX package does for a device
that reports no statistics; ``device=None`` is the card and raises
without one.  On a mesh every rank plans from that same cost-model
budget, so every rank makes the same decision without a collective.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import warnings
from typing import Optional

import numpy as np
import torch

from tpu_sgd_torch.device import resolve_device

logger = logging.getLogger("tpu_sgd_torch.plan")

#: the five schedules `plan` chooses among (resident_gram covers both the
#: exact and aligned variants via Plan.aligned)
SCHEDULES = (
    "resident_stock",
    "resident_gram",
    "partial_residency",
    "host_streamed",
    "streamed_virtual_gram",
)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Decision-boundary constants.  The measured fields' defaults come
    from ``chip_smoke.py`` phases on an H100 80GB HBM3 at a 700 W power
    limit (``PERF.md`` §5, phase ``plan``); override any of them for
    another card or host."""

    #: on-card read+write rate, GB/s: ``calibrate``'s probe on the card
    #: (phase ``plan`` (a): 3,087 GB/s)
    hbm_gb_s: float = 3087.0
    #: product rate of the statistics build, flop/s: the 10M x 1000 bf16
    #: build (phase ``gram`` (a)) less a 65,536-row one (phase ``plan``),
    #: per row; its products run in f64 on the tensor cores
    mxu_f32_flops: float = 4.26e13
    #: fixed cost of one statistics build (no compile step in the port):
    #: the 65,536-row build less its rows' share
    build_overhead_s: float = 4.2e-4
    #: per-iteration cost of the exact statistics iteration beyond its
    #: memory traffic: phase ``gram`` (c)'s wall (B = 8,192) less its
    #: bytes at ``hbm_gb_s``
    gram_iter_overhead_s: float = 3.57e-4
    #: host->card feed rate of the streaming schedules, GB/s: the
    #: EFFECTIVE rate of the port's streamed driver (a Bernoulli batch's
    #: bytes over its wall, phase ``streamed`` (b)), which the worker's
    #: assembly and checksum bind, not PCIe (``calibrate``'s raw pageable
    #: copy read 6.7 GB/s)
    host_feed_gb_s: float = 0.884
    #: device memory when no probe is taken (the CPU, a mesh): the card's
    #: ``total_memory``
    hbm_bytes: float = 85017493504.0
    #: fraction of free device memory the planner will commit (policy:
    #: the JAX package's value)
    hbm_safety: float = 0.80
    #: minimum fraction of iterations that must avoid transfer for partial
    #: residency to be chosen over plain streaming (policy: the JAX
    #: package's value)
    min_resident_gain: float = 0.05
    #: fixed host cost of ONE streamed-SGD iteration that K fused steps
    #: divide: (wall(K=1) - wall(K=8)) · 8/7 of the streamed full-batch
    #: feed (phase ``plan``), 0 where K = 8 is no faster (it read -0.37
    #: ms: fusion saves nothing on this driver, so the planner keeps
    #: K = 1); ``choose_replicas`` also reads it as the store's apply cost
    dispatch_overhead_s: float = 0.0
    #: target ceiling for the residual dispatch tax under fusion (policy:
    #: the JAX package's value)
    superstep_dispatch_frac: float = 0.05
    #: rate of the update combine between ranks, GB/s: a ``(d + 2)``-f32
    #: combine's bytes over its ms, 8 gloo ranks on the one card (phase
    #: ``mesh`` (b)): the gather's latency, not a link's bandwidth
    allreduce_gb_s: float = 2.77e-4
    #: per-step cost of the compressed wire: top-k minus dense ms an
    #: iteration of the meshed full-batch feed (phase ``mesh`` (k))
    compress_overhead_s: float = 1.78e-2
    #: top-k fraction the planner proposes when compression pays (policy:
    #: the JAX package's value)
    wire_compress_frac: float = 0.01
    #: density (nnz / dim) at which the sharded store's pairwise segment
    #: merge switches to a dense accumulator (policy: the JAX package's
    #: value)
    sparse_merge_density: float = 0.25
    #: set by :meth:`calibrate`: raw probe readings and which probes fell
    #: back to the defaults; excluded from equality and repr
    calibration_report: Optional[dict] = dataclasses.field(
        default=None, compare=False, repr=False)

    @classmethod
    def calibrate(cls, device=None, copy_mb: float = 256.0,
                  feed_mb: float = 64.0, **overrides):
        """Measure the two environment-sensitive rates on ``device``
        (``None``: the card) and return a :class:`CostModel` carrying them;
        every other field keeps its default unless overridden.

        * ``hbm_gb_s``: the SLOPE between 50 and 200 in-place passes
          (``x += 1``, one read and one write an element) over a
          ``copy_mb`` buffer, so the fixed cost of a call cancels.
        * ``host_feed_gb_s``: the slope between two pageable host->device
          copies, ``feed_mb`` and a quarter of it, into buffers allocated
          before the clock starts.

        Each timing ends with a synchronize and a one-element readback.
        A probe whose rate falls outside a plausibility window (1-20,000
        GB/s on the card, 0.001-1,000 GB/s for the feed), or whose byte
        delta was clamped to nothing, keeps the default and says so in
        ``calibration_report``."""
        import time

        dev = resolve_device(device)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        n_elems = max(1024, int(copy_mb * 1e6 // 4))
        x = torch.zeros((n_elems,), dtype=torch.float32, device=dev)

        def timed_passes(loops):
            sync()
            t0 = time.perf_counter()
            for _ in range(loops):
                x.add_(1.0)
            sync()
            float(x[:1].cpu()[0])  # readback: forces true completion
            return time.perf_counter() - t0

        def accept(raw, slope_s, window, default, label):
            """One rejection policy for both probes: a rate outside its
            window falls back to the default with a warning."""
            fell_back = not (window[0] <= raw <= window[1])
            if fell_back:
                logger.warning(
                    "calibrate: %s probe rejected (implied %.6g GB/s, "
                    "slope %.2e s); keeping the persisted default "
                    "%.6g GB/s", label, raw, slope_s, default)
            return (default if fell_back else raw), fell_back

        lo, hi = 50, 200
        timed_passes(2)  # warm
        dt_lo, dt_hi = timed_passes(lo), timed_passes(hi)
        hbm_slope = dt_hi - dt_lo
        hbm_raw = ((hi - lo) * 2.0 * n_elems * 4.0 / hbm_slope / 1e9
                   if hbm_slope > 1e-5 else 0.0)
        hbm_gb_s, hbm_fell_back = accept(
            hbm_raw, hbm_slope, (1.0, 20_000.0), cls.hbm_gb_s, "HBM")
        del x

        n_feed = max(1024, int(feed_mb * 1e6 // 4))
        h_lo = np.zeros((max(1024, n_feed // 4),), np.float32)
        h_hi = np.zeros((n_feed,), np.float32)
        d_lo = torch.empty(h_lo.shape, dtype=torch.float32, device=dev)
        d_hi = torch.empty(h_hi.shape, dtype=torch.float32, device=dev)

        def timed_put(h, dst):
            src = torch.from_numpy(h)
            sync()
            t0 = time.perf_counter()
            dst.copy_(src)
            sync()
            float(dst[:1].cpu()[0])  # readback: forces arrival
            return time.perf_counter() - t0

        timed_put(h_lo, d_lo)  # warm the copy path at both sizes
        timed_put(h_hi, d_hi)
        slope = timed_put(h_hi, d_hi) - timed_put(h_lo, d_lo)
        nbytes_delta = h_hi.nbytes - h_lo.nbytes
        # trust the slope only when h_lo escaped its 1024-element clamp: a
        # few-KB byte delta gives a jitter-dominated slope
        unclamped = n_feed // 4 >= 1024
        feed_raw = (nbytes_delta / slope / 1e9
                    if slope > 1e-5 and unclamped else 0.0)
        feed_gb_s, feed_fell_back = accept(
            feed_raw, slope, (1e-3, 1_000.0), cls.host_feed_gb_s,
            "host-feed")

        report = {"hbm_raw_gb_s": hbm_raw, "hbm_slope_s": hbm_slope,
                  "hbm_fell_back": hbm_fell_back,
                  "feed_raw_gb_s": feed_raw, "feed_slope_s": slope,
                  "feed_fell_back": feed_fell_back}
        # explicit overrides win, including over the measured fields
        return cls(**{"hbm_gb_s": hbm_gb_s, "host_feed_gb_s": feed_gb_s,
                      "calibration_report": report, **overrides})


DEFAULT_COST_MODEL = CostModel()


def _cuda_memory(dev: torch.device):
    """``(free, reserved, allocated)`` bytes of a CUDA device: the
    driver's free bytes and the caching allocator's two counters."""
    free, _total = torch.cuda.mem_get_info(dev)
    return (free, torch.cuda.memory_reserved(dev),
            torch.cuda.memory_allocated(dev))


def device_budget(device=None, cost_model: CostModel = DEFAULT_COST_MODEL):
    """``(free_bytes, source)`` for ``device`` (``None``: the card, which
    raises without one).  On a CUDA device the plannable bytes are the
    driver's free bytes plus the allocator's reserved-but-unallocated
    bytes, times ``hbm_safety`` (source ``"memory_stats"``); on the CPU
    the cost model's ``hbm_bytes × hbm_safety`` (source ``"fallback"``).
    No path budgets the CPU in the card's place."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        free, reserved, allocated = _cuda_memory(dev)
        plannable = free + reserved - allocated
        return max(0.0, plannable * cost_model.hbm_safety), "memory_stats"
    return cost_model.hbm_bytes * cost_model.hbm_safety, "fallback"


def mesh_budget(cost_model: CostModel = DEFAULT_COST_MODEL):
    """``(free_bytes, source)`` a rank of a mesh plans from: the cost
    model's ``hbm_bytes × hbm_safety`` on every rank alike, so the ranks
    make the same decision without a collective."""
    return cost_model.hbm_bytes * cost_model.hbm_safety, "fallback"


@dataclasses.dataclass(frozen=True)
class Plan:
    """A chosen execution schedule plus the estimates that chose it.

    ``apply(optimizer)`` configures a ``GradientDescent`` accordingly and
    returns it; ``describe()`` is the one-line explanation that
    ``train()`` logs.  The fields are the JAX package's: ``superstep`` and
    ``residency`` for the host_streamed schedule, ``wire_compress`` where
    a compressed update wire pays, and ``replicas`` / ``store_shards`` as
    sizing advice for the async replica driver (never applied: going
    async changes the update rule, so it stays the user's call)."""

    schedule: str
    reason: str
    block_rows: Optional[int] = None
    batch_rows: Optional[int] = None
    aligned: bool = False
    resident_rows: int = 0
    chunk_iters: Optional[int] = None
    wire_dtype: Optional[str] = None
    prefetch_depth: int = 2
    superstep: int = 1
    residency: int = 0
    wire_compress: Optional[str] = None
    replicas: int = 0
    store_shards: int = 1
    estimates: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return f"plan: {self.schedule} — {self.reason}"

    def apply(self, optimizer):
        """Configure ``optimizer`` (a ``GradientDescent``) for this
        schedule.  The schedule flags and the plan-owned knobs are set
        directly, not through the setters: the setters record the USER's
        intent (``_user_gram_opts``, ``last_plan``), and knobs the user
        set survive."""
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        apply_gram_knobs(optimizer, self)
        optimizer.host_streaming = self.schedule in (
            "partial_residency", "host_streamed")
        optimizer.streaming_resident_rows = (
            self.resident_rows if self.schedule == "partial_residency"
            else 0)
        optimizer.sufficient_stats = self.schedule == "resident_gram"
        optimizer.streamed_stats = self.schedule == "streamed_virtual_gram"
        optimizer.last_plan = self
        return optimizer

    def apply_quasi_newton(self, optimizer):
        """Configure an ``LBFGS`` / ``OWLQN`` optimizer for this plan, with
        :meth:`apply`'s contract."""
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        optimizer.sufficient_stats = self.schedule == "resident_gram"
        optimizer.streamed_stats = self.schedule == "streamed_virtual_gram"
        optimizer.host_streaming = self.schedule == "host_streamed"
        if "stream_batch_rows" not in getattr(
                optimizer, "_user_gram_opts", frozenset()):
            optimizer.stream_batch_rows = (
                self.batch_rows if self.schedule == "host_streamed"
                else None)
        apply_gram_knobs(optimizer, self)
        optimizer.last_plan = self
        return optimizer


def apply_gram_knobs(optimizer, p: "Plan") -> None:
    """Write a plan's knobs onto ``optimizer``, keeping every field the
    USER set (``_user_gram_opts``).  Plan-owned fields are always reset:
    a previous dataset's block size or chunk cap must not leak into this
    build (the statistics caches key on them)."""
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS

    user = getattr(optimizer, "_user_gram_opts", frozenset())
    if "block_rows" not in user:
        optimizer.gram_block_rows = p.block_rows or DEFAULT_BLOCK_ROWS
    if "batch_rows" not in user:
        # a host_streamed plan sizes batch_rows as the STREAM chunk
        # (stream_batch_rows); it is not the statistics build's chunk cap
        optimizer.gram_batch_rows = (
            None if p.schedule == "host_streamed" else p.batch_rows or None)
    if "aligned" not in user and hasattr(optimizer, "gram_aligned"):
        optimizer.gram_aligned = bool(p.aligned)
    if ("chunk_iters" not in user
            and hasattr(optimizer, "gram_chunk_iters")):
        optimizer.gram_chunk_iters = p.chunk_iters or None
    if ("wire_dtype" not in user
            and hasattr(optimizer, "ingest_wire_dtype")):
        optimizer.ingest_wire_dtype = p.wire_dtype
    if ("prefetch_depth" not in user
            and hasattr(optimizer, "ingest_prefetch_depth")):
        optimizer.ingest_prefetch_depth = int(p.prefetch_depth)
    if "superstep" not in user and hasattr(optimizer, "superstep"):
        optimizer.superstep = int(getattr(p, "superstep", 1) or 1)
    if ("residency" not in user
            and hasattr(optimizer, "resident_cadence")):
        optimizer.resident_cadence = int(getattr(p, "residency", 0) or 0)
    if ("wire_compress" not in user
            and hasattr(optimizer, "ingest_wire_compress")):
        optimizer.ingest_wire_compress = getattr(p, "wire_compress", None)


#: THE user-facing gram knob table: name -> (optimizer attribute,
#: requires a positive int)
_GRAM_KNOBS = {
    "block_rows": ("gram_block_rows", True),
    "batch_rows": ("gram_batch_rows", True),
    "aligned": ("gram_aligned", False),
    "chunk_iters": ("gram_chunk_iters", True),
}


def apply_user_gram_knobs(optimizer, **knobs) -> None:
    """Validate every USER-set gram knob, then apply them all (the
    ``set_gram_options`` body of ``GradientDescent`` and ``LBFGS``): a bad
    later argument leaves the earlier ones untouched.  Records each
    applied knob as user-owned and clears the repeat-run plan key
    (``last_plan`` stays, so the next run plans again)."""
    provided = {}
    for name, val in knobs.items():
        if val is None:
            continue
        attr, positive = _GRAM_KNOBS[name]
        if positive:
            if int(val) < 1:
                raise ValueError(f"{name} must be positive, got {val}")
            val = int(val)
        else:
            val = bool(val)
        provided[name] = (attr, val)
    for attr, val in provided.values():
        setattr(optimizer, attr, val)
    optimizer._user_gram_opts = optimizer._user_gram_opts | set(provided)
    optimizer._plan_key = None


def apply_user_ingest_options(optimizer, wire_dtype=None,
                              prefetch_depth=None, pipeline=None,
                              retry=None, wire_compress=None) -> None:
    """Validate every USER-set ingest knob, then apply them all (the
    ``set_ingest_options`` body of ``GradientDescent`` and ``LBFGS``),
    with :func:`apply_user_gram_knobs`' contract.  ``None`` leaves a knob
    as it is; ``False`` clears ``retry`` and ``wire_compress``."""
    from tpu_sgd_torch.io.sparse_wire import parse_wire_compress
    from tpu_sgd_torch.io.wire import resolve_wire_dtype
    from tpu_sgd_torch.reliability.retry import RetryPolicy

    provided = {}
    if wire_compress is not None:
        if wire_compress is False:
            provided["wire_compress"] = ("ingest_wire_compress", None)
        else:
            parse_wire_compress(wire_compress)  # validate, keep the spec
            provided["wire_compress"] = ("ingest_wire_compress",
                                         str(wire_compress))
    if retry is not None:
        if retry is False:
            provided["retry"] = ("ingest_retry_policy", None)
        elif not isinstance(retry, RetryPolicy):
            raise TypeError(
                f"retry must be a RetryPolicy or False, got "
                f"{type(retry).__name__}")
        else:
            provided["retry"] = ("ingest_retry_policy", retry)
    if wire_dtype is not None:
        resolve_wire_dtype(wire_dtype, "float32")  # validate the name
        provided["wire_dtype"] = ("ingest_wire_dtype", str(wire_dtype))
    if prefetch_depth is not None:
        if int(prefetch_depth) < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {prefetch_depth}")
        provided["prefetch_depth"] = ("ingest_prefetch_depth",
                                      int(prefetch_depth))
    if pipeline is not None:
        provided["pipeline"] = ("ingest_pipeline", bool(pipeline))
    for attr, val in provided.values():
        setattr(optimizer, attr, val)
    optimizer._user_gram_opts = optimizer._user_gram_opts | set(provided)
    optimizer._plan_key = None


def reset_plan_owned_gram_knobs(optimizer) -> None:
    """The clearing counterpart of :func:`apply_gram_knobs`: every knob
    the USER did not set goes back to its constructor default.  Called
    when a manual schedule setter takes over after a planned run."""
    from tpu_sgd_torch.io import DEFAULT_PREFETCH_DEPTH
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS

    user = getattr(optimizer, "_user_gram_opts", frozenset())
    if "block_rows" not in user:
        optimizer.gram_block_rows = DEFAULT_BLOCK_ROWS
    if "batch_rows" not in user:
        optimizer.gram_batch_rows = None
    if "aligned" not in user and hasattr(optimizer, "gram_aligned"):
        optimizer.gram_aligned = False
    if ("chunk_iters" not in user
            and hasattr(optimizer, "gram_chunk_iters")):
        optimizer.gram_chunk_iters = None
    if ("stream_batch_rows" not in user
            and hasattr(optimizer, "stream_batch_rows")):
        optimizer.stream_batch_rows = None
    if ("wire_dtype" not in user
            and hasattr(optimizer, "ingest_wire_dtype")):
        optimizer.ingest_wire_dtype = None
    if ("prefetch_depth" not in user
            and hasattr(optimizer, "ingest_prefetch_depth")):
        optimizer.ingest_prefetch_depth = DEFAULT_PREFETCH_DEPTH
    if "superstep" not in user and hasattr(optimizer, "superstep"):
        optimizer.superstep = 1
    if ("residency" not in user
            and hasattr(optimizer, "resident_cadence")):
        optimizer.resident_cadence = 0
    if ("wire_compress" not in user
            and hasattr(optimizer, "ingest_wire_compress")):
        optimizer.ingest_wire_compress = None


def _stack_bytes(n_local: int, block_rows: int, d: int) -> float:
    """Device bytes of the f32 block-prefix statistics at this block size
    (PG + Pb + Pyy + totals)."""
    nbf = max(1, n_local // block_rows)
    return (nbf + 2) * (d * d + d + 1) * 4.0


def choose_block_rows(n_local: int, d: int, stats_budget: float,
                      start: int = 4096) -> Optional[int]:
    """Smallest block size, doubling from ``start``, whose prefix stack
    fits the budget; None when none up to ``n_local`` fits."""
    B = min(max(1, start), max(1, n_local))
    while _stack_bytes(n_local, B, d) > stats_budget:
        if B >= n_local:
            return None
        B *= 2
    return B


def choose_streamed_build(n_local: int, d: int, itemsize: int,
                          budget: float, start: int = 4096):
    """``(block_rows, batch_rows)`` for a STREAMED statistics build whose
    whole device footprint fits ``budget``: the prefix stack gets ~2/3 of
    it, and the chunk the rest divided by TWO (the double-buffered feed
    keeps two chunks live), never above the build's 64-block default.
    ``(None, None)`` when no split fits."""
    B = choose_block_rows(n_local, d, budget * 2.0 / 3.0, start=start)
    if B is None:
        return None, None
    chunk_budget = budget - _stack_bytes(n_local, B, d)
    rows = int(chunk_budget // max(1, 2 * (d * itemsize + 4)))
    if rows < B:  # cannot hold even one block alongside the stack
        return None, None
    return B, int(min(rows, 64 * B))


def choose_superstep(window_rows: int, d: int, itemsize: int,
                     iter_s: float, staging_budget: float,
                     cost_model: CostModel = DEFAULT_COST_MODEL,
                     cap: int = 64) -> int:
    """Fused-step count K for the host_streamed schedule: the smallest K
    whose residual dispatch tax ``dispatch_overhead_s / K`` is at most
    ``superstep_dispatch_frac`` of the iteration's wall, clamped to what
    the double-buffered K-batch superchunk fits in ``staging_budget``
    (``inf``: the shared full-batch feed stages none) and to ``cap``.
    1 when fusion cannot pay."""
    cm = cost_model
    batch_bytes = window_rows * (d * itemsize + 5.0)  # X + y(f32) + valid
    if math.isinf(staging_budget):
        k_budget = int(cap)
    else:
        k_budget = int(staging_budget // max(1.0, 2.0 * batch_bytes))
    if k_budget < 2:
        return 1
    target = cm.superstep_dispatch_frac * max(iter_s, 1e-9)
    k_amortize = math.ceil(cm.dispatch_overhead_s / target)
    return int(max(1, min(cap, k_amortize, k_budget)))


def choose_wire_compress(dim: int, n_devices: int,
                         cost_model: CostModel = DEFAULT_COST_MODEL,
                         resident_cadence: int = 0) -> Optional[str]:
    """``"topk:<frac>"`` when the compressed update wire pays, else None.

    On a mesh: when the dense wire's ``dim * 4`` bytes at
    ``allreduce_gb_s``, less the ``2 * frac`` the top-k segment keeps,
    save more than ``compress_overhead_s``.  On one device only under
    ``resident_cadence >= 2``, where the select is one ``(dim,)`` pass at
    ``hbm_gb_s`` within ``compress_overhead_s`` and the kept segment
    holds an entry.  The compressed wire changes the update rule (matched
    final loss, not a bitwise trajectory), so borderline cases keep the
    dense wire."""
    cm = cost_model
    if int(dim) < 2:
        return None
    frac = float(cm.wire_compress_frac)
    if int(n_devices) <= 1:
        if int(resident_cadence) < 2 or frac * dim < 1.0:
            return None
        select_s = dim * 4.0 / (cm.hbm_gb_s * 1e9)
        if select_s > cm.compress_overhead_s:
            return None
        return f"topk:{frac:g}"
    dense_s = dim * 4.0 / (cm.allreduce_gb_s * 1e9)
    saved_s = dense_s * (1.0 - 2.0 * frac)
    if saved_s <= cm.compress_overhead_s:
        return None
    return f"topk:{frac:g}"


#: fraction of a replica worker's per-push compute wall the SERIALIZED
#: store work may take at the chosen fleet size
REPLICA_STORE_HEADROOM = 0.5


def choose_replicas(n: int, d: int, itemsize: int = 4,
                    n_devices: int = 1,
                    mini_batch_fraction: float = 1.0,
                    cost_model: CostModel = DEFAULT_COST_MODEL,
                    cap: int = 8, store_shards: int = 1) -> int:
    """Replica-worker count W for the async driver (``replica/``): the
    LARGEST W (capped by ``n_devices`` and ``cap``) whose store, one
    ``dispatch_overhead_s`` apply plus the update wire both ways (``2 * d
    * 4 / store_shards`` bytes at ``allreduce_gb_s``) a push, stays under
    :data:`REPLICA_STORE_HEADROOM` busy against the workers' two-read
    shard sums (``2 * (n/W) * frac * d * itemsize`` bytes at
    ``hbm_gb_s``); 0 when even W = 2 saturates it.  Sizing advice, never
    applied."""
    cm = cost_model
    store_s = (cm.dispatch_overhead_s
               + 2.0 * d * 4.0
               / (max(1, int(store_shards)) * cm.allreduce_gb_s * 1e9))
    best = 0
    # an empty range when fewer than 2 devices
    for w in range(2, min(int(n_devices), int(cap)) + 1):
        rows_local = max(1.0, float(n) / w)
        compute_s = (2.0 * rows_local * mini_batch_fraction * d
                     * itemsize / (cm.hbm_gb_s * 1e9))
        if w * store_s <= REPLICA_STORE_HEADROOM * compute_s:
            best = w
    return best


def choose_store_shards(n: int, d: int, itemsize: int = 4,
                        n_devices: int = 1,
                        workers: int = 2,
                        mini_batch_fraction: float = 1.0,
                        cost_model: CostModel = DEFAULT_COST_MODEL,
                        cap: int = 8) -> int:
    """Store-shard count S for the sharded store (``replica/shard.py``):
    the largest S (clamped by the device count and ``cap``) that keeps
    :data:`REPLICA_STORE_HEADROOM` headroom under ``workers``' pushes,
    while a shard's share of the update wire still outweighs one
    dispatch.  1 for small models.  Sizing advice, never applied."""
    cm = cost_model
    w = max(2, int(workers))
    transfer_s = 2.0 * d * 4.0 / (cm.allreduce_gb_s * 1e9)
    rows_local = max(1.0, float(n) / w)
    compute_s = (2.0 * rows_local * mini_batch_fraction * d
                 * itemsize / (cm.hbm_gb_s * 1e9))
    best = 1
    for s in range(2, min(int(n_devices), int(cap)) + 1):
        if transfer_s / s < cm.dispatch_overhead_s:
            break  # the (s-1)-way split already shrank the wire below
            # one dispatch
        if (w * (cm.dispatch_overhead_s + transfer_s / s)
                <= REPLICA_STORE_HEADROOM * compute_s):
            best = s
    return best


def choose_residency(k: int, checkpoint_every: int = 10,
                     preempt_latency_iters: Optional[int] = None,
                     cap: int = 64) -> int:
    """Cadence C (in K-step blocks) of the resident window driver: the
    LARGEST window within ``checkpoint_every`` iterations and the
    preemption-latency budget (default ``checkpoint_every``), and 0 (the
    per-block driver) when that window holds fewer than 2 blocks."""
    K = max(1, int(k))
    if K < 2:
        return 0  # residency rides the fused executor; no K, no ring
    budget_iters = min(
        max(1, int(checkpoint_every)),
        max(1, int(preempt_latency_iters))
        if preempt_latency_iters is not None else max(
            1, int(checkpoint_every)),
    )
    c = min(int(cap), budget_iters // K)
    return int(c) if c >= 2 else 0


def choose_slab_capacity(n_tenants: int, d: int, itemsize: int = 4,
                         free_hbm: Optional[float] = None,
                         working_set: Optional[int] = None,
                         hot_frac: float = 0.1,
                         cost_model: CostModel = DEFAULT_COST_MODEL,
                         cap: int = 65536) -> int:
    """Slab capacity C (resident tenant rows) for the multi-tenant store
    (``tenant/``): the smallest power of two holding the HOT working set
    (``working_set``, else ``hot_frac * n_tenants``), halved while ``C *
    (d + 1) * itemsize`` exceeds ``hbm_safety × free_hbm``
    (``free_hbm=None`` probes :func:`device_budget`: the card), and at
    most ``cap``.  Sizing advice: the caller builds the store."""
    m = max(1, int(n_tenants))
    target = (max(1, int(working_set)) if working_set is not None
              else max(1, int(round(hot_frac * m))))
    target = min(target, m)
    c = 1
    while c < target:
        c *= 2
    if free_hbm is None:
        free_hbm, _ = device_budget(cost_model=cost_model)
    row_bytes = (int(d) + 1) * int(itemsize)
    budget = cost_model.hbm_safety * float(free_hbm)
    while c > 1 and c * row_bytes > budget:
        c //= 2
    return int(min(c, int(cap)))


def _fmt_gb(b: float) -> str:
    return f"{b / 1e9:.2f} GB"


def plan(
    n: int,
    d: int,
    *,
    itemsize: int = 4,
    gram_able: bool = False,
    sampling: str = "bernoulli",
    mini_batch_fraction: float = 1.0,
    num_iterations: int = 100,
    n_devices: int = 1,
    free_hbm: Optional[float] = None,
    host_resident_ok: bool = True,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    force: Optional[str] = None,
    checkpoint_every: int = 10,
    device=None,
) -> Plan:
    """Pick an execution schedule for an ``(n, d)`` dense dataset: a pure
    decision function, the JAX package's ``plan`` term for term.

    ``itemsize``: bytes an element (2 for bf16).  ``gram_able``: the
    gradient is exactly least squares and the data dense.  ``sampling`` /
    ``mini_batch_fraction``: the user's, never changed.  ``n_devices``:
    data-mesh size (rows shard across it).  ``free_hbm``: plannable device
    bytes; None probes :func:`device_budget` on ``device`` (None: the
    card).  ``host_resident_ok``: False when the data is already on the
    card.  ``force``: a schedule to apply regardless, with a warning when
    the estimate says it loses.  ``checkpoint_every`` bounds the resident
    window (:func:`choose_residency`).  ``plan.estimates`` records every
    number the decision used."""
    if force is not None and force not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {force!r}; choose one of {SCHEDULES}"
        )
    cm = cost_model
    if free_hbm is None:
        free_hbm, budget_source = device_budget(device, cost_model=cm)
    else:
        budget_source = "caller"
    n_local = max(1, math.ceil(n / max(1, n_devices)))
    frac = float(mini_batch_fraction)
    full_batch = frac >= 1.0
    data_bytes_local = n_local * d * itemsize + n_local * 4.0  # + y
    fits = data_bytes_local <= free_hbm
    window_sliced = full_batch or sampling == "sliced"
    gram_eligible = bool(gram_able) and window_sliced

    est = {
        "n": int(n), "d": int(d), "itemsize": int(itemsize),
        "n_devices": int(n_devices), "n_local": int(n_local),
        "data_bytes_local": data_bytes_local,
        "free_hbm": float(free_hbm), "budget_source": budget_source,
        "fits_resident": bool(fits),
        "gram_eligible": gram_eligible,
        "sampling": sampling, "mini_batch_fraction": frac,
        "num_iterations": int(num_iterations),
    }

    # per-iteration walls of the candidate schedules (seconds); the stock
    # iteration is modelled as two reads of the window, as in the JAX
    # package (B1 / B2 read it once: PERF.md §7)
    window_rows = n_local if full_batch else max(1, round(frac * n_local))
    stock_iter_s = 2.0 * window_rows * d * itemsize / (cm.hbm_gb_s * 1e9)
    est["stock_iter_s"] = stock_iter_s

    def _gram_terms(B: int, aligned: bool):
        edge_bytes = 0.0 if aligned else 2.0 * B * d * itemsize
        prefix_bytes = 2.0 * (d * d + d) * 4.0
        it = (cm.gram_iter_overhead_s
              + (edge_bytes + prefix_bytes) / (cm.hbm_gb_s * 1e9))
        build = (cm.build_overhead_s
                 + n_local * d * itemsize / (cm.hbm_gb_s * 1e9)
                 + 2.0 * n_local * d * d / cm.mxu_f32_flops)
        return it, build

    chosen: Optional[Plan] = None

    # ---- resident regime -------------------------------------------------
    if fits:
        if gram_eligible:
            B = choose_block_rows(n_local, d, free_hbm - data_bytes_local)
            if B is not None:
                gram_iter_s, build_s = _gram_terms(B, aligned=False)
                saving = stock_iter_s - gram_iter_s
                amortize = (math.inf if saving <= 0
                            else build_s / saving)
                est.update(block_rows=B, gram_iter_s=gram_iter_s,
                           gram_build_s=build_s,
                           build_amortize_iters=amortize)
                if amortize <= num_iterations:
                    chosen = Plan(
                        "resident_gram",
                        f"data ({_fmt_gb(data_bytes_local)}/device) fits "
                        f"HBM ({_fmt_gb(free_hbm)} free); least-squares "
                        f"{'full-batch' if full_batch else 'sliced'} "
                        f"windows run from block-prefix statistics "
                        f"(B={B}, exact mode; build amortizes in "
                        f"~{amortize:.0f} of {num_iterations} iters)",
                        block_rows=B, estimates=est,
                    )
                elif force == "resident_gram":
                    warnings.warn(
                        "forced resident_gram is estimated a NET LOSS "
                        f"here: the statistics build (~{build_s:.2f}s) "
                        f"amortizes in ~{amortize:.0f} iterations but the "
                        f"run is only {num_iterations}",
                        RuntimeWarning, stacklevel=3,
                    )
        if chosen is None:
            why = (
                f"data ({_fmt_gb(data_bytes_local)}/device) fits HBM "
                f"({_fmt_gb(free_hbm)} free)"
            )
            if gram_eligible and "build_amortize_iters" in est:
                why += (
                    "; statistics build would amortize in "
                    f"~{est['build_amortize_iters']:.0f} iters > "
                    f"{num_iterations} run length, so stock wins"
                )
            elif gram_able and not window_sliced:
                why += (
                    f"; sufficient stats need sliced windows or full "
                    f"batch (sampling={sampling!r} honored)"
                )
            chosen = Plan("resident_stock", why, estimates=est)

    # ---- beyond-HBM regime ----------------------------------------------
    if chosen is None:
        feed = cm.host_feed_gb_s * 1e9
        streamed_iter_s = window_rows * d * itemsize / feed
        est["streamed_iter_s"] = streamed_iter_s
        if gram_eligible:
            B, batch_rows = choose_streamed_build(n_local, d, itemsize,
                                                  free_hbm)
            if B is not None:
                gram_iter_s, _ = _gram_terms(B, aligned=True)
                build_s = (cm.build_overhead_s
                           + n_local * d * itemsize / feed)
                saving = streamed_iter_s - gram_iter_s
                amortize = (math.inf if saving <= 0
                            else build_s / saving)
                est.update(block_rows=B, batch_rows=batch_rows,
                           gram_iter_s=gram_iter_s,
                           gram_build_s=build_s,
                           build_amortize_iters=amortize,
                           stack_bytes=_stack_bytes(n_local, B, d),
                           # double-buffered ingest: two chunks live
                           staging_bytes=2.0 * batch_rows
                           * (d * itemsize + 4.0))
                if amortize <= num_iterations:
                    chosen = Plan(
                        "streamed_virtual_gram",
                        f"data ({_fmt_gb(data_bytes_local)}) exceeds HBM "
                        f"({_fmt_gb(free_hbm)} free) but its statistics "
                        f"({_fmt_gb(est['stack_bytes'])}, B={B}) fit "
                        "beside the build chunk: one streaming build "
                        f"pass (~{build_s:.0f}s at {cm.host_feed_gb_s} "
                        "GB/s), then iterations touch no rows.  NOTE: "
                        "uses ALIGNED (block-floored) windows — a "
                        "sampling deviation (fine on shuffled rows, not "
                        "on sorted/grouped data); pass "
                        "schedule='host_streamed' to keep exact windows",
                        block_rows=B, batch_rows=batch_rows,
                        aligned=True, estimates=est,
                    )
                elif force == "streamed_virtual_gram":
                    warnings.warn(
                        "forced streamed_virtual_gram is estimated a NET "
                        f"LOSS here: the streaming build (~{build_s:.0f}s) "
                        f"amortizes in ~{amortize:.0f} iterations but the "
                        f"run is only {num_iterations}",
                        RuntimeWarning, stacklevel=3,
                    )
        if chosen is None and (sampling == "sliced" and not full_batch
                               and n_devices == 1):
            m = max(1, round(frac * n_local))
            R = int((free_hbm - 4.0 * n_local) // (d * itemsize))
            p_resident = min(
                1.0, max(0.0, (R - m + 1) / max(n_local - m + 1, 1))
            )
            est.update(resident_rows=max(0, R),
                       resident_window_p=p_resident)
            if R >= m and p_resident >= cm.min_resident_gain:
                chosen = Plan(
                    "partial_residency",
                    f"data ({_fmt_gb(data_bytes_local)}) exceeds HBM "
                    f"({_fmt_gb(free_hbm)} free); keeping the leading "
                    f"{R} rows resident makes ~{p_resident:.0%} of "
                    "sliced windows transfer-free",
                    resident_rows=R, estimates=est,
                )
        if chosen is None:
            # superstep fusion, one device only, budgeted against a
            # quarter of the free memory a streamed schedule leaves idle;
            # the shared full-batch feed transfers once and then iterates
            # at the device rate, so its K is judged against
            # stock_iter_s and it stages no superchunk
            K = 1
            if n_devices == 1:
                K = choose_superstep(
                    window_rows, d, itemsize,
                    stock_iter_s if full_batch else streamed_iter_s,
                    math.inf if full_batch else free_hbm * 0.25,
                    cost_model=cm)
            est["superstep"] = K
            # the resident window driver: full batch, one device, a
            # cadence window of >= 2 blocks; K shrinks into the
            # checkpoint cadence only if residency engages
            Cres = 0
            if n_devices == 1 and full_batch and K > 1:
                K_res = max(2, min(K, max(1, int(checkpoint_every) // 2)))
                Cres = choose_residency(K_res, checkpoint_every)
                if Cres:
                    K = K_res
                    est["superstep"] = K
            est["residency"] = Cres
            wc = choose_wire_compress(d, n_devices, cost_model=cm,
                                      resident_cadence=Cres)
            est["wire_compress"] = wc
            fused_note = (
                f"; K={K} fused steps per dispatch amortize the "
                f"~{cm.dispatch_overhead_s * 1e3:.1f} ms/iter host "
                "dispatch tax" if K > 1 else "")
            if Cres:
                fused_note += (
                    f"; device-resident run loop (cadence {Cres} "
                    "supersteps/host hop — one dispatch per run)")
            if wc and n_devices > 1:
                fused_note += (
                    f"; compressed gradient wire ({wc}: top-k + error "
                    "feedback — matched final loss, NOT a bitwise "
                    "trajectory; pass wire_compress=False to keep the "
                    "dense all-reduce)")
            elif wc:
                fused_note += (
                    f"; compressed gradient wire ({wc}) riding the "
                    "resident body — the EF top-k selects in-trace "
                    "inside the one while-loop dispatch, "
                    "matched final loss, NOT a bitwise trajectory; "
                    "pass wire_compress=False to keep the dense "
                    "update")
            chosen = Plan(
                "host_streamed",
                f"data ({_fmt_gb(data_bytes_local)}) exceeds HBM "
                f"({_fmt_gb(free_hbm)} free); host-resident with "
                "double-buffered per-iteration batches "
                f"(~{streamed_iter_s:.2f}s/iter at {cm.host_feed_gb_s} "
                f"GB/s feed){fused_note}",
                superstep=K, residency=Cres, wire_compress=wc,
                estimates=est,
            )

    # async replica sizing advice, stamped on every plan: the single-apply
    # estimate feeds the shard choice, then the replica advice is derived
    # again against the sharded store
    replicas = choose_replicas(n, d, itemsize, n_devices,
                               mini_batch_fraction=frac, cost_model=cm)
    store_shards = choose_store_shards(
        n, d, itemsize, n_devices, workers=max(2, replicas),
        mini_batch_fraction=frac, cost_model=cm)
    if store_shards > 1:
        replicas = choose_replicas(n, d, itemsize, n_devices,
                                   mini_batch_fraction=frac,
                                   cost_model=cm,
                                   store_shards=store_shards)
    est["replicas"] = replicas
    est["store_shards"] = store_shards

    if not host_resident_ok and chosen.schedule in (
            "partial_residency", "host_streamed", "streamed_virtual_gram"):
        chosen = Plan(
            "resident_stock",
            "data is already device-committed; streaming schedules do "
            "not apply (" + chosen.reason + ")",
            estimates=est,
        )

    if force is not None and force != chosen.schedule:
        forced = _forced_plan(
            force, chosen, est, fits=fits, free_hbm=free_hbm,
            data_bytes_local=data_bytes_local,
            per_dev=f"/device × {n_devices}" if n_devices > 1 else "",
            stacklevel=4,
            aligned=force == "streamed_virtual_gram",
            resident_rows=est.get("resident_rows", 0),
        )
        if force == "partial_residency" and not forced.resident_rows:
            if fits:
                raise ValueError(
                    "partial_residency cannot be forced here: the data "
                    f"({_fmt_gb(data_bytes_local)}/device) already fits "
                    "HBM — run resident, or shrink free_hbm to test the "
                    "beyond-HBM ladder"
                )
            raise ValueError(
                "partial_residency cannot be forced here: it needs "
                "sliced sampling with mini_batch_fraction < 1 on a "
                "single device, and at least one window of rows must "
                f"fit the budget (sampling={sampling!r}, frac={frac}, "
                f"n_devices={n_devices})"
            )
        return dataclasses.replace(forced, replicas=replicas,
                                   store_shards=store_shards)
    return dataclasses.replace(chosen, replicas=replicas,
                               store_shards=store_shards)


def _forced_plan(force, chosen, est, *, fits, free_hbm, data_bytes_local,
                 per_dev="", stacklevel=3, **plan_fields):
    """The forced-schedule contract of :func:`plan` and
    :func:`plan_quasi_newton`: warn when the forced schedule has no
    feasible statistics block size or exceeds the budget, then build the
    forced :class:`Plan`, recording what the planner would have picked."""
    if (force in ("resident_gram", "streamed_virtual_gram")
            and est.get("block_rows") is None):
        warnings.warn(
            f"forced {force} has NO feasible block size at this "
            f"budget ({_fmt_gb(free_hbm)} free vs O(d²) statistics); "
            "the build will run at the default block size and may "
            "exhaust device memory",
            RuntimeWarning, stacklevel=stacklevel,
        )
    if force.startswith("resident_") and not fits:
        warnings.warn(
            f"forced {force} commits {_fmt_gb(data_bytes_local)}"
            f"{per_dev} to a device with only {_fmt_gb(free_hbm)} in "
            "the probed budget — it does not fit and will likely "
            "exhaust device memory",
            RuntimeWarning, stacklevel=stacklevel,
        )
    return Plan(
        force,
        f"forced by caller (planner would pick {chosen.schedule}: "
        + chosen.reason + ")",
        block_rows=est.get("block_rows"),
        batch_rows=est.get("batch_rows"),
        estimates=est, **plan_fields,
    )


#: schedules a quasi-Newton optimizer can be forced onto
QN_SCHEDULES = ("resident_stock", "resident_gram", "host_streamed",
                "streamed_virtual_gram")


def _shape(X) -> tuple:
    """``X``'s shape without materializing it (tensors, arrays, or any
    object with a ``shape``)."""
    shape = getattr(X, "shape", None)
    return tuple(np.shape(X) if shape is None else shape)


def _itemsize(X) -> int:
    """Bytes an element of a floating ``X`` (the JAX package's rule: int
    and bool features coerce to f32, so 4)."""
    dt = getattr(X, "dtype", np.float32)
    if isinstance(dt, torch.dtype):
        return dt.itemsize if dt.is_floating_point else 4
    dt = np.dtype(dt)
    return dt.itemsize if np.issubdtype(dt, np.inexact) else 4


def _on_card(X) -> bool:
    """True for data already committed to a CUDA device."""
    return isinstance(X, torch.Tensor) and X.is_cuda


def _data_devices(mesh) -> Optional[int]:
    """The data-axis size of ``mesh`` (1 without one), or None for a mesh
    with a model axis, which the planner leaves as the user set it."""
    if mesh is None:
        return 1
    from tpu_sgd_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    shape = mesh.shape
    if DATA_AXIS not in shape or shape.get(MODEL_AXIS, 1) > 1:
        return None
    return int(shape[DATA_AXIS])


def _budget(optimizer, cm, free_hbm):
    """``(free_hbm, source)``: the caller's, else the cost model's on a
    mesh (:func:`mesh_budget`), else the optimizer's device's."""
    if free_hbm is not None:
        return free_hbm, "caller"
    if getattr(optimizer, "mesh", None) is not None:
        return mesh_budget(cm)
    return device_budget(getattr(optimizer, "device", None), cost_model=cm)


def plan_quasi_newton(optimizer, X, y,
                      cost_model: Optional[CostModel] = None,
                      free_hbm: Optional[float] = None,
                      force: Optional[str] = None) -> Optional[Plan]:
    """Schedule decision for ``LBFGS`` / ``OWLQN``: the sufficient
    statistics when their build amortizes inside ``max_num_iterations``
    (least squares), else stock full-batch passes; beyond the card the
    streamed statistics (least squares) or the chunked streamed CostFun
    (any other loss, ``optimize/streamed_costfun.py``), whose
    ``batch_rows`` this plan sizes.  A CUDA tensor is already on the card
    and never streams (``plan``'s rule).  A data mesh divides the budget
    by its ranks; a mesh with a model axis, sparse X and ``GramData`` are
    not planned (None).  ``force`` accepts any of ``QN_SCHEDULES``."""
    from tpu_sgd_torch.ops.gradients import LeastSquaresGradient
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS, GramData
    from tpu_sgd_torch.ops.sparse import is_sparse
    from tpu_sgd_torch.optimize.lbfgs import LBFGS

    if (not isinstance(optimizer, LBFGS) or is_sparse(X)
            or isinstance(X, GramData)):
        return None
    if force is not None and force not in QN_SCHEDULES:
        raise ValueError(
            f"schedule {force!r} does not exist behind a quasi-Newton "
            f"optimizer; choose one of {QN_SCHEDULES}"
        )
    n_devices = _data_devices(optimizer.mesh)
    if n_devices is None:
        return None  # model-sharded: leave the user's config alone
    shape = _shape(X)
    if len(shape) != 2 or shape[0] == 0:
        return None
    n, d = (int(shape[0]), int(shape[1]))
    itemsize = _itemsize(X)
    cm = cost_model or DEFAULT_COST_MODEL
    free_hbm, budget_source = _budget(optimizer, cm, free_hbm)
    iters = int(optimizer.max_num_iterations)
    gram_able = type(optimizer.gradient) is LeastSquaresGradient
    n_local = max(1, math.ceil(n / n_devices))
    data_bytes_local = n_local * d * itemsize + n_local * 4.0
    fits = data_bytes_local <= free_hbm
    est = {
        "n": n, "d": d, "itemsize": int(itemsize),
        "n_devices": int(n_devices), "n_local": int(n_local),
        "data_bytes_local": data_bytes_local,
        "free_hbm": float(free_hbm), "budget_source": budget_source,
        "fits_resident": bool(fits), "gram_able": bool(gram_able),
        "max_num_iterations": iters,
    }
    per_dev = f"/device × {n_devices}" if n_devices > 1 else ""
    on_card = _on_card(X)

    def _force_wrap(chosen):
        if on_card and chosen.schedule in ("host_streamed",
                                           "streamed_virtual_gram"):
            # plan's rule: data already on the card never streams
            chosen = Plan(
                "resident_stock",
                "data is already device-committed; streaming schedules do "
                "not apply (" + chosen.reason + ")",
                estimates=est,
            )
        if force is None or force == chosen.schedule:
            return chosen
        return _forced_plan(
            force, chosen, est, fits=fits, free_hbm=free_hbm,
            data_bytes_local=data_bytes_local, per_dev=per_dev,
            stacklevel=5,
        )

    # ---- non-least-squares losses ---------------------------------------
    if not gram_able:
        if force in ("resident_gram", "streamed_virtual_gram"):
            raise ValueError(
                f"schedule {force!r} cannot apply: no fixed-size "
                "sufficient statistics exist for "
                f"{type(optimizer.gradient).__name__} (least squares "
                "only); choose resident_stock or host_streamed"
            )
        if fits:
            chosen = Plan(
                "resident_stock",
                f"data ({_fmt_gb(data_bytes_local)}{per_dev}) fits; "
                "stock full-batch passes (no fixed-size statistics "
                f"exist for {type(optimizer.gradient).__name__})",
                estimates=est,
            )
        else:
            from tpu_sgd_torch.optimize.streamed_costfun import (
                default_stream_batch_rows,
            )

            # two in-flight chunks in half the per-device budget; the
            # evaluator shards each chunk over the mesh
            batch_rows = default_stream_batch_rows(
                d, itemsize, chunk_bytes=free_hbm * 0.25 * n_devices)
            est["batch_rows"] = batch_rows
            chosen = Plan(
                "host_streamed",
                f"data ({_fmt_gb(data_bytes_local)}{per_dev}) exceeds "
                f"HBM ({_fmt_gb(free_hbm)} free) and "
                f"{type(optimizer.gradient).__name__} has no fixed-size "
                "statistics: every full-batch cost/sweep streams the "
                "rows through the device in "
                f"{batch_rows}-row chunks (the chunked treeAggregate "
                "CostFun — feed-bound, ~3 dataset reads per iteration)",
                batch_rows=batch_rows, estimates=est,
            )
        return _force_wrap(chosen)

    # ---- least squares, beyond HBM --------------------------------------
    if not fits:
        B, batch_rows = choose_streamed_build(n_local, d, itemsize,
                                              free_hbm)
        if B is None and n_devices > 1:
            # the meshed build carries O(d²) totals, not prefix stacks
            rows = int((free_hbm - 3 * d * d * 4.0)
                       // max(1, 2 * (d * itemsize + 4)))
            if rows >= 1:
                B, batch_rows = min(DEFAULT_BLOCK_ROWS, rows), rows
        if B is not None:
            est.update(block_rows=B, batch_rows=batch_rows,
                       stack_bytes=(_stack_bytes(n_local, B, d)
                                    if n_devices == 1 else 3 * d * d * 4.0))
            tail_note = (
                f"exact totals; the n_local % {B} tail rows are dropped"
                if n_devices == 1 else
                "EXACT totals — the meshed build keeps every row"
            )
            chosen = Plan(
                "streamed_virtual_gram",
                f"data ({_fmt_gb(data_bytes_local)}{per_dev}) exceeds "
                f"HBM ({_fmt_gb(free_hbm)} free) but its statistics "
                f"({_fmt_gb(est['stack_bytes'])}, B={B}) fit beside the "
                "build chunk: one streaming build pass"
                f"{' per shard' if n_devices > 1 else ''}, then every "
                "full-batch cost/sweep is an O(d²) statistics read "
                f"({tail_note})",
                block_rows=B, batch_rows=batch_rows, estimates=est,
            )
        else:
            chosen = Plan(
                "resident_stock",
                f"data ({_fmt_gb(data_bytes_local)}{per_dev}) exceeds "
                f"HBM ({_fmt_gb(free_hbm)} free) and so does its O(d²) "
                "statistics stack; no schedule fits this device",
                estimates=est,
            )
        return _force_wrap(chosen)

    # ---- least squares, resident ----------------------------------------
    if n_devices == 1:
        B = choose_block_rows(n_local, d, free_hbm - data_bytes_local)
    else:
        # the meshed substitution carries O(d²) TOTALS per shard
        carry_bytes = 3 * d * d * 4.0
        B = (min(DEFAULT_BLOCK_ROWS, n_local)
             if carry_bytes <= free_hbm - data_bytes_local else None)
    chosen = None
    if B is not None:
        # ~4 full row reads per iteration vs O(d²) statistics matvecs
        stock_iter_s = 4.0 * n_local * d * itemsize / (cm.hbm_gb_s * 1e9)
        gram_iter_s = (cm.gram_iter_overhead_s
                       + 8.0 * d * d * 4.0 / (cm.hbm_gb_s * 1e9))
        build_s = (cm.build_overhead_s
                   + n_local * d * itemsize / (cm.hbm_gb_s * 1e9)
                   + 2.0 * n_local * d * d / cm.mxu_f32_flops)
        saving = stock_iter_s - gram_iter_s
        amortize = math.inf if saving <= 0 else build_s / saving
        est.update(block_rows=B, stock_iter_s=stock_iter_s,
                   gram_iter_s=gram_iter_s, gram_build_s=build_s,
                   build_amortize_iters=amortize)
        if amortize <= iters:
            chosen = Plan(
                "resident_gram",
                f"quasi-Newton least squares on a resident "
                f"({_fmt_gb(data_bytes_local)}{per_dev}) dataset: "
                f"full-batch cost/sweep from statistics (B={B}; build "
                f"amortizes in ~{amortize:.0f} of {iters} iterations"
                + ("; per-shard totals combine over the mesh"
                   if n_devices > 1 else "") + ")",
                block_rows=B, estimates=est,
            )
        elif force == "resident_gram":
            warnings.warn(
                "forced resident_gram is estimated a NET LOSS here: the "
                f"statistics build (~{build_s:.2f}s) amortizes in "
                f"~{amortize:.0f} iterations but max_num_iterations is "
                f"{iters}",
                RuntimeWarning, stacklevel=3,
            )
    if chosen is None:
        why = (f"data ({_fmt_gb(data_bytes_local)}{per_dev}) fits; "
               "stock full-batch passes")
        if "build_amortize_iters" in est:
            why += (
                f" (statistics build would amortize in "
                f"~{est['build_amortize_iters']:.0f} iters > {iters})"
            )
        chosen = Plan("resident_stock", why, estimates=est)
    return _force_wrap(chosen)


def plan_for(optimizer, X, y, cost_model: Optional[CostModel] = None,
             force: Optional[str] = None) -> Optional[Plan]:
    """Probe ``(optimizer, X, y)`` and :func:`plan` for it, budgeting the
    optimizer's device (on a mesh, :func:`mesh_budget`).

    Returns None (no planning) for sparse X (it trains resident by
    construction), ``GramData`` input, a mesh with a model axis, or an
    optimizer that is not a ``GradientDescent``.  A CUDA tensor is already
    on the card and never streams; a numpy array or a CPU tensor is host
    data.  As in the JAX package, X on a mesh is read as the rows the mesh
    shares (the form the streamed routes take), so its rows are divided by
    the data ranks.  The caller applies and logs the plan."""
    from tpu_sgd_torch.ops.gradients import LeastSquaresGradient
    from tpu_sgd_torch.ops.gram import GramData
    from tpu_sgd_torch.ops.sparse import is_sparse
    from tpu_sgd_torch.optimize.gradient_descent import GradientDescent

    if not isinstance(optimizer, GradientDescent) or is_sparse(X):
        return None
    if isinstance(X, GramData):
        return None  # statistics-first input: the schedule is the input
    n_devices = _data_devices(optimizer.mesh)
    if n_devices is None:
        return None  # a model axis: leave the user's configuration
    shape = _shape(X)
    if len(shape) != 2 or shape[0] == 0:
        return None
    n, d = shape
    cm = cost_model or DEFAULT_COST_MODEL
    free_hbm, source = _budget(optimizer, cm, None)
    cfg = optimizer.config
    p = plan(
        int(n), int(d),
        itemsize=_itemsize(X),
        gram_able=type(optimizer.gradient) is LeastSquaresGradient,
        sampling=cfg.sampling,
        mini_batch_fraction=cfg.mini_batch_fraction,
        num_iterations=cfg.num_iterations,
        n_devices=n_devices,
        free_hbm=free_hbm,
        host_resident_ok=not _on_card(X),
        cost_model=cm,
        force=force,
        checkpoint_every=int(getattr(optimizer, "checkpoint_every", 10)),
    )
    p.estimates["budget_source"] = source
    return p
