"""Host-streamed SGD for datasets that do not fit, or do not stay, on the
card: the port of ``tpu_sgd/optimize/streamed.py`` (one device, or the
ranks of one host on a data mesh).

The dataset stays in host memory (a numpy array, or a CPU tensor of any
float dtype, bf16 included).  Each iteration's mini-batch is drawn on the
HOST with exactly the JAX package's rule, ``np.random.default_rng(seed +
i)`` (:class:`HostSampler`), so the sampled rows, windows and caps are
bit-identical to the JAX package's; the batch is assembled into a pinned
staging slot (``torch.index_select`` into the slot for the Bernoulli and
indexed gathers, a contiguous copy for a sliced window, the bf16 wire cast
in the same pass), copied to the card on a side stream, and consumed
there by the SAME step as every other driver: frac 1.0 over the
transferred batch with its ``valid`` mask, i.e. one masked launch of the
fused kernel (B1).  The worker thread of :class:`~tpu_sgd_torch.io.
prefetch.Prefetcher` assembles and sends batch ``i+1`` while the card runs
step ``i`` (``prefetch_depth=2``; ``0`` assembles inline, bitwise the
same); :class:`~tpu_sgd_torch.io.prefetch.PinnedRing` orders the slot
reuse with CUDA events.

Fixed row cap, so every step has one shape: Bernoulli batches cap at the
binomial mean + 6 sigma + 8 (a uniformly random subset on overflow),
indexed and sliced batches have ``round(frac * n)`` rows; full batch
(``frac >= 1``) transfers the data ONCE and steps on it.

``resident_rows=R`` (sliced sampling): rows ``[0, R)`` are placed on the
card once, and a window inside them is copied on the card into the step's
slot instead of over PCIe; the window sequence is unchanged, and
resident and transferred windows go through the same kernel on the same
slot, so ``R`` changes where rows come from, never the result.

Superstep ``K`` (``superstep_k``): the worker stacks K batches into one
``(K, cap, d)`` superchunk slot (``io.chunking.stack_superchunk``: a
tail pads with zero rows and all-False masks); the card runs the K steps
as one block, captured once per slot as a CUDA graph and replayed (the
copies stay outside the graph, into the slot's fixed buffers), its ys
rows fetched once a block and replayed through the observed driver's
bookkeeping.  History, convergence iteration, events and checkpoints are
the K = 1 loop's bitwise.  ``resident_cadence=C >= 2`` applies to the
full-batch and fully-resident feeds (as in the JAX package): windows of
C blocks through ``optimize/resident_driver.py``.

Compressed wire (``wire_compress="topk:<frac>"``): the top-k
error-feedback update of ``make_compressed_step``; the accumulator is
carried on the card, written into each ys row and checkpointed as
``extras={"ef": ...}`` (either package restores the other's).

Reliability: the host->device hop passes the ``io.device_put`` failpoint
and ships each batch as a checksummed frame through the ``io.chunk``
corrupting failpoint, verified before the copy; the superchunk stack
passes ``io.superstep``.  A ``retry_policy`` re-runs a failed assembly,
and since the sample is a function of ``(seed, i)`` a healed run is
bitwise the clean one.  ``stop_signal`` is polled each iteration (each
block with K > 1, each window with C) and a preempted run resumes from
its checkpoint bitwise.

What the feed costs is seen only when an operator asks: with counters on
(``obs.counters.enable``), ``record_wire`` counts each frame's logical and
physical bytes by format; with tracing on (``obs.spans.enable_tracing``),
each produce is an ``ingest.produce`` span (the worker's assembly), its
frame's checksum an ``ingest.checksum`` span, and the ring reports its
pinned bytes and each copy's bytes and card time (``ingest.ring``,
``ingest.h2d``; ``io/prefetch.py``).

Data parallelism (``mesh``, a 1-D data mesh of ``k`` ranks): the JAX
package streams on a mesh from ONE process, whose host sampler draws
one global batch that is then row-sharded over the devices.  Here a
rank is a process, and the rule that decides is: ranks on one host act
as that one process.  Every rank passes the SAME whole host dataset
and draws the same global sample (the sampler is not folded with the
shard: the streamed batch is one global sample); the cap is padded up
to a multiple of ``k`` (padding rows invalid), and rank ``r`` stages
and sends only rows ``[r·cap/k, (r+1)·cap/k)`` of each global batch (of
the dataset itself at full batch; of each batch of a K-batch
superchunk), so its pinned ring holds its share alone.  The rank's sums
then combine in rank order (``parallel.mesh.combine_sums``), or its
top-k segment on the compressed wire (``parallel.mesh.combine_topk``,
each rank's error-feedback accumulator its own), and the trajectory is
the JAX package's ``k``-device mesh's.  The host rows must be SHARED by
the ranks, never copied per rank: pass a host tensor that maps a file
every rank maps (``torch.from_file(path, shared=True, size=n * d,
dtype=torch.bfloat16).view(n, d)``, or a ``np.memmap``), which
``host_tensor`` wraps without a copy.  A mesh whose ranks lie on more
than one host raises (``parallel.mesh.require_single_host``, the JAX
package's message), as does ``resident_rows`` on a mesh;
``resident_cadence`` warns and runs the superstep driver.  The
compressed wire's checkpoint keeps the JAX package's layout,
``extras={"ef": (n_shards, d)}``: rank 0 writes every rank's row
(gathered), a resume gives each rank its row back, and either package
restores the other's.  Stop polls are agreed by every rank
(``gradient_descent.agreed_stop``); rank 0 saves, then every rank
passes a barrier.
"""

from __future__ import annotations

import time
import warnings
from typing import Tuple

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.io.chunking import plan_chunks, stack_superchunk
from tpu_sgd_torch.io.integrity import seal, verify
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.sparse_wire import parse_wire_compress
from tpu_sgd_torch.io.wire import host_tensor, resolve_wire_dtype
from tpu_sgd_torch.obs.counters import record_wire
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.ops.gradients import Gradient
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.parallel.mesh import barrier
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint

Tensor = torch.Tensor

#: bytes of one staging chunk of a one-time full-batch transfer
FULL_BATCH_CHUNK_BYTES = 64 << 20


def sliced_window_rows(n: int, frac: float) -> int:
    """Rows per sliced-sampling window: THE definition shared by the
    sampler and its consumers."""
    return max(1, round(frac * n))


def resident_window_probability(n: int, frac: float, resident: int) -> float:
    """Probability that a sliced window lies in the resident prefix: the
    sampler draws ``start ~ integers(0, n - m + 1)`` and the window is
    resident iff ``start + m <= resident``."""
    m = sliced_window_rows(n, frac)
    return min(1.0, max(0.0, (resident - m + 1) / max(n - m + 1, 1)))


def bernoulli_cap(n: int, frac: float) -> int:
    """The fixed row cap of a Bernoulli batch: the binomial mean + 6 sigma
    + 8 rows (overflow is astronomically rare; the sampler then keeps a
    uniformly random subset)."""
    sigma = np.sqrt(n * frac * (1.0 - frac))
    return int(min(n, np.ceil(n * frac + 6.0 * sigma + 8)))


class HostSampler:
    """Iteration ``i``'s sample, drawn on the host from
    ``np.random.default_rng(seed + i)`` exactly as the JAX package's
    streamed drivers draw it.  :meth:`draw` returns one of

    * ``("resident", start)``: a sliced window inside the resident prefix;
    * ``("window", start)``: a sliced window read from host rows;
    * ``("rows", idx, count)``: ``idx`` the ``(cap,)`` int64 row ids, the
      first ``count`` sampled and the rest 0 (padding rows, not valid);
    * ``("full",)``: every row (``frac >= 1``).

    On a data mesh of ``shards`` ranks the cap is padded up to a multiple
    of ``shards`` (padding rows invalid) and ``share = cap // shards`` is
    one rank's rows of each batch; the draws are the same on every rank.
    """

    def __init__(self, cfg: SGDConfig, n: int, resident_rows: int = 0,
                 shards: int = 1):
        self.cfg = cfg
        self.n = int(n)
        self.frac = cfg.mini_batch_fraction
        self.m = sliced_window_rows(self.n, self.frac)
        self.R = int(resident_rows)
        if self.frac >= 1.0:
            self.cap = self.n
        elif cfg.sampling == "bernoulli":
            self.cap = bernoulli_cap(self.n, self.frac)
        else:  # indexed / sliced: the resident path's batch size
            self.cap = self.m
        self.cap += (-self.cap) % int(shards)  # even shares
        self.share = self.cap // int(shards)

    def sample_rows(self, i: int) -> np.ndarray:
        """Iteration ``i``'s row ids (the Bernoulli or indexed draw, or all
        rows at full batch), truncated to the cap as the batch is."""
        kind = self.draw(i)
        if kind[0] == "full":
            return np.arange(self.n, dtype=np.int64)
        if kind[0] in ("window", "resident"):
            return np.arange(kind[1], kind[1] + self.m, dtype=np.int64)
        return kind[1][:kind[2]]

    def draw(self, i: int):
        cfg, n, frac = self.cfg, self.n, self.frac
        if frac >= 1.0:
            return ("full",)
        rng = np.random.default_rng(cfg.seed + i)
        if cfg.sampling == "sliced":
            start = int(rng.integers(0, max(1, n - self.m + 1)))
            if start + self.m <= self.R:
                return ("resident", start)
            return ("window", start)
        if cfg.sampling == "indexed":
            idx = rng.integers(0, n, size=self.m)
        else:  # bernoulli
            mask = rng.random(n) < frac
            idx = np.nonzero(mask)[0]
            if idx.shape[0] > self.cap:
                idx = rng.permutation(idx)[:self.cap]
        pad = np.zeros((self.cap,), np.int64)
        pad[:idx.shape[0]] = idx
        return ("rows", pad, int(idx.shape[0]))


def frame_view(t: Tensor) -> np.ndarray:
    """A host tensor as a numpy view for the integrity frame (bf16, which
    numpy cannot name, as its int16 bit pattern)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def transfer_rows(Xh: Tensor, dst: Tensor, retry_policy, depth: int,
                  fmt: str = "dense-f32") -> None:
    """Copy host rows ``Xh`` (cast to ``dst``'s dtype) into the device
    tensor ``dst`` in fixed-size chunks through a pinned ring: the
    one-time transfer of a full batch or a resident prefix.  Each chunk is
    a checksummed frame (``io.chunk``) behind the ``io.device_put``
    failpoint, inside ``retry_policy``'s scope."""
    n = Xh.shape[0]
    if n == 0:
        return
    row_bytes = max(1, dst[0].numel() * dst.element_size())
    plan = plan_chunks(n, max(1, FULL_BATCH_CHUNK_BYTES // row_bytes))
    slots = ring_slots(depth)
    shape = (plan.chunk_rows,) + tuple(dst.shape[1:])
    # the device side of a slot is the destination rows themselves
    ring = PinnedRing({"x": (shape, dst.dtype)}, slots, dst.device,
                      device_buffers=False)

    def produce(chunk):
        slot = chunk.index % slots
        buf = ring.claim(slot)["x"][:chunk.valid]
        buf.copy_(Xh[chunk.start:chunk.stop])
        failpoint("io.device_put")
        with span("ingest.checksum"):
            ck = seal(frame_view(buf))
            (got,) = corruptpoint("io.chunk", (frame_view(buf),))
            verify("io.chunk", ck, got)
        record_wire(fmt, logical_nbytes=buf.numel() * 4,
                    physical_nbytes=buf.numel() * buf.element_size())
        ring.send(slot, [(dst[chunk.start:chunk.stop], buf)])
        return slot

    with Prefetcher(produce, plan, depth=depth,
                    retry_policy=retry_policy) as feed:
        for slot in feed:
            ring.take(slot)
            ring.release(slot)
    ring.drain()


class _FeedRunner:
    """A block runner fed by the prefetcher: each :meth:`run` takes the
    next prefetched slot, waits for its copies, runs the slot's own block
    runner (one captured graph a slot: the copies land in the slot's fixed
    buffers, outside the graph) and releases the slot.  Has the ``k``,
    ``state`` and ``run`` of ``gradient_descent._BlockRunner``, so the
    resident window loop drives it too."""

    def __init__(self, runners, ring: PinnedRing, feed: Prefetcher):
        self.runners = runners
        self.ring = ring
        self.feed = feed
        self.k = runners[0].k
        self.state = runners[0].state

    def run(self, i0: int, steps: int) -> None:
        slot, got_steps = next(self.feed)
        if got_steps != steps:
            raise AssertionError(
                f"the feed staged {got_steps} steps at iteration {i0}, "
                f"the driver runs {steps}")
        self.ring.take(slot)
        self.runners[slot].run(i0, steps)
        self.ring.release(slot)


def optimize_host_streamed(
    gradient: Gradient,
    updater: Updater,
    config: SGDConfig,
    X,
    y,
    initial_weights,
    device=None,
    mesh=None,
    listener=None,
    checkpoint_manager=None,
    checkpoint_every: int = 10,
    resident_rows: int = 0,
    wire_dtype=None,
    prefetch_depth: int = 2,
    retry_policy=None,
    stop_signal=None,
    superstep_k: int = 1,
    resident_cadence: int = 0,
    wire_compress=None,
    check_numerics: bool = False,
) -> Tuple[Tensor, np.ndarray]:
    """Run mini-batch SGD with the dataset resident on the HOST; returns
    ``(weights, loss_history)`` (weights on ``device``, the history a
    numpy array) with the resident drivers' semantics: the loss includes
    the previous iteration's reg value, an empty batch skips the update,
    convergence is tested from the second iteration on.  See the module
    docstring for the feed, ``resident_rows``, ``superstep_k``,
    ``resident_cadence``, ``wire_compress`` and the reliability hooks."""
    from tpu_sgd_torch.optimize.gradient_descent import (
        _coerce_w0,
        agreed_stop,
    )

    mesh = _streamed_mesh(mesh)
    cfg = config
    dev = resolve_device(device)
    Xh = host_tensor(X)
    if Xh.dim() != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(Xh.shape)}")
    if not Xh.is_contiguous():
        Xh = Xh.contiguous()
    n, d = Xh.shape
    yh = host_tensor(y).to(torch.float32).contiguous()
    w0 = _coerce_w0(gradient, initial_weights, d, dev)
    if n == 0:
        return w0, np.zeros((0,), np.float32)
    wd = resolve_wire_dtype(wire_dtype, Xh.dtype)
    xdt = wd if wd is not None else Xh.dtype
    if xdt not in (torch.float32, torch.bfloat16):
        # int/bool/f64 rows train in f32 (the wire cast does it a batch
        # at a time), as the resident path converts them once
        xdt = torch.float32
    comp_frac = parse_wire_compress(wire_compress)
    frac = cfg.mini_batch_fraction
    m_fixed = sliced_window_rows(n, frac)
    R = 0
    if resident_rows:
        if mesh is not None:
            raise NotImplementedError(
                "resident_rows composes with a single device; a mesh "
                "shards the resident slab with its own layout — use the "
                "fully-resident mesh path or plain streaming")
        if cfg.sampling != "sliced" or frac >= 1.0:
            raise NotImplementedError(
                "resident_rows requires sampling='sliced' with "
                "mini_batch_fraction < 1 (contiguous windows are what can "
                "be sliced on the card)")
        R = min(int(resident_rows), n)
        if R < m_fixed:
            raise ValueError(
                f"resident_rows={resident_rows} is smaller than one window "
                f"({m_fixed} rows); no window can ever hit the resident "
                "prefix — raise it or use plain streaming")
    K = max(1, int(superstep_k))
    C = max(0, int(resident_cadence))
    fully_resident = bool(R) and R >= n
    full_batch = frac >= 1.0
    if C >= 2 and K <= 1:
        warnings.warn(
            "device residency rides the fused superstep executor; pass "
            "superstep_k >= 2 to engage it", RuntimeWarning, stacklevel=3)
        C = 0
    if C >= 2 and (mesh is not None
                   or not (full_batch or fully_resident)):
        warnings.warn(
            "device residency applies to the single-device full-batch and "
            "fully-resident-slab feeds (a host-sampled feed's host hop IS "
            "the data feed); running the superstep driver",
            RuntimeWarning, stacklevel=3)
        C = 0
    if comp_frac is not None and R and not fully_resident:
        warnings.warn(
            "wire_compress with a partially-resident window feed runs the "
            "dense gradient wire (the JAX package's recorded cell "
            "feed=slab-partial x compressed); a fully resident slab "
            "carries the error feedback", RuntimeWarning, stacklevel=3)
        comp_frac = None
    shards = 1 if mesh is None else mesh.size
    run = _DenseRun(gradient, updater, cfg, dev,
                    HostSampler(cfg, n, R, shards), K, C, comp_frac,
                    prefetch_depth, retry_policy, listener, checkpoint_every,
                    agreed_stop(mesh, stop_signal, dev), check_numerics,
                    mesh=mesh, Xh=Xh, yh=yh, xdt=xdt)
    return execute(run, w0, checkpoint_manager)


def _streamed_mesh(mesh):
    """The data mesh of a host-streamed run (None: one device): a
    ``parallel.Mesh``, its trivial model axis flattened; a 2-D mesh
    raises, and so does one whose ranks lie on more than one host."""
    if mesh is None:
        return None
    from tpu_sgd_torch.parallel.mesh import (
        Mesh,
        as_data_mesh,
        has_model_axis,
        require_single_host,
    )

    if not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh takes a tpu_sgd_torch.parallel.Mesh (data_mesh, "
            f"make_mesh), got {type(mesh).__name__}")
    if has_model_axis(mesh):
        raise NotImplementedError(
            "host streaming supports 1-D data meshes; feature-axis "
            "('model') sharding needs the resident path")
    mesh = as_data_mesh(mesh)
    require_single_host(mesh, "streamed SGD batches")
    return mesh


def execute(run: "_StreamedRun", w0: Tensor, checkpoint_manager=None):
    """Drive one streamed run (dense or sparse) from ``w0``, or from the
    manager's checkpoint when it holds one: the initial reg value, the
    resume (weights, reg value, history and the error-feedback
    accumulator), the listener's start and end events, and the save
    callback whose extras carry the accumulator of the saved iteration.
    Returns ``(weights, loss_history)``."""
    cfg, gradient, updater, dev = run.cfg, run.gradient, run.updater, run.dev
    mesh = run.mesh
    _, reg0 = updater.compute(w0, torch.zeros_like(w0), 0.0, 1,
                              cfg.reg_param)
    reg_val = float(reg0)
    losses = run.losses
    start_iter = 1
    w = w0
    config_key = repr((type(gradient).__name__, type(updater).__name__, cfg))
    ef_resume = None
    if checkpoint_manager is not None:
        state = checkpoint_manager.restore()
        if state is not None:
            if state["config_key"] and state["config_key"] != config_key:
                warnings.warn(
                    "checkpoint config differs from current config; "
                    "resuming anyway", RuntimeWarning, stacklevel=4)
            w = torch.as_tensor(np.asarray(state["weights"]),
                                dtype=torch.float32).to(dev)
            reg_val = state["reg_val"]
            losses.extend(np.asarray(state["loss_history"], np.float32))
            start_iter = state["iteration"] + 1
            ef_resume = (state.get("extras") or {}).get("ef")
    ef = None
    if run.comp_frac is not None:
        ef0 = np.zeros((w.numel(),), np.float32)
        if ef_resume is not None:
            ef_resume = np.asarray(ef_resume, np.float32)
            if mesh is not None:  # the JAX layout: a row per shard
                ef_resume = ef_resume.reshape(mesh.size, -1)[run.rank]
            ef0 = ef_resume.reshape(ef0.shape)
        elif start_iter > 1:
            warnings.warn(
                "resuming a compressed run from a checkpoint without EF "
                "state; the accumulator restarts at zero — the trajectory "
                "will not be bitwise vs an uninterrupted compressed run",
                RuntimeWarning, stacklevel=4)
        ef = torch.from_numpy(ef0).to(dev)
    run.ef_live = ef
    if run.listener is not None:
        run.listener.on_run_start(cfg)
    run.ef_window["i0"] = start_iter

    def _save(ii, w_np, rv):
        extras = None
        if run.comp_frac is not None:
            efs = run.ef_window["efs"]
            ef_row = (efs[ii - run.ef_window["i0"]] if efs is not None
                      else run.ef_live.detach().cpu().numpy())
            if mesh is not None:
                ef_row = _gather_rows(mesh, ef_row)
            extras = {"ef": ef_row}
        if mesh is None or run.rank == 0:
            checkpoint_manager.save(ii, np.asarray(w_np), rv,
                                    np.asarray(losses), config_key,
                                    extras=extras)
        if mesh is not None:
            barrier(mesh, dev)

    run.save_cb = _save if checkpoint_manager is not None else None
    t_run = time.perf_counter()
    converged = False
    try:
        if start_iter <= cfg.num_iterations:
            w, reg_val, converged, ef = run.run(w, reg_val, ef, start_iter)
    finally:
        run.close()
    if run.listener is not None:
        from tpu_sgd_torch.utils.events import RunEvent

        run.listener.on_run_end(RunEvent(
            event="run_completed", num_iterations=len(losses),
            final_loss=losses[-1] if losses else None,
            converged_early=converged,
            wall_time_s=time.perf_counter() - t_run))
    return w, np.asarray(losses, np.float32)


def _gather_rows(mesh, row) -> np.ndarray:
    """Every rank's host ``row`` stacked in rank order, ``(ranks,
    len(row))`` (collective)."""
    from tpu_sgd_torch.parallel.mesh import all_gather, collective_device

    t = torch.as_tensor(np.asarray(row, np.float32)).reshape(-1)
    return all_gather(mesh, t.to(collective_device(mesh))).cpu().numpy()


class _StreamedRun:
    """One streamed run's loops over a feed: the per-step driver (K = 1),
    the block driver (K > 1) and the window driver (K > 1, C >= 2).  A
    subclass supplies the feed: :meth:`_full_data` (the full batch on the
    card, sent once), :meth:`_ring_feed` (the prefetcher and the ring of
    per-(super)step slots) and :meth:`_slot_data` (a slot's device
    batches, one a step)."""

    def __init__(self, gradient, updater, cfg, dev, sampler, K, C,
                 comp_frac, depth, retry_policy, listener,
                 save_every, stop_signal, check_numerics, mesh=None):
        self.gradient, self.updater = gradient, updater
        #: the data mesh (None: one device) and this rank's index on it
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.cfg = cfg
        self.step_cfg = cfg.replace(mini_batch_fraction=1.0)
        self.dev = dev
        self.sampler = sampler
        self.K, self.C = K, C
        self.comp_frac = comp_frac
        self.depth = int(depth)
        self.retry_policy = retry_policy
        self.listener = listener
        self.save_every = save_every
        self.stop_signal = stop_signal
        self.check_numerics = check_numerics
        self.losses = []
        self.ef_window = {"efs": None, "i0": 1}
        #: the accumulator after the last step of the per-step loop (a
        #: save there reads it; the block loops install ``ef_window``)
        self.ef_live = None
        self.save_cb = None
        self.feed = None
        self.ring = None

    def close(self) -> None:
        """End the run's feed and let go of its staging memory (the
        prefetcher's producer and the save callback refer back to this
        run: the references go, so the buffers are freed at once)."""
        if self.feed is not None:
            self.feed.close()
        if self.ring is not None:
            self.ring.drain()
        self.feed = self.ring = self.save_cb = None

    def _full_data(self):
        raise NotImplementedError

    def _ring_feed(self, i0: int, N: int) -> PinnedRing:
        raise NotImplementedError

    def _slot_data(self, slot: int):
        raise NotImplementedError

    # -- the loops -------------------------------------------------------
    def run(self, w, reg_val, ef, i0):
        from tpu_sgd_torch.optimize import gradient_descent as gd

        full_batch = self.sampler.frac >= 1.0
        data = self._full_data() if full_batch else None
        if self.K == 1:
            return self._per_step(w, reg_val, ef, i0, data)
        block = gd._make_block(self.gradient, self.updater, self.step_cfg,
                               history=False, stacked=not full_batch,
                               topk_frac=self.comp_frac, mesh=self.mesh)
        state = gd._RunState(w, self.cfg.num_iterations, ys_rows=self.K,
                             extra=ef)
        state.reset(w, reg_val, i0, ef)
        capture = gd._captures(self.gradient, self.step_cfg, self.dev,
                               self.mesh)
        N = self.cfg.num_iterations
        if full_batch:
            runner = gd._BlockRunner(block, state, data, None, self.K,
                                     capture, adaptive=False)
            runner.begin(*data, N)
        else:
            ring = self._ring_feed(i0, N)
            runners = []
            for slot in range(ring.slots):
                sd = self._slot_data(slot)
                r = gd._BlockRunner(block, state, sd, None, self.K, capture,
                                    adaptive=False)
                r.begin(*sd, N)
                runners.append(r)
            runner = _FeedRunner(runners, ring, self.feed)
        if self.C >= 2:
            return self._windows(runner, reg_val, i0)
        return self._blocks(runner, reg_val, i0)

    def _per_step(self, w, reg_val, ef, i, data):
        """K = 1: one eager step an iteration on the card, then the observed
        driver's host tail (one barrier, each scalar fetched once)."""
        from tpu_sgd_torch.optimize import gradient_descent as gd

        cfg, N = self.cfg, self.cfg.num_iterations
        if self.comp_frac is None:
            step = gd.make_step(self.gradient, self.updater, self.step_cfg,
                                self.mesh)
        else:
            step = gd.make_compressed_step(self.gradient, self.updater,
                                           self.step_cfg, self.comp_frac,
                                           self.mesh)
        ring = None
        if data is None:
            ring = self._ring_feed(i, N)
            slot_data = [self._slot_data(s) for s in range(ring.slots)]
            nxt = next(self.feed)
        w = w.clone()
        reg = torch.full((), float(reg_val), dtype=torch.float32,
                         device=self.dev)
        converged = False
        while i <= N:
            t0 = time.perf_counter()
            failpoint("optimize.streamed.step")
            with span("train.step", i=i):
                if ring is not None:
                    slot, _ = nxt
                    ring.take(slot)
                    X, y, v, Xt = slot_data[slot]
                    Xb, yb, vb = X[0], y[0], v[0]
                    Xtb = None if Xt is None else Xt[0]
                else:
                    Xb, yb, vb, Xtb = data
                it = torch.full((1,), i, dtype=torch.int64, device=self.dev)
                if self.comp_frac is None:
                    new_w, loss_i, new_reg, c = step(w, Xb, yb, it, reg, vb,
                                                     Xtb)
                else:
                    new_w, ef, loss_i, new_reg, c = step(w, ef, Xb, yb, it,
                                                         reg, vb, Xtb)
                    self.ef_live = ef
                if ring is not None:
                    ring.release(slot)
                    if i < N:
                        nxt = next(self.feed)
                if new_w.is_cuda:
                    torch.cuda.synchronize(new_w.device)
            dt = time.perf_counter() - t0
            w, reg_val, converged = gd.observed_loop_tail(
                i, w, new_w, loss_i.to(torch.float32), new_reg, c,
                self.losses, reg_val, cfg, listener=self.listener,
                wall_dt=dt, save_cb=self.save_cb, save_every=self.save_every,
                stop_signal=self.stop_signal,
                check_numerics=self.check_numerics)
            reg = new_reg
            if converged:
                break
            i += 1
        return w, reg_val, converged, ef

    def _blocks(self, runner, reg_val, i0):
        """K > 1: one block a superchunk, its ys rows fetched once and
        replayed through the per-iteration bookkeeping."""
        from tpu_sgd_torch.optimize import gradient_descent as gd

        cfg, K, st = self.cfg, self.K, runner.state
        N = cfg.num_iterations
        host = gd._pinned_like(st.ys)
        w, converged, ef = st.w, False, None
        while i0 <= N and not converged:
            steps = min(K, N - i0 + 1)
            t0 = time.perf_counter()
            failpoint("optimize.streamed.step")
            with span("train.superstep", i0=i0, steps=steps):
                runner.run(i0, steps)
                rows = gd._fetch_rows(st.ys, steps, host)
            ys_host = st.ys_leaves(rows)
            dt = time.perf_counter() - t0
            if self.comp_frac is not None:
                self.ef_window["efs"], self.ef_window["i0"] = ys_host[6], i0
                ys_host = ys_host[:6]
            t_last, reg_val, converged = gd._replay_fused_steps(
                ys_host, i0, steps, self.losses, reg_val, cfg,
                listener=self.listener, wall_dt=dt / steps,
                check_numerics=self.check_numerics, save_cb=self.save_cb,
                save_every=self.save_every)
            if converged or steps < K:
                w = torch.as_tensor(ys_host[0][t_last]).to(self.dev)
            else:
                w = st.w.clone()
            if self.comp_frac is not None:
                ef = torch.as_tensor(np.asarray(
                    self.ef_window["efs"][t_last])).to(self.dev)
            if (not converged and self.stop_signal is not None
                    and self.stop_signal()):
                from tpu_sgd_torch.reliability.supervisor import (
                    TrainingPreempted,
                )

                boundary = i0 + steps - 1
                if self.save_cb is not None:
                    self.save_cb(boundary, gd._host(w), reg_val)
                raise TrainingPreempted(boundary)
            i0 += steps
        return w, reg_val, converged, ef

    def _windows(self, runner, reg_val, i0):
        """K > 1 with C >= 2 on the full-batch or fully-resident feed:
        windows of C blocks (``optimize/resident_driver.py``)."""
        from tpu_sgd_torch.optimize.resident_driver import (
            ResidentBookkeeper,
            ResidentLoop,
        )

        def install(i0w, exs):
            self.ef_window["efs"], self.ef_window["i0"] = exs, int(i0w)

        hooks = ResidentBookkeeper(
            self.cfg, self.K, self.C, losses=self.losses, reg_val=reg_val,
            start_iter=i0, listener=self.listener, save_cb=self.save_cb,
            save_every=self.save_every, stop_signal=self.stop_signal,
            retry_policy=self.retry_policy,
            check_numerics=self.check_numerics,
            extras_cb=install if self.comp_frac is not None else None)
        failpoint("optimize.streamed.step")
        w_np, converged = ResidentLoop(runner, self.cfg, self.K,
                                       self.C).run(i0, hooks)
        ef = None
        if hooks.last_extra is not None:
            ef = torch.as_tensor(hooks.last_extra).to(self.dev)
        return (torch.as_tensor(np.asarray(w_np)).to(self.dev),
                hooks.reg_val, converged, ef)


class _DenseRun(_StreamedRun):
    """The dense feed: rows gathered (or a window copied) into pinned
    ``(K, cap, d)`` slots, resident-prefix windows copied on the card."""

    def __init__(self, *args, mesh=None, Xh, yh, xdt):
        super().__init__(*args, mesh=mesh)
        self.Xh, self.yh, self.xdt = Xh, yh, xdt
        self.Xres = self.yres = None

    def _device_rows(self, lo: int, hi: int, rows: int):
        """Host rows ``[lo, hi)`` on the card in a ``rows``-row tensor
        (the full batch, a rank's share of it, or the resident prefix),
        sent once through a pinned ring; rows past ``hi - lo`` are
        zero."""
        d = self.Xh.shape[1]
        v = hi - lo
        make = torch.empty if v == rows else torch.zeros
        Xd = make((rows, d), dtype=self.xdt, device=self.dev)
        transfer_rows(self.Xh[lo:hi], Xd[:v], self.retry_policy,
                      self.depth, fmt=self._wire_fmt())
        yd = make((rows,), dtype=torch.float32, device=self.dev)
        yd[:v].copy_(self.yh[lo:hi])
        return Xd, yd

    def _wire_fmt(self) -> str:
        return "bf16" if self.xdt == torch.bfloat16 else "dense-f32"

    def _share_rows(self, count: int) -> Tuple[int, int]:
        """``[a, b)``: the positions of this rank's share that hold real
        rows in a global batch of ``count`` rows."""
        share = self.sampler.share
        a = min(self.rank * share, count)
        return a, min(a + share, count)

    def _full_data(self):
        a, b = self._share_rows(self.sampler.n)
        share = self.sampler.share
        Xd, yd = self._device_rows(a, b, share)
        if b - a == share:
            vd = torch.ones((share,), dtype=torch.bool, device=self.dev)
        else:
            vd = torch.arange(share, device=self.dev) < b - a
        return Xd, yd, vd, None

    def _slot_data(self, slot: int):
        dv = self.ring.dev[slot]
        return dv["X"], dv["y"], dv["v"], None

    def _ring_feed(self, i0: int, N: int) -> PinnedRing:
        K, cap, d = self.K, self.sampler.share, self.Xh.shape[1]
        slots = ring_slots(self.depth)
        self.ring = ring = PinnedRing(
            {"X": ((K, cap, d), self.xdt), "y": ((K, cap), torch.float32),
             "v": ((K, cap), torch.bool)}, slots, self.dev)
        if self.sampler.R:
            R = self.sampler.R
            self.Xres, self.yres = self._device_rows(0, R, R)
        wire_fmt = self._wire_fmt()

        def produce(base: int):
            # the slot is the item's, so a retried attempt refills it
            slot = (base - i0) // K % slots
            host = ring.claim(slot)
            steps = min(K, N - base + 1)
            resident, sent = [], []
            for t in range(steps):
                draw = self.sampler.draw(base + t)
                if draw[0] == "resident":
                    # rows copied on the card below; the host rows are
                    # not sent
                    resident.append((t, draw[1]))
                    host["v"][t].fill_(True)
                    continue
                self._assemble(draw, host["X"][t], host["y"][t],
                               host["v"][t])
                sent.append(t)
            stack_superchunk([host["X"][t] for t in range(steps)],
                             [host["y"][t] for t in range(steps)],
                             [host["v"][t] for t in range(steps)], k=K,
                             out=(host["X"], host["y"], host["v"]))
            failpoint("io.device_put")
            frame = tuple([frame_view(host["X"][t]) for t in sent] + [
                frame_view(host["y"]), frame_view(host["v"])])
            with span("ingest.checksum"):
                ck = seal(*frame)
                verify("io.chunk", ck, *corruptpoint("io.chunk", frame))
            xb = len(sent) * cap * d * host["X"].element_size()
            yv = host["y"].numel() * 4 + host["v"].numel()
            record_wire(wire_fmt, logical_nbytes=len(sent) * cap * d * 4 + yv,
                        physical_nbytes=xb + yv)
            dev = ring.dev[slot]
            copies = [(dev["X"][t], host["X"][t]) for t in sent] + [
                (dev["y"], host["y"]), (dev["v"], host["v"])]

            def resident_windows():
                m = self.sampler.m
                for t, start in resident:
                    dev["X"][t].copy_(self.Xres[start:start + m])
                    dev["y"][t].copy_(self.yres[start:start + m])

            ring.send(slot, copies, resident_windows if resident else None)
            return slot, steps

        self.feed = Prefetcher(produce, range(i0, N + 1, K),
                               depth=self.depth,
                               retry_policy=self.retry_policy)
        return ring

    def _assemble(self, draw, Xb: Tensor, yb: Tensor, vb: Tensor) -> None:
        """This rank's share of one host batch into its slot rows (a
        gather or a window copy, the wire cast in the same pass); on one
        device the share is the whole batch."""
        Xh, yh = self.Xh, self.yh
        if draw[0] == "window":
            s = draw[1]
            a, b = self._share_rows(self.sampler.m)
            v = b - a
            Xb[:v].copy_(Xh[s + a:s + b])
            yb[:v].copy_(yh[s + a:s + b])
            vb[:v].fill_(True)
            vb[v:].fill_(False)
            if v < Xb.shape[0]:  # a mesh's padding rows
                Xb[v:].zero_()
                yb[v:].zero_()
            return
        lo, share = self.rank * self.sampler.share, self.sampler.share
        idx = torch.from_numpy(draw[1][lo:lo + share])
        if Xb.dtype == Xh.dtype:
            torch.index_select(Xh, 0, idx, out=Xb)
        else:
            Xb.copy_(torch.index_select(Xh, 0, idx))
        torch.index_select(yh, 0, idx, out=yb)
        vb.fill_(False)
        vb[:min(max(draw[2] - lo, 0), share)] = True
