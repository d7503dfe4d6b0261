"""Sharded parameter store: S per-shard apply pipelines behind the
ONE store contract (the port of ``tpu_sgd/replica/shard.py``; README
"Sharded store"; ADVICE.md "Shard the apply, not the contract").

The async plane's structural bottleneck is the store's serialized
per-push work.  The math says exactly which half of that work is
parallelizable: the UPDATER is not per-coordinate separable (the
regularizer value is a whole-vector norm), but the per-push COMBINE —
accumulating dense contributions, merging top-k segments — acts
coordinate-wise, and disjoint coordinate ranges commute (the
asynchronous-SGD numeric-core argument, arXiv:1505.04956: updates
touching disjoint coordinates compose in any order to the same result).
So :class:`ShardedParameterStore` shards the COMBINE, not the contract:

* each push's coordinates split into S contiguous ranges
  (:func:`shard_offsets`) and ride the admitted payload as per-shard
  host slices — the ``"ssums"`` / ``"stopk"`` payload kinds — through
  the parent's UNCHANGED admission flow (epoch fence, staleness
  contract, poison gate, τ=0 inbox);
* at apply time the overridden ``_combine_*_locked`` hooks submit one
  job per shard to S persistent :class:`ShardPipeline` threads — each
  with its own condition, inbox (the one-deep job slot), and counters
  — then collect IN SHARD ORDER and reassemble the full vector for the
  parent's one whole-vector apply on the store's device.

Why this is bitwise: per shard, the dense combine runs the IDENTICAL
coordinate-wise f32 add chain in the identical payload order as the
parent's flattened rank-order sum — an IEEE-754 round-to-nearest add
has one answer whether numpy on the host or torch on the card executes
it, and concatenating disjoint slices is not arithmetic — so τ=0 stays
BITWISE the synchronous meshed path at every S (pinned across
S ∈ {1, 2, 4} in ``tests/test_torch_store_shard.py``).  The compressed
combine swaps the flat gather-add-store for the SparCML pairwise tree
merge with the dense crossover
(:func:`~tpu_sgd_torch.io.sparse_wire.merge_sparse_segments`,
arXiv:1802.08021) — a different but DETERMINISTIC association, so the
compressed contract stays what it always was (matched final loss vs
sync; bitwise primary-vs-standby, because both replay the identical
segment list through the identical tree).

HA composition (``replica/ha.py``): the payload slices ARE the
replication unit — a delta record's ``"stopk"`` payload carries
``None`` for untouched shards, so replication bytes scale with the
touched coordinate range and a standby's replay (or a promotion's gap
drain) re-submits work ONLY to the shards a record actually touched
(per-shard replay counters surface this).  The epoch fence still
serializes push admission, log append, and checkpoint naming exactly
as before — it lives in the parent's ``_admit`` /
``_apply_payloads_locked``, which this class never reimplements.

Lock discipline: the subclass adds NO ``_cond``-guarded state — every
new field (``_pipes``, ``_offsets``, ``_merge_density``) is write-once
in ``__init__`` and immutable after.  Each pipeline declares its OWN
one-condition map below; the only lock order is global ``_cond`` →
shard ``_cond`` (pipelines never take the store lock), so the
discipline stays depth-1 with no cycle.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from tpu_sgd_torch.device import as_tensor
from tpu_sgd_torch.io.integrity import verify
from tpu_sgd_torch.io.sparse_wire import merge_sparse_segments
from tpu_sgd_torch.obs.counters import record_wire
from tpu_sgd_torch.obs.spans import event
from tpu_sgd_torch.optimize.gradient_descent import _host
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint
from tpu_sgd_torch.replica.store import ParameterStore, PushResult

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: one condition per pipeline guards its job slot and counters; the
#: worker thread executes jobs OUTSIDE the lock (numpy releases the GIL
#: — that is the parallelism).  ``ShardedParameterStore`` itself
#: declares nothing: it adds no guarded state (module docstring) and
#: inherits the parent's discipline.
GRAFTLINT_LOCKS = {
    "ShardPipeline": {
        "_job": "_cond",
        "_done": "_cond",
        "_result": "_cond",
        "_error": "_cond",
        "_stopped": "_cond",
        "_pushes": "_cond",
        "_applies": "_cond",
        "_replays": "_cond",
        # lazily spawned by the first submit(), swapped out by
        # shutdown() — both under _cond (an unlocked shutdown swap
        # would race the first-submit spawn)
        "_thread": "_cond",
    },
}


def shard_offsets(dim: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous balanced ``(start, stop)`` ranges covering
    ``[0, dim)``: the first ``dim % n_shards`` shards carry one extra
    coordinate.  Contiguity is what makes the dense split a slice and
    the reassembly a concatenate — zero arithmetic, zero reindexing."""
    dim = int(dim)
    n_shards = max(1, min(int(n_shards), dim if dim > 0 else 1))
    base, extra = divmod(dim, n_shards)
    out = []
    start = 0
    for k in range(n_shards):
        stop = start + base + (1 if k < extra else 0)
        out.append((start, stop))
        start = stop
    return out


class ShardPipeline:
    """One shard's apply pipeline: a persistent daemon thread with a
    one-deep job slot.  ``submit(fn)`` posts a thunk; the thread runs
    it OUTSIDE the lock and posts the result; ``collect()`` blocks for
    it (re-raising the job's error).  The store submits all S jobs,
    then collects in shard order — the pipelines overlap, the
    reassembly is deterministic.  Counters: ``pushes`` (payload slices
    routed here), ``applies`` (jobs executed), ``replays`` (delta-log
    records replayed that touched this shard)."""

    def __init__(self, index: int, start: int, stop: int,
                 name: str = "shard"):
        self.index = int(index)
        self.start = int(start)
        self.stop = int(stop)
        self.name = name
        self._cond = threading.Condition()
        self._job = None
        self._done = False
        self._result = None
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._pushes = 0
        self._applies = 0
        self._replays = 0
        # the worker thread starts LAZILY on the first submit: an idle
        # pipeline costs nothing
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._job is None and not self._stopped:
                    self._cond.wait()
                if self._job is None:
                    return  # stopped with an empty slot
                job = self._job
                self._job = None
            # execute OUTSIDE the lock: the numpy kernels release the
            # GIL, so S pipelines genuinely overlap on S cores
            try:
                out, err = job(), None
            except BaseException as e:  # posted to collect(), never lost
                out, err = None, e
            with self._cond:
                self._result = out
                self._error = err
                self._done = True
                self._applies += 1
                self._cond.notify_all()

    def submit(self, fn) -> None:
        """Post one thunk.  The slot is one-deep by protocol — the
        store always collects before the next submit — so a full slot
        is a bug, not a queue."""
        with self._cond:
            if self._stopped:
                raise RuntimeError(
                    f"shard pipeline {self.name} is shut down")
            if self._job is not None or self._done:
                raise RuntimeError(
                    f"shard pipeline {self.name}: job slot busy "
                    "(collect() must drain the previous submit)")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"shard-pipeline-{self.name}")
                self._thread.start()
            self._job = fn
            self._cond.notify_all()

    def collect(self):
        """Block for the posted job's result; re-raises its error."""
        with self._cond:
            while not self._done:
                self._cond.wait()
            out, err = self._result, self._error
            self._result = None
            self._error = None
            self._done = False
            self._cond.notify_all()
        if err is not None:
            raise err
        return out

    def count_push(self) -> None:
        with self._cond:
            self._pushes += 1

    def count_replay(self) -> None:
        with self._cond:
            self._replays += 1

    @property
    def pushes(self) -> int:
        with self._cond:
            return self._pushes

    @property
    def applies(self) -> int:
        with self._cond:
            return self._applies

    @property
    def replays(self) -> int:
        with self._cond:
            return self._replays

    def shutdown(self) -> None:
        """Stop the thread (idempotent).  Safe only when no job is in
        flight — the store calls this from ``stop()``, after the run's
        last apply has serialized through the store lock."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            # swap the handle under the lock — submit() lazily writes
            # it under _cond, and an unlocked swap here would race that
            # first-submit spawn; the join itself happens OUTSIDE the
            # lock (ADVICE.md "A lock order is a declaration, not a
            # convention": joining under _cond would deadlock against
            # the worker's final acquisition)
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)


def _sum_job(slices):
    """Thunk: chain-accumulate one shard's dense slices in payload
    order — per coordinate the identical ((s0+s1)+s2)… f32 add chain
    as the parent's rank-order sum, which is the bitwise pin."""
    def job():
        acc = slices[0]
        for s in slices[1:]:
            acc = np.add(acc, s)
        return np.asarray(acc, np.float32)
    return job


def _merge_job(segments, dim: int, density: float):
    """Thunk: SparCML tree-merge one shard's top-k segments into the
    shard's dense accumulator slice."""
    def job():
        return merge_sparse_segments(segments, dim, density)
    return job


class ShardedParameterStore(ParameterStore):
    """See module docstring.  Presents the exact
    :class:`~tpu_sgd_torch.replica.store.ParameterStore` push/pull/version
    contract; ``n_shards=1`` is the degenerate (still bitwise, still one
    pipeline) spelling — the driver only constructs this class when
    ``set_store_shards(S > 1)`` asked for it, so the single-store path
    is the plain store.

    ``merge_density``: the compressed combine's density crossover
    (``None`` = ``plan.DEFAULT_COST_MODEL.sparse_merge_density``, a
    policy fraction the port keeps from the JAX package)."""

    def __init__(self, updater, config, initial_weights, *,
                 n_shards: int = 1,
                 merge_density: Optional[float] = None, **kwargs):
        super().__init__(updater, config, initial_weights, **kwargs)
        if merge_density is None:
            from tpu_sgd_torch.plan import DEFAULT_COST_MODEL

            merge_density = DEFAULT_COST_MODEL.sparse_merge_density
        self._merge_density = float(merge_density)
        self._offsets = shard_offsets(self._dim, n_shards)
        self._pipes = [
            ShardPipeline(k, start, stop, name=f"{self.name}-s{k}")
            for k, (start, stop) in enumerate(self._offsets)
        ]

    # -- the worker protocol (sharded wire) ---------------------------------
    def push(self, worker_id: str, basis_version: int, grad_sum,
             loss_sum, count, *,
             basis_epoch: Optional[int] = None,
             checksum: Optional[int] = None) -> PushResult:
        """Dense push, split into per-shard slices at the wire.  Host
        staging is unconditional here (the split IS host work: one copy
        from the card, none from the CPU), then the same consume-site
        corrupt/verify/poison order as the parent.  The slices ride
        the admitted payload — the parent's admission flow, τ=0 inbox,
        and replication capture all see one ``"ssums"`` payload whose
        groups are already shard-routed."""
        failpoint("replica.push")
        g_h = _host(grad_sum)
        l_h = _host(loss_sum)
        c_h = _host(count)
        g_h, l_h, c_h = corruptpoint("replica.push.wire",
                                     (g_h, l_h, c_h))
        verify("replica.push.wire", checksum, g_h, l_h, c_h)
        poison = self._poison_stats(g_h, l_h, float(c_h))
        flat = np.asarray(g_h, np.float32).reshape(-1)
        slices = tuple(np.array(flat[start:stop], copy=True)
                       for start, stop in self._offsets)
        for k, s in enumerate(slices):
            record_wire("dense-f32", logical_nbytes=int(s.nbytes),
                        physical_nbytes=int(s.nbytes), tag=f"s{k}")
            event("replica.shard.push", shard=f"s{k}",
                  worker=worker_id, nbytes=int(s.nbytes))
            self._pipes[k].count_push()
        return self._admit(
            worker_id, basis_version,
            ("ssums", slices, np.asarray(l_h, np.float32),
             np.asarray(c_h, np.float32)),
            basis_epoch=basis_epoch, poison=poison)

    def push_compressed(self, worker_id: str, basis_version: int,
                        indices, values, loss_sum: float,
                        count: float, *,
                        basis_epoch: Optional[int] = None,
                        checksum: Optional[int] = None,
                        shard_seals=None) -> PushResult:
        """Compressed push, split into per-shard ``(local_idx, vals)``
        segments (``None`` for untouched shards — the replication-byte
        win).  ``shard_seals``: optional per-shard CRC seals the worker
        computed over ITS OWN split — verified here against THIS
        split, so a disagreement between the two ends' routing (or a
        damaged segment the whole-frame checksum missed) is a typed
        integrity error at the consume site, not a silently misrouted
        coordinate."""
        failpoint("replica.push")
        idx_h = np.asarray(_host(indices), np.int32).reshape(-1)
        vals_h = np.asarray(_host(values), np.float32).reshape(-1)
        idx_h, vals_h = corruptpoint("replica.push.wire",
                                     (idx_h, vals_h))
        verify("replica.push.wire", checksum, idx_h, vals_h)
        poison = self._poison_stats(vals_h, np.asarray(loss_sum), None)
        if (shard_seals is not None
                and len(shard_seals) != len(self._offsets)):
            raise ValueError(
                f"push carries {len(shard_seals)} shard seals, store "
                f"has {len(self._offsets)} shards (layouts must agree; "
                "see shard_layout())")
        segs = []
        for k, (start, stop) in enumerate(self._offsets):
            m = (idx_h >= start) & (idx_h < stop)
            si = (idx_h[m] - start).astype(np.int32)
            sv = vals_h[m].copy()
            if shard_seals is not None:
                verify("replica.push.shard", shard_seals[k], si, sv)
            if si.size == 0:
                segs.append(None)
                continue
            record_wire("topk",
                        logical_nbytes=int((stop - start) * 4),
                        physical_nbytes=int(si.nbytes + sv.nbytes),
                        tag=f"s{k}")
            event("replica.shard.push", shard=f"s{k}",
                  worker=worker_id,
                  nbytes=int(si.nbytes + sv.nbytes))
            self._pipes[k].count_push()
            segs.append((si, sv))
        return self._admit(
            worker_id, basis_version,
            ("stopk", tuple(segs), float(loss_sum), float(count)),
            basis_epoch=basis_epoch, poison=poison)

    # -- the sharded combine (runs under _cond, from the parent apply) ------
    def _combine_sums_locked(self, payloads):
        if payloads[0][0] == "sums":  # unsharded payload (tests/tools)
            return super()._combine_sums_locked(payloads)
        for k, pipe in enumerate(self._pipes):
            pipe.submit(_sum_job([p[1][k] for p in payloads]))
        parts = [pipe.collect() for pipe in self._pipes]
        g = as_tensor(np.concatenate(parts), self._device)
        l = np.asarray(payloads[0][2], np.float32)
        c = np.asarray(payloads[0][3], np.float32)
        for p in payloads[1:]:
            l = np.add(l, np.asarray(p[2], np.float32))
            c = np.add(c, np.asarray(p[3], np.float32))
        return (g, as_tensor(l, self._device),
                as_tensor(c, self._device))

    def _combine_topk_locked(self, payloads):
        if payloads[0][0] == "topk":
            return super()._combine_topk_locked(payloads)
        for k, pipe in enumerate(self._pipes):
            start, stop = self._offsets[k]
            segs = [p[1][k] for p in payloads if p[1][k] is not None]
            pipe.submit(_merge_job(segs, stop - start,
                                   self._merge_density))
        parts = [pipe.collect() for pipe in self._pipes]
        g = as_tensor(np.concatenate(parts), self._device)
        l_host = 0.0
        c_host = 0.0
        for p in payloads:
            l_host += p[2]
            c_host += p[3]
        return g, l_host, c_host

    # -- replication (per-shard payload groups) -----------------------------
    def _host_payload(self, p: tuple) -> tuple:
        if p[0] == "ssums":
            return ("ssums",
                    tuple(np.asarray(s, np.float32) for s in p[1]),
                    np.asarray(p[2], np.float32),
                    np.asarray(p[3], np.float32))
        if p[0] == "stopk":
            return ("stopk",
                    tuple(None if s is None
                          else (np.asarray(s[0], np.int32),
                                np.asarray(s[1], np.float32))
                          for s in p[1]),
                    float(p[2]), float(p[3]))
        return super()._host_payload(p)

    def _device_payload(self, p: tuple) -> tuple:
        if p[0] in ("ssums", "stopk"):
            # the sharded combine consumes HOST slices (the pipelines
            # are host numpy) — normalization IS the staging
            return self._host_payload(p)
        return super()._device_payload(p)

    def apply_replica_record(self, record) -> None:
        super().apply_replica_record(record)
        # count which shards this record actually touched — the
        # single-shard-failover invariant's observable: a gap replay
        # of stopk records confined to shard k bumps ONLY pipe k
        for k in range(len(self._pipes)):
            touched = False
            for p in record.payloads:
                if p[0] == "ssums" or (p[0] == "stopk"
                                       and p[1][k] is not None):
                    touched = True
                    break
            if touched:
                self._pipes[k].count_replay()

    # -- introspection / lifecycle ------------------------------------------
    def shard_layout(self):
        return list(self._offsets)

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["store_shards"] = len(self._pipes)
        snap["shard_pushes"] = [p.pushes for p in self._pipes]
        snap["shard_applies"] = [p.applies for p in self._pipes]
        snap["shard_replays"] = [p.replays for p in self._pipes]
        return snap

    def stop(self) -> None:
        """Parent stop (τ=0 waiters wake; no further apply can enter —
        applies serialize through ``_cond``), then shut the pipelines.
        The supervisor drains standbys BEFORE calling the stores'
        ``stop()``, so a drain never races a dead pipeline."""
        super().stop()
        for pipe in self._pipes:
            pipe.shutdown()
