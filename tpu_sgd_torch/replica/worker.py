"""One async replica: pull → local shard gradient → push, repeatedly (the
port of ``tpu_sgd/replica/worker.py``).

A :class:`ReplicaWorker` owns one shard of the example axis (the same
row-block layout ``parallel.data_parallel.local_rows`` gives rank ``i``
of a mesh, padded and masked as the mesh pads) on ITS device, plus one
local-sums function built from the SHARED sampling recipe
(``optimize.gradient_descent._make_local_sums`` and ``_make_sampler``
with ``shard=i``): the worker folds its shard index into the sample
stream exactly where a mesh rank folds its data index, so worker ``s``
draws at iteration ``i`` exactly what mesh rank ``s`` draws — the
foundation of the τ=0 bitwise contract (``replica/store.py``).  On the
card the sums are the fused kernels' (B1 for a Bernoulli, indexed or
full batch, B2 for a sliced window); on the CPU their plain versions.

The loop is the async-SGD worker protocol (arXiv:1505.04956):

1. ``pull`` HEAD ``(weights, version)`` from the store (never blocks);
2. compute the shard's local ``(grad_sum, loss_sum, count)`` at
   iteration ``version + 1`` — ONE kernel launch;
3. ``push`` the contribution with ``basis_version = version``.  A
   rejection (stale beyond the bound) discards the work and re-pulls;
   at τ=0 the push blocks until the barrier round applies.

Every device op of the per-cycle loop runs on the device's current
stream (the default stream, the same on every thread), and nothing of it
is captured.

Resident mode (``resident_rounds = K >= 1``, the JAX package's resident
worker): a round runs ``K`` supersteps of the same local sums against one
pulled basis (superstep ``t`` samples iteration ``version + 1 + t``: the
K-fold batch union), folds ``(G, L, C)`` on the device, and pushes and
pulls through the very host code of the per-cycle loop
(:meth:`ReplicaWorker._push_contribution`, :meth:`ReplicaWorker._account`).
On a card the round is ONE CUDA graph, the counterpart of the JAX
package's whole-run device loop: captured once, on the worker's own card
(a worker in this mode owns its card: ``ReplicaDriver`` runs it only with
a card a worker), on a side stream in ``thread_local`` capture mode, so
other threads launch and capture on their cards meanwhile; then replayed
once a round after the pulled weights are copied into its input and the
shard's sample stream is set to ``version + 1`` (its Philox offset, read
at replay time).  A capture that fails raises: the round never runs
eagerly on a card.  On the CPU the same body runs eagerly.  ``K = 1`` is
per-push bitwise the per-cycle loop on both wires; ``K >= 2`` is
matched-loss, not bitwise.  The graph goes when the worker's loop ends,
a death included, so a rejoined worker captures afresh and a long
elastic run keeps one graph a live worker.

Reliability: the ``replica.pull`` / ``replica.push`` failpoints fire at
the protocol hops and heal in place under the worker's ``RetryPolicy``;
an unretryable (or retry-exhausted) error kills the worker thread,
which the elastic driver detects, deregisters, and rejoins
(``replica/driver.py``).  The worker ticks a ``Heartbeat`` per cycle so
the health monitor can spot stragglers.

Partition tolerance (``replica/ha.py``): under a replicated store the
worker's ``store`` handle is a ``StoreClient`` — a push that lands on a
just-failed primary re-routes to the promoted one transparently, and
comes back ``fenced`` when its basis belongs to the superseded epoch
(handled exactly like a staleness rejection: the compressed wire
restores its extracted segment, the worker re-pulls and recomputes —
stale work is discarded WHOLE, its error-feedback mass is not).  A
worker that cannot reach ANY store sees ``StoreUnreachable`` from its
``RetryPolicy``-wrapped calls: a partition is just a longer rejection,
healed by retry or by death-and-rejoin — zero gradient mass lost either
way.

Compressed wire (``topk:<frac>``): the worker normalizes its
contribution to a batch-mean gradient on the host (one copy of the
``(d,)`` sum from the card a push), folds it through its persistent
per-worker :class:`~tpu_sgd_torch.io.sparse_wire.ErrorFeedback`
accumulator (registered with the STORE, so it checkpoints and survives
rejoin), and ships only the top-k segment.  A rejected compressed push
restores its extracted segment into the accumulator — staleness
rejections must not leak gradient mass.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.io.integrity import IntegrityError, integrity_enabled, seal
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.optimize.gradient_descent import (_host,
                                                     _make_local_sums,
                                                     _make_sampler)


def make_shard_local_sums(gradient, config, shard_index: int,
                          with_valid: bool):
    """The worker's local-sums function: its shard's per-iteration LOCAL
    ``(grad_sum, loss_sum, count)`` — the synchronous step's pre-combine
    half, from the shared ``_make_local_sums`` recipe and the shard's
    sample stream (``_make_sampler(..., shard=shard_index)``).
    ``fn(w, X, y, i)`` or ``fn(w, X, y, i, valid)``: iteration ``i``'s
    sample is taken by seeking the stream to ``i`` and drawing, which is
    random access on the CPU and on the card's Philox offset alike."""
    local = _make_local_sums(gradient, config)
    samplers = {}

    def sums(w, X, y, i, valid=None):
        key = (X.shape[0], str(X.device))
        if key not in samplers:
            samplers[key] = _make_sampler(config, X, shard=int(shard_index))
        sampler = samplers[key]
        sample = None
        if sampler is not None:
            sampler.seek(int(i))
            sample = sampler.draw()
        return local(w, X, y, sample, valid)

    if with_valid:
        return sums
    return lambda w, X, y, i: sums(w, X, y, i)


class ReplicaWorker:
    """See module docstring.  ``X_shard``/``y_shard`` are the worker's
    rows: a tensor on ``device`` is kept as it is (a view of the
    driver's rows, no copy), host rows are staged to ``device`` once
    here.  ``valid`` masks padding rows exactly like the meshed path's
    ``shard_dataset`` mask.  ``device``: ``None`` is the card."""

    #: consecutive poisoned rejections before the worker gives up
    #: LOUDLY (typed IntegrityError).  A poisoned rejection whose
    #: recompute is deterministic can only heal if the corruption was
    #: on the WIRE (the recompute ships clean) or the store's state
    #: changes under it (a rollback restores finite weights, bumping
    #: version/epoch and resetting this streak) — a payload that is
    #: GENUINELY bad, k times in a row against the same basis, would
    #: otherwise livelock the fleet: the victim spins poison→re-pull→
    #: identical poison while its τ=0 peers wait in the round barrier.
    #: Sized well above any rollback's detection latency (the driver's
    #: 0.1s health poll) at realistic cycle times.
    POISON_STREAK_LIMIT = 256
    #: ... and the streak must also have lasted this long: ten of the
    #: driver's 0.1 s health polls.  A poisoned cycle can take well under
    #: 0.1 ms here, and 256 of them would then run out before the
    #: rollback that heals them is even detected (a count alone only
    #: bounds the time at the cycle times it was sized for).
    POISON_STREAK_MIN_S = 1.0

    def __init__(
        self,
        worker_id: str,
        shard_index: int,
        store,
        gradient,
        config,
        X_shard,
        y_shard,
        valid=None,
        *,
        device=None,
        retry_policy=None,
        heartbeat=None,
        wire_frac: Optional[float] = None,
        resident_rounds: int = 0,
    ):
        self.worker_id = worker_id
        self.shard_index = int(shard_index)
        self.store = store
        self.config = config
        self.device = resolve_device(device)
        self.retry_policy = retry_policy
        self.heartbeat = heartbeat
        self._X = as_tensor(X_shard, self.device)
        self._y = as_tensor(y_shard, self.device)
        self._valid = (None if valid is None
                       else as_tensor(valid, self.device, torch.bool))
        self._local_sums = make_shard_local_sums(
            gradient, config, self.shard_index,
            with_valid=self._valid is not None)
        self.resident_rounds = max(0, int(resident_rounds))
        # the resident round's recipe and sample stream (the per-cycle
        # sums keep their own), and on a card its graph, built on the
        # first round
        self._local = _make_local_sums(gradient, config)
        self._sampler = (_make_sampler(config, self._X,
                                       shard=self.shard_index)
                         if self.resident_rounds else None)
        self._graph = None
        self._graph_in = None
        self._graph_out = None
        self._graph_launches = None
        self.ef = (None if wire_frac is None
                   else store.error_feedback(worker_id, wire_frac))
        # the store's per-shard coordinate layout (None = unsharded):
        # probed ONCE — a supervised group keeps one layout across
        # failovers (ha.StoreClient.shard_layout), so compressed pushes
        # can seal their per-shard splits at the producer
        self._shard_layout = (store.shard_layout()
                              if hasattr(store, "shard_layout")
                              else None)
        self.cycles = 0
        self.rejected = 0
        self.fenced = 0
        self.poisoned = 0
        self._poison_streak = 0
        self._poison_basis = None
        self._poison_since = 0.0

    def _call(self, fn, *args, **kwargs):
        if self.retry_policy is not None:
            return self.retry_policy.call(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    def _push_contribution(self, version: int, epoch, g, l, c):
        """Ship ONE ``(grad_sum, loss_sum, count)`` contribution computed
        at basis ``version`` over the configured wire — the dense sealed
        push, or the compressed top-k wire with its error-feedback
        restore-on-rejection discipline."""
        if self.ef is not None:
            # compressed wire: batch-mean normalize HOST-side (EF state
            # must accumulate at one scale), fold + select top-k.  This
            # is the wire boundary: the segment selection runs in host
            # numpy, so the contribution comes home here — one copy of
            # the (d,) sum plus its two scalars
            c_host = float(c)
            l_host = float(l)
            if c_host <= 0.0:
                # empty sampled batch: the store's apply is a no-op
                # (has_batch gates the update), so folding the EF
                # accumulator here would extract mass an ACCEPTED push
                # then silently discards — ship an empty segment instead
                # (the push still advances the protocol; the
                # accumulator is untouched)
                idx = np.zeros((0,), np.int32)
                vals = np.zeros((0,), np.float32)
            else:
                gn = _host(g).reshape(-1) / max(c_host, 1.0)
                idx, vals = self.ef.compress(gn)
            try:
                # seal the segment's host bytes: the store verifies at
                # ITS consume site, after the modeled wire hop — a
                # corrupt-detected push heals inside _call's retry with
                # the intact originals, EF mass untouched.  Against a
                # SHARDED store the seals additionally ride per-shard:
                # the producer splits exactly as the store will
                # (shard_layout) and seals each split, so a
                # misrouted/damaged shard segment is caught at the
                # store's per-shard consume site
                push_kw = {}
                if self._shard_layout is not None:
                    push_kw["shard_seals"] = tuple(
                        seal((idx[(idx >= a) & (idx < b)]
                              - a).astype(np.int32),
                             vals[(idx >= a) & (idx < b)])
                        for a, b in self._shard_layout)
                res = self._call(
                    self.store.push_compressed, self.worker_id,
                    version, idx, vals, l_host, c_host,
                    basis_epoch=epoch,
                    checksum=seal(idx, vals), **push_kw)
            except BaseException:
                # the push never produced a result (retry budget
                # exhausted, or a kill): this worker may die and REJOIN
                # re-attached to the same accumulator — the extracted
                # mass must go back first, or every such death leaks
                # gradient
                self.ef.restore_segment(idx, vals)
                raise
            if not res.accepted and not res.done:
                # stale push: the extracted mass must go back into the
                # accumulator or the rejection silently drops gradient
                self.ef.restore_segment(idx, vals)
            return res
        # the dense wire's seal: host copies of the local sums, verified
        # at the store's consume site, which takes these same host bytes
        # (one copy from the card a push).  Gated so set_integrity(False)
        # really removes the device→host staging
        ck = None
        if integrity_enabled():
            g, l, c = _host(g), _host(l), _host(c)
            ck = seal(g, l, c)
        return self._call(
            self.store.push, self.worker_id,
            version, g, l, c,
            basis_epoch=epoch, checksum=ck)

    def _account(self, res, version: int, epoch) -> None:
        """Post-push bookkeeping: the cycle / rejection / fenced /
        poisoned counters, the poison-streak limit, and the heartbeat
        tick."""
        self.cycles += 1
        if not res.accepted and not res.done:
            # a fenced push is the failover spelling of a staleness
            # rejection, a poisoned push the integrity spelling: the
            # work is discarded WHOLE either way — re-pull and
            # recompute (EF mass already restored above)
            if getattr(res, "fenced", False):
                self.fenced += 1
            elif getattr(res, "poisoned", False):
                self.poisoned += 1
                # the streak counts SAME-(epoch, basis) rejections: a
                # rollback moves the store to a restored version line
                # and the recompute against it is a genuinely new
                # payload — never charge it with the old line's spins
                basis = (epoch, version)
                if basis == self._poison_basis:
                    self._poison_streak += 1
                else:
                    self._poison_streak = 1
                    self._poison_since = time.monotonic()
                self._poison_basis = basis
                if (self._poison_streak >= self.POISON_STREAK_LIMIT
                        and time.monotonic() - self._poison_since
                        >= self.POISON_STREAK_MIN_S):
                    # the recompute is deterministic: this payload is
                    # genuinely bad and nothing upstream is changing —
                    # fail LOUDLY (the driver's rejoin budget absorbs a
                    # transient; an exhausted budget propagates this
                    # error, and its IntegrityError class is what the
                    # integrity.unhealed accounting keys on)
                    raise IntegrityError(
                        "replica.push", "poison",
                        f"worker {self.worker_id!r}: "
                        f"{self._poison_streak} consecutive poisoned "
                        f"rejections at basis {version} — the "
                        "deterministic recompute cannot heal this "
                        "(weights corrupted with rollback unarmed, or "
                        "genuine divergence)")
            else:
                self.rejected += 1
        if res.accepted:
            self._poison_streak = 0
        if self.heartbeat is not None:
            self.heartbeat.beat()

    def run_once(self) -> bool:
        """One pull → compute → push cycle; False when the run is done
        (the worker's loop exits)."""
        pulled = self._call(self.store.pull, self.worker_id)
        if pulled.done:
            return False
        i = pulled.version + 1
        w = pulled.weights
        if w.device != self._X.device:
            # the pull wire: HEAD weights hop to this worker's device
            # (a byte-exact copy — placement never changes the math)
            w = w.to(self._X.device)
        # ONE span per cycle — compute, (compress,) and push all tag
        # the 'replica' subsystem for the wire counters; at τ=0 the push
        # blocks on the round barrier, so the span duration shows where
        # a straggling fleet's wall clock goes
        with span("replica.step", worker=self.worker_id,
                  basis=pulled.version, i=i):
            if self._valid is not None:
                g, l, c = self._local_sums(w, self._X, self._y, i,
                                           self._valid)
            else:
                g, l, c = self._local_sums(w, self._X, self._y, i)
            res = self._push_contribution(
                pulled.version, pulled.epoch, g, l, c)
        self._account(res, pulled.version, pulled.epoch)
        return not res.done

    # -- resident mode: one round a push, a captured graph on a card --------

    def _round_body(self, w):
        """``K`` supersteps' local sums at basis ``w``, folded in order
        (the sample stream positioned at the round's first iteration)."""
        G = L = C = None
        for _ in range(self.resident_rounds):
            sample = None if self._sampler is None else self._sampler.draw()
            g, l, c = self._local(w, self._X, self._y, sample, self._valid)
            if G is None:
                G, L, C = g, l, c
            else:
                G, L, C = G + g, L + l, C + c
        return G, L, C

    def _capture_round(self, weights) -> None:
        """Capture the round once on this worker's card: on a side stream,
        in ``thread_local`` mode (other threads launch and capture on
        their cards meanwhile), the sample stream's generator registered.
        Raises when the capture fails; nothing falls back to the eager
        body."""
        dev = self._X.device
        self._graph_in = torch.empty(weights.shape, dtype=weights.dtype,
                                     device=dev)
        self._graph_in.copy_(weights)
        graph = torch.cuda.CUDAGraph()
        if self._sampler is not None:
            graph.register_generator_state(self._sampler.gen)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), ck.captured_launches() as record:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self._round_body(self._graph_in)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is broken: the body's error counts
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph, self._graph_out = graph, out
        self._graph_launches = record

    def _release_round(self) -> None:
        """Let go of the captured round, its pool and its buffers."""
        self._graph = self._graph_in = self._graph_out = None
        self._graph_launches = None

    def _round(self, weights, version: int):
        """One resident round's folded ``(G, L, C)`` at basis ``version``:
        on the CPU the body eagerly, on a card one replay of the captured
        round (copies of its outputs: the store may still hold them when
        the next replay writes)."""
        if self._X.device.type != "cuda":
            if self._sampler is not None:
                self._sampler.seek(version + 1)
            if weights.device != self._X.device:
                weights = weights.to(self._X.device)
            return self._round_body(weights)
        if self._graph is None:
            self._capture_round(weights)
        if self._sampler is not None:
            self._sampler.seek(version + 1)
        self._graph_in.copy_(weights)
        self._graph.replay()
        ck.add_replayed_launches(self._graph_launches)
        return tuple(t.clone() for t in self._graph_out)

    def run_round(self) -> bool:
        """One resident round: pull → ``K`` supersteps → push; False when
        the run is done.  A rejected push discards the round whole (the
        compressed wire restores its segment), and the next round re-pulls
        and replays at the new basis."""
        pulled = self._call(self.store.pull, self.worker_id)
        if pulled.done:
            return False
        with span("replica.round", worker=self.worker_id,
                  basis=pulled.version, k=self.resident_rounds):
            G, L, C = self._round(pulled.weights, pulled.version)
            res = self._push_contribution(
                pulled.version, pulled.epoch, G, L, C)
        self._account(res, pulled.version, pulled.epoch)
        return not res.done

    def run(self) -> None:
        """The worker main loop (the driver runs this on a thread):
        ``resident_rounds >= 1`` runs rounds, else pull → compute → push
        cycles.  A resident worker's graph goes when the loop ends, by
        death too."""
        if not self.resident_rounds:
            while self.run_once():
                pass
            return
        try:
            if self._X.device.type == "cuda":
                with torch.cuda.device(self._X.device):
                    while self.run_round():
                        pass
            else:
                while self.run_round():
                    pass
        finally:
            self._release_round()
