#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgd_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository.  Phases, each printing one JSON line:

1. device  — exits non-zero without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` gives them.
2. build   — compiles every CUDA source with ``nvcc`` (sm_90a), in parallel;
   prints each kernel's registers and spills (``window_sums.cu``'s
   ``window_main`` and ``gather_main`` apart).
3. kernels — each kernel wrapper against its plain PyTorch version on the
   card: three loss families x {f32, bf16} x {mask, no mask}, ragged row
   counts, d in {24, 1000, 47237}; the window kernels at random and
   clamped starts; ``FusedGradient``'s tile-floored windows.  Then the
   window route by shape: d in {24, 1000, 2048, 4096} and 7,216 bf16
   (``window_sums.cu``), 7,216 f32 and 47,237 (``fused_sums.cu``, counted
   by source) x f32/bf16 x the three families, windows of 1, R - 1, R,
   R + 1 rows (R the planner's stage rows), fewer rows than the grid and
   65,536 rows, starts random, negative and past the end, ``valid`` on
   and off, each call repeated bitwise.  Then the CSR kernel bit for bit
   against its numpy walk (``cuda_kernels.csr_walk``) on small matrices
   (empty rows, rows of 1-33 entries, a row longer than three blocks'
   shares, many rows of 1-3 entries), T in {1, 2, 30, 1024}, int32 and
   int64 indices, no mask and a mask at both block shares; and an int64
   CSR whose row holds more than 2^31 entries, at T = 1 and 2.  Then B1 by
   shape: d in {24, 1000, 2048, 4096, 7216} x f32/bf16 x the three
   families, unmasked and under masks of no live row, one, 0.1%, 10%, 30%,
   all, the blocks' share boundaries only and a prefix: against the plain
   version, a second call bitwise, the all-true mask bitwise the unmasked
   call, the ring's grid on the card equal to its mirror, the route
   (``window_sums.cu``'s gather or window entry; ``fused_sums.cu`` for
   7,216 f32 and a misaligned base) counted by source.
4. full    — the main path at config 4's width: 10,000,000 x 1000 bf16
   least squares made on the card from a seed, trained through
   ``LinearRegressionWithSGD`` at ``mini_batch_fraction=0.1``: Bernoulli,
   sliced, and sliced through ``FusedGradient(window_kernel="vpu")``.
   Launch counts (by wrapper and by CUDA source) are set to 0 before and
   read after; each kernel must have run once per iteration, all in
   ``window_sums.cu`` (B1's Bernoulli batch in its gather entry).  Then a
   profiler trace splits an iteration's device time by kernel, and each
   kernel is timed at these shapes beside its plain version, one PyTorch
   call of the same work and its bound.  B1 and the window kernel are
   timed beside their old route (``fused_sums.cu``) in turns (old, new,
   new, old), each as device time (launches captured in a CUDA graph, the
   replay timed with events) and as back-to-back calls paced by the host;
   masked B1's library yardstick is an ``index_select`` of the live rows
   and two matmuls over them.
5. configs — configs 1-3 of BASELINE.md through the user API, each held to
   its pass criterion against a numpy/scipy oracle: config 3 both on dense
   ``svm_data`` and undensified on its RCV1 stand-in after a LIBSVM round
   trip (against the LP oracle and against the dense path on the same
   data; the file must be read by the native parser, built on the card's
   host at first use); then config 5, streaming SGD over ten
   micro-batches.
6. sparse  — config 3 at full RCV1 scale, 697,641 x 47,236 with 75
   nonzeros a row, made on the card from a seed and trained undensified
   (hinge + L1) at frac 1.0 and 0.1: loss, accuracy, peak memory, dense
   kernel launches (must stay 0), warm ms per iteration, device time by
   op, idle share, CSR bytes, the bandwidth bound and bitwise repeatability.
7. quasi_newton — the L-BFGS, OWL-QN and normal-equations paths:
   (a) binary L-BFGS (``LogisticRegressionWithLBFGS``, 20 iterations) on
   the 10M x 1000 bf16 matrix of phase 4 with labels from a planted
   logistic model, every cost evaluation one unmasked launch of the fused
   kernel (counted exactly), against 20 full-batch SGD iterations and a
   numpy AUC of the same scores; the iteration split by the profiler and
   the kernel timed at this full-batch shape; (b) exact least squares
   (``LinearRegressionWithNormal``) on the same matrix against
   ``LinearRegressionWithLBFGS`` and the planted weights, the Gram pass
   timed against its bound; (c) multinomial L-BFGS at MNIST8M's shape
   (8,100,000 x 784 bf16, 10 classes) against the planted softmax model's
   accuracy; (d) sparse OWL-QN on phase 6's RCV1-scale CSR: hinge + L1
   (history non-increasing, objective below its start, reported beside
   the SGD path's), and logistic + L1 against a full-batch SGD run of the
   same objective, with the dense kernels' launch counts 0 and the peak
   memory bounded.  Configs 1 and 2 of phase
   5 also run through ``LinearRegressionWithNormal`` and
   ``LogisticRegressionWithLBFGS``, and config 1 from sufficient
   statistics with sliced windows.
8. gram — least squares from block-prefix Gram statistics on phase 4's
   matrix (runs right after leg (b)): (a) the build (time against its
   bound, stack and peak bytes); (b) exact-mode windows against B2 at a
   random, a block-boundary and a clamped 1M-row start; (c) SGD from the
   statistics on phase 4's sliced windows (history against the exact f32
   sums of the same windows, objective against the stock run, no fused
   launch); (d) aligned windows, per iteration and through the chunked
   driver (which must equal them); (e) L-BFGS from the statistics against
   leg (b)'s; (f) ``ChunkedGradient``, one B2 launch per 65,536-row block
   (counted exactly) against phase 4's sliced run; (g) ``GramData.save`` /
   ``load`` at config 1's size; (h) the exact window loss near convergence
   against f64 sums, with the statistics' sums in f64 (as built) and in
   f32 (the JAX package's choice).  Each run's warm wall and device ms
   per iteration, idle share, and host operator calls per iteration.
9. observed — on phase 4's matrix, right after phase 8: each row
   (Bernoulli, indexed, sliced, sliced-vpu, statistics exact, aligned and
   chunked, ``ChunkedGradient``) run 20 iterations with every K-iteration
   block eager (``gradient_descent.CUDA_GRAPHS = False``) and with full
   blocks replayed from their CUDA graph, in turns (eager, captured,
   captured, eager), after one first run in each mode (a first run of 20
   iterations must not capture: its one replay cannot repay a capture;
   the next run on the same tensors warms up its first block and
   captures the second, and every later run replays both): weights and
   history
   bitwise equal, launches exact by wrapper and by source in both modes
   (one per iteration the card runs: a replay counts the launches its
   capture recorded), the capture's one-off ms, graph replays and host
   syncs per run (torch's sync detector), peak and reserved memory of the
   eager first run and of the run that captures, and each mode's wall and
   device ms per iteration, idle share and host operator calls.  Then the
   observed driver on the sliced run (72 iterations): a listener and
   checkpoints every 5 iterations at K = 1, K = 8 and K = 8 with C = 4
   must give the same history, events and checkpoint contents; a stop
   raised at iteration 13 and a resume must equal the uninterrupted run,
   also under ``TrainingSupervisor``.  The updater's device step for
   i = 1 .. 10^6 must equal the host's rounding; each sampler's draw is
   timed.
9b. replica — async replicated training (``tpu_sgd_torch.replica``) on
   phase 4's matrix, right after phase 9: 8 replica workers as threads on
   the card, each on a view of its row block, through ``ReplicaDriver``
   at its default devices.  (a) τ=0 on the 1M-row prefix, Bernoulli and
   sliced, 20 rounds: bitwise the one-process rank-order sum of the same
   8 shards, launches exactly 8 x 20, 160 pushes accepted at staleness 0.
   (b) τ=0 over all 10M rows: launches exact, the objective within 1.01x
   of phase ``profile``'s single-device run, wall and device ms a round
   and the host's share; then 200 rounds.  (c) τ=2 for 200 applied steps:
   every accepted push within the bound (traced), one launch per push
   attempt, the objective within 1.01x of (b)'s 200 rounds, steps/s and
   the staleness histogram.  (d) the ``topk:0.01`` wire on the prefix at
   τ=0 and τ=2 against the dense objective, wire bytes ~2·frac.  (e) a
   standby bitwise the primary at every version, ``kill_primary()`` from
   a timer and the sharded store at S = 4, each bitwise the fault-free
   run.  (f) a stop at round 13 and its resume, bitwise.  B1 timed at a
   worker's shard under 8 threads' concurrent launches.
9c. obs — the observability layer (``tpu_sgd_torch.obs``) on runs that
   already happen.  (a) at the end of phase 9: the observed driver's
   sliced run (72 iterations, K = 8, a listener), warmed, with the layer
   off under torch's sync detector and on under ``obs.enable(trace)``:
   ``train.dispatch`` equals the run's graph replays plus its launches
   outside a capture, ``compile`` is 0, ``host_sync`` equals the sync
   detector's count, the run is bitwise the one with the layer off; the
   wall an iteration off and on (not gated).  (b) in phase 9b (e): the
   fault-free HA run and the killed one each under ``obs.enable(trace,
   detect=True, flightrec=...)``: the fault-free run trips nothing and
   dumps nothing, the killed run (still bitwise the fault-free one)
   trips ``failover`` once per failover and the flight recorder's dump
   names ``alert:failover``.  (c) on the killed run's trace, three
   subprocesses at once: ``python -m tpu_sgd_torch.obs.report`` exits 0
   on an SLO document the run meets (writing a Chrome trace that loads)
   and 1 on one it violates, its alerts section names ``failover``, and
   ``python -m tpu_sgd_torch.obs.watch --once`` renders.
9d. analysis — graftlint's runtime checkers (``tpu_sgd_torch.analysis``)
   on phase 4's matrix, right after phase 9c (a).  (a) A 20-iteration
   Bernoulli SGD run at K = 10 (``make_run``), run until both blocks
   replay from the graph: around that run ``count_dispatches()`` equals
   the block runner's replays plus its launches outside a capture, and
   is above 0; around a second identical run ``assert_compile_count(0)``
   holds (the ``_run_cache`` hit captures and builds nothing).  (b)
   ``count_host_syncs()`` around phase 9c (a)'s observed run equals
   torch's sync detector's count on the same run, above 0; the replayed
   run of (a) reads the card only at its end (``assert_no_host_sync``
   with the run's two boundary reads allowed, and those two exactly).
   (c) Binary L-BFGS of leg (a) at one and at two iterations: the host
   reads one iteration adds.
10. streamed — host-streamed SGD (``set_host_streaming``), right after
   phase 9: phase 4's matrix copied to the host once, into a memfd that
   phase 12's ranks map too (the phase fails, naming the shortfall, when
   the host lacks the room for it and the staging ring).  (a) 3 full-batch iterations streamed against the
   resident run on the same X (B1 masked by the batch's valid mask
   against B1 unmasked): loss rtol 2e-4, weights at the gradient tier;
   (b) Bernoulli, indexed and sliced at frac 0.1, 6 iterations each at
   the full 10M rows: wall, device (kernels, copies) and idle share from
   a 2-iteration traced run, the worker's assembly and checksum ms a
   batch, H2D GB/s, logical and physical wire bytes, pinned, peak device
   and host bytes; (c) on a 1M-row prefix, bitwise: the pinned ring's
   slot reuse under a slow step, prefetch depth 2 against 0, K = 1
   against K = 8 (Bernoulli) and against K = 8 with C = 4 (full batch,
   fully resident slab), a resident half against none (the transferred
   windows counted against ``resident_window_probability``), one
   ``io.device_put`` fault and one ``io.chunk`` corruption healed, a stop
   at 13 and its resume, ``topk:0.01`` at K = 8 against K = 8 with C = 4
   (its final loss against the dense wire's reported); (d)
   ``predict_streamed`` over the 10M host rows against ``predict``.
   After phase 6: the RCV1-scale CSR as host arrays, Bernoulli at 0.1
   and full batch, 60 iterations: repeat, prefetch A/B and K = 8 against
   K = 1 bitwise, exact CSR launches, wire bytes >= 10x below dense f32,
   peak device bytes below one dense batch; then the CSR kernel against
   its plain twin and cuSPARSE at the sparse path's shapes, each call at
   most two CUDA launches (the nodes of its captured graph), without a
   host sync, and replayed from a CUDA graph bitwise.
11. streamed_qn — the streamed statistics and quasi-Newton feeds, right
   after phase 10's dense legs, on its host copy of the 10M x 1000 rows:
   (a) binary L-BFGS (logistic + L2, 5 iterations) with every cost
   evaluation and sweep streamed from the host rows at the default chunk
   (``set_host_streaming``): history rtol 2e-4 against the resident run, a
   second run bitwise, B1 launches exactly chunks x cost evaluations; wall
   ms, cost evaluations and sweeps per iteration, H2D GB/s, device ms and
   idle share from a traced 2-iteration run, the bound at phase 10's H2D
   rate; B1 timed at the chunk shape and at the tail's prefix mask, each
   against its old route in turns; (b) OWL-QN (logistic + L1, 3
   iterations) streamed from the first 2M rows against the resident run;
   (c) ``build_streamed`` (B = 8,192) bitwise the resident build of the
   whole blocks, its seconds against phase 8's build and the transfer
   bound, its peak under the stack + 1 GB + the staged chunks; then
   ``set_streamed_stats`` for sliced SGD (bitwise the resident aligned
   run) and for L-BFGS (phase 8 leg (e)'s objective within 1 + 1e-4);
   (d) a streamed build and the normal equations' streamed totals over
   the first 1M rows stopped by a fault in the feed and resumed, bitwise;
   (e) the normal equations from streamed totals over the 10M rows: leg
   (b) of phase 7's objective within 1 + 1e-5, two runs bitwise.
11b. plan — the execution planner (``tpu_sgd_torch/plan.py``), right
   after phase 11 (phase 4's rows on the card, phase 10's on the host):
   (a) ``CostModel.calibrate()`` on the card, both probes accepted, the
   rates beside the defaults; (b) ``device_budget()`` equal to (free +
   reserved - allocated) × ``hbm_safety`` from torch's readings; (c) a
   zero-flag ``LogisticRegressionWithSGD.train`` on the 10M x 1000 bf16
   rows at frac 0.1 plans ``resident_stock``, exactly one B1 launch an
   iteration, bitwise the ``set_schedule("off")`` run; (d) zero-flag least
   squares, sliced at 0.1 on a 5M-row prefix, with enough iterations that
   the build amortizes, plans ``resident_gram``, no fused launch, bitwise
   the run with the statistics and the plan's block size set by hand; (e)
   ``plan_for`` on phase 10's 20 GB of host rows under an ``hbm_safety``
   that puts the budget at half their bytes names a streaming schedule,
   and its applied run is bitwise the hand-set one (phase 10 (b)'s
   Bernoulli run, whose knobs match); (f, in phase 5) ``NormalEquations``
   on config 1's host data places itself resident and logs nothing, and
   config 1 trains zero-flag and prints its plan line.  Then each
   schedule's estimate beside the wall this run measured on its route,
   and, after phase 12, the measured ``CostModel`` fields beside the
   defaults.  Every other phase that measures a named route pins it
   (``set_schedule("off")`` or its explicit flags).
12. mesh — data parallelism (``tpu_sgd_torch.parallel``), after the
   sparse phases, on its own 10M x 1000 bf16 matrix made as 8 row blocks
   from ``(seed, block)``: (a) this process as a mesh of one rank over
   NCCL, full batch bitwise the single-device run, Bernoulli and sliced
   captured (the gather inside the CUDA graph) bitwise the eager blocks
   with exact launches, wall and device ms beside phase 4's profile; (d)
   the observed driver on that mesh (a listener at K = 1 and 8, a stop at
   13 and its resume, bitwise); (b) 8 ranks on the one card over gloo,
   subprocesses of this script (``--mesh-rank``), 1.25M rows each:
   Bernoulli, indexed, sliced at 0.1 and full batch twice each, launches
   exact per rank, every rank bitwise equal, full batch and a 1M-row
   prefix bitwise the one-process rank-order sum, objectives within
   1.01x of the single-device runs; (c) phase 6's CSR in 8 row blocks
   over the same world, hinge + L1 at 1.0 (history rtol 2e-4 against one
   device) and 0.1, peak memory per rank; the kernels timed at a rank's
   shapes.  Then, in the same job, resident training on a mesh: (e) the
   4 x 2 ``(data, model)`` mesh (a rank 2.5M rows x 500 columns; full
   batch, Bernoulli, sliced; bitwise the one-process 2-D rank-order sum
   on a 1M-row prefix and on all rows, 0 fused-kernel launches, two
   library products an iteration, the margin combine timed); (f) meshed
   L-BFGS (B1 a cost evaluation, bitwise its reference); (g) the meshed
   normal equations; (h) the meshed statistics (each rank's prefix stack,
   sliced exact and aligned, L-BFGS from the meshed totals); (i)
   ``set_residency`` and feature scaling on a mesh, OWL-QN on the 8 CSR
   blocks.  Then host-streamed training on the mesh, each rank mapping
   phase 10's 20 GB of host rows (one memfd) and passing them whole: (j)
   SGD, Bernoulli and sliced at 0.1 over the 10M rows (wall ms a rank),
   and on a 1M-row prefix every mode bitwise the one-process rank-order
   sum of the same shares, repeated, at prefetch depth 0, at K = 8, a
   stop at 13 and its resume, against one device's streamed run (full
   batch history rtol 3e-3 and objective within 1e-4, sampled <= 1.01x);
   (k) the ``topk:0.01`` wire (bitwise its reference, K = 8, the EF
   resume, 600 full-batch iterations within 1.01x the dense wire's
   objective, the bytes gathered); (l) L-BFGS and OWL-QN through the
   streamed CostFun against phase 11's (a) and (b) (rtol 2e-4), twice
   bitwise, B1 launches = chunks x cost evaluations a rank; (m) the
   streamed statistics (each rank's stack bitwise its resident build,
   the virtual run bitwise its rank-order reference, a resumed build),
   the totals' dense and compressed merges, L-BFGS from them and the
   streamed normal equations within 1e-5 of phase 11's; each rank's
   resident host memory grows by less than half the rows' bytes.
13. serve — the serving plane (``tpu_sgd_torch.serve``, ``.tenant``),
   after phase 12: through ``Server``, 12,000 single-row requests a model
   from 8 client threads (4,000 closed loop, one in flight a client: p50
   / p99 latency; the rest open loop: rows/s at saturation) for config
   4's width (1,000; served from a ``ModelRegistry`` whose checkpoint
   directory gets 4 new versions mid-traffic), config 2's (a9a, 123,
   logistic scores), multinomial at MNIST8M's shape (784 x 10 classes)
   and config 3's RCV1 width (47,236, sparse rows of 75 entries, SVM
   margins).  Every dense batch bitwise ``model.predict`` on the same
   rows (the batch's own registry version), every answer its batch's, no
   padded-shape key after warm-up; sparse answers within 1e-6 relative of
   ``model.predict`` on all rows, each batch re-scored bitwise, one CSR
   kernel launch a batch (counts set to 0 before, read after).  Then each
   bucket's product alone (graph replays) against its bytes bound, and a
   batch of 8 and of 512 rows: wall, H2D and D2H ms, device ms, kernels
   and copies, the host's share.  Then 10,000 tenants' checkpoints
   written, a 1,024-row slab at width 1,000, Zipf(1.1) traffic through
   ``TenantServer`` (the same split) while 8 hot tenants are republished
   6 times: uniform batches bitwise the single-model engine on one
   version, mixed rows within 1e-5 of one version, one version a tenant
   a batch, admissions from disk and evictions counted.  The CSR kernel
   at 1, 8, 32, 128 and 512 RCV1 rows against its plain twin and
   cuSPARSE joins the kernel table.
   Each served dense batch is also held to a float64 numpy score of its
   model (within 1e-5 of ``|x|.|w| + |b|`` a row; MNIST8M's classes on
   every row whose top two logits lie 1e-3 apart).
14. corr — ``stat.corr`` of a CSR matrix (100,000 x 4,096, 75 entries a
   row, made from a seed): its Gram by column blocks through the CSR
   kernel (``csr_grad_sum``, one launch a block of 1,024 columns and one
   for the column means, counted), two calls bitwise equal, against a float64 correlation of
   the dense copy on the card; the kernel at a block's shape joins the
   kernel table.
14b. scenario — the production scenarios (``tpu_sgd_torch.scenario``) in
   their ``"full"`` mode, each with every launch count set to 0 just
   before and read just after: (a) ``run_scenario(seed=0, smoke=False)``
   (a replica fleet of 3 workers retraining on a drifting stream at the
   JAX package's width 16 — B1 a push — while a dense, a sparse (the CSR
   kernel) and a multinomial endpoint serve an open-loop burst; a worker
   killed and rejoined, the primary store killed and its standby
   promoted under delta-log corruption): exit code 0 (every SLO: p99 <=
   1.0 s, interactive shed <= 0.5, failover <= 10 s, zero dropped, ...),
   a flight record with its meta header, >= 1 failover, >= 1 rejoin, >= 2
   hot reloads, corruption detected and none unhealed, the ledger
   conserved, B1 (by route) and ``csr_margins`` launched; (b)
   ``run_tenant_scenario(seed=0, smoke=False)`` (4,000 tenants, width 32,
   a 256-row slab): exit code 0, ``tenant.swap`` and ``tenant.evict``
   above 0, a ``slab-thrash`` alert; after each run ``torch.Tensor``'s
   read methods are torch's own again.  Per lane p50 / p99, rows/s, the
   failover span, alerts and walls are printed.  B1 at a worker's shard
   and the CSR kernel at the sparse endpoint's batch join the kernel
   table with the scenario's launches, while (c) ``python -m
   tpu_sgd_torch.analysis.lint`` must exit 0 with all thirteen rules.
15. summary — the sparse line, the quasi_newton line, the gram line, the
   streamed line, the streamed_qn line, the plan line, the mesh line, the serve line,
   the corr line, the scenario line, the replica line, the observed line,
   the obs line, the kernel table
   (B1-B3, B1 at a replica worker's shard under concurrent launches, B1 at
   the
   streamed chunk shape and its tail, the CSR kernel, B1, B2 and the CSR
   kernel at a mesh rank's shapes, B1 at a streamed rank's shares (a
   Bernoulli share, a window share, a CostFun chunk's share and an empty
   one), the CSR kernel at the serving shapes
   and at a correlation block), then
   the card's name and power limit, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero.  It imports
nothing of JAX or of the JAX package ``tpu_sgd``.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import mmap
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, f32 outside the tensor cores
F64_FLOPS = 67e12           # H100 SXM data sheet, f64 on the tensor cores
FULL_ROWS, FULL_D, FRAC, ITERS = 10_000_000, 1000, 0.1, 20
WINDOW_TILE = 2000          # divides both 10^7 and the 10^6-row window
SOURCE = "tpu_sgd_torch/ops/csrc/fused_sums.cu"
WINDOW_SOURCE = "tpu_sgd_torch/ops/csrc/window_sums.cu"
RCV1_ROWS, RCV1_D, RCV1_NNZ = 697_641, 47_236, 75
SPARSE_ITERS = 60
SPARSE_MEMORY_LIMIT = 8e9   # bytes; densified f32 this data is 131.8 GB
# rows of config 3's undensified leg, cut from the stand-in's 20,000 so
# that its LP oracle (HiGHS) stays within about a minute
CONFIG3_SPARSE_ROWS = 10_000
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
QN_ITERS = 20               # L-BFGS iterations of legs (a)-(c)
MNIST8M_ROWS, MNIST8M_D, MNIST8M_K = 8_100_000, 784, 10
OWLQN_ITERS = 50
# "the history does not increase": the accepted point's objective is
# re-evaluated by the cost pass after the sweep accepted it, with another
# summation order, so a flat step may read higher by f32 rounding
HISTORY_RTOL = 1e-6
GRAM_BLOCK = 8192           # the statistics' prefix block (the default)
GRAM_CHUNK_ITERS = 8        # the chunked gram driver's K of leg (d)
CHUNK_ROWS = 65536          # ChunkedGradient's block of leg (f)
#: leg (f): ChunkedGradient against the stock window at equal weights,
#: per step, relative (loss; gradient of max |g|).  Sound runs read
#: 1.97e-7 / 2.23e-7 (PERF.md); a window one row short at each
#: of its 16 block seams reads 3.8e-5 / 3.5e-4.
CHUNKED_STEP_RTOL = 2e-6
CONFIG1_GRAM_FRAC = 0.5     # config 1's sliced fraction from statistics
GRAM_CONFIG1_BLOCK = 1024   # leg (g)'s block at config 1's 100k rows
CSR_SOURCE = "tpu_sgd_torch/ops/csrc/csr_products.cu"
#: B1's kernels and their second passes as the profiler names them
#: (window_sums.cu's entries, or fused_sums.cu's)
B1_KERNELS = tuple(f"void (anonymous namespace)::{k}" for k in (
    "window_main", "gather_main", "window_reduce", "sums_phase"))
REPLACES = {
    "fused_gradient_sums": "tpu_sgd/ops/pallas_kernels.py:265",
    "fused_window_sums": "tpu_sgd/ops/pallas_kernels.py:342",
    "fused_window_sums_vpu": "tpu_sgd/ops/pallas_kernels.py:425",
    # not Pallas kernels: XLA's BCOO products in the JAX package
    "csr_margins": "tpu_sgd/ops/gradients.py:61",
    "csr_grad_sum": "tpu_sgd/ops/gradients.py:81",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, launches: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call that the host cannot pace: ``launches``
    calls captured in a CUDA graph (after a warm-up call on the capture
    side stream), the graph replayed ``replays`` times between two
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (launches * replays)
    del graph
    return ms


def ptxas_report(log: str) -> dict:
    """Most registers and spill bytes of any kernel in one ``-Xptxas -v``
    log."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
    return {"max_registers": max(regs) if regs else None,
            "max_spill_bytes": max(spills) if spills else None}


def _entry_name(mangled: str) -> str:
    """A kernel's own name from its mangled one (the name after an
    anonymous namespace's, or the free function's)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if m:
        rest = mangled[m.end() + int(m.group(1)):]
        m2 = re.match(r"(\d+)", rest)
        if m2:
            return rest[m2.end():m2.end() + int(m2.group(1))]
    m = re.match(r"_Z(\d+)", mangled)
    if m:
        return mangled[m.end():m.end() + int(m.group(1))]
    return mangled


def ptxas_entries(log: str) -> dict:
    """Registers (each instance's, sorted) and most spill bytes of each
    kernel in one ``-Xptxas -v`` log, by the kernel's name."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = _entry_name(part.split("'")[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        e = out.setdefault(name, {"registers": [], "max_spill_bytes": 0})
        if regs:
            e["registers"] = sorted(set(e["registers"])
                                    | {int(regs.group(1))})
        if spill:
            e["max_spill_bytes"] = max(e["max_spill_bytes"],
                                       int(spill.group(1)))
    return out


# -- phase 3 -----------------------------------------------------------------

def _close(torch, got, ref, bf16: bool):
    """Kernel vs plain on one output triple.  f32: the bounds of
    tests/test_pallas.py (grad rtol 2e-4 / atol 2e-3, loss rtol 2e-4).
    bf16: both sides round w and coeff to bf16 at the same points, but
    their f32 margins are summed in other orders, so a row whose coeff
    sits on a bf16 rounding boundary (or a hinge row on its margin) can
    move by one bf16 ulp (2^-8) — bounded normwise: max |dg| <= 4e-3 *
    max |g|, loss rtol 1e-3.  Count exact in both."""
    g, l, c = (t.double().cpu() for t in got)
    gr, lr, cr = (t.double().cpu() for t in ref)
    err = float((g - gr).abs().max()) if g.numel() else 0.0
    scale = float(gr.abs().max()) if gr.numel() else 0.0
    if bf16:
        ok_g = err <= 4e-3 * scale + 1e-6
        ok_l = abs(float(l - lr)) <= 1e-3 * abs(float(lr)) + 1e-6
    else:
        ok_g = bool(torch.all((g - gr).abs() <= 2e-3 + 2e-4 * gr.abs()))
        ok_l = abs(float(l - lr)) <= 2e-4 * abs(float(lr)) + 1e-9
    return ok_g and ok_l and float(c) == float(cr), err, scale


def _problem(torch, gen, n, d, family, dtype):
    dev = "cuda"
    X = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    w = torch.randn(d, generator=gen, device=dev) / math.sqrt(d)
    if family == "least_squares":
        y = torch.randn(n, generator=gen, device=dev)
    else:
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    return X, y, w


def phase_kernels(torch, ck, grads):
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = 0
    worst = {}
    for d, n in ((24, 5003), (1000, 5003), (47237, 1003)):
        for name, g in grads.items():
            for dtype in (torch.float32, torch.bfloat16):
                X, y, w = _problem(torch, gen, n, d, name, dtype)
                bf16 = dtype == torch.bfloat16
                for use_mask in (False, True):
                    mask = (torch.rand(n, generator=gen, device="cuda") < 0.3
                            if use_mask else None)
                    got = ck.fused_gradient_sums(g.pointwise, X, y, w, mask)
                    ref = ck.fused_gradient_sums_plain(g.pointwise, X, y, w,
                                                       mask)
                    ok, err, scale = _close(torch, got, ref, bf16)
                    check(ok, f"fused_gradient_sums {name} {dtype} d={d} "
                          f"mask={use_mask}: max|dg|={err} of {scale}")
                    key = "fused_gradient_sums"
                    worst[key] = max(worst.get(key, 0.0), err)
                    cases += 1
                    # no float atomics: a second call is bitwise equal
                    again = ck.fused_gradient_sums(g.pointwise, X, y, w, mask)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"fused_gradient_sums {name} {dtype} d={d} is not "
                          "deterministic")
    # window kernels: random, negative and past-the-end starts (clamped)
    tile = 256
    n, d = 32 * tile, 1000
    for name, g in grads.items():
        for dtype in (torch.float32, torch.bfloat16):
            X, y, w = _problem(torch, gen, n, d, name, dtype)
            for kernel in (ck.fused_window_sums, ck.fused_window_sums_vpu):
                for start_tile in (5, 0, 24, -3, 1000):
                    s = torch.tensor([start_tile], device="cuda")
                    got = kernel(g.pointwise, X, y, w, s, 8, tile_m=tile)
                    ref = ck.fused_window_sums_plain(g.pointwise, X, y, w,
                                                     start_tile, 8, tile)
                    ok, err, scale = _close(torch, got, ref,
                                            dtype == torch.bfloat16)
                    check(ok, f"{kernel.__name__} {name} {dtype} "
                          f"start_tile={start_tile}: max|dg|={err}")
                    worst[kernel.__name__] = max(
                        worst.get(kernel.__name__, 0.0), err)
                    cases += 1
            # FusedGradient: a start that is not tile-aligned is floored
            # to its tile; the sub-tile remainder goes through the base
            for wk in ("mxu", "vpu"):
                fg = ck.FusedGradient(g, tile_m=tile, window_kernel=wk)
                m = 8 * tile + 100
                got = fg.window_sums(X, y, w, torch.tensor([777],
                                                           device="cuda"), m)
                floor = (777 // tile) * tile
                ref = ck.fused_gradient_sums_plain(
                    g.pointwise, X[floor:floor + m], y[floor:floor + m], w)
                ok, err, _ = _close(torch, got, ref, dtype == torch.bfloat16)
                check(ok, f"FusedGradient({wk}) {name} {dtype}: {err}")
                cases += 1
    # a feature width past the shared-memory limit raises before launch
    try:
        ck._check_tile_smem(torch.empty(0, 60_000))
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: _check_tile_smem took d=60000")
    routed = window_route_cases(torch, ck, grads, gen, worst)
    routed += gather_route_cases(torch, ck, grads, gen, worst)
    walked = csr_walk_cases(torch, ck, worst)
    walked += csr_long_row_cases(torch, ck)
    torch.cuda.synchronize()
    return cases + routed + walked, worst


def csr_long_row_cases(torch, ck):
    """The CSR kernel on an int64 CSR whose middle row holds more than
    2^31 entries (26 GB on the card), at T = 1 and 2: the block where
    that row ends lies more than 2^31 entries past the row's start, and
    must still pass its part to the second pass as a head carry.  Every
    column index is 0 and every value 0 but the first S and those from
    that block on (the rows around the long one, its first entries and
    its last block's), so each row's sum is a small integer, exact in any
    order."""
    S = ck.CSR_BLOCK_ITEMS
    # row 1's end mark is the last item of its block
    L = (-(-2**31 // S) + 2) * S - 9
    crow_np = np.cumsum([0, 7, L, 3]).astype(np.int64)
    split = ck.csr_split(crow_np, S)
    hb = int(np.flatnonzero(split.head_row == 1)[0])
    check(int(split.first_entry[hb] - crow_np[1]) > 2**31,
          f"csr long row: block {hb} lies within 2^31 of the row's start")
    nnz = int(crow_np[-1])
    col = torch.zeros(nnz, dtype=torch.int64, device="cuda")
    val = torch.zeros(nnz, dtype=torch.float32, device="cuda")
    val[:S] = 1.0
    val[int(split.first_entry[hb]):] = 1.0
    X = torch.sparse_csr_tensor(torch.from_numpy(crow_np).cuda(), col, val,
                                size=(3, 1))
    sums = torch.stack([val[int(a):int(b)].sum()
                        for a, b in zip(crow_np[:-1], crow_np[1:])])
    for T in (1, 2):
        rhs = torch.arange(1, T + 1, dtype=torch.float32,
                           device="cuda").reshape(1, T)
        got = ck.csr_margins(X, rhs[:, 0] if T == 1 else rhs)
        want = (sums[:, None] * rhs).reshape(got.shape)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        check(bool(torch.equal(got, want)),
              # graftlint: disable=host-sync -- chip check: reads each case back to compare it
              f"csr long row T={T}: {got.tolist()} != {want.tolist()}")
    del X, col, val
    torch.cuda.empty_cache()
    return 2


def csr_walk_cases(torch, ck, worst):
    """The CSR kernel bit for bit against its numpy walk (``ck.csr_walk``,
    the order of additions that the CPU tests hold against the plain twin
    and the JAX package's BCOO products), and within 1e-4 of its scale of
    the plain twin: rows of 0, 1, 31, 32, 33 and 75 entries with one
    longer than three blocks' shares, and 3,000 rows of 1-3 entries (a
    transposed CSR's tail); T in {1, 2, 30, 1024}; int32 and int64
    indices; no mask and a Bernoulli mask, the mask also at the wide share
    that only large masked calls take.  Then a matrix without entries and
    one without rows."""
    rng = np.random.default_rng(5)
    min_blocks = ck.CSR_MASKED_MIN_BLOCKS
    shapes = {
        "mixed": np.concatenate([[0, 1, 31, 32, 33, 0, 0, 75,
                                  3 * ck.CSR_BLOCK_ITEMS + 500, 2],
                                 rng.integers(0, 40, 300)]),
        "short": rng.integers(1, 4, 3000),
        "empty": np.zeros(700, np.int64)}
    cases = 0
    for shape, lens in shapes.items():
        k = int(max(64, lens.max() + 64))
        col = np.concatenate([np.sort(rng.choice(k, int(n), replace=False))
                              for n in lens] + [np.zeros(0, np.int64)])
        val = rng.normal(size=col.size).astype(np.float32)
        crow = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        rows = crow.size - 1
        for idt in (torch.int32, torch.int64):
            X = torch.sparse_csr_tensor(
                torch.from_numpy(crow).to(idt), torch.from_numpy(col).to(idt),
                torch.from_numpy(val), size=(rows, k)).cuda()
            for T in (1, 2, 30, 1024):
                rhs = rng.normal(size=(k, T)).astype(np.float32)
                keep = rng.random(rows) < 0.4
                # no mask; a mask at the share these shapes give, and at
                # the wide share of large masked calls
                for mask_np, wide in ((None, 0), (keep, 0), (keep, 1)):
                    mask = None if mask_np is None else \
                        torch.from_numpy(mask_np).cuda()
                    arg = torch.from_numpy(rhs).cuda()
                    ck.CSR_MASKED_MIN_BLOCKS = 0 if wide else min_blocks
                    try:
                        got = ck.csr_margins(
                            X, arg[:, 0] if T == 1 else arg, mask)
                    finally:
                        ck.CSR_MASKED_MIN_BLOCKS = min_blocks
                    # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                    got = got.reshape(rows, T).cpu().numpy()
                    share = (ck.CSR_MASKED_BLOCK_ITEMS if wide
                             else ck.CSR_BLOCK_ITEMS)
                    walk = ck.csr_walk(crow, col, val, rhs, mask_np, share)
                    # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                    ref = ck.csr_matmul_plain(X, arg, mask).cpu().numpy()
                    # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                    err = float(np.abs(got - ref).max()) if got.size else 0.0
                    scale = float(np.abs(ref).max()) if got.size else 0.0
                    what = (f"csr kernel {shape} {idt} T={T} "
                            f"mask={mask_np is not None} share={share}")
                    check(np.array_equal(got, walk), f"{what}: not its walk")
                    check(err <= 1e-4 * scale + 1e-6, f"{what}: {err}")
                    worst["csr_margins"] = max(worst.get("csr_margins", 0.0),
                                               err)
                    cases += 1
    none = torch.sparse_csr_tensor(torch.zeros(1, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.int32),
                                   torch.zeros(0), size=(0, 5)).cuda()
    check(ck.csr_margins(none, torch.ones(5, device="cuda")).shape == (0,),
          "csr kernel on a matrix without rows")
    return cases + 1


def window_route_cases(torch, ck, grads, gen, worst):
    """Windows routed by shape: d in {24, 1000, 2048, 4096} and 7,216 bf16
    to ``window_sums.cu`` (1, 2, 4 and 8 column chunks a thread), 7,216 f32
    and 47,237 to ``fused_sums.cu`` (the launches counted by source), at
    the stage-boundary lengths, fewer rows than the grid and 65,536 rows,
    random / negative / past-the-end starts, with and without ``valid``;
    each call repeated and held bitwise equal."""
    cases = 0
    both = (torch.float32, torch.bfloat16)
    # width -> the element types whose windows go to window_sums.cu
    routes = {24: both, 1000: both, 2048: both, 4096: both,
              7216: (torch.bfloat16,), 47237: ()}
    for d, new_dtypes in routes.items():
        wide = d == 47237
        n = 3_000 if wide else CHUNK_ROWS + 1_000
        for dtype in both:
            X = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda") / math.sqrt(d)
            y_ls = torch.randn(n, generator=gen, device="cuda")
            y_01 = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
            valid = torch.rand(n, generator=gen, device="cuda") < 0.5
            plan = ck.window_plan_for(X)
            check((plan is not None) == (dtype in new_dtypes),
                  f"route of d={d} {dtype}: plan {plan}")
            R = plan.stage_rows if plan else 16
            lengths = [1, R - 1, R, R + 1, 100, 2_048 if wide else CHUNK_ROWS]
            ck.reset_launch_counts()
            calls = 0
            bf16 = dtype == torch.bfloat16
            for name, g in grads.items():
                y = y_ls if name == "least_squares" else y_01
                for i, m in enumerate(lengths):
                    kernel = (ck.fused_window_sums_vpu if i % 2
                              else ck.fused_window_sums)
                    s_rand = int(torch.randint(0, n - m + 1, (1,),
                                               generator=gen, device="cuda"))
                    for s0 in (s_rand, -(n // 3), n + 123):
                        for v in (None, valid):
                            s = torch.tensor([s0], device="cuda")
                            got = kernel(g.pointwise, X, y, w, s, m, tile_m=1,
                                         valid=v)
                            again = kernel(g.pointwise, X, y, w, s, m,
                                           tile_m=1, valid=v)
                            calls += 2
                            ref = ck.fused_window_sums_plain(
                                g.pointwise, X, y, w, s0, m, 1, v)
                            ok, err, scale = _close(torch, got, ref, bf16)
                            what = (f"{kernel.__name__} {name} {dtype} d={d} "
                                    f"m={m} start={s0} "
                                    f"valid={v is not None}")
                            check(ok, f"{what}: max|dg|={err} of {scale}")
                            check(all(torch.equal(a, b)
                                      for a, b in zip(got, again)),
                                  f"{what}: a second call differs")
                            key = "window_sums" if plan else "fused_sums"
                            worst[f"window_route_{key}"] = max(
                                worst.get(f"window_route_{key}", 0.0), err)
                            cases += 1
            counts = ck.kernel_launch_counts()
            expect = ({"fused_sums": 0, "window_sums": calls} if plan
                      else {"fused_sums": calls, "window_sums": 0})
            check(counts == expect,
                  f"d={d} {dtype}: launches by source {counts} != {expect}")
            del X
    return cases


#: B1's widths by element type: the ring's (gather and window entries of
#: window_sums.cu), or fused_sums.cu's (7,216 f32: no ring fits)
GATHER_ROUTES = ((24, ("float32", "bfloat16")), (1000, ("float32", "bfloat16")),
                 (2048, ("float32", "bfloat16")),
                 (4096, ("float32", "bfloat16")),
                 (7216, ("bfloat16", "float32")))
GATHER_ROWS = 20_011


def _gather_masks(torch, gen, n, blocks):
    """Masks of every density the gather entry treats apart: none live,
    one row, 0.1%, 10%, 30%, all, live rows only at the blocks' share
    boundaries, and a prefix (the CostFun tail's shape)."""
    u = torch.rand(n, generator=gen, device="cuda")
    zeros = lambda: torch.zeros(n, dtype=torch.bool, device="cuda")  # noqa
    one, edges, prefix = zeros(), zeros(), zeros()
    one[n // 3] = True
    for b in range(1, blocks):
        e = n * b // blocks
        edges[e - 1] = edges[e] = True
    prefix[:n // 8] = True
    return {"zero": zeros(), "one_row": one, "p0.001": u < 0.001,
            "p0.1": u < 0.1, "p0.3": u < 0.3,
            "all": torch.ones(n, dtype=torch.bool, device="cuda"),
            "share_edges": edges, "prefix": prefix}


def gather_route_cases(torch, ck, grads, gen, worst):
    """B1 by shape: at d in {24, 1000, 2048, 4096, 7216} in f32 and bf16,
    the three families, unmasked and under every mask of
    ``_gather_masks``: the kernel against the plain version (``_close``),
    a second call bitwise equal, an all-true mask bitwise the unmasked
    call, a mask with no live row a zero gradient, loss and count, and the
    route asserted through the launch counts by source (the ring's widths
    to window_sums.cu, 7,216 f32 and a base one element off alignment to
    fused_sums.cu)."""
    cases = 0
    n = GATHER_ROWS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d, dtypes in GATHER_ROUTES:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            X = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda") / math.sqrt(d)
            y_ls = torch.randn(n, generator=gen, device="cuda")
            y_01 = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
            plan = ck.window_plan_for(X)
            ring = plan is not None
            check(ring == ((d, dt) != (7216, "float32")),
                  f"B1 route of d={d} {dt}: plan {plan}")
            # the ring's blocks (its mirror), for masks live at their
            # shares' edges
            blocks = ck.ring_grid(n, plan, sms) if ring else 64
            masks = _gather_masks(torch, gen, n, blocks)
            bf16 = dtype == torch.bfloat16
            ck.reset_launch_counts()
            calls = 0
            for name, g in grads.items():
                y = y_ls if name == "least_squares" else y_01
                unmasked = ck.fused_gradient_sums(g.pointwise, X, y, w)
                calls += 1
                ok, err, scale = _close(torch, unmasked,
                                        ck.fused_gradient_sums_plain(
                                            g.pointwise, X, y, w), bf16)
                check(ok, f"B1 {name} {dt} d={d} unmasked: {err} of {scale}")
                for mname, m in masks.items():
                    got = ck.fused_gradient_sums(g.pointwise, X, y, w, m)
                    again = ck.fused_gradient_sums(g.pointwise, X, y, w, m)
                    calls += 2
                    ref = ck.fused_gradient_sums_plain(g.pointwise, X, y, w, m)
                    ok, err, scale = _close(torch, got, ref, bf16)
                    what = f"B1 {name} {dt} d={d} mask {mname}"
                    check(ok, f"{what}: max|dg|={err} of {scale}, count "
                          # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                          f"{float(got[2])} vs {float(ref[2])}")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{what}: a second call differs")
                    if mname == "all":
                        check(all(torch.equal(a, b)
                                  for a, b in zip(got, unmasked)),
                              f"{what}: not bitwise the unmasked call")
                    if mname == "zero":
                        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                        check(float(got[2]) == 0.0 and float(got[1]) == 0.0
                              # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                              and not bool(got[0].any()),
                              f"{what}: {got[1]}, {got[2]}")
                    key = "b1_ring" if ring else "b1_fused_sums"
                    worst[key] = max(worst.get(key, 0.0), err)
                    cases += 1
            counts = ck.kernel_launch_counts()
            expect = ({"fused_sums": 0, "window_sums": calls} if ring
                      else {"fused_sums": calls, "window_sums": 0})
            check(counts == expect,
                  f"B1 d={d} {dt}: launches by source {counts} != {expect}")
            del X
    # a base one element past alignment: fused_sums.cu, masked or not
    X = torch.randn(3 * 1000 + 1, generator=gen, device="cuda").to(
        torch.bfloat16)[1:].view(3, 1000)
    y = torch.randn(3, generator=gen, device="cuda")
    w = torch.randn(1000, generator=gen, device="cuda")
    m = torch.tensor([True, False, True], device="cuda")
    ck.reset_launch_counts()
    for mask in (None, m):
        g = grads["least_squares"]
        ok, err, _ = _close(torch, ck.fused_gradient_sums(g.pointwise, X, y,
                                                          w, mask),
                            ck.fused_gradient_sums_plain(g.pointwise, X, y,
                                                         w, mask), True)
        check(ok, f"B1 on a misaligned base, mask={mask is not None}: {err}")
        cases += 1
    check(ck.kernel_launch_counts() == {"fused_sums": 2, "window_sums": 0},
          f"misaligned base: launches {ck.kernel_launch_counts()}")
    return cases


# -- phase 4 -----------------------------------------------------------------

def make_full_data(torch, n, d, seed=4, chunk=1_000_000):
    """bf16 X (n, d) and f32 y = X w + 0.1 eps, made on the card in
    chunks from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w_true = torch.rand(d, generator=gen, device="cuda") * 2 - 1
    X = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((n,), dtype=torch.float32, device="cuda")
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        Xc = torch.randn(e - s, d, generator=gen, device="cuda")
        X[s:e] = Xc.to(torch.bfloat16)
        y[s:e] = X[s:e].float() @ w_true + 0.1 * torch.randn(
            e - s, generator=gen, device="cuda")
        del Xc
    torch.cuda.synchronize()
    return X, y, w_true


class CountRecorder:
    """Delegates to a Gradient and keeps each call's count (a device
    tensor: recording never syncs)."""

    def __init__(self, inner):
        self.inner = inner
        self.family = inner.family
        self.counts = []

    def pointwise(self, margin, label):
        return self.inner.pointwise(margin, label)

    def weight_dim(self, num_features):
        return self.inner.weight_dim(num_features)

    def batch_sums(self, *args, **kw):
        out = self.inner.batch_sums(*args, **kw)
        self.counts.append(out[2])
        return out

    def window_sums(self, *args, **kw):
        out = self.inner.window_sums(*args, **kw)
        self.counts.append(out[2])
        return out


def phase_full(torch, tst, ck):
    t0 = time.perf_counter()
    X, y, w_true = make_full_data(torch, FULL_ROWS, FULL_D)
    gen_s = time.perf_counter() - t0
    n = FULL_ROWS
    m = round(FRAC * n)
    runs = {}
    ck.reset_launch_counts()
    for mode in ("bernoulli", "sliced", "sliced_vpu"):
        alg = tst.LinearRegressionWithSGD(0.5, ITERS, None, FRAC)
        alg.set_schedule("off")  # a named route: no planner
        alg.optimizer.set_convergence_tol(0.0)
        inner = tst.LeastSquaresGradient()
        if mode == "sliced_vpu":
            inner = tst.FusedGradient(inner, tile_m=WINDOW_TILE,
                                      window_kernel="vpu")
        rec = CountRecorder(inner)
        alg.optimizer.set_gradient(rec)
        alg.optimizer.set_sampling("bernoulli" if mode == "bernoulli"
                                   else "sliced")
        before = ck.launch_counts()
        before_src = ck.kernel_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model = alg.run((X, y))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ck.launch_counts()
        after_src = ck.kernel_launch_counts()
        losses = alg.optimizer.loss_history
        counts = torch.stack(rec.counts).cpu().numpy()
        w_err = float(torch.linalg.vector_norm(model.weights - w_true))
        runs[mode] = {
            "first_run_ms_per_iteration": 1e3 * secs / ITERS,
            "launches": {k: after[k] - before[k] for k in after},
            "launches_by_source": {k: after_src[k] - before_src[k]
                                   for k in after_src},
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "w_err": w_err,
            "count_min": float(counts.min()),
            "count_max": float(counts.max()),
        }
        if mode == "sliced":
            sliced_ref = (np.asarray(losses), model.weights)
        check(len(losses) == ITERS, f"{mode}: {len(losses)} losses")
        check(bool(np.all(np.isfinite(losses))), f"{mode}: non-finite loss")
        check(losses[-1] < losses[0], f"{mode}: loss did not fall")
        if mode == "bernoulli":
            sigma = math.sqrt(n * FRAC * (1 - FRAC))
            check(bool(np.all(np.abs(counts - FRAC * n) <= 5 * sigma)),
                  f"bernoulli counts {counts.min()}..{counts.max()}")
        else:
            check(bool(np.all(counts == m)), f"{mode} counts {counts}")
        # B1's Bernoulli batch through window_sums.cu's gather entry, each
        # sliced window through its window entry
        check(runs[mode]["launches_by_source"]
              == {"fused_sums": 0, "window_sums": ITERS},
              f"{mode}: launches by source {runs[mode]['launches_by_source']}")
    counts = ck.launch_counts()
    expect = {"fused_gradient_sums": ITERS, "fused_window_sums": ITERS,
              "fused_window_sums_vpu": ITERS}
    check(counts == expect, f"main-path launches {counts} != {expect}")
    by_source = ck.kernel_launch_counts()
    check(by_source == {"fused_sums": 0, "window_sums": 3 * ITERS},
          f"main-path launches by source {by_source}")
    emit({"phase": "full", "rows": n, "d": FULL_D, "dtype": "bfloat16",
          "mini_batch_fraction": FRAC, "iterations": ITERS,
          "data_seconds": gen_s, "launches": counts,
          "launches_by_source": by_source, "runs": runs})
    return X, y, w_true, counts, sliced_ref


def device_ms_by_kernel(torch, prof) -> dict:
    """Device ms by kernel name from a ``torch.profiler`` run: device-side
    events only, since an aten op's own self device time repeats that of
    the kernels it launched."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            # kernels whose names share their first 60 characters (the
            # many at::native elementwise instantiations) add up
            key = ev.key[:60]
            out[key] = out.get(key, 0.0) + dev_us / 1e3
    return out


def phase_profile(torch, tst, ck, X, y, iters=20):
    """Where a warm training iteration's time goes, per sampling mode: the
    host's wall clock over ``iters`` iterations without tracing (its
    launches counted by wrapper and by source: one a replayed iteration,
    all in ``window_sums.cu``), then ``torch.profiler`` device time by
    kernel name over the same run traced.  Idle share = 1 - device time /
    untraced wall time; the traced run's extra wall time is the tracing
    overhead."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in ("bernoulli", "sliced"):
        alg = tst.LinearRegressionWithSGD(0.5, iters, None, FRAC)
        alg.set_schedule("off")  # a named route: no planner
        alg.optimizer.set_convergence_tol(0.0).set_sampling(mode)
        for _ in range(2):  # warm: allocator, generator and the capture
            alg.run((X, y))  # (a repeated run captures its block)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t = time.perf_counter()
        model = alg.run((X, y))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t) / iters
        wrapper = ("fused_gradient_sums" if mode == "bernoulli"
                   else "fused_window_sums")
        launches = {"wrappers": ck.launch_counts(),
                    "sources": ck.kernel_launch_counts()}
        check(launches["wrappers"][wrapper] == iters
              and sum(launches["wrappers"].values()) == iters
              and launches["sources"] == {"fused_sums": 0,
                                          "window_sums": iters},
              f"profile {mode}: launches {launches}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            alg.run((X, y))
            torch.cuda.synchronize()
            traced = 1e3 * (time.perf_counter() - t) / iters
        kernels = {k: v / iters
                   for k, v in device_ms_by_kernel(torch, prof).items()}
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        out[mode] = {"wall_ms_per_iteration": wall, "launches": launches,
                     # the weights after ``iters`` iterations, for phase
                     # replica (b)'s matched objective
                     "objective": ls_objective_exact(torch, X, y,
                                                     model.weights),
                     "traced_wall_ms_per_iteration": traced,
                     "device_ms_per_iteration": busy,
                     "idle_share": max(0.0, 1 - busy / wall),
                     "top_device_ms": dict(top)}
    emit({"phase": "profile", "iterations": iters, **out})
    return out


def _bound_ms(sel_rows, d, itemsize, extra_bytes):
    bytes_ = sel_rows * (d * itemsize + 4) + extra_bytes + 8 * d + 8
    flops = 4.0 * sel_rows * d
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_row(torch, ck, kernel, pw, X, y, w, s0, rows, path):
    """A window kernel's row at ``rows`` rows from ``s0``: max |dg| against
    the plain version; the kernel (``window_sums.cu``) and the old window
    path (``fused_sums.cu``'s, called directly) timed in turns (old, new,
    new, old), each as graph-replayed device time and as host-paced
    back-to-back calls; the plain version, two library matmuls of the same
    work, and the bound."""
    n, d = X.shape
    start = torch.tensor([s0], device="cuda")
    check(ck.window_plan_for(X) is not None,
          f"the window of d={d} does not route to window_sums.cu")

    def new():
        return kernel(pw, X, y, w, start, rows, tile_m=1)

    def old():
        return ck._launch(pw, X, y, w, None, start, 1, rows)

    ref = ck.fused_window_sums_plain(pw, X, y, w, s0, rows, 1)
    ok, err, scale = _close(torch, new(), ref, True)
    check(ok, f"{kernel.__name__} at {rows} rows: max|dg|={err} of {scale}")
    ok, old_err, _ = _close(torch, old(), ref, True)
    check(ok, f"old window path at {rows} rows: max|dg|={old_err}")
    reps = 50 if rows <= CHUNK_ROWS else 20
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = old if which == "old" else new
        turns[which].append({"device_ms": graph_ms(torch, fn),
                             "host_paced_ms": time_ms(torch, fn, reps)})

    def mean(which, key):
        return sum(t[key] for t in turns[which]) / len(turns[which])

    Xw = X[s0:s0 + rows]
    wb = w.to(torch.bfloat16)
    coeff = torch.randn(rows, device="cuda").to(torch.bfloat16)
    bound, by = _bound_ms(rows, d, 2, 0)
    return {
        "name": kernel.__name__, "path": path, "source": WINDOW_SOURCE,
        "shape": [rows, d], "selected_rows": rows,
        "max_abs_err": err, "old_path_max_abs_err": old_err,
        "grad_scale": scale,
        "ms": mean("new", "device_ms"),
        "host_paced_ms": mean("new", "host_paced_ms"),
        "old_path_ms": mean("old", "device_ms"),
        "old_path_host_paced_ms": mean("old", "host_paced_ms"),
        "turns": turns,
        "plain_ms": time_ms(torch, lambda: ck.fused_window_sums_plain(
            pw, X, y, w, s0, rows, 1), 3),
        "library_ms": time_ms(torch, lambda: (Xw @ wb, coeff @ Xw), reps),
        "bound_ms": bound, "bound_by": by}


def b1_row(torch, ck, pw, X, y, w, mask, path, reps):
    """B1 at one shape of the main path: max |dg| against the plain version;
    the new route (``gradient_sums_route``: the gather or window entry of
    ``window_sums.cu``) and the old one (``fused_sums.cu``, called
    directly) timed in turns (old, new, new, old), each as graph-replayed
    device time and as host-paced back-to-back calls; the plain version;
    the library yardstick (two matmuls over the rows the call sums: for a
    mask, after an ``index_select`` of the live rows, which the time
    includes, the indices found beforehand; the old yardstick over all
    rows beside it); the bound (the mask's bytes included)."""
    n, d = X.shape
    route = ck.gradient_sums_route(X, mask is not None)
    check(route != "fused_sums", f"B1 at {path} does not take the ring")

    def new():
        return ck.fused_gradient_sums(pw, X, y, w, mask)

    def old():
        return ck._launch(pw, X, y, w, mask, None, 1, n)

    ref = ck.fused_gradient_sums_plain(pw, X, y, w, mask)
    bf16 = X.dtype == torch.bfloat16
    ok, err, scale = _close(torch, new(), ref, bf16)
    check(ok, f"B1 at {path}: max|dg|={err} of {scale}")
    ok, old_err, _ = _close(torch, old(), ref, bf16)
    check(ok, f"B1's old route at {path}: max|dg|={old_err}")
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = old if which == "old" else new
        turns[which].append({"device_ms": graph_ms(torch, fn),
                             "host_paced_ms": time_ms(torch, fn, reps)})

    def mean(which, key):
        return sum(t[key] for t in turns[which]) / len(turns[which])

    wb = w.to(X.dtype)
    sel = n if mask is None else int(mask.sum())
    coeff = torch.randn(sel, device="cuda").to(X.dtype)
    row = {"name": "fused_gradient_sums", "path": path,
           "source": WINDOW_SOURCE, "route": route, "shape": [n, d],
           "selected_rows": sel, "max_abs_err": err,
           "old_path_max_abs_err": old_err, "grad_scale": scale,
           "ms": mean("new", "device_ms"),
           "host_paced_ms": mean("new", "host_paced_ms"),
           "old_path_ms": mean("old", "device_ms"),
           "old_path_host_paced_ms": mean("old", "host_paced_ms"),
           "turns": turns,
           "plain_ms": time_ms(torch, lambda: ck.fused_gradient_sums_plain(
               pw, X, y, w, mask), 2)}
    if mask is None:
        row["library_ms"] = time_ms(torch, lambda: (X @ wb, coeff @ X), reps)
    else:
        idx = torch.nonzero(mask).squeeze(1)

        def library():
            Xs = X.index_select(0, idx)
            return Xs @ wb, coeff @ Xs

        row["library_ms"] = time_ms(torch, library, reps)
        row["library_includes"] = ("index_select of the live rows, then "
                                   "two matmuls over them")
        coeff_all = torch.randn(n, device="cuda").to(X.dtype)
        row["library_all_rows_ms"] = time_ms(
            torch, lambda: (X @ wb, coeff_all @ X), max(2, reps // 4))
    bound, by = _bound_ms(sel, d, X.element_size(),
                          0 if mask is None else n)
    row.update(bound_ms=bound, bound_by=by, share_of_bound=bound / row["ms"])
    return row


def phase_timing(torch, tst, ck, X, y, launches):
    """Each kernel at the main path's shapes: B1 (``b1_row``: new route
    and old in turns) and B2/B3 (``window_row``), each with the plain
    version's time, one PyTorch call of the same work (a yardstick only)
    and the bound; max |dg| against the plain version."""
    n, d = X.shape
    g = tst.LeastSquaresGradient()
    pw = g.pointwise
    w = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") / math.sqrt(d)
    mask = torch.rand(n, generator=torch.Generator(device="cuda")
                      .manual_seed(6), device="cuda") < FRAC
    rows = [b1_row(torch, ck, pw, X, y, w, mask, "sgd", 10)]
    m = round(FRAC * n)
    for kernel in (ck.fused_window_sums, ck.fused_window_sums_vpu):
        rows.append(window_row(torch, ck, kernel, pw, X, y, w,
                               1234 * WINDOW_TILE, m, "sgd"))
    for r in rows:
        r["launches"] = launches[r["name"]]
    emit({"phase": "timing", "kernels": rows})
    return rows


# -- phase 5 -----------------------------------------------------------------

def _logistic_l2_oracle(X, y, reg):
    """Newton's method in f64 on mean log-loss + 0.5 reg |w|^2."""
    X = X.astype(np.float64)
    w = np.zeros(X.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-(X @ w)))
        g = X.T @ (p - y) / len(y) + reg * w
        H = (X.T * (p * (1 - p))) @ X / len(y) + reg * np.eye(X.shape[1])
        step = np.linalg.solve(H, g)
        w -= step
        if np.max(np.abs(step)) < 1e-12:
            break
    return w


def _logistic_objective(X, y, w, reg):
    m = X.astype(np.float64) @ w
    return float(np.mean(np.logaddexp(0.0, -m) + (1 - y) * m)
                 + 0.5 * reg * np.dot(w, w))


def _hinge_l1_oracle(X, y, reg):
    """Exact hinge + L1 minimizer as a linear program (HiGHS)."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, hstack, identity

    n, d = X.shape
    A = -((2 * y.astype(np.float64) - 1)[:, None] * X.astype(np.float64))
    A_ub = hstack([csr_matrix(A), csr_matrix(-A),
                   -identity(n, format="csr")]).tocsr()
    c = np.concatenate([np.full(2 * d, reg), np.full(n, 1.0 / n)])
    res = linprog(c, A_ub=A_ub, b_ub=-np.ones(n), bounds=(0, None),
                  method="highs")
    check(res.status == 0, f"hinge LP oracle: {res.message}")
    return res.x[:d] - res.x[d:2 * d]


def _hinge_objective(X, y, w, reg):
    m = X.astype(np.float64) @ w
    return float(np.mean(np.maximum(0.0, 1 - (2 * y - 1) * m))
                 + reg * np.abs(w).sum())


def _scipy_csr(X):
    from scipy.sparse import csr_matrix

    X = X.cpu()
    return csr_matrix((X.values().double().numpy(),
                       X.col_indices().numpy(), X.crow_indices().numpy()),
                      shape=tuple(X.shape))


def _hinge_l1_oracle_sparse(Xs, y, reg):
    """The exact hinge + L1 minimizer of scipy CSR ``Xs`` as a linear
    program (HiGHS interior point)."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, hstack, identity

    n, d = Xs.shape
    A = csr_matrix(Xs.multiply(-(2 * y.astype(np.float64) - 1)[:, None]))
    A_ub = hstack([A, -A, -identity(n, format="csr")]).tocsr()
    c = np.concatenate([np.full(2 * d, reg), np.full(n, 1.0 / n)])
    res = linprog(c, A_ub=A_ub, b_ub=-np.ones(n), bounds=(0, None),
                  method="highs-ipm")
    check(res.status == 0, f"sparse hinge LP oracle: {res.message}")
    return res.x[:d] - res.x[d:2 * d]


def _hinge_objective_sparse(Xs, y, w, reg):
    m = Xs @ np.asarray(w, np.float64)
    return float(np.mean(np.maximum(0.0, 1 - (2 * y - 1) * m))
                 + reg * np.abs(w).sum())


def config3_sparse(torch, tst, rows):
    """Config 3 undensified: its RCV1 stand-in (d = 2000) through
    save_as_libsvm_file -> load_libsvm_file(dense=False), trained on the
    sparse path, held to the LP oracle and to the dense path on the same
    data densified (frac 1.0: neither run samples)."""
    from tpu_sgd_torch.ops.sparse import csr_from_triple
    from tpu_sgd_torch.utils import mlutils
    from tpu_sgd_torch.utils.mlutils import (load_libsvm_file,
                                             rcv1_like_data,
                                             save_as_libsvm_file)

    d, reg = 2000, 1e-4
    X0, y0, _ = rcv1_like_data(rows, d=d, nnz_per_row=75, seed=2)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rcv1_standin.libsvm")
        save_as_libsvm_file(path, X0, y0)
        csr, y, d_read = load_libsvm_file(path, num_features=d, dense=False)
    io_s = time.perf_counter() - t
    check(mlutils.last_reader == "native",
          f"config 3: the LIBSVM file was read by the {mlutils.last_reader} "
          "parser, not the native one")
    X = csr_from_triple(csr, d_read)
    check(np.array_equal(y, y0)
          and torch.equal(X.col_indices(), X0.col_indices())
          and torch.equal(X.values(), X0.values()),
          "config 3: the LIBSVM round trip changed the data")
    models = {}
    for kind, data in (("sparse", X), ("dense", X.to_dense().numpy())):
        alg = tst.SVMWithSGD(300.0, 3000, reg, 1.0)
        alg.optimizer.set_updater(tst.L1Updater()).set_convergence_tol(0.0)
        t = time.perf_counter()
        models[kind] = alg.run((data, y))
        torch.cuda.synchronize()
        models[kind + "_s"] = time.perf_counter() - t
    Xs = _scipy_csr(X)
    t = time.perf_counter()
    w_star = _hinge_l1_oracle_sparse(Xs, y, reg)
    lp_s = time.perf_counter() - t
    w = models["sparse"].weights.double().cpu().numpy()
    w_dense = models["dense"].weights.double().cpu().numpy()
    L = _hinge_objective_sparse(Xs, y, w, reg)
    L_dense = _hinge_objective_sparse(Xs, y, w_dense, reg)
    L_star = _hinge_objective_sparse(Xs, y, w_star, reg)
    acc = float(np.mean(models["sparse"].predict(X).cpu().numpy() == y))
    acc_star = float(np.mean((Xs @ w_star > 0) == (y > 0)))
    out = {"rows": rows, "d": d, "nnz": int(X._nnz()),
           "weights_device": str(models["sparse"].weights.device),
           "objective": L, "dense_objective": L_dense, "oracle": L_star,
           "gap": (L - L_star) / L_star, "vs_dense": L / L_dense,
           "accuracy": acc, "oracle_accuracy": acc_star,
           "libsvm_roundtrip_s": io_s, "libsvm_reader": mlutils.last_reader,
           "lp_s": lp_s,
           "train_s": models["sparse_s"], "dense_train_s": models["dense_s"]}
    check(out["weights_device"].startswith("cuda")
          and out["gap"] < 0.20 and acc > acc_star - 0.01
          and out["vs_dense"] <= 1.01, f"config 3 sparse: {out}")
    return out


def config5(torch, tst):
    """Streaming SGD (config 5): ten micro-batches of 2000 x 50 through
    StreamingLinearRegressionWithSGD on the card; the weight error to the
    truth must fall from the first batch to the last, and end under 0.05."""
    d = 50
    w_true = np.linspace(-1, 1, d).astype(np.float32)
    alg = tst.StreamingLinearRegressionWithSGD(step_size=0.3,
                                               num_iterations=25)
    alg.set_initial_weights(np.zeros(d, np.float32))
    errs = []
    for i in range(10):
        Xb, yb, _ = tst.linear_data(2_000, d, weights=w_true, eps=0.05,
                                    seed=10 + i)
        alg.train_on_batch(Xb, yb)
        w = alg.latest_model().weights
        check(w.is_cuda, f"config 5: weights on {w.device}")
        errs.append(float(np.linalg.norm(w.cpu().numpy() - w_true)))
    out = {"w_err": errs, "batches": alg._batch_count}
    check(errs[-1] < errs[0] and errs[-1] < 0.05, f"config 5: {out}")
    return out


def phase_configs(torch, tst):
    """Configs 1-3 and 5; returns phase plan's (f): config 1's host data
    through ``NormalEquations``' AUTO placement."""
    out = {}
    # config 1: least squares, 100k x 100, within 1% of the exact optimum,
    # zero-flag as users call it (its plan line printed)
    X, y, _ = tst.linear_data(100_000, 100, eps=0.1, seed=0)
    with plan_log() as lines:
        model = tst.LinearRegressionWithSGD.train((X, y), 100, 1.0)
    plan_line = lines[0] if lines else None
    check(plan_line is not None and plan_line.startswith("plan: "),
          f"config 1: no plan line ({lines})")
    w = model.weights.double().cpu().numpy()
    w_star = np.linalg.lstsq(X.astype(np.float64), y.astype(np.float64),
                             rcond=None)[0]
    L = 0.5 * float(np.mean((X @ w - y) ** 2))
    L_star = 0.5 * float(np.mean((X @ w_star - y) ** 2))
    # phase plan (f): the host data fits, so AUTO places it resident and
    # logs nothing
    with plan_log() as lines:
        ne = tst.LinearRegressionWithNormal()
        w_ne = ne.run((X, y)).weights
    check(w_ne.is_cuda, f"config 1 normal: weights on {w_ne.device}")
    check(ne.optimizer.host_streaming is None and not lines,
          f"plan (f): NormalEquations placement logged {lines}")
    placement = {"placed": "resident", "host_streaming": None,
                 "log_lines": lines, "data_bytes": X.nbytes + y.nbytes}
    L_ne = 0.5 * float(np.mean((X @ w_ne.double().cpu().numpy() - y) ** 2))
    # ... and from sufficient statistics, sliced windows at frac 0.5
    gs = tst.LinearRegressionWithSGD(1.0, 100, None, CONFIG1_GRAM_FRAC)
    gs.optimizer.set_sampling("sliced").set_sufficient_stats(True)
    gs.set_schedule("off")
    w_gs = gs.run((X, y)).weights
    check(w_gs.is_cuda, f"config 1 statistics: weights on {w_gs.device}")
    L_gs = 0.5 * float(np.mean((X @ w_gs.double().cpu().numpy() - y) ** 2))
    out["config1"] = {"plan_line": plan_line,
                      "objective": L, "oracle": L_star,
                      "gap": (L - L_star) / L_star,
                      "normal_objective": L_ne,
                      "normal_gap": (L_ne - L_star) / L_star,
                      "gram_sliced_objective": L_gs,
                      "gram_sliced_gap": (L_gs - L_star) / L_star}
    check(out["config1"]["gap"] < 0.01
          and out["config1"]["normal_gap"] < 1e-4
          and out["config1"]["gram_sliced_gap"] < 0.01,
          f"config 1: {out['config1']}")

    # config 2: logistic + L2 on the a9a stand-in, within 1% of the optimum
    X, y, _ = tst.a9a_like_data(20_000, seed=1)
    reg = 0.01
    alg = tst.LogisticRegressionWithSGD(2.0, 500, reg, 1.0)
    alg.optimizer.set_convergence_tol(0.0)
    model = alg.run((X, y))
    w = model.weights.double().cpu().numpy()
    L = _logistic_objective(X, y, w, reg)
    L_star = _logistic_objective(X, y, _logistic_l2_oracle(X, y, reg), reg)
    acc = float(np.mean(model.predict(X).cpu().numpy() == y))
    lb_alg = tst.LogisticRegressionWithLBFGS(reg_param=reg)
    w_lb = lb_alg.run((X, y)).weights.double().cpu().numpy()
    L_lb = _logistic_objective(X, y, w_lb, reg)
    out["config2"] = {"objective": L, "oracle": L_star,
                      "gap": (L - L_star) / L_star, "accuracy": acc,
                      "lbfgs_objective": L_lb,
                      "lbfgs_gap": (L_lb - L_star) / L_star,
                      "lbfgs_iterations":
                          len(lb_alg.optimizer.loss_history) - 1}
    check(out["config2"]["gap"] < 0.01
          and out["config2"]["lbfgs_gap"] < 1e-3,
          f"config 2: {out['config2']}")

    # config 3: hinge + L1 (subgradient descent, O(1/sqrt t)): within 20%
    # of the exact optimum and accuracy within 1 point of it
    X, y, _ = tst.svm_data(10_000, 50, seed=2)
    reg = 0.01
    alg = tst.SVMWithSGD(1.0, 500, reg, 1.0)
    alg.optimizer.set_updater(tst.L1Updater()).set_convergence_tol(0.0)
    model = alg.run((X, y))
    w = model.weights.double().cpu().numpy()
    w_star = _hinge_l1_oracle(X, y, reg)
    L, L_star = _hinge_objective(X, y, w, reg), _hinge_objective(X, y,
                                                                 w_star, reg)
    acc = float(np.mean(model.predict(X).cpu().numpy() == y))
    acc_star = float(np.mean((X @ w_star > 0) == (y > 0)))
    out["config3"] = {"objective": L, "oracle": L_star,
                      "gap": (L - L_star) / L_star, "accuracy": acc,
                      "oracle_accuracy": acc_star}
    check(out["config3"]["gap"] < 0.20 and acc > acc_star - 0.01,
          f"config 3: {out['config3']}")
    out["config3_sparse"] = config3_sparse(torch, tst, CONFIG3_SPARSE_ROWS)
    out["config5"] = config5(torch, tst)
    emit({"phase": "configs", **out})
    return placement


# -- phase 6 -----------------------------------------------------------------

def make_rcv1_data(torch, n, d, k, seed=7, chunk=4096):
    """``rcv1_like_data``'s recipe made on the card from a torch
    Generator (other bits than numpy's): Zipf(0.9) column popularity, k
    distinct columns a row drawn by Gumbel top-k over row chunks, lognormal
    (sigma 0.5) values normalised to unit rows, labels from a sparse w on
    d/100 popular features thresholded at the median margin.  Returns
    ``(X: CSR with int32 indices, y)`` on the card."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    pop = 1.0 / torch.arange(1, d + 1, device=dev, dtype=torch.float64) ** 0.9
    log_pop = torch.log(pop / pop.sum()).float()

    def gumbel_top(rows, count):
        e = torch.empty((rows, d), device=dev).exponential_(generator=gen)
        return torch.topk(log_pop - torch.log(e), count, dim=1,
                          sorted=False).indices

    w = torch.zeros(d, device=dev)
    active = gumbel_top(1, max(8, d // 100))[0]
    w[active] = 1.5 * torch.randn(active.numel(), generator=gen, device=dev)
    cols = torch.empty((n, k), dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        cols[lo:hi] = torch.sort(gumbel_top(hi - lo, k), dim=1).values.to(
            torch.int32)
    vals = torch.empty((n, k), device=dev).log_normal_(0.0, 0.5,
                                                       generator=gen)
    vals /= torch.linalg.vector_norm(vals, dim=1, keepdim=True)
    margins = (vals * w[cols.long()]).sum(dim=1)
    noise = 0.05 * torch.randn(n, generator=gen, device=dev)
    y = ((margins + noise) > torch.median(margins)).float()
    crow = torch.arange(0, (n + 1) * k, k, dtype=torch.int32, device=dev)
    X = torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1),
                                size=(n, d), check_invariants=False)
    torch.cuda.synchronize()
    return X, y


def _sparse_alg(tst, iters, frac):
    alg = tst.SVMWithSGD(100.0, iters, 1e-5, frac)
    alg.optimizer.set_updater(tst.L1Updater()).set_convergence_tol(0.0)
    return alg


def _sparse_iteration_profile(torch, tst, X, Xt, y, frac, iters=20):
    """Where a warm sparse iteration's time goes at ``frac``: ``make_run``
    over ``iters`` iterations with the transposed copy built beforehand,
    so the run's set-up drops out — the wall clock untraced, ending in
    ``synchronize``, then device time by kernel from ``torch.profiler``
    over the same run traced."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_sgd_torch.optimize.gradient_descent import make_run

    cfg = tst.SGDConfig(step_size=100.0, num_iterations=iters,
                        reg_param=1e-5, mini_batch_fraction=frac,
                        convergence_tol=0.0)
    run = make_run(tst.HingeGradient(), tst.L1Updater(), cfg)
    w0 = torch.zeros(X.shape[1], device=X.device)
    for _ in range(2):  # warm: allocator, generator and the capture
        run(w0, X, y, Xt=Xt)  # (a repeated run captures its block)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(w0, X, y, Xt=Xt)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(w0, X, y, Xt=Xt)
        torch.cuda.synchronize()
    per_kernel = {k: v / iters
                  for k, v in device_ms_by_kernel(torch, prof).items()}
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_iteration": wall,
            "device_ms_per_iteration": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "top_device_ms": dict(top)}


def phase_sparse(torch, tst, ck):
    """Config 3 at full RCV1 scale, undensified on the card."""
    from tpu_sgd_torch.ops import sparse as sp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    X, y = make_rcv1_data(torch, RCV1_ROWS, RCV1_D, RCV1_NNZ)
    gen_s = time.perf_counter() - t
    check(X.is_cuda and X.layout == torch.sparse_csr, "RCV1 X not CSR on cuda")
    n, d = X.shape
    nnz = X._nnz()
    runs, weights = {}, {}
    launches = {k: 0 for k in ck.launch_counts()}
    for frac in (1.0, 0.1):
        alg = _sparse_alg(tst, SPARSE_ITERS, frac)
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model = alg.run((X, y))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        csr_launches = ck.csr_launch_counts(by_columns=True)
        for k, v in ck.launch_counts().items():
            launches[k] += v
        losses = alg.optimizer.loss_history
        acc = float((model.predict(X) == y).float().mean())
        weights[frac] = model.weights
        runs[str(frac)] = {
            "first_run_s": secs, "weights_device": str(model.weights.device),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "accuracy": acc, "csr_launches": csr_launches,
            "nonzero_weights": int((model.weights != 0).sum())}
        check(model.weights.is_cuda, f"frac {frac}: weights not on cuda")
        check(len(losses) == SPARSE_ITERS
              and bool(np.all(np.isfinite(losses))),
              f"frac {frac}: loss history {losses}")
        check(losses[-1] < losses[0], f"frac {frac}: loss did not fall")
        check(acc > 0.8, f"frac {frac}: training accuracy {acc}")
    check(all(v == 0 for v in launches.values()),
          f"the sparse path launched dense kernels: {launches}")
    again = _sparse_alg(tst, SPARSE_ITERS, 1.0).run((X, y)).weights
    bitwise = bool(torch.equal(again, weights[1.0]))
    max_diff = float((again - weights[1.0]).abs().max())

    Xt = sp.transpose_csr(X)
    x_bytes, xt_bytes = sp.csr_bytes(X), sp.csr_bytes(Xt)
    transpose_ms = time_ms(torch, lambda: sp.transpose_csr(X), 3)
    for frac in (1.0, 0.1):
        prof = _sparse_iteration_profile(torch, tst, X, Xt, y, frac)
        # the least bytes an iteration must move: the entries of the rows
        # it uses (all rows at frac 1.0, the expected 10% at 0.1) in both
        # copies, their row pointers, y and w read and the gradient written
        used = frac * (x_bytes + xt_bytes) + 4 * n * frac + 8 * d
        flops = 4.0 * frac * nnz
        t_bytes = 1e3 * used / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / F32_FLOPS
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        runs[str(frac)].update(prof)
        runs[str(frac)].update({
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / prof["wall_ms_per_iteration"]})
    peak = torch.cuda.max_memory_allocated()
    check(peak < SPARSE_MEMORY_LIMIT, f"peak device memory {peak} bytes")
    out = {"rows": n, "d": d, "nnz": nnz,
           "index_dtype": str(X.col_indices().dtype),
           "iterations": SPARSE_ITERS, "data_seconds": gen_s,
           "csr_bytes": x_bytes, "transposed_csr_bytes": xt_bytes,
           "transpose_ms": transpose_ms,
           "densified_f32_bytes": 4 * n * d,
           "peak_allocated_bytes": peak, "dense_kernel_launches": launches,
           "bitwise_repeatable": bitwise, "repeat_max_abs_diff": max_diff,
           "runs": runs}
    emit({"phase": "sparse", **out})
    # the CSR kernel adds in a fixed order: two runs give the same bits
    check(bitwise, f"sparse runs differ by up to {max_diff}")
    return out, X, y, weights[1.0]


# -- phase 7 -----------------------------------------------------------------

def _nonincreasing(hist) -> bool:
    h = np.asarray(hist, np.float64)
    return bool(np.all(np.diff(h) <= HISTORY_RTOL * np.abs(h[:-1])))


def _numpy_auc(scores, labels) -> float:
    """Mann-Whitney AUC in f64 with average ranks (a tie counts half)."""
    from scipy.stats import rankdata

    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    ranks = rankdata(scores.astype(np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


_PRODUCT_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def _qn_iteration_profile(torch, tst, X, y, iters=10):
    """Where a warm binary L-BFGS iteration's time goes at 10M x 1000:
    the host's wall clock over ``iters`` iterations untraced (ending in
    ``synchronize``), then ``torch.profiler`` device time by kernel over
    the same run traced, split into the fused kernel (B1, the cost), the
    library products (the sweep's ``X @ Wᵀ``, by kernel name) and the
    rest.  Per iteration: the run's time over its iterations (the run
    also makes the initial cost evaluation)."""
    from torch.profiler import ProfilerActivity, profile

    opt = tst.LBFGS(tst.LogisticGradient(), tst.SquaredL2Updater(),
                    reg_param=1e-4, max_num_iterations=iters,
                    convergence_tol=0.0)
    w0 = torch.zeros(X.shape[1], device="cuda")
    opt.optimize_with_history((X, y), w0)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, hist = opt.optimize_with_history((X, y), w0)
    torch.cuda.synchronize()
    its = len(hist) - 1
    wall = 1e3 * (time.perf_counter() - t) / its
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.optimize_with_history((X, y), w0)
        torch.cuda.synchronize()
    per = {k: v / its for k, v in device_ms_by_kernel(torch, prof).items()}
    busy = sum(per.values())
    b1 = sum(v for k, v in per.items() if k.startswith(B1_KERNELS))
    products = sum(v for k, v in per.items()
                   if any(p in k.lower() for p in _PRODUCT_NAMES))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"iterations": its, "wall_ms_per_iteration": wall,
            "device_ms_per_iteration": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "b1_ms": b1, "products_ms": products,
            "rest_ms": busy - b1 - products, "top_device_ms": dict(top)}


def logistic_labels(torch, X, w_true):
    """Labels of a planted logistic model with margins of std ~2, drawn on
    the card from a seed (legs (a) of phases quasi_newton and
    streamed_qn)."""
    from tpu_sgd_torch.ops.gradients import f32_product

    gen = torch.Generator(device="cuda").manual_seed(11)
    w_plant = w_true * (2.0 / torch.linalg.vector_norm(w_true))
    p = torch.sigmoid(f32_product(X, w_plant))
    return (torch.rand(X.shape[0], generator=gen, device="cuda") < p).float()


def leg_binary_lbfgs(torch, tst, ck, X, w_true):
    """(a) Binary L-BFGS at config 4's shape; returns the leg's record and
    B1's full-batch timing row."""
    from tpu_sgd_torch.optimize.lbfgs import _build_loss_sweep, _reg_terms
    from tpu_sgd_torch.optimize.oracle import full_objective

    n, d = X.shape
    reg = 1e-4
    y = logistic_labels(torch, X, w_true)
    alg = tst.LogisticRegressionWithLBFGS(max_num_iterations=QN_ITERS,
                                          reg_param=reg)
    alg.set_schedule("off")  # a named route: no planner
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t = time.perf_counter()
    model = alg.run((X, y))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ck.launch_counts()
    by_source = ck.kernel_launch_counts()
    hist = alg.optimizer.loss_history
    check(model.weights.is_cuda, "(a): weights not on the card")
    check(by_source == {"fused_sums": 0, "window_sums": len(hist)},
          f"(a): launches by source {by_source}")
    check(_nonincreasing(hist), f"(a): the loss history rose: {hist}")
    check(launches == {"fused_gradient_sums": len(hist),
                       "fused_window_sums": 0, "fused_window_sums_vpu": 0},
          f"(a): launches {launches} for {len(hist)} cost evaluations")
    sgd = tst.LogisticRegressionWithSGD(1.0, QN_ITERS, reg, 1.0)
    sgd.set_schedule("off")  # a named route: no planner
    sgd.optimizer.set_convergence_tol(0.0)
    w_sgd = sgd.run((X, y)).weights
    g = tst.LogisticGradient()
    L_lb = full_objective(g, X, y, model.weights, reg, "l2")
    L_sgd = full_objective(g, X, y, w_sgd, reg, "l2")
    check(L_lb < L_sgd, f"(a): L-BFGS objective {L_lb} >= SGD's {L_sgd}")
    model.clear_threshold()
    scores = model.predict(X)
    t = time.perf_counter()
    auc = tst.BinaryClassificationMetrics(scores, y).area_under_roc
    torch.cuda.synchronize()
    auc_s = time.perf_counter() - t
    auc_np = _numpy_auc(scores.cpu().numpy(), y.cpu().numpy())
    check(abs(auc - auc_np) <= 1e-6, f"(a): AUC {auc} vs numpy {auc_np}")
    prof = _qn_iteration_profile(torch, tst, X, y)
    # the sweep alone at this shape: the 25-trial ladder in one pass
    reg_value = _reg_terms(tst.SquaredL2Updater(), reg)[0]
    sweep = _build_loss_sweep(g, reg_value, X, y)
    ladder = 0.5 ** torch.arange(25, device="cuda", dtype=torch.float32)
    trials = model.weights[None, :] * (1.0 - ladder[:, None])
    sweep_ms = time_ms(torch, lambda: sweep(trials), 3)
    # B1 at the full-batch shape (the window entry over all rows), against
    # the old route in turns, beside its bound, plain version and library
    row = b1_row(torch, ck, g.pointwise, X, y, model.weights, None,
                 "lbfgs_full_batch", 5)
    row["launches"] = launches["fused_gradient_sums"]
    out = {"rows": n, "d": d, "reg_param": reg,
           "cost_evaluations": len(hist), "launches": launches,
           "first_run_s": secs, "loss_first": float(hist[0]),
           "loss_last": float(hist[-1]), "objective": L_lb,
           "sgd_objective": L_sgd, "auc": auc, "numpy_auc": auc_np,
           "auc_s": auc_s, "sweep_ms": sweep_ms, "profile": prof}
    emit({"phase": "quasi_newton", "leg": "a_binary_lbfgs", **out,
          "b1_full_batch": row})
    return out, row


def leg_normal_equations(torch, tst, X, y, w_true):
    """(b) Exact least squares on the 10M x 1000 matrix, labels rounded to
    bf16 (the Gram's Xᵀy rounds y to X's dtype, so these labels reach it
    exactly and the solve is the optimum of the problem it is held to)."""
    from tpu_sgd_torch.optimize import normal
    from tpu_sgd_torch.optimize.oracle import full_objective

    n, d = X.shape
    y_ls = y.to(torch.bfloat16).to(torch.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    w_ne = tst.LinearRegressionWithNormal().run((X, y_ls)).weights
    torch.cuda.synchronize()
    ne_s = time.perf_counter() - t
    lb = tst.LinearRegressionWithLBFGS(max_num_iterations=QN_ITERS)
    lb.set_schedule("off")  # a named route: no planner
    t = time.perf_counter()
    w_lb = lb.run((X, y_ls)).weights
    torch.cuda.synchronize()
    lb_s = time.perf_counter() - t
    g = tst.LeastSquaresGradient()
    L_ne = full_objective(g, X, y_ls, w_ne)
    L_lb = full_objective(g, X, y_ls, w_lb)
    check(L_ne <= L_lb * (1 + 1e-5),
          f"(b): normal objective {L_ne} > L-BFGS's {L_lb} x (1 + 1e-5)")
    rel = float(torch.linalg.vector_norm(w_ne - w_true)
                / torch.linalg.vector_norm(w_true))
    # noise level: with X ~ N(0, I), |w - w_true| ~ sigma sqrt(d / n)
    sigma = math.sqrt(2.0 * L_ne)
    noise = sigma * math.sqrt(d / n) / float(torch.linalg.vector_norm(w_true))
    check(rel <= 2.0 * noise, f"(b): |w - w_true| / |w_true| = {rel} "
          f"above twice the noise level {noise}")
    gram_ms = time_ms(torch, lambda: normal._gram_sums(X, y_ls), 2)
    t_bytes = 1e3 * (n * (d * 2 + 4)) / HBM_BYTES_PER_S
    t_ops = 1e3 * 2.0 * n * d * d / BF16_FLOPS
    bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                 else (t_ops, "operations"))
    out = {"normal_s": ne_s, "objective": L_ne, "lbfgs_objective": L_lb,
           "lbfgs_iterations": len(lb.optimizer.loss_history) - 1,
           "lbfgs_s": lb_s,
           "lbfgs_ms_per_iteration": 1e3 * lb_s / max(
               1, len(lb.optimizer.loss_history) - 1),
           "w_rel_err": rel, "noise_level": noise, "gram_ms": gram_ms,
           "gram_bound_ms": bound, "gram_bound_by": by}
    emit({"phase": "quasi_newton", "leg": "b_normal_equations", **out})
    out["weights"] = w_ne  # for phase streamed_qn (e)
    return out


def make_multiclass_data(torch, n, d, k, seed=12, chunk=1_000_000):
    """bf16 X (n, d) and labels drawn from a planted softmax model (logit
    std ~2.5) by the Gumbel-max trick, made on the card in chunks; returns
    ``(X, y, the planted model's own accuracy)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    W = torch.randn(k, d, generator=gen, device="cuda") * (2.5 / math.sqrt(d))
    X = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((n,), dtype=torch.float32, device="cuda")
    hits = torch.zeros((), dtype=torch.int64, device="cuda")
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        X[s:e] = torch.randn(e - s, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
        logits = X[s:e].float() @ W.T
        gumbel = -torch.log(torch.empty_like(logits).exponential_(
            generator=gen))
        y[s:e] = torch.argmax(logits + gumbel, dim=1).float()
        hits += (torch.argmax(logits, dim=1).float() == y[s:e]).sum()
    torch.cuda.synchronize()
    return X, y, float(hits) / n


def leg_multinomial(torch, tst):
    """(c) Multinomial L-BFGS at MNIST8M's published shape."""
    t = time.perf_counter()
    X, y, planted_acc = make_multiclass_data(torch, MNIST8M_ROWS, MNIST8M_D,
                                             MNIST8M_K)
    gen_s = time.perf_counter() - t
    alg = tst.LogisticRegressionWithLBFGS(max_num_iterations=QN_ITERS)
    alg.set_num_classes(MNIST8M_K).set_schedule("off")
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = alg.run((X, y))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    hist = alg.optimizer.loss_history
    check(isinstance(model, tst.MultinomialLogisticRegressionModel)
          and model.weights.is_cuda, "(c): not a multinomial model on cuda")
    check(_nonincreasing(hist), f"(c): the loss history rose: {hist}")
    acc = tst.MulticlassMetrics(model.predict(X), y,
                                num_classes=MNIST8M_K).accuracy
    check(abs(acc - planted_acc) <= 0.02,
          f"(c): accuracy {acc} vs the planted model's {planted_acc}")
    out = {"rows": MNIST8M_ROWS, "d": MNIST8M_D, "classes": MNIST8M_K,
           "dtype": "bfloat16", "data_seconds": gen_s, "run_s": secs,
           "iterations": len(hist) - 1,
           "ms_per_iteration": 1e3 * secs / max(1, len(hist) - 1),
           "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
           "accuracy": acc, "planted_accuracy": planted_acc}
    emit({"phase": "quasi_newton", "leg": "c_multinomial", **out})
    return out


def _owlqn_logistic_vs_sgd(torch, tst, X, y, reg):
    """(d), the objective check: OWL-QN on L1-regularized logistic
    regression (its own problem) against a full-batch SGD run of the same
    objective with phase ``sparse``'s step and iterations."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    g = tst.LogisticGradient()
    alg = tst.LogisticRegressionWithSGD(100.0, SPARSE_ITERS, reg, 1.0)
    alg.optimizer.set_updater(tst.L1Updater()).set_convergence_tol(0.0)
    L_sgd = full_objective(g, X, y, alg.run((X, y)).weights, reg, "l1")
    opt = tst.OWLQN(g, reg_param=reg, max_num_iterations=OWLQN_ITERS)
    w, hist = opt.optimize_with_history((X, y), torch.zeros(X.shape[1],
                                                            device="cuda"))
    L = full_objective(g, X, y, w, reg, "l1")
    check(_nonincreasing(hist), f"(d) logistic: the loss history rose: "
          f"{hist}")
    check(L <= L_sgd, f"(d): OWL-QN logistic objective {L} above the SGD "
          f"path's {L_sgd}")
    return {"logistic_objective": L, "logistic_sgd_objective": L_sgd,
            "logistic_iterations": len(hist) - 1}


def leg_sparse_owlqn(torch, tst, ck, X, y, w_sgd):
    """(d) Sparse OWL-QN at RCV1 scale: hinge + L1 (its objective beside
    the SGD path's frac-1.0 one, reported: with exact products the hinge
    gradient does not change while every margin stays inside the hinge,
    so the curvature pairs are 0 and OWL-QN takes steepest-descent steps,
    as the JAX package's does), and logistic + L1, held against SGD on
    the same objective."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    class KeepTrials(tst.HingeGradient):
        """The hinge gradient, keeping its last line search's trial
        points (the CSR kernel's many-column case in ``csr_rows``)."""

        def loss_sweep(self, X, y, W, mask=None):
            self.trials = W
            return super().loss_sweep(X, y, W, mask)

    reg = 1e-5
    g = KeepTrials()
    L_sgd = full_objective(g, X, y, w_sgd, reg, "l1")
    opt = tst.OWLQN(g, reg_param=reg, max_num_iterations=OWLQN_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t = time.perf_counter()
    w, hist = opt.optimize_with_history((X, y), torch.zeros_like(w_sgd))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ck.launch_counts()
    csr_launches = ck.csr_launch_counts(by_columns=True)
    peak = torch.cuda.max_memory_allocated()
    L = full_objective(g, X, y, w, reg, "l1")
    check(w.is_cuda, "(d): weights not on cuda")
    check(_nonincreasing(hist), f"(d): the loss history rose: {hist}")
    check(all(v == 0 for v in launches.values()),
          f"(d): the sparse path launched dense kernels: {launches}")
    check(peak < SPARSE_MEMORY_LIMIT, f"(d): peak device memory {peak}")
    check(L < float(hist[0]), f"(d): OWL-QN objective {L} did not fall")
    out = {"rows": X.shape[0], "d": X.shape[1], "reg_param": reg,
           "iterations": len(hist) - 1, "run_s": secs,
           "ms_per_iteration": 1e3 * secs / max(1, len(hist) - 1),
           "objective": L, "sgd_objective": L_sgd,
           "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
           "exact_zeros": int((w == 0).sum()),
           "sgd_exact_zeros": int((w_sgd == 0).sum()),
           "dense_kernel_launches": launches, "csr_launches": csr_launches,
           "peak_allocated_bytes": peak}
    out.update(_owlqn_logistic_vs_sgd(torch, tst, X, y, reg))
    emit({"phase": "quasi_newton", "leg": "d_sparse_owlqn", **out})
    return out | {"trials": g.trials, "weights": w}


# -- phase 8 -----------------------------------------------------------------

def _run_profile(torch, run, iters):
    """A warm run's wall ms per iteration (untraced, ending in
    ``synchronize``), then over the same run traced: device ms per
    iteration by kernel, and the host's operator calls and self ms by
    operator per iteration; idle share = 1 - device / wall.  Two more
    runs go first, so that the timed run never holds a capture (a
    repeated run warms up and captures its block)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per = {k: v / iters for k, v in device_ms_by_kernel(torch, prof).items()}
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    host, calls = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU and (
                ev.key.startswith("aten::") or ev.key.startswith("cuda")):
            host[ev.key] = ev.self_cpu_time_total / 1e3 / iters
            calls += ev.count if ev.key.startswith("aten::") else 0
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms_per_iteration": wall, "device_ms_per_iteration": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "top_device_ms": dict(top),
            "aten_calls_per_iteration": calls / iters,
            "top_host_self_ms": dict(top_host)}


def _sgd_alg(tst, gradient=None, sufficient_stats=False):
    """Phase ``full``'s sliced run (seed, step, fraction, iterations), so
    every run below samples the same windows."""
    alg = tst.LinearRegressionWithSGD(0.5, ITERS, None, FRAC)
    alg.set_schedule("off")  # a named route: no planner
    alg.optimizer.set_convergence_tol(0.0).set_sampling("sliced")
    if gradient is not None:
        alg.optimizer.set_gradient(gradient)
    if sufficient_stats:
        alg.optimizer.set_sufficient_stats(True)
    return alg


def _exact_window_gradient(torch, tst):
    """The exact f32 sums of a sliced window (rows upcast, weights not
    rounded), the reference of the statistics' loss history: the fused
    kernel computes margins with the weights rounded to bf16, the JAX
    package's bf16 contract, which the statistics do not follow."""

    class ExactWindow(tst.LeastSquaresGradient):
        family = None

        def window_sums(self, X, y, weights, start, m, valid=None,
                        margin_axis_name=None):
            s = min(max(int(start), 0), X.shape[0] - m)  # a reference
            Xw = X[s:s + m].float()
            r = Xw @ weights - y[s:s + m]
            return (r @ Xw, 0.5 * torch.dot(r, r),
                    torch.full((), float(m), device=X.device))

    return ExactWindow()


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def gram_build(torch, tst, X, y):
    """(a) The statistics of the 10M x 1000 matrix: time, stack and peak
    bytes against the bound."""
    n, d = X.shape
    B = GRAM_BLOCK
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gram = tst.GramLeastSquaresGradient.build(X, y, block_rows=B)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    PG = gram.data.PG
    stack_bytes = PG.numel() * PG.element_size()
    expect = (n // B + 1) * d * d * 4
    check(stack_bytes == expect, f"(a): stack {stack_bytes} != {expect}")
    # one f32 block, its Gram and the f64 carry beside the stack, never a
    # second stack
    check(peak < stack_bytes + 1e9, f"(a): build peak {peak} bytes")
    del gram, PG
    t = time.perf_counter()
    gram = tst.GramLeastSquaresGradient.build(X, y, block_rows=B)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    moved = (n * d * X.element_size() + 4 * n + stack_bytes
             + (n // B + 1) * (4 * d + 8) + 4 * d * d + 4 * d + 8)
    # the block products run in f64 (tpu_sgd_torch/ops/gram.py)
    t_ops = 2.0 * n * d * d / F64_FLOPS
    t_bytes = moved / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes)
    out = {"block_rows": B, "prefix_entries": n // B + 1,
           "first_s": first_s, "warm_s": warm_s, "stack_bytes": stack_bytes,
           "peak_allocated_bytes": peak, "bound_s": bound,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": bound / warm_s}
    return gram, out


def gram_windows(torch, tst, ck, gram, X, y, w_true):
    """(b) Exact-mode windows against B2 at three 1M-row starts, with
    weights on a bf16 grid at |w_true|'s scale (so that B2's rounding of
    the weights to bf16 is exact and both compute one function)."""
    n, d = X.shape
    m = round(FRAC * n)
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = torch.randn(d, generator=gen, device="cuda")
    w = (w * (torch.linalg.vector_norm(w_true) / torch.linalg.vector_norm(w))
         ).to(torch.bfloat16).float()
    exact = _exact_window_gradient(torch, tst)
    starts = {
        "random": int(torch.randint(0, n - m + 1, (1,), generator=gen,
                                    device="cuda")),
        "block_boundary": 300 * GRAM_BLOCK,
        "clamped": n - 1000,
    }
    out = {}
    for name, s0 in starts.items():
        s = torch.tensor([s0], device="cuda")
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        g, l, c = gram.window_sums(gram.data, y, w, s, m)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        gk, lk, ck_ = ck.fused_window_sums(gram.pointwise, X, y, w, s, m,
                                           tile_m=1)
        ge, le, _ = exact.window_sums(X, y, w, s, m)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        scale = float(gk.abs().max())
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        err = float((g - gk).abs().max())
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        rel_l = abs(float(l) - float(lk)) / abs(float(lk))
        out[name] = {
            "start": s0, "grad_scale": scale, "max_abs_err": err,
            "max_abs_err_over_scale": err / scale, "loss_rel_err": rel_l,
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            "exact_max_abs_err": float((g - ge).abs().max()),
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            "exact_loss_rel_err": abs(float(l) - float(le)) / float(le),
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            "kernel_exact_max_abs_err": float((gk - ge).abs().max())}
        check(err <= 1e-3 * scale and rel_l <= 1e-3
              # graftlint: disable=host-sync -- chip check: reads each case back to compare it
              and float(c) == float(ck_) == m,
              f"(b) {name}: statistics vs B2 {out[name]}")
    return out


def gram_sgd(torch, tst, ck, X, y, sliced_ref):
    """(c) SGD from the statistics in exact mode, phase ``full``'s windows;
    (d) aligned and chunked."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    n, d = X.shape
    m = round(FRAC * n)
    ls = tst.LeastSquaresGradient()
    ref_alg = _sgd_alg(tst, _exact_window_gradient(torch, tst))
    ref_alg.run((X, y))
    ref_hist = np.asarray(ref_alg.optimizer.loss_history)

    alg = _sgd_alg(tst, sufficient_stats=True)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = alg.run((X, y))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = ck.launch_counts()
    hist = np.asarray(alg.optimizer.loss_history)
    check(all(v == 0 for v in launches.values()),
          f"(c): the statistics launched fused kernels: {launches}")
    check(len(hist) == ITERS and bool(np.all(np.isfinite(hist))),
          f"(c): history {hist}")
    rel_exact = _max_rel(hist, ref_hist)
    check(rel_exact <= 1e-3, f"(c): history vs the exact windows' "
          f"{rel_exact} > 1e-3")
    L = full_objective(ls, X, y, model.weights)
    L_stock = full_objective(ls, X, y, sliced_ref[1])
    check(L <= 1.01 * L_stock, f"(c): objective {L} > 1.01 x {L_stock}")
    prof = _run_profile(torch, lambda: alg.run((X, y)), ITERS)
    # bytes one exact iteration must move: two prefix rows (G, b, yy) and
    # two B-row edge slices of X and y
    moved = 2 * (4 * d * d + 4 * d + 8) + 2 * GRAM_BLOCK * (2 * d + 4)
    bound = 1e3 * moved / HBM_BYTES_PER_S
    exact = {"first_run_s": first_s, "launches": launches,
             "history_max_rel_vs_exact_windows": rel_exact,
             "history_max_rel_vs_bf16_kernel_run": _max_rel(
                 hist, sliced_ref[0]),
             "history_first_rel_vs_bf16_kernel_run": _max_rel(
                 hist[:1], sliced_ref[0][:1]),
             "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
             "objective": L, "stock_objective": L_stock,
             "bound_ms": bound, "bound_bytes": moved,
             "share_of_bound": bound / prof["wall_ms_per_iteration"],
             **prof}
    exact["weights"] = model.weights
    alg.optimizer.release_sufficient_stats()
    del alg, model

    runs = {}
    opt = _sgd_alg(tst, sufficient_stats=True).optimizer
    opt.set_gram_options(block_rows=GRAM_BLOCK, aligned=True)
    for name, chunk in (("aligned", None), ("chunked", GRAM_CHUNK_ITERS)):
        if chunk:
            opt.set_gram_options(chunk_iters=chunk)
        ck.reset_launch_counts()
        w, h = opt.optimize_with_history((X, y), torch.zeros(d,
                                                             device="cuda"))
        launches = ck.launch_counts()
        check(all(v == 0 for v in launches.values()),
              f"(d) {name}: fused launches {launches}")
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        runs[name] = (w, np.asarray(h), _run_profile(
            torch, lambda: opt.optimize_with_history(
                (X, y), torch.zeros(d, device="cuda")), ITERS))
    (wa, ha, pa), (wc, hc, pc) = runs["aligned"], runs["chunked"]
    bitwise = bool(torch.equal(wa, wc) and np.array_equal(ha, hc))
    check(bitwise or (np.allclose(hc, ha, rtol=1e-6, atol=0)
                      and bool(torch.allclose(wc, wa, rtol=1e-6, atol=0))),
          "(d): the chunked run differs from the per-iteration aligned run "
          f"(history {_max_rel(hc, ha)}, weights "
          f"{float(((wc - wa).abs() / wa.abs()).max())})")
    opt.release_sufficient_stats()
    aligned = {"aligned": pa, "chunked": pc, "chunk_iters": GRAM_CHUNK_ITERS,
               "chunked_equals_aligned_bitwise": bitwise,
               "aligned_loss_last": float(ha[-1]),
               "aligned_history_max_rel_vs_exact_mode": _max_rel(ha, hist)}
    return exact, aligned


def gram_lbfgs(torch, tst, ck, X, y, qn_b):
    """(e) Least-squares L-BFGS from the statistics on leg (b)'s labels."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    y_ls = y.to(torch.bfloat16).to(torch.float32)
    alg = tst.LinearRegressionWithLBFGS(max_num_iterations=QN_ITERS)
    alg.set_schedule("off")  # a named route: no planner
    alg.optimizer.set_convergence_tol(0.0).set_sufficient_stats(True)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = alg.run((X, y_ls))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = ck.launch_counts()
    hist = alg.optimizer.loss_history
    its = len(hist) - 1
    check(all(v == 0 for v in launches.values()),
          f"(e): the statistics launched fused kernels: {launches}")
    check(_nonincreasing(hist), f"(e): the loss history rose: {hist}")
    L = full_objective(tst.LeastSquaresGradient(), X, y_ls, model.weights)
    check(L <= qn_b["lbfgs_objective"] * (1 + 1e-4),
          f"(e): objective {L} > leg (b)'s L-BFGS "
          f"{qn_b['lbfgs_objective']} x (1 + 1e-4)")
    prof = _run_profile(torch, lambda: alg.run((X, y_ls)), max(1, its))
    out = {"iterations": its, "first_run_s": first_s, "launches": launches,
           "objective": L, "stock_lbfgs_objective": qn_b["lbfgs_objective"],
           "normal_objective": qn_b["objective"],
           "stock_lbfgs_ms_per_iteration": qn_b["lbfgs_ms_per_iteration"],
           "stock_lbfgs_iterations": qn_b["lbfgs_iterations"], **prof}
    alg.optimizer.release_sufficient_stats()
    return out


def gram_chunked_gradient(torch, tst, ck, X, y, sliced_ref):
    """(f) ``ChunkedGradient`` at 65,536-row blocks: one B2 launch per
    block; against the stock window at each step of phase ``full``'s
    sliced run (loss and gradient rtol 2e-4), and its whole run against
    that run's objective (<= 1.01x); and B2's row at the block shape."""
    n = X.shape[0]
    m = round(FRAC * n)
    blocks = -(-m // CHUNK_ROWS)
    chunked = tst.ChunkedGradient(tst.LeastSquaresGradient(), CHUNK_ROWS)
    alg = _sgd_alg(tst, chunked)
    ck.reset_launch_counts()
    model = alg.run((X, y))
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    by_source = ck.kernel_launch_counts()
    hist = np.asarray(alg.optimizer.loss_history)
    expect = {"fused_gradient_sums": 0, "fused_window_sums": ITERS * blocks,
              "fused_window_sums_vpu": 0}
    check(launches == expect, f"(f): launches {launches} != {expect}")
    check(by_source == {"fused_sums": 0, "window_sums": ITERS * blocks},
          f"(f): launches by source {by_source}")
    rel = _max_rel(hist, sliced_ref[0])
    step_loss, step_grad, seams = _chunked_along_stock(
        torch, tst, chunked, alg, X, y, sliced_ref, blocks)
    check(step_loss <= CHUNKED_STEP_RTOL and step_grad <= CHUNKED_STEP_RTOL,
          f"(f): against the stock window at each step's weights: loss "
          f"{step_loss}, grad {step_grad} (of max |g|), limit "
          f"{CHUNKED_STEP_RTOL}")
    from tpu_sgd_torch.optimize.oracle import full_objective

    ls = tst.LeastSquaresGradient()
    L = full_objective(ls, X, y, model.weights)
    L_stock = full_objective(ls, X, y, sliced_ref[1])
    check(L <= 1.01 * L_stock, f"(f): objective {L} > 1.01 x {L_stock}")
    prof = _run_profile(torch, lambda: alg.run((X, y)), ITERS)
    # B2 at the block shape
    row = window_row(torch, ck, ck.fused_window_sums, chunked.pointwise, X,
                     y, sliced_ref[1], (n - CHUNK_ROWS) // 2, CHUNK_ROWS,
                     "chunked")
    row["launches"] = launches["fused_window_sums"]
    out = {"chunk_rows": CHUNK_ROWS, "blocks_per_window": blocks,
           "launches": launches, "launches_by_source": by_source,
           "history_max_rel_vs_stock": rel,
           "step_loss_max_rel_vs_stock": step_loss,
           "step_grad_max_err_over_scale_vs_stock": step_grad,
           "step_limit": CHUNKED_STEP_RTOL,
           "seam_rows_short_vs_stock": seams,
           "objective": L, "stock_objective": L_stock, **prof}
    return out, row


def _chunked_along_stock(torch, tst, chunked, alg, X, y, sliced_ref,
                         blocks):
    """``ChunkedGradient`` against the stock window path at each iteration
    of phase ``full``'s sliced run, at that iteration's weights and window:
    the stock run replayed step by step (its history must come out
    bitwise), the largest loss difference relative to the loss and the
    largest gradient difference relative to the largest gradient entry;
    and, at the first step, the same two differences for a window one row
    short at each of its ``blocks`` block seams (the scale of a wrong
    block sum, which the limit must stay under).
    (The two runs' own trajectories part by the f32 rounding of their sums:
    a difference of 1e-7 in the weights can flip one entry's bf16
    rounding, which moves that step's loss by 1e-3.)"""
    from tpu_sgd_torch.optimize import gradient_descent as gd

    opt = alg.optimizer
    cfg, upd = opt.config, opt.updater
    stock = tst.LeastSquaresGradient()
    step = gd.make_step(stock, upd, cfg)
    sampler = gd._make_sampler(cfg, X)
    m = round(cfg.mini_batch_fraction * X.shape[0])
    w = torch.zeros(X.shape[1], device="cuda")
    _, reg = upd.compute(w, torch.zeros_like(w), 0.0, 1, cfg.reg_param)
    worst_l = worst_g = 0.0
    seams = None
    replay = []
    for i in range(1, cfg.num_iterations + 1):
        sampler.seek(i)
        start = sampler.draw()
        gs, lsum, c = stock.window_sums(X, y, w, start, m)
        gc, lc, cc = chunked.window_sums(X, y, w, start, m)
        if seams is None:
            gb, lb, _ = stock.window_sums(X, y, w, start, m - blocks)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            seams = {"loss": abs(float(lb) - float(lsum)) / abs(float(lsum)),
                     # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                     "grad": float((gb - gs).abs().max())
                     # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                     / float(gs.abs().max())}
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        check(float(cc) == float(c), f"(f): count {float(cc)} at {i}")
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        worst_l = max(worst_l, abs(float(lc) - float(lsum))
                      # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                      / abs(float(lsum)))
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        worst_g = max(worst_g, float((gc - gs).abs().max())
                      # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                      / float(gs.abs().max()))
        w, loss_i, reg, _ = step(w, X, y, i, reg)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        replay.append(float(loss_i))
    check(np.array_equal(np.asarray(replay, np.float32), sliced_ref[0]),
          "(f): the step-by-step replay is not phase full's sliced run")
    return worst_l, worst_g, seams


def gram_precision(torch, tst, X, y, w):
    """(h) The exact window loss at the weights ``w`` (leg (c)'s last,
    near convergence) against f64 sums of the same rows, with the build's
    products, prefix carries, small stacks and loss terms in f64 (the
    module as it is) and all in f32 (the JAX package's choice)."""
    from tpu_sgd_torch.ops import gram

    n = X.shape[0]
    m = round(FRAC * n)
    starts = (0, n // 3, n - m)
    exact = []
    for s in starts:
        r = X[s:s + m].double() @ w.double() - y[s:s + m].double()
        exact.append(0.5 * float(r @ r))
        del r
    out = {"starts": list(starts), "loss_per_row": exact[0] / m}
    try:
        for name, dtype in (("f64_sums", torch.float64),
                            ("f32_sums", torch.float32)):
            gram.SUM_DTYPE = dtype
            g = tst.GramLeastSquaresGradient.build(X, y,
                                                   block_rows=GRAM_BLOCK)
            out[name] = max(
                abs(float(g.window_sums(g.data, y, w, s, m)[1]) - ref) / ref
                for s, ref in zip(starts, exact))
            del g
            torch.cuda.empty_cache()
    finally:
        gram.SUM_DTYPE = torch.float64
    check(out["f64_sums"] <= 1e-3, f"(h): {out}")
    return out


def gram_persistence(torch, tst):
    """(g) ``GramData.save`` / ``load`` at config 1's size: the loaded
    virtual bundle drives an aligned sliced run equal to the resident
    one."""
    X, y, _ = tst.linear_data(100_000, 100, eps=0.1, seed=0)
    Xg = torch.as_tensor(X, device="cuda")
    yg = torch.as_tensor(y, device="cuda")
    resident = tst.GramLeastSquaresGradient.build(
        Xg, yg, block_rows=GRAM_CONFIG1_BLOCK, aligned=True)
    with tempfile.TemporaryDirectory() as tmp:
        resident.data.save(tmp)
        data = tst.GramData.load(tmp)
    check(data.X is None and data.PG.is_cuda, "(g): the loaded bundle")

    def run(gradient, Xarg):
        opt = (tst.GradientDescent(gradient, tst.SimpleUpdater())
               .set_step_size(1.0).set_num_iterations(100)
               .set_mini_batch_fraction(0.1).set_sampling("sliced")
               .set_convergence_tol(0.0))
        w, h = opt.optimize_with_history(
            (Xarg, yg), torch.zeros(100, device="cuda"))
        return w, np.asarray(h)

    w_r, h_r = run(resident, Xg)
    w_v, h_v = run(tst.GramLeastSquaresGradient(data), data)
    bitwise = bool(torch.equal(w_r, w_v) and np.array_equal(h_r, h_v))
    check(bitwise or (np.allclose(h_v, h_r, rtol=1e-6, atol=0)
                      and bool(torch.allclose(w_v, w_r, rtol=1e-6, atol=0))),
          "(g): the loaded bundle's run differs from the resident one")
    return {"rows": X.shape[0], "d": X.shape[1],
            "block_rows": GRAM_CONFIG1_BLOCK,
            "loaded_equals_resident_bitwise": bitwise,
            "loss_last": float(h_v[-1])}


def phase_gram(torch, tst, ck, X, y, w_true, sliced_ref, qn_b):
    """Phase ``gram``: legs (a)-(g) on the 10M x 1000 matrix of phase
    ``full`` (config 1's size for (g))."""
    out = {}

    def leg(name, record):
        out[name] = record
        emit({"phase": "gram", "leg": name, **record})

    gram, record = gram_build(torch, tst, X, y)
    leg("a_build", record)
    leg("b_windows", gram_windows(torch, tst, ck, gram, X, y, w_true))
    del gram
    torch.cuda.empty_cache()
    exact, aligned = gram_sgd(torch, tst, ck, X, y, sliced_ref)
    w_c = exact.pop("weights")
    leg("c_sgd_exact", exact)
    leg("d_sgd_aligned", aligned)
    torch.cuda.empty_cache()
    leg("e_lbfgs", gram_lbfgs(torch, tst, ck, X, y, qn_b))
    torch.cuda.empty_cache()
    record, row = gram_chunked_gradient(torch, tst, ck, X, y, sliced_ref)
    leg("f_chunked_gradient", record)
    leg("g_persistence", gram_persistence(torch, tst))
    leg("h_precision", gram_precision(torch, tst, X, y, w_c))
    return out, row


# -- phase 9 -----------------------------------------------------------------

OBS_ITERS = 72              # the observed driver's run: two full windows
OBS_K, OBS_C = 8, 4         # of C = 4 blocks of K = 8, then one block
OBS_CKPT_EVERY = 5
OBS_STOP_AT = 13            # the iteration whose event raises the stop flag
#: rows of phase ``observed``: the sampling and the gradient of each run
OBS_ROWS = ("bernoulli", "indexed", "sliced", "sliced_vpu", "stats_exact",
            "stats_aligned", "stats_chunked", "chunked_gradient")


class _SyncCounter:
    """Host syncs of a region, counted by torch's own sync detector
    (``torch.cuda.set_sync_debug_mode("warn")`` warns on each operation
    that waits for the card: ``bool``/``int`` of a card tensor, ``.cpu()``,
    ``.item()``)."""

    def __init__(self, torch):
        self.torch = torch
        self.n = 0

    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings(record=True)
        self._log = self._cm.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self.n = sum(1 for w in self._log
                     if "synchroniz" in str(w.message).lower())
        self._cm.__exit__(*exc)
        return False


def _obs_optimizer(torch, tst, row, grams):
    """A fresh optimizer of one row: phase ``full``'s seed, step and
    fraction, ``convergence_tol=0`` (as phase ``profile``), 20
    iterations."""
    ls = tst.LeastSquaresGradient()
    sampling, gradient = "sliced", ls
    if row in ("bernoulli", "indexed"):
        sampling = row
    elif row == "sliced_vpu":
        gradient = tst.FusedGradient(ls, tile_m=WINDOW_TILE,
                                     window_kernel="vpu")
    elif row == "stats_exact":
        gradient = grams["exact"]
    elif row in ("stats_aligned", "stats_chunked"):
        gradient = grams["aligned"]
    elif row == "chunked_gradient":
        gradient = tst.ChunkedGradient(ls, CHUNK_ROWS)
    opt = tst.GradientDescent(gradient, tst.SimpleUpdater(), device="cuda")
    opt.set_step_size(0.5).set_num_iterations(ITERS)
    opt.set_mini_batch_fraction(FRAC).set_convergence_tol(0.0)
    opt.set_sampling(sampling)
    if row == "stats_chunked":
        opt.set_gram_options(chunk_iters=GRAM_CHUNK_ITERS)
    return opt


def _expected_launches(row):
    """Launches of one 20-iteration run, by wrapper and by source: one per
    iteration the card executes (a replayed block counts its captured
    launches), 16 a ``ChunkedGradient`` iteration, none from the
    statistics."""
    blocks = -(-round(FRAC * FULL_ROWS) // CHUNK_ROWS)
    n = {"bernoulli": ("fused_gradient_sums", "window_sums", ITERS),
         "indexed": ("fused_gradient_sums", "window_sums", ITERS),
         "sliced": ("fused_window_sums", "window_sums", ITERS),
         "sliced_vpu": ("fused_window_sums_vpu", "window_sums", ITERS),
         "chunked_gradient": ("fused_window_sums", "window_sums",
                              ITERS * blocks)}.get(row)
    wrappers = {"fused_gradient_sums": 0, "fused_window_sums": 0,
                "fused_window_sums_vpu": 0}
    sources = {"fused_sums": 0, "window_sums": 0}
    if n is not None:
        wrappers[n[0]] = n[2]
        sources[n[1]] = n[2]
    return wrappers, sources


def _obs_run(torch, ck, opt, X, y, d):
    """One warm run of ``opt``: weights, history, launches by wrapper and
    by source, host syncs, graph replays, and the peak of allocated and
    reserved bytes above what the run started with."""
    runner = lambda: (opt._run_cache[1].cache.get("runner")  # noqa: E731
                      if opt._run_cache else None)
    r0 = runner()
    replays0 = r0.replays if r0 is not None else 0
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    base_res = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    with _SyncCounter(torch) as syncs:
        w, h = opt.optimize_with_history((X, y), torch.zeros(d,
                                                             device="cuda"))
    torch.cuda.synchronize()
    r1 = runner()
    return {"w": w, "h": np.asarray(h),
            "launches": ck.launch_counts(),
            "launches_by_source": ck.kernel_launch_counts(),
            "host_syncs": syncs.n,
            "graph_replays": (r1.replays - (replays0 if r1 is r0 else 0)
                              if r1 is not None else 0),
            "capture_ms": r1.capture_ms if r1 is not None else None,
            "peak_extra_allocated_bytes":
                torch.cuda.max_memory_allocated() - base_alloc,
            "extra_reserved_bytes":
                torch.cuda.memory_reserved() - base_res}


def observed_rows(torch, tst, ck, X, y):
    """Captured against eager per row, in turns (eager, captured,
    captured, eager), 20 warm iterations each: bitwise weights and
    history, exact launch counts, the profile of each mode."""
    from tpu_sgd_torch.optimize import gradient_descent as gd

    d = X.shape[1]
    out = {}
    grams = {}
    for row in OBS_ROWS:
        if row == "stats_exact":
            grams = {"exact": tst.GramLeastSquaresGradient.build(
                X, y, block_rows=GRAM_BLOCK, device="cuda")}
        elif row == "stats_aligned":
            grams = {"aligned": tst.GramLeastSquaresGradient.build(
                X, y, block_rows=GRAM_BLOCK, aligned=True, device="cuda")}
        elif row == "chunked_gradient":
            grams = {}
        opts = {}
        for mode, graphs in (("eager", False), ("captured", True)):
            gd.CUDA_GRAPHS = graphs
            try:
                opts[mode] = _obs_optimizer(torch, tst, row, grams)
                first = _obs_run(torch, ck, opts[mode], X, y, d)  # warm-up
            finally:
                gd.CUDA_GRAPHS = True
            opts[mode].first = first
        check(opts["captured"].first["graph_replays"] == 0,
              f"observed {row}: a first run of {ITERS} iterations captured")
        runs = {"eager": [], "captured": []}
        for mode in ("eager", "captured", "captured", "eager"):
            runs[mode].append(_obs_run(torch, ck, opts[mode], X, y, d))
        ref = runs["eager"][0]
        exp_w, exp_s = _expected_launches(row)
        bitwise = True
        for mode in ("eager", "captured"):
            for r in runs[mode]:
                bitwise &= bool(torch.equal(r["w"], ref["w"])
                                and np.array_equal(r["h"], ref["h"]))
                check(r["launches"] == exp_w and
                      r["launches_by_source"] == exp_s,
                      f"observed {row} {mode}: launches {r['launches']} / "
                      f"{r['launches_by_source']}, expected {exp_w} / "
                      f"{exp_s}")
        check(bitwise, f"observed {row}: a captured run differs from the "
              "eager loop")
        check(len(ref["h"]) == ITERS and bool(np.all(np.isfinite(ref["h"]))),
              f"observed {row}: history {ref['h']}")
        # the second run on the same tensors warms up its first block and
        # captures the second; every later run replays both
        cap = runs["captured"][0]
        blocks = ITERS // (GRAM_CHUNK_ITERS if row == "stats_chunked"
                           else gd.RUN_BLOCK_ITERS)
        replays = [r["graph_replays"] for r in runs["captured"]]
        check(cap["capture_ms"] is not None
              and replays == [blocks - 1, blocks],
              f"observed {row}: graph replays {replays}")
        prof = {}
        for mode in ("eager", "captured", "captured", "eager"):
            opt = opts[mode]
            p = _run_profile(torch, lambda: opt.optimize_with_history(
                (X, y), torch.zeros(d, device="cuda")), ITERS)
            prof.setdefault(mode, []).append(p)

        def mean(mode, key):
            return sum(p[key] for p in prof[mode]) / len(prof[mode])

        keys = ("wall_ms_per_iteration", "device_ms_per_iteration",
                "idle_share", "aten_calls_per_iteration")
        out[row] = {
            "bitwise_equal": bitwise,
            "launches": cap["launches"],
            "launches_by_source": cap["launches_by_source"],
            "capture_ms": cap["capture_ms"],
            # the eager mode's first run beside the captured mode's run
            # that captures (its second)
            "first_run_peak_extra_allocated_bytes": {
                "eager": opts["eager"].first["peak_extra_allocated_bytes"],
                "captured": cap["peak_extra_allocated_bytes"]},
            "first_run_extra_reserved_bytes": {
                "eager": opts["eager"].first["extra_reserved_bytes"],
                "captured": cap["extra_reserved_bytes"]},
            **{mode: {**{k: mean(mode, k) for k in keys},
                      "walls": [p["wall_ms_per_iteration"]
                                for p in prof[mode]],
                      "host_syncs_per_run": runs[mode][0]["host_syncs"],
                      "graph_replays_per_run": runs[mode][1]["graph_replays"],
                      "peak_extra_allocated_bytes":
                          runs[mode][0]["peak_extra_allocated_bytes"],
                      "top_device_ms": prof[mode][0]["top_device_ms"]}
               for mode in ("eager", "captured")}}
        emit({"phase": "observed", "row": row, **out[row]})
        del opts, runs, prof
        torch.cuda.empty_cache()
    return out


def _stop_listener(at=None, on_stop=None):
    """A ``CollectingListener`` that raises its ``flag`` (and calls
    ``on_stop`` once) when the event of iteration ``at`` arrives."""
    from tpu_sgd_torch.utils.events import CollectingListener

    class StopAt(CollectingListener):
        flag = False

        def on_iteration(self, event):
            super().on_iteration(event)
            if at is not None and event.iteration >= at and not self.flag:
                self.flag = True
                if on_stop is not None:
                    on_stop()

        def stop(self):
            return self.flag

    return StopAt()


def _ckpt_contents(path):
    """Each checkpoint file's entries, by file name."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.startswith("ckpt_"):
            with np.load(os.path.join(path, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    return out


def _same_ckpts(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[f].keys() == b[f].keys()
        and all(np.array_equal(a[f][k], b[f][k]) for k in a[f])
        for f in a)


def observed_driver(torch, tst, X, y):
    """The observed driver on phase ``full``'s sliced run at 72
    iterations: a listener and checkpoints every 5 iterations at K = 1,
    K = 8 and K = 8 with C = 4 (histories, events and checkpoint contents
    equal); a stop raised by the event of iteration 13 and a resume,
    bitwise the uninterrupted run, in each mode (the stop lands at 13, at
    the block boundary 16, and at the next window's poll, 64);
    ``TrainingSupervisor`` preempted once."""
    from tpu_sgd_torch.reliability import (
        TrainingPreempted,
        TrainingSupervisor,
    )
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    d = X.shape[1]
    modes = {"k1": (1, 0), "k8": (OBS_K, 0), "k8_c4": (OBS_K, OBS_C)}
    w0 = torch.zeros(d, device="cuda")

    def optimizer(k, c):
        opt = tst.GradientDescent(device="cuda").set_step_size(0.5)
        opt.set_num_iterations(OBS_ITERS).set_mini_batch_fraction(FRAC)
        opt.set_sampling("sliced").set_convergence_tol(0.0)
        opt.set_superstep(k)
        if c:
            opt.set_residency(c)
        return opt

    out, ref = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for name, (k, c) in modes.items():
            lis = _stop_listener()
            opt = optimizer(k, c).set_listener(lis)
            path = os.path.join(tmp, name)
            opt.set_checkpoint(CheckpointManager(path, keep=100),
                               every=OBS_CKPT_EVERY)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            w, h = opt.optimize_with_history((X, y), w0)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - base
            events = [(e.iteration, e.loss, e.weight_delta_norm,
                       e.mini_batch_size) for e in lis.iterations]
            ckpts = _ckpt_contents(path)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            run = {"w": w, "h": np.asarray(h), "events": events,
                   "ckpts": ckpts}
            if ref is None:
                ref = run
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            same = (bool(torch.equal(w, ref["w"]))
                    and np.array_equal(run["h"], ref["h"])
                    and events == ref["events"]
                    and _same_ckpts(ckpts, ref["ckpts"]))
            check(same, f"observed driver {name}: differs from k1")
            check(len(h) == OBS_ITERS and len(events) == OBS_ITERS,
                  f"observed driver {name}: {len(h)} losses")
            # a stop raised at iteration 13, then a resume
            stop_path = os.path.join(tmp, name + "_stop")
            lis2 = _stop_listener(OBS_STOP_AT)
            opt2 = optimizer(k, c).set_listener(lis2)
            opt2.set_checkpoint(CheckpointManager(stop_path),
                                every=OBS_CKPT_EVERY)
            opt2.set_stop_signal(lis2.stop)
            stopped_at = None
            try:
                opt2.optimize_with_history((X, y), w0)
            except TrainingPreempted as e:
                stopped_at = e.iteration
            check(stopped_at is not None, f"{name}: the stop was ignored")
            opt2.set_stop_signal(None)
            w2, h2 = opt2.optimize_with_history((X, y), w0)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            resumed = (bool(torch.equal(w2, ref["w"]))
                       # graftlint: disable=host-sync -- chip check: reads each case back to compare it
                       and np.array_equal(np.asarray(h2), ref["h"]))
            check(resumed, f"{name}: stop at {stopped_at} and resume "
                  "differs from the uninterrupted run")
            # the warm pace: a listener only, the second of two runs
            warm = optimizer(k, c).set_listener(_stop_listener())
            warm.optimize_with_history((X, y), w0)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            torch.cuda.synchronize()
            t = time.perf_counter()
            warm.optimize_with_history((X, y), w0)
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            torch.cuda.synchronize()
            warm_ms = 1e3 * (time.perf_counter() - t) / OBS_ITERS
            out[name] = {"first_run_ms_per_iteration": 1e3 * secs / OBS_ITERS,
                         "warm_ms_per_iteration": warm_ms,
                         "peak_extra_allocated_bytes": peak,
                         "checkpoints": len(ckpts),
                         "equal_to_k1": same, "stopped_at": stopped_at,
                         "resume_bitwise": resumed}
        # the supervisor around the K = 8 run, preempted once: the event
        # of iteration 13 requests it, and the run stops at the boundary
        sup = None
        lis3 = _stop_listener(OBS_STOP_AT, lambda: sup.request_preempt())
        opt3 = optimizer(OBS_K, 0).set_listener(lis3)
        sup = TrainingSupervisor(
            opt3, checkpoint_manager=os.path.join(tmp, "sup"),
            checkpoint_every=OBS_CKPT_EVERY, install_signal_handlers=False)
        first = sup.run((X, y), w0)
        second = sup.run((X, y), w0)
        sup_ok = (first.status == "preempted" and second.completed
                  and bool(torch.equal(second.weights, ref["w"]))
                  and np.array_equal(second.loss_history, ref["h"]))
        check(sup_ok, f"supervisor: {first.status} at {first.preempted_at},"
              f" then {second.status}")
        out["supervisor"] = {"preempted_at": first.preempted_at,
                             "then": second.status, "bitwise": sup_ok}
    return out


def device_step_check(torch):
    """The updater's step on the card, ``step_size / sqrt(i)`` in f32 for
    i = 1 .. 10^6, against numpy's host rounding: bitwise."""
    from tpu_sgd_torch.ops.updaters import _this_step

    i = np.arange(1, 1_000_001)
    host = np.float32(0.5) / np.sqrt(i.astype(np.float32))
    dev = _this_step(0.5, torch.arange(1, 1_000_001, device="cuda"))
    same = bool(np.array_equal(dev.cpu().numpy(), host))
    check(same, "the device step differs from the host rounding")
    return same


def sampler_ms(torch, tst, X, draws=20, replays=10):
    """Device ms of one draw of each sampler at config 4's shape: ``draws``
    draws captured in a CUDA graph (the sampler's generator registered with
    it, as the run's blocks register it), the replay timed by events."""
    from tpu_sgd_torch.optimize import gradient_descent as gd

    out = {}
    for mode in ("bernoulli", "sliced", "indexed"):
        cfg = tst.SGDConfig(mini_batch_fraction=FRAC, sampling=mode)
        s = gd._make_sampler(cfg, X)
        # graftlint: disable=eager-in-loop -- one capture per sampler mode, each timed alone
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(s.gen)
        # graftlint: disable=eager-in-loop -- one capture per sampler mode, each timed alone
        with torch.cuda.graph(graph):
            for _ in range(draws):
                # graftlint: disable=callback-discipline -- draw's host side only moves the registered offset
                s.draw()
        graph.replay()
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        end.synchronize()
        out[mode] = {"ms": start.elapsed_time(end) / (draws * replays),
                     "offset_stride": s.stride}
        del graph
    return out


def phase_observed(torch, tst, ck, X, y):
    """Phase ``observed`` on phase ``full``'s matrix, then phase ``obs``
    (a) on the same matrix (``obs_counters_on_card``)."""
    t = time.perf_counter()
    rows = observed_rows(torch, tst, ck, X, y)
    driver = observed_driver(torch, tst, X, y)
    out = {"rows": rows, "driver": driver,
           "device_step_equals_host": device_step_check(torch),
           "sampler_ms": sampler_ms(torch, tst, X),
           "seconds": time.perf_counter() - t}
    emit({"phase": "observed", "driver": driver,
          "device_step_equals_host": out["device_step_equals_host"],
          "sampler_ms": out["sampler_ms"], "seconds": out["seconds"]})
    t = time.perf_counter()
    out["obs_counters"] = obs_counters_on_card(torch, tst, ck, X, y)
    out["obs_counters"]["seconds"] = time.perf_counter() - t
    return out


# -- phase obs: the observability layer on the card ---------------------------

#: the time series' window width of phase ``obs`` (b): the HA runs take
#: 0.5-1 s, so each spans several windows
OBS_WINDOW_S = 0.1


def obs_counters_on_card(torch, tst, ck, X, y):
    """Phase ``obs`` (a): the observed driver's sliced run of phase
    ``observed`` (``OBS_ITERS`` iterations at K = ``OBS_K``, a listener),
    warmed (its first run captures the block; every later run on the same
    tensors replays all its blocks).  Run with the layer off under torch's
    sync detector (the witness), then under ``obs.enable(trace)``:
    ``train.dispatch`` equals the run's graph replays plus the kernel
    launches it made outside a capture (``_BlockRunner.replays``, and
    ``cuda_kernels.kernel_launch_counts()`` less what the replays added),
    ``compile`` is 0, ``host_sync`` equals the witness, and the run is
    bitwise the one with the layer off.  Then off, on, on, off for the
    walls (not gated; an "on" wall is taken with the layer on)."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.obs import counters

    d = X.shape[1]
    w0 = torch.zeros(d, device="cuda")
    opt = (tst.GradientDescent(device="cuda").set_step_size(0.5)
           .set_num_iterations(OBS_ITERS).set_mini_batch_fraction(FRAC)
           .set_sampling("sliced").set_convergence_tol(0.0)
           .set_superstep(OBS_K).set_listener(_stop_listener()))

    def runner():  # the observed driver's cached block runner
        return opt._observed_entry[1] if opt._observed_entry else None

    opt.optimize_with_history((X, y), w0)  # warms up, captures, replays

    def run(trace=None):
        r0 = runner()
        replays0 = r0.replays if r0 is not None else 0
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        if trace is not None:
            obs.enable(trace)
            counters.reset()
        try:
            t = time.perf_counter()
            w, h = opt.optimize_with_history((X, y), w0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            snap = counters.snapshot() if trace is not None else None
        finally:
            if trace is not None:
                obs.disable()
        r1 = runner()
        replays = r1.replays - (replays0 if r1 is r0 else 0)
        per_replay = sum(r1.launches["sources"].values())
        eager = sum(ck.kernel_launch_counts().values()) - replays * per_replay
        return {"w": w, "h": np.asarray(h), "snap": snap, "replays": replays,
                "eager_launches": eager,
                "ms_per_iteration": 1e3 * wall / OBS_ITERS}

    def total(snap, kind):
        return sum(v["n"] for k, v in snap.items() if k.endswith("." + kind))

    with tempfile.TemporaryDirectory() as tmp:
        with _SyncCounter(torch) as syncs:
            off = run()
        on = run(os.path.join(tmp, "counted.jsonl"))
        snap = on["snap"]
        structural = off["replays"] + off["eager_launches"]
        out = {"iterations": OBS_ITERS, "k": OBS_K,
               "graph_replays": off["replays"],
               "eager_launches": off["eager_launches"],
               "train_dispatch": snap.get("train.dispatch", {"n": 0})["n"],
               "dispatch": total(snap, "dispatch"),
               "compile": total(snap, "compile"),
               "host_sync": total(snap, "host_sync"),
               "host_sync_witness": syncs.n,
               "h2d": total(snap, "h2d")}
        check(on["replays"] == off["replays"] == OBS_ITERS // OBS_K
              and on["eager_launches"] == off["eager_launches"],
              f"obs (a): the runs differ in structure {out}")
        check(out["train_dispatch"] == out["dispatch"] == structural,
              f"obs (a): dispatch {out}, want replays + eager launches "
              f"{structural}")
        check(out["compile"] == 0, f"obs (a): compiles {out}")
        check(out["host_sync"] == syncs.n > 0,
              f"obs (a): host syncs {out}, the sync detector saw {syncs.n}")
        check(bool(torch.equal(on["w"], off["w"]))
              and np.array_equal(on["h"], off["h"]),
              "obs (a): the run with the layer on differs from the run "
              "with it off")
        walls = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            r = run(os.path.join(tmp, f"wall_{len(walls['on'])}.jsonl")
                    if mode == "on" else None)
            walls[mode].append(r["ms_per_iteration"])
    out["wall_ms_per_iteration_off"] = walls["off"]
    out["wall_ms_per_iteration_on"] = walls["on"]
    return out


def phase_analysis(torch, tst, ck, X, y):
    """Phase ``analysis``: graftlint's runtime checkers on real card
    tensors (module docstring, 9d).  Each count must be above 0 where the
    card must count, or the checker read nothing."""
    from tpu_sgd_torch.analysis import runtime as rt

    t0 = time.perf_counter()
    out = {}
    d = X.shape[1]
    w0 = torch.zeros(d, device="cuda")
    # (a) dispatches and compiles around the unobserved captured run
    opt = (tst.GradientDescent(device="cuda").set_step_size(0.5)
           .set_num_iterations(20).set_mini_batch_fraction(FRAC)
           .set_sampling("bernoulli").set_convergence_tol(0.0))
    opt.optimize_with_history((X, y), w0)  # a first run: eager
    opt.optimize_with_history((X, y), w0)  # warms block 1, captures 2
    runner = opt._run_cache[1].cache["runner"]
    check(runner.graph is not None, "analysis (a): no block was captured")
    replays0 = runner.replays
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    with rt.count_dispatches() as disp:
        w_a, h_a = opt.optimize_with_history((X, y), w0)
    torch.cuda.synchronize()
    replays = runner.replays - replays0
    per_replay = sum(runner.launches["sources"].values())
    eager = sum(ck.kernel_launch_counts().values()) - replays * per_replay
    out["a"] = {"iterations": 20, "k": runner.k, "dispatches": disp["n"],
                "graph_replays": replays, "eager_launches": eager,
                "launches_per_replay": per_replay}
    check(disp["n"] == replays + eager and disp["n"] > 0 and replays == 2,
          f"analysis (a): dispatches {out['a']}")
    with rt.count_host_syncs() as reads:
        with rt.assert_compile_count(0):
            w_b, h_b = opt.optimize_with_history((X, y), w0)
    check(bool(torch.equal(w_a, w_b)) and np.array_equal(h_a, h_b),
          "analysis (a): the repeated run differs")
    out["a"]["repeat_compiles"] = 0
    # (b) host syncs: the replayed run reads only its end (the record
    # count and the history), and the observed run's reads equal torch's
    # sync detector's
    with rt.assert_no_host_sync(allow=2):
        opt.optimize_with_history((X, y), w0)
    out["b"] = {"replayed_run_reads": reads["n"],
                "replayed_run_read_shapes": [list(s) + [dt] for s, dt
                                             in reads["shapes"]]}
    check(reads["n"] == 2, f"analysis (b): the replayed run read "
          f"{reads['shapes']}, want its two boundary reads")
    obs_opt = (tst.GradientDescent(device="cuda").set_step_size(0.5)
               .set_num_iterations(OBS_ITERS).set_mini_batch_fraction(FRAC)
               .set_sampling("sliced").set_convergence_tol(0.0)
               .set_superstep(OBS_K).set_listener(_stop_listener()))
    obs_opt.optimize_with_history((X, y), w0)  # warms up and captures
    # the detector's first switch-on in a process reports one synchronizing
    # call of its own (``set_sync_debug_mode``, torch/cuda/__init__.py:
    # one more than the counters when this phase runs first in a process):
    # switch it on once before the witnessed run
    with _SyncCounter(torch):
        pass
    with _SyncCounter(torch) as witness:
        obs_opt.optimize_with_history((X, y), w0)
    with rt.count_host_syncs() as syncs:
        obs_opt.optimize_with_history((X, y), w0)
    out["b"].update({"observed_iterations": OBS_ITERS, "observed_k": OBS_K,
                     "observed_reads": syncs["n"],
                     "sync_detector": witness.n})
    check(syncs["n"] == witness.n > 0,
          f"analysis (b): count_host_syncs {syncs['n']}, the sync "
          f"detector {witness.n}")
    # (c) the host reads one L-BFGS iteration adds (leg (a)'s problem)
    y_log = logistic_labels(torch, X, X.new_ones(d).float())
    per_run = {}
    for iters in (1, 2):
        alg = tst.LogisticRegressionWithLBFGS(max_num_iterations=iters,
                                              reg_param=1e-4)
        alg.set_schedule("off")  # a named route: no planner
        alg.optimizer.set_convergence_tol(0.0)
        with rt.count_host_syncs() as c:
            alg.run((X, y_log))
        per_run[iters] = {"reads": c["n"], "cost_evaluations":
                          len(alg.optimizer.loss_history)}
    out["c"] = {"one_iteration": per_run[1], "two_iterations": per_run[2],
                "reads_per_iteration": per_run[2]["reads"]
                - per_run[1]["reads"]}
    check(out["c"]["reads_per_iteration"] > 0,
          f"analysis (c): an L-BFGS iteration read nothing {out['c']}")
    del y_log
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "analysis", **out})
    return out


@contextlib.contextmanager
def armed_obs(tmp, name):
    """One run under ``obs.enable(trace, detect=True, flightrec=...)``:
    yields the paths, and after the run the detectors' trip counts (the
    trailing window evaluated first)."""
    from tpu_sgd_torch import obs

    rec = {"trace": os.path.join(tmp, f"{name}.jsonl"),
           "flightrec": os.path.join(tmp, f"{name}_flightrec.jsonl")}
    t = time.perf_counter()
    obs.enable(rec["trace"], detect=True, window_s=OBS_WINDOW_S,
               flightrec=rec["flightrec"])
    rec["overhead_s"] = time.perf_counter() - t
    try:
        yield rec
        t = time.perf_counter()
        obs.flush_windows()
        rec["trips"] = obs.detector_engine().trip_counts()
    finally:
        obs.disable()
        rec["overhead_s"] += time.perf_counter() - t


def obs_clis(trace, tmp):
    """Phase ``obs`` (c): the report and watch CLIs on the killed HA run's
    trace, as subprocesses started together: the report exits 0 on an SLO
    document the run meets (with a Chrome trace written) and 1 on one it
    violates, its alerts section names ``failover``, the Chrome JSON
    loads, and the watcher renders once."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    docs = {"meets": {"slos": [
        {"name": "one-failover-alert", "metric": "alert_count",
         "rule": "failover", "min": 1, "max": 1},
        {"name": "promotion-span", "metric": "span_count",
         "span": "replica.failover", "min": 1},
        {"name": "no-straggler", "metric": "alert_count",
         "rule": "replica-straggler", "max": 0}]},
        "violates": {"slos": [
            {"name": "no-failover", "metric": "alert_count",
             "rule": "failover", "max": 0}]}}
    paths = {}
    for name, doc in docs.items():
        paths[name] = os.path.join(tmp, f"slo_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    chrome = os.path.join(tmp, "chrome.json")
    report = [sys.executable, "-m", "tpu_sgd_torch.obs.report", trace]
    cmds = {"meets": report + ["--slo", paths["meets"], "--chrome", chrome],
            "violates": report + ["--slo", paths["violates"]],
            "watch": [sys.executable, "-m", "tpu_sgd_torch.obs.watch", trace,
                      "--once", "--window", str(OBS_WINDOW_S)]}
    t = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=root, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    said = {}
    try:
        for k, p in procs.items():
            said[k] = p.communicate(timeout=120) + (p.returncode,)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = {k: v[2] for k, v in said.items()}
    check(codes == {"meets": 0, "violates": 1, "watch": 0},
          f"obs (c): exit codes {codes}: "
          + " | ".join(f"{k}: {v[1][-400:]}" for k, v in said.items()))
    alerts = said["meets"][0].split("alerts (", 1)
    check(len(alerts) == 2 and "[failover]" in alerts[1],
          f"obs (c): the report names no failover alert: "
          f"{said['meets'][0][-600:]}")
    check("SLO FAIL: no-failover" in said["violates"][0],
          f"obs (c): {said['violates'][0][-300:]}")
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    check(len(events) > 0, "obs (c): an empty Chrome trace")
    check("ACTIVE ALERTS" in said["watch"][0] or "window" in said["watch"][0],
          f"obs (c): the watcher rendered {said['watch'][0][-300:]}")
    return {"exit_codes": codes, "chrome_events": len(events),
            "alerts_section_names_failover": True,
            "watch_lines": said["watch"][0].count("\n"),
            "seconds": time.perf_counter() - t}


def phase_obs(observed, replica) -> dict:
    """Phase ``obs``'s line: (a) from phase ``observed``'s end, (b) and (c)
    from phase ``replica`` (e)."""
    ha = replica["e_ha"]
    out = {"a_counters": observed["obs_counters"],
           "b_detectors": ha["obs"], "c_clis": ha["obs"].pop("clis")}
    out["seconds"] = (out["a_counters"]["seconds"]
                      + out["b_detectors"]["added_seconds"]
                      + out["c_clis"]["seconds"])
    emit({"phase": "obs", **out})
    return out


# -- phase replica: async replicated training on phase full's matrix ---------

REPLICA_WORKERS = 8
REPLICA_PREFIX_ROWS = 1_000_000  # (a), (d)-(f): 8 shards of 125,000 rows
REPLICA_ROUNDS = 20         # (a), (b), (e): phase profile's iterations
REPLICA_TAU = 2             # (c), (d)
REPLICA_STEPS = 200         # (c)'s applied steps, and (b)'s long τ=0 run
REPLICA_TOPK = "topk:0.01"  # (d)
# (d): the compressed wire's rounds and steps.  A τ=0 round adds 8
# segments of k = 10 coordinates; a τ=2 step applies one, from one of 8
# error-feedback accumulators, so a coordinate leaves a worker's
# accumulator about once in 100 of its pushes and the τ=2 run needs
# thousands of steps to meet the dense objective (the ratio each run
# reads is in the phase's line)
REPLICA_TOPK_ROUNDS = 500
REPLICA_TOPK_STEPS = 4000
REPLICA_STOP_ROUNDS, REPLICA_STOP_AT = 40, 13  # (f)
REPLICA_OBJECTIVE_RATIO = 1.01
# (e): the kill timer's delay as shares of the fault-free HA run's wall;
# the next share is tried only when a kill landed after the run ended
REPLICA_KILL_SHARES = (0.4, 0.25, 0.6)


def _replica_driver(tst, mode, rounds, tau=0):
    """Phase ``full``'s problem (least squares, step 0.5, frac 0.1) over
    ``REPLICA_WORKERS`` replica workers at staleness ``tau``, on the
    default devices (every visible card: here the one)."""
    from tpu_sgd_torch.replica import ReplicaDriver

    return (ReplicaDriver(tst.LeastSquaresGradient(), tst.SimpleUpdater())
            .set_step_size(0.5).set_num_iterations(rounds)
            .set_mini_batch_fraction(FRAC).set_convergence_tol(0.0)
            .set_sampling(mode).set_workers(REPLICA_WORKERS)
            .set_staleness(tau))


def _replica_run(torch, ck, drv, X, y, rounds) -> dict:
    """One driver run: weights, history, launches by wrapper and by source
    (set to 0 just before and read just after), the store's snapshot, wall
    ms a round."""
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    w, h = drv.optimize_with_history(
        (X, y), torch.zeros(X.shape[1], device=X.device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return {"w": w, "h": np.asarray(h), "launches": ck.launch_counts(),
            "by_source": ck.kernel_launch_counts(),
            "snap": drv.last_store_snapshot, "wall_s": wall,
            "ms_per_round": 1e3 * wall / rounds}


def _replica_launches(run, mode, n, what) -> None:
    """Exactly ``n`` launches of the mode's wrapper, all in
    ``window_sums.cu``, and none of another wrapper."""
    wrapper = ("fused_gradient_sums" if mode == "bernoulli"
               else "fused_window_sums")
    want = {k: (n if k == wrapper else 0) for k in run["launches"]}
    check(run["launches"] == want
          and run["by_source"] == {"fused_sums": 0, "window_sums": n},
          f"replica {what}: launches {run['launches']} {run['by_source']}, "
          f"want {n} of {wrapper}")


def _prefix_shards(X, y):
    rows = REPLICA_PREFIX_ROWS // REPLICA_WORKERS
    return [(X[s * rows:(s + 1) * rows], y[s * rows:(s + 1) * rows])
            for s in range(REPLICA_WORKERS)]


class _PushTrace:
    """A trace sink that keeps the ``replica.push`` events' verdicts
    (emitted from every worker thread)."""

    def __init__(self):
        self.pushes = []

    def emit(self, kind, payload):
        if kind == "trace_event" and payload.get("name") == "replica.push":
            self.pushes.append((bool(payload.get("accepted")),
                                int(payload.get("staleness", 0))))


def replica_prefix(torch, tst, ck, X, y):
    """(a): τ=0 on the 1M-row prefix, Bernoulli and sliced, bitwise the
    one-process rank-order sum of the same 8 shards
    (``rank_order_reference``, phase ``mesh`` (b)'s), with exact launches
    and store counts.  Returns the report and the references."""
    Xp, yp = X[:REPLICA_PREFIX_ROWS], y[:REPLICA_PREFIX_ROWS]
    refs, out = {}, {}
    for mode in ("bernoulli", "sliced"):
        refs[mode] = rank_order_reference(torch, tst, _prefix_shards(X, y),
                                          mode, iters=REPLICA_ROUNDS)
        run = _replica_run(torch, ck, _replica_driver(tst, mode,
                                                      REPLICA_ROUNDS),
                           Xp, yp, REPLICA_ROUNDS)
        same = (torch.equal(run["w"], refs[mode][0])
                and np.array_equal(run["h"], refs[mode][1]))
        check(same, f"replica (a) {mode}: not the rank-order sum")
        _replica_launches(run, mode, REPLICA_WORKERS * REPLICA_ROUNDS,
                          f"(a) {mode}")
        snap = run["snap"]
        check(snap["version"] == REPLICA_ROUNDS
              and snap["pushes_accepted"] == REPLICA_WORKERS
              * REPLICA_ROUNDS and snap["max_accepted_staleness"] == 0,
              f"replica (a) {mode}: store {snap}")
        out[mode] = {"bitwise_rank_order_sum": same,
                     "launches": run["launches"],
                     "pushes_accepted": snap["pushes_accepted"],
                     "max_accepted_staleness":
                         snap["max_accepted_staleness"],
                     "ms_per_round": run["ms_per_round"]}
    return out, refs


def replica_full(torch, tst, ck, X, y, profile):
    """(b): τ=0 over all 10M rows (8 x 1.25M, views of X), Bernoulli and
    sliced: launches exact, the objective within 1.01x of phase
    ``profile``'s single-device run at the same iterations, wall ms a
    round, device ms a round (``torch.profiler``: the kernels of all 8
    threads on the card) and the host's share; then the τ=0 Bernoulli run
    of ``REPLICA_STEPS`` rounds that (c) is held to."""
    from torch.profiler import ProfilerActivity, profile as trace

    out = {}
    for mode in ("bernoulli", "sliced"):
        drv = _replica_driver(tst, mode, REPLICA_ROUNDS)
        run = _replica_run(torch, ck, drv, X, y, REPLICA_ROUNDS)
        _replica_launches(run, mode, REPLICA_WORKERS * REPLICA_ROUNDS,
                          f"(b) {mode}")
        obj = ls_objective_exact(torch, X, y, run["w"])
        ratio = obj / profile[mode]["objective"]
        check(ratio <= REPLICA_OBJECTIVE_RATIO,
              f"replica (b) {mode}: objective {ratio}x the single "
              "device's")
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            traced = _replica_run(torch, ck, drv, X, y, REPLICA_ROUNDS)
        kernels = {k: v / REPLICA_ROUNDS
                   for k, v in device_ms_by_kernel(torch, prof).items()}
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        out[mode] = {
            "launches": run["launches"], "objective": obj,
            "single_device_objective": profile[mode]["objective"],
            "objective_ratio": ratio,
            "ms_per_round": run["ms_per_round"],
            "traced_ms_per_round": traced["ms_per_round"],
            "device_ms_per_round": busy if busy > 0 else None,
            "host_share": (1 - busy / run["ms_per_round"]) if busy > 0
            else None,
            "single_device_ms_per_iteration":
                profile[mode]["wall_ms_per_iteration"],
            "top_device_ms": dict(top)}
    long = _replica_run(torch, ck, _replica_driver(tst, "bernoulli",
                                                   REPLICA_STEPS),
                        X, y, REPLICA_STEPS)
    _replica_launches(long, "bernoulli", REPLICA_WORKERS * REPLICA_STEPS,
                      "(b) long")
    out["long"] = {"rounds": REPLICA_STEPS,
                   "objective": ls_objective_exact(torch, X, y, long["w"]),
                   "ms_per_round": long["ms_per_round"]}
    return out


def replica_async(torch, tst, ck, X, y, tau0):
    """(c): τ=2 over all rows, Bernoulli, ``REPLICA_STEPS`` applied steps,
    traced: every accepted push within the bound, every rejected one
    beyond it, one launch per push attempt (accepted, rejected, or answered
    ``done``), the objective within 1.01x of (b)'s τ=0 run at the same
    count; applied steps/s and the staleness histogram."""
    from tpu_sgd_torch.obs import spans

    sink = _PushTrace()
    spans.enable_tracing(sink)
    try:
        run = _replica_run(torch, ck, _replica_driver(
            tst, "bernoulli", REPLICA_STEPS, tau=REPLICA_TAU), X, y,
            REPLICA_STEPS)
    finally:
        spans.disable_tracing()
    snap = run["snap"]
    accepted = [st for ok, st in sink.pushes if ok]
    rejected = [st for ok, st in sink.pushes if not ok]
    check(len(accepted) == snap["pushes_accepted"] == REPLICA_STEPS
          and snap["version"] == REPLICA_STEPS,
          f"replica (c): {len(accepted)} accepted pushes traced, {snap}")
    check(max(accepted) <= REPLICA_TAU
          and snap["max_accepted_staleness"] <= REPLICA_TAU
          and all(st > REPLICA_TAU for st in rejected),
          f"replica (c): staleness {sorted(set(accepted))} accepted, "
          f"{sorted(set(rejected))} rejected")
    attempts = (snap["pushes_accepted"] + snap["pushes_rejected"]
                + snap["pushes_after_done"] + snap["pushes_fenced"]
                + snap["pushes_poisoned"])
    launched = run["launches"]["fused_gradient_sums"]
    check(launched == attempts and run["by_source"]["window_sums"] == launched,
          f"replica (c): {launched} launches for {attempts} push attempts "
          f"({snap})")
    obj = ls_objective_exact(torch, X, y, run["w"])
    ratio = obj / tau0["objective"]
    check(ratio <= REPLICA_OBJECTIVE_RATIO,
          f"replica (c): objective {ratio}x the τ=0 run's")
    hist = {}
    for st in accepted:
        hist[st] = hist.get(st, 0) + 1
    return {"tau": REPLICA_TAU, "applied_steps": REPLICA_STEPS,
            "applied_steps_per_s": REPLICA_STEPS / run["wall_s"],
            "launches": launched, "push_attempts": attempts,
            "pushes_rejected": snap["pushes_rejected"],
            "pushes_after_done": snap["pushes_after_done"],
            "accepted_staleness_histogram": {str(k): v for k, v in
                                             sorted(hist.items())},
            "objective": obj, "tau0_objective": tau0["objective"],
            "objective_ratio": ratio}


def replica_compressed(torch, tst, ck, X, y):
    """(d): the top-k wire (``REPLICA_TOPK``) on the prefix at τ=0
    (``REPLICA_TOPK_ROUNDS`` rounds) and τ=2 (``REPLICA_TOPK_STEPS``
    applied steps), each at most 1.01x the objective of the synchronous
    dense run on the prefix at ``REPLICA_TOPK_ROUNDS`` iterations (the JAX
    package's matched-objective rule; the single-device run, whose
    batches are the τ=0 round's 8 x 10% of 125,000 rows in size); the
    wire's physical bytes 2k/d of its logical bytes (about 2·frac), by
    ``record_wire``."""
    from tpu_sgd_torch.io.sparse_wire import parse_wire_compress, topk_nnz
    from tpu_sgd_torch.obs import counters, spans

    frac = parse_wire_compress(REPLICA_TOPK)
    Xp, yp = X[:REPLICA_PREFIX_ROWS], y[:REPLICA_PREFIX_ROWS]
    alg = tst.LinearRegressionWithSGD(0.5, REPLICA_TOPK_ROUNDS, None, FRAC)
    alg.set_schedule("off")  # a named route: no planner
    alg.optimizer.set_convergence_tol(0.0)
    ref = ls_objective_exact(torch, Xp, yp, alg.run((Xp, yp)).weights)
    out = {"dense_iterations": REPLICA_TOPK_ROUNDS, "dense_objective": ref}
    for tau, n in ((0, REPLICA_TOPK_ROUNDS), (REPLICA_TAU,
                                             REPLICA_TOPK_STEPS)):
        drv = _replica_driver(tst, "bernoulli", n, tau=tau) \
            .set_wire_compress(REPLICA_TOPK)
        spans.enable_tracing(_PushTrace())
        counters.enable()
        counters.reset()
        try:
            run = _replica_run(torch, ck, drv, Xp, yp, n)
            wire = counters.wire_ratios(counters.snapshot())
        finally:
            counters.disable()
            spans.disable_tracing()
        topk = wire.get("replica.wire.topk")
        check(topk is not None, f"replica (d) τ={tau}: no topk wire {wire}")
        # each push ships k int32 indices and k f32 values for d f32
        share = topk["physical_bytes"] / topk["logical_bytes"]
        want = 2 * topk_nnz(X.shape[1], frac) / X.shape[1]
        check(share == want, f"replica (d) τ={tau}: wire share {share}, "
              f"want {want} (2·frac = {2 * frac})")
        obj = ls_objective_exact(torch, Xp, yp, run["w"])
        check(obj <= REPLICA_OBJECTIVE_RATIO * ref,
              f"replica (d) τ={tau}: objective {obj / ref}x the dense "
              "run's")
        out[f"tau{tau}"] = {
            "applied": n, "objective": obj, "objective_ratio": obj / ref,
            "wire_physical_over_logical": share,
            "pushes": topk["n"],
            "ms_per_applied": run["ms_per_round"],
            "max_accepted_staleness":
                run["snap"]["max_accepted_staleness"]}
    return out


def replica_ha(torch, tst, ck, X, y, refs):
    """(e) on the prefix at τ=0, Bernoulli, each against (a)'s rank-order
    reference: a primary and a standby built directly (listeners on
    both), the standby bitwise the primary at every version; through the
    driver with ``set_standbys(1)``, fault-free and with
    ``kill_primary()`` fired mid-run from a ``threading.Timer``, both
    bitwise, each under the armed detectors (phase ``obs`` (b), then (c)
    on the killed run's trace); the sharded store at S = 4, bitwise (so
    S = 1)."""
    import threading

    from tpu_sgd_torch.replica import (ParameterStore, ReplicaWorker,
                                       StoreSupervisor)
    from tpu_sgd_torch.utils.events import CollectingListener

    Xp, yp = X[:REPLICA_PREFIX_ROWS], y[:REPLICA_PREFIX_ROWS]
    w_ref, h_ref = refs["bernoulli"]

    def same(run):
        return (torch.equal(run["w"], w_ref)
                and np.array_equal(run["h"], h_ref))

    cfg = tst.SGDConfig(step_size=0.5, num_iterations=REPLICA_ROUNDS,
                        mini_batch_fraction=FRAC, convergence_tol=0.0)
    lis = [CollectingListener(), CollectingListener()]
    registry = {}
    stores = [ParameterStore(tst.SimpleUpdater(), cfg,
                             torch.zeros(X.shape[1], device=X.device),
                             listener=lis[k], ef_registry=registry,
                             name=f"s{k}")
              for k in range(2)]
    sup = StoreSupervisor(stores)
    client = sup.client()
    workers = [ReplicaWorker(f"w{s}", s, client, tst.LeastSquaresGradient(),
                             cfg, Xs, ys)
               for s, (Xs, ys) in enumerate(_prefix_shards(X, y))]
    for s in range(REPLICA_WORKERS):
        client.register_worker(f"w{s}", s)
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    check(not any(t.is_alive() for t in threads), "replica (e): a hung "
          "worker")
    sup.stop()
    events = [[(e.iteration, e.loss, e.weight_delta_norm)
               for e in li.iterations] for li in lis]
    standby_same = (events[0] == events[1]
                    and len(events[0]) == REPLICA_ROUNDS
                    and torch.equal(stores[0].weights, stores[1].weights)
                    and torch.equal(stores[0].weights, w_ref))
    check(standby_same, "replica (e): the standby is not the primary at "
          "every version")
    out = {"standby_bitwise_every_version": standby_same}

    # phase obs (b): the fault-free and the killed HA runs each under the
    # armed detectors and the flight recorder; (c) reads the killed run's
    # trace with the CLIs
    with tempfile.TemporaryDirectory() as tmp:
        armed = {}
        with armed_obs(tmp, "free") as armed["free"]:
            free = _replica_run(torch, ck, _replica_driver(
                tst, "bernoulli", REPLICA_ROUNDS).set_standbys(1), Xp, yp,
                REPLICA_ROUNDS)
        check(same(free), "replica (e): the fault-free HA run is not the "
              "single store's")
        check(armed["free"]["trips"] == {}
              and not os.path.exists(armed["free"]["flightrec"]),
              f"obs (b): the fault-free HA run tripped "
              f"{armed['free']['trips']}")
        out["fault_free_bitwise"] = True
        out["fault_free_ms_per_round"] = free["ms_per_round"]
        kill = None
        for i, share in enumerate(REPLICA_KILL_SHARES):
            drv = _replica_driver(tst, "bernoulli", REPLICA_ROUNDS) \
                .set_standbys(1)
            timer = threading.Timer(share * free["wall_s"], drv.kill_primary)
            with armed_obs(tmp, f"kill{i}") as armed[f"kill{i}"]:
                timer.start()
                try:
                    run = _replica_run(torch, ck, drv, Xp, yp, REPLICA_ROUNDS)
                finally:
                    timer.cancel()
            fo = drv.last_failover_snapshot
            if fo["failovers"]:
                kill = (share, run, fo)
                armed["kill"] = armed[f"kill{i}"]
                break
        check(kill is not None, "replica (e): no timer landed inside the run")
        share, run, fo = kill
        rec = fo["records"][0]
        check(fo["failovers"] == 1 and not rec["cold_recovery"]
              and same(run), f"replica (e): the killed run {fo} is not the "
              "fault-free run")
        out["kill_primary"] = {"bitwise": True, "timer_share": share,
                               "old_version": rec["old_version"],
                               "gap_replayed": rec["gap_replayed"],
                               "epoch": run["snap"]["epoch"]}
        trips = armed["kill"]["trips"]
        check(trips.get("failover") == fo["failovers"],
              f"obs (b): trips {trips} for {fo['failovers']} failover(s)")
        check(os.path.exists(armed["kill"]["flightrec"]),
              "obs (b): no flight-recorder dump")
        with open(armed["kill"]["flightrec"]) as f:
            meta = json.loads(f.readline())
        check(meta.get("kind") == "flightrec_meta"
              and meta.get("reason") == "alert:failover",
              f"obs (b): the flight recorder's trigger is {meta}")
        out["obs"] = {
            "window_s": OBS_WINDOW_S,
            "fault_free_trips": armed["free"]["trips"],
            "kill_trips": trips, "failovers": fo["failovers"],
            "flightrec_trigger": meta["reason"],
            "flightrec_detail": meta.get("detail"),
            "runs_timed_with_the_layer_on": ["fault_free_ms_per_round"],
            "added_seconds": sum(a["overhead_s"] for k, a in armed.items()
                                 if k != "kill")}
        out["obs"]["clis"] = obs_clis(armed["kill"]["trace"], tmp)
    sharded = _replica_run(torch, ck, _replica_driver(
        tst, "bernoulli", REPLICA_ROUNDS).set_store_shards(4), Xp, yp,
        REPLICA_ROUNDS)
    check(same(sharded) and sharded["snap"]["store_shards"] == 4,
          "replica (e): the sharded store at S = 4 is not S = 1")
    _replica_launches(sharded, "bernoulli",
                      REPLICA_WORKERS * REPLICA_ROUNDS, "(e) sharded")
    out["sharded_s4_bitwise_s1"] = True
    return out


def replica_supervised(torch, tst, ck, X, y):
    """(f): a stop requested by the event of round ``REPLICA_STOP_AT``
    through ``TrainingSupervisor``, then the resume from its checkpoint,
    bitwise the uninterrupted run of ``REPLICA_STOP_ROUNDS`` rounds."""
    from tpu_sgd_torch.reliability import TrainingSupervisor
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    Xp, yp = X[:REPLICA_PREFIX_ROWS], y[:REPLICA_PREFIX_ROWS]
    whole = _replica_run(torch, ck, _replica_driver(
        tst, "bernoulli", REPLICA_STOP_ROUNDS), Xp, yp, REPLICA_STOP_ROUNDS)
    w0 = torch.zeros(X.shape[1], device=X.device)
    with tempfile.TemporaryDirectory() as tmp:
        drv = _replica_driver(tst, "bernoulli", REPLICA_STOP_ROUNDS)
        sup = TrainingSupervisor(drv, checkpoint_manager=CheckpointManager(
            tmp), checkpoint_every=5, install_signal_handlers=False)
        drv.set_listener(_stop_listener(at=REPLICA_STOP_AT,
                                        on_stop=sup.request_preempt))
        first = sup.run((Xp, yp), w0)
        drv.set_listener(None)
        saved = CheckpointManager(tmp).latest_version()
        second = sup.run((Xp, yp), w0)
    stopped = first.preempted_at
    same = (second.completed
            and torch.equal(second.weights, whole["w"])
            and np.array_equal(second.loss_history, whole["h"]))
    check(first.status == "preempted" and stopped is not None
          and REPLICA_STOP_AT <= stopped < REPLICA_STOP_ROUNDS
          and saved == stopped and same,
          f"replica (f): stopped at {stopped} ({first.status}), saved "
          f"{saved}, resume bitwise {same}")
    return {"rounds": REPLICA_STOP_ROUNDS, "stop_requested_at":
            REPLICA_STOP_AT, "stopped_at": stopped,
            "resume_bitwise": same}


def replica_b1_row(torch, ck, tst, X, y, reps=50):
    """B1 at a worker's shard (1.25M rows of X, a 10% mask) launched by
    ``REPLICA_WORKERS`` threads at once, each on its own shard, as the
    replica workers launch it.  ``ms`` is the card's busy time a launch
    (``torch.profiler``'s device time of every kernel in one such turn,
    over its launches): the kernel's own time.  ``concurrent_wall_ms`` is
    the CUDA events' time around all the threads' launches, a launch,
    which also holds the gaps where the threads do not keep the card fed.
    Beside them the same launches from one thread, the plain version, the
    library yardstick (``index_select`` of the live rows and two matmuls)
    and the bound."""
    import threading

    from torch.profiler import ProfilerActivity, profile as trace

    pw = tst.LeastSquaresGradient().pointwise
    n, d = X.shape
    rows = n // REPLICA_WORKERS
    gen = torch.Generator(device="cuda").manual_seed(33)
    w = torch.randn(d, generator=gen, device="cuda") / math.sqrt(d)
    shards = [(X[s * rows:(s + 1) * rows], y[s * rows:(s + 1) * rows],
               torch.rand(rows, generator=gen, device="cuda") < FRAC)
              for s in range(REPLICA_WORKERS)]
    worst, scale = 0.0, 0.0
    for Xs, ys, m in shards:
        ok, err, sc = _close(torch, ck.fused_gradient_sums(pw, Xs, ys, w, m),
                             ck.fused_gradient_sums_plain(pw, Xs, ys, w, m),
                             True)
        check(ok, f"replica B1 shard: max|dg|={err} of {sc}")
        worst, scale = max(worst, err), max(scale, sc)

    def concurrent():
        barrier = threading.Barrier(REPLICA_WORKERS + 1)

        def launch(Xs, ys, m):
            barrier.wait()
            for _ in range(reps):
                ck.fused_gradient_sums(pw, Xs, ys, w, m)

        threads = [threading.Thread(target=launch, args=sh)
                   for sh in shards]
        for t in threads:
            t.start()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        barrier.wait()
        for t in threads:
            t.join(timeout=120)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * REPLICA_WORKERS)

    def serial():
        for Xs, ys, m in shards:
            ck.fused_gradient_sums(pw, Xs, ys, w, m)

    concurrent()  # warm: each thread's first call
    turns = [concurrent(), concurrent()]
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        concurrent()
    busy = (sum(device_ms_by_kernel(torch, prof).values())
            / (reps * REPLICA_WORKERS))
    check(busy > 0, "replica B1 row: the trace holds no device time")
    Xs, ys, m = shards[0]
    sel = int(m.sum())
    idx = torch.nonzero(m).squeeze(1)
    wb = w.to(X.dtype)
    coeff = torch.randn(sel, device="cuda").to(X.dtype)

    def library():
        Xl = Xs.index_select(0, idx)
        return Xl @ wb, coeff @ Xl

    bound, by = _bound_ms(sel, d, X.element_size(), rows)
    return {"name": "fused_gradient_sums",
            "path": f"replica (a worker's {rows:,}-row shard, 10% mask, "
                    f"{REPLICA_WORKERS} threads launching at once)",
            "source": WINDOW_SOURCE,
            "route": ck.gradient_sums_route(Xs, True), "shape": [rows, d],
            "selected_rows": sel, "max_abs_err": worst, "grad_scale": scale,
            "ms": busy, "ms_from": "torch.profiler device time a launch",
            "concurrent_wall_ms": sum(turns) / len(turns),
            "concurrent_wall_turns_ms": turns,
            "one_thread_ms": time_ms(torch, serial, reps) / REPLICA_WORKERS,
            "plain_ms": time_ms(torch, lambda: ck.fused_gradient_sums_plain(
                pw, Xs, ys, w, m), 2),
            "library_ms": time_ms(torch, library, reps),
            "library_includes": ("index_select of the live rows, then two "
                                 "matmuls over them"),
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / busy}


def phase_replica(torch, tst, ck, X, y, profile):
    """Phase ``replica``: async replicated training (``tpu_sgd_torch.
    replica``) at config 4's width on phase ``full``'s resident 10M x 1000
    bf16 matrix (no copy: each worker's rows are a view of X), 8 workers
    as threads on the one card, each launching B1 (Bernoulli) or B2
    (sliced) once a push: (a) ``replica_prefix``, (b) ``replica_full``,
    (c) ``replica_async``, (d) ``replica_compressed``, (e) ``replica_ha``,
    (f) ``replica_supervised``; then B1 timed under 8 threads' concurrent
    launches (``replica_b1_row``).  Returns the report and that row, its
    launches those of (b)'s Bernoulli run."""
    t0 = time.perf_counter()
    out = {"workers": REPLICA_WORKERS, "rows": X.shape[0],
           "prefix_rows": REPLICA_PREFIX_ROWS}
    parts = {}
    t = time.perf_counter()
    out["a_prefix"], refs = replica_prefix(torch, tst, ck, X, y)
    parts["a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["b_full"] = replica_full(torch, tst, ck, X, y, profile)
    parts["b"] = time.perf_counter() - t
    t = time.perf_counter()
    out["c_async"] = replica_async(torch, tst, ck, X, y,
                                   out["b_full"]["long"])
    parts["c"] = time.perf_counter() - t
    t = time.perf_counter()
    out["d_compressed"] = replica_compressed(torch, tst, ck, X, y)
    parts["d"] = time.perf_counter() - t
    t = time.perf_counter()
    out["e_ha"] = replica_ha(torch, tst, ck, X, y, refs)
    parts["e"] = time.perf_counter() - t
    t = time.perf_counter()
    out["f_supervised"] = replica_supervised(torch, tst, ck, X, y)
    parts["f"] = time.perf_counter() - t
    row = replica_b1_row(torch, ck, tst, X, y)
    row["launches"] = out["b_full"]["bernoulli"]["launches"][
        "fused_gradient_sums"]
    row["launches_from"] = "phase replica (b), Bernoulli"
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "replica", **out, "b1_row": row})
    return out, row


# -- phase 10: host-streamed SGD ---------------------------------------------

#: rows of the prefix that the bitwise contracts of leg (c) run on
STREAM_PREFIX_ROWS = 1_000_000
STREAM_ITERS = 20
# leg (b)'s timing runs, a mode each (and phase plan (e)'s run): cut in
# depth for the script's time
STREAM_SAMPLED_ITERS = 6
STREAM_TRACED_ITERS = 2     # leg (b)'s traced runs, cut in depth for time
STREAMED_QN_ITERS = 5       # leg (a) of phase streamed_qn
# leg (b): OWL-QN over the first 2M host rows, cut in depth for time
STREAMED_OWLQN_ROWS, STREAMED_OWLQN_ITERS = 2_000_000, 3
# leg (d): the resumed builds over the first 1M rows in 8-block chunks
RESUME_ROWS, RESUME_BATCH_ROWS = 1_000_000, 8 * 8192
STREAM_STOP_AT = 13
SPARSE_STREAM_ITERS = 30    # cut from 60 in depth for the script's time
#: host bytes kept free beside the host copy of X and the staging ring
HOST_SLACK_BYTES = 8 << 30


def _mem_available() -> int:
    """``MemAvailable`` of ``/proc/meminfo``, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _rss_bytes() -> dict:
    """The process's resident host memory now and at its peak."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) * 1024
    return {"rss_bytes": now,
            "peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024}


def _stream_opt(tst, mode, frac, iters, *, k=1, c=0, R=0, depth=2, wc=None,
                gradient=None, updater=None, step=0.5, retry=None):
    opt = tst.GradientDescent(gradient or tst.LeastSquaresGradient(),
                              updater)
    opt.set_num_iterations(iters).set_step_size(step) \
        .set_mini_batch_fraction(frac).set_sampling(mode) \
        .set_convergence_tol(0.0).set_host_streaming(True, resident_rows=R) \
        .set_ingest_options(prefetch_depth=depth, wire_compress=wc,
                            retry=retry).set_superstep(k)
    if c:
        opt.set_residency(c)
    return opt


class IngestSink:
    """A trace sink that adds up what a streamed feed reports
    (``optimize/streamed.py``, ``io/prefetch.py``): the worker's produce
    and checksum spans, the ring's pinned bytes and its copies' bytes and
    card ms."""

    def __init__(self):
        self.n = {"ingest.produce": 0, "ingest.checksum": 0}
        self.secs = {"ingest.produce": 0.0, "ingest.checksum": 0.0}
        self.h2d_bytes = 0
        self.h2d_ms = 0.0
        self.pinned_bytes = 0

    def emit(self, kind, payload):
        name = payload["name"]
        if kind == "trace_span" and name in self.n:
            self.n[name] += 1
            self.secs[name] += payload["dur_s"]
        elif name == "ingest.h2d":
            self.h2d_bytes += payload["bytes"]
            self.h2d_ms += payload["ms"]
        elif name == "ingest.ring":
            self.pinned_bytes = max(self.pinned_bytes,
                                    payload["pinned_bytes"])

    def report(self) -> dict:
        batches = self.n["ingest.produce"]
        per = (lambda s: 1e3 * s / batches) if batches else (lambda s: 0.0)
        return {"batches": batches,
                "assembly_ms_per_batch": per(self.secs["ingest.produce"]),
                "checksum_ms_per_batch": per(self.secs["ingest.checksum"]),
                "h2d_bytes": self.h2d_bytes, "h2d_ms": self.h2d_ms,
                "h2d_gb_per_s": (self.h2d_bytes / (1e6 * self.h2d_ms)
                                 if self.h2d_ms else None),
                "pinned_bytes": self.pinned_bytes}


def _streamed_run(torch, ck, opt, X, y, w0, iters, *, profile_iters=0):
    """One streamed run: weights, history, wall ms an iteration, launches
    of the dense and CSR wrappers (counts set to 0 just before), what the
    feed reported with counters and tracing on (wire bytes; assembly,
    checksum and copy times), peak device bytes; with ``profile_iters``
    also a shorter profiled run for device ms (kernels and copies apart)
    and the idle share."""
    from tpu_sgd_torch.obs import counters, spans

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sink = IngestSink()
    counters.enable()
    counters.reset()
    spans.enable_tracing(sink)
    try:
        t = time.perf_counter()
        w, hist = opt.optimize_with_history((X, y), w0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        wire = counters.wire_ratios()
    finally:
        spans.disable_tracing()
        counters.disable()
        counters.reset()
    stats = sink.report()
    logical = sum(r["logical_bytes"] for r in wire.values())
    physical = sum(r["physical_bytes"] for r in wire.values())
    out = {"weights": w, "history": hist,
           "wall_ms_per_iteration": 1e3 * secs / iters,
           "launches": ck.launch_counts(),
           "csr_launches": ck.csr_launch_counts(),
           "csr_column_launches": ck.csr_launch_counts(by_columns=True),
           "ingest": stats,
           "wire_logical_bytes_per_iteration": logical / iters,
           "wire_physical_bytes_per_iteration": physical / iters,
           "peak_extra_device_bytes":
               torch.cuda.max_memory_allocated() - base}
    if profile_iters:
        from torch.profiler import ProfilerActivity, profile

        opt.set_num_iterations(profile_iters)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            opt.optimize_with_history((X, y), w0)
            torch.cuda.synchronize()
            traced = 1e3 * (time.perf_counter() - t) / profile_iters
        opt.set_num_iterations(iters)
        per = {k: v / profile_iters
               for k, v in device_ms_by_kernel(torch, prof).items()}
        copies = sum(v for k, v in per.items() if k.startswith("Memcpy"))
        kernels = sum(v for k, v in per.items()
                      if not k.startswith(("Memcpy", "Memset")))
        out.update({
            "traced_wall_ms_per_iteration": traced,
            "device_kernel_ms_per_iteration": kernels,
            "device_copy_ms_per_iteration": copies,
            "idle_share": max(0.0, 1 - kernels / traced),
            "top_device_ms": dict(sorted(per.items(),
                                         key=lambda kv: -kv[1])[:6])})
    return out


def _same(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a["weights"].cpu()),
                               np.asarray(b["weights"].cpu()))
                and np.array_equal(a["history"], b["history"]))


def _report(r) -> dict:
    return {k: v for k, v in r.items() if k not in ("weights", "history")}


def streamed_full_batch(torch, tst, ck, Xh, yh, X, y):
    """Leg (a): 3 full-batch iterations streamed from the host rows
    against the resident run on the same X; the streamed side sends X once
    and runs B1 masked (its valid mask, all True), the resident side runs
    B1 unmasked."""
    iters = 3
    w0 = torch.zeros(X.shape[1], device="cuda")
    got = _streamed_run(torch, ck, _stream_opt(tst, "bernoulli", 1.0, iters),
                        Xh, yh, w0, iters)
    check(got["launches"]["fused_gradient_sums"] == iters,
          f"(a) streamed B1 launches {got['launches']}")
    ck.reset_launch_counts()
    ref = tst.GradientDescent().set_num_iterations(iters).set_step_size(0.5) \
        .set_mini_batch_fraction(1.0).set_convergence_tol(0.0)
    w_ref, h_ref = ref.optimize_with_history((X, y), w0)
    check(ck.launch_counts()["fused_gradient_sums"] == iters,
          f"(a) resident B1 launches {ck.launch_counts()}")
    rel = np.abs(got["history"] - h_ref) / np.abs(h_ref)
    dw = (got["weights"] - w_ref).abs()
    scale = float(w_ref.abs().max())
    check(bool(np.all(rel <= 2e-4)), f"(a) loss rel {rel}")
    check(bool(torch.all(dw <= 2e-3 + 2e-4 * w_ref.abs())),
          f"(a) weights max |dw| {float(dw.max())} of {scale}")
    return _report(got) | {
        "streamed_b1": "masked (valid all True)", "resident_b1": "unmasked",
        "loss_max_rel": float(rel.max()), "weights_max_abs_diff":
            float(dw.max()), "weights_scale": scale}


#: phase streamed (b)'s Bernoulli run, for phase plan (e)
LEG_B_RUNS = {}


def streamed_sampled(torch, tst, ck, Xh, yh):
    """Leg (b): Bernoulli, indexed and sliced at frac 0.1,
    ``STREAM_SAMPLED_ITERS`` iterations each at the full rows, then a
    ``STREAM_TRACED_ITERS``-iteration traced run of each."""
    w0 = torch.zeros(Xh.shape[1], device="cuda")
    out = {}
    for mode in ("bernoulli", "indexed", "sliced"):
        r = _streamed_run(torch, ck, _stream_opt(tst, mode, FRAC,
                                                 STREAM_SAMPLED_ITERS),
                          Xh, yh, w0, STREAM_SAMPLED_ITERS,
                          profile_iters=STREAM_TRACED_ITERS)
        h = r["history"]
        check(len(h) == STREAM_SAMPLED_ITERS
              # graftlint: disable=host-sync -- chip check: reads each case back to compare it
              and bool(np.all(np.isfinite(h))) and h[-1] < h[0],
              f"(b) {mode}: history {h}")
        check(r["launches"]["fused_gradient_sums"] == STREAM_SAMPLED_ITERS,
              f"(b) {mode}: B1 launches {r['launches']}")
        out[mode] = _report(r) | _rss_bytes() | {
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            "loss_first": float(h[0]), "loss_last": float(h[-1])}
        if mode == "bernoulli":
            # phase plan (e) meets this run's weights and history
            LEG_B_RUNS["bernoulli"] = {"weights": r["weights"],
                                       "history": h}
    return out


def _slow_ring_check(torch):
    """The ring's slot reuse on the card: a 2-slot feed whose step sleeps
    on the card before it reads its slot; without the FREE wait the copy
    of item j + 2 would overwrite slot j before the step read it."""
    from tpu_sgd_torch.io import PinnedRing, Prefetcher

    ring = PinnedRing({"x": ((1 << 20,), torch.float32)}, 2,
                      torch.device("cuda"))

    def produce(j):
        slot = j % 2
        ring.claim(slot)["x"].fill_(float(j))
        ring.send(slot, [(ring.dev[slot]["x"], ring.host[slot]["x"])])
        return slot, j

    sums = []
    with Prefetcher(produce, range(12), depth=2) as feed:
        for slot, j in feed:
            x = ring.take(slot)["x"]
            torch.cuda._sleep(20_000_000)  # ~10 ms on the card
            sums.append((x.sum(), j))
            ring.release(slot)
    ring.drain()
    ok = all(float(s) == j * (1 << 20) for s, j in sums)
    check(ok, "the pinned ring refilled a slot its step still read")
    return ok


def streamed_contracts(torch, tst, ck, Xh, yh):
    """Leg (c): the bitwise contracts, on the first ``STREAM_PREFIX_ROWS``
    host rows."""
    from tpu_sgd_torch.optimize.streamed import (HostSampler,
                                                 resident_window_probability)
    from tpu_sgd_torch.reliability import (RetryPolicy, TrainingPreempted,
                                           corrupt_nth, fail_nth,
                                           inject_faults)
    from tpu_sgd_torch.reliability import failpoints as fp
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    Xp, yp = Xh[:STREAM_PREFIX_ROWS], yh[:STREAM_PREFIX_ROWS]
    n = Xp.shape[0]
    w0 = torch.zeros(Xp.shape[1], device="cuda")
    N = 32
    out = {"rows": n, "ring_slot_reuse_ok": _slow_ring_check(torch)}

    def run(opt, iters=N):
        return _streamed_run(torch, ck, opt, Xp, yp, w0, iters)

    base = run(_stream_opt(tst, "bernoulli", FRAC, N))
    out["prefetch_2_vs_0"] = _same(base, run(_stream_opt(
        tst, "bernoulli", FRAC, N, depth=0)))
    k8 = run(_stream_opt(tst, "bernoulli", FRAC, N, k=8))
    out["bernoulli_k1_vs_k8"] = _same(base, k8)
    full = [run(_stream_opt(tst, "bernoulli", 1.0, N, **kw))
            for kw in ({}, {"k": 8}, {"k": 8, "c": 4})]
    out["full_batch_k1_vs_k8_vs_k8_c4"] = (_same(full[0], full[1])
                                           and _same(full[0], full[2]))
    slab = [run(_stream_opt(tst, "sliced", FRAC, N, R=n, **kw))
            for kw in ({}, {"k": 8}, {"k": 8, "c": 4})]
    out["resident_slab_k1_vs_k8_vs_k8_c4"] = (_same(slab[0], slab[1])
                                              and _same(slab[0], slab[2]))
    N_R = 40
    r0 = run(_stream_opt(tst, "sliced", FRAC, N_R), N_R)
    rh = run(_stream_opt(tst, "sliced", FRAC, N_R, R=n // 2), N_R)
    cfg = tst.SGDConfig(num_iterations=N_R, mini_batch_fraction=FRAC,
                        sampling="sliced", seed=42)
    sampler = HostSampler(cfg, n, n // 2)
    resident = sum(sampler.draw(i)[0] == "resident"
                   for i in range(1, N_R + 1))
    p = resident_window_probability(n, FRAC, n // 2)
    window_bytes = round(FRAC * n) * Xp.shape[1] * 2
    sent_windows = (rh["ingest"]["h2d_bytes"]
                    - (n // 2) * Xp.shape[1] * 2
                    - N_R * round(FRAC * n) * 5) / window_bytes
    out["resident_half_vs_none"] = _same(r0, rh)
    out["resident_windows"] = {
        "resident": resident, "transferred": N_R - resident,
        "transferred_by_bytes": sent_windows,
        "expected_transferred": N_R * (1 - p), "probability": p}
    check(abs(sent_windows - (N_R - resident)) < 1e-6,
          f"(c) transferred windows {sent_windows} != {N_R - resident}")
    check(abs(resident - N_R * p) <= 4 * math.sqrt(N_R * p * (1 - p)) + 1,
          f"(c) {resident} resident windows, expected {N_R * p}")
    opt = _stream_opt(tst, "bernoulli", FRAC, N,
                      retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0))
    with inject_faults({"io.device_put": fail_nth(3),
                        "io.chunk": corrupt_nth(5)}):
        healed = run(opt)
        fired = (fp.triggers("io.device_put"), fp.triggers("io.chunk"))
    out["fault_heal"] = _same(base, healed) and fired == (1, 1)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        seen = {"i": 0}

        class Stop:
            def on_run_start(self, cfg):
                pass

            def on_iteration(self, e):
                seen["i"] = e.iteration

            def on_run_end(self, e):
                pass

        ref = run(_stream_opt(tst, "bernoulli", FRAC, STREAM_ITERS),
                  STREAM_ITERS)
        opt = _stream_opt(tst, "bernoulli", FRAC, STREAM_ITERS)
        opt.set_listener(Stop()).set_checkpoint(CheckpointManager(tmp),
                                                every=5)
        opt.set_stop_signal(lambda: seen["i"] >= STREAM_STOP_AT)
        try:
            opt.optimize_with_history((Xp, yp), w0)
            stopped = None
        except TrainingPreempted as e:
            stopped = e.iteration
        opt2 = _stream_opt(tst, "bernoulli", FRAC, STREAM_ITERS)
        opt2.set_checkpoint(CheckpointManager(tmp), every=5)
        resumed = run(opt2, STREAM_ITERS)
        out["stop_at_13_resume"] = stopped == STREAM_STOP_AT and _same(
            ref, resumed)
    comp = [run(_stream_opt(tst, "bernoulli", 1.0, N, wc="topk:0.01", **kw))
            for kw in ({"k": 8}, {"k": 8, "c": 4})]
    dense = full[1]
    out["topk_k8_vs_k8_c4"] = _same(comp[0], comp[1])
    out["topk_final_loss"] = float(comp[0]["history"][-1])
    out["dense_final_loss"] = float(dense["history"][-1])
    out["topk_over_dense_final_loss"] = (out["topk_final_loss"]
                                         / out["dense_final_loss"])
    for key in ("ring_slot_reuse_ok", "prefetch_2_vs_0", "bernoulli_k1_vs_k8",
                "full_batch_k1_vs_k8_vs_k8_c4",
                "resident_slab_k1_vs_k8_vs_k8_c4", "resident_half_vs_none",
                "fault_heal", "stop_at_13_resume", "topk_k8_vs_k8_c4"):
        check(out[key] is True, f"(c) {key} failed")
    out["launches_k8_replayed"] = k8["launches"]
    check(k8["launches"]["fused_gradient_sums"] == N,
          f"(c) K = 8 B1 launches {k8['launches']}")
    return out


def streamed_predict(torch, tst, Xh, X):
    """Leg (d): ``predict_streamed`` over the host rows against the
    resident ``predict`` of the same model."""
    w = torch.randn(X.shape[1], generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda") / math.sqrt(X.shape[1])
    model = tst.LinearRegressionModel(w, 0.25)
    t = time.perf_counter()
    got = model.predict_streamed(Xh)
    secs = time.perf_counter() - t
    ref = model.predict(X).cpu().numpy()
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    check(got.shape == ref.shape and err <= 1e-5 * scale + 1e-6,
          f"(d) predict_streamed max |d| {err} of {scale}")
    return {"rows": int(got.shape[0]), "seconds": secs,
            "max_abs_diff": err, "scale": scale}


def phase_streamed_dense(torch, tst, ck, X, y):
    """Phase ``streamed``, dense rows: phase ``full``'s X copied to the host
    once, into a memfd that phase ``mesh``'s ranks map too
    (``shared_host_rows``), then legs (a)-(d).  Returns ``(record, Xh, yh,
    fd)``."""
    n, d = X.shape
    x_bytes = n * d * X.element_size()
    ring_bytes = 2 * 2 * (round(FRAC * n) + 8 * int(math.sqrt(n))) * d * 2
    need = x_bytes + ring_bytes + HOST_SLACK_BYTES
    avail = _mem_available()
    check(avail >= need,
          f"phase streamed needs {need} host bytes (X {x_bytes}, staging "
          f"{ring_bytes}, slack {HOST_SLACK_BYTES}); {avail} are "
          f"available, {need - avail} short")
    t = time.perf_counter()
    Xh, fd = shared_host_rows(torch, X)
    yh = y.cpu()
    copy_s = time.perf_counter() - t
    out = {"host_copy_seconds": copy_s, "host_bytes": x_bytes,
           "host_map": "memfd, shared with phase mesh's ranks",
           "mem_available_before": avail}
    t = time.perf_counter()
    legs = (("a_full_batch", lambda: streamed_full_batch(
                torch, tst, ck, Xh, yh, X, y)),
            ("b_sampled", lambda: streamed_sampled(torch, tst, ck, Xh, yh)),
            ("c_contracts", lambda: streamed_contracts(torch, tst, ck, Xh,
                                                       yh)),
            ("d_predict", lambda: streamed_predict(torch, tst, Xh, X)))
    out["leg_seconds"] = {}
    for name, leg in legs:
        t_leg = time.perf_counter()
        out[name] = leg()
        out["leg_seconds"][name] = time.perf_counter() - t_leg
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    return out, Xh, yh, fd


# -- phase streamed_qn --------------------------------------------------------

def _rel_max(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def _same_run(torch, a, b) -> bool:
    """Two ``(weights, history)`` runs equal bit for bit."""
    return bool(torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


@contextlib.contextmanager
def counting_evaluations(scf):
    """Count the streamed CostFun's cost evaluations and sweeps inside the
    block (its methods wrapped on the instance, and unwrapped after: the
    wrappers hold the instance, a cycle that would keep its staging
    buffers alive until the garbage collector ran)."""
    counts = {"cost": 0, "sweep": 0}
    for name in counts:
        real = getattr(scf, f"{name}_sums")

        def wrapped(w, _real=real, _name=name):
            counts[_name] += 1
            return _real(w)

        setattr(scf, f"{name}_sums", wrapped)
    try:
        yield counts
    finally:
        for name in counts:
            delattr(scf, f"{name}_sums")


def b1_chunk_rows(torch, tst, ck, X, y, w, scf, routes):
    """B1 at the streamed CostFun's chunk shape (``b1_row``): a full chunk
    unmasked (its rule for every chunk but the tail) and the tail's mask,
    whose live rows are a prefix of the chunk: they fall to the first
    blocks of the grid alone (the split is by rows, not by live rows).
    Each row's launches are those of its route in ``routes``
    (``ck.gradient_route_counts`` of the run)."""
    cap = scf.cap
    Xc, yc = X[:cap], y[:cap]
    pw = tst.LogisticGradient().pointwise
    tail = scf.n - (scf.n_chunks - 1) * cap
    mask = torch.zeros(cap, dtype=torch.bool, device="cuda")
    mask[:tail] = True
    rows = [b1_row(torch, ck, pw, Xc, yc, w, None, "streamed_costfun_chunk",
                   50),
            b1_row(torch, ck, pw, Xc, yc, w, mask,
                   f"streamed_costfun_tail ({tail:,} live rows, a prefix)",
                   50)]
    for r in rows:
        r["launches"] = routes[r["route"]]
        r["launches_from"] = (f"streamed_qn (a), its first run: the "
                              f"{r['route']} route's calls")
    return rows


def streamed_qn_lbfgs(torch, tst, ck, X, y, Xh, yh, h2d_gb_s):
    """(a) Binary L-BFGS with logistic + L2, every cost evaluation and sweep
    streamed from the 10M host rows (default chunk), against the resident
    run; a second run bitwise, with the feed's events and the evaluations
    counted; a traced 2-iteration run; B1 at the chunk shape."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_sgd_torch.obs import spans

    d = X.shape[1]
    w0 = torch.zeros(d, device="cuda")

    def make():
        return tst.LBFGS(tst.LogisticGradient(), tst.SquaredL2Updater(),
                         reg_param=1e-4, convergence_tol=0.0,
                         max_num_iterations=STREAMED_QN_ITERS)

    ref = make().optimize_with_history((X, y), w0)
    opt = make().set_host_streaming(True)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = opt.optimize_with_history((Xh, yh), w0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = ck.launch_counts()
    by_source = ck.kernel_launch_counts()
    routes = ck.gradient_route_counts()
    hist = first[1]
    its = len(hist) - 1
    scf = opt._stream_costfun_entry[2]
    expect = scf.n_chunks * len(hist)
    # every chunk unmasked but a partial tail, which is masked
    masked = len(hist) if scf.n % scf.cap else 0
    check(its == STREAMED_QN_ITERS, f"(a): {its} iterations, {hist}")
    check(launches["fused_gradient_sums"] == expect
          and by_source == {"fused_sums": 0, "window_sums": expect}
          and routes == {"gather": masked, "window": expect - masked,
                         "fused_sums": 0},
          f"(a): launches {launches} / {by_source} / {routes}, expected "
          f"{expect} ({scf.n_chunks} chunks x {len(hist)} cost "
          f"evaluations, {masked} of them masked tails)")
    rel = _rel_max(hist, ref[1])
    check(len(ref[1]) == len(hist) and rel <= 2e-4,
          f"(a): history {hist} against the resident {ref[1]}")
    sink = IngestSink()
    spans.enable_tracing(sink)
    try:
        with counting_evaluations(scf) as counts:
            second = opt.optimize_with_history((Xh, yh), w0)
            torch.cuda.synchronize()
    finally:
        spans.disable_tracing()
    check(_same_run(torch, first, second),
          "(a): a second run is not bitwise the first")
    feed = sink.report()
    opt.set_max_num_iterations(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        opt.optimize_with_history((Xh, yh), w0)
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t) / 2
    per = {k: v / 2 for k, v in device_ms_by_kernel(torch, prof).items()}
    copies = sum(v for k, v in per.items() if k.startswith("Memcpy"))
    kernels = sum(v for k, v in per.items()
                  if not k.startswith(("Memcpy", "Memset")))
    pass_bytes = scf.n_chunks * scf.cap * (d * X.element_size() + 4)
    passes = (counts["cost"] + counts["sweep"]) / its
    row = b1_chunk_rows(torch, tst, ck, X, y, first[0], scf, routes)
    out = {"rows": scf.n, "chunk_rows": scf.cap, "chunks": scf.n_chunks,
           "iterations": its, "history": [float(h) for h in hist],
           "history_max_rel_vs_resident": rel, "launches": launches,
           "wall_ms_per_iteration": 1e3 * secs / its,
           "cost_evaluations": counts["cost"], "sweeps": counts["sweep"],
           "cost_evaluations_per_iteration": counts["cost"] / its,
           "sweeps_per_iteration": counts["sweep"] / its,
           "h2d_gb_per_s": feed["h2d_gb_per_s"],
           "h2d_bytes_per_pass": pass_bytes,
           "assembly_ms_per_chunk": feed["assembly_ms_per_batch"],
           "pinned_bytes": scf._ring.pinned_bytes,
           "traced_wall_ms_per_iteration": traced,
           "device_kernel_ms_per_iteration": kernels,
           "device_copy_ms_per_iteration": copies,
           "idle_share": max(0.0, 1 - kernels / traced),
           "top_device_ms": dict(sorted(per.items(),
                                        key=lambda kv: -kv[1])[:6]),
           "bound_ms_per_iteration":
               1e3 * passes * pass_bytes / (1e9 * h2d_gb_s),
           "bound_by": "h2d bytes at phase streamed's rate",
           "bitwise_repeat": True}
    out["share_of_bound"] = (out["bound_ms_per_iteration"]
                             / out["wall_ms_per_iteration"])
    opt.release_sufficient_stats()
    return out, row


def streamed_qn_owlqn(torch, tst, X, y, Xh, yh):
    """(b) OWL-QN with logistic + L1 streamed from the first
    ``STREAMED_OWLQN_ROWS`` host rows (cut in depth to keep the phase
    short), against the resident run on the same rows."""
    rows = STREAMED_OWLQN_ROWS
    w0 = torch.zeros(X.shape[1], device="cuda")

    def make():
        return tst.OWLQN(tst.LogisticGradient(), reg_param=1e-4,
                         convergence_tol=0.0,
                         max_num_iterations=STREAMED_OWLQN_ITERS)

    _, h_ref = make().optimize_with_history((X[:rows], y[:rows]), w0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    w, hist = make().set_host_streaming(True).optimize_with_history(
        (Xh[:rows], yh[:rows]), w0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    rel = _rel_max(hist, h_ref)
    check(len(hist) == len(h_ref) == STREAMED_OWLQN_ITERS + 1
          and rel <= 2e-4, f"(b): history {hist} against {h_ref}")
    return {"rows": rows, "iterations": len(hist) - 1,
            "history": [float(v) for v in hist],
            "history_max_rel_vs_resident": rel, "seconds": secs,
            "exact_zeros": int((w == 0).sum())}


def streamed_qn_statistics(torch, tst, ck, X, y_ls, Xh, yh_ls, gram,
                           h2d_gb_s):
    """(c) ``build_streamed`` from the 10M host rows against the resident
    ``build`` of the whole blocks (bitwise), its time against phase gram's
    resident build and the transfer bound, its peak; then
    ``set_streamed_stats`` for sliced SGD (bitwise the resident aligned
    run) and for L-BFGS (leg (e) of phase gram's objective)."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    n, d = X.shape
    B = GRAM_BLOCK
    n_use = (n // B) * B
    depth, chunk_rows = 2, 64 * B
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    g_s = tst.GramLeastSquaresGradient.build_streamed(Xh, yh_ls, block_rows=B)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    stack = g_s.data.PG.numel() * g_s.data.PG.element_size()
    staged = depth * chunk_rows * (d * X.element_size() + 4)
    check(peak < stack + 1e9 + staged,
          f"(c): build peak {peak} bytes, stack {stack}, staged {staged}")
    g_r = tst.GramLeastSquaresGradient.build(X[:n_use], y_ls[:n_use],
                                             block_rows=B, aligned=True)
    for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"):
        check(torch.equal(getattr(g_s.data, leaf), getattr(g_r.data, leaf)),
              f"(c): streamed {leaf} is not the resident build's")
    check(g_s.data.shape == (n_use, d), f"(c): shape {g_s.data.shape}")
    del g_s
    torch.cuda.empty_cache()
    moved = n_use * (d * X.element_size() + 4)
    w0 = torch.zeros(d, device="cuda")

    def gd():
        return tst.GradientDescent().set_num_iterations(ITERS) \
            .set_step_size(0.5).set_mini_batch_fraction(FRAC) \
            .set_sampling("sliced").set_convergence_tol(0.0)

    o = gd().set_streamed_stats(True)
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = o.optimize_with_history((Xh, yh_ls), w0)
    torch.cuda.synchronize()
    gd_s = time.perf_counter() - t
    check(all(v == 0 for v in ck.launch_counts().values()),
          f"(c): the statistics launched kernels {ck.launch_counts()}")
    o.release_sufficient_stats()
    ref = tst.GradientDescent(g_r).set_num_iterations(ITERS) \
        .set_step_size(0.5).set_mini_batch_fraction(FRAC) \
        .set_sampling("sliced").set_convergence_tol(0.0) \
        .optimize_with_history((g_r.data.X, y_ls[:n_use]), w0)
    check(_same_run(torch, got, ref), "(c): set_streamed_stats SGD is not the "
          "resident aligned run")
    del g_r
    torch.cuda.empty_cache()
    lb = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                   max_num_iterations=QN_ITERS, convergence_tol=0.0) \
        .set_streamed_stats(True)
    t = time.perf_counter()
    w_lb, h_lb = lb.optimize_with_history((Xh, yh_ls), w0)
    torch.cuda.synchronize()
    lb_s = time.perf_counter() - t
    lb.release_sufficient_stats()
    L = full_objective(tst.LeastSquaresGradient(), X, y_ls, w_lb)
    L_e = gram["e_lbfgs"]["objective"]
    check(L <= L_e * (1 + 1e-4),
          f"(c): L-BFGS objective {L} > phase gram (e)'s {L_e} x (1 + 1e-4)")
    return {"block_rows": B, "rows_used": n_use, "build_s": build_s,
            "resident_build_warm_s": gram["a_build"]["warm_s"],
            "transfer_bound_s": moved / (1e9 * h2d_gb_s),
            "share_of_transfer_bound": moved / (1e9 * h2d_gb_s) / build_s,
            "stack_bytes": stack, "peak_allocated_bytes": peak,
            "peak_limit_bytes": stack + 1e9 + staged,
            "stack_equals_resident_bitwise": True,
            "sgd_seconds_with_build": gd_s,
            "sgd_equals_resident_aligned_bitwise": True,
            "sgd_loss_last": float(got[1][-1]),
            "lbfgs_seconds_with_build": lb_s,
            "lbfgs_iterations": len(h_lb) - 1, "lbfgs_objective": L,
            "gram_e_objective": L_e, "refs": {"c_lbfgs_w": w_lb}}


def streamed_qn_resume(torch, tst, Xh, yh):
    """(d) A streamed prefix build over the first ``RESUME_ROWS`` host rows
    stopped by a fault in its feed after its third chunk, then resumed:
    bitwise the uninterrupted build; the same for the totals through
    ``NormalEquations.set_host_streaming(resume_dir=)`` (stopped after a
    save)."""
    from tpu_sgd_torch.reliability import failpoints as fp

    Xr, yr = Xh[:RESUME_ROWS], yh[:RESUME_ROWS]
    kw = dict(block_rows=GRAM_BLOCK, batch_rows=RESUME_BATCH_ROWS)
    build = tst.GramLeastSquaresGradient.build_streamed
    ref = build(Xr, yr, **kw)
    w0 = np.zeros(Xh.shape[1], np.float32)

    def normal(**kw2):
        return tst.NormalEquations().set_host_streaming(
            True, batch_rows=RESUME_BATCH_ROWS, **kw2)

    w_ref = normal().optimize((Xr, yr), w0)
    out = {"rows": RESUME_ROWS, "chunk_rows": RESUME_BATCH_ROWS}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rd = os.path.join(tmp, "prefix")
        with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(4)}):
            try:
                build(Xr, yr, resume_dir=rd, **kw)
                stopped = False
            except fp.FaultInjected:
                stopped = True
        check(stopped, "(d): the prefix build did not stop")
        with open(os.path.join(rd, "meta.json")) as f:
            out["prefix_high_water_rows"] = json.load(f)["high_water_rows"]
        check(out["prefix_high_water_rows"] == 3 * RESUME_BATCH_ROWS,
              f"(d): stopped at {out['prefix_high_water_rows']} rows")
        got = build(Xr, yr, resume_dir=rd, **kw)
        for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"):
            check(torch.equal(getattr(got.data, leaf),
                              getattr(ref.data, leaf)),
                  f"(d): the resumed {leaf} is not the uninterrupted one")
        check(not os.path.exists(rd), "(d): the prefix parts remain")
        del got, ref
        rd = os.path.join(tmp, "totals")
        ne = normal(resume_dir=rd)
        with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(7)}):
            try:
                ne.optimize((Xr, yr), w0)
                stopped = False
            except fp.FaultInjected:
                stopped = True
        check(stopped, "(d): the totals pass did not stop")
        with np.load(os.path.join(rd, "totals.npz")) as z:
            out["totals_rows_done"] = int(z["rows_done"])
        check(out["totals_rows_done"] == 4 * RESUME_BATCH_ROWS,
              f"(d): totals saved at {out['totals_rows_done']} rows")
        w = ne.optimize((Xr, yr), w0)
        check(torch.equal(w, w_ref), "(d): the resumed normal solve is not "
              "the uninterrupted one")
    out["seconds"] = time.perf_counter() - t
    out["prefix_resumed_bitwise"] = out["totals_resumed_bitwise"] = True
    return out


def ls_objective_exact(torch, X, y, w, chunk=1_000_000) -> float:
    """The least-squares objective of ``w`` itself: margins of f32 ``w``
    over the rows upcast to f32, the squared residuals summed in f64.  The
    oracle's ``full_objective`` rounds ``w`` to X's bf16 (the kernels'
    mixed-precision contract), which moves the objective of two solves a
    few 1e-6 apart by about 1e-5 of itself."""
    total = 0.0
    w32 = w.to(torch.float32)
    for s in range(0, X.shape[0], chunk):
        r = X[s:s + chunk].to(torch.float32) @ w32 - y[s:s + chunk]
        total += float(torch.sum(r.double() ** 2))
    return 0.5 * total / X.shape[0]


def streamed_qn_normal(torch, tst, X, y_ls, Xh, yh_ls, qn_b, h2d_gb_s):
    """(e) The normal equations from host-streamed totals over the 10M host
    rows: leg (b)'s resident objective within (1 + 1e-5), both evaluated
    at their own f32 weights; two runs bitwise, seconds against the
    transfer bound."""
    from tpu_sgd_torch.optimize.oracle import full_objective

    n, d = X.shape
    w0 = torch.zeros(d, device="cuda")
    runs = []
    for _ in range(2):
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        t = time.perf_counter()
        w = tst.NormalEquations().set_host_streaming(True).optimize(
            (Xh, yh_ls), w0)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        runs.append((w, time.perf_counter() - t))
    check(torch.equal(runs[0][0], runs[1][0]),
          "(e): two streamed normal solves differ")
    L = ls_objective_exact(torch, X, y_ls, runs[0][0])
    L_b = ls_objective_exact(torch, X, y_ls, qn_b["weights"])
    check(L <= L_b * (1 + 1e-5),
          f"(e): objective {L} > leg (b)'s {L_b} x (1 + 1e-5)")
    bound = n * (d * X.element_size() + 4) / (1e9 * h2d_gb_s)
    return {"rows": n, "seconds": [r[1] for r in runs],
            "transfer_bound_s": bound,
            "share_of_transfer_bound": bound / runs[1][1], "objective": L,
            "resident_objective": L_b,
            "objective_bf16_weights": full_objective(
                tst.LeastSquaresGradient(), X, y_ls, runs[0][0]),
            "resident_objective_bf16_weights": qn_b["objective"],
            "bitwise_repeat": True, "refs": {"e_normal_w": runs[0][0]}}


def phase_streamed_qn(torch, tst, ck, X, y, w_true, Xh, qn_b, gram,
                      streamed):
    """Phase ``streamed_qn``, right after phase ``streamed`` on its host
    copy of the 10M x 1000 bf16 rows: legs (a)-(e).  Returns the phase's
    record, B1's rows at the streamed chunk shape, and what phase
    ``mesh`` (l), (m) meet: the labels on the host, (a)'s and (b)'s
    histories, (c)'s L-BFGS weights and (e)'s normal solution (host
    numpy)."""
    t0 = time.perf_counter()
    h2d = max(r["ingest"]["h2d_gb_per_s"]
              for r in streamed["b_sampled"].values())
    y_log = logistic_labels(torch, X, w_true)
    yh_log = y_log.cpu()
    y_ls = y.to(torch.bfloat16).to(torch.float32)
    yh_ls = y_ls.cpu()
    out = {"phase_streamed_h2d_gb_per_s": h2d, "leg_seconds": {}}
    legs = (("a_lbfgs", lambda: streamed_qn_lbfgs(
                torch, tst, ck, X, y_log, Xh, yh_log, h2d)),
            ("b_owlqn", lambda: streamed_qn_owlqn(
                torch, tst, X, y_log, Xh, yh_log)),
            ("c_statistics", lambda: streamed_qn_statistics(
                torch, tst, ck, X, y_ls, Xh, yh_ls, gram, h2d)),
            ("d_resume", lambda: streamed_qn_resume(torch, tst, Xh, yh_ls)),
            ("e_normal", lambda: streamed_qn_normal(
                torch, tst, X, y_ls, Xh, yh_ls, qn_b, h2d)))
    b1_rows = []
    refs = {"yh_ls": yh_ls, "yh_log": yh_log}
    for name, leg in legs:
        t = time.perf_counter()
        rec = leg()
        if name == "a_lbfgs":
            rec, b1_rows = rec
        refs.update({k: v.cpu().numpy() for k, v in
                     rec.pop("refs", {}).items()})
        out[name] = rec
        out["leg_seconds"][name] = time.perf_counter() - t
        emit({"phase": "streamed_qn", "leg": name, **rec})
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    refs["a_history"] = np.asarray(out["a_lbfgs"]["history"], np.float32)
    refs["b_history"] = np.asarray(out["b_owlqn"]["history"], np.float32)
    return out, b1_rows, refs


# -- phase plan ------------------------------------------------------------------

PLAN_LS_ROWS = 5_000_000    # (d): the prefix of phase full's rows it trains on
PLAN_MAX_ITERS = 5_000      # (d): the statistics build must amortize within
PLAN_BUILD_ROWS = 65_536    # the small build that reads the build's fixed cost
#: the streamed driver's dispatch tax: a full-batch feed of this prefix of
#: the host rows (one transfer, then iterations at the card's rate)
PLAN_DISPATCH_ROWS, PLAN_DISPATCH_ITERS = 65_536, 64
#: the schedules' stand-ins on config 4's shape (10M x 1000 bf16, frac 0.1)
#: for the estimate-against-measured line: a budget that holds the rows
#: and a B = 8,192 stack but not a B = 4,096 one (phase gram's block), and
#: a 12 GB one beyond them
PLAN_FIT_FREE = FULL_ROWS * (FULL_D * 2 + 4) + 6e9
PLAN_BEYOND_FREE = 12e9


@contextlib.contextmanager
def plan_log():
    """The messages of the planner's logger (``tpu_sgd_torch.plan``) while
    the block runs."""
    import logging

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg = logging.getLogger("tpu_sgd_torch.plan")
    handler, level = Lines(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)


def plan_calibration(torch):
    """(a) ``CostModel.calibrate()`` on the card: both probes accepted."""
    from tpu_sgd_torch.plan import CostModel

    t = time.perf_counter()
    with plan_log() as lines:
        cm = CostModel.calibrate()
    rep = cm.calibration_report
    check(not rep["hbm_fell_back"] and not rep["feed_fell_back"],
          f"plan (a): a calibration probe fell back: {rep} {lines}")
    default = CostModel()
    return cm, {"hbm_gb_s": cm.hbm_gb_s,
                "host_feed_raw_gb_s": cm.host_feed_gb_s, "report": rep,
                "defaults": {"hbm_gb_s": default.hbm_gb_s,
                             "host_feed_gb_s": default.host_feed_gb_s},
                "nvidia_smi": nvidia_smi_line(),
                "seconds": time.perf_counter() - t}


def plan_budget(torch):
    """(b) ``device_budget()`` against torch's own readings at that moment:
    ``(free + reserved - allocated) × hbm_safety``."""
    from tpu_sgd_torch.plan import DEFAULT_COST_MODEL, device_budget

    def read():
        free, total = torch.cuda.mem_get_info()
        return (free, torch.cuda.memory_reserved(),
                torch.cuda.memory_allocated(), total)

    torch.cuda.synchronize()
    before = read()
    got, source = device_budget()
    after = read()
    want = [max(0.0, (f + r - a) * DEFAULT_COST_MODEL.hbm_safety)
            for f, r, a, _ in (before, after)]
    check(source == "memory_stats" and got in want,
          f"plan (b): budget {got} ({source}), torch's readings give "
          f"{want}")
    return {"budget_bytes": got, "source": source, "free_bytes": before[0],
            "reserved_bytes": before[1], "allocated_bytes": before[2],
            "total_bytes": before[3],
            "hbm_safety": DEFAULT_COST_MODEL.hbm_safety}


def plan_zero_flag_sgd(torch, tst, ck, X, w_true):
    """(c) A zero-flag ``LogisticRegressionWithSGD.train`` on the 10M x
    1000 bf16 rows at frac 0.1 plans ``resident_stock`` and runs exactly
    one B1 launch an iteration; the zero-flag run is bitwise the
    ``set_schedule("off")`` run (weights and history)."""
    y_log = logistic_labels(torch, X, w_true)
    with plan_log() as lines:
        ck.reset_launch_counts()
        model = tst.LogisticRegressionWithSGD.train((X, y_log), ITERS, 1.0,
                                                    FRAC)
        torch.cuda.synchronize()
        launches = {"wrappers": ck.launch_counts(),
                    "sources": ck.kernel_launch_counts()}
    check(launches["wrappers"] == {"fused_gradient_sums": ITERS,
                                   "fused_window_sums": 0,
                                   "fused_window_sums_vpu": 0}
          and launches["sources"] == {"fused_sums": 0, "window_sums": ITERS},
          f"plan (c): launches {launches}")
    runs = {}
    for mode in ("auto", "off"):
        alg = tst.LogisticRegressionWithSGD(1.0, ITERS, 0.0, FRAC)
        alg.set_schedule(mode)
        runs[mode] = (alg.run((X, y_log)).weights,
                      alg.optimizer.loss_history, alg.optimizer.last_plan)
    p = runs["auto"][2]
    check(p is not None and p.schedule == "resident_stock"
          and runs["off"][2] is None, f"plan (c): plans {p}")
    check(bool(torch.equal(model.weights, runs["off"][0])
               and torch.equal(runs["auto"][0], runs["off"][0])
               and np.array_equal(runs["auto"][1], runs["off"][1])),
          "plan (c): the zero-flag run differs from schedule='off'")
    del y_log
    return {"plan_line": lines[0] if lines else None, "schedule": p.schedule,
            "launches": launches, "bitwise_schedule_off": True,
            "loss_last": float(runs["auto"][1][-1])}


def plan_zero_flag_gram(torch, tst, ck, X, y):
    """(d) Zero-flag least squares, sliced at frac 0.1, on the first
    ``PLAN_LS_ROWS`` rows at the full 1,000 columns, with enough
    iterations that the statistics build amortizes: the plan is
    ``resident_gram``, no fused launch, and the weights and history are
    bitwise those of the run that sets the statistics and the plan's block
    size by hand."""
    from tpu_sgd_torch.plan import plan_for

    Xp, yp = X[:PLAN_LS_ROWS], y[:PLAN_LS_ROWS]

    def alg(iters):
        a = tst.LinearRegressionWithSGD(0.5, iters, None, FRAC)
        a.optimizer.set_sampling("sliced").set_convergence_tol(0.0)
        return a

    probe = plan_for(alg(1).optimizer, Xp, yp)
    amortize = probe.estimates.get("build_amortize_iters", math.inf)
    check(amortize < PLAN_MAX_ITERS,
          f"plan (d): the build amortizes in {amortize} iterations")
    iters = max(ITERS, math.ceil(1.25 * amortize))
    a = alg(iters)
    with plan_log() as lines:
        ck.reset_launch_counts()
        t = time.perf_counter()
        w_auto = a.run((Xp, yp)).weights
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t
        launches = {"wrappers": ck.launch_counts(),
                    "sources": ck.kernel_launch_counts()}
    p = a.optimizer.last_plan
    h_auto = a.optimizer.loss_history
    a.optimizer.release_sufficient_stats()
    check(p is not None and p.schedule == "resident_gram",
          f"plan (d): planned {p and p.describe()}")
    check(sum(launches["wrappers"].values()) == 0
          and sum(launches["sources"].values()) == 0,
          f"plan (d): fused launches on statistics {launches}")
    b = alg(iters)
    b.set_schedule("off")
    b.optimizer.set_sufficient_stats(True).set_gram_options(
        block_rows=p.block_rows)
    w_hand = b.run((Xp, yp)).weights
    h_hand = b.optimizer.loss_history
    b.optimizer.release_sufficient_stats()
    check(bool(torch.equal(w_auto, w_hand)
               and np.array_equal(h_auto, h_hand)),
          "plan (d): the planned run differs from the hand-set statistics")
    return {"rows": PLAN_LS_ROWS, "iterations": iters,
            "build_amortize_iters": amortize, "plan_line": lines[0],
            "block_rows": p.block_rows, "launches": launches,
            "seconds_with_build": auto_s, "bitwise_hand_set": True}


def plan_build_overhead(torch, tst, X, y):
    """The statistics build's fixed cost: a ``PLAN_BUILD_ROWS``-row build
    (phase gram's block), warm."""
    Xs, ys = X[:PLAN_BUILD_ROWS], y[:PLAN_BUILD_ROWS]
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g = tst.GramLeastSquaresGradient.build(Xs, ys, block_rows=GRAM_BLOCK)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        del g
    return {"rows": PLAN_BUILD_ROWS, "block_rows": GRAM_BLOCK,
            "warm_s": min(secs[1:])}


def plan_dispatch_tax(torch, tst, Xh, yh):
    """The streamed driver's fixed host cost an iteration, which K fused
    steps divide: the full-batch feed of a ``PLAN_DISPATCH_ROWS``-row
    prefix (sent once, then iterating at the card's rate) at K = 1 and K =
    8, in turns (1, 8, 8, 1), the faster of each pair; the tax is
    (wall(K=1) - wall(K=8)) · 8/7."""
    Xp, yp = Xh[:PLAN_DISPATCH_ROWS], yh[:PLAN_DISPATCH_ROWS]
    w0 = torch.zeros(Xh.shape[1], device="cuda")
    walls = {1: [], 8: []}
    for k in (1, 8, 8, 1):
        opt = _stream_opt(tst, "bernoulli", 1.0, PLAN_DISPATCH_ITERS, k=k)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.optimize_with_history((Xp, yp), w0)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        walls[k].append(1e3 * (time.perf_counter() - t) / PLAN_DISPATCH_ITERS)
    w1, w8 = min(walls[1]), min(walls[8])
    return {"rows": PLAN_DISPATCH_ROWS, "iterations": PLAN_DISPATCH_ITERS,
            "walls_ms_per_iteration": {str(k): v for k, v in walls.items()},
            "dispatch_overhead_s": (w1 - w8) * 8 / 7 / 1e3}


def plan_beyond_budget(torch, tst, ck, Xh, yh, leg_b):
    """(e) Phase streamed's 20 GB of host rows under a cost model whose
    ``hbm_safety`` puts the budget at half their bytes: ``plan_for`` names
    a streaming schedule, and its applied run is bitwise the run with the
    same knobs set by hand (phase streamed (b)'s Bernoulli run, whose
    knobs match, else a run here)."""
    from tpu_sgd_torch.plan import CostModel, device_budget, plan_for

    n, d = Xh.shape
    iters = STREAM_SAMPLED_ITERS

    def base():
        return (tst.GradientDescent().set_num_iterations(iters)
                .set_step_size(0.5).set_mini_batch_fraction(FRAC)
                .set_sampling("bernoulli").set_convergence_tol(0.0))

    data_bytes = n * d * Xh.element_size() + 4.0 * n
    free, _ = device_budget(cost_model=CostModel(hbm_safety=1.0))
    safety = 0.5 * data_bytes / free
    opt = base()
    p = plan_for(opt, Xh, yh, cost_model=CostModel(hbm_safety=safety))
    check(p.schedule in ("partial_residency", "host_streamed",
                         "streamed_virtual_gram"),
          f"plan (e): {p.describe()}")
    p.apply(opt)
    w0 = torch.zeros(d, device="cuda")
    got = _streamed_run(torch, ck, opt, Xh, yh, w0, iters)
    matches_b = (p.schedule == "host_streamed" and p.superstep == 1
                 and p.residency == 0 and p.wire_compress is None
                 and p.prefetch_depth == 2 and p.wire_dtype is None)
    if matches_b:
        ref = leg_b
    else:
        hand = base().set_host_streaming(
            p.schedule != "streamed_virtual_gram",
            resident_rows=p.resident_rows).set_superstep(p.superstep) \
            .set_ingest_options(prefetch_depth=p.prefetch_depth)
        if p.residency:
            hand.set_residency(p.residency)
        if p.schedule == "streamed_virtual_gram":
            hand.set_streamed_stats(True).set_gram_options(
                block_rows=p.block_rows, batch_rows=p.batch_rows,
                aligned=True)
        ref = _streamed_run(torch, ck, hand, Xh, yh, w0, iters)
    check(_same(got, ref), "plan (e): the planned run differs from the "
          "hand-set knobs")
    return {"hbm_safety": safety, "budget_bytes": free * safety,
            "data_bytes": data_bytes, "plan_line": p.describe(),
            "schedule": p.schedule, "superstep": p.superstep,
            "reused_phase_streamed_b": matches_b, "iterations": iters,
            "wall_ms_per_iteration": got["wall_ms_per_iteration"],
            "bitwise_hand_set": True}


def plan_estimates(profile, gram, streamed, streamed_qn):
    """Each candidate schedule's estimate on config 4's shape (the default
    cost model) beside the wall an iteration this run measured on its
    route."""
    from tpu_sgd_torch.plan import plan

    kw = dict(itemsize=2, mini_batch_fraction=FRAC, num_iterations=10 ** 6)
    fit = plan(FULL_ROWS, FULL_D, gram_able=True, sampling="sliced",
               free_hbm=PLAN_FIT_FREE, **kw).estimates
    virt = plan(FULL_ROWS, FULL_D, gram_able=True, sampling="sliced",
                free_hbm=PLAN_BEYOND_FREE, **kw).estimates
    part = plan(FULL_ROWS, FULL_D, sampling="sliced",
                free_hbm=PLAN_BEYOND_FREE, **kw)
    host = plan(FULL_ROWS, FULL_D, sampling="bernoulli",
                free_hbm=PLAN_BEYOND_FREE, **kw).estimates
    walls = {m: r["wall_ms_per_iteration"]
             for m, r in streamed["b_sampled"].items()}

    def row(est_s, measured_ms, what):
        return {"estimate_ms": 1e3 * est_s, "measured_ms": measured_ms,
                "measured_over_estimate": measured_ms / (1e3 * est_s),
                "measured": what}

    c = streamed_qn["c_statistics"]
    return {
        "resident_stock": row(fit["stock_iter_s"],
                              profile["sliced"]["wall_ms_per_iteration"],
                              "phase profile, sliced (Bernoulli "
                              f"{profile['bernoulli']['wall_ms_per_iteration']}"
                              " ms)"),
        "resident_gram": row(fit["gram_iter_s"],
                             gram["c_sgd_exact"]["wall_ms_per_iteration"],
                             f"phase gram (c), exact, B={fit['block_rows']}"),
        "streamed_virtual_gram": row(
            virt["gram_iter_s"],
            gram["d_sgd_aligned"]["aligned"]["wall_ms_per_iteration"],
            "phase gram (d), aligned") | {
            "build_estimate_s": virt["gram_build_s"],
            "build_measured_s": c["build_s"],
            "build_measured": "phase streamed_qn (c), build_streamed"},
        "host_streamed": row(host["streamed_iter_s"], walls["bernoulli"],
                             "phase streamed (b), Bernoulli") | {
            "measured_ms_by_sampler": walls},
        "partial_residency": {
            "estimate_ms": None, "measured_ms": None,
            "resident_rows": part.resident_rows,
            "resident_window_p": part.estimates["resident_window_p"],
            "measured": "none: the planner estimates the transfer-free "
                        "share of windows, not a wall; phase streamed (c) "
                        "counts that share on its prefix"}}


def phase_plan(torch, tst, ck, X, y, w_true, Xh, yh, profile, gram,
               streamed, streamed_qn, leg_b):
    """Phase ``plan``, right after phase streamed_qn (phase full's rows
    still on the card, phase streamed's on the host): (a)-(e), the small
    build, and the estimates beside this run's walls.  (f) runs in phase
    configs.  Returns the record and the calibrated cost model."""
    t0 = time.perf_counter()
    out = {}
    cm, out["a_calibration"] = plan_calibration(torch)
    out["b_budget"] = plan_budget(torch)
    out["c_zero_flag_sgd"] = plan_zero_flag_sgd(torch, tst, ck, X, w_true)
    torch.cuda.empty_cache()
    out["d_zero_flag_gram"] = plan_zero_flag_gram(torch, tst, ck, X, y)
    torch.cuda.empty_cache()
    out["build_overhead"] = plan_build_overhead(torch, tst, X, y)
    out["dispatch_tax"] = plan_dispatch_tax(torch, tst, Xh, yh)
    out["e_beyond_budget"] = plan_beyond_budget(torch, tst, ck, Xh, yh,
                                                leg_b)
    out["estimates"] = plan_estimates(profile, gram, streamed, streamed_qn)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "plan", **out})
    return out, cm


def plan_constants(torch, cm, plan_rec, gram, streamed, mesh):
    """The measured ``CostModel`` fields from this run's phases, beside
    the defaults: what ``tpu_sgd_torch/plan.py``'s defaults come from."""
    from tpu_sgd_torch.plan import CostModel

    hbm = cm.hbm_gb_s * 1e9
    b = gram["a_build"]
    small = plan_rec["build_overhead"]
    # seconds a row of the build, then its fixed cost
    per_row = (b["warm_s"] - small["warm_s"]) / (FULL_ROWS - small["rows"])
    overhead = small["warm_s"] - per_row * small["rows"]
    flops = 2.0 * FULL_D * FULL_D / (per_row - FULL_D * 2 / hbm)
    exact_ms = gram["c_sgd_exact"]["wall_ms_per_iteration"]
    exact_bytes = 2.0 * GRAM_BLOCK * FULL_D * 2 + 2.0 * (FULL_D ** 2
                                                         + FULL_D) * 4
    bern = streamed["b_sampled"]["bernoulli"]
    feed = (bern["ingest"]["h2d_bytes"] / STREAM_SAMPLED_ITERS
            / (bern["wall_ms_per_iteration"] / 1e3))
    combine = mesh["combine_ms_by_rank"]["combine_ms"]
    combine_ms = sum(combine) / len(combine)
    k = [rep["k"] for rep in mesh["streamed"]["by_rank"]]
    compress = sum(r["full_topk_ms_per_iteration"]
                   - r["full_dense_ms_per_iteration"] for r in k) / len(k)
    measured = {
        "hbm_gb_s": cm.hbm_gb_s,
        "mxu_f32_flops": flops,
        "build_overhead_s": overhead,
        "gram_iter_overhead_s": exact_ms / 1e3 - exact_bytes / hbm,
        "host_feed_gb_s": feed / 1e9,
        "hbm_bytes": float(torch.cuda.get_device_properties(0).total_memory),
        # a slope at or below 0: K = 8 is no faster, fusion divides nothing
        "dispatch_overhead_s": max(
            0.0, plan_rec["dispatch_tax"]["dispatch_overhead_s"]),
        "allreduce_gb_s": (FULL_D + 2) * 4 / (combine_ms / 1e3) / 1e9,
        "compress_overhead_s": compress / 1e3}
    default = CostModel()
    out = {"measured": measured,
           "defaults": {k: getattr(default, k) for k in measured},
           "host_feed_raw_probe_gb_s": cm.host_feed_gb_s,
           "from": {"hbm_gb_s": "plan (a)",
                    "mxu_f32_flops": "gram (a) and plan's small build",
                    "build_overhead_s": "the same two builds",
                    "gram_iter_overhead_s": "gram (c)",
                    "host_feed_gb_s": "streamed (b), Bernoulli",
                    "hbm_bytes": "total_memory",
                    "dispatch_overhead_s": "plan: full-batch feed, K=1/8",
                    "allreduce_gb_s": "mesh (b) combine",
                    "compress_overhead_s": "mesh (k)"},
           "nvidia_smi": nvidia_smi_line()}
    emit({"phase": "plan", "part": "constants", **out})
    return out


def staged_sparse_batch(torch, tst, Xh, cfg):
    """Iteration 1's batch of the streamed sparse run with config
    ``cfg``, staged as the driver stages it (``(row_cap, nse_cap)`` CSR
    components, the padding entries at the end of the last row) and put
    on the card, with its transposed copy built there as the driver
    builds it and its valid mask."""
    from tpu_sgd_torch.io.sparse_wire import (csr_host, plan_sparse_batches,
                                              sparse_batch_index_dtype,
                                              stage_sparse_batch)
    from tpu_sgd_torch.ops import sparse as sp
    from tpu_sgd_torch.optimize.streamed import HostSampler

    indptr, cols, vals, (n, d) = csr_host(Xh)
    sampler = HostSampler(cfg, n)
    cap = sampler.cap
    nse = plan_sparse_batches(indptr, sampler.sample_rows,
                              cfg.num_iterations, cap)
    idt = sparse_batch_index_dtype(cap, nse, d)
    host = (torch.empty((cap + 1,), dtype=idt),
            torch.empty((nse,), dtype=idt),
            torch.empty((nse,), dtype=torch.float32),
            torch.empty((cap,), dtype=torch.bool))
    stage_sparse_batch(indptr, cols, vals.astype(np.float32),
                       sampler.sample_rows(1), cap, nse, out=host)
    crow, col, val, valid = (t.cuda() for t in host)
    crow_t = torch.empty((d + 1,), dtype=idt, device="cuda")
    row_t = torch.empty((nse,), dtype=idt, device="cuda")
    val_t = torch.empty((nse,), dtype=torch.float32, device="cuda")
    sp.transpose_csr_into(crow, col, val, d, crow_t, row_t, val_t)
    return {"X": sp._csr(crow, col, val, (cap, d)),
            "Xt": sp._csr(crow_t, row_t, val_t, (d, cap)), "valid": valid}


def csr_rows(torch, ck, X, sparse, owlqn, streamed, batch):
    """The CSR kernel at every shape the smoke's sparse paths give it, each
    against its plain twin and cuSPARSE (torch's CSR product, the library
    call) with its bound; each case's launches are those of the run that
    gives the kernel that shape:

    * RCV1-scale X, all rows (phase ``sparse`` at frac 1.0), a 10% row
      mask (frac 0.1), and the gradient over its transposed copy (both);
    * the trial points of leg (d)'s last line search on X (OWL-QN's 30;
      its hinge run, ``csr_margins/30``);
    * iteration 1's staged batch of the streamed Bernoulli run, masked by
      its valid rows, and the gradient over the batch's transposed copy
      (that run).

    Each case is also held to the kernel's contract for capture: no host
    synchronisation (torch's sync detector set to raise), at most two CUDA
    launches a call (the nodes of a CUDA graph that captured one call,
    read through the driver), and that graph's replay bitwise equal to
    the eager call.  ``one_line_graph_ms`` is the same call on the
    operand's structure with every column index 0 (:func:`one_line_csr`):
    the same split and entry stream, each gather of rhs one line, so
    ``graph_ms`` less it is what the gathers' misses cost."""
    from tpu_sgd_torch.ops import sparse as sp

    Xt = sp.transpose_csr(X)
    X1, Xt1, Xb1, Xbt1 = (one_line_csr(torch, A)
                          for A in (X, Xt, batch["X"], batch["Xt"]))
    n, d = X.shape
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = torch.randn(d, generator=gen, device="cuda")
    coeff = torch.randn(n, generator=gen, device="cuda")
    mask = torch.rand(n, generator=gen, device="cuda") < FRAC
    W = owlqn["trials"].T.contiguous()
    Xb, Xbt, valid = batch["X"], batch["Xt"], batch["valid"]
    cap = Xb.shape[0]
    coeff_b = torch.randn(cap, generator=gen, device="cuda") * valid
    row_nnz = torch.diff(X.crow_indices().long())
    batch_nnz = torch.diff(Xb.crow_indices().long())
    full = sparse["runs"]["1.0"]["csr_launches"]
    tenth = sparse["runs"]["0.1"]["csr_launches"]
    stream = streamed["runs"][str(FRAC)]["csr_column_launches"]
    rows = []
    # name, shape, kernel, plain, library, the kernel on one line, entries
    # read, rows of the operand, its columns, right-hand columns, launches,
    # their run
    cases = (("csr_margins", "all rows", lambda: ck.csr_margins(X, w),
              lambda: ck.csr_matmul_plain(X, w), lambda: X @ w,
              lambda: ck.csr_margins(X1, w),
              X._nnz(), n, d, 1, full.get("csr_margins/1", 0),
              "phase sparse, frac 1.0"),
             ("csr_margins", "10% mask",
              lambda: ck.csr_margins(X, w, mask),
              lambda: ck.csr_matmul_plain(X, w, mask),
              lambda: X @ w, lambda: ck.csr_margins(X1, w, mask),
              int(row_nnz[mask].sum()), n, d, 1,
              tenth.get("csr_margins/1", 0), "phase sparse, frac 0.1"),
             ("csr_grad_sum", "all rows", lambda: ck.csr_grad_sum(Xt, coeff),
              lambda: ck.csr_matmul_plain(Xt, coeff), lambda: Xt @ coeff,
              lambda: ck.csr_grad_sum(Xt1, coeff), Xt._nnz(), d, n, 1,
              full.get("csr_grad_sum/1", 0) + tenth.get("csr_grad_sum/1", 0),
              "phase sparse, frac 1.0 and 0.1"),
             ("csr_margins", f"{W.shape[1]} trial points",
              lambda: ck.csr_margins(X, W),
              lambda: ck.csr_matmul_plain(X, W), lambda: X @ W,
              lambda: ck.csr_margins(X1, W), X._nnz(), n, d, W.shape[1],
              owlqn["csr_launches"].get(f"csr_margins/{W.shape[1]}", 0),
              "leg (d), hinge + L1"),
             ("csr_margins", "streamed batch",
              lambda: ck.csr_margins(Xb, w, valid),
              lambda: ck.csr_matmul_plain(Xb, w, valid), lambda: Xb @ w,
              lambda: ck.csr_margins(Xb1, w, valid),
              int(batch_nnz[valid].sum()), cap, d, 1,
              stream.get("csr_margins/1", 0),
              f"streamed sparse, frac {FRAC}"),
             ("csr_grad_sum", "streamed batch, transposed",
              lambda: ck.csr_grad_sum(Xbt, coeff_b),
              lambda: ck.csr_matmul_plain(Xbt, coeff_b),
              lambda: Xbt @ coeff_b, lambda: ck.csr_grad_sum(Xbt1, coeff_b),
              Xbt._nnz(), d, cap, 1,
              stream.get("csr_grad_sum/1", 0),
              f"streamed sparse, frac {FRAC}"))
    for (name, shape, kern, plain, lib, one_line, nnz, prow, k, T, launches,
         source_run) in cases:
        got, ref = kern(), plain()
        again = kern()
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.equal(got, again)), f"{name} ({shape}) not bitwise")
        check(err <= 1e-4 * scale + 1e-6,
              f"{name} ({shape}): max |d| {err} of {scale}")
        check(launches > 0, f"{name} ({shape}): no launch in {source_run}")
        check(no_host_sync(torch, kern), f"{name} ({shape}) syncs the host")
        replay, per_call = captured_call(torch, ck, kern)
        check(1 <= sum(per_call.values()) <= 2,
              f"{name} ({shape}): {per_call} CUDA launches a call")
        check(bool(torch.equal(replay, got)),
              f"{name} ({shape}): captured replay differs from the eager call")
        idx = X.col_indices().element_size()
        bytes_ = nnz * (4 + idx) + (prow + 1) * idx + 4 * T * (k + prow)
        if "mask" in shape or shape == "streamed batch":
            bytes_ += prow  # the mask
        t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
        t_ops = 1e3 * 2.0 * nnz * T / F32_FLOPS
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        ms = time_ms(torch, kern, 20)
        with ck.captured_launches():
            kern_graph = graph_ms(torch, kern)
            one_line_graph = graph_ms(torch, one_line)
        rows.append({
            "name": name, "path": f"sparse ({shape})",
            "source": CSR_SOURCE, "shape": [prow, k], "columns": T,
            "nnz": nnz, "max_abs_err": err, "grad_scale": scale, "ms": ms,
            "plain_ms": time_ms(torch, plain, 20),
            "library_ms": time_ms(torch, lib, 20),
            # device time alone: calls replayed from a CUDA graph (events
            # over back-to-back calls include the host's pacing of them)
            "graph_ms": kern_graph,
            "library_graph_ms": graph_ms(torch, lib),
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms,
            "one_line_graph_ms": one_line_graph,
            "cuda_launches_per_call": per_call, "host_syncs": 0,
            "replay_bitwise": True,
            "launches": launches, "launches_from": source_run})
    del Xt, X1, Xt1, Xb1, Xbt1
    return rows


def one_line_csr(torch, X):
    """``X``'s row pointers and values with every column index 0: a
    product over it reads the same entries in the same split, and each
    gather of rhs reads rhs's first line."""
    return torch.sparse_csr_tensor(
        X.crow_indices(), torch.zeros_like(X.col_indices()), X.values(),
        size=X.shape)


#: CUgraphNodeType names (cuda.h) of the nodes a capture can record
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty"}


def graph_node_types(torch, graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    by type, read through the driver (``cuGraphGetNodes``): every kernel,
    copy and set the captured calls enqueued, torch's own included."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes")
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType")
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def no_host_sync(torch, fn) -> bool:
    """True when one ``fn`` call makes no host synchronisation: torch's
    sync detector raises on the first."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return True


def captured_call(torch, ck, fn):
    """One ``fn`` call captured in a CUDA graph (warmed up on the
    capture's side stream; its launches kept out of the counts) and
    replayed once: returns the replay's result and the graph's nodes by
    type, i.e. what one call launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with ck.captured_launches():
        with torch.cuda.graph(graph):
            out = fn()
    nodes = graph_node_types(torch, graph)
    graph.replay()
    torch.cuda.synchronize()
    out = out.clone()
    del graph
    return out, nodes


def phase_streamed_sparse(torch, tst, ck, X, y):
    """Phase ``streamed``, sparse rows: the RCV1-scale CSR of phase
    ``sparse`` held as host CSR arrays, Bernoulli at frac 0.1 and full
    batch, ``SPARSE_STREAM_ITERS`` iterations (hinge + L1).  Returns the report and the
    Bernoulli run's first staged batch on the card (for ``csr_rows``)."""
    t = time.perf_counter()
    Xh = X.cpu()
    yh = y.cpu()
    n, d = X.shape
    w0 = torch.zeros(d, device="cuda")
    out = {"host_copy_seconds": time.perf_counter() - t}

    def opt(frac, **kw):
        return _stream_opt(tst, "bernoulli", frac, SPARSE_STREAM_ITERS,
                           gradient=tst.HingeGradient(),
                           updater=tst.L1Updater(), step=100.0,
                           **kw).set_reg_param(1e-5)

    def run(o, profile_iters=0):
        return _streamed_run(torch, ck, o, Xh, yh, w0, SPARSE_STREAM_ITERS,
                             profile_iters=profile_iters)

    runs = {}
    for frac in (FRAC, 1.0):
        a = run(opt(frac), profile_iters=10)
        b = run(opt(frac))
        h = a["history"]
        check(len(h) == SPARSE_STREAM_ITERS and h[-1] < h[0],
              f"sparse streamed frac {frac}: history {h[:3]}..{h[-3:]}")
        check(a["launches"] == {"fused_gradient_sums": 0,
                                "fused_window_sums": 0,
                                "fused_window_sums_vpu": 0},
              f"sparse streamed launched dense kernels {a['launches']}")
        check(a["csr_launches"] == {"csr_margins": SPARSE_STREAM_ITERS,
                                    "csr_grad_sum": SPARSE_STREAM_ITERS},
              f"sparse streamed CSR launches {a['csr_launches']}")
        rec = _report(a) | {"repeat_bitwise": _same(a, b),
                            "loss_first": float(h[0]),
                            "loss_last": float(h[-1])}
        if frac < 1.0:
            rec["prefetch_2_vs_0"] = _same(a, run(opt(frac, depth=0)))
            rec["k8_vs_k1"] = _same(a, run(opt(frac, k=8)))
            ratio = (a["wire_logical_bytes_per_iteration"]
                     / a["wire_physical_bytes_per_iteration"])
            rec["wire_dense_over_physical"] = ratio
            check(ratio >= 10.0, f"sparse wire ratio {ratio} < 10")
            dense_batch = bernoulli_rows(n) * d * 4
            rec["dense_batch_f32_bytes"] = dense_batch
            check(a["peak_extra_device_bytes"] < dense_batch,
                  f"sparse streamed peak {a['peak_extra_device_bytes']} "
                  f">= a dense batch ({dense_batch})")
            for key in ("prefetch_2_vs_0", "k8_vs_k1"):
                check(rec[key], f"sparse streamed {key} failed")
        check(rec["repeat_bitwise"], f"sparse streamed frac {frac} repeat")
        runs[str(frac)] = rec
    out["runs"] = runs
    out["launches"] = runs[str(FRAC)]["csr_launches"]
    out["seconds"] = time.perf_counter() - t
    return out, staged_sparse_batch(torch, tst, Xh, opt(FRAC).config)


# -- phase 13: data parallelism ----------------------------------------------

MESH_RANKS = 8
MESH_SEED = 10
MESH_ITERS = ITERS          # 20: ``_expected_launches`` counts per run
MESH_PREFIX_ROWS = 125_000  # a rank's rows of the 1M-row bitwise check
MESH_WINDOW_START = 500_000  # B2's row: a shard's 125,000-row window
MESH_TIMEOUT = 720          # seconds for the 8-rank job, start-up included
MESH_COMBINE_REPS = 100
MESH_OBS_K = 8
MESH_OBS_STOP_AT = 13
MESH_HISTORY_RTOL = 2e-4    # the gradient tier
# bf16 full batch against one device: 5.8e-4 on the card, 1.3e-3 in a CPU
# replay at 400,000 rows (the margins round w to bf16)
MESH_FULL_HISTORY_RTOL = 3e-3
MESH_FULL_OBJECTIVE_TOL = 1e-4  # |ratio - 1| at full batch (read 2.7e-5)
MESH_OBJECTIVE_RATIO = 1.01  # the matched objective of a sampled run


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fill_mesh_block(torch, X, y, block, seed=MESH_SEED,
                    chunk=MESH_PREFIX_ROWS, cols=None):
    """Row block ``block`` of phase ``mesh``'s data made into ``X`` (bf16,
    ``(rows, d)``) and ``y`` on their device from ``(seed, block)`` alone,
    ``chunk`` rows at a time (a block's first ``chunk`` rows do not depend
    on its length): a rank makes its own block and the parent every block,
    bit for bit the same.  ``y = X w + 0.1 eps`` with ``w`` from ``seed``
    alone, the margins summed by rows (no library product, whose algorithm
    might differ between processes).  ``cols`` (a slice of the ``FULL_D``
    columns): X holds only those columns of the block's rows, and y is
    the whole rows' (a 2-D mesh rank's feature block)."""
    dev = X.device
    d = FULL_D if cols is not None else X.shape[1]
    w = torch.rand(d, generator=torch.Generator(device=dev).manual_seed(seed),
                   device=dev) * 2 - 1
    gen = torch.Generator(device=dev).manual_seed(
        seed * 1_000_003 + 1 + block)
    for s in range(0, X.shape[0], chunk):
        e = min(X.shape[0], s + chunk)
        Xc = torch.randn(e - s, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        y[s:e] = (Xc.float() * w).sum(dim=1) + 0.1 * torch.randn(
            e - s, generator=gen, device=dev)
        X[s:e] = Xc if cols is None else Xc[:, cols]
    return w


def _block_digest(X, y) -> str:
    """sha256 of ``y`` and of every 1,000th row of ``X`` (bf16 values,
    exact in f32)."""
    import hashlib

    h = hashlib.sha256(y.cpu().numpy().tobytes())
    h.update(X[::1000].float().cpu().numpy().tobytes())
    return h.hexdigest()


def csr_row_block(torch, X, lo, hi):
    """Rows ``[lo, hi)`` of a CSR ``X`` as a CSR of their own, on X's
    device."""
    crow = X.crow_indices()
    a, b = int(crow[lo]), int(crow[hi])
    return torch.sparse_csr_tensor(crow[lo:hi + 1] - crow[lo],
                                   X.col_indices()[a:b], X.values()[a:b],
                                   size=(hi - lo, X.shape[1]))


def _mesh_alg(tst, mode, frac, mesh=None):
    """Phase ``full``'s least-squares run (step, seed, iterations) at
    ``frac`` with ``mode`` sampling, on ``mesh`` when one is given."""
    alg = tst.LinearRegressionWithSGD(0.5, MESH_ITERS, None, frac)
    alg.set_schedule("off")  # a named route: no planner
    alg.optimizer.set_convergence_tol(0.0).set_sampling(
        "bernoulli" if mode == "full" else mode)
    if mesh is not None:
        alg.optimizer.set_mesh(mesh)
    return alg


def _mesh_run(torch, ck, alg, X, y) -> dict:
    """One run of ``alg``: weights, history, launches by wrapper and by
    source (set to 0 just before and read just after), wall ms an
    iteration."""
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = alg.run((X, y))
    torch.cuda.synchronize()
    return {"w": model.weights,
            "h": np.asarray(alg.optimizer.loss_history),
            "launches": ck.launch_counts(),
            "by_source": ck.kernel_launch_counts(),
            "products": ck.model_axis_product_counts(),
            "ms": 1e3 * (time.perf_counter() - t) / MESH_ITERS}


def _check_launches(run, mode, what):
    wrappers, sources = _expected_launches(
        "bernoulli" if mode == "full" else mode)
    check(run["launches"] == wrappers and run["by_source"] == sources,
          f"{what} {mode}: launches {run['launches']} "
          f"{run['by_source']}")


def _combine_ms(torch, par, mesh, reps=MESH_COMBINE_REPS) -> dict:
    """Wall ms of one ``combine_sums`` of a ``(FULL_D + 2)``-float vector
    on the card, and of its parts under gloo: the copy to the host (which
    waits for the card) and the gather of a host vector."""
    from tpu_sgd_torch.parallel.mesh import all_gather

    g = torch.ones(FULL_D, device="cuda")
    l = torch.ones((), device="cuda")
    c = torch.ones((), device="cuda")
    flat = torch.ones(FULL_D + 2)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    out = {"combine_ms": per_call(lambda: par.combine_sums(mesh, g, l, c))}
    if mesh.backend != "nccl":  # gloo's route through the host, by part
        out["to_host_ms"] = per_call(lambda: g.cpu())
        out["host_gather_ms"] = per_call(lambda: all_gather(mesh, flat))
    return out


def mesh_rank_runs(torch, tst, ck, par, mesh, out_dir):
    """One rank's work in (b), (c) and (e)-(i): its block of the data made
    on the card; Bernoulli, indexed and sliced at ``FRAC`` and full batch,
    each run twice; Bernoulli and sliced on its first
    ``MESH_PREFIX_ROWS`` rows; the combine timed; (f)-(i) on the block
    (``mesh_rank_dense``); the block freed, (e) on the 4 x 2 mesh
    (``mesh_rank_2d``); then hinge + L1 on its CSR row block
    (``sparse<rank>.npz``) at frac 1.0 and ``FRAC``, and OWL-QN on it
    (``mesh_rank_sparse_owlqn``); then (j)-(m) over phase ``streamed``'s
    host rows (``mesh_rank_streamed``).  Returns ``(report, arrays)``."""
    rank, dev = mesh.rank, "cuda"
    rows = FULL_ROWS // mesh.size
    X = torch.empty((rows, FULL_D), dtype=torch.bfloat16, device=dev)
    y = torch.empty((rows,), dtype=torch.float32, device=dev)
    fill_mesh_block(torch, X, y, rank)
    res = {"rank": rank, "world": mesh.size, "backend": mesh.backend,
           "digest": _block_digest(X, y), "runs": {}, "sparse": {}}
    arrays = {}
    for mode in ("bernoulli", "indexed", "sliced", "full"):
        frac = 1.0 if mode == "full" else FRAC
        first, again = (_mesh_run(torch, ck, _mesh_alg(tst, mode, frac, mesh),
                                  X, y) for _ in range(2))
        res["runs"][mode] = {
            "ms_per_iteration": again["ms"],
            "first_run_ms_per_iteration": first["ms"],
            "launches": first["launches"],
            "launches_by_source": first["by_source"],
            "again_launches": again["launches"],
            "repeat_bitwise": _same_run(torch, (first["w"], first["h"]),
                                        (again["w"], again["h"])),
            "loss_first": float(first["h"][0]),
            "loss_last": float(first["h"][-1])}
        arrays[mode + "_w"] = first["w"].cpu().numpy()
        arrays[mode + "_h"] = first["h"]
    for mode in ("bernoulli", "sliced"):
        r = _mesh_run(torch, ck, _mesh_alg(tst, mode, FRAC, mesh),
                      X[:MESH_PREFIX_ROWS], y[:MESH_PREFIX_ROWS])
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        arrays[f"prefix_{mode}_w"] = r["w"].cpu().numpy()
        arrays[f"prefix_{mode}_h"] = r["h"]
    res["combine_ms"] = _combine_ms(torch, par, mesh)
    dense, dense_arrays = mesh_rank_dense(torch, tst, ck, par, mesh, X, y)
    res.update(dense)
    arrays.update(dense_arrays)
    del X, y
    torch.cuda.empty_cache()
    res["e"], e_arrays = mesh_rank_2d(torch, tst, ck, par)
    arrays.update(e_arrays)
    torch.cuda.empty_cache()
    with np.load(os.path.join(out_dir, f"sparse{rank}.npz")) as z:
        Xs = torch.sparse_csr_tensor(
            torch.as_tensor(z["crow"]).to(dev),
            torch.as_tensor(z["col"]).to(dev),
            torch.as_tensor(z["val"]).to(dev),
            size=tuple(int(v) for v in z["shape"]))
        ys = torch.as_tensor(z["y"]).to(dev)
    for frac in (1.0, FRAC):
        alg = _sparse_alg(tst, MESH_ITERS, frac)
        alg.optimizer.set_mesh(mesh)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t = time.perf_counter()
        model = alg.run((Xs, ys))
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        h = np.asarray(alg.optimizer.loss_history)
        res["sparse"][str(frac)] = {
            "ms_per_iteration": 1e3 * (time.perf_counter() - t) / MESH_ITERS,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            "rows": int(Xs.shape[0]), "nnz": int(Xs._nnz()),
            "csr_launches": ck.csr_launch_counts(),
            "dense_launches": ck.launch_counts(),
            "loss_first": float(h[0]), "loss_last": float(h[-1])}
        arrays[f"sparse_{frac}_w"] = model.weights.cpu().numpy()
        arrays[f"sparse_{frac}_h"] = h
    res["i_sparse"], sp_arrays = mesh_rank_sparse_owlqn(torch, tst, ck, mesh,
                                                        Xs, ys)
    arrays.update(sp_arrays)
    del Xs, ys
    torch.cuda.empty_cache()
    res["streamed"], st_arrays = mesh_rank_streamed(torch, tst, ck, par, mesh,
                                                    out_dir)
    arrays.update(st_arrays)
    return res, arrays


def mesh_child(rank, world, port, out_dir) -> int:
    """A rank of (b) and (c), started by the parent as ``chip_smoke.py
    --mesh-rank RANK WORLD PORT DIR``: a gloo world on the one card
    (NCCL refuses two ranks on one card), the port only."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: a mesh rank needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.ops import cuda_kernels as ck

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    par.initialize_distributed(f"tcp://127.0.0.1:{port}", int(world),
                               int(rank), backend="gloo")
    mesh = par.data_mesh()
    res, arrays = mesh_rank_runs(torch, tst, ck, par, mesh, out_dir)
    res["leaked"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    par.mesh.barrier(mesh, "cuda")
    torch.distributed.destroy_process_group()
    check(not res["leaked"], f"mesh rank {rank} imported {res['leaked']}")
    return 0


def mesh_spawn(world, out_dir, timeout=MESH_TIMEOUT, script=None,
               flag="--mesh-rank", pass_fds=()):
    """Start ``world`` ranks, ``python3 SCRIPT FLAG RANK WORLD PORT DIR``
    (by default this script's ``mesh_child``), on a free port and wait
    for all; a rank that exits non-zero, or a job that outlives
    ``timeout``, fails the phase, every rank stopped first.  Only a port
    taken between the probe and the bind starts the job again, on another
    port.  Each rank's output goes to ``rank<r>.log``; ``pass_fds`` stay
    open in every rank (the memfd of the shared host rows).  Returns the
    job's seconds."""
    script = script or os.path.abspath(__file__)
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    for attempt in range(3):
        port = _free_port()
        t = time.perf_counter()
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, script, flag, str(r), str(world),
                         str(port), out_dir],
                        stdout=log, stderr=subprocess.STDOUT,
                        pass_fds=tuple(pass_fds)))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break  # the others would wait for it in a collective
                check(time.perf_counter() - t < timeout,
                      f"the mesh job hung past {timeout} s")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        secs = time.perf_counter() - t
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if not bad:
            return secs
        text = []
        for r in range(world):
            with open(logs[r]) as f:
                text.append(f.read())
        if attempt < 2 and any("address already in use" in x.lower()
                               for x in text):
            continue
        tails = "\n".join(f"--- rank {r} ---\n{text[r][-2000:]}"
                          for r in bad)
        raise RuntimeError(f"check failed: mesh ranks {bad} exited non-zero"
                           f"\n{tails}")
    raise RuntimeError("check failed: no free port for the mesh job")


def rank_order_reference(torch, tst, shards, mode, iters=MESH_ITERS,
                         grads=None):
    """The meshed run's arithmetic in one process on the card: each
    shard's own sample stream (``_make_sampler(..., shard=s)``; none at
    full batch, ``mode="full"``) and kernel sums, added in rank order on
    the card (the gloo ranks add on the host), then ``make_run``'s update
    (least squares, simple updater).  ``grads``: each shard's gradient
    (its statistics gradient, its X then the ``GramData``)."""
    from tpu_sgd_torch.optimize import gradient_descent as tgd

    frac = 1.0 if mode == "full" else FRAC
    cfg = tst.SGDConfig(step_size=0.5, num_iterations=iters,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        sampling="bernoulli" if mode == "full" else mode)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    grads = grads or [g] * len(shards)
    dev = shards[0][0].device
    d = shards[0][0].shape[1]
    samplers = [tgd._make_sampler(cfg, Xs, shard=s)
                for s, (Xs, _) in enumerate(shards)]
    w = torch.zeros(d, device=dev)
    reg = torch.zeros((), device=dev)
    reg.copy_(u.compute(w, torch.zeros_like(w), 0.0, 1, 0.0)[1])
    hist = []
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64, device=dev)
        parts = []
        for (Xs, ys), smp, gr in zip(shards, samplers, grads):
            sample = None
            if smp is not None:
                smp.seek(i)
                sample = smp.draw()
            if mode == "sliced":
                m = max(1, round(FRAC * Xs.shape[0]))
                gs, ls, cs = gr.window_sums(Xs, ys, w, sample, m)
            else:
                gs, ls, cs = gr.batch_sums(Xs, ys, w, sample)
            parts.append(torch.cat([gs, ls.reshape(1), cs.reshape(1)]))
        tot = parts[0]
        for p in parts[1:]:  # rank order, one add at a time
            tot = tot + p
        c = tot[d + 1]
        safe = torch.clamp(c, min=1.0)
        loss = tot[d] / safe + reg
        new_w, new_reg = u.compute(w, tot[:d] / safe, cfg.step_size, it, 0.0)
        if bool(c > 0):
            hist.append(loss.to(torch.float32))
            w, reg = new_w, new_reg
    return w, torch.stack(hist).cpu().numpy()


def mesh_observed(torch, tst, X, y, mesh):
    """(d) The observed driver on a mesh: a listener at K = 1 and at
    ``MESH_OBS_K`` (captured blocks, the gather in the graph under NCCL)
    bitwise the unobserved meshed run; a stop raised by the event of
    ``MESH_OBS_STOP_AT`` and its resume from rank 0's checkpoint,
    bitwise."""
    from tpu_sgd_torch.reliability import TrainingPreempted
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    def opt(k):
        return (tst.GradientDescent(device=X.device).set_step_size(0.5)
                .set_num_iterations(MESH_ITERS).set_mini_batch_fraction(FRAC)
                .set_convergence_tol(0.0).set_mesh(mesh).set_superstep(k))

    w0 = torch.zeros(X.shape[1], device=X.device)
    ref_w, ref_h = opt(1).optimize_with_history((X, y), w0)
    out = {}
    for k in (1, MESH_OBS_K):
        lis = _stop_listener()
        w, h = opt(k).set_listener(lis).optimize_with_history((X, y), w0)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        same = bool(torch.equal(w, ref_w)) and np.array_equal(h, ref_h)
        check(same and len(lis.iterations) == MESH_ITERS,
              f"mesh observed K={k}: not the unobserved run")
        out[f"k{k}_bitwise"] = same
    with tempfile.TemporaryDirectory() as tmp:
        lis = _stop_listener(at=MESH_OBS_STOP_AT)
        o = opt(1).set_listener(lis).set_checkpoint(CheckpointManager(tmp),
                                                    every=5)
        o.set_stop_signal(lis.stop)
        stopped = None
        try:
            o.optimize_with_history((X, y), w0)
        except TrainingPreempted as e:
            stopped = e.iteration
        o.set_stop_signal(None)
        w, h = o.optimize_with_history((X, y), w0)
    same = bool(torch.equal(w, ref_w)) and np.array_equal(h, ref_h)
    check(stopped == MESH_OBS_STOP_AT and same,
          f"mesh observed: stopped at {stopped}, resume bitwise {same}")
    out.update(stopped_at=stopped, resume_bitwise=same)
    return out


def _check_objective_ratios(ratios, full, what) -> None:
    """Each meshed run's objective over the single-device run's: the full
    batch run (key ``full``) within ``MESH_FULL_OBJECTIVE_TOL`` of 1 (the
    same problem, another summation order), each sampled run (its own
    per-shard sample stream) at most ``MESH_OBJECTIVE_RATIO``."""
    for key, r in ratios.items():
        ok = (abs(r - 1.0) <= MESH_FULL_OBJECTIVE_TOL if key == full
              else r <= MESH_OBJECTIVE_RATIO)
        check(ok, f"{what} {key}: objective {r}x the single device's")


def mesh_world1(torch, tst, ck, X, y, profile):
    """(a) and (d): this process as a mesh of one rank over NCCL.
    Full batch meshed bitwise the single-device run; at ``FRAC``, per
    sampler, every block eager (``CUDA_GRAPHS = False``) against a first
    run, a second that captures its second block, and a third that
    replays both, bitwise, launches exact; the replayed run's wall and
    device ms an iteration beside phase ``profile``'s single-device rows;
    then (d).  Every optimizer's CUDA graphs, which hold the captured
    gather, are released before the group is destroyed.  Returns
    ``(report, the single-device full-batch run)``."""
    import gc

    import torch.distributed as dist

    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.optimize import gradient_descent as tgd

    par.initialize_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                               backend="nccl")
    try:
        mesh = par.data_mesh()
        check(mesh.backend == "nccl" and mesh.size == 1,
              f"world-1 mesh {mesh} over {mesh.backend}")
        single = _mesh_run(torch, ck, _mesh_alg(tst, "full", 1.0), X, y)
        meshed = _mesh_run(torch, ck, _mesh_alg(tst, "full", 1.0, mesh), X, y)
        _check_launches(meshed, "full", "world 1")
        full_same = _same_run(torch, (single["w"], single["h"]),
                              (meshed["w"], meshed["h"]))
        check(full_same, "world 1, full batch: not the single-device run")
        out = {"backend": mesh.backend, "full_batch_bitwise": full_same,
               "full_batch_ms_per_iteration": {
                   "single_device": single["ms"], "mesh": meshed["ms"]},
               "rows": {}}
        for mode in ("bernoulli", "sliced"):
            tgd.CUDA_GRAPHS = False
            try:
                eager = _mesh_run(torch, ck, _mesh_alg(tst, mode, FRAC, mesh),
                                  X, y)
            finally:
                tgd.CUDA_GRAPHS = True
            alg = _mesh_alg(tst, mode, FRAC, mesh)
            runs = [_mesh_run(torch, ck, alg, X, y) for _ in range(3)]
            runner = alg.optimizer._run_cache[1].cache["runner"]
            for r in [eager] + runs:
                _check_launches(r, mode, "world 1")
            same = all(_same_run(torch, (eager["w"], eager["h"]),
                                 (r["w"], r["h"])) for r in runs)
            check(same, f"world 1 {mode}: captured blocks differ from eager")
            replays = runner.replays
            check(replays == (3 if runner.capture else 0),
                  f"world 1 {mode}: {replays} graph replays")
            prof = _run_profile(torch, lambda: alg.run((X, y)), MESH_ITERS)
            out["rows"][mode] = {
                "captured_equals_eager_bitwise": same,
                "graph_replays_in_three_runs": replays,
                "capture_ms": runner.capture_ms,
                "eager_ms_per_iteration": eager["ms"],
                "launches": runs[-1]["launches"],
                "mesh": {k: prof[k] for k in (
                    "wall_ms_per_iteration", "device_ms_per_iteration",
                    "idle_share", "top_device_ms",
                    "aten_calls_per_iteration")},
                "single_device": {k: profile[mode][k] for k in (
                    "wall_ms_per_iteration", "device_ms_per_iteration",
                    "idle_share")} if mode in profile else None}
            alg.optimizer.release_graphs()
            del alg, runner
        out["observed"] = mesh_observed(torch, tst, X, y, mesh)
    finally:
        gc.collect()
        dist.destroy_process_group()
    return out, single


def mesh_kernel_rows(torch, ck, tst, Xs, ys, Xb):
    """The kernels at a rank's shapes, each against its plain version,
    the library and its bound: B1 over a 1,250,000-row shard with a 10%
    mask, B2 over a 125,000-row window of it, B1 over the whole shard
    unmasked (meshed L-BFGS's cost evaluation), the CSR products over a
    rank's row block of the RCV1-scale CSR and its transposed copy, and
    the margins of 30 trial points over the block (meshed OWL-QN's
    line-search sweep)."""
    from tpu_sgd_torch.ops import sparse as sp

    pw = tst.LeastSquaresGradient().pointwise
    n, d = Xs.shape
    gen = torch.Generator(device="cuda").manual_seed(31)
    w = torch.randn(d, generator=gen, device="cuda") / math.sqrt(d)
    mask = torch.rand(n, generator=gen, device="cuda") < FRAC
    rows = [b1_row(torch, ck, pw, Xs, ys, w, mask,
                   f"mesh (a rank's {n:,}-row shard, 10% mask)", 50)]
    m = round(FRAC * n)
    rows.append(window_row(torch, ck, ck.fused_window_sums, pw, Xs, ys, w,
                           MESH_WINDOW_START, m,
                           f"mesh (a shard's {m:,}-row window)"))
    rows.append(b1_row(torch, ck, pw, Xs, ys, w, None,
                       f"mesh (a rank's {n:,}-row shard, unmasked: meshed "
                       "L-BFGS's cost)", 50))
    Xbt = sp.transpose_csr(Xb)
    nb, db = Xb.shape
    wd = torch.randn(db, generator=gen, device="cuda")
    cb = torch.randn(nb, generator=gen, device="cuda")
    idx = Xb.col_indices().element_size()
    W30 = torch.randn((db, 30), generator=gen, device="cuda") / 30
    for name, path, kern, plain, lib, prow, k, T in (
            ("csr_margins", f"mesh (a rank's {nb:,}-row CSR block)",
             lambda: ck.csr_margins(Xb, wd),
             lambda: ck.csr_matmul_plain(Xb, wd), lambda: Xb @ wd, nb, db,
             1),
            ("csr_grad_sum", "mesh (the block's transposed CSR)",
             lambda: ck.csr_grad_sum(Xbt, cb),
             lambda: ck.csr_matmul_plain(Xbt, cb), lambda: Xbt @ cb, db,
             nb, 1),
            ("csr_margins", f"mesh (a rank's {nb:,}-row CSR block, 30 trial "
             "points: meshed OWL-QN's sweep)",
             lambda: ck.csr_margins(Xb, W30),
             lambda: ck.csr_matmul_plain(Xb, W30), lambda: Xb @ W30, nb, db,
             30)):
        got, ref = kern(), plain()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= 1e-4 * scale + 1e-6,
              f"{name} ({path}): max |d| {err} of {scale}")
        nnz = Xb._nnz()
        bytes_ = nnz * (4 + idx) + (prow + 1) * idx + 4 * T * (k + prow)
        t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
        t_ops = 1e3 * 2.0 * nnz * T / F32_FLOPS
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        rows.append({
            "name": name, "path": path, "source": CSR_SOURCE,
            "shape": [prow, k], "columns": T, "nnz": nnz,
            "max_abs_err": err, "grad_scale": scale,
            "ms": time_ms(torch, kern, 50),
            "plain_ms": time_ms(torch, plain, 20),
            "library_ms": time_ms(torch, lib, 20),
            "bound_ms": bound, "bound_by": by})
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    return rows


# -- phase mesh, parts (e)-(i): resident training on a mesh -----------------

MESH2D = (4, 2)             # (data, model): each rank 2.5M rows x 500 columns
MESH2D_PREFIX_ROWS = 250_000  # a data block's rows of the 1M-row bitwise check
MESH_QN_ITERS = 10          # meshed L-BFGS iterations (leg (a) runs 20)
MESH_QN_REG = 1e-4          # its squared-L2 term
MESH_NORMAL_RTOL = 1e-5     # meshed normal equations against one device
MESH_STATS_RTOL = 1e-3      # the statistics run against the stock one
MESH_RES_K, MESH_RES_C, MESH_RES_ITERS = 8, 3, 24
MESH_OWLQN_OBJECTIVE_TOL = 1e-3  # |ratio - 1| against leg (d)'s objective


def _qn_objective(torch, X, y, w, reg=MESH_QN_REG) -> float:
    """Least squares plus the squared-L2 term of the meshed L-BFGS runs,
    at ``w`` itself (``ls_objective_exact``)."""
    return (ls_objective_exact(torch, X, y, w)
            + 0.5 * reg * float(torch.sum(w.double() ** 2)))


def _mesh_lbfgs(tst, mesh=None, stats=False):
    opt = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                    reg_param=MESH_QN_REG, max_num_iterations=MESH_QN_ITERS,
                    convergence_tol=0.0)
    if mesh is not None:
        opt.set_mesh(mesh)
    return opt.set_sufficient_stats(stats)


def _mesh_stats_opt(tst, mesh, aligned):
    return (tst.GradientDescent().set_step_size(0.5)
            .set_num_iterations(MESH_ITERS).set_mini_batch_fraction(FRAC)
            .set_sampling("sliced").set_convergence_tol(0.0).set_mesh(mesh)
            .set_sufficient_stats(True).set_gram_options(aligned=aligned))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def mesh_rank_dense(torch, tst, ck, par, mesh, X, y):
    """A rank's (f)-(i) on its 1.25M-row block: meshed L-BFGS twice, the
    meshed normal equations, the meshed statistics (sliced exact and
    aligned, then L-BFGS from the meshed totals), and on its first
    ``MESH_PREFIX_ROWS`` rows ``set_residency`` beside the superstep
    driver and feature scaling.  Returns ``(report, arrays)``."""
    import warnings

    from tpu_sgd_torch.utils import CollectingListener

    d = X.shape[1]
    w0 = torch.zeros(d, device="cuda")
    res, arrays = {}, {}
    runs = []
    for _ in range(2):
        ck.reset_launch_counts()
        (w, h), secs = _timed(torch, lambda: _mesh_lbfgs(
            tst, mesh).optimize_with_history((X, y), w0))
        runs.append((w, h, ck.launch_counts(), ck.gradient_route_counts(),
                     secs))
    (w, h, launches, routes, secs), again = runs[0], runs[1]
    res["f"] = {"cost_evaluations": len(h),
                "b1_launches": launches["fused_gradient_sums"],
                "launches": launches, "b1_routes": routes,
                "repeat_bitwise": _same_run(torch, (w, h), again[:2]),
                "ms_per_iteration": 1e3 * again[4] / max(1, len(h) - 1),
                "first_run_ms_per_iteration": 1e3 * secs / max(1, len(h) - 1)}
    arrays["f_w"], arrays["f_h"] = w.cpu().numpy(), h
    y_ls = y.to(torch.bfloat16).to(torch.float32)
    w, secs = _timed(torch, lambda: tst.NormalEquations().set_mesh(
        mesh).optimize((X, y_ls), w0))
    res["g"] = {"seconds": secs}
    arrays["g_w"] = w.cpu().numpy()
    res["h"] = {}
    for aligned in (False, True):
        opt = _mesh_stats_opt(tst, mesh, aligned)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        (w, h), secs = _timed(torch, lambda: opt.optimize_with_history(
            (X, y), w0))
        gram = opt._gram_dp_entry[3]
        key = "aligned" if aligned else "exact"
        res["h"][key] = {
            "seconds": secs, "engaged": gram is not None,
            "stack_bytes": gram.data.PG.numel() * gram.data.PG.element_size(),
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
            "launches": ck.launch_counts()}
        arrays[f"h_{key}_w"], arrays[f"h_{key}_h"] = w.cpu().numpy(), h
        opt.release_sufficient_stats()
        del opt, gram
    ck.reset_launch_counts()
    (w, h), secs = _timed(torch, lambda: _mesh_lbfgs(
        tst, mesh, stats=True).optimize_with_history((X, y), w0))
    res["h"]["lbfgs"] = {"seconds": secs, "launches": ck.launch_counts(),
                         "cost_evaluations": len(h)}
    arrays["h_lbfgs_w"], arrays["h_lbfgs_h"] = w.cpu().numpy(), h
    Xp, yp = X[:MESH_PREFIX_ROWS], y[:MESH_PREFIX_ROWS]

    def observed(residency):
        lis = CollectingListener()
        o = (tst.GradientDescent().set_step_size(0.5)
             .set_num_iterations(MESH_RES_ITERS)
             .set_mini_batch_fraction(FRAC).set_convergence_tol(0.0)
             .set_mesh(mesh).set_superstep(MESH_RES_K).set_listener(lis))
        if residency:
            o.set_residency(MESH_RES_C)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            w, h = o.optimize_with_history((Xp, yp), w0)
        o.release_graphs()
        return w, h, [str(r.message) for r in rec], len(lis.iterations)

    rw, rh, msgs, events = observed(True)
    sw, sh, _, _ = observed(False)
    res["i"] = {"residency_warned": any(
        "set_residency is single-device" in m for m in msgs),
        "residency_events": events,
        "residency_bitwise_superstep": _same_run(torch, (rw, rh), (sw, sh))}
    alg = tst.LinearRegressionWithSGD(0.5, MESH_ITERS, None, 1.0)
    alg.set_feature_scaling(True).set_schedule("off")
    alg.optimizer.set_convergence_tol(0.0).set_mesh(mesh)
    model = alg.run((Xp, yp))
    arrays["i_scaled_w"] = model.weights.cpu().numpy()
    arrays["i_scaled_h"] = np.asarray(alg.optimizer.loss_history)
    return res, arrays


def mesh_rank_2d(torch, tst, ck, par):
    """A rank's (e) on the 4 x 2 mesh: the rows of its data block (fill
    blocks ``2 di`` and ``2 di + 1``, 2.5M rows) and the columns of its
    model block (500).  Full batch, Bernoulli and sliced at 0.1 through
    ``GradientDescent`` on the first ``MESH2D_PREFIX_ROWS`` rows of the
    data block with every column (the rank keeps its block), then through
    ``dp_mp_run_fn`` on its 2.5M x 500 block, the whole vector gathered;
    launches and library products counted; the margin combine timed."""
    n_data, n_model = MESH2D
    m2 = par.make_mesh(n_data=n_data, n_model=n_model)
    di, mi = m2.rank, m2.model_index
    res = {"data_index": di, "model_index": mi, "prefix": {}, "full": {}}
    arrays = {}
    Xp = torch.empty((MESH2D_PREFIX_ROWS, FULL_D), dtype=torch.bfloat16,
                     device="cuda")
    yp = torch.empty((MESH2D_PREFIX_ROWS,), device="cuda")
    fill_mesh_block(torch, Xp, yp, 2 * di)
    for mode in ("full", "bernoulli", "sliced"):
        frac = 1.0 if mode == "full" else FRAC
        r = _mesh_run(torch, ck, _mesh_alg(tst, mode, frac, m2), Xp, yp)
        res["prefix"][mode] = {"launches": r["launches"],
                               "products": r["products"], "ms": r["ms"]}
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        arrays[f"e_prefix_{mode}_w"] = r["w"].cpu().numpy()
        arrays[f"e_prefix_{mode}_h"] = r["h"]
    del Xp, yp
    rows, b = FULL_ROWS // n_data, FULL_D // n_model
    cols = slice(mi * b, (mi + 1) * b)
    Xb = torch.empty((rows, b), dtype=torch.bfloat16, device="cuda")
    yb = torch.empty((rows,), device="cuda")
    half = rows // 2
    fill_mesh_block(torch, Xb[:half], yb[:half], 2 * di, cols=cols)
    fill_mesh_block(torch, Xb[half:], yb[half:], 2 * di + 1, cols=cols)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    for mode in ("full", "bernoulli", "sliced"):
        frac = 1.0 if mode == "full" else FRAC
        cfg = tst.SGDConfig(step_size=0.5, num_iterations=MESH_ITERS,
                            mini_batch_fraction=frac, convergence_tol=0.0,
                            sampling="bernoulli" if mode == "full" else mode)
        run = par.dp_mp_run_fn(g, u, cfg, m2)
        ck.reset_launch_counts()
        (wb, h, n), secs = _timed(torch, lambda: run(
            torch.zeros(b, device="cuda"), Xb, yb, None))
        w = par.gather_model(m2, wb).reshape(-1)
        res["full"][mode] = {"launches": ck.launch_counts(),
                             "products": ck.model_axis_product_counts(),
                             "ms_per_iteration": 1e3 * secs / MESH_ITERS}
        arrays[f"e_full_{mode}_w"] = w.cpu().numpy()
        arrays[f"e_full_{mode}_h"] = h[:int(n)].cpu().numpy()
        arrays[f"e_block_{mode}_w"] = wb.cpu().numpy()
    combine = {}
    for name, length in (("full_batch", rows), ("window", round(FRAC * rows))):
        margins = torch.ones(length, device="cuda")
        par.combine_model(m2, margins)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            par.combine_model(m2, margins)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        combine[name] = {"ms": 1e3 * (time.perf_counter() - t) / 20,
                         "bytes_per_rank": 4 * length}
    res["margin_combine"] = combine
    return res, arrays


def mesh_rank_sparse_owlqn(torch, tst, ck, mesh, Xs, ys):
    """A rank's (i), sparse: OWL-QN hinge + L1 (leg (d)'s problem) on its
    CSR row block, the CSR kernel's launches by right-hand columns."""
    ck.reset_launch_counts()
    (w, h), secs = _timed(torch, lambda: tst.OWLQN(
        tst.HingeGradient(), reg_param=1e-5,
        max_num_iterations=OWLQN_ITERS).set_mesh(mesh).optimize_with_history(
        (Xs, ys), torch.zeros(Xs.shape[1], device="cuda")))
    return ({"iterations": len(h) - 1, "seconds": secs,
             "csr_launches": ck.csr_launch_counts(by_columns=True),
             "dense_launches": ck.launch_counts()},
            {"i_owlqn_w": w.cpu().numpy(), "i_owlqn_h": h})


def rank_order_reference_2d(torch, tst, shards, mode, iters=MESH_ITERS,
                            n_model=MESH2D[1]):
    """A 2-D run's arithmetic in one process on the card (``n_model``
    feature blocks; the 4 x 2 mesh's by default): each data shard's rows
    cut into contiguous column blocks, its own sample stream;
    per shard the blocks' partial margins (``mm_acc``) added in model-rank
    order, the pointwise rule, each block's gradient; per block the sums
    added in data-rank order, each block's update, the reg values added in
    model-rank order (least squares, simple updater)."""
    from tpu_sgd_torch.ops.gradients import _window_rows, mm_acc
    from tpu_sgd_torch.optimize import gradient_descent as tgd

    frac = 1.0 if mode == "full" else FRAC
    cfg = tst.SGDConfig(step_size=0.5, num_iterations=iters,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        sampling="bernoulli" if mode == "full" else mode)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    b = FULL_D // n_model
    blocks = [[X[:, m * b:(m + 1) * b].contiguous() for m in range(n_model)]
              for X, _ in shards]
    samplers = [tgd._make_sampler(cfg, bl[0], shard=s)
                for s, bl in enumerate(blocks)]
    w = [torch.zeros(b, device="cuda") for _ in range(n_model)]
    regs = [u.compute(wm, torch.zeros_like(wm), 0.0, 1, 0.0)[1] for wm in w]
    reg = regs[0]
    for r in regs[1:]:
        reg = reg + r
    hist = []
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64, device="cuda")
        parts = [[] for _ in range(n_model)]
        for (_, ys), bl, smp in zip(shards, blocks, samplers):
            Xs, yv, mask = bl, ys, None
            if smp is not None:
                smp.seek(i)
                sample = smp.draw()
                if mode == "sliced":
                    m_rows = max(1, round(FRAC * ys.shape[0]))
                    Xs = [_window_rows(B, ys, None, sample, m_rows)[0]
                          for B in bl]
                    yv = _window_rows(bl[0], ys, None, sample, m_rows)[1]
                else:
                    mask = sample
            partial = [mm_acc(Xs[m], w[m].to(torch.bfloat16)[:, None])[:, 0]
                       for m in range(n_model)]
            margins = partial[0]
            for p in partial[1:]:  # model-rank order
                margins = margins + p
            coeff, losses = g.pointwise(margins, yv.to(margins.dtype))
            if mask is not None:
                mf = mask.to(margins.dtype)
                coeff, losses, count = coeff * mf, losses * mf, torch.sum(mf)
            else:
                count = torch.full((), float(yv.shape[0]), device="cuda")
            for m in range(n_model):
                gm = mm_acc(coeff.to(torch.bfloat16)[None, :], Xs[m])[0]
                parts[m].append(torch.cat([gm, torch.sum(losses).reshape(1),
                                           count.reshape(1)]))
        tots = []
        for m in range(n_model):
            tot = parts[m][0]
            for p in parts[m][1:]:  # data-rank order
                tot = tot + p
            tots.append(tot)
        c = tots[0][b + 1]
        safe = torch.clamp(c, min=1.0)
        loss = tots[0][b] / safe + reg
        new = [u.compute(w[m], tots[m][:b] / safe, cfg.step_size, it, 0.0)
               for m in range(n_model)]
        if bool(c > 0):
            hist.append(loss.to(torch.float32))
            w = [nw for nw, _ in new]
            reg = new[0][1]
            for _, r in new[1:]:
                reg = reg + r
    del blocks
    return torch.cat(w), torch.stack(hist).cpu().numpy()


def lbfgs_rank_order_reference(torch, tst, blocks, stats=False):
    """Meshed L-BFGS's arithmetic in one process on the card: every cost
    evaluation's B1 sums and every sweep's loss sums over each block, added
    in rank order, then the port's own loop; with ``stats`` the rank-order
    sum of every block's f64 totals, then the unmeshed loop from them."""
    from tpu_sgd_torch.ops.gram import GramLeastSquaresGradient as G
    from tpu_sgd_torch.ops.gram import _acc_totals, _sum_carries

    g = tst.LeastSquaresGradient()
    d = blocks[0][0].shape[1]
    opt = _mesh_lbfgs(tst)
    reg = MESH_QN_REG
    w0 = torch.zeros(d, device="cuda")

    def rank_order(parts):
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        return tot

    if stats:
        B = min(8192, blocks[0][0].shape[0])
        tot = rank_order([torch.cat([t.reshape(-1) for t in _acc_totals(
            _sum_carries(d, "cuda"), Xb, yb, B)]) for Xb, yb in blocks])
        n = sum(Xb.shape[0] for Xb, _ in blocks)
        gram = G(G.totals_only_data(
            tot[:d * d].reshape(d, d).to(torch.float32), tot[d * d:d * d + d],
            tot[-1], n, d, blocks[0][0].dtype))
        return opt.set_gradient(gram).optimize_with_history(
            (gram.data, blocks[0][1]), w0)

    def cost1(w):
        tot = rank_order([torch.cat([gs, ls.reshape(1), cs.reshape(1)])
                          for gs, ls, cs in (g.batch_sums(Xb, yb, w)
                                             for Xb, yb in blocks)])
        return (tot[d] / tot[d + 1] + 0.5 * reg * torch.sum(w * w, dim=-1),
                tot[:d] / tot[d + 1] + reg * w)

    def sweep1(W):
        tot = rank_order([torch.cat([ls, cs.reshape(1)])
                          for ls, cs in (g.loss_sweep(Xb, yb, W)
                                         for Xb, yb in blocks)])
        T = W.shape[0]
        return tot[:T] / tot[T] + 0.5 * reg * torch.sum(W * W, dim=-1)

    return opt._qn_loop(w0, cost1, sweep1, None)


def mesh_resident_checks(torch, tst, ck, X, y, blocks, reports, arrays,
                         single, objective, sparse_owlqn):
    """The parent's side of (e)-(i), after the rank job (the ranks' memory
    is free): each rank's report checked, and rank 0's arrays (every rank's
    are bitwise equal, checked by the caller) against the one-process
    rank-order references and against one device on the parent's whole
    matrix.  ``single``: the single-device full-batch run; ``objective``:
    the single-device sampled runs' objectives; ``sparse_owlqn``: ``(X_sp,
    y_sp, leg (d)'s weights)``.  Returns the report."""
    from tpu_sgd_torch.optimize import normal

    a0, out = arrays[0], {}
    n_data, n_model = MESH2D
    rows2 = FULL_ROWS // n_data
    dev = "cuda"
    # (e) the 2-D mesh
    for rep in reports:
        e = rep["e"]
        for where in ("prefix", "full"):
            for mode, r in e[where].items():
                check(not any(r["launches"].values())
                      and r["products"] == 2 * MESH_ITERS,
                      f"mesh 2-D {where} {mode} rank {rep['rank']}: "
                      f"launches {r['launches']}, {r['products']} products")
    for r, a in enumerate(arrays):
        peer = arrays[r - r % n_model]  # the first rank of its data row
        for mode in ("full", "bernoulli", "sliced"):
            col = arrays[r % n_model][f"e_block_{mode}_w"]
            check(np.array_equal(a[f"e_block_{mode}_w"], col),
                  f"mesh 2-D {mode}: rank {r}'s block differs from its "
                  "model column's")
            check(np.array_equal(a[f"e_full_{mode}_w"],
                                 peer[f"e_full_{mode}_w"]),
                  f"mesh 2-D {mode}: rank {r}'s weights differ")
    e_out = {"prefix_bitwise_rank_order_sum": {},
             "full_bitwise_rank_order_sum": {}, "objective_ratio": {}}
    prefix = [(X[s * rows2:s * rows2 + MESH2D_PREFIX_ROWS],
               y[s * rows2:s * rows2 + MESH2D_PREFIX_ROWS])
              for s in range(n_data)]
    full = [(X[s * rows2:(s + 1) * rows2], y[s * rows2:(s + 1) * rows2])
            for s in range(n_data)]
    for mode in ("full", "bernoulli", "sliced"):
        for key, shards in (("prefix", prefix), ("full", full)):
            w, h = rank_order_reference_2d(torch, tst, shards, mode)
            same = (np.array_equal(a0[f"e_{key}_{mode}_w"], w.cpu().numpy())
                    and np.array_equal(a0[f"e_{key}_{mode}_h"], h))
            check(same, f"mesh 2-D {key} {mode}: not the one-process "
                  "rank-order sum")
            e_out[f"{key}_bitwise_rank_order_sum"][mode] = same
            del w
        torch.cuda.empty_cache()
        ours = ls_objective_exact(torch, X, y, torch.as_tensor(
            a0[f"e_full_{mode}_w"], device=dev))
        ref = objective["full" if mode == "full" else mode]
        e_out["objective_ratio"][mode] = ours / ref
    _check_objective_ratios(e_out["objective_ratio"], "full", "mesh 2-D")
    e_out["full_batch_history_max_rel"] = _rel_max(a0["e_full_full_h"],
                                                   single["h"])
    e_out["full_batch_first_loss_rel"] = _rel_max(a0["e_full_full_h"][:1],
                                                  single["h"][:1])
    check(e_out["full_batch_first_loss_rel"] <= MESH_HISTORY_RTOL
          and e_out["full_batch_history_max_rel"] <= MESH_FULL_HISTORY_RTOL,
          f"mesh 2-D full batch against one device: {e_out}")
    r0 = reports[0]["e"]
    e_out.update(
        ms_per_iteration_by_rank={mode: [rep["e"]["full"][mode][
            "ms_per_iteration"] for rep in reports] for mode in r0["full"]},
        prefix_ms_per_iteration_rank0={
            mode: r0["prefix"][mode]["ms"] for mode in r0["prefix"]},
        margin_combine_by_rank={k: [rep["e"]["margin_combine"][k]["ms"]
                                    for rep in reports]
                                for k in r0["margin_combine"]},
        margin_combine_bytes_per_rank={
            k: v["bytes_per_rank"] for k, v in r0["margin_combine"].items()},
        launches_dense=0, products_per_iteration=2)
    out["e"] = e_out
    # (f) meshed L-BFGS
    for rep in reports:
        f = rep["f"]
        check(f["repeat_bitwise"], f"mesh L-BFGS rank {rep['rank']}: two "
              "runs differ")
        check(f["b1_launches"] == f["cost_evaluations"]
              and f["b1_routes"]["window"] == f["cost_evaluations"],
              f"mesh L-BFGS rank {rep['rank']}: {f['b1_launches']} B1 "
              f"launches ({f['b1_routes']}) for {f['cost_evaluations']} "
              "cost evaluations")
    w, h = lbfgs_rank_order_reference(torch, tst, blocks)
    f_same = (np.array_equal(a0["f_w"], w.cpu().numpy())
              and np.array_equal(a0["f_h"], h))
    check(f_same, "mesh L-BFGS: not the one-process rank-order sum")
    ws, hs = _mesh_lbfgs(tst).optimize_with_history(
        (X, y), torch.zeros(FULL_D, device=dev))
    check(len(hs) == len(a0["f_h"]), f"mesh L-BFGS: {len(a0['f_h'])} "
          f"evaluations, one device {len(hs)}")
    L_single = _qn_objective(torch, X, y, ws)
    L_mesh = _qn_objective(torch, X, y, torch.as_tensor(a0["f_w"],
                                                          device=dev))
    f_out = {"bitwise_rank_order_sum": f_same,
             "history_max_rel": _rel_max(a0["f_h"], hs),
             "objective_ratio": L_mesh / L_single,
             "cost_evaluations": reports[0]["f"]["cost_evaluations"],
             "b1_launches_rank0": reports[0]["f"]["b1_launches"],
             "ms_per_iteration_by_rank": [rep["f"]["ms_per_iteration"]
                                          for rep in reports]}
    check(f_out["history_max_rel"] <= MESH_FULL_HISTORY_RTOL
          and abs(f_out["objective_ratio"] - 1) <= MESH_FULL_OBJECTIVE_TOL,
          f"mesh L-BFGS against one device: {f_out}")
    out["f"] = f_out
    # (g) meshed normal equations
    parts = []
    for Xb, yb in blocks:
        A, b, yy = normal._gram_sums_wide(Xb, yb.to(torch.bfloat16).to(
            torch.float32))
        parts.append(torch.cat([A.reshape(-1), b, yy.reshape(1),
                                torch.full((1,), float(Xb.shape[0]),
                                           dtype=torch.float64, device=dev)]))
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    d = FULL_D
    w_ref, _ = normal._solve(tot[:d * d].reshape(d, d).float(),
                             tot[d * d:d * d + d].float(), tot[-2].float(),
                             tot[-1].float(), 0.0)
    g_same = np.array_equal(a0["g_w"], w_ref.cpu().numpy())
    check(g_same, "mesh normal equations: not the rank-order sum")
    w_one = tst.NormalEquations().optimize(
        (X, y.to(torch.bfloat16).to(torch.float32)),
        torch.zeros(d, device=dev))
    g_rel = float(torch.linalg.vector_norm(
        torch.as_tensor(a0["g_w"], device=dev) - w_one)
        / torch.linalg.vector_norm(w_one))
    check(g_rel <= MESH_NORMAL_RTOL, f"mesh normal equations: {g_rel} "
          "from one device")
    out["g"] = {"bitwise_rank_order_sum": g_same, "rel_to_one_device": g_rel,
                "seconds_by_rank": [rep["g"]["seconds"] for rep in reports]}
    # (h) meshed statistics
    h_out = {"bitwise_rank_order_sum": {}}
    grams = [tst.GramLeastSquaresGradient.build(Xb, yb, block_rows=GRAM_BLOCK)
             for Xb, yb in blocks]
    for key, aligned in (("exact", False), ("aligned", True)):
        for rep in reports:
            hr = rep["h"][key]
            check(hr["engaged"] and not any(hr["launches"].values()),
                  f"mesh statistics {key} rank {rep['rank']}: {hr}")
        gs = [tst.GramLeastSquaresGradient(gr.data, aligned=aligned)
              for gr in grams]
        w, h = rank_order_reference(
            torch, tst, [(gr.data, yb) for gr, (_, yb) in zip(grams, blocks)],
            "sliced", grads=gs)
        same = (np.array_equal(a0[f"h_{key}_w"], w.cpu().numpy())
                and np.array_equal(a0[f"h_{key}_h"], h))
        check(same, f"mesh statistics {key}: not the rank-order sum")
        h_out["bitwise_rank_order_sum"][key] = same
    del grams, gs
    torch.cuda.empty_cache()
    # as phase gram (c): the history against the stock windows summed in
    # f32 (the meshed run's own windows, rank order, w not rounded to
    # bf16), the objective against (b)'s stock run (the bf16 kernel)
    _, h_f32 = rank_order_reference(
        torch, tst, blocks, "sliced",
        grads=[_exact_window_gradient(torch, tst)] * len(blocks))
    h_out["history_max_rel_vs_f32_windows"] = _rel_max(a0["h_exact_h"],
                                                       h_f32)
    h_out["history_max_rel_vs_bf16_kernel_run"] = _rel_max(
        a0["h_exact_h"], a0["sliced_h"])
    stock = ls_objective_exact(torch, X, y, torch.as_tensor(
        a0["sliced_w"], device=dev))
    h_out["objective_ratio_vs_stock"] = {
        key: ls_objective_exact(torch, X, y, torch.as_tensor(
            a0[f"h_{key}_w"], device=dev)) / stock
        for key in ("exact", "aligned")}
    check(h_out["history_max_rel_vs_f32_windows"] <= MESH_STATS_RTOL
          and max(h_out["objective_ratio_vs_stock"].values())
          <= MESH_OBJECTIVE_RATIO,
          f"mesh statistics against the stock sliced run: {h_out}")
    w, h = lbfgs_rank_order_reference(torch, tst, blocks, stats=True)
    h_out["lbfgs_bitwise_rank_order_sum"] = (
        np.array_equal(a0["h_lbfgs_w"], w.cpu().numpy())
        and np.array_equal(a0["h_lbfgs_h"], h))
    check(h_out["lbfgs_bitwise_rank_order_sum"],
          "mesh statistics L-BFGS: not the rank-order sum of the totals")
    L_stats = _qn_objective(torch, X, y, torch.as_tensor(a0["h_lbfgs_w"],
                                                         device=dev))
    h_out["lbfgs_objective_ratio_vs_one_device"] = L_stats / L_single
    check(L_stats <= L_single * (1 + 1e-4), "mesh statistics L-BFGS: "
          f"objective {L_stats} above one device's {L_single} x (1 + 1e-4)")
    for rep in reports:
        check(not any(rep["h"]["lbfgs"]["launches"].values()),
              f"mesh statistics L-BFGS rank {rep['rank']}: launches")
    h_out.update(
        stack_bytes_rank0=reports[0]["h"]["exact"]["stack_bytes"],
        peak_extra_bytes_by_rank=[rep["h"]["exact"]["peak_extra_bytes"]
                                  for rep in reports],
        seconds_rank0={k: reports[0]["h"][k]["seconds"]
                       for k in ("exact", "aligned", "lbfgs")})
    out["h"] = h_out
    # (i) residency, feature scaling, sparse OWL-QN
    for rep in reports:
        ir = rep["i"]
        check(ir["residency_warned"] and ir["residency_bitwise_superstep"]
              and ir["residency_events"] == MESH_RES_ITERS,
              f"mesh residency rank {rep['rank']}: {ir}")
    Xp = torch.cat([Xb[:MESH_PREFIX_ROWS] for Xb, _ in blocks])
    yp = torch.cat([yb[:MESH_PREFIX_ROWS] for _, yb in blocks])
    alg = tst.LinearRegressionWithSGD(0.5, MESH_ITERS, None, 1.0)
    alg.set_feature_scaling(True).set_schedule("off")
    alg.optimizer.set_convergence_tol(0.0)
    w_sc = alg.run((Xp, yp)).weights
    i_out = {"residency_bitwise_superstep": True,
             "scaled_history_max_rel": _rel_max(
                 a0["i_scaled_h"], np.asarray(alg.optimizer.loss_history)),
             "scaled_objective_ratio": ls_objective_exact(
                 torch, Xp, yp, torch.as_tensor(a0["i_scaled_w"],
                                                device=dev))
             / ls_objective_exact(torch, Xp, yp, w_sc)}
    check(i_out["scaled_history_max_rel"] <= MESH_FULL_HISTORY_RTOL
          and abs(i_out["scaled_objective_ratio"] - 1)
          <= MESH_FULL_OBJECTIVE_TOL,
          f"mesh feature scaling against one device: {i_out}")
    del Xp, yp
    X_sp, y_sp, w_d = sparse_owlqn
    Xsc, ysh = _scipy_csr(X_sp), y_sp.cpu().numpy()
    i_out["owlqn_objective_ratio"] = (
        _hinge_objective_sparse(Xsc, ysh, a0["i_owlqn_w"], 1e-5)
        / _hinge_objective_sparse(Xsc, ysh, w_d.cpu().numpy(), 1e-5))
    i_out["owlqn_iterations"] = reports[0]["i_sparse"]["iterations"]
    i_out["owlqn_seconds_rank0"] = reports[0]["i_sparse"]["seconds"]
    check(abs(i_out["owlqn_objective_ratio"] - 1)
          <= MESH_OWLQN_OBJECTIVE_TOL,
          f"mesh sparse OWL-QN against leg (d): {i_out}")
    for rep in reports:
        sr = rep["i_sparse"]
        check(sr["csr_launches"].get("csr_margins/30", 0) > 0
              and not any(sr["dense_launches"].values()),
              f"mesh sparse OWL-QN rank {rep['rank']}: {sr}")
    out["i"] = i_out
    return out


# -- phase mesh, parts (j)-(m): host-streamed training on a mesh -------------

MESH_STREAM_PREFIX = 1_000_000  # host rows of the bitwise contracts
MESH_STREAM_ITERS = 10          # a bitwise run
MESH_STREAM_TIMING_ITERS = 3    # (j)'s timing runs, cut in depth for time
MESH_STREAM_STOP_ITERS = 20     # the stop-and-resume runs (stop at 13)
MESH_TOPK = "topk:0.01"
# full batch on the prefix: error feedback at 1% of the coordinates meets
# the dense wire's objective within 1.01x after about 500 iterations (a
# numpy model of the run at 16,000 x 1000 read 1.011x at 500)
MESH_TOPK_ITERS = 600
MESH_TOPK_RATIO = 1.01
# a rank's resident host memory grows by the pages of the shared rows it
# reads (its share, about 1/8) and by its rings, never by the 20 GB
MESH_HOST_GROWTH_LIMIT = 10e9
MESH_TOTALS_RTOL = 1e-6         # the compressed merge against the dense
MESH_STREAMED_QN_RTOL = 1e-5    # (m) against the single-device results


def _proc_status() -> dict:
    """The process's resident host memory, bytes: ``VmRSS`` and, where the
    kernel reports them, ``RssAnon`` / ``RssFile`` / ``RssShmem``
    (``/proc/self/status``), and ``statm``'s resident and shared pages
    (their difference: the private pages, where ``RssAnon`` is not
    reported)."""
    keys = {"VmRSS": "rss", "RssAnon": "anon", "RssFile": "file",
            "RssShmem": "shmem"}
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            k = line.split(":")[0]
            if k in keys:
                out[keys[k]] = int(line.split()[1]) * 1024
    try:
        with open("/proc/self/statm") as f:
            _, resident, shared = (int(v) for v in f.read().split()[:3])
        page = os.sysconf("SC_PAGE_SIZE")
        out["statm_resident"] = resident * page
        out["statm_private"] = (resident - shared) * page
    except (OSError, ValueError):
        pass
    return out


def _private_bytes(status: dict):
    """Private resident bytes: ``RssAnon``, else ``statm``'s resident less
    shared, else None."""
    return status.get("anon", status.get("statm_private"))


def shared_host_rows(torch, X, chunk=500_000):
    """``X`` copied from the card into host memory that other processes
    map: a ``memfd``, written chunk by chunk from a pinned staging buffer
    (``os.pwrite``: no page fault a page), then mapped shared and
    populated.  The mesh ranks of phase ``mesh`` map the same pages
    (``torch.from_file`` of ``/proc/self/fd/<fd>``, the fd passed to
    them; lazily, so a rank's resident memory shows what it reads), and
    eight ranks read one copy of the 20 GB.  Returns ``(Xh, fd)``."""
    n, d = X.shape
    row = d * X.element_size()
    fd = os.memfd_create("chip_smoke_rows")
    os.ftruncate(fd, n * row)
    stage = torch.empty((min(chunk, n), d), dtype=X.dtype,
                        pin_memory=X.is_cuda)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        stage[:e - s].copy_(X[s:e])
        buf = memoryview(stage[:e - s].view(torch.uint8).numpy()).cast("B")
        done = 0
        while done < len(buf):
            done += os.pwrite(fd, buf[done:], s * row + done)
    del stage
    # this process maps it populated: it reads every row in phase
    # streamed, and faulting the pages in one at a time took 20 s over
    # the 20 GB on the card's host
    mm = mmap.mmap(fd, n * row, flags=mmap.MAP_SHARED | getattr(
        mmap, "MAP_POPULATE", 0))
    return torch.frombuffer(mm, dtype=X.dtype).view(n, d), fd


def _stream_mesh_opt(tst, mesh, mode, frac, iters, k=1, depth=2, wc=None):
    """Phase ``streamed``'s least-squares run (step 0.5) streamed from the
    host rows on ``mesh`` (None: one device)."""
    opt = (tst.GradientDescent().set_step_size(0.5).set_num_iterations(iters)
           .set_mini_batch_fraction(frac)
           .set_sampling("bernoulli" if mode == "full" else mode)
           .set_convergence_tol(0.0).set_host_streaming(True)
           .set_superstep(k).set_ingest_options(prefetch_depth=depth,
                                                wire_compress=wc))
    return opt.set_mesh(mesh) if mesh is not None else opt


def _mode_frac(mode):
    return 1.0 if mode == "full" else FRAC


def _stream_stop_resume(torch, tst, mesh, X, y, w0, ckdir, wc=None):
    """A Bernoulli run on ``X`` stopped by the last rank's signal alone at
    ``MESH_OBS_STOP_AT`` (every rank stops there: the poll is agreed), then
    resumed from rank 0's checkpoint: against the uninterrupted run."""
    from tpu_sgd_torch.reliability import TrainingPreempted
    from tpu_sgd_torch.utils import CollectingListener
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    seen = {"i": 0}

    class Seen(CollectingListener):
        def on_iteration(self, ev):
            seen["i"] = ev.iteration

    last = mesh.rank == mesh.size - 1

    def opt():
        return _stream_mesh_opt(tst, mesh, "bernoulli", FRAC,
                                MESH_STREAM_STOP_ITERS, wc=wc)

    ref = opt().optimize_with_history((X, y), w0)
    stopping = (opt().set_listener(Seen())
                .set_checkpoint(CheckpointManager(ckdir), every=5)
                .set_stop_signal(lambda: last
                                 and seen["i"] >= MESH_OBS_STOP_AT))
    try:
        stopping.optimize_with_history((X, y), w0)
        at = None
    except TrainingPreempted as e:
        at = e.iteration
    got = opt().set_checkpoint(CheckpointManager(ckdir),
                               every=5).optimize_with_history((X, y), w0)
    return {"stopped_at": at, "resumed_bitwise": _same_run(torch, ref, got)}


def _part_start(torch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), _proc_status(), time.perf_counter()


def _part_end(torch, start) -> dict:
    base, host0, t = start
    torch.cuda.synchronize()
    host = _proc_status()
    p0, p1 = _private_bytes(host0), _private_bytes(host)
    return {"seconds": time.perf_counter() - t,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "peak_device_extra_bytes": torch.cuda.max_memory_allocated()
            - base,
            "host_bytes": host,
            "host_rss_growth_bytes": host["rss"] - host0["rss"],
            "host_private_growth_bytes": (None if p0 is None or p1 is None
                                          else p1 - p0)}


def mesh_rank_streamed(torch, tst, ck, par, mesh, out_dir):
    """A rank's (j)-(m) over phase ``streamed``'s 10M x 1000 bf16 host
    rows, mapped from the parent's memfd (``streamed.json`` names it): the
    rank passes the WHOLE host dataset and streams its share.  (j) SGD:
    Bernoulli and sliced at ``FRAC`` over the 10M rows, timed; on the
    first ``MESH_STREAM_PREFIX`` rows every mode's run, again, at
    prefetch depth 0 and at K = 8, and a stop at 13 with its resume.  (k)
    The compressed wire: a prefix run, K = 8, the stop and its EF resume,
    full batch on the prefix on both wires for the matched objective, the
    compressed combine timed.  (l) L-BFGS and OWL-QN through the streamed
    CostFun, as phase ``streamed_qn`` (a) and (b), L-BFGS twice.  (m) The
    streamed statistics (the build against this rank's resident build of
    its slice; the virtual run twice; a resumed prefix build), the totals
    dense and compressed, L-BFGS from them, the streamed normal
    equations.  Returns ``(report, arrays)``."""
    from tpu_sgd_torch.io.sparse_wire import topk_nnz
    from tpu_sgd_torch.io.wire import host_tensor
    from tpu_sgd_torch.parallel.mesh import combine_topk
    from tpu_sgd_torch.reliability import failpoints as fp

    with open(os.path.join(out_dir, "streamed.json")) as f:
        spec = json.load(f)
    n, d = spec["shape"]
    Xh = torch.from_file(f"/proc/self/fd/{spec['fd']}", shared=True,
                         size=n * d, dtype=torch.bfloat16).view(n, d)
    ys = {k: host_tensor(np.load(os.path.join(out_dir, f"{k}.npy"),
                                 mmap_mode="r"))
          for k in ("y", "y_ls", "y_log")}
    rank, world = mesh.rank, mesh.size
    w0 = torch.zeros(d, device="cuda")
    res, arrays = {"host_at_start": _proc_status()}, {}
    P = MESH_STREAM_PREFIX
    Xp, yp = Xh[:P], ys["y"][:P]

    # (j) streamed SGD
    start = _part_start(torch)
    j = {"timing": {}, "prefix": {}}
    for mode in ("bernoulli", "sliced"):
        opt = _stream_mesh_opt(tst, mesh, mode, FRAC,
                               MESH_STREAM_TIMING_ITERS)
        ck.reset_launch_counts()
        (w, h), secs = _timed(torch, lambda: opt.optimize_with_history(
            (Xh, ys["y"]), w0))
        j["timing"][mode] = {
            "ms_per_iteration": 1e3 * secs / MESH_STREAM_TIMING_ITERS,
            "launches": ck.launch_counts(),
            "routes": ck.gradient_route_counts(),
            "loss_first": float(h[0]), "loss_last": float(h[-1])}
    j["combine_ms"] = _combine_ms(torch, par, mesh, reps=20)
    for mode in ("bernoulli", "indexed", "sliced", "full"):
        runs = {}
        for key, kw in (("first", {}), ("again", {}), ("depth0", {"depth": 0}),
                        ("k8", {"k": 8})):
            runs[key] = _stream_mesh_opt(
                tst, mesh, mode, _mode_frac(mode), MESH_STREAM_ITERS,
                **kw).optimize_with_history((Xp, yp), w0)
        j["prefix"][mode] = {key: _same_run(torch, runs["first"], runs[key])
                             for key in ("again", "depth0", "k8")}
        arrays[f"j_{mode}_w"] = runs["first"][0].cpu().numpy()
        arrays[f"j_{mode}_h"] = runs["first"][1]
    j["stop"] = _stream_stop_resume(torch, tst, mesh, Xp, yp, w0,
                                    os.path.join(out_dir, "ck_j"))
    res["j"] = {**j, **_part_end(torch, start)}

    # (k) the compressed wire
    start = _part_start(torch)
    kp = {}
    first = _stream_mesh_opt(tst, mesh, "bernoulli", FRAC, MESH_STREAM_ITERS,
                             wc=MESH_TOPK).optimize_with_history((Xp, yp),
                                                                 w0)
    k8 = _stream_mesh_opt(tst, mesh, "bernoulli", FRAC, MESH_STREAM_ITERS,
                          k=8, wc=MESH_TOPK).optimize_with_history((Xp, yp),
                                                                   w0)
    kp["k8_bitwise"] = _same_run(torch, first, k8)
    arrays["k_w"], arrays["k_h"] = first[0].cpu().numpy(), first[1]
    kp["stop"] = _stream_stop_resume(torch, tst, mesh, Xp, yp, w0,
                                     os.path.join(out_dir, "ck_k"),
                                     wc=MESH_TOPK)
    for wire, wc in (("dense", None), ("topk", MESH_TOPK)):
        opt = _stream_mesh_opt(tst, mesh, "full", 1.0, MESH_TOPK_ITERS, k=8,
                               wc=wc)
        (w, h), secs = _timed(torch, lambda: opt.optimize_with_history(
            (Xp, yp), w0))
        kp[f"full_{wire}_ms_per_iteration"] = 1e3 * secs / MESH_TOPK_ITERS
        arrays[f"k_full_{wire}_w"] = w.cpu().numpy()
        arrays[f"k_full_{wire}_h"] = h
    kk = topk_nnz(d, float(MESH_TOPK.split(":")[1]))
    kp["k"] = kk
    # each rank's bytes on the wire an iteration: the loss and count (two
    # f32) and its segment (k f32 values, k int32 indices), beside the
    # dense combine's d + 2 f32
    kp["gathered_bytes_per_rank_iteration"] = {
        "topk": 8 + 8 * kk, "dense": 4 * (d + 2)}
    gen = torch.Generator(device="cuda").manual_seed(41 + rank)
    vals = torch.randn(kk, generator=gen, device="cuda")
    idx = torch.randperm(d, generator=gen, device="cuda")[:kk]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        combine_topk(mesh, vals, idx, d)
    torch.cuda.synchronize()
    kp["combine_topk_ms"] = 1e3 * (time.perf_counter() - t) / 20
    res["k"] = {**kp, **_part_end(torch, start)}

    # (l) L-BFGS and OWL-QN through the streamed CostFun
    start = _part_start(torch)
    lp = {"runs": []}
    for _ in range(2):
        opt = tst.LBFGS(tst.LogisticGradient(), tst.SquaredL2Updater(),
                        reg_param=1e-4, convergence_tol=0.0,
                        max_num_iterations=STREAMED_QN_ITERS) \
            .set_mesh(mesh).set_host_streaming(True)
        ck.reset_launch_counts()
        (w, h), secs = _timed(torch, lambda: opt.optimize_with_history(
            (Xh, ys["y_log"]), w0))
        scf = opt._stream_costfun_entry[2]
        partial = sum(1 for s, e in map(scf._span, range(scf.n_chunks))
                      if e - s < scf.share)
        lp["runs"].append({
            "seconds": secs, "cost_evaluations": len(h),
            "ms_per_iteration": 1e3 * secs / max(1, len(h) - 1),
            "launches": ck.launch_counts(),
            "routes": ck.gradient_route_counts(),
            "chunks": scf.n_chunks, "cap": scf.cap, "share": scf.share,
            "partial_shares": partial, "pinned_bytes": scf._ring.pinned_bytes})
        if len(lp["runs"]) == 1:
            first = (w, h)
        opt.release_sufficient_stats()
        del opt, scf
    lp["repeat_bitwise"] = _same_run(torch, first, (w, h))
    arrays["l_w"], arrays["l_h"] = first[0].cpu().numpy(), first[1]
    rows = STREAMED_OWLQN_ROWS
    (w, h), secs = _timed(torch, lambda: tst.OWLQN(
        tst.LogisticGradient(), reg_param=1e-4, convergence_tol=0.0,
        max_num_iterations=STREAMED_OWLQN_ITERS).set_mesh(mesh)
        .set_host_streaming(True).optimize_with_history(
            (Xh[:rows], ys["y_log"][:rows]), w0))
    lp["owlqn_seconds"] = secs
    arrays["l_owlqn_w"], arrays["l_owlqn_h"] = w.cpu().numpy(), h
    res["l"] = {**lp, **_part_end(torch, start)}

    # (m) streamed statistics and totals
    start = _part_start(torch)
    mp = {}
    B = GRAM_BLOCK
    y_ls = ys["y_ls"]

    def gd():
        return (tst.GradientDescent().set_step_size(0.5)
                .set_num_iterations(MESH_ITERS).set_mini_batch_fraction(FRAC)
                .set_sampling("sliced").set_convergence_tol(0.0)
                .set_mesh(mesh).set_streamed_stats(True, block_rows=B))

    opt = gd()
    ck.reset_launch_counts()
    first, secs = _timed(torch, lambda: opt.optimize_with_history(
        (Xh, y_ls), w0))
    again, secs2 = _timed(torch, lambda: opt.optimize_with_history(
        (Xh, y_ls), w0))
    data, B_used, n_used, _ = opt._streamed_gram_dp_entry[3]
    mp.update(run_with_build_seconds=secs, run_seconds=secs2,
              build_seconds=secs - secs2, block_rows=B_used, rows=n_used,
              launches=ck.launch_counts(),
              repeat_bitwise=_same_run(torch, first, again),
              stack_bytes=data.PG.numel() * data.PG.element_size(),
              peak_device_extra_bytes_with_build=(
                  torch.cuda.max_memory_allocated() - start[0]))
    arrays["m_w"], arrays["m_h"] = first[0].cpu().numpy(), first[1]
    s = rank * (n // world)
    Xr = Xh[s:s + n_used].to("cuda")
    yr = y_ls[s:s + n_used].to("cuda")
    g_r = tst.GramLeastSquaresGradient.build(Xr, yr, block_rows=B)
    mp["stack_equals_resident_bitwise"] = all(
        torch.equal(getattr(data, leaf), getattr(g_r.data, leaf))
        for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"))
    del Xr, yr, g_r, data
    opt.release_sufficient_stats()
    del opt
    torch.cuda.empty_cache()
    # a resumed prefix build: each rank stopped in its feed
    yp_ls = y_ls[:P]
    kw = dict(block_rows=B, batch_rows=2 * B)
    ref, _, _ = par.build_streamed_sharded_gram_stats(mesh, Xp, yp_ls, **kw)
    rd = os.path.join(out_dir, "m_resume")
    with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(3)}):
        try:
            par.build_streamed_sharded_gram_stats(mesh, Xp, yp_ls,
                                                  resume_dir=rd, **kw)
            mp["resume_stopped"] = False
        except fp.FaultInjected:
            mp["resume_stopped"] = True
    got, _, _ = par.build_streamed_sharded_gram_stats(mesh, Xp, yp_ls,
                                                      resume_dir=rd, **kw)
    mp["resumed_bitwise"] = all(
        torch.equal(getattr(got, leaf), getattr(ref, leaf))
        for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"))
    del ref, got
    # L-BFGS from the meshed totals (their dense merge), then the
    # compressed merge beside it, then the normal equations
    lb = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                   max_num_iterations=QN_ITERS, convergence_tol=0.0) \
        .set_mesh(mesh).set_streamed_stats(True)
    (w, h), secs = _timed(torch, lambda: lb.optimize_with_history(
        (Xh, y_ls), w0))
    dense = lb._streamed_gram_entry[2].data
    mp["lbfgs_seconds_with_build"] = secs
    arrays["m_lbfgs_w"], arrays["m_lbfgs_h"] = w.cpu().numpy(), h
    arrays["m_G"] = dense.G_tot.cpu().numpy()
    arrays["m_b"] = dense.b_tot.cpu().numpy()
    arrays["m_yy"] = dense.yy_tot.reshape(1).cpu().numpy()
    comp, secs = _timed(torch, lambda: par.build_streamed_total_stats(
        mesh, Xh, y_ls, wire_compress=MESH_TOPK))
    mp["compressed_totals_seconds"] = secs
    scale = max(float(dense.G_tot.double().abs().max()),
                float(dense.b_tot.abs().max()), float(dense.yy_tot.abs()))
    mp["compressed_max_abs_over_scale"] = max(
        float((comp.G_tot.double() - dense.G_tot.double()).abs().max()),
        float((comp.b_tot - dense.b_tot).abs().max()),
        float((comp.yy_tot - dense.yy_tot).abs())) / scale
    lb.release_sufficient_stats()
    del lb, dense, comp
    w, secs = _timed(torch, lambda: tst.NormalEquations().set_mesh(mesh)
                     .set_host_streaming(True).optimize((Xh, y_ls), w0))
    mp["normal_seconds"] = secs
    arrays["m_normal_w"] = w.cpu().numpy()
    res["m"] = {**mp, **_part_end(torch, start)}
    return res, arrays


def streamed_rank_order_reference(torch, tst, Xh, yh, cfg, k, topk=None):
    """The meshed streamed run's arithmetic in one process on the card:
    iteration ``i``'s global sample (``HostSampler``), each rank's share
    staged as the ranks stage it (padding rows zero, or row 0 for a
    gather, never valid) and summed by B1 with its valid mask, the sums
    (or the loss and count, then each rank's top-k segment of its
    error-feedback accumulator) added in rank order, then the update
    (least squares, simple updater)."""
    from tpu_sgd_torch.io.sparse_wire import topk_indices, topk_nnz
    from tpu_sgd_torch.optimize.streamed import HostSampler

    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    dev = "cuda"
    n, d = Xh.shape
    sm = HostSampler(cfg, n, 0, k)
    share = sm.share
    w = torch.zeros(d, device=dev)
    _, reg0 = u.compute(w, torch.zeros_like(w), 0.0, 1, cfg.reg_param)
    reg = torch.full((), float(reg0), device=dev)
    efs = [torch.zeros(d, device=dev) for _ in range(k)]
    hist = []
    for i in range(1, cfg.num_iterations + 1):
        draw = sm.draw(i)
        sums = []
        for r in range(k):
            lo = r * share
            Xs = torch.zeros((share, d), dtype=Xh.dtype, device=dev)
            ysh = torch.zeros((share,), device=dev)
            if draw[0] in ("full", "window"):
                count, s0 = ((n, 0) if draw[0] == "full"
                             else (sm.m, draw[1]))
                a, b = min(lo, count), min(lo + share, count)
                Xs[:b - a] = Xh[s0 + a:s0 + b].to(dev)
                ysh[:b - a] = yh[s0 + a:s0 + b].to(dev)
                v = b - a
            else:
                idx = torch.from_numpy(draw[1][lo:lo + share])
                Xs.copy_(torch.index_select(Xh, 0, idx))
                ysh.copy_(torch.index_select(yh, 0, idx))
                v = min(max(draw[2] - lo, 0), share)
            mask = torch.arange(share, device=dev) < v
            sums.append(g.batch_sums(Xs, ysh, w, mask))
        it = torch.full((1,), i, dtype=torch.int64, device=dev)
        if topk is None:
            parts = [torch.cat([gs, ls.reshape(1), cs.reshape(1)])
                     for gs, ls, cs in sums]
        else:
            parts = [torch.cat([ls.reshape(1), cs.reshape(1)])
                     for _, ls, cs in sums]
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        c = tot[-1]
        safe = torch.clamp(c, min=1.0)
        loss = tot[-2] / safe + reg
        if topk is None:
            step = tot[:d] / safe
        else:
            step = torch.zeros(d, device=dev)
            new_efs = []
            for (gs, _, _), ef in zip(sums, efs):
                acc = ef + gs / safe
                top = topk_indices(acc, topk_nnz(d, topk))
                step.index_put_((top,), step.index_select(0, top)
                                + acc.index_select(0, top))
                new_efs.append(acc.index_fill(0, top, 0.0))
        new_w, new_reg = u.compute(w, step, cfg.step_size, it, cfg.reg_param)
        if bool(c > 0):
            # graftlint: disable=host-sync -- chip check: reads each case back to compare it
            hist.append(float(loss))
            w, reg = new_w, new_reg
            if topk is not None:
                efs = new_efs
    return w, np.asarray(hist, np.float32)


def _totals_objective(G, b, yy, n, w) -> float:
    """The least-squares objective of ``w`` from total statistics, in
    f64: ``(wᵀGw - 2bᵀw + yy) / 2n``."""
    G = np.asarray(G, np.float64)
    w = np.asarray(w, np.float64)
    return float((w @ G @ w - 2 * np.asarray(b, np.float64) @ w
                  + float(np.asarray(yy).reshape(-1)[0])) / (2 * n))


def mesh_streamed_checks(torch, tst, ck, Xh, yh, yh_ls, reports, arrays,
                         qn_refs):
    """The parent's side of (j)-(m), after the job: the one-process
    rank-order references on the card (bitwise), the single-device
    streamed runs on the same prefix, phase ``streamed_qn``'s results, the
    launches, the rank's host memory; then B1 at the new per-rank shapes
    for the kernel table.  Returns ``(record, kernel rows)``."""
    from tpu_sgd_torch.optimize.streamed import HostSampler

    world = len(reports)
    a0, r0 = arrays[0], reports[0]["streamed"]
    n, d = Xh.shape
    P = MESH_STREAM_PREFIX
    Xp, yp = Xh[:P], yh[:P]
    Xpc, ypc = Xp.to("cuda"), yp.to("cuda")
    out = {"ranks": world}
    for rep in reports:
        s = rep["streamed"]
        for part in ("j", "k", "l", "m"):
            grew = s[part]["host_rss_growth_bytes"]
            check(grew < MESH_HOST_GROWTH_LIMIT,
                  f"mesh ({part}) rank {rep['rank']}: resident host memory "
                  f"grew by {grew} bytes")
        for mode, t in s["j"]["timing"].items():
            check(t["launches"]["fused_gradient_sums"]
                  == MESH_STREAM_TIMING_ITERS
                  and t["routes"]["fused_sums"] == 0,
                  f"mesh (j) rank {rep['rank']} {mode}: {t['launches']} "
                  f"{t['routes']}")
        for mode, flags in s["j"]["prefix"].items():
            check(all(flags.values()), f"mesh (j) rank {rep['rank']} "
                  f"{mode}: {flags}")
        for part in ("j", "k"):
            st = s[part]["stop"]
            check(st["stopped_at"] == MESH_OBS_STOP_AT
                  and st["resumed_bitwise"],
                  f"mesh ({part}) rank {rep['rank']}: stop {st}")
        check(s["k"]["k8_bitwise"], f"mesh (k) rank {rep['rank']}: K = 8")
        for run in s["l"]["runs"]:
            evals, chunks = run["cost_evaluations"], run["chunks"]
            masked = run["partial_shares"] * evals
            check(run["launches"]["fused_gradient_sums"] == chunks * evals
                  and run["routes"]["window"] == chunks * evals - masked
                  and run["routes"]["gather"] == masked
                  and run["routes"]["fused_sums"] == 0,
                  f"mesh (l) rank {rep['rank']}: {run}")
        check(s["l"]["repeat_bitwise"], f"mesh (l) rank {rep['rank']}: two "
              "runs differ")
        m = s["m"]
        check(m["stack_equals_resident_bitwise"] and m["repeat_bitwise"]
              and m["resume_stopped"] and m["resumed_bitwise"]
              and not any(m["launches"].values()),
              f"mesh (m) rank {rep['rank']}: {m}")
        check(m["compressed_max_abs_over_scale"] <= MESH_TOTALS_RTOL,
              f"mesh (m) rank {rep['rank']}: the compressed merge is "
              f"{m['compressed_max_abs_over_scale']} from the dense")
    # (j) against the one-process rank-order sum and one device
    j = {"rank_order_bitwise": {}, "vs_single_device": {}}
    for mode in ("bernoulli", "indexed", "sliced", "full"):
        cfg = _stream_mesh_opt(tst, None, mode, _mode_frac(mode),
                               MESH_STREAM_ITERS).config
        w, h = streamed_rank_order_reference(torch, tst, Xp, yp, cfg, world)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        same = (np.array_equal(a0[f"j_{mode}_w"], w.cpu().numpy())
                and np.array_equal(a0[f"j_{mode}_h"], h))
        check(same, f"mesh (j) {mode}: not the one-process rank-order sum")
        j["rank_order_bitwise"][mode] = same
        w1, h1 = _stream_mesh_opt(tst, None, mode, _mode_frac(mode),
                                  MESH_STREAM_ITERS).optimize_with_history(
            (Xp, yp), torch.zeros(d, device="cuda"))
        ratio = (ls_objective_exact(torch, Xpc, ypc, torch.as_tensor(
            a0[f"j_{mode}_w"], device="cuda"))
            / ls_objective_exact(torch, Xpc, ypc, w1))
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        rel = _rel_max(a0[f"j_{mode}_h"], h1)
        j["vs_single_device"][mode] = {"objective_ratio": ratio,
                                       "history_max_rel": rel}
        if mode == "full":
            check(rel <= MESH_FULL_HISTORY_RTOL
                  and abs(ratio - 1) <= MESH_FULL_OBJECTIVE_TOL,
                  f"mesh (j) full batch against one device: {rel} {ratio}")
        else:
            check(ratio <= MESH_OBJECTIVE_RATIO,
                  f"mesh (j) {mode} against one device: {ratio}")
    out["j"] = j
    # (k) the compressed wire
    cfg = _stream_mesh_opt(tst, None, "bernoulli", FRAC,
                           MESH_STREAM_ITERS).config
    w, h = streamed_rank_order_reference(
        torch, tst, Xp, yp, cfg, world,
        topk=float(MESH_TOPK.split(":")[1]))
    k_same = (np.array_equal(a0["k_w"], w.cpu().numpy())
              and np.array_equal(a0["k_h"], h))
    check(k_same, "mesh (k): not the one-process rank-order sum")
    obj = {wire: ls_objective_exact(torch, Xpc, ypc, torch.as_tensor(
        a0[f"k_full_{wire}_w"], device="cuda")) for wire in ("dense", "topk")}
    k_ratio = obj["topk"] / obj["dense"]
    check(k_ratio <= MESH_TOPK_RATIO, f"mesh (k): the compressed wire's "
          f"objective {obj['topk']} is {k_ratio}x the dense wire's")
    out["k"] = {"rank_order_bitwise": k_same, "objective": obj,
                "objective_ratio": k_ratio}
    # (l) against phase streamed_qn (a) and (b)
    l_rel = _rel_max(a0["l_h"], qn_refs["a_history"])
    check(len(a0["l_h"]) == len(qn_refs["a_history"])
          and l_rel <= MESH_HISTORY_RTOL,
          f"mesh (l) L-BFGS: history {l_rel} from streamed_qn (a)")
    o_rel = _rel_max(a0["l_owlqn_h"], qn_refs["b_history"])
    check(len(a0["l_owlqn_h"]) == len(qn_refs["b_history"])
          and o_rel <= MESH_HISTORY_RTOL,
          f"mesh (l) OWL-QN: history {o_rel} from streamed_qn (b)")
    out["l"] = {"lbfgs_history_max_rel": l_rel,
                "owlqn_history_max_rel": o_rel}
    # (m) the virtual run against its rank-order reference, the results
    # against one device's streamed ones
    n_local = n // world
    n_used = (n_local // GRAM_BLOCK) * GRAM_BLOCK
    grams = [tst.GramLeastSquaresGradient.build_streamed(
        Xh[r * n_local:r * n_local + n_used],
        yh_ls[r * n_local:r * n_local + n_used], block_rows=GRAM_BLOCK)
        for r in range(world)]
    w, h = rank_order_reference(
        torch, tst, [(g.data, yh_ls[r * n_local:r * n_local + n_used]
                      .to("cuda")) for r, g in enumerate(grams)],
        "sliced", grads=grams)
    m_same = (np.array_equal(a0["m_w"], w.cpu().numpy())
              and np.array_equal(a0["m_h"], h))
    check(m_same, "mesh (m): the virtual run is not the rank-order sum")
    del grams
    torch.cuda.empty_cache()
    L = {key: _totals_objective(a0["m_G"], a0["m_b"], a0["m_yy"], n, wv)
         for key, wv in (("mesh", a0["m_lbfgs_w"]),
                         ("one_device", qn_refs["c_lbfgs_w"]))}
    lb_ratio = L["mesh"] / L["one_device"]
    check(abs(lb_ratio - 1) <= MESH_STREAMED_QN_RTOL,
          f"mesh (m) L-BFGS from the totals: {lb_ratio} of one device's")
    w1 = qn_refs["e_normal_w"]
    ne_rel = float(np.abs(a0["m_normal_w"] - w1).max() / np.abs(w1).max())
    check(ne_rel <= MESH_STREAMED_QN_RTOL,
          f"mesh (m) normal equations: {ne_rel} from one device")
    out["m"] = {"rank_order_bitwise": m_same, "lbfgs_objective": L,
                "lbfgs_objective_ratio": lb_ratio,
                "normal_max_abs_over_scale": ne_rel}
    # B1 at the new per-rank shapes
    pw = tst.LeastSquaresGradient().pointwise
    gen = torch.Generator(device="cuda").manual_seed(43)
    w = torch.randn(d, generator=gen, device="cuda") / math.sqrt(d)
    sm = HostSampler(_stream_mesh_opt(tst, None, "bernoulli", FRAC,
                                      1).config, n, 0, world)
    live = sm.draw(1)[2] - (world - 1) * sm.share
    share = sm.share
    costfun = reports[0]["streamed"]["l"]["runs"][0]
    cs = costfun["share"]
    rows = []
    for X_, mask, path, launches, run in (
            (Xpc[:share], torch.arange(share, device="cuda") < live,
             f"mesh streamed (a rank's share of a 10% Bernoulli batch: "
             f"{share:,} rows, {live:,} live on the last rank)",
             r0["j"]["timing"]["bernoulli"]["launches"][
                 "fused_gradient_sums"],
             "rank 0's streamed Bernoulli run over the 10M host rows (j)"),
            (Xpc[:sm.m // world], torch.ones(sm.m // world, dtype=torch.bool,
                                              device="cuda"),
             f"mesh streamed (a rank's share of a sliced window: "
             f"{sm.m // world:,} rows, all valid)",
             r0["j"]["timing"]["sliced"]["launches"]["fused_gradient_sums"],
             "rank 0's streamed sliced run over the 10M host rows (j)"),
            (Xpc[:cs], None,
             f"mesh streamed_costfun (a rank's share of a chunk: {cs:,} "
             "rows)", costfun["routes"]["window"],
             "rank 0's meshed streamed L-BFGS run (l): its window route"),
            (Xpc[:cs], torch.zeros(cs, dtype=torch.bool, device="cuda"),
             f"mesh streamed_costfun (an empty share past the last row: "
             f"{cs:,} rows, none live)",
             reports[-1]["streamed"]["l"]["runs"][0]["routes"]["gather"],
             "the last rank's meshed streamed L-BFGS run (l): its gather "
             "route")):
        row = b1_row(torch, ck, pw, X_, ypc[:X_.shape[0]], w, mask, path, 50)
        row["launches"], row["launches_from"] = launches, run
        check(launches > 0, f"B1 ({path}): no launch")
        rows.append(row)
    del Xpc, ypc
    torch.cuda.empty_cache()
    return out, rows


def phase_mesh(torch, tst, ck, X_sp, y_sp, profile, sparse_owlqn_w,
               host_rows, qn_refs):
    """Phase ``mesh``: data parallelism at config 4's shape, after config
    4's matrix of phase ``full`` was freed.  The data: 10M x 1000 bf16
    least squares as 8 row blocks, each made from ``(seed, block)``
    (``fill_mesh_block``); the parent holds all 8, each rank its own.

    (a) This process as a mesh of one rank over NCCL (``mesh_world1``).
    (b) 8 ranks on the one card over gloo, subprocesses of this script:
    Bernoulli, indexed and sliced at 0.1 and full batch, each twice
    (bitwise), launches exact per rank, every rank's weights bitwise
    equal; on the first 125,000 rows of each block (1M rows), Bernoulli
    and sliced bitwise the one-process rank-order sum
    (``rank_order_reference``), and full batch over all 10M rows too;
    against the single-device run, full batch's history at
    ``MESH_FULL_HISTORY_RTOL`` (its first loss at the gradient tier) and
    its objective within ``MESH_FULL_OBJECTIVE_TOL``, each sampled run's
    objective within 1.01x.  (c) Phase ``sparse``'s CSR in 8 row blocks,
    hinge + L1 at 1.0 (the gradient tier against the single-device run,
    the objective within ``MESH_FULL_OBJECTIVE_TOL``) and 0.1 (the
    objective within 1.01x), over the same world; peak memory per rank.
    (d) The observed driver at world 1 (``mesh_observed``).
    (e)-(i) Resident training on a mesh, in the same 8-rank job after (b)
    (``mesh_rank_dense``, ``mesh_rank_2d``, ``mesh_rank_sparse_owlqn``),
    checked after it (``mesh_resident_checks``): (e) the 4 x 2 mesh, full
    batch, Bernoulli and sliced, on a 1M-row prefix through the user API
    and on all 10M rows on each rank's 2.5M x 500 block, bitwise the
    one-process 2-D rank-order sum, no fused kernel and two library
    products an iteration, full batch against one device at the full-batch
    tolerances, sampled objectives within 1.01x, the margin combine timed;
    (f) meshed L-BFGS, bitwise its rank-order reference and itself, B1
    launches = cost evaluations, against one device; (g) the meshed normal
    equations, bitwise, within ``MESH_NORMAL_RTOL`` of one device; (h)
    each rank's prefix stack, sliced exact and aligned bitwise their
    rank-order references and against (b)'s stock sliced run, L-BFGS from
    the meshed totals against one device; (i) ``set_residency`` (warns,
    bitwise the superstep run), feature scaling on the 1M-row prefix
    against one device, OWL-QN hinge + L1 on the 8 CSR blocks against leg
    (d).  (j)-(m) Host-streamed training on the mesh, in the same job after
    (i) (``mesh_rank_streamed``), checked after it
    (``mesh_streamed_checks``): every rank maps phase ``streamed``'s 10M x
    1000 bf16 host rows (``host_rows``: the tensor, its memfd, the labels)
    and streams its share; (j) SGD, (k) the compressed wire ``topk:0.01``,
    (l) L-BFGS and OWL-QN through the streamed CostFun, (m) the streamed
    statistics and totals, L-BFGS from them and the normal equations
    (``qn_refs``: phase ``streamed_qn``'s results to meet)."""
    t0 = time.perf_counter()
    world, n, d, dev = MESH_RANKS, FULL_ROWS, FULL_D, "cuda"
    Xh, fd, y_host, yh_ls, yh_log = host_rows
    rows = n // world
    X = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    blocks = [(X[b * rows:(b + 1) * rows], y[b * rows:(b + 1) * rows])
              for b in range(world)]
    for b, (Xb, yb) in enumerate(blocks):
        fill_mesh_block(torch, Xb, yb, b)
    digests = [_block_digest(Xb, yb) for Xb, yb in blocks]
    world1, single = mesh_world1(torch, tst, ck, X, y, profile)
    emit({"phase": "mesh", "part": "a_d_world1", **world1})

    # the one-process references of (b) and (c)
    objective = {}
    for mode in ("bernoulli", "indexed", "sliced"):
        r = _mesh_run(torch, ck, _mesh_alg(tst, mode, FRAC), X, y)
        objective[mode] = ls_objective_exact(torch, X, y, r["w"])
    reference = {mode: rank_order_reference(
        torch, tst, [(Xb[:MESH_PREFIX_ROWS], yb[:MESH_PREFIX_ROWS])
                     for Xb, yb in blocks], mode)
        for mode in ("bernoulli", "sliced")}
    full_reference = rank_order_reference(torch, tst, blocks, "full")
    ns = X_sp.shape[0]
    srows = -(-ns // world)
    sparse_single = {}
    for frac in (1.0, FRAC):
        alg = _sparse_alg(tst, MESH_ITERS, frac)
        model = alg.run((X_sp, y_sp))
        sparse_single[frac] = (model.weights,
                               np.asarray(alg.optimizer.loss_history))
    kernel_rows = mesh_kernel_rows(torch, ck, tst, *blocks[0],
                                   csr_row_block(torch, X_sp, 0, srows))

    with tempfile.TemporaryDirectory() as tmp:
        crow = X_sp.crow_indices().cpu().numpy()
        col = X_sp.col_indices().cpu().numpy()
        val = X_sp.values().cpu().numpy()
        yh = y_sp.cpu().numpy()
        for r in range(world):
            lo, hi = min(ns, r * srows), min(ns, (r + 1) * srows)
            a, b = int(crow[lo]), int(crow[hi])
            np.savez(os.path.join(tmp, f"sparse{r}.npz"),
                     crow=crow[lo:hi + 1] - crow[lo], col=col[a:b],
                     val=val[a:b], y=yh[lo:hi],
                     shape=np.array([hi - lo, X_sp.shape[1]]))
        del crow, col, val
        with open(os.path.join(tmp, "streamed.json"), "w") as f:
            json.dump({"fd": fd, "shape": list(Xh.shape)}, f)
        for name, t in (("y", y_host), ("y_ls", yh_ls), ("y_log", yh_log)):
            np.save(os.path.join(tmp, f"{name}.npy"), t.numpy())
        job_s = mesh_spawn(world, tmp, pass_fds=(fd,))
        reports, arrays = [], []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})

    for r, rep in enumerate(reports):
        check(rep["rank"] == r and rep["world"] == world
              and rep["backend"] == "gloo", f"mesh rank {r}: {rep}")
        check(rep["digest"] == digests[r], f"mesh rank {r}: other data")
        check(not rep["leaked"], f"mesh rank {r} imported {rep['leaked']}")
        for mode, run in rep["runs"].items():
            _check_launches({"launches": run["launches"],
                             "by_source": run["launches_by_source"]},
                            mode, f"mesh rank {r}")
            check(run["again_launches"] == run["launches"],
                  f"mesh rank {r} {mode}: launches differ between runs")
            check(run["repeat_bitwise"], f"mesh rank {r} {mode}: two runs "
                  "differ")
        for frac, run in rep["sparse"].items():
            check(run["csr_launches"] == {"csr_margins": MESH_ITERS,
                                          "csr_grad_sum": MESH_ITERS}
                  and not any(run["dense_launches"].values()),
                  f"mesh rank {r} sparse {frac}: {run['csr_launches']} "
                  f"{run['dense_launches']}")
    for k in arrays[0]:
        if k.startswith("e_block_"):
            continue  # a 2-D rank's weight block: its model column's
        check(all(np.array_equal(a[k], arrays[0][k]) for a in arrays[1:]),
              f"mesh: ranks differ in {k}")
    a0 = arrays[0]
    prefix = {}
    for mode, (w_ref, h_ref) in reference.items():
        same = (np.array_equal(a0[f"prefix_{mode}_w"], w_ref.cpu().numpy())
                and np.array_equal(a0[f"prefix_{mode}_h"], h_ref))
        check(same, f"mesh prefix {mode}: not the one-process rank-order sum")
        prefix[mode] = same
    full_same = (np.array_equal(a0["full_w"], full_reference[0].cpu().numpy())
                 and np.array_equal(a0["full_h"], full_reference[1]))
    check(full_same, "mesh full batch: not the one-process rank-order sum")
    # iteration 1 sums the same rows at the same weights: the gradient
    # tier.  Later weights differ in their last bits, and the margins
    # round them to bf16 (the mixed-precision contract), so whole runs
    # are held to the matched objective
    full_rel = _rel_max(a0["full_h"], single["h"])
    first_rel = _rel_max(a0["full_h"][:1], single["h"][:1])
    check(first_rel <= MESH_HISTORY_RTOL,
          f"mesh full batch: iteration 1's loss {first_rel} from the "
          "single device")
    check(full_rel <= MESH_FULL_HISTORY_RTOL,
          f"mesh full batch: history {full_rel} from the single device")
    objective["full"] = ls_objective_exact(torch, X, y, single["w"])
    ratios = {}
    for mode in ("bernoulli", "indexed", "sliced", "full"):
        ours = ls_objective_exact(torch, X, y, torch.as_tensor(
            a0[mode + "_w"], device=dev))
        ratios[mode] = ours / objective[mode]
    _check_objective_ratios(ratios, "full", "mesh")
    resident = mesh_resident_checks(
        torch, tst, ck, X, y, blocks, reports, arrays, single, objective,
        (X_sp, y_sp, sparse_owlqn_w))
    emit({"phase": "mesh", "part": "e_i_resident", **resident})
    del X, y, blocks
    torch.cuda.empty_cache()
    streamed, streamed_rows = mesh_streamed_checks(
        torch, tst, ck, Xh, y_host, yh_ls, reports, arrays, qn_refs)
    kernel_rows.extend(streamed_rows)
    streamed["by_rank"] = [rep["streamed"] for rep in reports]
    emit({"phase": "mesh", "part": "j_m_streamed", **streamed})
    sparse_rel = _rel_max(a0["sparse_1.0_h"], sparse_single[1.0][1])
    check(sparse_rel <= MESH_HISTORY_RTOL,
          f"mesh sparse full batch: history {sparse_rel} from one device")
    Xsc, ysh = _scipy_csr(X_sp), y_sp.cpu().numpy()
    sparse_obj = {str(f): _hinge_objective_sparse(Xsc, ysh, a0[f"sparse_{f}_w"],
                                                  1e-5)
                  / _hinge_objective_sparse(Xsc, ysh,
                                            sparse_single[f][0].cpu().numpy(),
                                            1e-5)
                  for f in (1.0, FRAC)}
    _check_objective_ratios(sparse_obj, "1.0", "mesh sparse")
    r0 = reports[0]
    launches = (r0["runs"]["bernoulli"]["launches"]["fused_gradient_sums"],
                r0["runs"]["sliced"]["launches"]["fused_window_sums"],
                r0["f"]["b1_launches"],
                r0["sparse"]["1.0"]["csr_launches"]["csr_margins"],
                r0["sparse"]["1.0"]["csr_launches"]["csr_grad_sum"],
                r0["i_sparse"]["csr_launches"].get("csr_margins/30", 0))
    for row, count, run in zip(kernel_rows, launches, (
            "rank 0's Bernoulli run", "rank 0's sliced run",
            "rank 0's meshed L-BFGS run (f)",
            "rank 0's sparse run, frac 1.0",
            "rank 0's sparse run, frac 1.0",
            "rank 0's meshed OWL-QN run (i)")):
        row["launches"], row["launches_from"] = count, run
        check(count > 0, f"{row['name']} ({row['path']}): no launch")
    out = {
        "ranks": world, "rows_per_rank": rows, "d": d,
        "iterations": MESH_ITERS, "job_seconds": job_s,
        "b": {mode: {
            "ms_per_iteration_by_rank": [
                rep["runs"][mode]["ms_per_iteration"] for rep in reports],
            "first_run_ms_per_iteration_rank0":
                r0["runs"][mode]["first_run_ms_per_iteration"],
            "loss_first": r0["runs"][mode]["loss_first"],
            "loss_last": r0["runs"][mode]["loss_last"]}
            for mode in r0["runs"]},
        "combine_ms_by_rank": {k: [rep["combine_ms"][k] for rep in reports]
                               for k in r0["combine_ms"]},
        "ranks_bitwise_equal": True, "repeat_bitwise": True,
        "prefix_bitwise_rank_order_sum": prefix,
        "full_batch_bitwise_rank_order_sum": full_same,
        "full_batch_history_max_rel": full_rel,
        "full_batch_first_loss_rel": first_rel,
        "sampled_objective_ratio": ratios,
        "c_sparse": {
            "rows_per_rank": [rep["sparse"]["1.0"]["rows"]
                              for rep in reports],
            "nnz_per_rank": [rep["sparse"]["1.0"]["nnz"] for rep in reports],
            "history_max_rel_full_batch": sparse_rel,
            "objective_ratio": sparse_obj,
            "ms_per_iteration_rank0": {
                f: r0["sparse"][f]["ms_per_iteration"] for f in r0["sparse"]},
            "peak_allocated_bytes_by_rank": {
                f: [rep["sparse"][f]["peak_allocated_bytes"]
                    for rep in reports] for f in r0["sparse"]}},
        "seconds": time.perf_counter() - t0}
    emit({"phase": "mesh", "part": "b_c_ranks", **out})
    return {"world1": world1, "resident": resident, "streamed": streamed,
            **out}, kernel_rows


# -- phase serve ---------------------------------------------------------------

SERVE_REQUESTS = 12_000     # single-row requests per model, in all: 8,000
#                             open loop (cut from 20,000 for the script's time)
SERVE_CLIENTS = 8           # client threads
SERVE_CLOSED_LOOP = 4_000   # of them closed loop (the latency run)
SERVE_SINGLE = 16           # of those, sent by one client first
SERVE_RELOADS = 4           # registry versions published mid-traffic
TENANTS, SLAB_ROWS, ZIPF_S = 10_000, 1_024, 1.1
TENANT_HOT = 8              # hot tenants republished mid-traffic
TENANT_UNIFORM = 400        # closed-loop requests that all ask tenant 0
SERVE_BUCKETS = (1, 8, 32, 128, 512)
A9A_D, MNIST_K = 123, 10
SERVE_SEED = 31
#: the phase's size on the card; a CPU rehearsal passes smaller ones
SERVE_SIZE = {"device": "cuda", "requests": SERVE_REQUESTS,
              "closed": SERVE_CLOSED_LOOP, "tenants": TENANTS,
              "slab": SLAB_ROWS}


def _serve_rows(kind, n, d, rng):
    """``n`` request rows of a served model from ``rng``: config 4's
    Gaussian features, config 2's binary a9a-like rows (about 11% ones),
    MNIST8M-like pixels in [0, 1), or RCV1-like sparse rows
    (``SparseVector``s of ``RCV1_NNZ`` unit-norm positive entries)."""
    if kind == "rcv1":
        from tpu_sgd_torch.linalg import SparseVector

        rows = []
        for _ in range(n):
            idx = np.sort(rng.choice(d, RCV1_NNZ, replace=False))
            v = np.abs(rng.normal(size=RCV1_NNZ)).astype(np.float32)
            rows.append(SparseVector(d, idx, v / np.linalg.norm(v)))
        return rows
    if kind == "a9a":
        return (rng.random((n, d)) < 0.113).astype(np.float32)
    if kind == "mnist":
        return rng.random((n, d), dtype=np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _log_batches(engine):
    """Wrap ``engine.predict_batch`` to keep every batch it scores: its
    arguments and a copy of its answers (the batch is the unit of the
    bitwise contract: the same rows through ``model.predict``)."""
    log = []
    real = engine.predict_batch

    def logged(*args):
        out = real(*args)
        log.append(args + (out.copy(),))
        return out

    engine.predict_batch = logged
    return log


def _drive(submit, n, clients, closed):
    """Drive requests ``0 .. n-1`` through ``submit(i)`` from ``clients``
    threads, request i on thread ``i % clients``.  Closed loop: each
    thread waits for an answer before its next request (the latency
    run; one request in flight a client).  Open loop: each thread
    submits all of its requests, then collects them (saturation).
    Returns the answers, each request's latency (closed loop; submit to
    answer) and the wall seconds."""
    import threading

    answers = [None] * n
    lat = np.zeros(n)
    errors = []

    def run(k):
        try:
            if closed:
                for i in range(k, n, clients):
                    t = time.perf_counter()
                    answers[i] = submit(i).result(timeout=300)
                    lat[i] = time.perf_counter() - t
            else:
                futs = [(i, submit(i)) for i in range(k, n, clients)]
                for i, f in futs:
                    answers[i] = f.result(timeout=300)
        except BaseException as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,), name=f"client{k}")
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        raise errors[0]
    return np.asarray(answers, np.float32), lat, wall


def _legs(n_closed, n_all):
    """A served model's legs, as ``(leg, clients, first, end)`` request
    ranges: ``SERVE_SINGLE`` requests from one client (a lone request a
    batch: bucket 1), the closed loop over ``SERVE_CLIENTS`` clients
    (latency), the rest open loop (saturation)."""
    return (("single", 1, 0, SERVE_SINGLE),
            ("latency", SERVE_CLIENTS, SERVE_SINGLE, n_closed),
            ("saturation", SERVE_CLIENTS, n_closed, n_all))


def _leg_report(leg, lat, wall, n, clients, batches):
    """A closed-loop leg's p50 / p99 / max latency (submit to answer) and
    its offered load; the open-loop leg's rows/s."""
    if leg == "saturation":
        return {"rows_per_s": n / wall, "rows": n, "batches": len(batches),
                "mean_batch_rows": n / len(batches),
                "offered": f"open loop: {clients} clients submit every "
                           "request, then wait for the answers"}
    return {**_latency(lat),
            "offered": f"closed loop: {clients} client(s), one request in "
                       "flight each",
            "achieved_requests_per_s": n / wall, "batches": len(batches)}


def _latency(lat) -> dict:
    """p50 / p99 / max of request latencies given in seconds, in ms."""
    lat = np.sort(lat)
    n = len(lat)
    return {"p50_ms": 1e3 * float(lat[int(0.50 * (n - 1))]),
            "p99_ms": 1e3 * float(lat[int(0.99 * (n - 1))]),
            "max_ms": 1e3 * float(lat[-1]), "requests": n}


def _answers_equal_batches(rows, answers, log, key=lambda r: r.tobytes()):
    """Every answer is its batch's answer for its row, bit for bit (a row
    is found by its bytes; the request rows are distinct)."""
    by_row = {}
    for entry in log:
        X, out = entry[-2], entry[-1]
        for j in range(X.shape[0]):
            by_row[key(X[j])] = out[j]
    got = np.asarray([by_row[key(r)] for r in rows], np.float32)
    return bool(np.array_equal(got.view(np.int32), answers.view(np.int32)))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(
        np.array_equal(a.view(np.int32), b.view(np.int32)))


def _float64_check(name, kind, log) -> dict:
    """Every served dense batch against a float64 numpy score of its own
    model on the same rows, an independent reference: ``X @ w + b`` (the
    sigmoid for the logistic family) within 1e-5 of the row's
    ``|x|.|w| + |b|`` (the scale of a float32 dot's rounding), and the
    multinomial classes (pivot rule over ``[x, 1] @ Wᵀ``) equal on every
    row whose top two logits lie more than 1e-3 apart."""
    weights = {}
    worst, rows, decided = 0.0, 0, 0
    for m, X, o in log:
        if id(m) not in weights:
            weights[id(m)] = m.weights.detach().cpu().numpy().astype(
                np.float64)
        w = weights[id(m)]
        X64 = np.asarray(X, np.float64)
        rows += X64.shape[0]
        if kind == "mnist":
            X64 = np.hstack([X64, np.ones((X64.shape[0], 1))])
            logits = np.hstack([np.zeros((X64.shape[0], 1)),
                                X64 @ w.reshape(m.num_classes - 1, -1).T])
            top2 = np.sort(logits, axis=1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 1e-3
            bad = int(np.sum(np.argmax(logits, 1)[clear] != o[clear]))
            check(not bad, f"{name}: {bad} classes differ from float64")
            decided += int(clear.sum())
            continue
        ref = X64 @ w + m.intercept
        if m._activation == "sigmoid":
            ref = 1.0 / (1.0 + np.exp(-ref))
        err = np.abs(o - ref) / (np.abs(X64) @ np.abs(w) + abs(m.intercept))
        worst = max(worst, float(err.max()))
    if kind == "mnist":
        check(decided > 0.9 * rows, f"{name}: {decided} of {rows} rows "
              "clear of a tie")
        return {"rows": rows, "rows_decided": decided,
                "tolerance": "classes equal where the top two logits lie "
                             "more than 1e-3 apart"}
    check(worst <= 1e-5, f"{name}: {worst} of |x|.|w| + |b| from float64")
    return {"rows": rows, "max_err": worst,
            "tolerance": "1e-5 of |x|.|w| + |b| a row"}


def _dense_compute(torch, model, kind, rows, device) -> dict:
    """The device part of a dense batch of ``rows`` padded rows: the ops of
    ``ops/bucketed.py`` on rows already on the card (the multinomial
    model's rows with their bias column), with the f32 elements it moves
    and its multiply-adds."""
    if kind == "mnist":
        w = model.weights.reshape(model.num_classes - 1, -1).T
    else:
        w = model.weights
    from tpu_sgd_torch.ops.gradients import pivot_class_traced

    X = torch.randn(rows, w.shape[0], device=device)

    def fn():
        r = X.to(torch.float32) @ w + float(model.intercept)
        if kind == "mnist":  # the pivot rule on the card: one class a row
            return pivot_class_traced(r)
        return torch.sigmoid(r) if model._activation == "sigmoid" else r

    return {"fn": fn, "X": X, "elems": X.numel() + w.numel() + rows,
            "macs": rows * w.numel()}


def _bucket_rows(torch, ck, fn, elems, macs, **_):
    """One bucket's device part alone: its time from a CUDA graph's
    replays against its bound (``elems`` f32 elements moved, ``macs``
    multiply-adds), and its kernels (the nodes of a graph that captured
    one call)."""
    t_bytes = 1e3 * 4 * elems / HBM_BYTES_PER_S
    t_ops = 1e3 * 2.0 * macs / F32_FLOPS
    ms = graph_ms(torch, fn)
    _, nodes = captured_call(torch, ck, fn)
    return {"device_ms": ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": max(t_bytes, t_ops) / ms,
            "kernels": nodes.get("kernel", 0)}


def _event_ms(torch, fn, reps=30) -> float:
    """Device-timeline ms of one ``fn`` call (a copy from or to pageable
    host memory), by CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _anatomy(torch, ck, call, copies_in, n_in, copy_out, compute,
             reps=30):
    """A batch through its engine: the wall of ``call`` by the host clock
    (each call ends in its copy back), its copies in (``n_in`` arrays)
    and out and its device part (``compute``, graph replays) on the
    device timeline, the host's share of the wall, its kernels (a
    capture of ``compute``) and copies."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        call()
    wall = 1e3 * (time.perf_counter() - t) / reps
    h2d = sum(_event_ms(torch, c, reps) for c in copies_in)
    d2h = _event_ms(torch, copy_out, reps)
    dev = graph_ms(torch, compute)
    _, nodes = captured_call(torch, ck, compute)
    return {"wall_ms": wall, "h2d_ms": h2d, "d2h_ms": d2h,
            "compute_ms": dev, "device_ms": h2d + dev + d2h,
            "host_share": max(0.0, 1 - (h2d + dev + d2h) / wall),
            "kernels_per_batch": nodes.get("kernel", 0),
            "copies_per_batch": n_in + 1}


def _dense_batches(torch, ck, engine, model, kind, d, rng):
    """Each bucket's device part alone, and a batch of 8 and of 512 rows
    through the engine (:func:`_anatomy`)."""
    from tpu_sgd_torch.serve import stack_rows

    dev = engine.device
    computes = {n: _dense_compute(torch, model, kind, n, dev)
                for n in SERVE_BUCKETS}
    buckets = {str(n): _bucket_rows(torch, ck, **c)
               for n, c in computes.items()}
    batch = {}
    for n in (8, 512):
        X = stack_rows(list(_serve_rows(kind, n, d, rng)))
        c = computes[n]
        Xp = torch.zeros(tuple(c["X"].shape))
        res = torch.zeros(tuple(c["fn"]().shape), device=dev)
        batch[str(n)] = {"rows": n, **_anatomy(
            torch, ck, lambda: engine.predict_batch(model, X),
            [lambda: Xp.to(dev)], 1, lambda: res.cpu(), c["fn"])}
    return buckets, batch


def _sparse_batch(torch, ck, engine, model, d, n, rng):
    """A sparse batch of ``n`` RCV1-width rows through the engine, as
    :func:`_anatomy` reads it (its CSR's three arrays copied in)."""
    from tpu_sgd_torch.serve import stack_rows

    dev = engine.device
    X = stack_rows(_serve_rows("rcv1", n, d, rng))
    Xd = X.to(dev)
    res = torch.zeros(n, device=dev)
    return {"rows": n, "nnz": int(X._nnz()), **_anatomy(
        torch, ck, lambda: engine.predict_batch(model, X),
        [lambda: X.to(dev)], 3, lambda: res.cpu(),
        lambda: ck.csr_margins(Xd, model.weights) + float(model.intercept))}


def serve_csr_rows(torch, ck, d, log, rng):
    """The CSR kernel (``csr_margins``) at the serving shapes: batches of
    1, 8, 32, 128 and 512 RCV1-width rows of ``RCV1_NNZ`` entries, each
    against its plain twin and cuSPARSE (torch's CSR product, the library
    call) with its bound (of w, only the 32-byte sectors the batch's
    columns touch); ``launches`` are the served sparse run's batches of
    that bucket's row range (one launch each; sparse batches are not
    padded, so a 5-row batch counts under the 8-row shape)."""
    from tpu_sgd_torch.ops.bucketed import bucket_for
    from tpu_sgd_torch.serve import stack_rows

    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).cuda()
    served = {}
    for _, X, _ in log:
        b = bucket_for(X.shape[0])
        served[b] = served.get(b, 0) + 1
    check(sum(served.get(n, 0) for n in SERVE_BUCKETS) == len(log),
          f"serve csr: served batches by bucket {served}")
    rows, lo = [], 1
    for n in SERVE_BUCKETS:
        X = stack_rows(_serve_rows("rcv1", n, d, rng)).cuda()
        got, ref = ck.csr_margins(X, w), ck.csr_matmul_plain(X, w)
        again = ck.csr_margins(X, w)
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        torch.cuda.synchronize()
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        err = float((got - ref).abs().max())
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        scale = float(ref.abs().max())
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        check(bool(torch.equal(got, again)), f"serve csr ({n}) not bitwise")
        check(err <= 1e-4 * scale + 1e-6,
              f"serve csr ({n}): max |d| {err} of {scale}")
        replay, per_call = captured_call(torch, ck,
                                         lambda: ck.csr_margins(X, w))
        check(1 <= sum(per_call.values()) <= 2,
              f"serve csr ({n}): {per_call} CUDA launches a call")
        # graftlint: disable=host-sync -- chip check: reads each case back to compare it
        check(bool(torch.equal(replay, got)), f"serve csr ({n}): replay")
        nnz = X._nnz()
        idx = X.col_indices().element_size()
        # w is read only where the batch's columns fall: its distinct
        # 32-byte sectors (8 floats), at most all of w
        w_bytes = min(4 * d, 32 * int(torch.unique(
            X.col_indices() // 8).numel()))
        bytes_ = nnz * (4 + idx) + (n + 1) * idx + 4 * n + w_bytes
        t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
        t_ops = 1e3 * 2.0 * nnz / F32_FLOPS
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        ms = time_ms(torch, lambda: ck.csr_margins(X, w), 50)
        with ck.captured_launches():
            kern_graph = graph_ms(torch, lambda: ck.csr_margins(X, w))
        rows.append({
            "name": "csr_margins", "path": f"serve ({n} rows)",
            "source": CSR_SOURCE, "shape": [n, d], "columns": 1,
            "nnz": nnz, "max_abs_err": err, "grad_scale": scale, "ms": ms,
            "plain_ms": time_ms(torch, lambda: ck.csr_matmul_plain(X, w),
                                50),
            "library_ms": time_ms(torch, lambda: X @ w, 50),
            "graph_ms": kern_graph,
            "library_graph_ms": graph_ms(torch, lambda: X @ w),
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms,
            "w_bytes": w_bytes, "cuda_launches_per_call": per_call,
            "launches": served.get(n, 0),
            "launches_from": "phase serve, RCV1-width sparse batches of "
                             f"{lo}-{n} rows (not padded; this row times "
                             f"{n} rows)"})
        lo = n + 1
    return rows


def _serve_model(torch, ck, name, model, kind, d, rng, size, *,
                 registry=None, publish=None):
    """One model through ``Server``: ``size["closed"]`` requests closed loop
    over ``SERVE_CLIENTS`` threads (latency; ``publish``, when given, runs
    beside it: the registry's new versions mid-traffic), then the rest of
    ``size["requests"]`` open loop (saturation).  Checks every dense batch
    bitwise against ``model.predict`` on the same rows (the batch's own
    model, for a registry) and every answer against its batch; sparse
    answers against ``model.predict`` on all rows within 1e-6 relative,
    every sparse batch re-scored bitwise, and one CSR kernel launch a
    sparse batch."""
    import threading

    from tpu_sgd_torch.ops import bucketed
    from tpu_sgd_torch.serve import Server, stack_rows

    n_all, n_closed, dev = size["requests"], size["closed"], size["device"]
    rows = _serve_rows(kind, n_all, d, rng)
    sparse = kind == "rcv1"
    out = {"width": d}
    ck.reset_launch_counts()
    shapes0 = bucketed.program_cache_size()
    answers, log = [], []
    for leg, clients, lo, hi in _legs(n_closed, n_all):
        server = (Server(registry=registry, reload_interval_s=0.0,
                         max_queue=n_all, device=dev)
                  if registry is not None else
                  Server(model, max_queue=n_all, device=dev))
        batches = _log_batches(server.engine)
        pub = (threading.Thread(target=publish, name="publisher")
               if leg == "latency" and publish is not None else None)
        with server:
            if pub is not None:
                pub.start()
            got, lat, wall = _drive(lambda i: server.submit(rows[lo + i]),
                                    hi - lo, clients, leg != "saturation")
            if pub is not None:
                pub.join(timeout=300)
                check(not pub.is_alive(), "the publisher hung")
        out[leg] = _leg_report(leg, lat, wall, hi - lo, clients, batches)
        answers.append(got)
        log += batches
    answers = np.concatenate(answers)
    check(bool(np.isfinite(answers).all()), f"{name}: non-finite answers")
    if sparse:
        if dev != "cpu":
            launches = ck.csr_launch_counts()["csr_margins"]
            check(launches == len(log),
                  f"{name}: {launches} CSR launches for {len(log)} batches")
            check(sum(ck.launch_counts().values()) == 0,
                  f"{name}: a dense kernel ran")
            out["csr_launches"] = launches
        X_all = stack_rows(rows).to(dev)
        ref = model.predict(X_all).cpu().numpy()
        rel = float(np.max(np.abs(answers - ref)) / np.max(np.abs(ref)))
        check(rel <= 1e-6, f"{name}: answers vs predict, relative {rel}")
        check(_same_bits(model.predict(X_all).cpu().numpy(), ref),
              f"{name}: predict does not repeat")
        check(all(_same_bits(server.engine.predict_batch(m, X), o)
                  for m, X, o in log),
              f"{name}: a re-scored sparse batch differs")
        out["max_rel_vs_predict"] = rel
        out["batches_repeat_bitwise"] = len(log)
    else:
        bad = sum(not _same_bits(m.predict(X).cpu().numpy(), o)
                  for m, X, o in log)
        check(not bad, f"{name}: {bad} of {len(log)} batches differ "
              "from model.predict on the same rows")
        check(_answers_equal_batches(rows, answers, log),
              f"{name}: an answer differs from its batch")
        out["batches_bitwise_predict"] = len(log)
        out["vs_float64"] = _float64_check(name, kind, log)
    out["new_shape_keys"] = bucketed.program_cache_size() - shapes0
    check(out["new_shape_keys"] == 0,
          f"{name}: {out['new_shape_keys']} padded shapes after warm-up")
    if registry is not None:
        out["versions_served"] = sorted({int(m.intercept)
                                         for m, _, _ in log})
        check(len(out["versions_served"]) >= 2,
              f"{name}: served versions {out['versions_served']}")
    return out, log


def _tenant_leg(torch, tst, ck, rng, tmp, size):
    """The tenant plane: ``size["tenants"]`` tenants' checkpoints written
    first, a ``size["slab"]``-row slab at config 4's width, Zipf(``ZIPF_S``)
    traffic through ``TenantServer`` (closed loop, then open loop) while
    the hot tenants are republished.  Every uniform batch is bitwise the
    single-model engine on one version of its tenant, every mixed row
    within tight tolerance of one version of its tenant, the rows of one
    tenant in one batch on one version, every answer its batch's."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from tpu_sgd_torch.serve import PredictEngine
    from tpu_sgd_torch.tenant import (TenantModelStore, TenantPredictEngine,
                                      TenantServer)

    n_all, n_closed, dev = size["requests"], size["closed"], size["device"]
    n_ten, d = size["tenants"], FULL_D
    W = rng.normal(size=(n_ten, d)).astype(np.float32)
    b = rng.normal(size=n_ten).astype(np.float32)
    store = TenantModelStore(os.path.join(tmp, "tenants"),
                             capacity=size["slab"], d=d, device=dev)
    t = time.perf_counter()
    with ThreadPoolExecutor(16) as pool:
        list(pool.map(lambda i: store.publish(i, W[i], float(b[i])),
                      range(n_ten)))
    out = {"tenants": n_ten, "slab_rows": size["slab"], "width": d,
           "zipf_s": ZIPF_S, "publish_seconds": time.perf_counter() - t}
    versions = {i: [(W[i], float(b[i]))] for i in range(n_ten)}
    p = np.arange(1, n_ten + 1, dtype=np.float64) ** -ZIPF_S
    tids = rng.choice(n_ten, size=n_all, p=p / p.sum())
    # the first requests all ask for tenant 0 (hot, republished): their
    # batches are uniform, the M = 1 case
    n_uniform = min(TENANT_UNIFORM, n_closed // 2)
    tids[:n_uniform] = 0
    X = rng.normal(size=(n_all, d)).astype(np.float32)
    warm = TenantPredictEngine(store)  # every bucket through both paths
    for n in SERVE_BUCKETS:
        warm.predict_batch(np.zeros(n, np.int64), X[:n])
        warm.predict_batch(np.arange(n) % 2 + 1, X[:n])
    shapes0 = warm.compile_count
    ledger0 = store.slab.ledger_snapshot()
    stop = threading.Event()

    def publisher():
        # version v: weights (1 + v) W[t], intercept b[t] + 1000 v, so any
        # two versions' scores of a row lie about 1000 apart
        for v in range(1, 7):
            for tid in range(TENANT_HOT):
                w_new = (W[tid] * (1.0 + v)).astype(np.float32)
                versions[tid].append((w_new, float(b[tid]) + 1000.0 * v))
                store.publish(tid, w_new, float(b[tid]) + 1000.0 * v)
            if stop.wait(0.05):
                return

    log, answers = [], []
    for leg, clients, lo, hi in _legs(n_closed, n_all):
        srv = TenantServer(store, max_batch=SERVE_BUCKETS[-1],
                           max_queue=n_all)
        batches = _log_batches(srv.engine)
        pub = threading.Thread(target=publisher, name="publisher") \
            if leg == "latency" else None
        with srv:
            if pub is not None:
                pub.start()
            got, lat, wall = _drive(
                lambda i: srv.submit(int(tids[lo + i]), X[lo + i]), hi - lo,
                clients, leg != "saturation")
            if pub is not None:
                stop.set()
                pub.join(timeout=300)
                check(not pub.is_alive(), "the publisher hung")
        out[leg] = _leg_report(leg, lat, wall, hi - lo, clients, batches)
        if leg == "latency":
            # the forced tenant-0 prefix apart from the Zipf requests
            cut = max(0, n_uniform - lo)
            out[leg]["uniform_prefix"] = _latency(lat[:cut])
            out[leg]["zipf_only"] = _latency(lat[cut:])
        log += batches
        answers.append(got)
    single = PredictEngine(device=dev)
    uniform = mixed = 0
    for tb, Xb, ob in log:
        uniq = np.unique(tb)
        if len(uniq) == 1:
            hits = [k for k, (w_, b_) in enumerate(versions[int(uniq[0])])
                    if _same_bits(single.predict_batch(
                        tst.LinearRegressionModel(w_, b_, device=dev), Xb),
                        ob)]
            check(len(hits) == 1, f"a uniform batch of tenant {uniq[0]} "
                  f"matches versions {hits}")
            uniform += 1
            continue
        mixed += 1
        scale = float(np.abs(ob).max())
        chosen = {}
        for j, t_ in enumerate(tb):
            ref = [float(Xb[j].astype(np.float64) @ w_ + b_)
                   for w_, b_ in versions[int(t_)]]
            hits = [k for k, r in enumerate(ref)
                    if abs(r - ob[j]) <= 1e-5 * max(abs(r), scale)]
            check(len(hits) == 1, f"a mixed row of tenant {t_} matches "
                  f"versions {hits} ({ob[j]} against {ref})")
            check(chosen.setdefault(int(t_), hits[0]) == hits[0],
                  f"tenant {t_} on two versions in one batch")
    check(_answers_equal_batches(
        [np.concatenate([[np.float32(t_)], x]) for t_, x in zip(tids, X)],
        np.concatenate(answers),
        [(np.column_stack([tb.astype(np.float32), Xb]), ob)
         for tb, Xb, ob in log]),
        "a tenant answer differs from its batch")
    ledger = store.slab.ledger_snapshot()
    out.update({"uniform_batches": uniform, "mixed_batches": mixed,
                "versions_published": TENANT_HOT * 6,
                "ledger": {k: ledger[k] - ledger0[k]
                           for k in ("admitted", "evicted", "swapped",
                                     "hits", "misses")},
                "resident": ledger["resident"],
                "new_shape_keys": warm.compile_count - shapes0})
    check(out["new_shape_keys"] == 0,
          f"tenant: {out['new_shape_keys']} padded shapes after warm-up")
    check(out["ledger"]["misses"] > 0 and out["ledger"]["evicted"] > 0,
          f"tenant: no admission from disk under Zipf ({out['ledger']})")
    check(out["ledger"]["swapped"] > 0, "tenant: no hot swap mid-traffic")
    check(uniform > 0 and mixed > 0,
          f"tenant: {uniform} uniform and {mixed} mixed batches")
    if dev != "cpu":
        out["bucket_device_ms"], out["batch"] = _gather_batches(
            torch, ck, srv.engine, store, log, d)
    return out


def _gather_batches(torch, ck, engine, store, log, d):
    """The mixed-tenant gathered pass alone at each bucket on the slab
    (the rows, their slab rows, slots, intercepts and answers crossing
    device memory once), and a mixed batch of the run through the engine
    (:func:`_anatomy`; its rows and slot vector copied in)."""
    from tpu_sgd_torch.ops.bucketed import bucket_for

    _, _, Wd, bd = store.slab.snapshot_resident()
    dev = engine.store.slab.device
    computes = {}
    for n in SERVE_BUCKETS:
        Xd = torch.randn(n, d, device=dev)
        sd = torch.arange(n, device=dev) % Wd.shape[0]
        computes[n] = (lambda Xd=Xd, sd=sd:
                       (Xd.to(torch.float32) * Wd[sd]).sum(-1) + bd[sd])
    buckets = {str(n): _bucket_rows(torch, ck, fn, 2 * n * d + 4 * n, n * d)
               for n, fn in computes.items()}
    tb, Xb = next((tb, Xb) for tb, Xb, _ in log
                  if len(np.unique(tb)) > 1 and len(tb) > 256)
    rows = bucket_for(len(tb))
    Xp, sp = torch.zeros(rows, d), torch.zeros(rows, dtype=torch.int64)
    res = torch.zeros(rows, device=dev)
    batch = {"rows": int(Xb.shape[0]), "tenants": int(len(np.unique(tb))),
             **_anatomy(torch, ck, lambda: engine.predict_batch(tb, Xb),
                        [lambda: Xp.to(dev), lambda: sp.to(dev)], 2,
                        lambda: res.cpu(), computes[rows])}
    return buckets, batch


def phase_serve(torch, tst, ck, size=None):
    """Phase ``serve``: the serving plane (module docstring, phase 13).
    ``size`` (default :data:`SERVE_SIZE`) sets the device, the requests
    a model, the closed-loop share, the tenants and the slab rows; on the
    CPU (a rehearsal) the card's timings and the kernel rows are left
    out.  Returns the phase's report and the CSR kernel's rows at the
    serving shapes."""
    from tpu_sgd_torch.serve import ModelRegistry, PredictEngine, stack_rows
    from tpu_sgd_torch.utils import CheckpointManager

    size = dict(SERVE_SIZE, **(size or {}))
    dev = size["device"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(SERVE_SEED)
    report = {"requests_per_model": size["requests"],
              "clients": SERVE_CLIENTS, "closed_loop": size["closed"]}
    engine = PredictEngine(device=dev)
    with tempfile.TemporaryDirectory(prefix="serve_") as tmp:
        # config 4's width from a registry, republished mid-traffic; a
        # version's intercept is its number
        mgr = CheckpointManager(os.path.join(tmp, "registry"),
                                keep=SERVE_RELOADS + 2)
        w4 = rng.normal(size=FULL_D).astype(np.float32)

        def save(v):
            mgr.save(v, (w4 * (1.0 + 0.25 * v)).astype(np.float32), 0.0, [],
                     extras={"intercept": np.float64(v)})

        def publish():
            for v in range(2, 2 + SERVE_RELOADS):
                time.sleep(0.2)
                save(v)

        save(1)
        registry = ModelRegistry(mgr, tst.LinearRegressionModel, device=dev)
        models = {
            "config4": (registry.model(), "config4", FULL_D,
                        {"registry": registry, "publish": publish}),
            "config2": (tst.LogisticRegressionModel(
                rng.normal(size=A9A_D).astype(np.float32), -0.2,
                device=dev).clear_threshold(), "a9a", A9A_D, {}),
            "mnist8m": (tst.MultinomialLogisticRegressionModel(
                rng.normal(size=(MNIST_K - 1) * (MNIST8M_D + 1))
                .astype(np.float32) * 0.05, 0.0, MNIST_K, MNIST8M_D + 1,
                has_intercept_column=True, device=dev), "mnist", MNIST8M_D,
                {}),
            "rcv1": (tst.SVMModel(rng.normal(size=RCV1_D).astype(np.float32),
                                  0.05, device=dev).clear_threshold(),
                     "rcv1", RCV1_D, {}),
        }
        csr_log = []
        for name, (model, kind, d, kw) in models.items():
            for n in SERVE_BUCKETS:  # warm-up: every bucket's shape
                engine.predict_batch(model, stack_rows(
                    list(_serve_rows(kind, n, d, rng))))
            t = time.perf_counter()
            report[name], log = _serve_model(torch, ck, name, model, kind, d,
                                             rng, size, **kw)
            report[name]["seconds"] = time.perf_counter() - t
            emit({"phase": "serve", "model": name, **report[name]})
            if kind == "rcv1":
                csr_log = log
        if dev != "cpu":
            # each bucket's product alone, and a batch's anatomy
            for name, (model, kind, d, _) in models.items():
                if kind == "rcv1":
                    report[name]["batch"] = {
                        str(n): _sparse_batch(torch, ck, engine, model, d,
                                              n, rng) for n in (8, 512)}
                    continue
                (report[name]["bucket_device_ms"],
                 report[name]["batch"]) = _dense_batches(
                    torch, ck, engine, model, kind, d, rng)
        t = time.perf_counter()
        report["tenant"] = _tenant_leg(torch, tst, ck, rng, tmp, size)
        report["tenant"]["seconds"] = time.perf_counter() - t
        emit({"phase": "serve", "model": "tenant",
              **{k: v for k, v in report["tenant"].items()
                 if k not in ("bucket_device_ms", "batch")}})
    rows = [] if dev == "cpu" else serve_csr_rows(torch, ck, RCV1_D,
                                                  csr_log, rng)
    report["seconds"] = time.perf_counter() - t0
    return report, rows


CORR_ROWS, CORR_D, CORR_NNZ, CORR_SEED = 100_000, 4_096, 75, 41


def phase_corr(torch, tst, ck):
    """Phase ``corr``: ``stat.corr`` of a CSR X on the card.  Its Gram goes
    through ``csr_grad_sum`` once a block of ``CSR_MAX_COLUMNS`` columns,
    and its column means once more (counted from 0), two calls agree bit
    for bit, and the result is held
    to a float64 correlation of X's dense copy.  Returns the phase's
    report and the kernel's row at one block's shape."""
    from tpu_sgd_torch import stat
    from tpu_sgd_torch.ops.sparse import sparse_data, transpose_csr

    t0 = time.perf_counter()
    X = sparse_data(CORR_ROWS, CORR_D, CORR_NNZ, seed=CORR_SEED)[0].cuda()
    blocks = -(-CORR_D // ck.CSR_MAX_COLUMNS)
    ck.reset_launch_counts()
    t = time.perf_counter()
    C = stat.corr(X)
    corr_s = time.perf_counter() - t
    launches = ck.csr_launch_counts()
    # one launch a block of the Gram, one for the column means
    check(launches["csr_grad_sum"] == blocks + 1
          and launches["csr_margins"] == 0,
          f"corr: {launches} CSR launches for {blocks} blocks")
    check(sum(ck.launch_counts().values()) == 0, "corr: a dense kernel ran")
    check(_same_bits(stat.corr(X), C), "corr: two calls differ")
    Xd = X.to_dense().double()
    mean = Xd.mean(0)
    cov = (Xd.T @ Xd - CORR_ROWS * torch.outer(mean, mean)) / (CORR_ROWS - 1)
    sd = torch.sqrt(torch.diagonal(cov))
    ref = (cov / torch.outer(sd, sd)).cpu().numpy()
    del Xd, cov
    err = float(np.nanmax(np.abs(C - ref)))
    check(err <= 1e-4, f"corr: max |d| {err} against float64")
    # the kernel alone at one block's shape: X's transposed copy against
    # a dense (rows, 1024) block of X's columns
    Xt = transpose_csr(X)
    B = X.to_dense()[:, :ck.CSR_MAX_COLUMNS].contiguous()
    got, ref_b = ck.csr_grad_sum(Xt, B), ck.csr_matmul_plain(Xt, B)
    torch.cuda.synchronize()
    b_err = float((got - ref_b).abs().max())
    scale = float(ref_b.abs().max())
    check(b_err <= 1e-4 * scale, f"corr block: max |d| {b_err} of {scale}")
    nnz, idx = Xt._nnz(), Xt.col_indices().element_size()
    bytes_ = (nnz * (4 + idx) + (CORR_D + 1) * idx + 4 * B.numel()
              + 4 * CORR_D * B.shape[1])
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * 2.0 * nnz * B.shape[1] / F32_FLOPS
    bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                 else (t_ops, "operations"))
    ms = time_ms(torch, lambda: ck.csr_grad_sum(Xt, B), 10)
    row = {
        "name": "csr_grad_sum", "path": "corr (a Gram block)",
        "source": CSR_SOURCE, "shape": [CORR_D, CORR_ROWS],
        "columns": int(B.shape[1]), "nnz": nnz, "max_abs_err": b_err,
        "grad_scale": scale, "ms": ms,
        "plain_ms": time_ms(torch, lambda: ck.csr_matmul_plain(Xt, B), 10),
        "library_ms": time_ms(torch, lambda: Xt @ B, 10),
        "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
        "launches": launches["csr_grad_sum"],
        "launches_from": f"phase corr, one corr call ({blocks} Gram "
                         "blocks and the column means)"}
    out = {"rows": CORR_ROWS, "d": CORR_D, "nnz": int(X._nnz()),
           "blocks": blocks, "csr_grad_sum_launches": row["launches"],
           "corr_seconds": corr_s, "max_abs_err_vs_float64": err,
           "repeat_bitwise": True, "seconds": time.perf_counter() - t0}
    del X, Xt, B
    torch.cuda.empty_cache()
    return out, row


# -- phase 14b: the production scenarios ---------------------------------------

SCENARIO_SEED = 0
#: the flagship scenario's replica fleet: 512 drifting rows of width 16
#: over 3 workers (the JAX package's knobs), so a worker's shard is
SCENARIO_SHARD = (171, 16)
#: the sparse endpoint's batches: at most 32 rows of width 16, ~5 entries
SCENARIO_SPARSE = (32, 16)


def _tensor_methods(torch):
    """``torch.Tensor``'s read methods that ``obs`` hooks while enabled,
    as they stand (the identity and whether the class itself holds it)."""
    from tpu_sgd_torch.obs import counters

    return {n: (getattr(torch.Tensor, n), n in vars(torch.Tensor))
            for n in counters.SYNC_METHODS}


def _scenario_run(torch, ck, run, name, out_dir):
    """One scenario on the card with every launch count set to 0 just
    before and read just after; the trace's numbers as the phase prints
    them.  The counting hooks must be torch's own again after the run."""
    from tpu_sgd_torch.obs import counters
    from tpu_sgd_torch.obs import report as obs_report

    methods = _tensor_methods(torch)
    # the run's trace carries one cumulative counter snapshot: counts
    # start at 0 here, so one scenario's gate never reads another's
    counters.reset()
    ck.reset_launch_counts()
    t = time.perf_counter()
    rc = run(seed=SCENARIO_SEED, smoke=False, out_dir=out_dir,
             verbose=False)
    wall = time.perf_counter() - t
    launches = {"wrappers": ck.launch_counts(),
                "csr": ck.csr_launch_counts(),
                "b1_routes": ck.gradient_route_counts(),
                "sources": ck.kernel_launch_counts()}
    check(_tensor_methods(torch) == methods and counters._PATCHES is None
          and not counters.is_enabled(),
          f"scenario {name}: obs left a hook on torch.Tensor")
    records = obs_report.load_trace(os.path.join(out_dir,
                                                 f"{name}_trace.jsonl"))
    with open(os.path.join(out_dir, f"{name}_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(out_dir, f"{name}_slo.json")) as f:
        slo_doc = json.load(f)
    deltas = obs_report.counter_deltas(records)
    verdicts = obs_report.evaluate_slos(records, slo_doc)
    spans = obs_report.span_stats(records)
    t_ = summary["totals"]
    check(t_["submitted"] == sum(t_[k] for k in (
        "answered", "rejected", "displaced", "errored", "dropped")),
        f"scenario {name}: ledger does not conserve: {t_}")
    failing = [v["name"] for v in verdicts if not v["ok"]]
    check(rc == 0 and not failing,
          f"scenario {name}: exit code {rc}, SLOs failing {failing}")
    return {
        "exit_code": rc, "wall_s": wall, "traffic_wall_s": summary["wall_s"],
        "totals": t_,
        "answered_rows_per_s": t_["answered"] / summary["wall_s"],
        "classes": {c: {k: v[k] for k in ("submitted", "answered",
                                          "p50_s", "p99_s")}
                    for c, v in summary["classes"].items()},
        "lanes_server": {lane: {k: v[k] for k in ("requests", "p50_s",
                                                  "p99_s")}
                         for lane, v in obs_report.lane_latency_stats(
                             records).items()},
        "alerts": obs_report.alert_stats(records)["by_rule"],
        "slos": {v["name"]: v["value"] for v in verdicts},
        "counters": {k: v["n"] for k, v in deltas.items()
                     if k.split(".")[0] in ("integrity", "tenant",
                                            "scenario")},
        "spans_max_s": {k: spans[k]["max_s"] for k in (
            "replica.failover", "serve.batch", "tenant.batch")
            if k in spans},
        "launches": launches}, summary


def scenario_flagship(torch, ck, tmp):
    """(a) ``run_scenario(seed=0, smoke=False)`` on the card: the replica
    fleet retraining (B1 a push), three endpoints under the burst (the
    CSR kernel on the sparse one), a worker killed and rejoined, the
    primary store killed and its standby promoted under delta-log
    corruption, every SLO of the production document."""
    from tpu_sgd_torch.scenario import run_scenario
    from tpu_sgd_torch.utils.events import JsonLinesEventLog

    out_dir = os.path.join(tmp, "flagship")
    rec, summary = _scenario_run(torch, ck, run_scenario, "scenario",
                                 out_dir)
    frec = JsonLinesEventLog.read(os.path.join(out_dir, "flightrec.jsonl"))
    check(frec and frec[0]["kind"] == "flightrec_meta",
          "scenario: flight record without its meta header")
    counters = rec["counters"]
    check(summary["failovers"] >= 1 and summary["rejoins"] >= 1
          and summary["hot_reloads"] >= 2,
          f"scenario: failovers {summary['failovers']}, rejoins "
          f"{summary['rejoins']}, hot reloads {summary['hot_reloads']}")
    check(counters.get("integrity.corrupt", 0) >= 1
          and counters.get("integrity.unhealed", 0) == 0,
          f"scenario: integrity counters {counters}")
    routes = rec["launches"]["b1_routes"]
    check(rec["launches"]["wrappers"]["fused_gradient_sums"] > 0
          and sum(routes.values())
          == rec["launches"]["wrappers"]["fused_gradient_sums"],
          f"scenario: B1 launches {rec['launches']}")
    check(rec["launches"]["csr"]["csr_margins"] > 0,
          f"scenario: no csr_margins launch {rec['launches']['csr']}")
    rec.update({k: summary[k] for k in ("hot_reloads", "rejoins",
                                        "failovers", "corruptions_healed")})
    rec["flightrec_records"] = len(frec)
    return rec


def scenario_tenant(torch, ck, tmp):
    """(b) ``run_tenant_scenario(seed=0, smoke=False)`` on the card: 4,000
    tenants at width 32 over a 256-row slab, Zipf traffic, the retraining
    trickle and the eviction and reload storms."""
    from tpu_sgd_torch.scenario import run_tenant_scenario

    rec, summary = _scenario_run(torch, ck, run_tenant_scenario, "tenant",
                                 os.path.join(tmp, "tenant"))
    counters = rec["counters"]
    check(counters.get("tenant.swap", 0) > 0
          and counters.get("tenant.evict", 0) > 0
          and rec["alerts"].get("slab-thrash", 0) >= 1,
          f"tenant scenario: counters {counters}, alerts {rec['alerts']}")
    check((summary["n_tenants"], summary["capacity"]) == (4000, 256),
          f"tenant scenario: {summary['n_tenants']} tenants, "
          f"capacity {summary['capacity']}")
    rec.update({"slab": summary["slab"], "chaos": summary["chaos"]})
    return rec


def scenario_b1_row(torch, ck, tst, launches, route_counts):
    """B1 at a replica worker's shard of the flagship scenario (171 x 16
    f32) under its Bernoulli mask at frac 1.0 (every row live, as the
    workers draw it), against its plain version, the library's
    ``index_select`` and two products, and its bound."""
    pw = tst.LeastSquaresGradient().pointwise
    n, d = SCENARIO_SHARD
    gen = torch.Generator(device="cuda").manual_seed(SCENARIO_SEED + 51)
    X = torch.randn(n, d, generator=gen, device="cuda")
    y = torch.randn(n, generator=gen, device="cuda")
    w = torch.randn(d, generator=gen, device="cuda")
    m = torch.ones(n, dtype=torch.bool, device="cuda")
    ok, err, scale = _close(torch, ck.fused_gradient_sums(pw, X, y, w, m),
                            ck.fused_gradient_sums_plain(pw, X, y, w, m),
                            False)
    check(ok, f"scenario B1: max|dg|={err} of {scale}")
    route = ck.gradient_sums_route(X, True)
    check(route_counts.get(route, 0) == launches,
          f"scenario B1: {launches} launches, by route {route_counts}, "
          f"this shape and mask take {route}")
    idx = torch.nonzero(m).squeeze(1)
    coeff = torch.randn(n, generator=gen, device="cuda")

    def library():
        Xl = X.index_select(0, idx)
        return Xl @ w, coeff @ Xl

    bound, by = _bound_ms(n, d, 4, n)
    ms = time_ms(torch, lambda: ck.fused_gradient_sums(pw, X, y, w, m), 200)
    return {"name": "fused_gradient_sums",
            "path": f"scenario (a replica worker's {n}-row shard, d = {d}, "
                    "its frac-1.0 Bernoulli mask: all rows live)",
            "source": WINDOW_SOURCE if route != "fused_sums" else SOURCE,
            "route": route, "shape": [n, d], "max_abs_err": err,
            "grad_scale": scale, "ms": ms,
            "plain_ms": time_ms(torch, lambda: ck.fused_gradient_sums_plain(
                pw, X, y, w, m), 200),
            "library_ms": time_ms(torch, library, 200),
            "library_includes": ("index_select of the live rows, then two "
                                 "matmuls over them"),
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
            "launches": launches, "launches_by_route": route_counts,
            "launches_from": "phase scenario (a), the replica workers' "
                             "pushes (rounds 0-3)"}


def scenario_csr_row(torch, ck, launches):
    """The CSR kernel at the sparse endpoint's largest batch (32 rows of
    width 16, column 0 and ~a quarter of the rest set, as the harness
    makes them), against its plain twin and cuSPARSE."""
    from tpu_sgd_torch.scenario.harness import _sparse_row
    from tpu_sgd_torch.serve import stack_rows

    n, d = SCENARIO_SPARSE
    rng = np.random.default_rng(SCENARIO_SEED + 52)
    rows = []
    for _ in range(n):
        row = np.where(rng.random(d) < 0.25, rng.normal(size=d),
                       0.0).astype(np.float32)
        row[0] = 1.0
        rows.append(_sparse_row(row))
    X = stack_rows(rows).cuda()
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).cuda()
    got, ref = ck.csr_margins(X, w), ck.csr_matmul_plain(X, w)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= 1e-4 * scale + 1e-6, f"scenario csr: max|d| {err}")
    # a row whose one entry is column 0 goes through the kernel too
    only0 = np.zeros(d, np.float32)
    only0[0] = 1.0
    X0 = stack_rows([_sparse_row(only0)]).cuda()
    before = ck.csr_launch_counts()["csr_margins"]
    one = float(ck.csr_margins(X0, w)[0])
    check(ck.csr_launch_counts()["csr_margins"] == before + 1
          and one == float(w[0]), "scenario csr: the column-0 row")
    nnz, idx = X._nnz(), X.col_indices().element_size()
    bytes_ = nnz * (4 + idx) + (n + 1) * idx + 4 * n + 4 * d
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * 2.0 * nnz / F32_FLOPS
    bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                 else (t_ops, "operations"))
    ms = time_ms(torch, lambda: ck.csr_margins(X, w), 200)
    return {"name": "csr_margins", "path": f"scenario ({n} sparse rows, "
                                           f"d = {d})",
            "source": CSR_SOURCE, "shape": [n, d], "columns": 1,
            "nnz": nnz, "max_abs_err": err, "grad_scale": scale, "ms": ms,
            "plain_ms": time_ms(torch, lambda: ck.csr_matmul_plain(X, w),
                                200),
            "library_ms": time_ms(torch, lambda: X @ w, 200),
            "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
            "launches": launches,
            "launches_from": "phase scenario (a), the sparse endpoint's "
                             "batches (1-32 rows, not padded)"}


def scenario_lint():
    """(c) the port's graftlint over its defaults, in a subprocess started
    beside the kernels' build (it reads sources only); phase ``scenario``
    reads its exit code and summary line."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_sgd_torch.analysis.lint"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_scenario(torch, tst, ck, lint):
    """Phase ``scenario``: (a) the flagship scenario and (b) the tenant
    scenario in their production mode on the card, each gated by its own
    SLO document, then the scenarios' kernels (B1 at a worker's shard, the
    CSR kernel at the sparse endpoint's batch) against their plain
    versions, and (c) the port's graftlint: ``lint`` is its process
    (:func:`scenario_lint`), started with the script and read here.
    Returns the phase's report and the two kernel rows."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="scenario_") as tmp:
        out["a_flagship"] = scenario_flagship(torch, ck, tmp)
        out["b_tenant"] = scenario_tenant(torch, ck, tmp)
    launches = out["a_flagship"]["launches"]
    rows = [scenario_b1_row(torch, ck, tst,
                            launches["wrappers"]["fused_gradient_sums"],
                            launches["b1_routes"]),
            scenario_csr_row(torch, ck, launches["csr"]["csr_margins"])]
    stdout, stderr = lint.communicate(timeout=600)
    summary = [ln for ln in stderr.splitlines()
               if ln.startswith("graftlint:")]
    check(lint.returncode == 0 and summary and "13 rule(s)" in summary[-1],
          f"scenario: the port's lint exited {lint.returncode}: "
          f"{stdout[-2000:]} {stderr[-2000:]}")
    out["c_lint"] = {"exit_code": lint.returncode, "summary": summary[-1]}
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "scenario", **out})
    return out, rows


def bernoulli_rows(n: int) -> int:
    """The Bernoulli row cap of the streamed drivers at ``FRAC``."""
    from tpu_sgd_torch.optimize.streamed import bernoulli_cap

    return bernoulli_cap(n, FRAC)


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_child(*sys.argv[2:6])
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tpu_sgd_torch as tst
        from tpu_sgd_torch.ops import _build
        from tpu_sgd_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "visible_count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # phase scenario's lint reads the sources only: it runs beside the
    # build and the phases, and the phase collects it (or, when a check
    # fails first, the exit stops it)
    lint = scenario_lint()
    atexit.register(lambda: lint.poll() is None and lint.kill())
    t = time.perf_counter()
    report = _build.build_all()
    sources = {k: {"seconds": v["seconds"], **ptxas_report(v["log"]),
                   "entries": ptxas_entries(v["log"])}
               for k, v in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "sources": sources})
    check(sources["window_sums"]["max_spill_bytes"] in (None, 0),
          f"window_sums.cu spills: {sources['window_sums']}")

    grads = {"least_squares": tst.LeastSquaresGradient(),
             "logistic": tst.LogisticGradient(),
             "hinge": tst.HingeGradient()}
    t = time.perf_counter()
    cases, worst = phase_kernels(torch, ck, grads)
    emit({"phase": "kernels", "cases": cases, "max_abs_err": worst,
          "seconds": time.perf_counter() - t})

    X, y, w_true, launches, sliced_ref = phase_full(torch, tst, ck)
    profile = phase_profile(torch, tst, ck, X, y)
    rows = phase_timing(torch, tst, ck, X, y, launches)
    qn = {}
    qn["a"], b1_row = leg_binary_lbfgs(torch, tst, ck, X, w_true)
    rows.append(b1_row)
    qn["b"] = leg_normal_equations(torch, tst, X, y, w_true)
    gram, chunked_row = phase_gram(torch, tst, ck, X, y, w_true, sliced_ref,
                                   qn["b"])
    rows.append(chunked_row)
    torch.cuda.empty_cache()
    observed = phase_observed(torch, tst, ck, X, y)
    torch.cuda.empty_cache()
    phase_analysis(torch, tst, ck, X, y)
    torch.cuda.empty_cache()
    replica, replica_row = phase_replica(torch, tst, ck, X, y, profile)
    rows.append(replica_row)
    obs_rec = phase_obs(observed, replica)
    torch.cuda.empty_cache()
    streamed, Xh, yh, fd = phase_streamed_dense(torch, tst, ck, X, y)
    emit({"phase": "streamed", "dense": streamed})
    streamed_qn, b1_chunk, qn_refs = phase_streamed_qn(
        torch, tst, ck, X, y, w_true, Xh, qn["b"], gram, streamed)
    rows.extend(b1_chunk)
    torch.cuda.empty_cache()
    plan_rec, cm = phase_plan(torch, tst, ck, X, y, w_true, Xh, yh, profile,
                              gram, streamed, streamed_qn,
                              LEG_B_RUNS.pop("bernoulli"))
    # the host rows stay for phase mesh's (j)-(m)
    host_rows = (Xh, fd, yh, qn_refs.pop("yh_ls"), qn_refs.pop("yh_log"))
    del X, y, sliced_ref, Xh, yh
    torch.cuda.empty_cache()
    qn["c"] = leg_multinomial(torch, tst)
    torch.cuda.empty_cache()

    plan_rec["f_normal_placement"] = phase_configs(torch, tst)
    sparse, X_sp, y_sp, w_sgd = phase_sparse(torch, tst, ck)
    qn["d"] = leg_sparse_owlqn(torch, tst, ck, X_sp, y_sp, w_sgd)
    torch.cuda.empty_cache()
    streamed["sparse"], batch = phase_streamed_sparse(torch, tst, ck, X_sp,
                                                      y_sp)
    emit({"phase": "streamed", "sparse": streamed["sparse"]})
    rows.extend(csr_rows(torch, ck, X_sp, sparse, qn["d"],
                         streamed["sparse"], batch))
    del batch
    torch.cuda.empty_cache()
    mesh, mesh_rows = phase_mesh(torch, tst, ck, X_sp, y_sp, profile,
                                 qn["d"]["weights"], host_rows, qn_refs)
    rows.extend(mesh_rows)
    plan_rec["constants"] = plan_constants(torch, cm, plan_rec, gram,
                                           streamed, mesh)
    del host_rows
    os.close(fd)
    del X_sp, y_sp
    torch.cuda.empty_cache()
    serve, serve_rows = phase_serve(torch, tst, ck)
    rows.extend(serve_rows)
    corr, corr_row = phase_corr(torch, tst, ck)
    rows.append(corr_row)
    torch.cuda.empty_cache()
    scenario, scenario_rows = phase_scenario(torch, tst, ck, lint)
    rows.extend(scenario_rows)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd"))
    check(not leaked, f"imported {leaked}")

    emit({"sparse": {
        "shape": [sparse["rows"], sparse["d"]], "nnz": sparse["nnz"],
        "index_dtype": sparse["index_dtype"],
        "csr_bytes": sparse["csr_bytes"],
        "transposed_csr_bytes": sparse["transposed_csr_bytes"],
        "peak_allocated_bytes": sparse["peak_allocated_bytes"],
        "bitwise_repeatable": sparse["bitwise_repeatable"],
        "runs": {f: {k: r[k] for k in (
            "wall_ms_per_iteration", "device_ms_per_iteration",
            "idle_share", "bound_ms", "bound_by", "share_of_bound",
            "accuracy", "loss_first", "loss_last", "top_device_ms")}
            for f, r in sparse["runs"].items()}}})
    emit({"quasi_newton": {
        "binary_lbfgs": {k: qn["a"][k] for k in (
            "cost_evaluations", "objective", "sgd_objective", "auc",
            "numpy_auc", "sweep_ms")} | {k: qn["a"]["profile"][k] for k in (
                "wall_ms_per_iteration", "device_ms_per_iteration",
                "idle_share", "b1_ms", "products_ms", "rest_ms")},
        "normal": {k: qn["b"][k] for k in (
            "objective", "lbfgs_objective", "w_rel_err", "noise_level",
            "gram_ms", "gram_bound_ms", "gram_bound_by")},
        "multinomial": {k: qn["c"][k] for k in (
            "rows", "iterations", "ms_per_iteration", "accuracy",
            "planted_accuracy")},
        "sparse_owlqn": {k: qn["d"][k] for k in (
            "objective", "sgd_objective", "iterations", "ms_per_iteration",
            "exact_zeros", "peak_allocated_bytes", "logistic_objective",
            "logistic_sgd_objective")}}})
    prof_keys = ("wall_ms_per_iteration", "device_ms_per_iteration",
                 "idle_share")
    emit({"gram": {
        "build": {k: gram["a_build"][k] for k in (
            "first_s", "warm_s", "stack_bytes", "peak_allocated_bytes",
            "bound_s", "share_of_bound")},
        "windows_max_abs_err_over_scale": {
            k: v["max_abs_err_over_scale"]
            for k, v in gram["b_windows"].items()},
        "sgd_exact": {k: gram["c_sgd_exact"][k] for k in prof_keys + (
            "history_max_rel_vs_exact_windows",
            "history_max_rel_vs_bf16_kernel_run", "objective",
            "stock_objective", "bound_ms", "share_of_bound")},
        "sgd_aligned": {k: gram["d_sgd_aligned"]["aligned"][k]
                        for k in prof_keys},
        "sgd_chunked": {k: gram["d_sgd_aligned"]["chunked"][k]
                        for k in prof_keys} | {
            "equals_aligned_bitwise":
                gram["d_sgd_aligned"]["chunked_equals_aligned_bitwise"]},
        "lbfgs": {k: gram["e_lbfgs"][k] for k in prof_keys + (
            "iterations", "objective", "stock_lbfgs_objective",
            "stock_lbfgs_ms_per_iteration")},
        "chunked_gradient": {k: gram["f_chunked_gradient"][k]
                             for k in prof_keys + ("launches",)},
        "persistence_bitwise":
            gram["g_persistence"]["loaded_equals_resident_bitwise"],
        "window_loss_rel_err": {k: gram["h_precision"][k]
                                for k in ("f64_sums", "f32_sums")}}})
    emit({"streamed": {
        "dense": {k: streamed[k] for k in (
            "host_copy_seconds", "a_full_batch", "b_sampled",
            "c_contracts", "d_predict", "leg_seconds", "seconds")},
        "sparse": streamed["sparse"]}})
    emit({"streamed_qn": streamed_qn})
    emit({"plan": {k: plan_rec[k] for k in (
        "a_calibration", "b_budget", "c_zero_flag_sgd", "d_zero_flag_gram",
        "e_beyond_budget", "f_normal_placement", "dispatch_tax", "estimates",
        "constants", "seconds")}})
    emit({"mesh": {k: mesh[k] for k in (
        "world1", "b", "combine_ms_by_rank", "prefix_bitwise_rank_order_sum",
        "full_batch_bitwise_rank_order_sum", "full_batch_first_loss_rel",
        "full_batch_history_max_rel", "sampled_objective_ratio", "c_sparse",
        "resident", "job_seconds", "seconds")} | {"streamed": {
            k: v for k, v in mesh["streamed"].items() if k != "by_rank"}}})
    emit({"serve": serve})
    emit({"corr": corr})
    emit({"scenario": {part: {k: v for k, v in rec.items()
                              if k not in ("classes", "counters", "slos")}
                       if isinstance(rec, dict) else rec
                       for part, rec in scenario.items()}})
    emit({"replica": {
        "a_prefix": replica["a_prefix"],
        "b_full": {m: {k: r[k] for k in (
            "objective_ratio", "ms_per_round", "device_ms_per_round",
            "host_share", "single_device_ms_per_iteration")}
            for m, r in replica["b_full"].items() if m != "long"},
        "c_async": {k: replica["c_async"][k] for k in (
            "applied_steps_per_s", "accepted_staleness_histogram",
            "launches", "push_attempts", "objective_ratio")},
        "d_compressed": replica["d_compressed"],
        "e_ha": replica["e_ha"], "f_supervised": replica["f_supervised"],
        "part_seconds": replica["part_seconds"],
        "seconds": replica["seconds"]}})
    emit({"observed": {
        "rows": {row: {"bitwise_equal": r["bitwise_equal"],
                       "capture_ms": r["capture_ms"],
                       "launches_by_source": r["launches_by_source"]} | {
            mode: {k: r[mode][k] for k in (
                "wall_ms_per_iteration", "device_ms_per_iteration",
                "idle_share", "aten_calls_per_iteration",
                "host_syncs_per_run", "graph_replays_per_run",
                "peak_extra_allocated_bytes")}
            for mode in ("eager", "captured")}
            for row, r in observed["rows"].items()},
        "driver": observed["driver"],
        "device_step_equals_host": observed["device_step_equals_host"],
        "sampler_ms": observed["sampler_ms"],
        "seconds": observed["seconds"]}})
    emit({"obs": {
        "a_counters": obs_rec["a_counters"],
        "b_detectors": {k: obs_rec["b_detectors"][k] for k in (
            "fault_free_trips", "kill_trips", "failovers",
            "flightrec_trigger")},
        "c_clis": {k: obs_rec["c_clis"][k] for k in (
            "exit_codes", "chrome_events", "alerts_section_names_failover")},
        "seconds": obs_rec["seconds"]}})
    # the kernel table last but for the card's line: the end of the output
    # is what a reader of a long run sees
    emit({"kernels": [{
        "name": r["name"], "path": r.get("path", "sgd"), "route": "cuda",
        "source": r.get("source", SOURCE),
        "replaces": REPLACES[r["name"]], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "grad_scale": r["grad_scale"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } | {k: r[k] for k in ("host_paced_ms", "old_path_ms",
                           "old_path_host_paced_ms", "nnz", "columns",
                           "share_of_bound", "graph_ms",
                           "library_graph_ms", "one_line_graph_ms",
                           "cuda_launches_per_call", "launches_from",
                           "route", "library_all_rows_ms",
                           "launches_by_route",
                           "library_includes")
         if k in r}
        for r in rows]})
    print(smi, flush=True)
    # one card drove the run, however many the host shows
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
