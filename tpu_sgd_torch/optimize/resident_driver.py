"""Device-resident training driver: the port of
``tpu_sgd/optimize/resident_driver.py`` (``set_residency``).

The JAX package runs the whole observed run as one ``lax.while_loop``
program over fused superstep scans, with an ordered ``io_callback`` that
hands the host a bounded ring of per-step history every ``cadence``
supersteps.  Here a window is ``cadence`` replays of the K-iteration
block's CUDA graph (``optimize/gradient_descent.py``), queued back to
back: each replay's ys rows are copied into a device ring of ``C·K``
rows, and one copy to pinned host memory goes out at the window's end.
The host then replays the ring through the shared
:func:`~tpu_sgd_torch.optimize.gradient_descent._replay_fused_steps`
(:class:`ResidentBookkeeper`), polls the stop signal, and queues the next
window.  So the loss history, the convergence iteration, listener events
and the checkpoint cadence are byte for byte the superstep driver's, and
the host waits for the card once a window instead of once a block.

Window semantics follow the JAX driver: the window hook
(:meth:`ResidentBookkeeper.on_window`, which bumps ``train.io_callback``,
passes the ``io.resident_callback`` failpoint inside the retry policy's
scope, polls the stop signal and replays) fires on each FULL window in
which the device's float32 convergence predicate did not fire; a partial
last window, or one where the predicate fired, replays without it.  The
host replay stays the authority on convergence: where the float32
predicate fires and the host's comparison does not, the run simply goes
on from the replayed state.  A run that converges mid-window has run the
window's remaining blocks; its weights come from the ring row of the true
last iteration.

Failure containment: an exception in the window's bookkeeping (an
injected checkpoint-save fault, a listener error) is stashed, no further
window is queued, and the ORIGINAL exception re-raises on the host, where
``TrainingSupervisor`` sees its true class and resumes from the last
checkpoint.  A replayed graph calls nothing on the host, so the ring has
no size cap.

Extra carried state (the JAX driver's ``with_extra``): when the block
carries the compressed wire's error-feedback accumulator
(``_RunState.extra``), each ring row holds it after the step's other
values, the rings gain a seventh leaf, and the bookkeeper hands each
window's accumulators to ``extras_cb(i0w, extras)`` before the replay, so
a checkpoint saved mid-window reads the accumulator of its exact
iteration (``last_extra`` follows the replayed boundary like ``last_w``).

Observability: the driver emits ``train.resident_dispatch`` and
``train.window`` spans and the ``train.io_callback`` counter.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.obs.counters import inc as obs_inc
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.reliability.failpoints import failpoint


class ResidentBookkeeper:
    """Host-side bookkeeping state for ONE resident run.

    Owns the loss list, the running reg value, the listener and the
    checkpoint save callback, and replays ring windows through the one
    shared ``_replay_fused_steps``, so resident bookkeeping cannot drift
    from the superstep driver's.  ``on_window`` is the window hook;
    ``replay`` is also called by the driver for a window the hook does
    not take.
    """

    def __init__(self, config: SGDConfig, k: int, cadence: int, *,
                 losses: list, reg_val: float, start_iter: int,
                 listener=None, save_cb: Optional[Callable] = None,
                 save_every: int = 0, stop_signal=None,
                 retry_policy=None, check_numerics: bool = False,
                 extras_cb: Optional[Callable] = None):
        self.cfg = config
        self.k = int(k)
        self.cadence = int(cadence)
        self.losses = losses
        self.reg_val = float(reg_val)
        self.listener = listener
        self.save_cb = save_cb
        self.save_every = int(save_every)
        self.stop_signal = stop_signal
        self.retry_policy = retry_policy
        self.check_numerics = bool(check_numerics)
        #: called as ``extras_cb(i0w, extras)`` with a window's per-step
        #: extra state (the error-feedback accumulators) before its replay
        self.extras_cb = extras_cb
        #: last iteration whose bookkeeping has been replayed (the
        #: preemption boundary)
        self.replayed_through = int(start_iter) - 1
        #: host copy of the weights AT ``replayed_through`` (from the ring
        #: rows: the final state when a run ends inside a block)
        self.last_w: Optional[np.ndarray] = None
        #: host copy of the extra state AT ``replayed_through`` (runs that
        #: carry one)
        self.last_extra: Optional[np.ndarray] = None
        self.host_converged = False
        self.stop_requested = False
        self.error: Optional[BaseException] = None
        self.windows_fired = 0
        self._t_mark = time.perf_counter()

    # -- the window hook -------------------------------------------------------
    def on_window(self, i0w, *rings) -> bool:
        """Replay one FULL window and poll the stop signal.

        Returns whether the run stops.  Never raises: an exception is
        stashed in ``error`` (see the module docstring)."""
        try:
            self.windows_fired += 1
            obs_inc("train.io_callback")
            with span("train.window", supersteps=self.cadence) as sp:

                def _probe():
                    # THE host-side fault-injection site of the resident
                    # path, BEFORE any bookkeeping mutates, so a healed
                    # retry replays nothing twice
                    failpoint("io.resident_callback")
                    return bool(self.stop_signal()) \
                        if self.stop_signal is not None else False
                if self.retry_policy is not None:
                    want_stop = self.retry_policy.call(_probe)
                else:
                    want_stop = _probe()
                i0_host = int(i0w)
                sp.set(i0=i0_host)
                self.replay(i0_host, rings, self.cadence)
            if want_stop and not self.host_converged:
                self.stop_requested = True
            return bool(self.host_converged or self.stop_requested)
        except BaseException as e:  # noqa: BLE001 — see the docstring
            self.error = e
            return True

    # -- shared replay -----------------------------------------------------
    def replay(self, i0w: int, rings, n_supersteps: int) -> None:
        """Replay ``n_supersteps`` blocks of ring rows starting at
        iteration ``i0w`` with EXACTLY the fused drivers' bookkeeping
        (``_replay_fused_steps`` per block).  Steps past
        ``num_iterations`` are bounded out here.  A seventh leaf carries
        the per-step extra state (see the module docstring)."""
        from tpu_sgd_torch.optimize.gradient_descent import (
            _replay_fused_steps,
        )

        K, cfg = self.k, self.cfg
        exs = None
        if len(rings) == 7:
            exs, rings = rings[6], rings[:6]
            if self.extras_cb is not None:
                self.extras_cb(i0w, exs)
        ws, ls, rs, cs, dns, wns = rings
        now = time.perf_counter()
        n_steps = max(1, n_supersteps * K)
        wall_dt = (now - self._t_mark) / n_steps
        self._t_mark = now
        for s in range(n_supersteps):
            base = i0w + s * K
            if base > cfg.num_iterations:
                break
            steps = min(K, cfg.num_iterations - base + 1)
            lo = s * K
            t_last, self.reg_val, conv = _replay_fused_steps(
                (ws[lo:lo + K], ls[lo:lo + K], rs[lo:lo + K],
                 cs[lo:lo + K], dns[lo:lo + K], wns[lo:lo + K]),
                base, steps, self.losses, self.reg_val, cfg,
                listener=self.listener, wall_dt=wall_dt,
                check_numerics=self.check_numerics,
                save_cb=self.save_cb, save_every=self.save_every,
            )
            self.replayed_through = base + t_last
            self.last_w = np.asarray(ws[lo + t_last])
            if exs is not None:
                self.last_extra = np.asarray(exs[lo + t_last])
            if conv:
                self.host_converged = True
                break


def _device_converged(rings, i0w: int, tol: float) -> bool:
    """The JAX driver's device predicate over a window's rows, in
    float32: a recorded step (count > 0) from the second iteration on
    with ``‖Δw‖ < tol · max(‖w‖, 1)``."""
    if tol <= 0.0:
        return False
    cs, dns, wns = rings[3], rings[4], rings[5]
    idx = i0w + np.arange(cs.shape[0])
    f32 = np.float32
    hit = (cs > 0) & (idx > 1) & (
        dns < f32(tol) * np.maximum(wns, f32(1.0)))
    return bool(np.any(hit))


class ResidentLoop:
    """Windows of ``cadence`` replays of one K-iteration block.

    ``runner`` is the observed driver's block runner
    (``gradient_descent._BlockRunner`` with K ys rows): it replays the
    captured graph for a full block and runs a shorter block eagerly.
    ``run()`` may be called repeatedly (resumes included); the graph is
    the runner's and is captured once."""

    def __init__(self, runner, config: SGDConfig, k: int, cadence: int):
        if int(cadence) < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        if int(k) < 1:
            raise ValueError(f"superstep k must be >= 1, got {k}")
        if runner.k != int(k):
            raise ValueError(
                f"the runner's block holds {runner.k} iterations, not {k}")
        self.runner = runner
        self.config = config
        self.k = int(k)
        self.cadence = int(cadence)
        ys = runner.state.ys
        self.ring = torch.empty((self.cadence * self.k, ys.shape[1]),
                                dtype=ys.dtype, device=ys.device)
        self.host_ring = (torch.empty(self.ring.shape, dtype=ys.dtype,
                                      pin_memory=True)
                          if ys.is_cuda else None)

    def _fetch(self, rows: int) -> np.ndarray:
        """The window's ring rows on the host: one copy into pinned
        memory, then one wait for the card."""
        from tpu_sgd_torch.optimize.gradient_descent import _fetch_rows

        return _fetch_rows(self.ring, rows, self.host_ring)

    def run(self, start_iter: int, hooks: ResidentBookkeeper):
        """Run from ``start_iter`` (the runner's state is set there) and
        finalize through ``hooks``.

        Returns ``(weights_np, converged)`` with every side effect (loss
        history, listener events, checkpoint saves) applied by the window
        replays.  Raises the stashed hook exception, or
        ``TrainingPreempted`` at the exact replayed boundary when the stop
        signal fired."""
        from tpu_sgd_torch.reliability.supervisor import TrainingPreempted

        cfg, K, C = self.config, self.k, self.cadence
        N = cfg.num_iterations
        st = self.runner.state
        i = int(start_iter)
        with span("train.resident_dispatch", i0=i):
            while i <= N:
                i0w, blocks, rows, full = i, 0, 0, True
                while blocks < C and i <= N:
                    steps = min(K, N - i + 1)
                    full = full and steps == K
                    self.runner.run(i, steps)
                    self.ring[rows:rows + steps].copy_(st.ys[:steps])
                    i += steps
                    rows += steps
                    blocks += 1
                rings = st.ys_leaves(self._fetch(rows))
                if blocks == C and full and not _device_converged(
                        rings, i0w, cfg.convergence_tol):
                    hooks.on_window(i0w, *rings)
                else:
                    hooks.replay(i0w, rings, blocks)
                if (hooks.error is not None or hooks.stop_requested
                        or hooks.host_converged):
                    break
        if hooks.error is not None:
            raise hooks.error
        if hooks.stop_requested and not hooks.host_converged:
            boundary = hooks.replayed_through
            if hooks.save_cb is not None:
                hooks.save_cb(boundary, hooks.last_w, hooks.reg_val)
            raise TrainingPreempted(boundary)
        return hooks.last_w, hooks.host_converged
