"""OWL-QN, orthant-wise limited-memory quasi-Newton for L1 objectives: the
port of ``tpu_sgd/optimize/owlqn.py`` (device-resident data, one device).

Objective: ``F(w) = (1/n)·Σ loss(w; x, y) + reg_param·‖w‖₁``, the
``L1Updater`` regularization.  Algorithm (Andrew & Gao 2007):

  1. the pseudo-gradient ⋄F of the non-smooth objective,
  2. the L-BFGS two-loop direction from SMOOTH-part curvature pairs,
     projected onto the pseudo-gradient's descent orthant,
  3. a backtracking line search over orthant-projected trial points
     ``π(w + t·d; ξ)``, the whole ladder in one ``loss_sweep`` pass,
  4. curvature pairs (s, y) from the smooth gradient only.

The smooth cost is the same ``Gradient.batch_sums`` call as L-BFGS's (one
fused-kernel launch for the binary families on dense X, or the total
statistics for Lasso least squares under ``set_sufficient_stats``).  Host syncs per
iteration: the directional derivative, the sweep (its objectives and
predicted decreases in one read) and ``s . y``.  Host rows beyond the card
take L-BFGS's two schedules (``set_host_streaming``,
``set_streamed_stats``), inherited, and so does the data mesh
(``set_mesh``): the rank-order combine of the smooth sums and of the
sweep's loss sums, with the L1 term added after the combine, as in the
JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor
from tpu_sgd_torch.ops.gradients import Gradient
from tpu_sgd_torch.optimize.lbfgs import (
    LBFGS,
    _build_cost,
    _build_loss_only,
    _build_loss_sweep,
    _push_correction,
    _streams_local_rows,
    _two_loop,
    _warn_sequential_line_search,
    agree_on_host,
)
from tpu_sgd_torch.optimize.optimizer import Dataset

Tensor = torch.Tensor


def _pseudo_gradient(w: Tensor, g: Tensor, reg: Tensor) -> Tensor:
    """⋄F: the steepest-descent direction's negative for f + ‖reg·w‖₁.
    ``reg`` is a per-coordinate penalty vector (0 entries are unpenalized:
    the intercept column)."""
    right = g + reg  # derivative approaching from w_i -> 0+
    left = g - reg   # derivative approaching from w_i -> 0-
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, 0.0))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def _project_orthant(v: Tensor, xi: Tensor, penalized: Tensor) -> Tensor:
    """Zero the PENALIZED components of ``v`` (a vector, or a stack of
    rows) whose sign disagrees with orthant ``xi``; unpenalized
    coordinates move freely (their objective is smooth)."""
    return torch.where(penalized & (torch.sign(v) != xi), 0.0, v)


class OWLQN(LBFGS):
    """Orthant-wise LBFGS for ``smooth loss + reg_param * ||w||_1``.

    ``reg_param=0`` degenerates to plain LBFGS on the smooth loss.
    ``penalize_intercept=False`` (the model wrappers' setting with an
    intercept) exempts the LAST weight coordinate, the GLM harness's
    appended bias column, from the penalty."""

    #: deeper backtracking than plain LBFGS: orthant projection can zero
    #: out most of a large step, so more halvings are worth trying
    _LS_TRIALS = 30

    def __init__(
        self,
        gradient: Gradient = None,
        num_corrections: int = 10,
        convergence_tol: float = 1e-6,
        max_num_iterations: int = 100,
        reg_param: float = 0.0,
        penalize_intercept: bool = True,
        device=None,
    ):
        super().__init__(
            gradient=gradient,
            updater=None,
            num_corrections=num_corrections,
            convergence_tol=convergence_tol,
            max_num_iterations=max_num_iterations,
            reg_param=reg_param,
            device=device,
        )
        self.penalize_intercept = bool(penalize_intercept)

    def set_updater(self, u):
        raise AttributeError(
            "OWLQN has no Updater axis: the L1 penalty is part of the "
            "objective (reg_param); use LBFGS for updater-style reg"
        )

    def set_penalize_intercept(self, flag: bool):
        self.penalize_intercept = bool(flag)
        return self

    def _reg_vector(self, w):
        """Per-coordinate L1 strengths.  The intercept exemption assumes
        VECTOR weights (the GLM bias rides as the LAST coordinate): a
        flattened multinomial matrix has one intercept per class row."""
        reg = torch.full(w.shape, self.reg_param, dtype=w.dtype,
                         device=w.device)
        if not self.penalize_intercept:
            if getattr(self.gradient, "num_classes", 2) > 2:
                raise NotImplementedError(
                    "penalize_intercept=False assumes vector weights "
                    "(one bias as the last coordinate); multinomial "
                    "weights carry one intercept per class row — "
                    "penalize the intercepts or use LBFGS with "
                    "SquaredL2Updater"
                )
            reg[-1] = 0.0
        return reg

    def _host_streamed_evaluators(self, X, y, initial_weights):
        """OWL-QN's shape of the streamed CostFun's evaluators (see
        ``LBFGS._host_streamed_evaluators``): ``(w0, reg, smooth_cost1,
        sweep1, full_loss1)``, the smooth part from the cost and the FULL
        objective (smooth + L1) from the sweep and the loss, as
        :meth:`_owlqn_loop` takes them; None for empty input."""
        if X.shape[0] == 0 and not _streams_local_rows(self.mesh):
            return None
        scf = self._host_streamed_costfun(X, y)
        w = as_tensor(initial_weights, scf.device, torch.float32)
        reg = self._reg_vector(w)

        def l1_value(wv):
            return torch.sum(reg * torch.abs(wv), dim=-1)

        def smooth_cost1(wv):
            g_sum, l_sum, c = scf.cost_sums(wv)
            return l_sum / c, g_sum / c

        if hasattr(self.gradient, "loss_sweep"):
            def sweep1(W):
                l_sum, c = scf.sweep_sums(W)
                return l_sum / c + l1_value(W)

            return w, reg, smooth_cost1, sweep1, None
        _warn_sequential_line_search(self.gradient, self._LS_TRIALS)

        def full_loss1(wv):
            l_sum, c = scf.loss_sums(wv)
            return l_sum / c + l1_value(wv)

        return w, reg, smooth_cost1, None, full_loss1

    def optimize_with_history(self, data: Dataset, initial_weights):
        X, y = data
        streamed = self._maybe_streamed_reentry(X, y, initial_weights)
        if streamed is not None:
            return streamed
        if self.host_streaming:
            # before _coerce_inputs, which would move X to the card whole
            ev = self._host_streamed_evaluators(X, y, initial_weights)
            if ev is not None:
                return self._owlqn_loop(*ev, self.mesh)
        arrays, w = self._resident(data, initial_weights)
        if arrays is None:
            return w, self._loss_history
        gradient, X, y, Xt, valid, mesh = arrays
        reg = self._reg_vector(w)  # per-coordinate, broadcast through

        def l1_value(wv):
            return torch.sum(reg * torch.abs(wv), dim=-1)

        def zero(wv):
            return torch.zeros(wv.shape[:-1], dtype=wv.dtype,
                               device=wv.device)

        # the smooth cost; the L1 part is added where the algorithm needs
        # the FULL objective (after a mesh's combine)
        smooth_cost1 = _build_cost(gradient, zero, torch.zeros_like, X, y, Xt,
                                   valid, mesh)
        if hasattr(gradient, "loss_sweep"):
            sweep1 = _build_loss_sweep(gradient, l1_value, X, y, valid, mesh)
            return self._owlqn_loop(w, reg, smooth_cost1, sweep1, None, mesh)
        _warn_sequential_line_search(gradient, self._LS_TRIALS)
        full_loss1 = _build_loss_only(gradient, l1_value, X, y, Xt, valid,
                                      mesh)
        return self._owlqn_loop(w, reg, smooth_cost1, None, full_loss1, mesh)

    def _owlqn_loop(self, w, reg, smooth_cost1, sweep1, full_loss1,
                    mesh=None):
        """The orthant-wise iteration loop over full-batch evaluators:
        ``smooth_cost1(w) -> (f_smooth, g_smooth)``, ``sweep1(W_trials)
        -> (T,)`` FULL objectives (None for gradients without a sweep
        rule), ``full_loss1(w) -> F`` (the sequential fallback).  On a
        ``mesh`` the ranks check that they agree on the host scalars
        before each decision to stop (``lbfgs.agree_on_host``)."""
        penalized = reg > 0
        any_penalty = self.reg_param > 0
        n_ls = self._LS_TRIALS
        ladder_h = (0.5 ** np.arange(n_ls)).astype(np.float32)
        ladder = torch.as_tensor(ladder_h, device=w.device)
        swept = sweep1 is not None

        m = self.num_corrections
        d_dim = w.shape[0]
        s_stack = torch.zeros((m, d_dim), dtype=w.dtype, device=w.device)
        y_stack = torch.zeros((m, d_dim), dtype=w.dtype, device=w.device)
        rho = torch.zeros((m,), dtype=w.dtype, device=w.device)
        k = 0

        f_s, g = smooth_cost1(w)
        F = float(f_s) + float(torch.sum(reg * torch.abs(w)))
        losses: List[float] = [F]
        for _ in range(self.max_num_iterations):
            pg = _pseudo_gradient(w, g, reg)
            direction = -_two_loop(pg, s_stack, y_stack, rho, k)
            if any_penalty:
                # restrict to the descent orthant indicated by -pg
                direction = _project_orthant(direction, torch.sign(-pg),
                                             penalized)
            dir_deriv = float(torch.dot(pg, direction))
            agree_on_host(mesh, (dir_deriv,), w.device)
            if dir_deriv >= 0:
                direction = -pg
                dir_deriv = float(torch.dot(pg, direction))
                agree_on_host(mesh, (dir_deriv,), w.device)
                if dir_deriv >= 0:  # pg == 0: stationary point
                    break
            # orthant for the trial points: sign(w), or sign(-pg) at zeros
            xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
            # Armijo on the PROJECTED step (Andrew & Gao): the predicted
            # decrease is pg . (w_trial - w), not t * pg . d
            if swept:
                W_trials = w[None, :] + ladder[:, None] * direction[None, :]
                if any_penalty:
                    W_trials = _project_orthant(W_trials, xi, penalized)
                preds = (W_trials - w[None, :]) @ pg
                # one read: the trial objectives and predicted decreases
                F_trials, preds_h = torch.stack(
                    [sweep1(W_trials), preds]).cpu().numpy()
                ok = (F_trials <= F + 1e-4 * preds_h) & (preds_h < 0)
                j = int(np.argmax(ok)) if ok.any() else -1
                accepted = j >= 0
                if accepted:
                    w_new = W_trials[j]
                    F_new = float(F_trials[j])
            else:
                t = 1.0
                accepted = False
                for _ls in range(n_ls):
                    w_new = w + t * direction
                    if any_penalty:
                        w_new = _project_orthant(w_new, xi, penalized)
                    F_new = float(full_loss1(w_new))
                    pred = float(torch.dot(pg, w_new - w))
                    if F_new <= F + 1e-4 * pred and pred < 0:
                        accepted = True
                        break
                    t *= 0.5
            agree_on_host(mesh, (accepted,), w.device)
            if not accepted:
                break
            _, g_new = smooth_cost1(w_new)
            s = w_new - w
            yv = g_new - g  # smooth-part curvature only
            sy = float(torch.dot(s, yv))
            if sy > 1e-10:
                s_stack, y_stack, rho, k = _push_correction(
                    s_stack, y_stack, rho, k, m, s, yv, sy)
            w, g = w_new, g_new
            F = F_new
            losses.append(F)
            agree_on_host(mesh, (sy, F), w.device)
            rel = abs(losses[-2] - losses[-1]) / max(
                abs(losses[-2]), abs(losses[-1]), 1.0
            )
            if rel < self.convergence_tol:
                break

        self._loss_history = np.asarray(losses, np.float32)
        return w, self._loss_history
