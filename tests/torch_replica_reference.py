"""Shared pieces of the replica twins (``tests/test_torch_replica*.py``,
``tests/test_torch_store_shard.py``): the data, the exact objective, and
the port's one-process rank-order reference of a synchronous
data-parallel run.

The reference is written out here, apart from the replica package: each
shard's rows padded as a mesh pads them, its own sample stream
(``_make_sampler(..., shard=s)``), the local sums added in shard order
one add at a time over the flattened ``(grad, loss, count)`` vectors,
then the updater — the arithmetic of ``tests/test_torch_parallel.py``'s
``one_process_rank_order``, which pins the 8-rank meshed run bitwise,
widened to any gradient, updater, regularization, sampling and
convergence tolerance."""

import numpy as np
import torch

import tpu_sgd_torch as tst
from tpu_sgd_torch.optimize import gradient_descent as tgd
from tpu_sgd_torch.parallel.data_parallel import pad_to_multiple


def data(n=256, d=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (X @ w_true + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, y, np.zeros(d, np.float32)


def full_objective(X, y, w, reg):
    """Exact full-batch objective (mean squared residual / 2 + L2 reg):
    the matched-loss metric, immune to minibatch sampling noise."""
    w = np.asarray(w, np.float64)
    r = np.asarray(X, np.float64) @ w - y
    return float(0.5 * np.mean(r * r) + 0.5 * reg * np.sum(w ** 2))


def rank_order_reference(gradient, updater, X, y, w0, *, iters=24, frac=0.5,
                         step=0.3, reg=0.1, workers=4, sampling="bernoulli",
                         tol=0.0, seed=42):
    """``(weights, loss history)`` of the synchronous data-parallel run of
    ``workers`` shards, computed in one process on the CPU (module
    docstring).  Convergence is tested as the observed drivers test it:
    ``|w_t - w_(t-1)| < tol * max(|w_t|, 1)`` from the second step on."""
    cfg = tst.SGDConfig(step_size=step, num_iterations=iters,
                        mini_batch_fraction=frac, convergence_tol=tol,
                        reg_param=reg, sampling=sampling, seed=seed)
    Xp, yp, valid = pad_to_multiple(np.asarray(X), np.asarray(y), workers)
    rows = Xp.shape[0] // workers
    padded = Xp.shape[0] != X.shape[0]
    shards = []
    for s in range(workers):
        sl = slice(s * rows, (s + 1) * rows)
        Xs = torch.as_tensor(Xp[sl])
        shards.append((Xs, torch.as_tensor(yp[sl]),
                       torch.as_tensor(valid[sl]) if padded else None,
                       tgd._make_sampler(cfg, Xs, shard=s)))
    w = torch.as_tensor(np.asarray(w0, np.float32))
    d = w.shape[0]
    rv = updater.compute(w, torch.zeros_like(w), 0.0, 1, reg)[1]
    hist = []
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64)
        parts = []
        for Xs, ys, vs, smp in shards:
            sample = None
            if smp is not None:
                smp.seek(i)
                sample = smp.draw()
            if sampling == "sliced" and frac < 1.0:
                m = max(1, round(frac * Xs.shape[0]))
                g, l, c = gradient.window_sums(Xs, ys, w, sample, m,
                                               valid=vs)
            else:
                if sampling == "indexed" and frac < 1.0:
                    Xb, yb = Xs[sample], ys[sample]
                    mask = None if vs is None else vs[sample]
                else:
                    Xb, yb = Xs, ys
                    mask = sample if vs is None else (
                        vs if sample is None else sample & vs)
                g, l, c = gradient.batch_sums(Xb, yb, w, mask)
            parts.append(torch.cat([g.reshape(-1), l.reshape(1),
                                    c.reshape(1)]))
        tot = parts[0]
        for p in parts[1:]:  # shard order, one add at a time
            tot = tot + p
        c = tot[d + 1]
        safe = torch.clamp(c, min=1.0)
        loss = tot[d] / safe + rv
        new_w, new_reg = updater.compute(w, tot[:d] / safe, step, it, reg)
        if not bool(c > 0):
            continue
        hist.append(float(loss))
        delta = float(torch.linalg.vector_norm(new_w - w))
        norm = float(torch.linalg.vector_norm(new_w))
        w, rv = new_w, new_reg
        if tol > 0 and i > 1 and delta < tol * max(norm, 1.0):
            break
    return w.numpy(), np.asarray(hist, np.float32)


class ListSink:
    """Minimal trace sink: collects ``(kind, payload)`` records."""

    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, dict(payload)))
