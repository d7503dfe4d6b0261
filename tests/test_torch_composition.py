"""The single-device cells of the composition grid of
``tests/test_composition.py`` (feed x compressed x resident), one
parametrised case a cell.  Every run of a cell goes through the port on
the CPU and, on the same inputs, through the JAX package's
``GradientDescent`` as ``tests/test_composition.py`` runs it: the loss
histories agree at rtol 1e-4, and the same recorded fallbacks warn on
both sides.

Within the port each cell either trains BITWISE against its recorded
twin, or is matched-loss (<= 1.01x) and says so (compressed cells change
the update rule), or is a LOUD recorded fallback whose warning says
which driver runs instead.  The meshed cells are twinned in
``tests/test_torch_mesh_streamed.py``; the replica cells wait for ROADMAP
A11.
"""

import warnings

import numpy as np
import pytest

from tpu_sgd.ops.gradients import HingeGradient as JaxHingeGradient
from tpu_sgd.ops.sparse import sparse_data as jax_sparse_data
from tpu_sgd.optimize.gradient_descent import \
    GradientDescent as JaxGradientDescent
from tpu_sgd_torch.ops.gradients import HingeGradient
from tpu_sgd_torch.ops.sparse import sparse_data
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent

TOL_MATCHED = 0.01  # compressed cells: <= 1.01x matched final loss
HISTORY_RTOL = 1e-4  # the port's history against the JAX package's
#: the recorded fallbacks, by words that both packages' warnings use
FALLBACKS = ("host hop IS the data feed", "partially-resident",
             "already compressed")


def _dense(n=256, d=16, seed=3):
    """``(port X, JAX X, y, w0)``: one numpy X for both packages."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (X @ w_true + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, X, y, np.zeros(d, np.float32)


def _sparse(n=160, d=300, seed=4):
    """``(port CSR, JAX BCOO, y, w0)`` from the same numpy draws."""
    X, y, _ = sparse_data(n, d, nnz_per_row=6, kind="svm", seed=seed)
    jX, jy, _ = jax_sparse_data(n, d, nnz_per_row=6, kind="svm", seed=seed)
    np.testing.assert_array_equal(np.asarray(X.to_dense()),
                                  np.asarray(jX.todense()))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(jy))
    return X, jX, np.asarray(y), np.zeros(d, np.float32)


def _opt(package, *, iters=16, frac=1.0, sampling="bernoulli", k=4, c=0,
         wc=None, step=0.1, seed=7, R=0, hinge=False):
    if package == "port":
        o = GradientDescent(HingeGradient() if hinge else None,
                            device="cpu")
    else:
        o = JaxGradientDescent(JaxHingeGradient() if hinge else None)
    o.set_num_iterations(iters).set_step_size(step) \
        .set_mini_batch_fraction(frac).set_sampling(sampling) \
        .set_convergence_tol(0.0).set_seed(seed) \
        .set_host_streaming(True, resident_rows=R).set_superstep(k)
    if c:
        o.set_residency(c)
    if wc:
        o.set_ingest_options(wire_compress=wc)
    return o


def _run(package, data, spec):
    """One run: ``(weights, history, [(warning category, message)])``."""
    X_port, X_jax, y, w0 = data
    X = X_port if package == "port" else X_jax
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        w, h = _opt(package, **spec).optimize_with_history((X, y), w0)
    said = [(m.category, str(m.message)) for m in caught]
    return np.asarray(w), np.asarray(h), said


def _fallbacks(said):
    return sorted({f for f in FALLBACKS for cat, m in said
                   if issubclass(cat, RuntimeWarning) and f in m})


def _pair(data, spec):
    """The port's run of ``spec`` held against the JAX package's on the
    same inputs; returns both."""
    got = _run("port", data, spec)
    ref = _run("jax", data, spec)
    assert _fallbacks(got[2]) == _fallbacks(ref[2])
    assert len(got[1]) == len(ref[1])
    np.testing.assert_allclose(got[1], ref[1], rtol=HISTORY_RTOL)
    return got, ref


def _twin(data, **spec):
    """The port's ``(weights, history, warnings)``, held against the JAX
    package's run."""
    return _pair(data, spec)[0]


def _quiet(data, **spec):
    """A twin run in which the port warns nothing at all and the JAX
    package no RuntimeWarning."""
    got, ref = _pair(data, spec)
    assert got[2] == []
    assert not any(issubclass(cat, RuntimeWarning) for cat, _ in ref[2])
    return got


def _loud(data, fallback, **spec):
    """A twin run whose warning names ``fallback`` on both sides."""
    got = _twin(data, **spec)
    assert fallback in _fallbacks(got[2])
    return got


def _eq(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def cell_dense_full_batch_resident(wc):
    data = _dense()
    _eq(_twin(data, k=4, wc=wc), _quiet(data, k=4, c=2, wc=wc))


def cell_dense_compressed_matched_loss_not_bitwise(_):
    data = _dense()
    _, h_dense, _ = _twin(data, iters=120, k=4)
    _, h_comp, _ = _quiet(data, iters=120, k=4, c=2, wc="topk:0.75")
    assert abs(h_comp[-1] - h_dense[-1]) <= TOL_MATCHED * abs(h_dense[-1])
    assert not np.array_equal(h_comp, h_dense)


def cell_slab_fully_resident_compressed_bitwise_replay(_):
    data = _dense(n=200)
    spec = dict(frac=0.25, sampling="sliced", k=4, c=2, wc="topk:0.25",
                R=200)
    _eq(_quiet(data, **spec), _quiet(data, **spec))


def cell_slab_partial_compressed_is_loud_dense_wire(_):
    data = _dense(n=200)
    spec = dict(frac=0.25, sampling="sliced", k=4, R=100)
    _eq(_loud(data, "partially-resident", wc="topk:0.25", **spec),
        _twin(data, **spec))


def cell_host_sampled_resident_is_loud_superstep(_):
    data = _dense()
    _eq(_loud(data, "host hop IS the data feed", frac=0.5, k=4, c=2),
        _twin(data, frac=0.5, k=4))


def cell_sparse_full_batch_resident(_):
    data = _sparse()
    _eq(_twin(data, k=4, hinge=True), _quiet(data, k=4, c=2, hinge=True))


def cell_sparse_bernoulli_resident_is_loud(_):
    data = _sparse()
    _eq(_loud(data, "host hop IS the data feed", frac=0.5, k=4, c=2,
              hinge=True),
        _twin(data, frac=0.5, k=4, hinge=True))


def cell_sparse_compressed_is_a_loud_no_op(_):
    data = _sparse()
    _eq(_loud(data, "already compressed", frac=0.5, k=4, wc="topk:0.25",
              hinge=True),
        _twin(data, frac=0.5, k=4, hinge=True))


CELLS = {
    "dense-full-batch-resident": (cell_dense_full_batch_resident, None),
    "dense-full-batch-compressed-resident": (cell_dense_full_batch_resident,
                                             "topk:0.25"),
    "dense-compressed-matched-loss": (
        cell_dense_compressed_matched_loss_not_bitwise, None),
    "slab-fully-resident-compressed": (
        cell_slab_fully_resident_compressed_bitwise_replay, None),
    "slab-partial-compressed-fallback": (
        cell_slab_partial_compressed_is_loud_dense_wire, None),
    "host-sampled-resident-fallback": (
        cell_host_sampled_resident_is_loud_superstep, None),
    "sparse-full-batch-resident": (cell_sparse_full_batch_resident, None),
    "sparse-bernoulli-resident-fallback": (
        cell_sparse_bernoulli_resident_is_loud, None),
    "sparse-compressed-no-op": (cell_sparse_compressed_is_a_loud_no_op,
                                None),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_composition_cell(cell):
    fn, arg = CELLS[cell]
    fn(arg)
