"""Serving plane of the PyTorch port (``tpu_sgd_torch/serve``,
``ops/bucketed.py``) on the CPU: the twins of ``tests/test_serve.py``, and
parity with the JAX package (``tpu_sgd/serve``).

Tiers: host decisions (buckets, ``stack_rows``' layout, the batcher's
admission decisions and ledgers, the registry's version sequence) equal
the JAX package's exactly; scores match its scores at rtol 1e-5 / atol
1e-5 x max|score|; within the port the dense endpoint is bitwise
``model.predict``.  No test here reads a wall clock: deadlines are driven
by moving a request's enqueue stamp, flushes by starting and stopping the
batcher.
"""

import json

import numpy as np
import pytest
import torch

import tpu_sgd.serve as jserve
from tpu_sgd.models import LinearRegressionModel as JLinear
from tpu_sgd.models import LogisticRegressionModel as JLogistic
from tpu_sgd.models import MultinomialLogisticRegressionModel as JMulti
from tpu_sgd.models import SVMModel as JSVM
from tpu_sgd.utils import CheckpointManager as JCheckpointManager
from tpu_sgd_torch.interop import (glm_model_from_numpy,
                                   multinomial_model_from_numpy)
from tpu_sgd_torch.models import (LinearRegressionModel,
                                  LogisticRegressionModel,
                                  MultinomialLogisticRegressionModel,
                                  StreamingLinearRegressionWithSGD, SVMModel)
from tpu_sgd_torch.ops import bucketed, cuda_kernels
from tpu_sgd_torch.serve import (BackpressureError, MicroBatcher,
                                 ModelRegistry, NoModelError, Overloaded,
                                 PredictEngine, Server, stack_rows)
from tpu_sgd_torch.serve.metrics import nearest_rank
from tpu_sgd_torch.utils import CheckpointManager, JsonLinesEventLog

CPU = "cpu"


def _linear_model(rng, d=12):
    return LinearRegressionModel(
        rng.normal(size=d).astype(np.float32), 0.25, device=CPU)


def _engine_batcher(rng, model=None, **kw):
    model = model if model is not None else _linear_model(rng)
    engine = PredictEngine(device=CPU)
    return MicroBatcher(lambda X: engine.predict_batch(model, X), **kw), model


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _sparse_row(dense_row):
    return torch.from_numpy(np.asarray(dense_row, np.float32)).to_sparse()


def _stream_batch(rng, w_true, n=256):
    d = w_true.shape[0]
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = X @ w_true + 0.01 * rng.normal(size=n).astype(np.float32)
    return X, y


def _streaming(rng, d, tmp_path, iters=15):
    alg = StreamingLinearRegressionWithSGD(step_size=0.3,
                                           num_iterations=iters, device=CPU)
    alg.set_initial_weights(np.zeros(d, np.float32))
    alg.set_checkpoint(str(tmp_path), every=1)
    return alg


def _expire(batcher, lane="interactive", by_s=0.12):
    """Age every queued request of ``lane`` by ``by_s`` seconds: its
    deadline expires without the test sleeping."""
    with batcher._cond:
        for r in batcher._lanes[lane]:
            r.t_enqueue -= by_s


# -- (a) coalescing --------------------------------------------------------
def test_single_rows_coalesce_into_one_batch_call(rng):
    model = _linear_model(rng)
    engine = PredictEngine(device=CPU)
    calls = []

    def counted(X):
        calls.append(int(X.shape[0]))
        return engine.predict_batch(model, X)

    batcher = MicroBatcher(counted, max_batch=64, max_latency_s=0.01)
    X = rng.normal(size=(9, 12)).astype(np.float32)
    futs = [batcher.submit(X[i]) for i in range(9)]
    with batcher:
        got = np.asarray([f.result(timeout=30) for f in futs])
    assert calls == [9]  # one coalesced call, not nine
    np.testing.assert_array_equal(got, _host(model.predict(X)))


# -- (b) deadline flush ----------------------------------------------------
def test_lone_request_answered_by_the_deadline_flush(rng):
    """A lone request in a batcher whose batch never fills is flushed by
    the max-latency deadline alone: one batch of one row (no latency is
    asserted; the future's timeout only guards a dead flush thread)."""
    model = _linear_model(rng)
    batcher, _ = _engine_batcher(rng, model, max_batch=512,
                                 max_latency_s=0.05, max_queue=64)
    with batcher:
        out = batcher.predict(rng.normal(size=12).astype(np.float32),
                              timeout=60)
    assert np.isfinite(out)
    assert batcher.batch_count == 1


# -- (c) backpressure ------------------------------------------------------
def test_full_queue_rejects_with_backpressure(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                 max_queue=4)
    x = rng.normal(size=12).astype(np.float32)
    futs = [batcher.submit(x) for _ in range(4)]  # not started: queue holds
    with pytest.raises(BackpressureError):
        batcher.submit(x)
    assert batcher.reject_count == 1
    with batcher:  # drain on stop answers the queued four
        pass
    assert all(np.isfinite(f.result(timeout=30)) for f in futs)


# -- (d) hot reload + rollback --------------------------------------------
def test_hot_reload_and_corrupt_rollback(rng, tmp_path):
    d = 8
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path)
    registry = ModelRegistry(str(tmp_path), alg.algorithm.create_model,
                             device=CPU)
    alg.add_model_update_listener(registry.on_model_update)
    server = Server(registry=registry, max_latency_s=0.005,
                    device=CPU).start()
    try:
        x = rng.normal(size=d).astype(np.float32)
        alg.train_on_batch(*_stream_batch(rng, w_true))
        v1 = registry.current_version
        p1 = server.predict(x, timeout=30)
        assert p1 == float(alg.latest_model().predict(x))

        alg.train_on_batch(*_stream_batch(rng, w_true))
        v2 = registry.current_version
        assert v2 > v1
        p2 = server.predict(x, timeout=30)
        assert p2 == float(alg.latest_model().predict(x))
        assert p2 != p1  # new weights actually serve

        bad_version = v2 + 3
        (tmp_path / f"ckpt_{bad_version:08d}.npz").write_bytes(
            b"\x00garbage, not an npz")
        assert registry.maybe_reload() is False
        assert registry.current_version == v2
        assert bad_version in registry.bad_versions
        assert server.predict(x, timeout=30) == p2
        assert registry.maybe_reload() is False  # never retried
    finally:
        server.stop()


def test_registry_pin_and_unpin(rng, tmp_path):
    d = 6
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path, iters=10)
    registry = ModelRegistry(str(tmp_path), alg.algorithm.create_model,
                             device=CPU)
    alg.train_on_batch(*_stream_batch(rng, w_true))
    alg.train_on_batch(*_stream_batch(rng, w_true))
    registry.pin(1)
    assert registry.current_version == 1 and registry.pinned
    assert registry.maybe_reload() is False
    assert registry.current_version == 1
    registry.unpin()
    assert registry.maybe_reload() is True
    assert registry.current_version == 2
    with pytest.raises(FileNotFoundError):
        registry.pin(99)


def test_registry_empty_directory_raises(tmp_path):
    registry = ModelRegistry(
        str(tmp_path),
        lambda w, b: LinearRegressionModel(w, b), device=CPU)
    with pytest.raises(NoModelError):
        registry.model()


# -- (e) padded/bucketed exactness ----------------------------------------
def _families(rng, d):
    return [
        _linear_model(rng, d),
        LogisticRegressionModel(rng.normal(size=d).astype(np.float32),
                                -0.1, device=CPU),
        SVMModel(rng.normal(size=d).astype(np.float32), 0.2, device=CPU),
        MultinomialLogisticRegressionModel(
            rng.normal(size=3 * (d + 1)).astype(np.float32), 0.0,
            num_classes=4, num_features=d + 1, has_intercept_column=True,
            device=CPU),
        LogisticRegressionModel(rng.normal(size=d).astype(np.float32), 0.3,
                                device=CPU).clear_threshold(),
    ]


def test_bucketed_predictions_match_model_predict_exactly(rng):
    """Bitwise, every family, at 1, 3, 5, 8, 31, 200 and 700 rows (700:
    beyond the largest bucket, one natural-shape pass on both sides)."""
    engine = PredictEngine(device=CPU)
    d = 10
    for model in _families(rng, d):
        for n in (1, 3, 5, 8, 31, 200, 700):
            X = rng.normal(size=(n, d)).astype(np.float32)
            got = engine.predict_batch(model, X)
            np.testing.assert_array_equal(
                got, _host(model.predict(X)),
                err_msg=f"{type(model).__name__} at n={n}")


def test_sparse_bucketed_predictions_match(rng):
    engine = PredictEngine(device=CPU)
    d = 20
    dense = np.where(rng.random((13, d)) < 0.25,
                     rng.normal(size=(13, d)), 0.0).astype(np.float32)
    Xs = torch.from_numpy(dense).to_sparse_csr()
    for model in (
        _linear_model(rng, d),
        LogisticRegressionModel(rng.normal(size=d).astype(np.float32), 0.1,
                                device=CPU),
        MultinomialLogisticRegressionModel(
            rng.normal(size=2 * d).astype(np.float32), 0.0, num_classes=3,
            num_features=d, device=CPU),
    ):
        np.testing.assert_allclose(engine.predict_batch(model, Xs),
                                   _host(model.predict(Xs)),
                                   rtol=1e-6, atol=1e-6)


def test_single_sparse_vector_predict_batch(rng):
    d = 700  # wider than the largest bucket
    model = _linear_model(rng, d)
    row = _sparse_row(np.where(rng.random(d) < 0.05, rng.normal(size=d),
                               0.0))
    got = PredictEngine(device=CPU).predict_batch(model, row)
    assert got.shape == (1,)
    np.testing.assert_allclose(got[0], float(model.predict(row)),
                               rtol=1e-6, atol=1e-6)


def test_reentrant_reload_listener_does_not_deadlock(rng, tmp_path):
    d = 4
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path, iters=5)
    alg.train_on_batch(*_stream_batch(rng, w_true, n=64))
    registry = ModelRegistry(str(tmp_path), alg.algorithm.create_model,
                             device=CPU)

    class _Reentrant:
        def record_reload(self, event):
            registry.maybe_reload()  # would deadlock if emitted under lock
            registry.clear_bad_versions()

    registry.metrics = _Reentrant()
    assert registry.maybe_reload() is True
    assert registry.current_version == 1


def test_sparse_rows_coalesce(rng):
    d = 16
    model = _linear_model(rng, d)
    rows = [_sparse_row(np.where(rng.random(d) < 0.3, rng.normal(size=d),
                                 0.0)) for _ in range(5)]
    with Server(model, max_latency_s=0.02, device=CPU) as server:
        futs = [server.submit(r) for r in rows]
        got = [f.result(timeout=30) for f in futs]
    want = [float(model.predict(r)) for r in rows]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- metrics / event log ---------------------------------------------------
def test_serving_metrics_in_jsonl_event_log(rng, tmp_path):
    model = _linear_model(rng)
    path = str(tmp_path / "serve_events.jsonl")
    log = JsonLinesEventLog(path)
    server = Server(model, max_latency_s=0.01, max_queue=2, event_log=log,
                    device=CPU)
    X = rng.normal(size=(8, 12)).astype(np.float32)
    futs = [server.submit(X[i]) for i in range(2)]
    with pytest.raises(BackpressureError):  # queue bounded at 2
        server.submit(X[2])
    with server:
        [f.result(timeout=30) for f in futs]
    log.close()
    events = [json.loads(line) for line in open(path)]
    batches = [e for e in events if e["kind"] == "serve_batch"]
    assert batches
    for e in batches:
        for field in ("queue_depth", "batch_size", "padded_size",
                      "latency_s", "reject_count", "model_version"):
            assert field in e
    assert batches[-1]["reject_count"] == 1
    assert batches[0]["batch_size"] == 2
    assert batches[0]["padded_size"] == 8  # bucketed up
    snap = server.metrics.snapshot()
    assert snap["total_requests"] == 2
    assert snap["total_rejects"] == 1
    assert snap["p99_latency_s"] >= snap["p50_latency_s"] >= 0.0


def test_cancelled_future_does_not_kill_flush_thread(rng):
    batcher, _ = _engine_batcher(rng, max_batch=64, max_latency_s=0.01)
    X = rng.normal(size=(3, 12)).astype(np.float32)
    keep1 = batcher.submit(X[0])
    doomed = batcher.submit(X[1])
    assert doomed.cancel()
    with batcher:
        assert np.isfinite(keep1.result(timeout=30))
        keep2 = batcher.submit(X[2])
        assert np.isfinite(keep2.result(timeout=30))


def test_predict_margin_autograd_takes_the_plain_product(rng):
    """The JAX package's tracer cases (jit / vmap over the input, grad
    over the weights) as one autograd case: weights or an input that
    require grad take the plain product, which autograd differentiates;
    the values equal the bucketed margins'."""
    X = rng.normal(size=(4, 6)).astype(np.float32)
    w = torch.ones(6, dtype=torch.float32, requires_grad=True)
    model = LinearRegressionModel(w, 0.0)
    model.predict_margin(X).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), X.sum(axis=0), rtol=1e-5)
    frozen = LinearRegressionModel(np.ones(6, np.float32), 0.0, device=CPU)
    Xg = torch.from_numpy(X).requires_grad_(True)
    np.testing.assert_allclose(
        model.predict_margin(X).detach().numpy(),
        _host(frozen.predict_margin(X)), rtol=1e-6, atol=1e-7)
    frozen.predict_margin(Xg).sum().backward()
    np.testing.assert_array_equal(Xg.grad.numpy(), np.ones((4, 6)))
    multi = MultinomialLogisticRegressionModel(
        torch.from_numpy(rng.normal(size=3 * 6).astype(np.float32))
        .requires_grad_(True), 0.0, num_classes=4, num_features=6)
    np.testing.assert_array_equal(
        multi.predict(X).numpy(),
        MultinomialLogisticRegressionModel(
            multi.weights.detach().numpy(), 0.0, num_classes=4,
            num_features=6, device=CPU).predict(X).numpy())


def test_pin_survives_reload_attempts(rng, tmp_path):
    d = 4
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path, iters=5)
    for _ in range(2):
        alg.train_on_batch(*_stream_batch(rng, w_true, n=64))
    registry = ModelRegistry(str(tmp_path), alg.algorithm.create_model,
                             device=CPU)
    registry.pin(1)
    for _ in range(3):
        assert registry.maybe_reload() is False
        assert registry.pinned and registry.current_version == 1
    registry.unpin()
    assert registry.maybe_reload() is True
    assert registry.current_version == 2


def test_server_rejects_max_batch_beyond_buckets(rng):
    with pytest.raises(ValueError, match="max_batch"):
        Server(_linear_model(rng), max_batch=1024, device=CPU)


def test_raising_listener_does_not_kill_flush_thread(rng):
    class _Boom:
        def on_serve_batch(self, event):
            raise ValueError("listener exploded")

        def on_serve_reload(self, event):
            raise ValueError("listener exploded")

    model = _linear_model(rng)
    with Server(model, max_latency_s=0.005, event_log=_Boom(),
                device=CPU) as server:
        X = rng.normal(size=(3, 12)).astype(np.float32)
        assert np.isfinite(server.predict(X[0], timeout=30))
        assert np.isfinite(server.predict(X[1], timeout=30))


def test_event_log_close_is_safe_under_writes(rng, tmp_path):
    model = _linear_model(rng)
    log = JsonLinesEventLog(str(tmp_path / "ev.jsonl"))
    with Server(model, max_latency_s=0.005, event_log=log,
                device=CPU) as server:
        x = rng.normal(size=12).astype(np.float32)
        server.predict(x, timeout=30)
        log.close()  # out of order on purpose: writes become no-ops
        assert np.isfinite(server.predict(x, timeout=30))
    lines = [json.loads(line) for line in open(log.path)]
    assert all("kind" in e for e in lines)


def test_warm_engine_serves_every_size_without_compiling(rng):
    """Once every bucket has been scored, no request size inside the
    bucket range adds a padded-shape key (the JAX package's compile
    count)."""
    from tpu_sgd.analysis import assert_compile_count

    model = _linear_model(rng)
    engine = PredictEngine(device=CPU)
    for b in engine.buckets:
        engine.predict_batch(model, rng.normal(size=(b, 12))
                             .astype(np.float32))
    with assert_compile_count(0, of=lambda: engine.compile_count):
        for n in (1, 2, 3, 5, 9, 17, 33, 100, 200, 511):
            out = engine.predict_batch(
                model, rng.normal(size=(n, 12)).astype(np.float32))
            assert out.shape == (n,)


def test_custom_engine_buckets_are_honored(rng):
    engine = PredictEngine(buckets=(4, 16), device=CPU)
    assert engine.bucket_for(5) == 16
    assert engine.max_batch == 16
    model = _linear_model(rng)
    X = rng.normal(size=(6, 12)).astype(np.float32)
    np.testing.assert_allclose(engine.predict_batch(model, X),
                               _host(model.predict(X)), rtol=1e-6,
                               atol=1e-7)


def test_stack_rows_handles_all_zero_sparse_row(rng):
    dense = np.zeros((2, 6), np.float32)
    dense[0, [1, 4]] = (2.0, 3.0)
    X = stack_rows([_sparse_row(dense[0]), _sparse_row(dense[1])])
    assert X.shape == (2, 6)
    assert X.layout == torch.sparse_csr
    assert X.crow_indices().dtype == torch.int32
    np.testing.assert_allclose(X.to_dense().numpy(), dense)


def test_stack_rows_promotes_mixed_dtypes_and_rejects_bad_shapes(rng):
    out = stack_rows([np.array([1, 2, 3]),
                      np.array([0.5, 1.5, 2.5], np.float32)])
    np.testing.assert_allclose(out[1], [0.5, 1.5, 2.5])
    np.testing.assert_allclose(out[0], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="mixed or mis-shaped"):
        stack_rows([np.zeros(3, np.float32), np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match="mixed or mis-shaped"):
        stack_rows([_sparse_row(np.ones(3)), np.zeros(3, np.float32)])


def test_raising_reload_listener_does_not_break_reload(rng, tmp_path):
    d = 4
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path, iters=5)
    alg.train_on_batch(*_stream_batch(rng, w_true, n=64))

    class _BoomMetrics:
        def record_reload(self, event):
            raise ValueError("reload listener exploded")

    registry = ModelRegistry(str(tmp_path), alg.algorithm.create_model,
                             metrics=_BoomMetrics(), device=CPU)
    assert registry.maybe_reload() is True
    assert registry.current_version == 1


def test_stop_with_drain_before_start_answers_queue(rng):
    batcher, model = _engine_batcher(rng, max_batch=4, max_latency_s=1.0)
    X = rng.normal(size=(6, 12)).astype(np.float32)
    futs = [batcher.submit(X[i]) for i in range(6)]  # > max_batch: 2 flushes
    batcher.stop(drain=True)
    got = np.asarray([f.result(timeout=30) for f in futs])
    np.testing.assert_array_equal(got, _host(model.predict(X)))


def test_batch_failure_fails_futures_not_server(rng):
    def exploding(X):
        raise RuntimeError("bad batch")

    with MicroBatcher(exploding, max_latency_s=0.005) as batcher:
        fut = batcher.submit(np.zeros(4, np.float32))
        with pytest.raises(RuntimeError, match="bad batch"):
            fut.result(timeout=30)
        fut2 = batcher.submit(np.zeros(4, np.float32))
        with pytest.raises(RuntimeError, match="bad batch"):
            fut2.result(timeout=30)


# -- admission control: lanes, deadlines, shedding ------------------------
def test_queue_full_rejection_is_typed_overloaded(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                 max_queue=4)
    x = rng.normal(size=12).astype(np.float32)
    futs = [batcher.submit(x) for _ in range(4)]
    with pytest.raises(Overloaded) as ei:
        batcher.submit(x)
    assert isinstance(ei.value, BackpressureError)
    assert ei.value.reason == "queue_full"
    assert ei.value.lane == "interactive"
    assert batcher.reject_count == 1
    with batcher:
        pass
    assert all(np.isfinite(f.result(timeout=30)) for f in futs)


def test_unknown_lane_rejected_eagerly(rng):
    batcher, _ = _engine_batcher(rng)
    with pytest.raises(ValueError, match="unknown lane"):
        batcher.submit(np.zeros(12, np.float32), lane="premium")


def test_priority_inversion_impossible_by_construction(rng):
    model = _linear_model(rng)
    engine = PredictEngine(device=CPU)
    first_batch_rows = []

    def recording(X):
        if not first_batch_rows:
            first_batch_rows.append(np.asarray(X))
        return engine.predict_batch(model, X)

    batcher = MicroBatcher(recording, max_batch=4, max_latency_s=0.01)
    slow = rng.normal(size=(4, 12)).astype(np.float32)
    urgent = np.full(12, 9.0, np.float32)
    for i in range(4):
        batcher.submit(slow[i], lane="batch")
    fut = batcher.submit(urgent, lane="interactive")
    with batcher:
        got = fut.result(timeout=30)
    assert np.isfinite(got)
    np.testing.assert_array_equal(first_batch_rows[0][0], urgent)
    assert first_batch_rows[0].shape[0] == 4


def test_utilization_shedding_sheds_low_lanes_first(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                 max_queue=8)
    x = rng.normal(size=12).astype(np.float32)
    futs = [batcher.submit(x) for _ in range(4)]  # depth 4 = 50%
    with pytest.raises(Overloaded) as ei:
        batcher.submit(x, lane="shadow")
    assert ei.value.reason == "shed" and ei.value.lane == "shadow"
    futs.append(batcher.submit(x, lane="batch"))
    futs.append(batcher.submit(x, lane="batch"))  # depth 6 = 75%...
    with pytest.raises(Overloaded) as ei:
        batcher.submit(x, lane="batch")
    assert ei.value.reason == "shed" and ei.value.lane == "batch"
    futs.append(batcher.submit(x))  # interactive still admits
    counts = batcher.lane_snapshot()
    assert counts["shadow"]["shed"] == 1
    assert counts["batch"]["shed"] == 1
    assert counts["interactive"]["admitted"] == 5
    with batcher:
        pass
    assert all(np.isfinite(f.result(timeout=30)) for f in futs)


def test_shedding_disabled_restores_pure_backpressure(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                 max_queue=4, shed_utilization={})
    x = rng.normal(size=12).astype(np.float32)
    futs = [batcher.submit(x, lane="shadow") for _ in range(4)]
    with pytest.raises(Overloaded) as ei:
        batcher.submit(x, lane="shadow")
    assert ei.value.reason == "queue_full"
    with batcher:
        pass
    assert all(np.isfinite(f.result(timeout=30)) for f in futs)


def _seed_p99(batcher, wall_s):
    with batcher._cond:
        batcher._flush_walls.extend([wall_s] * 8)
        batcher._p99_wall = nearest_rank(sorted(batcher._flush_walls), 99)


def test_deadline_early_rejection_prices_against_p99_wall(rng):
    batcher, _ = _engine_batcher(rng, max_batch=4, max_latency_s=1.0,
                                 max_queue=64)
    x = rng.normal(size=12).astype(np.float32)
    fut = batcher.submit(x, deadline_s=1e-6)  # cold window: admitted
    _seed_p99(batcher, 0.05)
    with pytest.raises(Overloaded) as ei:
        batcher.submit(x, deadline_s=0.01)  # 10ms budget < 50ms wall
    assert ei.value.reason == "deadline"
    fut2 = batcher.submit(x, deadline_s=10.0)
    assert batcher.lane_snapshot()["interactive"]["rejected"] == 1
    with batcher:
        pass
    assert np.isfinite(fut.result(timeout=30))
    assert np.isfinite(fut2.result(timeout=30))


def test_admitted_request_with_expired_deadline_is_answered(rng):
    """Reject at admission, never at completion: a request admitted with
    a positive budget whose deadline has passed while queued (its
    enqueue stamp moved back, no sleep) is still answered."""
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=0.01,
                                 max_queue=8)
    x = rng.normal(size=12).astype(np.float32)
    fut = batcher.submit(x, deadline_s=0.05)
    _expire(batcher)
    with batcher:
        got = fut.result(timeout=30)
    assert np.isfinite(got)


def test_displacement_evicts_newest_lowest_lane_with_typed_answer(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                 max_queue=3, shed_utilization={})
    x = rng.normal(size=12).astype(np.float32)
    shadow = [batcher.submit(x, lane="shadow") for _ in range(3)]
    urgent = batcher.submit(x, lane="interactive")
    with pytest.raises(Overloaded) as ei:
        shadow[2].result(timeout=30)
    assert ei.value.reason == "displaced" and ei.value.lane == "shadow"
    counts = batcher.lane_snapshot()
    assert counts["shadow"]["displaced"] == 1
    assert counts["shadow"]["shed"] == 0
    assert counts["shadow"]["admitted"] == 3
    assert counts["interactive"]["admitted"] == 1
    with batcher:
        pass
    assert np.isfinite(urgent.result(timeout=30))
    assert all(np.isfinite(f.result(timeout=30)) for f in shadow[:2])
    batcher2, _ = _engine_batcher(rng, max_batch=512, max_latency_s=1.0,
                                  max_queue=2, shed_utilization={})
    keep = [batcher2.submit(x, lane="shadow") for _ in range(2)]
    with pytest.raises(Overloaded) as ei:
        batcher2.submit(x, lane="shadow")
    assert ei.value.reason == "queue_full"
    with batcher2:
        pass
    assert all(np.isfinite(f.result(timeout=30)) for f in keep)


def test_cancelled_futures_during_shed_wave_dont_kill_flush(rng):
    batcher, _ = _engine_batcher(rng, max_batch=512, max_latency_s=0.01,
                                 max_queue=3, shed_utilization={})
    x = rng.normal(size=12).astype(np.float32)
    shadow = [batcher.submit(x, lane="shadow") for _ in range(3)]
    assert shadow[2].cancel()
    urgent = batcher.submit(x, lane="interactive")
    assert shadow[2].cancelled()
    assert shadow[1].cancel()
    with batcher:
        assert np.isfinite(urgent.result(timeout=30))
        assert np.isfinite(shadow[0].result(timeout=30))
        assert np.isfinite(batcher.predict(x, timeout=30))


def test_overload_burst_conserves_every_request(rng):
    batcher, _ = _engine_batcher(rng, max_batch=8, max_latency_s=0.001,
                                 max_queue=16)
    lanes = ("interactive", "interactive", "batch", "shadow")
    X = rng.normal(size=(300, 12)).astype(np.float32)
    with batcher:
        futs, typed = [], 0
        for i in range(300):
            try:
                futs.append(batcher.submit(X[i], lane=lanes[i % 4]))
            except Overloaded:
                typed += 1
        answered = 0
        for f in futs:
            try:
                assert np.isfinite(f.result(timeout=60))
                answered += 1
            except Overloaded as e:
                assert e.reason == "displaced"
                typed += 1
    assert answered + typed == 300
    assert answered > 0
    counts = batcher.lane_snapshot()
    assert sum(c["admitted"] for c in counts.values()) == len(futs)


def test_healthz_exposes_lane_counters_and_breaker(rng, tmp_path):
    from tpu_sgd_torch.reliability import CircuitBreaker

    d = 4
    w_true = rng.normal(size=d).astype(np.float32)
    alg = _streaming(rng, d, tmp_path, iters=5)
    alg.train_on_batch(*_stream_batch(rng, w_true, n=64))
    registry = ModelRegistry(
        str(tmp_path), alg.algorithm.create_model,
        breaker=CircuitBreaker(failure_threshold=3, reset_timeout_s=0.1),
        device=CPU)
    with Server(registry=registry, max_latency_s=0.005, max_queue=4,
                device=CPU) as server:
        x = rng.normal(size=d).astype(np.float32)
        assert np.isfinite(server.predict(x, timeout=30))
        with pytest.raises(Overloaded):
            for _ in range(64):
                server.submit(x, lane="shadow")
        h = server.healthz()
    assert h["breaker"]["state"] == "closed"
    assert h["registry"]["load_failed_count"] == 0
    assert set(h["lanes"]) == {"interactive", "batch", "shadow"}
    assert h["admit_count"] >= 1
    assert h["shed_count"] + h["reject_count"] >= 1
    assert h["lanes"]["interactive"]["admitted"] >= 1
    snap = server.metrics.snapshot()
    assert sum(snap["rejects_by_lane"].values()) == snap["total_rejects"]
    assert snap["rejects_by_reason"]


def test_serve_batch_event_carries_lane_composition(rng, tmp_path):
    model = _linear_model(rng)
    path = str(tmp_path / "lane_events.jsonl")
    log = JsonLinesEventLog(path)
    server = Server(model, max_latency_s=0.05, event_log=log, device=CPU)
    X = rng.normal(size=(3, 12)).astype(np.float32)
    futs = [server.submit(X[0], lane="interactive"),
            server.submit(X[1], lane="interactive"),
            server.submit(X[2], lane="batch")]
    with server:
        [f.result(timeout=30) for f in futs]
    log.close()
    batches = [e for e in JsonLinesEventLog.read(path)
               if e["kind"] == "serve_batch" and e.get("lanes")]
    assert batches
    lanes = batches[0]["lanes"]
    assert lanes["interactive"]["n"] == 2
    assert lanes["batch"]["n"] == 1
    for st in lanes.values():
        assert st["max_latency_s"] >= 0.0


def test_streaming_on_model_update_hook(rng):
    d = 5
    w_true = rng.normal(size=d).astype(np.float32)
    alg = StreamingLinearRegressionWithSGD(step_size=0.3, num_iterations=5,
                                           device=CPU)
    alg.set_initial_weights(np.zeros(d, np.float32))
    seen = []
    alg.add_model_update_listener(
        lambda model, batch_index: seen.append(
            (batch_index, float(model.weights[0]))))
    alg.train_on_batch(*_stream_batch(rng, w_true, n=64))
    alg.train_on_batch(*_stream_batch(rng, w_true, n=64))
    assert [s[0] for s in seen] == [1, 2]
    alg.train_on_batch(np.zeros((0, d), np.float32), np.zeros(0, np.float32))
    assert len(seen) == 2
    with pytest.raises(TypeError):
        alg.add_model_update_listener("not-callable")


def test_checkpoint_versions_and_restore_version(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for it in (3, 7, 12):
        mgr.save(it, np.full(4, float(it), np.float32), 0.0, [1.0])
    assert mgr.versions() == [3, 7, 12]
    assert mgr.latest_version() == 12
    ck = mgr.restore_version(7)
    np.testing.assert_array_equal(ck["weights"], np.full(4, 7.0, np.float32))
    with pytest.raises(FileNotFoundError, match="retained"):
        mgr.restore_version(5)
    (tmp_path / "ckpt_00000012.npz").write_bytes(b"torn")
    with pytest.raises(Exception):
        mgr.restore_version(12)
    ck = mgr.restore()
    assert ck["iteration"] == 7


# -- the serving feeds of the port's obs and reliability planes ------------
def test_server_healthz_carries_windows_snapshot(rng):
    from tpu_sgd_torch.obs import counters, spans, timeseries

    class _Sink:
        def emit(self, kind, payload):
            pass

    model = _linear_model(rng, 6)
    X = rng.normal(size=(8, 6)).astype(np.float32)
    with Server(model, max_latency_s=0.002, device=CPU) as srv:
        srv.predict(X[0], timeout=30)
        assert srv.healthz()["windows"] is None  # layer off: honest None
    spans.enable_tracing(_Sink())
    counters.enable()
    timeseries.enable(width_s=60.0)
    try:
        with Server(model, max_latency_s=0.002, device=CPU) as srv:
            for i in range(8):
                srv.predict(X[i], timeout=30)
            wins = srv.healthz()["windows"]
    finally:
        timeseries.disable()
        counters.disable()
        spans.disable_tracing()
    names = {n for w in wins for n in w["series"]}
    assert {"serve.batch", "serve.predict",
            "serve.admitted.interactive"} <= names, names


def test_batcher_enqueue_failpoint_sheds_single_request(rng):
    from tpu_sgd_torch.reliability import (FaultInjected, fail_nth,
                                           inject_faults)

    model = LinearRegressionModel(rng.normal(size=6).astype(np.float32),
                                  0.0, device=CPU)
    X = rng.normal(size=(4, 6)).astype(np.float32)
    with Server(model, max_latency_s=0.002, device=CPU) as server:
        with inject_faults({"serve.batcher.enqueue": fail_nth(2)}):
            a = server.submit(X[0])
            with pytest.raises(FaultInjected):
                server.submit(X[1])
            b = server.submit(X[2])
            got = [a.result(timeout=30), b.result(timeout=30)]
    np.testing.assert_array_equal(np.asarray(got),
                                  _host(model.predict(X[[0, 2]])))


# -- the repair: sparse predict through the CSR kernel's wrapper ----------
def test_sparse_predict_goes_through_csr_margins(rng, monkeypatch):
    """Sparse ``predict``, ``predict_margin``, ``predict_streamed`` and
    the engine's sparse batches call ``cuda_kernels.csr_margins`` (the
    CSR kernel on the card, never torch's sparse ``@``); the multinomial
    ``X @ Wᵀ`` passes its ``(d, K-1)`` right-hand side to the same
    wrapper."""
    calls = []
    real = cuda_kernels.csr_margins

    def spy(X, rhs, mask=None):
        calls.append(tuple(rhs.shape))
        return real(X, rhs, mask)

    monkeypatch.setattr(cuda_kernels, "csr_margins", spy)
    d = 20
    dense = np.where(rng.random((9, d)) < 0.3, rng.normal(size=(9, d)),
                     0.0).astype(np.float32)
    Xs = torch.from_numpy(dense).to_sparse_csr()
    model = LogisticRegressionModel(rng.normal(size=d).astype(np.float32),
                                    0.1, device=CPU)
    model.predict(Xs)
    model.predict_margin(Xs)
    model.predict_streamed(Xs, batch_rows=4)
    PredictEngine(device=CPU).predict_batch(model, Xs)
    multi = MultinomialLogisticRegressionModel(
        rng.normal(size=2 * (d + 1)).astype(np.float32), 0.0, num_classes=3,
        num_features=d + 1, has_intercept_column=True, device=CPU)
    multi.predict(Xs)
    assert calls == [(d,)] * 6 + [(d + 1, 2)]
    # int one-hot values promote instead of truncating the weights
    Xi = torch.from_numpy((dense != 0).astype(np.int64)).to_sparse_csr()
    np.testing.assert_allclose(
        _host(model.predict_margin(Xi)),
        (dense != 0).astype(np.float32) @ model.weights.numpy() + 0.1,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [5, 700])
def test_dense_predict_on_the_device_never_leaves_it(rng, monkeypatch, n):
    """A dense batch already on the weights' device, in a bucket (5 rows)
    or beyond the largest one (700), is scored and decided there:
    ``predict`` and ``predict_margin`` never copy to the host (every way
    out of a tensor raises) and return a tensor on that device, equal to
    the plain product and the device pivot rule."""
    from tpu_sgd_torch.ops.gradients import f32_product, pivot_class_traced

    d = 16
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    multi = MultinomialLogisticRegressionModel(
        rng.normal(size=3 * (d + 1)).astype(np.float32), 0.0, num_classes=4,
        num_features=d + 1, has_intercept_column=True, device=CPU)
    logistic = LogisticRegressionModel(rng.normal(size=d).astype(np.float32),
                                       0.2, device=CPU)
    W = multi.weights.reshape(3, d + 1)
    want_classes = pivot_class_traced(f32_product(
        torch.cat([X, torch.ones(n, 1)], 1), W.T))
    want_margins = f32_product(X, logistic.weights) + 0.2

    def leaves(*_a, **_k):
        raise AssertionError("a prediction left the device")

    for name in ("cpu", "numpy", "tolist", "item", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, leaves)
    classes = multi.predict(X)
    margins = logistic.predict_margin(X)
    probs = logistic.predict(X)
    monkeypatch.undo()
    for out in (classes, margins, probs):
        assert isinstance(out, torch.Tensor) and out.shape == (n,)
        assert out.device == X.device
    assert torch.equal(classes, want_classes)
    torch.testing.assert_close(margins, want_margins, rtol=1e-6, atol=1e-6)
    assert torch.equal(probs, (torch.sigmoid(margins) > 0.5).float())


# -- parity with the JAX package ------------------------------------------
def test_bucket_for_equals_the_jax_package(rng):
    from tpu_sgd.ops.bucketed import bucket_for as jbucket

    assert bucketed.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS
    for buckets in (bucketed.DEFAULT_BUCKETS, (4, 16), (3, 5, 100)):
        for n in range(0, 700):
            assert bucketed.bucket_for(n, buckets) == jbucket(n, buckets)


def test_stack_rows_layout_equals_the_jax_package(rng):
    from jax.experimental.sparse import BCOO

    dense = [np.array([1, 2, 3]), np.array([0.5, 1.5, 2.5], np.float32),
             np.array([4, 5, 6], np.int32)]
    got, want = stack_rows(dense), jserve.stack_rows(dense)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    f64 = [np.array([0.1, 0.2]), np.array([1.0, 2.0], np.float32)]
    assert stack_rows(f64).dtype == jserve.stack_rows(f64).dtype
    rows = np.where(rng.random((4, 9)) < 0.4, rng.normal(size=(4, 9)),
                    0.0).astype(np.float32)
    rows[2] = 0.0  # an all-zero request
    X = stack_rows([_sparse_row(r) for r in rows])
    J = jserve.stack_rows([BCOO.fromdense(r) for r in rows])
    ji = np.asarray(J.indices)
    np.testing.assert_array_equal(X.col_indices().numpy(), ji[:, 1])
    np.testing.assert_array_equal(
        X.crow_indices().numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(ji[:, 0],
                                                   minlength=4))]))
    np.testing.assert_array_equal(X.values().numpy(), np.asarray(J.data))


_SCRIPT = [
    # (lane, deadline_s) submits against a batcher whose flush thread has
    # not started: shed, deadline, queue_full and displacement all fire
    ("interactive", None), ("batch", None), ("shadow", None),
    ("shadow", None), ("interactive", 0.01), ("batch", 10.0),
    ("shadow", None), ("batch", None), ("interactive", None),
    ("interactive", 0.2), ("interactive", None), ("batch", 0.01),
    ("interactive", None), ("interactive", None), ("shadow", None),
    ("interactive", None), ("interactive", 1.0),
]


def _run_script(mod, engine_fn, shed, seed_wall):
    b = mod.MicroBatcher(engine_fn, max_batch=2, max_latency_s=1.0,
                         max_queue=6, shed_utilization=shed)
    out = []
    x = np.zeros(3, np.float32)
    futs = []
    for i, (lane, deadline) in enumerate(_SCRIPT):
        if i == 4:  # seed the p99 wall as test_serve.py does
            with b._cond:
                b._flush_walls.extend([seed_wall] * 8)
                b._p99_wall = mod.metrics.nearest_rank(
                    sorted(b._flush_walls), 99)
        if i == 8:  # a burst mid-script, into a part-full queue
            burst = b.submit_burst([x] * 4, lane="interactive",
                                   deadline_s=0.12)
            out.append([f.exception().reason if f.done() else "admitted"
                        for f in burst])
        try:
            futs.append(b.submit(x, lane=lane, deadline_s=deadline))
            out.append("admitted")
        except mod.Overloaded as e:
            out.append(e.reason)
    burst = b.submit_burst([x] * 5, lane="interactive", deadline_s=0.3)
    out.append([f.exception().reason if f.done() else "admitted"
                for f in burst])
    displaced = [f.exception().reason for f in futs
                 if f.done() and f.exception() is not None]
    return (out, displaced, b.lane_snapshot(), b.admission_snapshot(),
            b.reject_count)


@pytest.mark.parametrize("shed", [None, {}, {"batch": 0.5}])
def test_batcher_decisions_equal_the_jax_package(shed):
    """The same script of submits and one burst, with the p99 wall
    seeded directly: every admit / reject / shed / displace decision,
    the lane counts, the admission lock rounds and the reject count are
    the JAX package's."""
    import tpu_sgd_torch.serve as tserve

    def zeros(X):
        return np.zeros(len(X), np.float32)

    got = _run_script(tserve, zeros, shed, 0.05)
    want = _run_script(jserve, zeros, shed, 0.05)
    assert got == want
    assert "displaced" in got[1]


def test_dense_scores_match_the_jax_package(rng):
    d = 9
    for make_t, make_j, extra in (
            (LinearRegressionModel, JLinear, {}),
            (LogisticRegressionModel, JLogistic, {"clear": True}),
            (SVMModel, JSVM, {"clear": True})):
        w = rng.normal(size=d).astype(np.float32)
        b = float(rng.normal())
        tm = glm_model_from_numpy(make_t, w, b, device=CPU)
        jm = make_j(w, b)
        if extra.get("clear"):
            tm.clear_threshold()
            jm.clear_threshold()
        te, je = PredictEngine(device=CPU), jserve.PredictEngine()
        for n in (1, 5, 31, 700):
            X = rng.normal(size=(n, d)).astype(np.float32)
            got, want = te.predict_batch(tm, X), je.predict_batch(jm, X)
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
            np.testing.assert_allclose(_host(tm.predict(X)),
                                       np.asarray(jm.predict(X)), rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def _off_boundary_rows(rng, n, d, margin_fn):
    """Rows whose decision margin is at least 1e-3 from the boundary."""
    X = rng.normal(size=(4 * n, d)).astype(np.float32)
    keep = np.abs(margin_fn(X)) > 1e-3
    return X[keep][:n]


def test_thresholded_and_multinomial_classes_equal_the_jax_package(rng):
    d = 7
    w = rng.normal(size=d).astype(np.float32)
    for make_t, make_j, b in ((LogisticRegressionModel, JLogistic, 0.2),
                              (SVMModel, JSVM, -0.3)):
        tm = glm_model_from_numpy(make_t, w, b, device=CPU)
        jm = make_j(w, b)
        X = _off_boundary_rows(rng, 200, d, lambda X: X @ w + b)
        np.testing.assert_array_equal(
            PredictEngine(device=CPU).predict_batch(tm, X),
            jserve.PredictEngine().predict_batch(jm, X))
    W = rng.normal(size=3 * (d + 1)).astype(np.float32)
    tm = multinomial_model_from_numpy(W, 4, True, d + 1, device=CPU)
    jm = JMulti(W, 0.0, num_classes=4, num_features=d + 1,
                has_intercept_column=True)

    def gap(X):
        logits = np.concatenate(
            [np.zeros((len(X), 1), np.float32),
             np.hstack([X, np.ones((len(X), 1), np.float32)])
             @ W.reshape(3, d + 1).T], axis=1)
        top = np.sort(logits, axis=1)
        return top[:, -1] - top[:, -2]

    X = _off_boundary_rows(rng, 300, d, gap)
    for n in (1, 8, 300):
        np.testing.assert_array_equal(
            PredictEngine(device=CPU).predict_batch(tm, X[:n]),
            jserve.PredictEngine().predict_batch(jm, X[:n]))
        np.testing.assert_array_equal(_host(tm.predict(X[:n])),
                                      np.asarray(jm.predict(X[:n])))


def test_sparse_scores_match_the_jax_package(rng):
    from jax.experimental.sparse import BCOO

    d = 30
    w = rng.normal(size=d).astype(np.float32)
    tm = glm_model_from_numpy(LinearRegressionModel, w, 0.4, device=CPU)
    jm = JLinear(w, 0.4)
    rows = np.where(rng.random((11, d)) < 0.2, rng.normal(size=(11, d)),
                    0.0).astype(np.float32)
    got = PredictEngine(device=CPU).predict_batch(
        tm, stack_rows([_sparse_row(r) for r in rows]))
    want = jserve.PredictEngine().predict_batch(
        jm, jserve.stack_rows([BCOO.fromdense(r) for r in rows]))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_registry_serves_the_jax_packages_checkpoints(rng, tmp_path):
    """Cross-package: the JAX package's ``CheckpointManager`` writes the
    versions; the port's registry walks the same version / pin /
    rollback sequence as the JAX registry, rolls back past a corrupt
    newest version, and serves the same scores."""
    d = 6
    mgr = JCheckpointManager(str(tmp_path), keep=8)
    ws = rng.normal(size=(3, d)).astype(np.float32)
    for v in (1, 2, 3):
        mgr.save(v, ws[v - 1], 0.0, [],
                 extras={"intercept": np.float32(0.5 * v)})
    (tmp_path / "ckpt_00000004.npz").write_bytes(b"\x00not an npz")
    treg = ModelRegistry(str(tmp_path),
                         lambda w, b: LinearRegressionModel(w, b),
                         device=CPU)
    jreg = jserve.ModelRegistry(str(tmp_path), JLinear)
    X = rng.normal(size=(5, d)).astype(np.float32)

    def step(reg, action):
        if action == "reload":
            reg.maybe_reload()
        elif action == "pin2":
            reg.pin(2)
        elif action == "unpin":
            reg.unpin()
        return (reg.current_version, reg.previous_version, reg.pinned,
                sorted(reg.bad_versions))

    for action in ("reload", "reload", "pin2", "reload", "unpin", "reload"):
        assert step(treg, action) == step(jreg, action), action
        np.testing.assert_allclose(
            PredictEngine(device=CPU).predict_batch(treg.model(), X),
            jserve.PredictEngine().predict_batch(jreg.model(), X),
            rtol=1e-5, atol=1e-5)
    assert treg.current_version == 3 and 4 in treg.bad_versions
