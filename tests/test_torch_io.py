"""The port's ingest layer (``tpu_sgd_torch/io``), on the CPU: the twins of
``tests/test_io.py``.

Pinned against the JAX package (exact): the chunk plans and their
zero-row tails, ``stack_superchunk``'s padding, ``pad_rows``, the wire
dtype rules and the bf16 cast's values.  Pinned within the port: the
prefetcher's order, exceptions, cancellation, bounded lookahead and
retry scope, and the pinned ring's slot protocol as the CPU runs it
(pageable buffers, no events; the card's pinned slots and side stream
are held by ``chip_smoke.py`` phase ``streamed``).
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_sgd import io as jio
from tpu_sgd_torch import io as tio
from tpu_sgd_torch.io.prefetch import PinnedRing
from tpu_sgd_torch.reliability import (FaultInjected, RetryPolicy, fail_nth,
                                       inject_faults)
from tpu_sgd_torch.reliability import failpoints as fp


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


# ---- chunk planner (exact against the JAX package) -------------------------

@pytest.mark.parametrize("n,rows,offset,round_to", [
    (1000, 256, 0, 32), (1000, 256, 0, 1), (100, 500, 0, 1),
    (100, 500, 0, 32), (960, 256, 0, 32), (100_000, 4096, 8192, 64),
    (0, 16, 0, 1), (7, 3, 3, 3), (65536, 65536, 0, 8192)])
def test_plan_chunks_equals_the_jax_plan(n, rows, offset, round_to):
    a = tio.plan_chunks(n, rows, offset=offset, round_to=round_to)
    b = jio.plan_chunks(n, rows, offset=offset, round_to=round_to)
    assert (a.chunk_rows, a.n_chunks, a.pad_rows) == (
        b.chunk_rows, b.n_chunks, b.pad_rows)
    assert [(c.index, c.start, c.stop, c.rows, c.valid, c.pad)
            for c in a] == [(c.index, c.start, c.stop, c.rows, c.valid,
                             c.pad) for c in b]


def test_plan_chunks_validates_like_the_jax_plan():
    for kw in ({"offset": -1}, {"offset": 2000}, {"offset": 5,
                                                  "round_to": 4}):
        with pytest.raises(ValueError):
            tio.plan_chunks(1000, 64, **kw)
        with pytest.raises(ValueError):
            jio.plan_chunks(1000, 64, **kw)


@pytest.mark.parametrize("steps,k", [(3, 3), (2, 4), (1, 5)])
def test_stack_superchunk_zero_row_tails_equal_the_jax_stack(rng, steps, k):
    xs = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(steps)]
    ys = [rng.normal(size=(6,)).astype(np.float32) for _ in range(steps)]
    vs = [rng.random(6) < 0.7 for _ in range(steps)]
    a = tio.stack_superchunk(xs, ys, vs, k=k)
    b = jio.stack_superchunk(xs, ys, vs, k=k)
    for got, ref in zip(a, b):
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.shape == ref.shape


def test_stack_superchunk_in_place_skips_its_own_rows(rng):
    out = (torch.full((4, 5, 2), 7.0), torch.full((4, 5), 7.0),
           torch.ones((4, 5), dtype=torch.bool))
    out[0][0].copy_(torch.arange(10.0).reshape(5, 2))
    xs = [out[0][0], torch.ones((5, 2))]
    ys = [torch.zeros(5), torch.ones(5)]
    vs = [torch.ones(5, dtype=torch.bool), torch.zeros(5, dtype=torch.bool)]
    Xs, Ys, Vs = tio.stack_superchunk(xs, ys, vs, k=4, out=out)
    assert Xs is out[0]
    np.testing.assert_array_equal(Xs[0].numpy(),
                                  np.arange(10.0).reshape(5, 2))
    assert torch.all(Xs[1] == 1) and torch.all(Xs[2:] == 0)
    assert torch.all(~Vs[1:]) and torch.all(Vs[0])
    with pytest.raises(ValueError):
        tio.stack_superchunk(xs, ys, vs, k=1)
    with pytest.raises(ValueError):
        tio.stack_superchunk([], [], [])


def test_stack_superchunk_passes_its_failpoint():
    with inject_faults({"io.superstep": fail_nth(1)}):
        with pytest.raises(FaultInjected):
            tio.stack_superchunk([np.zeros((2, 2), np.float32)],
                                 [np.zeros(2, np.float32)],
                                 [np.ones(2, bool)], k=2)


def test_pad_rows_zero_copy_and_cast():
    a = torch.ones((8, 3))
    assert tio.pad_rows(a, 8) is a
    p = tio.pad_rows(a, 10)
    ref = jio.pad_rows(a.numpy(), 10)
    np.testing.assert_array_equal(p.numpy(), ref)
    q = tio.pad_rows(a, 10, dtype="bfloat16")
    qj = jio.pad_rows(a.numpy(), 10, dtype=ml_dtypes.bfloat16)
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(q), np.asarray(qj, np.float32))
    with pytest.raises(ValueError, match="do not fit"):
        tio.pad_rows(a, 4)


# ---- wire format -----------------------------------------------------------

def test_resolve_wire_dtype():
    assert tio.resolve_wire_dtype(None, torch.float32) is None
    assert tio.resolve_wire_dtype("bfloat16", torch.bfloat16) is None
    assert tio.resolve_wire_dtype("bfloat16", np.float32) == torch.bfloat16
    assert tio.resolve_wire_dtype("float32", "float32") is None
    with pytest.raises(ValueError, match="floating"):
        tio.resolve_wire_dtype("int32", np.float32)
    with pytest.raises(ValueError, match="floating"):
        jio.resolve_wire_dtype("int32", np.float32)


def test_wire_cast_bf16_values_equal_the_jax_cast(rng):
    a = rng.normal(size=(256, 8)).astype(np.float32)
    assert tio.wire_cast(a, None).data_ptr() == \
        torch.from_numpy(a).data_ptr()  # zero-copy identity
    got = _np(tio.wire_cast(a, torch.bfloat16))
    ref = np.asarray(jio.wire_cast(a, jio.resolve_wire_dtype(
        "bfloat16", a.dtype)), np.float32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, a, rtol=8e-3, atol=1e-6)


# ---- prefetcher ------------------------------------------------------------

def test_prefetcher_preserves_order():
    def produce(i):
        time.sleep(0.002 * (5 - i % 5))
        return i * i

    assert list(tio.Prefetcher(produce, range(12), depth=3)) == [
        i * i for i in range(12)]
    assert tio.DEFAULT_PREFETCH_DEPTH == jio.DEFAULT_PREFETCH_DEPTH == 2


def test_prefetcher_runs_producer_off_thread():
    main = threading.get_ident()
    seen = []

    def produce(i):
        seen.append(threading.get_ident())
        return i

    list(tio.Prefetcher(produce, range(4), depth=2))
    assert all(t != main for t in seen)
    seen.clear()
    list(tio.Prefetcher(produce, range(4), depth=0))
    assert all(t == main for t in seen)


def test_prefetcher_worker_runs_on_the_consumers_card(monkeypatch):
    """The worker thread starts on the card current on the consumer's
    thread (a new thread's own is the first): a producer's tensor on
    "cuda" lands on the consumer's card.  Without an initialized CUDA (the
    CPU) the worker sets nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda card: calls.append(
                            (card, threading.current_thread().name)))
    assert list(tio.Prefetcher(lambda i: i, range(4), depth=2)) == [0, 1,
                                                                      2, 3]
    assert len(calls) == 1 and calls[0][0] == 3
    assert calls[0][1].startswith("tpu-sgd-torch-ingest")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    calls.clear()
    assert list(tio.Prefetcher(lambda i: i, range(4), depth=2)) == [0, 1,
                                                                      2, 3]
    assert calls == []


def test_prefetcher_exception_propagates_in_order():
    def produce(i):
        if i == 3:
            raise RuntimeError("wedged at 3")
        return i

    pf = tio.Prefetcher(produce, range(6), depth=2)
    got = []
    with pytest.raises(RuntimeError, match="wedged at 3"):
        for v in pf:
            got.append(v)
    assert got == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_close_cancels_lookahead():
    produced = []

    def produce(i):
        produced.append(i)
        time.sleep(0.01)
        return i

    pf = tio.Prefetcher(produce, range(100), depth=2)
    assert next(pf) == 0
    pf.close()
    time.sleep(0.05)
    assert len(produced) <= 4
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_bounded_lookahead():
    in_flight = []

    def produce(i):
        in_flight.append(i)
        return i

    pf = tio.Prefetcher(produce, range(50), depth=2)
    time.sleep(0.05)
    assert len(in_flight) <= 1
    assert next(pf) == 0
    time.sleep(0.05)
    assert len(in_flight) <= 2
    pf.close()
    with pytest.raises(ValueError, match="depth"):
        tio.Prefetcher(produce, range(3), depth=-1)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_retry_heals_a_one_shot_fault(depth):
    """The ``io.prefetch.produce`` failpoint sits inside the retry scope:
    a one-shot fault heals in place, and the items are unchanged."""
    pol = RetryPolicy(max_attempts=3, base_backoff_s=0.0)
    with inject_faults({"io.prefetch.produce": fail_nth(3)}):
        got = list(tio.Prefetcher(lambda i: 2 * i, range(6), depth=depth,
                                  retry_policy=pol))
        assert fp.triggers("io.prefetch.produce") == 1
    assert got == [0, 2, 4, 6, 8, 10]
    with inject_faults({"io.prefetch.produce": fail_nth(2)}):
        with pytest.raises(FaultInjected):
            list(tio.Prefetcher(lambda i: i, range(4), depth=depth))


# ---- the staging ring, as the CPU runs it -----------------------------------

def test_cpu_ring_slots_are_pageable_and_shared_with_the_step():
    ring = PinnedRing({"x": ((4, 3), torch.float32),
                       "v": ((4,), torch.bool)}, 2, torch.device("cpu"),
                      device_specs={"t": ((3,), torch.int32)})
    assert ring.slots == 2 and ring.pinned_bytes == 0
    assert not ring.host[0]["x"].is_pinned()
    host = ring.claim(1)
    host["x"].fill_(5.0)
    ring.send(1, [(ring.dev[1]["x"], host["x"])])
    dev = ring.take(1)
    assert dev["x"] is host["x"] and torch.all(dev["x"] == 5.0)
    assert dev["t"].shape == (3,)
    ring.release(1)
    ring.drain()
    assert tio.ring_slots(0) == tio.ring_slots(1) == 1
    assert tio.ring_slots(3) == 3


def test_ring_feed_keeps_item_order_under_slow_steps():
    """A depth-2 feed through a 2-slot ring: each item lands in slot
    ``j % 2`` and reaches the consumer intact while the worker refills
    the other slot (the CPU twin of the card's FREE/READY protocol)."""
    ring = PinnedRing({"x": ((8,), torch.float32)}, 2,
                      torch.device("cpu"))

    def produce(j):
        slot = j % 2
        buf = ring.claim(slot)["x"]
        buf.fill_(float(j))
        ring.send(slot, [])
        return slot, j

    seen = []
    for slot, j in tio.Prefetcher(produce, range(10), depth=2):
        x = ring.take(slot)["x"]
        time.sleep(0.002)  # a slow step
        seen.append(float(x[0]) == j and bool(torch.all(x == j)))
        ring.release(slot)
    assert seen == [True] * 10
