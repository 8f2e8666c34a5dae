"""The port's AdaptivePipeline and BatchPipeline(list_size=4) against the
JAX package's, on the toy configuration (mirrors tests/test_adaptive.py).

Same numpy recordings (JAX toy encoder plus seeded noise) into both.
Exact: ok, bits, p0, flips, sync_gate and the fallback count.  cfo_rad
within 1e-5 rad/sample and snr within 1e-3 relative (the front ends'
FFTs round differently).  Port against port: every key exactly.
"""

import numpy as np
import pytest
import torch

from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_recordings
from modem_tpu.pipeline import AdaptivePipeline as JaxAdaptivePipeline
from modem_tpu.pipeline import BatchPipeline as JaxBatchPipeline
from modem_tpu_torch import profiling
from modem_tpu_torch.numerology import toy_config
from modem_tpu_torch.pipeline import (AdaptivePipeline, BatchPipeline,
                                      cached_adaptive_pipeline,
                                      cached_pipeline)

EXACT_KEYS = ("ok", "bits", "p0", "flips", "sync_gate")


def _toy(cls, **kw):
    cfg = toy_config()
    return cls(rate=cfg.rate, oper_mode=0, list_size=4, mode_spec=cfg.mode,
               symbol_len_override=cfg.symbol_len, device="cpu", **kw)


def _jax_toy(cls, **kw):
    cfg = jax_toy_config()
    return cls(rate=cfg.rate, oper_mode=0, list_size=4, mode_spec=cfg.mode,
               symbol_len_override=cfg.symbol_len, **kw)


def assert_matches_jax(got: dict, want: dict):
    assert set(got) == set(want)
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], np.asarray(want[key])), key
    assert np.abs(got["cfo_rad"] - np.asarray(want["cfo_rad"])).max() <= 1e-5
    assert np.allclose(got["snr"], np.asarray(want["snr"]), rtol=1e-3)


def assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in got:
        assert np.array_equal(got[key], want[key]), key


@pytest.fixture(scope="module")
def port():
    return _toy(AdaptivePipeline)


@pytest.fixture(scope="module")
def port_scl():
    return _toy(BatchPipeline)


@pytest.fixture(scope="module")
def jax_pipes():
    return _jax_toy(JaxAdaptivePipeline), _jax_toy(JaxBatchPipeline)


@pytest.fixture(scope="module")
def clean():
    recs, payloads = toy_recordings(4, seed=3)
    return np.asarray(recs), payloads


@pytest.fixture(scope="module")
def noisy():
    """The noise-0.3 batch of tests/test_torch_pipeline.py, whose LLR
    signs the front-end test there pins equal to JAX's (so ``flips``,
    a count of sign disagreements, can be compared exactly)."""
    recs, payloads = toy_recordings(8, seed=3)
    recs = np.asarray(recs)
    rng = np.random.default_rng(42)
    for sigma in (0.05, 0.3):
        x = recs + sigma * rng.standard_normal(recs.shape).astype(np.float32)
    return x, payloads


@pytest.fixture(scope="module")
def noisy_results(port, jax_pipes, noisy):
    """(port adaptive, its fallbacks, JAX adaptive, its fallbacks) on the
    noisy batch."""
    jax_adaptive, _ = jax_pipes
    x, _ = noisy
    got = port.decode_batch(x)
    n_port = port.last_fallbacks
    want = jax_adaptive.decode_batch(x)
    return got, n_port, want, jax_adaptive.last_fallbacks


def test_clean_batch(port, jax_pipes, clean):
    """Clean frames all pass SC: zero escalations, exact payloads, no
    flips, and the JAX result on every key."""
    x, payloads = clean
    res = port.decode_batch(x)
    assert res["ok"].all()
    assert port.last_fallbacks == 0
    assert all(port.payload_bytes(res, i) == p
               for i, p in enumerate(payloads))
    assert res["flips"].max() == 0
    assert_matches_jax(res, jax_pipes[0].decode_batch(x))


def test_noisy_batch_matches_jax(port, noisy_results, noisy):
    """At noise 0.3 SC fails on some frames; the port escalates the same
    frames as JAX and agrees on every key, and the list decoder recovers
    at least one frame that SC lost."""
    got, n_port, want, n_jax = noisy_results
    assert n_port == n_jax > 0
    assert_matches_jax(got, want)
    _, payloads = noisy
    recovered = [i for i in np.flatnonzero(got["ok"])
                 if port.payload_bytes(got, i) == payloads[i]]
    assert len(recovered) >= 1


def test_noisy_batch_equals_pure_list_decode(noisy_results, port_scl,
                                             noisy):
    """Escalated frames return the list decoder's result verbatim: the
    adaptive output equals the port's BatchPipeline(list_size=4) on every
    key."""
    got = noisy_results[0]
    x, _ = noisy
    assert_equal(got, port_scl.fetch(port_scl.decode_batch(x)))


def test_batch_pipeline_list4_matches_jax(port_scl, jax_pipes, noisy):
    _, jax_scl = jax_pipes
    x, _ = noisy
    assert_matches_jax(port_scl.fetch(port_scl.decode_batch(x)),
                       jax_scl.fetch(jax_scl.decode_batch(x)))


def test_fallback_batch_pads_groups(port, noisy_results, noisy):
    """A fallback batch of 2 with more failures than that: several
    padded groups, the same result as one group of 16."""
    got = noisy_results[0]
    assert noisy_results[1] > 2
    small = _toy(AdaptivePipeline, fallback_batch=2,
                 state=port.sc.state)
    res = small.decode_batch(noisy[0])
    assert small.last_fallbacks == noisy_results[1]
    assert_equal(res, got)


def test_async_handles_resolve_in_order(port, clean, noisy, noisy_results):
    """Two handles dispatched before either resolves give what
    decode_batch gives, batch by batch."""
    h1 = port.decode_batch_async(clean[0])
    h2 = port.decode_batch_async(noisy[0])
    first = port.resolve(h1)
    assert port.last_fallbacks == 0
    second = port.resolve(h2)
    assert port.last_fallbacks == noisy_results[1]
    assert_equal(first, port.decode_batch(clean[0]))
    assert_equal(second, noisy_results[0])


def test_cached_factories():
    a = cached_adaptive_pipeline(8000, 6, device="cpu")
    assert a is cached_adaptive_pipeline(8000, 6, device="cpu")
    assert (a.sc.list_size, a.scl.list_size, a.fallback_batch) == (1, 8, 16)
    assert a.scl.state is a.sc.state
    p = cached_pipeline(8000, 6, 4, device="cpu")
    assert p is cached_pipeline(8000, 6, 4, device="cpu") and p.list_size == 4
    assert cached_pipeline(8000, 6, device="cpu").list_size == 8



def test_fast_list_decode_matches_jax(noisy):
    """scl_exact=False (the Fast-SSC-List decoder, kernel C): on the noisy
    batch the port's AdaptivePipeline escalates the frames JAX's does and
    agrees with it on every key, and equals the port's BatchPipeline(
    list_size=4, scl_exact=False) outright."""
    x, _ = noisy
    port = _toy(AdaptivePipeline, scl_exact=False)
    assert port.scl.scl_exact is False
    jax_adaptive = _jax_toy(JaxAdaptivePipeline, scl_exact=False)
    got = port.decode_batch(x)
    want = jax_adaptive.decode_batch(x)
    assert port.last_fallbacks == jax_adaptive.last_fallbacks > 0
    assert_matches_jax(got, want)
    whole = _toy(BatchPipeline, scl_exact=False, state=port.sc.state)
    assert_equal(got, whole.fetch(whole.decode_batch(x)))


# -- spans and counters of the serving loop (modem_tpu_torch.profiling) ---------

@pytest.fixture(scope="module")
def traced_batches(port, clean, noisy):
    """The clean and the noisy batch dispatched together and resolved in
    the other order, once with tracing off and once under torch.profiler:
    (syncs off, the off run's records, record_function entries off,
    syncs on, the on run's records, the two handles, the results)."""
    mp = pytest.MonkeyPatch()
    entered = []
    real = torch.profiler.record_function
    mp.setattr(torch.profiler, "record_function",
               lambda name, *a: entered.append(name) or real(name, *a))

    def serve():
        h1 = port.decode_batch_async(clean[0])
        h2 = port.decode_batch_async(noisy[0])
        return (h1, h2), (port.resolve(h2), port.resolve(h1))

    try:
        profiling.clear_spans()
        s0 = profiling.syncs
        serve()
        off = (profiling.syncs - s0, profiling.spans(), list(entered))
        s0 = profiling.syncs
        with torch.profiler.profile():
            handles, results = serve()
        on = (profiling.syncs - s0, profiling.spans())
    finally:
        mp.undo()
    return off + on + (handles, results)


def test_batches_record_no_span_when_tracing_is_off(traced_batches):
    syncs_off, recs_off, entered = traced_batches[:3]
    assert recs_off == [] and entered == []
    assert syncs_off == traced_batches[3] > 0


def test_batch_spans_nest_and_share_their_request(traced_batches,
                                                  noisy_results):
    recs, (h1, h2), (r2, r1) = traced_batches[4:]
    assert_equal(r2, noisy_results[0])
    byid = {r.id: r for r in recs}
    pairs = [(r.name, byid[r.parent].name if r.parent else None)
             for r in recs]
    groups = -(-noisy_results[1] // 16)
    dispatch = [("pipeline.dispatch", None),
                ("pipeline.demod", "pipeline.dispatch"),
                ("pipeline.upload", "pipeline.demod"),   # host recordings
                ("pipeline.sc", "pipeline.dispatch"),
                ("pipeline.pack", "pipeline.dispatch")]
    resolve = [("pipeline.resolve", None),
               ("pipeline.unpack", "pipeline.resolve")]
    escalate = [("pipeline.escalate", "pipeline.resolve"),
                ("pipeline.upload", "pipeline.escalate"),
                ("pipeline.fetch", "pipeline.escalate")]
    assert pairs == dispatch * 2 + resolve + escalate * groups + resolve
    assert h1.request != h2.request
    first, second = len(dispatch), 2 * len(dispatch)
    assert {r.request for r in recs[:first]} == {h1.request}
    assert {r.request for r in recs[first: second]} == {h2.request}
    # the noisy batch resolves first, in its dispatch's request
    n2 = len(resolve) + len(escalate) * groups
    assert {r.request for r in recs[second: second + n2]} == {h2.request}
    assert {r.request for r in recs[second + n2:]} == {h1.request}
    for r in recs:
        if r.parent is not None:
            p = byid[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_batch_syncs_are_the_wait_spans(traced_batches, noisy_results):
    syncs, recs = traced_batches[3:5]
    waits = [r for r in recs if r.wait]
    assert syncs == len(waits)
    resolves = [r for r in recs if r.name == "pipeline.resolve"]
    groups = -(-noisy_results[1] // 16)
    # on the CPU no event: an upload and a fetch a group
    assert [r.counts["syncs"] for r in resolves] == [2 * groups, 0]
    assert all(r.counts["sc_launches"] == r.counts["scl_launches"] == 0
               for r in recs)          # the plain versions on the CPU


def test_handle_unpacks_as_before(port, clean):
    handle = port.decode_batch_async(clean[0])
    front, packed, event = handle
    assert isinstance(handle, tuple) and len(handle) == 3
    assert handle.request is None and event is None
    assert_equal(port.resolve((front, packed, event)), port.resolve(handle))
