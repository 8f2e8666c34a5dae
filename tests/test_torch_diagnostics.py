"""The port's diagnostics (``profiling``, ``debug``) against the JAX
package's contracts, on the CPU: StageTimer's accounting and report text,
device_trace's trace file, NaN trapping (FloatingPointError, as
jax_debug_nans raises) and the float64 shadow."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu import debug as jdebug
from modem_tpu import profiling as jprofiling
from modem_tpu_torch import debug, ofdm, profiling


def test_stage_timer_accounts_and_reports_as_jax():
    timer, jtimer = profiling.StageTimer(), jprofiling.StageTimer()
    for t, arr in ((timer, torch.ones(3)), (jtimer, jnp.ones(3))):
        for name in ("sync", "demod", "sync"):
            with t(name) as stage:
                stage.out = {"x": [arr * 2, (arr, np.zeros(2))], "n": 3}
    assert dict(timer.counts) == dict(jtimer.counts) == {"sync": 2,
                                                         "demod": 1}
    assert all(v > 0 for v in timer.totals.values())
    timer.totals.update({"sync": 0.0123, "demod": 0.5})
    jtimer.totals.update({"sync": 0.0123, "demod": 0.5})
    assert timer.report() == jtimer.report()
    assert timer.report().splitlines()[0].startswith("demod")


def test_stage_timer_charges_a_stage_that_raises():
    timer = profiling.StageTimer()
    with pytest.raises(KeyError):
        with timer("bad") as stage:
            stage.out = torch.zeros(2)
            raise KeyError("x")
    assert timer.counts["bad"] == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.device_trace(str(log_dir), device="cpu") as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)
    assert any("fft" in a.key for a in prof.key_averages())


def test_device_trace_writes_the_trace_when_the_block_raises(tmp_path):
    """As jax.profiler.trace does: the trace of a block that raises is
    still written, and the error goes on to the caller."""
    log_dir = tmp_path / "trace"
    with pytest.raises(KeyError):
        with profiling.device_trace(str(log_dir), device="cpu"):
            torch.fft.fft(torch.ones(64, dtype=torch.complex64))
            raise KeyError("x")
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)


def test_device_trace_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """The default device is the card; with none, it raises rather than
    trace the host under a device's name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.device_trace(str(tmp_path)):
            pass


def test_nan_checks_raise_as_jax_does():
    x = np.array([0.0, 1.0], np.float32)
    debug.enable_nan_checks(True)
    debug.enable_nan_checks(True)          # a second enable is a no-op
    try:
        with pytest.raises(FloatingPointError):
            torch.from_numpy(x) / torch.from_numpy(x)
        with pytest.raises(FloatingPointError):
            torch.complex(torch.tensor([float("nan")]), torch.ones(1)) * 2
        assert torch.equal(torch.arange(4) // 2, torch.tensor([0, 0, 1, 1]))
        assert float(torch.ones(3).sum()) == 3.0
    finally:
        debug.enable_nan_checks(False)
    assert torch.isnan(torch.from_numpy(x) / torch.from_numpy(x))[0]

    jdebug.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(lambda v: v / v)(jnp.asarray(x)).block_until_ready()
    finally:
        jdebug.enable_nan_checks(False)


def test_nan_checks_catch_the_erasure_path():
    """The docstring's caveat: demod_or_erase turns NaNs into erasures on
    purpose, so with the checks on it raises."""
    sym = torch.tensor([[1 + 1j, complex(float("nan"), 0.0)]],
                       dtype=torch.complex64)
    prev = torch.tensor([[1 + 0j, 1 + 0j]], dtype=torch.complex64)
    erased = ofdm.demod_or_erase(sym, prev)
    assert erased[0, 1] == 0
    debug.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            ofdm.demod_or_erase(sym, prev)
    finally:
        debug.enable_nan_checks(False)
    assert torch.equal(ofdm.demod_or_erase(sym, prev), erased)


def test_shadow_f64_sets_and_restores_the_default_dtype():
    assert torch.get_default_dtype() == torch.float32
    with debug.shadow_f64():
        assert torch.tensor([0.5]).dtype == torch.float64
        assert torch.zeros(2).dtype == torch.float64
    with pytest.raises(ValueError):
        with debug.shadow_f64():
            raise ValueError
    assert torch.get_default_dtype() == torch.float32
    old = jax.config.jax_enable_x64
    with jdebug.shadow_f64():
        assert jnp.asarray(0.5).dtype == jnp.float64
    assert jax.config.jax_enable_x64 == old


def test_spans_are_recorded_exactly_while_the_profiler_records():
    profiling.clear_spans()
    s0 = profiling.syncs
    with profiling.span("outer") as rec:
        assert rec is None
        with profiling.wait("outer.wait") as w:
            assert w is None
    assert profiling.spans() == [] and profiling.syncs == s0 + 1
    with torch.profiler.profile():
        assert profiling.tracing()
        with profiling.span("outer") as outer:
            with profiling.span("inner", device="cpu") as inner:
                with profiling.wait("inner.wait"):
                    pass
        with profiling.span("again", request=outer.request) as again:
            pass
        with profiling.span("next"):
            pass
    assert not profiling.tracing()
    recs = profiling.spans()
    assert [r.name for r in recs] == ["outer", "inner", "inner.wait",
                                      "again", "next"]
    assert [r.parent for r in recs] == [None, outer.id, inner.id, None,
                                        None]
    assert [r.wait for r in recs] == [False, False, True, False, False]
    assert [r.request for r in recs[:4]] == [outer.request] * 4
    assert recs[4].request != outer.request
    assert outer.counts["syncs"] == inner.counts["syncs"] == 1
    assert recs[2].counts["syncs"] == 0 and again.counts["syncs"] == 0
    assert inner.events is None and inner.device_ms is None
    assert outer.host_ms >= inner.host_ms >= 0
    profiling.clear_spans()
    assert profiling.spans() == []


def test_an_upload_waits_only_where_the_data_is_not_yet_there():
    s0 = profiling.syncs
    for data, device in (([1, 2], "cpu"), (np.ones(2), "cpu"),
                         (torch.ones(2), "cuda")):
        with profiling.upload("up", data, device):
            pass
    with profiling.upload("up", torch.ones(2), "cpu"):
        pass
    assert profiling.syncs == s0 + 3


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    profiling.clear_spans()
    with torch.profiler.profile():
        with timer("sync") as stage:
            with timer("demod") as inner:
                inner.out = torch.ones(2)
            stage.out = np.zeros(2)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["sync", "demod"]
    assert recs[1].parent == recs[0].id
    assert dict(timer.counts) == {"sync": 1, "demod": 1}
