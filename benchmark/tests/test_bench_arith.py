"""The harness's arithmetic on synthetic numbers: the tail, the rate and
the device's idle share and gaps from a kernel timeline."""

import pathlib
import types

import numpy as np
import pytest

from harness import batch, common, trace
from harness.trace import Interval

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_p95_is_linear_interpolation_over_all_values():
    values = list(range(1, 101))          # 1..100
    assert common.percentile(values, 95) == pytest.approx(95.05)
    assert common.percentile([5.0] * 7, 95) == 5.0
    rng = np.random.default_rng(0)
    v = rng.exponential(size=999)
    assert common.percentile(v, 95) == pytest.approx(np.percentile(v, 95))


def test_rate_is_all_work_over_all_time_and_the_tail_of_every_batch():
    lat = [0.010] * 95 + [0.050] * 5            # seconds, 100 batches
    got = batch.window_metrics(lat, 512 * 100, 2.0, 17.5)
    assert got["frames_per_s"] == pytest.approx(25600.0)
    assert got["batch_ms_p95"] == pytest.approx(12.0)   # 10 + 0.05 * 40
    assert got["setup_s"] == 17.5


def test_the_loop_tail_is_the_tail_of_every_batch_of_the_window():
    read = common.reader(REPO, "loop_ms_p95.batch")
    run = types.SimpleNamespace(counters=dict(
        latency_s=[0.010] * 95 + [0.050] * 5))
    assert read(run) == pytest.approx(12.0)
    assert read(types.SimpleNamespace(counters={})) is None


def timeline():
    return [Interval("bench.slice", 10.0, 20.0, False),
            Interval("bench.dispatch", 10.0, 12.0, False),
            Interval("cudaLaunchKernel", 11.5, 11.6, False),
            Interval("bench.resolve", 12.0, 19.0, False),
            Interval("cudaEventSynchronize", 12.5, 18.0, False),
            Interval("void sc_decode_kernel(float const*)", 11.0, 13.0,
                     True),
            Interval("void scl_decode_kernel(float const*)", 12.5, 14.0,
                     True),
            Interval("Memcpy DtoH (Device -> Pinned)", 16.0, 17.0, True),
            Interval("void sc_decode_kernel(float const*)", 9.0, 10.5,
                     True)]


def test_busy_is_the_union_of_device_intervals_inside_the_slice():
    s = trace.summarise(timeline())
    assert s.window_s == pytest.approx(10.0)
    # [10, 10.5] + [11, 14] + [16, 17]
    assert s.busy_s == pytest.approx(4.5)
    assert s.idle_pct == pytest.approx(55.0)


def test_idle_gaps_are_named_by_what_the_host_did():
    s = trace.summarise(timeline())
    # gaps [17, 20], [14, 16], [10.5, 11], longest first
    assert [name for name, _ in s.idle_gaps] == [
        "bench.resolve:cudaEventSynchronize",
        "bench.resolve:cudaEventSynchronize", "bench.dispatch"]
    assert [g for _, g in s.idle_gaps] == pytest.approx([3.0, 2.0, 0.5])


def test_kernel_time_is_matched_by_whole_name():
    s = trace.summarise(timeline())
    assert s.kernel_ms("sc_decode_kernel") == pytest.approx(1750.0)
    assert s.kernel_ms("scl_decode_kernel") == pytest.approx(1500.0)
    assert s.kernel_ms("decode_kernel") is None
    assert s.device_ops[0][0].startswith("void sc_decode_kernel")
