"""The reference's vectorised scan against the per-sample Schmitt trigger
it replaced (the oracle below): the same (edge, n_max, phase) events on
the interactive pool's recordings, on a toy recording with long
noise-only stretches and a frame at each end, on one with more than 32
edges, and on synthetic metrics with NaNs and values at the thresholds.
Equal events give the interactive cell's reference the same answers."""

import math

import numpy as np
import pytest
import torch

from harness import inputs, interactive
from reference import modem as M
from reference.encoder import Encoder
from reference.frontend import FrontEnd
from reference.interactive import (MAX_EDGES, Receiver, analytic,
                                   schmitt_events)
from toycell import TOY_CONFIG

TOY = M.config_of(TOY_CONFIG["modem"])


def oracle(t, ph, lo, hi, match_del, max_edges):
    """The per-sample loop of decode.cc:88-108: on above hi, on at or
    above lo if on before, and at each falling edge the first maximum of
    the run and the phase match_del samples before it."""
    out, state, vmax, imax = [], False, -math.inf, 0
    for n in range(t.shape[0]):
        v = t[n]
        new = bool(v > hi or (v >= lo and state))
        if new and not state:
            vmax, imax = -math.inf, n
        if new and v > vmax:
            vmax, imax = v, n
        if state and not new:
            out.append((n, imax, float(ph[max(imax - match_del, 0)])))
            if len(out) >= max_edges:
                break
        state = new
    return out


def toy_receiver():
    """A Receiver whose scan runs at the toy numerology."""
    rx = Receiver(8000, 8, "cpu")
    rx.sync = FrontEnd(M.Config(8000, TOY.mode, 0, 256), "cpu", 1)
    return rx


def same_events(rx, x, max_edges):
    fe = rx.sync
    t, ph = rx.metric(x, lambda v: v)
    args = (0.17 * fe.match_len, 0.19 * fe.match_len, fe.match_del,
            max_edges)
    want = oracle(t, ph, *args)
    assert schmitt_events(t, ph, *args) == want
    return want


def toy_frames(n, seed):
    gen = torch.Generator().manual_seed(seed)
    bits = inputs.payload_bits(TOY.mode.data_bytes, n, gen, "cpu")
    wave = Encoder(TOY, "cpu").encode(bits, np.arange(1, n + 1))
    return wave.real.double()


def test_the_interactive_pools_recordings():
    params = {"pool": 2, "pad_s": 1.0,
              "channel": {"awgn_db": -30.0, "cfo_hz": 234.567,
                          "sfo_ppm": 147.0, "spread": 10}}
    cfg = M.config_of({"rate": 8000, "mode": 6, "freq_off": 2000})
    pool, _, _ = interactive.mono_pool(cfg, params, 2 ** 33 + 5, "cpu")
    rx = Receiver(8000, 8, "cpu")
    for samples in pool:
        x = analytic(torch.as_tensor(samples), 8000)
        got = same_events(rx, x, MAX_EDGES)
        assert len(got) >= 1
        assert rx.events(x, lambda v: v) == got


def test_long_noise_and_a_frame_at_each_end():
    frames = toy_frames(2, 1)
    gen = torch.Generator().manual_seed(2)
    x = 0.03 * torch.randn(400_000, generator=gen, dtype=torch.float64)
    w = frames.shape[1]
    x[:w] += frames[0]
    x[-w:] += frames[1]
    got = same_events(toy_receiver(), analytic(x.float(), 8000), 256)
    assert len(got) >= 1
    assert got[0][1] < 2 * w and got[-1][0] > x.shape[0] - 2 * w


@pytest.mark.parametrize("max_edges", [MAX_EDGES, 256])
def test_more_than_32_edges(max_edges):
    frames = toy_frames(40, 3)
    gap = torch.zeros(frames.shape[0], 2000, dtype=torch.float64)
    x = torch.cat([frames, gap], dim=1).reshape(-1)
    gen = torch.Generator().manual_seed(4)
    x = x + 0.01 * torch.randn(x.shape, generator=gen, dtype=torch.float64)
    got = same_events(toy_receiver(), analytic(x.float(), 8000), max_edges)
    if max_edges == MAX_EDGES:
        assert len(got) == MAX_EDGES
    else:
        assert len(got) > 40


@pytest.mark.parametrize("seed", range(6))
def test_synthetic_metrics_with_nans_and_threshold_values(seed):
    rng = np.random.default_rng(seed)
    lo, hi = 17.0, 19.0
    t = np.cumsum(rng.normal(0, 2.0, 5000)).astype(np.float32) % 40
    at = rng.choice(5000, 300, replace=False)
    t[at[:100]] = lo
    t[at[100:200]] = hi
    t[at[200:220]] = np.nan
    t[at[220:]] = t[at[220:] - 1]           # ties for the first maximum
    ph = rng.uniform(-3, 3, 5000).astype(np.float32)
    for max_edges in (1, 5, 10 ** 6):
        assert (schmitt_events(t, ph, lo, hi, 7, max_edges)
                == oracle(t, ph, lo, hi, 7, max_edges))
    assert schmitt_events(np.zeros(0, np.float32), ph, lo, hi, 7, 5) == []
