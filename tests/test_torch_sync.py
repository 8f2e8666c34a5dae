"""The port's Schmidl-Cox synchroniser against the JAX package: window
sums, the full-rate and strided timing metrics, the fine stage, and the
synchroniser's constants (matched kernel, thresholds, stride rule).

Inputs are toy recordings from the JAX encoder plus seeded noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu import sync as jsync
from modem_tpu.numerology import make_config as jax_make_config
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_recordings
from modem_tpu_torch import numerology, sync


@pytest.fixture(scope="module")
def recordings():
    recs, _ = toy_recordings(3, seed=21)
    recs = np.asarray(recs)
    rng = np.random.default_rng(22)
    noisy = recs + 0.1 * rng.standard_normal(recs.shape).astype(np.float32)
    return np.concatenate([recs, noisy])


@pytest.fixture(scope="module")
def pair():
    return (sync.Synchronizer(numerology.toy_config(), "cpu"),
            jsync.Synchronizer(jax_toy_config()))


def as_complex(recs):
    return torch.from_numpy((recs[..., 0] + 1j * recs[..., 1]).astype(
        np.complex64))


@pytest.mark.parametrize("w", [1, 20, 128, 513, 1500])
def test_window_sum_matches(w):
    """The f64 cumsum difference is within f32 rounding of the exact
    window sums; the JAX two-level block sums within their own bound
    (f32 rounding of block prefix sums over 512 samples)."""
    rng = np.random.default_rng(w)
    x = rng.standard_normal((2, 4000)).astype(np.float32) + 3.0
    got = sync.window_sum(torch.from_numpy(x), w).numpy()
    want = np.asarray(jsync.window_sum(jnp.asarray(x), w))
    exact = np.stack([np.convolve(r.astype(np.float64), np.ones(w))[:4000]
                      for r in x])
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()
    bound = 4 * np.finfo(np.float32).eps * (512 + w) * np.abs(x).max()
    assert np.abs(got - want).max() <= bound


def test_window_sum_does_not_drift():
    """A long offset signal: the f64 running total cancels without
    drift, so late windows are as exact as early ones."""
    x = np.full(1 << 20, 0.1, np.float32)
    got = sync.window_sum(torch.from_numpy(x), 640).numpy()
    assert np.allclose(got[640:], np.float32(0.1) * 640, rtol=1e-6)


@pytest.mark.parametrize("shape", [(1,), (9,), (3, 50), (2, 3, 4096)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_last_true_is_a_running_max(shape, density):
    """sync.last_true equals the running maximum (cummax) of the true
    indices, with the fill where none is true yet."""
    rng = np.random.default_rng(len(shape) * 100 + int(density * 100))
    mask = torch.from_numpy(rng.random(shape) < density)
    idx = torch.arange(shape[-1]).expand(shape)
    for fill in (-2, torch.tensor(-1)):
        want = torch.where(mask, idx, fill).cummax(-1)[0]
        assert torch.equal(sync.last_true(mask, fill), want)


def test_constants_match(pair):
    port, ref = pair
    assert (port.L, port.match_len, port.match_del) == \
        (ref.L, ref.match_len, ref.match_del)
    assert (port.thr_lo, port.thr_hi) == (ref.thr_lo, ref.thr_hi)
    kern = ref.kerns[0]
    assert np.allclose(port.kernel.numpy(), kern[:, 0] + 1j * kern[:, 1],
                       atol=1e-6)


@pytest.mark.parametrize("rate,mode", [(8000, 6), (16000, 7), (44100, 6),
                                       (48000, 10)])
def test_stride_rule_matches(rate, mode):
    port = sync.Synchronizer(numerology.make_config(rate, mode), "cpu")
    ref = jsync.Synchronizer(jax_make_config(rate, mode))
    for stride in (1, 2, 4, 8, 16):
        assert port.stride_ok(stride) == ref.stride_ok(stride)
    assert np.allclose(port.kernel.numpy(),
                       ref.kerns[0][:, 0] + 1j * ref.kerns[0][:, 1],
                       atol=1e-6)


def test_metrics_parts_match(pair, recordings):
    port, ref = pair
    got = port._metrics_parts(as_complex(recordings))
    want = jax.vmap(ref._metrics_parts)(jnp.asarray(recordings))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.allclose(g.numpy(), w, rtol=1e-4,
                           atol=1e-5 * np.abs(w).max())
    # the peaks the argmax commits to are the same samples
    assert np.array_equal(got[0].argmax(-1).numpy(),
                          np.asarray(want[0]).argmax(-1))


def test_metrics_parts_strided_match(pair, recordings):
    port, ref = pair
    for stride in (2, 8):
        assert port.stride_ok(stride)
        got = port._metrics_parts_strided(as_complex(recordings), stride)
        want = jax.vmap(lambda x: ref._metrics_parts_strided(x, stride))(
            jnp.asarray(recordings))
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.allclose(g.numpy(), w, rtol=1e-4,
                               atol=1e-5 * np.abs(w).max())
        assert np.array_equal(got[0].argmax(-1).numpy(),
                              np.asarray(want[0]).argmax(-1))


def test_fine_stage_matches(pair, recordings):
    """shift and pos_err exactly; peak, next and the angle to f32
    rounding (pos_err = round(angle * L / 2 pi) sits well clear of .5
    on these recordings)."""
    port, ref = pair
    L = port.L
    timing, p_re, p_im = port._metrics_parts(as_complex(recordings))
    n_max = timing.argmax(-1)
    p0 = (n_max - port.match_del).numpy()
    i = (n_max - port.match_del)[:, None]
    fc = (torch.atan2(p_im.gather(-1, i), p_re.gather(-1, i))[:, 0]
          / L).numpy()
    wins = np.stack([recordings[b, p0[b] + L: p0[b] + 2 * L]
                     for b in range(len(p0))])
    got = port._fine_stage(as_complex(wins), torch.from_numpy(fc))
    want = [np.asarray(v)[:, 0] for v in jax.vmap(ref._fine_stage)(
        jnp.asarray(wins), jnp.asarray(fc))]
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    for g, w in zip(got[2:], want[2:]):
        assert np.allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
    frac = np.abs(want[4] * L / (2 * np.pi) % 1.0 - 0.5)
    assert frac.min() > 1e-3


def test_slice_windows_clamps_like_dynamic_slice():
    x = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    out = sync.slice_windows(x, torch.tensor([-3, 8]), 4)
    assert out.tolist() == [[0, 1, 2, 3], [16, 17, 18, 19]]
