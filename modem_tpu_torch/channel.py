"""Channel impairments: multipath, CFO, SFO, AWGN (host numpy).

Counterpart of ``modem_tpu/channel.py``: the impairment chain of the
reference's demonstration (README.md:42-49: ``multipath .. 10 | cfo - -
234.567 | sfo - - 147 | awgn - - -30``), for tests and the card smoke
run; impairments are fixtures, not a serving path.

  * multipath: FIR with complex taps at integer sample delays;
  * cfo(hz): multiply by e^{j 2 pi f t};
  * sfo(ppm): resample by 1 + ppm * 1e-6 with Kaiser-windowed sinc
    interpolation (a sound card's clock offset);
  * awgn(db): complex white Gaussian noise at ``db`` relative to full
    scale 1.0, split equally between I and Q.
"""

from __future__ import annotations

import numpy as np

# A 4-tap profile in place of the demonstration's file-driven taps (an
# assumed shape).  The demonstration stretches its delays by 10, so the
# base delays make x10 span 75 % of the 160-sample guard at 8 kHz.
DEFAULT_MULTIPATH = (
    (0, 1.0 + 0.0j),
    (2, 0.5 + 0.2j),
    (5, -0.3 + 0.1j),
    (12, 0.2 - 0.15j),
)


def multipath(x: np.ndarray, taps=DEFAULT_MULTIPATH,
              spread: int = 1) -> np.ndarray:
    """Apply complex FIR taps at (delay * spread) sample offsets."""
    x = np.asarray(x, dtype=np.complex128)
    max_d = max(d for d, _ in taps) * spread
    out = np.zeros(len(x) + max_d, dtype=np.complex128)
    for delay, gain in taps:
        out[delay * spread: delay * spread + len(x)] += gain * x
    return out


def cfo(x: np.ndarray, hz: float, rate: int) -> np.ndarray:
    n = np.arange(len(x))
    return np.asarray(x) * np.exp(2j * np.pi * hz * n / rate)


def analytic_np(x: np.ndarray) -> np.ndarray:
    """Exact FFT analytic signal of a real vector (one-sided spectrum),
    for impairing real recordings physically: a passband frequency
    shift acts on the analytic signal.  The receiver's own causal front
    end is dsp.frontend / ingest.analytic_chunk."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    spec = np.fft.fft(x)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[1: (n + 1) // 2] = 2.0
    return np.fft.ifft(spec * h)


def sfo(x: np.ndarray, ppm: float, taps: int = 32) -> np.ndarray:
    """Resample by 1 + ppm * 1e-6 (the receiver's clock running fast or
    slow) with Kaiser-windowed sinc fractional-delay interpolation: the
    band reaches ~0.42 fs at 8 kHz, where linear interpolation injects
    ~10 dB of distortion; 32 taps keep the error ~60 dB down."""
    factor = 1.0 + ppm * 1e-6
    x = np.asarray(x, dtype=np.complex128)
    t = np.arange(int(len(x) / factor)) * factor
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    half = taps // 2
    xp = np.pad(x, (half, half))
    beta = 8.6
    out = np.zeros(len(t), dtype=np.complex128)
    win_arg = lambda u: np.clip(1.0 - (u / half) ** 2, 0.0, None)
    for k in range(-half + 1, half + 1):
        u = frac - k
        w = np.sinc(u) * np.i0(beta * np.sqrt(win_arg(u))) / np.i0(beta)
        out += w * xp[i0 + k + half]
    return out


def awgn(x: np.ndarray, db: float, rng=None) -> np.ndarray:
    """Add complex Gaussian noise of total power ``db`` dB relative to
    full scale 1.0, split equally between I and Q (an assumed
    convention of the demonstration's tool)."""
    rng = rng or np.random.default_rng(0)
    sigma = 10.0 ** (db / 20.0)
    noise = sigma * (rng.standard_normal(len(x)) +
                     1j * rng.standard_normal(len(x))) / np.sqrt(2)
    return np.asarray(x) + noise


def reference_chain(x: np.ndarray, rate: int, rng=None,
                    cfo_hz: float = 234.567, sfo_ppm: float = 147.0,
                    awgn_db: float = -30.0,
                    spread: int = 10) -> np.ndarray:
    """The demonstration's chain with its published parameters
    (README.md:49): multipath stretched by ``spread``, then cfo, sfo
    and awgn."""
    y = multipath(x, spread=spread)
    y = cfo(y, cfo_hz, rate)
    y = sfo(y, sfo_ppm)
    return awgn(y, awgn_db, rng)
