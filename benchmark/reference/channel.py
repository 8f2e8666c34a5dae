"""The upstream README's demonstration channel, plain PyTorch on any
device, batched over recordings: ``multipath .. 10 | cfo - - 234.567 |
sfo - - 147 | awgn - - <dB>`` (aicodix/modem README.md:42-49).

  * multipath: complex taps at integer delays stretched by ``spread``
    (the taps are an assumed 4-tap profile; x10 spans 75 % of the
    160-sample guard at 8 kHz);
  * cfo: multiply by e^{j 2 pi f n / rate};
  * sfo: resample by 1 + ppm 1e-6, Kaiser-windowed sinc (32 taps,
    beta 8.6);
  * awgn: complex Gaussian noise of power ``db`` relative to full scale,
    split equally between I and Q, from the caller's generator.
"""

from __future__ import annotations

import math

import torch

TAPS = ((0, 1.0 + 0.0j), (2, 0.5 + 0.2j), (5, -0.3 + 0.1j),
        (12, 0.2 - 0.15j))


def multipath(x: torch.Tensor, spread: int) -> torch.Tensor:
    """[B, T] -> [B, T + max delay]."""
    top = max(d for d, _ in TAPS) * spread
    out = x.new_zeros(x.shape[0], x.shape[1] + top)
    for d, gain in TAPS:
        out[:, d * spread: d * spread + x.shape[1]] += gain * x
    return out


def cfo(x: torch.Tensor, hz: float, rate: int) -> torch.Tensor:
    n = torch.arange(x.shape[-1], device=x.device, dtype=torch.float64)
    rot = torch.polar(torch.ones_like(n), 2.0 * math.pi * hz * n / rate)
    return x * rot.to(x.dtype)


def sfo(x: torch.Tensor, ppm: float, taps: int = 32) -> torch.Tensor:
    """[B, T] -> [B, int(T / factor)]: sample t = i * factor of x."""
    factor = 1.0 + ppm * 1e-6
    t = torch.arange(int(x.shape[-1] / factor), device=x.device,
                     dtype=torch.float64) * factor
    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0
    half = taps // 2
    xp = torch.nn.functional.pad(x, (half, half))
    out = x.new_zeros(x.shape[0], t.shape[0])
    i_beta = torch.special.i0(torch.tensor(8.6, dtype=torch.float64))
    for k in range(-half + 1, half + 1):
        u = frac - k
        arg = (1.0 - (u / half) ** 2).clamp(min=0.0)
        w = torch.sinc(u) * torch.special.i0(8.6 * arg.sqrt()) / i_beta
        out += w.to(x.real.dtype) * xp[:, i0 + k + half]
    return out


def awgn(x: torch.Tensor, db: float, gen: torch.Generator) -> torch.Tensor:
    sigma = 10.0 ** (db / 20.0) / math.sqrt(2.0)
    noise = torch.randn(x.shape + (2,), generator=gen, device=x.device,
                        dtype=x.real.dtype)
    return x + sigma * torch.complex(noise[..., 0], noise[..., 1])


def chain(x: torch.Tensor, rate: int, awgn_db: float, gen: torch.Generator,
          cfo_hz: float = 234.567, sfo_ppm: float = 147.0,
          spread: int = 10) -> torch.Tensor:
    """The demonstration chain over recordings [B, T] complex64."""
    y = sfo(cfo(multipath(x, spread), cfo_hz, rate), sfo_ppm)
    return awgn(y, awgn_db, gen)


def analytic(x: torch.Tensor) -> torch.Tensor:
    """Exact FFT analytic signal of real rows [B, T] (one-sided
    spectrum): a passband frequency shift acts on it."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[1: (n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(x.to(torch.float64)) * h)


def impair_real(x: torch.Tensor, rate: int, cfo_hz: float = 234.567,
                sfo_ppm: float = 147.0, spread: int = 10) -> torch.Tensor:
    """The chain's multipath, CFO and SFO on real mono rows [B, T], as
    the demonstration's tools treat a one-channel WAV: each stage keeps
    the real part; the CFO shifts the analytic signal.  No noise."""
    y = multipath(x.to(torch.complex128), spread).real
    y = cfo(analytic(y), cfo_hz, rate).real
    return sfo(y.to(torch.complex128), sfo_ppm).real


def chain_real(x: torch.Tensor, rate: int, awgn_db: float,
               gen: torch.Generator, cfo_hz: float = 234.567,
               sfo_ppm: float = 147.0, spread: int = 10) -> torch.Tensor:
    """:func:`impair_real`, then real noise of the stated total power."""
    y = impair_real(x, rate, cfo_hz, sfo_ppm, spread)
    sigma = 10.0 ** (awgn_db / 20.0)
    noise = torch.randn(y.shape, generator=gen, device=y.device,
                        dtype=torch.float64)
    return y + sigma * noise
