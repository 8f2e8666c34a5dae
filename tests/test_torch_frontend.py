"""The port's front-end primitives against the JAX package: FFT, PSK,
OFDM (differential demod, PAPR clip-and-filter, synthesis) and channel
tracking (Theil-Sen derotation, soft demap).

Same seeded numpy inputs into both; complex tensors in the port,
split-complex [..., 2] arrays in JAX.  Tolerances are stated per test;
the JAX DFT is a matmul, torch.fft is not, so transforms agree to f32
rounding of the whole sum, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu import cplx
from modem_tpu import fft as jfft
from modem_tpu import ofdm as jofdm
from modem_tpu import psk as jpsk
from modem_tpu import track as jtrack
from modem_tpu_torch import fft, ofdm, psk, track


def split(x):
    return jnp.asarray(cplx.from_np(np.asarray(x)))


def joined(x):
    x = np.asarray(x)
    return x[..., 0] + 1j * x[..., 1]


def crandn(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


@pytest.mark.parametrize("n", [256, 640, 1280, 5120])
def test_fft_matches(n):
    rng = np.random.default_rng(n)
    x = crandn(rng, 3, n)
    t = torch.from_numpy(x)
    for port, ref in ((fft.fwd, jfft.fwd), (fft.bwd, jfft.bwd)):
        got = port(t).numpy()
        want = joined(ref(split(x)))
        # f32 rounding of an n-term sum, relative to the spectrum's size
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert np.allclose(fft.bwd(fft.fwd(t)).numpy() / n, x, atol=1e-5)


@pytest.mark.parametrize("mod_bits", [1, 2, 3])
def test_psk_matches(mod_bits):
    rng = np.random.default_rng(mod_bits)
    nrz = (1 - 2 * rng.integers(0, 2, (64, mod_bits))).astype(np.float32)
    sym = psk.mod_map(mod_bits, torch.from_numpy(nrz)).numpy()
    assert np.array_equal(sym, joined(jpsk.mod_map(mod_bits, nrz)))
    assert np.allclose(psk.mod_phase(mod_bits, torch.from_numpy(nrz)),
                       np.asarray(jpsk.mod_phase(mod_bits, nrz)), atol=1e-6)
    noisy = sym + crandn(rng, 64, scale=0.3)
    hard = psk.mod_hard(mod_bits, torch.from_numpy(noisy)).numpy()
    assert np.array_equal(hard, np.asarray(jpsk.mod_hard(mod_bits,
                                                         split(noisy))))
    prec = np.float32(7.5)
    soft = psk.mod_soft(mod_bits, torch.from_numpy(noisy),
                        torch.tensor(prec)).numpy()
    want = np.asarray(jpsk.mod_soft(mod_bits, split(noisy), prec))
    assert np.allclose(soft, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(psk.mod_hard(mod_bits, torch.from_numpy(sym)),
                          nrz)


def test_psk_rejects_unknown_order():
    with pytest.raises(ValueError):
        psk.mod_map(4, torch.ones(2, 4))


def test_demod_or_erase_matches():
    """Including the erasures: |prev|^2 == 0, |curr/prev|^2 > 4, NaN."""
    rng = np.random.default_rng(5)
    curr = crandn(rng, 200)
    prev = crandn(rng, 200)
    prev[:5] = 0
    curr[5:10] = 10 * prev[5:10]
    curr[10] = np.nan
    got = ofdm.demod_or_erase(torch.from_numpy(curr),
                              torch.from_numpy(prev)).numpy()
    want = joined(jofdm.demod_or_erase(split(curr), split(prev)))
    assert np.array_equal(got == 0, want == 0)
    assert (got[:11] == 0).all()
    assert np.allclose(got, want, rtol=1e-6, atol=1e-7)


def test_improve_papr_and_synthesize_match():
    rng = np.random.default_rng(6)
    n, g = 256, 32
    fdom = np.zeros((5, n), np.complex64)
    occupied = rng.integers(-40, 40, 60) % n
    fdom[:, occupied] = 3.0 * crandn(rng, 5, 60)   # clips in the time domain
    got = ofdm.improve_papr(torch.from_numpy(fdom)).numpy()
    want = joined(jofdm.improve_papr(split(fdom)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (got[:, np.setdiff1d(np.arange(n), occupied)] == 0).all()

    mask = np.array([True, False, True, True, True])
    wave, papr = ofdm.synthesize(torch.from_numpy(fdom), g, mask)
    jwave, jpapr = jofdm.synthesize(split(fdom), g, mask)
    assert wave.shape == (5 * (n + g),)
    assert np.abs(wave.numpy() - joined(jwave)).max() <= \
        1e-5 * np.abs(joined(jwave)).max()
    assert np.allclose(papr.numpy(), np.asarray(jpapr), rtol=1e-4)


def test_synthesize_batches_over_leading_axes():
    rng = np.random.default_rng(7)
    fdom = crandn(rng, 2, 3, 64)
    batched, _ = ofdm.synthesize(torch.from_numpy(fdom), 8)
    for b in range(2):
        one, _ = ofdm.synthesize(torch.from_numpy(fdom[b]), 8)
        assert torch.allclose(batched[b], one, atol=1e-6)


@pytest.mark.parametrize("cols", [32, 33, 432])
def test_theil_sen_matches(cols):
    """Disjoint-pairs Theil-Sen with the UPPER middle for even counts
    (the JAX _median_lower takes sort(v)[n // 2])."""
    rng = np.random.default_rng(cols)
    x = (np.arange(cols) - cols // 2).astype(np.float32)
    y = (0.01 * x + 0.2 + 0.05 * rng.standard_normal((4, cols))).astype(
        np.float32)
    slope, yint = track.theil_sen(torch.from_numpy(x), torch.from_numpy(y))
    jslope, jyint = jax.vmap(lambda r: jtrack.theil_sen(jnp.asarray(x),
                                                        r))(y)
    assert np.array_equal(slope.numpy(), np.asarray(jslope))
    assert np.allclose(yint.numpy(), np.asarray(jyint), atol=1e-7)
    # torch.median would pick the lower middle: the port must not
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert track._median_upper(v) == 3.0


@pytest.mark.parametrize("mod_bits,code_off", [(2, -16), (3, -216)])
def test_derotate_and_soft_llrs_match(mod_bits, code_off):
    rng = np.random.default_rng(mod_bits)
    rows, cols = 6, -2 * code_off
    nrz = (1 - 2 * rng.integers(0, 2, (rows, cols, mod_bits))).astype(
        np.float32)
    sym = joined(jpsk.mod_map(mod_bits, nrz))
    k = np.arange(cols) + code_off
    rot = np.exp(1j * (0.002 * k + 0.05))[None, :]
    cons = (sym * rot + crandn(rng, rows, cols, scale=0.1)).astype(
        np.complex64)
    out, slope, yint = track.derotate_rows(torch.from_numpy(cons), code_off,
                                           mod_bits)
    jout, jslope, jyint = jtrack.derotate_rows(split(cons), code_off,
                                               mod_bits)
    assert np.allclose(out.numpy(), joined(jout), atol=2e-6)
    assert np.isclose(slope.item(), float(jslope), atol=1e-7)
    assert np.isclose(yint.item(), float(jyint), atol=1e-6)
    llrs, snr = track.soft_llrs(out, mod_bits)
    jllrs, jsnr = jtrack.soft_llrs(jout, mod_bits)
    assert np.allclose(llrs.numpy(), np.asarray(jllrs), rtol=1e-4,
                       atol=1e-3)
    assert np.array_equal(np.sign(llrs.numpy()), np.sign(np.asarray(jllrs)))
    assert np.allclose(snr.numpy(), np.asarray(jsnr), rtol=1e-4)
