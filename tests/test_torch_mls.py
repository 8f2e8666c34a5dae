"""The three MLS conventions on the port against the JAX package.

Same inputs into both: the three polynomials (MLS0, MLS1, MLS2), toy
payloads from a numpy seed, and the frozen golden recordings
tests/data/golden_mode6_{galois,fibonacci,msb}.wav (mode 6, call sign
N0CALL, one per convention).

- ``bits.mls_bits`` equal outright for every convention and polynomial;
- the receive tables under "auto" (MLS0 kernels [K, L], MLS1 scramblers
  [K, 255]) equal to JAX's ``Synchronizer.kerns`` and
  ``Decoder._mls1_seqs`` within 1e-6, and the port built from those JAX
  arrays through ``state_from_numpy``;
- the toy ``Encoder`` under "fibonacci" and "msb" against JAX's at
  tests/test_torch_encoder.py's tolerance (waveform 1e-5, papr rtol
  1e-4);
- the auto synchroniser's candidates on each golden: p0, ok and the set
  of passing hypotheses exact; with AWGN added, also conv and the ranked
  hypotheses (conv, p0) exact, CFOs within 1e-5 rad/sample, peak ratios
  within rtol 1e-3 (see test_auto_scan_ranks_as_jax for why the ranking
  of a noiseless recording turns on the FFT's rounding);
- ``Decoder(8000, mls_convention="auto")`` on the fibonacci and msb
  goldens against JAX's: ok, payload, oper_mode, call_sign, symbol_pos,
  bit_flips, status exact (cfo within 1e-3 Hz, sfo within 1e-3 ppm);
- ``decode_headers_batch`` on the fibonacci golden under "auto", and a
  galois-only receiver's outcome on it, as JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu import wav as jwav
from modem_tpu.decoder import Decoder as JaxDecoder
from modem_tpu.encoder import Encoder as JaxEncoder
from modem_tpu.numerology import make_config as jax_make_config
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.sync import Synchronizer as JaxSynchronizer
from modem_tpu_torch import bits, channel, numerology
from modem_tpu_torch.decoder import Decoder
from modem_tpu_torch.encoder import Encoder
from modem_tpu_torch.numerology import make_config, toy_config
from modem_tpu_torch.state import build_state, state_from_numpy
from modem_tpu_torch.sync import Synchronizer

_DATA = os.path.join(os.path.dirname(__file__), "data")
POLYS = [(numerology.MLS0_POLY, 127), (numerology.MLS1_POLY, 255),
         (numerology.MLS2_POLY, 432)]


def golden(conv):
    return jwav.read_wav(os.path.join(
        _DATA, f"golden_mode6_{conv}.wav")).analytic


def split(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def decoders():
    return (Decoder(8000, mls_convention="auto", device="cpu"),
            JaxDecoder(8000, mls_convention="auto"))


@pytest.mark.parametrize("conv", bits.MLS_CONVENTIONS)
@pytest.mark.parametrize("poly,count", POLYS)
def test_mls_bits_match(conv, poly, count):
    got = bits.mls_bits(poly, count, convention=conv)
    assert np.array_equal(got, jbits.mls_bits(poly, count, convention=conv))
    assert np.array_equal(bits.mls_nrz(poly, count, convention=conv),
                          jbits.mls_nrz(poly, count, convention=conv))


def test_convention_names():
    assert bits.MLS_CONVENTIONS == jbits.MLS_CONVENTIONS
    with pytest.raises(ValueError):
        bits.mls_bits(numerology.MLS0_POLY, 8, convention="lsb")


def test_auto_tables_match_jax(decoders):
    port, ref = decoders
    cfg = dataclasses.replace(make_config(8000, 6), freq_off=0,
                              mls_convention="auto")
    state = build_state(cfg)
    kerns = ref.sync.kerns
    assert state.mls0_kernel.shape == kerns.shape[:2] == (3, 640)
    assert np.allclose(state.mls0_kernel.numpy(),
                       kerns[..., 0] + 1j * kerns[..., 1], atol=1e-6)
    assert np.array_equal(state.mls1_seq.numpy(), ref._mls1_seqs)
    assert state.pilot_fdom is None and state.sc_fdom is None
    assert port.sync.conventions == ref.sync.conventions
    assert np.allclose(port.sync.kernel.numpy(),
                       kerns[..., 0] + 1j * kerns[..., 1], atol=1e-6)
    # the JAX arrays carried across whole
    carried = state_from_numpy(mls0_kernel=kerns, mls1_seq=ref._mls1_seqs)
    assert carried.mls0_kernel.shape == (3, 640)
    assert torch.allclose(carried.mls0_kernel, state.mls0_kernel, atol=1e-6)
    sync = Synchronizer(cfg, "cpu", carried.mls0_kernel)
    assert torch.equal(sync.kernel, carried.mls0_kernel)
    with pytest.raises(ValueError):
        Synchronizer(cfg, "cpu", carried.mls0_kernel[0])


@pytest.mark.parametrize("conv", ["fibonacci", "msb"])
def test_toy_encoder_matches(conv):
    port = Encoder(dataclasses.replace(toy_config(), mls_convention=conv),
                   device="cpu")
    ref = JaxEncoder(dataclasses.replace(jax_toy_config(),
                                         mls_convention=conv))
    assert np.array_equal(port.pilot_fdom.numpy(), ref.pilot_fdom)
    assert np.array_equal(port.sc_fdom.numpy(), ref.sc_fdom)
    assert np.array_equal(port.mls1_seq, ref.mls1_seq)
    rng = np.random.default_rng(41)
    payloads = [rng.integers(0, 256, port.cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(2)]
    call = bits.base37_encode("TOY")
    wave, papr = port.encode_batch(payloads, call)
    jwave, jpapr = ref.encode_batch(payloads, jbits.base37_encode("TOY"))
    assert wave.shape == jwave.shape
    assert np.abs(wave.numpy() - jwave).max() <= 1e-5
    assert np.allclose(papr.numpy(), jpapr, rtol=1e-4)


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("conv", bits.MLS_CONVENTIONS)
def test_auto_scan_ranks_as_jax(decoders, conv, noisy):
    """On the noiseless goldens the bins outside the band hold only
    quantisation noise, and their differential demod (a ratio of two
    such bins, erased past |cons|^2 > 4) turns on the FFT's rounding, so
    the fine stage's second peak does too: the peak ratios of the
    hypotheses differ between torch.fft and the JAX matmul DFT, and two
    hypotheses that JAX ranks close together (fibonacci and msb on the
    fibonacci golden) may rank either way.  There the passing hypotheses
    are held equal as a set; with AWGN at -30 dB (channel.awgn, seed 3)
    the bins carry real noise and the ranking, conv and peak ratios
    (rtol 1e-3) are held to JAX's."""
    port, ref = decoders
    x = golden(conv)
    if noisy:
        x = channel.awgn(x, -30.0, np.random.default_rng(3)).astype(
            np.complex64)
    got = port.sync.scan(x)
    want = ref.sync.scan(split(x))
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert (a.p0, a.ok) == (b.p0, b.ok)
        assert sorted(h[:2] for h in a.alts) == sorted(h[:2] for h in b.alts)
        if not noisy:
            continue
        assert a.conv == b.conv
        assert abs(a.cfo_rad - b.cfo_rad) < 1e-5
        assert [h[:2] for h in a.alts] == [h[:2] for h in b.alts]
        assert np.allclose([h[2] for h in a.alts], [h[2] for h in b.alts],
                           atol=1e-5)
        assert np.allclose([h[3] for h in a.alts], [h[3] for h in b.alts],
                           rtol=1e-3)
    assert any(c.ok for c in got)


@pytest.mark.parametrize("conv", ["fibonacci", "msb"])
def test_auto_decoder_matches_jax(decoders, conv):
    port, ref = decoders
    x = golden(conv)
    got, want = port.decode(x, channels=2), ref.decode(x, channels=2)
    assert got.ok and want.ok, (got.status, want.status)
    sent = np.load(os.path.join(_DATA,
                                "waveform_pin_payload_seed.npy")).tobytes()
    assert got.payload == want.payload == sent
    for key in ("ok", "oper_mode", "call_sign", "symbol_pos", "bit_flips",
                "status", "status_emitted"):
        assert getattr(got, key) == getattr(want, key), key
    assert abs(got.cfo_hz - want.cfo_hz) <= 1e-3
    assert abs(got.sfo_ppm - want.sfo_ppm) <= 1e-3


def test_auto_header_batch_matches_jax(decoders):
    port, ref = decoders
    x = golden("fibonacci")
    cands = [c for c in port.sync.scan(x) if c.ok]
    want_cands = [c for c in ref.sync.scan(split(x)) if c.ok]
    got = port.decode_headers_batch(x, cands)
    assert got == ref.decode_headers_batch(split(x), want_cands)
    assert got[0] == ((6, bits.base37_encode("N0CALL")), "ok")
    for a, b in zip(cands, want_cands):
        assert (a.conv, a.p0, a.alts[0][:2]) == (b.conv, b.p0, b.alts[0][:2])
    assert port.sync.conventions[cands[0].conv] == "fibonacci"


def test_galois_receiver_rejects_fibonacci():
    """A galois-only receiver does not decode the fibonacci recording,
    and says what the JAX one says: the decoder's status and oper_mode,
    the scan's events before the fine stage (the edge walk's (edge,
    n_max) and assemble_events' p0 exact, the phase and frac_cfo within
    1e-6, as test_torch_decoder.py holds them: JAX sums in f32, the port
    in f64), each fed as its package's scan feeds it, and each
    candidate's ok.  The fine-stage p0 of a candidate that fails the gate
    is not compared: it is the event minus the argmax of a correlation
    with no peak (peak ratio ~1, gate 4), which the FFT's rounding
    decides, and the reference holds p0 exact only for frames."""
    x = golden("fibonacci")
    got = Decoder(8000, device="cpu").decode(x, channels=2)
    want = JaxDecoder(8000).decode(x, channels=2)
    assert not got.ok and not want.ok
    assert (got.status, got.oper_mode) == (want.status, want.oper_mode)
    port = Synchronizer(dataclasses.replace(make_config(8000, 6),
                                            freq_off=0), "cpu")
    ref = JaxSynchronizer(dataclasses.replace(jax_make_config(8000, 6),
                                              freq_off=0))
    raw = port._events_device(port.recording(x), port.CHUNK_SMALL, 4 * 8)
    raw_ref, _ = ref._events_device(split(x), ref.CHUNK_SMALL, 4 * 8)
    assert raw and [e[:2] for e in raw] == [e[:2] for e in raw_ref]
    assert np.allclose([e[2] for e in raw], [e[2] for e in raw_ref],
                       atol=1e-6)
    events, events_ref = port.assemble_events(raw), ref.assemble_events(
        raw_ref)
    assert [e[0] for e in events] == [e[0] for e in events_ref]
    assert np.allclose([e[1] for e in events], [e[1] for e in events_ref],
                       atol=1e-6)
    cands, want_cands = port.scan(x), ref.scan(split(x))
    assert [c.ok for c in cands] == [c.ok for c in want_cands]
    assert not any(c.ok for c in cands)
