"""The port's encoder against the JAX package's, and the wire-format pin.

Toy size: the same payloads through both encoders' batch paths, the
continuous ``encode`` and the int16 batch; ``synthesize_carry`` over any
split.  Wire size: a two-frame ``encode`` against the JAX package's.  Wire
size (port only, no JAX on the path): the mode-6 fingerprint of
tests/data/waveform_pin_mode6_galois.npy, held to the rule of
tests/test_waveform_pin.py (|diff| <= 1 LSB on < 0.5 % of samples).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu.encoder import Encoder as JaxEncoder
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu_torch import bits, ofdm
from modem_tpu_torch.encoder import Encoder, blocked_cumsum, cached_encoder
from modem_tpu_torch.numerology import make_config, toy_config

_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def toy_pair():
    return Encoder(toy_config(), device="cpu"), JaxEncoder(jax_toy_config())


def test_constants_match(toy_pair):
    port, ref = toy_pair
    assert np.array_equal(port.pilot_fdom.numpy(), ref.pilot_fdom)
    assert np.array_equal(port.sc_fdom.numpy(), ref.sc_fdom)
    assert np.array_equal(port.mls1_seq, ref.mls1_seq)
    assert np.array_equal(port.pilot_phase.numpy(), ref.pilot_phase)
    call = bits.base37_encode("TOY")
    assert np.array_equal(port.meta_fdom(call), ref.meta_fdom(call))
    payload = bytes(range(port.cfg.mode.data_bytes))
    assert np.array_equal(port.mesg_bits(payload), ref.mesg_bits(payload))


@pytest.mark.parametrize("n", [3, 16, 50, 70])
def test_blocked_cumsum_matches_jax_cumsum(n):
    """The phase accumulation sums in jnp.cumsum's order: bit-equal."""
    rng = np.random.default_rng(n)
    theta = (rng.integers(-4, 4, (2, n, 40)) * (np.pi / 4)
             + np.pi / 8).astype(np.float32)
    got = blocked_cumsum(torch.from_numpy(theta)).numpy()
    assert np.array_equal(got, np.asarray(jnp.cumsum(theta, axis=1)))


def test_toy_encode_batch_matches(toy_pair):
    port, ref = toy_pair
    rng = np.random.default_rng(31)
    payloads = [rng.integers(0, 256, port.cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(3)]
    call = bits.base37_encode("TOY")
    wave, papr = port.encode_batch(payloads, call)
    jwave, jpapr = ref.encode_batch(payloads, jbits.base37_encode("TOY"))
    assert wave.shape == jwave.shape and wave.dtype == torch.complex64
    # f32 rounding of the FFTs (torch.fft vs the JAX matmul DFT)
    assert np.abs(wave.numpy() - jwave).max() <= 1e-5
    assert np.allclose(papr.numpy(), jpapr, rtol=1e-4)


def test_encoder_rejects_what_waits():
    cfg = toy_config()
    import dataclasses
    with pytest.raises(ValueError):
        Encoder(dataclasses.replace(cfg, mls_convention="auto"),
                device="cpu")
    assert Encoder(dataclasses.replace(cfg, mls_convention="msb"),
                   device="cpu").cfg.mls_convention == "msb"
    with pytest.raises(ValueError):
        Encoder(dataclasses.replace(cfg, mls_convention="lsb"),
                device="cpu")
    with pytest.raises(ValueError):
        Encoder(cfg, device="cpu").mesg_bits(b"short")


def test_mode6_waveform_fingerprint():
    """The port's wire-size encode against the frozen transmit
    fingerprint (same rule as tests/test_waveform_pin.py)."""
    pin = np.load(os.path.join(_DATA, "waveform_pin_mode6_galois.npy"))
    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    enc = Encoder(make_config(8000, 6, 2000), device="cpu")
    wave, _ = enc.encode_batch([payload], bits.base37_encode("N0CALL"))
    wave = wave[0].numpy()
    q = np.clip(np.rint(wave.real * 32767.0), -32768, 32767).astype(np.int16)
    qi = np.clip(np.rint(wave.imag * 32767.0), -32768,
                 32767).astype(np.int16)
    fp = np.stack([q[::97], qi[::97]])
    assert fp.shape == pin.shape
    diff = np.abs(fp.astype(np.int32) - pin.astype(np.int32))
    assert diff.max() <= 1, f"waveform changed (max LSB diff {diff.max()})"
    frac = float((diff > 0).mean())
    assert frac < 0.005, f"waveform changed ({frac:.2%} samples differ)"


@pytest.mark.parametrize("split", [1, 2, 5])
def test_synthesize_carry_any_split(toy_pair, split):
    """Two synthesize_carry calls, the head carried across ``split``,
    give synthesize's samples and PAPR over the whole spectrum stack."""
    port, _ = toy_pair
    rng = np.random.default_rng(split)
    n = port.cfg.symbol_len
    g = port.cfg.guard_len
    fdom = torch.from_numpy((rng.standard_normal((7, n))
                             + 1j * rng.standard_normal((7, n))).astype(
        np.complex64))
    mask = np.arange(7) % 3 != 0
    wave, papr = ofdm.synthesize(fdom, g, mask)
    w1, p1, head = ofdm.synthesize_carry(fdom[:split], g, mask[:split])
    w2, p2, last = ofdm.synthesize_carry(fdom[split:], g, mask[split:], head)
    assert torch.equal(torch.cat([w1, w2]), wave)
    assert torch.equal(torch.cat([p1, p2]), papr)
    assert torch.equal(last, w2[-n:][:g])


@pytest.mark.parametrize("frames", [1, 2, 9])
def test_toy_encode_matches_jax(toy_pair, frames):
    """The continuous transmission of 1, 2 and 9 frames (9 crosses a
    synthesis chunk of 8) equals the JAX package's within 1e-5."""
    port, ref = toy_pair
    rng = np.random.default_rng(40 + frames)
    payloads = [rng.integers(0, 256, port.cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(frames)]
    one = payloads[0] if frames == 1 else payloads
    wave, papr = port.encode(one, bits.base37_encode("TOY"))
    jwave, jpapr = ref.encode(one, jbits.base37_encode("TOY"))
    assert isinstance(wave, np.ndarray) and wave.dtype == np.complex64
    assert wave.shape == jwave.shape and papr.shape == jpapr.shape
    cfg = port.cfg
    assert len(wave) == (frames * cfg.frame_symbols + 2) * cfg.extended_len
    assert np.abs(wave - jwave).max() <= 1e-5
    assert np.allclose(papr, jpapr, rtol=1e-4)


def test_encode_does_not_depend_on_chunking(toy_pair, monkeypatch):
    port, _ = toy_pair
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 256, port.cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(5)]
    call = bits.base37_encode("TOY")
    wave, papr = port.encode(payloads, call)
    monkeypatch.setattr(port, "ENCODE_CHUNK_FRAMES", 2)
    wave2, papr2 = port.encode(payloads, call)
    assert np.array_equal(wave, wave2) and np.array_equal(papr, papr2)


def test_wire_encode_two_frames_matches_jax():
    """Mode 6 at 8 kHz, two frames: the port's encode equals the JAX
    package's within 1e-5 (PAPR within rtol 1e-4)."""
    from modem_tpu.encoder import cached_encoder as jax_cached_encoder
    from modem_tpu.numerology import make_config as jax_make_config
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
                for _ in range(2)]
    wave, papr = cached_encoder(make_config(8000, 6, 2000), "cpu").encode(
        payloads, bits.base37_encode("N0CALL"))
    jwave, jpapr = jax_cached_encoder(jax_make_config(8000, 6, 2000)).encode(
        payloads, jbits.base37_encode("N0CALL"))
    assert wave.shape == jwave.shape
    assert np.abs(wave - jwave).max() <= 1e-5
    assert np.allclose(papr, jpapr, rtol=1e-4)


def test_toy_encode_batch_pcm16_matches_jax(toy_pair):
    """encode_batch(pcm_bits=16): int16 I/Q within 1 LSB of the JAX
    package's quantised batch."""
    port, ref = toy_pair
    rng = np.random.default_rng(33)
    payloads = [rng.integers(0, 256, port.cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(3)]
    q, papr = port.encode_batch(payloads, bits.base37_encode("TOY"),
                                pcm_bits=16)
    jq, jpapr = ref.encode_batch(payloads, jbits.base37_encode("TOY"),
                                 pcm_bits=16)
    assert q.dtype == torch.int16 and q.shape == jq.shape
    diff = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1
    assert np.allclose(papr.numpy(), jpapr, rtol=1e-4)
    wave, _ = port.encode_batch(payloads, bits.base37_encode("TOY"))
    want = np.clip(np.rint(np.stack([wave.real.numpy(), wave.imag.numpy()],
                                    -1) * 32767.0), -32768, 32767)
    assert np.array_equal(q.numpy(), want.astype(np.int16))
    with pytest.raises(ValueError):
        port.encode_batch(payloads, 1, pcm_bits=8)


def test_cached_encoder_is_shared():
    cfg = make_config(8000, 6, 2000)
    assert cached_encoder(cfg, "cpu") is cached_encoder(cfg, "cpu")
