"""The port's encoder against the JAX package's, and the wire-format pin.

Toy size: the same payloads through both encoders' batch paths.  Wire
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
from modem_tpu_torch import bits
from modem_tpu_torch.encoder import Encoder, blocked_cumsum
from modem_tpu_torch.numerology import make_config, toy_config

_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def toy_pair():
    return Encoder(toy_config()), JaxEncoder(jax_toy_config())


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
        Encoder(dataclasses.replace(cfg, mls_convention="auto"))
    with pytest.raises(NotImplementedError):
        Encoder(dataclasses.replace(cfg, mls_convention="msb"))
    with pytest.raises(ValueError):
        Encoder(cfg).mesg_bits(b"short")


def test_mode6_waveform_fingerprint():
    """The port's wire-size encode against the frozen transmit
    fingerprint (same rule as tests/test_waveform_pin.py)."""
    pin = np.load(os.path.join(_DATA, "waveform_pin_mode6_galois.npy"))
    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    enc = Encoder(make_config(8000, 6, 2000))
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
