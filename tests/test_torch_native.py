"""The port's native host runtime (csrc/modem_host.cc through
modem_tpu_torch.native) against the JAX package's (native/modem_host.cc
through modem_tpu.native) and against the port's numpy plain versions.

Both libraries build here with the host C++ compiler.  Compared exactly:
scramble and CRC-16/32 on random lengths (0 and 1 byte included), LE
bit packing, and WAV files at 8 and 16 bits, 1 and 2 channels, written
byte for byte as JAX's ``native.wav_write`` writes them, exact
quantisation ties included, and read back to the same floats.  The
numpy codec (``wav._quantize``, ties to even in f64) is the plain
version: within 1 LSB of the native one, equal away from ties.  A
missing compiler raises instead of falling back to numpy.
"""

import numpy as np
import pytest

from modem_tpu import bits as jbits
from modem_tpu import native as jnative
from modem_tpu import wav as jwav
from modem_tpu_torch import bits, native, wav
from modem_tpu_torch.kernels import _build
from modem_tpu_torch.numerology import CRC16_POLY, CRC32_POLY

LENGTHS = [0, 1, 2, 7, 255, 5380]


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX package's library builds here; without it these tests
    would compare against its numpy fallback."""
    assert jnative.available()


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_scramble_matches(n):
    data = _data(n, n)
    got = bits.scramble(data)
    assert got == native.scramble(data) == jnative.scramble(data)
    assert got == bits.scramble_np(data) == jbits.scramble(data)
    assert bits.scramble(got) == data
    assert native.scramble(data, seed=12345) == jnative.scramble(data,
                                                                 seed=12345)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("poly,width", [(CRC16_POLY, 16), (CRC32_POLY, 32)])
def test_crc_matches(n, poly, width):
    data = _data(n, 100 + n)
    crc = bits.Crc(poly, width)
    for reg in (0, 0x1234, crc.mask):
        want = jnative.crc_bytes(poly, data, reg) & crc.mask
        assert crc.update_bytes(reg, data) == want
        assert crc.update_bytes_np(reg, data) == want
        assert native.crc_bytes(poly, data, reg) == jnative.crc_bytes(
            poly, data, reg)
    assert bits.payload_crc32(data) == jbits.payload_crc32(data)


@pytest.mark.parametrize("n", LENGTHS)
def test_le_packing_matches(n):
    data = _data(n, 200 + n)
    got = native.bytes_to_bits_le(data)
    assert np.array_equal(got, jnative.bytes_to_bits_le(data))
    assert np.array_equal(got, bits.bytes_to_bits_le(data))
    odd = np.random.default_rng(n).integers(0, 2, 8 * n + 3, dtype=np.uint8)
    assert native.bits_to_bytes_le(odd) == jnative.bits_to_bytes_le(odd) \
        == bits.bits_to_bytes_le(odd)
    assert native.bits_to_bytes_le(got) == data


def _signal(bits_):
    """Seeded complex samples with exact quantisation ties: steps of half
    an LSB, both signs, the clip edges and beyond."""
    full = 32767.0 if bits_ == 16 else 127.0
    rng = np.random.default_rng(bits_)
    ties = (rng.integers(-int(full) - 2, int(full) + 2, 600) + 0.5) / full
    edges = np.array([1.0, -1.0, 1.5, -1.5, 0.0, 0.5 / full, -0.5 / full,
                      (full + 0.5) / full, -(full + 1.5) / full])
    noise = 0.7 * rng.standard_normal(1000)
    re = np.concatenate([ties, edges, noise])
    return re + 1j * rng.permutation(re)


@pytest.mark.parametrize("bits_", [8, 16])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_files_match_jax(tmp_path, bits_, channels):
    sig = _signal(bits_)
    port_path, jax_path, raw_path = (str(tmp_path / n) for n in
                                     ("p.wav", "j.wav", "n.wav"))
    wav.write_wav(port_path, sig, 8000, bits_, channels)
    jwav.write_wav(jax_path, sig, 8000, bits_, channels)
    flat = np.stack([sig.real, sig.imag], axis=-1)[:, :channels]
    assert jnative.wav_write(raw_path, flat.astype(np.float32), 8000,
                             channels, bits_)
    blob = open(port_path, "rb").read()
    assert blob == open(jax_path, "rb").read() == open(raw_path, "rb").read()

    got, want = wav.read_wav(port_path), jwav.read_wav(port_path)
    assert (got.rate, got.channels, got.bits) == (want.rate, want.channels,
                                                  want.bits) == (
        8000, channels, bits_)
    assert got.samples.dtype == np.float32
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.analytic, want.analytic)

    # the plain numpy codec: the same header, each sample within 1 LSB,
    # equal wherever the scaled value is not a tie
    plain = wav._quantize(flat.reshape(-1).astype(np.float64), bits_)
    dt = np.dtype("<i2") if bits_ == 16 else np.uint8
    q_nat = np.frombuffer(blob[44:], dtype=dt).astype(np.int64)
    q_np = np.frombuffer(plain, dtype=dt).astype(np.int64)
    assert np.abs(q_nat - q_np).max() <= 1
    full = 32767.0 if bits_ == 16 else 127.0
    scaled = flat.reshape(-1).astype(np.float32) * np.float32(full)
    tie = np.abs(np.abs(scaled) % 1 - 0.5) < 1e-3
    assert tie.sum() > 100
    assert np.array_equal(q_nat[~tie], q_np[~tie])


def test_wav_refusals_match_jax(tmp_path):
    """What the native codec refuses takes the numpy path, which raises
    as the JAX package's does."""
    for mod in (wav, jwav):
        with pytest.raises(ValueError, match="unsupported bit depth 24"):
            mod.write_wav(str(tmp_path / "x.wav"), np.zeros(4), 8000, 24)
        (tmp_path / "bad.wav").write_bytes(b"RIFX" + bytes(40))
        with pytest.raises(ValueError, match="not a RIFF/WAVE file"):
            mod.read_wav(str(tmp_path / "bad.wav"))
        with pytest.raises(FileNotFoundError):
            mod.write_wav(str(tmp_path / "no" / "x.wav"), np.zeros(4), 8000)
    assert native.wav_read(str(tmp_path / "bad.wav")) is None


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """With no library built and no compiler, scramble, the CRC and the
    WAV codec raise RuntimeError; nothing falls back to numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_CXX", "no-such-c++")
    _build.load_host.cache_clear()
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
            bits.scramble(b"abc")
        with pytest.raises(RuntimeError):
            bits.crc32.over_bytes(b"abc")
        with pytest.raises(RuntimeError):
            wav.write_wav(str(tmp_path / "x.wav"), np.zeros(4), 8000)
        assert not (tmp_path / "x.wav").exists()
    finally:
        monkeypatch.undo()
        _build.load_host.cache_clear()
        native.library.cache_clear()
    assert bits.scramble(b"abc") == bits.scramble_np(b"abc")


def test_build_failure_reports_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's text."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cc").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cc"):
        _build.load_host.__wrapped__("broken")
