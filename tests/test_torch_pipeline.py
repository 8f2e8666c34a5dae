"""The port's BatchPipeline(list_size=1) against the JAX package's, end
to end on toy recordings, and on the frozen mode-6 golden recording.

Same numpy recordings (JAX toy encoder plus seeded noise) into both.
Exact: ok, bits, p0, flips, sync_gate, multiframe.  cfo_rad within 1e-5
rad/sample; snr within 1e-3 relative on noisy batches (on clean ones
the noise power is ~0 and the estimate is fragile by nature).
"""

import os
import wave

import numpy as np
import pytest
import torch

from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_recordings
from modem_tpu.pipeline import BatchPipeline as JaxBatchPipeline
from modem_tpu_torch.numerology import toy_config
from modem_tpu_torch.pipeline import BatchPipeline

_DATA = os.path.join(os.path.dirname(__file__), "data")
EXACT_KEYS = ("ok", "bits", "p0", "flips", "sync_gate", "multiframe")


def toy_port(**kw):
    cfg = toy_config()
    return BatchPipeline(rate=cfg.rate, oper_mode=0, mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len, **kw)


@pytest.fixture(scope="module")
def pipes():
    cfg = jax_toy_config()
    ref = JaxBatchPipeline(rate=cfg.rate, oper_mode=0, list_size=1,
                           mode_spec=cfg.mode,
                           symbol_len_override=cfg.symbol_len)
    return toy_port(), ref


@pytest.fixture(scope="module")
def batches():
    recs, payloads = toy_recordings(8, seed=3)
    recs = np.asarray(recs)
    rng = np.random.default_rng(42)
    out = {0.0: recs}
    for sigma in (0.05, 0.3):
        out[sigma] = recs + sigma * rng.standard_normal(recs.shape).astype(
            np.float32)
    return out, payloads


@pytest.fixture(scope="module")
def results(pipes, batches):
    port, ref = pipes
    recs, _ = batches
    return {sigma: ({k: v.numpy() for k, v in port.decode_batch(x).items()},
                    {k: np.asarray(v) for k, v in ref.decode_batch(x).items()})
            for sigma, x in recs.items()}


@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.3])
def test_matches_jax_pipeline(results, sigma):
    got, want = results[sigma]
    assert set(got) == set(want)
    for key in EXACT_KEYS:
        assert np.array_equal(got[key], want[key].astype(got[key].dtype)), key
    assert np.abs(got["cfo_rad"] - want["cfo_rad"]).max() <= 1e-5
    if sigma > 0:
        assert np.allclose(got["snr"], want["snr"], rtol=1e-3)


@pytest.mark.parametrize("sigma", [0.05, 0.3])
def test_demod_matches_jax_demod(pipes, batches, sigma):
    """The front end alone: the port's batched demod against the JAX
    _demod_one under vmap.  p0 and the gates exactly; LLR signs exactly;
    LLR values to f32 rounding of the FFTs, relative to the largest
    channel LLR (the shortened positions carry the 9000 known-bit LLR)."""
    import jax
    import jax.numpy as jnp

    port, ref = pipes
    x = batches[0][sigma]
    got = port.demod(x)
    want = jax.jit(jax.vmap(ref._demod_one))(jnp.asarray(x))
    for key in ("p0", "sync_gate", "multiframe"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    llr_g, llr_w = got["llrs"].numpy(), np.asarray(want["llrs"])
    assert llr_g.shape == llr_w.shape
    assert np.array_equal(np.sign(llr_g), np.sign(llr_w))
    scale = np.abs(llr_w[llr_w < 9000]).max()
    assert np.abs(llr_g - llr_w).max() <= 1e-3 * scale
    assert np.allclose(got["snr"].numpy(), np.asarray(want["snr"]),
                       rtol=1e-3)


def test_noise_points_cover_failures(results, batches):
    """Clean and sigma 0.05 decode every frame byte-exact; at sigma 0.3
    plain SC loses some frames (ok=False), and the parity above holds
    on both kinds."""
    _, payloads = batches
    port = toy_port()
    for sigma in (0.0, 0.05):
        got, _ = results[sigma]
        assert got["ok"].all()
        assert all(port.payload_bytes(got, i) == p
                   for i, p in enumerate(payloads))
    assert not results[0.3][0]["ok"].all()
    assert results[0.3][0]["ok"].any()


def test_fetch_matches_jax_fetch(pipes, batches):
    port, ref = pipes
    x = batches[0][0.3]
    got = port.fetch(port.decode_batch(x))
    want = ref.fetch(ref.decode_batch(x))
    assert set(got) == set(want)
    for key in ("ok", "flips", "p0", "sync_gate", "bits"):
        assert np.array_equal(got[key], want[key]), key
    assert np.abs(got["cfo_rad"] - want["cfo_rad"]).max() <= 1e-5
    assert got["bits"].shape == (8, toy_config().mode.data_bits)


def test_input_layouts_agree(pipes, batches):
    """Split-complex [B, T, 2] numpy, complex numpy and complex tensors
    decode alike."""
    port, _ = pipes
    x = batches[0][0.05][:2]
    c = x[..., 0] + 1j * x[..., 1]
    a = port.decode_batch(x)
    for other in (c.astype(np.complex64), torch.from_numpy(c)):
        b = port.decode_batch(other)
        assert all(torch.equal(a[k], b[k]) for k in EXACT_KEYS)


def test_multiframe_recording_flagged(pipes, batches):
    port, _ = pipes
    one = batches[0][0.0][0]
    two = np.concatenate([one, batches[0][0.0][1]], axis=0)
    batch = np.stack([two, np.concatenate([one, np.zeros_like(one)])])
    flag = port.decode_batch(batch)["multiframe"].numpy()
    assert flag[0] and not flag[1]


def test_strided_sync_matches_full_rate(batches):
    full = toy_port(sync_stride=1)
    strided = toy_port()
    assert (full.sync_stride, strided.sync_stride) == (1, 8)
    for sigma in (0.0, 0.05):
        a = full.decode_batch(batches[0][sigma])
        b = strided.decode_batch(batches[0][sigma])
        for key in ("ok", "bits", "p0"):
            assert torch.equal(a[key], b[key]), key


def test_options_that_wait_raise():
    with pytest.raises(NotImplementedError):
        toy_port(list_size=8)
    with pytest.raises(NotImplementedError):
        toy_port(mls_convention="fibonacci")
    with pytest.raises(ValueError):
        toy_port(mls_convention="auto")


def test_sync_stride_fallback_when_indivisible():
    """44.1 kHz has match_del = 441: stride 8 falls back to full rate."""
    assert BatchPipeline(44100, 6).sync_stride == 1
    assert BatchPipeline(8000, 6).sync_stride == 8


def read_golden(name="golden_mode6_galois.wav"):
    with wave.open(os.path.join(_DATA, name)) as f:
        assert (f.getframerate(), f.getnchannels(),
                f.getsampwidth()) == (8000, 2, 2)
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0          # wav.hh dequantisation
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def test_golden_recording_decodes():
    """The frozen mode-6 recording decodes byte-exact through the port's
    wire-size pipeline on the CPU (plain SC path, no JAX)."""
    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    pipe = BatchPipeline(8000, 6)
    res = pipe.fetch(pipe.decode_batch(read_golden()[None]))
    assert res["ok"][0] and res["sync_gate"][0]
    assert res["flips"][0] == 0
    assert abs(res["cfo_rad"][0] * 8000 / (2 * np.pi) - 2000.0) < 1.0
    assert pipe.payload_bytes(res, 0) == payload


@pytest.mark.slow
def test_wire_demod_matches_jax():
    """Wire-size front end, JAX _demod_one against the port's demod on
    the golden recording plus noise: LLR signs and sync exact, LLRs to
    f32 rounding."""
    import jax
    import jax.numpy as jnp

    x = read_golden()
    rng = np.random.default_rng(5)
    noisy = x + (0.05 * (rng.standard_normal(x.shape)
                         + 1j * rng.standard_normal(x.shape))).astype(
        np.complex64)
    recs = np.stack([x, noisy])
    split = np.stack([recs.real, recs.imag], axis=-1).astype(np.float32)
    ref = JaxBatchPipeline(8000, 6, list_size=1)
    want = jax.jit(jax.vmap(ref._demod_one))(jnp.asarray(split))
    got = BatchPipeline(8000, 6).demod(recs)
    for key in ("p0", "sync_gate", "multiframe"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    llr_w = np.asarray(want["llrs"])
    llr_g = got["llrs"].numpy()
    assert np.array_equal(np.sign(llr_g), np.sign(llr_w))
    assert np.allclose(llr_g, llr_w, rtol=1e-3, atol=1e-2 * np.abs(
        llr_w[llr_w < 9000]).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SC kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_decode_matches_cpu(cuda_device, batches):
    """The whole toy pipeline on the card, through the CUDA SC kernel,
    against the CPU run of the same batch."""
    from modem_tpu_torch.kernels.sc_decode import sc_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = toy_port()
    card = toy_port(device=cuda_device)
    x = batches[0][0.3]
    before = sc_decode.launches
    got = card.fetch(card.decode_batch(x))
    assert sc_decode.launches == before + 1
    want = cpu.fetch(cpu.decode_batch(x))
    for key in ("ok", "bits", "p0", "flips", "sync_gate"):
        assert np.array_equal(got[key], want[key]), key
