"""The port's live stream decoder against the JAX package's, and against
the port's own decode_recording_auto.

The recordings are tests/test_stream.py's, made by the port's encoder
from the same seeds: two mode-10 frames (seed 31, call sign AB1CDE,
offset 2300) between 1 s of silence, one mode-10 frame at 16 kHz (seed
13), and a mode-10 then a mode-12 frame (seed 9).  The port's
``StreamDecoder`` equals JAX's ``StreamDecoder`` on the two-frame
recording as mono int16 (computed once for the module); the other cases
hold the stream to the port's ``decode_recording_auto`` on the same
samples, which tests/test_torch_recording.py pins to the JAX package.
Exact on every key but ``snr``, which is held within 1e-4.
"""

import numpy as np
import pytest

from modem_tpu.stream import StreamDecoder as JaxStreamDecoder
from modem_tpu_torch import bits as B
from modem_tpu_torch.encoder import cached_encoder
from modem_tpu_torch.ingest import PcmRecording
from modem_tpu_torch.numerology import make_config
from modem_tpu_torch.pipeline import decode_recording_auto
from modem_tpu_torch.stream import StreamDecoder

SNR_TOL = 1e-4
EXACT = ("pos", "mode", "call_sign", "ok", "payload", "flips", "status")


def same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert [a[k] for k in EXACT] == [b[k] for k in EXACT]
        if b["snr"] is None:
            assert a["snr"] is None
        else:
            assert np.allclose(a["snr"], b["snr"], rtol=0, atol=SNR_TOL)


def feed_all(sd, x, step, stop=None):
    """Feed x[:stop] in blocks of ``step``, then finish; returns (frames
    in time order, samples fed when the first frame came out, the
    buffer's origin when each frame came out)."""
    stop = len(x) if stop is None else stop
    got, first, origins = [], None, []
    for i in range(0, stop, step):
        out = sd.feed(x[i: min(i + step, stop)])
        if out and first is None:
            first = min(i + step, stop)
        if isinstance(sd, StreamDecoder):
            origins += [sd.buf.origin] * len(out)
        got += out
    got += sd.finish()
    return sorted(got, key=lambda f: f["pos"]), first, origins


def quantise(x, bits=16):
    if bits == 16:
        return np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)
    return (np.clip(np.rint(x * 127), -128, 127) + 128).astype(np.uint8)


def frames_of(mode, rate, seed, n, call="AB1CDE", offset=2300):
    rng = np.random.default_rng(seed)
    cfg = make_config(rate, mode, offset)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(n)]
    wave, _ = cached_encoder(cfg, "cpu").encode(payloads,
                                                B.base37_encode(call))
    return wave, payloads


@pytest.fixture(scope="module")
def two_frame():
    wave, payloads = frames_of(10, 8000, 31, 2)
    sil = np.zeros(8000, np.complex64)
    rec = np.concatenate([sil, wave, sil])
    return rec, payloads


@pytest.fixture(scope="module")
def inputs(two_frame):
    """The two-frame recording as each kind of stream input, with the
    port's decode_recording_auto of the same samples."""
    rec, _ = two_frame
    iq = np.stack([rec.real, rec.imag], 1).astype(np.float32)
    made = {"float": (iq, None, 2, iq),
            "mono16": (quantise(rec.real), 16, 1, None),
            "stereo16": (quantise(iq), 16, 2, None),
            "mono8": (quantise(rec.real, 8), 8, 1, None)}
    out = {}
    for name, (x, bits, ch, analytic) in made.items():
        src = analytic if bits is None else PcmRecording(data=x, bits=bits,
                                                         rate=8000)
        out[name] = (x, bits, ch, decode_recording_auto(
            src, 8000, channels=ch, device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_pair(inputs):
    """JAX's StreamDecoder and the port's on the mono int16 recording,
    fed 8,000 samples at a time."""
    x, _, _, _ = inputs["mono16"]
    want, _, _ = feed_all(JaxStreamDecoder(8000, channels=1, bits=16), x,
                          8000)
    got, _, _ = feed_all(StreamDecoder(8000, channels=1, bits=16,
                                       device="cpu"), x, 8000)
    return got, want


def test_stream_matches_jax_stream(jax_pair, two_frame):
    got, want = jax_pair
    _, payloads = two_frame
    same_frames(got, want)
    assert [f["payload"] for f in got] == payloads
    assert all(f["ok"] and f["mode"] == 10 and f["call_sign"] == "AB1CDE"
               for f in got)


@pytest.mark.parametrize("step", [7001, 8192, 9000])
def test_feed_sizes_give_one_result(inputs, two_frame, step):
    """Mono int16 fed in blocks of 7,001, 8,192 and 9,000 samples: the
    frames of decode_recording_auto, emitted live (frame 0 before the
    stream's last 8,000 samples), with the buffer bounded."""
    x, _, _, ref = inputs["mono16"]
    sd = StreamDecoder(8000, channels=1, bits=16, device="cpu")
    got, first, _ = feed_all(sd, x, step)
    same_frames(got, ref)
    assert [f["payload"] for f in got] == two_frame[1]
    assert first is not None and first < len(x) - 8000
    assert sd.buf.data.shape[0] < 4 * sd.c
    assert sd.peak_buffered < 80_000


def test_frame_after_retirement_keeps_dc_index(inputs):
    """The DC block's count clamps at the absolute stream start: the
    second frame, which arrives after retirement moved the buffer's
    origin, decodes exactly as in decode_recording_auto."""
    x, _, _, ref = inputs["mono16"]
    sd = StreamDecoder(8000, channels=1, bits=16, device="cpu")
    got, _, origins = feed_all(sd, x, 4096)
    assert origins[1] > 0
    same_frames(got, ref)


@pytest.mark.parametrize("name,step", [("float", 7001), ("stereo16", 9000),
                                       ("mono8", 9000)])
def test_stream_inputs_match_batch(inputs, two_frame, name, step):
    """Float I/Q, stereo int16 (dequantised on the device, no Hilbert)
    and mono uint8 (silence 128)."""
    x, bits, ch, ref = inputs[name]
    sd = StreamDecoder(8000, channels=ch, bits=bits, device="cpu")
    got, first, _ = feed_all(sd, x, step)
    same_frames(got, ref)
    assert [f["payload"] for f in got] == two_frame[1]
    assert first < len(x) - 8000


def test_stream_complex_input(inputs, two_frame):
    """A complex stream is the float I/Q stream."""
    rec, _ = two_frame
    _, _, _, ref = inputs["float"]
    got, _, _ = feed_all(StreamDecoder(8000, bits=None, device="cpu"), rec,
                         8192)
    same_frames(got, ref)


@pytest.mark.parametrize("name", ["float", "mono16"])
def test_one_big_feed(inputs, name):
    """The whole recording in one feed: every chunk ready at once."""
    x, bits, ch, ref = inputs[name]
    sd = StreamDecoder(8000, channels=ch, bits=bits, device="cpu")
    got = sd.feed(x) + sd.finish()
    same_frames(got, ref)


def test_stream_16k_mono():
    wave, payloads = frames_of(10, 16000, 13, 1)
    sil = np.zeros(16000, np.complex64)
    mono = quantise(np.concatenate([sil, wave, sil]).real)
    ref = decode_recording_auto(PcmRecording(data=mono, bits=16, rate=16000),
                                16000, channels=1, device="cpu")
    got, _, _ = feed_all(StreamDecoder(16000, channels=1, bits=16,
                                       device="cpu"), mono, 17000)
    same_frames(got, ref)
    assert got[0]["ok"] and got[0]["payload"] == payloads[0]


def test_stream_mixed_modes():
    """A mode-10 and a mode-12 frame: each frame's mode from its own
    header, the payloads grouped by mode."""
    rng = np.random.default_rng(9)
    waves, payloads = [], []
    for mode, call in ((10, "AB1CDE"), (12, "N0CALL")):
        cfg = make_config(8000, mode, 2000)
        p = rng.integers(0, 256, cfg.mode.data_bytes, dtype=np.uint8).tobytes()
        w, _ = cached_encoder(cfg, "cpu").encode(p, B.base37_encode(call))
        waves.append(w)
        payloads.append(p)
    gap = np.zeros(2000, np.complex64)
    rec = np.concatenate([gap, waves[0], gap, waves[1], gap])
    ref = decode_recording_auto(rec, 8000, device="cpu")
    x = np.stack([rec.real, rec.imag], 1).astype(np.float32)
    got, _, _ = feed_all(StreamDecoder(8000, bits=None, device="cpu"), x,
                         8192)
    same_frames(got, ref)
    assert [(f["mode"], f["call_sign"], f["payload"]) for f in got] == [
        (10, "AB1CDE", payloads[0]), (12, "N0CALL", payloads[1])]


def test_truncated_frame_is_past_recording_end(inputs, two_frame):
    """A stream cut in the second frame's payload: that frame is reported
    "past recording end" with its mode known, never decoded against the
    silence pad (decode.cc:296-297)."""
    x, _, _, _ = inputs["float"]
    cfg = make_config(8000, 10, 2300)
    cut = 8000 + cfg.extended_len + cfg.frame_samples + 4 * cfg.extended_len
    got, _, _ = feed_all(StreamDecoder(8000, bits=None, device="cpu"), x,
                         7001, stop=cut)
    assert len(got) == 2
    assert got[0]["ok"] and got[0]["payload"] == two_frame[1][0]
    assert not got[1]["ok"] and got[1]["status"] == "past recording end"
    assert got[1]["mode"] == 10 and got[1]["call_sign"] == "AB1CDE"


def test_stream_rejects_bad_input():
    with pytest.raises(ValueError):
        StreamDecoder(8000, channels=1, bits=None, device="cpu")
    with pytest.raises(ValueError):
        StreamDecoder(11025, channels=1, bits=16, device="cpu")
    sd = StreamDecoder(8000, channels=1, bits=16, device="cpu")
    with pytest.raises(ValueError):
        sd.feed(np.zeros(10, np.float32))
    with pytest.raises(ValueError):
        sd.feed(np.zeros((10, 2), np.int16))
    assert sd.finish() == [] and sd.finish() == []
    with pytest.raises(RuntimeError):
        sd.feed(np.zeros(10, np.int16))


def test_silent_stream_retires():
    """A long stream with no event holds a bounded buffer: retirement
    follows the scan even when nothing is pending."""
    sd = StreamDecoder(8000, channels=1, bits=16, device="cpu")
    block = np.zeros(sd.c, np.int16)
    for _ in range(40):
        assert sd.feed(block) == []
    assert sd.chunks >= 38
    assert sd.buf.data.shape[0] < 4 * sd.c
    assert sd.buf.origin > 30 * sd.c
    assert sd.finish() == []


def test_chunk_step_over_a_retiring_buffer(inputs):
    """Synchronizer.chunk_step walked over a StreamBuffer that receives
    the samples block by block and retires what the scan has passed
    gives the events of the same walk over the whole PcmRecording, bit
    for bit (absolute positions, the DC count clamped at the stream
    start); reading a retired sample raises."""
    from modem_tpu_torch.decoder import cached_decoder
    from modem_tpu_torch.ingest import StreamBuffer
    x, _, _, _ = inputs["mono16"]
    sync = cached_decoder(8000, device="cpu").sync
    c, ctx = sync._context(8192)
    pcm = PcmRecording(data=x, bits=16, rate=8000)
    buf = StreamBuffer(16, 1)
    n_out = len(x) - 2 * sync.L
    whole, part = sync.scan_start(), sync.scan_start()
    got, want = [], []
    for n0 in range(0, n_out, c):
        buf.append(x[buf.end: n0 + c + 2 * sync.L])
        ev, whole = sync.chunk_step(pcm, n0, c, ctx, whole, n_out)
        want += ev
        ev, part = sync.chunk_step(buf, n0, c, ctx, part, n_out)
        got += ev
        buf.retire(n0 + c - ctx - sync.front_lead)
    assert buf.origin > 0 and len(want) >= 2
    assert got == want
    with pytest.raises(RuntimeError):
        buf.raw_windows([buf.origin - 1], 4, "cpu")
    assert buf.raw_windows([-4, buf.end - 2], 4, "cpu").tolist() == [
        [0, 0, 0, 0], list(x[buf.end - 2:]) + [0, 0]]
