"""The port's WAV I/O, channel impairments, PCM front end and PCM scan
against the JAX package's.

Same numpy inputs into both (seeded with numpy; the PCM recordings are
tests/test_ingest.py's: toy frames from the JAX encoder at 2 kHz,
seeded noise, quantised to int16 or uint8, mono or stereo):

- ``wav``: the golden files read alike (wire-dtype samples equal, the
  floats equal to JAX's, both read by their native codecs, and within
  one f32 ulp, 6e-8, of the numpy dequantisation, which divides where
  the native codec multiplies by 1/32767 rounded first), and files of 8
  and 16 bits, mono and stereo, written by each package byte for byte
  alike and read back alike by the other;
- ``channel``: each function equal to JAX's on the same seed within
  1e-6 (``sfo`` within f32 tolerance, 1e-5);
- the PCM front end on the device (whole recording, and a 512-aligned
  chunk with its context) within 1e-5 of JAX's ``analytic_np``;
- ``Synchronizer.scan`` on a PcmRecording against the JAX scan of the
  same PCM: p0, ok and conv exact, cfo_rad within 1e-5; the raw events
  (edge, n_max) exact, their phase within 1e-5 rad; the same events at
  chunks of 1024, 2048 and the default; the walk in rounds equal event
  for event to a walk of ``chunk_step`` chunk by chunk, with one host
  wait a round;
- the frame windows cut from PCM within 1e-5 of JAX's (whose windows
  come from the scan's retained analytic recording: the DC sums regroup
  at the window starts here), and ``decode_recording`` on PCM equal to
  the JAX toy pipeline's (ok, bits, flips, positions exact).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu import channel as jchannel
from modem_tpu import cplx
from modem_tpu import wav as jwav
from modem_tpu.encoder import cached_encoder
from modem_tpu.ingest import PcmRecording as JaxPcm
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_pipeline
from modem_tpu.sync import Synchronizer as JaxSynchronizer
from modem_tpu_torch import channel, ingest, profiling, wav
from modem_tpu_torch.ingest import PcmRecording
from modem_tpu_torch.numerology import toy_config
from modem_tpu_torch.pipeline import BatchPipeline
from modem_tpu_torch.sync import Synchronizer

_DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = [f"golden_mode6_{c}.wav" for c in ("galois", "fibonacci", "msb")]
PCM_CASES = [(16, False), (16, True), (8, False)]


def toy_pcm(bits, stereo, n_copies=5, noise=0.01):
    """tests/test_ingest.py's _toy_pcm: (wire-dtype samples, payload)."""
    cfg = dataclasses.replace(jax_toy_config(), freq_off=2000)
    enc = cached_encoder(cfg)
    rng0 = np.random.default_rng(3)
    payload = rng0.integers(0, 256, cfg.mode.data_bytes,
                            dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, jbits.base37_encode("TOY"))
    sil = np.zeros(cfg.symbol_len, dtype=np.complex64)
    one = cplx.from_np(np.concatenate([sil, np.asarray(wave), sil]))
    x = np.concatenate([np.asarray(one)] * n_copies, axis=0)
    rng = np.random.default_rng(42)
    x = x + rng.normal(0, noise, x.shape).astype(np.float32)
    x = x * (0.5 / np.abs(x).max())
    if not stereo:
        x = x[:, 0]
    if bits == 16:
        q = np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
    else:
        q = (np.clip(np.rint(x * 127.0), -128, 127) + 128).astype(np.uint8)
    return q, payload


@pytest.fixture(scope="module")
def pcm_cases():
    """Per case: (port PcmRecording, JAX PcmRecording, payload, the JAX
    scan's candidates, the JAX raw events)."""
    out = {}
    ref = JaxSynchronizer(jax_toy_config())
    for bits, stereo in PCM_CASES:
        q, payload = toy_pcm(bits, stereo)
        jpcm = JaxPcm(data=q, bits=bits, rate=8000)
        front = ("stereo" if stereo else "mono", bits)
        events, _ = ref._events_device(q, ref.CHUNK_SMALL, 32, front)
        out[bits, stereo] = (PcmRecording(data=q, bits=bits, rate=8000),
                             jpcm, payload, ref.scan(jpcm, max_candidates=8),
                             events)
    return out


@pytest.fixture(scope="module")
def port_sync():
    return Synchronizer(toy_config(), "cpu")


# -- wav ---------------------------------------------------------------------

def assert_reads_alike(path, got, want):
    raw = jwav.read_wav_raw(path)
    numpy_path = jwav._dequantize(np.asarray(raw.data).tobytes(), raw.bits)
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.analytic, want.analytic)
    assert np.abs(got.samples.reshape(-1) - numpy_path).max() <= 6e-8
    assert np.array_equal(
        wav._dequantize(np.asarray(raw.data).tobytes(), raw.bits), numpy_path)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_files_read_alike(name):
    path = os.path.join(_DATA, name)
    got, want = wav.read_wav(path), jwav.read_wav(path)
    assert (got.rate, got.channels, got.bits) == (want.rate, want.channels,
                                                  want.bits)
    assert_reads_alike(path, got, want)
    raw, jraw = wav.read_wav_raw(path), jwav.read_wav_raw(path)
    assert (raw.bits, raw.rate, raw.channels) == (jraw.bits, jraw.rate, 2)
    assert raw.data.dtype == np.int16
    assert np.array_equal(raw.data, jraw.data)
    assert np.array_equal(raw.dequant_np(), jraw.dequant_np())


@pytest.mark.parametrize("bits,channels", [(8, 1), (8, 2), (16, 1),
                                           (16, 2)])
def test_write_read_both_ways(tmp_path, bits, channels):
    rng = np.random.default_rng(bits * 10 + channels)
    x = (0.6 * (rng.standard_normal(3001)
                + 1j * rng.standard_normal(3001))).astype(np.complex64)
    x[::97] = 2.0                       # clipped samples
    mine, theirs = tmp_path / "port.wav", tmp_path / "jax.wav"
    wav.write_wav(str(mine), x, 8000, bits, channels)
    jwav.write_wav(str(theirs), x, 8000, bits, channels)
    assert mine.read_bytes() == theirs.read_bytes()
    for path in (mine, theirs):
        got, want = wav.read_wav(str(path)), jwav.read_wav(str(path))
        assert_reads_alike(str(path), got, want)
        raw, jraw = wav.read_wav_raw(str(path)), jwav.read_wav_raw(str(path))
        assert raw.bits == bits and raw.channels == channels
        assert np.array_equal(raw.data, jraw.data)
    assert wav.read_wav_raw(str(tmp_path / "missing.wav")) is None


def test_quantisation_matches():
    x = np.linspace(-1.2, 1.2, 4001)
    for bits in (8, 16):
        q = wav._quantize(x, bits)
        assert q == jwav._quantize(x, bits)
        assert np.array_equal(wav._dequantize(q, bits),
                              jwav._dequantize(q, bits))
    with pytest.raises(ValueError):
        wav._quantize(x, 24)


# -- channel -----------------------------------------------------------------

@pytest.fixture(scope="module")
def channel_input():
    rng = np.random.default_rng(7)
    return (rng.standard_normal(4000)
            + 1j * rng.standard_normal(4000)).astype(np.complex64)


@pytest.mark.parametrize("name", ["multipath", "cfo", "analytic_np", "sfo",
                                  "awgn", "reference_chain"])
def test_channel_matches(channel_input, name):
    x = channel_input
    calls = {
        "multipath": lambda m: m.multipath(x, spread=3),
        "cfo": lambda m: m.cfo(x, 234.567, 8000),
        "analytic_np": lambda m: m.analytic_np(x.real),
        "sfo": lambda m: m.sfo(x, 147.0),
        "awgn": lambda m: m.awgn(x, -20.0, np.random.default_rng(1)),
        "reference_chain": lambda m: m.reference_chain(
            x, 8000, np.random.default_rng(2)),
    }
    got, want = calls[name](channel), calls[name](jchannel)
    assert got.shape == want.shape
    tol = 1e-5 if name in ("sfo", "reference_chain") else 1e-6
    assert np.abs(got - want).max() <= tol


# -- the PCM front end -------------------------------------------------------

def test_pcm_recording_checks():
    with pytest.raises(ValueError):
        PcmRecording(data=np.zeros(8, np.int16), bits=8, rate=8000)
    with pytest.raises(ValueError):
        PcmRecording(data=np.zeros(8, np.uint8), bits=24, rate=8000)
    q = np.arange(-4, 4, dtype=np.int16)
    q.flags.writeable = False
    pcm = PcmRecording(data=q, bits=16, rate=8000)
    dev = pcm.on("cpu")
    assert dev.dtype == torch.int16 and pcm.on("cpu") is dev
    assert pcm.shape == (8,) and pcm.channels == 1 and pcm.fill == 0
    assert PcmRecording(data=torch.zeros(4, 2, dtype=torch.uint8), bits=8,
                        rate=8000).fill == 128


@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_front_end_matches_host_spec(pcm_cases, port_sync, bits, stereo):
    pcm, jpcm, _, _, _ = pcm_cases[bits, stereo]
    spec = jpcm.analytic_np(port_sync.dc_window, port_sync.taps)
    got = port_sync.windows(pcm, [0], pcm.n_samples)[0].numpy()
    assert np.abs(got - (spec[:, 0] + 1j * spec[:, 1])).max() <= 1e-5
    assert np.array_equal(pcm.dequant_np(), jpcm.dequant_np())
    assert np.array_equal(ingest.dequant(pcm.on("cpu"), bits).numpy(),
                          jpcm.dequant_np())


def test_analytic_chunk_matches_host_spec(pcm_cases, port_sync):
    """One 512-aligned chunk with its front_lead of raw context against
    the whole-recording spec, and the start of the recording (context
    padded with quantised silence)."""
    pcm, jpcm, _, _, _ = pcm_cases[8, False]
    dcw, taps = port_sync.dc_window, port_sync.taps
    lead = ingest.front_lead(dcw, taps)
    assert lead == port_sync.front_lead and lead % 512 == 0
    assert lead >= dcw + taps
    spec = jpcm.analytic_np(dcw, taps)
    spec = spec[:, 0] + 1j * spec[:, 1]
    for n0 in (0, 1024):
        lo = n0 - lead
        raw = np.full(lead + 2048, 128, np.uint8)
        seg = pcm.data[max(lo, 0): lo + lead + 2048]
        raw[max(0, -lo): max(0, -lo) + len(seg)] = seg
        got = ingest.analytic_chunk(torch.from_numpy(raw), lo, lead, 2048,
                                    8, dcw, taps).numpy()
        assert np.abs(got - spec[n0: n0 + 2048]).max() <= 1e-5


# -- the scan on PCM ---------------------------------------------------------

@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_pcm_scan_matches_jax(pcm_cases, port_sync, bits, stereo):
    pcm, _, _, want, want_events = pcm_cases[bits, stereo]
    got = port_sync.scan(pcm, max_candidates=8)
    assert len(got) == len(want) >= 5
    assert sum(c.ok for c in got) >= 3
    for a, b in zip(got, want):
        assert (a.p0, a.ok, a.conv) == (b.p0, b.ok, b.conv)
        assert abs(a.cfo_rad - b.cfo_rad) < 1e-5
        assert abs(a.frac_cfo - b.frac_cfo) < 1e-5
    events = port_sync._events_device(pcm, port_sync.CHUNK_SMALL, 32)
    assert [e[:2] for e in events] == [e[:2] for e in want_events]
    assert np.allclose([e[2] for e in events],
                       [e[2] for e in want_events], atol=1e-5)


@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_pcm_events_same_at_chunk_sizes(pcm_cases, port_sync, bits,
                                        stereo):
    pcm = pcm_cases[bits, stereo][0]
    base = port_sync._events_device(pcm, port_sync.CHUNK_SMALL, 32)
    assert port_sync.last_chunks == 1
    for chunk in (1024, 2048):
        got = port_sync._events_device(pcm, chunk, 32)
        assert port_sync.last_chunks > 1
        assert [e[:2] for e in got] == [e[:2] for e in base], chunk
        assert np.allclose([e[2] for e in got], [e[2] for e in base],
                           atol=1e-6), chunk


def chunk_walk(sync, x, chunk: int, max_edges: int) -> list:
    """The scan's raw events walked chunk by chunk through
    ``Synchronizer.chunk_step`` (one host read a chunk), stopping after
    the chunk that brings ``max_edges`` of them."""
    c, ctx = sync._context(chunk)
    n_out = x.shape[0] - 2 * sync.L
    carry, events = sync.scan_start(), []
    for n0 in range(0, n_out, c):
        got, carry = sync.chunk_step(x, n0, c, ctx, carry, n_out, max_edges)
        events += got
        if len(events) >= max_edges:
            break
    return events[:max_edges]


# (stereo, samples kept, max_edges): the mono recording has 48 raw edges,
# more than 32; cut to 20,000 samples the walk at 2,048 ends mid-round;
# at 4 edges it stops after its first round
WALK_CASES = [(False, None, 32), (True, None, 32), (False, 20_000, 32),
              (True, None, 4)]


@pytest.mark.parametrize("chunk", [1024, 2048, Synchronizer.CHUNK_SMALL])
@pytest.mark.parametrize("stereo,keep,max_edges", WALK_CASES)
def test_pcm_round_walk_equals_chunk_walk(pcm_cases, port_sync, stereo,
                                          keep, max_edges, chunk):
    """_events_device, which reads each round of chunks back once, gives
    the events of the walk that reads every chunk, event for event."""
    q = pcm_cases[16, stereo][0].data[:keep]
    pcm = PcmRecording(data=q, bits=16, rate=8000)
    got = port_sync._events_device(pcm, chunk, max_edges)
    assert got == chunk_walk(port_sync, pcm, chunk, max_edges)
    assert len(got) == min(max_edges, len(chunk_walk(port_sync, pcm, chunk,
                                                     10 ** 6)))
    rounds = -(-port_sync.last_chunks // Synchronizer.MAX_CHUNKS_PER_ROUND)
    assert port_sync.last_rounds == rounds >= 1


@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_pcm_walk_waits_once_a_round(pcm_cases, port_sync, bits, stereo):
    """profiling.syncs over the walk grows with its rounds, not with its
    chunks: at chunks of 1024 (two rounds) and 2048 (one) the counts
    differ by no more than the rounds do, each at most a wait a round
    and one more."""
    pcm = pcm_cases[bits, stereo][0]
    port_sync._events_device(pcm, 1024, 1000)    # the taps to the device
    counts, rounds = [], []
    for chunk in (1024, 2048):
        s0 = profiling.syncs
        port_sync._events_device(pcm, chunk, 1000)
        counts.append(profiling.syncs - s0)
        rounds.append(port_sync.last_rounds)
        assert counts[-1] <= rounds[-1] + 1
        assert port_sync.last_chunks > rounds[-1]
    assert rounds == [2, 1]
    assert abs(counts[0] - counts[1]) <= abs(rounds[0] - rounds[1])


@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_pcm_frame_windows_match_jax(pcm_cases, bits, stereo):
    """Windows reaching before the recording start and past its end
    read quantised silence in both packages."""
    pcm, jpcm, _, want_cands, _ = pcm_cases[bits, stereo]
    cfg = toy_config()
    port = BatchPipeline(cfg.rate, 0, list_size=1, mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len, device="cpu")
    ref = toy_pipeline(list_size=1)
    positions = [c.p0 for c in want_cands if c.ok] + [10, pcm.n_samples - 50]
    got, pos = port.windows_at(pcm, positions)
    want, wpos = ref.windows_at(jpcm, positions)
    want = np.asarray(want)
    assert np.array_equal(pos, wpos)
    assert np.abs(got.numpy() - (want[..., 0] + 1j * want[..., 1])).max() \
        <= 1e-5


@pytest.mark.parametrize("bits,stereo", PCM_CASES)
def test_pcm_decode_recording_matches_jax(pcm_cases, bits, stereo):
    pcm, jpcm, payload, _, _ = pcm_cases[bits, stereo]
    cfg = toy_config()
    port = BatchPipeline(cfg.rate, 0, list_size=4, mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len, device="cpu")
    res, pos = port.decode_recording(pcm, max_frames=8)
    want, wpos = toy_pipeline(list_size=4).decode_recording(jpcm,
                                                            max_frames=8)
    assert np.array_equal(pos, wpos) and len(pos) >= 1
    got = port.fetch(res)
    for key in ("ok", "bits", "flips"):
        assert np.array_equal(got[key], np.asarray(want[key])[: len(pos)]), \
            key
    assert got["ok"].any()
    for i in np.flatnonzero(got["ok"]):
        assert port.payload_bytes(got, i) == payload
