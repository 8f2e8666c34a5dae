"""The port's interactive decoder and its stages against the JAX package's.

Same numpy inputs into both (seeded with numpy; recordings from the JAX
encoder or the frozen golden WAV):

- ``fec.osd.osd_decode`` against ``modem_tpu.fec.osd`` and ``osd_np`` on
  tests/test_osd.py's cases: data bits and ``unique`` exact;
- ``dsp.frontend`` within 1e-5 (the DC block's window sums are f64
  differences here, f32 block products in JAX);
- the Schmitt trigger exact on random timing arrays with a carry;
- the whole-recording timing metric within 1e-3 of JAX's
  ``metrics_host``, the Schmitt state and edges exact, and the scan's raw
  events (edge, n_max) exact and their phase within 1e-5 rad, chunked or
  whole; candidates' p0 and ok exact, CFOs within 1e-6 rad/sample;
- ``theil_sen_all_pairs`` within 1e-6 (one element of the same sorted
  f32 slopes);
- ``fec.scl_np`` equal outright;
- ``Decoder(8000, device="cpu")`` against ``cached_decoder(8000)`` on the
  golden WAV and a mode-6 loopback, analytic and mono: ok, payload,
  oper_mode, call_sign, symbol_pos and bit_flips exact; cfo_hz within
  1e-3 Hz, sfo_ppm within 1e-3 ppm, snr_db within rtol 1e-4 (f32 FFTs
  round differently); the transcript line for line, with the numbers of
  the coarse cfo, coarse sfo, finer cfo and Es/N0 lines within the same
  tolerances; and the loopback cut inside its frame, so that the header
  or the payload window leaves the recording: status and transcript;
- the same on a mode-6 recording through the reference impairment chain
  (multipath x10, cfo 234.567 Hz, sfo 147 ppm) at -18 dB, the geometry
  of chip_smoke.py's envelope (phase 16): the interactive decoder of the
  port and of the JAX package agree on every exact field at the cliff.
"""

import io
import json
import os
import wave

import jax
import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu import channel as jchannel
from modem_tpu import dsp as jdsp
from modem_tpu import sync as jsync
from modem_tpu import track as jtrack
from modem_tpu.decoder import cached_decoder as jax_cached_decoder
from modem_tpu.encoder import cached_encoder
from modem_tpu.fec import bch as jbch
from modem_tpu.fec.osd import osd_decode as jax_osd_decode
from modem_tpu.fec.osd_np import osd_decode_np
from modem_tpu.fec.polar import PolarCode as JaxPolarCode
from modem_tpu.fec.scl_np import scl_decode_np as jax_scl_np
from modem_tpu.numerology import make_config
from modem_tpu.parallel import toy_config as jax_toy_config
from modem_tpu.parallel import toy_recordings
from modem_tpu_torch import dsp, profiling, sync, track
from modem_tpu_torch.decoder import Decoder
from modem_tpu_torch.fec import scl_np
from modem_tpu_torch.fec.osd import osd_decode
from modem_tpu_torch.kernels.osd_eliminate import osd_eliminate
from modem_tpu_torch.numerology import toy_config

_DATA = os.path.join(os.path.dirname(__file__), "data")


# -- OSD ---------------------------------------------------------------------

def _osd_blocks(name):
    """tests/test_osd.py's inputs: (soft [n, 255] int8, sent data [n, 71])."""
    g = jbch.generator_matrix()
    if name == "noiseless":
        rng = np.random.default_rng(1)
        u = rng.integers(0, 2, (1, 71), dtype=np.uint8)
        soft = 127 * (1 - 2 * ((u @ g) % 2).astype(np.int32))
    elif name == "erasure":
        rng = np.random.default_rng(3)
        u = rng.integers(0, 2, (1, 71), dtype=np.uint8)
        soft = 100 * (1 - 2 * ((u @ g) % 2).astype(np.int32))
        soft[0, rng.choice(255, 40, replace=False)] = 0
    else:
        sigma = float(name[len("awgn"):])
        rng = np.random.default_rng(2)
        us, softs = [], []
        for _ in range(5):
            u = rng.integers(0, 2, 71, dtype=np.uint8)
            rx = (1.0 - 2.0 * ((u @ g) % 2)) + sigma * rng.standard_normal(255)
            us.append(u)
            softs.append(np.clip(np.round(127 * rx / 4), -128, 127))
        u, soft = np.stack(us), np.stack(softs)
    return soft.astype(np.int8), u


_jax_osd = jax.jit(jax_osd_decode)


@pytest.mark.parametrize("name", ["noiseless", "awgn0.5", "awgn0.8",
                                  "erasure"])
def test_osd_matches_jax(name):
    """One batched call against JAX's and the numpy OSD block by block."""
    soft, sent = _osd_blocks(name)
    data, unique = osd_decode(torch.from_numpy(soft))
    assert data.shape == (len(soft), 71) and data.dtype == torch.uint8
    for i, s in enumerate(soft):
        jd, ju = (np.asarray(v) for v in _jax_osd(s))
        nd, nu = osd_decode_np(s)
        assert np.array_equal(data[i].numpy(), jd), i
        assert bool(unique[i]) == bool(ju) == bool(nu), i
        assert np.array_equal(np.asarray(nd), jd), i
    ok = sum(bool(unique[i]) and np.array_equal(data[i].numpy(), sent[i])
             for i in range(len(soft)))
    assert ok >= len(soft) - 1


def test_osd_ties_report_not_unique():
    """An all-erased block: every codeword scores 0, so the first minimum
    (the all-zero word) wins and ``unique`` is False, as in JAX."""
    soft = np.zeros((1, 255), np.int8)
    data, unique = osd_decode(torch.from_numpy(soft))
    jd, ju = (np.asarray(v) for v in _jax_osd(soft[0]))
    assert np.array_equal(data[0].numpy(), jd) and not bool(ju)
    assert not bool(unique[0])


def test_osd_on_the_cpu_takes_the_plain_loop_and_launches_nothing():
    """A span records the elimination kernel's launches as
    ``osd_launches``; a CPU call runs the plain loop (255 columns, each
    a counted wait) and leaves the kernel's counter alone."""
    assert "osd_launches" in profiling.COUNTERS
    soft, _ = _osd_blocks("awgn0.5")
    n0, o0, s0 = (osd_eliminate.launches, profiling.osd_steps,
                  profiling.syncs)
    osd_decode(torch.from_numpy(soft))
    assert osd_eliminate.launches == n0
    assert profiling.osd_steps - o0 == 255
    assert profiling.syncs - s0 >= 255


@pytest.mark.parametrize("bad", ["g dtype", "perm dtype", "g shape",
                                 "perm shape", "device", "contiguous"])
def test_osd_eliminate_raises_on_inputs_it_does_not_take(bad):
    g = torch.from_numpy(jbch.generator_matrix().astype(np.uint8))
    perm = torch.stack([torch.randperm(255) for _ in range(2)])
    if bad == "g dtype":
        g = g.int()
    elif bad == "perm dtype":
        perm = perm.int()
    elif bad == "g shape":
        g = g[:, :200].contiguous()
    elif bad == "perm shape":
        perm = perm[:, None]
    elif bad == "device":
        g, perm = g.to("meta"), perm.to("meta")
    else:
        perm = perm.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        osd_eliminate(g, perm)


# -- front end ---------------------------------------------------------------

def test_frontend_matches_jax():
    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(4)
    t = np.arange(6000)
    x = (0.3 + 0.5 * np.sin(0.37 * t)
         + 0.1 * rng.standard_normal(6000)).astype(np.float32)
    assert np.array_equal(dsp.hilbert_taps(cfg.filter_len),
                          jdsp.hilbert_taps(cfg.filter_len))
    got = dsp.frontend(x, 1, 2 * cfg.extended_len, cfg.filter_len,
                       "cpu").numpy()
    want = np.asarray(jdsp.frontend(x, 1, 2 * cfg.extended_len,
                                    cfg.filter_len))
    assert got.dtype == np.complex64 and got.shape == (6000,)
    assert np.allclose(got.real, want[:, 0], atol=1e-5)
    assert np.allclose(got.imag, want[:, 1], atol=1e-5)
    iq = rng.standard_normal((50, 2)).astype(np.float32)
    got = dsp.frontend(iq, 2, 1, 1, "cpu")
    assert np.array_equal(torch.view_as_real(got), iq)


# -- sync scan ---------------------------------------------------------------

@pytest.mark.parametrize("carry", [False, True])
def test_schmitt_matches_jax(carry):
    rng = np.random.default_rng(5)
    t = rng.uniform(0.0, 2.0, (3, 500)).astype(np.float32)
    s, f = sync.schmitt_falling(torch.from_numpy(t), 0.8, 1.2,
                                torch.tensor(carry))
    js, jf = jsync.schmitt_falling(t, 0.8, 1.2, np.bool_(carry))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(f.numpy(), np.asarray(jf))


def test_segmented_argmax_first_max():
    v = torch.tensor([1.0, 3.0, 3.0, 0.0, 5.0, 5.0, 2.0])
    start = torch.tensor([False, False, False, True, False, False, True])
    seg, vmax, first = sync.segmented_argmax(v, start)
    assert seg.tolist() == [0, 0, 0, 1, 1, 1, 2]
    assert vmax[:3].tolist() == [3.0, 5.0, 2.0]
    assert first[:3].tolist() == [1, 4, 6]


def _multiframe(copies, seed=3, noise=0.02):
    recs, _ = toy_recordings(1, seed=seed)
    x = np.concatenate([np.asarray(recs[0])] * copies, axis=0)
    rng = np.random.default_rng(42)
    return x + rng.normal(0, noise, x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def scan_recs():
    """A 5-frame and a 24-frame noisy toy recording (split [T, 2])."""
    return {5: _multiframe(5), 24: _multiframe(24)}


def _jax_raw_events(js, x, max_edges):
    """The JAX host walk's (edge, n_max, phase) triples (scan(host=True))."""
    timing, phase, state, falling = js.metrics_host(x)
    raw = []
    for edge in np.nonzero(falling)[0][:max_edges]:
        prior = np.nonzero(~state[:edge])[0]
        rstart = prior[-1] + 1 if len(prior) else 0
        n_max = rstart + int(np.argmax(timing[rstart:edge]))
        raw.append((int(edge), n_max,
                    float(phase[max(n_max - js.match_del, 0)])))
    return raw


def test_metrics_host_matches_jax(scan_recs):
    """The port's timing metric and Schmitt trigger over the whole
    recording against JAX's host walk, and every falling edge of the
    chunked walk against its edges."""
    x = scan_recs[5]
    port = sync.Synchronizer(toy_config(), "cpu")
    js = jsync.Synchronizer(jax_toy_config())
    t, _ = port._metrics(sync.as_recording(x, "cpu"))
    s, f = sync.schmitt_falling(t, port.thr_lo, port.thr_hi)
    jt, jp, jst, jf = js.metrics_host(x)
    # JAX sums the windows as f32 block products, the port as f64
    # differences: up to ~2.4e-4 apart on this recording
    assert np.allclose(t.numpy(), jt, rtol=1e-3, atol=1e-3)
    assert np.array_equal(s.numpy(), jst) and np.array_equal(f.numpy(), jf)
    for chunk in (2048, 5000):
        got = port._events_device(sync.as_recording(x, "cpu"), chunk,
                                  len(x))
        assert [e[0] for e in got] == np.nonzero(jf)[0].tolist()


@pytest.mark.parametrize("chunk", [64, 1024, 1536, 2048, 4096, None])
def test_scan_events_match_jax_host_walk(scan_recs, chunk):
    """The chunked walk's raw events equal the JAX spec's: (edge, n_max)
    exact in integers, phase within 1e-5 rad; chunk 64 clamps up to the
    context size."""
    x = scan_recs[5]
    port = sync.Synchronizer(toy_config(), "cpu")
    want = _jax_raw_events(jsync.Synchronizer(jax_toy_config()), x, 32)
    got = port._events_device(sync.as_recording(x, "cpu"),
                              chunk or port.CHUNK_SMALL, 32)
    assert len(want) >= 8
    assert [e[:2] for e in got] == [e[:2] for e in want]
    assert np.allclose([e[2] for e in got], [e[2] for e in want], atol=1e-5)


@pytest.mark.parametrize("copies,chunk", [(5, None), (5, 1536), (24, None),
                                          (24, 4096)])
def test_scan_matches_jax(scan_recs, copies, chunk):
    """Candidates of the port's scan, chunked and in default chunks,
    against JAX's scan(host=True) and scan(): p0 and ok exact, CFOs
    within 1e-6 rad/sample.  The 24-frame recording takes two default
    chunks."""
    x = scan_recs[copies]
    port = sync.Synchronizer(toy_config(), "cpu")
    js = jsync.Synchronizer(jax_toy_config())
    want = js.scan(x, max_candidates=8, host=True)
    assert [(c.p0, c.ok) for c in js.scan(x, max_candidates=8)] == \
        [(c.p0, c.ok) for c in want]
    assert sum(c.ok for c in want) >= 4
    for got in (port.scan(x, max_candidates=8, chunk_samples=chunk),
                port.scan(x, max_candidates=8)):
        assert [(c.p0, c.ok) for c in got] == [(c.p0, c.ok) for c in want]
        for a, b in zip(got, want):
            assert abs(a.cfo_rad - b.cfo_rad) < 1e-6
            assert abs(a.frac_cfo - b.frac_cfo) < 1e-6
            assert a.alts == (() if not a.ok else
                              ((0, a.p0, a.cfo_rad, a.peak_ratio),))


# -- tracking, numpy list decoder ----------------------------------------------

def test_theil_sen_all_pairs_matches_jax():
    rng = np.random.default_rng(6)
    x = (np.arange(40) - 20).astype(np.float32)
    y = (0.01 * x + 0.2 + 0.05 * rng.standard_normal((4, 40))
         ).astype(np.float32)
    y[:, 3] += 2.0                          # outliers
    slope, yint = track.theil_sen_all_pairs(torch.from_numpy(x),
                                            torch.from_numpy(y))
    for r in range(4):
        js, jy = (float(v) for v in jtrack.theil_sen_all_pairs(x, y[r]))
        assert abs(float(slope[r]) - js) <= 1e-6
        assert abs(float(yint[r]) - jy) <= 1e-6


def test_scl_np_matches_jax():
    code = JaxPolarCode(n=224, k=144, order=8)
    rng = np.random.default_rng(7)
    llr = 2.0 * (1.0 + 0.8 * rng.standard_normal(code.code_len)) / 0.64
    for lsz in (1, 4, 8):
        got = scl_np.scl_decode_np(llr, code.frozen, lsz)
        want = jax_scl_np(llr, code.frozen, lsz)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                                  want[1])


# -- the interactive decoder ----------------------------------------------------

def _golden():
    with wave.open(os.path.join(_DATA, "golden_mode6_galois.wav")) as f:
        raw = np.frombuffer(f.readframes(f.getnframes()),
                            dtype="<i2").reshape(-1, 2)
    x = raw.astype(np.float32) / 32767.0
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def _loopback():
    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(99)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave_, _ = cached_encoder(cfg).encode(payload,
                                          jbits.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    return np.concatenate([sil, np.asarray(wave_), sil]), payload


@pytest.fixture(scope="module")
def port_decoder():
    return Decoder(8000, device="cpu")


NUMERIC = {"coarse cfo:": 1e-3, "coarse sfo:": 1e-3, "finer cfo:": 1e-3,
           "Es/N0 (dB):": None}


def assert_same_transcript(got: str, want: str):
    a, b = got.splitlines(), want.splitlines()
    assert len(a) == len(b), (a, b)
    for la, lb in zip(a, b):
        head = next((h for h in NUMERIC if la.startswith(h)), None)
        if head is None:
            assert la == lb
            continue
        assert lb.startswith(head)
        na = [float(v) for v in la[len(head):].split() if v != "Hz"
              and v != "ppm"]
        nb = [float(v) for v in lb[len(head):].split() if v != "Hz"
              and v != "ppm"]
        assert la.split()[-1] == lb.split()[-1]          # the unit
        if NUMERIC[head] is None:
            assert np.allclose(na, nb, rtol=1e-4), (la, lb)
        else:
            assert np.allclose(na, nb, rtol=0, atol=NUMERIC[head]), (la, lb)


# the symbol position of _loopback's frame
LOOPBACK_P0 = 9600


@pytest.mark.parametrize("name,channels", [("golden", 2), ("golden", 1),
                                           ("loopback", 2),
                                           ("loopback", 1),
                                           ("header-cut", 2),
                                           ("payload-cut", 2)])
def test_decoder_matches_jax(port_decoder, name, channels):
    """The cuts end the loopback inside its frame, so that the header
    window (half a symbol into the metadata symbol) or the payload
    window (just past the metadata symbol) leaves the recording: the
    status, and the transcript up to it, as JAX's."""
    if name == "golden":
        rec = _golden()
        sent = np.load(os.path.join(
            _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    else:
        rec, sent = _loopback()
    if name.endswith("-cut"):
        cfg = make_config(8000, 6, 2000)
        s, g = cfg.symbol_len, cfg.guard_len
        end = s + g + s // 2 if name == "header-cut" else 2 * s + g
        rec, sent = rec[: LOOPBACK_P0 + end], None
    samples = rec if channels == 2 else rec.real.astype(np.float32)
    log, jlog = io.StringIO(), io.StringIO()
    got = port_decoder.decode(samples, channels=channels, log=log)
    want = jax_cached_decoder(8000).decode(samples, channels=channels,
                                           log=jlog)
    assert got.ok == want.ok == (sent is not None), (got.status,
                                                     want.status)
    assert got.payload == want.payload == sent
    for key in ("ok", "oper_mode", "call_sign", "symbol_pos", "bit_flips",
                "status", "status_emitted"):
        assert getattr(got, key) == getattr(want, key), key
    assert_same_transcript(log.getvalue(), jlog.getvalue())
    if sent is None:
        assert got.snr_db is None and want.snr_db is None
        assert got.status == ("header window out of range"
                              if name == "header-cut"
                              else "payload decoding error.")
        assert got.status_emitted
        assert log.getvalue().startswith(f"symbol pos: {LOOPBACK_P0}\n")
        return
    assert (got.oper_mode, got.call_sign) == (6, "N0CALL")
    assert abs(got.cfo_hz - want.cfo_hz) <= 1e-3
    assert abs(got.sfo_ppm - want.sfo_ppm) <= 1e-3
    assert np.allclose(got.snr_db, want.snr_db, rtol=1e-4)


def test_decoder_matches_jax_impaired(port_decoder):
    """Phase 16's first recording at its hardest level: 0.5 s of silence
    either side, the payload of default_rng(0), the reference chain with
    AWGN at -18 dB from default_rng(100)."""
    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    waves, _ = cached_encoder(cfg).encode_batch(
        [payload], jbits.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 2, dtype=np.complex64)
    clean = np.concatenate([sil, np.asarray(waves[0]), sil])
    rec = jchannel.reference_chain(clean, 8000, awgn_db=-18.0,
                                   rng=np.random.default_rng(100))
    rec = rec[: len(clean)].astype(np.complex64)
    got = port_decoder.decode(rec, channels=2)
    want = jax_cached_decoder(8000).decode(rec, channels=2)
    for key in ("ok", "payload", "oper_mode", "call_sign", "symbol_pos",
                "bit_flips", "status"):
        assert getattr(got, key) == getattr(want, key), key
    if want.ok:
        assert abs(got.cfo_hz - want.cfo_hz) <= 1e-3
        assert abs(got.sfo_ppm - want.sfo_ppm) <= 1e-3
        assert np.allclose(got.snr_db, want.snr_db, rtol=1e-4)


def test_decoder_reports_no_preamble(port_decoder):
    res = port_decoder.decode(np.zeros(20000, np.complex64), channels=2)
    want = jax_cached_decoder(8000).decode(np.zeros(20000, np.complex64),
                                           channels=2)
    assert (res.ok, res.status) == (want.ok, want.status) == (
        False, "no preamble found")


def test_decoder_options():
    with pytest.raises(ValueError):
        Decoder(11025, device="cpu")
    assert Decoder(8000, mls_convention="auto",
                   device="cpu").sync.conventions == (
        "galois", "fibonacci", "msb")
    with pytest.raises(ValueError):
        Decoder(8000, mls_convention="lsb", device="cpu")
    with pytest.raises(NotImplementedError):
        Decoder(8000, list_size=3, device="cpu")
    dec = Decoder(8000, scl_exact=False, device="cpu")
    assert dec.scl_exact is False and dec.estimator == "all_pairs"


# -- spans and counters of a decode (modem_tpu_torch.profiling) ------------------

def _stub_list_decode(full, plan, list_size, exact, *, unroll=False):
    """All-zero paths in place of the wire-size list decode of the mode
    pipeline's ``_fec_select``: every CRC passes (the CRC is linear with
    init 0), so the call runs to its end without the plain list
    decoder."""
    n = full.shape[1]
    return (torch.zeros(1, list_size, n, dtype=torch.uint8),
            torch.zeros(1, list_size))


@pytest.fixture(scope="module")
def traced_decodes(port_decoder, tmp_path_factory):
    """One mono golden decode with tracing off, then one under
    device_trace: (syncs off, the off run's records, record_function
    entries off, syncs on, osd_steps on, the on run's records, the Chrome
    trace's events, the result)."""
    mp = pytest.MonkeyPatch()
    mp.setattr("modem_tpu_torch.pipeline.scl_decode", _stub_list_decode)
    entered = []
    real = torch.profiler.record_function
    mp.setattr(torch.profiler, "record_function",
               lambda name, *a: entered.append(name) or real(name, *a))
    samples = _golden().real.astype(np.float32)
    try:
        profiling.clear_spans()
        s0 = profiling.syncs
        port_decoder.decode(samples, channels=1)
        off = (profiling.syncs - s0, profiling.spans(), list(entered))
        log_dir = tmp_path_factory.mktemp("trace")
        s0, o0 = profiling.syncs, profiling.osd_steps
        with profiling.device_trace(str(log_dir), device="cpu"):
            res = port_decoder.decode(samples, channels=1)
        on = (profiling.syncs - s0, profiling.osd_steps - o0,
              profiling.spans())
    finally:
        mp.undo()
    path = os.path.join(log_dir, os.listdir(log_dir)[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return off + on + (events, res)


def test_decode_records_no_span_when_tracing_is_off(traced_decodes):
    syncs_off, recs_off, entered = traced_decodes[:3]
    assert recs_off == [] and entered == []
    # the counter is always on, and counts what the traced call counts
    assert syncs_off == traced_decodes[3] > 0


def test_decode_spans_nest_in_one_request(traced_decodes):
    recs, res = traced_decodes[5], traced_decodes[7]
    assert res.ok and res.oper_mode == 6
    byid = {r.id: r for r in recs}
    pairs = {(r.name, byid[r.parent].name if r.parent else None)
             for r in recs}
    assert [r.name for r in recs if r.parent is None] == ["decoder.decode"]
    for child in ("decoder.frontend", "decoder.scan", "decoder.header",
                  "decoder.demod", "decoder.list"):
        assert (child, "decoder.decode") in pairs
    assert {("osd.eliminate", "decoder.header"),
            ("osd.score", "decoder.header"),
            ("osd.column", "osd.eliminate"),
            ("frontend.upload", "decoder.frontend"),
            ("frontend.taps", "decoder.frontend"),
            ("sync.round", "decoder.scan"),
            ("sync.fine", "decoder.scan"),
            ("decoder.upload", "decoder.demod"),
            ("decoder.fetch", "decoder.list")} <= pairs
    assert len({r.request for r in recs}) == 1
    for r in recs:
        if r.parent is not None:
            p = byid[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, r.name
        assert r.events is None and r.device_ms is None   # the CPU


def test_decode_counts_a_sync_a_wait_and_255_osd_steps_a_call(
        traced_decodes):
    syncs, steps, recs = traced_decodes[3:6]
    waits = [r for r in recs if r.wait]
    assert syncs == len(waits)
    assert all(not r.counts["syncs"] for r in waits)
    top = recs[0]
    assert top.counts["syncs"] == syncs and top.counts["osd_steps"] == steps
    osd_calls = sum(r.name == "osd.eliminate" for r in recs)
    assert osd_calls >= 1 and steps == 255 * osd_calls
    assert sum(r.name == "osd.column" for r in recs) == steps


def test_device_trace_holds_every_span_around_its_children(traced_decodes):
    recs, events = traced_decodes[5], traced_decodes[6]
    ranges: dict = {}
    for e in sorted((e for e in events if e.get("ph") == "X"),
                    key=lambda e: e["ts"]):
        ranges.setdefault(e["name"], []).append((e["ts"],
                                                 e["ts"] + e["dur"]))
    seen: dict = {}
    where = {}
    for r in recs:              # records in the order they opened
        k = seen[r.name] = seen.get(r.name, -1) + 1
        assert k < len(ranges.get(r.name, [])), r.name
        where[r.id] = ranges[r.name][k]
    for r in recs:
        if r.parent is not None:
            (ps, pe), (cs, ce) = where[r.parent], where[r.id]
            assert ps <= cs and ce <= pe, r.name
