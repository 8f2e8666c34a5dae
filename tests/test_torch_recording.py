"""Decode-all on the port against the JAX package: the header batch, the
frame windows, ``decode_recording`` and ``decode_recording_auto``.

The recordings are tests/test_multiframe.py's, made by the JAX encoder
from the same seeds: two mode-6 frames back to back (seed 5), the same
with the second frame's header symbol overwritten by seeded noise, and a
mode-10 frame then a mode-12 one (seed 9).  Every JAX reference is
computed once per module.

Exact: the header batch's (header, status) list and the committed
candidates; the windows cut from an analytic recording; ``pos``, ``ok``,
``bits`` and ``flips`` of ``decode_recording`` (BatchPipeline and
AdaptivePipeline at mode 6); every key of ``decode_recording_auto``'s
frames (exact and adaptive) but ``snr``, which is held within 1e-4.
"""

import numpy as np
import pytest
import torch

from modem_tpu import bits as jbits
from modem_tpu.decoder import cached_decoder as jax_cached_decoder
from modem_tpu.encoder import cached_encoder
from modem_tpu.numerology import make_config
from modem_tpu.pipeline import cached_adaptive_pipeline as jax_adaptive
from modem_tpu.pipeline import cached_pipeline as jax_pipeline
from modem_tpu.pipeline import decode_recording_auto as jax_auto
from modem_tpu_torch.decoder import cached_decoder
from modem_tpu_torch.pipeline import (cached_adaptive_pipeline,
                                      cached_pipeline,
                                      decode_recording_auto)

SNR_TOL = 1e-4


def split(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def recordings():
    cfg = make_config(8000, 6, 2000)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(2)]
    wave, _ = cached_encoder(cfg).encode(payloads,
                                         jbits.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    two = np.concatenate([sil, wave, sil]).astype(np.complex64)

    reject = two.copy()
    s, g = cfg.symbol_len, cfg.guard_len
    lo = 8000 + cfg.extended_len + cfg.frame_samples + s + g
    nrng = np.random.default_rng(11)
    reject[lo: lo + s + g] = 0.3 * (nrng.standard_normal(s + g)
                                    + 1j * nrng.standard_normal(s + g))

    rng = np.random.default_rng(9)
    waves, mixed_payloads = [], []
    for mode, call in ((10, "AB1CDE"), (12, "N0CALL")):
        mcfg = make_config(8000, mode, 2000)
        p = rng.integers(0, 256, mcfg.mode.data_bytes,
                         dtype=np.uint8).tobytes()
        w, _ = cached_encoder(mcfg).encode(p, jbits.base37_encode(call))
        waves.append(w)
        mixed_payloads.append(p)
    gap = np.zeros(2000, dtype=np.complex64)
    mixed = np.concatenate([gap, waves[0], gap, waves[1], gap]).astype(
        np.complex64)
    return dict(two=(two, payloads), reject=(reject, payloads[:1]),
                mixed=(mixed, mixed_payloads))


@pytest.fixture(scope="module")
def auto_results(recordings):
    """decode_recording_auto of both packages, exact and adaptive, on the
    mixed-modes and the header-reject recordings."""
    out = {}
    for name in ("mixed", "reject"):
        rec, _ = recordings[name]
        for adaptive in (False, True):
            out[name, adaptive] = (
                decode_recording_auto(rec, 8000, adaptive=adaptive,
                                      device="cpu"),
                jax_auto(rec, 8000, adaptive=adaptive))
    return out


@pytest.fixture(scope="module")
def recording_results(recordings):
    """decode_recording at mode 6 on the two-frame recording, with
    BatchPipeline and AdaptivePipeline of both packages."""
    rec, _ = recordings["two"]
    out = {}
    for adaptive in (False, True):
        port = (cached_adaptive_pipeline if adaptive else cached_pipeline)(
            8000, 6, device="cpu")
        ref = (jax_adaptive if adaptive else jax_pipeline)(8000, 6)
        res, pos = port.decode_recording(rec)
        want, wpos = ref.decode_recording(rec)
        out[adaptive] = (port, port.fetch(res), pos, ref,
                         {k: np.asarray(v) for k, v in want.items()}, wpos)
    return out


def test_header_batch_matches_jax(recordings):
    rec, _ = recordings["reject"]
    port = cached_decoder(8000, device="cpu")
    ref = jax_cached_decoder(8000)
    cands = [c for c in port.sync.scan(rec) if c.ok]
    want_cands = [c for c in ref.sync.scan(split(rec)) if c.ok]
    got = port.decode_headers_batch(rec, cands)
    want = ref.decode_headers_batch(split(rec), want_cands)
    assert got == want
    assert [h for h, _ in got][0] == (6, jbits.base37_encode("N0CALL"))
    assert got[1][0] is None and got[1][1] in (
        "OSD error.", "header CRC error.", "call sign unsupported.")
    for a, b in zip(cands, want_cands):
        assert (a.p0, a.conv, a.ok) == (b.p0, b.conv, b.ok)
        assert abs(a.cfo_rad - b.cfo_rad) < 1e-5


def test_header_batch_reports_past_end(recordings):
    """A hypothesis whose header window leaves the recording reports the
    reference's text, as the JAX batch does."""
    rec, _ = recordings["two"]
    port = cached_decoder(8000, device="cpu")
    ref = jax_cached_decoder(8000)
    cut = rec[: 8000 + 1440 * 2]
    cands = [c for c in port.sync.scan(rec) if c.ok][:1]
    want_cands = [c for c in ref.sync.scan(split(rec)) if c.ok][:1]
    got = port.decode_headers_batch(cut, cands)
    assert got == ref.decode_headers_batch(split(cut), want_cands)
    assert got == [(None, "past recording end")]


def test_windows_at_matches_jax(recordings):
    rec, _ = recordings["two"]
    port = cached_pipeline(8000, 6, device="cpu")
    ref = jax_pipeline(8000, 6)
    positions = [9600, 85920, 40, rec.shape[0] - 1000]
    wins, pos = port.windows_at(rec, positions)
    want, wpos = ref.windows_at(rec, positions)
    assert np.array_equal(pos, wpos)
    assert wins.shape == want.shape[:2] and wins.dtype == torch.complex64
    assert np.array_equal(wins.numpy(), want[..., 0] + 1j * want[..., 1])
    empty, none = port.windows_at(rec, [])
    assert empty.shape[0] == 0 and none.size == 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_decode_recording_matches_jax(recording_results, recordings,
                                      adaptive):
    port, got, pos, ref, want, wpos = recording_results[adaptive]
    _, payloads = recordings["two"]
    assert np.array_equal(pos, wpos) and len(pos) == 2
    n = len(pos)
    for key in ("ok", "bits", "flips"):
        assert np.array_equal(got[key], want[key][:n]), key
    assert np.allclose(got["snr"], want["snr"][:n], rtol=SNR_TOL,
                       atol=SNR_TOL)
    assert [port.payload_bytes(got, i) for i in range(n)] == payloads


def _same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"pos", "mode", "call_sign", "ok",
                                    "payload", "flips", "snr", "status"}
        for key in ("pos", "mode", "call_sign", "ok", "payload", "flips",
                    "status"):
            assert a[key] == b[key], key
        if b["snr"] is None:
            assert a["snr"] is None
        else:
            assert np.allclose(a["snr"], b["snr"], rtol=SNR_TOL,
                               atol=SNR_TOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_auto_mixed_modes_matches_jax(auto_results, recordings, adaptive):
    got, want = auto_results["mixed", adaptive]
    _same_frames(got, want)
    _, payloads = recordings["mixed"]
    assert [f["mode"] for f in got] == [10, 12]
    assert [f["call_sign"] for f in got] == ["AB1CDE", "N0CALL"]
    assert [f["payload"] for f in got] == payloads


@pytest.mark.parametrize("adaptive", [False, True])
def test_auto_header_reject_matches_jax(auto_results, recordings, adaptive):
    got, want = auto_results["reject", adaptive]
    _same_frames(got, want)
    _, payloads = recordings["reject"]
    good = [f for f in got if f["mode"] is not None]
    rejected = [f for f in got if f["mode"] is None]
    assert len(good) == 1 and good[0]["ok"] and good[0]["status"] == "ok"
    assert good[0]["payload"] == payloads[0]
    assert len(rejected) == 1 and rejected[0]["pos"] > good[0]["pos"]


def test_auto_adaptive_equals_exact(auto_results):
    for name in ("mixed", "reject"):
        exact, _ = auto_results[name, False]
        adaptive, _ = auto_results[name, True]
        for a, b in zip(exact, adaptive):
            assert {k: v for k, v in a.items() if k != "snr"} == \
                {k: v for k, v in b.items() if k != "snr"}
