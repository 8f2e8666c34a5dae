"""The port's command line against the JAX package's: the same argv give
the same return codes, stderr texts and output files.

Both ``main``s run in this process on the same inputs, the port's with
``device="cpu"``.  Each JAX reference that decodes is computed once for
the module.  Compared exactly: return codes, payload files, every
stderr line but those that print floats of a transcript or a PAPR
(``%.4g`` / ``%.6g`` of f32 sums that round differently between
torch.fft and the JAX package's matmul DFT), which are parsed and held
within tolerance, and the impairment tools' WAVs, byte for byte (both
packages read and write regular files through their native codecs, the
port's a copy of the JAX package's).  Encoded WAVs are held to
tests/test_waveform_pin.py's rule: |diff| <= 1 LSB on < 0.5 % of the
samples (torch.fft and the matmul DFT round differently before the
quantiser).
"""

import io
import re
import sys
import wave

import numpy as np
import pytest

from modem_tpu import cli as jax_cli
from modem_tpu_torch import cli

FLOAT = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def run(main, argv, capsys, **kw):
    """(return code, stdout, stderr) of one main() call."""
    capsys.readouterr()
    rc = main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, out, err


def port(argv, capsys):
    return run(cli.main, argv, capsys, device="cpu")


def jax(argv, capsys):
    return run(jax_cli.main, argv, capsys)


def same_text(got: str, want: str, rtol=1e-3, atol=2e-3):
    """Line for line equal, except that the numbers of a line may differ
    within tolerance when the rest of the line is the same."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        if a == b:
            continue
        assert FLOAT.sub("#", a) == FLOAT.sub("#", b), (a, b)
        na = [float(v) for v in FLOAT.findall(a)]
        nb = [float(v) for v in FLOAT.findall(b)]
        assert np.allclose(na, nb, rtol=rtol, atol=atol), (a, b)


def wav_samples(path):
    with wave.open(str(path)) as w:
        raw = w.readframes(w.getnframes())
        params = (w.getnchannels(), w.getsampwidth(), w.getframerate())
    dt = np.int16 if params[1] == 2 else np.uint8
    return params, np.frombuffer(raw, dt).astype(np.int32)


def pinned(got, want):
    """tests/test_waveform_pin.py's rule on two WAV files."""
    (pg, sg), (pw, sw) = wav_samples(got), wav_samples(want)
    assert pg == pw and sg.shape == sw.shape
    diff = np.abs(sg - sw)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.005


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded payload files and the WAVs the JAX CLI encodes from them:
    the Makefile's smoke (8 kHz, 8 bits, mono, offset 2000, mode 6,
    N0CALL), and two mode-6 frames as mono int16."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(21)
    pay = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
           for _ in range(3)]
    names = []
    for i, p in enumerate(pay):
        names.append(str(d / f"in{i}.dat"))
        with open(names[-1], "wb") as f:
            f.write(p)
    smoke, two = str(d / "smoke.wav"), str(d / "two.wav")
    assert jax_cli.main(["encode", smoke, "8000", "8", "1", "2000", "6",
                         "N0CALL", names[0]]) == 0
    assert jax_cli.main(["encode", two, "8000", "16", "1", "2000", "6",
                         "N0CALL", names[1], names[2]]) == 0
    return dict(dir=d, payloads=pay, inputs=names, smoke=smoke, two=two)


# -- argv validation ---------------------------------------------------------

ENCODE_ERRORS = [
    ["encode", "o.wav", "8000", "16", "1", "2000", "6", "N0CALL"],
    ["encode", "o.wav", "8000", "24", "1", "2000", "6", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "3", "2000", "6", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "1", "2000", "5", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "1", "2000", "14", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "1", "2000", "6", "a!b", "IN"],
    ["encode", "o.wav", "11025", "16", "1", "2000", "6", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "1", "100", "6", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "2", "2675", "6", "N0CALL", "IN"],
    ["encode", "o.wav", "8000", "16", "2", "2025", "6", "N0CALL", "IN"],
    ["decode"], ["decode", "o.dat", "a.wav", "0", "1"],
    ["decode-stream"], ["decode-stream", "p", "a.wav", "b"],
    ["decode-all"], ["decode-all", "--adaptive", "p"],
    ["multipath", "o.wav"], ["cfo", "o.wav", "i.wav"],
    ["sfo", "o.wav"], ["awgn", "o.wav", "i.wav"],
    ["unknown-command"],
]


@pytest.mark.parametrize("argv", ENCODE_ERRORS,
                         ids=lambda a: "-".join(a[:1] + a[2:7]))
def test_argv_errors_match_jax(argv, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "IN").write_bytes(bytes(5380))
    got, want = port(argv, capsys), jax(argv, capsys)
    assert got == want
    assert got[0] == 1 and got[2]
    assert not (tmp_path / "o.wav").exists()


def test_no_command(capsys):
    rc, out, err = port([], capsys)
    assert (rc, out) == (1, "")
    assert err.startswith("usage: modem_tpu_torch.cli {encode|decode|")


def wav_bytes(rate=8000, channels=1, bits=16, fmt=1, frames=800):
    """A RIFF/WAVE of silence with the given header fields."""
    block = channels * bits // 8
    data = bytes(frames * block)
    hdr = (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
           + b"fmt " + (16).to_bytes(4, "little")
           + fmt.to_bytes(2, "little") + channels.to_bytes(2, "little")
           + rate.to_bytes(4, "little")
           + (rate * block).to_bytes(4, "little")
           + block.to_bytes(2, "little") + bits.to_bytes(2, "little")
           + b"data" + len(data).to_bytes(4, "little"))
    return hdr + data


BAD_WAVS = {
    "rate": wav_bytes(rate=11025), "channels": wav_bytes(channels=3),
    "float": wav_bytes(fmt=3, bits=32), "bits": wav_bytes(bits=24),
    "silence": wav_bytes(frames=20000),
    "not-riff": b"RIFX" + bytes(40), "no-data": wav_bytes()[:36],
}


@pytest.mark.parametrize("cmd", ["decode", "decode-stream"])
@pytest.mark.parametrize("name", sorted(BAD_WAVS))
def test_bad_input_matches_jax(cmd, name, tmp_path, capsys):
    """Unsupported WAVs and a recording without a frame: the same return
    code and stderr; what the JAX CLI raises on, the port raises too."""
    path = tmp_path / "in.wav"
    path.write_bytes(BAD_WAVS[name])
    argv = [cmd, str(tmp_path / "out"), str(path)]
    try:
        want = jax(argv, capsys)
    except Exception as e:                  # the JAX CLI's own failure
        with pytest.raises(type(e)):
            port(argv, capsys)
        return
    assert port(argv, capsys) == want
    assert want[0] == 1


def test_missing_input_encodes_ff(tmp_path, capsys):
    """The reference's quirk (encode.cc:410-413): an input that does not
    open is a payload of 0xFF bytes, and nothing is printed."""
    missing = str(tmp_path / "no_such_file.dat")
    assert cli._read_input(missing, True) == jax_cli._read_input(missing,
                                                                 True)
    assert cli._read_input(missing, True) == b"\xff" * 5380
    got = port(["encode", str(tmp_path / "p.wav"), "8000", "16", "1",
                "2000", "6", "N0CALL", missing], capsys)
    want = jax(["encode", str(tmp_path / "j.wav"), "8000", "16", "1",
                "2000", "6", "N0CALL", missing], capsys)
    assert got[:2] == want[:2] == (0, "")
    same_text(got[2], want[2])
    pinned(tmp_path / "p.wav", tmp_path / "j.wav")


def test_freezer_matches_jax(capsys):
    got, want = port(["freezer"], capsys), jax(["freezer"], capsys)
    assert got == want
    assert "frozen_64800_43072[2048]" in got[1]


# -- encode ------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["8000", "8", "1", "2000", "6", "N0CALL", 0],
    ["8000", "16", "2", "2300", "10", "AB1CDE", 1, 2]])
def test_encode_matches_jax(files, args, tmp_path, capsys):
    """WAVs within the waveform-pin rule of the JAX CLI's; the PAPR lines
    within 1e-3 dB."""
    inputs = [files["inputs"][i] for i in args[6:]]
    argv = lambda out: ["encode", str(out)] + args[:6] + inputs  # noqa: E731
    got = port(argv(tmp_path / "p.wav"), capsys)
    want = jax(argv(tmp_path / "j.wav"), capsys)
    assert got[:2] == want[:2] == (0, "")
    assert got[2].count("PAPR") == (2 if args[2] == "2" else 1)
    same_text(got[2], want[2], rtol=0, atol=1e-3)
    pinned(tmp_path / "p.wav", tmp_path / "j.wav")


# -- decode ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decode(files):
    """The JAX CLI's decode of the smoke WAV: to a file, and to a path
    that cannot be opened."""
    d = files["dir"]
    out = {}
    for name in ("ok", "bad"):
        path = str(d / "jax.dat") if name == "ok" else str(d / "no" / "x")
        err = io.StringIO()
        old, sys.stderr = sys.stderr, err
        try:
            rc = jax_cli.main(["decode", path, files["smoke"]])
        finally:
            sys.stderr = old
        out[name] = (rc, err.getvalue())
    return out


def test_decode_matches_jax(files, jax_decode, tmp_path, capsys):
    """The Makefile's smoke: encode, decode, byte compare; the decoder's
    stderr transcript as the JAX CLI's."""
    out = tmp_path / "p.dat"
    rc, stdout, err = port(["decode", str(out), files["smoke"]], capsys)
    assert (rc, stdout) == (0, "")
    assert out.read_bytes() == files["payloads"][0]
    assert (files["dir"] / "jax.dat").read_bytes() == files["payloads"][0]
    assert jax_decode["ok"][0] == 0
    same_text(err, jax_decode["ok"][1])
    assert "bit flips: 0" in err

    bad = str(files["dir"] / "no" / "x")
    rc, _, err = port(["decode", bad, files["smoke"]], capsys)
    assert rc == jax_decode["bad"][0] == 1
    same_text(err, jax_decode["bad"][1])
    assert err.endswith(f'Couldn\'t open file "{bad}" for writing.\n')


def test_encode_then_decode_through_the_port(files, tmp_path, capsys):
    """The smoke with the port on both ends, through stdout: the encoded
    WAV written to '-' equals the one written to a file."""
    argv = ["8000", "8", "1", "2000", "6", "N0CALL", files["inputs"][0]]
    rc, _, _ = port(["encode", str(tmp_path / "e.wav")] + argv, capsys)
    assert rc == 0
    assert port(["decode", str(tmp_path / "d.dat"), str(tmp_path / "e.wav")],
                capsys)[0] == 0
    assert (tmp_path / "d.dat").read_bytes() == files["payloads"][0]


# -- decode-all ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decode_all(files):
    """The JAX CLI's decode-all of the two-frame WAV, exact and
    adaptive: (rc, stderr, payload files)."""
    d = files["dir"]
    out = {}
    for flag in ([], ["--adaptive"]):
        prefix = str(d / f"jax_all{len(flag)}")
        err = io.StringIO()
        old, sys.stderr = sys.stderr, err
        try:
            rc = jax_cli.main(["decode-all"] + flag + [prefix, files["two"]])
        finally:
            sys.stderr = old
        out[len(flag)] = (rc, err.getvalue(), outputs(prefix))
    return out


def outputs(prefix):
    import glob
    return {p[len(prefix):]: open(p, "rb").read()
            for p in sorted(glob.glob(prefix + ".*"))}


@pytest.mark.parametrize("adaptive", [False, True])
def test_decode_all_matches_jax(files, jax_decode_all, adaptive, tmp_path,
                                capsys):
    flag = ["--adaptive"] if adaptive else []
    prefix = str(tmp_path / "all")
    got = port(["decode-all"] + flag + [prefix, files["two"]], capsys)
    rc, err, want_files = jax_decode_all[int(adaptive)]
    assert got == (rc, "", err) and rc == 0
    assert outputs(prefix) == want_files == {
        ".000": files["payloads"][1], ".001": files["payloads"][2]}


# -- decode-stream -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stream(files):
    d = files["dir"]
    prefix = str(d / "jax_live")
    err = io.StringIO()
    old, sys.stderr = sys.stderr, err
    try:
        rc = jax_cli.main(["decode-stream", prefix, files["two"]])
    finally:
        sys.stderr = old
    return rc, err.getvalue(), outputs(prefix)


def variant(raw: bytes, name: str) -> bytes:
    """The two-frame WAV with one RIFF quirk."""
    di = raw.index(b"data")
    if name == "trailing-list":
        junk = b"LIST" + (64).to_bytes(4, "little") + bytes(64)
        out = bytearray(raw + junk)
        out[4:8] = (int.from_bytes(raw[4:8], "little")
                    + len(junk)).to_bytes(4, "little")
        return bytes(out)
    if name == "odd-chunk":
        junk = b"note" + (5).to_bytes(4, "little") + b"hello" + b"\x00"
        return raw[:di] + junk + raw[di:]
    if name in ("size-0", "size-ffffffff"):
        size = 0 if name == "size-0" else 0xFFFFFFFF
        return raw[:di + 4] + size.to_bytes(4, "little") + raw[di + 8:]
    return raw


class Pipe(io.BytesIO):
    """A non-seekable byte stream, as stdin from a pipe."""

    def seekable(self):
        return False


@pytest.mark.parametrize("name", ["file", "stdin", "trailing-list",
                                  "odd-chunk", "size-0", "size-ffffffff"])
def test_decode_stream_matches_jax(files, jax_stream, name, tmp_path,
                                   capsys, monkeypatch):
    """decode-stream from a file, from a non-seekable stdin, with a
    trailing LIST chunk, an odd-sized chunk and its pad byte, and data
    sizes 0 and 0xFFFFFFFF (read to EOF): the JAX CLI's stderr and
    files on the plain file."""
    with open(files["two"], "rb") as f:
        raw = f.read()
    prefix = str(tmp_path / "live")
    if name == "stdin":
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(Pipe(raw)))
        argv = ["decode-stream", prefix]
    else:
        path = tmp_path / "in.wav"
        path.write_bytes(variant(raw, name))
        argv = ["decode-stream", prefix, str(path)]
    rc, err, want_files = jax_stream
    assert port(argv, capsys) == (rc, "", err) and rc == 0
    assert outputs(prefix) == want_files == {
        ".000": files["payloads"][1], ".001": files["payloads"][2]}


# -- the impairment tools ------------------------------------------------------

@pytest.fixture(scope="module")
def impair_src(tmp_path_factory):
    """Seeded noise as a stereo and a mono 16-bit WAV."""
    from modem_tpu_torch import wav
    d = tmp_path_factory.mktemp("impair")
    rng = np.random.default_rng(3)
    x = (0.4 * rng.standard_normal(4000)
         + 0.4j * rng.standard_normal(4000)).astype(np.complex64)
    for ch in (1, 2):
        wav.write_wav(str(d / f"src{ch}.wav"), x, 8000, 16, ch)
    (d / "taps.txt").write_text("0 1.0 0.0\n3 -0.4 0.25  # echo\n\n")
    return d


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("args", [
    ["cfo", "234.567"], ["sfo", "147"], ["awgn", "-30", "7"], ["awgn", "-20"],
    ["multipath", "-", "10"], ["multipath"], ["multipath", "TAPS", "2"]],
    ids="-".join)
def test_impairments_match_jax(impair_src, args, channels, tmp_path, capsys):
    """Output WAVs byte for byte the JAX CLI's, each package reading and
    writing through its own native codec (f32, ties away from zero)."""
    from modem_tpu import native as jnative
    assert jnative.available()
    args = [str(impair_src / "taps.txt") if a == "TAPS" else a for a in args]
    src = str(impair_src / f"src{channels}.wav")
    got = port([args[0], str(tmp_path / "p.wav"), src] + args[1:], capsys)
    want = jax([args[0], str(tmp_path / "j.wav"), src] + args[1:], capsys)
    assert got == want == (0, "", "")
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
